"""Telemetry of the port: convergence traces, metric primitives (clocks,
counters, latency accounting) and host-side spans. `metrics` and `spans`
are the port's own copies of the reference's modules."""
from repro_torch.obs.metrics import (Counter, FakeClock, Gauge, Histogram,
                                     LatencyRecorder, LatencyReport,
                                     Registry, perf_clock, wall_clock)
from repro_torch.obs.spans import (Span, SpanRecorder, install, recording,
                                   span, uninstall)
from repro_torch.obs.trace import AsyncSolveTrace, SolveTrace

__all__ = ["AsyncSolveTrace", "Counter", "FakeClock", "Gauge", "Histogram",
           "LatencyRecorder", "LatencyReport", "Registry", "SolveTrace",
           "Span", "SpanRecorder", "install", "perf_clock", "recording",
           "span", "uninstall", "wall_clock"]
