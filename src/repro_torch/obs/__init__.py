"""Telemetry of the port: what is recorded where.

The port's counterpart of the reference's `repro.obs`:

    ON DEVICE (one launch, no host read per round)
      solve_batched / async_solve_batched / chebyshev_solve_packed with
      `return_trace=True`
        └─▶ SolveTrace / AsyncSolveTrace  (repro_torch.obs.trace):
            per-round max|Δθ| from the chain kernels' res [R, J]; async
            adds active / broadcasts / deliveries / bytes per round.

    HOST SIDE (stdlib clocks, injectable — rule R006)
      pack_problem · stream ingest/refresh/publish · serve waves ·
      bench suites
        └─▶ spans (repro_torch.obs.spans)
      counters / gauges / histograms / LatencyRecorder
        └─▶ Registry (repro_torch.obs.metrics)

    DISPATCHES (counted as the program runs)
      dispatch_count(fn, *args) (repro_torch.obs.dispatch)
        └─▶ the calls in which an ops wrapper ran its kernel (CUDA) or
            its plain version (CPU), held to `round_dispatches`.

    EXPORT (repro_torch.obs.export)
      Registry ──▶ JSONL (spans + metrics + trace/latency events +
                   provenance block) ──▶ `python -m repro_torch.obs`
                   report (convergence table, comm frontier, span
                   waterfall, serve percentiles)
               ──▶ Prometheus text exposition (metrics only)
      provenance() / stamp_provenance() — git sha, torch and CUDA
      versions, the card's name and power limit, the plain flag, stamped
      by `python -m repro_torch.bench.run` into what it writes.

`metrics`, `spans` and `trace` are the port's own copies of the
reference's modules. The reference's `count_pallas_dispatches` (a jaxpr
walk) has no counterpart: PyTorch has no traced program to walk.
"""
from repro_torch.obs import export, spans
from repro_torch.obs.dispatch import dispatch_count, round_dispatches
from repro_torch.obs.metrics import (Counter, FakeClock, Gauge, Histogram,
                                     LatencyRecorder, LatencyReport,
                                     Registry, perf_clock, wall_clock)
from repro_torch.obs.spans import (Span, SpanRecorder, install, recording,
                                   span, uninstall)
from repro_torch.obs.trace import AsyncSolveTrace, SolveTrace

__all__ = ["AsyncSolveTrace", "Counter", "FakeClock", "Gauge", "Histogram",
           "LatencyRecorder", "LatencyReport", "Registry", "SolveTrace",
           "Span", "SpanRecorder", "dispatch_count", "export", "install",
           "perf_clock", "recording", "round_dispatches", "span", "spans",
           "uninstall", "wall_clock"]
