"""Metric primitives: clocks, counters, gauges, histograms, latency.

The port's own copy of the reference's `repro.obs.metrics` (stdlib and
numpy only; the port imports nothing of the reference package).

Clock policy: host-side timing in the port goes through the clocks
defined here (`perf_clock`, `wall_clock`, `trace_clock`, or an injected
callable defaulting to them), so every latency number is faked the same
way in tests (`FakeClock`).

`LatencyRecorder` / `LatencyReport` are generic per-request latency
accounting; `repro_torch.serve.admission` re-exports them.

Thread-safety contract: every mutating public method on `Counter`,
`Gauge`, `Histogram`, `Registry`, and `LatencyRecorder` holds its
instance lock for the whole critical section.
"""
from __future__ import annotations

import dataclasses
import threading
import time
from typing import Any, Callable, Iterable

import numpy as np

__all__ = [
    "Counter",
    "FakeClock",
    "Gauge",
    "Histogram",
    "LatencyRecorder",
    "LatencyReport",
    "Registry",
    "perf_clock",
    "trace_clock",
    "wall_clock",
]

# The only raw-clock references of the port: monotonic for durations,
# wall for provenance timestamps, and the profiler's clock for spans.
perf_clock: Callable[[], float] = time.perf_counter
wall_clock: Callable[[], float] = time.time


def trace_clock() -> float:
    """Seconds on the Unix epoch from `time.time_ns`: the clock that
    `torch.profiler` converts its host and CUDA timestamps to, so a span
    read on it lies on the profiler's device timeline."""
    return time.time_ns() * 1e-9


class FakeClock:
    """Deterministic injectable clock: starts at `start`, advances only
    via `advance` — a seeded load trace replayed against it produces
    bit-identical latency reports."""

    def __init__(self, start: float = 0.0):
        self._t = float(start)
        self._lock = threading.Lock()

    def __call__(self) -> float:
        with self._lock:
            return self._t

    def advance(self, dt: float) -> float:
        with self._lock:
            self._t += float(dt)
            return self._t


class Counter:
    """Monotonically-increasing count (dispatches, rounds, bytes)."""

    def __init__(self, name: str, help: str = ""):
        self.name = name
        self.help = help
        self._lock = threading.Lock()
        self._value = 0.0

    def inc(self, n: float = 1.0) -> None:
        if n < 0:
            raise ValueError(f"counter {self.name}: negative inc {n}")
        with self._lock:
            self._value += float(n)

    @property
    def value(self) -> float:
        with self._lock:
            return self._value


class Gauge:
    """Last-write-wins instantaneous value (queue depth, VMEM bytes)."""

    def __init__(self, name: str, help: str = ""):
        self.name = name
        self.help = help
        self._lock = threading.Lock()
        self._value = 0.0

    def set(self, v: float) -> None:
        with self._lock:
            self._value = float(v)

    def add(self, dv: float) -> None:
        with self._lock:
            self._value += float(dv)

    @property
    def value(self) -> float:
        with self._lock:
            return self._value


class Histogram:
    """Exact-sample histogram (bench/serve scale — samples are kept, so
    percentiles are the same `np.percentile` numbers `LatencyReport`
    uses, not bucket approximations)."""

    def __init__(self, name: str, help: str = "",
                 clock: Callable[[], float] = perf_clock):
        self.name = name
        self.help = help
        self.clock = clock
        self._lock = threading.Lock()
        self._samples: list[float] = []

    def observe(self, v: float) -> None:
        with self._lock:
            self._samples.append(float(v))

    def time(self):
        """Context manager observing the elapsed clock duration."""
        return _HistogramTimer(self)

    @property
    def count(self) -> int:
        with self._lock:
            return len(self._samples)

    def samples(self) -> list[float]:
        with self._lock:
            return list(self._samples)

    def summary(self) -> dict[str, float]:
        with self._lock:
            s = np.asarray(self._samples, dtype=np.float64)
        if s.size == 0:
            return {"count": 0, "sum": 0.0, "mean": 0.0, "max": 0.0,
                    "p50": 0.0, "p99": 0.0}
        return {
            "count": int(s.size),
            "sum": float(s.sum()),
            "mean": float(s.mean()),
            "max": float(s.max()),
            "p50": float(np.percentile(s, 50)),
            "p99": float(np.percentile(s, 99)),
        }


class _HistogramTimer:
    def __init__(self, hist: Histogram):
        self._hist = hist

    def __enter__(self):
        self._t0 = self._hist.clock()
        return self

    def __exit__(self, *exc):
        self._hist.observe(self._hist.clock() - self._t0)
        return False


class Registry:
    """One named home for every metric, span, and event of a run.

    Metrics are get-or-create by name (re-registering with a different
    type raises). `record_event` appends a free-form timestamped record
    (by convention ``trace`` for convergence traces, ``latency`` for
    serve percentiles, ``provenance`` for run provenance). `record_span`
    is the sink `repro_torch.obs.spans` drains finished spans into.
    """

    def __init__(self, clock: Callable[[], float] = perf_clock):
        self.clock = clock
        self._lock = threading.Lock()
        self._metrics: dict[str, Any] = {}
        self._events: list[dict[str, Any]] = []
        self._spans: list[Any] = []

    def _get_or_create(self, cls, name: str, help: str, **kw):
        with self._lock:
            got = self._metrics.get(name)
            if got is None:
                got = self._metrics[name] = cls(name, help, **kw)
            elif not isinstance(got, cls):
                raise TypeError(
                    f"metric {name!r} already registered as "
                    f"{type(got).__name__}, requested {cls.__name__}")
            return got

    def counter(self, name: str, help: str = "") -> Counter:
        return self._get_or_create(Counter, name, help)

    def gauge(self, name: str, help: str = "") -> Gauge:
        return self._get_or_create(Gauge, name, help)

    def histogram(self, name: str, help: str = "") -> Histogram:
        return self._get_or_create(Histogram, name, help,
                                   clock=self.clock)

    def record_event(self, kind: str, **fields: Any) -> dict[str, Any]:
        ev = {"event": str(kind), "t": float(self.clock()), **fields}
        with self._lock:
            self._events.append(ev)
        return ev

    def record_span(self, span: Any) -> None:
        with self._lock:
            self._spans.append(span)

    @property
    def metrics(self) -> dict[str, Any]:
        with self._lock:
            return dict(self._metrics)

    @property
    def events(self) -> list[dict[str, Any]]:
        with self._lock:
            return list(self._events)

    @property
    def spans(self) -> list[Any]:
        with self._lock:
            return list(self._spans)


@dataclasses.dataclass(frozen=True)
class LatencyReport:
    """Latency/throughput summary of one serving run.

    Latency is completion − admission per request (queueing included —
    the open-loop number a caller actually experiences); `qps` is
    requests / (last completion − first admission). Percentiles use the
    linear-interpolation convention of `np.percentile` and are exact
    deterministic functions of the recorded trace.
    """

    count: int
    p50: float
    p99: float
    mean: float
    max: float
    qps: float

    @staticmethod
    def empty() -> "LatencyReport":
        return LatencyReport(count=0, p50=0.0, p99=0.0, mean=0.0, max=0.0,
                             qps=0.0)


class LatencyRecorder:
    """Thread-safe per-request latency accumulator."""

    def __init__(self, clock: Callable[[], float] = perf_clock):
        self.clock = clock
        self._lock = threading.Lock()
        self._arrivals: list[float] = []
        self._completions: list[float] = []

    def now(self) -> float:
        return float(self.clock())

    def record(self, t_arrival: float, t_done: float) -> None:
        if t_done < t_arrival:
            raise ValueError(
                f"completion {t_done} precedes admission {t_arrival}")
        with self._lock:
            self._arrivals.append(float(t_arrival))
            self._completions.append(float(t_done))

    def record_wave(self, entries: Iterable[Any], t_done: float) -> None:
        """Record every entry of one wave (anything with a `t_arrival`
        attribute — `repro_torch.serve.admission.Admitted` in production)."""
        for e in entries:
            self.record(e.t_arrival, t_done)

    def reset(self) -> None:
        with self._lock:
            self._arrivals.clear()
            self._completions.clear()

    def report(self) -> LatencyReport:
        with self._lock:
            arrivals = np.asarray(self._arrivals, dtype=np.float64)
            completions = np.asarray(self._completions, dtype=np.float64)
        if arrivals.size == 0:
            return LatencyReport.empty()
        lat = completions - arrivals
        span = float(completions.max() - arrivals.min())
        return LatencyReport(
            count=int(lat.size),
            p50=float(np.percentile(lat, 50)),
            p99=float(np.percentile(lat, 99)),
            mean=float(lat.mean()),
            max=float(lat.max()),
            qps=float(lat.size / span) if span > 0 else float("inf"),
        )
