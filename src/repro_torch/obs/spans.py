"""Host-side trace spans: nested wall-clock intervals around the
runtimes' host work (the fit's DDRF selection, pack steps, solve and
predictions; snapshot publish; serve waves).

The port's counterpart of the reference's `repro.obs.spans`, with ids
besides. Spans measure *host* work — staging, queueing, the
host side of a wave — never device time (a span around asynchronous
CUDA work ends when the work is enqueued, unless the code inside it
waits for the device). Instrumented library code calls

    with span("serve.wave", slots=n):
        ...

which costs one attribute read unless a `SpanRecorder` is installed:
`span` then returns one shared no-op context manager. The harness that wants spans installs one for the duration of
a run:

    with recording(registry) as rec:
        ... serve ...
    # finished spans are now in registry.spans and rec.spans

Spans are read on `trace_clock` by default, the clock `torch.profiler`
stamps its host and device events with, so a span can be laid on the
profiler's timeline. It is the Unix clock, not a monotonic one: a
span's duration is a wall-clock duration, its stamps float seconds
(about 0.24 µs apart at today's epoch). Nesting is tracked per thread (each replica thread
gets its own depth stack against the one installed recorder), so a
serve-wave span inside an enclosing span records depth 1 and the
enclosing span's `span_id` as its `parent_id`.
"""
from __future__ import annotations

import contextlib
import dataclasses
import itertools
import threading
from typing import Any, Callable, Iterator

from repro_torch.obs.metrics import Registry, trace_clock

__all__ = ["Span", "SpanRecorder", "install", "last_recording",
           "recording", "span", "uninstall"]


@dataclasses.dataclass(slots=True)
class Span:
    """One finished interval. `depth` is the nesting level within its
    thread (0 = top-level); `parent` is the enclosing span's name and
    `parent_id` its `span_id` (ids are the recorder's, from 1 in the
    order spans open)."""

    name: str
    t_start: float
    t_end: float
    depth: int
    parent: str | None
    thread: str
    attrs: dict[str, Any]
    span_id: int
    parent_id: int | None

    @property
    def duration(self) -> float:
        return self.t_end - self.t_start


class _Live:
    """One open span: a context manager that stamps its ends and appends
    the finished `Span`. A plain class, where a generator context manager
    and a frozen `Span` would cost the host twice the µs a span."""

    __slots__ = ("rec", "name", "attrs", "span_id", "depth", "parent",
                 "t0")

    def __init__(self, rec: "SpanRecorder", name: str,
                 attrs: dict[str, Any]):
        self.rec, self.name, self.attrs = rec, name, attrs

    def __enter__(self) -> None:
        stack = self.rec._stack()
        self.depth = len(stack)
        self.parent = stack[-1] if stack else None
        self.span_id = next(self.rec._ids)
        stack.append(self)
        self.t0 = self.rec.clock()

    def __exit__(self, *exc: Any) -> None:
        t1 = self.rec.clock()
        self.rec._stack().pop()
        parent = self.parent
        sp = Span(self.name, float(self.t0), float(t1), self.depth,
                  parent.name if parent else None,
                  threading.current_thread().name, self.attrs,
                  self.span_id, parent.span_id if parent else None)
        self.rec.spans.append(sp)       # list.append is atomic
        if self.rec.registry is not None:
            self.rec.registry.record_span(sp)


class SpanRecorder:
    """Collects finished spans; optionally forwards them to a
    `Registry` (readers take them from `registry.spans`)."""

    def __init__(self, clock: Callable[[], float] = trace_clock,
                 registry: Registry | None = None):
        self.clock = clock
        self.registry = registry
        self._local = threading.local()
        self._ids = itertools.count(1)
        self.spans: list[Span] = []

    def _stack(self) -> list[_Live]:
        st = getattr(self._local, "stack", None)
        if st is None:
            st = self._local.stack = []
        return st

    def span(self, name: str, **attrs: Any) -> _Live:
        return _Live(self, name, attrs)


# The process-wide installed recorder. Library call sites are always-on
# cheap: `span()` reads this once and returns at once when None.
_installed: SpanRecorder | None = None
# The recorder of the last `recording()` scope to close, for a reader
# that is handed the scope's results but not its recorder.
_last: SpanRecorder | None = None
_install_lock = threading.Lock()
_OFF = contextlib.nullcontext()


def install(recorder: SpanRecorder) -> SpanRecorder:
    """Make `recorder` the process-wide span sink (replaces any prior)."""
    global _installed
    with _install_lock:
        _installed = recorder
    return recorder


def uninstall() -> None:
    global _installed
    with _install_lock:
        _installed = None


@contextlib.contextmanager
def recording(registry: Registry | None = None,
              clock: Callable[[], float] = trace_clock
              ) -> Iterator[SpanRecorder]:
    """Install a fresh recorder for the scope, restore the prior one
    after — the harness-side entry point."""
    global _installed, _last
    rec = SpanRecorder(clock=clock, registry=registry)
    with _install_lock:
        prev, _installed = _installed, rec
    try:
        yield rec
    finally:
        with _install_lock:
            _installed, _last = prev, rec


def last_recording() -> SpanRecorder | None:
    """The recorder of the most recent `recording()` scope to close in
    this process, or None."""
    return _last


def span(name: str, **attrs: Any) -> contextlib.AbstractContextManager:
    """Library-side span: records into the installed recorder; one
    shared no-op context manager when none is installed."""
    rec = _installed
    if rec is None:
        return _OFF
    return rec.span(name, **attrs)

