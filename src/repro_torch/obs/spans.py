"""Host-side trace spans: nested wall-clock intervals around the
runtimes' host work (snapshot publish, serve waves).

The port's own copy of the reference's `repro.obs.spans`. Spans measure
*host* work — staging, queueing, the host side of a wave — never device
time (a span around asynchronous CUDA work ends when the work is
enqueued, unless the code inside it waits for the device). Instrumented
library code calls

    with span("serve.wave", slots=n):
        ...

which is a no-op (one attribute read) unless a `SpanRecorder` is
installed. The harness that wants spans installs one for the duration
of a run:

    with recording(registry) as rec:
        ... serve ...
    # finished spans are now in registry.spans

Nesting is tracked per thread (each replica thread gets its own depth
stack against the one installed recorder), so a serve-wave span inside
an enclosing span records depth 1.
"""
from __future__ import annotations

import contextlib
import dataclasses
import threading
from typing import Any, Callable, Iterator

from repro_torch.obs.metrics import Registry, perf_clock

__all__ = ["Span", "SpanRecorder", "install", "recording", "span",
           "uninstall"]


@dataclasses.dataclass(frozen=True)
class Span:
    """One finished interval. `depth` is the nesting level within its
    thread (0 = top-level); `parent` is the enclosing span's name."""

    name: str
    t_start: float
    t_end: float
    depth: int
    parent: str | None
    thread: str
    attrs: dict[str, Any]

    @property
    def duration(self) -> float:
        return self.t_end - self.t_start


class SpanRecorder:
    """Collects finished spans; optionally forwards them to a
    `Registry` (readers take them from `registry.spans`)."""

    def __init__(self, clock: Callable[[], float] = perf_clock,
                 registry: Registry | None = None):
        self.clock = clock
        self.registry = registry
        self._lock = threading.Lock()
        self._local = threading.local()
        self.spans: list[Span] = []

    def _stack(self) -> list[str]:
        st = getattr(self._local, "stack", None)
        if st is None:
            st = self._local.stack = []
        return st

    @contextlib.contextmanager
    def span(self, name: str, **attrs: Any) -> Iterator[None]:
        stack = self._stack()
        depth = len(stack)
        parent = stack[-1] if stack else None
        stack.append(name)
        t0 = self.clock()
        try:
            yield
        finally:
            t1 = self.clock()
            stack.pop()
            sp = Span(name=name, t_start=float(t0), t_end=float(t1),
                      depth=depth, parent=parent,
                      thread=threading.current_thread().name,
                      attrs=dict(attrs))
            with self._lock:
                self.spans.append(sp)
            if self.registry is not None:
                self.registry.record_span(sp)


# The process-wide installed recorder. Library call sites are always-on
# cheap: `span()` reads this once and yields immediately when None.
_installed: SpanRecorder | None = None
_install_lock = threading.Lock()


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
              clock: Callable[[], float] = perf_clock
              ) -> Iterator[SpanRecorder]:
    """Install a fresh recorder for the scope, restore the prior one
    after — the harness-side entry point."""
    rec = SpanRecorder(clock=clock, registry=registry)
    with _install_lock:
        global _installed
        prev, _installed = _installed, rec
    try:
        yield rec
    finally:
        with _install_lock:
            _installed = prev


@contextlib.contextmanager
def span(name: str, **attrs: Any) -> Iterator[None]:
    """Library-side span: records into the installed recorder, no-op
    when none is installed."""
    rec = _installed
    if rec is None:
        yield
        return
    with rec.span(name, **attrs):
        yield
