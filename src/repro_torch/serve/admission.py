"""Shared admission / batching / latency machinery for the serving tier.

The DeKRR query tier (`repro_torch.serve.dekrr`) serves a stream of
variably-sized requests through fixed-size compute waves. This module is
the engine-agnostic part of that shape (the port's counterpart of the
reference's `repro.serve.admission`):

  * `AdmissionQueue` — a thread-safe FIFO of admitted requests, each
    carrying a *width* (query columns for DeKRR, 1 for LLM slots) and
    its admission timestamp. `take_wave(max_slots, max_columns)` pops
    the next wave under both budgets, so one queue serves slot-bounded
    engines (width ≡ 1) and column-bounded ones (DeKRR: a [d, m] block
    consumes m columns).
  * `pad_bucket` — the power-of-two padding buckets a wave's column
    count is rounded up to, so variable-width query streams run the
    featurize kernel at O(log(max wave width)) distinct shapes.
  * `LatencyRecorder` / `LatencyReport` — per-request latency accounting
    with p50/p99 percentiles, not just aggregate qps. The clock is
    injectable so a seeded load trace produces bit-identical reports.
    Both live in `repro_torch.obs.metrics` and are re-exported here.

Thread-safety contract: `AdmissionQueue` and `LatencyRecorder` may be
driven from any number of submitter and replica threads; every public
method holds the instance lock for its whole critical section. Waves are
FIFO in admission order (a replica never reorders past another request —
width bucketing pads, it does not reshuffle).
"""
from __future__ import annotations

import dataclasses
import threading
from typing import Any

from repro_torch.obs.metrics import LatencyRecorder, LatencyReport

__all__ = [
    "Admitted",
    "AdmissionQueue",
    "LatencyRecorder",
    "LatencyReport",
    "pad_bucket",
]


def pad_bucket(n: int, *, min_bucket: int = 8) -> int:
    """Smallest power-of-two ≥ max(n, min_bucket) — the padded column
    count a wave of n live query columns is staged at."""
    n = int(n)
    if n < 0:
        raise ValueError(f"bucket size must be >= 0, got {n}")
    floor = max(int(min_bucket), 1)
    return max(floor, 1 << (max(n, 1) - 1).bit_length())


@dataclasses.dataclass
class Admitted:
    """One queue entry: the engine-specific request plus the admission
    metadata the wave scheduler and latency accounting need."""

    item: Any
    uid: int
    width: int
    t_arrival: float


class AdmissionQueue:
    """Thread-safe FIFO admission queue with slot- and column-budgeted
    wave formation."""

    def __init__(self):
        self._lock = threading.Lock()
        self._entries: list[Admitted] = []

    def admit(self, item: Any, *, uid: int, width: int,
              now: float) -> Admitted:
        """Enqueue one request of `width` columns admitted at time
        `now`; returns its queue entry."""
        if int(width) < 1:
            raise ValueError(
                f"request {uid}: width must be >= 1, got {width}")
        entry = Admitted(item=item, uid=int(uid), width=int(width),
                         t_arrival=float(now))
        with self._lock:
            self._entries.append(entry)
        return entry

    def take_wave(self, max_slots: int,
                  max_columns: int | None = None) -> list[Admitted]:
        """Pop the next wave: up to `max_slots` requests, in FIFO order,
        whose total width stays within `max_columns` (None = unbounded).
        A head-of-line request wider than `max_columns` is returned alone
        (it can never co-batch, but it must not deadlock the queue).
        Returns [] when the queue is empty."""
        if max_slots < 1:
            raise ValueError(f"max_slots must be >= 1, got {max_slots}")
        with self._lock:
            wave: list[Admitted] = []
            cols = 0
            while self._entries and len(wave) < max_slots:
                nxt = self._entries[0]
                if (wave and max_columns is not None
                        and cols + nxt.width > max_columns):
                    break
                wave.append(self._entries.pop(0))
                cols += nxt.width
            return wave

    def __len__(self) -> int:
        with self._lock:
            return len(self._entries)

    @property
    def pending_columns(self) -> int:
        with self._lock:
            return sum(e.width for e in self._entries)
