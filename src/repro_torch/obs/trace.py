"""Convergence-trace containers returned by the solvers' ``return_trace=``.

``residuals[r]`` is ``max|θ_{r+1} − θ_r|`` over every coordinate of round
``r`` (0-based); padded coordinates are identically zero on both sides.
On ``tol > 0`` solves the trace keeps length ``num_iters`` and rounds
after the stop record 0, so the series does not depend on
``chunk_rounds``. The asynchronous trace adds the per-round wire series;
summing them gives `repro_torch.dist.AsyncGossipStats` exactly.
"""
from __future__ import annotations

from typing import Any, NamedTuple

__all__ = ["AsyncSolveTrace", "SolveTrace"]


class SolveTrace(NamedTuple):
    """Synchronous-solver trace: per-round max|Δθ|, shape [R]."""

    residuals: Any

    def as_lists(self) -> dict[str, list[float]]:
        return {"residuals": [float(v) for v in self.residuals]}


class AsyncSolveTrace(NamedTuple):
    """Asynchronous-gossip trace, all fields shape [R].

    ``active``: scheduled transmitters this round (activated nodes, or the
    2 endpoints under edge gossip). ``broadcasts``: transmissions that
    survived censoring. ``deliveries``: neighbour receipts (one per
    receiving directed edge). ``bytes``: wire bytes this round,
    D_max × Dy × itemsize per broadcast.
    """

    residuals: Any
    active: Any
    broadcasts: Any
    deliveries: Any
    bytes: Any

    def censored_fraction(self):
        """Per-round fraction of scheduled transmissions suppressed by
        the censor threshold (0 where nothing was scheduled), in float64;
        works on tensors, numpy arrays and lists."""
        act, bc = self.active, self.broadcasts
        if isinstance(act, (list, tuple)):
            import numpy as np

            act, bc = np.asarray(act), np.asarray(bc)
        else:
            act, bc = act.double(), bc.double()
        denom = act * (act > 0) + (act <= 0)
        return (act - bc) / denom

    def as_lists(self) -> dict[str, list[float]]:
        return {
            "residuals": [float(v) for v in self.residuals],
            "active": [int(v) for v in self.active],
            "broadcasts": [int(v) for v in self.broadcasts],
            "deliveries": [int(v) for v in self.deliveries],
            "bytes": [int(v) for v in self.bytes],
        }
