"""Convergence-trace container returned by `solve_batched(return_trace=True)`.

``residuals[r]`` is ``max|θ_{r+1} − θ_r|`` over every coordinate of round
``r`` (0-based); padded coordinates are identically zero on both sides.
On ``tol > 0`` solves the trace keeps length ``num_iters`` and rounds
after the stop record 0, so the series does not depend on
``chunk_rounds``.
"""
from __future__ import annotations

from typing import Any, NamedTuple

__all__ = ["SolveTrace"]


class SolveTrace(NamedTuple):
    """Synchronous-solver trace: per-round max|Δθ|, shape [R]."""

    residuals: Any

    def as_lists(self) -> dict[str, list[float]]:
        return {"residuals": [float(v) for v in self.residuals]}
