"""Dispatch accounting: kernel dispatches of a program, counted as it runs.

The port's counterpart of the reference's `repro.obs.dispatch`. The
reference traces a program to a jaxpr (nothing runs) and counts its
`pallas_call` equations. PyTorch has no trace-only counterpart of
`jax.make_jaxpr`, so here `dispatch_count(fn, *args, **kwargs)` RUNS
``fn`` and counts the calls in which a `repro_torch.kernels.ops` wrapper
ran its kernel on CUDA, or its plain version on the CPU
(`ops.DISPATCHES`). A CPU run is thus held to the same contract as the
card, where each dispatch is also one launch (`ops.LAUNCHES`).

The count is exact by construction: it is read from the program's own
run, not bounded from a trace, so a dispatch under a data-dependent loop
(a tol stop) is counted as often as it ran. The returned ``exact`` is
therefore always True; it stays in the signature so callers of the
reference's hook read the port's the same way. The count covers every
dispatch the process makes while ``fn`` runs, so run it where no other
thread dispatches kernels.

CUDA-graph replays are not counted yet: a replay launches the captured
kernels without calling the wrappers (ROADMAP queue 1 item 8, host
dispatch, must count them before it graph-captures a path).

The contract of the solvers (`round_dispatches`, as the reference's
J002 pins it): with tol = 0, ``torch`` 0 (no kernel), ``cuda`` R (one
round kernel a round), ``cuda_fused`` ⌈R / chunk_rounds⌉ (one chain
launch per chunk; one for the whole schedule by default). It holds for
`solve_batched`, `async_solve_batched` and `chebyshev_solve_packed`,
with or without their traces and stats, at every output width Dy.
"""
from __future__ import annotations

from typing import Any, Callable

__all__ = ["dispatch_count", "round_dispatches"]


def round_dispatches(backend: str, rounds: int, *,
                     chunk_rounds: int | None = None) -> int:
    """Kernel dispatches of an R-round solve at tol = 0 on ``backend``:
    torch 0, cuda R, cuda_fused ⌈R / chunk_rounds⌉ (chunk_rounds None:
    one launch for all R rounds; none for R = 0)."""
    if backend == "torch" or rounds == 0:
        return 0
    if backend == "cuda":
        return rounds
    if backend == "cuda_fused":
        return -(-rounds // (chunk_rounds or rounds))
    raise ValueError(f"backend must be one of ('torch', 'cuda', "
                     f"'cuda_fused'), got {backend!r}")


def dispatch_count(fn: Callable, *args: Any,
                   **kwargs: Any) -> tuple[int, bool]:
    """Run ``fn(*args, **kwargs)`` and return ``(kernel dispatches,
    exact)``: the calls in which an ops wrapper ran its kernel or its plain
    version meanwhile, and True (see the module docstring)."""
    from repro_torch.kernels import ops

    before = ops.dispatch_counts()
    fn(*args, **kwargs)
    after = ops.dispatch_counts()
    return sum(after[k] - before[k] for k in after), True
