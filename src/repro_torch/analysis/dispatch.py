"""The dispatch pass: the solvers' kernel dispatches against their contract.

The port's counterpart of the reference's J002 (`repro.analysis.
jaxpr_lint`): each solver entry point runs on a tiny synthetic packed
problem on the CPU (the kernels' plain versions), its dispatches are
counted by `repro_torch.obs.dispatch.dispatch_count`, and a count off the
documented `round_dispatches` contract is a J002 finding. The numerics
are irrelevant here; only shapes and the slot layout are real.

The SPMD solvers (`make_spmd_solver`, `make_async_spmd_solver`) run on
`SPMD_NODES` CPU ranks started by `repro_torch.dist.ranks.run_ranks`, one
launch for all of them, and each rank's dispatches are held to the
contract: rounds never fuse across the per-round exchange, so ``cuda``
and ``cuda_fused`` make R dispatches on every rank and ``torch`` none.
"""
from __future__ import annotations

import dataclasses
from typing import Callable

import numpy as np
import torch

from repro_torch.analysis.report import Finding
from repro_torch.obs.dispatch import dispatch_count, round_dispatches

ROUNDS = 5
BACKENDS = ("torch", "cuda", "cuda_fused")
SPMD_NODES = 4
SPMD_TIMEOUT = 120.0


@dataclasses.dataclass
class EntryPoint:
    """One solver program: `run()` runs it once; `expected_dispatches`
    pins its contract."""
    label: str
    run: Callable[[], object]
    expected_dispatches: int


def synthetic_packed(j_nodes: int = 4, d_feat: int = 8, dy: int = 1,
                     device: str = "cpu"):
    """Tiny circulant(J, (1,)) `PackedProblem` from seeded random tensors
    (blocks scaled by 1/D so the iterates stay bounded), float64; ``dy >
    1`` builds the multi-output layout."""
    from repro_torch.dist.dekrr_spmd import (PackedProblem,
                                             _circulant_slot_table)

    rng = np.random.default_rng(0)
    offsets = (1,)
    nbr_idx = _circulant_slot_table(offsets, j_nodes)
    k_slots = nbr_idx.shape[1]
    kw = dict(dtype=torch.float64, device=device)

    def rand(*shape, scale=1.0):
        return torch.as_tensor(rng.standard_normal(shape) * scale, **kw)

    d_shape = (j_nodes, d_feat) if dy == 1 else (j_nodes, d_feat, dy)
    return PackedProblem(
        g=rand(j_nodes, d_feat, d_feat, scale=1.0 / d_feat),
        d=rand(*d_shape),
        s=rand(j_nodes, d_feat, d_feat, scale=1.0 / d_feat),
        p=rand(j_nodes, k_slots, d_feat, d_feat, scale=1.0 / d_feat),
        theta_mask=torch.ones((j_nodes, d_feat), **kw),
        nbr_idx=torch.as_tensor(nbr_idx, device=device),
        nbr_mask=torch.ones((j_nodes, k_slots), **kw),
        offsets=offsets, node_dims=(d_feat,) * j_nodes,
        num_edges_directed=j_nodes * k_slots)


def entry_points(rounds: int = ROUNDS) -> list[EntryPoint]:
    """`solve_batched`, `async_solve_batched` and `chebyshev_solve_packed`
    on every backend at tol = 0, with and without traces or stats, at
    Dy = 1 and 3, the fused solves also in chunks of 2, and the ops
    wrappers `dekrr_step` / `dekrr_solve` (one dispatch each)."""
    from repro_torch.core import AsyncGossipConfig, activation_masks
    from repro_torch.core.acceleration import chebyshev_solve_packed
    from repro_torch.dist import async_solve_batched, solve_batched
    from repro_torch.kernels import ops

    packed, packed_dy = synthetic_packed(), synthetic_packed(dy=3)
    gen = torch.Generator().manual_seed(0)
    masks = activation_masks(gen, rounds, packed.num_nodes, prob=0.5)
    config = AsyncGossipConfig(prob=0.5, censor_tau=2e-2, censor_decay=0.9)
    eps = []
    for b in BACKENDS:
        want = round_dispatches(b, rounds)
        for tag, pk, kw in (("", packed, {}),
                            (",trace", packed, {"return_trace": True}),
                            (",dy=3", packed_dy, {})):
            eps.append(EntryPoint(
                f"solve_batched[backend={b},tol=0{tag}]",
                lambda pk=pk, b=b, kw=kw: solve_batched(
                    pk, rounds, backend=b, **kw), want))
            eps.append(EntryPoint(
                f"chebyshev_solve_packed[backend={b}{tag}]",
                lambda pk=pk, b=b, kw=kw: chebyshev_solve_packed(
                    pk, 0.9, 0.0, num_iters=rounds, backend=b, **kw),
                want))
        for tag, pk, kw in (("", packed, {}),
                            (",trace", packed, {"return_trace": True}),
                            (",stats", packed, {"return_stats": True}),
                            (",dy=3", packed_dy, {})):
            eps.append(EntryPoint(
                f"async_solve_batched[backend={b},tol=0{tag}]",
                lambda pk=pk, b=b, kw=kw: async_solve_batched(
                    pk, rounds, masks, config=config, backend=b, **kw),
                want))
    chunked = round_dispatches("cuda_fused", rounds, chunk_rounds=2)
    eps.append(EntryPoint(
        "solve_batched[backend=cuda_fused,tol=0,chunk_rounds=2]",
        lambda: solve_batched(packed, rounds, backend="cuda_fused",
                              chunk_rounds=2), chunked))
    eps.append(EntryPoint(
        "async_solve_batched[backend=cuda_fused,tol=0,chunk_rounds=2]",
        lambda: async_solve_batched(packed, rounds, masks, config=config,
                                    backend="cuda_fused", chunk_rounds=2),
        chunked))
    eps.append(EntryPoint(
        "chebyshev_solve_packed[backend=cuda_fused,chunk_rounds=2]",
        lambda: chebyshev_solve_packed(packed, 0.9, 0.0, num_iters=rounds,
                                       backend="cuda_fused",
                                       chunk_rounds=2), chunked))
    self_idx = torch.arange(packed.num_nodes, dtype=torch.int32)
    eps.append(EntryPoint(
        "ops.dekrr_step",
        lambda: ops.dekrr_step(packed.g, packed.d, packed.s, packed.p,
                               packed.d * 0, packed.nbr_idx, self_idx,
                               packed.nbr_mask), 1))
    eps.append(EntryPoint(
        "ops.dekrr_solve",
        lambda: ops.dekrr_solve(packed.g, packed.d, packed.s, packed.p,
                                packed.d * 0, packed.nbr_idx, self_idx,
                                packed.nbr_mask, num_rounds=rounds), 1))
    return eps


def spmd_entry_points(rounds: int = ROUNDS) -> list[dict]:
    """`spmd_cases.solve_cases` cases: both SPMD solvers on every mode and
    backend at tol = 0, with and without a trace, each with the per-rank
    dispatches its contract pins (``"expected"``)."""
    from repro_torch.core import AsyncGossipConfig, activation_masks

    gen = torch.Generator().manual_seed(0)
    masks = activation_masks(gen, rounds, SPMD_NODES, prob=0.5)
    config = AsyncGossipConfig(prob=0.5, censor_tau=2e-2, censor_decay=0.9)
    cases = []
    for solver, name in (("sync", "make_spmd_solver"),
                         ("async", "make_async_spmd_solver")):
        for mode in ("ppermute", "allgather"):
            for b in BACKENDS:
                for trace in (False, True):
                    kw = {"return_trace": trace}
                    if solver == "async":
                        kw.update(masks=masks, config=config)
                    cases.append(dict(
                        name=f"{name}[mode={mode},backend={b},tol=0"
                             f"{',trace' if trace else ''}]",
                        solver=solver, mode=mode, backend=b,
                        num_iters=rounds, kw=kw,
                        expected=round_dispatches(
                            "torch" if b == "torch" else "cuda", rounds)))
    return cases


def check_spmd_results(cases: list[dict],
                       per_rank: list[list[dict]]) -> list[Finding]:
    """J002 for every case where some rank's dispatches are off its pin
    (or the case raised)."""
    findings = []
    for i, case in enumerate(cases):
        counts = [rank[i].get("dispatches") for rank in per_rank]
        if all(c == case["expected"] for c in counts):
            continue
        findings.append(Finding(
            "dispatch", "J002", case["name"],
            f"the ranks ran {counts} kernel dispatch(es) but the "
            f"round_dispatches contract documents {case['expected']} on "
            f"each rank"))
    return findings


def run_spmd_pass(rounds: int = ROUNDS) -> list[Finding]:
    """The SPMD entry points on `SPMD_NODES` CPU ranks, one launch."""
    from repro_torch.dist.ranks import run_ranks
    from repro_torch.dist.spmd_cases import solve_cases

    cases = spmd_entry_points(rounds)
    per_rank = run_ranks(solve_cases, SPMD_NODES, timeout=SPMD_TIMEOUT,
                         args=(synthetic_packed(SPMD_NODES), cases, "cpu"))
    return check_spmd_results(cases, per_rank)


def check_entry_point(ep: EntryPoint) -> list[Finding]:
    count, exact = dispatch_count(ep.run)
    if exact and count == ep.expected_dispatches:
        return []
    return [Finding(
        "dispatch", "J002", ep.label,
        f"{count} kernel dispatch(es) ran but the round_dispatches "
        f"contract documents {ep.expected_dispatches}")]


def run_pass(rounds: int = ROUNDS) -> list[Finding]:
    findings = []
    for ep in entry_points(rounds):
        findings += check_entry_point(ep)
    return findings + run_spmd_pass(rounds)
