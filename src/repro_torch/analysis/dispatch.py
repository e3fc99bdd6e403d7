"""The dispatch pass: the solvers' kernel dispatches against their contract.

The port's counterpart of the reference's J002 (`repro.analysis.
jaxpr_lint`): each solver entry point runs on a tiny synthetic packed
problem on the CPU (the kernels' plain versions), its dispatches are
counted by `repro_torch.obs.dispatch.dispatch_count`, and a count off the
documented `round_dispatches` contract is a J002 finding. The numerics
are irrelevant here; only shapes and the slot layout are real.
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
    return findings
