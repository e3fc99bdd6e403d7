"""Multi-round Eq. 19 chains in one launch — CUDA kernels and their plain
versions: the synchronous solve, the asynchronous-gossip chain and the
Chebyshev chain.

Replaces `src/repro/kernels/dekrr_solve.py::dekrr_solve_pallas`
(`_dekrr_solve_kernel`). Same raw contract as
`repro_torch.kernels.dekrr_step` plus R ≥ 1 rounds: two θ tables (round
parity), both seeded from θ0, so table rows owned by no node stay at θ0;
returns the node rows after the last round and, with ``trace``,
res [R, J] = max|Δθ_j| per round from the same launch. self_idx rows must
be distinct.

The Pallas kernel relies on its (R, J) grid running in order. The CUDA
kernel (`csrc/dekrr_solve.cu`) is one persistent cooperative launch
instead: every node is a thread-block cluster running the round kernel's
node body, clusters loop over nodes past the ones the card holds at once,
and a grid-wide barrier separates the rounds. `chain_plan` sizes it. Its
rows are the round kernel's, so R rounds in one launch equal R round
launches bit for bit.

The asynchronous-gossip chain (`dekrr_async_solve_*`, replacing
`dekrr_async_solve_pallas` / `_dekrr_async_solve_kernel`,
`csrc/dekrr_async_solve.cu`) and the Chebyshev chain
(`dekrr_cheb_solve_*`, replacing `dekrr_cheb_solve_pallas` /
`_dekrr_cheb_solve_kernel`, `csrc/dekrr_cheb_solve.cu`) are built the
same way. Their raw contracts are in the plain versions' docstrings.
"""
from __future__ import annotations

import functools
from typing import Callable

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.dekrr_step import (dekrr_step_masked_reference,
                                            dekrr_step_reference, round_plan)


def dekrr_solve_reference(g, d, s, p, theta, nbr_idx, self_idx, nbr_mask,
                          *, num_rounds: int, dy: int = 1,
                          trace: bool = False):
    """Plain version: the round's plain version scanned R times, each
    round's rows scattered back into the table at self_idx."""
    j_nodes, d_feat = p.shape[0], d.shape[1]
    table = theta.reshape(-1, dy, d_feat).clone()
    rows = self_idx.long()
    res = []
    for _ in range(num_rounds):
        new = dekrr_step_reference(g, d, s, p, table.reshape(-1, d_feat),
                                   nbr_idx, self_idx, nbr_mask, dy=dy)
        new = new.reshape(j_nodes, dy, d_feat)
        if trace:
            res.append(torch.amax(torch.abs(new - table[rows]), dim=(1, 2)))
        table[rows] = new
    out = table[rows].reshape(j_nodes * dy, d_feat)
    if not trace:
        return out
    if res:
        return out, torch.stack(res)
    return out, torch.zeros((0, j_nodes), dtype=theta.dtype,
                            device=theta.device)


def chain_plan(j_nodes: int, d_feat: int,
               max_clusters: Callable[[int], int]) -> tuple[int, int, int]:
    """(blocks per node cluster C, rows per block, clusters) of a chain
    kernel's persistent launch: grid (C, clusters), cluster q running
    nodes q, q + clusters, ... (`csrc/dekrr_solve.cu`,
    `csrc/dekrr_async_solve.cu`, `csrc/dekrr_cheb_solve.cu`).

    C and the rows per block are the round kernel's (`round_plan`), so a
    node's rows split as one round launch splits them. ``max_clusters(C)``
    is the number of clusters of C blocks the card holds at once (the
    kernels' ``*_max_clusters_*`` exports, `chain_max_clusters`); the
    launch takes min(J, that). Only where not even one cluster of C blocks
    fits does C shrink, each block then forming more rows."""
    blocks, rows = round_plan(d_feat)
    cap = max_clusters(blocks)
    while cap < 1 and blocks > 1:
        rows = -(-max(1, d_feat) // (blocks - 1))
        blocks = -(-max(1, d_feat) // rows)
        cap = max_clusters(blocks)
    if cap < 1:
        raise RuntimeError(
            f"no thread-block cluster of the chain kernel fits on this "
            f"device at D={d_feat} (shared memory or cooperative-launch "
            f"support)")
    return blocks, rows, min(j_nodes, cap)


def chain_max_clusters(name: str, k_slots: int, d_feat: int, dy: int,
                       dtype: torch.dtype) -> Callable[[int], int]:
    """Clusters of C blocks of the kernel of ``csrc/<name>.cu`` that the
    current device holds at once at (K, D, Dy), as a function of C."""
    device = torch.cuda.current_device()
    return lambda blocks: _max_clusters(name, k_slots, d_feat, dy,
                                        _suffix(dtype), blocks, device)


@functools.lru_cache(maxsize=None)
def _max_clusters(name: str, k_slots: int, d_feat: int, dy: int,
                  suffix: str, blocks: int, device: int) -> int:
    fn = getattr(_build.library(name), f"{name}_max_clusters_{suffix}")
    cap = fn(k_slots, d_feat, dy, blocks)
    if cap < 0:
        _build.check(-cap, f"{name} occupancy query")
    return cap


def _suffix(dtype: torch.dtype) -> str:
    return "f64" if dtype == torch.float64 else "f32"


def _ptr(t: torch.Tensor | None):
    return None if t is None else t.data_ptr()


def dekrr_solve_cuda(g, d, s, p, theta, nbr_idx, self_idx, nbr_mask, out,
                     res, work, *, num_rounds: int, dy: int) -> None:
    """Launch the kernel on checked, contiguous CUDA tensors: out
    [J·Dy, D], res [R, J] or None, work 2·[T·Dy, D] scratch; sized by
    `chain_plan` for the current device."""
    j_nodes, k_slots, d_feat = p.shape[0], p.shape[1], d.shape[1]
    t_rows = theta.shape[0] // dy
    plan = chain_plan(j_nodes, d_feat, chain_max_clusters(
        "dekrr_solve", k_slots, d_feat, dy, g.dtype))
    fn = getattr(_build.library("dekrr_solve"),
                 f"dekrr_solve_{_suffix(g.dtype)}")
    stream = torch.cuda.current_stream(g.device).cuda_stream
    _build.check(fn(g.data_ptr(), d.data_ptr(), s.data_ptr(), p.data_ptr(),
                    theta.data_ptr(), nbr_idx.data_ptr(),
                    self_idx.data_ptr(), nbr_mask.data_ptr(), out.data_ptr(),
                    _ptr(res), work.data_ptr(), num_rounds, j_nodes, k_slots,
                    d_feat, dy, t_rows, *plan, stream),
                 "dekrr_solve launch")


# --------------------------------------------------------------- async chain
def dekrr_async_solve_reference(g, d, s, p, theta, sent, buffers, nbr_idx,
                                nbr_mask, active, thresholds, *,
                                censored: bool, edge_gossip: bool,
                                dy: int = 1, trace: bool = False):
    """Plain version of the asynchronous-gossip chain, raw contract:

    g/s [J, D, D], d [J·Dy, D], p [J, K, D, D] (K ≥ 1); theta/sent
    [T·Dy, D] with T ≥ J (node j at row block j); buffers [B·Dy, D] with
    B ≥ J·K (slot (j, k) at row block j·K + k); nbr_idx [J, K] NODE ids
    and nbr_mask [J, K] int32; active [R, J] int32; thresholds [R] (read
    only when ``censored``).

    Round r: active nodes run the masked round on the [θ; buffers] table
    (neighbour rows from their buffers), censored mode broadcasts iff
    max|new − sent| > thr[r] over the node's [Dy, D] block, and the round's
    broadcasts are delivered (edge gossip: only to active receivers).
    Returns (θ rows [J·Dy, D], sent rows [J·Dy, D], buffer rows
    [J·K·Dy, D]); with ``trace`` also (res, bc) [R + 1, J] — max|new − θ|
    and the broadcast flag per node and round, the last row (the kernel's
    delivery flush) zero.
    """
    j_nodes, k_slots, d_feat = p.shape[0], p.shape[1], d.shape[1]
    rows = j_nodes * dy
    dev = theta.device
    tab = theta.clone()
    sent3 = sent[:rows].reshape(j_nodes, dy, d_feat).clone()
    buf = buffers[:j_nodes * k_slots * dy].clone()
    self_idx = torch.arange(j_nodes, dtype=torch.int32, device=dev)
    buf_idx = (tab.shape[0] // dy + torch.arange(
        j_nodes * k_slots, dtype=torch.int32, device=dev)).reshape(
            j_nodes, k_slots)
    live = nbr_mask != 0
    nbr = torch.where(live, nbr_idx, 0).long()    # masked slots: any index
    res, bcs = [], []
    for r in range(active.shape[0]):
        act = active[r] != 0
        new = dekrr_step_masked_reference(
            g, d, s, p, torch.cat([tab, buf]), buf_idx, self_idx, nbr_mask,
            active[r], dy=dy)
        new3 = new.reshape(j_nodes, dy, d_feat)
        if censored:
            delta = torch.amax(torch.abs(new3 - sent3), dim=(1, 2))
            bc = act & (delta > thresholds[r])
        else:
            bc = act
        if trace:
            own3 = tab[:rows].reshape(j_nodes, dy, d_feat)
            res.append(torch.amax(torch.abs(new3 - own3), dim=(1, 2)))
            bcs.append(bc.to(torch.int32))
        sent3 = torch.where(bc[:, None, None], new3, sent3)
        tab[:rows] = new
        recv = live & bc[nbr]
        if edge_gossip:
            recv = recv & act[:, None]
        buf3 = buf.reshape(j_nodes, k_slots, dy, d_feat)
        buf = torch.where(recv[..., None, None], new3[nbr], buf3).reshape(
            -1, d_feat)
    out = (tab[:rows].clone(), sent3.reshape(rows, d_feat), buf)
    if not trace:
        return out
    res.append(theta.new_zeros((j_nodes,)))
    bcs.append(torch.zeros((j_nodes,), dtype=torch.int32, device=dev))
    return out + (torch.stack(res), torch.stack(bcs))


def dekrr_async_solve_cuda(g, d, s, p, theta, sent, buffers, nbr_idx,
                           nbr_mask, active, thresholds, out_theta, out_sent,
                           out_buf, res, bc, work, flags, *, censored: bool,
                           edge_gossip: bool, dy: int) -> None:
    """Launch the kernel on checked, contiguous CUDA tensors (the plain
    version's raw contract): out_theta/out_sent [J·Dy, D], out_buf
    [J·K·Dy, D], res/bc [R + 1, J] or both None, work 2·[T·Dy, D] and
    flags [2·J] int32 scratch; sized by `chain_plan`."""
    j_nodes, k_slots, d_feat = p.shape[0], p.shape[1], d.shape[1]
    t_rows = theta.shape[0] // dy
    plan = chain_plan(j_nodes, d_feat, chain_max_clusters(
        "dekrr_async_solve", k_slots, d_feat, dy, g.dtype))
    fn = getattr(_build.library("dekrr_async_solve"),
                 f"dekrr_async_solve_{_suffix(g.dtype)}")
    stream = torch.cuda.current_stream(g.device).cuda_stream
    _build.check(fn(g.data_ptr(), d.data_ptr(), s.data_ptr(), p.data_ptr(),
                    theta.data_ptr(), sent.data_ptr(), buffers.data_ptr(),
                    nbr_idx.data_ptr(), nbr_mask.data_ptr(),
                    active.data_ptr(), thresholds.data_ptr(),
                    out_theta.data_ptr(), out_sent.data_ptr(),
                    out_buf.data_ptr(), _ptr(res), _ptr(bc),
                    work.data_ptr(), flags.data_ptr(), active.shape[0],
                    j_nodes, k_slots, d_feat, dy, t_rows, int(censored),
                    int(edge_gossip), *plan, stream),
                 "dekrr_async_solve launch")


# ----------------------------------------------------------- Chebyshev chain
def dekrr_cheb_solve_reference(g, d, s, p, theta, delta, nbr_idx, self_idx,
                               nbr_mask, alphas, betas, *, dy: int = 1,
                               trace: bool = False):
    """Plain version of the Chebyshev chain, raw contract: the operands of
    `dekrr_solve_reference` plus delta [J'·Dy, D] (J' ≥ J; node j's search
    direction p at row block j) and the [R] (α, β) schedule. Per round:
    new = F(θ); p ← (new − θ_self) + β_r p; θ_self ← θ_self + α_r p.
    Returns (θ rows [J·Dy, D], p rows [J·Dy, D]); with ``trace`` also
    res [R, J] = max|θ_new − θ_self| per node and round."""
    j_nodes, d_feat = p.shape[0], d.shape[1]
    table = theta.reshape(-1, dy, d_feat).clone()
    rows = self_idx.long()
    pdir = delta[:j_nodes * dy].reshape(j_nodes, dy, d_feat).clone()
    res = []
    for r in range(alphas.shape[0]):
        new = dekrr_step_reference(g, d, s, p, table.reshape(-1, d_feat),
                                   nbr_idx, self_idx, nbr_mask, dy=dy)
        own = table[rows]
        pdir = (new.reshape(j_nodes, dy, d_feat) - own) + betas[r] * pdir
        th = own + alphas[r] * pdir
        if trace:
            res.append(torch.amax(torch.abs(th - own), dim=(1, 2)))
        table[rows] = th
    out = (table[rows].reshape(j_nodes * dy, d_feat),
           pdir.reshape(j_nodes * dy, d_feat))
    if not trace:
        return out
    res = torch.stack(res) if res else theta.new_zeros((0, j_nodes))
    return out + (res,)


def dekrr_cheb_solve_cuda(g, d, s, p, theta, delta, nbr_idx, self_idx,
                          nbr_mask, alphas, betas, out_theta, out_p, res,
                          work, *, dy: int) -> None:
    """Launch the kernel on checked, contiguous CUDA tensors: out_theta /
    out_p [J·Dy, D], res [R, J] or None, work 2·[T·Dy, D] scratch; sized
    by `chain_plan`."""
    j_nodes, k_slots, d_feat = p.shape[0], p.shape[1], d.shape[1]
    t_rows = theta.shape[0] // dy
    plan = chain_plan(j_nodes, d_feat, chain_max_clusters(
        "dekrr_cheb_solve", k_slots, d_feat, dy, g.dtype))
    fn = getattr(_build.library("dekrr_cheb_solve"),
                 f"dekrr_cheb_solve_{_suffix(g.dtype)}")
    stream = torch.cuda.current_stream(g.device).cuda_stream
    _build.check(fn(g.data_ptr(), d.data_ptr(), s.data_ptr(), p.data_ptr(),
                    theta.data_ptr(), delta.data_ptr(), nbr_idx.data_ptr(),
                    self_idx.data_ptr(), nbr_mask.data_ptr(),
                    alphas.data_ptr(), betas.data_ptr(),
                    out_theta.data_ptr(), out_p.data_ptr(), _ptr(res),
                    work.data_ptr(), alphas.shape[0], j_nodes, k_slots,
                    d_feat, dy, t_rows, *plan, stream),
                 "dekrr_cheb_solve launch")
