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
instead, on one of two routes that `solve_plan` picks and names:

- **resident**: one thread-block cluster per node, each block holding its
  rows of the node's S, live P and G on chip (shared memory and
  registers) for the whole launch, and the nodes' progress counters in
  place of a grid barrier: a node waits each round only on the nodes it
  reads and the nodes that read it (`wait_sets`). `resident_plan` sizes
  it where the operands fit on chip and R ≥ RESIDENT_MIN_ROUNDS.
- **streamed**: every node a cluster running the round kernel's node
  body, streaming the operands from L2 every round, clusters looping over
  nodes past the ones the card holds at once, a grid-wide barrier between
  the rounds; `chain_plan` sizes it. It runs where the resident route
  does not fit (J 40 at D 200, D past 256, many live slots) and for
  launches of one round (the stream path's), where both routes read every
  operand once and the resident route would only add its staging pass.

Both compute each row in the round kernel's order of operations, so R
rounds in one launch equal R round launches bit for bit on either route.

The asynchronous-gossip chain (`dekrr_async_solve_*`, replacing
`dekrr_async_solve_pallas` / `_dekrr_async_solve_kernel`,
`csrc/dekrr_async_solve.cu`) and the Chebyshev chain
(`dekrr_cheb_solve_*`, replacing `dekrr_cheb_solve_pallas` /
`_dekrr_cheb_solve_kernel`, `csrc/dekrr_cheb_solve.cu`) have the same two
routes (`async_plan`, `cheb_plan`); the Chebyshev chain's resident block
also holds its node's search-direction rows on chip. Their raw contracts
are in the plain versions' docstrings.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Callable

import numpy as np
import torch

from repro_torch.kernels import _build
from repro_torch.kernels.dekrr_step import (ROUND_CLUSTER,
                                            dekrr_step_masked_reference,
                                            dekrr_step_reference, round_plan)

# The resident route's limits (csrc/dekrr_common.cuh): a warp forms
# RESIDENT_ROWS_PER_WARP rows, a block at most RESIDENT_MAX_ROWS (512
# threads), a lane holds RESIDENT_LANE_COLS values of a G row (D ≤ 256
# with clusters of 8), a node has at most RESIDENT_MAX_LIVE live slots.
RESIDENT_ROWS_PER_WARP = 2
RESIDENT_MAX_ROWS = 32
RESIDENT_LANE_COLS = 8
RESIDENT_MAX_LIVE = 16
# Launches of fewer rounds take the streamed route: at R = 1 both routes
# read every operand from device memory once, and the resident route would
# add its staging pass and its counters for nothing.
RESIDENT_MIN_ROUNDS = 2
# Threads of a streamed block (csrc/dekrr_common.cuh's kClusterThreads).
STREAMED_THREADS = 1024
# [Dy, rows] blocks a resident block holds beside the operands: d's rows,
# and on the Chebyshev chain also its search direction p's.
RESIDENT_ROW_BLOCKS = {"dekrr_solve": 1, "dekrr_async_solve": 1,
                       "dekrr_cheb_solve": 2}

# The phases the `*_clocked` entry points mark, by (kernel, route), in
# order (csrc/dekrr_solve.cu, csrc/dekrr_async_solve.cu,
# csrc/dekrr_cheb_solve.cu: kStreamedPhases, kResidentPhases).
CHAIN_PHASES = {
    ("dekrr_solve", "streamed"): ("stage", "acc", "exchange", "out", "max",
                                  "grid barrier"),
    ("dekrr_solve", "resident"): ("wait", "stage", "acc", "exchange", "out",
                                  "publish"),
    ("dekrr_async_solve", "streamed"): ("delivery", "stage", "acc",
                                        "exchange", "out", "max",
                                        "sent and flags", "grid barrier"),
    ("dekrr_async_solve", "resident"): ("wait", "delivery", "stage", "acc",
                                        "exchange", "out", "max",
                                        "sent, flags and publish"),
    ("dekrr_cheb_solve", "streamed"): ("stage", "acc", "exchange", "out",
                                       "update", "max", "grid barrier"),
    ("dekrr_cheb_solve", "resident"): ("wait", "stage", "acc", "exchange",
                                       "out and update", "publish"),
}

# Launches by route, counted where each route launches (the route names
# of `solve_plan`'s, `async_plan`'s and `cheb_plan`'s plans).
ROUTE_LAUNCHES = {(name, route): 0
                  for name in ("dekrr_solve", "dekrr_async_solve",
                               "dekrr_cheb_solve")
                  for route in ("resident", "streamed")}


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


# ------------------------------------------------------------ the two routes
@dataclasses.dataclass(frozen=True)
class ChainPlan:
    """A chain launch: its route ("resident" or "streamed"), blocks per
    node cluster, rows per block (block c forms rows [c·rows, (c+1)·rows)
    ∩ [0, D)), clusters launched, threads a block and dynamic shared memory
    a block. On the resident route also the most live slots of a node
    (the shared-memory layout's L), each node's wait set and each slot's
    node (-1: no node, or a masked slot); on the streamed route `why`
    says why the resident route was not taken."""

    route: str
    blocks: int
    rows: int
    clusters: int
    threads: int
    smem_bytes: int
    live: int = 0
    waits: tuple[tuple[int, ...], ...] = ()
    slot_nodes: tuple[tuple[int, ...], ...] = ()
    why: str = ""

    def wait_table(self) -> np.ndarray:
        """[J, W] int32 wait sets, -1 padded (the kernels' `waits`)."""
        width = max((len(w) for w in self.waits), default=1)
        table = np.full((len(self.waits), width), -1, dtype=np.int32)
        for j, w in enumerate(self.waits):
            table[j, :len(w)] = w
        return table


def resident_threads(rows: int) -> int:
    """Threads of a resident block of ``rows`` rows: a warp per
    RESIDENT_ROWS_PER_WARP rows."""
    return 32 * -(-rows // RESIDENT_ROWS_PER_WARP)


def resident_smem_bytes(live: int, d_feat: int, dy: int, rows: int,
                        itemsize: int, row_blocks: int = 1) -> int:
    """Dynamic shared memory of a resident block (csrc/dekrr_common.cuh::
    resident_smem_elems): the S and live P rows [(1 + L), rows, D], the
    staged θ [(1 + L), Dy, D], acc [Dy, D] and ``row_blocks`` [Dy, rows]
    blocks of the block's own rows (`RESIDENT_ROW_BLOCKS`: d's, and the
    Chebyshev chain's p)."""
    return ((1 + live) * rows * d_feat + (1 + live) * dy * d_feat
            + dy * d_feat + row_blocks * dy * rows) * itemsize


def resident_shapes(d_feat: int, dy: int, live: int, itemsize: int,
                    limit: int, row_blocks: int = 1
                    ) -> list[tuple[int, int, int]]:
    """(blocks, rows, shared-memory bytes) of the resident layouts that
    fit ``limit`` bytes a block, most blocks first: at most ROUND_CLUSTER
    blocks a node and RESIDENT_MAX_ROWS rows a block, no block without
    rows. Fewer blocks mean more rows a block, so the list stops at the
    first that does not fit."""
    out = []
    if d_feat > RESIDENT_LANE_COLS * 32 or live > RESIDENT_MAX_LIVE:
        return out
    for blocks in range(ROUND_CLUSTER, 0, -1):
        rows = -(-d_feat // blocks)
        if rows > RESIDENT_MAX_ROWS:
            break
        if -(-d_feat // rows) != blocks:
            continue
        smem = resident_smem_bytes(live, d_feat, dy, rows, itemsize,
                                   row_blocks)
        if smem > limit:
            break
        out.append((blocks, rows, smem))
    return out


def wait_sets(slot_nodes) -> tuple[tuple[int, ...], ...]:
    """W(j) = {j} ∪ in(j) ∪ out(j) of each node, from its slots' nodes
    ([J, K], -1 for a slot that reads no node's rows): in(j) the nodes j
    reads, out(j) the nodes that read j. A resident chain's node waits on
    W(j) before each round: on in(j) for the rows it reads (read after
    write), on out(j) because it overwrites the parity table they read in
    the round before (write after read), on itself for its own rows, which
    all its blocks form. The slot table may be asymmetric."""
    nodes = np.asarray(slot_nodes, dtype=np.int64)
    sets = [{j} for j in range(nodes.shape[0])]
    for j, row in enumerate(nodes):
        for i in row[row >= 0]:
            sets[j].add(int(i))
            sets[int(i)].add(j)
    return tuple(tuple(sorted(w)) for w in sets)


def resident_plan(slot_nodes, live, d_feat: int, dy: int, itemsize: int,
                  rounds: int, max_clusters: Callable[[int, int, int], int],
                  limit: int, row_blocks: int = 1) -> ChainPlan | str:
    """The resident route's plan, or why it does not apply.

    slot_nodes [J, K]: the node whose rows each slot reads (-1: none, or a
    masked slot); live [J, K]: the live slots (a live slot of no node still
    holds its P block). ``max_clusters(blocks, threads, smem)`` is the
    number of such clusters the card holds at once (the kernels'
    ``*_resident_max_clusters_*`` exports): every node is one cluster and
    all are resident, so a layout is taken only where it is at least J.
    Of the layouts that fit (`resident_shapes`, ``row_blocks`` as there)
    the one with the most blocks a node that the card holds J of."""
    live = np.asarray(live, dtype=bool)
    j_nodes = live.shape[0]
    n_live = int(live.sum(axis=1).max(initial=0))
    if rounds < RESIDENT_MIN_ROUNDS:
        return (f"R = {rounds} below {RESIDENT_MIN_ROUNDS}: one round reads "
                f"every operand once on either route")
    shapes = resident_shapes(d_feat, dy, n_live, itemsize, limit,
                             row_blocks)
    if not shapes:
        return (f"the operands do not fit on chip: D {d_feat} (at most "
                f"{RESIDENT_LANE_COLS * 32}), {n_live} live slots (at most "
                f"{RESIDENT_MAX_LIVE}), Dy {dy}, {itemsize}-byte values "
                f"within {limit} bytes a block")
    for blocks, rows, smem in shapes:
        threads = resident_threads(rows)
        if max_clusters(blocks, threads, smem) >= j_nodes:
            return ChainPlan(
                "resident", blocks, rows, j_nodes, threads, smem, n_live,
                wait_sets(slot_nodes),
                tuple(tuple(int(v) for v in row)
                      for row in np.asarray(slot_nodes)))
    return (f"the card holds fewer than J = {j_nodes} clusters of "
            f"{shapes[0][0]} resident blocks ({shapes[0][2]} bytes each)")


def chain_route(name: str, slot_nodes, live, k_slots: int, d_feat: int,
                dy: int, dtype: torch.dtype, rounds: int) -> ChainPlan:
    """The plan of the chain kernel of ``csrc/<name>.cu`` on the current
    device: the resident route where `resident_plan` takes it, else the
    streamed route of `chain_plan`."""
    from repro_torch.analysis.smem import SMEM_LIMITS

    item = torch.finfo(dtype).bits // 8
    device = torch.cuda.current_device()
    plan = resident_plan(
        slot_nodes, live, d_feat, dy, item, rounds,
        lambda b, t, m: _resident_max_clusters(name, _suffix(dtype), b, t, m,
                                               device),
        SMEM_LIMITS[name], RESIDENT_ROW_BLOCKS[name])
    if isinstance(plan, ChainPlan):
        return plan
    return streamed_plan(name, len(live), k_slots, d_feat, dy, dtype,
                         why=plan)


def streamed_plan(name: str, j_nodes: int, k_slots: int, d_feat: int,
                  dy: int, dtype: torch.dtype, why: str = "") -> ChainPlan:
    """The streamed route's plan (`chain_plan`) on the current device."""
    blocks, rows, clusters = chain_plan(j_nodes, d_feat, chain_max_clusters(
        name, k_slots, d_feat, dy, dtype))
    item = torch.finfo(dtype).bits // 8
    return ChainPlan("streamed", blocks, rows, clusters, STREAMED_THREADS,
                     (k_slots + 2) * dy * d_feat * item, why=why)


@functools.lru_cache(maxsize=None)
def _resident_max_clusters(name: str, suffix: str, blocks: int, threads: int,
                           smem: int, device: int) -> int:
    fn = getattr(_build.library(name), f"{name}_resident_max_clusters_"
                 f"{suffix}")
    cap = fn(blocks, threads, smem)
    if cap < 0:
        _build.check(-cap, f"{name} resident occupancy query")
    return cap


def _host(t) -> np.ndarray:
    return t.detach().cpu().numpy() if isinstance(t, torch.Tensor) \
        else np.asarray(t)


def solve_plan(nbr_idx, self_idx, nbr_mask, *, d_feat: int, dy: int,
               dtype: torch.dtype, rounds: int,
               name: str = "dekrr_solve") -> ChainPlan:
    """`dekrr_solve`'s plan on the current device from its slot table
    (tensors or arrays: nbr_idx table rows, self_idx, nbr_mask): a live
    slot reads the node that owns its table row, or θ0's row where no node
    does. ``name`` "dekrr_cheb_solve" (`cheb_plan`) sizes the Chebyshev
    chain, which reads what this chain reads and writes only its own rows,
    so its slot nodes and wait sets are these; its resident block also
    holds its p rows (`RESIDENT_ROW_BLOCKS`)."""
    idx, own = _host(nbr_idx), _host(self_idx)
    live = _host(nbr_mask) != 0
    return _solve_plan(idx.astype(np.int64).tobytes(), idx.shape,
                       own.astype(np.int64).tobytes(), live.tobytes(),
                       d_feat, dy, dtype, rounds, torch.cuda.current_device(),
                       name)


def table_slot_nodes(nbr_idx, self_idx, live) -> np.ndarray:
    """[J, K] node whose θ rows each slot of the synchronous chain reads:
    the node that owns its table row (self_idx), -1 for a masked slot or a
    row no node owns (read from θ0 in every round)."""
    idx = np.asarray(nbr_idx, dtype=np.int64)
    own = np.asarray(self_idx, dtype=np.int64)
    live = np.asarray(live, dtype=bool)
    top = max(int(idx[live].max(initial=0)), int(own.max(initial=0)))
    owner = np.full(top + 1, -1, dtype=np.int64)
    owner[own] = np.arange(own.size)
    return np.where(live, owner[np.clip(idx, 0, top)], -1)


@functools.lru_cache(maxsize=64)
def _solve_plan(idx, shape, own, live, d_feat, dy, dtype, rounds, device,
                name):
    live = np.frombuffer(live, dtype=bool).reshape(shape)
    nodes = table_slot_nodes(
        np.frombuffer(idx, dtype=np.int64).reshape(shape),
        np.frombuffer(own, dtype=np.int64), live)
    return chain_route(name, nodes, live, shape[1], d_feat, dy, dtype,
                       rounds)


# `dekrr_cheb_solve`'s plan: `solve_plan` under the Chebyshev chain's name.
cheb_plan = functools.partial(solve_plan, name="dekrr_cheb_solve")


def async_plan(nbr_idx, nbr_mask, *, d_feat: int, dy: int,
               dtype: torch.dtype, rounds: int) -> ChainPlan:
    """`dekrr_async_solve`'s plan on the current device from its slot
    table (nbr_idx node ids, nbr_mask)."""
    idx = _host(nbr_idx).astype(np.int64)
    live = _host(nbr_mask) != 0
    return _async_plan(idx.tobytes(), idx.shape, live.tobytes(), d_feat, dy,
                       dtype, rounds, torch.cuda.current_device())


@functools.lru_cache(maxsize=64)
def _async_plan(idx, shape, live, d_feat, dy, dtype, rounds, device):
    idx = np.frombuffer(idx, dtype=np.int64).reshape(shape)
    live = np.frombuffer(live, dtype=bool).reshape(shape)
    return chain_route("dekrr_async_solve", np.where(live, idx, -1), live,
                       shape[1], d_feat, dy, dtype, rounds)


@functools.lru_cache(maxsize=64)
def _plan_tensors(plan: ChainPlan, device: torch.device):
    """The resident plan's wait table and slot nodes on ``device``."""
    waits = torch.as_tensor(plan.wait_table(), device=device)
    nodes = torch.as_tensor(np.asarray(plan.slot_nodes, dtype=np.int32),
                            device=device)
    return waits, nodes


def _ptr(t: torch.Tensor | None):
    return None if t is None else t.data_ptr()


def dekrr_solve_cuda(g, d, s, p, theta, nbr_idx, self_idx, nbr_mask, out,
                     res, work, *, num_rounds: int, dy: int,
                     plan: ChainPlan, stamps=None) -> None:
    """Launch the kernel on checked, contiguous CUDA tensors: out
    [J·Dy, D], res [R, J] or None, work 2·[T·Dy, D] scratch, on the route
    of ``plan`` (`solve_plan`, made beforehand so the launch never waits
    for the host). ``stamps`` (zeroed int64 [blocks, 1 + R·phases], f64
    only) runs the kernel with its phase clock on (`CHAIN_PHASES`)."""
    j_nodes, k_slots, d_feat = p.shape[0], p.shape[1], d.shape[1]
    t_rows = theta.shape[0] // dy
    lib = _build.library("dekrr_solve")
    kind = "_clocked" if stamps is not None else ""
    stream = torch.cuda.current_stream(g.device).cuda_stream
    head = (g.data_ptr(), d.data_ptr(), s.data_ptr(), p.data_ptr(),
            theta.data_ptr())
    if plan.route == "resident":
        waits, nodes = _plan_tensors(plan, g.device)
        prog = torch.empty((j_nodes,), dtype=torch.int32, device=g.device)
        fn = getattr(lib, f"dekrr_solve_resident{kind}_{_suffix(g.dtype)}")
        args = head + (nbr_idx.data_ptr(), nodes.data_ptr(),
                       self_idx.data_ptr(), nbr_mask.data_ptr(),
                       waits.data_ptr(), prog.data_ptr(), work.data_ptr(),
                       out.data_ptr(), _ptr(res)) + (
            (stamps.data_ptr(),) if stamps is not None else ()) + (
            num_rounds, j_nodes, k_slots, d_feat, dy, waits.shape[1],
            plan.blocks, plan.rows, plan.live, stream)
    else:
        fn = getattr(lib, f"dekrr_solve{kind}_{_suffix(g.dtype)}")
        args = head + (nbr_idx.data_ptr(), self_idx.data_ptr(),
                       nbr_mask.data_ptr(), out.data_ptr(), _ptr(res),
                       work.data_ptr()) + (
            (stamps.data_ptr(),) if stamps is not None else ()) + (
            num_rounds, j_nodes, k_slots, d_feat, dy, t_rows, plan.blocks,
            plan.rows, plan.clusters, stream)
    _build.check(fn(*args), f"dekrr_solve launch ({plan.route} route)")
    ROUTE_LAUNCHES["dekrr_solve", plan.route] += 1


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
                           edge_gossip: bool, dy: int, plan: ChainPlan,
                           stamps=None) -> None:
    """Launch the kernel on checked, contiguous CUDA tensors (the plain
    version's raw contract): out_theta/out_sent [J·Dy, D], out_buf
    [J·K·Dy, D], res/bc [R + 1, J] or both None, work 2·[T·Dy, D] and
    flags [2·J] int32 scratch, on the route of ``plan`` (`async_plan`).
    ``stamps`` (zeroed int64 [blocks, 1 + (R + 1)·phases], f64 only)
    turns the phase clock on."""
    j_nodes, k_slots, d_feat = p.shape[0], p.shape[1], d.shape[1]
    t_rows = theta.shape[0] // dy
    rounds = active.shape[0]
    lib = _build.library("dekrr_async_solve")
    kind = "_clocked" if stamps is not None else ""
    stream = torch.cuda.current_stream(g.device).cuda_stream
    head = (g.data_ptr(), d.data_ptr(), s.data_ptr(), p.data_ptr(),
            theta.data_ptr(), sent.data_ptr(), buffers.data_ptr(),
            nbr_idx.data_ptr(), nbr_mask.data_ptr(), active.data_ptr(),
            thresholds.data_ptr())
    clock = (stamps.data_ptr(),) if stamps is not None else ()
    if plan.route == "resident":
        waits, _ = _plan_tensors(plan, g.device)
        prog = torch.empty((j_nodes,), dtype=torch.int32, device=g.device)
        fn = getattr(lib, f"dekrr_async_solve_resident{kind}_"
                     f"{_suffix(g.dtype)}")
        args = head + (waits.data_ptr(), prog.data_ptr(),
                       out_theta.data_ptr(), out_sent.data_ptr(),
                       out_buf.data_ptr(), _ptr(res), _ptr(bc),
                       work.data_ptr(), flags.data_ptr()) + clock + (
            rounds, j_nodes, k_slots, d_feat, dy, waits.shape[1],
            int(censored), int(edge_gossip), plan.blocks, plan.rows,
            plan.live, stream)
    else:
        fn = getattr(lib, f"dekrr_async_solve{kind}_{_suffix(g.dtype)}")
        args = head + (out_theta.data_ptr(), out_sent.data_ptr(),
                       out_buf.data_ptr(), _ptr(res), _ptr(bc),
                       work.data_ptr(), flags.data_ptr()) + clock + (
            rounds, j_nodes, k_slots, d_feat, dy, t_rows, int(censored),
            int(edge_gossip), plan.blocks, plan.rows, plan.clusters, stream)
    _build.check(fn(*args), f"dekrr_async_solve launch ({plan.route} route)")
    ROUTE_LAUNCHES["dekrr_async_solve", plan.route] += 1


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
                          work, *, dy: int, plan: ChainPlan,
                          stamps=None) -> None:
    """Launch the kernel on checked, contiguous CUDA tensors: out_theta /
    out_p [J·Dy, D], res [R, J] or None, work 2·[T·Dy, D] scratch, on the
    route of ``plan`` (`cheb_plan`, made beforehand so the launch never
    waits for the host).
    ``stamps`` (zeroed int64 [blocks, 1 + R·phases], f64 only) runs the
    kernel with its phase clock on (`CHAIN_PHASES`)."""
    j_nodes, k_slots, d_feat = p.shape[0], p.shape[1], d.shape[1]
    t_rows = theta.shape[0] // dy
    rounds = alphas.shape[0]
    lib = _build.library("dekrr_cheb_solve")
    kind = "_clocked" if stamps is not None else ""
    stream = torch.cuda.current_stream(g.device).cuda_stream
    head = (g.data_ptr(), d.data_ptr(), s.data_ptr(), p.data_ptr(),
            theta.data_ptr(), delta.data_ptr())
    coef = (alphas.data_ptr(), betas.data_ptr())
    clock = (stamps.data_ptr(),) if stamps is not None else ()
    if plan.route == "resident":
        waits, nodes = _plan_tensors(plan, g.device)
        prog = torch.empty((j_nodes,), dtype=torch.int32, device=g.device)
        fn = getattr(lib, f"dekrr_cheb_solve_resident{kind}_"
                     f"{_suffix(g.dtype)}")
        args = head + (nbr_idx.data_ptr(), nodes.data_ptr(),
                       self_idx.data_ptr(), nbr_mask.data_ptr(),
                       waits.data_ptr()) + coef + (
            prog.data_ptr(), work.data_ptr(), out_theta.data_ptr(),
            out_p.data_ptr(), _ptr(res)) + clock + (
            rounds, j_nodes, k_slots, d_feat, dy, waits.shape[1],
            plan.blocks, plan.rows, plan.live, stream)
    else:
        fn = getattr(lib, f"dekrr_cheb_solve{kind}_{_suffix(g.dtype)}")
        args = head + (nbr_idx.data_ptr(), self_idx.data_ptr(),
                       nbr_mask.data_ptr()) + coef + (
            out_theta.data_ptr(), out_p.data_ptr(), _ptr(res),
            work.data_ptr()) + clock + (
            rounds, j_nodes, k_slots, d_feat, dy, t_rows, plan.blocks,
            plan.rows, plan.clusters, stream)
    _build.check(fn(*args), f"dekrr_cheb_solve launch ({plan.route} route)")
    ROUTE_LAUNCHES["dekrr_cheb_solve", plan.route] += 1
