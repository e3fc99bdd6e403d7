"""Asynchronous gossip DeKRR on the packed layout.

The counterpart of `repro.dist.async_gossip`: the packed runtime below,
and `make_async_spmd_solver`, one node per rank of a process group. `repro_torch.core.
async_gossip` defines the semantics; this module runs them on the packed
[J, D_max] problem:

* ``backend="torch"``: each round is `step_batched` with the two async
  extras — ``active`` (inactive nodes pass θ through) and ``nbr_theta``
  (the [J, K, D_max] staleness buffers replace ``theta[nbr_idx]``) —
  followed by censor and delivery in torch;
* ``"cuda"``: the same round with the activation-masked `dekrr_step`
  kernel, one launch per round;
* ``"cuda_fused"``: with ``tol == 0`` the whole schedule, or each
  ``chunk_rounds`` slice of it, is one launch of the async-chain kernel
  (`repro_torch.kernels.ops.dekrr_async_solve`), which also returns the
  trace and stats; with ``tol > 0`` it runs the masked round kernel per
  round like ``"cuda"``.

The reference draws its activation masks with `jax.random`; here the
caller passes the [R, J] table (`repro_torch.core.activation_masks` draws
one with a `torch.Generator`).

The ``tol > 0`` path keeps the convergence freeze on the device, as the
reference does: a converged flag, rounds after the stop recorded as 0,
all-silent rounds never latching the stop. The host reads the flag once
per chunk, so the rounds run and θ do not depend on ``chunk_rounds``.

With the synchronous schedule (p = 1, bernoulli, no censoring) every
backend reproduces `solve_batched` of the same backend bit for bit.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np
import torch

from repro_torch.core.async_gossip import (AsyncGossipConfig,
                                           _check_mask_table,
                                           activation_mask,
                                           censor_schedule,
                                           edges_from_slot_table)
from repro_torch.dist.dekrr_spmd import (PackedProblem, _all_max, _all_rows,
                                         _check_backend, _check_spmd_args,
                                         _check_spmd_problem, _make_exchange,
                                         _NodeRound, _rank_device,
                                         step_batched)
from repro_torch.kernels.ops import check_index_table
from repro_torch.obs.trace import AsyncSolveTrace

__all__ = [
    "AsyncGossipState",
    "AsyncGossipStats",
    "AsyncRoundInfo",
    "async_solve_batched",
    "async_step_batched",
    "init_async_state",
    "make_async_spmd_solver",
]

# Default tol-check chunk of the async solve: the per-round freeze makes
# the rounds run independent of it; it only sets how often the host reads
# the converged flag.
_ASYNC_CHUNK_DEFAULT = 16


@dataclasses.dataclass
class AsyncGossipState:
    """theta [J, D_max]: current iterates. sent [J, D_max]: the last θ
    each node broadcast (the censor reference). buffers [J, K, D_max]:
    buffers[j, k] is the last θ node j received from slot k's neighbour.
    Multi-output packings add a trailing Dy axis to all three."""

    theta: torch.Tensor
    sent: torch.Tensor
    buffers: torch.Tensor


class AsyncRoundInfo(NamedTuple):
    """bcast [J] bool: nodes that transmitted this round (active and
    uncensored). received [J, K] bool: buffer slots refreshed this round."""

    bcast: torch.Tensor
    received: torch.Tensor


class AsyncGossipStats(NamedTuple):
    """Cumulative communication accounting of an async solve."""

    rounds: int
    broadcasts: int
    deliveries: int


def init_async_state(packed: PackedProblem,
                     theta0: torch.Tensor | None = None) -> AsyncGossipState:
    """Round-0 state: every buffer holds its neighbour's θ0 and every
    node 'sent' θ0 — the synchronous iteration's view of round 0."""
    if theta0 is None:
        theta0 = torch.zeros_like(packed.d)
    return AsyncGossipState(theta=theta0, sent=theta0,
                            buffers=theta0[packed.nbr_idx.long()])


def _packed_edges(packed: PackedProblem) -> np.ndarray:
    """The canonical edge list of edge gossip, from the slot table, with
    its endpoints checked against [0, J)."""
    edges = edges_from_slot_table(packed.nbr_idx.detach().cpu().numpy(),
                                  packed.nbr_mask.detach().cpu().numpy())
    check_index_table("edges", edges, packed.num_nodes)
    return edges


def _gate(flags: torch.Tensor, ndim: int) -> torch.Tensor:
    """Broadcast a [J] or [J, K] flag tensor against an ndim-dimensional
    θ or buffer tensor."""
    return flags.reshape(tuple(flags.shape) + (1,) * (ndim - flags.ndim))


def _async_round(packed: PackedProblem, state: AsyncGossipState,
                 active: torch.Tensor, threshold: torch.Tensor, *,
                 gossip: str, censored: bool, backend: str
                 ) -> tuple[AsyncGossipState, AsyncRoundInfo]:
    """One round in the order every layer shares: update (against the
    staleness buffers) → censor → deliver."""
    new = step_batched(packed, state.theta, backend=backend, active=active,
                       nbr_theta=state.buffers)
    act = active != 0
    if censored:
        # per-node max|Δθ| over features AND (multi-output) outputs
        delta = torch.amax(torch.abs(new - state.sent),
                           dim=tuple(range(1, new.ndim)))
        bcast = act & (delta > threshold)
    else:
        bcast = act
    idx = packed.nbr_idx.long()
    received = (packed.nbr_mask != 0) & bcast[idx]           # [J, K]
    if gossip == "edge":
        received = received & act[:, None]     # pairwise: endpoint only
    sent = torch.where(_gate(bcast, new.ndim), new, state.sent)
    buffers = torch.where(_gate(received, new.ndim + 1), new[idx],
                          state.buffers)
    return (AsyncGossipState(theta=new, sent=sent, buffers=buffers),
            AsyncRoundInfo(bcast=bcast, received=received))


def async_step_batched(packed: PackedProblem, state: AsyncGossipState,
                       active: torch.Tensor, threshold: float = 0.0, *,
                       gossip: str = "bernoulli", censored: bool = False,
                       backend: str = "cuda"
                       ) -> tuple[AsyncGossipState, AsyncRoundInfo]:
    """One async round over all nodes from an explicit activation mask
    ([J]) and censor threshold (read only when ``censored``)."""
    _check_backend(backend)
    _check_mask_table("async_step_batched", active, -1, packed.num_nodes)
    threshold = torch.as_tensor(threshold, dtype=packed.d.dtype,
                                device=packed.device)
    return _async_round(packed, state, active.to(packed.device), threshold,
                        gossip=gossip, censored=censored, backend=backend)


def _wire_series(packed: PackedProblem, masks: torch.Tensor,
                 bcast_rj: torch.Tensor, *, gossip: str):
    """Per-round [R] active / broadcasts / deliveries / bytes from the
    per-(round, node) broadcast flags, by `_async_round`'s delivery
    rule, so their sums equal the per-round path's stats."""
    bc = bcast_rj != 0                                        # [R, J]
    act = masks != 0
    live = packed.nbr_mask != 0                               # [J, K]
    recv = live[None] & bc[:, packed.nbr_idx.long()]          # [R, J, K]
    if gossip == "edge":
        recv = recv & act[:, :, None]
    broadcasts = bc.sum(dim=1)
    return (act.sum(dim=1), broadcasts, recv.sum(dim=(1, 2)),
            broadcasts * _bytes_per_broadcast(packed))


def _bytes_per_broadcast(packed: PackedProblem) -> int:
    return packed.max_features * packed.num_outputs * packed.d.element_size()


def _async_solve_fused(packed, state, masks, thresholds, *, gossip,
                       censored, chunk_rounds, trace):
    """tol = 0 on "cuda_fused": one async-chain launch per
    ``chunk_rounds`` slice of the schedule (the whole schedule by
    default). The kernel returns the full state, so chunks chain bit for
    bit. Returns (state, (res [R, J], bc [R, J]) or None)."""
    from repro_torch.kernels.ops import dekrr_async_solve

    num_iters = masks.shape[0]
    chunk = chunk_rounds or max(num_iters, 1)
    res, bc = [], []
    for start in range(0, num_iters, chunk):
        outs = dekrr_async_solve(
            packed.g, packed.d, packed.s, packed.p, state.theta, state.sent,
            state.buffers, packed.nbr_idx, packed.nbr_mask,
            masks[start:start + chunk], thresholds[start:start + chunk],
            gossip=gossip, censored=censored, trace=trace)
        state = AsyncGossipState(*outs[:3])
        if trace:
            res.append(outs[3])
            bc.append(outs[4])
    if not trace:
        return state, None
    if not res:
        j_nodes = packed.num_nodes
        return state, (packed.d.new_zeros((0, j_nodes)),
                       torch.zeros((0, j_nodes), dtype=torch.int32,
                                   device=packed.device))
    return state, (torch.cat(res), torch.cat(bc))


def _solve_scanned(packed, state, masks, thresholds, *, gossip, censored,
                   backend, trace):
    """tol = 0 on the per-round backends: every round, no freeze.
    Returns (state, broadcasts, deliveries, (residuals [R], bc [R, J]) or
    None), the counts as device tensors."""
    nb = torch.zeros((), dtype=torch.int64, device=packed.device)
    nd = torch.zeros_like(nb)
    res, bcs = [], []
    for r in range(masks.shape[0]):
        new, info = _async_round(packed, state, masks[r], thresholds[r],
                                 gossip=gossip, censored=censored,
                                 backend=backend)
        if trace:
            res.append(torch.amax(torch.abs(new.theta - state.theta)))
            bcs.append(info.bcast)
        nb = nb + info.bcast.sum()
        nd = nd + info.received.sum()
        state = new
    series = None
    if trace:
        series = ((torch.stack(res), torch.stack(bcs)) if res else
                  (packed.d.new_zeros((0,)),
                   torch.zeros((0, packed.num_nodes), dtype=torch.bool,
                               device=packed.device)))
    return state, nb, nd, series


def _solve_tol(packed, state, masks, thresholds, *, gossip, censored,
               backend, tol, chunk_rounds, trace):
    """tol > 0: the per-round convergence freeze, evaluated after every
    round on the device; a converged solve passes later rounds through
    unchanged. The host reads the converged flag once per chunk. Returns
    (state, rounds, broadcasts, deliveries, (residuals, broadcasts,
    deliveries) [R] or None), counts as device tensors."""
    num_iters = masks.shape[0]
    dev = packed.device
    chunk = min(chunk_rounds or _ASYNC_CHUNK_DEFAULT, max(num_iters, 1))
    zero = torch.zeros((), dtype=torch.int64, device=dev)
    converged = torch.zeros((), dtype=torch.bool, device=dev)
    rounds, nb, nd = zero, zero, zero
    if trace:
        rbuf = packed.d.new_zeros((num_iters,))
        bbuf = torch.zeros((num_iters,), dtype=torch.int64, device=dev)
        dbuf = torch.zeros_like(bbuf)
    for start in range(0, num_iters, chunk):
        for r in range(start, min(start + chunk, num_iters)):
            new, info = _async_round(packed, state, masks[r], thresholds[r],
                                     gossip=gossip, censored=censored,
                                     backend=backend)
            delta = torch.amax(torch.abs(new.theta - state.theta))
            take = ~converged
            state = AsyncGossipState(*(
                torch.where(take, a, b) for a, b in
                ((new.theta, state.theta), (new.sent, state.sent),
                 (new.buffers, state.buffers))))
            rounds = rounds + take
            b = torch.where(take, info.bcast.sum(), zero)
            dv = torch.where(take, info.received.sum(), zero)
            nb, nd = nb + b, nd + dv
            if trace:
                rbuf[r] = torch.where(take, delta, 0.0)
                bbuf[r] = b
                dbuf[r] = dv
            # an all-silent round has Δθ ≡ 0 by construction: the schedule
            # idled, the iteration did not converge — it must not latch
            converged = converged | (take & (masks[r] != 0).any()
                                     & (delta < tol))
        if bool(converged):
            break
    return state, rounds, nb, nd, ((rbuf, bbuf, dbuf) if trace else None)


def async_solve_batched(packed: PackedProblem, num_iters: int,
                        masks: torch.Tensor, *,
                        config: AsyncGossipConfig = AsyncGossipConfig(),
                        thresholds: torch.Tensor | None = None,
                        theta0: torch.Tensor | None = None,
                        backend: str = "cuda_fused", tol: float = 0.0,
                        chunk_rounds: int | None = None,
                        return_rounds: bool = False,
                        return_stats: bool = False,
                        return_trace: bool = False):
    """Run up to `num_iters` async gossip rounds from θ = 0 (or theta0).

    ``masks`` is the [num_iters, J] activation table (nonzero = active);
    ``thresholds`` the [num_iters] censor thresholds, by default
    `censor_schedule` of ``config`` on the packed device.

    ``backend``: "torch" and "cuda" run round by round; "cuda_fused" runs
    the schedule as one async-chain launch per ``chunk_rounds`` slice
    (default: one), bit for bit the "cuda" rounds, and only ``tol > 0``
    takes the per-round masked kernel.

    ``tol > 0`` stops on max|Δθ| < tol, evaluated after every round on the
    device except after all-silent rounds; later rounds pass through
    unchanged, so rounds and θ do not depend on ``chunk_rounds`` (default
    16, the host's read cadence). ``return_rounds`` appends the rounds run
    (int), ``return_stats`` an `AsyncGossipStats`, ``return_trace`` an
    `AsyncSolveTrace` of [num_iters] series (0 after a tol stop; its sums
    are the stats). Return order: ``(theta[, rounds][, stats][, trace])``.
    """
    _check_backend(backend)
    if tol < 0:
        raise ValueError(f"tol must be >= 0, got {tol}")
    if chunk_rounds is not None and chunk_rounds < 1:
        raise ValueError(f"chunk_rounds must be >= 1, got {chunk_rounds}")
    num_iters = int(num_iters)
    j_nodes = packed.num_nodes
    if config.gossip == "edge" and len(_packed_edges(packed)) == 0:
        raise ValueError("gossip='edge' needs a non-empty edge list (the "
                         "packed problem has no edge)")
    _check_mask_table("async_solve_batched", masks, num_iters, j_nodes)
    masks = masks.to(packed.device)
    if thresholds is None:
        thresholds = censor_schedule(config.censor_tau, config.censor_decay,
                                     num_iters, dtype=packed.d.dtype,
                                     device=packed.device)
    elif tuple(thresholds.shape) != (num_iters,):
        raise ValueError(f"async_solve_batched: thresholds have shape "
                         f"{list(thresholds.shape)}, expected [{num_iters}]")
    thresholds = thresholds.to(dtype=packed.d.dtype, device=packed.device)
    state = init_async_state(packed, theta0)
    kw = dict(gossip=config.gossip, censored=config.censored)
    need_wire = return_stats or return_trace
    per_bcast = _bytes_per_broadcast(packed)

    trace = None
    if tol == 0.0 and backend == "cuda_fused":
        state, tr = _async_solve_fused(packed, state, masks, thresholds,
                                       chunk_rounds=chunk_rounds,
                                       trace=need_wire, **kw)
        rounds = num_iters
        if need_wire:
            res, bc = tr
            active, bcasts, delivs, wire = _wire_series(packed, masks, bc,
                                                        gossip=config.gossip)
            nb, nd = bcasts.sum(), delivs.sum()
            residuals = res.amax(dim=1) if num_iters else res.new_zeros((0,))
            trace = AsyncSolveTrace(residuals, active, bcasts, delivs, wire)
    elif tol == 0.0:
        state, nb, nd, series = _solve_scanned(
            packed, state, masks, thresholds, backend=backend,
            trace=return_trace, **kw)
        rounds = num_iters
        if return_trace:
            residuals, bc = series
            trace = AsyncSolveTrace(residuals, *_wire_series(
                packed, masks, bc, gossip=config.gossip))
    else:
        state, rounds_t, nb, nd, series = _solve_tol(
            packed, state, masks, thresholds, backend=backend, tol=tol,
            chunk_rounds=chunk_rounds, trace=return_trace, **kw)
        rounds = int(rounds_t)
        if return_trace:
            residuals, bcasts, delivs = series
            ran = torch.arange(num_iters, device=packed.device) < rounds
            active = (masks != 0).sum(dim=1) * ran
            trace = AsyncSolveTrace(residuals, active, bcasts, delivs,
                                    bcasts * per_bcast)

    out = (state.theta,)
    if return_rounds:
        out += (rounds,)
    if return_stats:
        out += (AsyncGossipStats(rounds=rounds, broadcasts=int(nb),
                                 deliveries=int(nd)),)
    if return_trace:
        out += (trace,)
    return out if len(out) > 1 else state.theta


# --------------------------------------------------------------------------
# SPMD: one node per rank of a torch.distributed process group
# --------------------------------------------------------------------------
def _spmd_masks(packed: PackedProblem, num_iters: int, masks, seed,
                config: AsyncGossipConfig, edges) -> torch.Tensor:
    """The [R, J] table every rank walks: the caller's, or row r drawn by
    `activation_mask(seed, r, …)` on each rank alike."""
    j_nodes = packed.num_nodes
    if masks is None:
        if seed is None:
            raise ValueError("make_async_spmd_solver: pass the [R, J] mask "
                             "table (masks=) or a seed to draw it from")
        rows = [activation_mask(seed, r, j_nodes, prob=config.prob,
                                gossip=config.gossip, edges=edges)
                for r in range(num_iters)]
        masks = (torch.stack(rows) if rows
                 else torch.zeros((0, j_nodes), dtype=torch.bool))
    _check_mask_table("make_async_spmd_solver", masks, num_iters, j_nodes)
    return masks.cpu() != 0


def make_async_spmd_solver(group=None, mode: str = "ppermute",
                           backend: str = "cuda", *, device=None):
    """Build the async counterpart of `make_spmd_solver`: ``run(packed,
    num_iters, masks=None, *, config=AsyncGossipConfig(), seed=None,
    thresholds=None, theta0=None, tol=0.0, return_rounds=False,
    return_trace=False)``, one node per rank of ``group``, the same
    exchange modes.

    The [R, J] activation table is replicated on every rank: ``masks``
    as given, or drawn row by row with `activation_mask(seed, r, …)`. The
    thresholds are `censor_schedule` of ``config`` unless given. Every
    rank walks the same table, so the exchange runs every round on every
    rank and the masks decide what lands in the staleness buffers, which
    one exchange before the loop fills with the neighbours' θ0.

    Per round: the masked round (``active``) on [own θ; buffers]; the
    node broadcasts when active and (censored) its Δ against ``sent``
    passes the threshold; the post-censoring ``sent`` is exchanged. Under
    "bernoulli" that alone is the delivery (a buffer always equals the
    sender's last broadcast); under "edge" the broadcast flag travels as
    a one-element exchange and gates delivery to the drawn edge.

    ``tol > 0`` stops on the network-wide max|Δθ| (one all-reduce a
    round) except after all-silent rounds, whose Δθ ≡ 0 is the schedule
    idling. ``return_trace`` appends an `AsyncSolveTrace`: the residuals
    combined by one all-reduce after the loop and the wire series from
    every rank's broadcast flags (one all-gather). With
    ``config.is_synchronous`` schedules (p = 1, bernoulli, no censoring)
    the result equals `make_spmd_solver`'s bit for bit. Return order:
    ``(theta[, rounds][, trace])``, θ as [J, D_max(, Dy)] on every rank.
    """
    _check_spmd_args(mode, backend)
    device = _rank_device(device)

    def run(packed: PackedProblem, num_iters: int,
            masks: torch.Tensor | None = None, *,
            config: AsyncGossipConfig = AsyncGossipConfig(),
            seed: int | None = None,
            thresholds: torch.Tensor | None = None,
            theta0: torch.Tensor | None = None, tol: float = 0.0,
            return_rounds: bool = False, return_trace: bool = False):
        _check_spmd_problem(packed, group, mode)
        if tol < 0:
            raise ValueError(f"tol must be >= 0, got {tol}")
        num_iters = int(num_iters)
        edge = config.gossip == "edge"
        edges = _packed_edges(packed) if edge else None
        masks = _spmd_masks(packed, num_iters, masks, seed, config, edges)
        dtype = packed.d.dtype
        if thresholds is None:
            thresholds = censor_schedule(config.censor_tau,
                                         config.censor_decay, num_iters,
                                         dtype=dtype, device=device)
        elif tuple(thresholds.shape) != (num_iters,):
            raise ValueError(f"make_async_spmd_solver: thresholds have "
                             f"shape {list(thresholds.shape)}, expected "
                             f"[{num_iters}]")
        thresholds = thresholds.to(dtype=dtype, device=device)
        step = _NodeRound(packed, group, device, backend)
        exchange = _make_exchange(mode, group, packed.offsets, step.slots)
        r = step.rank
        active = masks[:, r:r + 1].to(device)                 # [R, 1]
        live = step.node.nbr_mask[0] != 0                      # [K]
        if edge:
            nbr_active = masks[:, step.slots].to(device)       # [R, K]
        theta = (torch.zeros_like(step.node.d) if theta0 is None
                 else theta0[r:r + 1].to(device))
        sent, buffers = theta, exchange(theta)
        if return_trace:
            residuals = theta.new_zeros((num_iters,))
            flags = torch.zeros((num_iters,), dtype=torch.int32,
                                device=device)
        rounds = 0
        for rnd in range(num_iters):
            act = active[rnd]
            new = step(theta, buffers, act)
            if config.censored:
                delta = torch.amax(torch.abs(new - sent))
                bcast = act[0] & (delta > thresholds[rnd])
            else:
                bcast = act[0]
            sent = torch.where(bcast, new, sent)
            payload = exchange(sent)                           # [K, D…]
            if edge:
                flag = exchange(bcast.reshape(1, 1).to(dtype))[:, 0] != 0
                gate = act[0] & nbr_active[rnd] & flag & live
            else:
                gate = live
            buffers = torch.where(_gate(gate, payload.ndim), payload,
                                  buffers)
            if return_trace or tol > 0:
                local = torch.amax(torch.abs(new - theta))
            if return_trace:
                residuals[rnd] = local
                flags[rnd] = bcast.to(torch.int32)
            rounds += 1
            converged = (tol > 0 and bool(masks[rnd].any())
                         and float(_all_max(local, group)) < tol)
            theta = new
            if converged:
                break
        out = (_all_rows(theta, group),)
        if return_rounds:
            out += (rounds,)
        if return_trace:
            bc = _all_rows(flags[None], group).T               # [R, J]
            small = dataclasses.replace(
                packed, nbr_idx=packed.nbr_idx.to(device),
                nbr_mask=packed.nbr_mask.to(device))
            act_n, bcasts, delivs, wire = _wire_series(
                small, masks.to(device), bc, gossip=config.gossip)
            ran = torch.arange(num_iters, device=device) < rounds
            out += (AsyncSolveTrace(_all_max(residuals, group), act_n * ran,
                                    bcasts, delivs, wire),)
        return out if len(out) > 1 else out[0]

    return run
