"""Asynchronous gossip DeKRR — randomized activation, staleness, censoring.

The counterpart of `repro.core.async_gossip`: the shared schedule (the
activation-mask table and the censor thresholds) every runtime consumes,
and the ragged per-node ground-truth solver that the packed runtime
(`repro_torch.dist.async_gossip`) is held against.

One asynchronous round r (all runtimes, exactly this order):

  1. **Activate.** Row r of the [R, J] activation-mask table says which
     nodes run: ``gossip="bernoulli"`` draws each node iid
     Bernoulli(prob); ``gossip="edge"`` draws one edge uniformly and
     activates its two endpoints.
  2. **Update.** Active nodes run the Eq. 19 update against their
     receive buffers — the last θ each neighbour actually broadcast, not
     its current iterate. Inactive nodes keep θ.
  3. **Censor.** An active node broadcasts its new θ unless censoring is
     on (``censor_tau > 0``) and ‖θ_j^new − θ_j^sent‖_∞ ≤ τ_r, with
     τ_r = censor_tau · censor_decay^r.
  4. **Deliver.** A broadcast lands in the buffers of all the sender's
     neighbours under "bernoulli", only at the other endpoint under
     "edge".

The reference draws the masks with `jax.random`, which torch cannot
reproduce; every solver here therefore takes the mask table as an input.
`activation_masks` draws one with a `torch.Generator` for standalone use;
tests feed both packages the reference's table and thresholds so that
every censor decision falls on the same bits.

With prob = 1, gossip="bernoulli" and no censoring every node is active
and broadcasts every round: the recursion is the synchronous Jacobi
iteration.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch._device import resolve_device

__all__ = [
    "AsyncGossipConfig",
    "AsyncGossipResult",
    "activation_mask",
    "activation_masks",
    "async_gossip_solve",
    "censor_schedule",
    "edge_list",
    "edges_from_slot_table",
]

_GOSSIP_MODES = ("bernoulli", "edge")


@dataclasses.dataclass(frozen=True)
class AsyncGossipConfig:
    """Randomized-activation schedule shared by every async runtime.

    prob: per-node activation probability (``gossip="bernoulli"`` only;
      1.0 = every node active). gossip: "bernoulli" (iid node activation,
      broadcast delivery) or "edge" (one uniform edge per round, delivery
      along it only). censor_tau: initial censoring threshold τ_0 (0.0 =
      off). censor_decay: τ_r = τ_0 · decay^r.
    """

    prob: float = 1.0
    gossip: str = "bernoulli"
    censor_tau: float = 0.0
    censor_decay: float = 1.0

    def __post_init__(self):
        if not 0.0 < self.prob <= 1.0:
            raise ValueError(f"prob must be in (0, 1], got {self.prob}")
        if self.gossip not in _GOSSIP_MODES:
            raise ValueError(f"gossip must be one of {_GOSSIP_MODES}, "
                             f"got {self.gossip!r}")
        if self.censor_tau < 0.0:
            raise ValueError(f"censor_tau must be >= 0, "
                             f"got {self.censor_tau}")
        if not 0.0 < self.censor_decay <= 1.0:
            raise ValueError(f"censor_decay must be in (0, 1], "
                             f"got {self.censor_decay}")

    @property
    def censored(self) -> bool:
        return self.censor_tau > 0.0


# --------------------------------------------------------------------------
# The shared schedule
# --------------------------------------------------------------------------
def edge_list(topology) -> np.ndarray:
    """Canonical undirected edge list [E, 2] with i < j, sorted — the
    enumeration edge-gossip draws index into."""
    edges = np.asarray(topology.edges, dtype=np.int32).reshape(-1, 2)
    return edges[np.lexsort((edges[:, 1], edges[:, 0]))]


def edges_from_slot_table(nbr_idx: np.ndarray,
                          nbr_mask: np.ndarray) -> np.ndarray:
    """`edge_list` rebuilt from a packed slot table (np.unique sorts the
    rows as `edge_list` does, so both give the same list)."""
    nbr_idx = np.asarray(nbr_idx)
    nbr_mask = np.asarray(nbr_mask)
    j_nodes, k_slots = nbr_idx.shape
    senders = np.broadcast_to(
        np.arange(j_nodes, dtype=np.int32)[:, None], (j_nodes, k_slots))
    live = nbr_mask != 0
    pairs = np.stack([senders[live], nbr_idx[live].astype(np.int32)],
                     axis=1)
    pairs = np.sort(pairs, axis=1)          # undirected: (min, max)
    if pairs.size == 0:
        return np.zeros((0, 2), dtype=np.int32)
    return np.unique(pairs, axis=0)


def activation_masks(generator: torch.Generator, num_rounds: int,
                     num_nodes: int, *, prob: float = 1.0,
                     gossip: str = "bernoulli",
                     edges: np.ndarray | None = None) -> torch.Tensor:
    """A [R, J] bool activation table drawn with ``generator`` on its
    device: iid Bernoulli(prob) per node and round, or (``gossip="edge"``)
    one uniform edge of ``edges`` per round with both endpoints active.
    Not the reference's draw (that uses `jax.random`)."""
    if gossip not in _GOSSIP_MODES:
        raise ValueError(f"gossip must be one of {_GOSSIP_MODES}, "
                         f"got {gossip!r}")
    device = generator.device
    if gossip == "bernoulli":
        u = torch.rand((num_rounds, num_nodes), generator=generator,
                       dtype=torch.float64, device=device)
        return u < prob
    if edges is None or len(edges) == 0:
        raise ValueError("gossip='edge' needs a non-empty edge list")
    pick = torch.randint(0, len(edges), (num_rounds,), generator=generator,
                         device=device)
    uv = torch.as_tensor(np.asarray(edges), dtype=torch.long,
                         device=device)[pick]                   # [R, 2]
    masks = torch.zeros((num_rounds, num_nodes), dtype=torch.bool,
                        device=device)
    return masks.scatter_(1, uv, True)


def _round_seed(seed: int, round_idx: int) -> int:
    """A fixed mix of (seed, round): the SplitMix64 finaliser of
    seed·2⁶⁴-golden + round, so nearby seeds and rounds seed unrelated
    streams. Any process computes it without talking to another."""
    z = (int(seed) * 0x9E3779B97F4A7C15 + int(round_idx)) % 2 ** 64
    z = (z ^ (z >> 30)) * 0xBF58476D1CE4E5B9 % 2 ** 64
    z = (z ^ (z >> 27)) * 0x94D049BB133111EB % 2 ** 64
    return (z ^ (z >> 31)) >> 1                  # manual_seed takes < 2⁶³


def activation_mask(seed: int, round_idx: int, num_nodes: int, *,
                    prob: float = 1.0, gossip: str = "bernoulli",
                    edges: np.ndarray | None = None) -> torch.Tensor:
    """The round-r activation mask [J] bool, on the CPU, deterministic in
    (seed, round_idx): every rank of an SPMD solve computes the same row
    without talking (the reference folds the round into a `jax.random`
    key for the same reason; these are not its bits). Draws as
    `activation_masks` does, from a CPU `torch.Generator` seeded by a
    fixed mix of the two."""
    gen = torch.Generator().manual_seed(_round_seed(seed, round_idx))
    return activation_masks(gen, 1, num_nodes, prob=prob, gossip=gossip,
                            edges=edges)[0]


def censor_schedule(censor_tau: float, censor_decay: float, num_rounds: int,
                    *, dtype: torch.dtype = torch.float64,
                    device: str | torch.device | None = None
                    ) -> torch.Tensor:
    """τ_r = τ_0 · decay^r for r = 0 … R−1, one [R] tensor on ``device``
    (the card unless the caller names another)."""
    device = resolve_device(device)
    r = torch.arange(num_rounds, dtype=dtype, device=device)
    return torch.tensor(censor_tau, dtype=dtype, device=device) * \
        torch.tensor(censor_decay, dtype=dtype, device=device) ** r


# --------------------------------------------------------------------------
# Ragged per-node reference solver (ground truth)
# --------------------------------------------------------------------------
@dataclasses.dataclass
class AsyncGossipResult:
    """theta: ragged per-node iterates after the last executed round;
    rounds: rounds executed (< num_rounds iff tol stopped it);
    broadcasts: θ transmissions after censoring; deliveries: per-edge
    buffer refreshes."""

    theta: list[torch.Tensor]
    rounds: int
    broadcasts: int
    deliveries: int


def _check_mask_table(name: str, masks: torch.Tensor, num_rounds: int,
                      num_nodes: int) -> None:
    """Mask tables must be exactly [R, J] (or [J] for one round, with
    num_rounds = -1): a mis-shaped table would be broadcast or cut by the
    indexing that reads it."""
    shape = tuple(masks.shape)
    want = (num_rounds, num_nodes) if num_rounds >= 0 else (num_nodes,)
    if shape != want:
        raise ValueError(
            f"{name}: activation-mask table has shape {list(shape)}, "
            f"expected {list(want)} — one row per round, one column per "
            f"node")


def async_gossip_solve(solver, masks: torch.Tensor, num_rounds: int,
                       config: AsyncGossipConfig = AsyncGossipConfig(),
                       *, thresholds: torch.Tensor | None = None,
                       tol: float = 0.0) -> AsyncGossipResult:
    """Ragged ground-truth async gossip solve on a
    `repro_torch.core.DeKRRSolver`, in `DeKRRSolver.step`'s per-node style
    with explicit buffers ``buf[receiver][sender]``.

    ``masks`` is the [num_rounds, J] activation table; ``thresholds`` the
    [num_rounds] censor thresholds (default `censor_schedule` of
    ``config``, on the host in float64).

    ``tol > 0`` stops after the first round with max_j ‖Δθ_j‖_∞ < tol,
    ignoring all-silent rounds (their Δθ ≡ 0 is the schedule idling, not
    convergence); the converging round is counted.
    """
    topo, aux = solver.topology, solver.aux
    j_nodes = solver.J
    _check_mask_table("async_gossip_solve", masks, num_rounds, j_nodes)
    masks = masks.detach().cpu().numpy() != 0
    if thresholds is None:
        thresholds = censor_schedule(config.censor_tau, config.censor_decay,
                                     num_rounds, device="cpu")
    thresholds = thresholds.detach().cpu().numpy()

    theta = [torch.zeros_like(aux.d[j]) for j in range(j_nodes)]
    sent = list(theta)
    buf = [{p: torch.zeros_like(aux.d[p]) for p in topo.neighbors(j)}
           for j in range(j_nodes)]

    rounds = broadcasts = deliveries = 0
    for r in range(num_rounds):
        mask = masks[r]
        # update: active nodes read their (possibly stale) buffers
        new_theta = []
        for j in range(j_nodes):
            if not mask[j]:
                new_theta.append(theta[j])
                continue
            rhs = aux.d[j] + aux.s[j] @ theta[j]
            for p, pjp in aux.p[j].items():
                rhs = rhs + pjp @ buf[j][p]
            new_theta.append(aux.g[j] @ rhs)
        # censor: compare against the last value actually sent
        bcast = []
        for j in range(j_nodes):
            if not mask[j]:
                bcast.append(False)
            elif not config.censored:
                bcast.append(True)
            else:
                delta = float(torch.max(torch.abs(new_theta[j] - sent[j])))
                bcast.append(delta > thresholds[r])
        # deliver: all updates above were computed from the old buffers
        for j in range(j_nodes):
            if not bcast[j]:
                continue
            for rcv in topo.neighbors(j):
                if config.gossip == "edge" and not mask[rcv]:
                    continue        # pairwise: only the other endpoint
                buf[rcv][j] = new_theta[j]
                deliveries += 1
            sent[j] = new_theta[j]
            broadcasts += 1
        rounds += 1
        delta_round = max((float(torch.max(torch.abs(a - b)))
                           for a, b in zip(new_theta, theta)), default=0.0) \
            if tol > 0 else 0.0
        theta = new_theta
        # all-silent rounds have Δθ ≡ 0 by construction: don't stop on them
        if tol > 0 and mask.any() and delta_round < tol:
            break
    return AsyncGossipResult(theta=theta, rounds=rounds,
                             broadcasts=broadcasts, deliveries=deliveries)
