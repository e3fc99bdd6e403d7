"""Accuracy against communication of the asynchronous gossip runtime, the
counterpart of `benchmarks/async_gossip_bench.py`.

    python -m repro_torch.bench.async_gossip_bench [--fast] [--out PATH] \
        [--device cpu]

The async runtime's claim is not wall time: it is reaching a given
accuracy on fewer transmitted bytes than the synchronous Jacobi barrier.
On the paper's J = 10 circulant(1, 2) network, for each of the
reference's six activation/censoring schedules, the packed async solve
runs to a ladder of round budgets and records, per checkpoint,

  * rel_err — ‖θ_R − θ*‖₂ / ‖θ*‖₂ against the synchronous fixed point
    (`solve_batched` run far past convergence);
  * actual_bytes — deliveries observed on the wire (`AsyncGossipStats`;
    per-edge θ payloads at the packed width D_max);
  * expected_bytes — the §II-C model `comm_bytes_per_round(...,
    activation_prob, censor_fraction, gossip)` × rounds, at the
    schedule's p and the observed censor fraction.

The p = 1.0 uncensored row is the synchronous Jacobi baseline. Each
schedule's [R, J] activation table is drawn once, from a
`torch.Generator` seeded from the schedule, for the largest checkpoint;
every checkpoint runs its prefix, so the checkpoints are prefixes of one
trajectory, as the reference's (key, round) masks make them. The
reference draws with `jax.random`, so the two benches' rows agree in
kind, not draw for draw; `schedule_frontier` takes a table, and the
parity tests feed it the reference's. The solves run on ``cuda_fused``
(one async-chain launch each); the frontier itself is a property of the
iteration, the same on every backend.
"""
from __future__ import annotations

import sys

import torch

from repro_torch._device import resolve_device
from repro_torch.bench.common import cli, device_name, write_json
from repro_torch.core import (AsyncGossipConfig, DeKRRConfig, DeKRRSolver,
                              NodeData, activation_masks, select_features)
from repro_torch.dist import (async_solve_batched, comm_bytes_per_round,
                              pack_problem, solve_batched)
from repro_torch.dist.async_gossip import _packed_edges
from repro_torch.obs.export import trace_event
from repro_torch.paper import common as C

# (label, config) — p = 1.0 uncensored first: the synchronous baseline.
SCHEDULES = [
    ("sync_p1.0", AsyncGossipConfig()),
    ("bernoulli_p0.5", AsyncGossipConfig(prob=0.5)),
    ("bernoulli_p0.25", AsyncGossipConfig(prob=0.25)),
    ("bernoulli_p1.0_censored",
     AsyncGossipConfig(censor_tau=2e-2, censor_decay=0.95)),
    ("bernoulli_p0.5_censored",
     AsyncGossipConfig(prob=0.5, censor_tau=2e-2, censor_decay=0.95)),
    ("edge_gossip", AsyncGossipConfig(gossip="edge")),
]
CHECKPOINTS = (25, 50, 100, 200, 400)
FAST_CHECKPOINTS = (10, 25, 50)
BACKEND = "cuda_fused"


def build_problem(subsample: int, device):
    """The reference's problem: air_quality cut to ``subsample`` samples,
    D_j = 16 + 4·(j mod 3) energy-selected features from 5× candidates (a
    seeded `torch.Generator`), λ = 1e-6, c_nei = 0.02·N, packed."""
    ds, train, _ = C.load_split("air_quality", device=device)
    if subsample < C.SUBSAMPLE:
        keep = max(subsample // C.J, 8)
        train = [NodeData(x=t.x[:, :keep], y=t.y[:keep]) for t in train]
    gen = torch.Generator(device=device).manual_seed(0)
    dims = [16 + 4 * (j % 3) for j in range(C.J)]
    fmaps = [select_features(gen, ds.dim, dims[j], C.SIGMA, train[j].x,
                             train[j].y, method="energy", candidate_ratio=5)
             for j in range(C.J)]
    n = sum(t.num_samples for t in train)
    solver = DeKRRSolver(C.TOPOLOGY, fmaps, train,
                         DeKRRConfig(lam=C.LAM, c_nei=0.02 * n),
                         build_aux=False, device=device)
    return pack_problem(solver, device=device)


def schedule_masks(packed, config: AsyncGossipConfig, rounds: int,
                   seed: int) -> torch.Tensor:
    """The schedule's [rounds, J] activation table from a `torch.Generator`
    seeded with ``seed`` on the packed device."""
    gen = torch.Generator(device=packed.device).manual_seed(seed)
    edges = _packed_edges(packed) if config.gossip == "edge" else None
    return activation_masks(gen, rounds, packed.num_nodes, prob=config.prob,
                            gossip=config.gossip, edges=edges)


def schedule_frontier(packed, config: AsyncGossipConfig, masks,
                      theta_star: torch.Tensor, checkpoints, *,
                      registry=None, label: str = "") -> list[dict]:
    """One schedule's checkpoints, each the async solve of the first R
    rows of ``masks`` ([max(checkpoints), J]); the last checkpoint's
    trace recorded as a ``trace`` event in ``registry`` when given."""
    d_max = packed.max_features
    itemsize = packed.d.element_size()
    star_norm = float(torch.linalg.norm(theta_star))
    frontier = []
    for rounds in checkpoints:
        theta, stats, trace = async_solve_batched(
            packed, rounds, masks[:rounds], config=config, backend=BACKEND,
            return_stats=True, return_trace=True)
        rel_err = float(torch.linalg.norm(theta - theta_star)) / star_norm
        # observed censor fraction: transmissions suppressed among the
        # rounds' activations (edge gossip: 2 activations a round)
        expected_active = (2.0 * rounds if config.gossip == "edge"
                           else config.prob * packed.num_nodes * rounds)
        censor_frac = max(0.0, 1.0 - stats.broadcasts
                          / max(expected_active, 1.0))
        expected_bytes = rounds * comm_bytes_per_round(
            packed, "ppermute", activation_prob=config.prob,
            censor_fraction=censor_frac, gossip=config.gossip)
        frontier.append({
            "rounds": rounds, "rel_err": rel_err,
            "broadcasts": stats.broadcasts, "deliveries": stats.deliveries,
            "actual_bytes": stats.deliveries * d_max * itemsize,
            "expected_bytes": float(expected_bytes),
            "observed_censor_fraction": censor_frac,
        })
    if registry is not None:
        trace_event(registry, f"async/{label}", trace)
    return frontier


def run(fast: bool = False, *, out: str | None = None, device=None,
        registry=None, packed=None) -> dict:
    """The benchmark on the reference's problem (or on ``packed``, e.g.
    the main path's); returns the results and writes them as JSON to
    `out` when given."""
    device = resolve_device(device)
    if packed is None:
        packed = build_problem(600 if fast else 2000, device)
    checkpoints = FAST_CHECKPOINTS if fast else CHECKPOINTS
    theta_star = solve_batched(packed, 2 * checkpoints[-1] + 1000,
                               backend=BACKEND)
    rows = []
    for seed, (label, config) in enumerate(SCHEDULES):
        masks = schedule_masks(packed, config, checkpoints[-1], seed)
        frontier = schedule_frontier(packed, config, masks, theta_star,
                                     checkpoints, registry=registry,
                                     label=label)
        rows.append({"schedule": label, "gossip": config.gossip,
                     "activation_prob": config.prob,
                     "censor_tau": config.censor_tau,
                     "censor_decay": config.censor_decay,
                     "frontier": frontier})
        last = frontier[-1]
        C.csv_row(f"async/{label}", 0.0,
                  f"rounds={last['rounds']};rel_err={last['rel_err']:.3e};"
                  f"actual_MB={last['actual_bytes'] / 2**20:.3f};"
                  f"censor_frac={last['observed_censor_fraction']:.4f}")
    results = {"benchmark": ("async gossip DeKRR accuracy-vs-communication "
                             "frontier (sync Jacobi = p1.0 uncensored "
                             "baseline)"),
               "device": device_name(device), "backend": BACKEND,
               "j_nodes": packed.num_nodes, "d_max": packed.max_features,
               "checkpoints": list(checkpoints), "schedules": rows}
    if out is not None:
        write_json(results, out)
        print(f"async/json,0.0,wrote={out}")
    return results


if __name__ == "__main__":
    sys.exit(cli(run, __doc__))
