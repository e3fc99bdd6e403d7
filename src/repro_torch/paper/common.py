"""Shared protocol of the paper's experiments.

Protocol follows §IV of the paper on the synthetic stand-ins at the
paper's (d, N): J = 10 nodes of circulant(10, (1, 2)), 50/50 per-node
train/test split, RSE metric, σ = 1 and λ = 1e-6 fixed, and the
penalty c picked on a validation split from ``C_GRID`` (the stand-ins
need weaker coupling than the paper's {2^i N} grid). Datasets are cut
to ``SUBSAMPLE`` samples unless the caller passes ``subsample=None``
(the stand-in's full N, which the card runs).

Every draw goes through a `torch.Generator` seeded from the run's seed.
The runners also take the draws themselves (``candidates=``, ``fmap=``),
so a run can be repeated from given frequencies on another device or
held against another implementation's draws. Row names and numbers match
the JAX package's benchmarks, so the two outputs can be compared line by
line.
"""
from __future__ import annotations

from typing import NamedTuple, Sequence

import numpy as np
import torch

from repro_torch.core import (DKLA, DKLAConfig, DeKRRConfig, DeKRRSolver,
                              FeatureMap, NodeData, circulant,
                              dkla_ddrf_feature_map, rse, sample_rff,
                              select_features)
from repro_torch.data.synthetic import (imbalanced_sizes, make_dataset,
                                        partition, train_test_split_nodes)
from repro_torch.obs.metrics import perf_clock

J = 10
TOPOLOGY = circulant(J, (1, 2))          # the paper's 10-node, 4-neighbor net
SIGMA = 1.0
LAM = 1e-6
SUBSAMPLE = 3000
C_GRID = (0.002, 0.01, 0.05)             # × N
SEEDS = 3

PAPER_DBAR = {                            # Tab. 2 D̄ per dataset
    "houses": 70, "air_quality": 80, "energy": 100,
    "twitter": 130, "toms_hardware": 150, "wave": 200,
}


class RunResult(NamedTuple):
    """A runner's test RSE and wall seconds (indexable as the pair), and
    the c it chose (None for DKLA)."""

    rse: float
    seconds: float
    c: float | None = None


def load_split(name: str, *, mode: str = "noniid_y", sizes=None, seed=0,
               subsample: int | None = SUBSAMPLE, device=None):
    """(dataset, train, test) with the nodes' shards on ``device``."""
    ds = make_dataset(name, subsample=subsample, seed=seed)
    nodes = partition(ds, J, mode=mode, sizes=sizes, seed=seed,
                      device=device)
    train, test = train_test_split_nodes(nodes, seed=seed)
    return ds, train, test


def load_imbalanced(name: str, *, subsample: int | None = SUBSAMPLE,
                    device=None):
    """The §IV-B2 imbalanced split, N_j = (2j−1)N/100, seed 0."""
    ds = make_dataset(name, subsample=subsample, seed=0)
    sizes = imbalanced_sizes(ds.num_samples, J)
    nodes = partition(ds, J, mode="iid", sizes=sizes, seed=0, device=device)
    train, test = train_test_split_nodes(nodes, seed=0)
    return ds, train, test


def _val_split(train, frac=0.25, seed=0):
    """Hold out a slice of each node's training data for c selection."""
    rng = np.random.default_rng(seed)
    tr, va = [], []
    for nd in train:
        n = nd.num_samples
        perm = torch.as_tensor(rng.permutation(n), device=nd.x.device)
        k = max(int(n * frac), 1)
        va.append(NodeData(x=nd.x[:, perm[:k]], y=nd.y[perm[:k]]))
        tr.append(NodeData(x=nd.x[:, perm[k:]], y=nd.y[perm[k:]]))
    return tr, va


def _network_rse(predict_fn, test):
    ys = torch.cat([t.y for t in test])
    pred = torch.cat([predict_fn(j, test[j].x) for j in range(len(test))])
    return rse(pred, ys)


def _generator(seed: int, device) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(seed)


def run_dekrr_ddrf(ds, train, test, d_per_node, *, method="energy",
                   seed=0, candidate_ratio=20, c_grid=C_GRID,
                   candidates: Sequence[FeatureMap] | None = None
                   ) -> RunResult:
    """Our algorithm with per-node DDRF; c selected on a validation split.

    ``candidates`` gives each node's draw instead of the generator: its
    candidate pool for the scored methods, its map for ``"plain"``."""
    t0 = perf_clock()
    device = train[0].x.device
    if isinstance(d_per_node, int):
        d_per_node = [d_per_node] * J
    if candidates is not None and method == "plain":
        fmaps = [fm.to(device) for fm in candidates]
    else:
        gen = _generator(seed, device)
        fmaps = [
            select_features(gen, ds.dim, d_per_node[j], SIGMA, train[j].x,
                            train[j].y, method=method,
                            candidate_ratio=candidate_ratio,
                            candidates=None if candidates is None
                            else candidates[j])
            for j in range(J)
        ]
    tr, va = _val_split(train, seed=seed)
    n = sum(t.num_samples for t in tr)
    best_c, best_v = None, np.inf
    for c in c_grid:
        solver = DeKRRSolver(TOPOLOGY, fmaps, tr,
                             DeKRRConfig(lam=LAM, c_nei=c * n),
                             device=device)
        st = solver.solve_exact()
        v = _network_rse(lambda j, x: solver.predict(st.theta, x, node=j), va)
        if v < best_v:
            best_v, best_c = v, c
    n_full = sum(t.num_samples for t in train)
    solver = DeKRRSolver(TOPOLOGY, fmaps, train,
                         DeKRRConfig(lam=LAM, c_nei=best_c * n_full),
                         device=device)
    st = solver.solve_exact()
    r = _network_rse(lambda j, x: solver.predict(st.theta, x, node=j), test)
    return RunResult(r, perf_clock() - t0, best_c)


def run_dkla(ds, train, test, d_feat, *, ddrf=False, seed=0,
             num_iters=400, fmap: FeatureMap | None = None,
             candidates: FeatureMap | None = None) -> RunResult:
    """DKLA (plain shared RFF) or DKLA-DDRF (shared features selected on
    the biggest node). ``fmap`` gives plain DKLA's map and ``candidates``
    DKLA-DDRF's candidate pool instead of the generator's draw."""
    t0 = perf_clock()
    device = train[0].x.device
    gen = _generator(seed, device)
    if ddrf:
        fmap = dkla_ddrf_feature_map(gen, ds.dim, d_feat, SIGMA, train,
                                     method="energy", candidates=candidates)
    elif fmap is None:
        fmap = sample_rff(gen, ds.dim, d_feat, SIGMA)
    dkla = DKLA(TOPOLOGY, fmap, train, DKLAConfig(lam=LAM,
                                                  num_iters=num_iters),
                device=device)
    th = dkla.solve()
    r = _network_rse(lambda j, x: dkla.predict(th, x, node=j), test)
    return RunResult(r, perf_clock() - t0)


def mean_over_seeds(fn, seeds=SEEDS):
    vals = [fn(s) for s in range(seeds)]
    rs = [v[0] for v in vals]
    ts = [v[1] for v in vals]
    return float(np.mean(rs)), float(np.std(rs)), float(np.mean(ts))


def csv_row(name: str, us_per_call: float, derived: str):
    print(f"{name},{us_per_call:.1f},{derived}")
