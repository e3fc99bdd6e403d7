"""Quickstart: decentralized KRR with data-dependent random features, the
counterpart of `examples/quickstart.py`.

Ten nodes on the paper's circulant C_10(1,2) network each select their
own random features from local data (energy scoring, D0/D = 20), build
the Eq. 17 auxiliaries with one round of neighbour exchange, then iterate
the Eq. 19 update communicating only θ_j; DKLA, which needs one shared
feature map, is the baseline.

    PYTHONPATH=src python -m repro_torch.examples.quickstart [--device cpu]

The draws are a seeded `torch.Generator`'s on the run's device
(`draw_maps`); `run` takes other maps (``fmaps=``, ``dkla_fmap=``), so a
check can feed the same draws to two devices or the reference's.
"""
from __future__ import annotations

import argparse

import torch

from repro_torch._device import resolve_device
from repro_torch.core import (DKLA, DKLAConfig, DeKRRConfig, DeKRRSolver,
                              circulant, rse, sample_rff, select_features)
from repro_torch.data.synthetic import (make_dataset, partition,
                                        train_test_split_nodes)

SUBSAMPLE = 2000
J = 10
D_FEAT = 30
SIGMA = 1.0
CANDIDATE_RATIO = 20
LAM = 1e-6
C_NEI_OVER_N = 0.005
NUM_ITERS = 400


def load(device):
    """(dataset, train, test): houses at 2,000 samples, non-IID by |y|."""
    ds = make_dataset("houses", subsample=SUBSAMPLE, seed=0)
    train, test = train_test_split_nodes(
        partition(ds, J, mode="noniid_y", device=device))
    return ds, train, test


def draw_maps(device=None):
    """(per-node DDRF maps, DKLA's shared map) from generators seeded 0
    and 50 on ``device``."""
    device = resolve_device(device)
    ds, train, _ = load(device)
    gen = torch.Generator(device=device).manual_seed(0)
    fmaps = [select_features(gen, ds.dim, D_FEAT, SIGMA, train[j].x,
                             train[j].y, method="energy",
                             candidate_ratio=CANDIDATE_RATIO)
             for j in range(J)]
    dkla_fmap = sample_rff(torch.Generator(device=device).manual_seed(50),
                           ds.dim, D_FEAT, SIGMA)
    return fmaps, dkla_fmap


def run(device=None, *, fmaps=None, dkla_fmap=None,
        verbose: bool = False) -> dict:
    """{rse, limit_rse, rho, dkla_rse}: DeKRR-DDRF's test RSE after
    NUM_ITERS rounds, its limit point's, the spectral radius of the
    iteration and DKLA's RSE; ``verbose`` prints the reference's lines."""
    device = resolve_device(device)
    ds, train, test = load(device)
    if fmaps is None or dkla_fmap is None:
        drawn = draw_maps(device)
        fmaps = drawn[0] if fmaps is None else fmaps
        dkla_fmap = drawn[1] if dkla_fmap is None else dkla_fmap
    topo = circulant(J, (1, 2))
    n = sum(t.num_samples for t in train)
    if verbose:
        print(f"dataset d={ds.dim} N={ds.num_samples}, J={J}, |N_j|=4")

    solver = DeKRRSolver(topo, fmaps, train,
                         DeKRRConfig(lam=LAM, c_nei=C_NEI_OVER_N * n,
                                     num_iters=NUM_ITERS), device=device)
    state = solver.solve()                       # decentralized iteration
    limit = solver.solve_exact()                 # its limit point
    ys = torch.cat([t.y for t in test])
    pred = torch.cat([solver.predict(state.theta, test[j].x, node=j)
                      for j in range(J)])
    pred_lim = torch.cat([solver.predict(limit.theta, test[j].x, node=j)
                          for j in range(J)])
    out = {"rse": rse(pred, ys), "limit_rse": rse(pred_lim, ys),
           "rho": float(solver.spectral_radius())}
    if verbose:
        print(f"DeKRR-DDRF   RSE = {out['rse']:.4f} "
              f"(limit point {out['limit_rse']:.4f}, "
              f"spectral radius {out['rho']:.4f})")

    dkla = DKLA(topo, dkla_fmap, train,
                DKLAConfig(lam=LAM, num_iters=NUM_ITERS), device=device)
    th = dkla.solve()
    pred_d = torch.cat([dkla.predict(th, test[j].x, node=j)
                        for j in range(J)])
    out["dkla_rse"] = rse(pred_d, ys)
    if verbose:
        print(f"DKLA (RFF)   RSE = {out['dkla_rse']:.4f}")
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None,
                    help="device to run on (default: the CUDA card)")
    args = ap.parse_args(argv)
    run(args.device, verbose=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
