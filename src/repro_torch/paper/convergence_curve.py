"""§III: objective descent under the Prop. 1 condition + spectral radius of
the Eq. 19 iteration map."""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core import (DeKRRConfig, DeKRRSolver, prop1_required_c_self,
                              select_features)
from repro_torch.obs.metrics import perf_clock
from repro_torch.paper import common as C


def run(dataset="air_quality", d_feat=24, fast=False, *,
        subsample=C.SUBSAMPLE, device=None):
    ds, train, test = C.load_split(dataset, mode="noniid_y",
                                   subsample=subsample, device=device)
    dev = train[0].x.device
    gen = torch.Generator(device=dev).manual_seed(0)
    fmaps = [select_features(gen, ds.dim, d_feat, C.SIGMA, train[j].x,
                             train[j].y, method="energy")
             for j in range(C.J)]
    n = sum(t.num_samples for t in train)

    base = DeKRRSolver(C.TOPOLOGY, fmaps, train,
                       DeKRRConfig(lam=C.LAM, c_nei=0.01 * n,
                                   c_self_ratio=1.0),
                       build_aux=False, device=dev)
    req = prop1_required_c_self(base)
    ratio = float(np.max(req / (0.01 * n))) * 1.2 + 1.0

    t0 = perf_clock()
    solver = DeKRRSolver(C.TOPOLOGY, fmaps, train,
                         DeKRRConfig(lam=C.LAM, c_nei=0.01 * n,
                                     c_self_ratio=min(ratio, 50.0)),
                         device=dev)
    state = solver.init_state()
    objs = [float(solver.objective(state.theta))]
    iters = 10 if fast else 40
    for _ in range(iters):
        state = solver.step(state)
        objs.append(float(solver.objective(state.theta)))
    dt = perf_clock() - t0
    monotone = all(b <= a + 1e-12 for a, b in zip(objs, objs[1:]))
    rho = solver.spectral_radius()
    C.csv_row(
        f"convergence/{dataset}", dt / max(iters, 1) * 1e6,
        f"monotone={monotone};obj0={objs[0]:.6f};objK={objs[-1]:.6f};"
        f"spectral_radius={rho:.5f};prop1_ratio_used={min(ratio, 50.0):.1f}")
    return objs
