"""Fig. 4: per-node RSE under the imbalanced split (D̄=100). Shows the
big-data nodes (j=6..10) improving when D_j ∝ √N_j."""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core import DeKRRConfig, DeKRRSolver, rse, select_features
from repro_torch.paper import common as C
from repro_torch.paper.fig3_imbalanced import sqrt_proportional_d


def run(dataset="twitter", dbar=100, fast=False, *, subsample=C.SUBSAMPLE,
        device=None):
    if fast:
        dbar = 40
    ds, train, test = C.load_imbalanced(dataset, subsample=subsample,
                                        device=device)
    n = sum(t.num_samples for t in train)

    def per_node_rse(d_per_node):
        gen = torch.Generator(device=train[0].x.device).manual_seed(0)
        fmaps = [select_features(gen, ds.dim, d_per_node[j], C.SIGMA,
                                 train[j].x, train[j].y, method="energy")
                 for j in range(C.J)]
        solver = DeKRRSolver(C.TOPOLOGY, fmaps, train,
                             DeKRRConfig(lam=C.LAM, c_nei=0.01 * n),
                             device=train[0].x.device)
        st = solver.solve_exact()
        return [rse(solver.predict(st.theta, test[j].x, node=j), test[j].y)
                for j in range(C.J)]

    eq = per_node_rse([dbar] * C.J)
    var = per_node_rse(sqrt_proportional_d(train, dbar))
    big_eq = float(np.mean(eq[5:]))
    big_var = float(np.mean(var[5:]))
    C.csv_row(f"fig4/{dataset}", 0.0,
              f"per_node_eq={[round(v,3) for v in eq]};"
              f"per_node_sqrtN={[round(v,3) for v in var]};"
              f"bignode_eq={big_eq:.4f};bignode_sqrtN={big_var:.4f}")
    return eq, var
