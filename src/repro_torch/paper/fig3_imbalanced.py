"""Fig. 3: imbalanced data (N_j = (2j−1)N/100) on twitter — equal D_j vs
√N_j-proportional D_j at the same total communication budget."""
from __future__ import annotations

import numpy as np

from repro_torch.paper import common as C

DBARS = (40, 100)


def sqrt_proportional_d(train, dbar):
    """D_j = √N_j · J·D̄ / Σ√N_j (paper §IV-B2), rounded, ≥4."""
    ns = np.array([t.num_samples for t in train], float)
    w = np.sqrt(ns)
    d = np.maximum((w * len(train) * dbar / w.sum()).round().astype(int), 4)
    return d.tolist()


def run(dataset="twitter", dbars=DBARS, fast=False, *,
        subsample=C.SUBSAMPLE, device=None):
    if fast:
        dbars = dbars[:1]
    ds, train, test = C.load_imbalanced(dataset, subsample=subsample,
                                        device=device)
    out = []
    for dbar in dbars:
        r_dkla, _, _ = C.mean_over_seeds(
            lambda s: C.run_dkla(ds, train, test, dbar, seed=80 + s))
        r_dd, _, _ = C.mean_over_seeds(
            lambda s: C.run_dkla(ds, train, test, dbar, ddrf=True,
                                 seed=80 + s))
        r_eq, _, _ = C.mean_over_seeds(
            lambda s: C.run_dekrr_ddrf(ds, train, test, dbar, seed=s))
        d_var = sqrt_proportional_d(train, dbar)
        r_var, _, t = C.mean_over_seeds(
            lambda s: C.run_dekrr_ddrf(ds, train, test, d_var, seed=s))
        out.append((dbar, r_dkla, r_dd, r_eq, r_var))
        C.csv_row(
            f"fig3/{dataset}/D{dbar}", t * 1e6,
            f"DKLA={r_dkla:.4f};DKLA-DDRF={r_dd:.4f};ours-eq={r_eq:.4f};"
            f"ours-sqrtN={r_var:.4f};comm_budget_equal=True")
    return out
