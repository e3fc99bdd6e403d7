"""Fig. 1: RSE vs average features-per-node D̄, non-IID by |y|."""
from __future__ import annotations

from repro_torch.paper import common as C

DBARS = (20, 40, 80, 160)


def run(datasets=("houses", "twitter"), dbars=DBARS, fast=False, *,
        subsample=C.SUBSAMPLE, device=None):
    if fast:
        datasets, dbars = datasets[:1], dbars[:2]
    out = []
    for name in datasets:
        ds, train, test = C.load_split(name, mode="noniid_y",
                                       subsample=subsample, device=device)
        for dbar in dbars:
            r_dkla, _, _ = C.mean_over_seeds(
                lambda s: C.run_dkla(ds, train, test, dbar, seed=60 + s))
            r_ours, sd, t = C.mean_over_seeds(
                lambda s: C.run_dekrr_ddrf(ds, train, test, dbar, seed=s))
            out.append((name, dbar, r_dkla, r_ours))
            C.csv_row(f"fig1/{name}/D{dbar}", t * 1e6,
                      f"DKLA={r_dkla:.4f};ours={r_ours:.4f};std={sd:.4f}")
    return out
