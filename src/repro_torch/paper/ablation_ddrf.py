"""Ablation: which data-dependent selection rule drives the gains?

Four per-node feature strategies at fixed D under the non-IID |y| split:
  plain-shared   — one RFF draw broadcast to all nodes (DKLA premise)
  plain-pernode  — independent RFF draws per node (flexibility alone)
  energy         — top-D by label-alignment score ([33]; the paper's choice)
  leverage       — top-D by ridge leverage ([35, 36])

The three per-node strategies are solved with the same DeKRR consensus
(c from the validation grid), so their differences isolate the
*selection rule*; plain-shared runs DKLA. plain-pernode vs plain-shared
isolates the value of per-node feature freedom; energy/leverage vs
plain-pernode isolates data dependence.
"""
from __future__ import annotations

from repro_torch.paper import common as C


def run(datasets=("houses", "twitter"), d_feat=40, fast=False, *,
        subsample=C.SUBSAMPLE, device=None):
    if fast:
        datasets = datasets[:1]
    for name in datasets:
        ds, train, test = C.load_split(name, mode="noniid_y",
                                       subsample=subsample, device=device)
        results = {}
        for method in ("plain", "energy", "leverage"):
            r, sd, t = C.mean_over_seeds(
                lambda s: C.run_dekrr_ddrf(ds, train, test, d_feat,
                                           method=method, seed=s),
                seeds=2)
            key = "plain-pernode" if method == "plain" else method
            results[key] = r
        r_shared, _, _ = C.mean_over_seeds(
            lambda s: C.run_dkla(ds, train, test, d_feat, seed=40 + s),
            seeds=2)
        results["plain-shared(DKLA)"] = r_shared
        C.csv_row(
            f"ablation/ddrf/{name}", 0.0,
            ";".join(f"{k}={v:.4f}" for k, v in results.items())
            + f";D={d_feat}")
