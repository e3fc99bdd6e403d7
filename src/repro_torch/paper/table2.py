"""Table 2: RSE of DKLA / DKLA-DDRF / DeKRR-DDRF on the six datasets under
the non-IID |y| split, at the paper's per-dataset D̄."""
from __future__ import annotations

from repro_torch.paper import common as C


def run(datasets=None, fast=False, *, subsample=C.SUBSAMPLE, device=None):
    """One row (name, D̄, DKLA, DKLA-DDRF, ours, improvement %) a dataset,
    each RSE a mean over ``SEEDS`` seeds."""
    datasets = datasets or list(C.PAPER_DBAR)
    if fast:
        datasets = datasets[:2]
    rows = []
    for name in datasets:
        dbar = C.PAPER_DBAR[name]
        ds, train, test = C.load_split(name, mode="noniid_y",
                                       subsample=subsample, device=device)

        r_dkla, _, t_dkla = C.mean_over_seeds(
            lambda s: C.run_dkla(ds, train, test, dbar, seed=50 + s))
        r_dd, _, t_dd = C.mean_over_seeds(
            lambda s: C.run_dkla(ds, train, test, dbar, ddrf=True,
                                 seed=50 + s))
        r_ours, _, t_ours = C.mean_over_seeds(
            lambda s: C.run_dekrr_ddrf(ds, train, test, dbar, seed=s))

        imp = 100.0 * (r_dkla - r_ours) / max(r_dkla, 1e-12)
        rows.append((name, dbar, r_dkla, r_dd, r_ours, imp))
        C.csv_row(
            f"table2/{name}", t_ours * 1e6,
            f"D={dbar};DKLA={r_dkla:.4f};DKLA-DDRF={r_dd:.4f};"
            f"ours={r_ours:.4f};improvement={imp:.1f}%")
    mean_imp = sum(r[5] for r in rows) / len(rows)
    C.csv_row("table2/mean_improvement", 0.0,
              f"mean_rse_improvement_vs_DKLA={mean_imp:.1f}%"
              f";paper_claims=25.5%")
    return rows
