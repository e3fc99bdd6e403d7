"""Run the paper's experiments and print their CSV rows.

    python -m repro_torch.paper table2 [--fast] [--subsample N|full] \
        [--device cpu]

Runs on the CUDA card unless ``--device`` names another device;
``--subsample full`` takes each synthetic stand-in at its full N.
"""
from __future__ import annotations

import argparse
import sys

from repro_torch._device import resolve_device
from repro_torch.paper import (ablation_ddrf, comm_costs, common,
                               convergence_curve, fig1_noniid_y,
                               fig2_noniid_xnorm, fig3_imbalanced,
                               fig4_pernode, table2)

EXPERIMENTS = {
    "table2": table2.run, "fig1": fig1_noniid_y.run,
    "fig2": fig2_noniid_xnorm.run, "fig3": fig3_imbalanced.run,
    "fig4": fig4_pernode.run, "ablation": ablation_ddrf.run,
    "comm": comm_costs.run, "convergence": convergence_curve.run,
}


def _subsample(text: str) -> int | None:
    return None if text == "full" else int(text)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("experiment", choices=sorted(EXPERIMENTS) + ["all"])
    ap.add_argument("--fast", action="store_true",
                    help="the reference's reduced sweep of each experiment")
    ap.add_argument("--subsample", type=_subsample,
                    default=common.SUBSAMPLE,
                    help="samples a dataset is cut to, or 'full' "
                         f"(default {common.SUBSAMPLE})")
    ap.add_argument("--device", default=None,
                    help="device to run on (default: the CUDA card)")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    names = sorted(EXPERIMENTS) if args.experiment == "all" \
        else [args.experiment]
    for name in names:
        EXPERIMENTS[name](fast=args.fast, subsample=args.subsample,
                          device=device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
