"""CLI for the port's static checks: ``python -m repro_torch.analysis``.

Three passes, each reporting `Finding`s (the process exits nonzero iff
any has error severity):

``budget``       every kernel's shared memory, cluster and grid at the
                 shapes of the paths `chip_smoke.py` drives
                 (`repro_torch.analysis.smem.path_estimates`; V001);
``dispatch``     each solver entry point run on a small CPU problem,
                 its kernel dispatches against the `round_dispatches`
                 contract (`repro_torch.analysis.dispatch`; J002);
``conventions``  the AST lint of `src/repro_torch/` and
                 `tests/test_torch_*.py` (R001, R004, R005, R006).

Everything runs on the CPU; nothing needs a card.
"""
from __future__ import annotations

import argparse
import os
import sys

from repro_torch.obs.metrics import perf_clock

_PASSES = ("budget", "dispatch", "conventions")
REPO_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.dirname(os.path.abspath(__file__)))))


def main(argv: list[str] | None = None) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis",
        description="Static checks of the PyTorch/CUDA port.")
    parser.add_argument(
        "paths", nargs="*", default=None,
        help="files/dirs for the conventions pass (default: "
             "src/repro_torch and tests/test_torch_*.py)")
    parser.add_argument(
        "--format", choices=("text", "json"), default="text")
    parser.add_argument(
        "--pass", dest="passes", action="append", choices=_PASSES,
        help="run only the named pass(es); default: all")
    parser.add_argument(
        "--repo-root", default=REPO_ROOT,
        help="root for relative finding locations and the default paths")
    args = parser.parse_args(argv)

    passes = tuple(args.passes) if args.passes else _PASSES
    findings = []
    timings: dict[str, float] = {}
    for name in passes:
        t0 = perf_clock()
        if name == "budget":
            from repro_torch.analysis import smem
            findings += smem.run_pass()
        elif name == "dispatch":
            from repro_torch.analysis import dispatch
            findings += dispatch.run_pass()
        else:
            from repro_torch.analysis import conventions
            root = os.path.abspath(args.repo_root)
            paths = args.paths or conventions.default_paths(root)
            findings += conventions.run_pass(paths, repo_root=root)
        timings[name] = perf_clock() - t0

    from repro_torch.analysis.report import render_json, render_report

    if args.format == "json":
        extra = {"passes": list(passes),
                 "timings_s": {k: round(v, 3) for k, v in timings.items()}}
        print(render_json(findings, extra=extra))
    else:
        print(render_report(findings))
        for name in passes:
            print(f"{name}: {timings[name]:.2f}s")
    return 1 if any(f.severity == "error" for f in findings) else 0


if __name__ == "__main__":
    sys.exit(main())
