"""Times the port's static checks (`repro_torch.analysis`) so their cost
stays visible: the counterpart of `benchmarks/analysis_bench.py`.

    python -m repro_torch.bench.analysis_bench [--out PATH]

The three passes of ``python -m repro_torch.analysis``, run as its CLI
runs them (CPU only; nothing needs a card). Rows:

  analysis/budget       every kernel's shared memory, cluster and grid at
                        the paths' shapes (V001)
  analysis/dispatch     the solver entry points' kernel dispatches
                        against their contract, four CPU ranks for the
                        SPMD ones (J002)
  analysis/conventions  the AST lint of `src/repro_torch/` and
                        `tests/test_torch_*.py` (`conventions.
                        default_paths`)
  analysis/clean        1 iff no pass found anything

The reference's ``analysis/jaxpr`` row has no counterpart: PyTorch has no
traced program to lint, so the port's dispatch pass counts dispatches as
the entry points run instead (see `repro_torch/analysis/__init__.py`).
Any finding raises `RuntimeError`, as the reference's bench does.
"""
from __future__ import annotations

import argparse
import sys

from repro_torch.analysis.__main__ import REPO_ROOT
from repro_torch.bench.common import write_json
from repro_torch.obs.metrics import perf_clock
from repro_torch.paper.common import csv_row


def run(fast: bool = False, *, out: str | None = None, device=None,
        registry=None, repo_root: str = REPO_ROOT,
        paths: list[str] | None = None) -> dict:
    """Run and time the three passes; ``paths`` replaces the conventions
    pass's default paths. Returns {pass: {seconds, findings}} and writes
    the rows as JSON to ``out`` when given. ``fast`` and ``device`` are
    the runner's arguments: every pass runs whole, on the CPU."""
    from repro_torch.analysis import conventions, dispatch, smem

    passes = {
        "budget": smem.run_pass,
        "dispatch": dispatch.run_pass,
        "conventions": lambda: conventions.run_pass(
            paths or conventions.default_paths(repo_root),
            repo_root=repo_root),
    }
    found, rows = [], {}
    for name, fn in passes.items():
        t0 = perf_clock()
        findings = fn()
        secs = perf_clock() - t0
        csv_row(f"analysis/{name}", secs * 1e6, f"{len(findings)} findings")
        if registry is not None:
            registry.gauge(f"analysis.{name}.seconds").set(secs)
        rows[name] = {"seconds": secs, "findings": len(findings)}
        found += findings
    clean = int(not found)
    csv_row("analysis/clean", 0.0, str(clean))
    if out is not None:
        write_json({"benchmark": "static checks of the port, timed",
                    "passes": rows, "clean": clean}, out)
    if not clean:
        for f in found:
            print(f"#   {f.render()}")
        raise RuntimeError(f"{len(found)} analysis finding(s)")
    return rows


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=None,
                    help="write the rows as JSON to this path")
    args = ap.parse_args(argv)
    run(out=args.out)
    return 0


if __name__ == "__main__":
    sys.exit(main())
