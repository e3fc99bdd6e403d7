"""Benchmark runner: the paper's experiments and the system benchmarks, the
counterpart of `benchmarks/run.py`. Prints ``name,us_per_call,derived``
CSV.

    python -m repro_torch.bench.run [--fast] [--only NAME[,NAME...]] \
        [--device cpu] [--subsample N|full] [--out-dir DIR]

Suites: the paper's experiments (`repro_torch.paper`: table2, fig1–fig4,
comm, convergence, ablation, at ``--subsample`` samples a dataset), the
stream bench, and the step, solve, async, chebyshev, multiout and serve
benches of this package. They run on the CUDA card unless ``--device``
names another device.

Observability (`repro_torch.obs`): every suite runs inside a host-side
span (``bench.<name>``) recorded into one `Registry`, beside the benches'
trace and latency events; the registry is written as JSONL with a
provenance block (git sha, torch and CUDA versions, the card's name and
power limit, whether the kernels ran as their plain versions) to
``DIR/run.jsonl`` — render it with ``python -m repro_torch.obs
DIR/run.jsonl`` — and each bench writes its JSON to ``DIR/<name>.json``,
stamped with the same provenance. Nothing is written outside ``DIR``
(default ``build/bench/`` at the repository root). A failed suite is
reported, the others still run, and the exit code is 1.
"""
from __future__ import annotations

import argparse
import os
import sys
import traceback
from pathlib import Path

REPO_ROOT = Path(__file__).resolve().parents[3]
DEFAULT_OUT_DIR = REPO_ROOT / "build" / "bench"


def _subsample(text: str) -> int | None:
    return None if text == "full" else int(text)


def suites() -> dict:
    """name → fn(fast, device, subsample, out, registry), in run order."""
    from repro_torch.bench import (async_gossip_bench, chebyshev_bench,
                                   multiout_bench, serve_bench, solve_bench,
                                   step_kernel_bench, stream_bench)
    from repro_torch.paper import (ablation_ddrf, comm_costs,
                                   convergence_curve, fig1_noniid_y,
                                   fig2_noniid_xnorm, fig3_imbalanced,
                                   fig4_pernode, table2)

    def paper(fn):
        return lambda fast, device, subsample, out, registry: fn(
            fast=fast, subsample=subsample, device=device)

    def bench(fn, **kw):
        return lambda fast, device, subsample, out, registry: fn(
            fast=fast, device=device, out=out, **kw,
            **({} if registry is None else {"registry": registry}))

    return {
        "table2": paper(table2.run),
        "fig1": paper(fig1_noniid_y.run),
        "fig2": paper(fig2_noniid_xnorm.run),
        "fig3": paper(fig3_imbalanced.run),
        "fig4": paper(fig4_pernode.run),
        "comm": paper(comm_costs.run),
        "convergence": paper(convergence_curve.run),
        "ablation": paper(ablation_ddrf.run),
        "chebyshev": bench(chebyshev_bench.run),
        "step": bench(step_kernel_bench.run),
        "solve": bench(solve_bench.run),
        "async": bench(async_gossip_bench.run),
        "multiout": bench(multiout_bench.run),
        "stream": lambda fast, device, subsample, out, registry:
            stream_bench.run(fast=fast, out=out, device=device),
        "serve": bench(serve_bench.run),
    }


def main(argv=None) -> int:
    from repro_torch.paper import common

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--fast", action="store_true",
                    help="the reference's reduced grids")
    ap.add_argument("--only", default=None,
                    help="run only these suites (comma-separated names)")
    ap.add_argument("--device", default=None,
                    help="device to run on (default: the CUDA card)")
    ap.add_argument("--subsample", type=_subsample,
                    default=common.SUBSAMPLE,
                    help="samples a paper dataset is cut to, or 'full' "
                         f"(default {common.SUBSAMPLE})")
    ap.add_argument("--out-dir", default=str(DEFAULT_OUT_DIR),
                    help="directory of run.jsonl and the benches' JSON "
                         "(default build/bench/)")
    args = ap.parse_args(argv)

    from repro_torch._device import resolve_device
    from repro_torch.obs.export import (provenance, stamp_provenance,
                                        write_jsonl)
    from repro_torch.obs.metrics import Registry, perf_clock
    from repro_torch.obs.spans import recording, span

    device = resolve_device(args.device)
    table = suites()
    only = None if args.only is None else args.only.split(",")
    unknown = sorted(set(only or ()) - set(table))
    if unknown:
        ap.error(f"unknown suite(s) {unknown}; choose from {sorted(table)}")
    os.makedirs(args.out_dir, exist_ok=True)
    registry = Registry(clock=perf_clock)
    print("name,us_per_call,derived")
    failed, written = [], []
    with recording(registry):
        for name, fn in table.items():
            if only is not None and name not in only:
                continue
            out = os.path.join(args.out_dir, f"{name}.json")
            t0 = perf_clock()
            try:
                with span(f"bench.{name}", fast=bool(args.fast)):
                    fn(args.fast, device, args.subsample, out, registry)
            except Exception as e:  # noqa: BLE001 — run every suite
                failed.append((name, repr(e)))
                traceback.print_exc()
                registry.counter("bench.suites_failed").inc()
                print(f"{name}/FAILED,0.0,{e!r}")
            if os.path.exists(out):
                written.append(out)
            dt = perf_clock() - t0
            registry.counter("bench.suites_run").inc()
            registry.histogram("bench.suite_seconds").observe(dt)
            print(f"{name}/total,{dt * 1e6:.0f},done", flush=True)
    prov = provenance(plain=device.type != "cuda", device=device,
                      extra={"fast": bool(args.fast), "only": args.only,
                             "subsample": args.subsample})
    stamped = [p for p in written if stamp_provenance(p, prov)]
    jsonl = write_jsonl(registry, os.path.join(args.out_dir, "run.jsonl"),
                        prov)
    print(f"telemetry written to {jsonl}; provenance stamped into "
          f"{len(stamped)} bench JSON file(s)", file=sys.stderr)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
