"""Perf-iteration probe: one (arch × shape) pair traced with optional
configuration overrides, printing its memory a device, the roofline
terms and the top collective and memory contributors: the counterpart of
`experiments/perf_probe.py`.

    PYTHONPATH=src python -m repro_torch.experiments.perf_probe \\
        --arch qwen1_5_0_5b --shape train_4k [--set remat=false] \\
        [--mesh 16x16] [--multi-pod] [--batch B] [--seq S] \\
        [--policy tp|dp] [--top 12] [--json-out PATH]

The pair is traced as the dry run traces it
(`repro_torch.launch.dryrun.trace_pair`: a ``fake`` process group of the
mesh's world size, arguments under ``FakeTensorMode``, one step under
`CostMode`), so nothing runs on a device. The fake group is global to
its process: run the probe in a process of its own. ``--set k=v``
replaces a field of the pair's `ModelConfig` (``none``, ``true`` /
``false``, ints, floats and Python literals such as tuples; anything else
stays a string) and the step is built against the result
(`input_specs(overrides=)`). Times are the port's H100 constants
(`repro_torch.launch.mesh`: 989 TFLOP/s bf16, 3.35 TB/s, NVLink 450 GB/s
a direction); the memory term is the unfused upper bound. The counts of
the top lists are how many times an op ran (the port has no loop trip
counts). ``--json-out`` writes {peak, flops, hbm, coll}, the reference's
keys.
"""
from __future__ import annotations

import argparse
import ast
import json

from repro_torch.configs.registry import INPUT_SHAPES, get_arch
from repro_torch.launch.dryrun import pair_shape, trace_pair
from repro_torch.launch.mesh import (HBM_BANDWIDTH, LINK_BANDWIDTH,
                                     PEAK_FLOPS_BF16)


def parse_override(kv: str):
    """``k=v`` → (k, value): ``none`` → None, ``true``/``false`` → bool,
    then int, float, a Python literal (a tuple), else the text."""
    k, v = kv.split("=", 1)
    if v == "none":
        return k, None
    if v in ("true", "false"):
        return k, v == "true"
    for conv in (int, float):
        try:
            return k, conv(v)
        except ValueError:
            pass
    try:
        return k, ast.literal_eval(v)
    except (ValueError, SyntaxError):
        return k, v


def probe(arch: str, shape_name: str, overrides: dict, *,
          multi_pod: bool = False, mesh_grid: tuple[int, int] = (16, 16),
          batch: int | None = None, seq: int | None = None, top: int = 12,
          json_out: str | None = None, policy: str = "tp") -> dict:
    """Trace the pair, print the probe's report and return {peak, flops,
    hbm, coll} (written to ``json_out`` when given)."""
    shape = pair_shape(shape_name, batch, seq)
    _, costs, chips, trace_s = trace_pair(
        get_arch(arch), shape, multi_pod=multi_pod, mesh_grid=mesh_grid,
        policy=policy, overrides=overrides)
    tot_coll = sum(costs.coll_bytes.values())
    print(f"\n=== {arch} × {shape.name} on {chips} ranks "
          f"{'(multi-pod) ' if multi_pod else ''}overrides={overrides} ===")
    print(f"trace {trace_s:.0f}s   mem/dev {costs.peak_memory / 2**30:.2f} "
          f"GiB")
    print(f"compute    {costs.flops / PEAK_FLOPS_BF16 * 1e3:10.2f} ms"
          f"  ({costs.flops:.3e} flops/dev)")
    print(f"memory     {costs.bytes / HBM_BANDWIDTH * 1e3:10.2f} ms"
          f"  ({costs.bytes:.3e} B/dev, unfused upper bound)")
    print(f"collective {tot_coll / LINK_BANDWIDTH * 1e3:10.2f} ms"
          f"  ({tot_coll:.3e} B/dev)")
    print("by kind: " + "  ".join(
        f"{k}={v / 2**30:.2f}GiB" for k, v in costs.coll_bytes.items() if v))
    print("\ntop collectives (bytes × count):")
    for byts, kind, shp, m, name in costs.top_collectives[:top]:
        print(f"  {byts / 2**30:8.3f} GiB  {kind:18s} ×{int(m):4d}  "
              f"{shp:42s} {name[-60:]}")
    print("\ntop memory ops:")
    for byts, op, shp, m in costs.top_memory_ops[:top]:
        print(f"  {byts / 2**30:8.3f} GiB  {op:22s} ×{int(m):4d}  {shp}")
    out = {"peak": float(costs.peak_memory), "flops": costs.flops,
           "hbm": costs.bytes, "coll": dict(costs.coll_bytes)}
    if json_out:
        with open(json_out, "w") as f:
            json.dump(out, f, default=float)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", required=True)
    ap.add_argument("--shape", required=True, choices=list(INPUT_SHAPES))
    ap.add_argument("--set", action="append", default=[],
                    help="k=v: replace a field of the pair's configuration")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--mesh", default="16x16",
                    help="data x model grid, e.g. 16x16, 2x2 or 1x1")
    ap.add_argument("--batch", type=int, default=None,
                    help="replace the shape's global batch")
    ap.add_argument("--seq", type=int, default=None,
                    help="replace the shape's sequence length")
    ap.add_argument("--top", type=int, default=12)
    ap.add_argument("--json-out", default=None)
    ap.add_argument("--policy", default="tp", choices=["tp", "dp"])
    a = ap.parse_args(argv)
    try:
        grid = tuple(int(v) for v in a.mesh.split("x"))
    except ValueError:
        grid = ()
    if len(grid) != 2:
        ap.error(f"--mesh must be DxM (e.g. 2x2), got {a.mesh!r}")
    probe(a.arch, a.shape, dict(parse_override(s) for s in a.set),
          multi_pod=a.multi_pod, mesh_grid=grid, batch=a.batch, seq=a.seq,
          top=a.top, json_out=a.json_out, policy=a.policy)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
