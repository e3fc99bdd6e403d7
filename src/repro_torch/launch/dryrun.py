"""Dry run: every (architecture × input shape) on the production meshes,
with memory, cost and collectives per device: the port's counterpart of
`repro.launch.dryrun`.

The reference lowers and compiles each pair for placeholder devices. The
port inits the ``fake`` process group at the mesh's world size (this
process is rank 0 of it; a collective returns at once), builds every
argument under ``FakeTensorMode`` placed by the sharding rules, runs the
step once under `repro_torch.launch.cost_analysis.CostMode` and writes
the JSON. Nothing runs on a device and nothing is allocated at size.
Decode pairs run the chunked attention (``backend="torch"``, the
reference's own decode function): fake tensors launch no kernel.

The fake group is global to its process, so run the dry run in a process
of its own (tests start it as a subprocess):

  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen1_5_0_5b \\
      --shape decode_32k --mesh 4x4 --out DIR
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all [--multi-pod]
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen1_5_0_5b \
      --shape train_4k --batch 8 --seq 256 --mesh 1x1 --out DIR

Each pair writes ``<out>/<mesh>_<arch>_<shape>.json`` with the
reference's keys (``lower_s`` and ``compile_s`` become ``trace_s``) and
``bytes_model: "unfused"``; a pair the registry skips writes
``status: "skip"``.
"""
from __future__ import annotations

import argparse
import dataclasses
import gc
import json
import os
import traceback

from repro_torch.configs.registry import (INPUT_SHAPES, ShapeSpec, get_arch,
                                          list_archs)
from repro_torch.launch.cost_analysis import (analyze, model_flops_per_step,
                                              roofline)
from repro_torch.launch.specs import input_specs, shape_plan
from repro_torch.models.model import active_param_count, analytic_param_count
from repro_torch.obs.metrics import perf_clock


def init_fake_group(world_size: int) -> None:
    """This process as rank 0 of a ``fake`` group of ``world_size``
    ranks (`torch.testing`'s FakeStore: collectives return at once)."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore

    if dist.is_initialized():
        if dist.get_world_size() != world_size:
            raise RuntimeError(f"dryrun: the process group has "
                               f"{dist.get_world_size()} ranks, the mesh "
                               f"needs {world_size}")
        return
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world_size)


def mesh_name(multi_pod: bool, grid: tuple[int, int]) -> str:
    return (f"2x{grid[0]}x{grid[1]}" if multi_pod
            else f"{grid[0]}x{grid[1]}")


def pair_shape(shape_name: str, batch: int | None = None,
               seq: int | None = None) -> ShapeSpec:
    """The named input shape; ``batch`` and ``seq`` replace its global
    batch and sequence (the shape is then named
    ``<shape>@b<batch>s<seq>``), for a pair that fits a small mesh."""
    shape = INPUT_SHAPES[shape_name]
    if batch is None and seq is None:
        return shape
    batch = shape.global_batch if batch is None else batch
    seq = shape.seq_len if seq is None else seq
    return dataclasses.replace(shape, name=f"{shape_name}@b{batch}s{seq}",
                               global_batch=batch, seq_len=seq)


def trace_pair(spec, shape: ShapeSpec, *, multi_pod: bool = False,
               mesh_grid: tuple[int, int] = (16, 16), policy: str = "tp",
               overrides: dict | None = None):
    """Trace one pair's step once under `CostMode` on the fake group of
    the mesh's world size (this process as its rank 0): (the pair's
    configuration, its `Costs`, chips, seconds). ``policy`` and
    ``overrides`` go to `ShardingRules` and `input_specs`."""
    import torch
    from torch._subclasses.fake_tensor import FakeTensorMode

    from repro_torch.launch.mesh import make_production_mesh
    from repro_torch.launch.sharding import ShardingRules

    data_ax, model_ax = mesh_grid
    chips = (2 if multi_pod else 1) * data_ax * model_ax
    init_fake_group(chips)
    t0 = perf_clock()
    mesh = make_production_mesh(multi_pod=multi_pod, data=data_ax,
                                model=model_ax, device_type="cpu")
    rules = ShardingRules(mesh, policy=policy)
    with FakeTensorMode(allow_non_fake_inputs=True), torch.no_grad():
        pair = input_specs(spec, shape, rules, device="cpu",
                           backend="torch", overrides=overrides)
        cfg = pair["cfg"]
        _, costs = analyze(pair["fn"], *pair["args"])
        del pair
        gc.collect()
    return cfg, costs, chips, perf_clock() - t0


def run_pair(arch: str, shape_name: str, *, multi_pod: bool = False,
             mesh_grid: tuple[int, int] = (16, 16),
             out_dir: str | None = None, verbose: bool = True,
             batch: int | None = None, seq: int | None = None) -> dict:
    """One pair: its JSON record (written under ``out_dir``). ``batch``
    and ``seq`` replace the named shape's global batch and sequence
    (`pair_shape`)."""
    spec = get_arch(arch)
    shape = pair_shape(shape_name, batch, seq)
    shape_name = shape.name
    plan = shape_plan(spec, shape)
    name = mesh_name(multi_pod, mesh_grid)
    result: dict = {"arch": arch, "shape": shape_name, "mesh": name,
                    "plan": plan}
    if plan == "skip":
        result["status"] = "skip"
        _write(result, out_dir)
        return result

    cfg, costs, chips, trace_s = trace_pair(spec, shape, multi_pod=multi_pod,
                                            mesh_grid=mesh_grid)
    roof = roofline(costs)
    n_total = analytic_param_count(cfg)
    n_active = active_param_count(cfg)
    mf = model_flops_per_step(cfg, shape, n_active)
    total_flops = roof.flops * chips
    result.update(
        status="ok",
        chips=chips,
        trace_s=round(trace_s, 1),
        params_total=n_total,
        params_active=n_active,
        model_flops=mf,
        hlo_total_flops=total_flops,
        useful_flops_ratio=(mf / total_flops if total_flops else 0),
        bytes_model="unfused",
        **roof.as_dict(),
    )
    result["memory_analysis"] = {"argument_size": costs.argument_bytes,
                                 "ops": costs.ops}
    result["collective_ops_per_device"] = dict(costs.coll_ops)
    if verbose:
        print(f"[{name}] {arch} × {shape_name} ({plan}): "
              f"trace {trace_s:.0f}s  "
              f"mem/dev {(result['peak_memory_per_device'] or 0)/2**30:.2f}GiB"
              f"  compute {roof.compute_s*1e3:.2f}ms  "
              f"memory {roof.memory_s*1e3:.2f}ms  "
              f"collective {roof.collective_s*1e3:.2f}ms  "
              f"→ {roof.dominant}-bound  "
              f"useful-flops {result['useful_flops_ratio']:.2f}", flush=True)
    _write(result, out_dir)
    return result


def _write(result: dict, out_dir: str | None) -> None:
    if not out_dir:
        return
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(
        out_dir, f"{result['mesh']}_{result['arch']}_{result['shape']}.json")
    with open(path, "w") as f:
        json.dump(result, f, indent=2, default=float)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None,
                    choices=list(INPUT_SHAPES) + [None])
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--mesh", default="16x16",
                    help="data x model grid, e.g. 16x16 (production), 4x4 "
                         "or 1x1")
    ap.add_argument("--out", default="build/dryrun")
    ap.add_argument("--batch", type=int, default=None,
                    help="replace the shape's global batch")
    ap.add_argument("--seq", type=int, default=None,
                    help="replace the shape's sequence length")
    args = ap.parse_args(argv)
    try:
        mesh_grid = tuple(int(v) for v in args.mesh.split("x"))
    except ValueError:
        mesh_grid = ()
    if len(mesh_grid) != 2:
        ap.error(f"--mesh must be DxM (e.g. 4x4), got {args.mesh!r}")

    if args.all:
        pairs = [(a, s) for a in list_archs() for s in INPUT_SHAPES]
    else:
        archs = [args.arch] if args.arch else list_archs()
        shapes = [args.shape] if args.shape else list(INPUT_SHAPES)
        pairs = [(a, s) for a in archs for s in shapes]

    failures = []
    for arch, shape in pairs:
        try:
            run_pair(arch, shape, multi_pod=args.multi_pod,
                     mesh_grid=mesh_grid, out_dir=args.out,
                     batch=args.batch, seq=args.seq)
        except Exception as e:  # noqa: BLE001 — report every pair
            failures.append((arch, shape, repr(e)))
            print(f"FAILED {arch} × {shape}: {e}", flush=True)
            traceback.print_exc()
    if failures:
        print(f"\n{len(failures)} pair(s) failed:")
        for a, s, e in failures:
            print(f"  {a} × {s}: {e}")
        raise SystemExit(1)
    print("\nall pairs traced OK")


if __name__ == "__main__":
    main()
