"""The dry run's roofline tables as markdown: the counterpart of
`experiments/make_report.py`.

    PYTHONPATH=src python -m repro_torch.experiments.make_report \\
        [--dryrun-dir build/dryrun] [--baseline-dir DIR] \\
        [--mesh 16x16 --mesh 2x16x16]

One table a mesh over ``<dir>/<mesh>_<arch>_<shape>.json``
(`repro_torch.launch.dryrun`): the reference's architectures and shapes
in its order, a MISSING row for a pair with no record, a skip row for a
pair the registry skips, then any other record of the mesh (a shape cut
with ``--batch`` / ``--seq``). The chips in a table's header are the
records'. With ``--baseline-dir`` the same tables follow for that
directory. It reads JSON and prints; nothing runs on a device.
"""
from __future__ import annotations

import argparse
import glob
import json
import math
import os

DEFAULT_DRYRUN_DIR = "build/dryrun"
ARCH_ORDER = [
    "qwen1_5_0_5b", "llava_next_mistral_7b", "hubert_xlarge", "granite_3_8b",
    "smollm_135m", "rwkv6_7b", "qwen1_5_32b", "deepseek_moe_16b",
    "jamba_1_5_large_398b", "phi3_5_moe_42b",
]
SHAPE_ORDER = ["train_4k", "prefill_32k", "decode_32k", "long_500k"]
LEVERS = {
    "collective": "reduce per-layer activation regathers /"
                  " FSDP prefetch overlap",
    "memory": "shard or shrink the dominant resident buffer"
              " (KV cache / remat residuals)",
    "compute": "raise tensor-core utilization (larger tiles, fused"
               " featurize)",
}
BYTES_NOTE = ("memory ms is the unfused upper bound (bytes_model: "
              "\"unfused\"): operand plus result bytes of every op that is "
              "not a view, as eager PyTorch runs it")


def load(mesh: str, dirname: str = DEFAULT_DRYRUN_DIR) -> dict:
    out = {}
    for p in glob.glob(os.path.join(dirname, f"{mesh}_*.json")):
        with open(p) as f:
            r = json.load(f)
        out[(r["arch"], r["shape"])] = r
    return out


def _chips(rows: dict, mesh: str) -> int:
    """The records' chips (the mesh's size where no record has them)."""
    chips = {r["chips"] for r in rows.values() if "chips" in r}
    if len(chips) == 1:
        return chips.pop()
    return math.prod(int(v) for v in mesh.split("x"))


def _row(a: str, s: str, r: dict | None) -> str:
    if r is None:
        return f"| {a} | {s} | MISSING | | | | | | | |"
    if r.get("status") == "skip":
        return (f"| {a} | {s} | skip (encoder-only) | — | — | — | — |"
                f" — | — | — |")
    return (f"| {a} | {s} | {r['plan']} |"
            f" {(r['peak_memory_per_device'] or 0) / 2**30:.1f} |"
            f" {r['compute_s'] * 1e3:.2f} | {r['memory_s'] * 1e3:.2f} |"
            f" {r['collective_s'] * 1e3:.2f} | {r['dominant']} |"
            f" {r['useful_flops_ratio']:.2f} | {LEVERS[r['dominant']]} |")


def table(mesh: str, dirname: str = DEFAULT_DRYRUN_DIR,
          label: str = "") -> None:
    rows = load(mesh, dirname)
    print(f"\n### Mesh {mesh} ({_chips(rows, mesh)} chips){label}\n")
    print("| arch | shape | plan | mem/dev GiB | compute ms | memory ms |"
          " collective ms | dominant | useful-FLOPs | 1-sentence lever |")
    print("|---|---|---|---|---|---|---|---|---|---|")
    for a in ARCH_ORDER:
        for s in SHAPE_ORDER:
            print(_row(a, s, rows.get((a, s))))
    for (a, s), r in sorted(rows.items()):
        if a not in ARCH_ORDER or s not in SHAPE_ORDER:
            print(_row(a, s, r))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--dryrun-dir", default=DEFAULT_DRYRUN_DIR)
    ap.add_argument("--baseline-dir", default=None)
    ap.add_argument("--mesh", action="append", default=None,
                    help="a mesh's tables (default 16x16 and 2x16x16)")
    args = ap.parse_args(argv)
    meshes = args.mesh or ["16x16", "2x16x16"]
    print(BYTES_NOTE)
    for mesh in meshes:
        table(mesh, args.dryrun_dir)
    if args.baseline_dir is not None:
        for mesh in meshes:
            table(mesh, args.baseline_dir, label=" — baseline")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
