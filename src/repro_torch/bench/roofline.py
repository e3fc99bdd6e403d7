"""The dry run's roofline table: the port's counterpart of
`benchmarks/roofline.py`. It compiles nothing: it reads the JSON that
`repro_torch.launch.dryrun` wrote for each pair and prints one CSV row a
pair, ``roofline/<arch>/<shape>,0.0,<derived>``, as the reference does.

    PYTHONPATH=src python -m repro_torch.bench.roofline \\
        [--dryrun-dir build/dryrun] [--mesh 16x16] [--out-dir DIR]

With ``--out-dir`` the rows are also written to ``DIR/roofline.csv``;
nothing is written anywhere else.
"""
from __future__ import annotations

import argparse
import glob
import json
import os

DEFAULT_DRYRUN_DIR = "build/dryrun"


def rows(dryrun_dir: str = DEFAULT_DRYRUN_DIR, mesh: str = "16x16"
         ) -> list[dict]:
    """The dry run's records of ``mesh``, by file name."""
    out = []
    for path in sorted(glob.glob(os.path.join(dryrun_dir,
                                              f"{mesh}_*.json"))):
        with open(path) as f:
            out.append(json.load(f))
    return out


def csv_lines(found: list[dict], dryrun_dir: str) -> list[str]:
    """The reference's rows: a skipped pair names its plan; a traced one
    gives the three roofline terms in ms, the dominant one, memory a
    device and the useful-FLOPs ratio."""
    if not found:
        return [f"roofline/missing,0.0,no dryrun artifacts in {dryrun_dir}; "
                f"run: python -m repro_torch.launch.dryrun --all"]
    lines = []
    for r in found:
        name = f"roofline/{r['arch']}/{r['shape']}"
        if r.get("status") == "skip":
            lines.append(f"{name},0.0,plan=skip({r['plan']})")
            continue
        lines.append(
            f"{name},0.0,"
            f"compute_ms={r['compute_s'] * 1e3:.2f};"
            f"memory_ms={r['memory_s'] * 1e3:.2f};"
            f"collective_ms={r['collective_s'] * 1e3:.2f};"
            f"dominant={r['dominant']};"
            f"mem_per_dev_GiB="
            f"{(r['peak_memory_per_device'] or 0) / 2**30:.2f};"
            f"useful_flops={r['useful_flops_ratio']:.2f}")
    return lines


def run(dryrun_dir: str = DEFAULT_DRYRUN_DIR, mesh: str = "16x16",
        out_dir: str | None = None) -> list[str]:
    lines = csv_lines(rows(dryrun_dir, mesh), dryrun_dir)
    for line in lines:
        print(line)
    if out_dir is not None:
        os.makedirs(out_dir, exist_ok=True)
        with open(os.path.join(out_dir, "roofline.csv"), "w") as f:
            f.write("\n".join(lines) + "\n")
    return lines


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--dryrun-dir", default=DEFAULT_DRYRUN_DIR)
    ap.add_argument("--mesh", default="16x16")
    ap.add_argument("--out-dir", default=None)
    args = ap.parse_args(argv)
    run(args.dryrun_dir, args.mesh, args.out_dir)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
