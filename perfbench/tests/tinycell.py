"""A tiny cell for the CPU tests: a copy of the benchmark's data files
with one configuration cut to a few hundred samples and a few features a
node, added as new files and new ``BENCHMARK.json`` entries only."""
from __future__ import annotations

import json
import shutil
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]


def make_root(tmp: Path, base: str = "table2-wave", name: str = "tiny",
              **overrides) -> Path:
    """A checkout-like root under ``tmp`` holding ``BENCHMARK.json`` and
    ``perfbench/`` with the cell ``<name>-fit`` on configuration ``name``
    (``base`` cut to 400 samples, D̄ 6) and the limits of ``base``'s cell."""
    root = tmp / "root"
    shutil.copytree(ROOT / "perfbench", root / "perfbench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    shutil.copy(ROOT / "BENCHMARK.json", root / "BENCHMARK.json")
    bench = json.loads((root / "BENCHMARK.json").read_text())
    base_entry = next(c for c in bench["configs"] if c["name"] == base)
    cfg = json.loads((ROOT / base_entry["file"]).read_text())
    cfg.update(N=400, dbar=6)
    for key in ("node_samples", "node_features"):
        cfg.pop(key, None)
    cfg.update(overrides)
    (root / "perfbench" / "configs" / f"{name}.json").write_text(
        json.dumps(cfg))
    cell = f"{name}-fit"
    base_cell = next(w["name"] for w in bench["workloads"]
                     if w["config"] == base)
    shutil.copy(root / "perfbench" / "limits" / f"{base_cell}.json",
                root / "perfbench" / "limits" / f"{cell}.json")
    bench["configs"].append(dict(name=name, source=base_entry["source"],
                                 file=f"perfbench/configs/{name}.json",
                                 reduced=["data"], why="a CPU test"))
    bench["workloads"].append(dict(name=cell, config=name,
                                   traffic="fit-closed-loop", chips=1,
                                   why="a CPU test"))
    for m in bench["per_layer"]:
        m["workloads"].append(cell)
    (root / "BENCHMARK.json").write_text(json.dumps(bench, indent=1))
    return root
