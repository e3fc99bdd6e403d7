"""Run one cell of the benchmark once.

    python3 perfbench/run.py --workload <name> --seed <n> --seconds <s> \
        --trace <0|1> [--control 1]

From the root of a checkout. Everything is found by name from the
cell's entry in ``BENCHMARK.json``: the configuration's file, the
traffic mix (``perfbench/traffic/<traffic>.json``), the generator that
the mix names (``perfbench/generators/<generator>.py``), the limits of
the cell's output check (``perfbench/limits/<workload>.json``) and each
per-layer metric's reader (``perfbench/metrics/<metric>.py``). A cell,
a mix, a generator or a metric is added as files and entries, with no
edit to this one.

The generator makes the inputs from the seed and stages them on the
card (kernels build under ``build/repro_torch/`` in the checkout),
warms up every shape the window uses, then runs its work for
``--seconds``, ending at the first boundary after that. Everything
before the window is ``setup_s``; the other end-to-end values are the
generator's. After the window the generator holds a sample of the
window's outputs, drawn from the seed, against the plain reference.
The last line of standard output is one JSON object; the numbers
compared, each beside its limit, are the last lines of standard error
and the result's last key. ``--control 1`` also reads the check's
control on the same outputs (the readings the limits are set from).

``--trace 1`` reports the per-layer metrics instead of the end-to-end
ones, read from the profiler's record of a stated run of whole units
of work and from the generator's own clocks and the program's spans.

It refuses to run without a CUDA card, and exits without a result if
JAX or the JAX package was loaded.
"""
from __future__ import annotations

import time

T0 = time.perf_counter()

import sys
from pathlib import Path

# Run as a script, Python puts this folder first on the path, where its
# module names (trace, data, check) would shadow others.
_HERE = str(Path(__file__).resolve().parent)
sys.path[:] = [p for p in sys.path if p and str(Path(p).resolve()) != _HERE]

import argparse
import dataclasses
import importlib
import importlib.util
import json
import math
import os
import subprocess

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def _use_checkout(root: Path) -> None:
    for p in (str(root), str(root / "src")):
        if p not in sys.path:
            sys.path.insert(0, p)
    os.environ["REPRO_TORCH_BUILD_ROOT"] = str(root / "build" / "repro_torch")


def forbidden_modules() -> list[str]:
    """Loaded modules whose top-level name is JAX's or the JAX package's."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def load_json(path: Path):
    with open(path) as f:
        return json.load(f)


def applies(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


@dataclasses.dataclass
class Cell:
    name: str
    config: dict        # the configuration file
    traffic: dict
    end_to_end: list[dict]
    per_layer: list[dict]
    chips: int


def resolve(root: Path, workload: str) -> Cell:
    """A cell of ``BENCHMARK.json`` and the files it names."""
    bench = load_json(root / "BENCHMARK.json")
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise KeyError(f"no workload {workload!r}; have {sorted(cells)}")
    cell = cells[workload]
    configs = {c["name"]: c for c in bench["configs"]}
    config = load_json(root / configs[cell["config"]]["file"])
    config["name"] = cell["config"]
    traffic = load_json(root / "perfbench" / "traffic"
                        / f"{cell['traffic']}.json")
    return Cell(name=workload, config=config, traffic=traffic,
                end_to_end=[m for m in bench["end_to_end"]
                            if applies(m, workload)],
                per_layer=[m for m in bench["per_layer"]
                           if applies(m, workload)],
                chips=int(cell["chips"]))


def _load(path: Path, name: str):
    """The module in the file ``path``, under the module name ``name``."""
    name = name.replace(".", "_").replace("-", "_")
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod
    spec.loader.exec_module(mod)
    return mod


def reader(root: Path, metric: str):
    """The ``read(records)`` function of ``perfbench/metrics/<metric>.py``."""
    return _load(root / "perfbench" / "metrics" / f"{metric}.py",
                 "perfbench_metric_" + metric).read


def generator(root: Path, name: str):
    """The module ``perfbench/generators/<name>.py``: ``build``,
    ``warm_up``, ``window``, ``check`` and ``records`` (and, optionally,
    ``describe``) of one kind of traffic."""
    return _load(root / "perfbench" / "generators" / f"{name}.py",
                 "perfbench_generator_" + name)


def load_limits(root: Path, workload: str) -> dict[str, float]:
    """The limits of a cell's output check, ``perfbench/limits/<cell>.json``."""
    with open(root / "perfbench" / "limits" / f"{workload}.json") as f:
        return {k: float(v) for k, v in json.load(f)["limits"].items()}


def verdict(numbers: dict[str, float], limits: dict[str, float]) -> bool:
    """Every number compared is finite and within its limit, and every
    number has a limit and every limit a number."""
    return set(numbers) == set(limits) and all(
        math.isfinite(numbers[k]) and numbers[k] <= limits[k]
        for k in limits)


def _power_limit() -> str:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30)
        return out.stdout.strip() or "unknown"
    except (OSError, subprocess.SubprocessError):
        return "unknown"


def _host_clock() -> tuple[float, float, float]:
    """(process CPU seconds, host jiffies stolen by the hypervisor, all
    host jiffies) — to tell the program's host time from the host's."""
    t = os.times()
    try:
        with open("/proc/stat") as f:
            cpu = [int(v) for v in f.readline().split()[1:]]
        steal, total = float(cpu[7]), float(sum(cpu))
    except (OSError, IndexError, ValueError):
        steal = total = math.nan
    return t.user + t.system, steal, total


def _log(*args) -> None:
    print(*args, file=sys.stderr, flush=True)


def run_cell(root: Path, workload: str, seed: int, seconds: float,
             trace: bool, device: str = "cuda", t0: float | None = None,
             control: bool = False):
    """One run of a cell → (result dict, [(number, value, limit)]).

    The cell's mix names its generator, which builds the inputs, warms
    up, runs the window and checks the window's outputs; this function
    times set-up, reads the device, and reports the end-to-end values
    the generator returns or the per-layer readers' values. With
    ``control`` the check also reports the control's readings."""
    import torch

    from perfbench import trace as btrace

    t0 = T0 if t0 is None else t0
    cell = resolve(root, workload)
    gen = generator(root, cell.traffic["generator"])
    limits = load_limits(root, workload)
    t_imports = time.perf_counter()
    prob = gen.build(cell.config, cell.traffic, seed, device)
    t_inputs = time.perf_counter()
    gen.warm_up(prob, trace)
    host0 = _host_clock()
    win = gen.window(prob, seed, seconds, trace)
    host1 = _host_clock()
    setup_s = win.t_start - t0
    dev = torch.device(device)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    summary = (btrace.summarize(win.profile, win.traced, win.label,
                                win.phases)
               if win.profile is not None else None)
    win.profile = None
    (cpu0, steal0, all0), (cpu1, steal1, all1) = host0, host1
    _log(f"set-up {setup_s:.3f} s: imports {t_imports - t0:.3f}, inputs "
         f"{t_inputs - t_imports:.3f}, warm-up {win.t_start - t_inputs:.3f};"
         f" window {win.t_end - win.t_start:.3f} s, process CPU "
         f"{cpu1 - cpu0:.3f} s, host steal "
         f"{100 * (steal1 - steal0) / max(all1 - all0, 1):.2f}%; card "
         f"{_power_limit() if dev.type == 'cuda' else 'none'}")
    for line in getattr(gen, "describe", lambda p, w: [])(prob, win):
        _log(line)
    numbers, lows = gen.check(prob, win, control=control)

    metrics = {}
    if not trace:
        values = dict(win.end_to_end, setup_s=setup_s)
        for m in cell.end_to_end:
            if m["name"] not in values:
                raise KeyError(f"mix {cell.traffic['generator']!r} reports "
                               f"no {m['name']!r}")
            metrics[m["name"]] = dict(value=float(values[m["name"]]),
                                      unit=m["unit"])
    else:
        rec = gen.records(prob, win, summary)
        for m in cell.per_layer:
            v = reader(root, m["name"])(rec)
            if v is not None:
                metrics[m["name"]] = dict(value=float(v), unit=m["unit"])
    device_info = dict(
        platform="gpu" if dev.type == "cuda" else "cpu",
        kind=torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu",
        count=cell.chips, memory_peak_bytes=int(peak))
    result = dict(correct=verdict(numbers, limits),
                  attempted=win.attempted, failed=win.failed,
                  metrics=metrics, device=device_info)
    if summary is not None:
        device_info.update(busy_s=summary["busy_s"],
                           window_s=summary["window_s"])
        result["breakdown"] = btrace.breakdown(summary)
    names = list(numbers) + [k for k in limits if k not in numbers]
    result["check"] = {k: dict(value=numbers.get(k), limit=limits.get(k))
                       for k in names}
    if lows is not None:
        for k in names:
            result["check"][k]["control"] = lows.get(k)
    return result, [(k, numbers.get(k, math.nan), limits.get(k, math.nan))
                    for k in names]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--control", type=int, choices=(0, 1), default=0,
                    help="also read the check's control on the same fits "
                         "(for setting the limits; not a benchmark run)")
    args = ap.parse_args(argv)
    _use_checkout(ROOT)

    import torch

    chips = int(resolve(ROOT, args.workload).chips)
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        _log(f"needs {chips} CUDA card(s); found "
             f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}")
        return 2
    result, lines = run_cell(ROOT, args.workload, args.seed, args.seconds,
                             bool(args.trace), control=bool(args.control))
    found = forbidden_modules()
    if found:
        _log(f"forbidden modules loaded: {found}")
        return 3
    if args.control:
        for name, got in result["check"].items():
            _log(f"control {name} {got['control']!r}")
    for name, value, limit in lines:
        _log(f"check {name} {value!r} limit {limit!r}")
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
