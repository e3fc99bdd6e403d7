"""Pieces the port's benches share: the device's name and synchronize,
host timing around device work, the H100 peaks of the analytic bounds,
JSON output and the command line."""
from __future__ import annotations

import argparse
import json
import statistics

import torch

from repro_torch.obs.metrics import perf_clock

# One H100 (SXM, 700 W, NVIDIA's data sheet): device-memory rate, and the
# f32 and f64 peaks (f64 on the tensor cores, f32 outside them).
H100_BYTES_PER_S = 3.35e12
H100_FLOPS = {torch.float32: 67e12, torch.float64: 67e12}


def device_name(device: torch.device) -> str:
    """The card's name, or the device's where it is not a card."""
    return (torch.cuda.get_device_name(device) if device.type == "cuda"
            else str(device))


def sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def time_us(fn, reps: int, device: torch.device) -> float:
    """Mean µs of ``fn`` over ``reps`` calls after one warm-up call, host
    clock around work that ends in a device synchronize."""
    fn()
    sync(device)
    t0 = perf_clock()
    for _ in range(reps):
        fn()
    sync(device)
    return (perf_clock() - t0) / reps * 1e6


def median_us(fn, reps: int, device: torch.device) -> float:
    """Median µs of ``reps`` single calls of ``fn`` after one warm-up,
    each timed on the host clock around work that ends in a device
    synchronize."""
    fn()
    sync(device)
    times = []
    for _ in range(reps):
        t0 = perf_clock()
        fn()
        sync(device)
        times.append((perf_clock() - t0) * 1e6)
    return statistics.median(times)


def write_json(results: dict, path: str) -> None:
    with open(path, "w") as f:
        json.dump(results, f, indent=2)
        f.write("\n")


def cli(run_fn, doc: str, argv=None) -> int:
    """The command line of a bench module: ``--fast``, ``--out PATH``
    (its JSON; none by default) and ``--device`` (the card by default)."""
    ap = argparse.ArgumentParser(description=doc.splitlines()[0])
    ap.add_argument("--fast", action="store_true",
                    help="the reference's reduced sizes")
    ap.add_argument("--out", default=None,
                    help="write the results as JSON to this path")
    ap.add_argument("--device", default=None,
                    help="device to run on (default: the CUDA card)")
    args = ap.parse_args(argv)
    run_fn(fast=args.fast, out=args.out, device=args.device)
    return 0
