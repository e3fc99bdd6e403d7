"""The Eq. 19 round kernel against the batched-matmul round, the
counterpart of `benchmarks/step_kernel_bench.py`.

    python -m repro_torch.bench.step_kernel_bench [--fast] [--out PATH] \
        [--device cpu]

Grid: J ∈ {16, 64, 256} nodes × D_max ∈ {128, 512}, K = 4 circulant
slots (the paper's C_J(1, 2) degree), float32. Per case, the time of one
`step_batched` round on ``torch`` (the batched matmul round) and on
``cuda`` (the `dekrr_step` kernel; its plain version on CPU tensors),
the median of single rounds each timed on the host clock up to a device
synchronize, and
the least time one H100 could take for the round (`analytic`: the bytes
of the [J, D, D] blocks at 3.35 TB/s against the operations at
67 TFLOP/s in float32). Times are of the device the run names, printed
with the results; a CPU run's times are the plain versions'.
"""
from __future__ import annotations

import sys

import torch

from repro_torch._device import resolve_device
from repro_torch.bench.common import (H100_BYTES_PER_S, H100_FLOPS, cli,
                                      device_name, median_us, write_json)
from repro_torch.dist import PackedProblem, step_batched
from repro_torch.dist.dekrr_spmd import _circulant_slot_table
from repro_torch.paper.common import csv_row

CASES = [
    # (J, D_max) at K = 4 — the paper's topology degree; D spans Table 2's
    # D̄ and the packed production target.
    (16, 128), (16, 512),
    (64, 128), (64, 512),
    (256, 128), (256, 512),
]
OFFSETS = (1, 2)
DTYPE = torch.float32


def synthetic_packed(j_nodes: int, d_max: int, *,
                     device=None) -> PackedProblem:
    """A random packed problem with the circulant C_J(1, 2) slot layout,
    drawn with a `torch.Generator` seeded from (J, D) (contraction spectra
    do not matter for time, only shapes; blocks scaled by 1/D so the
    iterates stay bounded)."""
    device = torch.device(device) if device is not None else None
    gen = torch.Generator(device=device).manual_seed(j_nodes * 7919 + d_max)
    kw = dict(dtype=DTYPE, device=device)
    k_slots = 2 * len(OFFSETS)
    scale = 1.0 / d_max

    def rand(*shape, s=1.0):
        return torch.randn(shape, generator=gen, **kw) * s

    nbr_idx = _circulant_slot_table(OFFSETS, j_nodes)
    return PackedProblem(
        g=rand(j_nodes, d_max, d_max, s=scale), d=rand(j_nodes, d_max),
        s=rand(j_nodes, d_max, d_max, s=scale),
        p=rand(j_nodes, k_slots, d_max, d_max, s=scale),
        theta_mask=torch.ones((j_nodes, d_max), **kw),
        nbr_idx=torch.as_tensor(nbr_idx, device=device),
        nbr_mask=torch.ones((j_nodes, k_slots), **kw),
        offsets=OFFSETS, node_dims=(d_max,) * j_nodes,
        num_edges_directed=j_nodes * k_slots)


def analytic(j_nodes: int, d_max: int,
             k_slots: int = 4) -> tuple[int, int, float]:
    """(operations, bytes, bound µs) of one round on one H100: each
    [D, D] block (G, S, K × P) read once with 2 operations an element,
    d and θ read and θ written once."""
    item = torch.empty((), dtype=DTYPE).element_size()
    flops = j_nodes * 2 * (2 + k_slots) * d_max * d_max
    nbytes = (j_nodes * (2 + k_slots) * d_max * d_max
              + 3 * j_nodes * d_max) * item
    bound = max(flops / H100_FLOPS[DTYPE], nbytes / H100_BYTES_PER_S)
    return flops, nbytes, bound * 1e6


def run(fast: bool = False, *, out: str | None = None, device=None,
        registry=None) -> dict:
    """The benchmark; returns the results and writes them as JSON to
    `out` when given."""
    device = resolve_device(device)
    cases = [(j, d) for j, d in CASES if j <= 64 and d <= 128] if fast \
        else CASES
    rows = []
    for j_nodes, d_max in cases:
        packed = synthetic_packed(j_nodes, d_max, device=device)
        theta = torch.zeros_like(packed.d)
        reps = 20 if d_max <= 128 else 5
        times = {b: median_us(lambda b=b: step_batched(packed, theta,
                                                       backend=b),
                              reps, device)
                 for b in ("torch", "cuda")}
        flops, nbytes, bound_us = analytic(j_nodes, d_max,
                                           packed.num_slots)
        row = {"j_nodes": j_nodes, "d_max": d_max,
               "k_slots": packed.num_slots, "dtype": "float32",
               "torch_us": times["torch"], "cuda_us": times["cuda"],
               "flops": flops, "bytes": nbytes, "h100_bound_us": bound_us}
        rows.append(row)
        csv_row(f"step/J{j_nodes}_D{d_max}", times["cuda"],
                f"torch_us={times['torch']:.1f};"
                f"h100_bound_us={bound_us:.2f}")
        if registry is not None:
            registry.histogram("step.cuda_us").observe(times["cuda"])
    results = {"benchmark": ("dekrr_step round kernel vs the batched "
                             "matmul round"),
               "device": device_name(device), "cases": rows}
    if out is not None:
        write_json(results, out)
        print(f"step/json,0.0,wrote={out}")
    return results


if __name__ == "__main__":
    sys.exit(cli(run, __doc__))

