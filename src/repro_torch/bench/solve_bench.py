"""Whole-solve time on the three backends, each beside its kernel
dispatches: the counterpart of `benchmarks/solve_bench.py`.

    python -m repro_torch.bench.solve_bench [--fast] [--out PATH] \
        [--device cpu]

The step bench times one round alone, so the R dispatches and the R θ
round trips through device memory of a real solve — what
``solve_batched(backend="cuda_fused")`` removes — do not show there.
Here the unit is the whole solve at the paper's round counts (R ∈ {100,
1,000}; ρ(M) ≈ 0.95–0.999 needs hundreds to thousands) on ``torch`` (the
batched matmul round), ``cuda`` (R launches of the round kernel) and
``cuda_fused`` (one launch of the `dekrr_solve` chain), each with its
kernel dispatches counted from one run (`repro_torch.obs.dispatch`) and
held to the contract {torch: 0, cuda: R, cuda_fused: 1}: a count off it
fails the run. Times are host clock around solves that end in a device
synchronize, on the device the run names; the least time one H100 could
take is the step bench's `analytic` bound × R.
"""
from __future__ import annotations

import sys

from repro_torch._device import resolve_device
from repro_torch.bench.common import cli, device_name, median_us, write_json
from repro_torch.bench.step_kernel_bench import (OFFSETS, analytic,
                                                 synthetic_packed)
from repro_torch.dist import solve_batched
from repro_torch.obs.dispatch import dispatch_count, round_dispatches
from repro_torch.obs.export import trace_event
from repro_torch.paper.common import csv_row

CASES = [
    # (J, D_max, rounds) at K = 4 circulant slots — the paper's topology
    # degree; round counts span the ρ(M) ≈ 0.95 → 0.999 operating range.
    (16, 128, 100), (16, 128, 1000),
    (64, 128, 100), (64, 128, 1000),
]
BACKENDS = ("torch", "cuda", "cuda_fused")


def solve_row(packed, rounds: int, *, device, reps: int,
              registry=None, label: str = "") -> dict:
    """One case: per backend the µs of a whole solve (median of ``reps``
    timed solves) and the dispatches of one traced solve, checked against
    `round_dispatches`; the `cuda_fused` trace recorded as a ``trace``
    event in ``registry`` when given."""
    row = {"rounds": rounds, "us": {}, "dispatches": {},
           "dispatch_contract": {}}
    for backend in BACKENDS:
        traced = {}

        def solve_traced(backend=backend):
            traced["out"] = solve_batched(packed, rounds, backend=backend,
                                          return_trace=True)

        count, _ = dispatch_count(solve_traced)
        want = round_dispatches(backend, rounds)
        if count != want:
            raise RuntimeError(
                f"solve_batched(backend={backend!r}) made {count} kernel "
                f"dispatches in {rounds} rounds; the contract is {want}")
        row["us"][backend] = median_us(
            lambda backend=backend: solve_batched(packed, rounds,
                                                  backend=backend),
            reps, device)
        row["dispatches"][backend] = count
        row["dispatch_contract"][backend] = want
        if registry is not None and backend == "cuda_fused":
            trace_event(registry, f"solve/{label}", traced["out"][1])
    return row


def run(fast: bool = False, *, out: str | None = None, device=None,
        registry=None) -> dict:
    """The benchmark; returns the results and writes them as JSON to
    `out` when given."""
    device = resolve_device(device)
    cases = [(j, d, r) for j, d, r in CASES if j <= 16 and r <= 100] \
        if fast else CASES
    reps = 3
    rows = []
    for j_nodes, d_max, rounds in cases:
        packed = synthetic_packed(j_nodes, d_max, device=device)
        label = f"J{j_nodes}_D{d_max}_R{rounds}"
        row = solve_row(packed, rounds, device=device, reps=reps,
                        registry=registry, label=label)
        flops, nbytes, bound_us = analytic(j_nodes, d_max, packed.num_slots)
        row.update(j_nodes=j_nodes, d_max=d_max, k_slots=packed.num_slots,
                   dtype="float32", flops=rounds * flops,
                   bytes=rounds * nbytes, h100_bound_us=rounds * bound_us)
        rows.append(row)
        us = row["us"]
        csv_row(f"solve/{label}", us["cuda_fused"],
                f"cuda_us={us['cuda']:.1f};torch_us={us['torch']:.1f};"
                f"dispatches={row['dispatches']['cuda_fused']}/"
                f"{row['dispatches']['cuda']};"
                f"h100_bound_us={row['h100_bound_us']:.2f}")
    results = {"benchmark": ("whole-solve time: the dekrr_solve chain vs "
                             "per-round kernel launches vs the batched "
                             "matmul round"),
               "device": device_name(device),
               "circulant_offsets": list(OFFSETS), "reps": reps,
               "cases": rows}
    if out is not None:
        write_json(results, out)
        print(f"solve/json,0.0,wrote={out}")
    return results


if __name__ == "__main__":
    sys.exit(cli(run, __doc__))

