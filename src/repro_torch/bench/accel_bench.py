"""Chebyshev acceleration: rounds to each tolerance, plain Eq. 19 iteration
against Chebyshev semi-iteration, with the bytes each needs; the kernel
dispatches of the accelerated and the fused async solves on every
backend; and the µs of one accelerated solve a backend: the counterpart
of `benchmarks/accel_bench.py`.

    python -m repro_torch.bench.accel_bench [--fast] [--out PATH] \
        [--device cpu]

The problem is the reference's: the houses stand-in, noniid_y over the
paper's ten nodes, D_j = 30 energy-selected DDRF features a node (a
seeded `torch.Generator`, or the maps a caller passes), c_nei = 0.005·N,
at ``subsample`` samples (None: the stand-in's full N, as the card runs
it). The ladder: the spectral interval by power iteration on ``cuda``,
θ* from `solve_exact`, `rounds_to_tolerance` at each tolerance and
`comm_bytes_per_round(packed, "ppermute")`.

Dispatches are counted as the solves run (`repro_torch.obs.dispatch`;
the reference counts ``pallas_call`` equations of the traced program, its
J002 contract) on `analysis.dispatch.synthetic_packed`, and held to
`round_dispatches`: torch 0, cuda R, cuda_fused 1 for both chains. A
count off the contract fails the run. Solve µs: host clock around solves
that end in a device synchronize, after a warm-up solve. On the CPU the
``cuda*`` backends run the kernels' plain versions, so their µs time
those; the provenance's ``plain`` flag says which ran.
"""
from __future__ import annotations

import sys

import torch

from repro_torch._device import resolve_device
from repro_torch.bench.common import cli, device_name, time_us, write_json
from repro_torch.core import DeKRRConfig, DeKRRSolver, select_features
from repro_torch.core.acceleration import (chebyshev_solve_packed,
                                           estimate_spectral_interval,
                                           rounds_to_tolerance)
from repro_torch.dist import comm_bytes_per_round, pack_problem
from repro_torch.obs.dispatch import dispatch_count, round_dispatches
from repro_torch.paper import common as C

BACKENDS = ("torch", "cuda", "cuda_fused")
BACKEND = "cuda"


def build_problem(dataset: str, d_feat: int, cfrac: float, *,
                  subsample: int | None, device, fmaps=None):
    """(solver, packed) of the reference's `_build_problem`; ``fmaps``
    replaces the seeded draw (a parity test passes the reference's)."""
    ds, train, _ = C.load_split(dataset, mode="noniid_y",
                                subsample=subsample, device=device)
    if fmaps is None:
        gen = torch.Generator(device=device).manual_seed(0)
        fmaps = [select_features(gen, ds.dim, d_feat, C.SIGMA, train[j].x,
                                 train[j].y, method="energy")
                 for j in range(C.J)]
    n = sum(t.num_samples for t in train)
    solver = DeKRRSolver(C.TOPOLOGY, fmaps, train,
                         DeKRRConfig(lam=C.LAM, c_nei=cfrac * n),
                         device=device)
    return solver, pack_problem(solver, device=device)


def dispatch_counts(num_iters: int, device) -> dict:
    """Per backend, the kernel dispatches of `chebyshev_solve_packed` and
    `async_solve_batched` (all nodes active, so every round runs) at
    ``num_iters`` rounds on the synthetic packed problem, each checked
    against `round_dispatches`."""
    from repro_torch.analysis.dispatch import synthetic_packed
    from repro_torch.dist.async_gossip import async_solve_batched

    packed = synthetic_packed(device=device)
    masks = torch.ones((num_iters, packed.num_nodes), dtype=torch.int32,
                       device=device)
    out = {}
    for b in BACKENDS:
        cheb, _ = dispatch_count(chebyshev_solve_packed, packed, 0.9, 0.0,
                                 num_iters=num_iters, backend=b)
        asyn, _ = dispatch_count(async_solve_batched, packed, num_iters,
                                 masks, backend=b)
        want = round_dispatches(b, num_iters)
        if (cheb, asyn) != (want, want):
            raise RuntimeError(
                f"accel: backend {b} made {cheb} (Chebyshev) and {asyn} "
                f"(async) dispatches for {num_iters} rounds; the contract "
                f"is {want}")
        out[b] = {"chebyshev_solve_packed": cheb,
                  "async_solve_batched": asyn}
    return out


def run(fast: bool = False, *, out: str | None = None, device=None,
        registry=None, dataset: str = "houses", d_feat: int = 30,
        subsample: int | None = C.SUBSAMPLE, fmaps=None,
        interval: tuple[float, float] | None = None) -> dict:
    """The benchmark; returns the results and writes them as JSON to
    ``out`` when given. ``interval`` = (μ_min, μ_max) replaces the power
    iteration's estimate (a parity test feeds both sides the same)."""
    device = resolve_device(device)
    solver, packed = build_problem(dataset, d_feat, cfrac=0.005,
                                   subsample=subsample, device=device,
                                   fmaps=fmaps)
    exact = solver.solve_exact()
    dmax = packed.max_features
    theta_star = torch.stack([torch.nn.functional.pad(t, (0, dmax - len(t)))
                              for t in exact.theta])
    lo, hi = (estimate_spectral_interval(packed, backend=BACKEND)
              if interval is None else interval)
    bpr = comm_bytes_per_round(packed, "ppermute")

    tols = (1e-4, 1e-6) if fast else (1e-3, 1e-4, 1e-5, 1e-6)
    ladder = []
    for tol in tols:
        plain, cheb = rounds_to_tolerance(packed, theta_star, tol=tol,
                                          mu_max=hi, mu_min=lo,
                                          backend=BACKEND)
        ladder.append({"tol": tol, "rounds_plain": plain,
                       "rounds_chebyshev": cheb,
                       "speedup": round(plain / max(cheb, 1), 2),
                       "comm_plain_bytes": plain * bpr,
                       "comm_chebyshev_bytes": cheb * bpr})
        C.csv_row(f"accel/{dataset}/tol{tol:g}", 0.0,
                  f"rounds_plain={plain};rounds_chebyshev={cheb};"
                  f"speedup={plain / max(cheb, 1):.1f}x")
        if registry is not None:
            registry.gauge(f"accel.{dataset}.tol{tol:g}.rounds_plain"
                           ).set(plain)
            registry.gauge(f"accel.{dataset}.tol{tol:g}.rounds_cheb"
                           ).set(cheb)

    num_iters = 10 if fast else 30
    dispatches = dispatch_counts(num_iters, device)
    timings, thetas = {}, {}
    for b in BACKENDS:
        def solve(b=b):
            thetas[b] = chebyshev_solve_packed(packed, hi, lo,
                                               num_iters=num_iters,
                                               backend=b)
        us = time_us(solve, 1 if fast else 3, device)
        timings[b] = us
        C.csv_row(f"accel/solve{num_iters}/{b}", us,
                  f"dispatches={dispatches[b]['chebyshev_solve_packed']}")
    # every backend runs the same rounds: θ against the cuda backend's
    theta_diff = {b: float((thetas[b] - thetas["cuda"]).abs().max())
                  for b in BACKENDS}

    results = {
        "benchmark": ("Chebyshev-accelerated DeKRR: rounds-to-tolerance "
                      "vs plain iteration, dispatch counts, per-backend "
                      "solve wall time"),
        "device": device_name(device),
        "dataset": dataset,
        "n_train": sum(nd.num_samples for nd in solver.data),
        "j_nodes": packed.num_nodes,
        "d_feat": d_feat,
        "spectral_interval": [float(lo), float(hi)],
        "bytes_per_round": bpr,
        "rounds_to_tolerance": ladder,
        "round_dispatches": dispatches,
        "solve_us": {"num_iters": num_iters, **timings},
        "theta_max_abs_diff_vs_cuda": theta_diff,
    }
    if out is not None:
        write_json(results, out)
        print(f"accel/json,0.0,wrote={out}")
    return results


if __name__ == "__main__":
    sys.exit(cli(run, __doc__))
