"""Communication rounds to the Eq. 19 limit, plain stationary iteration
(the paper's) against Chebyshev semi-iteration (the same exchange a
round): the counterpart of `benchmarks/chebyshev_bench.py`.

    python -m repro_torch.bench.chebyshev_bench [--fast] [--out PATH] \
        [--device cpu]

On the houses stand-in (noniid_y, D_j = 30 energy-selected features a
node, a seeded `torch.Generator`) for c_nei ∈ {0.005, 0.05}·N: the
spectral interval by power iteration, then the rounds each method needs
to a relative error of 1e-6 against `solve_exact`
(`rounds_to_tolerance` on ``cuda``: one round-kernel launch a round),
the bytes of a round (`comm_bytes_per_round`, neighbour exchange) and the
bytes of each whole solve. The paper's cost is rounds × Σ_j |N_j| D_j.
"""
from __future__ import annotations

import sys

import torch

from repro_torch._device import resolve_device
from repro_torch.bench.common import cli, device_name, write_json
from repro_torch.core import DeKRRConfig, DeKRRSolver, select_features
from repro_torch.core.acceleration import (estimate_spectral_interval,
                                           rounds_to_tolerance)
from repro_torch.dist import comm_bytes_per_round, pack_problem
from repro_torch.obs.metrics import perf_clock
from repro_torch.paper import common as C

TOL = 1e-6
BACKEND = "cuda"


def run(fast: bool = False, *, out: str | None = None, device=None,
        registry=None, dataset: str = "houses", d_feat: int = 30,
        subsample: int | None = C.SUBSAMPLE) -> dict:
    """The benchmark (``subsample=None``: the stand-in's full N); returns
    the results and writes them as JSON to `out` when given."""
    device = resolve_device(device)
    ds, train, _ = C.load_split(dataset, mode="noniid_y",
                                subsample=subsample, device=device)
    gen = torch.Generator(device=device).manual_seed(0)
    fmaps = [select_features(gen, ds.dim, d_feat, C.SIGMA, train[j].x,
                             train[j].y, method="energy")
             for j in range(C.J)]
    n = sum(t.num_samples for t in train)
    rows = []
    for cfrac in ((0.005,) if fast else (0.005, 0.05)):
        t0 = perf_clock()
        solver = DeKRRSolver(C.TOPOLOGY, fmaps, train,
                             DeKRRConfig(lam=C.LAM, c_nei=cfrac * n),
                             device=device)
        packed = pack_problem(solver, device=device)
        exact = solver.solve_exact()
        dmax = packed.max_features
        theta_star = torch.stack([
            torch.nn.functional.pad(t, (0, dmax - t.shape[0]))
            for t in exact.theta])
        lo, hi = estimate_spectral_interval(packed, backend=BACKEND)
        plain, cheb = rounds_to_tolerance(packed, theta_star, tol=TOL,
                                          mu_max=hi, mu_min=lo,
                                          backend=BACKEND)
        bpr = comm_bytes_per_round(packed, "ppermute")
        secs = perf_clock() - t0
        row = {"c_over_n": cfrac, "rho": float(solver.spectral_radius()),
               "mu_interval": [lo, hi], "rounds_plain": plain,
               "rounds_chebyshev": cheb, "bytes_per_round": bpr,
               "total_comm_plain": plain * bpr,
               "total_comm_chebyshev": cheb * bpr, "seconds": secs}
        rows.append(row)
        C.csv_row(f"chebyshev/{dataset}/c{cfrac}N", secs * 1e6,
                  f"rho={row['rho']:.5f};rounds_plain={plain};"
                  f"rounds_chebyshev={cheb};"
                  f"speedup={plain / max(cheb, 1):.1f}x;"
                  f"bytes_per_round={bpr};total_comm_plain={plain * bpr};"
                  f"total_comm_cheb={cheb * bpr}")
        if registry is not None:
            registry.gauge(f"chebyshev.{dataset}.c{cfrac}N.rounds_plain"
                           ).set(plain)
            registry.gauge(f"chebyshev.{dataset}.c{cfrac}N.rounds_cheb"
                           ).set(cheb)
    results = {"benchmark": ("rounds to relative error 1e-6: plain Eq. 19 "
                             "iteration vs Chebyshev semi-iteration"),
               "device": device_name(device), "dataset": dataset,
               "n_train": n, "d_feat": d_feat, "backend": BACKEND,
               "tol": TOL, "rows": rows}
    if out is not None:
        write_json(results, out)
        print(f"chebyshev/json,0.0,wrote={out}")
    return results


if __name__ == "__main__":
    sys.exit(cli(run, __doc__))
