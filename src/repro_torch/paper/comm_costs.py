"""§II-C communication-cost model + the paper's headline efficiency claim:
at matched error, DeKRR-DDRF needs far fewer features per node than DKLA
(paper: D=20 vs D=100 on houses). Also measures the per-round wall time
of the packed runtime (the `dekrr_solve` kernel, after a `pack_problem`
whose Gram blocks go through `rff_gram`) and its Σ|N_j|·D cost model."""
from __future__ import annotations

import torch

from repro_torch.core import DeKRRConfig, DeKRRSolver, select_features
from repro_torch.dist import comm_bytes_per_round, pack_problem, solve_batched
from repro_torch.obs.metrics import perf_clock
from repro_torch.paper import common as C


def matched_error_features(dataset="houses", fast=False, *,
                           subsample=C.SUBSAMPLE, device=None):
    ds, train, test = C.load_split(dataset, mode="noniid_y",
                                   subsample=subsample, device=device)
    # DKLA reference error at D=100
    r_ref, _, _ = C.mean_over_seeds(
        lambda s: C.run_dkla(ds, train, test, 100, seed=90 + s))
    grid = (10, 20, 40, 80) if not fast else (20,)
    d_needed = None
    for d in grid:
        r, _, _ = C.mean_over_seeds(
            lambda s: C.run_dekrr_ddrf(ds, train, test, d, seed=s), seeds=2)
        if r <= r_ref * 1.05:
            d_needed = d
            break
    C.csv_row(
        f"comm/matched_error/{dataset}", 0.0,
        f"DKLA_D=100;DKLA_RSE={r_ref:.4f};ours_D={d_needed};"
        f"comm_reduction={'%.1fx' % (100 / d_needed) if d_needed else 'n/a'};"
        f"paper_claims=5x(D100->D20)")
    return d_needed


def iteration_cost(dataset="houses", d_feat=32, *, subsample=C.SUBSAMPLE,
                   device=None):
    """µs per round of `solve_batched(backend="cuda_fused")` (host clock
    after a device sync) and the bytes a round moves in each mode."""
    ds, train, test = C.load_split(dataset, mode="noniid_y",
                                   subsample=subsample, device=device)
    dev = train[0].x.device
    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)
    gen = torch.Generator(device=dev).manual_seed(0)
    fmaps = [select_features(gen, ds.dim, d_feat, C.SIGMA, train[j].x,
                             train[j].y, method="energy")
             for j in range(C.J)]
    n = sum(t.num_samples for t in train)
    solver = DeKRRSolver(C.TOPOLOGY, fmaps, train,
                         DeKRRConfig(lam=C.LAM, c_nei=0.01 * n),
                         build_aux=False, device=dev)
    packed = pack_problem(solver, device=dev)
    solve_batched(packed, 10, backend="cuda_fused")        # warmup
    sync()
    t0 = perf_clock()
    reps, iters = 5, 100
    for _ in range(reps):
        solve_batched(packed, iters, backend="cuda_fused")
    sync()
    us = (perf_clock() - t0) / (reps * iters) * 1e6
    bytes_pp = comm_bytes_per_round(packed, "ppermute")
    bytes_ag = comm_bytes_per_round(packed, "allgather")
    C.csv_row(
        f"comm/iteration/{dataset}", us,
        f"D={d_feat};ppermute_bytes_per_round={bytes_pp};"
        f"allgather_bytes_per_round={bytes_ag};"
        f"cost_model=sum_j|N_j|D_j={C.J * 4 * d_feat}")
    return dict(us_per_round=us, ppermute_bytes=bytes_pp,
                allgather_bytes=bytes_ag)


def run(fast=False, *, subsample=C.SUBSAMPLE, device=None):
    matched_error_features(fast=fast, subsample=subsample, device=device)
    iteration_cost(subsample=subsample, device=device)
