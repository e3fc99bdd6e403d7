"""Streaming DeKRR benchmark, the counterpart of `benchmarks/stream_bench.py`.

    python -m repro_torch.bench.stream_bench [--fast] [--out PATH] \
        [--device cpu]

Four numbers characterize the online runtime (`repro_torch.stream` +
`repro_torch.serve.dekrr`) on the paper's J = 10 circulant(1, 2) network:

  * ingest_us — time to fold one minibatch into the Eq. 17 auxiliaries
    by rank-b Woodbury updates (per batch size b), beside rebuild_us,
    the from-scratch `pack_problem` on the same accumulated data (the
    cost the incremental path avoids on every minibatch);
  * refresh_ms — one DDRF re-selection + single-slot rebuild;
  * warm and cold rounds to tol — after a wave of ingests, the consensus
    continuation from the carried θ against the same solve from zeros on
    the same packed operator, same tol and chunking. Warm must take fewer
    rounds, or the run raises;
  * serve qps — queries/second through `DeKRRServeEngine` serving the
    live stream (network-average answers, staleness bounds attached).

Times are host-clock around work that ends in a device synchronize, on
the device the run names (printed with the results). Round counts do not
depend on the device. The schedule's pieces (`stream_runtime`,
`ingest_rows`, `warm_cold_epochs`, `serve_queries`) are public, so a
caller can run them on its own problem at another width.
"""
from __future__ import annotations

import sys

import numpy as np
import torch

from repro_torch._device import resolve_device
from repro_torch.bench.common import cli, sync, time_us, write_json
from repro_torch.core import DeKRRConfig, DeKRRSolver, NodeData, select_features
from repro_torch.dist import pack_problem, solve_batched
from repro_torch.obs.metrics import perf_clock
from repro_torch.paper import common as C
from repro_torch.serve import DeKRRServeEngine, KernelQuery
from repro_torch.stream import StreamConfig, StreamingDeKRR, ingest as fold

LAM = 1e-3      # keeps cond(A) moderate, so Woodbury and a direct inverse
                # agree far below rtol 1e-9 (as tests/test_stream.py)
TOL = 1e-8
BUDGET = 2000   # round budget of a solve
CHUNK = 1       # tol checked every round: exact rounds to tol, warm and cold
INGEST_BATCHES = (8, 32)
EPOCH_NODES = (0, 3, 7)
EPOCH_BATCH = 16


def stream_runtime(topology, fmaps, train, *, backend: str = "cuda_fused",
                   gossip: str = "sync", seed: int = 0,
                   device=None) -> StreamingDeKRR:
    """The bench's stream on given maps and data: λ = LAM, c_nei =
    0.02·N, tol TOL, a BUDGET-round solve checked every CHUNK rounds."""
    n = sum(t.num_samples for t in train)
    solver = DeKRRSolver(topology, fmaps, train,
                         DeKRRConfig(lam=LAM, c_nei=0.02 * n),
                         build_aux=False, device=device)
    return StreamingDeKRR(solver, StreamConfig(
        backend=backend, gossip=gossip, rounds_per_epoch=BUDGET, tol=TOL,
        chunk_rounds=CHUNK, seed=seed))


def _build_runtime(subsample: int, device) -> tuple[StreamingDeKRR, tuple]:
    ds, train, test = C.load_split("air_quality", device=device)
    if subsample < C.SUBSAMPLE:
        keep = max(subsample // C.J, 8)
        train = [NodeData(x=t.x[:, :keep], y=t.y[:keep]) for t in train]
    gen = torch.Generator(device=device).manual_seed(0)
    dims = [16 + 4 * (j % 3) for j in range(C.J)]
    fmaps = [select_features(gen, ds.dim, dims[j], C.SIGMA, train[j].x,
                             train[j].y, method="energy", candidate_ratio=5)
             for j in range(C.J)]
    return stream_runtime(C.TOPOLOGY, fmaps, train, device=device), \
        (ds, test)


def ingest_rows(rt: StreamingDeKRR, batches, reps: int, rng) -> list[dict]:
    """µs per Woodbury fold at node 0 for each batch size, each fold from
    the same state (the runtime is not changed)."""
    rows = []
    aux_probe = rt.aux
    dim = int(aux_probe.omega.shape[2])
    for b in batches:
        xb = torch.as_tensor(rng.normal(size=(dim, b)), device=rt.device)
        yb = torch.as_tensor(rng.normal(size=b), device=rt.device)
        us = time_us(lambda: fold(aux_probe, 0, xb, yb), reps, rt.device)
        rows.append({"batch": b, "ingest_us": us,
                     "samples_per_sec": b / (us * 1e-6)})
        C.csv_row(f"stream/ingest_b{b}", us,
                  f"samples_per_sec={rows[-1]['samples_per_sec']:.1f}")
    return rows


def rebuild_us(rt: StreamingDeKRR, reps: int) -> float:
    """µs of a from-scratch `pack_problem` on the accumulated data."""
    ref = rt.reference_solver()
    us = time_us(lambda: pack_problem(ref, device=rt.device), reps,
                  rt.device)
    C.csv_row("stream/full_rebuild", us, "pack_problem baseline")
    return us


def warm_cold_epochs(rt: StreamingDeKRR, epochs: int, rng, *,
                     nodes=EPOCH_NODES, batch: int = EPOCH_BATCH,
                     after=None) -> list[dict]:
    """Each epoch: a `batch`-column minibatch at each of `nodes`, then the
    solve from zeros (cold) and the runtime's warm solve on the same
    packed operator, backend, tol and chunking. ``after(rt, theta0,
    row)``, when given, runs after each warm solve with the θ it started
    from and the epoch's row. Raises when warm is not fewer rounds than
    cold on average."""
    cfg = rt.config
    dim = int(rt.aux.omega.shape[2])
    rows = []
    for epoch in range(epochs):
        for node in nodes:
            rt.ingest(node, rng.normal(size=(dim, batch)),
                      rng.normal(size=batch))
        theta0 = rt.theta
        _, cold_rounds = solve_batched(
            rt.packed, cfg.rounds_per_epoch, backend=cfg.backend,
            tol=cfg.tol, chunk_rounds=cfg.chunk_rounds, return_rounds=True)
        t0 = perf_clock()
        warm = rt.solve()
        secs = perf_clock() - t0
        rows.append({"epoch": epoch, "warm_rounds": warm.rounds_run,
                     "cold_rounds": int(cold_rounds),
                     "residual": warm.residual, "warm_ms": secs * 1e3})
        C.csv_row(f"stream/epoch{epoch}", secs * 1e6,
                  f"warm_rounds={warm.rounds_run};"
                  f"cold_rounds={int(cold_rounds)}")
        if after is not None:
            after(rt, theta0, rows[-1])
    warm_mean = float(np.mean([e["warm_rounds"] for e in rows]))
    cold_mean = float(np.mean([e["cold_rounds"] for e in rows]))
    if warm_mean >= cold_mean:
        raise RuntimeError(
            f"warm-started solves must reach tol in fewer rounds than "
            f"cold starts (warm {warm_mean} vs cold {cold_mean})")
    return rows


def serve_queries(rt: StreamingDeKRR, x_test: np.ndarray, count: int, *,
                  batch_size: int = 64) -> tuple[list, float]:
    """`count` single-column network-mean queries from the columns of
    x_test [d, M], answered by a `DeKRRServeEngine` on the live stream
    after one warm-up query; returns (queries, wall seconds)."""
    queries = [KernelQuery(uid=i, x=x_test[:, i % x_test.shape[1]])
               for i in range(count)]
    eng = DeKRRServeEngine(rt, batch_size=batch_size)
    eng.run([KernelQuery(uid=-1, x=x_test[:, 0])])     # warm up
    sync(rt.device)
    t0 = perf_clock()
    out = eng.run(queries)
    sync(rt.device)
    return out, perf_clock() - t0


def run(fast: bool = False, *, out: str | None = None,
        device=None) -> dict:
    """The benchmark; returns the results and writes them as JSON to
    `out` when given."""
    device = resolve_device(device)
    reps = 3 if fast else 10
    rt, (ds, test) = _build_runtime(600 if fast else 2000, device)
    rng = np.random.default_rng(0)
    results: dict = {
        "benchmark": ("streaming DeKRR: Woodbury ingest, refresh latency, "
                      "warm vs cold rounds-to-tol, serve throughput"),
        "device": (torch.cuda.get_device_name(device)
                   if device.type == "cuda" else str(device)),
        "backend": rt.config.backend,
        "j_nodes": rt.num_nodes,
        "d_max": rt.aux.max_features,
        "n_initial": rt.aux.n_live,
        "tol": TOL,
    }
    results["ingest"] = ingest_rows(rt, INGEST_BATCHES, reps, rng)
    results["rebuild_us"] = rebuild_us(rt, max(1, reps // 3))

    sync(device)
    t0 = perf_clock()
    rt.refresh(1)
    sync(device)
    results["refresh_ms"] = (perf_clock() - t0) * 1e3
    C.csv_row("stream/refresh", results["refresh_ms"] * 1e3,
              "single-slot DDRF rebuild")

    cold0 = rt.solve()                       # from zeros: the cold baseline
    epochs = warm_cold_epochs(rt, 2 if fast else 4, rng)
    results["initial_cold_rounds"] = cold0.rounds_run
    results["epochs"] = epochs
    warm_mean = float(np.mean([e["warm_rounds"] for e in epochs]))
    cold_mean = float(np.mean([e["cold_rounds"] for e in epochs]))
    results["warm_rounds_mean"] = warm_mean
    results["cold_rounds_mean"] = cold_mean
    results["rounds_saved_fraction"] = 1.0 - warm_mean / cold_mean

    n_q = 64 if fast else 256
    served, wall = serve_queries(rt, test[0].x.cpu().numpy(), n_q)
    assert all(q.done and q.staleness is not None for q in served)
    results["serve"] = {"queries": n_q, "batch_size": 64,
                        "qps": n_q / wall,
                        "staleness_residual": served[-1].staleness.residual}
    C.csv_row("stream/serve", wall / n_q * 1e6,
              f"qps={results['serve']['qps']:.1f}")

    if out is not None:
        write_json(results, out)
        print(f"stream/json,0.0,wrote={out}")
    return results


if __name__ == "__main__":
    sys.exit(cli(run, __doc__))
