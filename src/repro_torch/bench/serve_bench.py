"""The serving tier under closed- and open-loop load, the counterpart of
`benchmarks/serve_bench.py`.

    python -m repro_torch.bench.serve_bench [--fast] [--out PATH] \
        [--device cpu]

Drives the replica serving stack (`repro_torch.serve.DeKRRReplicaServer`:
N replicas off a `SnapshotRegistry`, column-bucketed waves, optional
mixed-precision answers) and reports, per precision (fp64, bf16, int8):

  * closed-loop capacity: the replica server (qps over submit-and-drain
    runs) beside two single-engine baselines — the same wave-batched
    engine, and one query answered at a time (`batch_size=1`);
  * a Poisson OPEN-LOOP frontier: arrivals on an exponential clock that
    does not wait for answers, at 0.3, 0.6 and 0.9 of the precision's own
    closed-loop capacity, so queueing shows in the percentiles as a
    caller sees it: achieved qps, p50/p99 latency (admission to answer),
    and the answer error — max |f_served − f_hi| against a full-precision
    serve of the same queries, beside the largest attached
    `StalenessBound.precision`.

EVERY low-precision answer must lie within its attached bound, or the
run fails. Rates are reported, never gated: host timings spread about 2×
between runs, so the closed-loop numbers are medians over ``reps`` runs.
The snapshot is a parameter (`serve_frontier`), so a caller can serve
another θ (the card's main path serves its own); `run` builds the
reference's: the paper's J = 10 network on air_quality, λ 1e-3, solved
to tol 1e-8 by `StreamingDeKRR`. Each latency report is recorded as a
``latency`` event in ``registry`` when one is given.
"""
from __future__ import annotations

import statistics
import sys
import time

import numpy as np
import torch

from repro_torch._device import resolve_device
from repro_torch.bench.common import cli, device_name, sync, write_json
from repro_torch.core import (DeKRRConfig, DeKRRSolver, NodeData,
                              select_features)
from repro_torch.obs.export import latency_event
from repro_torch.obs.metrics import perf_clock
from repro_torch.paper import common as C
from repro_torch.serve import (DeKRRReplicaServer, DeKRRServeEngine,
                               KernelQuery)
from repro_torch.stream import (SnapshotRegistry, StreamConfig,
                                StreamingDeKRR)

LAM = 1e-3
TOL = 1e-8
BATCH = 16          # wave slots — small enough that waves keep forming
                    # under open-loop load instead of one giant batch
REPLICAS = 2
PRECISIONS = (None, "bf16", "int8")
LOADS = (0.3, 0.6, 0.9)


def build_snapshot(subsample: int, device):
    """Solve the paper's J = 10 circulant network once and freeze θ:
    (snapshot, test node data)."""
    ds, train, test = C.load_split("air_quality", device=device)
    if subsample < C.SUBSAMPLE:
        keep = max(subsample // C.J, 8)
        train = [NodeData(x=t.x[:, :keep], y=t.y[:keep]) for t in train]
    gen = torch.Generator(device=device).manual_seed(0)
    dims = [16 + 4 * (j % 3) for j in range(C.J)]
    fmaps = [select_features(gen, ds.dim, dims[j], C.SIGMA, train[j].x,
                             train[j].y, method="energy", candidate_ratio=5)
             for j in range(C.J)]
    n = sum(t.num_samples for t in train)
    solver = DeKRRSolver(C.TOPOLOGY, fmaps, train,
                         DeKRRConfig(lam=LAM, c_nei=0.02 * n),
                         build_aux=False, device=device)
    rt = StreamingDeKRR(solver, StreamConfig(rounds_per_epoch=2000,
                                             tol=TOL))
    rt.solve()
    return rt.snapshot(), test


def make_queries(n: int, xs: np.ndarray, seed: int = 0) -> list:
    """``n`` single-column network-mean queries: the columns of xs [d, M]
    in turn plus N(0, 0.01²) noise from ``default_rng(seed)``."""
    rng = np.random.default_rng(seed)
    d, cols = xs.shape
    return [KernelQuery(uid=i, x=np.asarray(xs[:, i % cols])
                        + 0.01 * rng.normal(size=d))
            for i in range(n)]


def closed_qps(run_fn, n: int, reps: int, device) -> float:
    """Median qps of ``reps`` closed-loop runs of ``n`` queries."""
    rates = []
    for _ in range(reps):
        t0 = perf_clock()
        run_fn()
        sync(device)
        rates.append(n / (perf_clock() - t0))
    return statistics.median(rates)


def open_loop(server: DeKRRReplicaServer, queries, rate: float,
              rng: np.random.Generator):
    """Poisson open-loop drive: submit each query at its exponential
    arrival time whatever the service's progress, then drain; returns the
    server's `LatencyReport`."""
    server.latency.reset()
    server.start()
    t_next = perf_clock()
    try:
        for q in queries:
            t_next += rng.exponential(1.0 / rate)
            while True:
                dt = t_next - perf_clock()
                if dt <= 0:
                    break
                time.sleep(min(dt, 0.0005))
            server.submit(q)
    finally:
        server.stop()
    return server.report()


def serve_frontier(snap, xs: np.ndarray, *, n_cap: int, n_open: int,
                   reps: int, registry=None) -> dict:
    """Closed-loop capacity and the open-loop frontier of ``snap`` on
    queries drawn from the columns of xs [d, M]. Raises when a
    low-precision answer lies outside its attached bound."""
    device = snap.device
    reg = SnapshotRegistry()
    reg.publish(snap)
    warm = make_queries(BATCH + BATCH // 2, xs, seed=9)

    # -- closed-loop capacity ------------------------------------------------
    eng_batched = DeKRRServeEngine(snap, batch_size=BATCH)
    eng_batched.run(list(warm))
    eng_seq = DeKRRServeEngine(snap, batch_size=1)
    eng_seq.run(list(warm[:4]))
    srv = DeKRRReplicaServer(reg, replicas=REPLICAS, batch_size=BATCH)
    srv.run(list(warm))
    seq_qps = closed_qps(lambda: eng_seq.run(make_queries(n_cap // 4, xs)),
                         n_cap // 4, reps, device)
    batched_qps = closed_qps(lambda: eng_batched.run(make_queries(n_cap,
                                                                  xs)),
                             n_cap, reps, device)
    replica_qps = closed_qps(lambda: srv.run(make_queries(n_cap, xs)),
                             n_cap, reps, device)
    results = {"closed_loop": {
        "single_engine_sequential_qps": seq_qps,
        "single_engine_batched_qps": batched_qps,
        "replica_qps": replica_qps,
        "speedup_vs_sequential": replica_qps / seq_qps}}
    C.csv_row("serve/seq_baseline", 1e6 / seq_qps, f"qps={seq_qps:.1f}")
    C.csv_row("serve/batched_engine", 1e6 / batched_qps,
              f"qps={batched_qps:.1f}")
    C.csv_row("serve/replicas", 1e6 / replica_qps,
              f"qps={replica_qps:.1f};replicas={REPLICAS}")

    # -- Poisson open-loop frontier -----------------------------------------
    ref_engine = DeKRRServeEngine(snap, batch_size=BATCH)
    frontier = []
    for precision in PRECISIONS:
        server = DeKRRReplicaServer(reg, replicas=REPLICAS,
                                    batch_size=BATCH, precision=precision)
        server.run(list(warm))
        # each precision is driven relative to its OWN closed-loop capacity
        cap = closed_qps(lambda: server.run(make_queries(n_cap // 2, xs)),
                         n_cap // 2, 1, device)
        name = precision or "fp64"
        for frac in LOADS:
            rate = max(frac * cap, 1.0)
            rng = np.random.default_rng(int(frac * 100))
            queries = make_queries(n_open, xs, seed=int(frac * 100))
            rep = open_loop(server, queries, rate, rng)
            row = {"precision": name, "capacity_qps": cap,
                   "offered_qps": rate, "achieved_qps": rep.qps,
                   "count": rep.count, "p50_ms": rep.p50 * 1e3,
                   "p99_ms": rep.p99 * 1e3, "max_answer_error": 0.0}
            if precision is not None:
                ref = ref_engine.run([KernelQuery(uid=q.uid, x=np.array(q.x))
                                      for q in queries])
                errs = np.array([
                    np.max(np.abs(np.asarray(q.prediction, np.float64)
                                  - np.asarray(r.prediction, np.float64)))
                    for q, r in zip(queries, ref)])
                bounds = np.array([q.staleness.precision for q in queries])
                row.update(max_answer_error=float(errs.max()),
                           mean_answer_error=float(errs.mean()),
                           max_precision_bound=float(bounds.max()),
                           all_within_bound=bool((errs <= bounds).all()))
                if not row["all_within_bound"]:
                    bad = int(np.argmax(errs - bounds))
                    raise RuntimeError(
                        f"{precision} answer uid {queries[bad].uid}: "
                        f"measured error {errs[bad]} exceeds its attached "
                        f"precision bound {bounds[bad]}")
            frontier.append(row)
            label = f"serve/open_{name}_f{int(frac * 100)}"
            C.csv_row(label, row["p99_ms"] * 1e3,
                      f"qps={row['achieved_qps']:.1f};"
                      f"p50_ms={row['p50_ms']:.3f};"
                      f"err={row['max_answer_error']:.2e}")
            if registry is not None:
                latency_event(registry, label, rep)
    results["frontier"] = frontier
    results.update(j_nodes=len(snap.feature_maps), batch_size=BATCH,
                   replicas=REPLICAS,
                   staleness_residual=snap.staleness.residual,
                   queries={"closed": n_cap, "open": n_open, "reps": reps})
    return results


def run(fast: bool = False, *, out: str | None = None, device=None,
        registry=None) -> dict:
    """The benchmark on the reference's snapshot; returns the results and
    writes them as JSON to `out` when given."""
    device = resolve_device(device)
    snap, test = build_snapshot(600 if fast else 1500, device)
    results = serve_frontier(
        snap, test[0].x.cpu().numpy(), n_cap=200 if fast else 600,
        n_open=60 if fast else 300, reps=2 if fast else 3,
        registry=registry)
    results = {"benchmark": ("replica serving tier: closed-loop capacity "
                             "vs single-engine baselines, Poisson "
                             "open-loop qps x p50/p99 x answer-error "
                             "frontier"),
               "device": device_name(device), **results}
    if out is not None:
        write_json(results, out)
        print(f"serve/json,0.0,wrote={out}")
    return results


if __name__ == "__main__":
    sys.exit(cli(run, __doc__))
