"""The SPMD solvers (`make_spmd_solver`, `make_async_spmd_solver`: one node
per rank of a `torch.distributed` group) held against the JAX package's
batched solvers, float64, rtol 1e-9 and atol 1e-12·max|ref|.

The reference's own SPMD solvers do not run on the installed JAX (ROADMAP
§3, caveat A), so the port is held against what they are pinned to:
`solve_batched(..., tol, chunk_rounds=1)` for the sync solver and
`async_solve_batched` for the async one, on the reference tests'
problems (`tests/test_stream.py`'s 4-node circulant and
`tests/test_dekrr_spmd.py`'s 10-node one), packed by the reference and
carried across as arrays. The JAX side runs in the test process; the
ranks run in processes spawned by `repro_torch.dist.ranks.run_ranks`
(gloo, ``device="cpu"``, where the ``cuda*`` backends run the round
kernel's plain version), all 4-node cases in one launch.

The async cases are fed the reference's `activation_masks(PRNGKey(3), …)`
table and censor thresholds, so every censor decision falls on the same
bits and the wire counts agree exactly. Within the port, invariants hold
bit for bit.
"""
import dataclasses
import functools
import os
import time

import jax
import numpy as np
import pytest
import torch

import repro.core as R
import repro.dist as RDIST
import repro_torch.core as T
from conftest import cached_fmaps, cached_split
from repro.dist.async_gossip import _packed_edges
from repro_torch import interop
from repro_torch.analysis.dispatch import synthetic_packed
from repro_torch.dist import (async_solve_batched, comm_bytes_per_round,
                              make_async_spmd_solver, make_spmd_solver)
from repro_torch.dist.ranks import run_ranks
from repro_torch.dist.spmd_cases import solve_cases
from repro_torch.obs.dispatch import round_dispatches
from test_torch_gpu import assert_close

CPU = "cpu"
ROUNDS = 40
TOL = 1e-8
TOL_BUDGET = 600
WARM_ROUNDS = 30
KEY = jax.random.PRNGKey(3)
CENSOR = dict(censor_tau=2e-2, censor_decay=0.9)
MODES = ("ppermute", "allgather")
BACKENDS = ("torch", "cuda", "cuda_fused")
MASK_SEED = 11
# A launch's limit: spawning the ranks takes a few seconds; the 4-node
# cases take a few more. A hung collective fails the test at this bound.
SPAWN_TIMEOUT = 120.0


def to_port(ref_packed) -> "interop.PackedProblem":
    fields = ("g", "d", "s", "p", "theta_mask", "nbr_idx", "nbr_mask")
    return interop.packed_from_arrays(
        **{f: np.asarray(getattr(ref_packed, f)) for f in fields},
        offsets=ref_packed.offsets, node_dims=ref_packed.node_dims,
        num_edges_directed=ref_packed.num_edges_directed, device=CPU)


def ref_solver(topo, dims, *, subsample, lam):
    j = topo.num_nodes
    _, train, _ = cached_split("air_quality", j, subsample=subsample, seed=0)
    fmaps = cached_fmaps("air_quality", j, tuple(dims), subsample=subsample,
                         seed=0)
    n = sum(t.num_samples for t in train)
    return R.DeKRRSolver(topo, fmaps, train,
                         R.DeKRRConfig(lam=lam, c_nei=0.02 * n),
                         build_aux=False)


@functools.lru_cache(maxsize=None)
def problem4():
    """tests/test_stream.py's circulant(4, (1,)) problem, dims [8, 10, 12,
    8], λ 1e-3: (reference packing, port packing)."""
    ref = RDIST.pack_problem(ref_solver(R.circulant(4, (1,)), [8, 10, 12, 8],
                                        subsample=300, lam=1e-3))
    return ref, to_port(ref)


@functools.lru_cache(maxsize=None)
def problem4_dy3():
    """problem4 with two more seeded output columns (zero on padding)."""
    ref, _ = problem4()
    rng = np.random.default_rng(5)
    d = np.asarray(ref.d)
    mask = np.asarray(ref.theta_mask)
    d3 = np.stack([d, rng.standard_normal(d.shape) * mask,
                   rng.standard_normal(d.shape) * mask], axis=-1)
    ref3 = dataclasses.replace(ref, d=jax.numpy.asarray(d3))
    return ref3, to_port(ref3)


@functools.lru_cache(maxsize=None)
def star4():
    ref = RDIST.pack_problem(ref_solver(R.star(4), [8, 10, 12, 8],
                                        subsample=300, lam=1e-3))
    return to_port(ref)


def schedule(ref_packed, rounds, config):
    """The reference's mask table and censor thresholds, as tensors."""
    edges = _packed_edges(ref_packed) if config.gossip == "edge" else None
    masks = R.activation_masks(KEY, rounds, ref_packed.num_nodes,
                               prob=config.prob, gossip=config.gossip,
                               edges=edges)
    thr = R.censor_schedule(config.censor_tau, config.censor_decay, rounds)
    return torch.as_tensor(np.array(masks)), torch.as_tensor(np.array(thr))


def configs(**kw):
    return R.AsyncGossipConfig(**kw), T.AsyncGossipConfig(**kw)


ASYNC = {
    "censored": dict(prob=0.5, **CENSOR),
    "edge": dict(gossip="edge", **CENSOR),
    "p05": dict(prob=0.5),
}


@functools.lru_cache(maxsize=None)
def ref_sync():
    """The reference's solves on problem4: θ and trace at ROUNDS, θ and
    rounds at TOL, the warm start from that θ, and each output column of
    the Dy = 3 problem."""
    ref, _ = problem4()
    theta, trace = RDIST.solve_batched(ref, ROUNDS, return_trace=True)
    theta_t, rounds_t = RDIST.solve_batched(
        ref, TOL_BUDGET, tol=TOL, chunk_rounds=1, return_rounds=True)
    theta_w, rounds_w = RDIST.solve_batched(
        ref, TOL_BUDGET, theta_t, tol=TOL, chunk_rounds=1,
        return_rounds=True)
    ref3, _ = problem4_dy3()
    cols = [RDIST.solve_batched(dataclasses.replace(ref3, d=ref3.d[..., i]),
                                ROUNDS) for i in range(3)]
    return dict(theta=np.asarray(theta),
                residuals=np.asarray(trace.residuals),
                theta_tol=np.asarray(theta_t), rounds_tol=int(rounds_t),
                theta_warm=np.asarray(theta_w), rounds_warm=int(rounds_w),
                dy3=np.stack([np.asarray(c) for c in cols], axis=-1))


@functools.lru_cache(maxsize=None)
def ref_async(name, rounds, tol=0.0, warm=False):
    ref, _ = problem4()
    rconfig, _ = configs(**ASYNC[name])
    theta0 = (jax.numpy.ones_like(ref.d) * ref.theta_mask) if warm else None
    return RDIST.async_solve_batched(
        ref, rounds, KEY, config=rconfig, theta0=theta0, tol=tol,
        return_rounds=True, return_trace=True)


def cases4():
    """Every 4-node case, named; one launch runs them all."""
    _, packed = problem4()
    _, packed3 = problem4_dy3()
    cases = []
    add = lambda name, **c: cases.append(dict(name=name, **c))  # noqa: E731
    warm0 = torch.tensor(ref_sync()["theta_tol"])
    for mode in MODES:
        for b in BACKENDS:
            add(f"sync/{mode}/{b}", solver="sync", mode=mode, backend=b,
                num_iters=ROUNDS, kw=dict(return_trace=True,
                                          return_rounds=True))
            add(f"sync-tol/{mode}/{b}", solver="sync", mode=mode, backend=b,
                num_iters=TOL_BUDGET, kw=dict(tol=TOL, return_rounds=True))
            _, tconfig = configs(**ASYNC["censored"])
            masks, thr = schedule(problem4()[0], ROUNDS, tconfig)
            add(f"async/{mode}/{b}", solver="async", mode=mode, backend=b,
                num_iters=ROUNDS, kw=dict(masks=masks, thresholds=thr,
                                          config=tconfig, return_trace=True))
            add(f"async-sync/{mode}/{b}", solver="async", mode=mode,
                backend=b, num_iters=ROUNDS,
                kw=dict(masks=torch.ones((ROUNDS, 4), dtype=torch.bool),
                        return_trace=True))
        add(f"sync-warm/{mode}", solver="sync", mode=mode, backend="cuda",
            num_iters=TOL_BUDGET, kw=dict(theta0=warm0, tol=TOL,
                                          return_rounds=True))
        add(f"sync-dy3/{mode}", solver="sync", mode=mode, backend="cuda",
            num_iters=ROUNDS, packed=packed3)
        _, econfig = configs(**ASYNC["edge"])
        masks, thr = schedule(problem4()[0], ROUNDS, econfig)
        add(f"async-edge/{mode}", solver="async", mode=mode, backend="cuda",
            num_iters=ROUNDS, kw=dict(masks=masks, thresholds=thr,
                                      config=econfig, return_trace=True))
        _, pconfig = configs(**ASYNC["p05"])
        masks, _ = schedule(problem4()[0], TOL_BUDGET, pconfig)
        add(f"async-tol/{mode}", solver="async", mode=mode, backend="cuda",
            num_iters=TOL_BUDGET, kw=dict(masks=masks, config=pconfig,
                                          tol=TOL, return_rounds=True,
                                          return_trace=True))
        masks, _ = schedule(problem4()[0], WARM_ROUNDS, pconfig)
        add(f"async-warm/{mode}", solver="async", mode=mode, backend="cuda",
            num_iters=WARM_ROUNDS,
            kw=dict(masks=masks, config=pconfig,
                    theta0=torch.ones_like(packed.d) * packed.theta_mask))
    _, sconfig = configs(**ASYNC["censored"])
    add("async-seeded", solver="async", mode="ppermute", backend="cuda",
        num_iters=ROUNDS, kw=dict(seed=MASK_SEED, config=sconfig))
    add("err/world", solver="sync", mode="allgather", backend="cuda",
        num_iters=3, packed=synthetic_packed(j_nodes=5))
    add("err/star", solver="sync", mode="ppermute", backend="cuda",
        num_iters=3, packed=star4())
    add("err/mode", solver="async", mode="ring", backend="cuda", num_iters=3)
    add("err/tol", solver="sync", mode="ppermute", backend="cuda",
        num_iters=3, kw=dict(tol=-1.0))
    for call in range(2):
        add(f"mask/{call}", solver="mask", seed=MASK_SEED, rounds=8,
            num_nodes=4, kw=dict(prob=0.5))
    return cases


@pytest.fixture(scope="module")
def spmd4():
    """{case name: [rank 0 result, …, rank 3 result]}."""
    _, packed = problem4()
    cases = cases4()
    per_rank = run_ranks(solve_cases, 4, args=(packed, cases, CPU),
                         timeout=SPAWN_TIMEOUT)
    return {c["name"]: [rank[i] for rank in per_rank]
            for i, c in enumerate(cases)}


def outputs(spmd4, name):
    return spmd4[name][0]["out"]


# --------------------------------------------------------------------- sync
@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("mode", MODES)
def test_sync_matches_reference(spmd4, mode, backend):
    theta, rounds, _ = outputs(spmd4, f"sync/{mode}/{backend}")
    assert rounds == ROUNDS
    assert_close(theta, ref_sync()["theta"])


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("mode", MODES)
def test_sync_trace_matches_reference(spmd4, mode, backend):
    _, _, trace = outputs(spmd4, f"sync/{mode}/{backend}")
    assert trace.residuals.shape == (ROUNDS,)
    assert_close(trace.residuals, ref_sync()["residuals"])


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("mode", MODES)
def test_sync_tol_matches_reference(spmd4, mode, backend):
    theta, rounds = outputs(spmd4, f"sync-tol/{mode}/{backend}")
    want = ref_sync()
    assert rounds == want["rounds_tol"] < TOL_BUDGET
    assert_close(theta, want["theta_tol"])


@pytest.mark.parametrize("mode", MODES)
def test_sync_warm_start_stops_within_one_round(spmd4, mode):
    theta, rounds = outputs(spmd4, f"sync-warm/{mode}")
    want = ref_sync()
    assert rounds == want["rounds_warm"] <= 1
    assert_close(theta, want["theta_warm"])


@pytest.mark.parametrize("mode", MODES)
def test_sync_multi_output_equals_per_output_loop(spmd4, mode):
    theta = outputs(spmd4, f"sync-dy3/{mode}")
    assert theta.shape == (4, 12, 3)
    assert_close(theta, ref_sync()["dy3"])


@pytest.mark.parametrize("mode", MODES)
def test_sync_cuda_equals_cuda_fused_bit_for_bit(spmd4, mode):
    for kind in ("sync", "sync-tol"):
        a = outputs(spmd4, f"{kind}/{mode}/cuda")
        b = outputs(spmd4, f"{kind}/{mode}/cuda_fused")
        assert torch.equal(a[0], b[0]) and a[1] == b[1]


# -------------------------------------------------------------------- async
def assert_async_trace(got, want):
    assert_close(got.residuals, want.residuals)
    for f in ("active", "broadcasts", "deliveries", "bytes"):
        np.testing.assert_array_equal(getattr(got, f).numpy(),
                                      np.asarray(getattr(want, f)),
                                      err_msg=f)


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("mode", MODES)
def test_async_censored_matches_reference(spmd4, mode, backend):
    theta, trace = outputs(spmd4, f"async/{mode}/{backend}")
    want, _, want_trace = ref_async("censored", ROUNDS)
    assert_close(theta, want)
    assert_async_trace(trace, want_trace)
    assert 0 < int(trace.broadcasts.sum()) < int(trace.active.sum())


@pytest.mark.parametrize("mode", MODES)
def test_async_edge_gossip_matches_reference(spmd4, mode):
    theta, trace = outputs(spmd4, f"async-edge/{mode}")
    want, _, want_trace = ref_async("edge", ROUNDS)
    assert_close(theta, want)
    assert_async_trace(trace, want_trace)


@pytest.mark.parametrize("mode", MODES)
def test_async_tol_matches_reference(spmd4, mode):
    theta, rounds, trace = outputs(spmd4, f"async-tol/{mode}")
    want, want_rounds, want_trace = ref_async("p05", TOL_BUDGET, tol=TOL)
    assert rounds == int(want_rounds) < TOL_BUDGET
    assert_close(theta, want)
    assert_async_trace(trace, want_trace)


@pytest.mark.parametrize("mode", MODES)
def test_async_warm_start_matches_reference(spmd4, mode):
    theta = outputs(spmd4, f"async-warm/{mode}")
    want, _, _ = ref_async("p05", WARM_ROUNDS, warm=True)
    assert_close(theta, want)


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("mode", MODES)
def test_async_synchronous_schedule_equals_sync_bit_for_bit(spmd4, mode,
                                                            backend):
    theta, trace = outputs(spmd4, f"async-sync/{mode}/{backend}")
    sync_theta, _, sync_trace = outputs(spmd4, f"sync/{mode}/{backend}")
    assert torch.equal(theta, sync_theta)
    assert torch.equal(trace.residuals, sync_trace.residuals)


def test_async_seeded_masks_equal_the_batched_solve(spmd4):
    """masks=None, seed=s: every rank draws row r with activation_mask(s,
    r, …); the batched solve on that table gives the same θ."""
    _, packed = problem4()
    _, config = configs(**ASYNC["censored"])
    masks = torch.stack([T.activation_mask(MASK_SEED, r, 4, prob=0.5)
                         for r in range(ROUNDS)])
    want = async_solve_batched(packed, ROUNDS, masks, config=config,
                               backend="cuda")
    assert torch.equal(outputs(spmd4, "async-seeded"), want)


# ---------------------------------------------------- invariants and errors
@pytest.mark.parametrize("name,match", [
    ("err/world", "4 ranks but the problem has 5 nodes"),
    ("err/star", "circulant-packed"),
    ("err/mode", "mode must be one of"),
    ("err/tol", "tol must be >= 0"),
])
def test_error_paths(spmd4, name, match):
    for rank in spmd4[name]:
        assert match in rank["error"]


def test_activation_mask_same_in_every_rank_and_call(spmd4):
    want = torch.stack([T.activation_mask(MASK_SEED, r, 4, prob=0.5)
                        for r in range(8)])
    assert want.dtype == torch.bool and 0 < int(want.sum()) < want.numel()
    for call in range(2):
        for rank in spmd4[f"mask/{call}"]:
            assert torch.equal(rank["out"], want)
    other = torch.stack([T.activation_mask(MASK_SEED + 1, r, 4, prob=0.5)
                         for r in range(8)])
    assert not torch.equal(other, want)


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("solver", ["sync", "async"])
def test_dispatches_per_rank_match_the_contract(spmd4, solver, mode,
                                                backend):
    want = round_dispatches("cuda" if backend != "torch" else "torch",
                            ROUNDS)
    for rank in spmd4[f"{solver}/{mode}/{backend}"]:
        assert rank["dispatches"] == want
        assert all(v == 0 for v in rank["launches"].values())


@pytest.mark.parametrize("mode", MODES)
def test_wire_bytes_per_round_equal_the_cost_model(spmd4, mode):
    _, packed = problem4()
    ranks = spmd4[f"sync/{mode}/cuda"]
    assert all(r["exchanges"] == ROUNDS for r in ranks)
    per_round = sum(r["wire_bytes"] for r in ranks) / ROUNDS
    assert per_round == comm_bytes_per_round(packed, mode)


def test_every_rank_returns_the_same_result(spmd4):
    for name, ranks in spmd4.items():
        if "out" not in ranks[0] or name.startswith("mask"):
            continue
        first = ranks[0]["out"]
        first = first[0] if isinstance(first, tuple) else first
        for rank in ranks[1:]:
            got = rank["out"]
            assert torch.equal(got[0] if isinstance(got, tuple) else got,
                               first), name


def test_spmd_solvers_default_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    for make in (make_spmd_solver, make_async_spmd_solver):
        with pytest.raises(RuntimeError, match='device="cpu"'):
            make()


# ------------------------------------------------------------- the launcher
@pytest.mark.parametrize("fn,args,timeout,error,match", [
    (int, ("not a number",), 60.0, RuntimeError, r"rank [01] of 2 failed"),
    (os._exit, (3,), 60.0, RuntimeError,
     r"rank [01] of 2 exited with code 3"),
    (time.sleep, (600,), 4.0, TimeoutError, r"rank 0 of 2 .* within 4 s"),
])
def test_run_ranks_fails_naming_the_rank(fn, args, timeout, error, match):
    """A rank that raises, dies or hangs fails the launch, naming it; the
    launch kills every rank and returns well before a hung rank would."""
    t0 = time.monotonic()
    with pytest.raises(error, match=match):
        run_ranks(fn, 2, args=args, timeout=timeout)
    assert time.monotonic() - t0 < timeout + 20.0


# ------------------------------------------------ the paper's ten nodes
def test_ten_nodes_on_ten_ranks():
    """tests/test_dekrr_spmd.py's 10-node problem (air_quality at 400
    samples, circulant(10, (1, 2)), dims 8 + 2(j mod 4), λ 1e-6) on ten
    ranks: both modes at 40 rounds, the tol stop and a warm start."""
    dims = [8 + 2 * (j % 4) for j in range(10)]
    ref = RDIST.pack_problem(ref_solver(R.circulant(10, (1, 2)), dims,
                                        subsample=400, lam=1e-6))
    packed = to_port(ref)
    want = np.asarray(RDIST.solve_batched(ref, ROUNDS))
    want_t, want_rounds = RDIST.solve_batched(
        ref, TOL_BUDGET, tol=TOL, chunk_rounds=1, return_rounds=True)
    cases = [dict(solver="sync", mode=m, backend="cuda", num_iters=ROUNDS)
             for m in MODES]
    cases.append(dict(solver="sync", mode="ppermute", backend="cuda",
                      num_iters=TOL_BUDGET,
                      kw=dict(tol=TOL, return_rounds=True)))
    cases.append(dict(solver="sync", mode="ppermute", backend="cuda",
                      num_iters=TOL_BUDGET,
                      kw=dict(theta0=torch.tensor(np.asarray(want_t)),
                              tol=TOL, return_rounds=True)))
    got = run_ranks(solve_cases, 10, args=(packed, cases, CPU),
                    timeout=SPAWN_TIMEOUT)[0]
    for r in got[:2]:
        assert_close(r["out"], want)
    theta_t, rounds_t = got[2]["out"]
    assert rounds_t == int(want_rounds) < TOL_BUDGET
    assert_close(theta_t, want_t)
    assert got[3]["out"][1] <= 1
