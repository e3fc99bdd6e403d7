"""The port's asynchronous gossip (schedule, ragged solver, packed runtime,
masked round and async-chain plain versions) held against the JAX package
on the reference's own test problems, float64, rtol 1e-9 and
atol 1e-12·max|ref|; the port's own invariants bit for bit.

The reference draws its activation masks with `jax.random`; the port is
fed the reference's mask table and censor thresholds, so every censor
decision falls on the same bits and the wire counts agree exactly.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core as R
import repro.dist as RDIST
import repro_torch.core as T
from conftest import cached_fmaps, cached_split
from repro.dist.async_gossip import _async_solve_impl
from repro.kernels import ops as rops
from repro.kernels.dekrr_step import \
    dekrr_step_masked_reference as ref_masked_reference
from repro_torch import interop
from repro_torch.dist import (AsyncGossipState, async_solve_batched,
                              async_step_batched, init_async_state,
                              pack_problem, solve_batched, step_batched)
from repro_torch.kernels import ops
from repro_torch.kernels.dekrr_solve import dekrr_async_solve_reference
from repro_torch.kernels.dekrr_step import (dekrr_step_masked_reference,
                                            dekrr_step_reference)
from repro_torch.obs import AsyncSolveTrace
from test_torch_gpu import assert_close, async_case, dekrr_case, to_t
from test_torch_packed import packs

CPU = "cpu"
ROUNDS = 15
KEY = jax.random.PRNGKey(7)
CENSOR = dict(censor_tau=2e-2, censor_decay=0.9)
BACKENDS = ("torch", "cuda", "cuda_fused")
TOPOLOGIES = {
    "circulant": (lambda m: m.circulant(6, (1, 2)), [8, 10, 12, 8, 10, 12]),
    "star": (lambda m: m.star(5), [6, 8, 10, 12, 14]),
    "er": (lambda m: m.erdos_renyi(6, 0.5, seed=2), [9, 11, 9, 11, 9, 11]),
    "complete": (lambda m: m.complete(4), [7, 9, 11, 9]),
    "j1": (lambda m: m.Topology(adjacency=np.zeros((1, 1), dtype=bool)),
           [10]),
}


@functools.lru_cache(maxsize=None)
def problem(name):
    """(reference solver, reference packing, port solver, port packing,
    dims) on the reference tests' problem for this topology."""
    make, dims = TOPOLOGIES[name]
    ref_topo = make(R)
    j = ref_topo.num_nodes
    _, train, _ = cached_split("air_quality", j, subsample=300, seed=0)
    fmaps = cached_fmaps("air_quality", j, tuple(dims), subsample=300,
                         seed=0)
    n = sum(t.num_samples for t in train)
    cfg = dict(lam=1e-6, c_nei=0.02 * n)
    ref = R.DeKRRSolver(ref_topo, fmaps, train, R.DeKRRConfig(**cfg))
    port = T.DeKRRSolver(
        T.Topology(adjacency=ref_topo.adjacency,
                   circulant_offsets=ref_topo.circulant_offsets),
        [interop.feature_map_from_arrays(np.asarray(f.omega),
                                         np.asarray(f.bias), f.kind,
                                         device=CPU) for f in fmaps],
        [interop.node_data_from_arrays(np.asarray(nd.x), np.asarray(nd.y),
                                       device=CPU) for nd in train],
        T.DeKRRConfig(**cfg), device=CPU)
    return (ref, RDIST.pack_problem(ref), port,
            pack_problem(port, device=CPU), dims)


def configs(prob=1.0, gossip="bernoulli", censored=False):
    kw = dict(prob=prob, gossip=gossip, **(CENSOR if censored else {}))
    return R.AsyncGossipConfig(**kw), T.AsyncGossipConfig(**kw)


def schedule(name, rounds, config, key=KEY):
    """The reference's mask table and censor thresholds, as tensors."""
    ref = problem(name)[0]
    edges = R.edge_list(ref.topology) if config.gossip == "edge" else None
    masks = R.activation_masks(key, rounds, ref.J, prob=config.prob,
                               gossip=config.gossip, edges=edges)
    thr = R.censor_schedule(config.censor_tau, config.censor_decay, rounds)
    return torch.as_tensor(np.array(masks)), torch.as_tensor(np.array(thr))


def port_solve(name, rounds, tconfig, rconfig, backend, **kw):
    masks, thr = schedule(name, rounds, rconfig)
    return async_solve_batched(problem(name)[3], rounds, masks,
                               config=tconfig, thresholds=thr,
                               backend=backend, **kw)


# ------------------------------------------------------------ the schedule
def test_censor_schedule_and_edge_lists_match_reference():
    got = T.censor_schedule(2e-2, 0.9, 40, device=CPU)
    assert_close(got, R.censor_schedule(2e-2, 0.9, 40))
    for name in TOPOLOGIES:
        ref, ref_packed, port, packed, _ = problem(name)
        want = R.edge_list(ref.topology)
        np.testing.assert_array_equal(T.edge_list(port.topology), want)
        np.testing.assert_array_equal(
            T.edges_from_slot_table(packed.nbr_idx.numpy(),
                                    packed.nbr_mask.numpy()), want)


def test_torch_activation_masks():
    gen = lambda: torch.Generator().manual_seed(3)
    m = T.activation_masks(gen(), 4000, 6, prob=0.25)
    assert m.shape == (4000, 6) and m.dtype == torch.bool
    assert abs(m.double().mean().item() - 0.25) < 0.02
    assert torch.equal(m, T.activation_masks(gen(), 4000, 6, prob=0.25))
    edges = R.edge_list(R.circulant(6, (1, 2)))
    e = T.activation_masks(gen(), 200, 6, gossip="edge", edges=edges)
    assert (e.sum(dim=1) == 2).all()
    pairs = {tuple(np.nonzero(row)[0]) for row in e.numpy()}
    assert pairs <= {tuple(p) for p in edges}
    with pytest.raises(ValueError, match="edge"):
        T.activation_masks(gen(), 3, 1, gossip="edge", edges=np.zeros((0, 2)))


def test_entry_points_default_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match='device="cpu"'):
        T.censor_schedule(2e-2, 0.9, 5)


# ------------------------------------------------- the conformance matrix
@pytest.mark.parametrize("name", list(TOPOLOGIES))
@pytest.mark.parametrize("prob", [0.25, 0.5, 1.0])
def test_async_conformance_matrix(name, prob):
    """Ragged reference == the port's ragged solver == the port's packed
    runtime on every backend, censored and not: θ at rtol 1e-9, the wire
    counts exactly."""
    ref, _, port, packed, dims = problem(name)
    for censored in (False, True):
        rconfig, tconfig = configs(prob, censored=censored)
        want = R.async_gossip_solve(ref, KEY, ROUNDS, rconfig)
        masks, thr = schedule(name, ROUNDS, rconfig)
        ragged = T.async_gossip_solve(port, masks, ROUNDS, tconfig,
                                      thresholds=thr)
        assert (ragged.rounds, ragged.broadcasts, ragged.deliveries) == \
            (want.rounds, want.broadcasts, want.deliveries)
        for a, w in zip(ragged.theta, want.theta):
            assert_close(a, w)
        for backend in BACKENDS:
            theta, stats = async_solve_batched(
                packed, ROUNDS, masks, config=tconfig, thresholds=thr,
                backend=backend, return_stats=True)
            for j, dj in enumerate(dims):
                assert_close(theta[j, :dj], want.theta[j])
                assert not theta[j, dj:].any()
            assert tuple(stats) == (ROUNDS, want.broadcasts,
                                    want.deliveries), backend


def test_censoring_actually_suppresses_broadcasts():
    on = port_solve("circulant", ROUNDS, *configs(censored=True)[::-1],
                    "cuda_fused", return_stats=True)[1]
    off = port_solve("circulant", ROUNDS, *configs()[::-1], "cuda_fused",
                     return_stats=True)[1]
    assert on.broadcasts < off.broadcasts
    assert on.deliveries < off.deliveries


@pytest.mark.parametrize("name", ["circulant", "star"])
@pytest.mark.parametrize("censored", [False, True])
def test_async_conformance_edge_gossip(name, censored):
    ref, _, port, packed, dims = problem(name)
    rconfig, tconfig = configs(gossip="edge", censored=censored)
    want = R.async_gossip_solve(ref, KEY, ROUNDS, rconfig)
    masks, thr = schedule(name, ROUNDS, rconfig)
    ragged = T.async_gossip_solve(port, masks, ROUNDS, tconfig,
                                  thresholds=thr)
    assert ragged.deliveries == ragged.broadcasts == want.broadcasts
    for backend in BACKENDS:
        theta, stats = async_solve_batched(
            packed, ROUNDS, masks, config=tconfig, thresholds=thr,
            backend=backend, return_stats=True)
        for j, dj in enumerate(dims):
            assert_close(theta[j, :dj], want.theta[j])
        assert (stats.broadcasts, stats.deliveries) == \
            (want.broadcasts, want.deliveries)


@pytest.mark.parametrize("name", list(TOPOLOGIES))
@pytest.mark.parametrize("backend", BACKENDS)
def test_p1_uncensored_is_bitwise_synchronous(name, backend):
    packed = problem(name)[3]
    masks = torch.ones((ROUNDS, packed.num_nodes), dtype=torch.bool)
    sync = solve_batched(packed, ROUNDS, backend=backend)
    got = async_solve_batched(packed, ROUNDS, masks, backend=backend)
    assert torch.equal(got, sync)


@pytest.mark.parametrize("gossip", ["bernoulli", "edge"])
@pytest.mark.parametrize("censored", [False, True])
def test_fused_chain_is_the_per_round_path(gossip, censored):
    """cuda_fused (the async-chain plain version) == cuda (the masked
    round, per round) bit for bit, for any chunking; both == the
    reference's packed runtime at rtol 1e-9."""
    rconfig, tconfig = configs(0.6, gossip, censored)
    _, ref_packed, _, packed, _ = problem("circulant")
    want = RDIST.async_solve_batched(ref_packed, ROUNDS, KEY, config=rconfig)
    masks, thr = schedule("circulant", ROUNDS, rconfig)
    run = lambda b, **kw: async_solve_batched(
        packed, ROUNDS, masks, config=tconfig, thresholds=thr, backend=b,
        **kw)
    fused = run("cuda_fused")
    assert torch.equal(fused, run("cuda"))
    assert_close(run("torch"), want)
    assert_close(fused, want)
    for chunk in (1, 7, 64):
        assert torch.equal(run("cuda_fused", chunk_rounds=chunk), fused)


def test_fused_stats_match_the_per_round_path():
    rconfig, tconfig = configs(0.6, censored=True)
    want = RDIST.async_solve_batched(problem("circulant")[1], ROUNDS, KEY,
                                     config=rconfig, return_stats=True)[1]
    for backend in BACKENDS:
        stats = port_solve("circulant", ROUNDS, tconfig, rconfig, backend,
                           return_stats=True)[1]
        assert tuple(stats) == (int(want.rounds), int(want.broadcasts),
                                int(want.deliveries)), backend


# -------------------------------------------------------- tol early stop
@pytest.mark.parametrize("backend", ["torch", "cuda_fused"])
def test_tol_rounds_identical_across_chunk_sizes(backend):
    """Convergence is checked after every round and frozen on the device,
    so rounds and θ do not depend on chunk_rounds; rounds equal the
    reference's and θ agrees at rtol 1e-9."""
    rconfig, tconfig = configs(0.5)
    want, want_rounds = RDIST.async_solve_batched(
        problem("circulant")[1], 500, KEY, config=rconfig, tol=1e-8,
        return_rounds=True)
    results = {chunk: port_solve("circulant", 500, tconfig, rconfig,
                                 backend, tol=1e-8, chunk_rounds=chunk,
                                 return_rounds=True)
               for chunk in (1, 7, 64)}
    theta, rounds = results[1]
    assert 0 < rounds < 500 and rounds == int(want_rounds)
    assert_close(theta, want)
    for chunk, (th, rd) in results.items():
        assert rd == rounds and torch.equal(th, theta), chunk


def _silent_start_schedule(rounds, silent=3):
    """A p = 0.5 mask table whose first `silent` rounds are all-silent,
    built by hand (no dependence on a PRNG's draw)."""
    masks, _ = schedule("circulant", rounds, R.AsyncGossipConfig(prob=0.5))
    masks[:silent] = False
    return masks


@pytest.mark.parametrize("backend", BACKENDS)
def test_tol_ignores_all_silent_rounds(backend):
    """An all-silent round has Δθ ≡ 0 by construction: tol > 0 must not
    stop there, and the rounds run and θ must not depend on
    chunk_rounds. Held against the reference runtime fed the same
    table."""
    masks = _silent_start_schedule(500)
    assert not masks[:3].any()
    _, ref_packed, port, packed, _ = problem("circulant")
    thr = torch.zeros(500, dtype=torch.float64)
    want, want_rounds = _async_solve_impl(
        ref_packed, jnp.asarray(masks.numpy()), jnp.asarray(thr.numpy()),
        None, num_iters=500, gossip="bernoulli", censored=False,
        backend="xla", tol=1e-8, chunk_rounds=None, return_rounds=True,
        return_stats=False, return_trace=False)
    got = {chunk: async_solve_batched(packed, 500, masks, backend=backend,
                                      tol=1e-8, chunk_rounds=chunk,
                                      return_rounds=True)
           for chunk in (1, 2, 7, 64)}
    theta, rounds = got[1]
    assert rounds > 3, "stopped on an idle round"
    assert theta.abs().max() > 0, "converged to the θ0 = 0 iterate"
    assert rounds == int(want_rounds)
    assert_close(theta, want)
    for chunk, (th, rd) in got.items():
        assert rd == rounds and torch.equal(th, theta), chunk
    ragged = T.async_gossip_solve(port, masks, 500, tol=1e-8)
    assert ragged.rounds == rounds


@pytest.mark.parametrize("backend", BACKENDS)
def test_warm_start_and_multi_output_match_reference(backend):
    """theta0 seeds θ, sent and the buffers; a Dy = 3 packing carries the
    output axis through every field, the censor taking the max over it."""
    rconfig, tconfig = configs(0.5, censored=True)
    masks, thr = schedule("circulant", ROUNDS, rconfig)
    _, ref_packed, _, packed, _ = problem("circulant")
    theta0 = np.random.default_rng(5).normal(
        size=tuple(packed.d.shape)) * packed.theta_mask.numpy() * 0.1
    want = _async_solve_impl(
        ref_packed, jnp.asarray(masks.numpy()), jnp.asarray(thr.numpy()),
        jnp.asarray(theta0), num_iters=ROUNDS, gossip="bernoulli",
        censored=True, backend="xla", tol=0.0, chunk_rounds=None,
        return_rounds=False, return_stats=True, return_trace=False)
    got, stats = async_solve_batched(packed, ROUNDS, masks, config=tconfig,
                                     thresholds=thr,
                                     theta0=torch.as_tensor(theta0),
                                     backend=backend, return_stats=True)
    assert_close(got, want[0])
    assert (stats.broadcasts, stats.deliveries) == \
        (int(want[1].broadcasts), int(want[1].deliveries))
    ref3, port3 = packs(3)
    want, wstats = RDIST.async_solve_batched(ref3, ROUNDS, KEY,
                                             config=rconfig,
                                             return_stats=True)
    got, stats = async_solve_batched(port3, ROUNDS, masks, config=tconfig,
                                     thresholds=thr, backend=backend,
                                     return_stats=True)
    assert got.shape == tuple(want.shape) == (6, 12, 3)
    assert_close(got, want)
    assert (stats.broadcasts, stats.deliveries) == \
        (int(wstats.broadcasts), int(wstats.deliveries))


# ----------------------------------------------------------------- traces
def _async_recompute(packed, masks, thr, tconfig):
    """Per-round series from the public single-round step."""
    state = init_async_state(packed)
    res, act, bc, dv = [], [], [], []
    for r in range(masks.shape[0]):
        new, info = async_step_batched(packed, state, masks[r], thr[r],
                                       gossip=tconfig.gossip,
                                       censored=tconfig.censored,
                                       backend="torch")
        res.append(float(torch.max(torch.abs(new.theta - state.theta))))
        act.append(int(masks[r].sum()))
        bc.append(int(info.bcast.sum()))
        dv.append(int(info.received.sum()))
        state = new
    return state.theta, np.array(res), np.array(act), np.array(bc), \
        np.array(dv)


def _per_bcast_bytes(packed):
    return packed.max_features * packed.num_outputs * packed.d.element_size()


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("name", ["circulant", "er", "j1", "star"])
def test_async_trace_matches_reference_and_recompute(name, backend):
    rconfig, tconfig = configs(0.5, censored=True)
    _, ref_packed, _, packed, _ = problem(name)
    masks, thr = schedule(name, ROUNDS, rconfig)
    theta, stats, trace = async_solve_batched(
        packed, ROUNDS, masks, config=tconfig, thresholds=thr,
        backend=backend, return_stats=True, return_trace=True)
    assert isinstance(trace, AsyncSolveTrace)
    want = _async_recompute(packed, masks, thr, tconfig)
    assert_close(theta, want[0])
    assert_close(trace.residuals, want[1])
    for got, ref in zip(trace[1:4], want[2:]):
        np.testing.assert_array_equal(got.numpy(), ref)
    np.testing.assert_array_equal(
        trace.bytes.numpy(), trace.broadcasts.numpy() * _per_bcast_bytes(
            packed))
    assert stats.broadcasts == want[3].sum()
    assert stats.deliveries == want[4].sum()
    ref_trace = RDIST.async_solve_batched(
        ref_packed, ROUNDS, KEY, config=rconfig, return_trace=True)[1]
    assert_close(trace.residuals, ref_trace.residuals)
    for f in ("active", "broadcasts", "deliveries", "bytes"):
        np.testing.assert_array_equal(getattr(trace, f).numpy(),
                                      np.asarray(getattr(ref_trace, f)))


def test_fused_trace_is_chunk_invariant():
    rconfig, tconfig = configs(0.5, censored=True)
    base = port_solve("circulant", ROUNDS, tconfig, rconfig, "cuda_fused",
                      return_trace=True)[1]
    for chunk in (1, 7, 64):
        got = port_solve("circulant", ROUNDS, tconfig, rconfig,
                         "cuda_fused", chunk_rounds=chunk,
                         return_trace=True)[1]
        for f in AsyncSolveTrace._fields:
            assert torch.equal(getattr(got, f), getattr(base, f)), (f, chunk)


@pytest.mark.parametrize("chunk", [1, 7, 64])
def test_tol_trace_frozen_rounds(chunk):
    rconfig, tconfig = configs(0.5, censored=True)
    iters = 200
    full = port_solve("circulant", iters, tconfig, rconfig, "cuda_fused",
                      return_trace=True)[1]
    _, rounds, trace = port_solve("circulant", iters, tconfig, rconfig,
                                  "cuda_fused", tol=1e-4,
                                  chunk_rounds=chunk, return_rounds=True,
                                  return_trace=True)
    want_rounds, want = RDIST.async_solve_batched(
        problem("circulant")[1], iters, KEY, config=rconfig, tol=1e-4,
        return_rounds=True, return_trace=True)[1:]
    assert 0 < rounds < iters and rounds == int(want_rounds)
    for f in AsyncSolveTrace._fields:
        got, ref = getattr(trace, f), getattr(full, f)
        assert got.shape == (iters,), f
        assert torch.equal(got[:rounds], ref[:rounds]), f
        assert not got[rounds:].any(), f
        if f == "residuals":
            assert_close(got, np.asarray(want.residuals))
        else:
            np.testing.assert_array_equal(got.numpy(),
                                          np.asarray(getattr(want, f)))


@pytest.mark.parametrize("backend", BACKENDS)
def test_degenerate_trace_is_the_sync_trace(backend):
    packed = problem("circulant")[3]
    sync = solve_batched(packed, ROUNDS, backend=backend,
                         return_trace=True)[1]
    masks = torch.ones((ROUNDS, 6), dtype=torch.bool)
    got = async_solve_batched(packed, ROUNDS, masks, backend=backend,
                              return_trace=True)[1]
    assert torch.equal(got.residuals, sync.residuals)
    live = int(packed.nbr_mask.count_nonzero())
    assert (got.active == 6).all() and (got.broadcasts == 6).all()
    assert (got.deliveries == live).all()


def test_censored_fraction_with_a_firing_threshold():
    """Thresholds chosen by hand so that the censor fires (the reference
    test's precondition rests on a PRNG draw)."""
    rconfig, tconfig = configs(0.5, censored=True)
    masks, _ = schedule("circulant", ROUNDS, rconfig)
    thr = torch.full((ROUNDS,), 5e-2, dtype=torch.float64)
    _, _, _, packed, _ = problem("circulant")
    trace = async_solve_batched(packed, ROUNDS, masks, config=tconfig,
                                thresholds=thr, return_trace=True)[1]
    censored = trace.active - trace.broadcasts
    assert censored.sum() > 0, "the threshold never fired"
    assert trace.broadcasts.sum() > 0, "the threshold fired every time"
    cf = trace.censored_fraction()
    assert ((cf >= 0) & (cf <= 1)).all()
    assert (cf[trace.active == 0] == 0).all()
    cf_lists = AsyncSolveTrace(**trace.as_lists()).censored_fraction()
    np.testing.assert_allclose(cf_lists, cf.numpy(), rtol=1e-12)
    want = _async_solve_impl(
        problem("circulant")[1], jnp.asarray(masks.numpy()),
        jnp.asarray(thr.numpy()), None, num_iters=ROUNDS, gossip="bernoulli",
        censored=True, backend="xla", tol=0.0, chunk_rounds=None,
        return_rounds=False, return_stats=False, return_trace=True)[1]
    np.testing.assert_array_equal(trace.broadcasts.numpy(),
                                  np.asarray(want.broadcasts))


# ------------------------------------------------------- the round extras
@pytest.mark.parametrize("backend", BACKENDS)
def test_step_extras_match_reference(backend):
    """step_batched(active=, nbr_theta=) against the reference's; all
    ones equals the unmasked round bit for bit."""
    _, ref_packed, _, packed, _ = problem("star")
    rng = np.random.default_rng(4)
    theta = rng.normal(size=tuple(packed.d.shape)) * packed.theta_mask.numpy()
    bufs = rng.normal(size=tuple(packed.nbr_idx.shape) + theta.shape[1:])
    active = np.array([1, 0, 1, 1, 0])
    want = RDIST.step_batched(ref_packed, jnp.asarray(theta),
                              active=jnp.asarray(active),
                              nbr_theta=jnp.asarray(bufs))
    th = torch.as_tensor(theta)
    got = step_batched(packed, th, backend=backend,
                       active=torch.as_tensor(active),
                       nbr_theta=torch.as_tensor(bufs))
    assert_close(got, want)
    assert torch.equal(got[1], th[1]) and torch.equal(got[4], th[4])
    ones = torch.ones(5, dtype=torch.int32)
    assert torch.equal(step_batched(packed, th, backend=backend,
                                    active=ones),
                       step_batched(packed, th, backend=backend))


@pytest.mark.parametrize("backend", BACKENDS)
def test_trailing_unit_output_axis_is_bit_identical(backend):
    packed = problem("circulant")[3]
    trailing = interop.packed_from_arrays(
        **{**interop.packed_to_arrays(packed),
           "d": interop.to_numpy(packed.d)[..., None]}, device=CPU)
    rconfig, tconfig = configs(0.5, censored=True)
    masks, thr = schedule("circulant", ROUNDS, rconfig)
    kw = dict(config=tconfig, thresholds=thr, backend=backend,
              return_trace=True)
    scalar, st = async_solve_batched(packed, ROUNDS, masks, **kw)
    multi, mt = async_solve_batched(trailing, ROUNDS, masks, **kw)
    assert torch.equal(multi[..., 0], scalar)
    for f in AsyncSolveTrace._fields[:4]:
        assert torch.equal(getattr(mt, f), getattr(st, f)), f


def test_async_gossip_rejects_bad_arguments():
    packed = problem("j1")[3]
    masks = torch.ones((5, 1), dtype=torch.bool)
    with pytest.raises(ValueError, match="prob"):
        T.AsyncGossipConfig(prob=0.0)
    with pytest.raises(ValueError, match="gossip"):
        T.AsyncGossipConfig(gossip="ring")
    with pytest.raises(ValueError, match="censor_tau"):
        T.AsyncGossipConfig(censor_tau=-1.0)
    with pytest.raises(ValueError, match="censor_decay"):
        T.AsyncGossipConfig(censor_decay=1.5)
    with pytest.raises(ValueError, match="backend"):
        async_solve_batched(packed, 5, masks, backend="pallas")
    with pytest.raises(ValueError, match="tol"):
        async_solve_batched(packed, 5, masks, tol=-1e-6)
    with pytest.raises(ValueError, match="chunk_rounds"):
        async_solve_batched(packed, 5, masks, chunk_rounds=0)
    with pytest.raises(ValueError, match="edge"):
        async_solve_batched(packed, 5, masks,
                            config=T.AsyncGossipConfig(gossip="edge"))
    with pytest.raises(ValueError, match="activation-mask"):
        async_solve_batched(packed, 4, masks)
    with pytest.raises(ValueError, match="activation-mask"):
        async_step_batched(packed, init_async_state(packed), masks)


# ------------------------------------------------- the kernels' contracts
@pytest.mark.parametrize("j,k,dfeat,dy,extra", [(5, 3, 12, 1, 0),
                                                (4, 2, 9, 3, 2),
                                                (3, 0, 7, 1, 0)])
def test_masked_round_matches_reference(j, k, dfeat, dy, extra):
    args = dekrr_case(j, k, dfeat, dy, extra, seed=j + k + dy)
    active = (np.arange(j) % 2).astype(np.int32)
    want = rops.dekrr_step(*[jnp.asarray(a) for a in args],
                           jnp.asarray(active), interpret=True)
    got = ops.dekrr_step(*to_t(args), torch.as_tensor(active))
    assert_close(got, want)
    lay = ops._pad_dekrr_operands("t", *to_t(args))[2]
    act = torch.as_tensor(active)
    raw = ref_masked_reference(*[jnp.asarray(a.numpy()) for a in lay],
                               jnp.asarray(active), dy=dy)
    assert_close(dekrr_step_masked_reference(*lay, act, dy=dy), raw)
    ones = torch.ones(j, dtype=torch.int32)
    assert torch.equal(dekrr_step_masked_reference(*lay, ones, dy=dy),
                       dekrr_step_reference(*lay, dy=dy))
    assert ops.launch_counts() == {n: 0 for n in ops.LAUNCHES}


ASYNC_CASES = [
    # (J, K, D, Dy, extra θ-table rows)
    (5, 3, 12, 1, 0),
    (4, 2, 9, 3, 2),       # T > J, Dy = 3
    (3, 0, 7, 1, 0),       # K = 0
]


@pytest.mark.parametrize("j,k,dfeat,dy,extra", ASYNC_CASES)
@pytest.mark.parametrize("gossip", ["bernoulli", "edge"])
@pytest.mark.parametrize("censored", [False, True])
def test_async_chain_matches_reference(j, k, dfeat, dy, extra, gossip,
                                       censored):
    """ops.dekrr_async_solve (its plain version on the CPU) against the
    reference wrapper in Pallas interpret mode, with the trace."""
    args = async_case(j, k, dfeat, dy, extra, rounds=5, seed=j + k + dy)
    kw = dict(gossip=gossip, censored=censored, trace=True)
    want = rops.dekrr_async_solve(*[jnp.asarray(a) for a in args],
                                  interpret=True, **kw)
    got = ops.dekrr_async_solve(*to_t(args), **kw)
    for a, w in zip(got[:4], want[:4]):
        assert a.shape == w.shape
        assert_close(a, w)
    np.testing.assert_array_equal(got[4].numpy(), np.asarray(want[4]))
    if censored:
        assert 0 < got[4].sum() < np.count_nonzero(args[9]), \
            "the censor must fire on some active node-rounds, not all"


def test_async_chain_is_masked_rounds_plus_delivery():
    """The chain's plain version == R masked rounds on the [θ; buffers]
    table followed by the delivery rule, bit for bit (in-port)."""
    args = to_t(async_case(5, 3, 12, 3, 0, rounds=6, seed=2))
    g, d, s, p, theta, sent, bufs, nbr_idx, nbr_mask, active, thr = args
    lay = ops._pad_dekrr_operands(
        "t", g, d, s, p, theta, nbr_idx, torch.arange(5), nbr_mask)[2]
    raw = lay[:5] + (ops._flatten_dy(sent), ops._flatten_buffers(bufs),
                     lay[5], lay[7], active, thr)
    chain = dekrr_async_solve_reference(*raw, censored=True,
                                        edge_gossip=False, dy=3)
    packed = interop.packed_from_arrays(
        g=g.numpy(), d=d.numpy(), s=s.numpy(), p=p.numpy(),
        theta_mask=np.ones((5, 12)), nbr_idx=nbr_idx.numpy(),
        nbr_mask=nbr_mask.numpy(), device=CPU)
    state = AsyncGossipState(theta, sent, bufs)
    for r in range(6):
        state, _ = async_step_batched(packed, state, active[r], thr[r],
                                      censored=True, backend="cuda")
    assert torch.equal(ops._unflatten_dy(chain[0], 3, 3), state.theta)
    assert torch.equal(ops._unflatten_dy(chain[1], 3, 3), state.sent)
    assert torch.equal(ops._unflatten_buffers(chain[2], 5, 3, 3, 3),
                       state.buffers)


def test_async_chain_wrapper_checks():
    args = list(to_t(async_case(4, 2, 6, 1, 0, rounds=3, seed=1)))
    out = ops.dekrr_async_solve(*args[:9], args[9][:0], args[10][:0],
                                trace=True)
    assert torch.equal(out[0], args[4][:4]) and out[3].shape == (0, 4)
    bad = list(args)
    bad[7] = args[7].clone()
    bad[7][0, 0] = 4                      # a node id past J ...
    masked = list(bad)
    masked[8] = args[8].clone()
    masked[8][0, 0] = 0.0                 # ... is legal on a masked slot
    ops.dekrr_async_solve(*masked)
    bad[8] = masked[8].clone()
    bad[8][0, 0] = 1.0                    # ... and refused on a live one
    with pytest.raises(ValueError, match="nbr_idx"):
        ops.dekrr_async_solve(*bad)
    with pytest.raises(ValueError, match="gossip"):
        ops.dekrr_async_solve(*args, gossip="ring")
    with pytest.raises(ValueError, match="shape"):
        ops.dekrr_async_solve(*args[:9], args[9][:, :3], args[10])
    assert ops.launch_counts() == {n: 0 for n in ops.LAUNCHES}
