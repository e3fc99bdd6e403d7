"""The port's streaming runtime (`repro_torch.stream`) held against the JAX
package's (`repro.stream`), float64.

Both sides get the same problems (`tests/test_stream.py`'s: air_quality
at 300 samples, λ 1e-3, c_nei 0.02·N), with the reference's DDRF maps
carried across by `interop.feature_map_from_arrays`, and run the same
ingest sequences on the same numpy minibatches. Tolerances: the packed
state, θ and the drift statistic at rtol 1e-9 with an atol of
1e-12·max|ref|; within the port, invariants bit for bit.

Draws. A refresh's candidate pool and the async activation masks are
`jax.random` draws in the reference. The refresh tests rebuild the
reference's pool from its key and hand it to the port
(`refresh(candidates=)`); the async test feeds the reference's mask
table to `async_solve_batched` on the stream's operator. The auto-refresh
test's drift-triggered refresh draws the port's own pool and is held to
the port's own from-scratch rebuild.

On CPU tensors the ``cuda*`` backends run the kernels' plain versions;
every test here checks that no wrapper counted a launch.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core as R
import repro.dist as RD
import repro.stream as RS
import repro_torch.core as T
from conftest import cached_fmaps, cached_split
from repro.core.rff import sample_rff as ref_sample_rff
from repro.serve import DeKRRServeEngine as RefEngine
from repro.serve import KernelQuery as RefQuery
from repro_torch import interop
from repro_torch.dist import (async_solve_batched, pack_problem, pack_theta,
                              solve_batched, unpack_theta)
from repro_torch.kernels import ops
from repro_torch.obs import spans
from repro_torch.serve import DeKRRServeEngine, KernelQuery
from repro_torch.stream import (DriftConfig, DriftDetector, SnapshotRegistry,
                                StreamConfig, StreamingDeKRR, ingest,
                                init_stream_aux, reference_lam, refresh_node,
                                repad_theta, to_packed)

CPU = "cpu"
LAM = 1e-3          # keeps cond(A) ≲ 1e5, as tests/test_stream.py
TOPOLOGIES = {
    "circulant": (lambda m: m.circulant(6, (1, 2)), (8, 12, 16, 8, 12, 16)),
    "star": (lambda m: m.star(5), (6, 8, 10, 12, 14)),
    "erdos_renyi": (lambda m: m.erdos_renyi(7, 0.5, seed=1), (9,) * 7),
    "single": (lambda m: m.Topology(adjacency=np.zeros((1, 1), bool)),
               (10,)),
}
BACKENDS = ("torch", "cuda", "cuda_fused")
CIRC5 = lambda m: m.circulant(5, (1,))          # noqa: E731
DIMS5 = (8, 10, 12, 8, 10)


@pytest.fixture(autouse=True)
def _no_launches_on_cpu():
    ops.reset_launch_counts()
    yield
    assert ops.launch_counts() == {k: 0 for k in ops.LAUNCHES}, \
        "a wrapper counted a launch for a CPU tensor"


def assert_close(got, want, rtol=1e-9):
    got = got.detach().cpu().numpy() if isinstance(got, torch.Tensor) \
        else np.asarray(got)
    want = want.detach().cpu().numpy() if isinstance(want, torch.Tensor) \
        else np.asarray(want)
    scale = np.abs(want).max() if want.size else 0.0
    np.testing.assert_allclose(got, want, rtol=rtol, atol=1e-12 * scale)


def _port_maps(fmaps):
    return [interop.feature_map_from_arrays(
        np.asarray(f.omega), None if f.bias is None else np.asarray(f.bias),
        f.kind, device=CPU) for f in fmaps]


def _port_data(train):
    return [interop.node_data_from_arrays(np.asarray(nd.x),
                                          np.asarray(nd.y), device=CPU)
            for nd in train]


def _solvers(topo="circulant", dims=None, method="energy", *, fmaps=None,
             train=None, make=None):
    """(reference solver, port solver, dataset) on one cached problem;
    `make(module)` replaces the topology of `topo`."""
    default_make, default_dims = TOPOLOGIES[topo]
    make = make or default_make
    dims = tuple(default_dims if dims is None else dims)
    ds, cached_train, _ = cached_split("air_quality", len(dims),
                                       subsample=300, seed=0)
    train = cached_train if train is None else train
    if fmaps is None:
        fmaps = cached_fmaps("air_quality", len(dims), dims, method=method,
                             subsample=300, seed=0)
    n = sum(t.num_samples for t in train)
    cfg = dict(lam=LAM, c_nei=0.02 * n)
    ref = R.DeKRRSolver(make(R), fmaps, train, R.DeKRRConfig(**cfg),
                        build_aux=False)
    port = T.DeKRRSolver(make(T), _port_maps(fmaps),
                         _port_data(train), T.DeKRRConfig(**cfg),
                         build_aux=False, device=CPU)
    return ref, port, ds


def _streams(topo="circulant", dims=None, *, ref_config=None,
             port_config=None, **kw):
    ref, port, ds = _solvers(topo, dims, **kw)
    return (RS.StreamingDeKRR(ref, ref_config or RS.StreamConfig()),
            StreamingDeKRR(port, port_config or StreamConfig()), ds)


def assert_packed_close(got, want):
    """A port PackedProblem against a reference (or port) one."""
    assert got.node_dims == want.node_dims
    assert got.offsets == want.offsets
    assert got.num_edges_directed == want.num_edges_directed
    np.testing.assert_array_equal(np.asarray(got.nbr_idx),
                                  np.asarray(want.nbr_idx))
    for name in ("g", "d", "s", "p", "theta_mask", "nbr_mask"):
        assert_close(getattr(got, name), getattr(want, name))


def _ingest_both(rr, pr, plan, dim, seed, dy=None):
    """The same minibatches into the reference stream (None: none) and
    the port's."""
    rng = np.random.default_rng(seed)
    for node, b in plan:
        x = rng.normal(size=(dim, b))
        y = rng.normal(size=b if dy is None else (b, dy))
        if rr is not None:
            rr.ingest(node, x, y)
        pr.ingest(node, x, y)


def _ref_candidates(rr, node, num_features):
    """The candidate pool the reference's `StreamingDeKRR.refresh` draws
    next for `node` (its key, bandwidth and ratio), as a port map."""
    cfg = rr.config
    key = jax.random.fold_in(jax.random.PRNGKey(cfg.seed),
                             1000 + rr.refresh_count)
    k_cand, _ = jax.random.split(key)
    fm = rr.feature_maps[node]
    freqs = num_features // 2 if fm.kind == "cos_sin" else num_features
    spread = float(np.std(np.asarray(fm.omega)))
    cand = ref_sample_rff(k_cand, fm.omega.shape[1],
                          cfg.refresh_candidate_ratio * freqs, 1.0 / spread,
                          kind=fm.kind)
    return _port_maps([cand])[0]


def _refresh_both(rr, pr, node, num_features=None):
    want = num_features if num_features is not None \
        else rr.aux.node_dims[node]
    cand = _ref_candidates(rr, node, want)
    ref_rep = rr.refresh(node, num_features=num_features)
    port_rep = pr.refresh(node, num_features=num_features, candidates=cand)
    assert dataclasses.astuple(port_rep) == dataclasses.astuple(ref_rep)
    assert_close(pr.feature_maps[node].omega, rr.feature_maps[node].omega)
    return port_rep


# ------------------------------------------- Woodbury ingest vs full rebuild
@pytest.mark.parametrize("topo", sorted(TOPOLOGIES))
@pytest.mark.parametrize("method", ["energy", "leverage"])
def test_ingest_parity_vs_full_rebuild(topo, method):
    """After k minibatches the port's Woodbury state equals the
    reference's, and the port's own from-scratch `pack_problem` on the
    accumulated data; the solve from it equals the reference's. On star
    and Erdős–Rényi graphs a node's padded slots repeat its own index, so
    a scatter that overwrote instead of accumulating would lose the
    node's own update here."""
    rr, pr, ds = _streams(topo, method=method)
    j = pr.num_nodes
    _ingest_both(rr, pr, [(0, 5), (j - 1, 17), (j // 2, 3), (0, 9)],
                 ds.dim, seed=7)
    assert pr.aux.n_live == rr.aux.n_live
    assert_packed_close(pr.packed, rr.packed)
    assert_packed_close(pr.packed, pack_problem(pr.reference_solver(),
                                                device=CPU))
    want = RD.solve_batched(rr.packed, 50)
    for backend in BACKENDS:
        assert_close(solve_batched(pr.packed, 50, backend=backend), want)


def test_reference_lam_tracks_pinned_ridge():
    rr, pr, ds = _streams()
    n0 = pr.aux.n_live
    assert reference_lam(pr.aux) == pytest.approx(LAM)
    assert pr.aux.nu == rr.aux.nu
    _ingest_both(rr, pr, [(0, 50)], ds.dim, seed=0)
    assert reference_lam(pr.aux) == pytest.approx(LAM * n0 / (n0 + 50))
    assert reference_lam(pr.aux) == RS.reference_lam(rr.aux)


def test_empty_minibatch_is_identity():
    _, port, ds = _solvers("single")
    aux = init_stream_aux(port)
    aux2 = ingest(aux, 0, np.zeros((ds.dim, 0)), np.zeros(0))
    assert aux2.n_live == aux.n_live
    assert torch.equal(aux2.binv, aux.binv)


def test_ingest_leaves_its_input_unchanged():
    """`ingest` is functional: folding twice from one state gives the same
    bits, and the state it was given keeps every bit."""
    _, port, ds = _solvers("star")
    aux = init_stream_aux(port)
    before = {f: getattr(aux, f).clone() for f in ("binv", "zy", "st", "pt")}
    rng = np.random.default_rng(3)
    x, y = rng.normal(size=(ds.dim, 12)), rng.normal(size=12)
    one = ingest(aux, 0, x, y)
    two = ingest(aux, 0, x, y)
    for f, t in before.items():
        assert torch.equal(getattr(aux, f), t), f
        assert torch.equal(getattr(one, f), getattr(two, f)), f
        assert not torch.equal(getattr(one, f), t), f
    assert aux.n_live + 12 == one.n_live


def test_multi_output_ingest_matches_reference():
    """Dy = 3: the label term [J, D_max, 3] folds as the reference's."""
    ds, train, _ = cached_split("air_quality", 6, subsample=300, seed=0)
    train = [R.NodeData(x=n.x, y=jnp.stack(
        [n.y * (1 - 0.4 * o) + 0.05 * o for o in range(3)], axis=1))
        for n in train]
    rr, pr, ds = _streams(train=train)
    assert pr.aux.zy.shape == (6, 16, 3)
    _ingest_both(rr, pr, [(1, 7), (4, 13)], ds.dim, seed=5, dy=3)
    assert_packed_close(pr.packed, rr.packed)
    rr.solve(rounds=40, tol=0.0)
    pr.solve(rounds=40, tol=0.0)
    assert_close(pr.theta, rr.theta)
    with pytest.raises(ValueError, match="Dy=3"):
        ingest(pr.aux, 0, np.zeros((ds.dim, 2)), np.zeros(2))


# ---------------------------------------------------------- feature refresh
@pytest.mark.parametrize("new_d", [18, 6])     # grows past D_max / shrinks
def test_refresh_then_solve_matches_scratch(new_d):
    rr, pr, ds = _streams(dims=(8, 12, 10, 8, 12, 10))
    _ingest_both(rr, pr, [(1, 11)], ds.dim, seed=3)
    old_dims = pr.aux.node_dims
    rep = _refresh_both(rr, pr, 1, new_d)
    assert rep.new_features == new_d
    assert rep.repadded == (max(pr.aux.node_dims) != max(old_dims))
    assert_packed_close(pr.packed, rr.packed)
    scratch = pack_problem(pr.reference_solver(), device=CPU)
    assert_packed_close(pr.packed, scratch)
    want = RD.solve_batched(rr.packed, 60)
    assert_close(solve_batched(pr.packed, 60), want)
    assert_close(solve_batched(scratch, 60), want)
    assert not pr.theta[1].any()
    _ingest_both(rr, pr, [(1, 6), (2, 4)], ds.dim, seed=4)
    assert_packed_close(pr.packed, rr.packed)
    assert_packed_close(pr.packed, pack_problem(pr.reference_solver(),
                                                device=CPU))


def test_refresh_node_matches_reference_on_a_given_map():
    """`refresh_node` on the reference's own new map (grown past D_max)
    gives the reference's state, and leaves the state it was given
    unchanged."""
    _, port, ds = _solvers(dims=(8, 12, 10, 8, 12, 10))
    ref, _, _ = _solvers(dims=(8, 12, 10, 8, 12, 10))
    raux, paux = RS.init_stream_aux(ref), init_stream_aux(port)
    key = jax.random.PRNGKey(11)
    new_ref = R.select_features(key, ds.dim, 15, 1.0, ref.data[2].x,
                                ref.data[2].y, candidate_ratio=4)
    ref_maps = list(ref.feature_maps)
    ref_maps[2] = new_ref
    port_maps = list(port.feature_maps)
    port_maps[2] = _port_maps([new_ref])[0]
    data_x = [np.asarray(nd.x) for nd in ref.data]
    before = paux.binv.clone()
    want = RS.refresh_node(raux, 2, new_ref, ref_maps, data_x,
                           np.asarray(ref.data[2].y))
    got = refresh_node(paux, 2, port_maps[2], port_maps, data_x,
                       np.asarray(ref.data[2].y))
    assert got.node_dims == want.node_dims
    for f in ("binv", "zy", "st", "pt", "theta_mask", "omega", "bias",
              "scale"):
        assert_close(getattr(got, f), getattr(want, f))
    np.testing.assert_array_equal(got.feat_idx.numpy(),
                                  np.asarray(want.feat_idx))
    assert torch.equal(paux.binv, before)
    assert_packed_close(to_packed(got), RS.to_packed(want))


def test_cos_sin_refresh_keeps_feature_count():
    """`num_features` counts packed features (D_j), select_features counts
    frequencies: a default cos_sin refresh must not double the node."""
    ds, train, _ = cached_split("air_quality", 5, subsample=300, seed=0)
    keys = jax.random.split(jax.random.PRNGKey(0), 5)
    fmaps = [R.select_features(keys[j], ds.dim, 6, 1.0, train[j].x,
                               train[j].y, method="energy",
                               candidate_ratio=5, kind="cos_sin")
             for j in range(5)]
    rr, pr, ds = _streams("circulant", (12,) * 5, fmaps=fmaps,
                          make=CIRC5)
    assert pr.aux.node_dims == (12,) * 5
    rep = _refresh_both(rr, pr, 2)
    assert rep.old_features == rep.new_features == 12
    assert pr.aux.node_dims == (12,) * 5
    assert_packed_close(pr.packed, rr.packed)
    assert_packed_close(pr.packed, pack_problem(pr.reference_solver(),
                                                device=CPU))
    with pytest.raises(ValueError, match="even"):
        pr.refresh(2, num_features=7)
    _ingest_both(rr, pr, [(2, 6)], ds.dim, seed=0)
    assert_packed_close(pr.packed, rr.packed)


def test_refresh_preserves_other_nodes_bits():
    """Only the refreshed node's slot (and the neighbour P̃ blocks that
    couple against it) may change: every other inverse, the neighbours'
    included, keeps its bits."""
    _, pr, _ = _streams(dims=(10,) * 6)
    before = pr.aux.binv.clone()
    pt_before = pr.aux.pt.clone()
    pr.refresh(2, num_features=10)
    after = pr.aux.binv
    for j in range(6):
        if j != 2:
            assert torch.equal(before[j], after[j]), j
    nbrs = set(pr.aux.nbr_idx[2].tolist())
    for j in range(6):
        if j not in nbrs | {2}:
            assert torch.equal(pt_before[j], pr.aux.pt[j]), j


def test_refresh_and_init_refusals():
    _, port, ds = _solvers(dims=(8, 12, 10, 8, 12, 10))
    aux = init_stream_aux(port)
    maps = list(port.feature_maps)
    gen = torch.Generator().manual_seed(0)
    new = T.select_features(gen, ds.dim, 9, 1.0, port.data[1].x,
                            port.data[1].y, candidate_ratio=3)
    data_x = [nd.x for nd in port.data]
    with pytest.raises(ValueError, match="refreshed map itself"):
        refresh_node(aux, 1, new, maps, data_x, port.data[1].y)
    grown = list(maps)
    grown[1] = new
    grown[3] = T.select_features(gen, ds.dim, 5, 1.0, port.data[3].x,
                                 port.data[3].y, candidate_ratio=3)
    with pytest.raises(ValueError, match="only change the refreshed"):
        refresh_node(aux, 1, new, grown, data_x, port.data[1].y)
    with pytest.raises(ValueError, match="out of range"):
        ingest(aux, 6, np.zeros((ds.dim, 1)), np.zeros(1))
    with pytest.raises(ValueError, match="minibatch must be"):
        ingest(aux, 0, np.zeros((ds.dim, 3)), np.zeros(2))
    gram_solver = T.DeKRRSolver(port.topology, port.feature_maps, port.data,
                                port.config, build_aux=False, device=CPU,
                                gram_fn=lambda fm, x: fm(x) @ fm(x).T)
    with pytest.raises(ValueError, match="gram_fn"):
        init_stream_aux(gram_solver)
    bagged = [T.NodeData(x=nd.x, y=nd.y[: (nd.num_samples + 1) // 2],
                         bags=torch.arange(nd.num_samples) // 2)
              for nd in port.data]
    bag_solver = T.DeKRRSolver(port.topology, port.feature_maps, bagged,
                               port.config, build_aux=False, device=CPU)
    with pytest.raises(ValueError, match="bagged"):
        init_stream_aux(bag_solver)


# ------------------------------------------- θ re-padding across refreshes
def test_theta_roundtrip_across_growing_refresh():
    _, pr, _ = _streams(dims=(8, 12, 10, 8, 12, 10))
    pr.solve(rounds=30, tol=0.0)
    ragged_old = unpack_theta(pr.packed, pr.theta)
    pr.refresh(0, num_features=20)             # D_max 12 → 20
    new_packed = pr.packed
    carried = list(ragged_old)
    carried[0] = torch.zeros(new_packed.node_dims[0], dtype=torch.float64)
    repacked = pack_theta(new_packed, carried)
    assert torch.equal(repacked, pr.theta)
    assert torch.equal(pack_theta(new_packed,
                                  unpack_theta(new_packed, repacked)),
                       repacked)


def test_stale_theta_raises_clear_errors():
    _, pr, _ = _streams(dims=(8, 12, 10, 8, 12, 10))
    pr.solve(rounds=10, tol=0.0)
    old_packed = pr.packed
    theta_old = pr.theta
    ragged_old = unpack_theta(old_packed, theta_old)
    pr.refresh(1, num_features=4)              # node 1: 12 → 4 features
    new_packed = pr.packed
    with pytest.raises(ValueError, match="stale"):
        pack_theta(new_packed, ragged_old)
    _, pr2, _ = _streams(dims=(8, 12, 10, 8, 12, 10))
    pr2.refresh(0, num_features=20)
    with pytest.raises(ValueError, match="different packing"):
        unpack_theta(pr2.packed, theta_old)
    carried = repad_theta(theta_old, old_packed.node_dims,
                          new_packed.node_dims, reset=(1,))
    assert carried.shape == (6, new_packed.max_features)
    assert not carried[1].any()
    want = RS.repad_theta(np.asarray(theta_old), old_packed.node_dims,
                          new_packed.node_dims, reset=(1,))
    assert_close(carried, want)
    with pytest.raises(ValueError, match="stale"):
        repad_theta(theta_old, old_packed.node_dims, new_packed.node_dims)
    with pytest.raises(ValueError, match="OLD packing"):
        repad_theta(theta_old[:, :5], old_packed.node_dims,
                    new_packed.node_dims, reset=(1,))


# ----------------------------- StreamingDeKRR: backends, warm start, serve
def _epoch_batches(dim, seed=11, epochs=2):
    rng = np.random.default_rng(seed)
    return [[(j, rng.normal(size=(dim, 6)), rng.normal(size=6))
             for j in (0, 3)] for _ in range(epochs)]


def test_streaming_sync_backends_match_reference():
    """θ after interleaved ingest/solve epochs: every port backend equals
    the reference at rtol 1e-9, and cuda equals cuda_fused bit for bit."""
    got = {}
    rr, _, ds = _streams("circulant", DIMS5, make=CIRC5, ref_config=(
        RS.StreamConfig(rounds_per_epoch=40, tol=0.0)))
    for batches in _epoch_batches(ds.dim):
        rr.step_epoch(batches)
    for backend in BACKENDS:
        _, port, _ = _solvers("circulant", DIMS5, make=CIRC5)
        pr = StreamingDeKRR(port, StreamConfig(
            backend=backend, rounds_per_epoch=40, tol=0.0))
        for batches in _epoch_batches(ds.dim):
            pr.step_epoch(batches)
        assert pr.theta_version == 2
        got[backend] = pr.theta
    for backend in BACKENDS:
        assert_close(got[backend], rr.theta)
    assert torch.equal(got["cuda"], got["cuda_fused"])


def test_streaming_async_epoch_matches_reference_on_its_masks():
    """An async epoch on the stream's operator: the port's async solve,
    fed the reference's activation table, lands on the reference
    runtime's θ on every backend; the port's own async runtime (its own
    masks) agrees across backends, cuda and cuda_fused bit for bit."""
    cfg = dict(gossip="async", rounds_per_epoch=40, tol=0.0, seed=3)
    rr, pr, ds = _streams(
        "circulant", DIMS5, make=CIRC5,
        ref_config=RS.StreamConfig(
            async_config=R.AsyncGossipConfig(prob=0.5), **cfg),
        port_config=StreamConfig(
            async_config=T.AsyncGossipConfig(prob=0.5), **cfg))
    plan = [(0, 6), (3, 6)]
    _ingest_both(rr, pr, plan, ds.dim, seed=11)
    key = jax.random.fold_in(jax.random.PRNGKey(3), rr.theta_version)
    masks = torch.as_tensor(np.array(R.activation_masks(key, 40, 5,
                                                          prob=0.5)))
    theta0 = pr.theta
    rr.solve()
    for backend in BACKENDS:
        got = async_solve_batched(pr.packed, 40, masks,
                                  config=T.AsyncGossipConfig(prob=0.5),
                                  theta0=theta0, backend=backend)
        assert_close(got, rr.theta)
    outs = {}
    for backend in BACKENDS:
        _, port, _ = _solvers("circulant", DIMS5, make=CIRC5)
        p2 = StreamingDeKRR(port, StreamConfig(
            backend=backend, async_config=T.AsyncGossipConfig(prob=0.5),
            **cfg))
        _ingest_both(None, p2, plan, ds.dim, seed=11)
        rep = p2.solve()
        assert rep.rounds_run == 40 and rep.theta_version == 1
        outs[backend] = p2.theta
    assert_close(outs["cuda"], outs["torch"])
    assert torch.equal(outs["cuda"], outs["cuda_fused"])
    assert not torch.equal(outs["cuda"], theta0)


def test_streaming_state_matches_scratch_solve_all_backends():
    """After an ingest/refresh sequence the port's packed state and solve
    equal the reference's and the port's from-scratch rebuild."""
    rr, pr, ds = _streams(
        "circulant", DIMS5, make=CIRC5,
        ref_config=RS.StreamConfig(rounds_per_epoch=30, tol=0.0),
        port_config=StreamConfig(rounds_per_epoch=30, tol=0.0))
    _ingest_both(rr, pr, [(0, 8), (2, 12)], ds.dim, seed=5)
    _refresh_both(rr, pr, 4, 14)
    _ingest_both(rr, pr, [(4, 5)], ds.dim, seed=6)
    scratch = pack_problem(pr.reference_solver(), device=CPU)
    assert_packed_close(pr.packed, scratch)
    assert_packed_close(pr.packed, rr.packed)
    want = RD.solve_batched(rr.packed, 40)
    for backend in BACKENDS:
        assert_close(solve_batched(pr.packed, 40, backend=backend), want)
        assert_close(solve_batched(scratch, 40, backend=backend), want)


@pytest.mark.parametrize("backend", ["torch", "cuda"])
def test_warm_start_reaches_tol_in_fewer_rounds(backend):
    """Warm rounds < cold rounds, both as many as the reference's (tol
    checked every round), and the warm θ on the reference's."""
    rr, pr, ds = _streams(
        dims=(10,) * 6,
        ref_config=RS.StreamConfig(rounds_per_epoch=600, tol=1e-9),
        port_config=StreamConfig(backend=backend, rounds_per_epoch=600,
                                 tol=1e-9))
    cold, ref_cold = pr.solve(), rr.solve()
    assert cold.converged and cold.rounds_run < 600
    assert cold.rounds_run == ref_cold.rounds_run
    _ingest_both(rr, pr, [(1, 10)], ds.dim, seed=2)
    warm, ref_warm = pr.solve(), rr.solve()
    assert warm.converged and warm.rounds_run < cold.rounds_run
    assert warm.rounds_run == ref_warm.rounds_run
    assert_close(pr.theta, rr.theta)
    star_ = solve_batched(pack_problem(pr.reference_solver(), device=CPU),
                          5000, backend="torch", tol=1e-13)
    np.testing.assert_allclose(pr.theta.numpy(), star_.numpy(), rtol=0,
                               atol=5e-7)


def test_staleness_bound_tracks_ingest_and_solve():
    rr, pr, ds = _streams(
        "circulant", (8,) * 5, make=CIRC5,
        ref_config=RS.StreamConfig(rounds_per_epoch=300, tol=1e-9),
        port_config=StreamConfig(backend="torch", rounds_per_epoch=300,
                                 tol=1e-9))
    pr.solve()
    rr.solve()
    s0 = pr.staleness()
    assert s0.theta_version == 1 and s0.ingests_behind == 0
    assert s0.residual < 1e-8
    _ingest_both(rr, pr, [(0, 20)], ds.dim, seed=4)
    s1, r1 = pr.staleness(), rr.staleness()
    assert (s1.ingests_behind, s1.samples_behind) == (1, 20)
    assert s1.residual > s0.residual     # the fixed point moved under θ
    assert s1.residual == pytest.approx(r1.residual, rel=1e-6)
    assert pr.staleness() is s1          # cached per state
    pr.solve()
    assert pr.staleness().ingests_behind == 0


# ------------------------------------------------------------------- drift
def test_drift_quiet_on_stationary_loud_on_shift():
    """The port's detector issues the reference's statistics on the same
    maps and windows."""
    ref, port, ds = _solvers("circulant", (10,) * 5, make=CIRC5)
    cfg = dict(threshold=0.3, min_samples=24)
    det = DriftDetector(port.feature_maps, port.data, DriftConfig(**cfg))
    ref_det = RS.DriftDetector(ref.feature_maps, ref.data,
                               RS.DriftConfig(**cfg))
    x0 = np.asarray(ref.data[0].x)
    y0 = np.asarray(ref.data[0].y).reshape(-1)
    rng = np.random.default_rng(0)
    shifted = (rng.normal(size=(ds.dim, 30)) * 6.0 + 4.0,
               rng.normal(size=30) * 10.0)
    verdicts = []
    for node, x, y in ((0, x0[:, :30], y0[:30]), (0, *shifted),
                       (1, x0[:, :4], y0[:4])):
        got, want = det.observe(node, x, y), ref_det.observe(node, x, y)
        assert (got.refresh, got.window_samples) == \
            (want.refresh, want.window_samples)
        if want.stat is None:
            assert got.stat is None
        else:
            assert got.stat == pytest.approx(want.stat, rel=1e-9, abs=1e-15)
        verdicts.append(got)
    quiet, loud, pending = verdicts
    assert quiet.stat < 0.3 and loud.stat > quiet.stat
    assert pending.stat is None and not pending.refresh
    lev = DriftDetector(port.feature_maps, port.data,
                        DriftConfig(score="leverage", **cfg))
    ref_lev = RS.DriftDetector(ref.feature_maps, ref.data,
                               RS.DriftConfig(score="leverage", **cfg))
    got, want = lev.observe(2, *shifted), ref_lev.observe(2, *shifted)
    assert got.stat == pytest.approx(want.stat, rel=1e-9, abs=1e-15)
    with pytest.raises(ValueError, match="threshold"):
        DriftConfig(threshold=0.0)


def test_runtime_auto_refresh_on_drift():
    """A loud window refreshes the node (the port's own draw); the state
    stays exactly rebuildable, and the verdict is the reference's."""
    cfg = dict(drift=None, rounds_per_epoch=30, tol=0.0)
    drift = dict(threshold=0.05, min_samples=16)
    rr, pr, ds = _streams(
        "circulant", (10,) * 5, make=CIRC5,
        ref_config=RS.StreamConfig(**dict(cfg, drift=RS.DriftConfig(
            **drift))),
        port_config=StreamConfig(**dict(cfg, drift=DriftConfig(**drift))))
    rng = np.random.default_rng(1)
    x, y = rng.normal(size=(ds.dim, 24)) * 8.0 + 5.0, \
        rng.normal(size=24) * 10.0
    rep, ref_rep = pr.ingest(3, x, y), rr.ingest(3, x, y)
    assert rep.drift.stat == pytest.approx(ref_rep.drift.stat, rel=1e-9)
    assert rep.refreshed and ref_rep.refreshed and pr.refresh_count == 1
    assert_packed_close(pr.packed, pack_problem(pr.reference_solver(),
                                                device=CPU))


# ----------------------------------------------------------------- serving
def test_serve_engine_matches_predict_with_staleness():
    """`DeKRRServeEngine(rt)` serves the live stream: answers equal
    `rt.predict` and the reference's answers, each with its staleness."""
    rr, pr, ds = _streams(
        "circulant", (10,) * 5, make=CIRC5,
        ref_config=RS.StreamConfig(rounds_per_epoch=300, tol=1e-9),
        port_config=StreamConfig(backend="torch", rounds_per_epoch=300,
                                 tol=1e-9))
    _, _, test = cached_split("air_quality", 5, subsample=300, seed=0)
    pr.solve()
    rr.solve()
    xs = np.asarray(test[0].x)[:, :9]
    want_mean = pr.predict(xs).numpy()
    want_node = pr.predict(xs, node=2).numpy()
    assert_close(want_mean, np.asarray(rr.predict(jnp.asarray(xs))))
    ref_out = RefEngine(rr, batch_size=4).run(
        [RefQuery(uid=i, x=xs[:, i]) for i in range(9)])
    for backend in ("torch", "cuda"):
        eng = DeKRRServeEngine(pr, batch_size=4, backend=backend)
        queries = [KernelQuery(uid=i, x=xs[:, i]) for i in range(9)]
        queries.append(KernelQuery(uid=99, x=xs, node=2))
        out = eng.run(queries)
        got = np.array([q.prediction for q in out[:9]])
        np.testing.assert_allclose(got, want_mean, rtol=1e-12,
                                   atol=1e-14, err_msg=backend)
        assert_close(got, np.array([q.prediction for q in ref_out]))
        np.testing.assert_allclose(np.asarray(out[9].prediction),
                                   want_node, rtol=1e-12, atol=1e-14)
        for q in out:
            assert q.done and q.staleness is not None
            assert q.staleness.theta_version == 1
            assert q.staleness.residual < 1e-8


def test_serve_staleness_reflects_unsolved_ingest():
    _, pr, ds = _streams(
        "circulant", (8,) * 5, make=CIRC5,
        port_config=StreamConfig(backend="torch", rounds_per_epoch=300,
                                 tol=1e-9))
    pr.solve()
    _ingest_both(None, pr, [(0, 16)], ds.dim, seed=9)
    out = DeKRRServeEngine(pr, batch_size=8, backend="torch").run(
        [KernelQuery(uid=0, x=np.zeros(ds.dim))])
    bound = out[0].staleness
    assert bound.ingests_behind == 1 and bound.samples_behind == 16
    reg = SnapshotRegistry()
    assert reg.publish_from(pr) == 1
    assert reg.latest().staleness == bound


def test_stream_events_emit_spans():
    _, pr, ds = _streams("circulant", (8,) * 5, make=CIRC5)
    reg = SnapshotRegistry()
    with spans.recording() as rec:
        _ingest_both(None, pr, [(1, 4)], ds.dim, seed=1)
        pr.refresh(2, num_features=6)
        pr.solve(rounds=5, tol=0.0)
        reg.publish_from(pr)
    names = [(s.name, s.parent) for s in rec.spans]
    assert names == [("stream.ingest", None),
                     ("ddrf.select", "stream.refresh"),
                     ("stream.refresh", None), ("solve", None),
                     ("stream.publish", None)]
    assert rec.spans[0].attrs == {"node": 1, "batch": 4}


# ------------------------------------------------------------------ interop
def test_stream_aux_round_trip_and_continuation():
    """A reference StreamAux carried across continues on both sides: the
    same ingests give the same state at rtol 1e-9; the arrays round-trip
    exactly."""
    ref, port, ds = _solvers("star")
    raux = RS.init_stream_aux(ref)
    fields = {f: np.asarray(getattr(raux, f)) for f in (
        "binv", "zy", "st", "pt", "theta_mask", "nbr_idx", "nbr_mask",
        "omega", "bias", "feat_idx", "scale", "u_self", "u_cross", "u_s")}
    meta = {f: getattr(raux, f) for f in ("n_live", "nu", "n_ref",
                                           "node_dims", "offsets", "kind")}
    paux = interop.stream_aux_from_arrays(**fields, **meta, device=CPU)
    back = interop.stream_aux_to_arrays(paux)
    for f, a in fields.items():
        np.testing.assert_array_equal(back[f], a, err_msg=f)
    assert {f: back[f] for f in meta} == meta
    np.testing.assert_array_equal(paux.rslot, raux.rslot)
    for got, want in zip(paux.ingest_tables, raux.ingest_tables):
        np.testing.assert_array_equal(got.numpy(), want)
    assert_packed_close(to_packed(paux), RS.to_packed(raux))
    rng = np.random.default_rng(8)
    for node, b in ((0, 9), (3, 4), (0, 2)):
        x, y = rng.normal(size=(ds.dim, b)), rng.normal(size=b)
        raux = RS.ingest(raux, node, x, y)
        paux = ingest(paux, node, x, y)
    for f in ("binv", "zy", "st", "pt"):
        assert_close(getattr(paux, f), getattr(raux, f))
    assert paux.n_live == raux.n_live
    own = interop.stream_aux_to_arrays(init_stream_aux(port))
    for f in ("binv", "zy", "st", "pt"):
        assert_close(own[f], fields[f])


# --------------------------------------------------------------- the bench
def test_stream_bench_runs_on_the_cpu(tmp_path):
    """The bench's schedule at its fast size: warm below cold, answers
    with staleness, and its JSON only at the path it was given."""
    import os
    from conftest import REPO_ROOT
    from repro_torch.bench import stream_bench
    bench_json = os.path.join(REPO_ROOT, "BENCH_stream.json")
    before = os.stat(bench_json).st_mtime_ns
    out = tmp_path / "stream.json"
    res = stream_bench.run(fast=True, out=str(out), device=CPU)
    assert os.stat(bench_json).st_mtime_ns == before
    assert out.exists() and '"warm_rounds_mean"' in out.read_text()
    assert res["device"] == "cpu" and res["j_nodes"] == 10
    assert [r["batch"] for r in res["ingest"]] == [8, 32]
    assert res["warm_rounds_mean"] < res["cold_rounds_mean"]
    assert all(e["warm_rounds"] < e["cold_rounds"] for e in res["epochs"])
    assert res["serve"]["qps"] > 0 and res["refresh_ms"] > 0
