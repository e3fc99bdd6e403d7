"""The port's baselines (centralized KRR and RF, DKLA, DKLA-DDRF), the
solver's ``gram_fn`` and `pack_problem`'s rule for it, held against the
JAX reference on the same numpy inputs and the reference's draws.

Tolerances: rtol 1e-9 (atol 1e-12·max|ref|) in float64; the ``gram_fn``
solvers compute their Gram blocks in float32 and are held at rtol 2e-4,
atol 2e-4, the reference's own tolerance for that pairing
(`tests/test_kernels_rff.py::test_gram_fn_for_solver_integration`).
"""
import warnings

import jax
import numpy as np
import pytest
import torch

import repro.core as R
import repro.kernels.ops as RK
import repro_torch.core as T
from conftest import cached_split
from repro.data.synthetic import (imbalanced_sizes, make_dataset, partition,
                                  pooled, train_test_split_nodes)
from repro_torch import interop
from repro_torch.dist import pack_problem
from repro_torch.kernels import ops

CPU = "cpu"
SIGMA, LAM = 1.0, 1e-6


def assert_close(got, want, rtol=1e-9, atol=None):
    got = got.detach().cpu().numpy() if isinstance(got, torch.Tensor) \
        else np.asarray(got)
    want = np.asarray(want)
    if atol is None:
        atol = 1e-12 * (np.abs(want).max() if want.size else 0.0)
    np.testing.assert_allclose(got, want, rtol=rtol, atol=atol)


def port_fmap(f):
    return interop.feature_map_from_arrays(
        np.asarray(f.omega), None if f.bias is None else np.asarray(f.bias),
        f.kind, device=CPU)


def port_nodes(nodes):
    return [interop.node_data_from_arrays(np.asarray(n.x), np.asarray(n.y),
                                          device=CPU) for n in nodes]


def as_t(a):
    return torch.as_tensor(np.array(a))


# ---------------------------------------------------------------- centralized
def test_centralized_krr_matches():
    _, train, test = cached_split("houses", 10, subsample=600, seed=0)
    tr, te = pooled(train), pooled(test)
    ref = R.CentralizedKRR(SIGMA, LAM).fit(tr.x, tr.y)
    port = T.CentralizedKRR(SIGMA, LAM).fit(as_t(tr.x), as_t(tr.y))
    want = np.asarray(ref.predict(te.x))
    # K + λN I has a condition number near 1e6 here, so α carries ~1e-10
    # relative error from the summation order alone and a prediction near
    # zero carries it absolutely: atol 1e-11·max|ref| beside rtol 1e-9
    assert_close(port.predict(as_t(te.x)), want,
                 atol=1e-11 * np.abs(want).max())


def test_centralized_rf_matches():
    ds, train, test = cached_split("houses", 10, subsample=600, seed=0)
    tr, te = pooled(train), pooled(test)
    fm = R.sample_rff(jax.random.PRNGKey(3), ds.dim, 40, SIGMA)
    ref = R.CentralizedRF(fm, LAM).fit(tr.x, tr.y)
    port = T.CentralizedRF(port_fmap(fm), LAM).fit(as_t(tr.x), as_t(tr.y))
    assert_close(port.theta, ref.theta)
    assert_close(port.predict(as_t(te.x)), ref.predict(te.x))


# ----------------------------------------------------------------------- DKLA
@pytest.fixture(scope="module")
def dkla_pair():
    """The reference's and the port's DKLA after 250 iterations, which
    crosses one ρ doubling (at k = 200)."""
    ds, train, test = cached_split("houses", 10, subsample=600, seed=0)
    topo_r, topo_t = R.circulant(10, (1, 2)), T.circulant(10, (1, 2))
    fm = R.sample_rff(jax.random.PRNGKey(7), ds.dim, 20, SIGMA)
    cfg = dict(lam=LAM, num_iters=250)
    ref = R.DKLA(topo_r, fm, train, R.DKLAConfig(**cfg))
    port = T.DKLA(topo_t, port_fmap(fm), port_nodes(train),
                  T.DKLAConfig(**cfg), device=CPU)
    return ref, ref.solve(), port, port.solve(), test


def test_dkla_config_defaults_match():
    import dataclasses
    assert dataclasses.asdict(T.DKLAConfig()) == \
        dataclasses.asdict(R.DKLAConfig())


def test_dkla_theta_matches_every_node(dkla_pair):
    _, th_ref, _, th_port, _ = dkla_pair
    assert len(th_port) == len(th_ref) == 10
    for a, b in zip(th_port, th_ref):
        assert_close(a, b)


@pytest.mark.parametrize("node", [None, 0, 7])
def test_dkla_predict_matches(dkla_pair, node):
    ref, th_ref, port, th_port, test = dkla_pair
    x = test[3].x
    assert_close(port.predict(th_port, as_t(x), node=node),
                 ref.predict(th_ref, x, node=node))


def test_dkla_rho_doubling_happens_before_iteration_200():
    """ρ doubles at k = 200, before that iteration's update: 201
    iterations differ from 200 iterations continued at the old ρ."""
    ds, train, _ = cached_split("houses", 10, subsample=600, seed=0)
    fm = port_fmap(R.sample_rff(jax.random.PRNGKey(7), ds.dim, 20, SIGMA))
    topo = T.circulant(10, (1, 2))
    nodes = port_nodes(train)
    doubled = T.DKLA(topo, fm, nodes, T.DKLAConfig(), device=CPU).solve(201)
    never = T.DKLA(topo, fm, nodes, T.DKLAConfig(rho_doubling_every=0),
                   device=CPU)
    same_200 = T.DKLA(topo, fm, nodes, T.DKLAConfig(), device=CPU).solve(200)
    for a, b in zip(same_200, never.solve(200)):
        assert torch.equal(a, b)
    assert any(not torch.equal(a, b)
               for a, b in zip(doubled, never.solve(201)))


def test_dkla_ddrf_feature_map_matches_on_the_reference_pool():
    """The same node (the biggest, under the imbalanced split) and the
    same selected frequencies, from the reference's candidate pool."""
    ds = make_dataset("houses", subsample=600, seed=0)
    nodes = partition(ds, 10, mode="iid",
                      sizes=imbalanced_sizes(ds.num_samples, 10))
    train, _ = train_test_split_nodes(nodes)
    key, d_feat = jax.random.PRNGKey(5), 12
    ref = R.dkla_ddrf_feature_map(key, ds.dim, d_feat, SIGMA, train)
    k_cand, _ = jax.random.split(key)
    pool = port_fmap(R.sample_rff(k_cand, ds.dim, 20 * d_feat, SIGMA))
    nodes_t = port_nodes(train)
    port = T.dkla_ddrf_feature_map(None, ds.dim, d_feat, SIGMA, nodes_t,
                                   candidates=pool)
    last = T.dkla_ddrf_feature_map(None, ds.dim, d_feat, SIGMA, nodes_t,
                                   node=9, candidates=pool)
    np.testing.assert_array_equal(port.omega.numpy(), np.asarray(ref.omega))
    np.testing.assert_array_equal(port.bias.numpy(), np.asarray(ref.bias))
    assert torch.equal(port.omega, last.omega)


# -------------------------------------------------------------------- gram_fn
@pytest.fixture(scope="module")
def gram_problem():
    """`tests/test_kernels_rff.py`'s integration problem: houses 400,
    J 4 iid on circulant(4, (1,)), D 10 energy-selected from 50."""
    ds = make_dataset("houses", subsample=400, seed=0)
    train, _ = train_test_split_nodes(partition(ds, 4, mode="iid"))
    keys = jax.random.split(jax.random.PRNGKey(0), 4)
    fmaps = [R.select_features(keys[j], ds.dim, 10, 1.0, train[j].x,
                               train[j].y, method="energy",
                               candidate_ratio=5) for j in range(4)]
    n = sum(t.num_samples for t in train)
    return fmaps, train, n


def test_gram_fn_solver_matches_reference_gram_fn_solver(gram_problem):
    """The port's solver with `ops.gram_fn_for_solver` (the plain version
    on CPU tensors) against the reference's with its Pallas kernel in
    interpret mode: float32 Gram blocks, rtol 2e-4 / atol 2e-4."""
    fmaps, train, n = gram_problem
    cfg = dict(lam=1e-6, c_nei=0.02 * n)
    ref = R.DeKRRSolver(R.circulant(4, (1,)), fmaps, train,
                        R.DeKRRConfig(**cfg), gram_fn=RK.gram_fn_for_solver)
    port = T.DeKRRSolver(T.circulant(4, (1,)), [port_fmap(f) for f in fmaps],
                         port_nodes(train), T.DeKRRConfig(**cfg),
                         gram_fn=ops.gram_fn_for_solver, device=CPU)
    plain = T.DeKRRSolver(T.circulant(4, (1,)),
                          [port_fmap(f) for f in fmaps], port_nodes(train),
                          T.DeKRRConfig(**cfg), device=CPU)
    th_ref = ref.solve_exact().theta
    for got in (port.solve_exact().theta, plain.solve_exact().theta):
        for a, b in zip(got, th_ref):
            assert_close(a, b, rtol=2e-4, atol=2e-4)
    # the neighbour Gram blocks themselves, f32 against f32
    for j, p in ((0, 1), (2, 3)):
        assert_close(port._gram(j, p), ref._gram(j, p), rtol=1e-5,
                     atol=1e-5 * np.abs(np.asarray(ref._gram(j, p))).max())


def test_gram_fn_for_solver_casts_back_and_counts_no_launch_on_cpu(
        gram_problem):
    fmaps, train, _ = gram_problem
    fm, x = port_fmap(fmaps[0]), as_t(train[1].x)
    ops.reset_launch_counts()
    g = ops.gram_fn_for_solver(fm, x)
    assert g.dtype == torch.float64 and g.shape == (10, 10)
    assert ops.launch_counts()["rff_gram"] == 0
    want = np.asarray(RK.gram_fn_for_solver(fmaps[0], train[1].x))
    assert_close(g, want, rtol=1e-5, atol=1e-5 * np.abs(want).max())


def test_gram_fn_rejects_bagged_nodes(gram_problem):
    fmaps, train, n = gram_problem
    nodes = port_nodes(train)
    nodes[1] = T.NodeData(x=nodes[1].x, y=nodes[1].y[:2],
                          bags=torch.arange(nodes[1].num_samples) % 2)
    with pytest.raises(ValueError, match="gram_fn bypasses featurization"):
        T.DeKRRSolver(T.circulant(4, (1,)), [port_fmap(f) for f in fmaps],
                      nodes, T.DeKRRConfig(c_nei=0.02 * n),
                      gram_fn=ops.gram_fn_for_solver, device=CPU)


def test_gram_fn_for_solver_refuses_cos_sin():
    rng = np.random.default_rng(0)
    fm = interop.feature_map_from_arrays(rng.normal(size=(6, 3)), None,
                                         "cos_sin", device=CPU)
    with pytest.raises(NotImplementedError, match="cos_bias"):
        ops.gram_fn_for_solver(fm, torch.as_tensor(rng.uniform(size=(3, 9))))


# ------------------------------------------- pack_problem with a gram_fn solver
def _gram_fn_solver():
    """`tests/test_dist_property.py`'s solver the batched build cannot
    honor (a custom gram_fn), carried across."""
    from conftest import cached_fmaps
    _, train, _ = cached_split("air_quality", 4, subsample=300, seed=0)
    fmaps = cached_fmaps("air_quality", 4, (8, 10, 8, 10), subsample=300,
                         seed=0)
    n = sum(t.num_samples for t in train)
    gram_fn = lambda fm, x: (lambda z: z @ z.T)(fm(x))
    return T.DeKRRSolver(T.circulant(4, (1,)), [port_fmap(f) for f in fmaps],
                         port_nodes(train), T.DeKRRConfig(lam=1e-6,
                                                          c_nei=0.02 * n),
                         gram_fn=gram_fn, device=CPU)


def test_pack_problem_warns_on_gram_fn_downgrade():
    with pytest.warns(UserWarning, match="downgraded to method='aux'"):
        packed = pack_problem(_gram_fn_solver(), device=CPU)
    assert packed.node_dims == (8, 10, 8, 10)


def test_pack_problem_aux_with_gram_fn_explicitly_does_not_warn():
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        pack_problem(_gram_fn_solver(), method="aux", device=CPU)
    assert not [c for c in caught if "downgraded" in str(c.message)]


def test_pack_problem_raises_when_cuda_gram_would_be_ignored():
    solver = _gram_fn_solver()
    with pytest.raises(ValueError, match="gram_fn"):
        pack_problem(solver, gram_backend="cuda", device=CPU)
    with pytest.raises(ValueError, match="ignores gram_backend"):
        pack_problem(solver, method="aux", gram_backend="cuda", device=CPU)
