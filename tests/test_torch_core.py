"""The port's core (graphs, features, DDRF, data, the ragged solver) held
against the JAX reference on the same numpy inputs, float64, at rtol 1e-9
and atol 1e-12·max|ref|."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core as R
import repro.data.synthetic as RD
import repro_torch.core as T
import repro_torch.data.synthetic as TD
from conftest import cached_fmaps, cached_split
from repro_torch import interop

CPU = "cpu"


def assert_close(got, want, rtol=1e-9):
    got = got.detach().cpu().numpy() if isinstance(got, torch.Tensor) \
        else np.asarray(got)
    want = np.asarray(want)
    scale = np.abs(want).max() if want.size else 0.0
    np.testing.assert_allclose(got, want, rtol=rtol, atol=1e-12 * scale)


def port_fmaps(fmaps):
    return [interop.feature_map_from_arrays(
        np.asarray(f.omega), None if f.bias is None else np.asarray(f.bias),
        f.kind, device=CPU) for f in fmaps]


def port_nodes(nodes):
    return [interop.node_data_from_arrays(
        np.asarray(n.x), np.asarray(n.y),
        None if n.bags is None else np.asarray(n.bags), device=CPU)
        for n in nodes]


# ------------------------------------------------------------------ graphs
GRAPHS = {
    "circulant": lambda m: m.circulant(10, (1, 2)),
    "ring": lambda m: m.ring(6),
    "complete": lambda m: m.complete(5),
    "star": lambda m: m.star(6),
    "erdos_renyi": lambda m: m.erdos_renyi(8, 0.4, seed=3),
}


@pytest.mark.parametrize("name", sorted(GRAPHS))
def test_graph_tables_match(name):
    ref, port = GRAPHS[name](R), GRAPHS[name](T)
    np.testing.assert_array_equal(port.adjacency, ref.adjacency)
    assert port.circulant_offsets == ref.circulant_offsets
    for a, b in zip(port.neighbor_table(), ref.neighbor_table()):
        np.testing.assert_array_equal(a, b)
    assert port.edges == ref.edges
    np.testing.assert_array_equal(port.degrees, ref.degrees)


def test_graph_rejects_disconnected():
    adj = np.zeros((3, 3), dtype=bool)
    adj[0, 1] = adj[1, 0] = True
    with pytest.raises(ValueError, match="connected"):
        T.Topology(adjacency=adj)


# ---------------------------------------------------------------- features
@pytest.mark.parametrize("kind", ["cos_bias", "cos_sin"])
def test_featurize_matches(kind):
    rng = np.random.default_rng(0)
    omega = rng.normal(size=(24, 13))
    bias = rng.uniform(0, 2 * np.pi, 24) if kind == "cos_bias" else None
    x = rng.uniform(size=(13, 70))
    ref = R.featurize(R.FeatureMap(jnp.asarray(omega),
                                   None if bias is None else jnp.asarray(bias),
                                   kind), jnp.asarray(x))
    fm = interop.feature_map_from_arrays(omega, bias, kind, device=CPU)
    assert_close(T.featurize(fm, torch.as_tensor(x)), ref)
    assert fm.num_features == (48 if kind == "cos_sin" else 24)


def test_gaussian_kernel_and_metrics_match():
    rng = np.random.default_rng(1)
    x, x2 = rng.uniform(size=(5, 30)), rng.uniform(size=(5, 20))
    assert_close(T.gaussian_kernel(torch.as_tensor(x), torch.as_tensor(x2),
                                   0.7),
                 R.gaussian_kernel(jnp.asarray(x), jnp.asarray(x2), 0.7))
    pred, y = rng.normal(size=50), rng.normal(size=50)
    tp, ty = torch.as_tensor(pred), torch.as_tensor(y)
    assert T.rse(tp, ty) == pytest.approx(R.rse(pred, y), rel=1e-12)
    assert T.mse(tp, ty) == pytest.approx(R.mse(pred, y), rel=1e-12)


def test_sample_rff_uses_the_generator():
    gen = torch.Generator().manual_seed(5)
    a = T.sample_rff(gen, 7, 40, 2.0)
    b = T.sample_rff(torch.Generator().manual_seed(5), 7, 40, 2.0)
    assert torch.equal(a.omega, b.omega) and torch.equal(a.bias, b.bias)
    assert a.omega.shape == (40, 7) and a.omega.dtype == torch.float64
    assert float(a.bias.min()) >= 0 and float(a.bias.max()) < 2 * np.pi
    assert T.sample_rff(gen, 7, 40, 2.0, kind="cos_sin").bias is None


# --------------------------------------------------------------------- data
@pytest.mark.parametrize("mode", ["iid", "noniid_y", "noniid_xnorm"])
def test_dataset_partition_split_equal(mode):
    ref_ds = RD.make_dataset("energy", subsample=400, seed=2)
    ds = TD.make_dataset("energy", subsample=400, seed=2)
    np.testing.assert_array_equal(ds.x, ref_ds.x)
    np.testing.assert_array_equal(ds.y, ref_ds.y)
    ref_nodes = RD.partition(ref_ds, 5, mode=mode, seed=4)
    nodes = TD.partition(ds, 5, mode=mode, seed=4, device=CPU)
    ref_tr, ref_te = RD.train_test_split_nodes(ref_nodes, seed=4)
    tr, te = TD.train_test_split_nodes(nodes, seed=4)
    for got, want in zip(nodes + tr + te, ref_nodes + ref_tr + ref_te):
        np.testing.assert_array_equal(got.x.numpy(), np.asarray(want.x))
        np.testing.assert_array_equal(got.y.numpy(), np.asarray(want.y))
    pooled, ref_pooled = TD.pooled(tr), RD.pooled(ref_tr)
    np.testing.assert_array_equal(pooled.x.numpy(), np.asarray(ref_pooled.x))


def test_partition_defaults_to_the_card():
    ds = TD.make_dataset("houses", subsample=50)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        TD.partition(ds, 2)


# --------------------------------------------------------------------- DDRF
@pytest.mark.parametrize("kind", ["cos_bias", "cos_sin"])
@pytest.mark.parametrize("method", ["energy", "leverage"])
def test_select_features_on_reference_pool(kind, method):
    _, train, _ = cached_split("air_quality", 4, subsample=400)
    nd = train[1]
    key = jax.random.PRNGKey(11)
    ref = R.select_features(key, 13, 10, 1.0, nd.x, nd.y, method=method,
                            candidate_ratio=5, kind=kind)
    # the reference draws its pool from the first half of the split key
    pool = R.sample_rff(jax.random.split(key)[0], 13, 50, 1.0, kind=kind)
    got = T.select_features(
        None, 13, 10, 1.0, torch.as_tensor(np.array(nd.x)),
        torch.as_tensor(np.array(nd.y)), method=method, kind=kind,
        candidates=port_fmaps([pool])[0])
    np.testing.assert_array_equal(got.omega.numpy(), np.asarray(ref.omega))
    if kind == "cos_bias":
        np.testing.assert_array_equal(got.bias.numpy(), np.asarray(ref.bias))


def test_scores_match_including_multi_output():
    _, train, _ = cached_split("air_quality", 4, subsample=400)
    nd = train[0]
    pool = R.sample_rff(jax.random.PRNGKey(3), 13, 30, 1.0)
    fm = port_fmaps([pool])[0]
    x = torch.as_tensor(np.array(nd.x))
    y = np.array(nd.y)
    y3 = np.stack([y, y**2, -y], axis=1)
    assert_close(T.energy_scores(fm, x, torch.as_tensor(y)),
                 R.energy_scores(pool, nd.x, nd.y))
    assert_close(T.energy_scores(fm, x, torch.as_tensor(y3)),
                 R.energy_scores(pool, nd.x, jnp.asarray(y3)))
    assert_close(T.leverage_scores(fm, x, lam=1e-4),
                 R.leverage_scores(pool, nd.x, lam=1e-4))


# ------------------------------------------------------------------- solver
def _solvers(topo_name, dims, *, dy=1, bags=False, tol=0.0, num_iters=60):
    j = len(dims)
    _, train, test = cached_split("air_quality", j, subsample=300)
    fmaps = cached_fmaps("air_quality", j, tuple(dims), subsample=300)
    if dy > 1:
        train = [R.NodeData(x=n.x, y=jnp.stack(
            [n.y * (o + 1) + o for o in range(dy)], axis=1)) for n in train]
    if bags:
        train = [R.NodeData(x=n.x, y=n.y[: (n.num_samples + 1) // 2],
                            bags=jnp.arange(n.num_samples) // 2)
                 for n in train]
    n = sum(nd.num_samples for nd in train)
    cfg = dict(lam=1e-4, c_nei=0.05 * n, tol=tol, num_iters=num_iters)
    topo = {"circulant": "circulant(j, (1, 2))", "star": "star(j)"}[topo_name]
    ref = R.DeKRRSolver(eval("R." + topo), fmaps, train, R.DeKRRConfig(**cfg))
    port = T.DeKRRSolver(eval("T." + topo), port_fmaps(fmaps),
                         port_nodes(train), T.DeKRRConfig(**cfg), device=CPU)
    return ref, port, test


@pytest.mark.parametrize("topo", ["circulant", "star"])
@pytest.mark.parametrize("dy", [1, 3])
def test_solver_aux_step_solve_predict(topo, dy):
    ref, port, test = _solvers(topo, [8, 10, 12, 8, 10, 12], dy=dy)
    for j in range(ref.J):
        for f in ("g", "d", "s"):
            assert_close(getattr(port.aux, f)[j], getattr(ref.aux, f)[j])
        assert sorted(port.aux.p[j]) == sorted(ref.aux.p[j])
        for nb in ref.aux.p[j]:
            assert_close(port.aux.p[j][nb], ref.aux.p[j][nb])
    st, rst = port.step(port.init_state()), ref.step(ref.init_state())
    for a, b in zip(st.theta, rst.theta):
        assert_close(a, b)
    st, rst = port.solve(num_iters=25), ref.solve(num_iters=25)
    for a, b in zip(st.theta, rst.theta):
        assert_close(a, b)
    ex, rex = port.solve_exact(), ref.solve_exact()
    for a, b in zip(ex.theta, rex.theta):
        assert_close(a, b, rtol=1e-8)
    x = test[2].x
    assert_close(port.predict(st.theta, torch.as_tensor(np.array(x)),
                              node=2),
                 ref.predict(rst.theta, x, node=2))
    assert_close(port.predict(st.theta, torch.as_tensor(np.array(x))),
                 ref.predict(rst.theta, x))
    assert_close(port.objective(st.theta), ref.objective(rst.theta))


def test_solver_tol_stop_and_diagnostics():
    ref, port, test = _solvers("circulant", [8, 10, 12, 8, 10, 12],
                               tol=1e-6, num_iters=2000)
    st, rst = port.solve(), ref.solve()
    assert st.iteration == rst.iteration < 2000
    for a, b in zip(st.theta, rst.theta):
        assert_close(a, b)
    assert port.spectral_radius() == pytest.approx(ref.spectral_radius(),
                                                   rel=1e-9)
    assert_close(T.prop1_required_c_self(port),
                 R.prop1_required_c_self(ref))
    ys = [nd.y for nd in test]
    pred = torch.cat([port.predict(st.theta, torch.as_tensor(np.array(
        nd.x)), node=j) for j, nd in enumerate(test)])
    rpred = jnp.concatenate([ref.predict(rst.theta, nd.x, node=j)
                             for j, nd in enumerate(test)])
    assert T.rse(pred, torch.as_tensor(np.array(jnp.concatenate(ys)))) \
        == pytest.approx(R.rse(rpred, jnp.concatenate(ys)), rel=1e-9)


def test_bagged_solver_aux_matches():
    ref, port, _ = _solvers("star", [8, 10, 12, 8], bags=True)
    for j in range(ref.J):
        assert_close(port.aux.g[j], ref.aux.g[j])
        assert_close(port.aux.d[j], ref.aux.d[j])


def test_solver_defaults_to_the_card():
    _, train, _ = cached_split("air_quality", 4, subsample=300)
    fmaps = cached_fmaps("air_quality", 4, (8, 8, 8, 8), subsample=300)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        T.DeKRRSolver(T.circulant(4, (1,)), port_fmaps(fmaps),
                      port_nodes(train))
