"""The port's paper protocol (`repro_torch.paper`) held against the JAX
package's own harness, `benchmarks/common.py`, at a small size: the same
splits, the same runners on the reference's draws, the same RSEs at rtol
1e-9 (float64) and the same c chosen; the configurations as data; the
headline claim; and each experiment's rows from the command line and in
process on the CPU."""
import dataclasses
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

import repro.configs.paper_dekrr as RC
import repro.core as R
import repro_torch.configs.paper_dekrr as TC
import repro_torch.core as T
from conftest import REPO_ROOT, cached_fmaps, cached_split, subprocess_env
from repro_torch import interop
from repro_torch.paper import common as C
from repro_torch.paper.__main__ import EXPERIMENTS
from repro_torch.paper.fig3_imbalanced import sqrt_proportional_d

CPU = "cpu"
SUB, D_FEAT = 600, 10


def port_fmap(f):
    return interop.feature_map_from_arrays(
        np.asarray(f.omega), None if f.bias is None else np.asarray(f.bias),
        f.kind, device=CPU)


def port_nodes(nodes):
    return [interop.node_data_from_arrays(np.asarray(n.x), np.asarray(n.y),
                                          device=CPU) for n in nodes]


@pytest.fixture(scope="module")
def bench():
    """`benchmarks/common.py` imported from the repository root, its
    SUBSAMPLE set to this file's size for the module's tests."""
    mp = pytest.MonkeyPatch()
    mp.syspath_prepend(REPO_ROOT)
    import benchmarks.common as BC
    mp.setattr(BC, "SUBSAMPLE", SUB)
    yield BC
    mp.undo()


@pytest.fixture(scope="module")
def houses(bench):
    return bench.load_split("houses", mode="noniid_y"), \
        C.load_split("houses", mode="noniid_y", subsample=SUB, device=CPU)


def _np(t):
    return t.detach().cpu().numpy() if isinstance(t, torch.Tensor) \
        else np.asarray(t)


def test_load_split_and_val_split_equal_the_reference(bench, houses):
    (ds_r, tr_r, te_r), (ds_t, tr_t, te_t) = houses
    np.testing.assert_array_equal(ds_t.x, np.asarray(ds_r.x))
    for a, b in zip(tr_t + te_t, tr_r + te_r):
        np.testing.assert_array_equal(_np(a.x), _np(b.x))
        np.testing.assert_array_equal(_np(a.y), _np(b.y))
    for a, b in zip(C._val_split(tr_t, seed=2), bench._val_split(tr_r,
                                                                 seed=2)):
        for na, nb in zip(a, b):
            np.testing.assert_array_equal(_np(na.x), _np(nb.x))
            np.testing.assert_array_equal(_np(na.y), _np(nb.y))


def test_protocol_constants_equal_the_reference(bench):
    assert (C.J, C.SIGMA, C.LAM, C.C_GRID, C.SEEDS, C.PAPER_DBAR) == \
        (bench.J, bench.SIGMA, bench.LAM, bench.C_GRID, bench.SEEDS,
         bench.PAPER_DBAR)
    assert C.SUBSAMPLE == 3000
    np.testing.assert_array_equal(C.TOPOLOGY.adjacency,
                                  bench.TOPOLOGY.adjacency)


def _chosen_c(bench, monkeypatch):
    """Record the c_nei/N of every solver the reference runner builds;
    its last one is built with the chosen c."""
    seen = []

    class Recording(bench.DeKRRSolver):
        def __init__(self, topo, fmaps, data, config, **kw):
            seen.append(config.c_nei / sum(d.num_samples for d in data))
            super().__init__(topo, fmaps, data, config, **kw)

    monkeypatch.setattr(bench, "DeKRRSolver", Recording)
    return seen


@pytest.mark.parametrize("seed", [0, 1])
def test_run_dekrr_ddrf_matches_on_the_reference_draws(bench, houses,
                                                       monkeypatch, seed):
    (ds_r, tr_r, te_r), (ds_t, tr_t, te_t) = houses
    seen = _chosen_c(bench, monkeypatch)
    want, _ = bench.run_dekrr_ddrf(ds_r, tr_r, te_r, D_FEAT, seed=seed)
    keys = jax.random.split(jax.random.PRNGKey(seed), C.J)
    pools = [port_fmap(R.sample_rff(jax.random.split(k)[0], ds_r.dim,
                                    20 * D_FEAT, C.SIGMA)) for k in keys]
    got = C.run_dekrr_ddrf(ds_t, tr_t, te_t, D_FEAT, seed=seed,
                           candidates=pools)
    np.testing.assert_allclose(got.rse, float(want), rtol=1e-9)
    assert got.c == pytest.approx(seen[-1], rel=1e-12)


@pytest.mark.parametrize("ddrf", [False, True])
def test_run_dkla_matches_on_the_reference_draws(bench, houses, ddrf):
    (ds_r, tr_r, te_r), (ds_t, tr_t, te_t) = houses
    seed = 50
    want, _ = bench.run_dkla(ds_r, tr_r, te_r, D_FEAT, ddrf=ddrf, seed=seed)
    key = jax.random.PRNGKey(seed)
    if ddrf:
        pool = port_fmap(R.sample_rff(jax.random.split(key)[0], ds_r.dim,
                                      20 * D_FEAT, C.SIGMA))
        got = C.run_dkla(ds_t, tr_t, te_t, D_FEAT, ddrf=True, seed=seed,
                         candidates=pool)
    else:
        fm = port_fmap(R.sample_rff(key, ds_r.dim, D_FEAT, C.SIGMA))
        got = C.run_dkla(ds_t, tr_t, te_t, D_FEAT, seed=seed, fmap=fm)
    np.testing.assert_allclose(got.rse, float(want), rtol=1e-9)
    assert got.c is None


def test_run_dekrr_ddrf_plain_takes_the_maps_as_drawn(houses):
    (ds_r, _, _), (ds_t, tr_t, te_t) = houses
    keys = jax.random.split(jax.random.PRNGKey(0), C.J)
    maps = [port_fmap(R.sample_rff(k, ds_r.dim, 6, C.SIGMA)) for k in keys]
    got = C.run_dekrr_ddrf(ds_t, tr_t, te_t, 6, method="plain",
                           candidates=maps, c_grid=(0.01,))
    solver = T.DeKRRSolver(C.TOPOLOGY, maps, tr_t,
                           T.DeKRRConfig(lam=C.LAM, c_nei=0.01 * sum(
                               t.num_samples for t in tr_t)), device=CPU)
    st = solver.solve_exact()
    want = C._network_rse(
        lambda j, x: solver.predict(st.theta, x, node=j), te_t)
    assert got.rse == want and got.c == 0.01


def test_sqrt_proportional_d_matches_the_reference(monkeypatch):
    monkeypatch.syspath_prepend(REPO_ROOT)
    from benchmarks.paper_fig3_imbalanced import sqrt_proportional_d as ref
    _, train_t, _ = C.load_imbalanced("twitter", subsample=SUB, device=CPU)
    nodes = [R.NodeData(x=np.asarray(n.x), y=np.asarray(n.y))
             for n in train_t]
    for dbar in (40, 100):
        assert sqrt_proportional_d(train_t, dbar) == ref(nodes, dbar)


def test_paper_experiments_equal_the_reference():
    assert [dataclasses.asdict(e) for e in TC.PAPER_EXPERIMENTS] == \
        [dataclasses.asdict(e) for e in RC.PAPER_EXPERIMENTS]
    for name in ("CV_LAMBDA", "CV_SIGMA", "CV_C_NEI_PAPER",
                 "CV_C_NEI_EXTENDED", "C_SELF_RATIO", "D0_OVER_D",
                 "DKLA_RHO"):
        assert getattr(TC, name) == getattr(RC, name), name


def test_dekrr_ddrf_beats_dkla_noniid_through_the_port():
    """`tests/test_dekrr.py::test_dekrr_ddrf_beats_dkla_noniid` through the
    port, on the reference's split and draws."""
    ds, train, test = cached_split("houses", 10, subsample=2000, seed=0)
    train, test = port_nodes(train), port_nodes(test)
    topo = T.circulant(10, (1, 2))
    n = sum(t.num_samples for t in train)
    D = 20
    ys = torch.cat([t.y for t in test])
    fmaps = [port_fmap(f) for f in cached_fmaps(
        "houses", 10, (D,) * 10, sigma=1.0, method="energy",
        candidate_ratio=20, subsample=2000, seed=0)]
    rse_ours = np.inf
    for c in (0.002, 0.01, 0.05):
        solver = T.DeKRRSolver(topo, fmaps, train,
                               T.DeKRRConfig(lam=1e-6, c_nei=c * n),
                               device=CPU)
        st = solver.solve_exact()
        pred = torch.cat([solver.predict(st.theta, test[j].x, node=j)
                          for j in range(10)])
        rse_ours = min(rse_ours, T.rse(pred, ys))
    rs = []
    for s in range(3):
        fm = port_fmap(R.sample_rff(jax.random.PRNGKey(50 + s), ds.dim, D,
                                    1.0))
        dkla = T.DKLA(topo, fm, train, T.DKLAConfig(lam=1e-6, num_iters=400),
                      device=CPU)
        th = dkla.solve()
        pred = torch.cat([dkla.predict(th, test[j].x, node=j)
                          for j in range(10)])
        rs.append(T.rse(pred, ys))
    assert rse_ours < np.mean(rs)


def _rows(text):
    rows = {}
    for line in text.strip().splitlines():
        name, us, derived = line.split(",", 2)
        float(us)
        rows[name] = dict(kv.split("=", 1) for kv in derived.split(";"))
    return rows


def test_cli_table2_rows_parse():
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.paper", "table2", "--fast",
         "--subsample", "300", "--device", "cpu"],
        cwd=REPO_ROOT, env=subprocess_env(), capture_output=True, text=True,
        timeout=300)
    assert out.returncode == 0, out.stderr
    rows = _rows(out.stdout)
    assert set(rows) == {"table2/houses", "table2/air_quality",
                         "table2/mean_improvement"}
    for name in ("table2/houses", "table2/air_quality"):
        assert {"D", "DKLA", "DKLA-DDRF", "ours", "improvement"} <= \
            set(rows[name])
        assert all(np.isfinite(float(rows[name][k]))
                   for k in ("DKLA", "DKLA-DDRF", "ours"))
    assert rows["table2/mean_improvement"]["paper_claims"] == "25.5%"


def test_cli_without_a_card_refuses_the_default_device():
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.paper", "table2", "--fast"],
        cwd=REPO_ROOT, env=subprocess_env(CUDA_VISIBLE_DEVICES=""),
        capture_output=True, text=True, timeout=300)
    assert out.returncode != 0 and "device=" in out.stderr
    assert out.stdout == ""


@pytest.mark.parametrize("name", sorted(set(EXPERIMENTS) - {"table2"}))
def test_experiment_prints_finite_rows(name, capsys):
    EXPERIMENTS[name](fast=True, subsample=300, device=torch.device(CPU))
    rows = _rows(capsys.readouterr().out)
    assert rows and all(n.split("/")[0] in (name, "ablation", "comm")
                        for n in rows)
    for fields in rows.values():
        for key, val in fields.items():
            if key.endswith("RSE") or key in ("DKLA", "ours"):
                assert np.isfinite(float(val)), (key, val)


def test_importing_the_paper_package_loads_no_jax():
    code = ("import repro_torch.paper.__main__, repro_torch.core.baselines, "
            "repro_torch.configs.paper_dekrr; import sys; bad = [m for m in "
            "sys.modules if m == 'jax' or m.startswith(('jax.', 'repro.'))]; "
            "assert not bad, bad")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO_ROOT,
                         env=subprocess_env(), capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr
