"""The port's examples (`repro_torch.examples`) against the reference's
`examples/quickstart.py` and `examples/decentralized_readout.py`, each
replayed here with the JAX package on its own draws: the quickstart's
four numbers given the reference's DDRF and DKLA maps, and the readout's
pooled features given the reference's weights and tokens, and its RSEs
given the reference's features, w_true, noise and DDRF maps."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core as R
from repro.configs import get_arch as ref_get_arch
from repro.core.rff import featurize as ref_featurize
from repro.data.synthetic import (make_dataset, partition,
                                  train_test_split_nodes)
from repro.models.model import Model as RefModel
from repro_torch import interop
from repro_torch.configs import get_arch
from repro_torch.examples import decentralized_readout, quickstart
from repro_torch.models.model import Model

CPU = "cpu"
RTOL = 1e-9                       # float64 on both sides
FEATURE_RTOL = 1e-5               # f32 backbone logits, of max|ref|
NUM_SEQS, SEQ = 320, 16           # the readout cut from 600 × 32


def port_fmap(f):
    return interop.feature_map_from_arrays(
        np.asarray(f.omega), np.asarray(f.bias), f.kind, device=CPU)


# --------------------------------------------------------------------------
# quickstart
# --------------------------------------------------------------------------
def ref_quickstart():
    """`examples/quickstart.py`'s numbers and its maps."""
    ds = make_dataset("houses", subsample=quickstart.SUBSAMPLE, seed=0)
    topo = R.circulant(10, (1, 2))
    train, test = train_test_split_nodes(partition(ds, 10, mode="noniid_y"))
    n = sum(t.num_samples for t in train)
    keys = jax.random.split(jax.random.PRNGKey(0), 10)
    fmaps = [R.select_features(keys[j], ds.dim, 30, 1.0, train[j].x,
                               train[j].y, method="energy",
                               candidate_ratio=20) for j in range(10)]
    solver = R.DeKRRSolver(topo, fmaps, train,
                           R.DeKRRConfig(lam=1e-6, c_nei=0.005 * n,
                                         num_iters=400))
    state, limit = solver.solve(), solver.solve_exact()
    ys = jnp.concatenate([t.y for t in test])

    def net_rse(predict, theta):
        return float(R.rse(jnp.concatenate(
            [predict(theta, test[j].x, node=j) for j in range(10)]), ys))

    fmap = R.sample_rff(jax.random.PRNGKey(50), ds.dim, 30, 1.0)
    dkla = R.DKLA(topo, fmap, train, R.DKLAConfig(lam=1e-6, num_iters=400))
    return ({"rse": net_rse(solver.predict, state.theta),
             "limit_rse": net_rse(solver.predict, limit.theta),
             "rho": float(solver.spectral_radius()),
             "dkla_rse": net_rse(dkla.predict, dkla.solve())},
            fmaps, fmap)


def test_quickstart_equals_the_reference_on_its_maps():
    want, fmaps, dkla_fmap = ref_quickstart()
    got = quickstart.run(CPU, fmaps=[port_fmap(f) for f in fmaps],
                         dkla_fmap=port_fmap(dkla_fmap))
    assert set(got) == set(want)
    for key, value in want.items():
        np.testing.assert_allclose(got[key], value, rtol=RTOL, err_msg=key)


def test_quickstart_prints_the_reference_lines(capsys):
    assert quickstart.main(["--device", CPU]) == 0
    lines = capsys.readouterr().out.splitlines()
    assert lines[0] == "dataset d=8 N=2000, J=10, |N_j|=4"
    assert lines[1].startswith("DeKRR-DDRF   RSE = ")
    assert "spectral radius" in lines[1]
    assert lines[2].startswith("DKLA (RFF)   RSE = ")


# --------------------------------------------------------------------------
# decentralized readout
# --------------------------------------------------------------------------
@pytest.fixture(scope="module")
def ref_readout():
    """`examples/decentralized_readout.py` at NUM_SEQS × SEQ: its
    parameters, tokens, pooled features, draws, maps and RSEs."""
    cfg = ref_get_arch("smollm_135m").config.reduced()
    model = RefModel(cfg)
    params = model.init(jax.random.PRNGKey(0))
    toks = jax.random.randint(jax.random.PRNGKey(1), (NUM_SEQS, SEQ), 0,
                              cfg.vocab_size)
    forward = jax.jit(lambda tb: model.forward(params, tokens=tb)[0]
                      .mean(axis=1))
    feats = jnp.concatenate([forward(toks[i:i + 64])
                             for i in range(0, NUM_SEQS, 64)])
    feats = feats[:, :64].astype(jnp.float64)
    w_true = jax.random.normal(jax.random.PRNGKey(2), (64,), jnp.float64)
    noise = jax.random.normal(jax.random.PRNGKey(3), (NUM_SEQS,),
                              jnp.float64)
    y = jnp.tanh(feats @ w_true) + 0.05 * noise
    order = jnp.argsort(-jnp.abs(y))
    x_all, y_all = feats[order].T, y[order]
    per = NUM_SEQS // 10
    train, test = [], []
    for j in range(10):
        cut = slice(j * per, (j + 1) * per)
        xj, yj = x_all[:, cut], y_all[cut]
        h = per // 2
        train.append(R.NodeData(x=xj[:, :h], y=yj[:h]))
        test.append(R.NodeData(x=xj[:, h:], y=yj[h:]))
    keys = jax.random.split(jax.random.PRNGKey(4), 10)
    fmaps = [R.select_features(keys[j], 64, 16, 2.0, train[j].x, train[j].y,
                               method="energy", candidate_ratio=10)
             for j in range(10)]
    ntr = sum(t.num_samples for t in train)
    solver = R.DeKRRSolver(R.circulant(10, (1, 2)), fmaps, train,
                           R.DeKRRConfig(lam=1e-6, c_nei=0.01 * ntr))
    st = solver.solve_exact()
    ys = jnp.concatenate([t.y for t in test])
    pred = jnp.concatenate([solver.predict(st.theta, test[j].x, node=j)
                            for j in range(10)])
    z = ref_featurize(fmaps[9], train[9].x)
    th = jnp.linalg.solve(z @ z.T + 1e-6 * z.shape[1] * jnp.eye(z.shape[0]),
                          z @ train[9].y)
    pooled_x = jnp.concatenate([t.x for t in test], axis=1)
    return dict(
        params=jax.tree.map(np.asarray, params), tokens=np.array(toks),
        feats=np.array(feats), w_true=np.array(w_true),
        noise=np.array(noise), fmaps=fmaps,
        rses={"rse": float(R.rse(pred, ys)),
              "local_rse": float(R.rse(th @ ref_featurize(fmaps[9],
                                                          pooled_x), ys)),
              "consensus_rse": float(R.rse(solver.predict(
                  st.theta, pooled_x, node=9), ys))})


def test_readout_pooled_features_equal_the_reference(ref_readout):
    cfg = get_arch("smollm_135m").config.reduced()
    params = interop.lm_params_from_arrays(cfg, ref_readout["params"],
                                           device=CPU)
    got = decentralized_readout.pooled_features(
        Model(cfg, params), torch.as_tensor(ref_readout["tokens"]))
    want = ref_readout["feats"]
    assert got.dtype == torch.float64 and got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=0,
                               atol=FEATURE_RTOL * np.abs(want).max())


def test_readout_rses_equal_the_reference_on_its_features(ref_readout):
    got = decentralized_readout.readout(
        torch.as_tensor(ref_readout["feats"]),
        torch.as_tensor(ref_readout["w_true"]),
        torch.as_tensor(ref_readout["noise"]),
        fmaps=[port_fmap(f) for f in ref_readout["fmaps"]])
    assert set(got) == set(ref_readout["rses"])
    for key, value in ref_readout["rses"].items():
        np.testing.assert_allclose(got[key], value, rtol=RTOL, err_msg=key)


def test_readout_runs_end_to_end_on_the_ports_draws(capsys):
    out = decentralized_readout.run(num_seqs=NUM_SEQS, seq=SEQ, device=CPU,
                                    verbose=True)
    assert out["feats"].shape == (NUM_SEQS, 64)
    assert all(np.isfinite(out[k]) for k in
               ("rse", "local_rse", "consensus_rse"))
    text = capsys.readouterr().out
    assert "backbone=smollm-135m  DeKRR-DDRF readout RSE = " in text
    assert "starved node on pooled test: local-only " in text
