"""The batched featurize kernel's plain versions and wrappers
(`repro_torch.kernels.rff_features`, `ops.rff_features_batched`,
`ops.rff_features_lowp_batched`) and the serving tier's one-launch wave,
held against the JAX package on the CPU.

The reference featurizes one node per call (`repro.kernels.ops`'s
`rff_features` / `rff_features_lowp`, run here in interpret mode), so
every node of a batch is held against its own call. Tolerances:

  * f64: rtol 1e-9, atol 1e-12·max|ref| (the sums run in another order);
  * bf16: the batched plain version bit-equal to the per-node one, every
    entry within the forward-error model bound s·((3u + γ_d)(|Ω||x| +
    |b|) + 3u), u = 2⁻⁸, of the float64 value, and at least 99% of the
    entries bit-equal to the JAX wrapper's (the f32 sums run in another
    order);
  * padded rows (r ≥ D_j) exactly zero;
  * answers of a ragged mixed-kind snapshot: rtol 1e-9 at full
    precision; at bf16/int8 each side within its own attached bound and
    the port's answers and bounds within rtol 1e-5 of the reference's.

On CPU tensors the wrappers run the plain versions and launch nothing
(checked after every test).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.rff import sample_rff as ref_sample_rff
from repro.kernels import ops as rops
from repro.serve import DeKRRServeEngine as RefEngine
from repro.serve import KernelQuery as RefQuery
from repro.stream import ServeSnapshot as RefSnapshot
from repro.stream import StalenessBound as RefStaleness
from repro_torch import interop
from repro_torch.kernels import ops
from repro_torch.kernels.rff_features import (
    rff_features_batched_reference, rff_features_bf16_batched_reference,
    rff_features_bf16_reference, rff_features_lowp_reference,
    rff_features_reference)
from repro_torch.serve import DeKRRServeEngine, KernelQuery
from test_torch_gpu import assert_close

U_BF16 = 2.0 ** -8
# (D_j per node, d, N): ragged nodes of the phase case, and two nodes of
# the serving width at a small column bucket
BATCHES = [((37, 200, 64), 21, 40), ((200, 200), 148, 16)]


@pytest.fixture(autouse=True)
def _no_launches_on_cpu():
    ops.reset_launch_counts()
    yield
    assert ops.launch_counts() == {k: 0 for k in ops.LAUNCHES}, \
        "a wrapper counted a launch for a CPU tensor"


def batch_case(d_feats, dim, n, seed):
    """Per-node Ω_j ~ N(0, 1) [D_j, d], b_j ~ U[0, 2π) and X ~ N(0, 1)
    [d, N], and the packed [J, D_max, d] / [J, D_max] operands with NaN
    in the padded Ω rows (the kernel's contract ignores them)."""
    rng = np.random.default_rng(seed)
    omegas = [rng.normal(size=(dj, dim)) for dj in d_feats]
    biases = [rng.uniform(0, 2 * np.pi, dj) for dj in d_feats]
    x = rng.normal(size=(dim, n))
    d_max = max(d_feats)
    omega = np.full((len(d_feats), d_max, dim), np.nan)
    bias = np.zeros((len(d_feats), d_max))
    for j, (om, b) in enumerate(zip(omegas, biases)):
        omega[j, :om.shape[0]] = om
        bias[j, :b.shape[0]] = b
    return omegas, biases, x, omega, bias


def _model_bound(omega, bias, x, scale):
    nu = min(omega.shape[1] * U_BF16, 0.5)
    mag = np.abs(omega) @ np.abs(x) + np.abs(bias)[:, None]
    return scale * ((3 * U_BF16 + nu / (1 - nu)) * mag + 3 * U_BF16)


@pytest.mark.parametrize("d_feats,dim,n", BATCHES)
def test_batched_plain_version_matches_jax_per_node(d_feats, dim, n):
    omegas, biases, x, omega, bias = batch_case(d_feats, dim, n, seed=dim)
    scales = [float(np.sqrt(2.0 / dj)) for dj in d_feats]
    got = ops.rff_features_batched(torch.as_tensor(omega),
                                   torch.as_tensor(bias), torch.as_tensor(x),
                                   scale=scales, d_feat=d_feats)
    assert got.dtype == torch.float64
    assert got.shape == (len(d_feats), max(d_feats), n)
    for j, (om, b, s, dj) in enumerate(zip(omegas, biases, scales, d_feats)):
        want = rops.rff_features(jnp.asarray(om), jnp.asarray(b),
                                 jnp.asarray(x), scale=s, interpret=True)
        assert_close(got[j, :dj], np.asarray(want))
        one = ops.rff_features(torch.as_tensor(om), torch.as_tensor(b),
                               torch.as_tensor(x), scale=s)
        assert torch.equal(got[j, :dj], one)
        assert torch.equal(got[j, dj:], torch.zeros_like(got[j, dj:]))


@pytest.mark.parametrize("d_feats,dim,n", BATCHES)
def test_batched_bf16_plain_version_matches_per_node_and_jax(d_feats, dim,
                                                             n):
    omegas, biases, x, omega, bias = batch_case(d_feats, dim, n,
                                                seed=dim + 1)
    x32 = x.astype(np.float32)
    scales = [float(np.sqrt(2.0 / dj)) for dj in d_feats]
    bf16 = torch.bfloat16
    unit = rff_features_bf16_batched_reference(
        torch.as_tensor(omega).to(bf16), torch.as_tensor(bias).to(bf16),
        torch.as_tensor(x32).to(bf16), d_feat=d_feats)
    got = ops.rff_features_lowp_batched(
        torch.as_tensor(omega), torch.as_tensor(bias), torch.as_tensor(x32),
        scale=scales, d_feat=d_feats)
    assert unit.dtype == bf16 and got.dtype == torch.float32
    for j, (om, b, s, dj) in enumerate(zip(omegas, biases, scales, d_feats)):
        args = (torch.as_tensor(om), torch.as_tensor(b),
                torch.as_tensor(x32))
        assert torch.equal(unit[j, :dj], rff_features_bf16_reference(
            *(a.to(bf16) for a in args)))
        assert torch.equal(unit[j, dj:], torch.zeros_like(unit[j, dj:]))
        per_node = rff_features_lowp_reference(*args, scale=s)
        assert torch.equal(got[j, :dj], per_node)
        assert torch.equal(got[j, :dj], ops.rff_features_lowp(*args,
                                                               scale=s))
        assert torch.equal(got[j, dj:], torch.zeros_like(got[j, dj:]))
        want = np.asarray(rops.rff_features_lowp(
            jnp.asarray(om), jnp.asarray(b), jnp.asarray(x32), scale=s,
            interpret=True))
        exact = s * np.cos(om @ x32.astype(np.float64) + b[:, None])
        bound = _model_bound(om, b, x32.astype(np.float64), s)
        mine = got[j, :dj].numpy()
        assert (np.abs(mine - exact) <= bound).all()
        assert (np.abs(want - exact) <= bound).all()
        assert np.mean(mine == want) >= 0.99


def test_batched_plain_version_f32_equals_per_node():
    omegas, biases, x, omega, bias = batch_case((37, 200, 64), 21, 40, 5)
    f32 = torch.float32
    scales = [float(np.sqrt(2.0 / o.shape[0])) for o in omegas]
    got = rff_features_batched_reference(
        torch.as_tensor(omega, dtype=f32), torch.as_tensor(bias, dtype=f32),
        torch.as_tensor(x, dtype=f32), scale=scales, d_feat=(37, 200, 64))
    assert got.dtype == f32
    for j, (om, b, s) in enumerate(zip(omegas, biases, scales)):
        one = rff_features_reference(torch.as_tensor(om, dtype=f32),
                                     torch.as_tensor(b, dtype=f32),
                                     torch.as_tensor(x, dtype=f32), scale=s)
        assert torch.equal(got[j, :om.shape[0]], one)


def _operands():
    _, _, x, omega, bias = batch_case((3, 5), 4, 6, seed=9)
    return torch.as_tensor(omega), torch.as_tensor(bias), torch.as_tensor(x)


@pytest.mark.parametrize("wrapper", [ops.rff_features_batched,
                                     ops.rff_features_lowp_batched])
def test_batched_wrappers_check_their_operands(wrapper):
    omega, bias, x = _operands()
    ok = dict(scale=(0.5, 0.25), d_feat=(3, 5))
    wrapper(omega, bias, x, **ok)
    with pytest.raises(ValueError, match=r"must lie in \[0, D_max = 5\]"):
        wrapper(omega, bias, x, scale=(0.5, 0.25), d_feat=(3, 6))
    with pytest.raises(ValueError, match="2 scales and 3 feature counts"):
        wrapper(omega, bias, x, scale=(0.5, 0.25), d_feat=(3, 5, 1))
    with pytest.raises(ValueError, match="several devices"):
        wrapper(omega, bias, x.to("meta"), **ok)
    with pytest.raises(ValueError, match="x must be contiguous"):
        wrapper(omega, bias, x.T.contiguous().T, **ok)
    with pytest.raises(ValueError, match="omega must be contiguous"):
        wrapper(omega.transpose(1, 2).contiguous().transpose(1, 2), bias, x,
                **ok)
    with pytest.raises(ValueError, match=r"must be \[J, D_max, d\]"):
        wrapper(omega[0], bias, x, **ok)
    with pytest.raises(ValueError, match="bias has shape"):
        wrapper(omega, bias[:, :4], x, **ok)


def test_batched_wrapper_checks_its_dtype():
    omega, bias, x = _operands()
    ok = dict(scale=(0.5, 0.25), d_feat=(3, 5))
    with pytest.raises(TypeError, match="share one dtype"):
        ops.rff_features_batched(omega, bias, x.float(), **ok)
    with pytest.raises(TypeError, match="must be floating point"):
        ops.rff_features_lowp_batched(omega, bias, x.long(), **ok)


# ------------------------------------------------------- the one-launch wave
# two cos_bias nodes of different widths and one cos_sin node
NODES = (("cos_bias", 24), ("cos_sin", 6), ("cos_bias", 9))


def _ref_snapshot(seed=11, d=5, dy=None) -> RefSnapshot:
    rng = np.random.default_rng(seed)
    key = jax.random.PRNGKey(seed)
    fmaps, thetas = [], []
    for kind, freqs in NODES:
        key, k = jax.random.split(key)
        fm = ref_sample_rff(k, d, freqs, 1.0, kind=kind)
        fmaps.append(fm)
        shape = (fm.num_features,) if dy is None else (fm.num_features, dy)
        thetas.append(jnp.asarray(rng.normal(size=shape)))
    return RefSnapshot(feature_maps=tuple(fmaps), theta=tuple(thetas),
                       staleness=RefStaleness(1, 0, 0, 0.0))


def _queries(seed=11, n=14, d=5):
    rng = np.random.default_rng(seed)
    return [(uid, 2.0 * (rng.normal(size=(d, int(rng.integers(1, 5))))
                         if uid % 3 else rng.normal(size=d)),
             uid % 3 if uid % 4 == 0 else None) for uid in range(n)]


def _run(engine, cls):
    got = engine.run([cls(uid=u, x=x, node=n) for u, x, n in _queries()])
    return [(np.asarray(q.prediction, dtype=np.float64), q.staleness)
            for q in got]


@pytest.mark.parametrize("dy", [None, 2])
@pytest.mark.parametrize("precision", [None, "bf16", "int8"])
def test_ragged_mixed_snapshot_answers_match_reference(dy, precision):
    ref = _ref_snapshot(dy=dy)
    snap = interop.snapshot_from_arrays(
        [np.asarray(fm.omega) for fm in ref.feature_maps],
        [None if fm.bias is None else np.asarray(fm.bias)
         for fm in ref.feature_maps],
        [fm.kind for fm in ref.feature_maps],
        [np.asarray(t) for t in ref.theta],
        dataclasses.astuple(ref.staleness), device="cpu")
    eng = DeKRRServeEngine(snap, batch_size=5, backend="cuda",
                           precision=precision)
    staged = eng._staged(snap)
    assert staged.packed.nodes == (0, 2)
    assert staged.packed.d_feat == (24, 9)
    got = _run(eng, KernelQuery)
    want = _run(RefEngine(ref, batch_size=5, backend="pallas",
                          precision=precision), RefQuery)
    if precision is None:
        for (g, gs), (w, ws) in zip(got, want, strict=True):
            assert g.shape == w.shape
            assert_close(g, w)
            assert dataclasses.astuple(gs) == dataclasses.astuple(ws)
        return
    hi = _run(DeKRRServeEngine(snap, batch_size=5, backend="cuda"),
              KernelQuery)
    for (h, _), (g, gs), (w, ws) in zip(hi, got, want, strict=True):
        assert np.max(np.abs(g - h)) <= gs.precision
        assert np.max(np.abs(w - h)) <= ws.precision
        assert np.max(np.abs(g - w)) <= 1e-5 * np.max(np.abs(w))
        assert gs.precision == pytest.approx(ws.precision, rel=1e-5)
