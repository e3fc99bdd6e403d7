"""The port's MoE ffn, Mamba mixer, RWKV-6 time and channel mix and the
sliding-window ring against the JAX reference, on the CPU.

Module functions (`repro_torch.models.{rwkv,ssm,moe}`) take the same
seeded numpy inputs as `repro.models.{rwkv,ssm,moe}`; the model tests
carry the reference's parameters across with
`repro_torch.interop.lm_params_from_arrays` on the reduced rwkv6-7b,
jamba-1.5-large, deepseek-moe-16b and phi3.5-moe, and on reduced
qwen1.5-0.5b with every slot ``swa``.

Tolerances (float32 on both sides, sums in another order), unless a test
states otherwise: atol = 1e-5·max|reference|, rtol 1e-5. The reference's
own invariants hold bit for bit within the port (chunk invariance, step
== scan), or at the reference's tolerance where the arithmetic's shape
changes (groups without drops: rtol 1e-5, atol 1e-6). Softplus: torch's
returns x past 20 where ``jax.nn.softplus`` adds log1p(e^−x) < 2.1e-9,
below float32's ulp there, so the Mamba tests use it as it is.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as ref_get_arch
from repro.models import model as ref_model
from repro.models import moe as ref_moe
from repro.models import rwkv as ref_rwkv
from repro.models import ssm as ref_ssm
from repro.serve import Request as RefRequest
from repro.serve import ServeEngine as RefServeEngine
from repro_torch import interop
from repro_torch.configs import get_arch
from repro_torch.kernels import ops
from repro_torch.launch import serve as serve_cli
from repro_torch.models import model as M
from repro_torch.models import moe, rwkv, ssm
from repro_torch.serve import Request, ServeEngine

RTOL = 1e-5
ARCHS = ["rwkv6_7b", "jamba_1_5_large_398b", "deepseek_moe_16b",
         "phi3_5_moe_42b"]
DECODE_STEPS = 12
SWA_WINDOW = 8
SWA_STEPS = 20


def assert_close(got, want, err_msg="", rtol=RTOL):
    want = np.asarray(want, dtype=np.float64)
    got = got.double().numpy() if isinstance(got, torch.Tensor) \
        else np.asarray(got, dtype=np.float64)
    np.testing.assert_allclose(got, want, rtol=rtol,
                               atol=rtol * np.abs(want).max(),
                               err_msg=err_msg)


def normal(rng, *shape, scale=1.0):
    return (rng.standard_normal(shape) * scale).astype(np.float32)


def both(*arrays):
    """Each array as a jnp array and as a torch tensor."""
    return ([jnp.asarray(a) for a in arrays],
            [torch.from_numpy(np.array(a)) for a in arrays])


# ------------------------------------------------------------------ RWKV-6
def _wkv_inputs(seed, b=2, s=13, h=3, dh=8):
    rng = np.random.default_rng(seed)
    r, k, v = (normal(rng, b, s, h, dh) for _ in range(3))
    w = (1 / (1 + np.exp(-normal(rng, b, s, h, dh))) * 0.9 + 0.05) \
        .astype(np.float32)
    u = normal(rng, h, dh, scale=0.3)
    state = normal(rng, b, h, dh, dh, scale=0.5)        # nonzero start
    return r, k, v, w, u, state


@pytest.mark.parametrize("s,chunk", [(13, 4), (20, 16), (5, 128), (1, 1)])
def test_wkv6_chunk_scan_matches_reference(s, chunk):
    arrays = _wkv_inputs(s, s=s)
    (jr, jk, jv, jw, ju, js), (tr, tk, tv, tw, tu, ts) = both(*arrays)
    want, want_st = ref_rwkv.wkv6_chunk_scan(jr, jk, jv, jw, ju, js,
                                             chunk=chunk)
    got, got_st = rwkv.wkv6_chunk_scan(tr, tk, tv, tw, tu, ts, chunk=chunk)
    assert got.dtype == torch.float32 and got_st.dtype == torch.float32
    assert_close(got, want)
    assert_close(got_st, want_st)


def test_wkv6_step_matches_reference():
    r, k, v, w, u, state = _wkv_inputs(3, s=1)
    (jr, jk, jv, jw, ju, js), (tr, tk, tv, tw, tu, ts) = both(
        r[:, 0], k[:, 0], v[:, 0], w[:, 0], u, state)
    want, want_st = ref_rwkv.wkv6_step(jr, jk, jv, jw, ju, js)
    got, got_st = rwkv.wkv6_step(tr, tk, tv, tw, tu, ts)
    assert_close(got, want)
    assert_close(got_st, want_st)


@pytest.mark.parametrize("s", [1, 7, 33])
def test_wkv6_chunk_invariance_and_step_are_bit_exact(s):
    """The reference's property as a port property, bit for bit: any
    chunk gives the same bits, and the scan equals repeated steps."""
    r, k, v, w, u, state = (torch.from_numpy(a)
                            for a in _wkv_inputs(s + 1, s=s))
    out, st = rwkv.wkv6_chunk_scan(r, k, v, w, u, state, chunk=128)
    for chunk in (1, 4, 16):
        o, stc = rwkv.wkv6_chunk_scan(r, k, v, w, u, state, chunk=chunk)
        assert torch.equal(o, out) and torch.equal(stc, st)
    seq = state
    for t in range(s):
        o, seq = rwkv.wkv6_step(r[:, t], k[:, t], v[:, t], w[:, t], u, seq)
        assert torch.equal(o, out[:, t]), t
    assert torch.equal(seq, st)


def test_data_dependent_decay_matches_reference_at_both_clamps():
    """Inputs whose rate exp(log_w) overflows (clamped to 80) and
    underflows (clamped to 1e-6), beside ordinary ones."""
    rng = np.random.default_rng(5)
    b, s, d, r, h = 2, 6, 16, 4, 2
    x = normal(rng, b, s, d, scale=3.0)
    w0 = np.full((d,), -0.6, np.float32)
    w0[:4], w0[4:8] = 100.0, -120.0           # rate → inf and → 0
    wa, wb = normal(rng, d, r), normal(rng, r, d)
    (jx, jw0, jwa, jwb), (tx, tw0, twa, twb) = both(x, w0, wa, wb)
    want = np.asarray(ref_rwkv.data_dependent_decay(jx, jw0, jwa, jwb, h))
    got = rwkv.data_dependent_decay(tx, tw0, twa, twb, h)
    assert_close(got, want)
    flat = got.reshape(b, s, d).numpy()
    np.testing.assert_array_equal(flat[..., :4], np.float32(np.exp(-80.0)))
    np.testing.assert_array_equal(flat[..., 4:8], np.float32(np.exp(-1e-6)))
    np.testing.assert_array_equal(want.reshape(b, s, d)[..., :8],
                                  flat[..., :8])


def test_data_dependent_decay_in_unit_interval():
    """The reference's property: w ∈ (0, 1), and it depends on the data."""
    rng = np.random.default_rng(0)
    b, s, d, r, h = 2, 10, 16, 4, 2
    x = torch.from_numpy(normal(rng, b, s, d, scale=3.0))
    w0 = torch.full((d,), -0.6)
    wa, wb = (torch.from_numpy(normal(rng, *sh)) for sh in ((d, r), (r, d)))
    w = rwkv.data_dependent_decay(x, w0, wa, wb, h)
    assert float(w.min()) > 0.0 and float(w.max()) < 1.0
    x2 = x.clone()
    x2[:, 0] = -x[:, 0]
    w2 = rwkv.data_dependent_decay(x2, w0, wa, wb, h)
    assert float((w[:, 0] - w2[:, 0]).abs().max()) > 1e-6


@pytest.mark.parametrize("with_prev", [False, True])
def test_token_shift_and_channel_mix_match_reference(with_prev):
    rng = np.random.default_rng(7)
    b, s, d, f = 2, 5, 16, 24
    x, mu = normal(rng, b, s, d), rng.random(d).astype(np.float32)
    wr, wk, wv = normal(rng, d, d), normal(rng, d, f), normal(rng, f, d)
    prev = normal(rng, b, d)
    (jx, jmu, jwr, jwk, jwv, jp), (tx, tmu, twr, twk, twv, tp) = both(
        x, mu, wr, wk, wv, prev)
    jp, tp = (jp, tp) if with_prev else (None, None)
    assert_close(rwkv.token_shift(tx, tmu, tp),
                 ref_rwkv.token_shift(jx, jmu, jp))
    assert_close(rwkv.channel_mix(tx, tmu, twr, twk, twv, tp),
                 ref_rwkv.channel_mix(jx, jmu, jwr, jwk, jwv, jp))


# -------------------------------------------------------------------- Mamba
@pytest.mark.parametrize("with_prev", [False, True])
def test_causal_conv1d_matches_reference(with_prev):
    rng = np.random.default_rng(11)
    b, s, c, ksz = 2, 9, 12, 4
    x, w, prev = normal(rng, b, s, c), normal(rng, ksz, c), \
        normal(rng, b, ksz - 1, c)
    (jx, jw, jp), (tx, tw, tp) = both(x, w, prev)
    assert_close(ssm.causal_conv1d(tx, tw, tp if with_prev else None),
                 ref_ssm.causal_conv1d(jx, jw, jp if with_prev else None))


def _ssm_inputs(seed, b=2, s=13, di=10, n=4):
    rng = np.random.default_rng(seed)
    x = normal(rng, b, s, di)
    delta = np.log1p(np.exp(normal(rng, b, s, di))).astype(np.float32)
    b_t, c_t = normal(rng, b, s, n), normal(rng, b, s, n)
    a_log = normal(rng, di, n, scale=0.3)
    d_skip = normal(rng, di)
    state = normal(rng, b, di, n, scale=0.5)            # nonzero start
    return x, delta, a_log, b_t, c_t, d_skip, state


@pytest.mark.parametrize("s,chunk", [(13, 4), (20, 16), (5, 128)])
def test_ssm_chunk_scan_matches_reference(s, chunk):
    jargs, targs = both(*_ssm_inputs(s, s=s))
    want, want_st = ref_ssm.ssm_chunk_scan(*jargs, chunk=chunk)
    got, got_st = ssm.ssm_chunk_scan(*targs, chunk=chunk)
    assert got_st.dtype == torch.float32
    assert_close(got, want)
    assert_close(got_st, want_st)


def test_ssm_step_matches_reference():
    x, delta, a_log, b_t, c_t, d_skip, state = _ssm_inputs(2, s=1)
    jargs, targs = both(x[:, 0], delta[:, 0], a_log, b_t[:, 0], c_t[:, 0],
                        d_skip, state)
    want, want_st = ref_ssm.ssm_step(*jargs)
    got, got_st = ssm.ssm_step(*targs)
    assert_close(got, want)
    assert_close(got_st, want_st)


@pytest.mark.parametrize("s", [1, 7, 33])
def test_ssm_chunk_invariance_and_step_are_bit_exact(s):
    x, delta, a_log, b_t, c_t, d_skip, state = (
        torch.from_numpy(a) for a in _ssm_inputs(s + 5, s=s))
    y, st = ssm.ssm_chunk_scan(x, delta, a_log, b_t, c_t, d_skip, state)
    for chunk in (1, 4, 16):
        yc, stc = ssm.ssm_chunk_scan(x, delta, a_log, b_t, c_t, d_skip,
                                     state, chunk=chunk)
        assert torch.equal(yc, y) and torch.equal(stc, st)
    seq = state
    for t in range(s):
        yt, seq = ssm.ssm_step(x[:, t], delta[:, t], a_log, b_t[:, t],
                               c_t[:, t], d_skip, seq)
        assert torch.equal(yt, y[:, t]), t
    assert torch.equal(seq, st)


# ---------------------------------------------------------------------- MoE
@pytest.mark.parametrize("tokens,e,k,factor", [
    (8, 64, 6, 1.25), (16, 4, 2, 1.25), (256, 8, 2, 1.25), (64, 4, 2, 0.25),
    (32, 4, 2, 16.0), (3, 4, 2, 1.25), (1024, 64, 6, 8.0)])
def test_moe_capacity_matches_reference(tokens, e, k, factor):
    dims = dict(num_experts=e, experts_per_token=k, d_model=8, d_ff=8,
                capacity_factor=factor)
    assert moe.moe_capacity(moe.MoEDims(**dims), tokens) == \
        ref_moe.moe_capacity(ref_moe.MoEDims(**dims), tokens)


def _moe_inputs(seed, t=256, d=32, e=8, f=16, shared=0):
    """Routing skewed toward expert 0, so it overflows its capacity."""
    rng = np.random.default_rng(seed)
    x = normal(rng, t, d) + 1.0
    router = normal(rng, d, e, scale=0.1)
    router[:, 0] += 0.1
    w = [normal(rng, e, d, f, scale=d ** -0.5),
         normal(rng, e, d, f, scale=d ** -0.5),
         normal(rng, e, f, d, scale=f ** -0.5)]
    sh = [normal(rng, d, shared * f, scale=d ** -0.5),
          normal(rng, d, shared * f, scale=d ** -0.5),
          normal(rng, shared * f, d, scale=(shared * f) ** -0.5)] \
        if shared else []
    return [x, router] + w, sh


def _ref_max_count(x, router, dims, groups):
    """The largest (group, expert) count of the reference's routing."""
    t = x.shape[0]
    g = groups if t % groups == 0 else 1
    probs = jax.nn.softmax(jnp.asarray(x).reshape(g, t // g, -1)
                           @ jnp.asarray(router), axis=-1)
    top_e = np.asarray(jax.lax.top_k(probs, dims.experts_per_token)[1])
    return max(np.bincount(top_e[i].ravel(), minlength=dims.num_experts)
               .max() for i in range(g))


@pytest.mark.parametrize("shared", [0, 2])
@pytest.mark.parametrize("groups", [1, 2, 4])
def test_moe_forward_matches_reference_with_drops(groups, shared):
    """Default capacity factor 1.25, routing skewed so the reference
    drops; the outputs and both aux losses agree."""
    (x, router, wg, wu, wd), sh = _moe_inputs(groups + 10 * shared,
                                             shared=shared)
    kw = dict(num_experts=8, experts_per_token=2, d_model=32, d_ff=16,
              num_shared_experts=shared)
    rdims, pdims = ref_moe.MoEDims(**kw), moe.MoEDims(**kw)
    cap = ref_moe.moe_capacity(rdims, x.shape[0] // groups)
    assert _ref_max_count(x, router, rdims, groups) > cap   # it drops
    jargs, targs = both(x, router, wg, wu, wd)
    jsh, tsh = both(*sh)
    names = ("shared_w_gate", "shared_w_up", "shared_w_down")
    want, want_aux = ref_moe.moe_forward(*jargs, rdims, groups=groups,
                                         **dict(zip(names, jsh)))
    got, got_aux = moe.moe_forward(*targs, pdims, groups=groups,
                                   **dict(zip(names, tsh)))
    assert_close(got, want)
    assert list(got_aux) == list(want_aux)
    for key in want_aux:
        assert_close(got_aux[key], want_aux[key], err_msg=key)


@pytest.mark.parametrize("groups", [1, 2, 4])
def test_moe_groups_equivalence_without_drops(groups):
    """The reference's property on the port: grouped dispatch equals one
    group when capacity never binds (rtol 1e-5, atol 1e-6 as there)."""
    (x, router, wg, wu, wd), _ = _moe_inputs(3, t=32, d=16, e=4, f=24)
    dims = moe.MoEDims(4, 2, 16, 24, capacity_factor=16.0)
    args = [torch.from_numpy(a) for a in (x, router, wg, wu, wd)]
    out1, aux1 = moe.moe_forward(*args, dims, groups=1)
    outg, auxg = moe.moe_forward(*args, dims, groups=groups)
    np.testing.assert_allclose(outg.numpy(), out1.numpy(), rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_allclose(float(auxg["load_balance_loss"]),
                               float(aux1["load_balance_loss"]), rtol=1e-6)


def test_moe_capacity_drops_reduce_output_norm():
    """The reference's property on the port: a tiny capacity factor drops
    tokens, and the output norm falls below the no-drop one."""
    rng = np.random.default_rng(1)
    t, d, e, f, k = 64, 8, 4, 16, 2
    args = [torch.from_numpy(a) for a in (
        normal(rng, t, d), normal(rng, d, e, scale=2.0),
        normal(rng, e, d, f, scale=d ** -0.5),
        normal(rng, e, d, f, scale=d ** -0.5),
        normal(rng, e, f, d, scale=f ** -0.5))]
    big = moe.MoEDims(e, k, d, f, capacity_factor=16.0)
    small = dataclasses.replace(big, capacity_factor=0.25)
    out_big, _ = moe.moe_forward(*args, big)
    out_small, _ = moe.moe_forward(*args, small)
    assert float(out_small.norm()) < float(out_big.norm())


def test_moe_is_deterministic_and_ignores_shard():
    (x, router, wg, wu, wd), _ = _moe_inputs(4)
    args = [torch.from_numpy(a) for a in (x, router, wg, wu, wd)]
    dims = moe.MoEDims(8, 2, 32, 16)
    out, _ = moe.moe_forward(*args, dims, groups=2)
    again, _ = moe.moe_forward(*args, dims, groups=2,
                               shard=(("data",), "model"))
    assert torch.equal(out, again)


# ------------------------------------------------------------ the models
def ref_config(arch, **kw):
    return dataclasses.replace(ref_get_arch(arch).config.reduced(), **kw)


def port_config(arch, **kw):
    return dataclasses.replace(get_arch(arch).config.reduced(), **kw)


def swa_kw():
    return dict(slots=(ref_model.SlotSpec("swa", "dense"),),
                sliding_window=SWA_WINDOW)


@functools.lru_cache(maxsize=None)
def ref_params(arch):
    return ref_model.init_params(ref_config(arch), jax.random.PRNGKey(0))


def port_model(arch, **kw):
    cfg = port_config(arch, **kw)
    arrays = jax.tree.map(np.asarray, ref_params(arch))
    return M.Model(cfg, interop.lm_params_from_arrays(cfg, arrays,
                                                      device="cpu"))


def swa_models():
    """Reduced qwen1.5-0.5b with every slot swa (window 8), both sides."""
    rc = ref_config("qwen1_5_0_5b", **swa_kw())
    pc = port_config("qwen1_5_0_5b", slots=(M.SlotSpec("swa", "dense"),),
                     sliding_window=SWA_WINDOW)
    arrays = jax.tree.map(np.asarray, ref_params("qwen1_5_0_5b"))
    return (ref_model.Model(rc),
            M.Model(pc, interop.lm_params_from_arrays(pc, arrays,
                                                      device="cpu")))


def tokens(arch, b, s, seed=1):
    vocab = ref_config(arch).vocab_size
    return np.random.default_rng(seed).integers(0, vocab, (b, s),
                                                dtype=np.int32)


def _assert_caches_close(got: dict, want: dict):
    assert set(got) == set(want)
    for slot, entries in want.items():
        assert set(got[slot]) == set(entries), slot
        for name, ref in entries.items():
            if name == "pos":
                np.testing.assert_array_equal(got[slot][name].numpy(),
                                              np.asarray(ref))
            else:
                assert_close(got[slot][name], np.asarray(ref, np.float64),
                             err_msg=f"{slot}.{name}")


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_and_aux_match_reference(arch):
    toks = tokens(arch, 2, 20)
    want, want_aux = ref_model.Model(ref_config(arch)).forward(
        ref_params(arch), tokens=jnp.asarray(toks))
    got, got_aux = port_model(arch).forward(torch.from_numpy(toks))
    assert_close(got, want)
    assert list(got_aux) == list(want_aux)
    assert bool(want_aux) == (arch != "rwkv6_7b")
    for key in want_aux:
        assert_close(got_aux[key], want_aux[key], err_msg=key)


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_steps_and_caches_match_reference(arch):
    """12 decode steps: the logits at every step and every cache entry
    after the last (K/V, conv windows, shift and recurrent states)."""
    toks = tokens(arch, 2, DECODE_STEPS)
    rm, pm = ref_model.Model(ref_config(arch)), port_model(arch)
    rcache, pcache = rm.init_cache(2, 16), pm.init_cache(2, 16)
    step = jax.jit(rm.decode_step)
    ops.reset_launch_counts()
    for t in range(DECODE_STEPS):
        want, rcache = step(ref_params(arch), rcache,
                            jnp.asarray(toks[:, t:t + 1]),
                            jnp.asarray(t, jnp.int32))
        got, pcache = pm.decode_step(pcache, torch.from_numpy(
            toks[:, t:t + 1]), t)
        assert_close(got, want, err_msg=f"step {t}")
    assert ops.launch_counts()["flash_decode"] == 0    # CPU: plain version
    _assert_caches_close(pcache, rcache)


@pytest.mark.parametrize("backend", ["cuda", "torch"])
@pytest.mark.parametrize("arch", ARCHS)
def test_decode_matches_own_forward(arch, backend):
    """The reference's `test_decode_matches_forward` on the port: rtol
    2e-3, atol 2e-4, capacity factor 8 so no token drops."""
    pm = port_model(arch, moe_capacity_factor=8.0)
    toks = torch.from_numpy(tokens(arch, 2, 16))
    full, _ = pm.forward(toks)
    cache = pm.init_cache(2, 32)
    for t in range(16):
        lg, cache = pm.decode_step(cache, toks[:, t:t + 1], t,
                                   backend=backend)
        np.testing.assert_allclose(lg.numpy(), full[:, t].numpy(),
                                   rtol=2e-3, atol=2e-4,
                                   err_msg=f"{arch} diverges at t={t}")


def test_swa_ring_matches_reference():
    """Window 8 over 20 steps, so the ring wraps twice: the logits at
    every step, and the K/V ring and ``pos`` table after each wrap."""
    rm, pm = swa_models()
    params = ref_params("qwen1_5_0_5b")
    toks = tokens("qwen1_5_0_5b", 2, SWA_STEPS)
    rcache, pcache = rm.init_cache(2, 64), pm.init_cache(2, 64)
    assert pcache["slot0"]["pos"].shape == (2, SWA_WINDOW)
    assert int(pcache["slot0"]["pos"].min()) == torch.iinfo(torch.int32).max
    step = jax.jit(rm.decode_step)
    for t in range(SWA_STEPS):
        want, rcache = step(params, rcache, jnp.asarray(toks[:, t:t + 1]),
                            jnp.asarray(t, jnp.int32))
        got, pcache = pm.decode_step(pcache, torch.from_numpy(
            toks[:, t:t + 1]), t)
        assert_close(got, want, err_msg=f"step {t}")
        if t % SWA_WINDOW == SWA_WINDOW - 1 or t == SWA_STEPS - 1:
            _assert_caches_close(pcache, rcache)
    assert sorted(pcache["slot0"]["pos"][0].tolist()) == list(
        range(SWA_STEPS - SWA_WINDOW, SWA_STEPS))


def test_swa_forward_matches_reference():
    rm, pm = swa_models()
    toks = tokens("qwen1_5_0_5b", 2, SWA_STEPS)
    want, _ = rm.forward(ref_params("qwen1_5_0_5b"),
                         tokens=jnp.asarray(toks))
    got, aux = pm.forward(torch.from_numpy(toks))
    assert aux == {}
    assert_close(got, want)


@pytest.mark.parametrize("arch", ARCHS + ["qwen1_5_0_5b"])
def test_init_params_fixed_entries_match_reference(arch):
    """Every entry the reference does not draw (norms, ``gn``, ``mu_*``,
    biases, ``dt_bias``, ``d_skip``, ``u``, ``a_log``, ``w0``) equals the
    reference's exactly; the drawn ones have the reference's shapes."""
    cfg = port_config(arch)
    got = interop.lm_params_to_arrays(
        M.init_params(cfg, torch.Generator().manual_seed(0)))
    want = jax.tree.map(np.asarray, ref_params(arch))
    assert jax.tree.map(np.shape, got) == jax.tree.map(np.shape, want)
    fixed = 0
    for slot in (k for k in want if k.startswith("slot")):
        for name, ref in want[slot].items():
            if M._fixed_param(name, (1,), torch.float32, "cpu") is not None:
                np.testing.assert_array_equal(got[slot][name], ref,
                                              err_msg=f"{slot}.{name}")
                fixed += 1
    np.testing.assert_array_equal(got["final_norm"], want["final_norm"])
    assert fixed >= 2


@pytest.mark.parametrize("arch", ["rwkv6_7b", "jamba_1_5_large_398b"])
def test_decode_resumes_from_reference_cache(arch):
    """The reference decodes 6 tokens; its cache crosses with
    `lm_cache_from_arrays` and the port continues for 6 more, equal to
    the reference's own continuation."""
    toks = tokens(arch, 2, 12)
    rm, pm = ref_model.Model(ref_config(arch)), port_model(arch)
    step = jax.jit(rm.decode_step)
    rcache = rm.init_cache(2, 16)
    for t in range(6):
        _, rcache = step(ref_params(arch), rcache,
                         jnp.asarray(toks[:, t:t + 1]),
                         jnp.asarray(t, jnp.int32))
    arrays = jax.tree.map(np.asarray, rcache)
    pcache = interop.lm_cache_from_arrays(pm.cfg, arrays, batch=2,
                                          max_seq=16, device="cpu")
    back = interop.lm_cache_to_arrays(pcache)
    assert jax.tree.structure(back) == jax.tree.structure(arrays)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(arrays)):
        np.testing.assert_array_equal(a, np.asarray(b, a.dtype))
    for t in range(6, 12):
        want, rcache = step(ref_params(arch), rcache,
                            jnp.asarray(toks[:, t:t + 1]),
                            jnp.asarray(t, jnp.int32))
        got, pcache = pm.decode_step(pcache, torch.from_numpy(
            toks[:, t:t + 1]), t)
        assert_close(got, want, err_msg=f"step {t}")
    _assert_caches_close(pcache, rcache)


def test_lm_cache_from_arrays_checks_shapes():
    rm, pm = swa_models()
    arrays = jax.tree.map(np.asarray, rm.init_cache(2, 16))
    interop.lm_cache_from_arrays(pm.cfg, arrays, batch=2, max_seq=16,
                                 device="cpu")
    bad = {"slot0": dict(arrays["slot0"], pos=arrays["slot0"]["pos"][:, 1:])}
    with pytest.raises(ValueError, match="slot0.pos"):
        interop.lm_cache_from_arrays(pm.cfg, bad, batch=2, max_seq=16,
                                     device="cpu")
    with pytest.raises(ValueError, match="names"):
        interop.lm_cache_from_arrays(
            pm.cfg, {"slot0": {"k": arrays["slot0"]["k"]}}, batch=2,
            max_seq=16, device="cpu")
    with pytest.raises(ValueError, match="shape"):
        interop.lm_cache_from_arrays(pm.cfg, arrays, batch=3, max_seq=16,
                                     device="cpu")


# ------------------------------------------------------------------ engine
def _requests(arch, cls, n=5, seed=4):
    rng = np.random.default_rng(seed)
    vocab = ref_config(arch).vocab_size
    return [cls(uid=i, prompt=rng.integers(0, vocab, rng.integers(3, 11))
                .tolist(), max_new_tokens=8) for i in range(n)]


def _ref_margins(arch, prompt, output):
    """The reference's top-2 logit margin and argmax at each generated
    position along prompt + output (batch of one, teacher-forced), and
    max|logit|."""
    rm = ref_model.Model(ref_config(arch))
    step = jax.jit(rm.decode_step)
    cache = rm.init_cache(1, 64)
    seq = list(prompt) + list(output)
    margins, tops, scale = [], [], 0.0
    for t in range(len(seq) - 1):
        lg, cache = step(ref_params(arch), cache,
                         jnp.asarray([[seq[t]]], jnp.int32),
                         jnp.asarray(t, jnp.int32))
        if t >= len(prompt) - 1:
            top2 = np.sort(np.asarray(lg[0]))[-2:]
            margins.append(top2[1] - top2[0])
            tops.append(int(jnp.argmax(lg[0])))
            scale = max(scale, float(jnp.abs(lg).max()))
    return np.array(margins), tops, scale


@pytest.mark.parametrize("arch", ["rwkv6_7b", "deepseek_moe_16b"])
def test_serve_engine_matches_reference(arch):
    """`tests/test_torch_llm.py`'s margin rule: tokens equal wherever the
    reference's top-2 margin exceeds 10× the logit tolerance, up to the
    first step where it does not (5 requests over 3 slots)."""
    ref = RefServeEngine(ref_config(arch), params=ref_params(arch),
                         batch_size=3, max_seq=64)
    want = ref.run(_requests(arch, RefRequest))
    cfg = port_config(arch)
    port = ServeEngine(cfg, interop.lm_params_from_arrays(
        cfg, jax.tree.map(np.asarray, ref_params(arch)), device="cpu"),
        batch_size=3, max_seq=64, device="cpu")
    got = port.run(_requests(arch, Request))
    assert [r.uid for r in got] == [r.uid for r in want]
    compared = 0
    for g, w in zip(got, want):
        assert g.done and len(g.output) == len(w.output) == 8
        margins, tops, scale = _ref_margins(arch, w.prompt, w.output)
        assert tops == w.output[:len(tops)]
        for i, margin in enumerate(margins):
            if margin <= 10 * RTOL * scale:
                break
            assert g.output[i] == w.output[i], (g.uid, i)
            compared += 1
    assert compared >= 20
    assert port.latency.report().count == 5


@pytest.mark.parametrize("arch", ARCHS)
def test_serve_cli_runs_the_reduced_config(arch, capsys):
    """`python -m repro_torch.launch.serve --arch <arch> --device cpu`: the
    reduced configuration (no ``--full``), seeded weights, greedy decode."""
    serve_cli.main(["--arch", arch, "--device", "cpu", "--batch", "2",
                    "--prompt-len", "4", "--gen", "3"])
    out = capsys.readouterr().out
    assert f"{port_config(arch).name} on cpu: generated (2, 3) tokens" \
        in out
