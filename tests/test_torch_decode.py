"""The port's decode attention and transformer layers against the JAX
reference, on the CPU.

`repro_torch.kernels.ops.flash_decode` runs its kernel's plain version on
CPU tensors; the reference's `repro.kernels.ops.flash_decode` runs its
Pallas kernel in interpret mode, as `tests/test_kernels_decode.py` does.
Inputs are drawn with seeded numpy and handed to both sides in float32.

Tolerances (all float32, both sides summing in another order):
* flash decode: rtol = atol = 2e-5, the reference kernel's own tolerance
  against its oracle (`tests/test_kernels_decode.py`);
* norms, RoPE, MLPs: rtol = atol = 1e-5 (a few f32 roundings of O(1)
  values, products of length ≤ 64);
* chunked attention: rtol = atol = 2e-5, as the reference's chunk-size
  property (`tests/test_models_property.py`); the sliding-window
  truncation property at 1e-5, as there.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _hypothesis_compat import given, settings, strategies as st

from repro.kernels import ops as ref_ops
from repro.models import layers as ref_layers
from repro_torch.kernels import ops
from repro_torch.kernels.decode_attention import (
    decode_plan, flash_decode_reference, flash_decode_split_reference)
from repro_torch.kernels.ref import chunked_decode_attention_ref
from repro_torch.models import layers as L

DECODE_TOL = 2e-5
LAYER_TOL = 1e-5

CASES = [
    # (B, H, K, dh, S, cur): the cases of tests/test_kernels_decode.py
    (2, 8, 8, 64, 256, 200),        # MHA
    (2, 8, 2, 64, 512, 512),        # GQA 4:1, full cache
    (1, 16, 16, 128, 1024, 37),     # qwen-ish heads, short valid prefix
    (4, 4, 1, 80, 300, 123),        # MQA, unaligned dh & S
    (3, 6, 3, 32, 96, 50),          # small everything
]


# the five cases, then len = 1 and len on the first chunk edge (512
# positions at dh 64, `decode_plan`) and one past it
SPLIT_CASES = CASES + [
    (1, 4, 4, 64, 1024, 1),
    (1, 4, 4, 64, 1024, 512),
    (2, 4, 2, 64, 1100, 513),
]


def decode_inputs(b, h, kh, dh, s, seed):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, 1, h, dh), dtype=np.float32)
    k = rng.standard_normal((b, s, kh, dh), dtype=np.float32)
    v = rng.standard_normal((b, s, kh, dh), dtype=np.float32)
    return q, k, v


def port_decode(q, k, v, cur):
    return ops.flash_decode(torch.from_numpy(q), torch.from_numpy(k),
                            torch.from_numpy(v), cur).numpy()


def ref_decode(q, k, v, cur):
    return np.asarray(ref_ops.flash_decode(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
        jnp.asarray(cur, jnp.int32), interpret=True))


@pytest.mark.parametrize("b,h,kh,dh,s,cur", CASES)
def test_flash_decode_matches_reference(b, h, kh, dh, s, cur):
    q, k, v = decode_inputs(b, h, kh, dh, s, seed=b * 1000 + s)
    np.testing.assert_allclose(port_decode(q, k, v, cur),
                               ref_decode(q, k, v, cur),
                               rtol=DECODE_TOL, atol=DECODE_TOL)


@pytest.mark.parametrize("b,h,kh,dh,s,cur", CASES)
def test_flash_decode_plain_version_matches_oracle(b, h, kh, dh, s, cur):
    """The plain version against the port's copy of the reference oracle
    (`kernels/ref.py::chunked_decode_attention_ref`, kv heads repeated)."""
    q, k, v = (torch.from_numpy(a)
               for a in decode_inputs(b, h, kh, dh, s, seed=s + cur))
    lens = torch.full((b * kh,), cur, dtype=torch.int32)
    got = flash_decode_reference(q, k, v, lens)
    g = h // kh
    mask = (torch.arange(s) < cur)[None, :].expand(b, s)
    want = chunked_decode_attention_ref(
        q[:, 0], k.repeat_interleave(g, dim=2), v.repeat_interleave(g, dim=2),
        scale=dh ** -0.5, mask=mask)[:, None]
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=DECODE_TOL,
                               atol=DECODE_TOL)


_REF_DECODE = {}


def _cached_ref_decode(case):
    """The reference's interpret-mode kernel on a case's inputs, run once
    per case."""
    if case not in _REF_DECODE:
        b, h, kh, dh, s, cur = case
        q, k, v = decode_inputs(b, h, kh, dh, s, seed=7 * s + cur)
        _REF_DECODE[case] = (q, k, v, ref_decode(q, k, v, cur))
    return _REF_DECODE[case]


@pytest.mark.parametrize("case", SPLIT_CASES, ids=str)
@pytest.mark.parametrize("chunk", [None, 32], ids=["plan_chunk", "chunk32"])
def test_flash_decode_split_reference_matches_reference(case, chunk):
    """The kernel's split (each chunk's partial, merged in chunk order),
    with decode_plan's chunk and with chunks of one 32-position tile,
    against the one-pass plain version and the reference's Pallas kernel
    in interpret mode, at the reference kernel's tolerance: the sums run
    in another order."""
    b, h, kh, dh, s, cur = case
    q, k, v, want = _cached_ref_decode(case)
    lens = torch.full((b * kh,), cur, dtype=torch.int32)
    tq, tk, tv = (torch.from_numpy(a) for a in (q, k, v))
    got = flash_decode_split_reference(tq, tk, tv, lens, chunk=chunk)
    assert got.shape == (b, 1, h, dh) and got.dtype == torch.float32
    np.testing.assert_allclose(
        got.numpy(), flash_decode_reference(tq, tk, tv, lens).numpy(),
        rtol=DECODE_TOL, atol=DECODE_TOL)
    np.testing.assert_allclose(got.numpy(), want, rtol=DECODE_TOL,
                               atol=DECODE_TOL)


def test_flash_decode_split_reference_takes_the_plan_chunk():
    """By default the split cuts decode_plan's chunk, and a length past
    one chunk merges more than one partial: the result moves with the
    chunk only within the sum-order tolerance."""
    q, k, v = (torch.from_numpy(a)
               for a in decode_inputs(1, 4, 4, 64, 1100, seed=9))
    lens = torch.full((4,), 1100, dtype=torch.int32)
    assert decode_plan(4, 1, 64).chunk == 512
    default = flash_decode_split_reference(q, k, v, lens)
    assert torch.equal(default,
                       flash_decode_split_reference(q, k, v, lens, chunk=512))
    np.testing.assert_allclose(
        default.numpy(),
        flash_decode_split_reference(q, k, v, lens, chunk=1100 + 60).numpy(),
        rtol=DECODE_TOL, atol=DECODE_TOL)


@given(b=st.integers(1, 3), kh=st.integers(1, 4), g=st.integers(1, 4),
       dh=st.sampled_from([16, 32, 64]), s=st.integers(8, 400),
       seed=st.integers(0, 2**16))
@settings(max_examples=15, deadline=None)
def test_flash_decode_property(b, kh, g, dh, s, seed):
    q, k, v = decode_inputs(b, kh * g, kh, dh, s, seed)
    cur = int(np.random.default_rng(seed + 1).integers(1, s + 1))
    np.testing.assert_allclose(port_decode(q, k, v, cur),
                               ref_decode(q, k, v, cur),
                               rtol=DECODE_TOL, atol=DECODE_TOL)


def test_flash_decode_ignores_stale_cache_tail():
    """Entries beyond cur_index do not change the output, bit for bit."""
    q, k, v = decode_inputs(1, 4, 4, 32, 128, seed=0)
    out1 = port_decode(q, k, v, 64)
    k2, v2 = k.copy(), v.copy()
    k2[:, 64:] = 999.0
    v2[:, 64:] = -999.0
    np.testing.assert_array_equal(port_decode(q, k2, v2, 64), out1)


@pytest.mark.parametrize("cur", [0, 129])
def test_flash_decode_rejects_cur_index_outside_the_cache(cur):
    q, k, v = decode_inputs(1, 4, 2, 32, 128, seed=1)
    with pytest.raises(ValueError, match="cur_index"):
        port_decode(q, k, v, cur)


def test_flash_decode_float64_runs_in_float32():
    """f64 operands are cast to f32 and back, as the reference does."""
    q, k, v = decode_inputs(2, 6, 3, 32, 96, seed=2)
    got = ops.flash_decode(*(torch.from_numpy(a).double()
                             for a in (q, k, v)), 50)
    assert got.dtype == torch.float64
    np.testing.assert_array_equal(got.numpy(),
                                  port_decode(q, k, v, 50).astype(np.float64))


@pytest.mark.parametrize("backend", ["cuda", "torch"])
def test_decode_attention_backends_match_reference(backend):
    """Both decode backends against the reference's decode attention (its
    single-chunk online softmax)."""
    q, k, v = decode_inputs(2, 8, 2, 32, 40, seed=3)
    for cur in (1, 17, 40):
        got = L.decode_attention(torch.from_numpy(q), torch.from_numpy(k),
                                 torch.from_numpy(v), cur, backend=backend)
        want = ref_layers.decode_attention(
            jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
            jnp.asarray(cur, jnp.int32))
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=DECODE_TOL, atol=DECODE_TOL)


def test_decode_attention_rejects_unknown_backend_and_cuda_window():
    """An unknown backend raises; decode takes no sliding window on either
    backend (the swa ring is not ported)."""
    q, k, v = (torch.from_numpy(a) for a in decode_inputs(1, 2, 2, 16, 8, 4))
    with pytest.raises(ValueError, match="backend"):
        L.decode_attention(q, k, v, 4, backend="pallas")
    for backend in L.DECODE_BACKENDS:
        with pytest.raises(TypeError, match="window"):
            L.decode_attention(q, k, v, 4, window=2, backend=backend)


# ------------------------------------------------------------------ layers
def test_norms_match_reference():
    rng = np.random.default_rng(5)
    x = rng.standard_normal((3, 7, 48), dtype=np.float32) * 3
    w = rng.standard_normal(48, dtype=np.float32)
    bias = rng.standard_normal(48, dtype=np.float32)
    np.testing.assert_allclose(
        L.rms_norm(torch.from_numpy(x), torch.from_numpy(w)).numpy(),
        np.asarray(ref_layers.rms_norm(jnp.asarray(x), jnp.asarray(w))),
        rtol=LAYER_TOL, atol=LAYER_TOL)
    np.testing.assert_allclose(
        L.layer_norm(torch.from_numpy(x), torch.from_numpy(w),
                     torch.from_numpy(bias)).numpy(),
        np.asarray(ref_layers.layer_norm(jnp.asarray(x), jnp.asarray(w),
                                         jnp.asarray(bias))),
        rtol=LAYER_TOL, atol=LAYER_TOL)


@pytest.mark.parametrize("dh,theta", [(32, 10000.0), (64, 1e6)])
def test_rope_matches_reference(dh, theta):
    rng = np.random.default_rng(dh)
    x = rng.standard_normal((2, 9, 3, dh), dtype=np.float32)
    pos = np.arange(100, 109, dtype=np.int32)
    got = L.apply_rope(torch.from_numpy(x), torch.from_numpy(pos), theta)
    want = ref_layers.apply_rope(jnp.asarray(x), jnp.asarray(pos), theta)
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               rtol=LAYER_TOL, atol=LAYER_TOL)


@given(sq=st.integers(1, 24), skv=st.integers(1, 48),
       chunk=st.sampled_from([4, 8, 16, 64]), seed=st.integers(0, 999))
@settings(max_examples=20, deadline=None)
def test_chunked_attention_chunk_size_invariance(sq, skv, chunk, seed):
    """The reference's property on the port (online-softmax chunking does
    not change the result), and the port against the reference."""
    rng = np.random.default_rng(seed)
    b, h, kh, dh = 2, 4, 2, 16
    q = rng.standard_normal((b, sq, h, dh), dtype=np.float32)
    k = rng.standard_normal((b, skv, kh, dh), dtype=np.float32)
    v = rng.standard_normal((b, skv, kh, dh), dtype=np.float32)
    qp = np.arange(sq, dtype=np.int32) + (skv - sq if skv >= sq else 0)
    kp = np.arange(skv, dtype=np.int32)
    tq, tk, tv, tqp, tkp = (torch.from_numpy(a) for a in (q, k, v, qp, kp))
    full = L.chunked_attention(tq, tk, tv, tqp, tkp, causal=True,
                               chunk_kv=max(skv, 1))
    got = L.chunked_attention(tq, tk, tv, tqp, tkp, causal=True,
                              chunk_kv=chunk)
    np.testing.assert_allclose(got.numpy(), full.numpy(), rtol=DECODE_TOL,
                               atol=DECODE_TOL)
    want = ref_layers.chunked_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(qp),
        jnp.asarray(kp), causal=True, chunk_kv=chunk)
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               rtol=DECODE_TOL, atol=DECODE_TOL)


def test_sliding_window_equals_truncated_context():
    """Window-w attention over a long context == full attention over the
    last w keys (for the final query position)."""
    rng = np.random.default_rng(0)
    b, h, dh, s, w = 1, 2, 16, 40, 8
    q = torch.from_numpy(rng.standard_normal((b, 1, h, dh), dtype=np.float32))
    k = torch.from_numpy(rng.standard_normal((b, s, h, dh), dtype=np.float32))
    v = torch.from_numpy(rng.standard_normal((b, s, h, dh), dtype=np.float32))
    qp = torch.tensor([s - 1], dtype=torch.int32)
    kp = torch.arange(s, dtype=torch.int32)
    win = L.chunked_attention(q, k, v, qp, kp, causal=True, window=w,
                              chunk_kv=16)
    trunc = L.chunked_attention(q, k[:, s - w:], v[:, s - w:], qp,
                                kp[s - w:], causal=True, chunk_kv=16)
    np.testing.assert_allclose(win.numpy(), trunc.numpy(), rtol=LAYER_TOL,
                               atol=LAYER_TOL)


def test_bidirectional_attention_matches_reference():
    rng = np.random.default_rng(6)
    q = rng.standard_normal((2, 10, 4, 16), dtype=np.float32)
    k = rng.standard_normal((2, 10, 2, 16), dtype=np.float32)
    v = rng.standard_normal((2, 10, 2, 16), dtype=np.float32)
    pos = np.arange(10, dtype=np.int32)
    got = L.chunked_attention(*(torch.from_numpy(a)
                                for a in (q, k, v, pos, pos)),
                              causal=False, chunk_kv=4)
    want = ref_layers.chunked_attention(
        *(jnp.asarray(a) for a in (q, k, v, pos, pos)), causal=False,
        chunk_kv=4)
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               rtol=DECODE_TOL, atol=DECODE_TOL)


def test_mlps_match_reference():
    rng = np.random.default_rng(7)
    d, f = 32, 64
    x = rng.standard_normal((2, 5, d), dtype=np.float32)
    wg, wu = (rng.standard_normal((d, f), dtype=np.float32)
              * np.float32(d ** -0.5) for _ in range(2))
    wd = rng.standard_normal((f, d), dtype=np.float32) * np.float32(f ** -0.5)
    bu = rng.standard_normal(f, dtype=np.float32)
    bd = rng.standard_normal(d, dtype=np.float32)
    t = lambda a: torch.from_numpy(a)
    j = jnp.asarray
    np.testing.assert_allclose(
        L.swiglu_mlp(t(x), t(wg), t(wu), t(wd)).numpy(),
        np.asarray(ref_layers.swiglu_mlp(j(x), j(wg), j(wu), j(wd))),
        rtol=LAYER_TOL, atol=LAYER_TOL)
    np.testing.assert_allclose(
        L.gelu_mlp(t(x), t(wu), t(bu), t(wd), t(bd)).numpy(),
        np.asarray(ref_layers.gelu_mlp(j(x), j(wu), j(bu), j(wd), j(bd))),
        rtol=LAYER_TOL, atol=LAYER_TOL)
