"""bf16 decode through the port's default backend against the JAX
reference, on the CPU.

A bf16 model decodes on ``backend="cuda"`` (`ops.flash_decode`; on CPU
tensors its plain version) with bf16 and int8 caches, and `ServeEngine`
serves it, against the reference's bf16 `decode_step` and engine on the
same weights (the reference's seeded bf16 parameters carried across).
The plain versions of the kernel compute bf16 operands in f32 and round
the output to bf16 once, the kernel's contract.

Tolerances:
* bf16 logits, port against reference: 2^-5·max|logit| (8 bf16 ulps of
  the largest logit; the two frameworks round bf16 activations at other
  places — measured 3.4 ulps over 10 steps of the reduced qwen1.5-0.5b);
* engine tokens: equal wherever the reference's top-2 margin exceeds
  that tolerance, up to the first step where it does not;
* the bf16 plain versions against the f32 plain versions on the same
  (bf16-valued) inputs: one bf16 rounding of the output, 2^-8·|out|,
  plus the f32 versions' own 2e-5;
* against the reference's Pallas kernel in interpret mode on the same
  bf16 values in f32: one bf16 rounding of the output plus the f32
  kernels' 2e-5.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as ref_get_arch
from repro.kernels import ops as ref_ops
from repro.models import model as ref_model
from repro.serve import Request as RefRequest
from repro.serve import ServeEngine as RefServeEngine
from repro_torch import interop
from repro_torch.analysis import smem
from repro_torch.configs import get_arch
from repro_torch.kernels import ops
from repro_torch.kernels.decode_attention import (
    decode_merge_bytes, decode_plan, decode_smem_bytes,
    flash_decode_reference, flash_decode_split_reference)
from repro_torch.models import model as M
from repro_torch.serve import Request, ServeEngine

ARCH = "qwen1_5_0_5b"
BF16 = dict(param_dtype="bfloat16", compute_dtype="bfloat16")
LOGIT_TOL = 2.0 ** -5
ROUND = 2.0 ** -8             # one bf16 rounding, relative
F32_TOL = 2e-5
STEPS = 10

CASES = [
    # (B, H, K, dh, S, cur): the f32 tests' cases at dh multiples of 8,
    # the serving cache's heads, and a length past 1,024 positions
    (2, 8, 8, 64, 256, 200),
    (2, 8, 2, 64, 512, 512),
    (1, 16, 16, 128, 1024, 37),
    (4, 4, 1, 80, 300, 123),
    (3, 6, 3, 32, 96, 50),
    (8, 16, 16, 64, 512, 128),
    (1, 4, 4, 64, 2100, 1025),
]


def bf16_inputs(b, h, kh, dh, s, seed):
    rng = np.random.default_rng(seed)
    return tuple(torch.from_numpy(rng.standard_normal(shape, np.float32))
                 .bfloat16() for shape in ((b, 1, h, dh), (b, s, kh, dh),
                                           (b, s, kh, dh)))


def _lens(b, kh, cur):
    return torch.full((b * kh,), cur, dtype=torch.int32)


# ------------------------------------------------------------ the kernel
@pytest.mark.parametrize("case", CASES, ids=str)
def test_bf16_plain_versions_match_f32(case):
    b, h, kh, dh, s, cur = case
    q, k, v = bf16_inputs(b, h, kh, dh, s, seed=s + cur)
    want = flash_decode_reference(q.float(), k.float(), v.float(),
                                  _lens(b, kh, cur))
    for plain in (flash_decode_reference, flash_decode_split_reference):
        got = plain(q, k, v, _lens(b, kh, cur))
        assert got.dtype == torch.bfloat16
        np.testing.assert_array_less(
            (got.float() - want).abs().numpy(),
            (ROUND * want.abs() + F32_TOL * (1 + want.abs())).numpy() + 1e-12)
    # the wrapper takes bf16 as it is (no f32 copy of the cache) and
    # rounds the plain version's f32 sums once
    out = ops.flash_decode(q, k, v, cur)
    assert torch.equal(out, flash_decode_reference(q, k, v,
                                                   _lens(b, kh, cur)))


@pytest.mark.parametrize("case", CASES[:5], ids=str)
def test_bf16_flash_decode_matches_reference_kernel(case):
    """The port's bf16 decode against the reference's Pallas kernel in
    interpret mode on the same bf16 values, carried in f32: the function
    the port's kernel computes (f32 scores, m, l and acc over bf16
    operands), to one rounding of the output to bf16. (Fed bf16 arrays,
    the reference's kernel also rounds its scores and p·v products to
    bf16, since ``jax.lax.dot`` returns the operands' type.)"""
    b, h, kh, dh, s, cur = case
    q, k, v = bf16_inputs(b, h, kh, dh, s, seed=7 * s + cur)
    want = np.asarray(ref_ops.flash_decode(
        *(jnp.asarray(t.float().numpy()) for t in (q, k, v)),
        jnp.asarray(cur, jnp.int32), interpret=True), np.float32)
    got = ops.flash_decode(q, k, v, cur).float().numpy()
    np.testing.assert_array_less(
        np.abs(got - want),
        ROUND * np.abs(want) + F32_TOL * (1 + np.abs(want)) + 1e-12)


def test_flash_decode_dtypes():
    q, k, v = bf16_inputs(1, 2, 2, 16, 8, seed=0)
    with pytest.raises(TypeError, match="share one dtype"):
        ops.flash_decode(q, k.float(), v, 4)
    with pytest.raises(TypeError, match="share one dtype"):
        ops.flash_decode(q.half(), k.half(), v.half(), 4)
    assert ops.flash_decode(q.double(), k.double(), v.double(),
                            4).dtype == torch.float64


@pytest.mark.parametrize("rows,groups,dh,s", [
    (128, 1, 64, 512), (16, 1, 64, 32_768), (128, 1, 64, 32_768),
    (128, 1, 128, 512), (8, 8, 256, 4096)])
def test_flash_decode_budget_at_itemsize_2(rows, groups, dh, s):
    """The bf16 route's layout (csrc/flash_decode.cu `bf16_smem_bytes`):
    a ring of bf16 K and V stages and a unit's query rows a stage, the
    query rows in f32, the merge area, a full and an empty mbarrier a
    stage and a 16-byte flag; the estimate follows
    `decode_plan(itemsize=2)`, the chunk is 16 stages (512 KB of K and V
    from dh 64 up), and a stage holds no more bytes than an f32 stage of
    the same dh."""
    est = smem.estimate_flash_decode(rows=rows, groups=groups, dh=dh, s=s,
                                     itemsize=2)
    plan = decode_plan(rows, groups, dh, 2)
    assert est.bytes == plan.smem_bytes == decode_smem_bytes(
        plan.ppg, plan.stages, plan.head_block, dh, 2)
    assert plan.smem_bytes == (plan.stages * 2 * plan.tile * dh * 2
                               + plan.stages * plan.head_block * dh * 2
                               + plan.head_block * dh * 4
                               + decode_merge_bytes(plan.head_block, dh)
                               + plan.stages * 16 + 16 + 128)
    assert plan.chunk == 16 * plan.tile
    assert plan.chunk * dh * 2 * 2 == 512 << 10
    assert est.grids == ((rows * plan.head_blocks, plan.chunks(s), 1),)
    assert est.fits and "stages*16" in est.formula
    f32 = decode_plan(rows, groups, dh, 4)
    assert plan.tile * dh * 2 <= f32.tile * dh * 4


@pytest.mark.parametrize("cur", [1, 2047, 2048, 2049, 4097, 5000])
def test_split_reference_folds_in_the_plans_merge_order(cur):
    """`flash_decode_split_reference` is the plain version of the bf16
    kernel's split: by default it cuts bf16 operands at the bf16 plan's
    chunk (2,048 positions at dh 64) and f32 ones at the f32 plan's, and its
    result is the fold the plan names (`merge_order`): each active chunk's
    partial (m_c, l_c, acc_c), then Σ e^{m_c − M}·acc_c / Σ e^{m_c − M}·l_c
    over the chunks in that order, M the largest m_c (an explicit fold,
    float64, to 1e-12)."""
    b, h, kh, dh, s = 1, 4, 2, 64, 5000
    rng = np.random.default_rng(cur)
    q, k, v = (torch.from_numpy(rng.standard_normal(shape))
               for shape in ((b, 1, h, dh), (b, s, kh, dh), (b, s, kh, dh)))
    lens = _lens(b, kh, cur)
    plan = decode_plan(b * kh, h // kh, dh, 2)
    assert plan.chunk == 2048 != decode_plan(b * kh, h // kh, dh, 4).chunk
    bq, bk, bv = q.bfloat16(), k.bfloat16(), v.bfloat16()
    assert torch.equal(flash_decode_split_reference(bq, bk, bv, lens),
                       flash_decode_split_reference(bq, bk, bv, lens,
                                                    chunk=plan.chunk))
    f32 = decode_plan(b * kh, h // kh, dh, 4).chunk
    assert torch.equal(
        flash_decode_split_reference(q.float(), k.float(), v.float(), lens),
        flash_decode_split_reference(q.float(), k.float(), v.float(), lens,
                                     chunk=f32))
    got = flash_decode_split_reference(q, k, v, lens, chunk=plan.chunk)
    g = h // kh
    want = torch.empty_like(q)
    for kv in range(kh):
        for gi in range(g):
            parts = []
            for c in plan.merge_order(cur):
                pos = slice(c * plan.chunk, min((c + 1) * plan.chunk, cur))
                sc = (k[0, pos, kv] @ q[0, 0, kv * g + gi]) * dh ** -0.5
                m_c = sc.max()
                p_c = torch.exp(sc - m_c)
                parts.append((m_c, p_c.sum(), p_c @ v[0, pos, kv]))
            big = max(m for m, _, _ in parts)
            l, acc = 0.0, torch.zeros(dh, dtype=torch.float64)
            for m_c, l_c, acc_c in parts:
                w = torch.exp(m_c - big)
                l, acc = l + w * l_c, acc + w * acc_c
            want[0, 0, kv * g + gi] = acc / max(float(l), 1e-30)
    torch.testing.assert_close(got, want, rtol=1e-12, atol=1e-12)


def test_decode_plan_rejects_a_head_dim_bf16_cannot_copy():
    with pytest.raises(ValueError, match="multiple of 8"):
        decode_plan(8, 1, 36, 2)
    assert decode_plan(8, 1, 36, 4).dh == 36


# ------------------------------------------------------------- the model
def ref_config(**kw):
    return dataclasses.replace(ref_get_arch(ARCH).config.reduced(),
                               **BF16, **kw)


def port_config(**kw):
    return dataclasses.replace(get_arch(ARCH).config.reduced(), **BF16, **kw)


@functools.lru_cache(maxsize=None)
def ref_params():
    return ref_model.init_params(ref_config(), jax.random.PRNGKey(0))


def port_params(cfg):
    # bf16 values cross exactly as float32 arrays
    arrays = jax.tree.map(lambda a: np.asarray(a, np.float32), ref_params())
    return interop.lm_params_from_arrays(cfg, arrays, device="cpu")


@pytest.mark.parametrize("kv", ["bfloat16", "int8"])
def test_bf16_decode_step_matches_reference(kv):
    rcfg, pcfg = ref_config(kv_cache_dtype=kv), port_config(kv_cache_dtype=kv)
    rm, pm = ref_model.Model(rcfg), M.Model(pcfg, port_params(pcfg))
    b, s = 2, 64
    rc, pc = rm.init_cache(b, s), pm.init_cache(b, s)
    toks = np.random.default_rng(1).integers(0, rcfg.vocab_size, (b, STEPS),
                                             dtype=np.int32)
    step = jax.jit(rm.decode_step)
    ops.reset_launch_counts()
    before = ops.dispatch_counts()["flash_decode"]
    for t in range(STEPS):
        rl, rc = step(ref_params(), rc, jnp.asarray(toks[:, t:t + 1]),
                      jnp.int32(t))
        pl, pc = pm.decode_step(pc, torch.from_numpy(toks[:, t:t + 1]), t)
        assert pl.dtype == torch.bfloat16
        want = np.asarray(rl, np.float32)
        np.testing.assert_allclose(pl.float().numpy(), want, rtol=0,
                                   atol=LOGIT_TOL * np.abs(want).max(),
                                   err_msg=f"step {t}")
    # every attention layer went through the wrapper (its plain version
    # on the CPU), once a step
    assert ops.dispatch_counts()["flash_decode"] - before \
        == STEPS * pcfg.num_layers


def _requests(cls, n=5, seed=4):
    rng = np.random.default_rng(seed)
    vocab = ref_config().vocab_size
    return [cls(uid=i, prompt=rng.integers(0, vocab, rng.integers(3, 11))
                .tolist(), max_new_tokens=8) for i in range(n)]


def _ref_margins(prompt, output):
    rm = ref_model.Model(ref_config())
    step = jax.jit(rm.decode_step)
    cache = rm.init_cache(1, 64)
    seq = list(prompt) + list(output)
    margins, scale = [], 0.0
    for t in range(len(seq) - 1):
        lg, cache = step(ref_params(), cache,
                         jnp.asarray([[seq[t]]], jnp.int32),
                         jnp.asarray(t, jnp.int32))
        if t >= len(prompt) - 1:
            top2 = np.sort(np.asarray(lg[0], np.float32))[-2:]
            margins.append(top2[1] - top2[0])
            scale = max(scale, float(jnp.abs(lg).max()))
    return np.array(margins), scale


def test_bf16_serve_engine_matches_reference():
    """`ServeEngine` on its default backend serves a bf16 model (no
    TypeError), and its tokens equal the reference engine's where the
    reference's margin is wider than the bf16 tolerance."""
    ref = RefServeEngine(ref_config(), params=ref_params(), batch_size=3,
                         max_seq=64)
    want = ref.run(_requests(RefRequest))
    cfg = port_config()
    port = ServeEngine(cfg, port_params(cfg), batch_size=3, max_seq=64,
                       device="cpu")
    assert port.backend == "cuda"
    got = port.run(_requests(Request))
    assert [r.uid for r in got] == [r.uid for r in want]
    compared = 0
    for g, w in zip(got, want):
        assert g.done and len(g.output) == len(w.output) == 8
        margins, scale = _ref_margins(w.prompt, w.output)
        for i, margin in enumerate(margins):
            if margin <= 2 * LOGIT_TOL * scale:
                break
            assert g.output[i] == w.output[i], (g.uid, i)
            compared += 1
    assert compared >= 5
