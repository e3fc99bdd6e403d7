"""The port's LLM serving path against the JAX reference, on the CPU.

Reduced configurations of qwen1.5-0.5b (QKV bias, MHA) and smollm-135m
(tied embeddings, GQA 3:1), and of hubert-xlarge and llava-next for the
embeddings entry of `forward`. The reference's seeded parameters are carried
across with `repro_torch.interop.lm_params_from_arrays`; token ids come
from seeded numpy. The port's decode attention runs backend ``cuda``
(on the CPU: the flash-decode kernel's plain version) unless a test says
otherwise.

Tolerances (float32 on both sides, sums in another order):
* logits and the f32 caches: atol = 1e-5·max|reference|, rtol 1e-5
  (measured ≤ 1.1e-6·max over 2 layers);
* int8 caches: codes within 1 and bf16 scales within one bf16 ulp (a
  rounding tie may fall the other way; measured: equal);
* decode == own forward: rtol 2e-3, atol 2e-4, the reference's
  `test_decode_matches_forward`;
* engine tokens: equal wherever the reference's top-2 logit margin
  exceeds 10× the logit tolerance, up to the first step where it does not.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as ref_get_arch
from repro.configs import list_archs as ref_list_archs
from repro.models import model as ref_model
from repro.serve import Request as RefRequest
from repro.serve import ServeEngine as RefServeEngine
from repro_torch import interop
from repro_torch.configs import INPUT_SHAPES, get_arch, list_archs
from repro_torch.kernels import ops
from repro_torch.models import model as M
from repro_torch.serve import Request, ServeEngine

ARCHS = ["qwen1_5_0_5b", "smollm_135m"]
LOGIT_RTOL = 1e-5
DECODE_STEPS = 12


def ref_config(arch, **kw):
    return dataclasses.replace(ref_get_arch(arch).config.reduced(), **kw)


def port_config(arch, **kw):
    return dataclasses.replace(get_arch(arch).config.reduced(), **kw)


@functools.lru_cache(maxsize=None)
def ref_params(arch):
    return ref_model.init_params(ref_config(arch), jax.random.PRNGKey(0))


def port_model(arch, **kw):
    cfg = port_config(arch, **kw)
    arrays = jax.tree.map(np.asarray, ref_params(arch))
    return M.Model(cfg, interop.lm_params_from_arrays(cfg, arrays,
                                                      device="cpu"))


def tokens(arch, b, s, seed=1):
    vocab = ref_config(arch).vocab_size
    return np.random.default_rng(seed).integers(0, vocab, (b, s),
                                                dtype=np.int32)


def assert_logits_close(got, want, err_msg=""):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=LOGIT_RTOL,
                               atol=LOGIT_RTOL * np.abs(want).max(),
                               err_msg=err_msg)


# ---------------------------------------------------------------- configs
@pytest.mark.parametrize("arch", ref_list_archs())
def test_configs_match_reference(arch):
    """The port's registry holds the reference's configurations field for
    field, with the same shape plans and reduced variants."""
    ref, port = ref_get_arch(arch), get_arch(arch)
    assert list_archs() == ref_list_archs()
    assert dataclasses.asdict(port.config) == dataclasses.asdict(ref.config)
    assert (dataclasses.asdict(port.config.reduced())
            == dataclasses.asdict(ref.config.reduced()))
    for field in ("input_kind", "supports_decode", "long_context_mode",
                  "long_context_window"):
        assert getattr(port, field) == getattr(ref, field)
    for shape in INPUT_SHAPES:
        assert port.shape_plan(shape) == ref.shape_plan(shape)


@pytest.mark.parametrize("arch", ref_list_archs())
def test_param_counts_match_reference(arch):
    ref_cfg, cfg = ref_get_arch(arch).config, get_arch(arch).config
    assert M.analytic_param_count(cfg) == \
        ref_model.analytic_param_count(ref_cfg)
    assert M.active_param_count(cfg) == ref_model.active_param_count(ref_cfg)


@pytest.mark.parametrize("arch", ARCHS)
def test_init_params_shapes_and_seed(arch):
    cfg = port_config(arch)
    p1 = M.init_params(cfg, torch.Generator().manual_seed(3))
    p2 = M.init_params(cfg, torch.Generator().manual_seed(3))
    assert M.param_count(p1) == M.analytic_param_count(cfg)
    arrays = interop.lm_params_to_arrays(p1)
    ref_shapes = jax.tree.map(np.shape, ref_params(arch))
    assert jax.tree.map(np.shape, arrays) == ref_shapes
    for a, b in zip(jax.tree.leaves(arrays),
                    jax.tree.leaves(interop.lm_params_to_arrays(p2))):
        np.testing.assert_array_equal(a, b)


def test_interop_round_trip_and_shape_check():
    cfg = port_config("qwen1_5_0_5b")
    arrays = jax.tree.map(np.asarray, ref_params("qwen1_5_0_5b"))
    back = interop.lm_params_to_arrays(
        interop.lm_params_from_arrays(cfg, arrays, device="cpu"))
    assert jax.tree.structure(back) == jax.tree.structure(arrays)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(arrays)):
        np.testing.assert_array_equal(a, b)
    bad = dict(arrays, slot0=dict(arrays["slot0"],
                                  wq=arrays["slot0"]["wq"][:, :, :-1]))
    with pytest.raises(ValueError, match="slot0.wq"):
        interop.lm_params_from_arrays(cfg, bad, device="cpu")
    with pytest.raises(ValueError, match="names"):
        interop.lm_params_from_arrays(
            cfg, {k: v for k, v in arrays.items() if k != "lm_head"},
            device="cpu")


DECODING_ARCHS = [a for a in ref_list_archs()
                  if ref_get_arch(a).supports_decode]


@pytest.mark.parametrize("arch", DECODING_ARCHS + ["qwen1_5_0_5b-swa"])
def test_every_decoding_arch_draws_and_decodes(arch):
    """Every decoding architecture of the registry, reduced (and the
    sliding-window variant `launch/specs.py` builds for long context),
    draws its parameters, runs forward, decodes 2 steps with finite
    logits and serves 3 requests through `ServeEngine` in the port."""
    base, _, variant = arch.partition("-")
    cfg = port_config(base)
    if variant:
        cfg = dataclasses.replace(
            cfg, slots=tuple(M.SlotSpec("swa" if s.mixer == "attn"
                                        else s.mixer, s.ffn)
                             for s in cfg.slots), sliding_window=8)
    model = M.Model(cfg, M.init_params(cfg, torch.Generator().manual_seed(0)))
    toks = torch.from_numpy(tokens(base, 2, 4))
    full, _ = model.forward(toks)
    assert torch.isfinite(full).all()
    cache = model.init_cache(2, 8)
    for t in range(2):
        logits, cache = model.decode_step(cache, toks[:, t:t + 1], t)
        assert logits.shape == (2, cfg.vocab_size)
        assert torch.isfinite(logits).all()
    engine = ServeEngine(cfg, model.params, batch_size=2, max_seq=8,
                         device="cpu")
    done = engine.run([Request(uid=i, prompt=toks[i % 2, i:].tolist(),
                               max_new_tokens=2) for i in range(3)])
    assert [len(r.output) for r in done] == [2, 2, 2]


@pytest.mark.parametrize("mixer,ffn", [("conv", "dense"), ("attn", "glu")])
def test_unknown_mixer_or_ffn_raises(mixer, ffn):
    cfg = dataclasses.replace(port_config("qwen1_5_0_5b"),
                              slots=(M.SlotSpec(mixer, ffn),))
    bad = mixer if mixer == "conv" else ffn
    with pytest.raises(ValueError, match=bad):
        M.init_params(cfg, torch.Generator())
    with pytest.raises(ValueError, match=bad):
        M.Model(cfg, {})


# ------------------------------------------------------------ model parity
@pytest.mark.parametrize("arch", ARCHS)
def test_forward_matches_reference(arch):
    toks = tokens(arch, 2, 16)
    want, _ = ref_model.Model(ref_config(arch)).forward(
        ref_params(arch), tokens=jnp.asarray(toks))
    got, aux = port_model(arch).forward(torch.from_numpy(toks))
    assert aux == {}
    assert_logits_close(got.numpy(), want)


@pytest.mark.parametrize("arch", ["hubert_xlarge", "llava_next_mistral_7b"])
def test_forward_with_embeds_matches_reference(arch):
    """The frontends' entry: frame embeddings alone (hubert: encoder,
    bidirectional, gelu MLP) and patch embeddings prepended to tokens
    (llava)."""
    ref_cfg, cfg = ref_config(arch), port_config(arch)
    params = ref_model.init_params(ref_cfg, jax.random.PRNGKey(2))
    port = M.Model(cfg, interop.lm_params_from_arrays(
        cfg, jax.tree.map(np.asarray, params), device="cpu"))
    rng = np.random.default_rng(3)
    embeds = rng.standard_normal((2, 6, cfg.d_model), dtype=np.float32)
    toks = None if arch == "hubert_xlarge" else tokens(arch, 2, 10)
    want, _ = ref_model.Model(ref_cfg).forward(
        params, tokens=None if toks is None else jnp.asarray(toks),
        embeds=jnp.asarray(embeds))
    got, _ = port.forward(None if toks is None else torch.from_numpy(toks),
                          embeds=torch.from_numpy(embeds))
    assert_logits_close(got.numpy(), want)


def _assert_caches_close(got: dict, want: dict):
    for slot, entries in want.items():
        for name, ref in entries.items():
            ref = np.asarray(ref).astype(np.float64)
            port = got[slot][name].double().numpy()
            if name in ("k", "v") and got[slot][name].dtype == torch.int8:
                assert np.abs(port - ref).max() <= 1, (slot, name)
            elif name.endswith("_scale"):
                np.testing.assert_allclose(port, ref, rtol=2.0 ** -8,
                                           err_msg=f"{slot}.{name}")
            else:
                np.testing.assert_allclose(
                    port, ref, rtol=LOGIT_RTOL,
                    atol=LOGIT_RTOL * np.abs(ref).max(),
                    err_msg=f"{slot}.{name}")


@pytest.mark.parametrize("kv_dtype", ["bfloat16", "int8"])
@pytest.mark.parametrize("arch", ARCHS)
def test_decode_steps_match_reference(arch, kv_dtype):
    """12 decode steps: logits at every step and the caches after the last
    against the reference's, with the f32 and the int8 caches."""
    toks = tokens(arch, 2, DECODE_STEPS)
    rm = ref_model.Model(ref_config(arch, kv_cache_dtype=kv_dtype))
    pm = port_model(arch, kv_cache_dtype=kv_dtype)
    rcache, pcache = rm.init_cache(2, 16), pm.init_cache(2, 16)
    step = jax.jit(rm.decode_step)
    ops.reset_launch_counts()
    for t in range(DECODE_STEPS):
        want, rcache = step(ref_params(arch), rcache,
                            jnp.asarray(toks[:, t:t + 1]),
                            jnp.asarray(t, jnp.int32))
        got, pcache = pm.decode_step(pcache, torch.from_numpy(
            toks[:, t:t + 1]), t)
        assert_logits_close(got.numpy(), want, err_msg=f"step {t}")
    assert ops.launch_counts()["flash_decode"] == 0    # CPU: plain version
    _assert_caches_close(pcache, rcache)


@pytest.mark.parametrize("backend", ["cuda", "torch"])
@pytest.mark.parametrize("arch", ARCHS)
def test_decode_matches_own_forward(arch, backend):
    """Teacher-forcing parity inside the port: step-by-step decode ==
    full forward (the reference's `test_decode_matches_forward`)."""
    pm = port_model(arch)
    toks = torch.from_numpy(tokens(arch, 2, 16))
    full, _ = pm.forward(toks)
    cache = pm.init_cache(2, 32)
    for t in range(16):
        lg, cache = pm.decode_step(cache, toks[:, t:t + 1], t,
                                   backend=backend)
        np.testing.assert_allclose(lg.numpy(), full[:, t].numpy(),
                                   rtol=2e-3, atol=2e-4,
                                   err_msg=f"{arch} diverges at t={t}")


def test_decode_backends_agree():
    """The two decode backends give the same logits (the kernel's plain
    version and the chunked attention compute one function)."""
    pm = port_model("smollm_135m")
    toks = torch.from_numpy(tokens("smollm_135m", 2, 10))
    caches = {b: pm.init_cache(2, 16) for b in ("cuda", "torch")}
    for t in range(10):
        out = {}
        for b in caches:
            out[b], caches[b] = pm.decode_step(caches[b], toks[:, t:t + 1],
                                               t, backend=b)
        assert_logits_close(out["cuda"].numpy(), out["torch"].numpy())


# ------------------------------------------------------------------ engine
def _requests(arch, cls, n=5, seed=4):
    rng = np.random.default_rng(seed)
    vocab = ref_config(arch).vocab_size
    return [cls(uid=i, prompt=rng.integers(0, vocab, rng.integers(3, 11))
                .tolist(), max_new_tokens=8) for i in range(n)]


def _ref_margins(arch, prompt, output):
    """The reference's logits along prompt + output (batch of one),
    teacher-forced; returns the top-2 margin and argmax at each generated
    position."""
    rm = ref_model.Model(ref_config(arch))
    step = jax.jit(rm.decode_step)
    cache = rm.init_cache(1, 64)
    seq = list(prompt) + list(output)
    margins, tops = [], []
    for t in range(len(seq) - 1):
        lg, cache = step(ref_params(arch), cache,
                         jnp.asarray([[seq[t]]], jnp.int32),
                         jnp.asarray(t, jnp.int32))
        if t >= len(prompt) - 1:
            top2 = np.sort(np.asarray(lg[0]))[-2:]
            margins.append(top2[1] - top2[0])
            tops.append(int(jnp.argmax(lg[0])))
            scale = float(jnp.abs(lg).max())
    return np.array(margins), tops, scale


@pytest.mark.parametrize("arch", ARCHS)
def test_serve_engine_matches_reference(arch):
    """The port's engine against the reference's on the same prompts and
    weights (5 requests over 3 slots: 2 waves)."""
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
            if margin <= 10 * LOGIT_RTOL * scale:
                break
            assert g.output[i] == w.output[i], (g.uid, i)
            compared += 1
    assert compared >= 20
    assert port.decode_steps > 0 and port.latency.report().count == 5


def test_serve_engine_single_request_matches_sequential_decode():
    """The invariant of `tests/test_serve_engine.py` on the port: one
    request through the engine == sequential greedy decode_step calls."""
    engine = ServeEngine(port_config("qwen1_5_0_5b"), batch_size=3,
                         max_seq=64, seed=0, device="cpu")
    prompt = [5, 17, 256, 3]
    model = engine.model
    cache = model.init_cache(engine.batch_size, engine.max_seq)
    want = []
    for t in range(len(prompt) + 8 - 1):
        cur = prompt[t] if t < len(prompt) else want[-1]
        toks = torch.zeros((engine.batch_size, 1), dtype=torch.long)
        toks[0, 0] = cur
        logits, cache = model.decode_step(cache, toks, t)
        if t >= len(prompt) - 1:
            want.append(int(logits[0].argmax()))
    [req] = engine.run([Request(uid=0, prompt=prompt, max_new_tokens=8)])
    assert req.done and req.output == want
    assert engine.decode_steps == len(prompt) + 8 - 1


def test_serve_engine_is_deterministic_and_stops_at_eos():
    engine = ServeEngine(port_config("smollm_135m"), batch_size=3,
                         max_seq=64, seed=1, device="cpu")
    first = engine.run(_requests("smollm_135m", Request, n=7))
    again = engine.run(_requests("smollm_135m", Request, n=7))
    assert [r.output for r in first] == [r.output for r in again]
    assert all(r.done and len(r.output) == 8 for r in first)
    eos = first[0].output[2]
    [stopped] = engine.run([Request(uid=9, prompt=first[0].prompt,
                                    max_new_tokens=8, eos_id=eos)])
    assert stopped.output == first[0].output[:first[0].output.index(eos)
                                              + 1]


def test_serve_engine_rejects_unknown_backend():
    with pytest.raises(ValueError, match="backend"):
        ServeEngine(port_config("smollm_135m"), device="cpu",
                    backend="pallas")
