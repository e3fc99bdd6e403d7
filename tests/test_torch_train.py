"""The port's training path (`repro_torch.train`, `repro_torch.data.tokens`)
against the reference's (`repro.train`, `repro.data.tokens`) on the CPU.

Every architecture runs at its ``reduced()`` size on the reference's
smoke batches (`tests/test_arch_smoke.py::_smoke_batch`: the audio
encoder's ``loss_mask``, the VLM's ``embeds``), from the reference's
train state carried across with `repro_torch.interop`: the dense, VLM
and audio ones here, the MoE, Mamba and RWKV ones in
`tests/test_torch_train_mixers.py`. The reference side is computed once
per architecture (one jit of its loss and gradients).

Tolerances (float32: the loss is float32 whatever the model's dtype):

* loss and ``ce_loss`` rtol 1e-6, the MoE aux losses rtol 1e-5 (the
  forward's sums run in another order; 1e-5 is the LLM path's own);
* each gradient leaf within 1e-4 of its max |g| (3e-6 on every
  architecture but jamba, whose Mamba scan's exp/cumsum chain gives
  5e-5);
* ``grad_norm`` rtol 1e-5, ``lr`` rtol 1e-7 (both sides' float32
  schedule);
* the parameters after one step: AdamW's first step moves an element by
  ≈ lr·sign(g), so an element whose gradient is near 0 may flip sign
  between the two frameworks and move by up to 2·lr; every element lies
  within that bound, and all but 0.1% within 1e-6;
* `adamw_update` on identical parameters, gradients and state: rtol
  1e-6 in float32, and one bfloat16 ulp (2⁻⁸) for bfloat16 moments.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as ref_get_arch
from repro.configs import list_archs
from repro.data import tokens as ref_tokens
from repro.models import model as ref_model
from repro.train import optim as ref_optim
from repro.train import step as ref_step
from repro_torch import interop
from repro_torch.configs import get_arch
from repro_torch.data import tokens
from repro_torch.models import model as M
from repro_torch.train import optim, step
from test_arch_smoke import _smoke_batch

ARCHS = list_archs()
DENSE_ARCHS = ["qwen1_5_0_5b", "llava_next_mistral_7b", "hubert_xlarge",
               "granite_3_8b", "smollm_135m", "qwen1_5_32b"]
MIXER_ARCHS = ["rwkv6_7b", "deepseek_moe_16b", "jamba_1_5_large_398b",
               "phi3_5_moe_42b"]
OPT = dict(total_steps=10, warmup_steps=2)
LOSS_RTOL = 1e-6
AUX_RTOL = 1e-5
GRAD_TOL = 1e-4
NORM_RTOL = 1e-5
LR_RTOL = 1e-7
PARAM_TIGHT = 1e-6
PARAM_TIGHT_SHARE = 0.999
ADAM_RTOL = {"float32": 1e-6, "bfloat16": 2.0 ** -8}


def assert_close(got, want, tol, err_msg=""):
    """|got − want| ≤ tol·|want| + tol·max|want|."""
    got = got.double().numpy() if isinstance(got, torch.Tensor) \
        else np.asarray(got, dtype=np.float64)
    want = np.asarray(want, dtype=np.float64)
    np.testing.assert_allclose(got, want, rtol=tol,
                               atol=tol * np.abs(want).max(),
                               err_msg=err_msg)


def tree_items(tree, prefix=""):
    """(dotted path, leaf) pairs of a nested dict, sorted."""
    for key in sorted(tree):
        if isinstance(tree[key], dict):
            yield from tree_items(tree[key], f"{prefix}{key}.")
        else:
            yield f"{prefix}{key}", tree[key]


def leaf(tree, path):
    for key in path.split("."):
        tree = tree[key]
    return tree


def as_numpy(tree):
    return jax.tree.map(np.asarray, tree)


# ------------------------------------------------------------------- tokens
@pytest.mark.parametrize("kw", [
    dict(vocab_size=1024, batch_size=2, seq_len=32),
    dict(vocab_size=151936, batch_size=3, seq_len=130, seed=5),
    dict(vocab_size=500, batch_size=4, seq_len=100, seed=2, zipf_a=1.05,
         copy_period=20, copy_len=7),
])
def test_token_batches_bit_equal_to_reference(kw):
    got = tokens.SyntheticTokenPipeline(tokens.TokenPipelineConfig(**kw))
    want = ref_tokens.SyntheticTokenPipeline(
        ref_tokens.TokenPipelineConfig(**kw))
    for g, w in zip(got.batches(3), want.batches(3), strict=True):
        assert set(g) == set(w) == {"tokens", "targets"}
        for k in g:
            assert g[k].dtype == w[k].dtype == np.int32
            np.testing.assert_array_equal(g[k], w[k])


# -------------------------------------------------------------------- AdamW
def _adam_tree(rng):
    return {"a": rng.standard_normal((7, 5)).astype(np.float32),
            "z": {"w": rng.standard_normal((3, 4, 6)).astype(np.float32),
                  "b": rng.standard_normal((6,)).astype(np.float32)}}


def _to_port(tree, dtype=None):
    def conv(a):
        a = np.asarray(a)
        t = torch.from_numpy(np.array(a.astype(np.float32)
                                      if a.dtype.name == "bfloat16" else a))
        return t if dtype is None else t.to(dtype)
    return jax.tree.map(conv, tree)


@pytest.mark.parametrize("step_no", [0, 1, 2, 5, 40, 99, 100, 101, 5000,
                                     9999, 20000])
def test_schedule_matches_reference(step_no):
    cfg = optim.AdamWConfig(warmup_steps=100, total_steps=10000)
    ref_cfg = ref_optim.AdamWConfig(warmup_steps=100, total_steps=10000)
    want = ref_optim._schedule(ref_cfg, jnp.asarray(step_no, jnp.int32))
    got = optim._schedule(cfg, torch.tensor(step_no, dtype=torch.int32))
    assert got.dtype == torch.float32 and want.dtype == jnp.float32
    assert_close(got, np.asarray(want), LR_RTOL)


def test_global_norm_matches_reference():
    tree = _adam_tree(np.random.default_rng(3))
    want = ref_optim.global_norm(jax.tree.map(jnp.asarray, tree))
    got = optim.global_norm(_to_port(tree))
    assert got.dtype == torch.float32
    assert_close(got, np.asarray(want), 1e-6)


@pytest.mark.parametrize("moment_dtype", ["float32", "bfloat16"])
def test_adamw_update_matches_reference_on_identical_inputs(moment_dtype):
    """Three updates; each starts both sides from the reference's
    parameters and state and feeds both the same gradients (scaled so
    the first clips and the others do not)."""
    kw = dict(warmup_steps=2, total_steps=10, moment_dtype=moment_dtype)
    cfg, ref_cfg = optim.AdamWConfig(**kw), ref_optim.AdamWConfig(**kw)
    rng = np.random.default_rng(7)
    params = jax.tree.map(jnp.asarray, _adam_tree(rng))
    state = ref_optim.adamw_init(ref_cfg, params)
    mdt = getattr(torch, moment_dtype)
    for update, scale in enumerate((10.0, 0.05, 0.2)):
        grads = jax.tree.map(lambda a: jnp.asarray(a * scale),
                             _adam_tree(rng))
        p_port = _to_port(as_numpy(params))
        s_port = {"m": _to_port(as_numpy(state["m"]), mdt),
                  "v": _to_port(as_numpy(state["v"]), mdt),
                  "step": torch.tensor(int(state["step"]),
                                       dtype=torch.int32)}
        got_p, got_s, got_m = optim.adamw_update(
            cfg, p_port, _to_port(as_numpy(grads)), s_port)
        params, state, metrics = ref_optim.adamw_update(ref_cfg, params,
                                                        grads, state)
        assert got_p is p_port and got_s is s_port        # in place
        assert int(got_s["step"]) == int(state["step"]) == update + 1
        assert_close(got_m["grad_norm"], np.asarray(metrics["grad_norm"]),
                     1e-6)
        assert_close(got_m["lr"], np.asarray(metrics["lr"]), LR_RTOL)
        for path, want in tree_items(as_numpy(params)):
            assert_close(leaf(got_p, path), want, ADAM_RTOL["float32"],
                         err_msg=f"update {update} param {path}")
        for name in ("m", "v"):
            for path, want in tree_items(as_numpy(state[name])):
                got = leaf(got_s[name], path)
                assert got.dtype == mdt
                assert_close(got.float(), np.asarray(want, np.float32),
                             ADAM_RTOL[moment_dtype],
                             err_msg=f"update {update} {name} {path}")


def test_adamw_init_matches_reference_layout():
    cfg = optim.AdamWConfig(moment_dtype="bfloat16")
    tree = _to_port(_adam_tree(np.random.default_rng(0)))
    state = optim.adamw_init(cfg, tree)
    assert set(state) == {"m", "v", "step"}
    assert state["step"].dtype == torch.int32 and int(state["step"]) == 0
    for name in ("m", "v"):
        for path, t in tree_items(state[name]):
            assert t.dtype == torch.bfloat16 and not t.any()
            assert t.shape == leaf(tree, path).shape


# ------------------------------------------------- the ten architectures
@functools.lru_cache(maxsize=None)
def reference(arch):
    """The reference's train state, smoke batch, loss and metrics,
    gradients (one jit of ``jax.value_and_grad(lm_loss)``), and one train
    step's parameters and metrics as its `make_train_step` forms them
    from those: `adamw_update` on the gradients, the metrics
    ``{**metrics, **opt_metrics, "loss": loss}``
    (`test_reference_train_step_is_value_and_grad_then_adamw` holds this
    to the jitted `make_train_step`), as numpy arrays."""
    spec = ref_get_arch(arch)
    cfg = spec.config.reduced()
    opt = ref_optim.AdamWConfig(**OPT)
    state = ref_step.train_state_init(cfg, opt, jax.random.PRNGKey(0))
    batch = _smoke_batch(spec, cfg, jax.random.PRNGKey(1))
    model = ref_model.Model(cfg)
    (loss, metrics), grads = jax.jit(jax.value_and_grad(
        lambda p, b: ref_step.lm_loss(model, p, b), has_aux=True))(
            state.params, batch)
    new_params, _, opt_metrics = jax.jit(functools.partial(
        ref_optim.adamw_update, opt))(state.params, grads, state.opt)
    return dict(state=as_numpy({"params": state.params, "opt": state.opt}),
                batch=as_numpy(batch), loss=float(loss),
                metrics=as_numpy(metrics), grads=as_numpy(grads),
                new_params=as_numpy(new_params),
                step_metrics=as_numpy({**metrics, **opt_metrics,
                                       "loss": loss}))


def port_setup(arch, **overrides):
    """The port's config, a fresh train state carried from the
    reference's, and the batch as tensors."""
    ref = reference(arch)
    cfg = dataclasses.replace(get_arch(arch).config.reduced(), **overrides)
    state = interop.train_state_from_arrays(
        cfg, optim.AdamWConfig(**OPT), ref["state"], device="cpu")
    batch = {k: torch.from_numpy(np.array(v)) for k, v in
             ref["batch"].items()}
    return cfg, state, batch


def test_port_configs_equal_the_reference_field_for_field():
    for arch in ARCHS:
        got = dataclasses.asdict(get_arch(arch).config.reduced())
        want = dataclasses.asdict(ref_get_arch(arch).config.reduced())
        assert got == want, arch


def test_the_two_files_cover_every_architecture():
    assert sorted(DENSE_ARCHS + MIXER_ARCHS) == sorted(ARCHS)


def test_reference_train_step_is_value_and_grad_then_adamw():
    """`reference` forms the reference's train step from its gradients
    and `adamw_update`, as `repro.train.step.make_train_step` does; the
    jitted `make_train_step` gives the same parameters and metrics."""
    arch = "qwen1_5_0_5b"
    ref = reference(arch)
    spec = ref_get_arch(arch)
    cfg = spec.config.reduced()
    opt = ref_optim.AdamWConfig(**OPT)
    state = ref_step.train_state_init(cfg, opt, jax.random.PRNGKey(0))
    new, metrics = jax.jit(ref_step.make_train_step(cfg, opt))(
        state, _smoke_batch(spec, cfg, jax.random.PRNGKey(1)))
    assert set(metrics) == set(ref["step_metrics"])
    for key, want in ref["step_metrics"].items():
        assert_close(np.asarray(metrics[key]), want, LOSS_RTOL,
                     err_msg=key)
    for path, want in tree_items(ref["new_params"]):
        assert_close(np.asarray(leaf(new.params, path)), want, 1e-6,
                     err_msg=path)


def check_lm_loss_and_metrics(arch):
    ref = reference(arch)
    cfg, state, batch = port_setup(arch)
    with torch.no_grad():
        loss, metrics = step.lm_loss(M.Model(cfg, state.params),
                                     state.params, batch)
    assert loss.dtype == torch.float32
    assert_close(loss, ref["loss"], LOSS_RTOL)
    assert set(metrics) == set(ref["metrics"])
    assert ("load_balance_loss" in metrics) == bool(cfg.moe_num_experts)
    for key, want in ref["metrics"].items():
        assert_close(metrics[key], want,
                     LOSS_RTOL if key == "ce_loss" else AUX_RTOL,
                     err_msg=key)


def check_gradients(arch):
    ref = reference(arch)
    cfg, state, batch = port_setup(arch)
    loss, _, grads = step.loss_and_grads(M.Model(cfg, state.params),
                                         state.params, batch)
    assert_close(loss, ref["loss"], LOSS_RTOL)
    want = dict(tree_items(ref["grads"]))
    got = dict(tree_items(grads))
    assert set(got) == set(want)
    for path, w in want.items():
        assert got[path].shape == w.shape and not got[path].requires_grad
        assert_close(got[path], w, GRAD_TOL, err_msg=f"{arch} {path}")
    for path, p in tree_items(state.params):
        assert not p.requires_grad, path


def check_train_step(arch):
    ref = reference(arch)
    cfg, state, batch = port_setup(arch)
    state, metrics = step.make_train_step(cfg, optim.AdamWConfig(**OPT))(
        state, batch)
    want = ref["step_metrics"]
    assert set(metrics) == set(want)
    for key, w in want.items():
        assert isinstance(metrics[key], torch.Tensor), key
    assert_close(metrics["loss"], want["loss"], LOSS_RTOL)
    assert_close(metrics["grad_norm"], want["grad_norm"], NORM_RTOL)
    assert_close(metrics["lr"], want["lr"], LR_RTOL)
    assert int(state.step) == int(state.opt["step"]) == 1
    bound = 2 * float(want["lr"]) * (1 + 1e-3)
    tight, total = 0, 0
    for path, w in tree_items(ref["new_params"]):
        err = np.abs(leaf(state.params, path).double().numpy()
                     - w.astype(np.float64))
        assert err.max() <= bound, (path, err.max(), bound)
        tight += int((err <= PARAM_TIGHT).sum())
        total += err.size
    assert tight >= PARAM_TIGHT_SHARE * total, (tight, total)


def check_reduced_train_step(arch):
    """The reference's `test_reduced_train_step` invariants on the port:
    finite loss, grad_norm > 0, parameters changed."""
    cfg, state, batch = port_setup(arch)
    before = {p: t.clone() for p, t in tree_items(state.params)}
    state, metrics = step.make_train_step(cfg, optim.AdamWConfig(**OPT))(
        state, batch)
    assert torch.isfinite(metrics["loss"])
    assert float(metrics["grad_norm"]) > 0
    changed = [p for p, t in tree_items(state.params)
               if not torch.equal(t, before[p])]
    assert "embed" in changed and len(changed) >= len(before) // 2


def check_remat_bits(arch):
    _, state, batch = port_setup(arch)
    runs = []
    for remat in (True, False):
        cfg, _, _ = port_setup(arch, remat=remat)
        runs.append(step.loss_and_grads(M.Model(cfg, state.params),
                                        state.params, batch))
    assert torch.equal(runs[0][0], runs[1][0])
    for (path, a), (_, b) in zip(tree_items(runs[0][2]),
                                 tree_items(runs[1][2])):
        assert torch.equal(a, b), path


# the dense, VLM and audio architectures here; the MoE, Mamba and RWKV
# ones in tests/test_torch_train_mixers.py (a second file, so two
# workers share the reference's compiles)
@pytest.mark.parametrize("arch", DENSE_ARCHS)
def test_lm_loss_and_metrics_match_reference(arch):
    check_lm_loss_and_metrics(arch)


@pytest.mark.parametrize("arch", DENSE_ARCHS)
def test_gradients_match_jax_grad(arch):
    check_gradients(arch)


@pytest.mark.parametrize("arch", DENSE_ARCHS)
def test_train_step_matches_reference(arch):
    check_train_step(arch)


@pytest.mark.parametrize("arch", DENSE_ARCHS)
def test_reduced_train_step(arch):
    check_reduced_train_step(arch)


@pytest.mark.parametrize("arch", DENSE_ARCHS)
def test_remat_on_and_off_give_the_same_bits(arch):
    check_remat_bits(arch)


def test_remat_checkpoints_each_group(monkeypatch):
    """With cfg.remat and gradients recorded, forward runs each layer
    group through torch.utils.checkpoint; without either, never."""
    calls = []
    real = M.checkpoint

    def counting(fn, *args, **kw):
        calls.append(kw.get("use_reentrant"))
        return real(fn, *args, **kw)

    monkeypatch.setattr(M, "checkpoint", counting)
    for remat, grad, want in ((True, True, 2), (True, False, 0),
                              (False, True, 0)):
        cfg, state, batch = port_setup("qwen1_5_0_5b", remat=remat)
        calls.clear()
        with torch.set_grad_enabled(grad):
            step.lm_loss(M.Model(cfg, state.params), state.params, batch)
        assert calls == [False] * want, (remat, grad)
    assert cfg.num_groups == 2


def test_in_place_update_reaches_decode_and_forward_of_a_bound_model():
    """The decode step's per-layer views are detached aliases made once:
    after a train step updates the parameters in place, a model built
    before the step decodes and forwards with the new values, the same
    bits as a model built after it."""
    cfg, state, batch = port_setup("qwen1_5_0_5b")
    old = M.Model(cfg, state.params)
    toks = batch["tokens"][:, :4]
    state, _ = step.make_train_step(cfg, optim.AdamWConfig(**OPT))(state,
                                                                   batch)
    new = M.Model(cfg, state.params)
    with torch.inference_mode():
        ca, cb = old.init_cache(2, 8), new.init_cache(2, 8)
        for t in range(4):
            la, ca = old.decode_step(ca, toks[:, t:t + 1], t)
            lb, cb = new.decode_step(cb, toks[:, t:t + 1], t)
            assert torch.equal(la, lb)
        assert torch.equal(old.forward(toks)[0], new.forward(toks)[0])


def test_prefill_and_serve_step_match_the_model():
    cfg, state, batch = port_setup("qwen1_5_0_5b")
    model = M.Model(cfg, state.params)
    logits = step.make_prefill(cfg)(state.params, batch)
    assert not logits.requires_grad
    assert torch.equal(logits, model.forward(batch["tokens"])[0].detach())
    serve = step.make_serve_step(cfg)
    ca, cb = model.init_cache(2, 8), model.init_cache(2, 8)
    toks = batch["tokens"]
    with torch.inference_mode():
        for t in range(3):
            la, ca = serve(state.params, ca, toks[:, t:t + 1], t)
            lb, cb = model.decode_step(cb, toks[:, t:t + 1], t)
            assert torch.equal(la, lb)


def test_train_state_init_draws_on_the_generator_device():
    cfg = get_arch("smollm_135m").config.reduced()
    opt = optim.AdamWConfig(moment_dtype="bfloat16")
    state = step.train_state_init(cfg, opt, torch.Generator().manual_seed(3),
                                  device="cpu")
    again = step.train_state_init(cfg, opt, torch.Generator().manual_seed(3),
                                  device="cpu")
    assert int(state.step) == 0
    for (path, a), (_, b) in zip(tree_items(state.params),
                                 tree_items(again.params)):
        assert torch.equal(a, b), path
        assert leaf(state.opt["m"], path).dtype == torch.bfloat16
    with pytest.raises(ValueError, match="generator"):
        step.train_state_init(cfg, opt, torch.Generator(), device="meta")
