"""The port's checkpoints, train loop and train launcher against the
reference's (`repro.train.checkpoint`, `repro.train.loop`,
`repro.launch.train`) on the CPU.

Checkpoints are compared byte for byte: the same tree (nested dicts in
unsorted insertion order, lists, tuples, scalars, float32, int32,
bfloat16 and other arrays, a train state) saved by both packages gives
the same file, and each package loads the other's file to the same
bits. The loop's history is held to the reference's over 5 steps from
the same state and batches: the same keys and logged steps, the loss
within rtol 1e-4 (after the first step AdamW moves an element whose
gradient is near 0 by up to 2·lr in either direction, see
`tests/test_torch_train.py`; the loss of step 1 is the one-step loss,
rtol 1e-6).
"""
import os
import re

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.configs import get_arch as ref_get_arch
from repro.data import tokens as ref_tokens
from repro.train import checkpoint as ref_ckpt
from repro.train import loop as ref_loop
from repro.train import optim as ref_optim
from repro.train import step as ref_step
from repro_torch import interop
from repro_torch.configs import get_arch
from repro_torch.data import tokens
from repro_torch.launch import train as train_cli
from repro_torch.train import checkpoint, loop, optim

LOOP_STEPS = 5
LOOP_LOSS_RTOL = 1e-4
FIRST_LOSS_RTOL = 1e-6


def _arrays(seed=0):
    rng = np.random.default_rng(seed)
    return dict(
        f32=rng.standard_normal((3, 4)).astype(np.float32),
        i32=rng.integers(-1000, 1000, (5,)).astype(np.int32),
        bf16=rng.standard_normal((2, 3)).astype(np.float32),
        zero_d=np.asarray(2.5, np.float32),
        empty=np.zeros((0, 3), np.float32),
        big=rng.standard_normal((70, 300)).astype(np.float32),  # bin32
        f64=rng.standard_normal((4,)),
        i8=rng.integers(-100, 100, (6,)).astype(np.int8),
        mask=rng.random((3,)) < 0.5,
        count=np.asarray(7, np.int32))


def _tree(arr, bf16):
    """A tree of every kind the format holds; dict keys inserted out of
    order."""
    return {"z": {"b": arr["f32"], "a": [1, -40, 300, 70000, -2 ** 40, 2.5,
                                         True, None, "txt", -1e300],
                  "t": (arr["i32"], {"y": 1, "x": 2.0})},
            "a": bf16, "m": arr["zero_d"], "empty": arr["empty"],
            "big": arr["big"], "f64": arr["f64"], "i8": arr["i8"],
            "mask": arr["mask"], "s": {"count": arr["count"]}}


def ref_tree(seed=0):
    arr = _arrays(seed)
    out = _tree({k: jnp.asarray(v) for k, v in arr.items()},
                jnp.asarray(arr["bf16"], jnp.bfloat16))
    return out


def port_tree(seed=0):
    arr = _arrays(seed)
    return _tree({k: torch.from_numpy(np.array(v)) for k, v in arr.items()},
                 torch.from_numpy(arr["bf16"]).to(torch.bfloat16))


def _bits(x):
    """A leaf as comparable bits: numpy bytes of an array (bfloat16 as
    its uint16 view), the value of a scalar."""
    if isinstance(x, torch.Tensor):
        if x.dtype == torch.bfloat16:
            x = x.view(torch.int16)
        return ("arr", tuple(x.shape), x.numpy().tobytes())
    if isinstance(x, (np.ndarray, jax.Array)):
        x = np.asarray(x)
        if x.dtype == ml_dtypes.bfloat16:
            x = x.view(np.int16)
        return ("arr", x.shape, x.tobytes())
    return x


def assert_same_bits(got, want, path="tree"):
    if isinstance(want, dict):
        assert isinstance(got, dict) and set(got) == set(want), path
        for k in want:
            assert_same_bits(got[k], want[k], f"{path}.{k}")
    elif isinstance(want, (list, tuple)):
        assert type(got) is type(want) and len(got) == len(want), path
        for i, (g, w) in enumerate(zip(got, want)):
            assert_same_bits(g, w, f"{path}[{i}]")
    else:
        assert _bits(got) == _bits(want), path


def _read(path):
    with open(path, "rb") as f:
        return f.read()


# -------------------------------------------------------------- the bytes
@pytest.mark.parametrize("step", [None, 0, 7, 300, 2 ** 33])
def test_port_bytes_equal_reference_bytes(tmp_path, step):
    a = checkpoint.save_checkpoint(str(tmp_path / "port" / "ck"),
                                   port_tree(), step=step)
    b = ref_ckpt.save_checkpoint(str(tmp_path / "ref" / "ck"), ref_tree(),
                                 step=step)
    assert _read(a) == _read(b)


def _train_states(moment_dtype):
    """The reference's reduced qwen1.5-0.5b train state and the port's
    carried from it, as checkpoint trees."""
    cfg = ref_get_arch("qwen1_5_0_5b").config.reduced()
    kw = dict(moment_dtype=moment_dtype)
    ref = ref_step.train_state_init(cfg, ref_optim.AdamWConfig(**kw),
                                    jax.random.PRNGKey(0))
    port = interop.train_state_from_arrays(
        get_arch("qwen1_5_0_5b").config.reduced(), optim.AdamWConfig(**kw),
        jax.tree.map(np.asarray, {"params": ref.params, "opt": ref.opt}),
        device="cpu")
    return ({"params": ref.params, "opt": ref.opt},
            {"params": port.params, "opt": port.opt})


@pytest.mark.parametrize("moment_dtype", ["float32", "bfloat16"])
def test_train_state_bytes_equal_reference_bytes(tmp_path, moment_dtype):
    ref, port = _train_states(moment_dtype)
    a = checkpoint.save_checkpoint(str(tmp_path / "port"), port, step=3)
    b = ref_ckpt.save_checkpoint(str(tmp_path / "ref"), ref, step=3)
    assert _read(a) == _read(b)
    assert port["opt"]["m"]["embed"].dtype == getattr(torch, moment_dtype)


def test_reference_loads_a_port_file_bit_for_bit(tmp_path):
    path = checkpoint.save_checkpoint(str(tmp_path / "ck"), port_tree(),
                                      step=11)
    tree, step = ref_ckpt.load_checkpoint(path)
    assert step == 11
    assert tree["a"].dtype == jnp.bfloat16
    assert_same_bits(tree, port_tree())


def test_port_loads_a_reference_file_bit_for_bit(tmp_path):
    path = ref_ckpt.save_checkpoint(str(tmp_path / "ck"), ref_tree(seed=4))
    tree, step = checkpoint.load_checkpoint(path, device="cpu")
    assert step is None
    assert tree["a"].dtype == torch.bfloat16
    assert tree["z"]["a"] == [1, -40, 300, 70000, -2 ** 40, 2.5, True, None,
                              "txt", -1e300]
    assert isinstance(tree["z"]["t"], tuple)
    assert_same_bits(tree, port_tree(seed=4))


@pytest.mark.parametrize("moment_dtype", ["float32", "bfloat16"])
def test_train_state_round_trips_both_ways(tmp_path, moment_dtype):
    ref, port = _train_states(moment_dtype)
    path = checkpoint.save_checkpoint(str(tmp_path / "p"), port, step=1)
    got, _ = ref_ckpt.load_checkpoint(path)
    assert_same_bits(got, ref)
    path = ref_ckpt.save_checkpoint(str(tmp_path / "r"), ref, step=1)
    got, step = checkpoint.load_checkpoint(path, device="cpu")
    assert step == 1
    assert_same_bits(got, port)


def test_save_overwrites_atomically(tmp_path, monkeypatch):
    path = str(tmp_path / "ck")
    checkpoint.save_checkpoint(path, {"a": torch.zeros(3)}, step=1)
    checkpoint.save_checkpoint(path, {"a": torch.ones(3)}, step=2)
    assert os.listdir(tmp_path) == ["ck"]
    tree, step = checkpoint.load_checkpoint(path, device="cpu")
    assert step == 2 and torch.equal(tree["a"], torch.ones(3))
    before = _read(path)

    def broken(write, obj):
        write(b"\x82partial")
        raise OSError("disk full")

    monkeypatch.setattr(checkpoint, "_pack", broken)
    with pytest.raises(OSError, match="disk full"):
        checkpoint.save_checkpoint(path, {"a": torch.full((3,), 5.0)})
    assert _read(path) == before          # the old checkpoint is intact


def test_load_refuses_what_is_not_a_checkpoint(tmp_path):
    path = tmp_path / "x"
    path.write_bytes(b"\x81\xa3abc\x01")
    with pytest.raises(ValueError, match="not a checkpoint"):
        checkpoint.load_checkpoint(str(path), device="cpu")
    path.write_bytes(b"\x81\xa4tree\xc4\x05ab")
    with pytest.raises(ValueError, match="truncated"):
        checkpoint.load_checkpoint(str(path), device="cpu")
    with pytest.raises(TypeError, match="cannot checkpoint"):
        checkpoint.save_checkpoint(str(tmp_path / "y"), {"a": object()})


def test_train_state_arrays_round_trip():
    ref, _ = _train_states("bfloat16")
    arrays = jax.tree.map(np.asarray, ref)
    cfg = get_arch("qwen1_5_0_5b").config.reduced()
    opt = optim.AdamWConfig(moment_dtype="bfloat16")
    state = interop.train_state_from_arrays(cfg, opt, arrays, device="cpu")
    back = interop.train_state_to_arrays(state)
    assert int(back["step"]) == 0 and back["opt"]["step"].dtype == np.int32
    for part in ("params", "opt"):
        jax.tree.map(lambda g, w: np.testing.assert_array_equal(
            g, np.asarray(w, np.float32) if w.dtype == ml_dtypes.bfloat16
            else w), back[part], arrays[part])
    bad = jax.tree.map(np.asarray, ref)
    bad["opt"]["m"]["embed"] = bad["opt"]["m"]["embed"][:-1]
    with pytest.raises(ValueError, match="moment"):
        interop.train_state_from_arrays(cfg, opt, bad, device="cpu")


# ------------------------------------------------------------------ loop
def _loop_inputs():
    cfg = ref_get_arch("smollm_135m").config.reduced()
    opt_kw = dict(total_steps=LOOP_STEPS, warmup_steps=2)
    ref_state = ref_step.train_state_init(cfg, ref_optim.AdamWConfig(
        **opt_kw), jax.random.PRNGKey(0))
    pipe_kw = dict(vocab_size=cfg.vocab_size, batch_size=2, seq_len=32)
    return cfg, opt_kw, ref_state, pipe_kw


def test_train_loop_history_matches_reference(tmp_path):
    cfg, opt_kw, ref_state, pipe_kw = _loop_inputs()
    want_lines, got_lines = [], []
    _, want = ref_loop.train_loop(
        cfg, ref_optim.AdamWConfig(**opt_kw), iter(
            ref_tokens.SyntheticTokenPipeline(
                ref_tokens.TokenPipelineConfig(**pipe_kw))),
        LOOP_STEPS, log_every=2, log_fn=want_lines.append, state=ref_state)
    pcfg = get_arch("smollm_135m").config.reduced()
    popt = optim.AdamWConfig(**opt_kw)
    state = interop.train_state_from_arrays(
        pcfg, popt, jax.tree.map(np.asarray, {"params": ref_state.params,
                                              "opt": ref_state.opt}),
        device="cpu")
    ck = str(tmp_path / "ck")
    state, got = loop.train_loop(
        pcfg, popt, iter(tokens.SyntheticTokenPipeline(
            tokens.TokenPipelineConfig(**pipe_kw))),
        LOOP_STEPS, log_every=2, log_fn=got_lines.append, state=state,
        ckpt_path=ck, ckpt_every=LOOP_STEPS)
    assert [h["step"] for h in got] == [h["step"] for h in want] == [1, 2, 4]
    for g, w in zip(got, want):
        assert set(g) == set(w)
        assert all(isinstance(v, (int, float)) for v in g.values())
        rtol = FIRST_LOSS_RTOL if g["step"] == 1 else LOOP_LOSS_RTOL
        for key in ("loss", "ce_loss", "grad_norm"):
            np.testing.assert_allclose(g[key], w[key], rtol=rtol,
                                       err_msg=f"step {g['step']} {key}")
        np.testing.assert_allclose(g["lr"], w["lr"], rtol=1e-7)
    line = re.compile(r"step +\d+  loss \d+\.\d{4}  gnorm \d+\.\d{2}  lr "
                      r"\d\.\d{2}e-\d{2}  \(\d+\.\ds\)")
    assert len(got_lines) == len(want_lines) == 3
    assert all(line.fullmatch(s) for s in got_lines + want_lines)
    # the checkpoint of step 5: {"params", "opt"}, loadable by both
    tree, step = checkpoint.load_checkpoint(ck, device="cpu")
    assert step == LOOP_STEPS and set(tree) == {"params", "opt"}
    assert_same_bits(tree, {"params": state.params, "opt": state.opt})
    ref_tree_, ref_step_no = ref_ckpt.load_checkpoint(ck)
    assert ref_step_no == LOOP_STEPS
    assert_same_bits(ref_tree_, tree)


def test_train_loop_draws_its_own_state_from_the_seed():
    cfg = get_arch("smollm_135m").config.reduced()
    opt = optim.AdamWConfig(total_steps=2, warmup_steps=1)
    pipe = tokens.TokenPipelineConfig(vocab_size=cfg.vocab_size,
                                      batch_size=2, seq_len=16)
    runs = [loop.train_loop(cfg, opt, iter(tokens.SyntheticTokenPipeline(
        pipe)), 2, seed=3, log_every=1, log_fn=lambda s: None,
        device="cpu") for _ in range(2)]
    assert runs[0][1][-1]["loss"] == runs[1][1][-1]["loss"]
    assert int(runs[0][0].step) == 2


# -------------------------------------------------------------- launcher
def test_launcher_trains_on_the_cpu(capsys):
    history = train_cli.main(["--arch", "smollm_135m", "--steps", "3",
                              "--batch", "2", "--seq", "16",
                              "--device", "cpu"])
    out = capsys.readouterr().out.splitlines()
    assert out[0] == ("arch=smollm-135m layers=2 d=256 vocab=1024 "
                      "(reduced)")
    assert re.fullmatch(r"loss \d+\.\d{4} → \d+\.\d{4} \(-?\d+\.\d% "
                        r"reduction\)", out[-1])
    assert [h["step"] for h in history] == [1]
    assert np.isfinite(history[0]["loss"])


def test_launcher_defaults_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train_cli.main(["--steps", "1"])


@pytest.mark.parametrize("mesh", ["single", "multi"])
def test_launcher_refuses_a_mesh(mesh, capsys):
    """``--mesh single|multi`` trains on a production mesh over the
    launched group (here this process, one gloo rank) and refuses a mesh
    the group does not fill, naming both sizes: ``single`` trains on a
    1×1 grid and refuses the default 16×16 (256 ranks); ``multi`` needs
    2·data·model ranks, 2 at the smallest."""
    small = ["--steps", "2", "--batch", "2", "--seq", "16", "--device", "cpu"]
    if mesh == "single":
        history = train_cli.main(["--mesh", mesh, "--data", "1", "--model",
                                  "1"] + small)
        out = capsys.readouterr().out
        assert "mesh {'data': 1, 'model': 1} over 1 rank(s), policy dp" in out
        assert [h["step"] for h in history] == [1]
        assert np.isfinite(history[0]["loss"])
        with pytest.raises(ValueError, match="needs 256 ranks.*has 1"):
            train_cli.main(["--mesh", mesh] + small)
    else:
        with pytest.raises(ValueError, match="needs 2 ranks.*has 1"):
            train_cli.main(["--mesh", mesh, "--data", "1", "--model", "1"]
                           + small)
        with pytest.raises(ValueError, match="needs 512 ranks.*has 1"):
            train_cli.main(["--mesh", mesh] + small)


def test_launcher_checkpoints_every_200_steps(tmp_path):
    """``--ckpt`` goes to the loop, which saves every 200 steps, as the
    reference's launcher does: a 2-step run writes nothing."""
    ck = str(tmp_path / "run" / "ck")
    train_cli.main(["--steps", "2", "--batch", "2", "--seq", "16",
                    "--device", "cpu", "--ckpt", ck])
    assert not os.path.exists(os.path.dirname(ck))
