"""Train steps on a mesh and the same steps on one device: the rank
program of the mesh launchers' checks.

`mesh_train_case` runs on every rank of a `torch.distributed` group
(`repro_torch.dist.ranks.run_ranks` starts the ranks; ``chip_smoke.py``
runs it as the one rank of an NCCL group): it trains an architecture on a
(data, model) mesh through `repro_torch.launch.specs.input_specs`, and,
on rank 0, the same steps from the same draws with plain tensors
(`repro_torch.train.step.make_train_step` without a mesh). It lives in
the package because a spawned rank imports the module of its function.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.configs import get_arch
from repro_torch.configs.registry import ShapeSpec
from repro_torch.obs.metrics import perf_clock


def mesh_pair(arch: str, *, data: int, model: int, batch: int, seq: int,
              seed: int = 0, reduced: bool = True, dtype: str | None = None,
              device=None, lr: float = 3e-4, steps: int = 10) -> dict:
    """`input_specs` of a train pair of ``arch`` (reduced unless told
    otherwise) at B ``batch`` × S ``seq`` on a (data, model) mesh over
    the default group, with a schedule of ``steps`` steps at ``lr``."""
    from repro_torch.launch.mesh import make_production_mesh
    from repro_torch.launch.sharding import ShardingRules
    from repro_torch.launch.specs import input_specs
    from repro_torch.train.optim import AdamWConfig

    device = torch.device(device or "cpu")
    spec = get_arch(arch)
    if reduced:
        spec = dataclasses.replace(spec, config=spec.config.reduced())
    mesh = make_production_mesh(data=data, model=model,
                                device_type=device.type)
    opt_cfg = AdamWConfig(lr=lr, total_steps=steps,
                          warmup_steps=max(steps // 20, 5))
    return input_specs(spec, ShapeSpec("mesh", seq, batch, "train"),
                       ShardingRules(mesh), device=device, seed=seed,
                       opt_cfg=opt_cfg, dtype=dtype)


def batches(vocab: int, batch: int, seq: int, steps: int,
            seed: int = 0) -> list[dict]:
    """``steps`` batches of the synthetic token pipeline, as numpy."""
    from repro_torch.data.tokens import (SyntheticTokenPipeline,
                                         TokenPipelineConfig)
    pipe = iter(SyntheticTokenPipeline(TokenPipelineConfig(
        vocab_size=vocab, batch_size=batch, seq_len=seq, seed=seed)))
    return [next(pipe) for _ in range(steps)]


def run_steps(fn, state, data: list[dict], shardings=None, device=None):
    """``fn`` over the batches (distributed by ``shardings`` when given);
    returns (state, the losses as floats)."""
    from repro_torch.launch.sharding import distribute

    losses = []
    for raw in data:
        b = {k: torch.as_tensor(v, device=device) for k, v in raw.items()}
        if shardings is not None:
            b = distribute(b, shardings)
        state, metrics = fn(state, b)
        loss = metrics["loss"]
        losses.append(float(loss.full_tensor() if hasattr(loss, "full_tensor")
                            else loss))
    return state, losses


def plain_pair(pair: dict, *, seed: int = 0, device=None):
    """The pair's train step and state on one device without a mesh:
    the same configuration and schedule, the parameters drawn from the
    same seed on the same device as `input_specs` draws them."""
    from repro_torch.train.step import make_train_step, train_state_init

    cfg = dataclasses.replace(pair["cfg"], act_shard=None)
    opt_cfg = pair["opt_cfg"]
    gen = torch.Generator(device=device or "cpu").manual_seed(seed)
    state = train_state_init(cfg, opt_cfg, gen, device=device or "cpu")
    return make_train_step(cfg, opt_cfg), state


def _full(t) -> torch.Tensor:
    return t.full_tensor() if hasattr(t, "full_tensor") else t


def mesh_train_case(arch: str, data: int, model: int, batch: int, seq: int,
                    steps: int, seed: int = 0, dtype: str | None = None,
                    device: str = "cpu", ckpt: str | None = None) -> dict:
    """On every rank: ``steps`` train steps on the (data, model) mesh.
    On rank 0 also the same steps with plain tensors. Returns, on rank 0,
    {"losses", "plain_losses", "params", "plain_params" (whole arrays
    after the steps, float32 numpy), "placements" (a parameter's
    placements by name), "ckpt_equal" (with ``ckpt``: the state saved and
    loaded back onto the mesh by ``load_checkpoint(shardings=)`` is the
    same DTensors, bit for bit)}; {} on the other ranks."""
    import torch.distributed as dist

    from repro_torch.train.checkpoint import load_checkpoint, save_checkpoint
    from repro_torch.train.optim import tree_leaves, tree_map

    pair = mesh_pair(arch, data=data, model=model, batch=batch, seq=seq,
                     seed=seed, dtype=dtype, device=device, steps=steps)
    cfg = pair["cfg"]
    data_ = batches(cfg.vocab_size, batch, seq, steps, seed)
    state = pair["args"][0]
    state, losses = run_steps(pair["fn"], state, data_,
                              pair["in_shardings"][1], device)
    out: dict = {}
    params = {k: _full(v) for k, v in _named(state.params)}
    if ckpt is not None:
        whole = tree_map(_full, state.params)     # a collective: every rank
        if dist.get_rank() == 0:
            save_checkpoint(ckpt, {"params": whole}, step=steps)
        dist.barrier()
        tree, _ = load_checkpoint(
            ckpt, shardings={"params": pair["in_shardings"][0].params},
            device=device)
        same = all(
            tuple(a.placements) == tuple(b.placements)
            and torch.equal(a.to_local(), b.to_local())
            for a, b in zip(tree_leaves(tree["params"]),
                            tree_leaves(state.params)))
        out["ckpt_equal"] = same
    if dist.get_rank() != 0:
        return {}
    fn, plain = plain_pair(pair, seed=seed, device=device)
    plain, plain_losses = run_steps(fn, plain, data_, device=device)
    out.update(
        losses=losses, plain_losses=plain_losses,
        params={k: v.float().cpu().numpy() for k, v in params.items()},
        plain_params={k: v.float().cpu().numpy()
                      for k, v in _named(plain.params)},
        placements={k: [str(p) for p in v.placements]
                    for k, v in _named(state.params)})
    return out


def _named(tree, prefix=""):
    if isinstance(tree, dict):
        for key in sorted(tree):
            yield from _named(tree[key], f"{prefix}{key}/")
    else:
        yield prefix.rstrip("/"), tree


def max_rel_diff(a: dict, b: dict) -> float:
    """max over the leaves of max|a − b| / max|b|."""
    return max(float(np.abs(a[k] - b[k]).max() / max(np.abs(b[k]).max(),
                                                      1e-30)) for k in b)


def fill_cache(cache: dict, seed: int, device) -> None:
    """Seeded values in every cache entry (in place, on each shard): int8
    codes over [−127, 127], scales in [0.005, 0.03], keys, values and
    states N(0, 1)."""
    gen = torch.Generator(device=device).manual_seed(seed)
    for entries in cache.values():
        for name, t in entries.items():
            local = t.to_local() if hasattr(t, "to_local") else t
            if local.dtype == torch.int8:
                local.copy_(torch.randint(-127, 128, local.shape,
                                          generator=gen, device=device,
                                          dtype=torch.int8))
            elif name.endswith("_scale"):
                local.copy_(torch.empty(local.shape, device=device)
                            .uniform_(0.005, 0.03, generator=gen))
            else:
                local.copy_(torch.randn(local.shape, generator=gen,
                                        device=device))


def decode_steps(pair: dict, steps: int, device, *, seed: int,
                 agrees) -> dict:
    """The serve step of a decode pair of `input_specs`, its cache
    filled from ``seed``: ``steps`` steps at the cache's last positions
    on backend cuda (`flash_decode` on each rank's shards; on the CPU its
    plain version), each step also run on backend torch from a copy of
    the same cache, so the two compare on equal inputs. Before them, the
    kernel on the first attention layer's inputs against its plain
    version, ``agrees(got, want, dtype)`` deciding. Returns {kv, cdt,
    launches (flash_decode's on the card, dispatches on the CPU), rel
    (max |Δlogit| / max|logit| over the steps), scale, finite,
    kernel_err, kernel_ok, step_ms (the cuda steps, host clock),
    cache_gb (one rank's), logits (whole, a step, float32)}."""
    from repro_torch.kernels import ops
    from repro_torch.kernels.decode_attention import flash_decode_reference
    from repro_torch.models import layers as L
    from repro_torch.train.step import make_serve_step

    device = torch.device(device)
    on_card = device.type == "cuda"
    cfg = pair["cfg"]
    params, cache, tokens, last = pair["args"]
    batch = tokens.shape[0]
    fill_cache(cache, seed, device)
    gen = torch.Generator(device=device).manual_seed(seed + 1)
    toks = torch.randint(0, cfg.vocab_size, (steps, batch, 1),
                         generator=gen, device=device, dtype=torch.int32)
    step = make_serve_step(cfg)
    first = last - steps + 1
    copy = {slot: {n: t.clone() for n, t in e.items()}
            for slot, e in cache.items()}

    def counts():
        return (ops.launch_counts() if on_card
                else ops.dispatch_counts())["flash_decode"]

    seen = []
    real = L.decode_attention

    def first_call(q, k, v, cur, *, backend="cuda"):
        if not seen and backend == "cuda":
            seen.append(tuple(t.to_local() if hasattr(t, "to_local") else t
                              for t in (q, k, v)) + (cur,))
        return real(q, k, v, cur, backend=backend)

    L.decode_attention = first_call
    try:
        step(params, copy, spmd_tokens(toks[0], tokens), first,
             backend="cuda")
    finally:
        L.decode_attention = real
    q0, k0, v0, cur0 = seen.pop()
    lens = torch.full((q0.shape[0] * k0.shape[2],), cur0, dtype=torch.int32,
                      device=device)
    got0 = ops.flash_decode(q0, k0, v0, cur0)
    want0 = flash_decode_reference(q0, k0, v0, lens)
    kernel_err = float((got0.float() - want0.float()).abs().max())
    kernel_ok = agrees(got0, want0, q0.dtype)
    del q0, k0, v0, got0, want0

    ops.reset_launch_counts()
    launches, secs, rel, scale, finite, logits = 0, 0.0, 0.0, 0.0, True, []
    for i in range(steps):
        for slot, entries in cache.items():
            for name, t in entries.items():
                copy[slot][name].to_local().copy_(t.to_local())
        tok = spmd_tokens(toks[i], tokens)
        before = counts()
        if on_card:
            torch.cuda.synchronize()
        t0 = perf_clock()
        got, cache = step(params, cache, tok, first + i, backend="cuda")
        if on_card:
            torch.cuda.synchronize()
        secs += perf_clock() - t0
        launches += counts() - before
        want, copy = step(params, copy, tok, first + i, backend="torch")
        got, want = got.full_tensor().float(), want.full_tensor().float()
        finite = finite and bool(torch.isfinite(got).all())
        step_scale = float(want.abs().max())
        scale = max(scale, step_scale)
        rel = max(rel, float((got - want).abs().max()) / step_scale)
        logits.append((got.cpu().numpy(), want.cpu().numpy()))
    return dict(kv=cfg.kv_cache_dtype, cdt=cfg.compute_dtype,
                launches=launches, rel=rel, scale=scale, finite=finite,
                kernel_err=kernel_err, kernel_ok=kernel_ok,
                step_ms=secs / steps * 1e3, logits=logits,
                cache_gb=sum(t.to_local().numel() * t.element_size()
                             for e in copy.values() for t in e.values()) / 1e9)


def mesh_decode_case(arch: str, data: int, model: int, batch: int, seq: int,
                     steps: int, seed: int = 0, device: str = "cpu") -> dict:
    """On every rank: `decode_steps` of a reduced ``arch``'s serve step
    from `input_specs` on a (data, model) mesh. Returns, on rank 0, its
    result and "refused" (the error a sequence-sharded cache raises on
    the cuda backend); {} on the other ranks."""
    import torch.distributed as dist
    from torch.distributed.tensor import Shard

    from repro_torch.launch.mesh import make_production_mesh
    from repro_torch.launch.sharding import ShardingRules
    from repro_torch.launch.specs import input_specs
    from repro_torch.models import layers as L

    spec = get_arch(arch)
    spec = dataclasses.replace(spec, config=spec.config.reduced())
    mesh = make_production_mesh(data=data, model=model,
                                device_type=torch.device(device).type)
    pair = input_specs(spec, ShapeSpec("mesh", seq, batch, "decode"),
                       ShardingRules(mesh), device=device, seed=seed)
    out = decode_steps(pair, steps, device, seed=seed + 1,
                       agrees=lambda a, b, dtype: torch.equal(a, b))
    k = pair["args"][1]["slot0"]["k"][0]
    seq_sharded = type(k).from_local(
        k.to_local(), mesh, [Shard(1)] * mesh.ndim, run_check=False)
    q = torch.zeros((batch, 1, pair["cfg"].num_heads, pair["cfg"].hd),
                    dtype=k.dtype, device=device)
    try:
        L.decode_attention(q, seq_sharded, seq_sharded, 1, backend="cuda")
        out["refused"] = None
    except ValueError as exc:
        out["refused"] = str(exc)
    return out if dist.get_rank() == 0 else {}


def spmd_tokens(whole: torch.Tensor, like) -> torch.Tensor:
    """Whole token ids [B, 1] placed as the DTensor ``like``."""
    from repro_torch.launch.sharding import distribute
    return distribute(whole, (like.device_mesh, tuple(like.placements)))
