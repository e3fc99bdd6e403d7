"""Step functions, arguments and placements of every (architecture ×
input shape) pair: the port's counterpart of `repro.launch.specs`.

`input_specs` gives what the dry run (`repro_torch.launch.dryrun`) and
the mesh launchers (`repro_torch.launch.train --mesh`, ``chip_smoke.py``'s
``mesh`` phase) run: the step function, its arguments as DTensors placed
by `repro_torch.launch.sharding.ShardingRules`, and those placements.
The arguments are made by the port's own initialisers on ``device``;
under ``FakeTensorMode`` (the dry run) they are fake tensors, so nothing
is allocated at size, as the reference's ``ShapeDtypeStruct``s.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Any

import torch

from repro_torch.configs.registry import INPUT_SHAPES, ArchSpec, ShapeSpec
from repro_torch.launch.sharding import (P, ShardingRules, distribute,
                                         make_shardings)
from repro_torch.models.model import (ModelConfig, SlotSpec,
                                      analytic_param_count, cache_spec,
                                      init_params)
from repro_torch.train.optim import AdamWConfig, adamw_init
from repro_torch.train.step import (TrainState, make_prefill,
                                    make_serve_step, make_train_step)

Tree = Any
GIB = 2 ** 30
VLM_IMAGE_TOKENS = 1024       # the anyres tile budget of the stub frontend


def resolve_shape(shape: str | ShapeSpec) -> ShapeSpec:
    return INPUT_SHAPES[shape] if isinstance(shape, str) else shape


def shape_plan(spec: ArchSpec, shape: str | ShapeSpec) -> str:
    """'run' | 'run-swa' | 'skip': the registry's plan for a named
    shape (or its `ShapeSpec`); for another `ShapeSpec`, 'skip' where a
    decoding shape meets an encoder and 'run' otherwise."""
    if isinstance(shape, str):
        return spec.shape_plan(shape)
    if INPUT_SHAPES.get(shape.name) == shape:
        return spec.shape_plan(shape.name)
    if shape.kind == "decode" and not spec.supports_decode:
        return "skip"
    return "run"


def variant_config(spec: ArchSpec, shape: str | ShapeSpec, *,
                   rules: ShardingRules | None = None) -> ModelConfig:
    """The configuration of a pair: bf16 parameters and compute, the
    sliding-window variant where the plan says so, and with ``rules`` the
    activation placements, an int8 KV cache when the bf16 cache would
    pass 8 GiB a device, and one MoE dispatch group per data shard."""
    plan = shape_plan(spec, shape)
    cfg = spec.config
    if plan == "skip":
        raise ValueError(f"{cfg.name} skips {resolve_shape(shape).name}")
    overrides: dict[str, Any] = dict(param_dtype="bfloat16",
                                     compute_dtype="bfloat16")
    if plan == "run-swa":
        overrides["slots"] = tuple(
            SlotSpec("swa" if s.mixer == "attn" else s.mixer, s.ffn)
            for s in cfg.slots)
        overrides["sliding_window"] = spec.long_context_window
    shape = resolve_shape(shape)
    if rules is not None:
        dp = (rules.dp_spec()
              if shape.global_batch % max(rules.dp_size, 1) == 0 else None)
        if shape.kind in ("train", "prefill"):
            seq_ax = (rules.tp_axis
                      if shape.seq_len % max(rules.tp_size, 1) == 0 else None)
            overrides["act_shard"] = (dp, seq_ax, None)
        else:                                 # decode: [B, 1, d]
            overrides["act_shard"] = (dp, None, None)
            attn_layers = sum(s.mixer == "attn" for s in cfg.slots) \
                * cfg.num_layers // max(cfg.period, 1)
            cache_bytes = (2 * attn_layers * shape.global_batch
                           * shape.seq_len * cfg.num_kv_heads * cfg.hd * 2)
            if cache_bytes / (rules.dp_size * rules.tp_size) > 8 * GIB:
                overrides["kv_cache_dtype"] = "int8"
        if cfg.moe_num_experts:
            overrides["moe_groups"] = rules.dp_size if dp is not None else 1
            overrides["moe_shard"] = (dp, rules.tp_axis)
    return dataclasses.replace(cfg, **overrides)


def opt_config_for(cfg: ModelConfig) -> AdamWConfig:
    """bf16 moments for the very largest configurations, so optimizer
    state fits a device."""
    big = analytic_param_count(cfg) > 1e11
    return AdamWConfig(total_steps=10000,
                       moment_dtype="bfloat16" if big else "float32")


# --------------------------------------------------------------- arguments
def _tok(b: int, s: int, device) -> torch.Tensor:
    return torch.zeros((b, s), dtype=torch.int32, device=device)


def train_batch_struct(spec: ArchSpec, cfg: ModelConfig, shape: ShapeSpec,
                       *, device=None) -> dict:
    """The train batch of a pair: zero tokens and targets (plus embeds,
    and a loss mask for audio), on ``device``."""
    b, s = shape.global_batch, shape.seq_len
    zeros = functools.partial(torch.zeros, device=device)
    if spec.input_kind == "audio":
        return {"embeds": zeros((b, s, cfg.d_model), dtype=cfg.cdt),
                "targets": _tok(b, s, device),
                "loss_mask": zeros((b, s), dtype=torch.float32)}
    if spec.input_kind == "vlm":
        return {"embeds": zeros((b, VLM_IMAGE_TOKENS, cfg.d_model),
                                dtype=cfg.cdt),
                "tokens": _tok(b, s - VLM_IMAGE_TOKENS, device),
                "targets": _tok(b, s - VLM_IMAGE_TOKENS, device)}
    return {"tokens": _tok(b, s, device), "targets": _tok(b, s, device)}


def prefill_batch_struct(spec: ArchSpec, cfg: ModelConfig,
                         shape: ShapeSpec, *, device=None) -> dict:
    b, s = shape.global_batch, shape.seq_len
    if spec.input_kind == "audio":
        return {"embeds": torch.zeros((b, s, cfg.d_model), dtype=cfg.cdt,
                                      device=device)}
    if spec.input_kind == "vlm":
        return {"embeds": torch.zeros((b, VLM_IMAGE_TOKENS, cfg.d_model),
                                      dtype=cfg.cdt, device=device),
                "tokens": _tok(b, s - VLM_IMAGE_TOKENS, device)}
    return {"tokens": _tok(b, s, device)}


def cache_len(cfg: ModelConfig, shape: ShapeSpec) -> int:
    """Positions of a decode pair's cache: the window for the
    sliding-window variant, the shape's sequence otherwise."""
    if any(s.mixer == "swa" for s in cfg.slots):
        return cfg.sliding_window
    return shape.seq_len


def init_cache(cfg: ModelConfig, batch: int, max_seq: int, *,
               device=None) -> dict:
    """Zero decode cache of `cache_spec`'s layout (the swa ``pos`` table
    at INT32_MAX), as `Model.init_cache` makes it, without a model."""
    from repro_torch.models.model import POS_UNWRITTEN
    cache: dict = {}
    for slot, entries in cache_spec(cfg, batch, max_seq).items():
        cache[slot] = {
            name: torch.full(shp, POS_UNWRITTEN if name == "pos" else 0,
                             dtype=dt, device=device)
            for name, (shp, dt) in entries.items()}
    return cache


def input_specs(arch_spec: ArchSpec, shape: str | ShapeSpec,
                rules: ShardingRules, *, device=None, seed: int = 0,
                backend: str = "cuda", opt_cfg: AdamWConfig | None = None,
                dtype: str | None = None, placed: bool = True) -> dict:
    """{fn, args, in_specs, in_shardings, out_shardings, donate_argnums,
    cfg, rules} for one pair on the mesh behind ``rules``: ``args`` are
    DTensors drawn by the port's initialisers from ``seed`` on
    ``device`` and placed by the rules (with ``placed=False``, the whole
    tensors, and the mesh may be an `AbstractMesh`); ``in_specs`` the
    trees of `PartitionSpec`s, ``in_shardings`` of (mesh, placements) of
    each argument (a plain Python value has None);
    ``donate_argnums`` is kept as metadata (the port's steps update the
    train state and the cache in place). ``backend`` is the decode
    attention of a decode pair (``cuda``: `flash_decode` on the local
    shards; ``torch``: the chunked attention, as the dry run runs it).
    ``shape`` is an `INPUT_SHAPES` name or a `ShapeSpec`. ``opt_cfg``
    (a launcher's schedule) replaces `opt_config_for`'s but keeps its
    moment dtype. ``dtype`` replaces the variant's bf16 parameters and
    compute (a parity check in float32)."""
    shape = resolve_shape(shape)
    if (shape.kind == "train" and rules.policy == "tp"
            and analytic_param_count(arch_spec.config) < 2e9):
        # small models train pure-DP: the model axis joins the batch axes
        rules = rules.with_policy("dp")
    cfg = variant_config(arch_spec, shape, rules=rules)
    if dtype is not None:
        cfg = dataclasses.replace(cfg, param_dtype=dtype,
                                  compute_dtype=dtype)
    gen = torch.Generator(device=device if device is not None else "cpu") \
        .manual_seed(seed)
    place = distribute if placed else (lambda tree, shardings: tree)
    if shape.kind == "train":
        moments = opt_config_for(cfg).moment_dtype
        opt_cfg = (opt_config_for(cfg) if opt_cfg is None else
                   dataclasses.replace(opt_cfg, moment_dtype=moments))
        params = init_params(cfg, gen)
        p_spec = rules.params_specs(params)
        state_spec = TrainState(params=p_spec,
                                opt=rules.opt_specs(None, p_spec), step=P())
        state = TrainState(params=params, opt=adamw_init(opt_cfg, params),
                           step=torch.zeros((), dtype=torch.int32,
                                            device=device))
        batch = train_batch_struct(arch_spec, cfg, shape, device=device)
        b_spec = rules.batch_specs(batch, shape.global_batch)
        state_shard = TrainState(
            params=make_shardings(rules, p_spec),
            opt=make_shardings(rules, state_spec.opt),
            step=make_shardings(rules, P()))
        b_shard = make_shardings(rules, b_spec)
        state = TrainState(params=place(state.params, state_shard.params),
                           opt=place(state.opt, state_shard.opt),
                           step=place(state.step, state_shard.step))
        return dict(
            fn=make_train_step(cfg, opt_cfg,
                               grad_specs=state_shard.params),
            args=(state, place(batch, b_shard)),
            in_specs=(state_spec, b_spec),
            in_shardings=(state_shard, b_shard),
            out_shardings=(state_shard, None),
            donate_argnums=(0,), cfg=cfg, rules=rules, opt_cfg=opt_cfg)

    if shape.kind == "prefill":
        params = init_params(cfg, gen)
        batch = prefill_batch_struct(arch_spec, cfg, shape, device=device)
        specs = (rules.params_specs(params),
                 rules.batch_specs(batch, shape.global_batch))
        shard = tuple(make_shardings(rules, sp) for sp in specs)
        return dict(
            fn=make_prefill(cfg),
            args=(place(params, shard[0]), place(batch, shard[1])),
            in_specs=specs, in_shardings=shard, out_shardings=None,
            donate_argnums=(), cfg=cfg, rules=rules)

    # decode: ONE new token against a seq_len cache. Parameters shard over
    # the model axis only (no FSDP) unless that alone passes 8 GiB a device
    params_per_dev = analytic_param_count(cfg) * 2 / max(rules.tp_size, 1)
    if rules.policy == "tp" and params_per_dev <= 8 * GIB:
        rules = rules.with_policy("serve")
    params = init_params(cfg, gen)
    b = shape.global_batch
    length = cache_len(cfg, shape)
    cache = init_cache(cfg, b, length, device=device)
    tokens = _tok(b, 1, device)
    specs = (rules.params_specs(params), rules.cache_specs(cache, b),
             rules.batch_specs({"tokens": tokens}, b)["tokens"], P())
    shard = tuple(make_shardings(rules, sp) for sp in specs[:3]) + (None,)
    serve_step = make_serve_step(cfg)
    return dict(
        fn=functools.partial(serve_step, backend=backend),
        # the last position: the step reads the whole cache, as the
        # reference's step does at any traced position
        args=(place(params, shard[0]), place(cache, shard[1]),
              place(tokens, shard[2]), length - 1),
        in_specs=specs, in_shardings=shard, out_shardings=None,
        donate_argnums=(1,), cfg=cfg, rules=rules)
