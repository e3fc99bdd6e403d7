"""Model assembly of the LLM serving path: the port's counterpart of
`repro.models.model`.

A model is ``num_groups`` repetitions of a *period* of slots
(``cfg.slots``); each slot is a (mixer, ffn) pair:

  mixer ∈ {attn, swa, mamba, rwkv}      ffn ∈ {dense, moe, rwkv_cmix, none}

  dense llama-style:   slots = ((attn, dense),)
  deepseek-moe:        slots = ((attn, moe),)
  rwkv6:               slots = ((rwkv, rwkv_cmix),)
  jamba (1:7 + MoE/2): 8 slots, slot 0 attn, the rest mamba, odd slots
                       moe, even slots dense

Parameters keep the reference's pytree layout and its [in, out] weights
(``x @ w``): ``{"embed": [V, d], "final_norm": [d], "lm_head": [d, V],
"slot{i}": {name: [num_groups, ...]}}``, so carrying weights across
(`repro_torch.interop.lm_params_from_arrays`) is a copy, not a
transpose. Caches keep the reference's layout too, by mixer:

  attn   ``k``, ``v`` [g, B, S, K, dh] (plus ``k_scale`` / ``v_scale``
         [g, B, S, K] in bf16 for the int8 cache);
  swa    ``k``, ``v`` [g, B, w, K, dh], a ring over the window w, and
         ``pos`` [g, w] int32, the position each ring slot holds
         (INT32_MAX while unwritten: masked as padding);
  mamba  ``conv`` [g, B, conv_width − 1, d_inner], ``state``
         [g, B, d_inner, N] float32;
  rwkv   ``shift_t``, ``shift_c`` [g, B, d], ``state`` [g, B, H, dh, dh]
         float32.

Two entry points:

  forward(tokens)                   — full sequence, chunked attention and
                                      the recurrences over time; returns
                                      the MoE aux losses. Differentiable:
                                      gradients flow to the leaves of the
                                      parameter dict it is given (the
                                      training path, `repro_torch.train`),
                                      and with ``cfg.remat`` each layer
                                      group is recomputed in the backward
                                      pass, as the reference's per-group
                                      ``jax.checkpoint``;
  decode_step(cache, tokens, pos)   — one token against the cache; the
                                      cache is updated in place (the
                                      reference returns a new pytree) and
                                      returned. Nothing in it reads a
                                      value back to the host, so a step
                                      captures into a CUDA graph.
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.models import layers as L
from repro_torch.models import moe as moe_lib
from repro_torch.models import rwkv as rwkv_lib
from repro_torch.models import spmd
from repro_torch.models import ssm as ssm_lib

Params = dict
Cache = dict

MIXERS = ("attn", "swa", "mamba", "rwkv")
FFNS = ("dense", "moe", "rwkv_cmix", "none")
AUX_KEYS = ("load_balance_loss", "router_z_loss")
# a swa ring slot not yet written: chunked_attention masks this position
# as padding
POS_UNWRITTEN = L._POS_PAD


@dataclasses.dataclass(frozen=True)
class SlotSpec:
    mixer: str          # attn | swa | mamba | rwkv
    ffn: str            # dense | moe | rwkv_cmix | none


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int | None = None
    slots: tuple[SlotSpec, ...] = (SlotSpec("attn", "dense"),)
    qkv_bias: bool = False
    is_encoder: bool = False
    act: str = "swiglu"               # swiglu | gelu
    rope_theta: float = 10000.0
    sliding_window: int | None = None
    # MoE
    moe_num_experts: int = 0
    moe_experts_per_token: int = 0
    moe_num_shared_experts: int = 0
    moe_capacity_factor: float = 1.25
    moe_groups: int = 1               # dispatch groups (= data shards)
    moe_shard: tuple | None = None    # (dp_axes, tp_axis) for MoE buffers
    # SSM
    ssm_state_dim: int = 16
    ssm_conv_width: int = 4
    ssm_expand: int = 2
    # RWKV
    rwkv_head_dim: int = 64
    rwkv_lora_rank: int = 64
    # serving
    kv_cache_dtype: str = "bfloat16"   # "int8" = quantized KV cache with
    #                                     per-(token, head) bf16 scales;
    #                                     anything else = the compute dtype
    # misc
    tie_embeddings: bool = False
    param_dtype: str = "float32"
    compute_dtype: str = "float32"
    attn_chunk: int = 1024
    scan_chunk: int = 128             # time chunk for ssm/rwkv scans
    remat: bool = True
    # the activations' spec on a mesh, (batch, sequence, d) axes: the
    # residual is redistributed to it after the embedding and after each
    # layer group (`repro_torch.models.spmd.constrain`); ignored on plain
    # tensors. ``analysis_unroll`` is the reference's dry-run switch, kept
    # so configurations compare field for field (the port never scans)
    act_shard: tuple | None = None
    analysis_unroll: bool = False
    citation: str = ""

    # ---- derived -----------------------------------------------------------
    @property
    def hd(self) -> int:
        return self.head_dim or self.d_model // self.num_heads

    @property
    def period(self) -> int:
        return len(self.slots)

    @property
    def num_groups(self) -> int:
        if self.num_layers % self.period:
            raise ValueError(f"num_layers {self.num_layers} is not a "
                             f"multiple of the period {self.period}")
        return self.num_layers // self.period

    @property
    def d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def dt_rank(self) -> int:
        return max(16, self.d_model // 32)

    @property
    def rwkv_heads(self) -> int:
        return self.d_model // self.rwkv_head_dim

    @property
    def pdt(self) -> torch.dtype:
        return getattr(torch, self.param_dtype)

    @property
    def cdt(self) -> torch.dtype:
        return getattr(torch, self.compute_dtype)

    def moe_dims(self) -> moe_lib.MoEDims:
        return moe_lib.MoEDims(
            num_experts=self.moe_num_experts,
            experts_per_token=self.moe_experts_per_token,
            d_model=self.d_model, d_ff=self.d_ff,
            num_shared_experts=self.moe_num_shared_experts,
            capacity_factor=self.moe_capacity_factor)

    def reduced(self, **overrides) -> "ModelConfig":
        """Smoke-test variant: 1 period of layers, d_model ≤ 512, ≤4
        experts."""
        d_model = min(self.d_model, 256)
        hd = 32
        heads = max(2, min(4, self.num_heads))
        kv = max(1, heads // max(1, self.num_heads // self.num_kv_heads))
        kw = dict(
            num_layers=2 * self.period if self.period <= 4 else self.period,
            d_model=d_model,
            num_heads=heads,
            num_kv_heads=kv,
            head_dim=hd,
            d_ff=min(self.d_ff, 512),
            vocab_size=min(self.vocab_size, 1024),
            moe_num_experts=min(self.moe_num_experts, 4),
            moe_experts_per_token=min(self.moe_experts_per_token, 2),
            rwkv_head_dim=32,
            rwkv_lora_rank=16,
            attn_chunk=64,
            scan_chunk=16,
        )
        kw.update(overrides)
        return dataclasses.replace(self, **kw)


# ============================================================== parameters
def _slot_param_shapes(cfg: ModelConfig, slot: SlotSpec) -> dict:
    d, hd = cfg.d_model, cfg.hd
    h, k = cfg.num_heads, cfg.num_kv_heads
    shapes: dict[str, tuple] = {"norm_mix": (d,)}
    if slot.mixer in ("attn", "swa"):
        shapes.update(wq=(d, h * hd), wk=(d, k * hd), wv=(d, k * hd),
                      wo=(h * hd, d))
        if cfg.qkv_bias:
            shapes.update(bq=(h * hd,), bk=(k * hd,), bv=(k * hd,))
    elif slot.mixer == "mamba":
        di, n, r = cfg.d_inner, cfg.ssm_state_dim, cfg.dt_rank
        shapes.update(in_x=(d, di), in_z=(d, di),
                      conv_w=(cfg.ssm_conv_width, di),
                      dt_down=(di, r), dt_up=(r, di), dt_bias=(di,),
                      w_b=(di, n), w_c=(di, n), a_log=(di, n),
                      d_skip=(di,), out=(di, d))
    elif slot.mixer == "rwkv":
        hh, dh, r = cfg.rwkv_heads, cfg.rwkv_head_dim, cfg.rwkv_lora_rank
        shapes.update(mu_r=(d,), mu_k=(d,), mu_v=(d,), mu_w=(d,), mu_g=(d,),
                      wr=(d, d), wk_t=(d, d), wv_t=(d, d), wg=(d, d),
                      w0=(d,), wa=(d, r), wb=(r, d), u=(hh, dh),
                      gn=(d,), wo=(d, d))
    else:
        raise ValueError(f"{cfg.name}: unknown mixer {slot.mixer!r}; "
                         f"expected one of {MIXERS}")

    if slot.ffn == "dense":
        shapes["norm_ffn"] = (d,)
        if cfg.act == "swiglu":
            shapes.update(w_gate=(d, cfg.d_ff), w_up=(d, cfg.d_ff),
                          w_down=(cfg.d_ff, d))
        else:
            shapes.update(w_up=(d, cfg.d_ff), b_up=(cfg.d_ff,),
                          w_down=(cfg.d_ff, d), b_down=(d,))
    elif slot.ffn == "moe":
        e, f = cfg.moe_num_experts, cfg.d_ff
        shapes["norm_ffn"] = (d,)
        shapes.update(router=(d, e), moe_gate=(e, d, f), moe_up=(e, d, f),
                      moe_down=(e, f, d))
        if cfg.moe_num_shared_experts:
            fs = cfg.moe_num_shared_experts * f
            shapes.update(sh_gate=(d, fs), sh_up=(d, fs), sh_down=(fs, d))
    elif slot.ffn == "rwkv_cmix":
        shapes.update(norm_ffn=(d,), mu_c=(d,), cm_r=(d, d),
                      cm_k=(d, cfg.d_ff), cm_v=(cfg.d_ff, d))
    elif slot.ffn != "none":
        raise ValueError(f"{cfg.name}: unknown ffn {slot.ffn!r}; expected "
                         f"one of {FFNS}")
    return shapes


def param_shapes(cfg: ModelConfig) -> dict:
    """The parameter pytree's shapes: top-level names to a shape, and
    ``slot{i}`` to a dict of names to [num_groups, ...] shapes."""
    d, v, g = cfg.d_model, cfg.vocab_size, cfg.num_groups
    shapes: dict = {"embed": (v, d), "final_norm": (d,)}
    if not cfg.tie_embeddings:
        shapes["lm_head"] = (d, v)
    for i, slot in enumerate(cfg.slots):
        shapes[f"slot{i}"] = {name: (g,) + shape for name, shape in
                              _slot_param_shapes(cfg, slot).items()}
    return shapes


def _normal(gen: torch.Generator, shape: tuple, dtype: torch.dtype,
            scale: float) -> torch.Tensor:
    out = torch.randn(shape, generator=gen, device=gen.device,
                      dtype=torch.float32).mul_(scale)
    return out.to(dtype)


def _fixed_param(name: str, shape: tuple, dtype: torch.dtype,
                 device) -> torch.Tensor | None:
    """The reference's deterministic entries (`repro.models.model.
    init_params`): norms and ``gn`` 1, ``mu_*`` 0.5, biases, ``dt_bias``,
    ``d_skip`` and ``u`` 0, ``a_log`` = log(1..N) along the state,
    ``w0`` −0.6; None for an entry drawn at random (the gelu ffn's
    ``b_up`` among them)."""
    kw = dict(dtype=dtype, device=device)
    if name.startswith("norm") or name == "gn":
        return torch.ones(shape, **kw)
    if name.startswith("mu_"):
        return torch.full(shape, 0.5, **kw)
    if (name.startswith("b") and name != "b_up") \
            or name in ("dt_bias", "d_skip", "u"):
        return torch.zeros(shape, **kw)
    if name == "a_log":
        # float32 log on the host: numpy rounds log(1..N) as the
        # reference's XLA CPU log does (log 7 one ulp above torch's)
        a0 = torch.from_numpy(np.log(np.arange(1, shape[-1] + 1,
                                               dtype=np.float32)))
        return a0.to(device=device, dtype=dtype).expand(shape).contiguous()
    if name == "w0":
        return torch.full(shape, -0.6, **kw)
    return None


def init_params(cfg: ModelConfig, generator: torch.Generator) -> Params:
    """Seeded initialisation on ``generator``'s device, with the
    reference's scheme: embeddings N(0, 0.02²), weights N(0, 1/fan_in),
    and the reference's fixed values for norms, biases and the mixers'
    deterministic entries (`_fixed_param`). The draws are torch's, not
    the reference's: parity tests carry the reference's parameters
    across instead."""
    d, v = cfg.d_model, cfg.vocab_size
    dev = generator.device
    params: Params = {
        "embed": _normal(generator, (v, d), cfg.pdt, 0.02),
        "final_norm": torch.ones((d,), dtype=cfg.pdt, device=dev),
    }
    if not cfg.tie_embeddings:
        params["lm_head"] = _normal(generator, (d, v), cfg.pdt,
                                    1.0 / math.sqrt(d))
    g = cfg.num_groups
    for i, slot in enumerate(cfg.slots):
        slot_params = {}
        for name, shape in sorted(_slot_param_shapes(cfg, slot).items()):
            p = _fixed_param(name, (g,) + shape, cfg.pdt, dev)
            if p is None:
                p = _normal(generator, (g,) + shape, cfg.pdt,
                            1.0 / math.sqrt(shape[0]))
            slot_params[name] = p
        params[f"slot{i}"] = slot_params
    return params


def param_count(params: Params) -> int:
    return sum(t.numel() for t in _leaves(params))


def _leaves(tree):
    if isinstance(tree, dict):
        for value in tree.values():
            yield from _leaves(value)
    else:
        yield tree


def analytic_param_count(cfg: ModelConfig) -> int:
    """Parameter count from shapes alone (no allocation)."""
    total = cfg.vocab_size * cfg.d_model + cfg.d_model       # embed + norm
    if not cfg.tie_embeddings:
        total += cfg.d_model * cfg.vocab_size
    for slot in cfg.slots:
        shapes = _slot_param_shapes(cfg, slot)
        total += cfg.num_groups * sum(
            math.prod(s) for s in shapes.values())
    return total


def active_param_count(cfg: ModelConfig) -> int:
    """Activated parameters per token (MoE: top-k of E experts)."""
    total = analytic_param_count(cfg)
    if cfg.moe_num_experts:
        for slot in cfg.slots:
            if slot.ffn == "moe":
                per_expert = 3 * cfg.d_model * cfg.d_ff
                inactive = (cfg.moe_num_experts
                            - cfg.moe_experts_per_token) * per_expert
                total -= cfg.num_groups * inactive
    return total


# ================================================================= slot apply
def _norm_in(cfg: ModelConfig, h: torch.Tensor,
             weight: torch.Tensor) -> torch.Tensor:
    """The normed input [B, S, d] of a mixer or ffn; on a mesh whose
    activations shard the sequence (``act_shard``), gathered over it
    first, so the column-sharded projections see whole sequences."""
    x = L.rms_norm(h, weight)
    if cfg.act_shard is not None and cfg.act_shard[1] is not None:
        x = spmd.constrain(x, (cfg.act_shard[0], None, None))
    return x


def _qkv(cfg: ModelConfig, p: dict, h: torch.Tensor,
         positions: torch.Tensor):
    nh, nk, hd = cfg.num_heads, cfg.num_kv_heads, cfg.hd
    x = _norm_in(cfg, h, p["norm_mix"])
    q = x @ p["wq"]
    k = x @ p["wk"]
    v = x @ p["wv"]
    if cfg.qkv_bias:
        q, k, v = q + p["bq"], k + p["bk"], v + p["bv"]
    q = L.apply_rope(spmd.split_last(q, nh, hd), positions, cfg.rope_theta)
    k = L.apply_rope(spmd.split_last(k, nk, hd), positions, cfg.rope_theta)
    return q, k, spmd.split_last(v, nk, hd)


def _mamba_in(cfg: ModelConfig, p: dict, h: torch.Tensor):
    """The Mamba mixer's projections: (x_in, z), each [..., d_inner]."""
    x = _norm_in(cfg, h, p["norm_mix"]) if h.ndim == 3 \
        else L.rms_norm(h, p["norm_mix"])
    return x @ p["in_x"], x @ p["in_z"]


def _mamba_delta(p: dict, xi: torch.Tensor) -> torch.Tensor:
    # F.softplus returns x past 20 where jax.nn.softplus adds log1p(e^−x)
    # (< 2.1e-9, below float32's ulp there)
    return F.softplus((xi @ p["dt_down"]) @ p["dt_up"] + p["dt_bias"])


def _mamba_mixer(cfg: ModelConfig, p: dict, h: torch.Tensor) -> torch.Tensor:
    xi, z = _mamba_in(cfg, p, h)
    xi = F.silu(ssm_lib.causal_conv1d(xi, p["conv_w"]))

    def scan(xi, delta, a_log, b_t, c_t, d_skip):
        state0 = torch.zeros((xi.shape[0], xi.shape[2],
                              cfg.ssm_state_dim), dtype=torch.float32,
                             device=xi.device)
        return ssm_lib.ssm_chunk_scan(xi, delta, a_log, b_t, c_t, d_skip,
                                      state0, chunk=cfg.scan_chunk)[0]

    args = (xi, _mamba_delta(p, xi), p["a_log"], xi @ p["w_b"],
            xi @ p["w_c"], p["d_skip"])
    if not spmd.is_dtensor(xi):
        y = scan(*args)
    else:
        lay = spmd.Layout(xi, cfg.d_inner)
        inner = lay.placements(3, batch=0, inner=2)
        y = spmd.local_call(
            scan, lay.mesh, args,
            (inner, inner, lay.placements(2, inner=0),
             lay.placements(3, batch=0), lay.placements(3, batch=0),
             lay.placements(1, inner=0)), (inner,), (xi.shape,))
    return (y * F.silu(z)) @ p["out"]


def _rwkv_inputs(cfg: ModelConfig, p: dict, x: torch.Tensor,
                 prev: torch.Tensor | None):
    """r, k, v, w [B, S, H, dh] and the gate g [B, S, d] of the time mix
    from the normed x [B, S, d] (``prev`` the decode shift state)."""
    hh, dh = cfg.rwkv_heads, cfg.rwkv_head_dim

    def mix(mu):
        return rwkv_lib.token_shift(x, mu, prev)

    r = spmd.split_last(mix(p["mu_r"]) @ p["wr"], hh, dh)
    k = spmd.split_last(mix(p["mu_k"]) @ p["wk_t"], hh, dh)
    v = spmd.split_last(mix(p["mu_v"]) @ p["wv_t"], hh, dh)
    g = F.silu(mix(p["mu_g"]) @ p["wg"])
    w = rwkv_lib.data_dependent_decay(mix(p["mu_w"]), p["w0"], p["wa"],
                                      p["wb"], hh)
    return r, k, v, w, g


def _rwkv_out(p: dict, out: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    # rms norm as the stand-in for the per-head group norm, as the
    # reference computes it
    out = L.rms_norm(spmd.merge_last(out), p["gn"])
    return (out * g) @ p["wo"]


def _rwkv_mixer(cfg: ModelConfig, p: dict, h: torch.Tensor) -> torch.Tensor:
    x = _norm_in(cfg, h, p["norm_mix"])
    r, k, v, w, g = _rwkv_inputs(cfg, p, x, None)

    def scan(r, k, v, w, u):
        state0 = torch.zeros((r.shape[0], r.shape[2], cfg.rwkv_head_dim,
                              cfg.rwkv_head_dim), dtype=torch.float32,
                             device=r.device)
        return rwkv_lib.wkv6_chunk_scan(r, k, v, w, u, state0,
                                        chunk=cfg.scan_chunk)[0]

    if not spmd.is_dtensor(r):
        out = scan(r, k, v, w, p["u"])
    else:
        lay = spmd.Layout(r, cfg.rwkv_heads)
        heads = lay.placements(4, batch=0, inner=2)
        out = spmd.local_call(scan, lay.mesh, (r, k, v, w, p["u"]),
                              (heads,) * 4 + (lay.placements(2, inner=0),),
                              (heads,), (r.shape,))
    return _rwkv_out(p, out, g)


def _ffn(cfg: ModelConfig, slot: SlotSpec, p: dict, h: torch.Tensor,
         aux: dict | None = None) -> torch.Tensor | None:
    """The slot's ffn on the residual h [B, S, d] (None for ``none``);
    MoE losses add into ``aux``."""
    if slot.ffn == "none":
        return None
    x = _norm_in(cfg, h, p["norm_ffn"])
    if slot.ffn == "dense":
        if cfg.act == "swiglu":
            return L.swiglu_mlp(x, p["w_gate"], p["w_up"], p["w_down"])
        return L.gelu_mlp(x, p["w_up"], p["b_up"], p["w_down"], p["b_down"])
    if slot.ffn == "moe":
        b, s, d = x.shape
        out, losses = moe_lib.moe_forward(
            x.reshape(b * s, d), p["router"], p["moe_gate"], p["moe_up"],
            p["moe_down"], cfg.moe_dims(),
            shared_w_gate=p.get("sh_gate"), shared_w_up=p.get("sh_up"),
            shared_w_down=p.get("sh_down"), groups=cfg.moe_groups,
            shard=cfg.moe_shard)
        if aux is not None:
            for key, val in losses.items():
                aux[key] = aux[key] + val if key in aux else val
        return out.reshape(b, s, d)
    if slot.ffn == "rwkv_cmix":
        return rwkv_lib.channel_mix(x, p["mu_c"], p["cm_r"], p["cm_k"],
                                    p["cm_v"])
    raise ValueError(f"{cfg.name}: unknown ffn {slot.ffn!r}; expected one "
                     f"of {FFNS}")


def _quantize(t: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """[B, 1, K, dh] → int8 codes and bf16 per-(token, head) scales;
    ``torch.round`` rounds half to even, as ``jnp.round`` does."""
    amax = t.abs().amax(dim=-1)
    scale = torch.clamp_min(amax, 1e-6) / 127.0
    q8 = torch.clamp(torch.round(t / scale[..., None]), -127, 127)
    return q8.to(torch.int8), scale.to(torch.bfloat16)


def check_slots(cfg: ModelConfig) -> None:
    """Raise ValueError for a slot whose mixer or ffn the model does not
    know, or a ``swa`` slot without a window."""
    for slot in cfg.slots:
        _slot_param_shapes(cfg, slot)
        if slot.mixer == "swa" and not cfg.sliding_window:
            raise ValueError(f"{cfg.name}: a 'swa' slot needs "
                             f"sliding_window")


def cache_spec(cfg: ModelConfig, batch: int, max_seq: int,
               dtype: torch.dtype | None = None) -> dict:
    """The decode cache's layout, the reference's: ``slot{i}`` to a dict
    of entry names to (shape, dtype), by the slot's mixer (the module
    docstring). ``dtype`` (default the compute dtype) is that of the
    f32/bf16 K/V caches, conv windows and shift states; the recurrent
    states are float32 whatever it is."""
    dtype = dtype or cfg.cdt
    g, nk, hd, d = cfg.num_groups, cfg.num_kv_heads, cfg.hd, cfg.d_model
    f32 = torch.float32
    spec: dict = {}
    for i, slot in enumerate(cfg.slots):
        if slot.mixer == "attn":
            kv = (g, batch, max_seq, nk, hd)
            if cfg.kv_cache_dtype == "int8":
                c = {"k": (kv, torch.int8), "v": (kv, torch.int8),
                     "k_scale": (kv[:-1], torch.bfloat16),
                     "v_scale": (kv[:-1], torch.bfloat16)}
            else:
                c = {"k": (kv, dtype), "v": (kv, dtype)}
        elif slot.mixer == "swa":
            w = cfg.sliding_window
            ring = (g, batch, w, nk, hd)
            c = {"k": (ring, dtype), "v": (ring, dtype),
                 "pos": ((g, w), torch.int32)}
        elif slot.mixer == "mamba":
            c = {"conv": ((g, batch, cfg.ssm_conv_width - 1, cfg.d_inner),
                          dtype),
                 "state": ((g, batch, cfg.d_inner, cfg.ssm_state_dim), f32)}
        elif slot.mixer == "rwkv":
            dh = cfg.rwkv_head_dim
            c = {"shift_t": ((g, batch, d), dtype),
                 "shift_c": ((g, batch, d), dtype),
                 "state": ((g, batch, cfg.rwkv_heads, dh, dh), f32)}
        else:
            raise ValueError(f"{cfg.name}: unknown mixer {slot.mixer!r}; "
                             f"expected one of {MIXERS}")
        spec[f"slot{i}"] = c
    return spec


# ==================================================================== model
def _group_views(params: Params, cfg: ModelConfig) -> list[list[dict]]:
    """Per-group views of the group-stacked slot parameters, [group][slot]
    → {name: tensor}: one ``unbind`` per stacked tensor, so a backward
    pass stacks the groups' gradients in one op."""
    per_slot = [{name: t.unbind(0) for name, t in params[f"slot{s}"].items()}
                for s in range(cfg.period)]
    return [[{name: ts[i] for name, ts in slot.items()} for slot in per_slot]
            for i in range(cfg.num_groups)]


class Model(nn.Module):
    """A model bound to its configuration and parameters (the reference's
    pytree, see the module docstring). The parameters are plain tensors,
    not ``nn.Parameter``s. `forward` records gradients through the leaves
    of the dict it is given (``params=``, by default the bound one); the
    trainer hands it aliases of the bound tensors that require grad and
    then updates the bound tensors in place
    (`repro_torch.train.optim.adamw_update`). `decode_step` reads them
    through per-layer views of their detached aliases, made once here:
    those see every in-place update and record no gradient."""

    def __init__(self, cfg: ModelConfig, params: Params):
        super().__init__()
        check_slots(cfg)
        self.cfg = cfg
        self.params = params
        self._layers = _group_views(
            {f"slot{s}": {name: t.detach() for name, t in
                          params[f"slot{s}"].items()}
             for s in range(cfg.period)}, cfg)

    @property
    def device(self) -> torch.device:
        return self.params["embed"].device

    def _embed(self, params: Params, tokens: torch.Tensor) -> torch.Tensor:
        """The token embeddings [B, S, d] in the compute dtype; on a mesh
        the table's FSDP shards gathered first, read through
        ``F.embedding`` (DTensor's masked lookup of a vocab-sharded
        table; its backward sums a repeated token's gradients in another
        order than the plain path's index backward), and the result
        placed by ``act_shard``'s batch entry."""
        table = params["embed"]
        if not spmd.is_dtensor(table):
            return table[tokens.long()].to(self.cfg.cdt)
        h = F.embedding(tokens.long(), spmd.unshard(table)).to(self.cfg.cdt)
        return self._constrain(h, batch_only=True)

    def _constrain(self, h: torch.Tensor, *, batch_only: bool = False
                   ) -> torch.Tensor:
        spec = self.cfg.act_shard
        if spec is None:
            return h
        return spmd.constrain(h, (spec[0], None, None) if batch_only
                              else spec)

    def _add(self, h: torch.Tensor, branch: torch.Tensor) -> torch.Tensor:
        """The residual h plus a mixer's or ffn's output; on a mesh the
        output (a partial sum over ``model`` after its row-sharded
        projection) is first reduced to ``act_shard``'s layout, in the
        compute dtype."""
        return h + self._constrain(branch)

    def _head(self, params: Params) -> torch.Tensor:
        head = (params["embed"].T if self.cfg.tie_embeddings
                else params["lm_head"])
        return spmd.unshard(head).to(self.cfg.cdt)

    # ---- full-sequence forward ----------------------------------------------
    def forward(self, tokens: torch.Tensor | None = None,
                embeds: torch.Tensor | None = None,
                positions: torch.Tensor | None = None, *,
                params: Params | None = None
                ) -> tuple[torch.Tensor, dict]:
        """tokens [B, S] and/or embeds [B, S_e, d] (embeds are prepended).
        Returns (logits [B, S_total, V], aux losses): with an MoE slot
        ``load_balance_loss`` and ``router_z_loss`` summed over the model's
        MoE layers, else empty. ``params`` (default the bound ones) are
        the tensors the result is differentiable in. While gradients are
        recorded and ``cfg.remat`` is set, each layer group runs under
        ``torch.utils.checkpoint`` (non-reentrant): its activations are
        recomputed in the backward pass, and the gradients are the same
        bits as without it."""
        params = self.params if params is None else params
        with spmd.implicit(spmd.on_mesh(params["embed"], tokens, embeds)):
            return self._forward(params, tokens, embeds, positions)

    def _forward(self, params, tokens, embeds, positions):
        cfg = self.cfg
        if tokens is not None:
            h = self._embed(params, tokens)
            if embeds is not None:
                h = torch.cat([embeds.to(cfg.cdt), h], dim=1)
        else:
            h = embeds.to(cfg.cdt)
        if positions is None:
            positions = torch.arange(h.shape[1], dtype=torch.int32,
                                     device=h.device)
        remat = cfg.remat and torch.is_grad_enabled()
        per_group = []
        for layer in _group_views(params, cfg):
            if remat:
                h, aux = checkpoint(self._group, h, layer, positions,
                                    use_reentrant=False)
            else:
                h, aux = self._group(h, layer, positions)
            per_group.append(aux)
        h = _norm_in(cfg, h, params["final_norm"])
        aux_total = {}
        if any(slot.ffn == "moe" for slot in cfg.slots):
            aux_total = {key: torch.stack([a[key] for a in per_group]).sum()
                         for key in AUX_KEYS}
        return h @ self._head(params), aux_total

    def _group(self, h: torch.Tensor, layer: list[dict],
               positions: torch.Tensor) -> tuple[torch.Tensor, dict]:
        """One layer group (a period of slots) over the residual h
        [B, S, d]; returns the new residual and the group's MoE losses."""
        cfg = self.cfg
        s = h.shape[1]
        aux: dict = {}
        for slot, p in zip(cfg.slots, spmd.unshard_layer(layer)):
            if slot.mixer in ("attn", "swa"):
                q, k, v = _qkv(cfg, p, h, positions)
                out = L.chunked_attention(
                    q, k, v, positions, positions, causal=not cfg.is_encoder,
                    window=(cfg.sliding_window if slot.mixer == "swa"
                            else None),
                    chunk_kv=min(cfg.attn_chunk, s))
                h = self._add(h, spmd.merge_last(out) @ p["wo"])
            elif slot.mixer == "mamba":
                h = self._add(h, _mamba_mixer(cfg, p, h))
            else:
                h = self._add(h, _rwkv_mixer(cfg, p, h))
            out = _ffn(cfg, slot, p, h, aux)
            if out is not None:
                h = self._add(h, out)
        return self._constrain(h), aux

    # ---- decode -------------------------------------------------------------
    def init_cache(self, batch: int, max_seq: int,
                   dtype: torch.dtype | None = None) -> Cache:
        """The decode cache of every slot (`cache_spec`'s layout): zeros,
        and the swa ``pos`` table at INT32_MAX."""
        cache: Cache = {}
        for slot, entries in cache_spec(self.cfg, batch, max_seq,
                                        dtype).items():
            cache[slot] = {}
            for name, (shape, dt) in entries.items():
                fill = POS_UNWRITTEN if name == "pos" else 0
                cache[slot][name] = torch.full(shape, fill, dtype=dt,
                                               device=self.device)
        return cache

    def decode_step(self, cache: Cache, tokens: torch.Tensor, pos: int, *,
                    backend: str = "cuda") -> tuple[torch.Tensor, Cache]:
        """One decode step: tokens [B, 1], ``pos`` this token's position
        (the number of tokens before it). Writes the token's keys and
        values (attn at ``pos``, swa at ``pos % window``) and the
        recurrent states into ``cache`` in place and returns (logits
        [B, V], cache). ``backend`` picks the decode attention of the
        ``attn`` slots: ``cuda`` (the flash-decode kernel) or ``torch``
        (the plain chunked attention); ``swa`` runs the chunked attention
        over its ring, as the reference does."""
        with spmd.implicit(spmd.on_mesh(self.params["embed"], tokens)):
            return self._decode_step(cache, tokens, int(pos), backend)

    def _decode_step(self, cache, tokens, pos, backend):
        cfg = self.cfg
        h = self._embed(self.params, tokens)                     # [B, 1, d]
        positions = torch.full((1,), pos, dtype=torch.int32,
                               device=h.device)
        for i, layer in enumerate(self._layers):
            for s, (slot, p) in enumerate(zip(cfg.slots,
                                              spmd.unshard_layer(layer))):
                c = cache[f"slot{s}"]
                if slot.mixer == "attn":
                    h = self._decode_attn(p, c, i, h, pos, positions,
                                          backend)
                elif slot.mixer == "swa":
                    h = self._decode_swa(p, c, i, h, pos, positions)
                elif slot.mixer == "mamba":
                    h = self._decode_mamba(p, c, i, h)
                else:
                    h = self._decode_rwkv(p, c, i, h)
                if slot.ffn == "rwkv_cmix":
                    h = self._decode_cmix(p, c, i, h)
                else:
                    out = _ffn(cfg, slot, p, h)
                    if out is not None:
                        h = self._add(h, out)
        h = L.rms_norm(h, self.params["final_norm"])
        return h[:, 0] @ self._head(self.params), cache

    def _decode_attn(self, p: dict, c: dict, group: int, h: torch.Tensor,
                     pos: int, positions: torch.Tensor,
                     backend: str) -> torch.Tensor:
        cfg = self.cfg
        cur = pos + 1
        q, k, v = _qkv(cfg, p, h, positions)
        if cfg.kv_cache_dtype == "int8":
            for name, t in (("k", k), ("v", v)):
                q8, scale = _quantize(t)
                spmd.assign(c[name], (group, slice(None), pos), q8[:, 0])
                spmd.assign(c[f"{name}_scale"], (group, slice(None), pos),
                            scale[:, 0])
            # dequantize the valid prefix only: the positions beyond it
            # are masked, so the function is the reference's
            kd, vd = (c[n][group, :, :cur].to(cfg.cdt)
                      * c[f"{n}_scale"][group, :, :cur, :, None].to(cfg.cdt)
                      for n in ("k", "v"))
        else:
            for name, t in (("k", k), ("v", v)):
                spmd.assign(c[name], (group, slice(None), pos),
                            t[:, 0].to(c[name].dtype))
            kd, vd = c["k"][group], c["v"][group]
        out = L.decode_attention(q, kd, vd, cur, backend=backend)
        return self._add(h, spmd.merge_last(out) @ p["wo"])

    def _decode_swa(self, p: dict, c: dict, group: int, h: torch.Tensor,
                    pos: int, positions: torch.Tensor) -> torch.Tensor:
        """The sliding-window ring: the token's keys and values at
        ``pos % w``, its position in the ``pos`` table, attention over the
        ring masked by position (causal, window, unwritten)."""
        cfg = self.cfg
        w = cfg.sliding_window
        ring = pos % w
        q, k, v = _qkv(cfg, p, h, positions)
        for name, t in (("k", k), ("v", v)):
            spmd.assign(c[name], (group, slice(None), ring),
                        t[:, 0].to(c[name].dtype))
        # from the device tensor: a Python int written here is a host copy
        spmd.assign(c["pos"], (group, slice(ring, ring + 1)), positions)
        out = L.chunked_attention(
            q, c["k"][group], c["v"][group], positions, c["pos"][group],
            causal=True, window=w, chunk_kv=min(cfg.attn_chunk, w))
        return self._add(h, spmd.merge_last(out) @ p["wo"])

    def _decode_mamba(self, p: dict, c: dict, group: int,
                      h: torch.Tensor) -> torch.Tensor:
        xi, z = _mamba_in(self.cfg, p, h[:, 0])
        conv = c["conv"][group]
        xin = xi[:, None, :].to(conv.dtype)
        xi = F.silu(ssm_lib.causal_conv1d(xin, p["conv_w"], prev=conv)[:, 0])
        args = (xi, _mamba_delta(p, xi), p["a_log"], xi @ p["w_b"],
                xi @ p["w_c"], p["d_skip"], c["state"][group])
        if not spmd.is_dtensor(xi):
            y, state = ssm_lib.ssm_step(*args)
        else:
            lay = spmd.Layout(xi, self.cfg.d_inner)
            inner = lay.placements(2, batch=0, inner=1)
            st = lay.placements(3, batch=0, inner=1)
            y, state = spmd.local_call(
                ssm_lib.ssm_step, lay.mesh, args,
                (inner, inner, lay.placements(2, inner=0),
                 lay.placements(2, batch=0), lay.placements(2, batch=0),
                 lay.placements(1, inner=0), st), (inner, st),
                (xi.shape, args[-1].shape))
        conv.copy_(torch.cat([conv[:, 1:], xin], dim=1))
        spmd.assign(c["state"], (group,), state)
        return self._add(h, ((y * F.silu(z)) @ p["out"])[:, None, :])

    def _decode_rwkv(self, p: dict, c: dict, group: int,
                     h: torch.Tensor) -> torch.Tensor:
        x = L.rms_norm(h, p["norm_mix"])                        # [B, 1, d]
        r, k, v, w, g = _rwkv_inputs(self.cfg, p, x, c["shift_t"][group])
        args = (r[:, 0], k[:, 0], v[:, 0], w[:, 0], p["u"],
                c["state"][group])
        if not spmd.is_dtensor(r):
            out, state = rwkv_lib.wkv6_step(*args)
        else:
            lay = spmd.Layout(args[0], self.cfg.rwkv_heads)
            heads = lay.placements(3, batch=0, inner=1)
            st = lay.placements(4, batch=0, inner=1)
            out, state = spmd.local_call(
                rwkv_lib.wkv6_step, lay.mesh, args,
                (heads,) * 4 + (lay.placements(2, inner=0), st),
                (heads, st), (args[0].shape, args[-1].shape))
        spmd.assign(c["shift_t"], (group,), x[:, 0].to(c["shift_t"].dtype))
        spmd.assign(c["state"], (group,), state)
        return self._add(h, _rwkv_out(p, out[:, None], g))

    def _decode_cmix(self, p: dict, c: dict, group: int,
                     h: torch.Tensor) -> torch.Tensor:
        x = L.rms_norm(h, p["norm_ffn"])                        # [B, 1, d]
        out = rwkv_lib.channel_mix(x, p["mu_c"], p["cm_r"], p["cm_k"],
                                   p["cm_v"], c["shift_c"][group])
        spmd.assign(c["shift_c"], (group,), x[:, 0].to(c["shift_c"].dtype))
        return self._add(h, out)
