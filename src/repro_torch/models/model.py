"""Model assembly of the LLM serving path: the port's counterpart of
`repro.models.model`.

A model is ``num_groups`` repetitions of a *period* of slots
(``cfg.slots``); each slot is a (mixer, ffn) pair. The configuration
(`ModelConfig`, `SlotSpec`) and the parameter shapes cover every family
of the reference (so `analytic_param_count` holds for all ten
architectures of the registry), but `Model` runs the ``attn`` mixer with the ``dense``
ffn (swiglu or gelu) only: the ``swa`` ring, ``mamba``, ``rwkv``,
``rwkv_cmix`` and ``moe`` raise `NotImplementedError` until their ROADMAP
item (slice 10b) ports them.

Parameters keep the reference's pytree layout and its [in, out] weights
(``x @ w``): ``{"embed": [V, d], "final_norm": [d], "lm_head": [d, V],
"slot{i}": {name: [num_groups, ...]}}``, so carrying weights across
(`repro_torch.interop.lm_params_from_arrays`) is a copy, not a
transpose. Caches keep the reference's layout too:
``{"slot{i}": {"k": [g, B, S, K, dh], "v": ...}}``, plus ``k_scale`` /
``v_scale`` [g, B, S, K] in bf16 for the int8 cache.

Two entry points:

  forward(tokens)                   — full sequence, chunked attention;
  decode_step(cache, tokens, pos)   — one token against the cache; the
                                      cache is updated in place (the
                                      reference returns a new pytree from
                                      ``dynamic_update_slice``) and
                                      returned.
"""
from __future__ import annotations

import dataclasses
import math

import torch
from torch import nn

from repro_torch.models import layers as L

Params = dict
Cache = dict

_NOT_PORTED = {
    "swa": "the sliding-window KV ring",
    "mamba": "the Mamba mixer (models/ssm.py)",
    "rwkv": "the RWKV-6 time mix (models/rwkv.py)",
    "rwkv_cmix": "the RWKV-6 channel mix (models/rwkv.py)",
    "moe": "the MoE ffn (models/moe.py)",
}


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
    # the reference's sharding and dry-run analysis switches; the port
    # keeps them so configurations compare field for field, and ignores
    # them (one device, eager)
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


def check_ported(cfg: ModelConfig) -> None:
    """Raise NotImplementedError for a slot the port does not run yet."""
    for slot in cfg.slots:
        for part, ported in ((slot.mixer, "attn"), (slot.ffn, "dense")):
            if part != ported:
                what = _NOT_PORTED.get(part, f"the slot part {part!r}")
                raise NotImplementedError(
                    f"{cfg.name}: {what} ({part!r}) is not ported yet "
                    f"(ROADMAP slice 10b); the port runs the 'attn' mixer "
                    f"with the 'dense' ffn")


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
        raise ValueError(slot.mixer)

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
        raise ValueError(slot.ffn)
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
                      dtype=torch.float32) * scale
    return out.to(dtype)


def init_params(cfg: ModelConfig, generator: torch.Generator) -> Params:
    """Seeded initialisation on ``generator``'s device, with the
    reference's scheme: embeddings N(0, 0.02²), weights N(0, 1/fan_in),
    norms 1, biases 0 (except the gelu ffn's ``b_up``, drawn as a
    weight). The draws are torch's, not the reference's: parity tests
    carry the reference's parameters across instead."""
    check_ported(cfg)
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
            if name.startswith("norm"):
                p = torch.ones((g,) + shape, dtype=cfg.pdt, device=dev)
            elif name.startswith("b") and name != "b_up":
                p = torch.zeros((g,) + shape, dtype=cfg.pdt, device=dev)
            else:
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
def _qkv(cfg: ModelConfig, p: dict, h: torch.Tensor,
         positions: torch.Tensor):
    b, s, _ = h.shape
    nh, nk, hd = cfg.num_heads, cfg.num_kv_heads, cfg.hd
    x = L.rms_norm(h, p["norm_mix"])
    q = x @ p["wq"]
    k = x @ p["wk"]
    v = x @ p["wv"]
    if cfg.qkv_bias:
        q, k, v = q + p["bq"], k + p["bk"], v + p["bv"]
    q = L.apply_rope(q.reshape(b, s, nh, hd), positions, cfg.rope_theta)
    k = L.apply_rope(k.reshape(b, s, nk, hd), positions, cfg.rope_theta)
    return q, k, v.reshape(b, s, nk, hd)


def _ffn(cfg: ModelConfig, p: dict, h: torch.Tensor) -> torch.Tensor:
    x = L.rms_norm(h, p["norm_ffn"])
    if cfg.act == "swiglu":
        return L.swiglu_mlp(x, p["w_gate"], p["w_up"], p["w_down"])
    return L.gelu_mlp(x, p["w_up"], p["b_up"], p["w_down"], p["b_down"])


def _quantize(t: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """[B, 1, K, dh] → int8 codes and bf16 per-(token, head) scales;
    ``torch.round`` rounds half to even, as ``jnp.round`` does."""
    amax = t.abs().amax(dim=-1)
    scale = torch.clamp_min(amax, 1e-6) / 127.0
    q8 = torch.clamp(torch.round(t / scale[..., None]), -127, 127)
    return q8.to(torch.int8), scale.to(torch.bfloat16)


# ==================================================================== model
class Model(nn.Module):
    """A dense-attention model bound to its configuration and parameters
    (the reference's pytree, see the module docstring). Inference only:
    the parameters are plain tensors and nothing records gradients."""

    def __init__(self, cfg: ModelConfig, params: Params):
        super().__init__()
        check_ported(cfg)
        self.cfg = cfg
        self.params = params
        # per-layer views of the group-stacked slot parameters
        self._layers = [
            [{name: t[i] for name, t in params[f"slot{s}"].items()}
             for s in range(cfg.period)]
            for i in range(cfg.num_groups)]

    @property
    def device(self) -> torch.device:
        return self.params["embed"].device

    def _head(self) -> torch.Tensor:
        head = (self.params["embed"].T if self.cfg.tie_embeddings
                else self.params["lm_head"])
        return head.to(self.cfg.cdt)

    # ---- full-sequence forward ----------------------------------------------
    def forward(self, tokens: torch.Tensor | None = None,
                embeds: torch.Tensor | None = None,
                positions: torch.Tensor | None = None
                ) -> tuple[torch.Tensor, dict]:
        """tokens [B, S] and/or embeds [B, S_e, d] (embeds are prepended).
        Returns (logits [B, S_total, V], aux-loss dict), the dict empty
        (no MoE)."""
        cfg = self.cfg
        if tokens is not None:
            h = self.params["embed"][tokens.long()].to(cfg.cdt)
            if embeds is not None:
                h = torch.cat([embeds.to(cfg.cdt), h], dim=1)
        else:
            h = embeds.to(cfg.cdt)
        s = h.shape[1]
        if positions is None:
            positions = torch.arange(s, dtype=torch.int32, device=h.device)
        for layer in self._layers:
            for p in layer:
                q, k, v = _qkv(cfg, p, h, positions)
                out = L.chunked_attention(
                    q, k, v, positions, positions, causal=not cfg.is_encoder,
                    chunk_kv=min(cfg.attn_chunk, s))
                h = h + out.reshape(h.shape[0], s, -1) @ p["wo"]
                h = h + _ffn(cfg, p, h)
        h = L.rms_norm(h, self.params["final_norm"])
        return h @ self._head(), {}

    # ---- decode -------------------------------------------------------------
    def init_cache(self, batch: int, max_seq: int,
                   dtype: torch.dtype | None = None) -> Cache:
        cfg = self.cfg
        dtype = dtype or cfg.cdt
        kw = dict(device=self.device)
        shape = (cfg.num_groups, batch, max_seq, cfg.num_kv_heads, cfg.hd)
        cache: Cache = {}
        for i in range(cfg.period):
            if cfg.kv_cache_dtype == "int8":
                cache[f"slot{i}"] = {
                    "k": torch.zeros(shape, dtype=torch.int8, **kw),
                    "v": torch.zeros(shape, dtype=torch.int8, **kw),
                    "k_scale": torch.zeros(shape[:-1], dtype=torch.bfloat16,
                                           **kw),
                    "v_scale": torch.zeros(shape[:-1], dtype=torch.bfloat16,
                                           **kw)}
            else:
                cache[f"slot{i}"] = {
                    "k": torch.zeros(shape, dtype=dtype, **kw),
                    "v": torch.zeros(shape, dtype=dtype, **kw)}
        return cache

    def decode_step(self, cache: Cache, tokens: torch.Tensor, pos: int, *,
                    backend: str = "cuda") -> tuple[torch.Tensor, Cache]:
        """One decode step: tokens [B, 1], ``pos`` this token's position
        (the number of cached positions before it). Writes the token's
        keys and values into ``cache`` at ``pos`` in place and returns
        (logits [B, V], cache). ``backend`` picks the decode attention:
        ``cuda`` (the flash-decode kernel) or ``torch`` (the plain
        chunked attention)."""
        cfg = self.cfg
        pos = int(pos)
        h = self.params["embed"][tokens.long()].to(cfg.cdt)      # [B, 1, d]
        positions = torch.full((1,), pos, dtype=torch.int32,
                               device=h.device)
        for i, layer in enumerate(self._layers):
            for s, p in enumerate(layer):
                h = self._decode_attn(p, cache[f"slot{s}"], i, h, pos,
                                      positions, backend)
                h = h + _ffn(cfg, p, h)
        h = L.rms_norm(h, self.params["final_norm"])
        return h[:, 0] @ self._head(), cache

    def _decode_attn(self, p: dict, c: dict, group: int, h: torch.Tensor,
                     pos: int, positions: torch.Tensor,
                     backend: str) -> torch.Tensor:
        cfg = self.cfg
        b = h.shape[0]
        cur = pos + 1
        q, k, v = _qkv(cfg, p, h, positions)
        if cfg.kv_cache_dtype == "int8":
            for name, t in (("k", k), ("v", v)):
                q8, scale = _quantize(t)
                c[name][group, :, pos] = q8[:, 0]
                c[f"{name}_scale"][group, :, pos] = scale[:, 0]
            # dequantize the valid prefix only: the positions beyond it
            # are masked, so the function is the reference's
            kd, vd = (c[n][group, :, :cur].to(cfg.cdt)
                      * c[f"{n}_scale"][group, :, :cur, :, None].to(cfg.cdt)
                      for n in ("k", "v"))
        else:
            c["k"][group, :, pos] = k[:, 0].to(c["k"].dtype)
            c["v"][group, :, pos] = v[:, 0].to(c["v"].dtype)
            kd, vd = c["k"][group], c["v"][group]
        out = L.decode_attention(q, kd, vd, cur, backend=backend)
        return h + out.reshape(b, 1, -1) @ p["wo"]
