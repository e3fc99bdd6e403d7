"""Shared transformer layers: norms, RoPE, attention (chunked online
softmax with GQA / sliding window / bidirectional), MLPs.

The port's counterpart of `repro.models.layers`. Every function computes
its statistics in float32 and returns the input's dtype, as there.

Attention is a chunked online softmax over KV chunks, so the S×S score
matrix never materialises. Decode attention has two backends:

* ``cuda`` — `repro_torch.kernels.ops.flash_decode`: the hand-written
  flash-decode kernel on CUDA tensors, its plain version on CPU tensors;
* ``torch`` — `chunked_attention` over one chunk spanning the cache,
  which is what the reference's ``decode_step`` runs.

Both compute the same function (the reference's decode path and its
Pallas kernel share one oracle).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.kernels import ops

_NEG_INF = -1e30   # finite mask value: keeps fully-masked rows NaN-free
_POS_PAD = torch.iinfo(torch.int32).max   # position of chunk padding
DECODE_BACKENDS = ("cuda", "torch")


# ------------------------------------------------------------------- norms
def rms_norm(x: torch.Tensor, weight: torch.Tensor,
             eps: float = 1e-6) -> torch.Tensor:
    xf = x.float()
    var = (xf * xf).mean(dim=-1, keepdim=True)
    out = xf * torch.rsqrt(var + eps)
    return (out * weight.float()).to(x.dtype)


def layer_norm(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
               eps: float = 1e-5) -> torch.Tensor:
    xf = x.float()
    mu = xf.mean(dim=-1, keepdim=True)
    var = xf.var(dim=-1, keepdim=True, unbiased=False)
    out = (xf - mu) * torch.rsqrt(var + eps)
    return (out * weight.float() + bias.float()).to(x.dtype)


# -------------------------------------------------------------------- RoPE
def rope_freqs(head_dim: int, theta: float = 10000.0, *,
               device=None) -> torch.Tensor:
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32,
                        device=device) / head_dim
    return 1.0 / (theta ** exps)


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float = 10000.0) -> torch.Tensor:
    """x [..., S, H, dh], positions [..., S] (broadcastable). Rotates the
    two halves of dh (non-interleaved), in float32."""
    dh = x.shape[-1]
    freqs = rope_freqs(dh, theta, device=x.device)         # [dh/2]
    angles = positions[..., :, None].float() * freqs       # [.., S, dh/2]
    cos = torch.cos(angles)[..., :, None, :]               # [.., S, 1, dh/2]
    sin = torch.sin(angles)[..., :, None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


# --------------------------------------------------------------- attention
def chunked_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      q_positions: torch.Tensor, kv_positions: torch.Tensor,
                      *, causal: bool = True, window: int | None = None,
                      chunk_kv: int = 1024,
                      kv_valid_len: int | torch.Tensor | None = None
                      ) -> torch.Tensor:
    """Online-softmax attention, looping over KV chunks.

    q [B, Sq, H, dh], k/v [B, Skv, K, dh], q_positions [Sq] and
    kv_positions [Skv] absolute positions. GQA: H query heads share K kv
    heads (H % K == 0). Masks: causal (q_pos ≥ kv_pos), sliding window
    (q_pos − kv_pos < window), kv positions ≥ ``kv_valid_len``, and the
    chunk padding. Softmax statistics are carried in float32.
    """
    b, sq, h, dh = q.shape
    _, skv, kh, _ = k.shape
    if h % kh:
        raise ValueError(f"num_heads {h} is not a multiple of "
                         f"num_kv_heads {kh}")
    g = h // kh
    scale = dh ** -0.5
    nkv = -(-skv // chunk_kv)
    pad = nkv * chunk_kv - skv
    if pad:
        k = F.pad(k, (0, 0, 0, 0, 0, pad))
        v = F.pad(v, (0, 0, 0, 0, 0, pad))
        kv_positions = F.pad(kv_positions, (0, pad), value=_POS_PAD)
    qg = q.float().reshape(b, sq, kh, g, dh)
    m = torch.full((b, sq, h), _NEG_INF, dtype=torch.float32,
                   device=q.device)
    l = torch.zeros((b, sq, h), dtype=torch.float32, device=q.device)
    acc = torch.zeros((b, sq, h, dh), dtype=torch.float32, device=q.device)
    for c in range(nkv):
        sl = slice(c * chunk_kv, (c + 1) * chunk_kv)
        kc, vc, pc = k[:, sl].float(), v[:, sl].float(), kv_positions[sl]
        s = torch.einsum("bqkgd,bckd->bqkgc", qg, kc)
        s = s.reshape(b, sq, h, chunk_kv) * scale
        mask = (pc < _POS_PAD)[None, :].expand(sq, chunk_kv)
        if causal:
            mask = mask & (q_positions[:, None] >= pc[None, :])
        if window is not None:
            mask = mask & (q_positions[:, None] - pc[None, :] < window)
        if kv_valid_len is not None:
            mask = mask & (pc < kv_valid_len)[None, :]
        s = torch.where(mask[None, :, None, :], s,
                        torch.full_like(s, _NEG_INF))
        m_new = torch.maximum(m, s.amax(dim=-1))
        alpha = torch.exp(m - m_new)
        p = torch.exp(s - m_new[..., None])
        l = l * alpha + p.sum(dim=-1)
        pv = torch.einsum("bqkgc,bckd->bqkgd",
                          p.reshape(b, sq, kh, g, chunk_kv), vc)
        acc = acc * alpha[..., None] + pv.reshape(b, sq, h, dh)
        m = m_new
    out = acc / torch.clamp_min(l[..., None], 1e-30)
    return out.to(q.dtype)


def decode_attention(q: torch.Tensor, k_cache: torch.Tensor,
                     v_cache: torch.Tensor, cur_index: int, *,
                     backend: str = "cuda") -> torch.Tensor:
    """Single-token decode attention: q [B, 1, H, dh] against k/v caches
    [B, S, K, dh] whose first ``cur_index`` positions are valid; returns
    [B, 1, H, dh].

    ``backend="cuda"`` runs `ops.flash_decode`; ``backend="torch"`` runs
    `chunked_attention` with the query at position ``cur_index − 1`` and
    one chunk spanning the cache, as the reference's decode step does."""
    if backend == "cuda":
        return ops.flash_decode(q, k_cache, v_cache, cur_index)
    if backend != "torch":
        raise ValueError(f"decode_attention: unknown backend {backend!r}; "
                         f"expected one of {DECODE_BACKENDS}")
    s = k_cache.shape[1]
    cur = int(cur_index)
    kv_pos = torch.arange(s, dtype=torch.int32, device=q.device)
    q_pos = torch.full((1,), cur - 1, dtype=torch.int32, device=q.device)
    return chunked_attention(q, k_cache, v_cache, q_pos, kv_pos,
                             causal=True, chunk_kv=s, kv_valid_len=cur)


# --------------------------------------------------------------------- MLP
def swiglu_mlp(x: torch.Tensor, w_gate: torch.Tensor, w_up: torch.Tensor,
               w_down: torch.Tensor) -> torch.Tensor:
    return (F.silu(x @ w_gate) * (x @ w_up)) @ w_down


def gelu_mlp(x: torch.Tensor, w_up: torch.Tensor, b_up: torch.Tensor,
             w_down: torch.Tensor, b_down: torch.Tensor) -> torch.Tensor:
    h = F.gelu(x @ w_up + b_up, approximate="tanh")
    return h @ w_down + b_down
