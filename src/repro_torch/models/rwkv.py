"""RWKV-6 ("Finch", arXiv:2404.05892) time mix and channel mix: the
port's counterpart of `repro.models.rwkv`.

The data-dependent decay w_t = exp(−exp(w0 + tanh(x W_a) W_b)) drives the
per-head matrix state S_t = diag(w_t) S_{t−1} + k_t v_tᵀ, read out with
the current-token bonus u before the update:

    out_t = r_t · (S_{t−1} + diag(u) k_t v_tᵀ)

The recurrence runs in float32 whatever the compute dtype. The reference
scans time in chunks only to bound what ``jax.checkpoint`` keeps; the
port runs one loop over time through the same update as `wkv6_step`, so
``chunk`` changes no bit of the result and the scan equals repeated steps
bit for bit. As in the reference, the 5-way data-dependent token shift of
the full Finch block is reduced to single learned-μ lerps.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.models import spmd

DECAY_RATE_MIN = 1e-6    # w = exp(−rate) < 1 when exp(log_w) underflows
DECAY_RATE_MAX = 80.0    # w > 0 when exp(log_w) overflows


def _wkv_update(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                w: torch.Tensor, u: torch.Tensor, state: torch.Tensor
                ) -> tuple[torch.Tensor, torch.Tensor]:
    """One step on float32 [B, H, dh] inputs and the [B, H, dh, dh] state:
    (out [B, H, dh], new state)."""
    kv = k[..., :, None] * v[..., None, :]
    out = (r[..., None, :] @ (state + u[None, :, :, None] * kv))[..., 0, :]
    return out, w[..., :, None] * state + kv


def wkv6_chunk_scan(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    w: torch.Tensor, u: torch.Tensor, state: torch.Tensor,
                    *, chunk: int = 128) -> tuple[torch.Tensor, torch.Tensor]:
    """r/k/v/w [B, S, H, dh] (w the decay in (0, 1)), u [H, dh], state
    [B, H, dh, dh] (key dim × value dim). Returns (out [B, S, H, dh] in
    r's dtype, new state in float32). ``chunk`` is the reference's
    checkpoint interval and does not change the result."""
    if chunk < 1:
        raise ValueError(f"chunk must be positive, got {chunk}")
    # time-major float32 copies, so each step reads contiguous [B, H, dh]
    rt, kt, vt, wt = (a.float().transpose(0, 1).contiguous()
                      for a in (r, k, v, w))
    uf = u.float()
    st = state.float()
    outs = []
    for t in range(r.shape[1]):
        out, st = _wkv_update(rt[t], kt[t], vt[t], wt[t], uf, st)
        outs.append(out)
    return torch.stack(outs, dim=1).to(r.dtype), st


def wkv6_step(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              w: torch.Tensor, u: torch.Tensor, state: torch.Tensor
              ) -> tuple[torch.Tensor, torch.Tensor]:
    """One decode step on [B, H, dh] inputs (the state stays [B, H, dh,
    dh], whatever the context length). Returns (out in r's dtype, new
    state in float32)."""
    out, st = _wkv_update(*(a.float().contiguous() for a in (r, k, v, w)),
                          u.float(), state.float())
    return out.to(r.dtype), st


def data_dependent_decay(x: torch.Tensor, w0: torch.Tensor,
                         w_a: torch.Tensor, w_b: torch.Tensor,
                         num_heads: int) -> torch.Tensor:
    """w_t = exp(−exp(w0 + tanh(x W_a) W_b)) ∈ (0, 1); x [B, S, d] →
    [B, S, H, dh]. The rate exp(log_w) is clamped to [1e-6, 80] in
    float32 so w stays inside the open interval. On a mesh each rank
    computes its batch shard and its heads' slice of d (the low-rank
    bottleneck whole), so no gradient of the bottleneck is split over
    the sequence."""
    def decay(x, w0, w_a, w_b):
        log_w = w0[None, None, :] + torch.tanh(x @ w_a) @ w_b
        rate = torch.clamp(torch.exp(log_w.float()), DECAY_RATE_MIN,
                           DECAY_RATE_MAX)
        heads = num_heads * w_b.shape[-1] // x.shape[-1]
        return torch.exp(-rate).reshape(*x.shape[:-1], heads, -1) \
            .to(x.dtype)

    if not spmd.is_dtensor(x):
        return decay(x, w0, w_a, w_b)
    lay = spmd.Layout(x, num_heads)
    out = lay.placements(4, batch=0, inner=2)
    return spmd.local_call(
        decay, lay.mesh, (x, w0, w_a, w_b),
        (lay.placements(3, batch=0), lay.placements(1, inner=0),
         lay.placements(2), lay.placements(2, inner=1)), (out,),
        ((*x.shape[:-1], num_heads, x.shape[-1] // num_heads),))


def token_shift(x: torch.Tensor, mu: torch.Tensor,
                prev: torch.Tensor | None = None) -> torch.Tensor:
    """lerp(x, x_{t−1}, μ) over x [B, S, d]; ``prev`` [B, d] is the
    decode-time shift state (zeros before the first token otherwise)."""
    if prev is None:
        shifted = F.pad(x, (0, 0, 1, 0))[:, :-1]
    else:
        shifted = prev[:, None, :]
    return x + mu * (shifted - x)


def channel_mix(x: torch.Tensor, mu: torch.Tensor, w_r: torch.Tensor,
                w_k: torch.Tensor, w_v: torch.Tensor,
                prev: torch.Tensor | None = None) -> torch.Tensor:
    """RWKV channel mix: a sigmoid receptance gate on a squared-ReLU MLP."""
    xs = token_shift(x, mu, prev)
    rgate = torch.sigmoid(xs @ w_r)
    h = torch.square(torch.relu(xs @ w_k))
    return rgate * (h @ w_v)
