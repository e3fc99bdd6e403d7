"""Selective SSM (Mamba), the state-space mixer of Jamba: the port's
counterpart of `repro.models.ssm`.

Diagonal selective scan over x [B, S, d_inner] (after the causal conv and
its activation):

    Δ_t = softplus(x_t W_Δ + b_Δ)
    h_t = exp(Δ_t ⊗ A) ⊙ h_{t−1} + (Δ_t x_t) ⊗ B_t     (A = −exp(a_log))
    y_t = ⟨h_t, C_t⟩_N + D ⊙ x_t

A and the [B, d_inner, N] state are float32; y is cast back to x's dtype
before the D skip, as in the reference. The reference scans in time
chunks only for ``jax.checkpoint``; the port loops over time through the
update `ssm_step` makes, so ``chunk`` changes no bit and the scan equals
repeated steps bit for bit. Decode keeps the conv window and the state:
constant-size in the context length.
"""
from __future__ import annotations

import torch


def causal_conv1d(x: torch.Tensor, w: torch.Tensor,
                  prev: torch.Tensor | None = None) -> torch.Tensor:
    """Depthwise causal conv: x [B, S, C], w [K, C]; ``prev`` [B, K−1, C]
    the window before x (decode), zeros otherwise."""
    ksz = w.shape[0]
    if prev is None:
        xp = torch.nn.functional.pad(x, (0, 0, ksz - 1, 0))
    else:
        xp = torch.cat([prev, x], dim=1)
    s = x.shape[1]
    out = xp[:, 0:s, :] * w[0][None, None, :]
    for i in range(1, ksz):
        out = out + xp[:, i:i + s, :] * w[i][None, None, :]
    return out


def _ssm_update(x: torch.Tensor, delta: torch.Tensor, a: torch.Tensor,
                b_t: torch.Tensor, c_t: torch.Tensor, state: torch.Tensor
                ) -> tuple[torch.Tensor, torch.Tensor]:
    """One step on float32 x/Δ [B, d_inner], B/C [B, N], A [d_inner, N]
    and the state [B, d_inner, N]: (y [B, d_inner] before the skip, new
    state)."""
    da = torch.exp(delta[..., None] * a[None])
    st = da * state + (delta * x)[..., None] * b_t[:, None, :]
    return (st @ c_t[..., None])[..., 0], st


def ssm_chunk_scan(x: torch.Tensor, delta: torch.Tensor,
                   a_log: torch.Tensor, b_t: torch.Tensor,
                   c_t: torch.Tensor, d_skip: torch.Tensor,
                   state: torch.Tensor, *, chunk: int = 128
                   ) -> tuple[torch.Tensor, torch.Tensor]:
    """x/Δ [B, S, d_inner], a_log [d_inner, N], B/C [B, S, N], D
    [d_inner], state [B, d_inner, N]. Returns (y [B, S, d_inner] in x's
    dtype, new state in float32). ``chunk`` is the reference's
    checkpoint interval and does not change the result."""
    if chunk < 1:
        raise ValueError(f"chunk must be positive, got {chunk}")
    a = -torch.exp(a_log.float())
    xt, dt, bt, ct = (t.float().transpose(0, 1).contiguous()
                      for t in (x, delta, b_t, c_t))
    st = state.float()
    ys = []
    for t in range(x.shape[1]):
        y, st = _ssm_update(xt[t], dt[t], a, bt[t], ct[t], st)
        ys.append(y)
    y = torch.stack(ys, dim=1).to(x.dtype)
    return y + x * d_skip[None, None, :].to(x.dtype), st


def ssm_step(x: torch.Tensor, delta: torch.Tensor, a_log: torch.Tensor,
             b_t: torch.Tensor, c_t: torch.Tensor, d_skip: torch.Tensor,
             state: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """One decode step: x/Δ [B, d_inner], B/C [B, N]. Returns (y in x's
    dtype, new state in float32)."""
    a = -torch.exp(a_log.float())
    y, st = _ssm_update(*(t.float().contiguous() for t in (x, delta)), a,
                        *(t.float().contiguous() for t in (b_t, c_t)),
                        state.float())
    return y.to(x.dtype) + x * d_skip[None, :].to(x.dtype), st
