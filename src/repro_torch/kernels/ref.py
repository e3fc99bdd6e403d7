"""Plain PyTorch versions of the featurize, Gram and decode-attention
kernels."""
from __future__ import annotations

import torch


def rff_features_ref(omega: torch.Tensor, bias: torch.Tensor,
                     x: torch.Tensor, *, scale: float) -> torch.Tensor:
    """Z = scale · cos(Ω X + b)."""
    return torch.cos(omega @ x + bias.reshape(-1, 1)) * scale


def rff_gram_ref(omega: torch.Tensor, bias: torch.Tensor, x: torch.Tensor,
                 y: torch.Tensor, *, scale: float
                 ) -> tuple[torch.Tensor, torch.Tensor]:
    """(Z Zᵀ, Z yᵀ) on materialized features."""
    z = rff_features_ref(omega, bias, x, scale=scale)
    return z @ z.T, z @ y.reshape(-1)


def chunked_decode_attention_ref(q: torch.Tensor, k: torch.Tensor,
                                 v: torch.Tensor, *, scale: float,
                                 mask: torch.Tensor | None = None
                                 ) -> torch.Tensor:
    """Single-query attention oracle: q [B, H, dh], k/v [B, S, H, dh],
    mask [B, S] (True = attend)."""
    s = torch.einsum("bhd,bshd->bhs", q, k) * scale
    if mask is not None:
        s = torch.where(mask[:, None, :], s,
                        torch.full_like(s, float("-inf")))
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhs,bshd->bhd", p, v)
