"""Plain PyTorch versions of the featurize and Gram kernels."""
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
