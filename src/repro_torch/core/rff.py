"""Random Fourier features (Rahimi & Recht, 2007) for shift-invariant kernels.

Feature-matrix convention follows the paper: Z(X) ∈ R^{D_feat × N} with
columns z(x_i). Two real-valued constructions for the Gaussian kernel
k(x, x') = exp(-||x - x'||² / (2σ²)):

  cos_sin  (Eq. 9):  ψ(ω, x) = 1/√D [cos(ωᵀx); sin(ωᵀx)]      (D_feat = 2D)
  cos_bias (Eq. 10): ψ(ω, x) = √(2/D) cos(ωᵀx + b), b ~ U[0,2π) (D_feat = D)

The scale is folded into the feature map so that z(x)ᵀz(x') ≈ k(x, x').
"""
from __future__ import annotations

import dataclasses
import math

import torch

_KINDS = ("cos_sin", "cos_bias")


@dataclasses.dataclass
class FeatureMap:
    """A concrete RFF map: frozen frequencies (and biases)."""

    omega: torch.Tensor          # [D, d]
    bias: torch.Tensor | None    # [D] for cos_bias, None for cos_sin
    kind: str                    # "cos_sin" | "cos_bias"

    @property
    def num_frequencies(self) -> int:
        return self.omega.shape[0]

    @property
    def num_features(self) -> int:
        d = self.omega.shape[0]
        return 2 * d if self.kind == "cos_sin" else d

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        """Featurize. x: [d, N] (paper layout) → Z: [num_features, N]."""
        return featurize(self, x)

    def subset(self, idx: torch.Tensor) -> "FeatureMap":
        """Select a subset of frequencies (DDRF top-D selection)."""
        return FeatureMap(
            omega=self.omega[idx],
            bias=None if self.bias is None else self.bias[idx],
            kind=self.kind,
        )

    def to(self, device: torch.device) -> "FeatureMap":
        return FeatureMap(
            omega=self.omega.to(device),
            bias=None if self.bias is None else self.bias.to(device),
            kind=self.kind,
        )


def sample_rff(generator: torch.Generator, dim: int, num_frequencies: int,
               sigma: float, kind: str = "cos_bias", *,
               dtype: torch.dtype = torch.float64) -> FeatureMap:
    """Sample ω ~ N(0, σ⁻² I_d) (Gaussian kernel spectral density) on the
    generator's device."""
    if kind not in _KINDS:
        raise ValueError(f"unknown RFF kind {kind!r}")
    device = generator.device
    omega = torch.randn((num_frequencies, dim), generator=generator,
                        dtype=dtype, device=device) / sigma
    bias = None
    if kind == "cos_bias":
        bias = torch.rand((num_frequencies,), generator=generator,
                          dtype=dtype, device=device) * (2 * math.pi)
    return FeatureMap(omega=omega, bias=bias, kind=kind)


def featurize(fmap: FeatureMap, x: torch.Tensor) -> torch.Tensor:
    """Z(X) ∈ R^{D_feat × N} for X ∈ R^{d × N}."""
    if x.ndim != 2:
        raise ValueError(f"x must be [d, N], got {tuple(x.shape)}")
    d = fmap.omega.shape[0]
    # The scale is rounded to the working dtype where the reference rounds
    # it (a Python float would be applied unrounded, at f32 for bf16).
    if fmap.kind == "cos_sin":
        proj = fmap.omega @ x                            # [D, N]
        scale = torch.tensor(1.0 / math.sqrt(d), dtype=proj.dtype).item()
        return torch.cat([torch.cos(proj), torch.sin(proj)], dim=0) * scale
    proj = fmap.omega @ x + fmap.bias[:, None]           # [D, N]
    scale = torch.sqrt(torch.tensor(2.0 / d, dtype=proj.dtype)).item()
    return torch.cos(proj) * scale


def gaussian_kernel(x: torch.Tensor, x2: torch.Tensor,
                    sigma: float) -> torch.Tensor:
    """Exact Gaussian Gram matrix K ∈ R^{N×M} for X [d,N], X2 [d,M]."""
    sq = (torch.sum(x * x, dim=0)[:, None]
          + torch.sum(x2 * x2, dim=0)[None, :]
          - 2.0 * x.T @ x2)
    return torch.exp(-torch.clamp(sq, min=0.0) / (2.0 * sigma**2))
