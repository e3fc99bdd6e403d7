"""Data-dependent random feature (DDRF) selection.

Two score families, as in the paper's references:

* energy / kernel-polarization score (Shahrampour et al. [33]): score each
  of D0 candidate frequencies by its alignment with the labels,
      S(ω) = ( (1/N) Σ_i y_i ψ(ω, x_i) )²,
  summed over the cos and sin channels for the paired construction.
* ridge leverage scores (Li et al. [35]; Liu et al. [36]):
      τ_k = [ Φ Φᵀ (Φ Φᵀ + λ N I)⁻¹ ]_{kk}
  from the D0×D0 candidate Gram.

`select_features` draws D0 = ratio·D candidates with a `torch.Generator`
and keeps the top D. A caller may pass the candidate pool instead
(``candidates=``), which is how the port is held against another
implementation's draws.
"""
from __future__ import annotations

from typing import Literal

import torch

from repro_torch.core.rff import FeatureMap, featurize, sample_rff
from repro_torch.obs.spans import span


def _fold_paired(per_feature: torch.Tensor, fmap: FeatureMap) -> torch.Tensor:
    """[num_features] → [num_frequencies]: a cos_sin map's two channels per
    frequency (stacked [cos; sin]) are summed; identity for cos_bias."""
    if fmap.kind == "cos_sin":
        d = fmap.num_frequencies
        return per_feature[:d] + per_feature[d:]
    return per_feature


def _channels(fmap: FeatureMap, x: torch.Tensor) -> torch.Tensor:
    """Unscaled per-feature channels [num_features, N]."""
    proj = fmap.omega @ x                              # [D, N]
    if fmap.kind == "cos_sin":
        return torch.cat([torch.cos(proj), torch.sin(proj)], dim=0)
    return torch.cos(proj + fmap.bias[:, None])


def energy_scores(fmap: FeatureMap, x: torch.Tensor,
                  y: torch.Tensor) -> torch.Tensor:
    """Per-frequency energy score on data (X [d,N], Y [N], [1,N] or
    [N, Dy]; a vector target sums its per-output alignments)."""
    if y.ndim == 2 and y.shape[0] != 1:                # [N, Dy] labels
        n = y.shape[0]
        align = _channels(fmap, x) @ y                 # [num_features, Dy]
        return _fold_paired(torch.sum(align**2, dim=1), fmap) / (n**2)
    y = y.reshape(-1)
    n = y.shape[0]
    align = _channels(fmap, x) @ y                     # [num_features]
    return _fold_paired(align**2, fmap) / (n**2)


def leverage_scores(fmap: FeatureMap, x: torch.Tensor,
                    lam: float = 1e-6) -> torch.Tensor:
    """Ridge leverage score per frequency (paired features are summed)."""
    z = featurize(fmap, x)                             # [D_feat, N]
    n = z.shape[1]
    g = z @ z.T
    reg = lam * n * torch.eye(g.shape[0], dtype=g.dtype, device=g.device)
    sol = torch.cholesky_solve(g, torch.linalg.cholesky(g + reg))
    return _fold_paired(torch.diagonal(sol), fmap)


def select_features(
    generator: torch.Generator | None,
    dim: int,
    num_features: int,
    sigma: float,
    x: torch.Tensor,
    y: torch.Tensor | None = None,
    *,
    method: Literal["plain", "energy", "leverage",
                    "leverage_resample"] = "energy",
    candidate_ratio: int = 20,
    kind: str = "cos_bias",
    leverage_lam: float = 1e-6,
    candidates: FeatureMap | None = None,
) -> FeatureMap:
    """DDRF pipeline: sample D0 = ratio·D candidates, score, select D.

    ``method="plain"`` returns data-independent RFF (the DKLA setting).
    ``candidates`` replaces the draw with a given pool (then ``generator``
    is used only by ``leverage_resample``).
    """
    if method == "plain":
        if candidates is not None:
            raise ValueError("method='plain' draws its own frequencies; "
                             "candidates= applies to scored methods")
        return sample_rff(generator, dim, num_features, sigma, kind=kind,
                          dtype=x.dtype)
    with span("ddrf.select"):
        if candidates is None:
            cand = sample_rff(generator, dim, candidate_ratio * num_features,
                              sigma, kind=kind, dtype=x.dtype)
        else:
            cand = candidates.to(x.device)

        if method == "energy":
            if y is None:
                raise ValueError("energy scoring requires labels y")
            scores = energy_scores(cand, x, y)
            idx = torch.argsort(-scores, stable=True)[:num_features]
        elif method == "leverage":
            scores = leverage_scores(cand, x, lam=leverage_lam)
            idx = torch.argsort(-scores, stable=True)[:num_features]
        elif method == "leverage_resample":
            scores = leverage_scores(cand, x, lam=leverage_lam)
            prob = torch.clamp(scores, min=0.0)
            prob = prob / torch.sum(prob)
            idx = torch.multinomial(prob, num_features, replacement=False,
                                    generator=generator)
        else:
            raise ValueError(f"unknown DDRF method {method!r}")
        return cand.subset(idx)
