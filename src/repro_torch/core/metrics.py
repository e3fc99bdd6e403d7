"""Evaluation metrics (paper §IV-A)."""
from __future__ import annotations

import torch


def rse(pred: torch.Tensor, y: torch.Tensor) -> float:
    """Relative square error: Σ(f(x)−y)² / Σ(y−ȳ)²."""
    pred = pred.reshape(-1)
    y = y.reshape(-1)
    num = torch.sum((pred - y) ** 2)
    den = torch.sum((y - torch.mean(y)) ** 2)
    return float(num / den)


def mse(pred: torch.Tensor, y: torch.Tensor) -> float:
    pred = pred.reshape(-1)
    y = y.reshape(-1)
    return float(torch.mean((pred - y) ** 2))
