"""Baselines the paper compares against.

* CentralizedKRR — exact kernel ridge regression on pooled data (upper
  reference; §IV "Centralized KRR"). O(N³) work and O(N²) memory.
* CentralizedRF — centralized ridge in a shared RF space (sanity midpoint).
* DKLA — decentralized kernel learning via consensus ADMM with *identical*
  features on every node (Xu et al., JMLR 2021 [22]; model (3) in the paper).
* DKLA-DDRF — DKLA where the shared features are DDRF-selected using a
  single node's data and broadcast (the paper's second baseline).
"""
from __future__ import annotations

import dataclasses
from typing import Sequence

import torch

from repro_torch._device import resolve_device
from repro_torch.core.ddrf import select_features
from repro_torch.core.dekrr import NodeData
from repro_torch.core.graph import Topology
from repro_torch.core.rff import FeatureMap, featurize, gaussian_kernel


def _cholesky_solve(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a⁻¹ b for symmetric positive definite a [n, n] and b [n]."""
    return torch.cholesky_solve(b[:, None], torch.linalg.cholesky(a))[:, 0]


# ---------------------------------------------------------------- centralized
@dataclasses.dataclass
class CentralizedKRR:
    """Exact KRR: α = (K + λN I)⁻¹ yᵀ, f(x) = K(x, X) α. Runs on the
    device of the training data."""

    sigma: float
    lam: float

    def fit(self, x: torch.Tensor, y: torch.Tensor) -> "CentralizedKRR":
        self.x_train = x
        k = gaussian_kernel(x, x, self.sigma)
        n = x.shape[1]
        k.diagonal().add_(self.lam * n)          # K + λN I, in place
        self.alpha = _cholesky_solve(k, y.reshape(-1))
        return self

    def predict(self, x: torch.Tensor) -> torch.Tensor:
        return gaussian_kernel(x.to(self.x_train.device), self.x_train,
                               self.sigma) @ self.alpha


@dataclasses.dataclass
class CentralizedRF:
    """Ridge regression in a shared random-feature space (pooled data)."""

    fmap: FeatureMap
    lam: float

    def fit(self, x: torch.Tensor, y: torch.Tensor) -> "CentralizedRF":
        self.fmap = self.fmap.to(x.device)
        z = featurize(self.fmap, x)                    # [D, N]
        n = z.shape[1]
        g = z @ z.T
        g.diagonal().add_(self.lam * n)
        self.theta = _cholesky_solve(g, z @ y.reshape(-1))
        return self

    def predict(self, x: torch.Tensor) -> torch.Tensor:
        return self.theta @ featurize(self.fmap, x.to(self.theta.device))


# ----------------------------------------------------------------------- DKLA
@dataclasses.dataclass(frozen=True)
class DKLAConfig:
    lam: float = 1e-6
    rho: float = 1e-4          # augmented coefficient (paper: 1e-4 ...
    rho_doubling_every: int = 200   # ... doubled every 200 iterations)
    num_iters: int = 600


class DKLA:
    """Decentralized consensus ADMM with one shared feature map.

    Local objective g_j(θ) = (1/N)‖θᵀZ_j − Y_j‖² + (λ/J)‖θ‖², consensus
    enforced with edge variables eliminated (DLM-style):

      θ_j^{k+1} = (2/N Z_jZ_jᵀ + 2λ/J I + 2ρ|N_j| I)⁻¹
                  (2/N Z_jY_jᵀ − γ_j^k + ρ Σ_{p∈N_j}(θ_j^k + θ_p^k))
      γ_j^{k+1} = γ_j^k + ρ Σ_{p∈N_j}(θ_j^{k+1} − θ_p^{k+1})

    Every node shares one D, so the J node solves run as one batched
    solve: the [J, D, D] left-hand sides are factored once per ρ value
    (ρ changes only at a doubling), and the neighbour sums are
    deg_j θ_j ± (A θ)_j with the adjacency A. The same function as a
    per-node loop, in another summation order.
    """

    def __init__(self, topology: Topology, fmap: FeatureMap,
                 data: Sequence[NodeData], config: DKLAConfig = DKLAConfig(),
                 *, device: str | torch.device | None = None):
        self.device = resolve_device(device)
        self.topology = topology
        self.fmap = fmap.to(self.device)
        self.data = [nd.to(self.device) for nd in data]
        self.config = config
        self.J = topology.num_nodes
        self.N = sum(nd.num_samples for nd in self.data)
        self.dfeat = fmap.num_features
        # local precomputations (fixed across iterations)
        zz, zy = [], []
        for nd in self.data:
            z = featurize(self.fmap, nd.x)
            zz.append(z @ z.T)
            zy.append(z @ nd.y.reshape(-1))
        self._zz = torch.stack(zz)                    # [J, D, D]
        self._zy = torch.stack(zy)                    # [J, D]
        dtype = self._zy.dtype
        self._adj = torch.as_tensor(topology.adjacency, dtype=dtype,
                                    device=self.device)
        self._deg = torch.as_tensor(topology.degrees, dtype=dtype,
                                    device=self.device)

    def _factor(self, rho: float) -> torch.Tensor:
        cfg = self.config
        lhs = (2.0 / self.N) * self._zz
        shift = 2.0 * cfg.lam / self.J + 2.0 * rho * self._deg     # [J]
        lhs.diagonal(dim1=1, dim2=2).add_(shift[:, None])
        return torch.linalg.cholesky(lhs)

    def solve(self, num_iters: int | None = None) -> list[torch.Tensor]:
        cfg = self.config
        iters = num_iters if num_iters is not None else cfg.num_iters
        theta = torch.zeros_like(self._zy)
        gamma = torch.zeros_like(theta)
        rho = cfg.rho
        chol = self._factor(rho)
        deg = self._deg[:, None]
        d_term = (2.0 / self.N) * self._zy
        for k in range(iters):
            if k > 0 and cfg.rho_doubling_every > 0 \
                    and k % cfg.rho_doubling_every == 0:
                rho *= 2.0
                chol = self._factor(rho)
            nb_sum = deg * theta + self._adj @ theta   # Σ_p (θ_j + θ_p)
            rhs = d_term - gamma + rho * nb_sum
            theta = torch.cholesky_solve(rhs[..., None], chol)[..., 0]
            gamma = gamma + rho * (deg * theta - self._adj @ theta)
        return list(theta.unbind(0))

    def predict(self, theta: Sequence[torch.Tensor], x: torch.Tensor,
                node: int | None = None) -> torch.Tensor:
        z = featurize(self.fmap, x.to(self.device))
        if node is not None:
            return theta[node] @ z
        return torch.mean(torch.stack([t @ z for t in theta]), dim=0)


def dkla_ddrf_feature_map(
    generator: torch.Generator | None, dim: int, num_features: int,
    sigma: float, data: Sequence[NodeData], *, node: int | None = None,
    method: str = "energy", candidate_ratio: int = 20,
    kind: str = "cos_bias", candidates: FeatureMap | None = None,
) -> FeatureMap:
    """DKLA-DDRF: select shared features on ONE node's data and broadcast.

    The paper uses the node with the most data in the imbalanced setting.
    ``candidates`` replaces the generator's draw of the candidate pool.
    """
    if node is None:
        node = max(range(len(data)), key=lambda j: data[j].num_samples)
    return select_features(
        generator, dim, num_features, sigma, data[node].x, data[node].y,
        method=method, candidate_ratio=candidate_ratio, kind=kind,
        candidates=candidates)
