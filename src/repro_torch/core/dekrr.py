"""DeKRR-DDRF: decentralized KRR with per-node data-dependent random features.

The ragged reference solver of Algorithm 1 (a Python loop over nodes, each
with auxiliaries of its own size D_j). Notation matches the paper:

  Z_{i,j} := Z_i(X_j) ∈ R^{D_i × N_j}   (node i's features on node j's data)
  c̃_{j,p} := c_{j,p} / (N |N̂_j|),  λ_j := λN/(J N_j)

Pre-iteration (Eq. 17):
  G_j = [ (1/N + 2c̃_{j,self} + |N_j| c̃_{j,nei}) Z_{j,j} Z_{j,j}ᵀ + (λ/J) I
          + Σ_{p∈N_j} c̃_{p,nei} Z_{j,p} Z_{j,p}ᵀ ]⁻¹
  d_j = (1/N) Z_{j,j} Y_jᵀ
  S_j = 2 c̃_{j,self} Z_{j,j} Z_{j,j}ᵀ
  P_{j,p} = c̃_{j,nei} Z_{j,j} Z_{p,j}ᵀ + c̃_{p,nei} Z_{j,p} Z_{p,p}ᵀ

Iteration (Eq. 19):
  θ_j^{k+1} = G_j ( d_j + S_j θ_j^k + Σ_{p∈N_j} P_{j,p} θ_p^k )

The packed runtime (`repro_torch.dist.pack_problem` / `solve_batched`)
recomputes Eq. 17 batched over nodes and runs Eq. 19 through the CUDA
kernels; the tests hold it to this solver.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Sequence

import numpy as np
import torch

from repro_torch._device import resolve_device
from repro_torch.core.graph import Topology
from repro_torch.core.rff import FeatureMap, featurize
from repro_torch.obs.spans import span


@dataclasses.dataclass
class NodeData:
    """One node's shard.

    x: [d, N_j] inputs (paper layout, columns are samples).
    y: [N_j] scalar targets, or [N_j, Dy] multi-output targets (θ becomes
       [D_j, Dy]; the Eq. 17 auxiliaries depend only on the features).
    bags: optional [N_j] int bag ids for aggregate-observation KRR: y has
       one row per bag and every feature block on this node's data is
       column-summed within bags before the Eq. 17 build. Singleton bags
       recover the standard build exactly.
    """

    x: torch.Tensor
    y: torch.Tensor
    bags: torch.Tensor | None = None

    @property
    def num_samples(self) -> int:
        return self.x.shape[1]

    @property
    def num_bags(self) -> int:
        """Observation count: bags when aggregated, samples otherwise."""
        return self.y.shape[0] if self.bags is not None \
            else self.num_samples

    @property
    def num_outputs(self) -> int:
        """Dy — trailing output width (1 for scalar [N] targets)."""
        return 1 if self.y.ndim == 1 else self.y.shape[1]

    def to(self, device: torch.device) -> "NodeData":
        return NodeData(x=self.x.to(device), y=self.y.to(device),
                        bags=None if self.bags is None
                        else self.bags.to(device))


@dataclasses.dataclass(frozen=True)
class DeKRRConfig:
    lam: float = 1e-6            # global ridge λ
    c_nei: float = 1.0           # c_{j,nei} (paper: grid {2^i N}, i=-1..3)
    c_self_ratio: float = 5.0    # c_{j,self} = ratio · c_{j,nei} (paper: 5)
    num_iters: int = 300
    tol: float = 0.0             # early stop on max ‖Δθ‖∞ (0 = run all iters)


@dataclasses.dataclass
class AuxMatrices:
    """Per-node auxiliary matrices (Eq. 17), ragged lists over nodes."""

    g: list[torch.Tensor]                 # [D_j, D_j] (the inverse, applied)
    d: list[torch.Tensor]                 # [D_j] or [D_j, Dy]
    s: list[torch.Tensor]                 # [D_j, D_j]
    p: list[dict[int, torch.Tensor]]      # p[j][nb] : [D_j, D_nb]


@dataclasses.dataclass
class DeKRRState:
    theta: list[torch.Tensor]             # [D_j] (or [D_j, Dy]) per node
    iteration: int = 0


def _c_tilde(c: float, n_total: int, degree: int) -> float:
    """c̃ = c / (N |N̂_j|) with |N̂_j| = degree + 1."""
    return c / (n_total * (degree + 1))


def _validate_data(data: Sequence[NodeData]) -> None:
    out_widths = {nd.num_outputs for nd in data}
    if len(out_widths) > 1:
        raise ValueError(
            f"all nodes must share one output width Dy, got "
            f"{sorted(out_widths)} — mixed scalar/multi-output shards "
            f"cannot reach network consensus on one θ layout")
    for j, nd in enumerate(data):
        if nd.bags is None:
            if nd.y.shape[0] != nd.num_samples:
                raise ValueError(
                    f"node {j}: y has {nd.y.shape[0]} rows but x has "
                    f"{nd.num_samples} samples")
            continue
        bags = nd.bags.detach().cpu().numpy()
        if bags.shape != (nd.num_samples,):
            raise ValueError(
                f"node {j}: bags must be [N_j]={nd.num_samples} int bag "
                f"ids, got shape {bags.shape}")
        if not np.issubdtype(bags.dtype, np.integer):
            raise ValueError(f"node {j}: bags must be integer ids, got "
                             f"dtype {bags.dtype}")
        if bags.size and (bags.min() < 0 or bags.max() >= nd.y.shape[0]):
            raise ValueError(
                f"node {j}: bag ids must lie in [0, B_j) with B_j = "
                f"y.shape[0] = {nd.y.shape[0]}, got range "
                f"[{bags.min()}, {bags.max()}]")


class DeKRRSolver:
    """Builds Eq. 17 auxiliaries and runs the Eq. 19 fixed-point iteration.

    Feature maps and data are moved to ``device`` (the CUDA card unless
    the caller names another; see `repro_torch.resolve_device`).
    ``build_aux=False`` defers the ragged Eq. 17 build until `aux` is
    first read — `repro_torch.dist.pack_problem` recomputes Eq. 17
    batched and never needs it. ``gram_fn(fmap, x)`` replaces the
    neighbour Gram blocks Z_{i,j} Z_{i,j}ᵀ of Eq. 17
    (`repro_torch.kernels.ops.gram_fn_for_solver` forms them with the
    `rff_gram` kernel); bagged nodes cannot take it.
    """

    def __init__(
        self,
        topology: Topology,
        feature_maps: Sequence[FeatureMap],
        data: Sequence[NodeData],
        config: DeKRRConfig = DeKRRConfig(),
        *,
        c_nei_per_node: Sequence[float] | None = None,
        gram_fn: Callable[[FeatureMap, torch.Tensor], torch.Tensor]
        | None = None,
        build_aux: bool = True,
        device: str | torch.device | None = None,
    ):
        if len(feature_maps) != topology.num_nodes:
            raise ValueError("one feature map per node required")
        if len(data) != topology.num_nodes:
            raise ValueError("one data shard per node required")
        self.device = resolve_device(device)
        self.topology = topology
        self.feature_maps = [fm.to(self.device) for fm in feature_maps]
        self.data = [nd.to(self.device) for nd in data]
        _validate_data(self.data)
        if gram_fn is not None and any(nd.bags is not None
                                       for nd in self.data):
            raise ValueError(
                "gram_fn bypasses featurization, so the bag-aggregation "
                "operator cannot be applied to its Gram blocks — "
                "aggregate-observation nodes require the default "
                "featurize path")
        self._gram_fn = gram_fn
        self.config = config
        self.J = topology.num_nodes
        self.N = sum(nd.num_samples for nd in self.data)
        self.c_nei = (list(c_nei_per_node) if c_nei_per_node is not None
                      else [config.c_nei] * self.J)
        self.c_self = [config.c_self_ratio * c for c in self.c_nei]
        self._aux: AuxMatrices | None = self._build_aux() if build_aux \
            else None

    @property
    def aux(self) -> AuxMatrices:
        """Ragged Eq. 17 auxiliaries, built lazily when deferred."""
        if self._aux is None:
            self._aux = self._build_aux()
        return self._aux

    def coupling_coefficients(self) -> tuple[np.ndarray, np.ndarray]:
        """Normalized (c̃_self [J], c̃_nei [J]) — c̃ = c / (N |N̂_j|)."""
        hood = self.topology.degrees.astype(np.float64) + 1.0
        ct_self = np.asarray(self.c_self, np.float64) / (self.N * hood)
        ct_nei = np.asarray(self.c_nei, np.float64) / (self.N * hood)
        return ct_self, ct_nei

    # -- pre-iteration communication + auxiliary construction ---------------
    def cross_features(self, i: int, j: int) -> torch.Tensor:
        """Z_{i,j} = Z_i(X_j) ∈ R^{D_i × N_j}."""
        return featurize(self.feature_maps[i], self.data[j].x)

    def _agg_cols(self, z: torch.Tensor, j: int) -> torch.Tensor:
        """Node j's bag aggregation on the columns of a feature block:
        [D, N_j] → [D, B_j]; the same tensor for un-bagged nodes."""
        bags = self.data[j].bags
        if bags is None:
            return z
        out = torch.zeros((z.shape[0], self.data[j].num_bags),
                          dtype=z.dtype, device=z.device)
        return out.index_add_(1, bags.long(), z)

    def obs_features(self, i: int, j: int) -> torch.Tensor:
        """Observation-space block Agg_j(Z_{i,j})."""
        return self._agg_cols(self.cross_features(i, j), j)

    def _gram(self, i: int, j: int) -> torch.Tensor:
        if self._gram_fn is not None:
            return self._gram_fn(self.feature_maps[i], self.data[j].x)
        z = self.obs_features(i, j)
        return z @ z.T

    def _build_aux(self) -> AuxMatrices:
        cfg, topo = self.config, self.topology
        g_list, d_list, s_list, p_list = [], [], [], []
        for j in range(self.J):
            deg = topo.degree(j)
            ct_self = _c_tilde(self.c_self[j], self.N, deg)
            ct_nei = _c_tilde(self.c_nei[j], self.N, deg)
            z_jj = self.obs_features(j, j)
            gram_jj = z_jj @ z_jj.T

            a = (1.0 / self.N + 2.0 * ct_self + deg * ct_nei) * gram_jj
            a = a + (cfg.lam / self.J) * torch.eye(
                z_jj.shape[0], dtype=z_jj.dtype, device=z_jj.device)
            for p in topo.neighbors(j):
                ct_p_nei = _c_tilde(self.c_nei[p], self.N, topo.degree(p))
                a = a + ct_p_nei * self._gram(j, p)
            g_list.append(torch.linalg.inv(a))

            y_j = self.data[j].y
            d_list.append((z_jj @ y_j) / self.N)      # [D_j] or [D_j, Dy]
            s_list.append(2.0 * ct_self * gram_jj)

            pj: dict[int, torch.Tensor] = {}
            for p in topo.neighbors(j):
                ct_p_nei = _c_tilde(self.c_nei[p], self.N, topo.degree(p))
                z_pj = self.obs_features(p, j)
                z_jp = self.obs_features(j, p)
                z_pp = self.obs_features(p, p)
                pj[p] = ct_nei * (z_jj @ z_pj.T) + ct_p_nei * (z_jp @ z_pp.T)
            p_list.append(pj)
        return AuxMatrices(g=g_list, d=d_list, s=s_list, p=p_list)

    # -- iteration ------------------------------------------------------------
    def init_state(self) -> DeKRRState:
        return DeKRRState(theta=[torch.zeros_like(dj) for dj in self.aux.d])

    def step(self, state: DeKRRState) -> DeKRRState:
        """One synchronous (Jacobi) round of Eq. 19 across all nodes."""
        new_theta = []
        for j in range(self.J):
            rhs = self.aux.d[j] + self.aux.s[j] @ state.theta[j]
            for p, pjp in self.aux.p[j].items():
                rhs = rhs + pjp @ state.theta[p]
            new_theta.append(self.aux.g[j] @ rhs)
        return DeKRRState(theta=new_theta, iteration=state.iteration + 1)

    def solve(self, state: DeKRRState | None = None,
              num_iters: int | None = None) -> DeKRRState:
        state = state or self.init_state()
        iters = num_iters if num_iters is not None else self.config.num_iters
        for _ in range(iters):
            new = self.step(state)
            if self.config.tol > 0:
                # one device reduction and one host read per round
                delta = float(torch.max(torch.stack([
                    torch.max(torch.abs(a - b))
                    for a, b in zip(new.theta, state.theta)])))
                state = new
                if delta < self.config.tol:
                    break
            else:
                state = new
        return state

    def _iteration_matrix(self, with_rhs: bool):
        """(M, b) of θ^{k+1} = M θ^k + b assembled on the host in float64."""
        dims = [fm.num_features for fm in self.feature_maps]
        off = np.concatenate([[0], np.cumsum(dims)])
        dt = int(off[-1])
        m = np.zeros((dt, dt))
        host = lambda t: t.detach().cpu().numpy()
        b = None
        if with_rhs:
            b = np.zeros((dt,) + tuple(self.aux.d[0].shape[1:]))
        for j in range(self.J):
            g = host(self.aux.g[j])
            if with_rhs:
                b[off[j]:off[j + 1]] = g @ host(self.aux.d[j])
            m[off[j]:off[j + 1], off[j]:off[j + 1]] = g @ host(self.aux.s[j])
            for p, pjp in self.aux.p[j].items():
                m[off[j]:off[j + 1], off[p]:off[p + 1]] += g @ host(pjp)
        return m, b, off

    def solve_exact(self) -> DeKRRState:
        """Infinite-iteration reference: solve (I − M)Θ = b directly (a
        fusion-center computation, for tests and checks only)."""
        m, b, off = self._iteration_matrix(with_rhs=True)
        theta = np.linalg.solve(np.eye(m.shape[0]) - m, b)
        dtype = self.aux.d[0].dtype
        return DeKRRState(
            theta=[torch.as_tensor(theta[off[j]:off[j + 1]], dtype=dtype,
                                   device=self.device)
                   for j in range(self.J)],
            iteration=-1,
        )

    def spectral_radius(self) -> float:
        """ρ(M) of the iteration matrix — convergence rate diagnostic."""
        m, _, _ = self._iteration_matrix(with_rhs=False)
        return float(np.max(np.abs(np.linalg.eigvals(m))))

    # -- objective (Eq. 13) ----------------------------------------------------
    def objective(self, theta: Sequence[torch.Tensor]) -> torch.Tensor:
        cfg, topo = self.config, self.topology
        total = torch.zeros((), dtype=theta[0].dtype, device=self.device)
        for j in range(self.J):
            ct_nei = _c_tilde(self.c_nei[j], self.N, topo.degree(j))
            z_jj = self.obs_features(j, j)
            if theta[j].ndim == 1:
                resid = theta[j] @ z_jj - self.data[j].y.reshape(-1)
            else:
                resid = theta[j].T @ z_jj - self.data[j].y.T   # [Dy, B_j]
            total = total + torch.sum(resid**2) / self.N
            total = total + (cfg.lam / self.J) * torch.sum(theta[j] ** 2)
            # consensus penalties over N̂_j (the self term is identically 0)
            for p in topo.neighbors(j):
                z_pj = self.obs_features(p, j)
                if theta[j].ndim == 1:
                    gap = theta[j] @ z_jj - theta[p] @ z_pj
                else:
                    gap = theta[j].T @ z_jj - theta[p].T @ z_pj
                total = total + ct_nei * torch.sum(gap**2)
        return total

    # -- prediction -------------------------------------------------------------
    def predict(self, theta: Sequence[torch.Tensor], x: torch.Tensor,
                node: int | None = None) -> torch.Tensor:
        """f_j(x) for one node, or the network-average prediction.

        Scalar θ [D_j] → [Q]; multi-output θ [D_j, Dy] → [Q, Dy]."""
        nodes = [node] if node is not None else range(self.J)
        with span("predict"):
            x = x.to(self.device)
            preds = []
            for j in nodes:
                z = featurize(self.feature_maps[j], x)
                preds.append(theta[j] @ z if theta[j].ndim == 1
                             else z.T @ theta[j])
            if node is not None:
                return preds[0]
            return torch.mean(torch.stack(preds), dim=0)


# -- Prop. 1 convergence bound -------------------------------------------------
def prop1_required_c_self(solver: DeKRRSolver) -> np.ndarray:
    """Per-node lower bound on c̃_{j,self} (Eq. 20), returned as the
    *unnormalized* c_{j,self} so it is directly comparable to config values."""
    topo, n = solver.topology, solver.N
    req = np.zeros(solver.J)
    for j in range(solver.J):
        deg = topo.degree(j)
        ct_nei = _c_tilde(solver.c_nei[j], n, deg)
        z_jj = solver.obs_features(j, j)
        gram_jj = z_jj @ z_jj.T
        acc = torch.zeros_like(gram_jj)
        for p in topo.neighbors(j):
            ct_p = _c_tilde(solver.c_nei[p], n, topo.degree(p))
            acc = acc + ct_p * solver._gram(j, p)
        lam_max = torch.linalg.eigvalsh(acc)[-1]
        lam_min = torch.linalg.eigvalsh(gram_jj)[0]
        tiny = torch.finfo(lam_min.dtype).tiny
        ct_req = deg * ct_nei / 2.0 + lam_max / (
            2.0 * torch.clamp(lam_min, min=tiny))
        req[j] = float(ct_req) * n * (deg + 1)   # un-normalize c̃ → c
    return req
