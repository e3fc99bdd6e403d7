"""`StreamingDeKRR` — the online DeKRR-DDRF event loop — and the serving
contract it publishes through: `StalenessBound`, `ServeSnapshot` and
`SnapshotRegistry`.

The counterpart of `repro.stream.runtime`. It ties the streaming layers
together around the packed runtime:

    ingest(j, Xb, Yb)  ──► rank-b Woodbury fold (`repro_torch.stream.updates`)
          │                     O(deg · D² b), no O(D³), no data replay
          ├──► drift check (`repro_torch.stream.drift`) ──► maybe refresh:
          │        DDRF re-selection on the node's accumulated data,
          │        single-slot rebuild, θ re-padded across the layout
          └──► solve(...): warm-started consensus continuation —
                   `repro_torch.dist.solve_batched` (sync Jacobi) or
                   `repro_torch.dist.async_solve_batched` (gossip), any
                   backend ("torch" | "cuda" | "cuda_fused"), θ carried
                   across epochs, tol-based round budgeting

The runtime's packed problem is always materializable exactly: after any
ingest/refresh sequence, `packed` equals `pack_problem` on the
accumulated data at the stream's pinned-ridge normalization
(`reference_solver()` builds that from-scratch comparison; rtol 1e-9 in
float64). Because θ is carried, each epoch's solve continues from the
previous consensus instead of re-running the full round count
(`repro_torch.bench.stream_bench` measures the warm-against-cold gap).

`snapshot()` exports an immutable view (feature maps + ragged θ + a
staleness bound) for the serving tier (`repro_torch.serve.dekrr`), which
also serves from a live stream directly, re-snapshotting once per wave.

Draws. The reference draws a refresh's candidate frequencies and the
async activation masks with `jax.random`, which torch cannot reproduce.
Here a `torch.Generator` on the stream's device is seeded from
(seed, refresh_count) and (seed, theta_version); `refresh(candidates=)`
takes a given candidate pool instead, which is how the port is held
against another implementation's draws.

θ shape contract. The carried θ mirrors the packed label block
`packed.d`: `[J, D_max]` for scalar targets, `[J, D_max, Dy]` for
multi-output streams (node j's live coefficients are `theta[j, :D_j]`).
A snapshot's θ_j is `[D_j]` or `[D_j, Dy]`, one shared Dy; θ and every
map's Ω and b are tensors on one device, the device the serving tier
answers on. No ingest, refresh or solve writes into a tensor a snapshot
holds: each replaces θ and the state with new tensors.
"""
from __future__ import annotations

import dataclasses
import threading

import numpy as np
import torch

from repro_torch.core.async_gossip import AsyncGossipConfig, activation_masks
from repro_torch.core.ddrf import select_features
from repro_torch.core.dekrr import DeKRRConfig, DeKRRSolver, NodeData
from repro_torch.core.rff import FeatureMap, featurize
from repro_torch.dist import async_solve_batched, solve_batched, step_batched
from repro_torch.dist.async_gossip import _packed_edges
from repro_torch.obs.spans import span
from repro_torch.stream.drift import DriftConfig, DriftDetector, DriftVerdict
from repro_torch.stream.updates import (StreamAux, _as_tensor,
                                        ingest as _fold, init_stream_aux,
                                        reference_lam, refresh_node,
                                        repad_theta, to_packed)

__all__ = [
    "IngestReport",
    "RefreshReport",
    "ServeSnapshot",
    "SnapshotRegistry",
    "SolveReport",
    "StalenessBound",
    "StreamConfig",
    "StreamingDeKRR",
]

_GOSSIP = ("sync", "async")
# Generator streams of the runtime's draws, seeded with (seed, tag, count).
_REFRESH_DRAWS, _MASK_DRAWS = 1, 2


@dataclasses.dataclass(frozen=True)
class StreamConfig:
    """Streaming-runtime policy knobs.

    backend / gossip pick how the warm-started consensus continuation
    runs — every combination of the packed runtime ("torch" | "cuda" |
    "cuda_fused" × "sync" | "async"). `rounds_per_epoch` is a solve's
    round budget; with `tol > 0` the solve stops early on max|Δθ| < tol
    (warm starts make this the common case). `drift` enables automatic
    per-node feature refreshes; refreshed maps are re-selected with
    `refresh_method` on the node's accumulated data at kernel bandwidth
    `sigma` — None (the default) recovers the bandwidth from the node's
    current frequencies (ω ~ N(0, σ⁻²I), so σ̂ = 1/std(ω), the population
    std, is the maximum-likelihood estimate), which keeps a refresh on
    the kernel the stream was built with. `seed` seeds the runtime's
    draws (refresh candidates, async activation masks).
    """

    backend: str = "cuda_fused"
    gossip: str = "sync"
    async_config: AsyncGossipConfig = AsyncGossipConfig()
    rounds_per_epoch: int = 200
    tol: float = 1e-8
    chunk_rounds: int | None = None
    drift: DriftConfig | None = None
    refresh_method: str = "energy"
    refresh_candidate_ratio: int = 10
    sigma: float | None = None
    seed: int = 0

    def __post_init__(self):
        if self.gossip not in _GOSSIP:
            raise ValueError(f"gossip must be one of {_GOSSIP}, "
                             f"got {self.gossip!r}")
        if self.rounds_per_epoch < 1:
            raise ValueError("rounds_per_epoch must be >= 1")
        if self.tol < 0:
            raise ValueError("tol must be >= 0")


@dataclasses.dataclass(frozen=True)
class StalenessBound:
    """How far an answer computed from a θ snapshot can be from the live
    full-precision prediction — a staleness term AND a precision term.

    theta_version:   increments on every solve.
    ingests_behind:  ingest events folded since θ was last solved.
    samples_behind:  samples those ingests carried.
    residual:        max|F(θ) − θ| of the snapshot θ under the current
                     packed operator (one extra Eq. 19 round) — the
                     contraction residual; θ is within
                     residual / (1 − ρ(M)) of the live fixed point. For
                     multi-output θ the max runs over features AND
                     outputs.
    precision:       per-answer inference-precision bound, in ANSWER
                     units: |f_served − f_hi(θ)| ≤ precision, where f_hi
                     is the same Eq. 1 dot product evaluated at the
                     snapshot dtype. 0.0 on the full-precision path. On
                     the mixed-precision serving paths
                     (`repro_torch.serve.dekrr`, precision="bf16"/"int8")
                     it is max(analytic forward-error bound of the
                     low-precision featurize+GEMV for this answer,
                     |f_hi − f_lo| measured per wave on a calibration
                     stripe), so every answer carries staleness and
                     quantization error through one contract.
    """

    theta_version: int
    ingests_behind: int
    samples_behind: int
    residual: float
    precision: float = 0.0


@dataclasses.dataclass(frozen=True)
class ServeSnapshot:
    """Immutable θ view for the serving path (`repro_torch.serve.dekrr`).

    Construction validates the serving contract so malformed snapshots
    fail HERE, with the per-node facts named, instead of deep inside a
    wave's stack or GEMM with an anonymous shape error:

      * one θ per feature map, every θ either [D_j] (scalar targets) or
        [D_j, Dy] with ONE shared Dy (mixed scalar/multi-output θ is
        rejected with the per-node output widths listed);
      * every θ's feature count equals its map's `num_features`;
      * one shared θ dtype (the wave is cast to it — a lone f32 node
        would silently degrade every sibling's f64 answer);
      * one shared query input dim across the maps' Ω matrices;
      * every θ, Ω and b on one device (the first node that differs is
        named).
    """

    feature_maps: tuple[FeatureMap, ...]
    theta: tuple[torch.Tensor, ...]
    staleness: StalenessBound

    def __post_init__(self):
        fmaps, theta = self.feature_maps, self.theta
        if len(fmaps) == 0 or len(fmaps) != len(theta):
            raise ValueError(
                f"snapshot needs one θ per feature map, got "
                f"{len(theta)} θ for {len(fmaps)} maps")
        if not all(isinstance(t, torch.Tensor) for t in theta):
            raise TypeError(
                f"snapshot θ must be torch tensors, got "
                f"{[type(t).__name__ for t in theta]}")
        widths = [1 if t.ndim == 1 else (t.shape[1] if t.ndim == 2 else -1)
                  for t in theta]
        if any(w < 0 for w in widths):
            raise ValueError(
                f"snapshot θ must be [D_j] or [D_j, Dy], got ndim "
                f"{[t.ndim for t in theta]}")
        ndims = {t.ndim for t in theta}
        if len(ndims) > 1 or (2 in ndims and len(set(widths)) > 1):
            raise ValueError(
                f"mixed scalar/multi-output θ snapshot: per-node output "
                f"widths {widths} (ndim {[t.ndim for t in theta]}) — "
                f"pack every node's θ as [D_j], or every node's as "
                f"[D_j, Dy] with one shared Dy")
        feats = [(int(t.shape[0]), fm.num_features)
                 for t, fm in zip(theta, fmaps)]
        if any(got != want for got, want in feats):
            raise ValueError(
                f"snapshot θ feature counts {[g for g, _ in feats]} do "
                f"not match the maps' num_features "
                f"{[w for _, w in feats]}")
        dtypes = [str(t.dtype).removeprefix("torch.") for t in theta]
        if len(set(dtypes)) > 1:
            raise ValueError(
                f"snapshot θ dtypes must agree (the wave is cast to one "
                f"dtype), got per-node {dtypes}")
        dims_in = {int(fm.omega.shape[1]) for fm in fmaps}
        if len(dims_in) > 1:
            raise ValueError(
                f"snapshot feature maps disagree on the query input dim: "
                f"{sorted(dims_in)}")
        want = theta[0].device
        for j, (t, fm) in enumerate(zip(theta, fmaps)):
            held = {"θ": t, "Ω": fm.omega, "b": fm.bias}
            off = {k: str(v.device) for k, v in held.items()
                   if v is not None and v.device != want}
            if off:
                raise ValueError(
                    f"snapshot tensors must lie on one device ({want}, "
                    f"node 0's θ), but node {j} has "
                    + ", ".join(f"{k} on {d}" for k, d in off.items()))

    @property
    def dtype(self) -> torch.dtype:
        """The shared θ dtype waves are cast to."""
        return self.theta[0].dtype

    @property
    def device(self) -> torch.device:
        """The device every θ and map lies on, where waves are answered."""
        return self.theta[0].device

    @property
    def output_width(self) -> int | None:
        """Dy for multi-output snapshots, None for scalar targets."""
        t0 = self.theta[0]
        return None if t0.ndim == 1 else int(t0.shape[1])

    @property
    def input_dim(self) -> int:
        """Query input dim d shared by every node's Ω."""
        return int(self.feature_maps[0].omega.shape[1])


@dataclasses.dataclass(frozen=True)
class IngestReport:
    node: int
    batch_size: int
    drift: DriftVerdict | None
    refreshed: bool


@dataclasses.dataclass(frozen=True)
class RefreshReport:
    node: int
    old_features: int
    new_features: int
    repadded: bool


@dataclasses.dataclass(frozen=True)
class SolveReport:
    rounds_run: int
    budget: int
    converged: bool
    residual: float
    theta_version: int


class SnapshotRegistry:
    """Versioned atomic-publish registry decoupling solvers from serving
    replicas.

    The solver side calls `publish(snapshot)` (or `publish_from(stream)`)
    after each solve; N serving replicas call `latest()` per wave and
    never block the solver — the published state is a single immutable `(version, ServeSnapshot)`
    tuple swapped by one reference assignment, so a reader sees either
    the whole previous snapshot or the whole new one, never a torn mix
    (the lock below only serializes *writers*' version bookkeeping).
    Registry versions increase by 1 per publish and are independent of
    `StalenessBound.theta_version` (re-publishing an unchanged θ bumps
    the registry version only).
    """

    def __init__(self):
        self._write_lock = threading.Lock()
        self._published: tuple[int, ServeSnapshot] | None = None

    def publish(self, snapshot: ServeSnapshot) -> int:
        """Atomically publish `snapshot`; returns its registry version."""
        if not isinstance(snapshot, ServeSnapshot):
            raise TypeError(
                f"publish() takes a ServeSnapshot, got "
                f"{type(snapshot).__name__}")
        with span("stream.publish"):
            with self._write_lock:
                version = (0 if self._published is None
                           else self._published[0]) + 1
                self._published = (version, snapshot)
        return version

    def publish_from(self, stream: "StreamingDeKRR") -> int:
        """Snapshot a live `StreamingDeKRR` and publish it."""
        return self.publish(stream.snapshot())

    @property
    def version(self) -> int:
        """Latest published version (0 = nothing published yet)."""
        pub = self._published
        return 0 if pub is None else pub[0]

    def latest(self) -> ServeSnapshot:
        return self.latest_versioned()[1]

    def latest_versioned(self) -> tuple[int, ServeSnapshot]:
        """(version, snapshot) read atomically as one tuple."""
        published = self._published
        if published is None:
            raise LookupError(
                "SnapshotRegistry is empty — publish() a ServeSnapshot "
                "before serving from it")
        return published


def _generator(device: torch.device, seed: int, tag: int,
               count: int) -> torch.Generator:
    """A generator on `device` seeded from (seed, tag, count): the draws of
    one refresh or one async solve, reproducible and distinct."""
    state = np.random.SeedSequence([seed, tag, count]).generate_state(2)
    return torch.Generator(device=device).manual_seed(
        int(state[0]) << 32 | int(state[1]))


class StreamingDeKRR:
    """Online DeKRR runtime over a fixed topology with streaming node data.

    Construct from a `DeKRRSolver` (topology + per-node DDRF feature maps
    + initial data); the solver is only read, never changed. The state,
    the carried θ and the accumulated data live on the solver's device.
    """

    def __init__(self, solver: DeKRRSolver,
                 config: StreamConfig = StreamConfig()):
        self.config = config
        self.topology = solver.topology
        self.device = solver.device
        self.feature_maps = list(solver.feature_maps)
        self.aux: StreamAux = init_stream_aux(solver)
        # Accumulated data as per-node chunk lists on the device (appended
        # per ingest, concatenated lazily by _node_data): copying the whole
        # history on every minibatch would make ingest O(N) instead of the
        # O(D² b) the Woodbury fold delivers.
        self._x = [[nd.x] for nd in solver.data]
        # Multi-output streams keep labels as [N, Dy] rows; scalar streams
        # keep the flat [N] convention (the Dy=1 pin).
        self._dy = self.aux.zy.shape[2] if self.aux.zy.ndim == 3 else None
        self._y = [[self._as_labels(nd.y)] for nd in solver.data]
        self._c_nei = list(solver.c_nei)
        self._c_self_ratio = float(solver.config.c_self_ratio)
        self.theta = torch.zeros_like(self.aux.zy)
        self._packed = None
        self._detector = (DriftDetector(self.feature_maps, solver.data,
                                        config.drift)
                          if config.drift is not None else None)
        self.theta_version = 0
        self.ingest_count = 0
        self.refresh_count = 0
        self._ingests_since_solve = 0
        self._samples_since_solve = 0
        self._residual = float("inf")
        self._staleness_cache: tuple | None = None

    # -- views --------------------------------------------------------------
    def _as_labels(self, y) -> torch.Tensor:
        """One node's labels on the stream's device: [N] for scalar
        streams, [N, Dy] for multi-output ones."""
        y = _as_tensor(y, device=self.device)
        return y.reshape(-1) if self._dy is None else y.reshape(-1, self._dy)

    @property
    def num_nodes(self) -> int:
        return self.aux.num_nodes

    @property
    def packed(self):
        """The live `PackedProblem` (cached; invalidated by ingest/refresh)."""
        if self._packed is None:
            self._packed = to_packed(self.aux)
        return self._packed

    def _node_data(self, j: int) -> tuple[torch.Tensor, torch.Tensor]:
        """Node j's accumulated (x [d, N_j], y [N_j]); collapses the
        pending chunk list in place (amortized — reads are rare)."""
        if len(self._x[j]) > 1:
            self._x[j] = [torch.cat(self._x[j], dim=1)]
            self._y[j] = [torch.cat(self._y[j])]
        return self._x[j][0], self._y[j][0]

    def accumulated_data(self) -> list[NodeData]:
        return [NodeData(*self._node_data(j)) for j in range(self.num_nodes)]

    def reference_solver(self) -> DeKRRSolver:
        """From-scratch `DeKRRSolver` on the accumulated data that
        reproduces the stream state exactly (pinned-ridge normalization:
        λ_eff = λ·n_ref/n_live — see `repro_torch.stream.updates`)."""
        return DeKRRSolver(
            self.topology, self.feature_maps, self.accumulated_data(),
            DeKRRConfig(lam=reference_lam(self.aux), c_nei=1.0,
                        c_self_ratio=self._c_self_ratio),
            c_nei_per_node=self._c_nei, build_aux=False, device=self.device)

    # -- event loop ---------------------------------------------------------
    def ingest(self, node: int, xb, yb) -> IngestReport:
        """Fold a minibatch into the Eq. 17 auxiliaries; run the drift
        policy; auto-refresh the node's features when it fires."""
        j = int(node)
        xb = _as_tensor(xb, dtype=self._x[j][0].dtype, device=self.device)
        yb = self._as_labels(yb).to(self._y[j][0].dtype)
        b = int(xb.shape[1])
        with span("stream.ingest", node=j, batch=b):
            self.aux = _fold(self.aux, j, xb, yb)
        if b:
            self._x[j].append(xb)
            self._y[j].append(yb)
        self._packed = None
        self.ingest_count += 1
        self._ingests_since_solve += 1
        self._samples_since_solve += b

        verdict = None
        refreshed = False
        if self._detector is not None:
            verdict = self._detector.observe(j, xb, yb)
            if verdict.refresh:
                self.refresh(j)
                refreshed = True
        return IngestReport(node=j, batch_size=b, drift=verdict,
                            refreshed=refreshed)

    def refresh(self, node: int, num_features: int | None = None, *,
                generator: torch.Generator | None = None,
                candidates: FeatureMap | None = None) -> RefreshReport:
        """Re-run DDRF selection for one node on its accumulated data and
        rebuild only that node's slot in the packed program. θ is carried
        across the (possibly re-padded) layout with the refreshed node
        reset to zero — its old iterate lives in the old feature basis.

        The candidate pool is drawn from `generator` (by default one
        seeded from (seed, refresh_count)), or given as `candidates`."""
        j = int(node)
        cfg = self.config
        old_dims = self.aux.node_dims
        old_dj = old_dims[j]
        if generator is None and candidates is None:
            generator = _generator(self.device, cfg.seed, _REFRESH_DRAWS,
                                   self.refresh_count)
        # `num_features` counts packed FEATURES (D_j), but select_features
        # counts frequencies — a cos_sin map carries 2 features per
        # frequency, so a default refresh must pass F_j, not D_j = 2·F_j
        # (otherwise every drift-triggered refresh would double the node).
        want_features = num_features if num_features is not None else old_dj
        if self.aux.kind == "cos_sin":
            if want_features % 2:
                raise ValueError(
                    f"cos_sin maps carry 2 features per frequency — "
                    f"num_features must be even, got {want_features}")
            want_freqs = want_features // 2
        else:
            want_freqs = want_features
        if cfg.sigma is not None:
            sigma = cfg.sigma
        else:
            # recover the node's kernel bandwidth from its live map:
            # ω ~ N(0, σ⁻² I) ⇒ σ̂ = 1/std(ω) (MLE over all entries)
            spread = float(torch.std(self.feature_maps[j].omega,
                                     correction=0))
            sigma = 1.0 / spread if spread > 0 else 1.0
        x_j, y_j = self._node_data(j)
        with span("stream.refresh", node=j):
            return self._refresh_impl(j, generator, candidates, want_freqs,
                                      sigma, x_j, y_j, old_dims, old_dj)

    def _refresh_impl(self, j, generator, candidates, want_freqs, sigma,
                      x_j, y_j, old_dims, old_dj) -> RefreshReport:
        cfg = self.config
        new_fmap = select_features(
            generator, x_j.shape[0], want_freqs, sigma, x_j, y_j,
            method=cfg.refresh_method,
            candidate_ratio=cfg.refresh_candidate_ratio,
            kind=self.aux.kind, candidates=candidates)
        self.feature_maps[j] = new_fmap
        # only the node and its live neighbours are read by the rebuild —
        # collapse exactly those chunk lists
        needed = {j} | {p for p, live in zip(self.aux.nbr_idx[j].tolist(),
                                             self.aux.nbr_mask[j].tolist())
                        if live}
        data_x: list = [None] * self.num_nodes
        for i in needed:
            data_x[i] = self._node_data(i)[0]
        self.aux = refresh_node(self.aux, j, new_fmap, self.feature_maps,
                                data_x, y_j)
        self.theta = repad_theta(self.theta, old_dims, self.aux.node_dims,
                                 reset=(j,))
        self._packed = None
        self.refresh_count += 1
        if self._detector is not None:
            self._detector.rebase(j, new_fmap, *self._node_data(j))
        return RefreshReport(node=j, old_features=old_dj,
                             new_features=new_fmap.num_features,
                             repadded=max(self.aux.node_dims)
                             != max(old_dims))

    def solve(self, rounds: int | None = None,
              tol: float | None = None) -> SolveReport:
        """Warm-started consensus continuation: up to `rounds` Eq. 19
        rounds from the carried θ, on the configured backend and gossip
        mode, stopping early at `tol`. Carries θ forward."""
        cfg = self.config
        budget = int(rounds if rounds is not None else cfg.rounds_per_epoch)
        tol = float(cfg.tol if tol is None else tol)
        packed = self.packed
        if cfg.gossip == "sync":
            theta, rounds_run = solve_batched(
                packed, budget, self.theta, backend=cfg.backend, tol=tol,
                chunk_rounds=cfg.chunk_rounds, return_rounds=True)
        else:
            acfg = cfg.async_config
            masks = activation_masks(
                _generator(self.device, cfg.seed, _MASK_DRAWS,
                           self.theta_version),
                budget, packed.num_nodes, prob=acfg.prob,
                gossip=acfg.gossip,
                edges=_packed_edges(packed) if acfg.gossip == "edge"
                else None)
            theta, rounds_run = async_solve_batched(
                packed, budget, masks, config=acfg, theta0=self.theta,
                backend=cfg.backend, tol=tol, chunk_rounds=cfg.chunk_rounds,
                return_rounds=True)
        self.theta = theta
        self.theta_version += 1
        self._ingests_since_solve = 0
        self._samples_since_solve = 0
        self._residual = self._contraction_residual()
        # seed the staleness cache — the bound for this exact state is
        # already known, so the next snapshot() must not recompute it
        self._staleness_cache = (
            (self.theta_version, self.ingest_count, self.refresh_count),
            StalenessBound(theta_version=self.theta_version,
                           ingests_behind=0, samples_behind=0,
                           residual=self._residual))
        rounds_run = int(rounds_run)
        return SolveReport(rounds_run=rounds_run, budget=budget,
                           converged=rounds_run < budget
                           or self._residual < tol,
                           residual=self._residual,
                           theta_version=self.theta_version)

    def step_epoch(self, batches) -> tuple[list[IngestReport], SolveReport]:
        """One event-loop epoch: ingest every (node, xb, yb) in `batches`
        (drift-triggered refreshes included), then run the warm-started
        solve continuation."""
        reports = [self.ingest(node, xb, yb) for node, xb, yb in batches]
        return reports, self.solve()

    # -- staleness / serving ------------------------------------------------
    def _contraction_residual(self) -> float:
        new = step_batched(self.packed, self.theta,
                           backend=self.config.backend)
        return float(torch.max(torch.abs(new - self.theta)))

    def staleness(self) -> StalenessBound:
        """Live staleness bound of the carried θ against the current
        operator (ingests folded since the last solve shift the fixed
        point; the residual is recomputed against the live packed
        program). Cached per (solve, ingest, refresh) state, so a serve
        engine re-snapshotting every wave pays the extra Eq. 19 round
        only when something changed."""
        state_key = (self.theta_version, self.ingest_count,
                     self.refresh_count)
        if self._staleness_cache is None \
                or self._staleness_cache[0] != state_key:
            bound = StalenessBound(
                theta_version=self.theta_version,
                ingests_behind=self._ingests_since_solve,
                samples_behind=self._samples_since_solve,
                residual=self._contraction_residual(),
            )
            self._staleness_cache = (state_key, bound)
        return self._staleness_cache[1]

    def snapshot(self) -> ServeSnapshot:
        """Immutable view for the serving path."""
        theta = tuple(self.theta[j, :dj]
                      for j, dj in enumerate(self.aux.node_dims))
        return ServeSnapshot(feature_maps=tuple(self.feature_maps),
                             theta=theta, staleness=self.staleness())

    def predict(self, x, node: int | None = None) -> torch.Tensor:
        """f_j(x) for one node, or the network-average prediction, from
        the carried θ (the batched serving engine is
        `repro_torch.serve.dekrr.DeKRRServeEngine`). Scalar streams
        answer [Q]; multi-output streams answer [Dy, Q] (one row per
        output)."""
        x = _as_tensor(x, device=self.device)
        theta = [self.theta[j, :dj]
                 for j, dj in enumerate(self.aux.node_dims)]

        def f_j(j: int) -> torch.Tensor:
            z = featurize(self.feature_maps[j], x)     # [D_j, Q]
            th = theta[j]
            return th @ z if th.ndim == 1 else th.T @ z
        if node is not None:
            return f_j(int(node))
        return torch.mean(torch.stack([f_j(j)
                                       for j in range(self.num_nodes)]),
                          dim=0)
