"""The serving contract of the online runtime: `StalenessBound`,
`ServeSnapshot` and `SnapshotRegistry`.

The port's counterpart of the reference's `repro.stream.runtime`, without
the online event loop: `StreamingDeKRR` (Woodbury ingest, drift refresh,
warm-started solves) and its reports come with the streaming slice. A
snapshot is built from a solved θ (`repro_torch.dist.unpack_theta`) and
the nodes' feature maps, or carried across from the reference by
`repro_torch.interop.snapshot_from_arrays`.

θ shape contract. A snapshot's θ_j is `[D_j]` for scalar targets or
`[D_j, Dy]` for multi-output models, one shared Dy; θ and every map's Ω
and b are torch tensors on one device, which is the device the serving
tier (`repro_torch.serve.dekrr`) answers on.
"""
from __future__ import annotations

import dataclasses
import threading

import torch

from repro_torch.core.rff import FeatureMap
from repro_torch.obs.spans import span

__all__ = ["ServeSnapshot", "SnapshotRegistry", "StalenessBound"]


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


class SnapshotRegistry:
    """Versioned atomic-publish registry decoupling solvers from serving
    replicas.

    The solver side calls `publish(snapshot)` after each solve; N serving
    replicas call `latest()` per wave and never block the solver — the
    published state is a single immutable `(version, ServeSnapshot)`
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
