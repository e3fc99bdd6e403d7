"""Batched DeKRR query serving: waves, replicas, precision-bounded answers.

The port's counterpart of the reference's `repro.serve.dekrr`:

  `DeKRRServeEngine`    — one engine: queries are admitted through the
      shared `repro_torch.serve.admission` queue into waves of at most
      `batch_size` slots, each wave is featurized once at a power-of-two
      padded column bucket (one kernel launch for every cos_bias node)
      and answered with a batched product and a few GEMVs. Per-request latency
      (p50/p99/qps) lands in `engine.latency`.

  `DeKRRReplicaServer`  — N engine replicas (threads) answering from the
      freshest `ServeSnapshot` published to a
      `repro_torch.stream.SnapshotRegistry`. Readers never block the
      solver: the registry swaps one immutable (version, snapshot) tuple
      per publish, each replica stages the snapshot once per version
      (θ in the wave's shapes, precision-bound constants) and serves
      waves from the shared admission queue while solves keep landing.

  mixed precision       — `precision="bf16"` (or `"int8"`) runs the
      query featurize+GEMV at low precision while the solve stays f64,
      and attaches a per-answer error bound through
      `StalenessBound.precision` (see below).

Per wave, for query matrix X ∈ R^{d×Q}:

    Z_j = z_j(X) ∈ R^{D_j × Q}      (node j's DDRF map on the queries)
    f_j(X) = θ_jᵀ Z_j               (the paper's Eq. 1 predictor)
    f(X)   = (1/J) Σ_j f_j(X)       (network-average answer)

θ shape contract: snapshot θ_j is [D_j] for scalar targets (answers are
scalars / [Q] rows) or [D_j, Dy] for multi-output models (answers are
[Dy] vectors / [Dy, Q] blocks). Malformed snapshots are rejected at
`ServeSnapshot` construction; malformed queries (wrong input dim, bad
node index) are rejected at ADMISSION with the offending `uid` named,
before anything is featurized. Every prediction handed out is an owned
copy — callers may mutate answers freely without corrupting wave
siblings. Waves run on the snapshot's device; queries and answers are
host numpy arrays.

Precision bound (the `StalenessBound.precision` term, answer units):
every low-precision answer satisfies |f_served − f_hi(θ)| ≤ precision,
where f_hi is the same dot product at the snapshot dtype. The attached
value is max(analytic, measured):

  * analytic — a forward-error bound from the staged per-node constants
    V_j = |θ_j|ᵀ|Ω_j|, wb_j = |θ_j|ᵀ|b_j|, ‖θ_j‖₁. With u = 2⁻⁸ (bf16),
    u₃₂ = 2⁻²⁴, γ_n = n·u/(1 − n·u), the per-column node-j bound is

        s_j·(3u + γ_d)·(V_j|x| + wb_j)        cos argument: rounded
                                              Ω/b/x + bf16 GEMM, through
                                              cos's 1-Lipschitz bound
      + 3u·s_j·‖θ_j‖₁                         cos output + scale rounding
      + γ_{D_j}^{(32)}·s_j·(1+u)·‖θ_j‖₁       f32 GEMV accumulation

    (×2 safety), and int8 adds the symmetric-quantization terms
    ½c‖θ‖₁ + ½t‖z‖₁ + ¼D·t·c for per-column z scale c and per-output θ
    scale t (exact integer accumulation). Network-mean answers get the
    mean of the per-node bounds. The f32 GEMVs must accumulate in f32:
    staging a low-precision snapshot on the card raises while
    `torch.backends.cuda.matmul.allow_tf32` is on.
  * measured — max|f_hi − f_lo| over a calibration stripe of the first
    `_CALIB_COLUMNS` columns of the wave, recomputed at the snapshot
    dtype. The analytic term guarantees soundness for every answer; the
    stripe keeps the attached number honest against the bound going
    slack.

Featurization of cos_bias maps goes through the hand-written kernel
when ``backend="cuda"``: the snapshot's cos_bias nodes are packed once
per staged snapshot (Ω [J_b, D_max, d], b, the per-node scale and D_j,
and θ as [J_b, Dyy, D_max], zero past D_j) and a wave featurizes all of
them in ONE launch per precision (`repro_torch.kernels.ops`'s
`rff_features_batched` / `rff_features_lowp_batched`; on a CPU snapshot
their plain versions). Full-precision predictions of those nodes are
one batched product over the packed θ; the low-precision GEMVs and
bound terms stay per node, on each node's first D_j rows. With
``backend="torch"`` every node takes `repro_torch.core.rff.featurize`.
cos_sin maps take `featurize` on both backends, as in the reference:
the kernel computes the cos_bias map only.

Every answer carries the `StalenessBound` of the snapshot it was
computed from (and on the mixed-precision paths the precision term
above), so staleness and quantization error travel through one
contract. Serving from a `SnapshotRegistry` re-reads the freshest
snapshot once per wave; serving from a frozen `ServeSnapshot` pins one
version.
"""
from __future__ import annotations

import dataclasses
import math
import threading
import time
from typing import Callable, Iterable

import numpy as np
import torch

from repro_torch.analysis import smem
from repro_torch.core.rff import FeatureMap, featurize
from repro_torch.kernels import ops
from repro_torch.obs.metrics import perf_clock
from repro_torch.obs.spans import span
from repro_torch.serve.admission import (Admitted, AdmissionQueue,
                                         LatencyRecorder, LatencyReport,
                                         pad_bucket)
from repro_torch.stream.runtime import (ServeSnapshot, SnapshotRegistry,
                                        StalenessBound, StreamingDeKRR)

__all__ = ["KernelQuery", "DeKRRServeEngine", "DeKRRReplicaServer",
           "stage_snapshot", "answer_wave"]

_BACKENDS = ("torch", "cuda")
_PRECISIONS = (None, "bf16", "int8")

# Unit roundoffs of the low-precision serve path: bf16 mantissa (8 bits
# incl. hidden) and f32 (24 bits). SAFETY doubles the analytic bound to
# absorb the model's slack (e.g. fused-multiply rounding differences
# between backends) — the bound stays answer-scale tight because every
# term is weighted by the actual |θ|/|Ω| magnitudes.
_U_BF16 = 2.0 ** -8
_U_F32 = 2.0 ** -24
_SAFETY = 2.0
# Width of the per-wave calibration stripe (the measured bound term).
_CALIB_COLUMNS = 8


@dataclasses.dataclass
class KernelQuery:
    """One prediction request.

    x: the query point [d] (or [d, m] for a small point block — answered
    as one slot of m columns). node: answer with that node's local
    predictor instead of the network average. Filled by the engine:
    prediction (an owned copy — never a view into wave-shared storage),
    staleness, done.
    """

    uid: int
    x: np.ndarray
    node: int | None = None
    prediction: np.ndarray | float | None = None
    staleness: StalenessBound | None = None
    done: bool = False


def _validate_query(q: KernelQuery, snap: ServeSnapshot) -> int:
    """Admission-time validation: shape/node errors name the offending
    query's uid HERE instead of surfacing as an anonymous GEMM shape
    error deep inside the wave. Returns the query's column width."""
    x = np.asarray(q.x)
    if x.ndim not in (1, 2):
        raise ValueError(
            f"query {q.uid}: x must be [d] or [d, m], got shape {x.shape}")
    d = int(x.shape[0])
    width = 1 if x.ndim == 1 else int(x.shape[1])
    if d != snap.input_dim:
        raise ValueError(
            f"query {q.uid}: x has input dim {d} but the snapshot's "
            f"feature maps expect d = {snap.input_dim} (Ω_j is "
            f"[D_j, {snap.input_dim}])")
    if width < 1:
        raise ValueError(
            f"query {q.uid}: x point block has no columns (shape {x.shape})")
    j_nodes = len(snap.feature_maps)
    if q.node is not None and not 0 <= int(q.node) < j_nodes:
        raise ValueError(
            f"query {q.uid}: node {q.node} out of range for the "
            f"{j_nodes}-node snapshot")
    return width


# -- snapshot staging --------------------------------------------------------
def _theta2d(theta: torch.Tensor) -> torch.Tensor:
    """θ as [D, Dyy] (Dyy = 1 for scalar targets) for uniform wave math."""
    return theta[:, None] if theta.ndim == 1 else theta


def _gamma(n: int, u: float) -> float:
    """Standard accumulated-rounding factor γ_n = n·u/(1 − n·u), clamped
    so absurdly long dots degrade gracefully instead of dividing by ≤ 0."""
    nu = min(n * u, 0.5)
    return nu / (1.0 - nu)


def _numpy_dtype(dtype: torch.dtype) -> np.dtype:
    return torch.empty((), dtype=dtype).numpy().dtype


@dataclasses.dataclass(frozen=True)
class _NodeBound:
    """Per-node constants of the analytic precision bound (f32 on the
    snapshot's device; precomputed once per staged snapshot so the
    per-wave cost is one [Dyy, d] × [d, Q] GEMM on |x|)."""

    s: float                # feature-map scale s_j
    coef: float             # s_j·(3u + γ_d) — multiplies V|x| + wb
    v: torch.Tensor         # [Dyy, d]  |θ_j|ᵀ|Ω_j| (cos_sin: halves folded)
    wb: torch.Tensor        # [Dyy]     |θ_j|ᵀ|b_j| (0 for cos_sin)
    const: torch.Tensor     # [Dyy]     column-independent ‖θ‖₁ terms
    l1: torch.Tensor        # [Dyy]     ‖θ_j‖₁ (int8 terms)
    d_feat: int             # D_j


@dataclasses.dataclass(frozen=True)
class _QuantTheta:
    """Symmetric per-output int8 quantization of one node's θ."""

    qint: torch.Tensor      # [D, Dyy] int8
    tscale: torch.Tensor    # [Dyy]    f32 dequant scale t (θ ≈ t·qint)


@dataclasses.dataclass(frozen=True)
class _PackedFeatures:
    """A snapshot's cos_bias nodes packed for one featurize launch a wave:
    Ω [J_b, D_max, d] and b [J_b, D_max] in the launch's dtype (bf16 on
    the low-precision paths) with zero rows past D_j, the per-node scale
    √(2/D_j) and D_j, and on the full-precision path θ as
    [J_b, Dyy, D_max] with zero columns past D_j."""

    nodes: tuple[int, ...]      # snapshot indices of the packed nodes
    omega: torch.Tensor
    bias: torch.Tensor
    scale: tuple[float, ...]
    d_feat: tuple[int, ...]
    theta_t: torch.Tensor | None


def _pack_features(snap: ServeSnapshot, theta2: tuple[torch.Tensor, ...],
                   dyy: int, lowp: bool) -> _PackedFeatures | None:
    nodes = tuple(j for j, fm in enumerate(snap.feature_maps)
                  if fm.kind == "cos_bias")
    if not nodes:
        return None
    d_feat = tuple(snap.feature_maps[j].num_frequencies for j in nodes)
    d_max, dev = max(d_feat), snap.device
    dtype = torch.bfloat16 if lowp else snap.dtype
    omega = torch.zeros((len(nodes), d_max, snap.input_dim), dtype=dtype,
                        device=dev)
    bias = torch.zeros((len(nodes), d_max), dtype=dtype, device=dev)
    theta_t = None if lowp else torch.zeros(
        (len(nodes), dyy, d_max), dtype=snap.dtype, device=dev)
    for i, (j, d_j) in enumerate(zip(nodes, d_feat)):
        fm = snap.feature_maps[j]
        omega[i, :d_j] = fm.omega
        bias[i, :d_j] = fm.bias
        if theta_t is not None:
            theta_t[i, :, :d_j] = theta2[j].T
    return _PackedFeatures(
        nodes=nodes, omega=omega, bias=bias,
        scale=tuple(math.sqrt(2.0 / d_j) for d_j in d_feat), d_feat=d_feat,
        theta_t=theta_t)


@dataclasses.dataclass(frozen=True)
class _StagedSnapshot:
    """One snapshot staged for serving: θ in the shapes the wave math
    wants, plus (on the low-precision paths) the bound constants and a
    full-precision twin for the calibration stripe. Immutable — safe to
    share across replica threads."""

    snap: ServeSnapshot
    backend: str
    precision: str | None
    dtype: np.dtype             # the snapshot dtype, as numpy
    dy: int | None              # snapshot output width (None = scalar)
    dyy: int                    # max(dy, 1) — the staged trailing width
    theta2: tuple[torch.Tensor, ...]          # hi θ as [D_j, Dyy]
    theta32: tuple[torch.Tensor, ...] | None  # f32 θ (lo GEMV operand)
    theta_q: tuple[_QuantTheta, ...] | None
    bounds: tuple[_NodeBound, ...] | None
    hi: "_StagedSnapshot | None"              # full-precision twin
    packed: _PackedFeatures | None            # cos_bias nodes (cuda)

    @property
    def input_dim(self) -> int:
        return self.snap.input_dim


def stage_snapshot(snap: ServeSnapshot, *, backend: str = "cuda",
                   precision: str | None = None) -> _StagedSnapshot:
    """Stage `snap` for serving with the given backend/precision pair.

    Full precision stages the [D_j, Dyy] θ views. Low precision
    additionally precomputes, per node, the f32 GEMV θ, the analytic
    bound constants (`_NodeBound`), the int8 quantized θ when asked for,
    and a full-precision twin used for the wave calibration stripe. On
    ``backend="cuda"`` either path packs the cos_bias nodes for the
    featurize kernel (`_PackedFeatures`). On a CUDA snapshot the low
    precision paths raise while TF32 matmuls are allowed, because the
    bound assumes f32 accumulation.
    """
    if backend not in _BACKENDS:
        raise ValueError(f"backend must be one of {_BACKENDS}, "
                         f"got {backend!r}")
    if precision not in _PRECISIONS:
        raise ValueError(f"precision must be one of {_PRECISIONS}, "
                         f"got {precision!r}")
    dy = snap.output_width
    dyy = 1 if dy is None else dy
    theta2 = tuple(_theta2d(t) for t in snap.theta)
    np_dtype = _numpy_dtype(snap.dtype)
    lowp = precision is not None
    packed = _pack_features(snap, theta2, dyy, lowp) \
        if backend == "cuda" else None
    if not lowp:
        return _StagedSnapshot(
            snap=snap, backend=backend, precision=None, dtype=np_dtype,
            dy=dy, dyy=dyy, theta2=theta2, theta32=None, theta_q=None,
            bounds=None, hi=None, packed=packed)
    if snap.device.type == "cuda" and torch.backends.cuda.matmul.allow_tf32:
        raise RuntimeError(
            f"precision={precision!r}: the attached error bound assumes "
            f"f32 GEMVs accumulate in f32, but "
            f"torch.backends.cuda.matmul.allow_tf32 is on — turn it off "
            f"before serving low-precision answers")

    f32 = torch.float32
    u, u32 = _U_BF16, _U_F32
    theta32, theta_q, bounds = [], [], []
    for fm, t2 in zip(snap.feature_maps, theta2):
        t32 = t2.to(f32)
        at = t32.abs()                                   # [D_j, Dyy]
        d_feat = int(t2.shape[0])
        d_in = int(fm.omega.shape[1])
        if fm.kind == "cos_bias":
            s = float(np.sqrt(2.0 / fm.num_frequencies))
            folded = at
            wb = at.T @ fm.bias.abs().to(f32)
        else:                                            # cos_sin: 2F rows
            s = float(1.0 / np.sqrt(fm.num_frequencies))
            half = fm.num_frequencies
            folded = at[:half] + at[half:]
            wb = torch.zeros((at.shape[1],), dtype=f32, device=at.device)
        v = folded.T @ fm.omega.abs().to(f32)
        l1 = at.sum(dim=0)
        coef = s * (3.0 * u + _gamma(d_in, u))
        const = (3.0 * u) * s * l1 \
            + _gamma(d_feat, u32) * s * (1.0 + u) * l1
        theta32.append(t32)
        bounds.append(_NodeBound(s=s, coef=coef, v=v, wb=wb, const=const,
                                 l1=l1, d_feat=d_feat))
        if precision == "int8":
            tscale = at.max(dim=0).values.clamp_min(1e-30) / 127.0
            qint = torch.clamp(torch.round(t32 / tscale[None, :]),
                               -127, 127).to(torch.int8)
            theta_q.append(_QuantTheta(qint=qint, tscale=tscale))
    return _StagedSnapshot(
        snap=snap, backend=backend, precision=precision, dtype=np_dtype,
        dy=dy, dyy=dyy, theta2=theta2, theta32=tuple(theta32),
        theta_q=tuple(theta_q) if precision == "int8" else None,
        bounds=tuple(bounds),
        hi=stage_snapshot(snap, backend=backend, precision=None),
        packed=packed)


# -- wave math ---------------------------------------------------------------
def _predict_hi(st: _StagedSnapshot, x: torch.Tensor) -> torch.Tensor:
    """Per-node Eq. 1 predictions [J, Dyy, Q] at the wave dtype: the packed
    cos_bias nodes through one featurize launch and one batched product,
    every other node through `featurize` and its GEMV."""
    fmaps = st.snap.feature_maps
    preds: list[torch.Tensor | None] = [None] * len(fmaps)
    pk = st.packed
    if pk is not None:
        z = ops.rff_features_batched(pk.omega, pk.bias, x, scale=pk.scale,
                                     d_feat=pk.d_feat)
        out = torch.bmm(pk.theta_t, z)                      # [J_b, Dyy, Q]
        for i, j in enumerate(pk.nodes):
            preds[j] = out[i]
    for j, (fm, t2) in enumerate(zip(fmaps, st.theta2)):
        if preds[j] is None:
            preds[j] = t2.T @ featurize(fm, x)
    return torch.stack(preds)


def _features_lo(st: _StagedSnapshot,
                 x32: torch.Tensor) -> list[torch.Tensor]:
    """Z_j(X) [D_j, Q] per node with the GEMM+cos in bf16, returned as f32
    (the arrangement the analytic bound models): the packed cos_bias
    nodes through one launch, every other node through the bf16
    `featurize`."""
    fmaps = st.snap.feature_maps
    zs: list[torch.Tensor | None] = [None] * len(fmaps)
    pk = st.packed
    if pk is not None:
        z = ops.rff_features_lowp_batched(pk.omega, pk.bias, x32,
                                          scale=pk.scale, d_feat=pk.d_feat)
        for i, (j, d_j) in enumerate(zip(pk.nodes, pk.d_feat)):
            zs[j] = z[i, :d_j]
    bf16 = torch.bfloat16
    for j, fm in enumerate(fmaps):
        if zs[j] is None:
            lo = FeatureMap(omega=fm.omega.to(bf16),
                            bias=None if fm.bias is None
                            else fm.bias.to(bf16), kind=fm.kind)
            zs[j] = featurize(lo, x32.to(bf16)).float()
    return zs


def answer_wave(st: _StagedSnapshot, x: torch.Tensor
                ) -> tuple[torch.Tensor, torch.Tensor | None]:
    """Answer one wave of query columns x [d, Q] (on the snapshot's
    device) from a staged snapshot.

    Returns (preds [J, Dyy, Q], bounds [J, Dyy, Q] | None): per-node
    Eq. 1 predictions, plus — on the low-precision paths — the analytic
    per-column precision bound (×SAFETY, answer units).
    """
    if st.precision is None:
        return _predict_hi(st, x), None

    x32 = x.to(torch.float32)
    ax = x32.abs()
    q8s = st.theta_q or (None,) * len(st.theta2)
    preds, bounds = [], []
    for z, t32, nb, q8 in zip(_features_lo(st, x32), st.theta32,
                              st.bounds, q8s):
        col = nb.coef * (nb.v @ ax + nb.wb[:, None]) + nb.const[:, None]
        if st.precision == "int8":
            c = z.abs().max(dim=0).values.clamp_min(1e-30) / 127.0
            zi = torch.clamp(torch.round(z / c[None, :]), -127, 127)
            # The int8 product, summed in f64: every partial sum is an
            # integer of magnitude ≤ 127²·D_j < 2⁵³, so it is exact and
            # equals the reference's int32 accumulation.
            acc = q8.qint.T.double() @ zi.double()
            f = acc.float() * q8.tscale[:, None] * c[None, :]
            zl1 = z.abs().sum(dim=0)                         # [Q]
            col = col + 0.5 * c[None, :] * nb.l1[:, None] \
                + 0.5 * q8.tscale[:, None] * zl1[None, :] \
                + 0.25 * nb.d_feat * q8.tscale[:, None] * c[None, :]
        else:
            f = t32.T @ z
        preds.append(f)
        bounds.append(col)
    return torch.stack(preds), torch.stack(bounds) * _SAFETY


def _check_wave_smem(st: _StagedSnapshot, q_pad: int) -> None:
    """Budget check of a ``backend="cuda"`` wave before anything of it is
    staged: its one featurize launch over the packed cos_bias nodes at the
    padded column bucket (`repro_torch.analysis.smem.estimate_serve_wave`;
    bf16 operands on the low-precision paths)."""
    pk = st.packed
    if pk is None:
        return
    smem.estimate_serve_wave(
        j=len(pk.nodes), d_feat=max(pk.d_feat), n=q_pad,
        itemsize=pk.omega.element_size(),
        sms=smem.device_sms(st.snap.device)).check()


def _serve_wave(st: _StagedSnapshot, entries: list[Admitted]) -> None:
    """Answer one admitted wave in place: featurize once at the padded
    column bucket, slice per query, COPY per answer, attach the
    staleness(+precision) bound."""
    spans: list[tuple[int, int]] = []
    offset = 0
    for e in entries:
        spans.append((offset, e.width))
        offset += e.width
    q_live = offset
    q_pad = pad_bucket(q_live)
    if st.backend == "cuda":
        _check_wave_smem(st, q_pad)

    fill_dtype = st.dtype if st.precision is None else np.float64
    x_np = np.zeros((st.input_dim, q_pad), dtype=fill_dtype)
    for e, (start, width) in zip(entries, spans):
        xq = np.asarray(e.item.x, dtype=fill_dtype)
        x_np[:, start:start + width] = xq[:, None] if xq.ndim == 1 else xq

    device = st.snap.device
    preds, bounds = answer_wave(st, torch.from_numpy(x_np).to(device))
    preds_np = preds.cpu().numpy()                # [J, Dyy, q_pad]
    bounds_np = None if bounds is None else bounds.cpu().numpy()

    measured = 0.0
    if st.precision is not None:
        # stripe width comes from the PADDED column count so its shape is
        # one shape per bucket, not one per live wave width (zero-padded
        # stripe columns are legitimate x = 0 measurement points — they
        # can only raise the attached bound, never lower it)
        stripe = min(_CALIB_COLUMNS, q_pad)
        x_hi = torch.from_numpy(
            np.ascontiguousarray(x_np[:, :stripe].astype(st.dtype))
        ).to(device)
        hi_preds, _ = answer_wave(st.hi, x_hi)
        diff = hi_preds.cpu().numpy().astype(np.float64) \
            - preds_np[:, :, :stripe].astype(np.float64)
        measured = float(np.max(np.abs(diff)))

    mean_np = preds_np.mean(axis=0)               # [Dyy, q_pad]
    mean_bounds = None if bounds_np is None else bounds_np.mean(axis=0)
    snap = st.snap
    for e, (start, width) in zip(entries, spans):
        q = e.item
        sl = slice(start, start + width)
        block = mean_np[:, sl] if q.node is None else preds_np[q.node][:, sl]
        if st.dy is None:
            vals = block[0]
            if width == 1 and np.asarray(q.x).ndim == 1:
                q.prediction = float(vals[0])
            else:
                q.prediction = np.array(vals, copy=True)
        else:
            if width == 1 and np.asarray(q.x).ndim == 1:
                q.prediction = np.array(block[:, 0], copy=True)
            else:
                q.prediction = np.array(block, copy=True)
        if bounds_np is None:
            q.staleness = snap.staleness
        else:
            bq = mean_bounds[:, sl] if q.node is None \
                else bounds_np[q.node][:, sl]
            attached = max(float(np.max(bq)), measured)
            q.staleness = dataclasses.replace(snap.staleness,
                                              precision=attached)
        q.done = True


class _StageCache:
    """Tiny thread-safe cache of staged snapshots keyed by identity (the
    registry version, or the snapshot object id for direct sources) —
    replicas restage only when a new version is published."""

    def __init__(self, capacity: int = 4):
        self._lock = threading.Lock()
        self._entries: dict[object, _StagedSnapshot] = {}
        self._capacity = capacity

    def get(self, key, snap: ServeSnapshot, *, backend: str,
            precision: str | None) -> _StagedSnapshot:
        with self._lock:
            hit = self._entries.get(key)
            if hit is not None and hit.snap is snap:
                return hit
        staged = stage_snapshot(snap, backend=backend, precision=precision)
        with self._lock:
            self._entries[key] = staged
            while len(self._entries) > self._capacity:
                self._entries.pop(next(iter(self._entries)))
        return staged


def _check_config(backend: str, precision: str | None,
                  batch_size: int) -> None:
    if backend not in _BACKENDS:
        raise ValueError(f"backend must be one of {_BACKENDS}, "
                         f"got {backend!r}")
    if precision not in _PRECISIONS:
        raise ValueError(f"precision must be one of {_PRECISIONS}, "
                         f"got {precision!r}")
    if batch_size < 1:
        raise ValueError("batch_size must be >= 1")


class DeKRRServeEngine:
    """Wave/slot-batched query answering over a θ snapshot source.

    ``source`` is a `repro_torch.stream.SnapshotRegistry` (its freshest
    published snapshot per wave), a live `repro_torch.stream.
    StreamingDeKRR` (re-snapshotted once per wave) or a frozen
    `repro_torch.stream.ServeSnapshot`. Waves run on the snapshot's
    device. ``backend`` is "cuda" (the featurize kernel; its plain
    version on a CPU snapshot) or "torch". ``precision`` selects the
    answer path: None (snapshot dtype), "bf16", or "int8" — low-precision
    answers carry their error bound in `staleness.precision`.
    """

    def __init__(self, source, *, batch_size: int = 64,
                 backend: str = "cuda", precision: str | None = None):
        _check_config(backend, precision, batch_size)
        if not isinstance(source, (ServeSnapshot, SnapshotRegistry,
                                   StreamingDeKRR)):
            raise TypeError(
                f"DeKRRServeEngine serves from a ServeSnapshot, a "
                f"SnapshotRegistry or a StreamingDeKRR, got "
                f"{type(source).__name__}")
        self.source = source
        self.batch_size = batch_size
        self.backend = backend
        self.precision = precision
        self.latency = LatencyRecorder()
        self._stages = _StageCache()

    def _snapshot(self) -> ServeSnapshot:
        if isinstance(self.source, ServeSnapshot):
            return self.source
        if isinstance(self.source, SnapshotRegistry):
            return self.source.latest()
        return self.source.snapshot()

    def _staged(self, snap: ServeSnapshot) -> _StagedSnapshot:
        return self._stages.get(id(snap), snap, backend=self.backend,
                                precision=self.precision)

    # -- serving ------------------------------------------------------------
    def run(self, queries: Iterable[KernelQuery]) -> list[KernelQuery]:
        """Serve all queries in admission order; returns them with
        `.prediction` and `.staleness` filled. Latency percentiles for
        the run are in `self.latency.report()`."""
        queue = AdmissionQueue()
        self.latency.reset()
        snap0 = self._snapshot()
        for q in queries:
            width = _validate_query(q, snap0)
            queue.admit(q, uid=q.uid, width=width, now=self.latency.now())
        finished: list[KernelQuery] = []
        while len(queue):
            wave = queue.take_wave(self.batch_size)
            with span("serve.wave", slots=len(wave),
                      columns=sum(e.width for e in wave)):
                st = self._staged(self._snapshot())
                _serve_wave(st, wave)
            self.latency.record_wave(wave, self.latency.now())
            finished.extend(e.item for e in wave)
        return finished


class DeKRRReplicaServer:
    """N serving replicas answering from the freshest published snapshot.

    Each replica is a thread running the wave loop of `DeKRRServeEngine`
    against a shared `AdmissionQueue`; per wave it reads
    `registry.latest_versioned()` — an atomic tuple read that never
    blocks the solver side — and serves from a per-version staged copy
    of the snapshot. Replicas launch on the current CUDA stream; the
    kernel launch (ctypes) and PyTorch's CUDA calls release the GIL, so
    one replica's host work overlaps another's device work. A replica
    that raises stops, and `stop()` re-raises its error.

    Use `run(queries)` for closed-loop serving (submit-then-drain), or
    `start()` / `submit()` / `stop()` for open-loop load. `clock` is
    injectable for deterministic latency accounting in tests.
    """

    def __init__(self, registry: SnapshotRegistry, *, replicas: int = 2,
                 batch_size: int = 64, backend: str = "cuda",
                 precision: str | None = None,
                 clock: Callable[[], float] = perf_clock):
        if not isinstance(registry, SnapshotRegistry):
            raise TypeError(
                f"DeKRRReplicaServer serves from a SnapshotRegistry, got "
                f"{type(registry).__name__} — wrap frozen snapshots via "
                f"registry.publish(snap)")
        if replicas < 1:
            raise ValueError("replicas must be >= 1")
        _check_config(backend, precision, batch_size)
        self.registry = registry
        self.replicas = replicas
        self.batch_size = batch_size
        self.backend = backend
        self.precision = precision
        self.queue = AdmissionQueue()
        self.latency = LatencyRecorder(clock)
        self.waves_served = 0
        self._stages = _StageCache()
        self._count_lock = threading.Lock()
        self._threads: list[threading.Thread] = []
        self._draining = False
        self._errors: list[BaseException] = []

    # -- submission ---------------------------------------------------------
    def submit(self, q: KernelQuery, *, now: float | None = None) -> None:
        """Validate and admit one query (thread-safe). `now` overrides
        the admission timestamp for replayed load traces."""
        width = _validate_query(q, self.registry.latest())
        self.queue.admit(q, uid=q.uid, width=width,
                         now=self.latency.now() if now is None else now)

    # -- replica loop -------------------------------------------------------
    def _replica_loop(self) -> None:
        try:
            while True:
                wave = self.queue.take_wave(self.batch_size)
                if not wave:
                    if self._draining:
                        return
                    time.sleep(0.0005)
                    continue
                with span("serve.wave", slots=len(wave),
                          columns=sum(e.width for e in wave)):
                    version, snap = self.registry.latest_versioned()
                    st = self._stages.get(version, snap,
                                          backend=self.backend,
                                          precision=self.precision)
                    _serve_wave(st, wave)
                self.latency.record_wave(wave, self.latency.now())
                with self._count_lock:
                    self.waves_served += 1
        except BaseException as exc:  # surfaced by stop()
            self._errors.append(exc)

    def start(self) -> None:
        """Spawn the replica threads (idle-polling until work arrives)."""
        if self._threads:
            raise RuntimeError("replica server already started")
        self._draining = False
        self._errors = []
        self._threads = [
            threading.Thread(target=self._replica_loop,
                             name=f"dekrr-replica-{i}", daemon=True)
            for i in range(self.replicas)]
        for t in self._threads:
            t.start()

    def stop(self) -> None:
        """Drain the queue, join every replica, re-raise replica errors."""
        self._draining = True
        for t in self._threads:
            t.join()
        self._threads = []
        if self._errors:
            raise self._errors[0]

    def run(self, queries: Iterable[KernelQuery],
            arrivals: Iterable[float] | None = None) -> list[KernelQuery]:
        """Closed-loop serve: submit every query, drain across all
        replicas, return the (mutated-in-place) queries. `arrivals`
        optionally pins per-query admission timestamps so a seeded load
        trace produces a deterministic latency report."""
        queries = list(queries)
        self.latency.reset()
        if arrivals is None:
            for q in queries:
                self.submit(q)
        else:
            arrivals = list(arrivals)
            if len(arrivals) != len(queries):
                raise ValueError(
                    f"got {len(arrivals)} arrival times for "
                    f"{len(queries)} queries")
            for q, t_arr in zip(queries, arrivals):
                self.submit(q, now=t_arr)
        self.start()
        self.stop()
        return queries

    def report(self) -> LatencyReport:
        return self.latency.report()
