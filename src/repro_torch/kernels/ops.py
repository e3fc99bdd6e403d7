"""Public wrappers of the port's kernels.

Each wrapper owns the layout its kernel takes, checks device, dtype,
shape and contiguity, and dispatches on the device of its tensors: on the
CPU it runs the kernel's plain PyTorch version, on a CUDA device it
launches the kernel (or raises). It never falls back from one to the
other.

Layout owned here, mirroring `repro.kernels.ops`:

* the Dy flatten ``[T, D, Dy] → [T·Dy, D]`` (`_flatten_dy` /
  `_unflatten_dy`);
* the K ≥ 1 zero slot for edgeless graphs (`_pad_dekrr_operands`);
* the bounds check of the slot tables (`_check_dekrr_indices`, and
  `_check_async_nbr_indices` for the node-id tables of the async chain).

The TPU wrappers' (8, 128) padding has no counterpart: the CUDA kernels
mask their own ragged edges.

`LAUNCHES` counts kernel launches per kernel; a wrapper adds one exactly
where it launches its kernel, never on the CPU path, under a lock, since
serving replicas launch from several threads. The round kernel with an
activation mask counts as ``dekrr_step_masked``, apart from the unmasked
round; the featurize kernel counts as ``rff_features`` in f64/f32 and as
``rff_features_lowp`` in bf16, once a launch whether it covers one node
or a whole wave; the decode-attention kernel as ``flash_decode``; the
Gram kernel as ``rff_gram``, once a call on either route (the wide route
makes two kernel launches per pass and N chunk, `kernels.rff_gram.
WideGramPlan`).
"""
from __future__ import annotations

import functools
import math
import threading

import numpy as np
import torch

from repro_torch.kernels.dekrr_solve import (dekrr_async_solve_cuda,
                                             dekrr_async_solve_reference,
                                             dekrr_cheb_solve_cuda,
                                             dekrr_cheb_solve_reference,
                                             dekrr_solve_cuda,
                                             dekrr_solve_reference)
from repro_torch.kernels.decode_attention import (flash_decode_cuda,
                                                  flash_decode_reference)
from repro_torch.kernels.dekrr_step import (dekrr_step_cuda,
                                            dekrr_step_masked_reference,
                                            dekrr_step_reference)
from repro_torch.kernels.ref import rff_gram_ref
from repro_torch.kernels.rff_features import (
    rff_features_batched_reference, rff_features_bf16_batched_reference,
    rff_features_cuda, rff_features_lowp_reference, rff_features_reference)
from repro_torch.kernels.rff_gram import (rff_gram_batched_reference,
                                          rff_gram_cuda)

LAUNCHES = {"rff_gram": 0, "dekrr_step": 0, "dekrr_step_masked": 0,
            "dekrr_solve": 0, "dekrr_async_solve": 0, "dekrr_cheb_solve": 0,
            "rff_features": 0, "rff_features_lowp": 0, "flash_decode": 0}
_FLOATS = (torch.float32, torch.float64)
_count_lock = threading.Lock()


def _count(name: str) -> None:
    with _count_lock:
        LAUNCHES[name] += 1


def reset_launch_counts() -> None:
    with _count_lock:
        for name in LAUNCHES:
            LAUNCHES[name] = 0


def launch_counts() -> dict[str, int]:
    with _count_lock:
        return dict(LAUNCHES)


def _on_cuda(name: str, *tensors: torch.Tensor) -> bool:
    """True for CUDA operands, False for CPU ones; raises on a mix or on
    any other device type."""
    devices = {t.device for t in tensors}
    if len(devices) != 1:
        raise ValueError(f"{name}: operands lie on several devices "
                         f"{sorted(map(str, devices))}")
    dev = devices.pop()
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"{name}: unsupported device {dev}")
    return dev.type == "cuda"


def _check_floats(name: str, *tensors: torch.Tensor) -> torch.dtype:
    dtypes = {t.dtype for t in tensors}
    if len(dtypes) != 1 or next(iter(dtypes)) not in _FLOATS:
        raise TypeError(f"{name}: operands must share one dtype of "
                        f"{_FLOATS}, got {sorted(map(str, dtypes))}")
    return dtypes.pop()


def _check_contiguous(name: str, **tensors: torch.Tensor) -> None:
    for key, t in tensors.items():
        if not t.is_contiguous():
            raise ValueError(f"{name}: {key} must be contiguous")


def _check_shape(name: str, key: str, t: torch.Tensor, want: tuple) -> None:
    if tuple(t.shape) != tuple(want):
        raise ValueError(f"{name}: {key} has shape {tuple(t.shape)}, "
                         f"expected {tuple(want)}")


# ---------------------------------------------------------------- featurize
@functools.lru_cache(maxsize=64)
def _node_table(values: tuple, dtype: torch.dtype,
                device: torch.device) -> torch.Tensor:
    """The per-node scales or feature counts as a device tensor, made once
    per distinct table (a snapshot's waves reuse it) and never written."""
    return torch.tensor(values, dtype=dtype, device=device)


def _check_features(name, omega, bias, x):
    if omega.ndim != 2 or x.ndim != 2:
        raise ValueError(f"{name}: omega {tuple(omega.shape)} and x "
                         f"{tuple(x.shape)} must be [D, d] and [d, N]")
    _check_shape(name, "bias", bias, (omega.shape[0],))
    _check_shape(name, "x", x, (omega.shape[1], x.shape[1]))
    return _on_cuda(name, omega, bias, x)


def _check_batched_features(name, omega, bias, x, scale, d_feat):
    """(on_cuda, scale tuple, d_feat tuple) of a batched featurize call;
    raises on shapes, devices, non-contiguous operands or a feature count
    outside [0, D_max]."""
    if omega.ndim != 3 or x.ndim != 2:
        raise ValueError(f"{name}: omega {tuple(omega.shape)} and x "
                         f"{tuple(x.shape)} must be [J, D_max, d] and [d, N]")
    j, d_max, dim = omega.shape
    _check_shape(name, "bias", bias, (j, d_max))
    _check_shape(name, "x", x, (dim, x.shape[1]))
    scale = tuple(float(v) for v in scale)
    d_feat = tuple(int(v) for v in d_feat)
    if len(scale) != j or len(d_feat) != j:
        raise ValueError(f"{name}: {len(scale)} scales and {len(d_feat)} "
                         f"feature counts for {j} nodes")
    if any(not 0 <= v <= d_max for v in d_feat):
        raise ValueError(f"{name}: feature counts {list(d_feat)} must lie "
                         f"in [0, D_max = {d_max}]")
    on_cuda = _on_cuda(name, omega, bias, x)
    _check_contiguous(name, omega=omega, bias=bias, x=x)
    return on_cuda, scale, d_feat


def _launch_features(omega, bias, x, scale, d_feat, dtype):
    """One kernel launch over contiguous CUDA operands of ``dtype``
    (scale None in bf16) → Z [J, D_max, N] in ``dtype``."""
    j, d_max, _ = omega.shape
    z = torch.empty((j, d_max, x.shape[1]), dtype=dtype, device=x.device)
    if z.numel():
        table = None if scale is None \
            else _node_table(scale, dtype, x.device)
        rff_features_cuda(omega, bias, x, table,
                          _node_table(d_feat, torch.int32, x.device), z)
        _count("rff_features_lowp" if dtype == torch.bfloat16
               else "rff_features")
    return z


def rff_features(omega: torch.Tensor, bias: torch.Tensor, x: torch.Tensor,
                 *, scale: float) -> torch.Tensor:
    """Z = scale·cos(Ω X + b): omega [D, d], bias [D], x [d, N] → Z [D, N]
    in the operands' dtype (f32 or f64). On CUDA: the batched kernel with
    J = 1."""
    name = "rff_features"
    on_cuda = _check_features(name, omega, bias, x)
    dtype = _check_floats(name, omega, bias, x)
    if not on_cuda:
        return rff_features_reference(omega, bias, x, scale=scale)
    return _launch_features(omega.contiguous()[None],
                            bias.contiguous()[None], x.contiguous(),
                            (scale,), (omega.shape[0],), dtype)[0]


def rff_features_batched(omega: torch.Tensor, bias: torch.Tensor,
                         x: torch.Tensor, *, scale, d_feat) -> torch.Tensor:
    """Every node of a wave in one launch: omega [J, D_max, d], bias
    [J, D_max], x [d, N] (shared by the nodes), ``scale`` and ``d_feat``
    sequences of J floats and ints (D_j ≤ D_max) → Z [J, D_max, N] in the
    operands' dtype (f32 or f64), Z[j, :D_j] = scale_j·cos(Ω_j X + b_j) and
    exact zeros below. Node j's rows are bit-equal to `rff_features` on
    its first D_j rows, on the card as on the CPU."""
    name = "rff_features"
    on_cuda, scale, d_feat = _check_batched_features(name, omega, bias, x,
                                                     scale, d_feat)
    dtype = _check_floats(name, omega, bias, x)
    if not on_cuda:
        return rff_features_batched_reference(omega, bias, x, scale=scale,
                                              d_feat=d_feat)
    return _launch_features(omega, bias, x, scale, d_feat, dtype)


def _check_real(name, omega, bias, x):
    for key, t in (("omega", omega), ("bias", bias), ("x", x)):
        if not t.is_floating_point():
            raise TypeError(f"{name}: {key} must be floating point, got "
                            f"{t.dtype}")


def rff_features_lowp(omega: torch.Tensor, bias: torch.Tensor,
                      x: torch.Tensor, *, scale: float) -> torch.Tensor:
    """Low-precision serving featurize: Ω, b and X (any float dtypes) are
    cast to bf16, the product is summed in f32 and rounded to bf16, the
    bias sum and the f32 cosine are rounded to bf16, and the result is
    cast to f32 and multiplied by the f32 ``scale``. Returns Z [D, N] in
    float32. The serving tier's analytic forward-error bound assumes
    exactly this arrangement, so the scale stays out of the bf16 kernel.
    On CUDA: the batched kernel with J = 1."""
    name = "rff_features_lowp"
    on_cuda = _check_features(name, omega, bias, x)
    _check_real(name, omega, bias, x)
    if not on_cuda:
        return rff_features_lowp_reference(omega, bias, x, scale=scale)
    bf16 = torch.bfloat16
    z = _launch_features(omega.to(bf16).contiguous()[None],
                         bias.to(bf16).contiguous()[None],
                         x.to(bf16).contiguous(), None, (omega.shape[0],),
                         bf16)[0]
    return z.float() * scale


def rff_features_lowp_batched(omega: torch.Tensor, bias: torch.Tensor,
                              x: torch.Tensor, *, scale,
                              d_feat) -> torch.Tensor:
    """`rff_features_lowp` for every node of a wave in one launch: omega
    [J, D_max, d], bias [J, D_max], x [d, N] (any float dtypes, cast to
    bf16), per-node f32 ``scale`` and ``d_feat`` (sequences of J) → Z
    [J, D_max, N] in float32, node j's first D_j rows bit-equal to
    `rff_features_lowp` on them and exact zeros below."""
    name = "rff_features_lowp"
    on_cuda, scale, d_feat = _check_batched_features(name, omega, bias, x,
                                                     scale, d_feat)
    _check_real(name, omega, bias, x)
    bf16 = torch.bfloat16
    omega, bias, x = omega.to(bf16), bias.to(bf16), x.to(bf16)
    if not on_cuda:
        z = rff_features_bf16_batched_reference(omega, bias, x,
                                                d_feat=d_feat)
        scales = torch.tensor(scale, dtype=torch.float32)
    else:
        z = _launch_features(omega, bias, x, None, d_feat, bf16)
        scales = _node_table(scale, torch.float32, x.device)
    return z.float() * scales[:, None, None]


# ------------------------------------------------------------------ decode
FLASH_DECODE_MAX_HEAD_DIM = 256


def flash_decode(q: torch.Tensor, k_cache: torch.Tensor,
                 v_cache: torch.Tensor,
                 cur_index: int | torch.Tensor) -> torch.Tensor:
    """Single-token decode attention: q [B, 1, H, dh] against k/v caches
    [B, S, K, dh] (GQA: H % K == 0) whose first ``cur_index`` positions
    are valid, ``cur_index`` a scalar in [1, S] (a tensor is read to the
    host). Returns [B, 1, H, dh] in q's dtype. Float64 operands are cast
    to float32 and the result back, as the reference does.

    On CUDA the kernel takes f32 with dh a multiple of 4 up to 256, q
    contiguous, and caches whose head and dh axes are contiguous (any
    batch and position strides, multiples of 4) at 16-byte aligned
    addresses; anything else raises."""
    name = "flash_decode"
    if q.ndim != 4 or k_cache.ndim != 4 or q.shape[1] != 1:
        raise ValueError(f"{name}: q {tuple(q.shape)} and k_cache "
                         f"{tuple(k_cache.shape)} must be [B, 1, H, dh] and "
                         f"[B, S, K, dh]")
    b, _, h, dh = q.shape
    s, kh = k_cache.shape[1], k_cache.shape[2]
    _check_shape(name, "k_cache", k_cache, (b, s, kh, dh))
    _check_shape(name, "v_cache", v_cache, (b, s, kh, dh))
    if kh == 0 or h % kh:
        raise ValueError(f"{name}: {h} query heads do not group over {kh} "
                         f"kv heads")
    on_cuda = _on_cuda(name, q, k_cache, v_cache)
    out_dtype = _check_floats(name, q, k_cache, v_cache)
    cur = int(cur_index)
    if not 1 <= cur <= s:
        raise ValueError(f"{name}: cur_index {cur} lies outside [1, {s}]")
    if out_dtype == torch.float64:
        q, k_cache, v_cache = (t.float() for t in (q, k_cache, v_cache))
    lens = torch.full((b * kh,), cur, dtype=torch.int32, device=q.device)
    if not on_cuda:
        return flash_decode_reference(q, k_cache, v_cache,
                                      lens).to(out_dtype)
    _check_contiguous(name, q=q)
    if dh % 4 or dh > FLASH_DECODE_MAX_HEAD_DIM:
        raise ValueError(f"{name}: head_dim {dh} must be a multiple of 4 "
                         f"up to {FLASH_DECODE_MAX_HEAD_DIM}")
    for key, t in (("k_cache", k_cache), ("v_cache", v_cache)):
        if t.stride(3) != 1 or t.stride(2) != dh:
            raise ValueError(f"{name}: {key} must have contiguous head and "
                             f"dh axes, got strides {t.stride()}")
        if t.stride(0) % 4 or t.stride(1) % 4 or t.data_ptr() % 16:
            raise ValueError(f"{name}: {key} must be 16-byte aligned with "
                             f"batch and position strides that are "
                             f"multiples of 4, got strides {t.stride()}")
    if q.data_ptr() % 16:
        raise ValueError(f"{name}: q must be 16-byte aligned")
    out = torch.empty_like(q)
    flash_decode_cuda(q, k_cache, v_cache, lens, out)
    _count(name)
    return out.to(out_dtype)


# --------------------------------------------------------------------- Gram
def rff_gram_batched(omega: torch.Tensor, bias: torch.Tensor,
                     x: torch.Tensor, y: torch.Tensor,
                     col_mask: torch.Tensor
                     ) -> tuple[torch.Tensor, torch.Tensor]:
    """Fused Gram blocks over a leading problem axis, cos_bias at unit
    scale: omega [B, F, d], bias [B, F], x [B, d, N], y [B, N],
    col_mask [B, N] → (gram [B, F, F], zy [B, F]) with
    Z = cos(Ω X + b)·col_mask. Callers fold in the per-node √(2/D_j) and
    mask padded frequencies (`repro_torch.dist.pack_problem`).

    On CUDA tensors any F: up to 560 in f64 and 1,024 in f32 the
    kernel's cluster route (every block holds all F rows of a Z tile in
    shared memory), beyond that its wide route, which forms each Z
    entry once into a workspace (`kernels.rff_gram.gram_plan`)."""
    name = "rff_gram_batched"
    b, f, dim = omega.shape
    n = x.shape[2]
    _check_shape(name, "bias", bias, (b, f))
    _check_shape(name, "x", x, (b, dim, n))
    _check_shape(name, "y", y, (b, n))
    _check_shape(name, "col_mask", col_mask, (b, n))
    dtype = _check_floats(name, omega, bias, x, y, col_mask)
    if not _on_cuda(name, omega, bias, x, y, col_mask):
        return rff_gram_batched_reference(omega, bias, x, y, col_mask)
    return _launch_rff_gram(omega, bias, x, y, col_mask, 1.0, dtype)


def rff_gram(omega: torch.Tensor, bias: torch.Tensor, x: torch.Tensor,
             y: torch.Tensor, *, scale: float
             ) -> tuple[torch.Tensor, torch.Tensor]:
    """Fused (Z Zᵀ, Z yᵀ) for Z = scale·cos(Ω X + b): omega [D, d],
    bias [D], x [d, N], y [N] → (G [D, D], zy [D]), through the kernel
    of `rff_gram_batched` on CUDA tensors."""
    name = "rff_gram"
    d_feat, dim = omega.shape
    n = x.shape[1]
    _check_shape(name, "bias", bias, (d_feat,))
    _check_shape(name, "x", x, (dim, n))
    _check_shape(name, "y", y, (n,))
    dtype = _check_floats(name, omega, bias, x, y)
    if not _on_cuda(name, omega, bias, x, y):
        return rff_gram_ref(omega, bias, x, y, scale=scale)
    mask = torch.ones((1, n), dtype=dtype, device=x.device)
    gram, zy = _launch_rff_gram(omega[None], bias[None], x[None], y[None],
                                mask, scale, dtype)
    return gram[0], zy[0]


def _launch_rff_gram(omega, bias, x, y, col_mask, scale, dtype):
    omega, bias, x, y, col_mask = (t.contiguous() for t in
                                   (omega, bias, x, y, col_mask))
    b, f, _ = omega.shape
    gram = torch.empty((b, f, f), dtype=dtype, device=x.device)
    zy = torch.empty((b, f), dtype=dtype, device=x.device)
    rff_gram_cuda(omega, bias, x, y, col_mask, gram, zy, scale=scale)
    _count("rff_gram")
    return gram, zy


def gram_fn_for_solver(fmap, x: torch.Tensor) -> torch.Tensor:
    """Drop-in ``gram_fn`` for `repro_torch.core.DeKRRSolver`: Z(Ω, X)
    Z(Ω, X)ᵀ through `rff_gram` (the kernel on CUDA tensors, its plain
    version on CPU ones), cos_bias maps only, computed in float32 as the
    reference's; the result is cast back to ``x.dtype``."""
    if fmap.kind != "cos_bias":
        raise NotImplementedError("fused gram kernel supports cos_bias maps")
    # √(2/D) in float64, rounded to f32 where the kernel applies it
    scale = math.sqrt(2.0 / fmap.num_frequencies)
    dtype = torch.float32
    g, _ = rff_gram(fmap.omega.to(dtype), fmap.bias.to(dtype), x.to(dtype),
                    torch.zeros(x.shape[1], dtype=dtype, device=x.device),
                    scale=scale)
    return g.to(x.dtype)


# -------------------------------------------------------------- Eq. 19 round
def _dekrr_dy(d: torch.Tensor) -> int:
    """Output width Dy: d/theta are [.., D] or [.., D, Dy]."""
    return 1 if d.ndim == 2 else int(d.shape[2])


def _flatten_dy(a: torch.Tensor) -> torch.Tensor:
    """[T, D, Dy] → [T·Dy, D] (table row t owns rows [t·Dy, (t+1)·Dy),
    i.e. θ_tᵀ); 2-D scalar-target operands pass through."""
    if a.ndim == 2:
        return a.contiguous()
    t, d_feat, dy = a.shape
    return a.transpose(1, 2).reshape(t * dy, d_feat).contiguous()


def _unflatten_dy(out: torch.Tensor, dy: int, ndim: int) -> torch.Tensor:
    """Invert `_flatten_dy` on a kernel output: [J·Dy, D] → [J, D] for
    scalar-layout operands, [J, D, Dy] for trailing-axis ones (even at
    Dy = 1, so a [.., 1] layout keeps its axis)."""
    if ndim == 2:
        return out
    j_nodes = out.shape[0] // dy
    return out.reshape(j_nodes, dy, -1).transpose(1, 2)


def check_index_table(name: str, table, size: int, *, lo: int = 0) -> None:
    """Every entry of the integer array-like ``table`` must lie in
    ``[lo, size)``; raises ValueError naming the offending range. A kernel
    gathering through an index table has no bounds check of its own (the
    port's copy of `repro.analysis.vmem.check_index_table`)."""
    arr = np.asarray(table)
    if arr.size == 0:
        return
    if not np.issubdtype(arr.dtype, np.integer):
        raise ValueError(
            f"{name}: index table must be integer-typed, got {arr.dtype}")
    amin, amax = int(arr.min()), int(arr.max())
    if amin < lo or amax >= size:
        raise ValueError(
            f"{name}: indices must lie in [{lo}, {size}) but span "
            f"[{amin}, {amax}] — an out-of-range slot would silently "
            f"gather an arbitrary table row")


def _check_dekrr_indices(t_rows: int, nbr_idx, self_idx, nbr_mask, *,
                         distinct_self: bool = False) -> None:
    """Bounds-check the slot tables against the θ-table row count on the
    host: a kernel reading an out-of-range row would gather arbitrary
    memory. Masked slots may hold any index."""
    own = self_idx.detach().cpu().numpy()
    if own.size and (own.min() < 0 or own.max() >= t_rows):
        raise ValueError(f"self_idx: indices must lie in [0, {t_rows}) but "
                         f"span [{own.min()}, {own.max()}]")
    if distinct_self and np.unique(own).size != own.size:
        raise ValueError("self_idx: rows must be distinct (two nodes "
                         "would write one θ-table row)")
    live = nbr_mask.detach().cpu().numpy() != 0
    idx = nbr_idx.detach().cpu().numpy()[live]
    if idx.size and (idx.min() < 0 or idx.max() >= t_rows):
        raise ValueError(f"nbr_idx: live indices must lie in [0, {t_rows}) "
                         f"but span [{idx.min()}, {idx.max()}]")


def _pad_dekrr_operands(name, g, d, s, p, theta, nbr_idx, self_idx,
                        nbr_mask):
    """Check the DeKRR operand set and bring it to the kernels' layout:
    Dy flattened into rows, the slot axis at K ≥ 1 (an all-masked zero-P
    slot for edgeless graphs), int32 index tables and a 0/1 int32 mask.
    Returns (on_cuda, dy, operands)."""
    if d.ndim not in (2, 3) or theta.ndim != d.ndim:
        raise ValueError(f"{name}: d {tuple(d.shape)} and theta "
                         f"{tuple(theta.shape)} must both be [.., D] or "
                         f"both [.., D, Dy]")
    j_nodes, d_feat = d.shape[0], d.shape[1]
    dy = _dekrr_dy(d)
    k_slots = p.shape[1] if p.ndim == 4 else -1
    _check_shape(name, "g", g, (j_nodes, d_feat, d_feat))
    _check_shape(name, "s", s, (j_nodes, d_feat, d_feat))
    _check_shape(name, "p", p, (j_nodes, k_slots, d_feat, d_feat))
    _check_shape(name, "theta", theta,
                 (theta.shape[0],) + tuple(d.shape[1:]))
    _check_shape(name, "nbr_idx", nbr_idx, (j_nodes, k_slots))
    _check_shape(name, "nbr_mask", nbr_mask, (j_nodes, k_slots))
    _check_shape(name, "self_idx", self_idx, (j_nodes,))
    _check_floats(name, g, d, s, p, theta)
    _check_contiguous(name, g=g, s=s, p=p)
    on_cuda = _on_cuda(name, g, d, s, p, theta, nbr_idx, self_idx, nbr_mask)
    if k_slots == 0:
        p = torch.zeros((j_nodes, 1, d_feat, d_feat), dtype=p.dtype,
                        device=p.device)
        nbr_idx = torch.zeros((j_nodes, 1), dtype=torch.int32,
                              device=p.device)
        nbr_mask = torch.zeros((j_nodes, 1), dtype=torch.int32,
                               device=p.device)
    ops = (g, _flatten_dy(d), s, p, _flatten_dy(theta),
           nbr_idx.to(torch.int32).contiguous(),
           self_idx.to(torch.int32).contiguous(),
           (nbr_mask != 0).to(torch.int32).contiguous())
    return on_cuda, dy, ops


def dekrr_step(g: torch.Tensor, d: torch.Tensor, s: torch.Tensor,
               p: torch.Tensor, theta: torch.Tensor, nbr_idx: torch.Tensor,
               self_idx: torch.Tensor, nbr_mask: torch.Tensor,
               active: torch.Tensor | None = None) -> torch.Tensor:
    """One packed Eq. 19 round: θ_j ← G_j(d_j + S_j θ_sj + Σ m P_jk θ_rk).

    g/s [J, D, D], d [J, D], p [J, K, D, D], theta [T, D] (θ table, T ≠ J
    allowed), nbr_idx [J, K] / self_idx [J] rows into the table, nbr_mask
    [J, K] (nonzero = live slot) → [J, D]. Multi-output: d [J, D, Dy] /
    theta [T, D, Dy] → [J, D, Dy].

    ``active`` ([J], any dtype) runs the activation-masked round of the
    asynchronous gossip: nodes with active[j] == 0 return their θ-table
    rows unchanged. With ``active`` omitted or all ones the arithmetic is
    the unmasked round's, bit for bit.
    """
    name = "dekrr_step"
    on_cuda, dy, ops = _pad_dekrr_operands(name, g, d, s, p, theta, nbr_idx,
                                           self_idx, nbr_mask)
    _check_dekrr_indices(theta.shape[0], ops[5], ops[6], ops[7])
    act = None
    if active is not None:
        _check_shape(name, "active", active, (d.shape[0],))
        _on_cuda(name, d, active)             # raises on a device mix
        act = (active != 0).to(torch.int32).contiguous()
    if not on_cuda:
        out = dekrr_step_reference(*ops, dy=dy) if act is None \
            else dekrr_step_masked_reference(*ops, act, dy=dy)
    else:
        out = torch.empty((d.shape[0] * dy, d.shape[1]), dtype=d.dtype,
                          device=d.device)
        dekrr_step_cuda(*ops, out, dy=dy, active=act)
        _count("dekrr_step" if act is None else "dekrr_step_masked")
    return _unflatten_dy(out, dy, d.ndim)


def dekrr_solve(g: torch.Tensor, d: torch.Tensor, s: torch.Tensor,
                p: torch.Tensor, theta: torch.Tensor, nbr_idx: torch.Tensor,
                self_idx: torch.Tensor, nbr_mask: torch.Tensor, *,
                num_rounds: int, trace: bool = False):
    """`num_rounds` Jacobi rounds in one launch (`dekrr_step`'s operand
    contract). Table rows owned by no node stay at their θ0 values; the
    [J, D] (or [J, D, Dy]) rows after the last round are returned, plus
    res [R, J] = max|Δθ_j| per round with ``trace``. ``num_rounds=0``
    returns the self_idx rows of θ unchanged. self_idx rows must be
    distinct."""
    name = "dekrr_solve"
    if num_rounds < 0:
        raise ValueError(f"{name}: num_rounds must be >= 0, got "
                         f"{num_rounds}")
    on_cuda, dy, ops = _pad_dekrr_operands(name, g, d, s, p, theta, nbr_idx,
                                           self_idx, nbr_mask)
    _check_dekrr_indices(theta.shape[0], ops[5], ops[6], ops[7],
                         distinct_self=True)
    j_nodes = d.shape[0]
    if num_rounds == 0:
        out = theta[self_idx.long()]
        if trace:
            return out, torch.zeros((0, j_nodes), dtype=theta.dtype,
                                    device=theta.device)
        return out
    if not on_cuda:
        out = dekrr_solve_reference(*ops, num_rounds=num_rounds, dy=dy,
                                    trace=trace)
        if trace:
            return _unflatten_dy(out[0], dy, d.ndim), out[1]
        return _unflatten_dy(out, dy, d.ndim)
    table = ops[4]
    out = torch.empty((j_nodes * dy, d.shape[1]), dtype=d.dtype,
                      device=d.device)
    res = torch.empty((num_rounds, j_nodes), dtype=d.dtype,
                      device=d.device) if trace else None
    work = torch.empty((2,) + tuple(table.shape), dtype=d.dtype,
                       device=d.device)
    dekrr_solve_cuda(*ops, out, res, work, num_rounds=num_rounds, dy=dy)
    _count("dekrr_solve")
    out = _unflatten_dy(out, dy, d.ndim)
    return (out, res) if trace else out


# ------------------------------------------------------------- async chain
def _check_async_nbr_indices(j_nodes: int, nbr_idx: torch.Tensor,
                             nbr_mask: torch.Tensor) -> None:
    """The async chain's nbr_idx entries are NODE ids: they index the [J]
    broadcast-flag vectors as well as θ rows, so live slots must lie in
    [0, J), not merely inside the θ table."""
    live = nbr_mask.detach().cpu().numpy() != 0
    check_index_table("nbr_idx", nbr_idx.detach().cpu().numpy()[live],
                      j_nodes)


def _flatten_buffers(buf: torch.Tensor) -> torch.Tensor:
    """[J, K, D] → [J·K, D]; [J, K, D, Dy] → [J·K·Dy, D] (slot (j, k) at
    row block j·K + k)."""
    j_nodes, k_slots, d_feat = buf.shape[:3]
    if buf.ndim == 3:
        return buf.reshape(j_nodes * k_slots, d_feat).contiguous()
    return buf.transpose(2, 3).reshape(-1, d_feat).contiguous()


def _unflatten_buffers(out: torch.Tensor, j_nodes: int, k_keep: int,
                       dy: int, ndim: int) -> torch.Tensor:
    """Invert `_flatten_buffers`, keeping the first ``k_keep`` slots (the
    wrapper pads K = 0 to one slot)."""
    blocks = out.reshape(j_nodes, -1, dy, out.shape[1])[:, :k_keep]
    if ndim == 2:
        return blocks[:, :, 0]
    return blocks.transpose(2, 3)


def dekrr_async_solve(g: torch.Tensor, d: torch.Tensor, s: torch.Tensor,
                      p: torch.Tensor, theta: torch.Tensor, sent: torch.Tensor,
                      buffers: torch.Tensor, nbr_idx: torch.Tensor,
                      nbr_mask: torch.Tensor, active_tab: torch.Tensor,
                      thresholds: torch.Tensor, *, gossip: str = "bernoulli",
                      censored: bool = False, trace: bool = False):
    """The whole R-round asynchronous-gossip schedule in one launch.

    Block contract of `dekrr_step`, but θ is indexed by node id (row j =
    node j, no self_idx): theta/sent [T, D] with T ≥ J, buffers [J, K, D]
    (slot (j, k) holds the last θ node j received from nbr_idx[j, k]),
    nbr_idx [J, K] node ids, nbr_mask [J, K]; the schedule is active_tab
    [R, J] (nonzero = active) and thresholds [R] (read only when
    ``censored``). ``gossip="edge"`` delivers only to receivers active in
    that round. Multi-output: trailing Dy on theta/sent/d, buffers
    [J, K, D, Dy]; the censor takes max|Δθ| over features and outputs.

    Returns the state after the schedule (theta [J, D], sent [J, D],
    buffers [J, K, D]), so chunked callers chain bit for bit; with
    ``trace`` also res [R, J] (max|Δθ_j|) and bc [R, J] int32 (broadcast
    flags), 0 for inactive nodes. R = 0 returns the state unchanged.
    """
    name = "dekrr_async_solve"
    if gossip not in ("bernoulli", "edge"):
        raise ValueError(f"gossip must be 'bernoulli' or 'edge', "
                         f"got {gossip!r}")
    j_nodes = d.shape[0]
    num_rounds = active_tab.shape[0] if active_tab.ndim == 2 else -1
    _check_shape(name, "active_tab", active_tab, (num_rounds, j_nodes))
    _check_shape(name, "thresholds", thresholds, (num_rounds,))
    _check_shape(name, "sent", sent, tuple(theta.shape))
    _check_shape(name, "buffers", buffers,
                 (j_nodes, nbr_idx.shape[1]) + tuple(d.shape[1:]))
    if theta.shape[0] < j_nodes:
        raise ValueError(f"{name}: theta has {theta.shape[0]} rows, fewer "
                         f"than the {j_nodes} nodes")
    self_idx = torch.arange(j_nodes, dtype=torch.int32, device=d.device)
    on_cuda, dy, ops = _pad_dekrr_operands(name, g, d, s, p, theta, nbr_idx,
                                           self_idx, nbr_mask)
    _check_floats(name, d, sent, buffers, thresholds)
    _on_cuda(name, d, sent, buffers, active_tab, thresholds)
    _check_async_nbr_indices(j_nodes, ops[5], ops[7])
    if num_rounds == 0:
        out = (theta[:j_nodes], sent[:j_nodes], buffers)
        if trace:
            return out + (theta.new_zeros((0, j_nodes)),
                          torch.zeros((0, j_nodes), dtype=torch.int32,
                                      device=d.device))
        return out
    g_, d_, s_, p_, theta_f, nbr_idx_, _, nbr_mask_ = ops
    k_pad = p_.shape[1]
    if buffers.shape[1] == 0:
        buffers = buffers.new_zeros((j_nodes, k_pad) + tuple(d.shape[1:]))
    raw = (g_, d_, s_, p_, theta_f, _flatten_dy(sent),
           _flatten_buffers(buffers), nbr_idx_, nbr_mask_,
           (active_tab != 0).to(torch.int32).contiguous(),
           thresholds.contiguous())
    if not on_cuda:
        outs = dekrr_async_solve_reference(
            *raw, censored=censored, edge_gossip=gossip == "edge", dy=dy,
            trace=trace)
    else:
        d_feat = d.shape[1]
        kw = dict(dtype=d.dtype, device=d.device)
        outs = (torch.empty((j_nodes * dy, d_feat), **kw),
                torch.empty((j_nodes * dy, d_feat), **kw),
                torch.empty((j_nodes * k_pad * dy, d_feat), **kw))
        res = bc = None
        if trace:
            res = torch.empty((num_rounds + 1, j_nodes), **kw)
            bc = torch.empty((num_rounds + 1, j_nodes), dtype=torch.int32,
                             device=d.device)
            outs = outs + (res, bc)
        work = torch.empty((2,) + tuple(theta_f.shape), **kw)
        flags = torch.empty((2 * j_nodes,), dtype=torch.int32,
                            device=d.device)
        dekrr_async_solve_cuda(*raw, *outs[:3], res, bc, work, flags,
                               censored=censored,
                               edge_gossip=gossip == "edge", dy=dy)
        _count(name)
    state = (_unflatten_dy(outs[0], dy, d.ndim),
             _unflatten_dy(outs[1], dy, d.ndim),
             _unflatten_buffers(outs[2], j_nodes, nbr_idx.shape[1], dy,
                                d.ndim))
    if trace:
        return state + (outs[3][:num_rounds], outs[4][:num_rounds])
    return state


# --------------------------------------------------------- Chebyshev chain
def dekrr_cheb_solve(g: torch.Tensor, d: torch.Tensor, s: torch.Tensor,
                     p: torch.Tensor, theta: torch.Tensor,
                     delta: torch.Tensor, nbr_idx: torch.Tensor,
                     self_idx: torch.Tensor, nbr_mask: torch.Tensor,
                     alphas: torch.Tensor, betas: torch.Tensor, *,
                     trace: bool = False):
    """R Chebyshev-accelerated rounds in one launch.

    `dekrr_solve`'s operand contract plus delta [J, D] (each node's search
    direction p) and the [R] (α, β) schedule of
    `repro_torch.core.acceleration.chebyshev_coefficients`. Returns the
    (θ rows [J, D], p rows [J, D]) after the schedule, so chunked callers
    chain bit for bit; with ``trace`` also res [R, J] = max|Δθ_j| of the
    accelerated step. R = 0 returns (theta[self_idx], delta). Multi-output:
    trailing Dy on d/theta/delta. self_idx rows must be distinct.
    """
    name = "dekrr_cheb_solve"
    j_nodes = d.shape[0]
    num_rounds = alphas.shape[0] if alphas.ndim == 1 else -1
    _check_shape(name, "alphas", alphas, (num_rounds,))
    _check_shape(name, "betas", betas, (num_rounds,))
    _check_shape(name, "delta", delta, tuple(d.shape))
    on_cuda, dy, ops = _pad_dekrr_operands(name, g, d, s, p, theta, nbr_idx,
                                           self_idx, nbr_mask)
    _check_floats(name, d, delta, alphas, betas)
    _on_cuda(name, d, delta, alphas, betas)
    _check_dekrr_indices(theta.shape[0], ops[5], ops[6], ops[7],
                         distinct_self=True)
    if num_rounds == 0:
        out = (theta[self_idx.long()], delta)
        return out + (theta.new_zeros((0, j_nodes)),) if trace else out
    raw = ops[:5] + (_flatten_dy(delta),) + ops[5:] + (
        alphas.contiguous(), betas.contiguous())
    if not on_cuda:
        outs = dekrr_cheb_solve_reference(*raw, dy=dy, trace=trace)
    else:
        kw = dict(dtype=d.dtype, device=d.device)
        outs = (torch.empty((j_nodes * dy, d.shape[1]), **kw),
                torch.empty((j_nodes * dy, d.shape[1]), **kw))
        res = torch.empty((num_rounds, j_nodes), **kw) if trace else None
        work = torch.empty((2,) + tuple(ops[4].shape), **kw)
        dekrr_cheb_solve_cuda(*raw, *outs, res, work, dy=dy)
        _count(name)
        if trace:
            outs = outs + (res,)
    out = (_unflatten_dy(outs[0], dy, d.ndim),
           _unflatten_dy(outs[1], dy, d.ndim))
    return out + (outs[2],) if trace else out
