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
* the bounds check of the slot tables (`_check_dekrr_indices`).

The TPU wrappers' (8, 128) padding has no counterpart: the CUDA kernels
mask their own ragged edges.

`LAUNCHES` counts kernel launches per kernel; a wrapper adds one exactly
where it launches its kernel, never on the CPU path.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.kernels.dekrr_solve import (dekrr_solve_cuda,
                                             dekrr_solve_reference)
from repro_torch.kernels.dekrr_step import (dekrr_step_cuda,
                                            dekrr_step_reference)
from repro_torch.kernels.ref import rff_gram_ref
from repro_torch.kernels.rff_gram import (rff_gram_batched_reference,
                                          rff_gram_cuda)

LAUNCHES = {"rff_gram": 0, "dekrr_step": 0, "dekrr_solve": 0}
_FLOATS = (torch.float32, torch.float64)


def reset_launch_counts() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def launch_counts() -> dict[str, int]:
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


# --------------------------------------------------------------------- Gram
def rff_gram_batched(omega: torch.Tensor, bias: torch.Tensor,
                     x: torch.Tensor, y: torch.Tensor,
                     col_mask: torch.Tensor
                     ) -> tuple[torch.Tensor, torch.Tensor]:
    """Fused Gram blocks over a leading problem axis, cos_bias at unit
    scale: omega [B, F, d], bias [B, F], x [B, d, N], y [B, N],
    col_mask [B, N] → (gram [B, F, F], zy [B, F]) with
    Z = cos(Ω X + b)·col_mask. Callers fold in the per-node √(2/D_j) and
    mask padded frequencies (`repro_torch.dist.pack_problem`)."""
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
    bias [D], x [d, N], y [N] → (G [D, D], zy [D])."""
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
    LAUNCHES["rff_gram"] += 1
    return gram, zy


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
               self_idx: torch.Tensor, nbr_mask: torch.Tensor
               ) -> torch.Tensor:
    """One packed Eq. 19 round: θ_j ← G_j(d_j + S_j θ_sj + Σ m P_jk θ_rk).

    g/s [J, D, D], d [J, D], p [J, K, D, D], theta [T, D] (θ table, T ≠ J
    allowed), nbr_idx [J, K] / self_idx [J] rows into the table, nbr_mask
    [J, K] (nonzero = live slot) → [J, D]. Multi-output: d [J, D, Dy] /
    theta [T, D, Dy] → [J, D, Dy].
    """
    name = "dekrr_step"
    on_cuda, dy, ops = _pad_dekrr_operands(name, g, d, s, p, theta, nbr_idx,
                                           self_idx, nbr_mask)
    _check_dekrr_indices(theta.shape[0], ops[5], ops[6], ops[7])
    if not on_cuda:
        out = dekrr_step_reference(*ops, dy=dy)
    else:
        out = torch.empty((d.shape[0] * dy, d.shape[1]), dtype=d.dtype,
                          device=d.device)
        dekrr_step_cuda(*ops, out, dy=dy)
        LAUNCHES["dekrr_step"] += 1
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
    LAUNCHES["dekrr_solve"] += 1
    out = _unflatten_dy(out, dy, d.ndim)
    return (out, res) if trace else out
