"""Fused random-feature Gram blocks of Eq. 17 — CUDA kernel and its plain
version.

Replaces `src/repro/kernels/rff_gram.py::rff_gram_pallas` (vmapped over
nodes by `repro.kernels.ops.rff_gram_batched`). For each problem b of a
batch:

    Z = scale · cos(Ω_b X_b + b_b) · colmask_b      (never stored)
    G_b = Z Zᵀ [F, F],  zy_b = Z y_bᵀ [F]

The kernel (`csrc/rff_gram.cu`) gives every block one 64×64 tile of one
G_b and loops over all N; it is bound by operations (2·F·d·N for the
features plus 2·F²·N for the Gram) and runs on the FP64 vector units.
Details and design are in the source. The wrapper that checks and
dispatches is `repro_torch.kernels.ops.rff_gram_batched`.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build


def rff_gram_batched_reference(omega: torch.Tensor, bias: torch.Tensor,
                               x: torch.Tensor, y: torch.Tensor,
                               col_mask: torch.Tensor, *, scale: float = 1.0
                               ) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain version: omega [B, F, d], bias [B, F], x [B, d, N], y [B, N],
    col_mask [B, N] → (gram [B, F, F], zy [B, F])."""
    z = torch.cos(omega @ x + bias[..., None]) * scale \
        * col_mask[:, None, :]
    return z @ z.transpose(1, 2), (z @ y[..., None])[..., 0]


def rff_gram_cuda(omega: torch.Tensor, bias: torch.Tensor, x: torch.Tensor,
                  y: torch.Tensor, col_mask: torch.Tensor, gram: torch.Tensor,
                  zy: torch.Tensor, *, scale: float) -> None:
    """Launch the kernel on checked, contiguous CUDA tensors of one dtype,
    writing gram [B, F, F] and zy [B, F] on the current stream."""
    b, f, dim = omega.shape
    n = x.shape[2]
    lib = _build.library("rff_gram")
    fn = lib.rff_gram_f64 if omega.dtype == torch.float64 \
        else lib.rff_gram_f32
    stream = torch.cuda.current_stream(omega.device).cuda_stream
    _build.check(fn(omega.data_ptr(), bias.data_ptr(), x.data_ptr(),
                    y.data_ptr(), col_mask.data_ptr(), gram.data_ptr(),
                    zy.data_ptr(), b, f, dim, n, float(scale), stream),
                 "rff_gram launch")
