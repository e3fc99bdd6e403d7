"""Random-feature map of the serving tier — CUDA kernel and its plain
versions.

Replaces `src/repro/kernels/rff_features.py::rff_features_pallas`, which
the reference's serving tier reaches through `repro.kernels.ops`'s
`rff_features` (snapshot dtype) and `rff_features_lowp` (bf16):

    Z = scale · cos(Ω X + b)        Ω [D, d], b [D], X [d, N] → Z [D, N]

The kernel (`csrc/rff_features.cu`) gives every block one 64×64 tile of Z
and walks the input dim in chunks through shared memory; in f64 and f32
it accumulates in the working type, in bf16 it accumulates in f32 and
rounds three times (product, bias sum, cosine), the arrangement the
serving tier's precision bound models. At the serving shapes its time is
launch latency. The wrappers that check and dispatch are
`repro_torch.kernels.ops.rff_features` / `rff_features_lowp`.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import rff_features_ref

rff_features_reference = rff_features_ref


def rff_features_bf16_reference(omega: torch.Tensor, bias: torch.Tensor,
                                x: torch.Tensor) -> torch.Tensor:
    """Plain version of the bf16 kernel: bf16 omega [D, d], bias [D],
    x [d, N] → cos(Ω X + b) [D, N] in bf16 at unit scale. The product is
    summed in f32 (products of bf16 values are exact there) and rounded
    to bf16, the bias sum is rounded to bf16, and the cosine is taken in
    f32 and rounded to bf16."""
    bf16 = torch.bfloat16
    proj = (omega.float() @ x.float()).to(bf16)
    arg = (proj.float() + bias.float()[:, None]).to(bf16)
    return torch.cos(arg.float()).to(bf16)


def rff_features_lowp_reference(omega: torch.Tensor, bias: torch.Tensor,
                                x: torch.Tensor, *,
                                scale: float) -> torch.Tensor:
    """Plain version of `ops.rff_features_lowp`: Ω, b and X cast to bf16,
    the bf16 map, then the cast to f32 and the f32 scale."""
    bf16 = torch.bfloat16
    z = rff_features_bf16_reference(omega.to(bf16), bias.to(bf16),
                                    x.to(bf16))
    return z.float() * scale


def rff_features_cuda(omega: torch.Tensor, bias: torch.Tensor,
                      x: torch.Tensor, z: torch.Tensor, *,
                      scale: float) -> None:
    """Launch the kernel on checked, contiguous CUDA tensors of one dtype
    (f64, f32, or bf16 at unit scale), writing z [D, N] on the current
    stream."""
    d_feat, dim = omega.shape
    n = x.shape[1]
    lib = _build.library("rff_features")
    stream = torch.cuda.current_stream(omega.device).cuda_stream
    ptrs = (omega.data_ptr(), bias.data_ptr(), x.data_ptr(), z.data_ptr(),
            d_feat, dim, n)
    if omega.dtype == torch.bfloat16:
        if scale != 1.0:
            raise ValueError("the bf16 kernel runs at unit scale; apply "
                             "the scale in f32 after it")
        code = lib.rff_features_bf16(*ptrs, stream)
    else:
        fn = lib.rff_features_f64 if omega.dtype == torch.float64 \
            else lib.rff_features_f32
        code = fn(*ptrs, float(scale), stream)
    _build.check(code, "rff_features launch")
