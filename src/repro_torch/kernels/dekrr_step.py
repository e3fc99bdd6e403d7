"""One Eq. 19 round over all nodes — CUDA kernel and its plain version.

Replaces `src/repro/kernels/dekrr_step.py::dekrr_step_pallas`
(`_dekrr_step_kernel`). Per node j of the packed problem:

    out_j = G_j (d_j + S_j θ_self(j) + Σ_k m_jk P_jk θ_nbr(j,k))

Raw contract (the wrapper `repro_torch.kernels.ops.dekrr_step` builds it):
g/s [J, D, D], p [J, K, D, D], d [J·Dy, D], θ table [T·Dy, D] with T ≠ J
allowed (table row t owns flat rows [t·Dy, (t+1)·Dy)), nbr_idx/nbr_mask
[J, K] int32, self_idx [J] int32 → [J·Dy, D]. Padded coordinates come out
exactly 0 because G's padded rows are zero.

The kernel (`csrc/dekrr_step.cu`, body in `csrc/dekrr_common.cuh`) is
bound by the bytes of the (2 + K) D×D blocks it streams once per node;
one block of 256 threads per node, one warp per matrix row.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build


def _table_rows(table: torch.Tensor, idx: torch.Tensor,
                dy: int) -> torch.Tensor:
    """[T·Dy, D] table + idx [...] → [..., Dy, D] row blocks."""
    return table.reshape(-1, dy, table.shape[1])[idx.long()]


def dekrr_step_reference(g, d, s, p, theta, nbr_idx, self_idx, nbr_mask,
                         *, dy: int = 1) -> torch.Tensor:
    """Plain version with the raw kernel's contract (see module doc).
    Masked slots may hold any index; they contribute exactly nothing."""
    j_nodes, d_feat = p.shape[0], d.shape[1]
    live = nbr_mask != 0
    safe_idx = torch.where(live, nbr_idx, self_idx[:, None])
    nbr = _table_rows(theta, safe_idx, dy) \
        * live[..., None, None].to(theta.dtype)             # [J, K, Dy, D]
    own = _table_rows(theta, self_idx, dy)                   # [J, Dy, D]
    acc = (d.reshape(j_nodes, dy, d_feat)
           + own @ s.transpose(1, 2)
           + (nbr @ p.transpose(2, 3)).sum(dim=1))
    return (acc @ g.transpose(1, 2)).reshape(j_nodes * dy, d_feat)


def dekrr_step_cuda(g, d, s, p, theta, nbr_idx, self_idx, nbr_mask,
                    out, *, dy: int) -> None:
    """Launch the kernel on checked, contiguous CUDA tensors (int32 index
    tables), writing out [J·Dy, D] on the current stream."""
    j_nodes, k_slots, d_feat = p.shape[0], p.shape[1], d.shape[1]
    lib = _build.library("dekrr_step")
    fn = lib.dekrr_step_f64 if g.dtype == torch.float64 \
        else lib.dekrr_step_f32
    stream = torch.cuda.current_stream(g.device).cuda_stream
    _build.check(fn(g.data_ptr(), d.data_ptr(), s.data_ptr(), p.data_ptr(),
                    theta.data_ptr(), nbr_idx.data_ptr(),
                    self_idx.data_ptr(), nbr_mask.data_ptr(), out.data_ptr(),
                    j_nodes, k_slots, d_feat, dy, stream),
                 "dekrr_step launch")
