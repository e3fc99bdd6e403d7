"""One Eq. 19 round over all nodes — CUDA kernel and its plain versions.

Replaces `src/repro/kernels/dekrr_step.py::dekrr_step_pallas`
(`_dekrr_step_kernel`, and with ``active`` its activation-masked variant
`_dekrr_step_masked_kernel`). Per node j of the packed problem:

    out_j = G_j (d_j + S_j θ_self(j) + Σ_k m_jk P_jk θ_nbr(j,k))

Raw contract (the wrapper `repro_torch.kernels.ops.dekrr_step` builds it):
g/s [J, D, D], p [J, K, D, D], d [J·Dy, D], θ table [T·Dy, D] with T ≠ J
allowed (table row t owns flat rows [t·Dy, (t+1)·Dy)), nbr_idx/nbr_mask
[J, K] int32, self_idx [J] int32 → [J·Dy, D]. Padded coordinates come out
exactly 0 because G's padded rows are zero. The masked variant adds
active [J] int32: nodes with active[j] == 0 return their own θ-table rows
unchanged; with all ones it is the unmasked round bit for bit (the kernel
runs the same node body).

The kernel (`csrc/dekrr_step.cu`, rows in `csrc/dekrr_common.cuh`) is
bound by the bytes of the (2 + K) D×D blocks it streams once per node.
One block per node would stream them through J of the card's 132 SMs; so
each node is a thread-block cluster of C blocks that split the node's rows
and pass acc = d + Sθ + ΣPθ between the round's two phases through
distributed shared memory. `round_plan` chooses C and the rows per block.
Each row is computed as the chain kernels compute it, so their fused
rounds equal per-round launches bit for bit.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build

# Warps per block of the round kernel (csrc/dekrr_step.cu's kWarps).
ROUND_WARPS = 32
# Blocks per node cluster at most: the portable cluster size.
ROUND_CLUSTER = 8


def round_plan(d_feat: int) -> tuple[int, int]:
    """(blocks per node cluster, rows per block) of the round kernel at D
    features: at most ROUND_CLUSTER blocks, no more than it takes to give
    every warp one row, and none without rows. Block c forms rows
    [c·rows, min(D, (c+1)·rows))."""
    d_feat = max(1, d_feat)
    blocks = max(1, min(ROUND_CLUSTER, -(-d_feat // ROUND_WARPS)))
    rows = -(-d_feat // blocks)
    return -(-d_feat // rows), rows


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


def dekrr_step_masked_reference(g, d, s, p, theta, nbr_idx, self_idx,
                                nbr_mask, active, *, dy: int = 1
                                ) -> torch.Tensor:
    """Plain version of the activation-masked round: inactive nodes return
    their own θ-table rows; active nodes run `dekrr_step_reference`."""
    new = dekrr_step_reference(g, d, s, p, theta, nbr_idx, self_idx,
                               nbr_mask, dy=dy)
    own = _table_rows(theta, self_idx, dy).reshape(new.shape)
    gate = torch.repeat_interleave(active != 0, dy)[:, None]
    return torch.where(gate, new, own)


def dekrr_step_cuda(g, d, s, p, theta, nbr_idx, self_idx, nbr_mask,
                    out, *, dy: int, active=None) -> None:
    """Launch the kernel on checked, contiguous CUDA tensors (int32 index
    tables, ``active`` [J] int32 or None for all ones), writing out
    [J·Dy, D] on the current stream."""
    j_nodes, k_slots, d_feat = p.shape[0], p.shape[1], d.shape[1]
    blocks, rows = round_plan(d_feat)
    lib = _build.library("dekrr_step")
    fn = lib.dekrr_step_f64 if g.dtype == torch.float64 \
        else lib.dekrr_step_f32
    stream = torch.cuda.current_stream(g.device).cuda_stream
    _build.check(fn(g.data_ptr(), d.data_ptr(), s.data_ptr(), p.data_ptr(),
                    theta.data_ptr(), nbr_idx.data_ptr(),
                    self_idx.data_ptr(), nbr_mask.data_ptr(),
                    None if active is None else active.data_ptr(),
                    out.data_ptr(), j_nodes, k_slots, d_feat, dy, blocks,
                    rows, stream),
                 "dekrr_step launch")
