"""R Jacobi rounds of Eq. 19 in one launch — CUDA kernel and its plain
version.

Replaces `src/repro/kernels/dekrr_solve.py::dekrr_solve_pallas`
(`_dekrr_solve_kernel`). Same raw contract as
`repro_torch.kernels.dekrr_step` plus R ≥ 1 rounds: two θ tables (round
parity), both seeded from θ0, so table rows owned by no node stay at θ0;
returns the node rows after the last round and, with ``trace``,
res [R, J] = max|Δθ_j| per round from the same launch. self_idx rows must
be distinct.

The Pallas kernel relies on its (R, J) grid running in order. The CUDA
kernel (`csrc/dekrr_solve.cu`) is one cooperative launch instead: a grid
capped at the co-resident block count loops over nodes, and a grid-wide
barrier separates the rounds. Its per-node body is the round kernel's, so
R rounds in one launch equal R round launches bit for bit.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.dekrr_step import dekrr_step_reference


def dekrr_solve_reference(g, d, s, p, theta, nbr_idx, self_idx, nbr_mask,
                          *, num_rounds: int, dy: int = 1,
                          trace: bool = False):
    """Plain version: the round's plain version scanned R times, each
    round's rows scattered back into the table at self_idx."""
    j_nodes, d_feat = p.shape[0], d.shape[1]
    table = theta.reshape(-1, dy, d_feat).clone()
    rows = self_idx.long()
    res = []
    for _ in range(num_rounds):
        new = dekrr_step_reference(g, d, s, p, table.reshape(-1, d_feat),
                                   nbr_idx, self_idx, nbr_mask, dy=dy)
        new = new.reshape(j_nodes, dy, d_feat)
        if trace:
            res.append(torch.amax(torch.abs(new - table[rows]), dim=(1, 2)))
        table[rows] = new
    out = table[rows].reshape(j_nodes * dy, d_feat)
    if not trace:
        return out
    if res:
        return out, torch.stack(res)
    return out, torch.zeros((0, j_nodes), dtype=theta.dtype,
                            device=theta.device)


def dekrr_solve_max_blocks(k_slots: int, d_feat: int, dy: int,
                           dtype: torch.dtype) -> int:
    """Co-resident blocks the cooperative launch may use on the current
    device (0: the device cannot launch it)."""
    lib = _build.library("dekrr_solve")
    fn = lib.dekrr_solve_max_blocks_f64 if dtype == torch.float64 \
        else lib.dekrr_solve_max_blocks_f32
    cap = fn(k_slots, d_feat, dy)
    if cap < 0:
        _build.check(-cap, "dekrr_solve occupancy query")
    return cap


def dekrr_solve_cuda(g, d, s, p, theta, nbr_idx, self_idx, nbr_mask, out,
                     res, work, *, num_rounds: int, dy: int) -> None:
    """Launch the kernel on checked, contiguous CUDA tensors: out
    [J·Dy, D], res [R, J] or None, work 2·[T·Dy, D] scratch."""
    j_nodes, k_slots, d_feat = p.shape[0], p.shape[1], d.shape[1]
    t_rows = theta.shape[0] // dy
    if dekrr_solve_max_blocks(k_slots, d_feat, dy, g.dtype) == 0:
        raise RuntimeError(
            f"dekrr_solve: no block of the cooperative kernel fits on this "
            f"device at K={k_slots}, D={d_feat}, Dy={dy} (shared memory "
            f"or cooperative-launch support)")
    lib = _build.library("dekrr_solve")
    fn = lib.dekrr_solve_f64 if g.dtype == torch.float64 \
        else lib.dekrr_solve_f32
    stream = torch.cuda.current_stream(g.device).cuda_stream
    _build.check(fn(g.data_ptr(), d.data_ptr(), s.data_ptr(), p.data_ptr(),
                    theta.data_ptr(), nbr_idx.data_ptr(),
                    self_idx.data_ptr(), nbr_mask.data_ptr(), out.data_ptr(),
                    None if res is None else res.data_ptr(),
                    work.data_ptr(), num_rounds, j_nodes, k_slots, d_feat,
                    dy, t_rows, stream),
                 "dekrr_solve launch")
