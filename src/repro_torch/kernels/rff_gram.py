"""Fused random-feature Gram blocks of Eq. 17 — CUDA kernel, its launch
plan and its plain version.

Replaces `src/repro/kernels/rff_gram.py::rff_gram_pallas` (vmapped over
nodes by `repro.kernels.ops.rff_gram_batched`). For each problem b of a
batch:

    Z = scale · cos(Ω_b X_b + b_b) · colmask_b      (never stored)
    G_b = Z Zᵀ [F, F],  zy_b = Z y_bᵀ [F]

The kernel (`csrc/rff_gram.cu`) is bound by operations: 2·F·d·N for the
projection plus F(F+1)·N for the Gram's upper triangle (G is symmetric),
which in f64 only the FP64 tensor cores run at the card's 67 TFLOP/s. It
splits N into S slices, one thread-block cluster of C blocks per
(problem, slice): the blocks split the feature rows (each holding its
rows of Ω in shared memory where they fit), form their rows of each
32-column tile of Z once, share them through distributed shared memory,
accumulate the upper triangle of Z Zᵀ on the tensor cores, and write
partial sums to a workspace that the last block of each problem reduces
in slice order, so G is exactly symmetric and the same from run to run.
`gram_plan` chooses C, S and the workspace; the wrapper that checks and
dispatches is `repro_torch.kernels.ops.rff_gram_batched`.

Past what a cluster's shared memory holds (F > 560 in f64, 1,024 in
f32), `gram_plan` picks the kernel's wide route (a `WideGramPlan`),
which stores Z: per pass of problems and chunk of N columns, one launch
forms each Z entry once into a workspace (the projection on the FP64
tensor cores), and a second takes one block per 64×64 tile of G's upper
triangle, accumulates Z_I Z_Jᵀ on the tensor cores and writes each
entry to G[i][j] and G[j][i] from one value, adding a later chunk's sums
to the earlier chunks' in chunk order. Every F gets a plan.
"""
from __future__ import annotations

import dataclasses
import math

import torch

from repro_torch.kernels import _build

# The kernel's tiling (csrc/rff_gram.cu): 8 warps a block, 32-column
# tiles, 32-deep projection chunks in a ring of 2, shared row strides of
# 36 elements, two 16×16 projection units per warp (at most 128 feature
# rows per block), six 16×16 Gram blocks per warp.
GRAM_WARPS = 8
GRAM_COLS = 32
GRAM_DEPTH = 32
GRAM_STAGES = 2
GRAM_MAX_RANK_ROWS = 128
GRAM_BLOCKS_PER_CTA = 6 * GRAM_WARPS
GRAM_CLUSTERS = (2, 4, 8)
# Shared memory a block may use (232,448 B on sm_90), less the kernel's
# static shared words and some slack.
GRAM_SMEM_LIMIT = 232_448 - 1_024
# Largest workspace a launch may take, in bytes.
GRAM_WORKSPACE_CAP = 64 << 20
# The wide route's Z and G tile (rows and columns), and the Gram blocks a
# pass aims for (four per SM) before its N chunks grow.
GRAM_WIDE_TILE = 64
GRAM_WIDE_BLOCKS_PER_SM = 4


@dataclasses.dataclass(frozen=True)
class GramPlan:
    """One `rff_gram` launch on the cluster route: grid (cluster·slices,
    groups, problems)."""
    cluster: int          # blocks per cluster, sharing the feature rows
    resident: bool        # Ω rows held in shared memory for the launch
    slices: int           # column slices per problem
    slice_cols: int       # columns per slice (a multiple of GRAM_COLS)
    groups: int           # upper-triangle groups (>1 recomputes Z)
    group_blocks: int     # 16×16 Gram blocks per group
    smem_bytes: int       # dynamic shared memory per block
    workspace: int        # workspace elements
    ctas: int             # blocks in the grid


@dataclasses.dataclass(frozen=True)
class WideGramPlan:
    """The wide route: for each pass of `batch` problems and each chunk of
    `cols` columns of N, one launch forms the chunk's Z [batch, f_pad,
    cols] in the workspace (a block per 64×64 tile of Z), then one takes a
    block per 64×64 tile of G's upper triangle and problem."""
    f_pad: int            # Z rows, F rounded up to GRAM_WIDE_TILE
    tiles: int            # 64×64 tiles of G's upper triangle, per problem
    batch: int            # problems per pass
    cols: int             # columns per N chunk (a multiple of the tile)
    chunks: int           # N chunks per pass
    workspace: int        # workspace elements, batch·f_pad·cols
    ctas: int             # Gram blocks per launch, tiles·batch


def _wide_plan(b: int, f: int, n: int, item: int, sms: int) -> WideGramPlan:
    """Problems per pass: enough for GRAM_WIDE_BLOCKS_PER_SM Gram blocks
    an SM (or all B), within the workspace cap at one 64-column block
    each; then the widest N chunk the cap allows, the chunks evened out.
    The cap holds wherever one problem's 64-column panel fits in it
    (F ≤ 131,072 in f64)."""
    t = GRAM_WIDE_TILE
    f_pad = -(-f // t) * t
    nt = f_pad // t
    tiles = nt * (nt + 1) // 2
    panel = f_pad * t * item
    batch = min(b, -(-GRAM_WIDE_BLOCKS_PER_SM * sms // tiles),
                max(1, GRAM_WORKSPACE_CAP // panel))
    widest = max(t, GRAM_WORKSPACE_CAP // (batch * f_pad * item) // t * t)
    chunks = -(-n // widest)
    cols = -(-(-(-n // chunks)) // t) * t
    return WideGramPlan(f_pad=f_pad, tiles=tiles, batch=batch, cols=cols,
                        chunks=chunks, workspace=batch * f_pad * cols,
                        ctas=tiles * batch)


def _smem_bytes(f: int, dim: int, cluster: int, resident: bool,
                item: int) -> int:
    """Shared memory of one block, in the layout of csrc/rff_gram.cu (its
    launcher refuses a size that does not cover it)."""
    fp = -(-f // 16) * 16
    rank_rows = -(-(fp // 16) // cluster) * 16
    omega = rank_rows * (-(-dim // GRAM_DEPTH) * GRAM_DEPTH + 4) if resident \
        else GRAM_STAGES * rank_rows * (GRAM_DEPTH + 4)
    return (fp * (GRAM_COLS + 4) + omega
            + GRAM_STAGES * GRAM_DEPTH * (GRAM_COLS + 4)
            + GRAM_STAGES * 2 * GRAM_COLS + rank_rows) * item


def gram_plan(b: int, f: int, dim: int, n: int, *, item: int = 8,
              sms: int = 132) -> GramPlan | WideGramPlan:
    """Launch plan of `rff_gram` for B problems of F features, d inputs
    and N columns in elements of ``item`` bytes on a card of ``sms`` SMs.

    C is the smallest cluster whose blocks hold the Z tile, their share of
    the feature rows and of Ω (resident, read from device memory once);
    failing that, the smallest that holds them with Ω streamed in chunks.
    S minimises the waves times the tiles a slice walks (one block per SM,
    sms // C clusters at a time; ties to fewer slices), within the
    workspace cap. Where F is too large for any cluster, the wide
    route (`_wide_plan`)."""
    nb = -(-f // 16)
    fits = [(cluster, resident) for resident in (True, False)
            for cluster in GRAM_CLUSTERS
            if -(-nb // cluster) * 16 <= GRAM_MAX_RANK_ROWS
            and _smem_bytes(f, dim, cluster, resident, item)
            <= GRAM_SMEM_LIMIT]
    if not fits:
        return _wide_plan(b, f, n, item, sms)
    cluster, resident = fits[0]
    total = nb * (nb + 1) // 2
    group_blocks = min(total, GRAM_BLOCKS_PER_CTA * cluster)
    groups = -(-total // group_blocks) if total else 1
    fp = nb * 16
    tiles = max(1, -(-n // GRAM_COLS))
    slots = max(1, sms // cluster)

    def workspace(slices: int) -> int:
        return b * slices * (groups * group_blocks * 256 + fp)

    best = None
    for slices in range(1, tiles + 1):
        per_slice = -(-tiles // slices)
        if -(-tiles // per_slice) != slices:
            continue          # the same slices as a smaller count
        if slices > 1 and workspace(slices) * item > GRAM_WORKSPACE_CAP:
            break
        cost = -(-(b * groups * slices) // slots) * per_slice
        if best is None or cost < best[0]:
            best = (cost, slices, per_slice)
    _, slices, per_slice = best
    return GramPlan(cluster=cluster, resident=resident,
                    slices=slices,
                    slice_cols=per_slice * GRAM_COLS, groups=groups,
                    group_blocks=group_blocks,
                    smem_bytes=_smem_bytes(f, dim, cluster, resident, item),
                    workspace=workspace(slices),
                    ctas=cluster * slices * groups * b)


def rff_gram_batched_reference(omega: torch.Tensor, bias: torch.Tensor,
                               x: torch.Tensor, y: torch.Tensor,
                               col_mask: torch.Tensor, *, scale: float = 1.0
                               ) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain version: omega [B, F, d], bias [B, F], x [B, d, N], y [B, N],
    col_mask [B, N] → (gram [B, F, F], zy [B, F])."""
    z = torch.cos(omega @ x + bias[..., None]) * scale \
        * col_mask[:, None, :]
    return z @ z.transpose(1, 2), (z @ y[..., None])[..., 0]


def _sm_count(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def rff_gram_cuda(omega: torch.Tensor, bias: torch.Tensor, x: torch.Tensor,
                  y: torch.Tensor, col_mask: torch.Tensor, gram: torch.Tensor,
                  zy: torch.Tensor, *, scale: float) -> None:
    """Launch the kernel on checked, contiguous CUDA tensors of one dtype,
    writing gram [B, F, F] and zy [B, F] on the current stream (the
    workspace, and the cluster route's zeroed counters, are allocated
    here, for this call)."""
    b, f, dim = omega.shape
    n = x.shape[2]
    plan = gram_plan(b, f, dim, n, item=omega.element_size(),
                     sms=_sm_count(omega.device))
    lib = _build.library("rff_gram")
    f64 = omega.dtype == torch.float64
    stream = torch.cuda.current_stream(omega.device).cuda_stream
    work = torch.empty((plan.workspace,), dtype=omega.dtype,
                       device=omega.device)
    if isinstance(plan, WideGramPlan):
        fn = lib.rff_gram_wide_f64 if f64 else lib.rff_gram_wide_f32
        _build.check(fn(omega.data_ptr(), bias.data_ptr(), x.data_ptr(),
                        y.data_ptr(), col_mask.data_ptr(), gram.data_ptr(),
                        zy.data_ptr(), work.data_ptr(), b, f, dim, n,
                        float(scale), plan.batch, plan.cols, stream),
                     "rff_gram launch (wide route)")
        return
    counters = torch.zeros((b * plan.groups * plan.cluster,),
                           dtype=torch.int32, device=omega.device)
    fn = lib.rff_gram_f64 if f64 else lib.rff_gram_f32
    _build.check(fn(omega.data_ptr(), bias.data_ptr(), x.data_ptr(),
                    y.data_ptr(), col_mask.data_ptr(), gram.data_ptr(),
                    zy.data_ptr(), work.data_ptr(), counters.data_ptr(), b,
                    f, dim, n, float(scale), plan.cluster, plan.slices,
                    plan.slice_cols, plan.groups, plan.group_blocks,
                    int(plan.resident), plan.smem_bytes, stream),
                 "rff_gram launch")
