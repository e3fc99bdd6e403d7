"""Random-feature map of the serving tier — CUDA kernels, their launch
plans and their plain versions.

Replaces `src/repro/kernels/rff_features.py::rff_features_pallas`, which
the reference's serving tier reaches once per node and wave through
`repro.kernels.ops`'s `rff_features` (snapshot dtype) and
`rff_features_lowp` (bf16). Here one launch covers every node of a wave:

    Z[j] = scale_j · cos(Ω_j X + b_j)     Ω [J, D_max, d], b [J, D_max],
                                          X [d, N] → Z [J, D_max, N]

with rows r ≥ D_j of node j written as exact zeros. In f64 and f32 the
kernel (`csrc/rff_features.cu`, `rff_features_kernel`) runs the product
on the FP64 tensor cores (DMMA) or by FMA in k order on the FP32 units,
staging d in 32-deep `cp.async` chunks through a ring of two; every entry
sums d in the same k16 steps whatever the tile, so a batched launch and a
per-node one give the same bits. bf16 has a kernel of its own
(`rff_features_bf16_kernel`): the wave as one product over the stacked
[J·D_max, d] rows, the operands widened to f32 once in shared memory,
register microtiles summed by FMA in k order (f32 sums equal to the plain
version's), then the three bf16 roundings of the serving tier's precision
bound: product, bias sum, cosine. `features_plan` picks the tile from the
shape (a `Bf16FeaturesPlan` for 2-byte elements) and `bf16_depth` the
chunk of d; the wrappers that check and dispatch are
`repro_torch.kernels.ops`'s `rff_features`, `rff_features_lowp` (one
node) and their `_batched` forms.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import rff_features_ref

rff_features_reference = rff_features_ref

# The f64/f32 kernel's tiling (csrc/rff_features.cu): FEAT_TILES lists
# its blocks as (warps along the rows, warps along the columns, m16n8
# tiles a warp), largest first; a warp owns 16 rows × 8·tiles columns. d
# is staged in chunks of 32 through a ring of FEAT_STAGES. The plan takes
# the largest block that still puts FEAT_WARPS_PER_SM warps on every SM.
FEAT_WARP_ROWS = 16
FEAT_DEPTH = 32
FEAT_STAGES = 2
FEAT_TILES = ((2, 2, 4), (2, 2, 2), (4, 2, 1))
FEAT_WARPS_PER_SM = 4

# The bf16 kernel's tiling: BF16_TILES lists its blocks as (rows, columns,
# a thread's rows, a thread's columns) of the stacked [J·D_max, N], largest
# first (128 threads each). d is staged as f32 in chunks of at most
# BF16_DEPTH through two slots; an Ω row takes BF16_ROW_STRIDE floats. The
# plan takes the largest block whose grid reaches three SMs in four or more
# (one node, D 200 × N 512: 32 × 32 blocks, 112 of them; on the card
# 16 × 32 blocks of 1 × 4 microtiles at twice the count were slower).
BF16_TILES = ((64, 64, 4, 8), (32, 64, 2, 8), (32, 32, 2, 4), (16, 32, 1, 4))
BF16_DEPTH = 80
BF16_ROW_STRIDE = BF16_DEPTH + 4


@dataclasses.dataclass(frozen=True)
class FeaturesPlan:
    """One f64/f32 `rff_features` launch: grid (⌈N / cols⌉, ⌈D_max / rows⌉,
    J)."""
    warp_rows: int        # warps of a block along the feature rows
    warp_cols: int        # warps of a block along the columns
    warp_tiles: int       # m16n8 tiles of a warp (8 columns each)
    rows: int             # feature rows of a block
    cols: int             # columns of a block
    blocks: int           # blocks in the grid
    smem_bytes: int       # dynamic shared memory of a block


@dataclasses.dataclass(frozen=True)
class Bf16FeaturesPlan:
    """One bf16 `rff_features` launch over the stacked rows: grid
    (⌈N / cols⌉, ⌈J·D_max / rows⌉)."""
    rows: int             # stacked feature rows of a block
    cols: int             # columns of a block
    thread_rows: int      # rows of a thread (a stride of rows / thread_rows)
    thread_cols: int      # adjacent columns of a thread
    threads: int          # threads of a block
    blocks: int           # blocks in the grid
    smem_bytes: int       # dynamic shared memory of a block


def _smem_bytes(tile: tuple[int, int, int], item: int) -> int:
    """Shared memory of an f64/f32 block in the layout of
    csrc/rff_features.cu (its launcher refuses a size that does not cover
    it)."""
    wr, wc, nt = tile
    return FEAT_STAGES * (FEAT_WARP_ROWS * wr * (FEAT_DEPTH + 4)
                          + FEAT_DEPTH * (8 * nt * wc + 4)) * item


def _bf16_smem_bytes(rows: int, cols: int) -> int:
    """Shared memory of a bf16 block (csrc/rff_features.cu,
    `bf16_smem_bytes`), in 4-byte words: two f32 X slots
    [BF16_DEPTH][cols], two Ω slots [rows][BF16_ROW_STRIDE], and each
    row's bias and state."""
    return 4 * (2 * BF16_DEPTH * cols + 2 * rows * BF16_ROW_STRIDE
                + 2 * rows)


def bf16_depth(dim: int) -> int:
    """d per staged chunk of the bf16 kernel: a multiple of 8, at most
    BF16_DEPTH, and at least two chunks where d > 8, so that the second
    loads while the first is multiplied (d 148: chunks of 80)."""
    chunks = max(2, -(-dim // BF16_DEPTH)) if dim > 8 else 1
    per_chunk = -(-dim // chunks)
    return -(-per_chunk // 8) * 8


def _bf16_plan(j: int, d_feat: int, n: int, sms: int) -> Bf16FeaturesPlan:
    rows = j * d_feat

    def blocks(tile):
        return -(-rows // tile[0]) * -(-n // tile[1])

    tile = next((t for t in BF16_TILES if 4 * blocks(t) >= 3 * sms),
                max(BF16_TILES, key=blocks))
    bm, bn, tm, tn = tile
    return Bf16FeaturesPlan(
        rows=bm, cols=bn, thread_rows=tm, thread_cols=tn,
        threads=(bm // tm) * (bn // tn), blocks=blocks(tile),
        smem_bytes=_bf16_smem_bytes(bm, bn))


def features_plan(j: int, d_feat: int, n: int, *, item: int = 8,
                  sms: int = 132) -> FeaturesPlan | Bf16FeaturesPlan:
    """Launch plan of `rff_features` for J nodes of at most ``d_feat``
    features and N columns in elements of ``item`` bytes on a card of
    ``sms`` SMs. f64/f32: the largest block of FEAT_TILES whose grid still
    puts FEAT_WARPS_PER_SM warps on every SM, else the one with the most
    warps. bf16 (``item`` 2): a `Bf16FeaturesPlan`, the largest block of
    BF16_TILES whose grid over the J·D_max stacked rows has a block for
    three SMs in four, else the one with the most blocks. No tile changes an
    entry's sum, which both kernels take over d in k order."""
    if item == 2:
        return _bf16_plan(j, d_feat, n, sms)

    def blocks(tile):
        wr, wc, nt = tile
        return (j * -(-d_feat // (FEAT_WARP_ROWS * wr))
                * -(-n // (8 * nt * wc)))

    def warps(tile):
        return blocks(tile) * tile[0] * tile[1]

    tile = next((t for t in FEAT_TILES
                 if warps(t) >= FEAT_WARPS_PER_SM * sms),
                max(FEAT_TILES, key=warps))
    wr, wc, nt = tile
    return FeaturesPlan(
        warp_rows=wr, warp_cols=wc, warp_tiles=nt, rows=FEAT_WARP_ROWS * wr,
        cols=8 * nt * wc, blocks=blocks(tile),
        smem_bytes=_smem_bytes(tile, item))


def _pad_rows(z: torch.Tensor, d_max: int) -> torch.Tensor:
    return torch.cat([z, z.new_zeros((d_max - z.shape[0], z.shape[1]))])


def rff_features_batched_reference(omega: torch.Tensor, bias: torch.Tensor,
                                   x: torch.Tensor, *, scale, d_feat
                                   ) -> torch.Tensor:
    """Plain version of the kernel in f64/f32: omega [J, D_max, d], bias
    [J, D_max], x [d, N], per-node ``scale`` and ``d_feat`` (sequences of
    J) → Z [J, D_max, N], node j's rows below D_j equal to the per-node
    plain version on its first D_j rows, the rest exact zeros."""
    d_max = omega.shape[1]
    return torch.stack([
        _pad_rows(rff_features_reference(om[:dj], b[:dj], x, scale=s), d_max)
        for om, b, s, dj in zip(omega, bias, scale, d_feat, strict=True)])


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


def rff_features_bf16_batched_reference(omega: torch.Tensor,
                                        bias: torch.Tensor, x: torch.Tensor,
                                        *, d_feat) -> torch.Tensor:
    """Plain version of the batched bf16 kernel: bf16 omega [J, D_max, d],
    bias [J, D_max], x [d, N] → Z [J, D_max, N] in bf16 at unit scale,
    node j's first D_j rows the per-node bf16 plain version, the rest
    exact zeros."""
    d_max = omega.shape[1]
    return torch.stack([
        _pad_rows(rff_features_bf16_reference(om[:dj], b[:dj], x), d_max)
        for om, b, dj in zip(omega, bias, d_feat, strict=True)])


def rff_features_lowp_reference(omega: torch.Tensor, bias: torch.Tensor,
                                x: torch.Tensor, *,
                                scale: float) -> torch.Tensor:
    """Plain version of `ops.rff_features_lowp`: Ω, b and X cast to bf16,
    the bf16 map, then the cast to f32 and the f32 scale."""
    bf16 = torch.bfloat16
    z = rff_features_bf16_reference(omega.to(bf16), bias.to(bf16),
                                    x.to(bf16))
    return z.float() * scale


def _sm_count(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def rff_features_cuda(omega: torch.Tensor, bias: torch.Tensor,
                      x: torch.Tensor, scale: torch.Tensor | None,
                      d_feat: torch.Tensor, z: torch.Tensor) -> None:
    """Launch the kernel on checked, contiguous CUDA tensors of one dtype
    (f64, f32, or bf16 with ``scale`` None: unit scale): omega [J, D_max,
    d], bias [J, D_max], x [d, N], scale [J], d_feat [J] int32 (each
    ≤ D_max), writing z [J, D_max, N] on the current stream."""
    j, d_max, dim = omega.shape
    n = x.shape[1]
    if (scale is None) != (omega.dtype == torch.bfloat16):
        raise ValueError("the bf16 kernel runs at unit scale (scale None); "
                         "f64 and f32 take a per-node scale")
    plan = features_plan(j, d_max, n, item=omega.element_size(),
                         sms=_sm_count(omega.device))
    lib = _build.library("rff_features")
    stream = torch.cuda.current_stream(omega.device).cuda_stream
    if omega.dtype == torch.bfloat16:
        code = lib.rff_features_bf16(
            omega.data_ptr(), bias.data_ptr(), x.data_ptr(),
            d_feat.data_ptr(), z.data_ptr(), j, d_max, dim, n, plan.rows,
            plan.cols, plan.thread_rows, plan.thread_cols, bf16_depth(dim),
            plan.smem_bytes, stream)
    else:
        fn = {torch.float64: lib.rff_features_f64,
              torch.float32: lib.rff_features_f32}[omega.dtype]
        code = fn(omega.data_ptr(), bias.data_ptr(), x.data_ptr(),
                  scale.data_ptr(), d_feat.data_ptr(), z.data_ptr(), j,
                  d_max, dim, n, plan.warp_rows, plan.warp_cols,
                  plan.warp_tiles, plan.smem_bytes, stream)
    _build.check(code, "rff_features launch")
