"""Shared-memory and launch-shape budget of the port's Hopper kernels.

The port's counterpart of the reference's `repro.analysis.vmem`. A CUDA
kernel whose dynamic shared memory passes what a block may take fails at
its launch with an opaque CUDA error: after the operands were staged, and
for the solve after the whole problem was packed. This module makes each
kernel's shared-memory layout (its ``csrc`` launcher's formula) and its
launch shape executable, so that the wrappers of
`repro_torch.kernels.ops` refuse an over-budget shape with a
`SmemBudgetError` naming the kernel, the formula, the bytes and the limit
BEFORE anything is staged or launched, on the CPU as on the card.

Budget table (bytes a block; one H100, sm_90):

  kernel             dynamic shared memory a block          cluster  grid
  -----------------  -------------------------------------  -------  ---------------
  dekrr_step         (K+2)·Dy·D·itemsize                    C ≤ 8    (C, J)
  dekrr_solve        (K+2)·Dy·D·itemsize                    C ≤ 8    (C, ≤ J)
  dekrr_solve,       ((1+L)·rows·D + (1+L)·Dy·D + Dy·D      C ≤ 8    (C, J)
    resident           + Dy·rows)·itemsize; registers:
                       rows·D·itemsize (G)
  dekrr_async_solve  (K+2)·Dy·D·itemsize                    C ≤ 8    (C, ≤ J)
  dekrr_async_solve, as dekrr_solve, resident              C ≤ 8    (C, J)
    resident
  dekrr_cheb_solve   (K+2)·Dy·D·itemsize                    C ≤ 8    (C, ≤ J)
  dekrr_cheb_solve,  as dekrr_solve, resident, + Dy·rows    C ≤ 8    (C, J)
    resident           (the block's p rows)
  rff_gram, cluster  (F'·36 + Ω + 2·32·36 + 2·2·32 + H)·it  C ≤ 8    (C·S, groups, B)
  rff_gram, f32      (Z·C·32·(H₃₂+4) + Ωᵀ + 3·32·36          C ≤ 8    (C·S, groups, B),
                         + 3·2·32 + H₃₂)·4                           (reduce, B)
  rff_gram, wide     max(Z: (2·64·36 + 2·32·68)·it,         1        (⌈n/64⌉, F'/64, b),
                         G: 3·(2·64·36 + 32)·it)                     (tiles, b)
  rff_features       2·(16·WR·(32+4) + 32·(8·NT·WC+4))·it   1        (⌈N/cols⌉, ⌈D/rows⌉, J)
  rff_features, bf16 (2·80·cols + 2·rows·84 + 2·rows)·4     1        (⌈N/cols⌉, ⌈J·D/rows⌉)
  serve_wave         rff_features' at the wave's shape      1        the same
  flash_decode       (stages·2·tile·dh + hb·dh)·itemsize    1        (rows·⌈G/hb⌉, chunks)
  flash_decode, bf16 stages·2·tile·dh·2 + stages·hb·dh·2   1        (rows·⌈G/hb⌉·chunks
                       + hb·dh·4 + max(34816,                       units, resident)
                       16·hb·(2+dh)) + stages·16 + 16 + 128

Terms: K the slot count (≥ 1: the wrapper pads an edgeless graph to one
slot), D the padded feature count, Dy the output width; the round kernel
stages (1 + K) θ blocks and the acc block, each [Dy, D]. The chains'
resident route (`kernels/dekrr_solve.py::resident_plan`) holds a block's
rows of S and of the node's L live P blocks in shared memory for the whole
launch, with the staged θ of the node and its live slots, acc and the
block's d rows (and on the Chebyshev chain its p rows), and the same rows
of G in registers; one cluster per node, all resident at once. For `rff_gram`
(`kernels/rff_gram.py::gram_plan`): F' = F rounded up to 16, H the rank
rows a block holds, Ω = H·(⌈d/32⌉·32 + 4) with Ω resident, else
2·H·(32 + 4). Its f32 route (`F32GramPlan`): H₃₂ the rank rows in
whole 32-row blocks, Z the Z tiles of its ring (1 or 2), Ωᵀ =
⌈d/32⌉·32·(H₃₂ + 4) resident, else 3·32·(H₃₂ + 4), and a second grid
that reduces the slices. For `rff_features` (`features_plan`): the tile (WR, WC,
NT) from the shape; in bf16 the block of rows × cols of the J·D stacked
rows (`Bf16FeaturesPlan`), its two f32 slots of up to 80 k each and a
bias and a state a row. For `flash_decode`
(`decode_plan`): tile = 32·ppg positions, 3 or 4 stages, hb query heads
a block; in bf16 tile = 32·ppg, 2 stages, each with a slot for a unit's
query rows and a full and an empty mbarrier (8 bytes each), the query
rows in f32, the merge area and a 16-byte flag; its persistent blocks
walk (chunk, row · head block) units. The limit is `SMEM_OPTIN_PER_BLOCK` (232,448 B, the opt-in
maximum of a block on sm_90) less the static shared memory each kernel
declares beside its dynamic buffer (`STATIC_SMEM`); registers a block
holds operands in stay within half an SM's register file
(`REGISTER_OPERAND_LIMIT`), the rest for the arithmetic. Grids hold at most
2³¹ − 1 blocks along x and 65,535 along y and z; a cluster at most the
portable 8 blocks.

What the CPU cannot know, the card decides at launch, and the estimate
says nothing of it: how many clusters of a chain kernel are resident at
once (`kernels/dekrr_solve.py::chain_max_clusters`, an occupancy query,
which sets the chains' second grid dimension and can shrink C), and the
registers a kernel takes (`nvcc -Xptxas -v`). The chains' grids are
bounded here by J, the most they ever take.

`check_index_table` is the port's copy of the reference's bounds check of
an index table: a kernel gathering through it has no bounds check of its
own.

This module imports only numpy and the standard library at import time;
the estimates read the kernels' launch plans from `repro_torch.kernels`
when called.
"""
from __future__ import annotations

import dataclasses

import numpy as np

__all__ = [
    "H100_SMS",
    "MAX_CLUSTER",
    "REGISTER_OPERAND_LIMIT",
    "SMEM_LIMITS",
    "SMEM_OPTIN_PER_BLOCK",
    "SMEM_PER_SM",
    "SMEM_RESERVED_PER_BLOCK",
    "STATIC_SMEM",
    "SmemBudgetError",
    "SmemEstimate",
    "check_index_table",
    "device_sms",
    "estimate_dekrr_async_solve",
    "estimate_dekrr_cheb_solve",
    "estimate_dekrr_solve",
    "estimate_dekrr_step",
    "estimate_flash_decode",
    "estimate_rff_features",
    "estimate_rff_gram",
    "estimate_serve_wave",
    "launcher_bytes",
    "path_estimates",
]

# One H100 (sm_90): shared memory a block may opt into, an SM's, and the
# 1 KB of an SM's that the system reserves for each resident block.
SMEM_OPTIN_PER_BLOCK = 232_448
SMEM_PER_SM = 233_472
SMEM_RESERVED_PER_BLOCK = 1_024
MAX_CLUSTER = 8                 # the portable cluster size
H100_SMS = 132                  # SMs of the card the CPU budgets for
# Operand bytes a block may hold in registers: half the SM's 256 KiB
# register file (the resident chains' G rows)
REGISTER_OPERAND_LIMIT = 128 * 1024
MAX_GRID_X = 2**31 - 1
MAX_GRID_YZ = 65_535

# Static shared memory each kernel declares beside its dynamic buffer, in
# bytes (at most): the chains' cluster-max scratch (`dekrr::ClusterMax`,
# 384 B in f64 for one value, 768 B for the async chain's two; on the
# resident route also the live-slot list and the staged rows' sources,
# 976 B at most), and
# `rff_gram`'s last-block flag with slack. `flash_decode`'s launcher
# refuses a dynamic size past 232,448 B itself (`kMaxSmem`).
STATIC_SMEM = {
    "dekrr_step": 0,
    "dekrr_solve": 1_024,
    "dekrr_async_solve": 1_024,
    "dekrr_cheb_solve": 1_024,
    "rff_gram": 1_024,
    "rff_features": 0,
    "serve_wave": 0,
    "flash_decode": 0,
}
# The dynamic shared memory a block of each kernel may take: the single
# table the launch plans read (`gram_plan`, `decode_plan`).
SMEM_LIMITS = {name: SMEM_OPTIN_PER_BLOCK - reserved
               for name, reserved in STATIC_SMEM.items()}


def device_sms(device) -> int:
    """SMs a launch plan sizes for: the card's on a CUDA device, an
    H100's (`H100_SMS`) elsewhere, so the CPU budgets as for the card."""
    if getattr(device, "type", device) != "cuda":
        return H100_SMS
    import torch

    return torch.cuda.get_device_properties(device).multi_processor_count


class SmemBudgetError(ValueError):
    """Raised before any staging or launch when a kernel's shared memory
    a block, its cluster or its grid passes what the card allows. The
    message names the kernel, the formula, the bytes and the limit."""


@dataclasses.dataclass(frozen=True)
class SmemEstimate:
    """Static budget of one kernel call: the dynamic shared memory of its
    largest block, its cluster size and its grids (one per launch; a
    zero extent launches nothing and passes)."""

    kernel: str
    formula: str        # symbolic, as in the module's table
    detail: str         # the formula with the shapes substituted
    bytes: int
    limit: int
    cluster: int = 1
    grids: tuple[tuple[int, ...], ...] = ((1, 1, 1),)
    register_bytes: int = 0   # operand bytes a block holds in registers

    def problems(self) -> list[str]:
        """What passes the card's limits, as phrases (empty: it fits)."""
        out = []
        if self.register_bytes > REGISTER_OPERAND_LIMIT:
            out.append(f"{self.register_bytes} bytes of operands a block in "
                       f"registers exceed {REGISTER_OPERAND_LIMIT}")
        if self.bytes > self.limit:
            out.append(f"shared memory {self.formula} = {self.detail} = "
                       f"{self.bytes} bytes a block exceeds the "
                       f"{self.limit}-byte limit ({SMEM_OPTIN_PER_BLOCK} B "
                       f"opt-in on sm_90 less the "
                       f"{SMEM_OPTIN_PER_BLOCK - self.limit} B the kernel "
                       f"reserves)")
        if not 1 <= self.cluster <= MAX_CLUSTER:
            out.append(f"a cluster of {self.cluster} blocks is outside "
                       f"[1, {MAX_CLUSTER}]")
        for grid in self.grids:
            dims = tuple(grid) + (1,) * (3 - len(grid))
            if dims[0] > MAX_GRID_X or max(dims[1:]) > MAX_GRID_YZ:
                out.append(f"grid {dims} is outside (2^31 - 1, 65535, "
                           f"65535)")
        return out

    @property
    def fits(self) -> bool:
        return not self.problems()

    def check(self) -> "SmemEstimate":
        """Return self, or raise `SmemBudgetError` naming what does not
        fit."""
        problems = self.problems()
        if problems:
            raise SmemBudgetError(
                f"{self.kernel}: " + "; ".join(problems) + " — shrink D, K "
                f"or Dy, or use backend='torch' (see "
                f"repro_torch.analysis.smem)")
        return self


def _round_estimate(kernel: str, j_nodes: int, k_slots: int, d_feat: int,
                    dy: int, itemsize: int) -> SmemEstimate:
    from repro_torch.kernels.dekrr_step import round_plan

    blocks, _ = round_plan(d_feat)
    return SmemEstimate(
        kernel=kernel, formula="(K+2)*Dy*D*itemsize",
        detail=f"({k_slots}+2)*{dy}*{d_feat}*{itemsize}",
        bytes=(k_slots + 2) * dy * d_feat * itemsize,
        limit=SMEM_LIMITS[kernel], cluster=blocks,
        grids=((blocks, j_nodes, 1),))


def estimate_dekrr_step(*, j_nodes: int, k_slots: int, d_feat: int,
                        dy: int = 1, itemsize: int = 8) -> SmemEstimate:
    """The round kernel (`csrc/dekrr_step.cu`, `dekrr::node_smem_elems`):
    (1 + K) staged θ blocks and the acc block, each [Dy, D], in each block
    of a node's cluster of `round_plan`'s C blocks; grid (C, J)."""
    return _round_estimate("dekrr_step", j_nodes, k_slots, d_feat, dy,
                           itemsize)


def _resident_estimate(kernel: str, j_nodes: int, d_feat: int, dy: int,
                       itemsize: int, blocks: int, rows: int,
                       live: int) -> SmemEstimate:
    from repro_torch.kernels.dekrr_solve import RESIDENT_ROW_BLOCKS

    held = RESIDENT_ROW_BLOCKS[kernel]
    times = "" if held == 1 else f"{held}*"
    elems = ((1 + live) * rows * d_feat + (1 + live) * dy * d_feat
             + dy * d_feat + held * dy * rows)
    return SmemEstimate(
        kernel=kernel,
        formula=(f"((1+L)*rows*D + (1+L)*Dy*D + Dy*D + {times}Dy*rows)"
                 f"*itemsize"),
        detail=(f"((1+{live})*{rows}*{d_feat} + (1+{live})*{dy}*{d_feat} + "
                f"{dy}*{d_feat} + {times}{dy}*{rows})*{itemsize}"),
        bytes=elems * itemsize, limit=SMEM_LIMITS[kernel], cluster=blocks,
        grids=((blocks, j_nodes, 1),),
        register_bytes=rows * d_feat * itemsize)


def _chain_estimate(kernel: str, j_nodes: int, k_slots: int, d_feat: int,
                    dy: int, itemsize: int, route: str,
                    plan) -> SmemEstimate:
    """A chain on the route of ``plan`` (a `kernels.dekrr_solve.ChainPlan`)
    or, without one, on ``route``: "streamed", or "resident" at the first
    layout that fits with every slot live (`resident_shapes`; the card
    decides at launch whether it holds J such clusters)."""
    if plan is not None:
        route = plan.route
    if route == "streamed":
        return _round_estimate(kernel, j_nodes, k_slots, d_feat, dy,
                               itemsize)
    if plan is not None:
        blocks, rows, live = plan.blocks, plan.rows, plan.live
    else:
        from repro_torch.kernels.dekrr_solve import (RESIDENT_ROW_BLOCKS,
                                                     resident_shapes)

        live = k_slots
        shapes = resident_shapes(d_feat, dy, live, itemsize,
                                 SMEM_LIMITS[kernel],
                                 RESIDENT_ROW_BLOCKS[kernel])
        if not shapes:
            raise SmemBudgetError(
                f"{kernel}: no resident layout fits D {d_feat}, Dy {dy}, "
                f"{live} live slots at itemsize {itemsize}")
        blocks, rows, _ = shapes[0]
    return _resident_estimate(kernel, j_nodes, d_feat, dy, itemsize, blocks,
                              rows, live)


def estimate_dekrr_solve(*, j_nodes: int, k_slots: int, d_feat: int,
                         dy: int = 1, itemsize: int = 8,
                         route: str = "streamed",
                         plan=None) -> SmemEstimate:
    """The synchronous chain (`csrc/dekrr_solve.cu`). Streamed route: the
    round kernel's node body, so its dynamic shared memory; grid (C,
    clusters ≤ J), the clusters the card's occupancy query allows (not
    known here). Resident route: the block's rows of S and the live P, the
    staged θ, acc and d rows in shared memory and its G rows in registers;
    grid (C, J). ``plan`` (`kernels.dekrr_solve.solve_plan`) names the
    route and layout of a launch."""
    return _chain_estimate("dekrr_solve", j_nodes, k_slots, d_feat, dy,
                           itemsize, route, plan)


def estimate_dekrr_async_solve(*, j_nodes: int, k_slots: int, d_feat: int,
                               dy: int = 1, itemsize: int = 8,
                               route: str = "streamed",
                               plan=None) -> SmemEstimate:
    """The asynchronous-gossip chain (`csrc/dekrr_async_solve.cu`): as
    `estimate_dekrr_solve`; its θ, sent and buffer tables live in device
    memory, not in shared memory."""
    return _chain_estimate("dekrr_async_solve", j_nodes, k_slots, d_feat,
                           dy, itemsize, route, plan)


def estimate_dekrr_cheb_solve(*, j_nodes: int, k_slots: int, d_feat: int,
                              dy: int = 1, itemsize: int = 8,
                              route: str = "streamed",
                              plan=None) -> SmemEstimate:
    """The Chebyshev chain (`csrc/dekrr_cheb_solve.cu`): as
    `estimate_dekrr_solve`; on the resident route each block also holds
    its p rows [Dy, rows] for the whole launch. ``plan``
    (`kernels.dekrr_solve.cheb_plan`) names the route and layout."""
    return _chain_estimate("dekrr_cheb_solve", j_nodes, k_slots, d_feat,
                           dy, itemsize, route, plan)


def estimate_rff_gram(*, b: int, f: int, dim: int, n: int,
                      itemsize: int = 8, sms: int = H100_SMS) -> SmemEstimate:
    """`rff_gram` on the route `gram_plan` picks (`csrc/rff_gram.cu`,
    `gram_smem_bytes`; the wide route's `z_smem_bytes` and
    `wide_smem_bytes`, its largest block)."""
    from repro_torch.kernels.rff_gram import (GRAM_WIDE_TILE, F32GramPlan,
                                              WideGramPlan, _f32_rank_rows,
                                              _wide_smem_bytes, gram_plan)

    plan = gram_plan(b, f, dim, n, item=itemsize, sms=sms)
    if isinstance(plan, F32GramPlan):
        h = _f32_rank_rows(f, plan.cluster)
        omega = (f"{-(-dim // 32) * 32}*({h}+4)" if plan.resident
                 else f"3*32*({h}+4)")
        return SmemEstimate(
            kernel="rff_gram",
            formula="(Z*C*32*(H32+4) + OmegaT + 3*32*36 + 3*2*32 + H32)*4",
            detail=(f"({plan.zbufs}*{plan.cluster}*32*({h}+4) + {omega} "
                    f"+ 3*32*36 + 3*2*32 + {h})*4"),
            bytes=plan.smem_bytes, limit=SMEM_LIMITS["rff_gram"],
            cluster=plan.cluster,
            grids=((plan.cluster * plan.slices, plan.groups, b),
                   (plan.reduce_ctas, b, 1)))
    if isinstance(plan, WideGramPlan):
        z_bytes, g_bytes = _wide_smem_bytes(itemsize)
        return SmemEstimate(
            kernel="rff_gram",
            formula="max((2*64*36 + 2*32*68)*itemsize, "
                    "3*(2*64*36 + 32)*itemsize)",
            detail=f"max({z_bytes}, {g_bytes}) at itemsize {itemsize}",
            bytes=max(z_bytes, g_bytes), limit=SMEM_LIMITS["rff_gram"],
            grids=((-(-plan.cols // GRAM_WIDE_TILE),
                    plan.f_pad // GRAM_WIDE_TILE, plan.batch),
                   (plan.tiles, plan.batch, 1)))
    fp = -(-f // 16) * 16
    rank_rows = -(-(fp // 16) // plan.cluster) * 16
    omega = (f"{rank_rows}*({-(-dim // 32) * 32}+4)" if plan.resident
             else f"2*{rank_rows}*(32+4)")
    return SmemEstimate(
        kernel="rff_gram",
        formula="(F'*36 + Omega + 2*32*36 + 2*2*32 + H)*itemsize",
        detail=(f"({fp}*36 + {omega} + 2*32*36 + 2*2*32 + {rank_rows})"
                f"*{itemsize}"),
        bytes=plan.smem_bytes, limit=SMEM_LIMITS["rff_gram"],
        cluster=plan.cluster,
        grids=((plan.cluster * plan.slices, plan.groups, b),))


def _features_estimate(kernel: str, j: int, d_feat: int, n: int,
                       itemsize: int, sms: int) -> SmemEstimate:
    from repro_torch.kernels.rff_features import (BF16_DEPTH,
                                                  BF16_ROW_STRIDE,
                                                  FEAT_DEPTH, FEAT_STAGES,
                                                  FEAT_WARP_ROWS,
                                                  features_plan)

    plan = features_plan(j, d_feat, n, item=itemsize, sms=sms)
    if itemsize == 2:
        return SmemEstimate(
            kernel=kernel,
            formula=(f"(2*{BF16_DEPTH}*cols + 2*rows*{BF16_ROW_STRIDE} "
                     f"+ 2*rows)*4"),
            detail=(f"(2*{BF16_DEPTH}*{plan.cols} + 2*{plan.rows}*"
                    f"{BF16_ROW_STRIDE} + 2*{plan.rows})*4"),
            bytes=plan.smem_bytes, limit=SMEM_LIMITS[kernel],
            grids=((-(-n // plan.cols), -(-(j * d_feat) // plan.rows), 1),))
    return SmemEstimate(
        kernel=kernel,
        formula="2*(16*WR*(32+4) + 32*(8*NT*WC+4))*itemsize",
        detail=(f"{FEAT_STAGES}*({FEAT_WARP_ROWS}*{plan.warp_rows}*"
                f"({FEAT_DEPTH}+4) + {FEAT_DEPTH}*(8*{plan.warp_tiles}*"
                f"{plan.warp_cols}+4))*{itemsize}"),
        bytes=plan.smem_bytes, limit=SMEM_LIMITS[kernel],
        grids=((-(-n // plan.cols), -(-d_feat // plan.rows), j),))


def estimate_rff_features(*, j: int, d_feat: int, n: int,
                          itemsize: int = 8, sms: int = H100_SMS
                          ) -> SmemEstimate:
    """The featurize kernel (`csrc/rff_features.cu`,
    `features_smem_bytes`; `bf16_smem_bytes` for ``itemsize`` 2) at the
    tile `features_plan` picks: two ring stages of an Ω slice and an X
    slice."""
    return _features_estimate("rff_features", j, d_feat, n, itemsize, sms)


def estimate_serve_wave(*, j: int, d_feat: int, n: int, itemsize: int = 8,
                        sms: int = H100_SMS) -> SmemEstimate:
    """A serving wave on ``backend="cuda"`` (`repro_torch.serve.dekrr`):
    ONE featurize launch for the J cos_bias nodes of the snapshot at
    D_max = ``d_feat`` and the wave's padded column bucket ``n``
    (itemsize 2 on the bf16/int8 paths). The θ products run in torch and
    take no shared memory of ours."""
    return _features_estimate("serve_wave", j, d_feat, n, itemsize, sms)


def estimate_flash_decode(*, rows: int, groups: int, dh: int,
                          s: int = 1, itemsize: int = 4) -> SmemEstimate:
    """The decode-attention kernel (`csrc/flash_decode.cu`) at
    `decode_plan`'s tiling for ``rows`` (batch, kv head) rows of
    ``groups`` query heads: in f32 (`smem_bytes`) a ring of K and V
    stages and the block's query rows; in bf16 (itemsize 2,
    `bf16_smem_bytes`) the ring and a unit's query rows a stage in bf16,
    the query rows in f32, the merge area, a full and an empty mbarrier a
    stage and the last-block flag; grid (rows·head blocks, chunks of S)
    (bf16: the units its persistent blocks walk)."""
    from repro_torch.kernels.decode_attention import (decode_smem_bytes,
                                                      decode_tiling)

    ppg, tile, stages, tiles, head_block = decode_tiling(groups, dh,
                                                         itemsize)
    chunks = -(-max(s, 1) // (tiles * tile))
    if itemsize == 2:
        formula = ("stages*2*tile*dh*2 + stages*hb*dh*2 + hb*dh*4 + "
                   "max(34816, 16*hb*(2+dh)) + stages*16 + 16 + 128")
        detail = (f"{stages}*2*{tile}*{dh}*2 + {stages}*{head_block}*{dh}*2"
                  f" + {head_block}*{dh}*4 + max(34816, 16*{head_block}*"
                  f"(2+{dh})) + {stages}*16 + 16 + 128")
    else:
        formula = "(stages*2*tile*dh + hb*dh)*itemsize"
        detail = (f"({stages}*2*{tile}*{dh} + {head_block}*{dh})"
                  f"*{itemsize}")
    return SmemEstimate(
        kernel="flash_decode",
        formula=formula,
        detail=detail,
        bytes=decode_smem_bytes(ppg, stages, head_block, dh, itemsize),
        limit=SMEM_LIMITS["flash_decode"],
        grids=((max(rows, 1) * -(-max(groups, 1) // head_block), chunks,
                1),))


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


# The shapes of the paths `chip_smoke.py` drives on the card (the paper's
# wave setting: J 10, circulant(10, (1, 2)) so K 4, D_j 200, d 148,
# N_j 3,180; the multi-output bench at Dy 8; the serving waves at buckets
# of 512 and 16 columns; `rff_gram` at the `gram_fn` shape and on its wide
# route at F 600; the LLM path's decode attention, qwen1.5-0.5b: 16 kv
# heads of 1 query head at dh 64, B 8 over a 512-position cache and B 1
# over 32,768).
_WAVE = dict(j_nodes=10, k_slots=4, d_feat=200)
PATH_SHAPES = (
    ("dekrr_step", dict(_WAVE)),
    ("dekrr_solve", dict(_WAVE)),
    ("dekrr_async_solve", dict(_WAVE)),
    ("dekrr_solve", dict(_WAVE, route="resident")),
    ("dekrr_async_solve", dict(_WAVE, route="resident")),
    ("dekrr_cheb_solve", dict(_WAVE)),
    ("dekrr_cheb_solve", dict(_WAVE, route="resident")),
    ("dekrr_solve", dict(j_nodes=10, k_slots=4, d_feat=32, dy=8)),
    ("rff_gram", dict(b=10, f=200, dim=148, n=3180)),
    ("rff_gram", dict(b=1, f=200, dim=148, n=3180, itemsize=4)),
    ("rff_gram", dict(b=10, f=600, dim=148, n=3180)),
    ("rff_features", dict(j=1, d_feat=200, n=8)),
    ("serve_wave", dict(j=10, d_feat=200, n=512)),
    ("serve_wave", dict(j=10, d_feat=200, n=512, itemsize=2)),
    ("serve_wave", dict(j=10, d_feat=200, n=16)),
    ("serve_wave", dict(j=10, d_feat=200, n=16, itemsize=2)),
    ("flash_decode", dict(rows=128, groups=1, dh=64, s=512)),
    ("flash_decode", dict(rows=16, groups=1, dh=64, s=32_768)),
    ("flash_decode", dict(rows=128, groups=1, dh=64, s=32_768, itemsize=2)),
    ("flash_decode", dict(rows=16, groups=1, dh=64, s=32_768, itemsize=2)),
)
_ESTIMATES = {
    "dekrr_step": estimate_dekrr_step,
    "dekrr_solve": estimate_dekrr_solve,
    "dekrr_async_solve": estimate_dekrr_async_solve,
    "dekrr_cheb_solve": estimate_dekrr_cheb_solve,
    "rff_gram": estimate_rff_gram,
    "rff_features": estimate_rff_features,
    "serve_wave": estimate_serve_wave,
    "flash_decode": estimate_flash_decode,
}
_SM_DEPENDENT = ("rff_gram", "rff_features", "serve_wave")


def _label(kernel: str, shape: dict) -> str:
    return kernel + "[" + ",".join(f"{k}={v}" for k, v in shape.items()) \
        + "]"


def path_estimates(sms: int = H100_SMS) -> list[tuple[str, SmemEstimate]]:
    """(label, estimate) of every kernel at `PATH_SHAPES`, on a card of
    ``sms`` SMs."""
    out = []
    for kernel, shape in PATH_SHAPES:
        kw = dict(shape, sms=sms) if kernel in _SM_DEPENDENT else shape
        out.append((_label(kernel, shape), _ESTIMATES[kernel](**kw)))
    return out


def launcher_bytes(kernel: str, shape: dict, sms: int = H100_SMS) -> int:
    """The dynamic shared memory a block that the kernel's ``csrc``
    launcher takes at ``shape`` (`PATH_SHAPES`' keys), read from the
    library's C export (``*_smem_bytes``) at the launch plan the wrapper
    would pass; the largest block for `rff_gram`'s wide route. This loads
    the built library, so it runs where the kernels build (the card's
    machine), never on the way to a launch."""
    from repro_torch.kernels import _build

    item = shape.get("itemsize", 8)
    if kernel.startswith("dekrr_"):
        lib = _build.library(kernel)
        suffix = "f64" if item == 8 else "f32"
        if shape.get("route") == "resident":
            from repro_torch.kernels.dekrr_solve import (RESIDENT_ROW_BLOCKS,
                                                         resident_shapes)

            live = shape["k_slots"]
            dy = shape.get("dy", 1)
            _, rows, _ = resident_shapes(shape["d_feat"], dy, live, item,
                                         SMEM_LIMITS[kernel],
                                         RESIDENT_ROW_BLOCKS[kernel])[0]
            fn = getattr(lib, f"{kernel}_resident_smem_bytes_{suffix}")
            return fn(live, shape["d_feat"], dy, rows)
        fn = getattr(lib, f"{kernel}_smem_bytes_{suffix}")
        return fn(shape["k_slots"], shape["d_feat"], shape.get("dy", 1))
    if kernel == "rff_gram":
        from repro_torch.kernels.rff_gram import (F32GramPlan, WideGramPlan,
                                                  gram_plan)

        lib = _build.library("rff_gram")
        plan = gram_plan(shape["b"], shape["f"], shape["dim"], shape["n"],
                         item=item, sms=sms)
        if isinstance(plan, WideGramPlan):
            return max(lib.rff_gram_wide_smem_bytes(item, 0),
                       lib.rff_gram_wide_smem_bytes(item, 1))
        layout = lib.rff_gram_smem_bytes(shape["f"], shape["dim"],
                                         plan.cluster, int(plan.resident),
                                         item,
                                         plan.zbufs if isinstance(
                                             plan, F32GramPlan) else 1)
        if layout != plan.smem_bytes:
            raise SmemBudgetError(
                f"rff_gram: gram_plan passes {plan.smem_bytes} bytes but "
                f"the kernel's layout takes {layout}")
        return plan.smem_bytes
    if kernel in ("rff_features", "serve_wave"):
        from repro_torch.kernels.rff_features import features_plan

        lib = _build.library("rff_features")
        plan = features_plan(shape["j"], shape["d_feat"], shape["n"],
                             item=item, sms=sms)
        if item == 2:
            return lib.rff_features_bf16_smem_bytes(plan.rows, plan.cols)
        return lib.rff_features_smem_bytes(plan.warp_rows, plan.warp_cols,
                                           plan.warp_tiles, item)
    if kernel == "flash_decode":
        from repro_torch.kernels.decode_attention import decode_plan

        item = shape.get("itemsize", 4)
        plan = decode_plan(shape["rows"], shape["groups"], shape["dh"], item)
        return _build.library("flash_decode").flash_decode_smem_bytes(
            plan.ppg, plan.stages, plan.head_block, plan.dh, item)
    raise ValueError(f"unknown kernel {kernel!r}")


def run_pass() -> list:
    """V001 findings: every path estimate that does not fit."""
    from repro_torch.analysis.report import Finding

    return [Finding("budget", "V001", label, "; ".join(est.problems()))
            for label, est in path_estimates() if not est.fits]
