"""The CUDA kernels' launch plans, which stay in Python so the CPU can
check them: `rff_gram`'s clusters, slices and workspace (and its wide
route past the clusters' shared memory: passes of problems, N chunks and
64×64 tiles), the featurize kernel's tiles, the round kernel's rows per
cluster block, the chain kernels' clusters (`chain_plan`), and the decode
kernel's chunks, head blocks and workspace (`decode_plan`)."""
import importlib
import re
from pathlib import Path

import numpy as np
import pytest

from repro_torch.analysis import smem
from repro_torch.kernels.decode_attention import (DECODE_BF16_CHUNK_TILES,
                                                  DECODE_BF16_THREADS,
                                                  DECODE_HEAD_BLOCKS,
                                                  DECODE_LANE_GROUPS,
                                                  DECODE_SMEM_LIMIT,
                                                  DECODE_THREADS, decode_plan,
                                                  decode_smem_bytes)
from repro_torch.kernels.dekrr_solve import (RESIDENT_MAX_ROWS,
                                             RESIDENT_ROW_BLOCKS,
                                             RESIDENT_ROWS_PER_WARP,
                                             ChainPlan, chain_plan,
                                             resident_plan,
                                             resident_smem_bytes,
                                             resident_shapes,
                                             table_slot_nodes, wait_sets)

from repro_torch.kernels.dekrr_step import (ROUND_CLUSTER, ROUND_WARPS,
                                             round_plan)
from repro_torch.kernels.rff_features import (BF16_DEPTH, BF16_ROW_STRIDE,
                                              BF16_TILES, FEAT_DEPTH,
                                              FEAT_STAGES, FEAT_TILES,
                                              FEAT_WARP_ROWS,
                                              _bf16_smem_bytes, bf16_depth,
                                              features_plan)
from repro_torch.kernels.rff_gram import (GRAM_COLS, GRAM_F32_MAX_UNITS,
                                          GRAM_MAX_RANK_ROWS,
                                          GRAM_SMEM_LIMIT, GRAM_WIDE_TILE,
                                          GRAM_WORKSPACE_CAP, F32GramPlan,
                                          GramPlan, WideGramPlan, gram_plan)

# the module, not `repro_torch.kernels.dekrr_solve` the wrapper
chains = importlib.import_module("repro_torch.kernels.dekrr_solve")

MAIN_PATH = [(10, 200, 148, 3180), (40, 200, 148, 3180)]
GRAM_SHAPES = MAIN_PATH + [(3, 70, 13, 300), (2, 200, 148, 21),
                           (2, 330, 21, 700), (1, 1, 1, 1), (400, 200, 148, 3180),
                           (5, 512, 784, 10_000), (7, 17, 5, 33),
                           (1, 512, 148, 300)]


@pytest.mark.parametrize("b,f,dim,n", GRAM_SHAPES)
@pytest.mark.parametrize("item", [8, 4])
def test_gram_plan_slices_cover_every_column_once(b, f, dim, n, item):
    plan = gram_plan(b, f, dim, n, item=item)
    # slice s takes columns [s·slice_cols, (s+1)·slice_cols) ∩ [0, N)
    slices = [range(min(n, s * plan.slice_cols),
                    min(n, (s + 1) * plan.slice_cols))
              for s in range(plan.slices)]
    assert [c for cols in slices for c in cols] == list(range(n))
    assert all(len(cols) for cols in slices)
    assert plan.slice_cols % GRAM_COLS == 0


@pytest.mark.parametrize("b,f,dim,n", GRAM_SHAPES)
@pytest.mark.parametrize("item", [8, 4])
def test_gram_plan_stays_within_shared_memory_and_workspace(b, f, dim, n,
                                                            item):
    plan = gram_plan(b, f, dim, n, item=item)
    assert plan.smem_bytes <= GRAM_SMEM_LIMIT
    assert plan.slices == 1 or plan.workspace * item <= GRAM_WORKSPACE_CAP
    if isinstance(plan, F32GramPlan):    # 32-row blocks, 32×32 units
        nb = -(-f // 32)
        assert -(-nb // plan.cluster) * 32 <= GRAM_MAX_RANK_ROWS
        assert plan.groups * plan.group_units >= nb * (nb + 1) // 2
    else:
        nb = -(-f // 16)
        assert -(-nb // plan.cluster) * 16 <= GRAM_MAX_RANK_ROWS
        assert plan.groups * plan.group_blocks >= nb * (nb + 1) // 2
    assert plan.ctas == plan.cluster * plan.slices * plan.groups * b


@pytest.mark.parametrize("b,f,dim,n", MAIN_PATH)
def test_gram_plan_fills_the_card_on_the_main_path(b, f, dim, n):
    plan = gram_plan(b, f, dim, n, item=8, sms=132)
    assert plan.ctas >= 132
    assert plan.groups == 1          # every cosine computed once
    assert plan.resident             # Ω read from device memory once


def test_gram_plan_refuses_features_beyond_shared_memory():
    """The cluster route refuses F = 2,048, which no cluster's shared
    memory holds: the plan is the wide route's, one Gram block per 64×64
    tile of G's upper triangle (32 tiles a side), one problem, one
    64-column chunk."""
    plan = gram_plan(1, 2048, 8, 64)
    assert plan == WideGramPlan(f_pad=2048, tiles=32 * 33 // 2, batch=1,
                                cols=64, chunks=1, workspace=2048 * 64,
                                ctas=32 * 33 // 2)


@pytest.mark.parametrize("b,f,dim,n", GRAM_SHAPES)
@pytest.mark.parametrize("item", [8, 4])
def test_gram_plan_keeps_the_cluster_route_where_it_fits(b, f, dim, n, item):
    assert isinstance(gram_plan(b, f, dim, n, item=item),
                      GramPlan if item == 8 else F32GramPlan)


# (B, F, d, N, item): past 560 features in f64 and 1,024 in f32 (at d =
# 148); the timing shape and its slot-block call, where the workspace cap
# splits N; many problems (passes); F and N large enough that one
# problem's Z takes many chunks
TILED_SHAPES = [(1, 600, 148, 3180, 8), (10, 600, 148, 3180, 8),
                (2, 1200, 21, 700, 8), (1, 1100, 148, 300, 4),
                (3, 561, 148, 33, 8), (1, 1025, 784, 64, 4),
                (40, 600, 148, 3180, 8), (400, 600, 148, 3180, 8),
                (1, 4000, 148, 100_000, 8), (7, 2500, 5, 33_333, 4)]


def _wide_owners(f, plan):
    """Upper-triangle entry → Gram block of one problem, as
    csrc/rff_gram.cu assigns them: block `idx` takes tile (I, J) of the
    row-major upper triangle (tri_block) and sums rows [I·64, (I+1)·64) ×
    [J·64, (J+1)·64) ∩ [0, F)², keeping r ≤ c on the diagonal."""
    t, nt = GRAM_WIDE_TILE, plan.f_pad // GRAM_WIDE_TILE
    tiles = [(i, j) for i in range(nt) for j in range(i, nt)]
    owners = {}
    for idx, (i, j) in enumerate(tiles):
        for r in range(i * t, min(f, (i + 1) * t)):
            for c in range(max(r, j * t), min(f, (j + 1) * t)):
                owners.setdefault((r, c), []).append(idx)
    return tiles, owners


@pytest.mark.parametrize("b,f,dim,n,item", TILED_SHAPES)
def test_gram_plan_takes_the_tiled_route_past_the_clusters(b, f, dim, n,
                                                          item):
    """Past the clusters the plan is the wide route's: one Gram block per
    64×64 tile (I ≤ J) of G's upper triangle, for every problem of a
    pass, and every upper-triangle entry owned by exactly one block."""
    plan = gram_plan(b, f, dim, n, item=item)
    assert isinstance(plan, WideGramPlan)
    assert plan.f_pad % GRAM_WIDE_TILE == 0
    assert plan.f_pad - GRAM_WIDE_TILE < f <= plan.f_pad
    f_seen = min(f, 1100)       # the first 1,100 rows (the check is O(F²))
    tiles, owners = _wide_owners(f_seen, plan)
    assert plan.tiles == len(tiles) and plan.ctas == plan.batch * len(tiles)
    assert set(owners) == {(r, c) for r in range(f_seen)
                           for c in range(r, f_seen)}
    assert all(len(blocks) == 1 for blocks in owners.values())


@pytest.mark.parametrize("b,f,dim,n,item", TILED_SHAPES)
def test_wide_gram_plan_reads_every_column_once_per_chunk(b, f, dim, n,
                                                          item):
    """Passes of `batch` problems cover every problem once; the N chunks
    [c·cols, (c+1)·cols) ∩ [0, N) cover every column once; within a
    chunk the Z launch's 64-column blocks and the Gram launch's
    32-column stages each read every column of the chunk once."""
    plan = gram_plan(b, f, dim, n, item=item)
    passes = [range(p, min(b, p + plan.batch))
              for p in range(0, b, plan.batch)]
    assert [q for ps in passes for q in ps] == list(range(b))
    chunks = [range(c * plan.cols, min(n, (c + 1) * plan.cols))
              for c in range(plan.chunks)]
    assert [col for ch in chunks for col in ch] == list(range(n))
    assert all(len(ch) for ch in chunks)
    assert plan.cols % GRAM_WIDE_TILE == 0
    for ch in chunks:
        width = len(ch)
        z_cols = [c for blk in range(-(-width // GRAM_WIDE_TILE))
                  for c in range(blk * GRAM_WIDE_TILE,
                                 (blk + 1) * GRAM_WIDE_TILE)]
        stages = [c for k in range(-(-width // 32))
                  for c in range(k * 32, (k + 1) * 32)]
        assert z_cols[:width] == stages[:width] == list(range(width))
        assert len(stages) <= len(z_cols) <= plan.cols   # zero-filled tail


@pytest.mark.parametrize("b,f,dim,n,item", TILED_SHAPES)
def test_wide_gram_plan_stays_within_the_workspace_cap(b, f, dim, n, item):
    """The workspace holds one pass's Z chunk [batch, F_pad, cols] and
    stays within GRAM_WORKSPACE_CAP; a pass takes all B problems where
    they fill four Gram blocks an SM, and N is split only where the cap
    binds."""
    plan = gram_plan(b, f, dim, n, item=item)
    assert plan.workspace == plan.batch * plan.f_pad * plan.cols
    assert plan.workspace * item <= GRAM_WORKSPACE_CAP
    assert plan.batch == b or plan.ctas >= 4 * 132
    n_pad = -(-n // GRAM_WIDE_TILE) * GRAM_WIDE_TILE
    if plan.chunks > 1:           # one more chunk's width would not fit
        assert plan.batch * plan.f_pad * n_pad * item > GRAM_WORKSPACE_CAP
    else:
        assert plan.cols == n_pad


def test_gram_plan_route_switches_exactly_past_the_limit():
    assert isinstance(gram_plan(1, 560, 148, 3180, item=8), GramPlan)
    assert isinstance(gram_plan(1, 561, 148, 3180, item=8), WideGramPlan)
    assert isinstance(gram_plan(1, 1024, 148, 3180, item=4), F32GramPlan)
    assert isinstance(gram_plan(1, 1025, 148, 3180, item=4), WideGramPlan)


# (B, F, d, N) of the f32 cluster route: the `gram_fn` shape, the kernel
# bench's three CASES, F 16 and 1,024 (Ω streamed at d 784), ragged N,
# a cluster of 4 and a few problems
F32_SHAPES = [(1, 200, 148, 3180), (1, 100, 8, 10_000), (1, 200, 148, 30_000),
              (1, 512, 96, 30_000), (1, 16, 5, 100), (1, 1024, 96, 3000),
              (1, 1024, 784, 777), (1, 512, 96, 1001), (1, 33, 13, 130),
              (1, 300, 21, 70), (3, 70, 13, 300), (10, 200, 148, 3180)]


def _f32_units(f):
    nb = -(-f // 32)
    return nb, [(i, j) for i in range(nb) for j in range(i, nb)]


@pytest.mark.parametrize("b,f,dim,n", F32_SHAPES)
def test_f32_gram_plan_reads_every_column_once_per_group(b, f, dim, n):
    """Each group's clusters walk the S slices [s·slice_cols, (s+1)·
    slice_cols) ∩ [0, N) in 32-column tiles: every column once per group,
    no slice empty, and every group holds Z of its slice once (its ranks
    form disjoint 32-row blocks covering F)."""
    plan = gram_plan(b, f, dim, n, item=4)
    assert isinstance(plan, F32GramPlan)
    for _ in range(plan.groups):
        cols = []
        for s in range(plan.slices):
            c_begin, c_end = s * plan.slice_cols, min(n, (s + 1)
                                                      * plan.slice_cols)
            assert c_end > c_begin
            for t in range(-(-(c_end - c_begin) // GRAM_COLS)):
                cols += range(c_begin + t * GRAM_COLS,
                              min(c_end, c_begin + (t + 1) * GRAM_COLS))
        assert cols == list(range(n))
    nb, _ = _f32_units(f)
    rank_rows = -(-nb // plan.cluster) * 32
    owned = [r for rank in range(plan.cluster)
             for r in range(rank * rank_rows,
                            min(nb * 32, (rank + 1) * rank_rows))]
    assert owned == list(range(nb * 32))
    assert rank_rows <= GRAM_MAX_RANK_ROWS    # a projection unit a producer warp


@pytest.mark.parametrize("b,f,dim,n", F32_SHAPES)
def test_f32_gram_plan_reduces_each_upper_element_once_in_slice_order(
        b, f, dim, n):
    """Every 32×32 unit of a group is held by one warp slot (rank l % C,
    warp l / C % 8, slot l / C / 8 < units_per_warp), and the reducing
    launch gives each upper-triangle element (i ≤ j < F) and each zy row
    exactly one thread, which reads the slices' partials at s = 0 … S−1 in
    order, where the Gram launch of slice s wrote that element."""
    plan = gram_plan(b, f, dim, n, item=4)
    nb, tri = _f32_units(f)
    gu, c = plan.group_units, plan.cluster
    assert plan.microtile == (4, 8)
    assert 1 <= plan.units_per_warp <= GRAM_F32_MAX_UNITS
    slots = set()
    for q in range(plan.groups):
        for l in range(min(gu, len(tri) - q * gu)):
            slot = (l % c, l // c % 8, l // c // 8)
            assert slot[2] < plan.units_per_warp and slot not in slots
            slots.add(slot)
        slots.clear()
    ublk = gu * 32 * 32
    per = plan.groups * ublk + nb * 32
    assert plan.reduce_ctas * 256 >= per > (plan.reduce_ctas - 1) * 256
    e = np.arange(plan.groups * ublk)
    q, rem = e // ublk, e % ublk
    unit, el = q * gu + rem // 1024, rem % 1024
    live = unit < len(tri)
    ij = np.asarray(tri)[unit[live]]
    i = ij[:, 0] * 32 + el[live] // 32
    j = ij[:, 1] * 32 + el[live] % 32
    keep = (i <= j) & (j < f)
    pairs = i[keep] * f + j[keep]
    assert np.array_equal(np.sort(pairs),
                          np.array([r * f + k for r in range(f)
                                    for k in range(r, f)]))
    # the partials a thread reads, in its order, are where the Gram launch
    # of slice s = 0, 1, … wrote its element: lane tr + 8·tc of the unit's
    # warp holds rows 4·tr + r, columns 8·tc + c of the unit
    for e0 in np.flatnonzero(live)[np.flatnonzero(keep)][:: max(1, len(
            pairs) // 64)]:
        qq, rr = divmod(int(e0), ublk)
        l, row, col = rr // 1024, rr % 1024 // 32, rr % 32
        tr, r, tc, cc = row // 4, row % 4, col // 8, col % 8
        reads = [(qq * plan.slices + s) * ublk + rr
                 for s in range(plan.slices)]
        writes = [(qq * plan.slices + s) * ublk + l * 1024
                  + (4 * tr + r) * 32 + 8 * tc + cc
                  for s in range(plan.slices)]
        assert reads == writes == sorted(reads)
    zy_rows = np.arange(plan.groups * ublk, per) - plan.groups * ublk
    assert list(zy_rows[zy_rows < f]) == list(range(f))


@pytest.mark.parametrize("b,f,dim,n", F32_SHAPES)
def test_f32_gram_plan_fits_shared_memory_and_the_workspace(b, f, dim, n):
    """The block's layout is within SMEM_LIMITS["rff_gram"], the estimate
    the wrapper checks equals it (both launches' grids within the card's
    limits), and the workspace of the slices' partials and zy rows is
    within GRAM_WORKSPACE_CAP."""
    plan = gram_plan(b, f, dim, n, item=4)
    est = smem.estimate_rff_gram(b=b, f=f, dim=dim, n=n, itemsize=4)
    assert plan.smem_bytes == est.bytes <= smem.SMEM_LIMITS["rff_gram"]
    assert est.fits and est.cluster == plan.cluster
    nb = -(-f // 32)
    assert plan.workspace == b * plan.slices * (
        plan.groups * plan.group_units * 1024 + nb * 32)
    assert plan.workspace * 4 <= GRAM_WORKSPACE_CAP
    assert plan.blocks_per_sm == 1


@pytest.mark.parametrize("b,f,dim,n", F32_SHAPES)
def test_f32_gram_plan_forms_z_once_up_to_608_features(b, f, dim, n):
    """One group (each Z entry of a slice formed once, the triangle held
    by one cluster's consumer warps) wherever the units fit a cluster of 8
    at three a warp (192 units: F ≤ 608); past that the groups each form Z
    again. The smallest cluster that holds the triangle at two units a
    warp is taken first, a ring of two Z tiles up to F 512 at least, and
    the B 1 shapes fill most of the card."""
    plan = gram_plan(b, f, dim, n, item=4)
    nb = -(-f // 32)
    units = nb * (nb + 1) // 2
    assert (plan.groups == 1) == (f <= 608)
    assert plan.zbufs == 2 or f > 512      # two Z tiles fit up to F 512
    assert plan.units_per_warp * 8 * plan.cluster >= plan.group_units
    half = plan.cluster // 2
    if half and units <= 2 * 8 * half:   # half the cluster would hold it:
        assert -(-nb // half) * 32 > GRAM_MAX_RANK_ROWS  # refused by rows
    if b == 1 and n >= 3000:
        assert plan.ctas >= 100


@pytest.mark.parametrize("b,f,dim,n", [(10, 200, 148, 3180),
                                       (40, 200, 148, 3180)])
def test_f64_gram_plans_at_the_main_path_are_unchanged(b, f, dim, n):
    """The f64 cluster route keeps its plans (csrc/rff_gram.cu's f64
    kernel is untouched by the f32 route)."""
    want = {10: GramPlan(cluster=2, resident=True, slices=13, slice_cols=256,
                         groups=1, group_blocks=91, smem_bytes=227_200,
                         workspace=3_055_520, ctas=260),
            40: GramPlan(cluster=2, resident=True, slices=8, slice_cols=416,
                         groups=1, group_blocks=91, smem_bytes=227_200,
                         workspace=7_521_280, ctas=640)}
    assert gram_plan(b, f, dim, n, item=8) == want[b]


# (J, D_max, N): the serving wave's node and wave shapes at each column
# bucket, the ragged phase case, and odd sizes
FEATURE_SHAPES = [(1, 200, 512), (10, 200, 512), (1, 200, 8), (10, 200, 64),
                  (3, 200, 13), (1, 37, 13), (40, 600, 4096), (2, 1, 1)]


@pytest.mark.parametrize("j,d_feat,n", FEATURE_SHAPES)
@pytest.mark.parametrize("item", [8, 4, 2])
def test_features_plan_covers_every_entry_once(j, d_feat, n, item):
    plan = features_plan(j, d_feat, n, item=item)
    if item == 2:
        # one product over the stacked [J·D_max, N]: every entry is owned
        # by one thread of one block, row tiles straddling nodes
        bm, bn, tm, tn = (plan.rows, plan.cols, plan.thread_rows,
                          plan.thread_cols)
        assert (bm, bn, tm, tn) in BF16_TILES
        assert plan.threads == (bm // tm) * (bn // tn) == 128
        rows = j * d_feat
        assert plan.blocks == -(-rows // bm) * -(-n // bn)
        # block (x, y)'s thread (t_m, t_n) owns rows y·bm + t_m + i·bm/tm,
        # i < tm, and columns x·bn + t_n·tn + e, e < tn
        rt = bm // tm
        owned_rows = sorted(
            r for y in range(-(-rows // bm)) for t in range(rt)
            for i in range(tm) if (r := y * bm + t + i * rt) < rows)
        owned_cols = sorted(
            c for x in range(-(-n // bn)) for t in range(bn // tn)
            for e in range(tn) if (c := x * bn + t * tn + e) < n)
        assert owned_rows == list(range(rows))
        assert owned_cols == list(range(n))
        if j > 1 and d_feat % bm:
            assert any((y * bm) // d_feat != (min(rows, (y + 1) * bm) - 1)
                       // d_feat for y in range(-(-rows // bm)))
        return
    assert (plan.warp_rows, plan.warp_cols, plan.warp_tiles) in FEAT_TILES
    assert plan.rows == FEAT_WARP_ROWS * plan.warp_rows
    assert plan.cols == 8 * plan.warp_tiles * plan.warp_cols
    row_tiles, col_tiles = -(-d_feat // plan.rows), -(-n // plan.cols)
    assert plan.blocks == j * row_tiles * col_tiles
    # block (x, y, node) writes rows [y·rows, (y+1)·rows) ∩ [0, D_max) and
    # columns [x·cols, (x+1)·cols) ∩ [0, N)
    rows = [r for y in range(row_tiles)
            for r in range(y * plan.rows, min(d_feat, (y + 1) * plan.rows))]
    cols = [c for x in range(col_tiles)
            for c in range(x * plan.cols, min(n, (x + 1) * plan.cols))]
    assert rows == list(range(d_feat)) and cols == list(range(n))


@pytest.mark.parametrize("j,d_feat,n", FEATURE_SHAPES)
@pytest.mark.parametrize("item", [8, 4, 2])
def test_features_plan_shared_memory_covers_the_layout(j, d_feat, n, item):
    """f64/f32: a ring of FEAT_STAGES slots, each an Ω slice [rows][32 + 4]
    and an X slice [32][cols + 4]. bf16: two f32 X slots [BF16_DEPTH][cols]
    (which then hold the sums [rows][cols + 4]), two Ω slots
    [rows][BF16_ROW_STRIDE], the row stride 4 past the deepest chunk (the
    prefetch past a chunk's end stays in its row) and 4 mod 8 floats (the
    four rows a warp reads at one k on distinct banks), and a bias and a
    state a row. Within the 227 KB a block may use."""
    plan = features_plan(j, d_feat, n, item=item)
    if item == 2:
        assert BF16_ROW_STRIDE >= BF16_DEPTH + 4 and BF16_ROW_STRIDE % 8 == 4
        assert plan.rows * (plan.cols + 4) <= 2 * BF16_DEPTH * plan.cols
        layout = 4 * (2 * BF16_DEPTH * plan.cols
                      + 2 * plan.rows * BF16_ROW_STRIDE + 2 * plan.rows)
    else:
        layout = FEAT_STAGES * (plan.rows * (FEAT_DEPTH + 4)
                                + FEAT_DEPTH * (plan.cols + 4)) * item
    assert plan.smem_bytes >= layout
    assert plan.smem_bytes <= 232_448


@pytest.mark.parametrize("item", [8, 4, 2])
def test_features_plan_fills_the_card_at_the_serving_shapes(item):
    """One node of the serving wave (D 200, N 512) gets ~100 blocks or
    more, the wave of 10 nodes at least one block per SM."""
    assert features_plan(1, 200, 512, item=item, sms=132).blocks >= 100
    assert features_plan(10, 200, 512, item=item, sms=132).blocks >= 132


def test_bf16_features_plan_takes_the_wave_in_one_round_of_blocks():
    """The wave (J 10, D 200, N 512): 64 × 64 blocks of 4 × 8 microtiles,
    256 blocks, two resident an SM (shared memory and registers), so the
    grid runs in one round on 132 SMs."""
    plan = features_plan(10, 200, 512, item=2, sms=132)
    assert (plan.rows, plan.cols, plan.thread_rows,
            plan.thread_cols) == (64, 64, 4, 8)
    assert plan.blocks == 256
    per_sm = smem.SMEM_PER_SM // (plan.smem_bytes
                                  + smem.SMEM_RESERVED_PER_BLOCK)
    assert per_sm >= 2 and per_sm * 132 >= plan.blocks
    assert 2 * plan.threads * 255 <= 65_536


# (J, D_max, N) at the serving shapes → the f64/f32 tile (warps along
# rows, along columns, m16n8 tiles a warp) and blocks, as before the bf16
# route had a kernel of its own
F64_F32_PLANS = [((1, 200, 512), (4, 2, 1), 128), ((10, 200, 512), (2, 2, 4), 560),
                 ((1, 200, 8), (4, 2, 1), 4), ((10, 200, 64), (2, 2, 2), 140),
                 ((10, 200, 16), (4, 2, 1), 40), ((3, 200, 13), (4, 2, 1), 12),
                 ((1, 37, 13), (2, 2, 4), 2)]


@pytest.mark.parametrize("shape,tile,blocks", F64_F32_PLANS)
@pytest.mark.parametrize("item", [8, 4])
def test_features_plan_f64_f32_unchanged_at_the_serving_shapes(
        shape, tile, blocks, item):
    plan = features_plan(*shape, item=item, sms=132)
    assert (plan.warp_rows, plan.warp_cols, plan.warp_tiles) == tile
    assert plan.blocks == blocks


FEATURES_CSRC = (Path(__file__).resolve().parents[1] / "src" / "repro_torch"
                 / "kernels" / "csrc" / "rff_features.cu")


@pytest.mark.parametrize("tile", BF16_TILES)
def test_bf16_features_layout_matches_the_kernel_source(tile):
    """The bf16 plan's tiles, depth and shared memory (the formula every
    bf16 plan's smem_bytes takes) are the kernel's: the launcher's tile
    menu, kBfDepth and kBfRowStride, and `bf16_smem_bytes`' return
    expression evaluated in Python."""
    src = FEATURES_CSRC.read_text()
    menu = tuple(tuple(int(v) for v in m) for m in re.findall(
        r"RFF_BF16_TILE\((\d+), (\d+), (\d+), (\d+)\)", src))
    assert menu == BF16_TILES
    depth = int(re.search(r"constexpr int kBfDepth = (\d+);", src).group(1))
    stride = re.search(r"constexpr int kBfRowStride = ([^;]+);", src).group(1)
    assert depth == BF16_DEPTH
    assert eval(stride, {}, dict(kBfDepth=depth)) == BF16_ROW_STRIDE
    body = src[src.index("size_t bf16_smem_bytes("):]
    expr = body[body.index("return") + len("return"):body.index(";")]
    for a, b in (("static_cast<size_t>", ""), ("sizeof(float)", "4")):
        expr = expr.replace(a, b)
    bm, bn = tile[:2]
    assert _bf16_smem_bytes(bm, bn) == eval(f"({expr})", {}, dict(
        bm=bm, bn=bn, kBfDepth=depth, kBfRowStride=BF16_ROW_STRIDE))


@pytest.mark.parametrize("dim", [1, 5, 8, 9, 16, 17, 64, 148, 149, 160,
                                 161, 600])
def test_bf16_depth_stages_d_in_few_chunks(dim):
    """Chunks of a multiple of 8 within the staged slot, two or more
    where d > 8 (the second loads while the first is multiplied), and no
    more than one chunk's worth of zero padding."""
    kc = bf16_depth(dim)
    chunks = -(-dim // kc)
    assert kc % 8 == 0 and 8 <= kc <= BF16_DEPTH
    assert chunks >= (2 if dim > 8 else 1)
    assert chunks == max(2 if dim > 8 else 1, -(-dim // BF16_DEPTH))
    assert chunks * kc - dim < 8 * chunks


@pytest.mark.parametrize("d_feat", [1, 7, 8, 9, 200, 513])
def test_round_plan_owns_every_row_once(d_feat):
    blocks, rows = round_plan(d_feat)
    assert 1 <= blocks <= ROUND_CLUSTER
    assert blocks <= -(-d_feat // ROUND_WARPS)     # no block past one row a warp
    spans = [range(c * rows, min(d_feat, (c + 1) * rows))
             for c in range(blocks)]              # as csrc/dekrr_step.cu splits
    assert [a for span in spans for a in span] == list(range(d_feat))
    assert all(len(span) for span in spans)



def _chain_owners(j_nodes, plan):
    """Node → cluster and row → block maps of a chain launch, as
    csrc/dekrr_solve.cu and csrc/dekrr_async_solve.cu assign them: cluster
    q runs nodes q, q + n, ...; block c of a cluster forms rows
    [c·rows, (c+1)·rows) ∩ [0, D)."""
    blocks, rows, n_clusters = plan
    nodes = [j for q in range(n_clusters) for j in range(q, j_nodes,
                                                         n_clusters)]
    return nodes, blocks, rows


CHAIN_J = [1, 3, 10, 40, 130]
CHAIN_D = [12, 150, 200, 257, 300]
CHAIN_CAPS = [1, 4, 16, 132]


@pytest.mark.parametrize("j_nodes", CHAIN_J)
@pytest.mark.parametrize("d_feat", CHAIN_D)
@pytest.mark.parametrize("cap", CHAIN_CAPS)
def test_chain_plan_owns_every_node_and_row_once(j_nodes, d_feat, cap):
    plan = chain_plan(j_nodes, d_feat, lambda _blocks: cap)
    nodes, blocks, rows = _chain_owners(j_nodes, plan)
    assert sorted(nodes) == list(range(j_nodes))     # one cluster per node
    assert 1 <= plan[2] <= min(cap, j_nodes)
    spans = [range(c * rows, min(d_feat, (c + 1) * rows))
             for c in range(blocks)]
    assert [a for span in spans for a in span] == list(range(d_feat))
    assert 1 <= blocks <= ROUND_CLUSTER


@pytest.mark.parametrize("j_nodes", CHAIN_J)
@pytest.mark.parametrize("d_feat", CHAIN_D)
@pytest.mark.parametrize("cap", CHAIN_CAPS)
def test_chain_plan_keeps_the_round_plan_where_a_cluster_fits(j_nodes,
                                                              d_feat, cap):
    """A node's rows split over the cluster as one round launch splits
    them, and the launch takes every cluster it may (up to one per
    node)."""
    assert chain_plan(j_nodes, d_feat, lambda _blocks: cap) == round_plan(
        d_feat) + (min(j_nodes, cap),)


@pytest.mark.parametrize("d_feat", CHAIN_D)
@pytest.mark.parametrize("fits_below", [1, 2, 5])
def test_chain_plan_shrinks_the_cluster_only_where_none_fits(d_feat,
                                                             fits_below):
    """Where no cluster of the round plan's size fits, C shrinks to the
    largest size that does, its blocks forming more rows, and still owns
    every row once."""
    blocks0, _ = round_plan(d_feat)
    fits = lambda blocks: 3 if blocks <= fits_below else 0   # noqa: E731
    plan = chain_plan(10, d_feat, fits)
    blocks, rows, n_clusters = plan
    assert blocks <= min(blocks0, fits_below) and n_clusters == 3
    assert -(-d_feat // rows) == blocks and blocks * rows >= d_feat
    larger = [b for b in range(blocks + 1, blocks0 + 1)
              if -(-d_feat // -(-d_feat // b)) == b]
    assert all(b > fits_below for b in larger)      # the largest that fits
    assert sorted(_chain_owners(10, plan)[0]) == list(range(10))


def test_chain_plan_refuses_where_no_cluster_fits():
    with pytest.raises(RuntimeError, match="no thread-block cluster"):
        chain_plan(10, 200, lambda _blocks: 0)


@pytest.mark.parametrize("j_nodes,clusters", [(10, 10), (40, 15)])
@pytest.mark.parametrize("dy", [1, 3])
def test_chain_plan_sizes_the_chebyshev_chain(j_nodes, clusters, dy):
    """The Chebyshev chain at the main path's K 4, D 200, with the card
    holding 15 clusters of 7 blocks at once (its shared memory per block
    is the sync chain's, node_smem_elems): round_plan's 7 blocks of 29
    rows, one cluster per node at J 10, and 15 clusters looping over the
    nodes at J 40."""
    d_feat = 200
    fits = lambda blocks: 15 if blocks <= 7 else 0     # noqa: E731
    plan = chain_plan(j_nodes, d_feat, fits)
    assert plan == round_plan(d_feat) + (clusters,) == (7, 29, clusters)
    nodes, blocks, rows = _chain_owners(j_nodes, plan)
    assert sorted(nodes) == list(range(j_nodes))
    # block c updates p and θ at rows [c·29, (c+1)·29) ∩ [0, D) of each of
    # the Dy output columns: every element of a node's [Dy, D] block once
    owned = [o * d_feat + a for c in range(blocks) for o in range(dy)
             for a in range(c * rows, min(d_feat, (c + 1) * rows))]
    assert sorted(owned) == list(range(dy * d_feat))


# ------------------------------------------------- the chains' resident route
def _h100_clusters(blocks, threads, nbytes):
    """Clusters of `blocks` such blocks an H100 holds at once, on the
    card's limits alone (232,448 B of an SM's shared memory a block plus
    1 KB reserved, 2,048 threads an SM, 132 SMs; the card's own query is
    stricter where a cluster must sit in one GPC)."""
    per_sm = min(smem.SMEM_PER_SM // (nbytes + smem.STATIC_SMEM[
        "dekrr_solve"] + smem.SMEM_RESERVED_PER_BLOCK), 2048 // threads)
    return smem.H100_SMS * per_sm // blocks


def _circulant(j_nodes, offsets=(1, -1, 2, -2)):
    return (np.arange(j_nodes)[:, None] + np.array(offsets)) % j_nodes


def _resident(nodes, live, d_feat, dy=1, item=8, rounds=32,
              fits=_h100_clusters, kernel="dekrr_solve"):
    return resident_plan(nodes, live, d_feat, dy, item, rounds, fits,
                         smem.SMEM_LIMITS[kernel],
                         RESIDENT_ROW_BLOCKS[kernel])


# (J, D, Dy, itemsize): the paper's shape, its Dy 3, f32, small and ragged D,
# the edge of the route (D 256, in f32: in f64 its 4 live slots' rows pass
# a block's shared memory), one node
RESIDENT_SHAPES = [(10, 200, 1, 8), (10, 200, 3, 8), (10, 200, 1, 4),
                   (5, 12, 3, 8), (7, 150, 2, 8), (3, 256, 1, 4),
                   (1, 200, 1, 8), (10, 33, 1, 4)]


@pytest.mark.parametrize("j_nodes,d_feat,dy,item", RESIDENT_SHAPES)
def test_resident_plan_owns_every_node_and_row_once(j_nodes, d_feat, dy,
                                                    item):
    """One cluster per node; block c of a node's cluster forms rows
    [c·rows, (c+1)·rows) ∩ [0, D): every row once, no block without rows,
    at most 32 rows (a warp per two) and 8 blocks."""
    nodes = _circulant(j_nodes)
    if j_nodes == 1:
        nodes = np.full((1, 4), -1)
    plan = _resident(nodes, np.ones(nodes.shape, bool), d_feat, dy, item)
    assert isinstance(plan, ChainPlan) and plan.route == "resident"
    assert plan.clusters == j_nodes and 1 <= plan.blocks <= ROUND_CLUSTER
    spans = [range(c * plan.rows, min(d_feat, (c + 1) * plan.rows))
             for c in range(plan.blocks)]
    assert [a for span in spans for a in span] == list(range(d_feat))
    assert all(len(span) for span in spans)
    assert plan.rows <= RESIDENT_MAX_ROWS
    assert plan.threads == 32 * -(-plan.rows // RESIDENT_ROWS_PER_WARP)
    assert plan.smem_bytes <= smem.SMEM_LIMITS["dekrr_solve"]


# (J, K live, D, Dy, itemsize, R, route): the paper's shape resident; J 40
# at D 200 (19.2 MB a node set, 320 blocks of 210 KB: more than the card
# holds), D past 256, Dy 8 at D 200 (shared memory), 17 live slots, and
# launches of one round streamed
ROUTE_CASES = [(10, 4, 200, 1, 8, 32, "resident"),
               (10, 4, 200, 1, 8, 1000, "resident"),
               (40, 4, 200, 1, 8, 32, "streamed"),
               (2, 1, 257, 1, 8, 32, "streamed"),
               (10, 4, 200, 8, 8, 32, "streamed"),
               (3, 17, 12, 1, 8, 32, "streamed"),
               (10, 4, 200, 1, 8, 1, "streamed"),
               (40, 4, 32, 1, 8, 7, "resident")]


@pytest.mark.parametrize("j_nodes,k,d_feat,dy,item,rounds,route",
                         ROUTE_CASES)
def test_resident_route_only_where_the_footprint_fits(j_nodes, k, d_feat,
                                                      dy, item, rounds,
                                                      route):
    """The resident route is taken only where a layout fits a block's
    shared memory (`resident_shapes`), the card holds J clusters of it and
    R ≥ RESIDENT_MIN_ROUNDS; elsewhere the plan says why not."""
    nodes = (np.arange(j_nodes)[:, None] + 1 + np.arange(k)) % j_nodes
    plan = _resident(nodes, np.ones((j_nodes, k), bool), d_feat, dy, item,
                     rounds)
    if route == "streamed":
        assert isinstance(plan, str) and plan
        return
    assert isinstance(plan, ChainPlan) and plan.route == "resident"
    shapes = resident_shapes(d_feat, dy, k, item,
                             smem.SMEM_LIMITS["dekrr_solve"])
    assert (plan.blocks, plan.rows, plan.smem_bytes) in shapes
    assert _h100_clusters(plan.blocks, plan.threads,
                          plan.smem_bytes) >= j_nodes
    # the card holding one cluster fewer than J sends the plan elsewhere
    short = _resident(nodes, np.ones((j_nodes, k), bool), d_feat, dy, item,
                      rounds, fits=lambda *_: j_nodes - 1)
    assert isinstance(short, str)


def _wait_sets_by_definition(nodes):
    j_nodes = len(nodes)
    reads = [{int(i) for i in row if i >= 0} for row in nodes]
    return tuple(tuple(sorted({j} | reads[j] | {i for i in range(j_nodes)
                                                if j in reads[i]}))
                 for j in range(j_nodes))


# slot tables: the paper's circulant(10, (1, 2)); an asymmetric one (node 0
# reads 3, nobody reads 0 but 2) with masked slots and a node reading no
# one; J 40 circulant
WAIT_TABLES = [
    (_circulant(10), np.ones((10, 4), bool)),
    (np.array([[3, 1, 2], [2, 0, 0], [0, 3, 1], [1, 1, 1], [0, 0, 0]]),
     np.array([[1, 0, 0], [1, 1, 0], [1, 0, 1], [0, 0, 0], [0, 0, 0]],
              bool)),
    (_circulant(40), np.ones((40, 4), bool)),
]


@pytest.mark.parametrize("table,live", WAIT_TABLES)
def test_wait_sets_are_in_and_out_neighbours(table, live):
    """W(j) = {j} ∪ in(j) ∪ out(j): for the async chain (slots hold node
    ids) and for the synchronous chain with θ-table rows mapped to the
    nodes that own them (rows no node owns read θ0 and wait on no one)."""
    nodes = np.where(live, table, -1)
    want = _wait_sets_by_definition(nodes)
    assert wait_sets(nodes) == want
    j_nodes = len(table)
    # the synchronous chain: node j owns table row self_idx[j] of T = J + 2
    self_idx = np.random.default_rng(j_nodes).permutation(j_nodes + 2)[
        :j_nodes]
    rows = np.where(live, self_idx[table], -1)
    rows[0, 0] = j_nodes + 5 if live[0, 0] else rows[0, 0]   # no owner
    got = table_slot_nodes(np.where(live, rows, 10 ** 6), self_idx, live)
    expect = np.where(live, table, -1)
    if live[0, 0]:
        expect[0, 0] = -1
    np.testing.assert_array_equal(got, expect)
    plan = _resident(got, live, 32)
    assert plan.waits == _wait_sets_by_definition(got)
    table_w = plan.wait_table()
    for j, w in enumerate(plan.waits):
        assert tuple(table_w[j][table_w[j] >= 0]) == w


@pytest.mark.parametrize("j_nodes,d_feat,dy,item", RESIDENT_SHAPES)
@pytest.mark.parametrize("kernel", ["dekrr_solve", "dekrr_async_solve",
                                    "dekrr_cheb_solve"])
def test_resident_plan_bytes_equal_the_smem_estimate(kernel, j_nodes,
                                                     d_feat, dy, item):
    """The plan's shared memory equals `analysis/smem.py`'s estimate of the
    same launch (its own formula), which fits, holds the G rows in
    registers and, without a plan, names the same first layout. The
    Chebyshev chain's block holds its p rows [Dy, rows] besides."""
    nodes = _circulant(j_nodes) if j_nodes > 1 else np.full((1, 4), -1)
    live = np.ones(nodes.shape, bool)
    plan = _resident(nodes, live, d_feat, dy, item, kernel=kernel)
    p_rows = dy * plan.rows * item if kernel == "dekrr_cheb_solve" else 0
    assert plan.smem_bytes == resident_smem_bytes(
        4, d_feat, dy, plan.rows, item) + p_rows
    est = getattr(smem, f"estimate_{kernel}")(
        j_nodes=j_nodes, k_slots=4, d_feat=d_feat, dy=dy, itemsize=item,
        plan=plan)
    assert est.bytes == plan.smem_bytes and est.fits
    assert est.cluster == plan.blocks
    assert est.grids == ((plan.blocks, j_nodes, 1),)
    assert est.register_bytes == plan.rows * d_feat * item
    bare = getattr(smem, f"estimate_{kernel}")(
        j_nodes=j_nodes, k_slots=4, d_feat=d_feat, dy=dy, itemsize=item,
        route="resident")
    assert bare.bytes == plan.smem_bytes


def _streamed_clusters(blocks, k_slots, d_feat, dy, item):
    """Clusters of `blocks` streamed chain blocks (1,024 threads,
    node_smem_elems) an H100 holds at once, on the card's limits alone."""
    nbytes = (k_slots + 2) * dy * d_feat * item
    per_sm = min(smem.SMEM_PER_SM // (nbytes + smem.STATIC_SMEM[
        "dekrr_cheb_solve"] + smem.SMEM_RESERVED_PER_BLOCK), 2048 // 1024)
    return smem.H100_SMS * per_sm // blocks


@pytest.fixture
def fake_card(monkeypatch):
    """The route plans on the CPU: device 0 and the occupancy queries of
    an H100 on its limits alone (`_h100_clusters`, `_streamed_clusters`)
    in place of the kernels' exports."""
    monkeypatch.setattr(chains.torch.cuda, "current_device", lambda: 0)
    monkeypatch.setattr(
        chains, "_resident_max_clusters",
        lambda name, suffix, blocks, threads, nbytes, device:
        _h100_clusters(blocks, threads, nbytes))
    monkeypatch.setattr(
        chains, "_max_clusters",
        lambda name, k, d_feat, dy, suffix, blocks, device:
        _streamed_clusters(blocks, k, d_feat, dy,
                           8 if suffix == "f64" else 4))
    chains._solve_plan.cache_clear()
    yield
    chains._solve_plan.cache_clear()


# (J, K, D, Dy, R, route) of `cheb_plan`: the paper's shape at the
# Chebyshev path's 96 rounds (8 blocks of 25 rows, 210,000 B a block),
# the Chebyshev and accel benches' D_j 30, a Dy 3 resident case; launches
# of one round, J 40 at D 200 and D 257 streamed
CHEB_ROUTES = [(10, 4, 200, 1, 96, "resident"), (10, 4, 30, 1, 96, "resident"),
               (10, 4, 200, 3, 7, "resident"), (10, 4, 200, 1, 1, "streamed"),
               (40, 4, 200, 1, 96, "streamed"),
               (2, 1, 257, 1, 32, "streamed")]


@pytest.mark.parametrize("j_nodes,k,d_feat,dy,rounds,route", CHEB_ROUTES)
def test_cheb_plan_takes_the_resident_route_where_it_fits(
        fake_card, j_nodes, k, d_feat, dy, rounds, route):
    """`cheb_plan` picks the route by the synchronous chain's rule with
    the p rows in the footprint, and its wait sets and slot nodes are
    `solve_plan`'s for the same slot table (self_idx a permutation of a
    table with two rows no node owns, so T > J)."""
    import torch

    rng = np.random.default_rng(j_nodes + d_feat)
    self_idx = rng.permutation(j_nodes + 2)[:j_nodes]
    nbr_idx = self_idx[(np.arange(j_nodes)[:, None] + 1
                        + np.arange(k)) % j_nodes]
    if j_nodes > 2:
        nbr_idx[0, -1] = np.setdiff1d(np.arange(j_nodes + 2), self_idx)[0]
    mask = np.ones((j_nodes, k))
    kw = dict(d_feat=d_feat, dy=dy, dtype=torch.float64, rounds=rounds)
    plan = chains.cheb_plan(nbr_idx, self_idx, mask, **kw)
    assert plan.route == route, plan
    if route == "streamed":
        assert plan.why
        assert plan.smem_bytes == (k + 2) * dy * d_feat * 8
        assert (plan.blocks, plan.rows) == chain_plan(j_nodes, d_feat,
                                                      lambda b: 1)[:2]
        return
    sync = chains.solve_plan(nbr_idx, self_idx, mask, **kw)
    assert sync.route == "resident"
    assert plan.waits == sync.waits == wait_sets(plan.slot_nodes)
    assert plan.slot_nodes == sync.slot_nodes
    assert (plan.blocks, plan.rows, plan.clusters) == (
        sync.blocks, sync.rows, j_nodes)
    assert plan.smem_bytes == sync.smem_bytes + dy * plan.rows * 8
    assert plan.smem_bytes == smem.estimate_dekrr_cheb_solve(
        j_nodes=j_nodes, k_slots=k, d_feat=d_feat, dy=dy, plan=plan).bytes
    if (j_nodes, d_feat, dy) == (10, 200, 1):
        assert (plan.blocks, plan.rows, plan.smem_bytes) == (8, 25, 210_000)


# ------------------------------------------------------------------ decode
# (rows = B·K, G, dh): qwen1.5-0.5b at one request and at the serving
# batch, smollm-135m (G 3), granite-3-8b (G 4, dh 128), hubert-xlarge's dh
# 80, jamba's G 8 (two head blocks), a dh-256 and a dh-4 edge
DECODE_HEADS = [(16, 1, 64), (128, 1, 64), (24, 3, 64), (64, 4, 128),
                (16, 1, 80), (8, 8, 128), (2, 4, 256), (3, 2, 4)]
DECODE_CACHE = 32_768


def _decode_lengths(chunk):
    """Row lengths: 1, either side of the first chunk edge, on it, on the
    second edge and the whole cache."""
    return (1, chunk - 1, chunk, chunk + 1, 2 * chunk, DECODE_CACHE)


def _chunk_positions(plan, length):
    return [[p for p in range(c * plan.chunk,
                              min((c + 1) * plan.chunk, length))]
            for c in plan.active_chunks(length)]


@pytest.mark.parametrize("rows,groups,dh", DECODE_HEADS)
def test_decode_plan_active_chunks_cover_each_position_once(rows, groups,
                                                            dh):
    """The chunks a row of len positions runs cover [0, len) exactly once,
    each holds at least one valid position, and all lie inside the grid
    of a launch over any cache that holds len."""
    plan = decode_plan(rows, groups, dh)
    for length in _decode_lengths(plan.chunk):
        cut = _chunk_positions(plan, length)
        assert [p for ps in cut for p in ps] == list(range(length))
        assert all(cut)
        for s in (length, length + 4, DECODE_CACHE):
            assert len(cut) <= plan.grid(s)[1] == -(-s // plan.chunk)


@pytest.mark.parametrize("rows,groups,dh", DECODE_HEADS)
def test_decode_plan_is_the_same_for_every_cache_and_length(rows, groups,
                                                            dh):
    """The plan is a function of (rows, G, dh): the chunk does not move
    with the batch either, and a length cuts the same chunks out of a view
    of any cache length (a strided view of cur + 4 positions, the int8
    path's slice to cur, a graph replayed at new lengths)."""
    plan = decode_plan(rows, groups, dh)
    assert decode_plan(rows, groups, dh) == plan
    assert {decode_plan(r, groups, dh).chunk for r in (1, 7, rows, 512)} \
        == {plan.chunk}
    assert plan.chunk % plan.tile == 0
    assert plan.tile == plan.ppg * DECODE_LANE_GROUPS
    assert plan.chunk * dh * 8 <= 256 << 10 or plan.chunk == plan.tile
    for length in _decode_lengths(plan.chunk):
        assert _chunk_positions(plan, length) == [
            list(range(c * plan.chunk, min((c + 1) * plan.chunk, length)))
            for c in range(-(-length // plan.chunk))]


@pytest.mark.parametrize("rows,groups,dh", DECODE_HEADS)
@pytest.mark.parametrize("s", [1, 512, 513, 4096, DECODE_CACHE])
def test_decode_plan_workspace_holds_every_partial_once(rows, groups, dh,
                                                       s):
    """One (m, l, acc[dh]) record per (row, chunk, query head), packed
    without gaps or overlaps into `workspace(s)` floats; one ticket per
    (row, head block)."""
    plan = decode_plan(rows, groups, dh)
    chunks = plan.chunks(s)
    assert plan.workspace(s) == rows * chunks * groups * (2 + dh)
    offsets = sorted(plan.record(r, c, g, s) for r in range(rows)
                     for c in range(chunks) for g in range(groups))
    assert offsets == list(range(0, plan.workspace(s), 2 + dh))
    assert plan.counters == rows * plan.head_blocks
    assert plan.blocks(s) == rows * plan.head_blocks * chunks


@pytest.mark.parametrize("groups", range(1, 10))
def test_decode_plan_head_blocks_take_every_query_head_once(groups):
    plan = decode_plan(4, groups, 64)
    assert plan.head_block in DECODE_HEAD_BLOCKS
    heads = [h for x in range(plan.head_blocks)
             for h in range(x * plan.head_block,
                            min(groups, (x + 1) * plan.head_block))]
    assert heads == list(range(groups))
    assert plan.head_blocks == 1 or plan.head_block == DECODE_HEAD_BLOCKS[-1]


@pytest.mark.parametrize("rows,groups,dh", DECODE_HEADS)
def test_decode_plan_ring_fits_shared_memory(rows, groups, dh):
    """At least three ring stages of 32 or 64 positions of K and V (two a
    lane group where such a stage is at most 32 KB), within what a block
    may take; the idle ring holds the merge of the 8 warps' states (m, l,
    acc[dh] per head) and the combine's (m, l, acc) per thread."""
    plan = decode_plan(rows, groups, dh)
    ring = plan.stages * 2 * plan.tile * dh
    assert plan.stages in (3, 4) and plan.threads == DECODE_THREADS
    assert plan.ppg == (2 if 2 * 64 * dh * 4 <= 32 << 10 else 1)
    assert plan.smem_bytes == (ring + plan.head_block * dh) * 4
    assert plan.smem_bytes <= DECODE_SMEM_LIMIT
    assert ring >= DECODE_THREADS // 32 * plan.head_block * (2 + dh)
    assert ring >= 3 * DECODE_THREADS
    assert plan.blocks_per_sm >= 1


def test_decode_plan_fills_the_card_at_one_long_request():
    """qwen1.5-0.5b at B 1, S 32,768: 16 rows in chunks of 512 positions
    give 1,024 blocks, at least two full waves of 132 SMs holding as many
    blocks as their shared memory takes."""
    plan = decode_plan(16, 1, 64)
    assert plan.chunk == 512 and plan.blocks(DECODE_CACHE) == 1024
    assert plan.blocks(DECODE_CACHE) >= 2 * 132 * plan.blocks_per_sm
    assert plan.waves(DECODE_CACHE, sms=132) >= 2


@pytest.mark.parametrize("dh", [0, 6, 66])
def test_decode_plan_refuses_a_head_dim_off_the_float4_grid(dh):
    with pytest.raises(ValueError, match="head_dim"):
        decode_plan(16, 1, dh)


# ------------------------------------------------------------- decode, bf16
# the (rows, G, dh) above whose dh a 16-byte copy of bf16 takes (a multiple
# of 8), and the bf16 route's third column count (dh 256)
DECODE_HEADS_BF16 = [c for c in DECODE_HEADS if c[2] % 8 == 0]
CSRC = (Path(__file__).resolve().parents[1] / "src" / "repro_torch"
        / "kernels" / "csrc" / "flash_decode.cu")


def _bf16_lengths(plan):
    """`_decode_lengths`, and either side of the last block's merge
    window (its second window starts one chunk past it)."""
    span = plan.merge_window * plan.chunk
    return _decode_lengths(plan.chunk) + (span, span + 1, span + plan.chunk
                                          + 1)


@pytest.mark.parametrize("rows,groups,dh", DECODE_HEADS_BF16)
def test_bf16_decode_plan_active_chunks_cover_each_position_once(rows,
                                                                 groups, dh):
    """bf16: the chunks a row of len positions runs cover [0, len) exactly
    once, each with a valid position, inside the grid of any cache that
    holds len; the merge folds exactly those chunks, in chunk order."""
    plan = decode_plan(rows, groups, dh, 2)
    for length in _bf16_lengths(plan):
        cut = _chunk_positions(plan, length)
        assert [p for ps in cut for p in ps] == list(range(length))
        assert all(cut)
        assert plan.merge_order(length) == list(range(len(cut)))
        for s in (length, length + 4, max(length, DECODE_CACHE)):
            assert len(cut) <= plan.grid(s)[1] == -(-s // plan.chunk)


@pytest.mark.parametrize("rows,groups,dh", DECODE_HEADS_BF16)
def test_bf16_decode_plan_depends_on_dh_alone(rows, groups, dh):
    """bf16: the chunk and the merge window move with neither the rows
    (a request alone and inside a batch cut the same chunks) nor the
    cache length or the row lengths, which the plan never reads; the
    chunk is 16 tiles of 32·ppg positions, ppg·⌈dh / 64⌉ = 4 (512 KB of
    K and V from dh 64 up)."""
    plan = decode_plan(rows, groups, dh, 2)
    others = [decode_plan(r, groups, dh, 2) for r in (1, 7, rows, 512)]
    assert {(o.chunk, o.merge_window, o.tile, o.stages) for o in others} \
        == {(plan.chunk, plan.merge_window, plan.tile, plan.stages)}
    columns = 1 if dh <= 64 else 2 if dh <= 128 else 4
    assert plan.ppg * columns == 4 and plan.tile == 32 * plan.ppg
    assert plan.chunk == DECODE_BF16_CHUNK_TILES * plan.tile
    assert plan.chunk * dh * 4 <= 512 << 10
    assert plan.chunk * dh * 4 == 512 << 10 or dh not in (64, 128, 256)
    assert plan.threads == DECODE_BF16_THREADS
    assert plan.chunk != decode_plan(rows, groups, dh, 4).chunk


def _cxx_constant(src, name):
    return int(re.search(rf"constexpr int {name} = (\d+);", src).group(1))


def _cxx_bf16_smem_bytes(ppg, stages, head_block, dh):
    """`bf16_smem_bytes` of csrc/flash_decode.cu, its return expression
    evaluated in Python (size_t(x) as x, sizeof(bf16) 2, sizeof(float)
    4, kBGroups the source's 32 · kBConsumerWarps / kLanes), with
    `bf16_merge_bytes` as the source states it: the larger of
    kBMergeBytes and kBConsumerWarps · head_block · (2 + dh) floats."""
    src = CSRC.read_text()
    body = src[src.index("size_t bf16_smem_bytes("):]
    expr = body[body.index("return") + len("return"):body.index(";")]
    groups = 32 * _cxx_constant(src, "kBConsumerWarps") \
        // _cxx_constant(src, "kLanes")
    for a, b in (("size_t(", "("), ("sizeof(bf16)", "2"),
                 ("sizeof(float)", "4"), ("kBGroups", str(groups))):
        expr = expr.replace(a, b)
    merge = src[src.index("size_t bf16_merge_bytes("):]
    assert "size_t(kBConsumerWarps) * head_block * (2 + dh) * sizeof(float)" \
        in merge[:merge.index("}")]
    floor = _cxx_constant(src, "kBMergeBytes")
    warps = _cxx_constant(src, "kBConsumerWarps")

    def bf16_merge_bytes(hb, d):
        return max(floor, warps * hb * (2 + d) * 4)

    return eval(f"({expr})", {}, dict(
        ppg=ppg, stages=stages, head_block=head_block, dh=dh,
        bf16_merge_bytes=bf16_merge_bytes))


@pytest.mark.parametrize("rows,groups,dh", DECODE_HEADS_BF16)
def test_bf16_decode_plan_layout_matches_the_kernel_source(rows, groups,
                                                           dh):
    """bf16: `decode_smem_bytes`, the kernel's `bf16_smem_bytes` and
    `estimate_flash_decode` agree: the ring of bf16 K and V stages, a slot
    a stage for a unit's query rows (bf16), the query rows in f32, the
    merge area, a full and an empty mbarrier a stage (8 bytes each),
    the 16-byte flag and 128 bytes to align the ring, under the block
    limit; the merge area holds the 8 consumer warps' states (head block
    × (2 + dh) floats each) and the merge window's whole partials, and not
    one more."""
    plan = decode_plan(rows, groups, dh, 2)
    ring = plan.stages * 2 * plan.tile * dh * 2
    merge = max(34_816, 8 * plan.head_block * (2 + dh) * 4)
    assert plan.smem_bytes == decode_smem_bytes(
        plan.ppg, plan.stages, plan.head_block, dh, 2) \
        == _cxx_bf16_smem_bytes(plan.ppg, plan.stages, plan.head_block, dh) \
        == (ring + plan.stages * plan.head_block * dh * 2
            + plan.head_block * dh * 4 + merge + plan.stages * 2 * 8 + 16 + 128)
    est = smem.estimate_flash_decode(rows=rows, groups=groups, dh=dh,
                                     s=DECODE_CACHE, itemsize=2)
    assert est.bytes == plan.smem_bytes and est.fits
    assert plan.smem_bytes <= DECODE_SMEM_LIMIT
    heads = min(groups, plan.head_block)
    assert merge >= 8 * plan.head_block * (2 + dh) * 4
    assert plan.merge_window >= 1
    assert plan.merge_window * heads * (2 + dh) * 4 <= merge \
        < (plan.merge_window + 1) * heads * (2 + dh) * 4


def test_bf16_decode_plan_fills_the_card():
    """qwen1.5-0.5b in bf16 (dh 64, G 1), 2 blocks an SM held for the
    whole launch (persistent; the kernel asks the card, whose registers
    hold 2 of 288 threads): one long request (B 1, S 32,768) cuts 256
    units of 2,048 positions (512 KB), one round of the 264 blocks with
    3% of them idle, and its 16 partials a row fit one merge window; at B
    8 the 2,048 units are 7.76 a block, so a block takes 7 or 8 and the
    last round leaves at most 3.1% of the unit slots idle. The serving
    cache's 128 rows (S 512) are 128 units, one a block on 128 of the 132
    SMs, at cur 512 and at cur 128, as the parent's were."""
    long = decode_plan(16, 1, 64, 2)
    batch, serving = decode_plan(128, 1, 64, 2), decode_plan(128, 1, 64, 2)
    assert long.blocks_per_sm == 2 and long.chunk == 2048
    assert long.resident(132) == 264
    assert long.blocks(DECODE_CACHE) == 256
    assert 0.96 < long.waves(DECODE_CACHE, sms=132) <= 1
    assert long.merge_window >= DECODE_CACHE // long.chunk
    waves = batch.waves(DECODE_CACHE, sms=132)
    assert batch.blocks(DECODE_CACHE) == 2048 and 7 < waves < 8
    assert (np.ceil(waves) - waves) / np.ceil(waves) <= 0.031
    assert serving.blocks(512) == 128 <= serving.resident(132)
    assert all(list(serving.active_chunks(cur)) == [0] for cur in (128, 512))
