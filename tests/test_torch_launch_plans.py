"""The CUDA kernels' launch plans, which stay in Python so the CPU can
check them: `rff_gram`'s clusters, slices and workspace (and its tiled
route past the clusters' shared memory), the featurize kernel's tiles,
and the round kernel's rows per cluster block."""
import pytest

from repro_torch.kernels.dekrr_step import (ROUND_CLUSTER, ROUND_WARPS,
                                             round_plan)
from repro_torch.kernels.rff_features import (FEAT_DEPTH, FEAT_STAGES,
                                              FEAT_TILES, FEAT_WARP_ROWS,
                                              features_plan)
from repro_torch.kernels.rff_gram import (GRAM_COLS, GRAM_MAX_RANK_ROWS,
                                          GRAM_SMEM_LIMIT, GRAM_TILE,
                                          GRAM_WORKSPACE_CAP, GramPlan,
                                          TiledGramPlan, gram_plan)

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
    memory holds: the plan is the tiled route's, one block per 32×32
    tile of G's upper triangle (64 tiles a side)."""
    plan = gram_plan(1, 2048, 8, 64)
    assert plan == TiledGramPlan(tiles=64 * 65 // 2, ctas=64 * 65 // 2)


@pytest.mark.parametrize("b,f,dim,n", GRAM_SHAPES)
@pytest.mark.parametrize("item", [8, 4])
def test_gram_plan_keeps_the_cluster_route_where_it_fits(b, f, dim, n, item):
    assert isinstance(gram_plan(b, f, dim, n, item=item), GramPlan)


# (B, F, d, N, item): past 560 features in f64 and 1,024 in f32 (at d = 148)
TILED_SHAPES = [(1, 600, 148, 3180, 8), (10, 600, 148, 3180, 8),
                (2, 1200, 21, 700, 8), (1, 1100, 148, 300, 4),
                (3, 561, 148, 33, 8), (1, 1025, 784, 64, 4)]


@pytest.mark.parametrize("b,f,dim,n,item", TILED_SHAPES)
def test_gram_plan_takes_the_tiled_route_past_the_clusters(b, f, dim, n,
                                                          item):
    plan = gram_plan(b, f, dim, n, item=item)
    tiles = -(-f // GRAM_TILE)
    assert isinstance(plan, TiledGramPlan)
    # one block per tile (I ≤ J) of G's upper triangle, for every problem
    pairs = [(i, j) for i in range(tiles) for j in range(i, tiles)]
    assert plan.tiles == len(pairs) and plan.ctas == b * len(pairs)
    covered = {(r, c) for i, j in pairs
               for r in range(i * GRAM_TILE, min(f, (i + 1) * GRAM_TILE))
               for c in range(j * GRAM_TILE, min(f, (j + 1) * GRAM_TILE))}
    assert {(r, c) for r, c in covered if r <= c} == {
        (r, c) for r in range(f) for c in range(r, f)}


def test_gram_plan_route_switches_exactly_past_the_limit():
    assert isinstance(gram_plan(1, 560, 148, 3180, item=8), GramPlan)
    assert isinstance(gram_plan(1, 561, 148, 3180, item=8), TiledGramPlan)
    assert isinstance(gram_plan(1, 1024, 148, 3180, item=4), GramPlan)
    assert isinstance(gram_plan(1, 1025, 148, 3180, item=4), TiledGramPlan)


# (J, D_max, N): the serving wave's node and wave shapes at each column
# bucket, the ragged phase case, and odd sizes
FEATURE_SHAPES = [(1, 200, 512), (10, 200, 512), (1, 200, 8), (10, 200, 64),
                  (3, 200, 13), (1, 37, 13), (40, 600, 4096), (2, 1, 1)]


@pytest.mark.parametrize("j,d_feat,n", FEATURE_SHAPES)
@pytest.mark.parametrize("item", [8, 4, 2])
def test_features_plan_covers_every_entry_once(j, d_feat, n, item):
    plan = features_plan(j, d_feat, n, item=item)
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
    """The kernel's layout: a ring of FEAT_STAGES slots, each an Ω slice
    [rows][32 + pad] and an X slice [32][cols + pad], pad 4 elements (8
    in bf16); within the 227 KB a block may use."""
    plan = features_plan(j, d_feat, n, item=item)
    pad = 8 if item == 2 else 4
    layout = FEAT_STAGES * (plan.rows * (FEAT_DEPTH + pad)
                            + FEAT_DEPTH * (plan.cols + pad)) * item
    assert plan.smem_bytes >= layout
    assert plan.smem_bytes <= 232_448


@pytest.mark.parametrize("item", [8, 4, 2])
def test_features_plan_fills_the_card_at_the_serving_shapes(item):
    """One node of the serving wave (D 200, N 512) gets ~100 blocks or
    more, the wave of 10 nodes at least one block per SM."""
    assert features_plan(1, 200, 512, item=item, sms=132).blocks >= 100
    assert features_plan(10, 200, 512, item=item, sms=132).blocks >= 132


@pytest.mark.parametrize("d_feat", [1, 7, 8, 9, 200, 513])
def test_round_plan_owns_every_row_once(d_feat):
    blocks, rows = round_plan(d_feat)
    assert 1 <= blocks <= ROUND_CLUSTER
    assert blocks <= -(-d_feat // ROUND_WARPS)     # no block past one row a warp
    spans = [range(c * rows, min(d_feat, (c + 1) * rows))
             for c in range(blocks)]              # as csrc/dekrr_step.cu splits
    assert [a for span in spans for a in span] == list(range(d_feat))
    assert all(len(span) for span in spans)

