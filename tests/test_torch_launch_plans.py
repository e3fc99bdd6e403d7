"""The CUDA kernels' launch plans, which stay in Python so the CPU can
check them: `rff_gram`'s clusters, slices and workspace (and its wide
route past the clusters' shared memory: passes of problems, N chunks and
64×64 tiles), the featurize kernel's tiles, the round kernel's rows per
cluster block, the chain kernels' clusters (`chain_plan`), and the decode
kernel's chunks, head blocks and workspace (`decode_plan`)."""
import pytest

from repro_torch.kernels.decode_attention import (DECODE_HEAD_BLOCKS,
                                                  DECODE_LANE_GROUPS,
                                                  DECODE_SMEM_LIMIT,
                                                  DECODE_THREADS, decode_plan)
from repro_torch.kernels.dekrr_solve import chain_plan

from repro_torch.kernels.dekrr_step import (ROUND_CLUSTER, ROUND_WARPS,
                                             round_plan)
from repro_torch.kernels.rff_features import (FEAT_DEPTH, FEAT_STAGES,
                                              FEAT_TILES, FEAT_WARP_ROWS,
                                              features_plan)
from repro_torch.kernels.rff_gram import (GRAM_COLS, GRAM_MAX_RANK_ROWS,
                                          GRAM_SMEM_LIMIT, GRAM_WIDE_TILE,
                                          GRAM_WORKSPACE_CAP, GramPlan,
                                          WideGramPlan, gram_plan)

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
    assert isinstance(gram_plan(b, f, dim, n, item=item), GramPlan)


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
    assert isinstance(gram_plan(1, 1024, 148, 3180, item=4), GramPlan)
    assert isinstance(gram_plan(1, 1025, 148, 3180, item=4), WideGramPlan)


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
