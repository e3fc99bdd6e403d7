"""The CUDA kernels' launch plans, which stay in Python so the CPU can
check them: `rff_gram`'s clusters, slices and workspace, and the round
kernel's rows per cluster block."""
import pytest

from repro_torch.kernels.dekrr_step import (ROUND_CLUSTER, ROUND_WARPS,
                                             round_plan)
from repro_torch.kernels.rff_gram import (GRAM_COLS, GRAM_MAX_RANK_ROWS,
                                          GRAM_SMEM_LIMIT, GRAM_WORKSPACE_CAP,
                                          gram_plan)

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
    with pytest.raises(ValueError, match="shared memory"):
        gram_plan(1, 2048, 8, 64)


@pytest.mark.parametrize("d_feat", [1, 7, 8, 9, 200, 513])
def test_round_plan_owns_every_row_once(d_feat):
    blocks, rows = round_plan(d_feat)
    assert 1 <= blocks <= ROUND_CLUSTER
    assert blocks <= -(-d_feat // ROUND_WARPS)     # no block past one row a warp
    spans = [range(c * rows, min(d_feat, (c + 1) * rows))
             for c in range(blocks)]              # as csrc/dekrr_step.cu splits
    assert [a for span in spans for a in span] == list(range(d_feat))
    assert all(len(span) for span in spans)

