"""Operation and byte counts of a fit: a hand-checked shape, live work on
ragged nodes, and no dependence on padding, chunking or route."""
import pytest

from perfbench import roofline
from perfbench.generators import fitloop
from perfbench.tests.tinycell import make_root

# Three nodes on a ring: every node has both others as neighbours.
SHAPE = roofline.FitShape(d=2, dims=[1, 2, 3], n_train=[4, 5, 6],
                          n_test=[1, 1, 2],
                          neighbours=[[1, 2], [2, 0], [0, 1]],
                          candidates=[20, 40, 60], rounds=5, chunk=2)


def test_hand_checked_counts():
    # DDRF: per node 2·F0·d·N + 2·F0·N (bias, cos) + 2·F0·N (align, square)
    assert roofline.ddrf_ops(SHAPE) == (
        (2 * 20 * 2 * 4 + 4 * 20 * 4) + (2 * 40 * 2 * 5 + 4 * 40 * 5)
        + (2 * 60 * 2 * 6 + 4 * 60 * 6))
    # one round: Σ_j 2·D_j·(2·D_j + Σ_p D_p)
    assert roofline.round_ops(SHAPE) == (2 * 1 * (2 + 5) + 2 * 2 * (4 + 4)
                                         + 2 * 3 * (6 + 3))
    feat = lambda f, n: 2 * f * 2 * n + 3 * f * n
    sym = lambda f, n: f * (f + 1) * n
    # every pair (i, k) is live on a 3-ring: 9 featurizations
    feats = sum(feat(f, n) for f in (1, 2, 3) for n in (4, 5, 6))
    grams = sum(sym(f, n) for f in (1, 2, 3) for n in (4, 5, 6))
    zy = 2 * (1 * 4 + 2 * 5 + 3 * 6)
    dims, ns = [1, 2, 3], [4, 5, 6]
    p = sum(2 * dims[j] * dims[q] * (ns[j] + ns[q])
            for j in range(3) for q in range(3) if q != j)
    sums = sum(4 * f * f for f in dims)
    inv = sum(2 * f**3 for f in dims)
    assert roofline.pack_ops(SHAPE) == feats + grams + zy + p + sums + inv
    assert roofline.predict_ops(SHAPE) == (feat(1, 1) + 2 + feat(2, 1) + 4
                                           + feat(3, 2) + 12)
    launches = roofline.solve_launches(SHAPE)
    assert [ops for ops, _ in launches] == [2 * 100, 2 * 100, 1 * 100]
    live = sum(2 * f * f + 3 * f for f in dims) + sum(
        dims[j] * dims[q] for j in range(3) for q in range(3) if q != j)
    assert all(b == 8 * live for _, b in launches)
    own, cross = roofline.gram_launches(SHAPE)
    assert own[0] == sum(feat(f, n) + sym(f, n) + 2 * f * n
                         for f, n in zip(dims, ns))
    assert cross[1] == 8 * (sum(f * 2 + f for f in dims)
                            + sum(2 * n for n in ns)
                            + sum(dims[j] ** 2 for j in range(3)
                                  for q in range(3) if q != j))


def test_ragged_nodes_count_live_work():
    import dataclasses

    padded = dataclasses.replace(
        SHAPE, dims=[3, 3, 3], n_train=[6, 6, 6], n_test=[2, 2, 2],
        candidates=[60, 60, 60])
    for count in (roofline.ddrf_ops, roofline.pack_ops, roofline.round_ops,
                  roofline.predict_ops, roofline.fit_ops):
        assert count(SHAPE) < count(padded)
    # a node's work is its own: dropping a node's features to 0 removes it
    solo = roofline.FitShape(d=2, dims=[3], n_train=[6], n_test=[2],
                             neighbours=[[]], candidates=[60])
    assert roofline.ddrf_ops(solo) == 2 * 60 * 2 * 6 + 4 * 60 * 6


@pytest.mark.parametrize("chunk", [1, 2, 5, 32])
def test_chain_count_does_not_depend_on_launches(chunk):
    import dataclasses

    sh = dataclasses.replace(SHAPE, chunk=chunk)
    launches = roofline.solve_launches(sh)
    assert sum(ops for ops, _ in launches) == 5 * roofline.round_ops(SHAPE)
    assert len(launches) == -(-5 // chunk)


@pytest.mark.parametrize("base", ["table2-wave", "fig4-twitter-imbalanced"])
def test_counts_follow_the_programs_live_shapes(tmp_path, base):
    """The harness's shape is the program's live layout: the packed
    problem's node_dims, whatever D_max the padding reaches; the chain's
    launches are the program's dispatches at the solve's rounds."""
    import importlib

    from perfbench import run

    ops = importlib.import_module("repro_torch.kernels.ops")
    root = make_root(tmp_path, base=base)
    cell = run.resolve(root, "tiny-fit")
    prob = fitloop.build(cell.config, cell.traffic, 7, "cpu")
    ops.reset_launch_counts()
    before = ops.dispatch_counts()["dekrr_solve"]
    out = fitloop.fit(prob, 0)
    packed = out["packed"]
    sh = prob.shape(out["rounds"])
    assert tuple(sh.dims) == packed.node_dims
    assert sh.n_train == [int(x.shape[1]) for x, _ in prob.train]
    assert len(roofline.solve_launches(sh)) == (
        ops.dispatch_counts()["dekrr_solve"] - before)
    if base.startswith("fig4"):
        assert packed.max_features > min(sh.dims)
