"""The frozen stand-in generator against the program's, and the inputs
of a run as a function of its seed."""
import numpy as np
import pytest
import torch

from perfbench import data
from perfbench.generators import fitloop
from perfbench.tests.tinycell import ROOT


@pytest.mark.parametrize("name,mode,imbalanced", [
    ("wave", "noniid_y", False), ("twitter", "iid", True),
    ("houses", "noniid_xnorm", False)])
def test_frozen_generator_matches_program(name, mode, imbalanced):
    from repro_torch.data import synthetic as prog

    x, y = data.make_dataset(name, seed=3, subsample=500)
    ds = prog.make_dataset(name, seed=3, subsample=500)
    assert np.array_equal(x, ds.x) and np.array_equal(y, ds.y)
    sizes = data.imbalanced_sizes(500, 10) if imbalanced else None
    assert sizes is None or sizes == prog.imbalanced_sizes(500, 10)
    ours = data.train_test_split_nodes(
        data.partition(x, y, 10, mode=mode, sizes=sizes, seed=3), seed=3)
    theirs = prog.train_test_split_nodes(
        prog.partition(ds, 10, mode=mode, sizes=sizes, seed=3,
                       device="cpu"), seed=3)
    for half_ours, half_theirs in zip(ours, theirs):
        for (xo, yo), nd in zip(half_ours, half_theirs):
            assert np.array_equal(xo, nd.x.numpy())
            assert np.array_equal(yo, nd.y.numpy())


def test_sqrt_proportional_matches_program():
    from repro_torch.core import NodeData
    from repro_torch.paper.fig3_imbalanced import sqrt_proportional_d

    sizes = [493, 1480, 2467, 3454, 4441, 5428, 6415, 7402, 8389, 9378]
    nodes = [NodeData(x=torch.zeros(1, n), y=torch.zeros(n)) for n in sizes]
    assert data.sqrt_proportional_d(sizes, 100) == sqrt_proportional_d(
        nodes, 100)


def test_inputs_come_from_the_seed():
    import json

    cfg = json.loads((ROOT / "perfbench/configs/table2-wave.json")
                     .read_text())
    cfg.update(N=300, dbar=5)
    for key in ("node_samples", "node_features"):
        cfg.pop(key)
    traffic = json.loads((ROOT / "perfbench/traffic/fit-closed-loop.json")
                         .read_text())
    seed = 2**31 + 12345
    a = fitloop.make_inputs(cfg, traffic, seed)
    b = fitloop.make_inputs(cfg, traffic, seed)
    c = fitloop.make_inputs(cfg, traffic, seed + 1)
    same = lambda u, v: all(np.array_equal(p, q) for p, q in zip(u, v))
    for pa, pb, pc in zip(a["pools"], b["pools"], c["pools"]):
        for (oa, ba), (ob, bb), (oc, bc) in zip(pa, pb, pc):
            assert np.array_equal(oa, ob) and np.array_equal(ba, bb)
            assert not np.array_equal(oa, oc)
    assert len(a["pools"]) == traffic["pools_per_node"]
    assert a["pools"][0][0][0].shape == (cfg["candidate_ratio"] * 5, 148)
    # the data is the configuration's: the same under every seed
    for key in ("train", "test"):
        for (xa, ya), (xc, yc) in zip(a[key], c[key]):
            assert same((xa, ya), (xc, yc))


def test_kernel_build_stays_in_the_checkout(monkeypatch):
    from perfbench import run

    monkeypatch.setenv("REPRO_TORCH_BUILD_ROOT", "/elsewhere")
    run._use_checkout(ROOT)
    import os

    assert os.environ["REPRO_TORCH_BUILD_ROOT"] == str(
        ROOT / "build" / "repro_torch")


@pytest.mark.parametrize("key, value", [("d", 147), ("N", 299),
                                        ("node_features", [5] * 9 + [6]),
                                        ("data", "file")])
def test_configuration_sizes_are_held_to_the_data(key, value):
    """Every size the configuration states is the generated data's: a
    stated size the data does not have is refused."""
    import json

    cfg = json.loads((ROOT / "perfbench/configs/table2-wave.json")
                     .read_text())
    cfg.update(N=300, dbar=5, node_samples=[30] * 10, node_features=[5] * 10)
    traffic = json.loads((ROOT / "perfbench/traffic/fit-closed-loop.json")
                         .read_text())
    fitloop.make_inputs(cfg, traffic, 1)
    cfg[key] = value
    with pytest.raises(ValueError):
        fitloop.make_inputs(cfg, traffic, 1)


def test_configuration_dtype_sets_the_staged_precision(tmp_path):
    from perfbench import run
    from perfbench.tests.tinycell import make_root

    root = make_root(tmp_path, dtype="float32")
    cell = run.resolve(root, "tiny-fit")
    prob = fitloop.build(cell.config, cell.traffic, 3, "cpu")
    assert prob.train_dev[0].x.dtype == torch.float32
    assert prob.pools_dev[0][0].omega.dtype == torch.float32
    assert prob.shape().word == 4
