"""The output check's control and faults must come out as not correct.

The control is the reference computed in float32 put in the program's
place; each fault is planted in the program's timed path and the run's
own check must say ``correct: false``. (A fault across chips does not
exist in these one-chip cells; the nodes' coupling is planted instead.)
"""
import numpy as np
import pytest
import torch

from perfbench import check, reference, run
from perfbench.generators import fitloop
from perfbench.tests.tinycell import make_root


@pytest.mark.parametrize("base", ["table2-wave", "fig4-twitter-imbalanced"])
def test_float32_control_is_not_correct(tmp_path, base):
    root = make_root(tmp_path, base=base)
    cell = run.resolve(root, "tiny-fit")
    prob = fitloop.build(cell.config, cell.traffic, 11, "cpu")
    limits = run.load_limits(root, "tiny-fit")
    for i in range(3):
        args = (prob.pools[prob.pool_of(i)], prob.train, prob.test,
                prob.dims, prob.neighbours)
        kw = dict(c_nei=prob.c_of(i), c_self_ratio=5.0, lam=1e-6,
                  num_rounds=64)
        want = reference.pad(reference.fit(*args, **kw), max(prob.dims))
        low = reference.pad(reference.fit(*args, dtype=np.float32, **kw),
                            max(prob.dims))
        numbers = check.compare(low, want)
        assert not run.verdict(numbers, limits), numbers
        assert run.verdict(check.compare(want, want), limits)


def _unchanged_state(mp):
    import repro_torch.dist as dist

    real = dist.solve_batched

    def solve(packed, num_iters, *a, **kw):
        theta, rounds = real(packed, num_iters, *a, **kw)
        return torch.zeros_like(theta), rounds
    mp.setattr(dist, "solve_batched", solve)


def _half_batch(mp):
    import repro_torch.dist as dist
    from repro_torch.core import NodeData

    real = dist.pack_problem

    def pack(solver, **kw):
        solver.data = [NodeData(x=nd.x[:, : nd.x.shape[1] // 2],
                                y=nd.y[: nd.y.shape[0] // 2])
                       for nd in solver.data]
        solver.N = sum(nd.num_samples for nd in solver.data)
        return real(solver, **kw)
    mp.setattr(dist, "pack_problem", pack)


def _no_coupling(mp):
    import repro_torch.dist as dist

    real = dist.pack_problem

    def pack(solver, **kw):
        packed = real(solver, **kw)
        packed.p = torch.zeros_like(packed.p)
        return packed
    mp.setattr(dist, "pack_problem", pack)


def _altered_answer(mp):
    from repro_torch.core import DeKRRSolver

    real = DeKRRSolver.predict

    def predict(self, theta, x, node=None):
        out = real(self, theta, x, node=node)
        if node == 3:
            out = out.clone()
            out[0] += 1e-6 * float(out.abs().max())
        return out
    mp.setattr(DeKRRSolver, "predict", predict)


def _altered_selection(mp):
    import repro_torch.core as core

    real = core.select_features

    def select(*a, candidates=None, **kw):
        fm = real(*a, candidates=candidates, **kw)
        fm.omega = fm.omega.clone()
        fm.omega[-1] = candidates.omega[-1]
        fm.bias = fm.bias.clone()
        fm.bias[-1] = candidates.bias[-1]
        return fm
    mp.setattr(core, "select_features", select)


@pytest.mark.parametrize("fault", [_unchanged_state, _half_batch,
                                   _no_coupling, _altered_answer,
                                   _altered_selection])
def test_planted_fault_is_not_correct(tmp_path, monkeypatch, fault):
    root = make_root(tmp_path)
    fault(monkeypatch)
    res, lines = run.run_cell(root, "tiny-fit", 2**31 + 3, 0.2, False,
                              device="cpu")
    assert res["correct"] is False, res["check"]


def test_unplanted_run_is_correct(tmp_path):
    root = make_root(tmp_path)
    res, _ = run.run_cell(root, "tiny-fit", 2**31 + 3, 0.2, False,
                          device="cpu")
    assert res["correct"] is True, res["check"]
