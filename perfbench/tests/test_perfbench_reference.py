"""The plain reference against the program, at a small size.

The reference imports nothing of the program; these tests do, to hold
the two against each other: piece by piece against the program's
ragged solver, and whole fits of the timed path on the CPU (the
kernels' plain versions) and, marked ``gpu``, on the card."""
import ast

import numpy as np
import pytest
import torch

from perfbench import check, reference
from perfbench.generators import fitloop
from perfbench.reference import dekrr as ref
from perfbench.tests.tinycell import ROOT, make_root


def _problem(tmp_path, base, device="cpu", **kw):
    from perfbench import run

    root = make_root(tmp_path, base=base, **kw)
    cell = run.resolve(root, "tiny-fit")
    return fitloop.build(cell.config, cell.traffic, 2**31 + 99, device)


def test_reference_imports_nothing_of_the_program():
    for path in (ROOT / "perfbench" / "reference").glob("*.py"):
        tree = ast.parse(path.read_text())
        names = {a.name.split(".")[0] for n in ast.walk(tree)
                 if isinstance(n, ast.Import) for a in n.names}
        names |= {n.module.split(".")[0] for n in ast.walk(tree)
                  if isinstance(n, ast.ImportFrom) and n.module}
        assert names <= {"__future__", "os", "concurrent", "numpy",
                         "perfbench"}, (path, names)


@pytest.mark.parametrize("base", ["table2-wave", "fig4-twitter-imbalanced"])
def test_pieces_match_the_programs_ragged_solver(tmp_path, base):
    from repro_torch.core import DeKRRConfig, DeKRRSolver, select_features

    prob = _problem(tmp_path, base)
    pool = prob.pools[1]
    c = prob.c_of(1)
    sel, maps = [], []
    for j, (om, b) in enumerate(pool):
        idx = ref.energy_select(om, b, *prob.train[j], prob.dims[j])
        fm = select_features(None, om.shape[1], prob.dims[j], 1.0,
                             prob.train_dev[j].x, prob.train_dev[j].y,
                             candidates=prob.pools_dev[1][j])
        assert np.array_equal(fm.omega.numpy(), om[idx])
        sel.append(fm)
        maps.append((om[idx], b[idx]))
    g, d, s, p = ref.aux(maps, prob.train, prob.neighbours, c, 5.0, 1e-6)
    solver = DeKRRSolver(prob.topology, sel, prob.train_dev,
                         DeKRRConfig(lam=1e-6, c_nei=c), device="cpu")
    aux = solver.aux
    for j, nb in enumerate(prob.neighbours):
        np.testing.assert_allclose(g[j], aux.g[j].numpy(), rtol=1e-9,
                                   atol=1e-9 * np.abs(g[j]).max())
        np.testing.assert_allclose(d[j], aux.d[j].numpy(), rtol=1e-12)
        np.testing.assert_allclose(s[j], aux.s[j].numpy(), rtol=1e-12)
        for k, q in enumerate(nb):
            np.testing.assert_allclose(p[j][k], aux.p[j][q].numpy(),
                                       rtol=1e-11, atol=1e-15)
    theta = ref.rounds(g, d, s, p, prob.neighbours, 7)
    state = solver.solve(num_iters=7)
    for j in range(len(theta)):
        np.testing.assert_allclose(theta[j], state.theta[j].numpy(),
                                   rtol=1e-9, atol=1e-12)
        pred = theta[j] @ ref.features(*maps[j], prob.test[j][0])
        np.testing.assert_allclose(
            pred, solver.predict(state.theta, prob.test_dev[j],
                                 node=j).numpy(), rtol=1e-9, atol=1e-12)


@pytest.mark.parametrize("base", ["table2-wave", "fig4-twitter-imbalanced"])
def test_timed_path_matches_reference_on_cpu(tmp_path, base):
    prob = _problem(tmp_path, base)
    for i in range(3):
        out = fitloop.to_host(prob, fitloop.fit(prob, i))
        want = reference.pad(reference.fit(
            prob.pools[prob.pool_of(i)], prob.train, prob.test, prob.dims,
            prob.neighbours, c_nei=out["c"], c_self_ratio=5.0, lam=1e-6,
            num_rounds=out["rounds"]), max(prob.dims))
        numbers = check.compare(out, want)
        assert numbers["select_mismatch"] == 0
        assert max(numbers[k] for k in check.NUMBERS[1:]) < 1e-11, numbers


@pytest.mark.gpu
@pytest.mark.parametrize("base", ["table2-wave", "fig4-twitter-imbalanced"])
def test_timed_path_matches_reference_on_card(tmp_path, base):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    prob = _problem(tmp_path, base, device="cuda")
    from perfbench import run

    limits = run.load_limits(tmp_path / "root", "tiny-fit")
    for i in range(3):
        out = fitloop.to_host(prob, fitloop.fit(prob, i))
        want = reference.pad(reference.fit(
            prob.pools[prob.pool_of(i)], prob.train, prob.test, prob.dims,
            prob.neighbours, c_nei=out["c"], c_self_ratio=5.0, lam=1e-6,
            num_rounds=out["rounds"]), max(prob.dims))
        assert run.verdict(check.compare(out, want), limits)
