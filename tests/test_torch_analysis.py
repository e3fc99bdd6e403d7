"""The port's static checks (`repro_torch.analysis`): the Hopper
shared-memory budget (each estimate against its launch plan, an
over-budget shape refused before any staging on the CPU, the single
table of limits), the findings model and the conventions lint against
the reference's `repro.analysis`, the dispatch pass, and the CLI."""
import os
import textwrap

import numpy as np
import pytest
import torch

import repro.analysis.conventions as ref_conventions
import repro.analysis.report as ref_report
from conftest import REPO_ROOT
from repro.analysis.vmem import check_index_table as ref_check_index_table
from repro_torch import analysis
from repro_torch.analysis import conventions, dispatch, smem
from repro_torch.analysis.__main__ import main as analysis_main
from repro_torch.analysis.report import Finding, render_json, render_report
from repro_torch.kernels import ops
from repro_torch.kernels.decode_attention import (DECODE_SMEM_LIMIT,
                                                  decode_plan)
from repro_torch.kernels.rff_features import features_plan
from repro_torch.kernels.rff_gram import (GRAM_SMEM_LIMIT, F32GramPlan,
                                          WideGramPlan, gram_plan)

# The over-budget round: (K + 2)·Dy·D·8 = 6·8·640·8 = 245,760 B a block,
# past the 232,448 B a block may take on sm_90.
OVER = dict(j_nodes=2, k_slots=4, d_feat=640, dy=8)


# --------------------------------------------------------------------------
# The budget table and each estimate against its launch plan
# --------------------------------------------------------------------------
def test_limits_live_in_one_table():
    assert smem.SMEM_OPTIN_PER_BLOCK == 232_448
    assert GRAM_SMEM_LIMIT == smem.SMEM_LIMITS["rff_gram"] == 231_424
    assert DECODE_SMEM_LIMIT == smem.SMEM_LIMITS["flash_decode"] == 232_448
    assert smem.SMEM_LIMITS["dekrr_step"] == 232_448
    assert all(smem.SMEM_LIMITS[k] == 232_448 - smem.STATIC_SMEM[k]
               for k in smem.STATIC_SMEM)
    assert analysis.check_index_table is ops.check_index_table


@pytest.mark.parametrize("b,f,dim,n,item", [
    (10, 200, 148, 3180, 8), (1, 200, 148, 3180, 4), (2, 64, 5, 100, 8),
    (3, 560, 148, 1000, 8), (3, 561, 148, 1000, 8), (2, 1025, 20, 300, 4),
    (10, 600, 148, 3180, 8), (1, 17, 300, 33, 4)])
def test_gram_estimate_matches_plan(b, f, dim, n, item):
    est = smem.estimate_rff_gram(b=b, f=f, dim=dim, n=n, itemsize=item)
    plan = gram_plan(b, f, dim, n, item=item)
    assert est.fits
    if isinstance(plan, WideGramPlan):
        t, k = 64, 32
        assert est.bytes == max((2 * t * (k + 4) + 2 * k * (t + 4)) * item,
                                3 * (2 * t * (k + 4) + k) * item)
        assert est.grids[1] == (plan.tiles, plan.batch, 1)
    else:
        assert est.bytes == plan.smem_bytes and est.cluster == plan.cluster
        grids = ((plan.cluster * plan.slices, plan.groups, b),)
        if isinstance(plan, F32GramPlan):    # and the reducing launch
            grids += ((plan.reduce_ctas, b, 1),)
        assert est.grids == grids


@pytest.mark.parametrize("j,d_feat,n,item", [
    (10, 200, 512, 8), (10, 200, 512, 2), (1, 200, 8, 8), (3, 37, 13, 4),
    (10, 200, 16, 2)])
def test_features_estimate_matches_plan(j, d_feat, n, item):
    """f64/f32: grid (column tiles, row tiles, J); bf16: one grid over the
    J·D_max stacked rows."""
    plan = features_plan(j, d_feat, n, item=item)
    grid = ((-(-n // plan.cols), -(-(j * d_feat) // plan.rows), 1)
            if item == 2 else
            (-(-n // plan.cols), -(-d_feat // plan.rows), j))
    for est in (smem.estimate_rff_features(j=j, d_feat=d_feat, n=n,
                                           itemsize=item),
                smem.estimate_serve_wave(j=j, d_feat=d_feat, n=n,
                                         itemsize=item)):
        assert est.bytes == plan.smem_bytes and est.fits
        assert est.grids == (grid,)


@pytest.mark.parametrize("rows,groups,dh,s", [
    (128, 1, 64, 512), (16, 1, 64, 32_768), (4, 4, 80, 300),
    (16, 8, 128, 1024), (2, 2, 256, 100)])
def test_decode_estimate_matches_plan(rows, groups, dh, s):
    plan = decode_plan(rows, groups, dh)
    est = smem.estimate_flash_decode(rows=rows, groups=groups, dh=dh, s=s)
    assert est.bytes == plan.smem_bytes and est.fits
    assert est.grids == (plan.grid(s) + (1,),)


def test_round_estimates_and_path_shapes_fit():
    for name in ("dekrr_step", "dekrr_solve", "dekrr_async_solve",
                 "dekrr_cheb_solve"):
        est = getattr(smem, f"estimate_{name}")(j_nodes=10, k_slots=4,
                                                d_feat=200)
        assert est.bytes == 6 * 200 * 8 and est.cluster == 7
        assert est.grids == ((7, 10, 1),)
    assert all(est.fits for _, est in smem.path_estimates())
    assert smem.run_pass() == []


def test_over_budget_estimate_names_formula_and_limit():
    est = smem.estimate_dekrr_step(**OVER)
    assert est.bytes == 245_760 and not est.fits
    with pytest.raises(smem.SmemBudgetError) as info:
        est.check()
    msg = str(info.value)
    assert "(K+2)*Dy*D*itemsize" in msg and "(4+2)*8*640*8" in msg
    assert "245760" in msg and "232448" in msg and "dekrr_step" in msg
    assert isinstance(info.value, ValueError)


def test_grid_and_cluster_limits():
    est = smem.SmemEstimate("k", "f", "d", bytes=10, limit=100, cluster=9,
                            grids=((1, 70_000, 1),))
    problems = est.problems()
    assert len(problems) == 2 and not est.fits
    assert smem.SmemEstimate("k", "f", "d", bytes=10, limit=100,
                             grids=((0, 0, 0),)).fits


# --------------------------------------------------------------------------
# The wrappers refuse an over-budget shape before staging, on the CPU
# --------------------------------------------------------------------------
def _over_operands():
    j, k, d, dy = (OVER[key] for key in ("j_nodes", "k_slots", "d_feat",
                                          "dy"))
    z = lambda *shape: torch.zeros(shape, dtype=torch.float64)
    nbr_idx = torch.tensor([[1] * k, [0] * k], dtype=torch.int32)
    return dict(g=z(j, d, d), d=z(j, d, dy), s=z(j, d, d), p=z(j, k, d, d),
                theta=z(j, d, dy), nbr_idx=nbr_idx,
                self_idx=torch.arange(j, dtype=torch.int32),
                nbr_mask=torch.ones((j, k), dtype=torch.int32))


def _call(kernel, a):
    common = (a["g"], a["d"], a["s"], a["p"], a["theta"])
    if kernel == "dekrr_step":
        return ops.dekrr_step(*common, a["nbr_idx"], a["self_idx"],
                              a["nbr_mask"])
    if kernel == "dekrr_solve":
        return ops.dekrr_solve(*common, a["nbr_idx"], a["self_idx"],
                               a["nbr_mask"], num_rounds=3)
    if kernel == "dekrr_async_solve":
        j, k = a["nbr_idx"].shape
        return ops.dekrr_async_solve(
            *common, a["theta"].clone(),
            torch.zeros((j, k) + tuple(a["d"].shape[1:]),
                        dtype=torch.float64),
            a["nbr_idx"], a["nbr_mask"],
            torch.ones((3, j), dtype=torch.int32),
            torch.zeros(3, dtype=torch.float64))
    return ops.dekrr_cheb_solve(
        *common, torch.zeros_like(a["d"]), a["nbr_idx"], a["self_idx"],
        a["nbr_mask"], torch.ones(3, dtype=torch.float64),
        torch.zeros(3, dtype=torch.float64))


@pytest.mark.parametrize("kernel", ["dekrr_step", "dekrr_solve",
                                    "dekrr_async_solve", "dekrr_cheb_solve"])
def test_over_budget_round_refused_before_staging(kernel, monkeypatch):
    a = _over_operands()

    def staged(*args, **kw):
        raise AssertionError("operands were staged before the budget check")

    monkeypatch.setattr(ops, "_flatten_dy", staged)
    dispatches, launches = ops.dispatch_counts(), ops.launch_counts()
    limit = smem.SMEM_LIMITS[kernel]
    with pytest.raises(smem.SmemBudgetError,
                       match=f"245760 bytes a block exceeds the {limit}"):
        _call(kernel, a)
    assert ops.dispatch_counts() == dispatches
    assert ops.launch_counts() == launches


def test_over_budget_solve_has_zero_dispatches():
    from repro_torch.dist import PackedProblem, solve_batched
    from repro_torch.obs import dispatch_count

    a = _over_operands()
    packed = PackedProblem(g=a["g"], d=a["d"], s=a["s"], p=a["p"],
                           theta_mask=torch.ones(2, 640,
                                                 dtype=torch.float64),
                           nbr_idx=a["nbr_idx"],
                           nbr_mask=a["nbr_mask"].double())
    for backend in ("cuda", "cuda_fused"):
        before = ops.dispatch_counts()
        with pytest.raises(smem.SmemBudgetError):
            solve_batched(packed, 4, backend=backend)
        assert ops.dispatch_counts() == before
    assert dispatch_count(solve_batched, packed, 4, backend="torch") == \
        (0, True)


def test_serve_wave_checked_before_featurize(monkeypatch):
    """A cuda wave runs `_check_wave_smem` before anything is featurized."""
    from repro_torch.serve import dekrr as serve_dekrr
    from repro_torch.stream import ServeSnapshot, StalenessBound

    gen = torch.Generator().manual_seed(0)
    from repro_torch.core import sample_rff
    fmaps = tuple(sample_rff(gen, 3, 6, 1.0) for _ in range(2))
    snap = ServeSnapshot(feature_maps=fmaps,
                         theta=tuple(torch.ones(6, dtype=torch.float64)
                                     for _ in fmaps),
                         staleness=StalenessBound(0, 0, 0, 0.0))
    seen = []
    real = smem.estimate_serve_wave

    def spy(**kw):
        seen.append(kw)
        return real(**kw)

    monkeypatch.setattr(smem, "estimate_serve_wave", spy)
    eng = serve_dekrr.DeKRRServeEngine(snap, batch_size=4, backend="cuda")
    eng.run([serve_dekrr.KernelQuery(uid=i, x=np.zeros(3)) for i in range(3)])
    assert seen == [dict(j=2, d_feat=6, n=8, itemsize=8, sms=132)]

    def refuse(**kw):
        raise smem.SmemBudgetError("refused")

    monkeypatch.setattr(smem, "estimate_serve_wave", refuse)
    monkeypatch.setattr(serve_dekrr, "answer_wave", lambda *a: pytest.fail(
        "the wave was featurized before its budget check"))
    with pytest.raises(smem.SmemBudgetError):
        eng.run([serve_dekrr.KernelQuery(uid=0, x=np.zeros(3))])


@pytest.mark.parametrize("table,size,lo", [
    ([0, 1, 2], 3, 0), ([0, 3], 3, 0), ([-1, 0], 3, 0), ([], 0, 0),
    ([1, 2], 3, 1), ([0, 2], 3, 1), (np.array([0.0, 1.0]), 3, 0)])
def test_check_index_table_matches_reference(table, size, lo):
    def outcome(fn):
        try:
            fn("t", table, size, lo=lo)
        except ValueError as exc:
            return str(exc).split(":")[0] + ":" + str(exc).split(":")[1][:30]
        return None

    got, want = outcome(smem.check_index_table), outcome(
        ref_check_index_table)
    assert (got is None) == (want is None)


# --------------------------------------------------------------------------
# Findings and their rendering
# --------------------------------------------------------------------------
FINDINGS = [("budget", "V001", "k[D=640]", "over budget", "error"),
            ("conventions", "R005", "a.py:3", "bare except", "error"),
            ("dispatch", "J002", "ep", "off contract", "warning")]


@pytest.mark.parametrize("fields", FINDINGS, ids=lambda f: f[1])
def test_finding_renders_as_reference(fields):
    port, ref = Finding(*fields), ref_report.Finding(*fields)
    assert port.render() == ref.render()
    assert port.to_json() == ref.to_json()


def test_reports_render_as_reference():
    port = [Finding(*f) for f in FINDINGS]
    ref = [ref_report.Finding(*f) for f in FINDINGS]
    assert render_report(port, title="t") == ref_report.render_report(
        ref, title="t")
    assert render_report([]) == "== repro_torch.analysis ==\nclean: no " \
        "findings"
    assert render_json(port, extra={"passes": ["budget"]}) == \
        ref_report.render_json(ref, extra={"passes": ["budget"]})


# --------------------------------------------------------------------------
# Conventions: the ported rules find what the reference's find
# --------------------------------------------------------------------------
SEEDS = {
    "R001": ("def solve_batched(packed, num_iters):\n    return None\n",
             None),
    "R004": (textwrap.dedent("""
        from repro.kernels.rff_gram import rff_gram_pallas

        def direct(a, b, x, y, m):
            return rff_gram_pallas(a, b, x, y, m, scale=1.0,
                                   block_n=128, interpret=True)
    """), textwrap.dedent("""
        from repro_torch.kernels.rff_gram import rff_gram_cuda

        def direct(a, b, x, y, m):
            return rff_gram_cuda(a, b, x, y, m, None, None,
                                 scale=1.0)
    """)),
    "R005": ("try:\n    pass\nexcept:\n    pass\n", None),
    "R005-waived": ("try:\n    pass\nexcept:  # analysis: ignore[R005]\n"
                    "    pass\n", None),
    "R006": (textwrap.dedent("""
        import time

        def f():
            t0 = time.perf_counter()
            t1 = time.time()
            time.sleep(0)
            return t1 - t0
    """), None),
}


def _lint(linter, tmp_path, package, sub, source):
    path = tmp_path / "src" / package / sub / "seed.py"
    path.parent.mkdir(parents=True, exist_ok=True)
    return [(f.rule, int(f.where.rsplit(":", 1)[1]))
            for f in linter.lint_file(str(path), source=source,
                                      repo_root=str(tmp_path))]


@pytest.mark.parametrize("sub", ["dist", "obs", "kernels"])
@pytest.mark.parametrize("seed", sorted(SEEDS))
def test_conventions_seeds_match_reference(seed, sub, tmp_path):
    ref_src, port_src = SEEDS[seed]
    want = _lint(ref_conventions, tmp_path, "repro", sub, ref_src)
    got = _lint(conventions, tmp_path, "repro_torch", sub,
                port_src or ref_src)
    assert got == want
    if seed == "R006":
        assert got == ([] if sub == "obs" else [("R006", 5), ("R006", 6)])


def test_live_port_lints_clean():
    findings = conventions.run_pass(conventions.default_paths(REPO_ROOT),
                                    repo_root=REPO_ROOT)
    assert findings == [], render_report(findings)
    paths = conventions.default_paths(REPO_ROOT)
    assert paths[0].endswith(os.path.join("src", "repro_torch"))
    assert any(p.endswith("test_torch_analysis.py") for p in paths)


# --------------------------------------------------------------------------
# The dispatch pass and the CLI
# --------------------------------------------------------------------------
def test_dispatch_pass_clean_and_catches_a_violation():
    eps = dispatch.entry_points()
    assert len(eps) == 35
    assert dispatch.run_pass() == []
    bad = dispatch.EntryPoint("seeded", eps[-1].run, 2)
    (finding,) = dispatch.check_entry_point(bad)
    assert (finding.rule, finding.where) == ("J002", "seeded")
    assert "1 kernel dispatch(es)" in finding.message


def test_spmd_dispatch_cases_and_a_violation():
    cases = dispatch.spmd_entry_points()
    assert len(cases) == 24
    assert {c["expected"] for c in cases} == {0, dispatch.ROUNDS}
    ok = [[{"dispatches": c["expected"]} for c in cases]
          for _ in range(dispatch.SPMD_NODES)]
    assert dispatch.check_spmd_results(cases, ok) == []
    ok[2][5] = {"dispatches": 7}
    ok[3][9] = {"error": "raised"}
    found = dispatch.check_spmd_results(cases, ok)
    assert [(f.rule, f.where) for f in found] == [
        ("J002", cases[5]["name"]), ("J002", cases[9]["name"])]
    assert "[5, 5, 7, 5]" in found[0].message or \
        "[0, 0, 7, 0]" in found[0].message


def test_cli_exits_zero_on_the_live_tree(capsys):
    assert analysis_main([]) == 0
    out = capsys.readouterr().out
    assert "clean: no findings" in out
    for name in ("budget", "dispatch", "conventions"):
        assert f"{name}: " in out


def test_cli_json_and_nonzero_on_error(tmp_path, capsys):
    import json

    bad = tmp_path / "bad.py"
    bad.write_text("try:\n    pass\nexcept:\n    pass\n")
    assert analysis_main(["--pass", "conventions", "--format", "json",
                          "--repo-root", str(tmp_path), str(bad)]) == 1
    doc = json.loads(capsys.readouterr().out)
    assert doc["num_errors"] == 1 and doc["passes"] == ["conventions"]
