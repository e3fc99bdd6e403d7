"""The port's accel, kernel and analysis benches against the reference's
`benchmarks/accel_bench.py`, `benchmarks/kernel_bench.py` and
`benchmarks/analysis_bench.py` on the CPU: the accel ladder on the
reference's problem (its own DDRF maps carried across, one spectral
interval fed to both), the dispatch counts against the reference's J002
counts, the kernel bench's analytic terms and its plain `rff_gram`
against the reference's oracle, and the analysis bench on a planted
finding."""
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core.acceleration as RA
from conftest import REPO_ROOT
from repro.dist import comm_bytes_per_round as ref_comm_bytes
from repro.kernels.ref import rff_gram_ref as ref_rff_gram
from repro_torch import interop
from repro_torch.analysis.smem import SMEM_OPTIN_PER_BLOCK
from repro_torch.bench import accel_bench, analysis_bench, kernel_bench
from repro_torch.kernels import ops

CPU = "cpu"
SUB = 600
BACKEND_NAMES = {"xla": "torch", "pallas": "cuda",
                 "pallas_fused": "cuda_fused"}


@pytest.fixture(scope="module")
def ref_bench():
    """The reference's `benchmarks/` modules, imported from the repository
    root, the shared harness cut to SUB samples a dataset."""
    mp = pytest.MonkeyPatch()
    mp.syspath_prepend(REPO_ROOT)
    import benchmarks.accel_bench as AB
    import benchmarks.common as BC
    import benchmarks.kernel_bench as KB
    mp.setattr(BC, "SUBSAMPLE", SUB)
    yield AB, KB
    mp.undo()


def port_fmap(f):
    return interop.feature_map_from_arrays(
        np.asarray(f.omega), np.asarray(f.bias), f.kind, device=CPU)


# --------------------------------------------------------------------------
# accel: the ladder and the dispatch counts
# --------------------------------------------------------------------------
def test_accel_ladder_equals_the_reference(ref_bench):
    """Rounds to each fast tolerance and the bytes of a round on the
    reference's problem and maps, both sides fed one interval. A count
    may differ by one only where the error at that round lies within
    1e-9 (relative) of the tolerance's target, and the test says so."""
    AB, _ = ref_bench
    solver, packed = AB._build_problem("houses", 30, 0.005)
    exact = solver.solve_exact()
    dmax = packed.d.shape[1]
    theta_star = jnp.stack([jnp.pad(t, (0, dmax - t.shape[0]))
                            for t in exact.theta])
    lo, hi = (float(v) for v in RA.estimate_spectral_interval(packed))
    got = accel_bench.run(fast=True, device=CPU, subsample=SUB,
                          fmaps=[port_fmap(f) for f in solver.feature_maps],
                          interval=(lo, hi))
    assert got["bytes_per_round"] == ref_comm_bytes(packed, "ppermute")
    assert got["spectral_interval"] == [lo, hi]
    target_norm = float(jnp.linalg.norm(theta_star))
    for row in got["rounds_to_tolerance"]:
        want = RA.rounds_to_tolerance(packed, theta_star, tol=row["tol"],
                                      mu_max=hi, mu_min=lo)
        for (key, curve), w in zip(
                (("rounds_plain", RA._plain_error_curve),
                 ("rounds_chebyshev", None)), want):
            if row[key] == w:
                continue
            # off by one: the crossing round's error sits on the target
            assert abs(row[key] - w) == 1, (key, row[key], w)
            if curve is None:
                al, be = RA.chebyshev_coefficients(hi, lo, 5000)
                errs = RA._cheb_error_curve(packed, theta_star,
                                            jnp.asarray(al), jnp.asarray(be),
                                            backend="xla")
            else:
                errs = curve(packed, theta_star, max_rounds=5000,
                             backend="xla")
            err = float(errs[min(row[key], w) - 1])
            target = row["tol"] * target_norm
            assert abs(err - target) <= 1e-9 * target, \
                f"{key} at tol {row['tol']}: {row[key]} vs {w}, and the " \
                f"error {err!r} is not within 1e-9 of the target {target!r}"
        assert row["comm_plain_bytes"] == row["rounds_plain"] * \
            got["bytes_per_round"]
    assert got["round_dispatches"]["cuda_fused"] == {
        "chebyshev_solve_packed": 1, "async_solve_batched": 1}
    assert got["theta_max_abs_diff_vs_cuda"]["cuda_fused"] == 0.0


@pytest.mark.parametrize("num_iters", [10, 30])
def test_accel_dispatch_counts_equal_the_reference_j002(ref_bench,
                                                        num_iters):
    AB, _ = ref_bench
    want = {BACKEND_NAMES[b]: v
            for b, v in AB._dispatch_counts(num_iters).items()}
    assert accel_bench.dispatch_counts(num_iters, torch.device(CPU)) == want


# --------------------------------------------------------------------------
# kernel: the analytic terms and the plain Gram build
# --------------------------------------------------------------------------
@pytest.mark.parametrize("case", kernel_bench.CASES,
                         ids=lambda c: "D{}_d{}_N{}".format(*c))
def test_kernel_analytic_flops_and_bytes_equal_the_reference(ref_bench,
                                                             case):
    _, KB = ref_bench
    flops, hbm, smem, ai, bound_s = kernel_bench.analytic(*case)
    r_flops, r_hbm, _, r_ai, _ = KB.analytic(*case)
    assert (flops, hbm) == (r_flops, r_hbm)
    assert ai == r_ai
    assert 0 < smem <= SMEM_OPTIN_PER_BLOCK
    assert bound_s == max(flops / 67e12, hbm / 3.35e12)


def test_kernel_plain_gram_equals_the_reference_oracle():
    """The first CASE in f32 through `ops.rff_gram` on CPU tensors (the
    plain version), against `repro.kernels.ref.rff_gram_ref` on the same
    numpy draws: rtol 1e-4 with an atol of 1e-4·max|ref| (f32 sums over
    N = 10,000 in another order)."""
    d_feat, d_in, n = kernel_bench.CASES[0]
    rng = np.random.default_rng(0)
    arrays = (rng.standard_normal((d_feat, d_in)), rng.uniform(size=d_feat),
              rng.uniform(size=(d_in, n)), rng.standard_normal(n))
    arrays = [a.astype(np.float32) for a in arrays]
    scale = math.sqrt(2.0 / d_feat)
    before = ops.dispatch_counts()["rff_gram"]
    got = ops.rff_gram(*(torch.as_tensor(a) for a in arrays), scale=scale)
    assert ops.dispatch_counts()["rff_gram"] == before + 1
    want = ref_rff_gram(*(jnp.asarray(a) for a in arrays), scale=scale)
    for g, w in zip(got, want):
        w = np.asarray(w)
        assert g.dtype == torch.float32
        np.testing.assert_allclose(g.numpy(), w, rtol=1e-4,
                                   atol=1e-4 * np.abs(w).max())


def test_kernel_bench_on_the_cpu_times_the_plain_version(capsys):
    res = kernel_bench.run(fast=True, device=CPU)
    (row,) = res["rows"]
    assert res["plain"] is True and row["ms"] is None
    assert row["plain_ms"] > 0 and row["fits_smem"]
    assert row["name"] == "kernel/rff_gram/D100_d8_N10000"
    assert row["name"] + "," in capsys.readouterr().out


# --------------------------------------------------------------------------
# analysis: a planted finding
# --------------------------------------------------------------------------
def test_analysis_bench_raises_on_a_planted_finding(tmp_path, capsys):
    """A bare ``except:`` (R005) in a linted file fails the bench; the
    budget and dispatch passes still report their rows, clean."""
    bad = tmp_path / "planted.py"
    bad.write_text("try:\n    pass\nexcept:\n    pass\n")
    with pytest.raises(RuntimeError, match="1 analysis finding"):
        analysis_bench.run(paths=[str(bad)], repo_root=str(tmp_path))
    out = capsys.readouterr().out
    for row in ("analysis/budget,", "analysis/dispatch,"):
        line = next(ln for ln in out.splitlines() if ln.startswith(row))
        assert line.endswith(",0 findings")
    assert "analysis/conventions," in out and "R005" in out
    assert "analysis/clean,0.0,0" in out
