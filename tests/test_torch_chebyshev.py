"""The port's Chebyshev acceleration (`repro_torch.core.acceleration` and
the Chebyshev-chain plain version) held against the JAX package, float64,
rtol 1e-9 and atol 1e-12·max|ref|: the dense closed form, the reference's
packed problem on every backend, the power-iteration interval with the
reference's start vectors, and the strictly-fewer-rounds property. The
port's own invariants (chunked == unchunked, Dy = 1 == scalar) bit for
bit.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core.acceleration as RA
from repro.kernels import ops as rops
from repro_torch import interop
from repro_torch.core import acceleration as TA
from repro_torch.dist import solve_batched, step_batched
from repro_torch.kernels import ops
from test_torch_async import problem
from test_torch_gpu import CASES, assert_close, dekrr_case, to_t
from test_torch_packed import packs

MU_MAX, MU_MIN = 0.9, -0.05
BACKENDS = ("torch", "cuda", "cuda_fused")


def _dense_problem(n=24, seed=0):
    """F(θ) = Mθ + b with a known eigendecomposition, spec(M) ⊂
    [−0.05, 0.9]."""
    rng = np.random.default_rng(seed)
    q, _ = np.linalg.qr(rng.standard_normal((n, n)))
    eigs = np.linspace(MU_MIN, MU_MAX, n)
    m = q @ np.diag(eigs) @ q.T
    b = rng.standard_normal(n)
    theta_star = np.linalg.solve(np.eye(n) - m, b)
    return q, eigs, torch.as_tensor(m), torch.as_tensor(b), theta_star


def _cheb_t(k, x):
    t_prev, t = np.ones_like(x), np.asarray(x, np.float64)
    if k == 0:
        return t_prev
    for _ in range(k - 1):
        t_prev, t = t, 2.0 * x * t - t_prev
    return t


def _closed_form_iterate(q, eigs, theta_star, k):
    """θ_k = θ* + Q σ_k(Λ_A) Qᵀ (θ₀ − θ*) for θ₀ = 0, A = I − M."""
    a_lo, b_hi = 1.0 - MU_MAX, 1.0 - MU_MIN
    d0, c0 = (a_lo + b_hi) / 2.0, (b_hi - a_lo) / 2.0
    lam_a = 1.0 - eigs
    sigma = _cheb_t(k, (d0 - lam_a) / c0) / _cheb_t(
        k, np.full_like(lam_a, d0 / c0))
    return theta_star + q @ (sigma * (q.T @ (-theta_star)))


def _buggy_coefficients(mu_max, mu_min, num_iters):
    """The generic β_k = (c·α_{k−1}/2)² applied at k = 1 too (¼(c/d)²)."""
    a_lo, b_hi = 1.0 - mu_max, 1.0 - mu_min
    d0, c0 = (a_lo + b_hi) / 2.0, (b_hi - a_lo) / 2.0
    alphas, betas = np.empty(num_iters), np.empty(num_iters)
    alpha_prev = None
    for k in range(num_iters):
        beta = 0.0 if k == 0 else (c0 * alpha_prev / 2.0) ** 2
        alpha = 1.0 / d0 if k == 0 else 1.0 / (d0 - beta / alpha_prev)
        alphas[k], betas[k] = alpha, beta
        alpha_prev = alpha
    return alphas, betas


# ------------------------------------------------------------ closed form
@pytest.mark.parametrize("k", [1, 2, 3, 5, 8, 12])
def test_chebyshev_matches_dense_closed_form(k):
    q, eigs, m, b, theta_star = _dense_problem()
    theta = TA.chebyshev_solve(lambda th: m @ th + b, torch.zeros_like(b),
                               MU_MAX, MU_MIN, num_iters=k)
    assert_close(theta, _closed_form_iterate(q, eigs, theta_star, k))
    want = RA.chebyshev_solve(lambda th: jnp.asarray(m.numpy()) @ th
                              + jnp.asarray(b.numpy()),
                              jnp.zeros(b.shape[0]), MU_MAX, MU_MIN,
                              num_iters=k)
    assert_close(theta, want)


def test_buggy_beta1_breaks_closed_form():
    q, eigs, m, b, theta_star = _dense_problem()
    for k, should_match in ((1, True), (2, False), (5, False)):
        al, be = _buggy_coefficients(MU_MAX, MU_MIN, k)
        theta, _, _ = TA.chebyshev_scan(lambda th: m @ th + b,
                                        torch.zeros_like(b),
                                        torch.as_tensor(al),
                                        torch.as_tensor(be))
        expect = _closed_form_iterate(q, eigs, theta_star, k)
        close = np.allclose(theta.numpy(), expect, rtol=1e-9, atol=1e-12)
        assert close == should_match, f"k={k}"


def test_coefficients_match_reference():
    al, be = TA.chebyshev_coefficients(0.9, 0.0, 3)
    d0, c0 = (0.1 + 1.0) / 2.0, (1.0 - 0.1) / 2.0
    assert be[0] == 0.0 and al[0] == 1.0 / d0
    np.testing.assert_allclose(be[1], 0.5 * (c0 / d0) ** 2, rtol=1e-15)
    np.testing.assert_allclose(be[2], (c0 * al[1] / 2.0) ** 2, rtol=1e-15)
    for args in ((0.9, 0.0, 3), (0.97, -0.2, 40)):
        for a, w in zip(TA.chebyshev_coefficients(*args),
                        RA.chebyshev_coefficients(*args)):
            np.testing.assert_array_equal(a, w)


# -------------------------------------------------------- packed problem
def _ref_v0(packed, seed):
    """The reference's power-iteration start vector, drawn by JAX."""
    return torch.as_tensor(np.array(jax.random.normal(
        jax.random.PRNGKey(seed), tuple(packed.d.shape), jnp.float64)))


@pytest.fixture(scope="module")
def interval():
    """(μ_min, μ_max) from 15 power iterations, port and reference, with
    the reference's start vectors."""
    _, ref_packed, _, packed, _ = problem("circulant")
    hi = TA.power_iteration_mu_max(packed, iters=15,
                                   v0=_ref_v0(packed, 0))
    lo = TA.power_iteration_mu_min(packed, hi, iters=15,
                                   v0=_ref_v0(packed, 1))
    want_hi = RA.power_iteration_mu_max(ref_packed, iters=15)
    want_lo = RA.power_iteration_mu_min(ref_packed, want_hi, iters=15)
    return hi, lo, want_hi, want_lo


def test_power_iteration_matches_reference(interval):
    hi, lo, want_hi, want_lo = interval
    np.testing.assert_allclose(hi, want_hi, rtol=1e-9)
    np.testing.assert_allclose(lo, want_lo, rtol=1e-9, atol=1e-12)
    assert -1.0 < lo < hi < 1.0


@pytest.mark.parametrize("backend", BACKENDS)
def test_spectral_interval_matches_reference(backend):
    _, ref_packed, _, packed, _ = problem("star")
    got = TA.estimate_spectral_interval(packed, 20, backend=backend,
                                        v0_max=_ref_v0(packed, 0),
                                        v0_min=_ref_v0(packed, 1))
    want = RA.estimate_spectral_interval(ref_packed, 20)
    np.testing.assert_allclose(got, want, rtol=1e-9)


def test_fixed_recurrence_needs_strictly_fewer_rounds(interval):
    hi, lo = interval[:2]
    _, ref_packed, _, packed, _ = problem("circulant")
    theta_star = solve_batched(packed, 3000)
    tol, max_rounds = 1e-5, 800
    plain, cheb = TA.rounds_to_tolerance(
        packed, theta_star, tol=tol, max_rounds=max_rounds, mu_max=hi,
        mu_min=lo)
    assert cheb < plain < max_rounds
    want = RA.rounds_to_tolerance(
        ref_packed, jnp.asarray(theta_star.numpy()), tol=tol,
        max_rounds=max_rounds, mu_max=hi, mu_min=lo)
    assert (plain, cheb) == tuple(want)

    # the pre-fix iteration: Δ-form body driven by the generic-β₁ table
    al, be = _buggy_coefficients(hi, lo, max_rounds)
    theta = delta = torch.zeros_like(packed.d)
    target = tol * float(torch.linalg.norm(theta_star))
    cheb_old = max_rounds
    for k in range(max_rounds):
        delta = al[k] * (step_batched(packed, theta) - theta) + be[k] * delta
        theta = theta + delta
        if float(torch.linalg.norm(theta - theta_star)) <= target:
            cheb_old = k + 1
            break
    assert cheb < cheb_old


def test_packed_backends_match_reference(interval):
    hi, lo = interval[:2]
    _, ref_packed, _, packed, _ = problem("circulant")
    want = RA.chebyshev_solve_packed(ref_packed, hi, lo, num_iters=30)
    got = {b: TA.chebyshev_solve_packed(packed, hi, lo, num_iters=30,
                                        backend=b) for b in BACKENDS}
    for backend, theta in got.items():
        assert_close(theta, want)
        assert not theta[packed.theta_mask == 0].any(), backend


def test_fused_chebyshev_chunk_invariant_bitwise(interval):
    hi, lo = interval[:2]
    packed = problem("circulant")[3]
    fused = TA.chebyshev_solve_packed(packed, hi, lo, num_iters=30)
    for chunk in (1, 7, 30, 64):
        assert torch.equal(TA.chebyshev_solve_packed(
            packed, hi, lo, num_iters=30, chunk_rounds=chunk), fused), chunk


def test_chebyshev_trace_matches_reference_and_recompute():
    iters, mu = 8, 0.9
    _, ref_packed, _, packed, _ = problem("circulant")
    want = RA.chebyshev_solve_packed(ref_packed, mu, num_iters=iters,
                                     return_trace=True)[1]
    prefixes = [TA.chebyshev_solve_packed(packed, mu, num_iters=k,
                                          backend="torch")
                for k in range(iters + 1)]
    steps = torch.stack([torch.max(torch.abs(prefixes[k + 1] - prefixes[k]))
                         for k in range(iters)])
    traces = {}
    for backend in BACKENDS:
        theta, trace = TA.chebyshev_solve_packed(
            packed, mu, num_iters=iters, backend=backend, return_trace=True)
        assert trace.residuals.shape == (iters,)
        assert_close(trace.residuals, want.residuals)
        assert_close(trace.residuals, steps)
        traces[backend] = trace.residuals
    for chunk in (1, 3, 64):
        got = TA.chebyshev_solve_packed(packed, mu, num_iters=iters,
                                        chunk_rounds=chunk,
                                        return_trace=True)[1]
        assert torch.equal(got.residuals, traces["cuda_fused"]), chunk


@pytest.mark.parametrize("backend", BACKENDS)
def test_multi_output_matches_reference(backend):
    ref3, port3 = packs(3)
    want = RA.chebyshev_solve_packed(ref3, 0.9, -0.1, num_iters=20,
                                     return_trace=True)
    got = TA.chebyshev_solve_packed(port3, 0.9, -0.1, num_iters=20,
                                    backend=backend, return_trace=True)
    assert got[0].shape == (6, 12, 3)
    assert_close(got[0], want[0])
    assert_close(got[1].residuals, want[1].residuals)


@pytest.mark.parametrize("backend", BACKENDS)
def test_trailing_unit_output_axis_is_bit_identical(backend):
    packed = problem("circulant")[3]
    trailing = interop.packed_from_arrays(
        **{**interop.packed_to_arrays(packed),
           "d": interop.to_numpy(packed.d)[..., None]}, device="cpu")
    scalar, st = TA.chebyshev_solve_packed(packed, 0.9, -0.1, num_iters=12,
                                           backend=backend,
                                           return_trace=True)
    multi, mt = TA.chebyshev_solve_packed(trailing, 0.9, -0.1, num_iters=12,
                                          backend=backend, return_trace=True)
    assert torch.equal(multi[..., 0], scalar)
    assert torch.equal(mt.residuals, st.residuals)


def test_chebyshev_solve_packed_rejects_bad_arguments():
    packed = problem("circulant")[3]
    with pytest.raises(ValueError, match="backend"):
        TA.chebyshev_solve_packed(packed, 0.9, backend="pallas_fused")
    with pytest.raises(ValueError, match="chunk_rounds"):
        TA.chebyshev_solve_packed(packed, 0.9, chunk_rounds=0)
    with pytest.raises(ValueError, match="backend"):
        TA.power_iteration_mu_max(packed, backend="xla")
    zero = TA.chebyshev_solve_packed(packed, 0.9, num_iters=0)
    assert not zero.any()


# ----------------------------------------------- the kernel's contract
@pytest.mark.parametrize("j,k,dfeat,dy,extra", CASES)
def test_cheb_chain_matches_reference(j, k, dfeat, dy, extra):
    """ops.dekrr_cheb_solve (its plain version on the CPU) against the
    reference wrapper in Pallas interpret mode, with the trace."""
    args = list(dekrr_case(j, k, dfeat, dy, extra, seed=j * 10 + k + dy))
    rng = np.random.default_rng(j + k)
    delta = rng.normal(size=args[1].shape)
    alphas, betas = rng.uniform(0.5, 1.5, 6), rng.uniform(0.0, 0.3, 6)
    args = args[:5] + [delta] + args[5:] + [alphas, betas]
    want = rops.dekrr_cheb_solve(*[jnp.asarray(a) for a in args],
                                 trace=True, interpret=True)
    got = ops.dekrr_cheb_solve(*to_t(args), trace=True)
    for a, w in zip(got, want):
        assert a.shape == w.shape
        assert_close(a, w)
    none = torch.zeros(0, dtype=torch.float64)
    zero = ops.dekrr_cheb_solve(*to_t(args[:9]), none, none, trace=True)
    assert torch.equal(zero[0], torch.as_tensor(args[4])[args[7]])
    assert zero[2].shape == (0, j)
    assert ops.launch_counts() == {n: 0 for n in ops.LAUNCHES}
