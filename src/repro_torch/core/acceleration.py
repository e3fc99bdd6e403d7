"""Chebyshev semi-iterative acceleration of the Eq. 19 fixed-point iteration.

The counterpart of `repro.core.acceleration`. The paper's solver is the
stationary iteration θ^{k+1} = F(θ^k) = Mθ^k + b, whose error contracts
at ρ(M). Chebyshev iteration on (I − M)θ = b with spec(M) ⊂ [μ_min, μ_max]
contracts at (√κ − 1)/(√κ + 1), κ = (1 − μ_min)/(1 − μ_max), with one
application of F — one neighbour exchange — per round, like Algorithm 1.

Every consumer shares one precomputed (α, β) table
(`chebyshev_coefficients`, where β₁ = ½(c/d)² — not the generic
(c·α₀/2)² = ¼(c/d)²): the host loop `chebyshev_scan` (the "torch" and
"cuda" backends of `chebyshev_solve_packed`, one F-application per round
through `step_batched`) and the Chebyshev chain kernel
(``backend="cuda_fused"``, `repro_torch.kernels.ops.dekrr_cheb_solve`:
one launch per ``chunk_rounds`` slice of the schedule, the search
direction kept on the device between rounds).

Both interval ends come from power iteration on the homogeneous part of
F: μ_max directly, μ_min through the shifted operator μ_max·I − M. The
reference draws the start vectors with `jax.random`; here they are an
argument (``v0``) or drawn from a `torch.Generator` seeded with ``seed``.
`estimate_spectral_interval` widens both ends, because the acceleration
polynomial grows outside its interval.
"""
from __future__ import annotations

from typing import Callable

import numpy as np
import torch

from repro_torch.dist.dekrr_spmd import (PackedProblem, _check_backend,
                                         step_batched)
from repro_torch.obs.trace import SolveTrace

__all__ = [
    "chebyshev_coefficients",
    "chebyshev_scan",
    "chebyshev_solve",
    "chebyshev_solve_packed",
    "estimate_spectral_interval",
    "power_iteration_mu_max",
    "power_iteration_mu_min",
    "rounds_to_tolerance",
    "safe_mu",
]


def safe_mu(mu_est: float, margin: float = 0.02) -> float:
    """Inflate a power-iteration estimate of ρ(M): Chebyshev tolerates an
    over-estimate of μ_max (a slightly slower rate) but diverges when the
    top eigenvalue lies outside [μ_min, μ_max]."""
    return min(mu_est * (1.0 + margin) + 0.002, 0.99999)


def _mask_like(packed: PackedProblem, v: torch.Tensor) -> torch.Tensor:
    """theta_mask broadcast against a θ-shaped tensor."""
    mask = packed.theta_mask
    return mask if v.ndim == mask.ndim else mask[..., None]


def _start_vector(packed: PackedProblem, seed: int,
                  v0: torch.Tensor | None) -> torch.Tensor:
    """The power iteration's start vector: ``v0`` as given, or a normal
    draw from a `torch.Generator` seeded with ``seed``; masked to the live
    coordinates."""
    if v0 is None:
        gen = torch.Generator(device=packed.device).manual_seed(seed)
        v0 = torch.randn(tuple(packed.d.shape), generator=gen,
                         dtype=packed.d.dtype, device=packed.device)
    v0 = v0.to(dtype=packed.d.dtype, device=packed.device)
    return v0 * _mask_like(packed, v0)


def _power_iteration_lam(packed, v0, shift, *, iters, backend,
                         shifted) -> float:
    """Power iteration on the homogeneous part of F (b cancels in the
    difference F(v) − F(0)); v is normalized before the loop, so ‖v‖ = 1
    on every iterate and λ = ‖M v‖. One host read, at the end."""
    b = step_batched(packed, torch.zeros_like(packed.d), backend=backend)
    v = v0 / torch.clamp(torch.linalg.norm(v0), min=1e-30)
    lam = packed.d.new_zeros(())
    for _ in range(iters):
        mv = step_batched(packed, v, backend=backend) - b      # M v
        fv = shift * v - mv if shifted else mv
        lam = torch.linalg.norm(fv)
        v = fv / torch.clamp(lam, min=1e-30)
    return float(lam)


def power_iteration_mu_max(packed: PackedProblem, iters: int = 50,
                           seed: int = 0, backend: str = "cuda", *,
                           v0: torch.Tensor | None = None) -> float:
    """Estimate ρ(M) by power iteration; each step is one Eq. 19 round
    (`step_batched`'s ``backend``) and one global norm."""
    _check_backend(backend)
    return _power_iteration_lam(packed, _start_vector(packed, seed, v0),
                                0.0, iters=iters, backend=backend,
                                shifted=False)


def power_iteration_mu_min(packed: PackedProblem, mu_max: float,
                           iters: int = 50, seed: int = 1,
                           backend: str = "cuda", *,
                           v0: torch.Tensor | None = None) -> float:
    """Estimate the bottom of spec(M) by power iteration on μ_max·I − M
    (its top eigenvalue is μ_max − μ_min). The spectrum is real but not
    nonnegative in general, and Chebyshev diverges if the interval misses
    its negative tail."""
    _check_backend(backend)
    lam = _power_iteration_lam(packed, _start_vector(packed, seed, v0),
                               mu_max, iters=iters, backend=backend,
                               shifted=True)
    return mu_max - lam


def estimate_spectral_interval(packed: PackedProblem, iters: int = 60,
                               backend: str = "cuda", *,
                               v0_max: torch.Tensor | None = None,
                               v0_min: torch.Tensor | None = None
                               ) -> tuple[float, float]:
    """Safe (μ_min, μ_max) for Chebyshev: power-iteration estimates with
    outward margins on both ends (start vectors as in the two power
    iterations: ``v0_max`` / ``v0_min``, or draws seeded 0 and 1)."""
    mu_hi = safe_mu(power_iteration_mu_max(packed, iters, backend=backend,
                                           v0=v0_max))
    mu_lo_est = power_iteration_mu_min(packed, mu_hi, iters,
                                       backend=backend, v0=v0_min)
    spread = mu_hi - mu_lo_est
    mu_lo = mu_lo_est - 0.05 * spread - 0.002
    return mu_lo, mu_hi


def chebyshev_coefficients(mu_max: float, mu_min: float,
                           num_iters: int
                           ) -> tuple[np.ndarray, np.ndarray]:
    """The (α_k, β_k) schedule of `num_iters` Chebyshev steps as float64
    numpy tables (Golub & Van Loan §10.1.5):

      α₀ = 1/d,  β₀ = 0,  β₁ = ½(c/d)²,
      α_k = 1/(d − β_k/α_{k−1}),  β_k = (c·α_{k−1}/2)²  for k ≥ 2,

    with d = (a+b)/2, c = (b−a)/2 on [a, b] = [1−μ_max, 1−μ_min]."""
    a_lo, b_hi = 1.0 - float(mu_max), 1.0 - float(mu_min)
    d = (a_lo + b_hi) / 2.0
    c = (b_hi - a_lo) / 2.0
    alphas = np.empty(num_iters, np.float64)
    betas = np.empty(num_iters, np.float64)
    alpha_prev = None
    for k in range(num_iters):
        if k == 0:
            alpha, beta = 1.0 / d, 0.0
        else:
            beta = 0.5 * (c / d) ** 2 if k == 1 \
                else (c * alpha_prev / 2.0) ** 2
            alpha = 1.0 / (d - beta / alpha_prev)
        alphas[k] = alpha
        betas[k] = beta
        alpha_prev = alpha
    return alphas, betas


def chebyshev_scan(apply_f: Callable[[torch.Tensor], torch.Tensor],
                   theta0: torch.Tensor, alphas: torch.Tensor,
                   betas: torch.Tensor, *,
                   theta_star: torch.Tensor | None = None,
                   p0: torch.Tensor | None = None,
                   record_deltas: bool = False):
    """The shared host loop: one F-application per step and the two-term
    recurrence on the search direction,

      p_k = (F(θ_k) − θ_k) + β_k p_{k−1},   θ_{k+1} = θ_k + α_k p_k,

    coefficients from the tables (tensors on θ's device). Returns
    ``(theta, p, errs)`` — ``errs`` the per-step ‖θ_k − θ*‖ when
    ``theta_star`` is given, else None; ``p0`` resumes mid-schedule (cold
    start p₀ = 0). ``record_deltas=True`` appends the per-step
    max|α_k p_k| (the step taken, not the F-residual). The series stay on
    the device."""
    theta = theta0
    p = torch.zeros_like(theta0) if p0 is None else p0
    errs, deltas = [], []
    for k in range(alphas.shape[0]):
        resid = apply_f(theta) - theta
        p = resid + betas[k] * p
        theta_new = theta + alphas[k] * p
        if theta_star is not None:
            errs.append(torch.linalg.norm(theta_new - theta_star))
        if record_deltas:
            deltas.append(torch.max(torch.abs(theta_new - theta)))
        theta = theta_new
    stack = lambda xs: torch.stack(xs) if xs else theta0.new_zeros((0,))
    errs = stack(errs) if theta_star is not None else None
    if record_deltas:
        return theta, p, errs, stack(deltas)
    return theta, p, errs


def chebyshev_solve(apply_f: Callable[[torch.Tensor], torch.Tensor],
                    theta0: torch.Tensor, mu_max: float,
                    mu_min: float = 0.0,
                    num_iters: int = 100) -> torch.Tensor:
    """Chebyshev iteration for θ = F(θ), F(θ) = Mθ + b with
    spec(M) ⊂ [μ_min, μ_max]: the `chebyshev_coefficients` schedule
    through `chebyshev_scan`. The k-th iterate's error is the Chebyshev
    polynomial T_k((d−λ)/c)/T_k(d/c) applied to the initial error."""
    if num_iters == 0:
        return theta0
    alphas, betas = chebyshev_coefficients(mu_max, mu_min, num_iters)
    kw = dict(dtype=theta0.dtype, device=theta0.device)
    theta, _, _ = chebyshev_scan(apply_f, theta0,
                                 torch.as_tensor(alphas, **kw),
                                 torch.as_tensor(betas, **kw))
    return theta


def _chebyshev_fused(packed: PackedProblem, alphas: torch.Tensor,
                     betas: torch.Tensor, chunk_rounds: int | None,
                     trace: bool = False):
    """backend="cuda_fused": one Chebyshev-chain launch per
    ``chunk_rounds`` slice of the schedule (one by default); (θ, p) chain
    across chunks bit for bit. Returns θ, or (θ, res [R, J])."""
    from repro_torch.kernels import ops

    theta = torch.zeros_like(packed.d)
    p_dir = torch.zeros_like(packed.d)
    self_idx = torch.arange(packed.num_nodes, dtype=torch.int32,
                            device=packed.device)
    num_iters = alphas.shape[0]
    chunk = chunk_rounds or num_iters
    res = []
    for start in range(0, num_iters, chunk):
        outs = ops.dekrr_cheb_solve(
            packed.g, packed.d, packed.s, packed.p, theta, p_dir,
            packed.nbr_idx, self_idx, packed.nbr_mask,
            alphas[start:start + chunk], betas[start:start + chunk],
            trace=trace)
        theta, p_dir = outs[0], outs[1]
        if trace:
            res.append(outs[2])
    return (theta, torch.cat(res)) if trace else theta


def chebyshev_solve_packed(packed: PackedProblem, mu_max: float,
                           mu_min: float = 0.0, num_iters: int = 100,
                           backend: str = "cuda_fused",
                           chunk_rounds: int | None = None,
                           return_trace: bool = False):
    """Chebyshev on the packed runtime from θ = 0 (the same exchange as
    Algorithm 1).

    "torch" and "cuda" run `chebyshev_scan` with `step_batched` of that
    backend as F; "cuda_fused" runs the schedule in the Chebyshev-chain
    kernel, one launch per ``chunk_rounds`` slice (one by default; bit
    for bit the same for any chunking; ignored on the other backends).
    ``return_trace=True`` returns ``(theta, SolveTrace)`` whose residuals
    are the per-round max|α_k p_k|."""
    _check_backend(backend)
    if chunk_rounds is not None and chunk_rounds < 1:
        raise ValueError(f"chunk_rounds must be >= 1, got {chunk_rounds}")
    num_iters = int(num_iters)
    if num_iters == 0:
        theta = torch.zeros_like(packed.d)
        if return_trace:
            return theta, SolveTrace(residuals=packed.d.new_zeros((0,)))
        return theta
    alphas, betas = chebyshev_coefficients(mu_max, mu_min, num_iters)
    kw = dict(dtype=packed.d.dtype, device=packed.device)
    alphas = torch.as_tensor(alphas, **kw)
    betas = torch.as_tensor(betas, **kw)
    if backend == "cuda_fused":
        if not return_trace:
            return _chebyshev_fused(packed, alphas, betas, chunk_rounds)
        theta, res = _chebyshev_fused(packed, alphas, betas, chunk_rounds,
                                      trace=True)
        return theta, SolveTrace(residuals=res.amax(dim=1))
    apply_f = lambda th: step_batched(packed, th, backend=backend)
    out = chebyshev_scan(apply_f, torch.zeros_like(packed.d), alphas, betas,
                         record_deltas=return_trace)
    if return_trace:
        return out[0], SolveTrace(residuals=out[3])
    return out[0]


def _plain_error_curve(packed, theta_star, *, max_rounds, backend):
    """‖θ_k − θ*‖ for k = 1 … max_rounds of the plain Eq. 19 iteration,
    kept on the device and read once by the caller."""
    theta = torch.zeros_like(packed.d)
    errs = []
    for _ in range(max_rounds):
        theta = step_batched(packed, theta, backend=backend)
        errs.append(torch.linalg.norm(theta - theta_star))
    return torch.stack(errs)


def _cheb_error_curve(packed, theta_star, alphas, betas, *, backend):
    """Chebyshev counterpart of `_plain_error_curve` — the same
    `chebyshev_scan` as every other consumer."""
    apply_f = lambda th: step_batched(packed, th, backend=backend)
    _, _, errs = chebyshev_scan(apply_f, torch.zeros_like(packed.d),
                                alphas, betas, theta_star=theta_star)
    return errs


def rounds_to_tolerance(packed: PackedProblem, theta_star: torch.Tensor,
                        tol: float = 1e-6, max_rounds: int = 5000,
                        mu_max: float | None = None,
                        mu_min: float | None = None,
                        backend: str = "cuda") -> tuple[int, int]:
    """(plain rounds, Chebyshev rounds) to reach relative error ≤ tol
    (``max_rounds`` where never). Both error curves stay on the device and
    are read once; the interval is estimated when not given."""
    _check_backend(backend)
    if mu_max is None or mu_min is None:
        lo, hi = estimate_spectral_interval(packed, backend=backend)
        mu_max = hi if mu_max is None else mu_max
        mu_min = lo if mu_min is None else mu_min
    target = tol * float(torch.linalg.norm(theta_star))

    def first_crossing(errs: torch.Tensor) -> int:
        hit = errs.detach().cpu().numpy() <= target
        return int(np.argmax(hit)) + 1 if hit.any() else max_rounds

    plain = _plain_error_curve(packed, theta_star, max_rounds=max_rounds,
                               backend=backend)
    alphas, betas = chebyshev_coefficients(mu_max, mu_min, max_rounds)
    kw = dict(dtype=packed.d.dtype, device=packed.device)
    cheb = _cheb_error_curve(packed, theta_star,
                             torch.as_tensor(alphas, **kw),
                             torch.as_tensor(betas, **kw), backend=backend)
    return first_crossing(plain), first_crossing(cheb)
