"""Drive the PyTorch/CUDA port's main paths on one NVIDIA card.

    python3 chip_smoke.py

1. Card: name and power limit (nvidia-smi), TF32 switched off.
2. Build: the five CUDA kernels from ``src/repro_torch/kernels/csrc``
   (one nvcc per source, in parallel), with each ``-Xptxas -v`` report.
3. Kernel phases: each kernel against its plain PyTorch version on the
   card, at the main path's shapes, in float64 and float32, with the
   invariants that hold bit for bit (a solve launch == round launches;
   the masked round at all ones == the unmasked one; an async-chain
   launch == masked round launches plus the delivery rule; chunked
   Chebyshev launches == one launch).
4. Main path at the paper's full width (Table 2, ``wave``): N = 63,600,
   d = 148, noniid_y over J = 10 nodes of circulant(10, (1, 2)), D_j = 200
   energy-selected DDRF features from D0 = 4,000 candidates per node,
   σ = 1, λ = 1e-6, c_nei = 0.01·N. pack_problem → solve_batched
   (cuda_fused, tol 1e-10) → solve_batched (cuda, the same rounds) →
   predict → RSE, checked against the port's own references.
5. Asynchronous gossip on the same packed problem: 1,000 rounds at
   p = 0.5 with the reference tests' censor schedule (τ0 = 2e-2, decay
   0.9), masks drawn by a seeded `torch.Generator` on the card;
   cuda_fused == cuda bit for bit, both == torch at rtol 1e-9, one
   edge-gossip run, one tol = 1e-10 run.
6. Chebyshev acceleration on the same problem: the spectral interval on
   cuda, then chebyshev_solve_packed on cuda_fused, == cuda at rtol
   1e-9, and strictly fewer rounds than plain Jacobi to the same error.
7. Launch counts of each path and run, zeroed just before it.
8. Kernel times by CUDA events beside their plain versions, a PyTorch
   yardstick and the least time the card could take.

The last line is ``{"ok": true, "device": {...}}``; any failed phase
exits non-zero before it. Without a CUDA device the script exits
non-zero. ``--cpu-rehearsal`` runs steps 4–6 on the CPU at a small size
(the kernels' plain versions), for the tests.
"""
from __future__ import annotations

import argparse
import json
import math
import os
import subprocess
import sys
import time

import torch

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "src"))

# H100 SXM published peaks (NVIDIA data sheet): HBM3 bandwidth and the
# f64 tensor-core rate; f32 outside the tensor cores has the same rate.
PEAK_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {torch.float64: 67e12, torch.float32: 67e12}

TOL = {torch.float64: 1e-9, torch.float32: 1e-4}

# The paper's Table 2 `wave` setting.
J_NODES = 10
D_PER_NODE = 200
CANDIDATE_RATIO = 20
SIGMA = 1.0
LAM = 1e-6
C_NEI_OVER_N = 0.01
NUM_ITERS = 3000
SOLVE_TOL = 1e-10
CHUNK = 32          # solve_batched's default tol-check cadence on cuda_fused

# Asynchronous gossip: the reference tests' censor schedule at p = 0.5.
ASYNC_ROUNDS = 1000
ASYNC_CONFIG = dict(prob=0.5, censor_tau=2e-2, censor_decay=0.9)
ASYNC_TOL = 1e-10
ASYNC_CHUNK = 16    # async_solve_batched's default tol-check chunk
PHASE_ROUNDS = 7    # rounds of the chain kernels' phases
CHEB_TOL = 1e-8     # relative error of the rounds-to-tolerance comparison


class PhaseError(RuntimeError):
    pass


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def compare(name: str, got: torch.Tensor, want: torch.Tensor,
            dtype: torch.dtype) -> float:
    """max |got − want|; raises unless |got − want| ≤ rtol·|want| +
    rtol·max|want| elementwise (rtol by dtype)."""
    rtol = TOL[dtype]
    err = (got - want).abs()
    scale = want.abs().max().item() if want.numel() else 0.0
    bad = err > rtol * want.abs() + rtol * scale
    max_err = err.max().item() if err.numel() else 0.0
    if not torch.isfinite(got).all() or bad.any():
        raise PhaseError(f"{name}: kernel disagrees with its plain version "
                         f"(max abs err {max_err:.3e}, max |ref| "
                         f"{scale:.3e}, rtol {rtol:g})")
    return max_err


def cuda_ms(fn, *, reps: int = 20, warmup: int = 3) -> float:
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def bound_ms(nbytes: float, flops: float, dtype: torch.dtype):
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[dtype] * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                 else "operations")


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


# ---------------------------------------------------------------- operands
def dekrr_operands(j_nodes, k_slots, d_feat, dy, t_rows, dtype, seed):
    """A random packed operand set with a contracting iteration."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    kw = dict(dtype=dtype, device="cuda", generator=gen)
    scale = 0.5 / d_feat
    g = torch.randn((j_nodes, d_feat, d_feat), **kw) * scale
    s = torch.randn((j_nodes, d_feat, d_feat), **kw) * scale
    p = torch.randn((j_nodes, k_slots, d_feat, d_feat), **kw) * scale
    tail = () if dy == 1 else (dy,)
    d = torch.randn((j_nodes, d_feat) + tail, **kw)
    theta = torch.randn((t_rows, d_feat) + tail, **kw)
    nbr_idx = torch.randint(0, t_rows, (j_nodes, k_slots), device="cuda",
                            generator=gen, dtype=torch.int32)
    self_idx = torch.randperm(t_rows, device="cuda", generator=gen)[
        :j_nodes].to(torch.int32)
    nbr_mask = torch.ones((j_nodes, k_slots), dtype=dtype, device="cuda")
    if k_slots > 1:
        nbr_mask[0, 1] = 0.0       # one masked slot
    return g, d, s, p, theta, nbr_idx, self_idx, nbr_mask


def gram_operands(b, f, dim, n, dtype, seed):
    gen = torch.Generator(device="cuda").manual_seed(seed)
    kw = dict(dtype=dtype, device="cuda", generator=gen)
    omega = torch.randn((b, f, dim), **kw) / SIGMA
    bias = torch.rand((b, f), **kw) * (2 * math.pi)
    x = torch.rand((b, dim, n), **kw)
    y = torch.randn((b, n), **kw)
    mask = torch.ones((b, n), dtype=dtype, device="cuda")
    mask[:, n - 7:] = 0.0        # padded columns
    return omega, bias, x, y, mask


# ------------------------------------------------------------ kernel phases
def kernel_phases() -> dict[str, float]:
    """Each kernel against its plain version at the main path's shapes
    (J = 10, K = 4, D = 200, d = 148, N = 3,180) plus T > J and Dy = 3
    cases. Returns the largest f64 error per kernel."""
    from repro_torch.kernels import ops
    from repro_torch.kernels.dekrr_solve import dekrr_solve_reference
    from repro_torch.kernels.dekrr_step import dekrr_step_reference
    from repro_torch.kernels.rff_gram import rff_gram_batched_reference

    errs = {"rff_gram": 0.0, "dekrr_step": 0.0, "dekrr_solve": 0.0}
    for dtype in (torch.float64, torch.float32):
        f64 = dtype == torch.float64
        for b in (J_NODES, J_NODES * 4):
            args = gram_operands(b, D_PER_NODE, 148, 3180, dtype, seed=b)
            gram, zy = ops.rff_gram_batched(*args)
            gref, zref = rff_gram_batched_reference(*args)
            torch.cuda.synchronize()
            e = max(compare(f"rff_gram B={b} {dtype}", gram, gref, dtype),
                    compare(f"rff_gram zy B={b} {dtype}", zy, zref, dtype))
            if f64:
                errs["rff_gram"] = max(errs["rff_gram"], e)
        for dy, t_rows, k in ((1, J_NODES, 4), (1, J_NODES + 3, 4),
                              (3, J_NODES, 4), (3, J_NODES + 3, 4),
                              (1, J_NODES, 0)):
            g, d, s, p, theta, nbr_idx, self_idx, nbr_mask = dekrr_operands(
                J_NODES, k, D_PER_NODE, dy, t_rows, dtype, seed=7 * t_rows)
            ops_args = (g, d, s, p, theta, nbr_idx, self_idx, nbr_mask)
            case = f"Dy={dy} T={t_rows} K={k} {dtype}"
            got = ops.dekrr_step(*ops_args)
            lay = _raw_layout(ops_args)
            want = ops._unflatten_dy(dekrr_step_reference(*lay, dy=dy), dy,
                                     d.ndim)
            torch.cuda.synchronize()
            e = compare(f"dekrr_step {case}", got, want, dtype)
            if f64:
                errs["dekrr_step"] = max(errs["dekrr_step"], e)
            for rounds in (1, 7):
                got, res = ops.dekrr_solve(*ops_args, num_rounds=rounds,
                                           trace=True)
                want, wres = dekrr_solve_reference(
                    *lay, num_rounds=rounds, dy=dy, trace=True)
                want = ops._unflatten_dy(want, dy, d.ndim)
                torch.cuda.synchronize()
                e = max(compare(f"dekrr_solve R={rounds} {case}", got, want,
                                dtype),
                        compare(f"dekrr_solve trace R={rounds} {case}", res,
                                wres, dtype))
                if f64:
                    errs["dekrr_solve"] = max(errs["dekrr_solve"], e)
            # one launch of R rounds == R round launches, bit for bit
            if t_rows == J_NODES:
                seq = theta
                for _ in range(7):
                    seq = ops.dekrr_step(g, d, s, p, seq, nbr_idx,
                                         torch.arange(J_NODES, device="cuda",
                                                      dtype=torch.int32),
                                         nbr_mask)
                fused = ops.dekrr_solve(
                    g, d, s, p, theta, nbr_idx,
                    torch.arange(J_NODES, device="cuda", dtype=torch.int32),
                    nbr_mask, num_rounds=7)
                torch.cuda.synchronize()
                if not torch.equal(seq, fused):
                    raise PhaseError(f"dekrr_solve ≠ 7 dekrr_step launches "
                                     f"bit for bit ({case})")
        print(f"kernel phases {dtype}: pass", flush=True)
    return errs


def _raw_layout(ops_args):
    """The plain versions' raw operand layout, as the wrappers build it."""
    from repro_torch.kernels import ops
    return ops._pad_dekrr_operands("phase", *ops_args)[2]


def async_operands(j_nodes, k_slots, d_feat, dy, t_rows, dtype, rounds,
                   seed):
    """Operands of the async chain: dekrr_operands' blocks, θ/sent tables
    of t_rows rows, buffers [J, K, D(, Dy)], node-id nbr_idx, a random
    [R, J] activation table and thresholds spread over 1e-3 … 1 (around
    the censor deltas of these operands, so the censor fires on some
    node-rounds)."""
    g, d, s, p, theta, _, _, nbr_mask = dekrr_operands(
        j_nodes, k_slots, d_feat, dy, t_rows, dtype, seed)
    gen = torch.Generator(device="cuda").manual_seed(seed + 1)
    kw = dict(dtype=dtype, device="cuda", generator=gen)
    sent = theta + 0.5 * torch.randn(tuple(theta.shape), **kw)
    buffers = torch.randn((j_nodes, k_slots) + tuple(d.shape[1:]), **kw)
    ints = dict(device="cuda", generator=gen, dtype=torch.int32)
    nbr_idx = torch.randint(0, j_nodes, (j_nodes, k_slots), **ints)
    active = torch.randint(0, 2, (rounds, j_nodes), **ints)
    thresholds = 10.0 ** (3.0 * torch.rand((rounds,), **kw) - 3.0)
    return (g, d, s, p, theta, sent, buffers, nbr_idx, nbr_mask, active,
            thresholds)


def _async_raw(args):
    """The async chain's raw operand layout, as its wrapper builds it."""
    from repro_torch.kernels import ops
    g, d, s, p, theta, sent, bufs, nbr_idx, nbr_mask, active, thr = args
    j_nodes = d.shape[0]
    lay = ops._pad_dekrr_operands(
        "phase", g, d, s, p, theta, nbr_idx,
        torch.arange(j_nodes, dtype=torch.int32, device=d.device),
        nbr_mask)[2]
    if bufs.shape[1] == 0:
        bufs = bufs.new_zeros((j_nodes, 1) + tuple(bufs.shape[2:]))
    return lay[:5] + (ops._flatten_dy(sent), ops._flatten_buffers(bufs),
                      lay[5], lay[7], (active != 0).to(torch.int32),
                      thr.contiguous())


def chain_phases() -> dict[str, float]:
    """Kernels 4–6 (the masked round, the async chain, the Chebyshev
    chain) against their plain versions at the main path's shapes, plus
    T > J, Dy = 3 and K = 0, with their bit-for-bit invariants. Returns
    the largest f64 error per kernel."""
    from repro_torch.dist import (AsyncGossipState, PackedProblem,
                                  async_step_batched)
    from repro_torch.kernels import ops
    from repro_torch.kernels.dekrr_solve import (dekrr_async_solve_reference,
                                                 dekrr_cheb_solve_reference)
    from repro_torch.kernels.dekrr_step import dekrr_step_masked_reference

    errs = {"dekrr_step_masked": 0.0, "dekrr_async_solve": 0.0,
            "dekrr_cheb_solve": 0.0}
    rounds = PHASE_ROUNDS
    for dtype in (torch.float64, torch.float32):
        f64 = dtype == torch.float64

        def note(name, e):
            if f64:
                errs[name] = max(errs[name], e)

        for dy, t_rows, k in ((1, J_NODES, 4), (1, J_NODES + 3, 4),
                              (3, J_NODES, 4), (3, J_NODES + 3, 4),
                              (1, J_NODES, 0)):
            case = f"Dy={dy} T={t_rows} K={k} {dtype}"
            seed = 11 * t_rows + dy + k
            args = dekrr_operands(J_NODES, k, D_PER_NODE, dy, t_rows, dtype,
                                  seed)
            lay = _raw_layout(args)
            ndim = args[1].ndim
            # kernel 4: the activation-masked round
            active = (torch.arange(J_NODES, device="cuda") % 3 != 0).to(
                torch.int32)
            got = ops.dekrr_step(*args, active)
            want = ops._unflatten_dy(dekrr_step_masked_reference(
                *lay, active, dy=dy), dy, ndim)
            torch.cuda.synchronize()
            note("dekrr_step_masked",
                 compare(f"dekrr_step_masked {case}", got, want, dtype))
            ones = torch.ones(J_NODES, dtype=torch.int32, device="cuda")
            if not torch.equal(ops.dekrr_step(*args, ones),
                               ops.dekrr_step(*args)):
                raise PhaseError(f"dekrr_step_masked at all ones ≠ "
                                 f"dekrr_step bit for bit ({case})")
            # kernel 5: the async chain
            a_args = async_operands(J_NODES, k, D_PER_NODE, dy, t_rows,
                                    dtype, rounds, seed)
            raw = _async_raw(a_args)
            for gossip in ("bernoulli", "edge"):
                for censored in (False, True):
                    tag = f"{gossip} censored={censored} {case}"
                    got = ops.dekrr_async_solve(*a_args, gossip=gossip,
                                                censored=censored,
                                                trace=True)
                    w = dekrr_async_solve_reference(
                        *raw, censored=censored, edge_gossip=gossip == "edge",
                        dy=dy, trace=True)
                    want = (ops._unflatten_dy(w[0], dy, ndim),
                            ops._unflatten_dy(w[1], dy, ndim),
                            ops._unflatten_buffers(w[2], J_NODES, k, dy,
                                                   ndim),
                            w[3][:rounds])
                    torch.cuda.synchronize()
                    for what, a, b in zip(("θ", "sent", "buffers", "res"),
                                          got[:4], want):
                        note("dekrr_async_solve",
                             compare(f"dekrr_async_solve {what} {tag}", a,
                                     b, dtype))
                    if not torch.equal(got[4], w[4][:rounds]):
                        raise PhaseError(f"dekrr_async_solve broadcast "
                                         f"flags differ ({tag})")
                    if t_rows != J_NODES:
                        continue
                    # one launch of R rounds == R masked round launches
                    # followed by the delivery rule, bit for bit
                    g, d, s, p, theta, sent, bufs, nbr_idx, nbr_mask, act, \
                        thr = a_args
                    packed = PackedProblem(
                        g=g, d=d, s=s, p=p,
                        theta_mask=torch.ones_like(d[..., 0] if ndim == 3
                                                   else d),
                        nbr_idx=nbr_idx, nbr_mask=nbr_mask)
                    state = AsyncGossipState(theta, sent, bufs)
                    for r in range(rounds):
                        state, _ = async_step_batched(
                            packed, state, act[r], thr[r], gossip=gossip,
                            censored=censored, backend="cuda")
                    torch.cuda.synchronize()
                    if not (torch.equal(got[0], state.theta)
                            and torch.equal(got[1], state.sent)
                            and torch.equal(got[2], state.buffers)):
                        raise PhaseError(f"dekrr_async_solve ≠ {rounds} "
                                         f"dekrr_step_masked rounds bit for "
                                         f"bit ({tag})")
            # kernel 6: the Chebyshev chain
            g, d, s, p, theta, nbr_idx, self_idx, nbr_mask = args
            gen = torch.Generator(device="cuda").manual_seed(seed + 2)
            kw = dict(dtype=dtype, device="cuda", generator=gen)
            delta = torch.randn(tuple(d.shape), **kw)
            alphas = 0.5 + torch.rand((rounds,), **kw)
            betas = 0.3 * torch.rand((rounds,), **kw)
            c_args = (g, d, s, p, theta, delta, nbr_idx, self_idx, nbr_mask,
                      alphas, betas)
            got = ops.dekrr_cheb_solve(*c_args, trace=True)
            w = dekrr_cheb_solve_reference(
                *lay[:5], ops._flatten_dy(delta), *lay[5:], alphas, betas,
                dy=dy, trace=True)
            want = (ops._unflatten_dy(w[0], dy, ndim),
                    ops._unflatten_dy(w[1], dy, ndim), w[2])
            torch.cuda.synchronize()
            for what, a, b in zip(("θ", "p", "res"), got, want):
                note("dekrr_cheb_solve",
                     compare(f"dekrr_cheb_solve {what} {case}", a, b, dtype))
            if t_rows == J_NODES:
                # chunked launches == one launch, bit for bit
                ident = torch.arange(J_NODES, dtype=torch.int32,
                                     device="cuda")
                c_args = c_args[:7] + (ident,) + c_args[8:]
                whole = ops.dekrr_cheb_solve(*c_args, trace=True)
                first = ops.dekrr_cheb_solve(*c_args[:9], alphas[:3],
                                             betas[:3], trace=True)
                rest = ops.dekrr_cheb_solve(*c_args[:4], first[0], first[1],
                                            *c_args[6:9], alphas[3:],
                                            betas[3:], trace=True)
                torch.cuda.synchronize()
                if not (torch.equal(rest[0], whole[0])
                        and torch.equal(rest[1], whole[1])
                        and torch.equal(torch.cat([first[2], rest[2]]),
                                        whole[2])):
                    raise PhaseError(f"dekrr_cheb_solve chunked ≠ unchunked "
                                     f"bit for bit ({case})")
        print(f"chain kernel phases {dtype}: pass", flush=True)
    return errs


# ---------------------------------------------------------------- main path
def main_path(device: str, *, subsample: int | None, d_per_node: int,
              num_iters: int, seed: int = 0) -> dict:
    """The paper's main path through the port's entry points; returns the
    packed problem and everything the checks and timings need."""
    from repro_torch.core import (DeKRRConfig, DeKRRSolver, circulant, rse,
                                  select_features)
    from repro_torch.data.synthetic import (make_dataset, partition,
                                            train_test_split_nodes)
    from repro_torch.dist import pack_problem, solve_batched, unpack_theta
    from repro_torch.kernels import ops

    sync = torch.cuda.synchronize if device == "cuda" else (lambda: None)
    ds = make_dataset("wave", seed=seed, subsample=subsample)
    nodes = partition(ds, J_NODES, mode="noniid_y", seed=seed, device=device)
    train, test = train_test_split_nodes(nodes, seed=seed)
    gen = torch.Generator(device=device).manual_seed(seed)
    fmaps = [select_features(gen, ds.dim, d_per_node, SIGMA, nd.x, nd.y,
                             method="energy",
                             candidate_ratio=CANDIDATE_RATIO)
             for nd in train]
    n_train = sum(nd.num_samples for nd in train)
    solver = DeKRRSolver(circulant(J_NODES, (1, 2)), fmaps, train,
                         DeKRRConfig(lam=LAM, c_nei=C_NEI_OVER_N * n_train),
                         build_aux=False, device=device)
    sync()

    ops.reset_launch_counts()
    t0 = time.perf_counter()
    packed = pack_problem(solver, gram_backend="cuda", device=device)
    sync()
    t_pack = time.perf_counter() - t0
    t0 = time.perf_counter()
    theta, rounds, trace = solve_batched(
        packed, num_iters, backend="cuda_fused", tol=SOLVE_TOL,
        return_rounds=True, return_trace=True)
    sync()
    t_solve = time.perf_counter() - t0
    theta_step = solve_batched(packed, rounds, backend="cuda")
    preds = torch.cat([solver.predict(unpack_theta(packed, theta), nd.x,
                                      node=j) for j, nd in enumerate(test)])
    test_rse = rse(preds, torch.cat([nd.y for nd in test]))
    sync()
    launches = ops.launch_counts()
    return dict(solver=solver, packed=packed, theta=theta,
                theta_step=theta_step, rounds=rounds, trace=trace,
                rse=test_rse, t_pack=t_pack, t_solve=t_solve,
                launches=launches, n_train=n_train, preds=preds)


def check_main_path(run: dict) -> dict:
    """The port's own references on the same device; raises on failure."""
    from repro_torch.dist import solve_batched, unpack_theta

    packed, theta, rounds = run["packed"], run["theta"], run["rounds"]
    res = run["trace"].residuals[:rounds]
    if not (torch.isfinite(theta).all() and torch.isfinite(run["preds"]).all()
            and math.isfinite(run["rse"])):
        raise PhaseError("main path produced non-finite values")
    if not torch.equal(run["theta_step"], theta):
        raise PhaseError("cuda (per-round) and cuda_fused disagree")
    theta_torch = solve_batched(packed, rounds, backend="torch")
    scale = theta_torch.abs().max()
    if ((theta - theta_torch).abs()
            > 1e-9 * theta_torch.abs() + 1e-9 * scale).any():
        raise PhaseError("cuda_fused and the torch backend differ beyond "
                         "rtol 1e-9")
    if (theta[packed.theta_mask == 0] != 0).any():
        raise PhaseError("padded θ coordinates are not exactly 0")
    exact = run["solver"].solve_exact().theta
    got = unpack_theta(packed, theta)
    err = max((a - b).abs().max().item() for a, b in zip(got, exact))
    theta_scale = max(b.abs().max().item() for b in exact)
    # contraction: ‖θ_k − θ*‖ ≲ ρ/(1−ρ)·‖θ_k − θ_{k−1}‖, ρ read off the
    # trace's last 50 rounds; ×10 for the ∞-norm and the estimate
    last = res[-1].item()
    window = min(50, rounds - 1)
    rho = (last / res[-1 - window].item()) ** (1.0 / window) \
        if window > 0 and res[-1 - window] > 0 else 0.0
    if not rho < 1.0:
        raise PhaseError(f"the trace does not contract (ρ ≈ {rho})")
    bound = 10.0 * last * rho / (1.0 - rho) + 1e-9 * theta_scale
    if err > bound:
        raise PhaseError(f"iterate is {err:.3e} from solve_exact, beyond "
                         f"the {bound:.3e} the trace implies")
    return dict(exact_err=err, exact_bound=bound, rho=rho, last_res=last,
                exact=exact)


def _launched(fn):
    """Run fn with the launch counts zeroed just before it; returns
    (result, host seconds up to a device sync, launch counts)."""
    from repro_torch.kernels import ops
    sync = torch.cuda.synchronize if torch.cuda.is_available() \
        else (lambda: None)
    sync()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    out = fn()
    sync()
    return out, time.perf_counter() - t0, ops.launch_counts()


def async_path(run: dict, *, rounds: int, seed: int = 0) -> dict:
    """Asynchronous gossip on the main path's packed problem: masks drawn
    on its device by a seeded generator; cuda_fused, cuda and torch with
    stats and trace, edge gossip on cuda_fused and cuda, and a tol run on
    cuda_fused (the per-round masked kernel)."""
    from repro_torch.core import AsyncGossipConfig, activation_masks
    from repro_torch.dist import async_solve_batched
    from repro_torch.dist.async_gossip import _packed_edges

    packed = run["packed"]
    gen = torch.Generator(device=packed.device).manual_seed(seed)
    config = AsyncGossipConfig(**ASYNC_CONFIG)
    masks = activation_masks(gen, rounds, packed.num_nodes,
                             prob=config.prob)
    edge_config = AsyncGossipConfig(
        gossip="edge", censor_tau=config.censor_tau,
        censor_decay=config.censor_decay)
    edge_masks = activation_masks(gen, rounds, packed.num_nodes,
                                  gossip="edge", edges=_packed_edges(packed))
    solve = lambda m, c, b, **kw: _launched(lambda: async_solve_batched(
        packed, rounds, m, config=c, backend=b, **kw))
    wire = dict(return_stats=True, return_trace=True)
    return dict(
        masks=masks, config=config, rounds=rounds,
        fused=solve(masks, config, "cuda_fused", **wire),
        per_round=solve(masks, config, "cuda", **wire),
        torch=solve(masks, config, "torch", **wire),
        edge_fused=solve(edge_masks, edge_config, "cuda_fused",
                         return_stats=True),
        edge_round=solve(edge_masks, edge_config, "cuda",
                         return_stats=True),
        tol=solve(masks, config, "cuda_fused", tol=ASYNC_TOL,
                  return_rounds=True, return_stats=True))


def _exact_err(run, checks, theta) -> float:
    from repro_torch.dist import unpack_theta
    got = unpack_theta(run["packed"], theta)
    return max((a - b).abs().max().item()
               for a, b in zip(got, checks["exact"]))


def check_async_path(a: dict, run: dict, checks: dict) -> dict:
    """Results of the async path; raises on failure."""
    (fused, fstats, ftrace) = a["fused"][0]
    (cuda, cstats, ctrace) = a["per_round"][0]
    (plain, tstats, ttrace) = a["torch"][0]
    if not torch.isfinite(fused).all():
        raise PhaseError("async path produced non-finite values")
    if not (torch.equal(fused, cuda) and fstats == cstats and all(
            torch.equal(x, y) for x, y in zip(ftrace, ctrace))):
        raise PhaseError("async cuda_fused and cuda differ (θ, stats or "
                         "trace)")
    compare("async cuda_fused vs torch", fused, plain, torch.float64)
    compare("async trace residuals vs torch", ftrace.residuals,
            ttrace.residuals, torch.float64)
    # Censor decisions must agree with torch's wherever the iteration still
    # moves. At its floating-point fixed point a node's new θ equals what
    # it sent, or differs by an ulp, depending on the order of the sums,
    # and τ_r has decayed far below an ulp: there the two arithmetics may
    # decide differently, and such rounds are counted, not failed.
    differ = (ftrace.broadcasts != ttrace.broadcasts) | \
        (ftrace.deliveries != ttrace.deliveries)
    moving = ttrace.residuals > 1e-12 * plain.abs().max()
    if (differ & moving).any():
        r = int(torch.nonzero(differ & moving)[0])
        raise PhaseError(f"async wire counts differ from torch in round {r} "
                         f"(residual {ttrace.residuals[r].item():.3e}): "
                         f"{fstats} vs {tstats}")
    fixed_point = dict(rounds=int(differ.sum()),
                       first=int(torch.nonzero(differ)[0]) if differ.any()
                       else None,
                       broadcasts=int(tstats.broadcasts) - fstats.broadcasts)
    if not fstats.broadcasts < int(a["masks"].sum()):
        raise PhaseError("the censor never fired on the async path")
    (efused, estats), (eround, erstats) = (a["edge_fused"][0],
                                           a["edge_round"][0])
    if not (torch.equal(efused, eround) and estats == erstats
            and estats.deliveries == estats.broadcasts):
        raise PhaseError("edge gossip: cuda_fused and cuda differ")
    theta_tol, tol_rounds, tol_stats = a["tol"][0]
    if not tol_rounds < a["rounds"]:
        raise PhaseError(f"async tol {ASYNC_TOL} never stopped the solve")
    err = _exact_err(run, checks, fused)
    if not err <= checks["exact_bound"]:
        raise PhaseError(f"async iterate is {err:.3e} from solve_exact, "
                         f"beyond the main path's {checks['exact_bound']:.3e}")
    return dict(err=err, tol_err=_exact_err(run, checks, theta_tol),
                edge_err=_exact_err(run, checks, efused), stats=fstats,
                edge_stats=estats, tol_rounds=tol_rounds,
                tol_stats=tol_stats, fixed_point=fixed_point)


def check_async_launches(a: dict) -> dict:
    """Each async run launched exactly what its path must."""
    rounds = a["rounds"]
    tol_rounds = a["tol"][0][1]
    tol_launches = min(-(-tol_rounds // ASYNC_CHUNK) * ASYNC_CHUNK, rounds)
    want = {"fused": {"dekrr_async_solve": 1},
            "per_round": {"dekrr_step_masked": rounds},
            "torch": {},
            "edge_fused": {"dekrr_async_solve": 1},
            "edge_round": {"dekrr_step_masked": rounds},
            "tol": {"dekrr_step_masked": tol_launches}}
    total = {}
    for key, expect in want.items():
        got = {k: v for k, v in a[key][2].items() if v}
        if got != expect:
            raise PhaseError(f"async {key} launch counts {got}, expected "
                             f"{expect}")
        for k, v in got.items():
            total[k] = total.get(k, 0) + v
    return total


def cheb_path(run: dict, checks: dict) -> dict:
    """Chebyshev on the main path's packed problem: the spectral interval
    on cuda, the accelerated solve on cuda_fused (one launch) and on
    cuda, and rounds to the same relative error, plain vs Chebyshev."""
    from repro_torch.core.acceleration import (chebyshev_solve_packed,
                                               estimate_spectral_interval,
                                               rounds_to_tolerance)
    from repro_torch.dist import pack_theta

    packed = run["packed"]
    rounds = run["rounds"]
    interval = _launched(lambda: estimate_spectral_interval(
        packed, backend="cuda"))
    lo, hi = interval[0]
    fused = _launched(lambda: chebyshev_solve_packed(
        packed, hi, lo, num_iters=rounds, backend="cuda_fused",
        return_trace=True))
    per_round = _launched(lambda: chebyshev_solve_packed(
        packed, hi, lo, num_iters=rounds, backend="cuda"))
    theta_star = pack_theta(packed, checks["exact"])
    plain_rounds, cheb_rounds = rounds_to_tolerance(
        packed, theta_star, tol=CHEB_TOL, max_rounds=2 * rounds,
        mu_max=hi, mu_min=lo, backend="cuda")
    return dict(mu=(lo, hi), rounds=rounds, interval=interval, fused=fused,
                per_round=per_round, plain_rounds=plain_rounds,
                cheb_rounds=cheb_rounds)


def check_cheb_path(c: dict, run: dict, checks: dict) -> dict:
    theta, trace = c["fused"][0]
    if not torch.isfinite(theta).all():
        raise PhaseError("Chebyshev path produced non-finite values")
    compare("Chebyshev cuda_fused vs cuda", theta, c["per_round"][0],
            torch.float64)
    err = _exact_err(run, checks, theta)
    if not err <= checks["exact_bound"]:
        raise PhaseError(f"Chebyshev iterate is {err:.3e} from solve_exact, "
                         f"beyond the main path's {checks['exact_bound']:.3e}")
    if not c["cheb_rounds"] < c["plain_rounds"]:
        raise PhaseError(f"Chebyshev needs {c['cheb_rounds']} rounds to "
                         f"relative error {CHEB_TOL}, plain Jacobi "
                         f"{c['plain_rounds']}")
    return dict(err=err, last_res=trace.residuals[-1].item())


def check_cheb_launches(c: dict, iters: int = 60) -> dict:
    want = {"interval": {"dekrr_step": 2 * iters + 2},
            "fused": {"dekrr_cheb_solve": 1},
            "per_round": {"dekrr_step": c["rounds"]}}
    for key, expect in want.items():
        got = {k: v for k, v in c[key][2].items() if v}
        if got != expect:
            raise PhaseError(f"Chebyshev {key} launch counts {got}, "
                             f"expected {expect}")
    return {"dekrr_cheb_solve": 1}


# ----------------------------------------------------------------- timings
def timings(packed, run) -> list[dict]:
    """Each kernel at the shapes the main path gave it, by CUDA events."""
    from repro_torch.dist.dekrr_spmd import (_gram_kernel_calls,
                                             _stage_packed_inputs)
    from repro_torch.kernels import ops
    from repro_torch.kernels.dekrr_solve import dekrr_solve_reference
    from repro_torch.kernels.dekrr_step import dekrr_step_reference
    from repro_torch.kernels.rff_gram import rff_gram_batched_reference

    dtype = packed.d.dtype
    rows = []
    # rff_gram: the two launches pack_problem makes (self, then cross)
    staged = _stage_packed_inputs(run["solver"], packed.device,
                                  gram_backend="torch")["inputs"]
    calls = [tuple(t.contiguous() for t in c)
             for c in _gram_kernel_calls(staged)]

    def library_gram(om, bi, x, y, cm):
        z = torch.cos(torch.baddbmm(bi[..., None], om, x)) * cm[:, None]
        return z @ z.transpose(1, 2), (z @ y[..., None])[..., 0]

    flops = byts = 0
    for om, bi, x, y, cm in calls:
        n_live = cm.sum().item()          # columns this data needs
        b, f, d_in = om.shape
        flops += 2 * f * d_in * n_live + 2 * f * f * n_live
        byts += nbytes(om, bi, x, y, cm) + (b * f * f + b * f) * om.element_size()
    bms, by = bound_ms(byts, flops, dtype)
    rows.append(dict(
        name="rff_gram", route="cuda",
        source="src/repro_torch/kernels/csrc/rff_gram.cu",
        replaces="src/repro/kernels/rff_gram.py:70",
        ms=cuda_ms(lambda: [ops.rff_gram_batched(*c) for c in calls]),
        plain_ms=cuda_ms(lambda: [rff_gram_batched_reference(*c)
                                  for c in calls]),
        bound_ms=bms, bound_by=by,
        library_ms=cuda_ms(lambda: [library_gram(*c) for c in calls])))

    # dekrr_step and dekrr_solve on the packed problem
    self_idx = torch.arange(packed.num_nodes, dtype=torch.int32,
                            device=packed.device)
    args = (packed.g, packed.d, packed.s, packed.p, run["theta"],
            packed.nbr_idx, self_idx, packed.nbr_mask)
    lay = _raw_layout(args)
    live = int(packed.nbr_mask.count_nonzero().item())
    d_feat, dy = packed.max_features, packed.num_outputs
    step_flops = 2 * (2 * packed.num_nodes + live) * d_feat * d_feat * dy
    step_bytes = nbytes(packed.g, packed.s, packed.d, run["theta"],
                        packed.nbr_idx, packed.nbr_mask) \
        + live * d_feat * d_feat * packed.p.element_size() \
        + nbytes(run["theta"])

    def library_round(theta):
        nbr = theta[packed.nbr_idx.long()] * packed.nbr_mask[..., None]
        acc = packed.d + torch.einsum("jab,jb->ja", packed.s, theta) \
            + torch.einsum("jkab,jkb->ja", packed.p, nbr)
        return torch.einsum("jab,jb->ja", packed.g, acc)

    from repro_torch.kernels.dekrr_step import dekrr_step_cuda
    out = torch.empty_like(lay[1])
    bms, by = bound_ms(step_bytes, step_flops, dtype)
    rows.append(dict(
        name="dekrr_step", route="cuda",
        source="src/repro_torch/kernels/csrc/dekrr_step.cu",
        replaces="src/repro/kernels/dekrr_step.py:192",
        ms=cuda_ms(lambda: dekrr_step_cuda(*lay, out, dy=dy)),
        plain_ms=cuda_ms(lambda: dekrr_step_reference(*lay, dy=dy)),
        bound_ms=bms, bound_by=by,
        library_ms=cuda_ms(lambda: library_round(run["theta"]))))

    from repro_torch.kernels.dekrr_solve import dekrr_solve_cuda
    res = torch.empty((CHUNK, packed.num_nodes), dtype=dtype,
                      device=packed.device)
    work = torch.empty((2,) + tuple(lay[4].shape), dtype=dtype,
                       device=packed.device)

    def library_solve(theta):
        for _ in range(CHUNK):
            theta = library_round(theta)
        return theta

    bms, by = bound_ms(step_bytes, CHUNK * step_flops, dtype)
    rows.append(dict(
        name="dekrr_solve", route="cuda",
        source="src/repro_torch/kernels/csrc/dekrr_solve.cu",
        replaces="src/repro/kernels/dekrr_solve.py:204",
        ms=cuda_ms(lambda: dekrr_solve_cuda(*lay, out, res, work,
                                            num_rounds=CHUNK, dy=dy)),
        plain_ms=cuda_ms(lambda: dekrr_solve_reference(
            *lay, num_rounds=CHUNK, dy=dy, trace=True), reps=5),
        bound_ms=bms, bound_by=by,
        library_ms=cuda_ms(lambda: library_solve(run["theta"]), reps=5)))
    return rows


def chain_timings(run: dict, a: dict, c: dict) -> list[dict]:
    """Kernels 4–6 at the shapes their paths gave them, by CUDA events:
    the masked round on the async path's [θ; buffers] table with round
    0's activation, the async chain over the whole 1,000-round schedule,
    the Chebyshev chain over its path's rounds."""
    from repro_torch.core import censor_schedule
    from repro_torch.core.acceleration import (chebyshev_coefficients,
                                               chebyshev_solve_packed)
    from repro_torch.dist import async_solve_batched
    from repro_torch.kernels import ops
    from repro_torch.kernels.dekrr_solve import (dekrr_async_solve_cuda,
                                                 dekrr_async_solve_reference,
                                                 dekrr_cheb_solve_cuda,
                                                 dekrr_cheb_solve_reference)
    from repro_torch.kernels.dekrr_step import (dekrr_step_cuda,
                                                dekrr_step_masked_reference)

    packed = run["packed"]
    dtype, dev = packed.d.dtype, packed.device
    j_nodes, k_slots = packed.num_nodes, packed.num_slots
    d_feat, dy = packed.max_features, packed.num_outputs
    item = packed.d.element_size()
    live = packed.nbr_mask != 0
    per_node_flops = 2 * (2 + live.sum(dim=1)) * d_feat * d_feat * dy  # [J]
    rows = lambda n: n * d_feat * dy * item        # bytes of n θ row blocks
    rows_out = []

    # kernel 4: one masked round on the [θ; buffers] table
    theta = run["theta"]
    bufs = theta[packed.nbr_idx.long()]
    table = torch.cat([theta, bufs.reshape(j_nodes * k_slots, -1)])
    buf_idx = j_nodes + torch.arange(j_nodes * k_slots, dtype=torch.int32,
                                     device=dev).reshape(j_nodes, k_slots)
    self_idx = torch.arange(j_nodes, dtype=torch.int32, device=dev)
    lay = _raw_layout((packed.g, packed.d, packed.s, packed.p, table,
                       buf_idx, self_idx, packed.nbr_mask))
    active = a["masks"][0].to(torch.int32)
    act = active != 0
    n_act, live_act = int(act.sum()), int(live[act].sum())
    out = torch.empty_like(lay[1])
    gate = act[:, None]

    def library_masked():
        acc = packed.d + torch.einsum("jab,jb->ja", packed.s, theta) \
            + torch.einsum("jkab,jkb->ja", packed.p,
                           bufs * packed.nbr_mask[..., None])
        return torch.where(gate, torch.einsum("jab,jb->ja", packed.g, acc),
                           theta)

    # G, S, d and the live P blocks of the active nodes; every node's own
    # rows and the active nodes' live neighbour rows; the output rows
    flops = float(per_node_flops[act].sum())
    byts = (2 * n_act + live_act) * d_feat * d_feat * item + rows(n_act) \
        + rows(j_nodes + live_act) + rows(j_nodes) \
        + nbytes(active, buf_idx, self_idx, lay[7])
    bms, by = bound_ms(byts, flops, dtype)
    rows_out.append(dict(
        name="dekrr_step_masked", route="cuda",
        source="src/repro_torch/kernels/csrc/dekrr_step.cu",
        replaces="src/repro/kernels/dekrr_step.py:121",
        ms=cuda_ms(lambda: dekrr_step_cuda(*lay, out, dy=dy, active=active)),
        plain_ms=cuda_ms(lambda: dekrr_step_masked_reference(*lay, active,
                                                             dy=dy)),
        bound_ms=bms, bound_by=by, library_ms=cuda_ms(library_masked)))

    # kernel 5: the whole async schedule in one launch
    masks, config, rounds = a["masks"], a["config"], a["rounds"]
    thr = censor_schedule(config.censor_tau, config.censor_decay, rounds,
                          dtype=dtype, device=dev)
    zero = torch.zeros_like(packed.d)
    raw = _async_raw((packed.g, packed.d, packed.s, packed.p, zero, zero,
                      zero[packed.nbr_idx.long()], packed.nbr_idx,
                      packed.nbr_mask, masks, thr))
    kw = dict(dtype=dtype, device=dev)
    outs = (torch.empty((j_nodes * dy, d_feat), **kw),
            torch.empty((j_nodes * dy, d_feat), **kw),
            torch.empty((j_nodes * k_slots * dy, d_feat), **kw),
            torch.empty((rounds + 1, j_nodes), **kw),
            torch.empty((rounds + 1, j_nodes), dtype=torch.int32,
                        device=dev))
    work = torch.empty((2,) + tuple(raw[4].shape), **kw)
    flags = torch.empty((2 * j_nodes,), dtype=torch.int32, device=dev)
    # G, S, the live P blocks, d, θ0, sent0 and buffers in; θ, sent and
    # buffers out; the schedule and the trace; flops of the active rounds
    flops = float((masks.to(dtype).sum(dim=0) * per_node_flops).sum())
    byts = (2 * j_nodes + int(live.sum())) * d_feat * d_feat * item \
        + 5 * rows(j_nodes) + 2 * rows(j_nodes * k_slots) \
        + nbytes(raw[7], raw[8], raw[9], thr, outs[3], outs[4])
    bms, by = bound_ms(byts, flops, dtype)
    rows_out.append(dict(
        name="dekrr_async_solve", route="cuda",
        source="src/repro_torch/kernels/csrc/dekrr_async_solve.cu",
        replaces="src/repro/kernels/dekrr_solve.py:457",
        ms=cuda_ms(lambda: dekrr_async_solve_cuda(
            *raw, *outs, work, flags, censored=True, edge_gossip=False,
            dy=dy), reps=3, warmup=1),
        plain_ms=cuda_ms(lambda: dekrr_async_solve_reference(
            *raw, censored=True, edge_gossip=False, dy=dy, trace=True),
            reps=2, warmup=1),
        bound_ms=bms, bound_by=by,
        library_ms=cuda_ms(lambda: async_solve_batched(
            packed, rounds, masks, config=config, backend="torch",
            return_trace=True), reps=2, warmup=1)))

    # kernel 6: the Chebyshev schedule in one launch
    lo, hi = c["mu"]
    al, be = (torch.as_tensor(t, **kw) for t in
              chebyshev_coefficients(hi, lo, c["rounds"]))
    lay = _raw_layout((packed.g, packed.d, packed.s, packed.p, zero,
                       packed.nbr_idx, self_idx, packed.nbr_mask))
    craw = lay[:5] + (ops._flatten_dy(zero),) + lay[5:] + (al, be)
    couts = (torch.empty((j_nodes * dy, d_feat), **kw),
             torch.empty((j_nodes * dy, d_feat), **kw),
             torch.empty((c["rounds"], j_nodes), **kw))
    work = torch.empty((2,) + tuple(lay[4].shape), **kw)
    # G, S, the live P blocks, d, θ0 and p0 in; θ and p out
    flops = float(c["rounds"] * per_node_flops.sum())
    byts = (2 * j_nodes + int(live.sum())) * d_feat * d_feat * item \
        + 5 * rows(j_nodes) + nbytes(lay[5], lay[6], lay[7], al, be,
                                     couts[2])
    bms, by = bound_ms(byts, flops, dtype)
    rows_out.append(dict(
        name="dekrr_cheb_solve", route="cuda",
        source="src/repro_torch/kernels/csrc/dekrr_cheb_solve.cu",
        replaces="src/repro/kernels/dekrr_solve.py:620",
        ms=cuda_ms(lambda: dekrr_cheb_solve_cuda(*craw, *couts, work,
                                                 dy=dy), reps=5),
        plain_ms=cuda_ms(lambda: dekrr_cheb_solve_reference(
            *craw, dy=dy, trace=True), reps=3, warmup=1),
        bound_ms=bms, bound_by=by,
        library_ms=cuda_ms(lambda: chebyshev_solve_packed(
            packed, hi, lo, num_iters=c["rounds"], backend="torch",
            return_trace=True), reps=3, warmup=1)))
    return rows_out


def check_launches(run: dict) -> None:
    got = {k: v for k, v in run["launches"].items() if v}
    rounds = run["rounds"]
    want = {"rff_gram": 2, "dekrr_solve": -(-rounds // CHUNK),
            "dekrr_step": rounds}
    if got != want:
        raise PhaseError(f"main path launch counts {got}, expected {want}")


# ------------------------------------------------------------------- main
def rehearse_on_cpu() -> int:
    """The main, async and Chebyshev paths on the CPU at a small size
    (plain kernel versions)."""
    run = main_path("cpu", subsample=2000, d_per_node=12, num_iters=200)
    checks = check_main_path(run)
    a = async_path(run, rounds=300)
    a_checks = check_async_path(a, run, checks)
    c = cheb_path(run, checks)
    c_checks = check_cheb_path(c, run, checks)
    summary = dict(rounds=run["rounds"], rse=run["rse"],
                   launches=run["launches"], exact_err=checks["exact_err"],
                   rho=checks["rho"], async_err=a_checks["err"],
                   async_tol_rounds=a_checks["tol_rounds"],
                   cheb_err=c_checks["err"],
                   cheb_rounds=(c["plain_rounds"], c["cheb_rounds"]))
    print(json.dumps({"cpu_rehearsal": summary}))
    return 0


def run_on_card() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available (torch.cuda."
              "is_available() is False); this script runs only on the card",
              file=sys.stderr)
        return 2
    t_start = time.perf_counter()
    card = card_line()
    name, count = torch.cuda.get_device_name(0), torch.cuda.device_count()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(f"card: {card} | torch {torch.__version__} cuda "
          f"{torch.version.cuda} | {name} x{count}")
    print(f"allow_tf32: matmul={torch.backends.cuda.matmul.allow_tf32} "
          f"cudnn={torch.backends.cudnn.allow_tf32}", flush=True)

    from repro_torch.kernels import _build
    t0 = time.perf_counter()
    reports = _build.build_all()
    print(f"build: {time.perf_counter() - t0:.1f} s "
          f"(sources {_build.source_hash()})")
    for src, text in reports.items():
        print(f"--- ptxas {src} ---\n{text.strip()}")

    errs = kernel_phases()
    errs.update(chain_phases())

    run = main_path("cuda", subsample=None, d_per_node=D_PER_NODE,
                    num_iters=NUM_ITERS)
    checks = check_main_path(run)
    print(f"main path [{card}]: N={run['n_train']} train, rounds "
          f"{run['rounds']}, last residual {checks['last_res']:.3e}, "
          f"rho {checks['rho']:.6f}, |θ − θ*| {checks['exact_err']:.3e} "
          f"(bound {checks['exact_bound']:.3e}), test RSE {run['rse']:.6f}, "
          f"pack {run['t_pack'] * 1e3:.1f} ms, solve "
          f"{run['t_solve'] * 1e3:.1f} ms", flush=True)
    print(f"launches: {json.dumps(run['launches'])}")
    check_launches(run)

    a = async_path(run, rounds=ASYNC_ROUNDS)
    a_checks = check_async_path(a, run, checks)
    a_launches = check_async_launches(a)
    st, ts = a_checks["stats"], a_checks["tol_stats"]
    print(f"async path [{card}]: {a['rounds']} rounds p={a['config'].prob} "
          f"censor τ0={a['config'].censor_tau} decay "
          f"{a['config'].censor_decay}: {st.broadcasts} broadcasts, "
          f"{st.deliveries} deliveries of {int(a['masks'].sum())} "
          f"activations, |θ − θ*| {a_checks['err']:.3e}; wall cuda_fused "
          f"{a['fused'][1] * 1e3:.1f} ms, cuda {a['per_round'][1] * 1e3:.1f} "
          f"ms, torch {a['torch'][1] * 1e3:.1f} ms; edge gossip "
          f"{a_checks['edge_stats'].broadcasts} broadcasts, |θ − θ*| "
          f"{a_checks['edge_err']:.3e}, wall cuda_fused "
          f"{a['edge_fused'][1] * 1e3:.1f} ms; tol {ASYNC_TOL}: "
          f"{a_checks['tol_rounds']} rounds, {ts.broadcasts} broadcasts, "
          f"{ts.deliveries} deliveries, |θ − θ*| {a_checks['tol_err']:.3e}, "
          f"wall {a['tol'][1] * 1e3:.1f} ms", flush=True)
    print(f"async vs torch at the fixed point (rounds whose wire counts "
          f"differ, the first, torch's extra broadcasts): "
          f"{json.dumps(a_checks['fixed_point'])}")
    print(f"async launches: {json.dumps(a_launches)}")

    c = cheb_path(run, checks)
    c_checks = check_cheb_path(c, run, checks)
    c_launches = check_cheb_launches(c)
    print(f"chebyshev path [{card}]: interval [{c['mu'][0]:.6f}, "
          f"{c['mu'][1]:.6f}] in {c['interval'][1] * 1e3:.1f} ms, "
          f"{c['rounds']} rounds cuda_fused {c['fused'][1] * 1e3:.1f} ms "
          f"(cuda {c['per_round'][1] * 1e3:.1f} ms), |θ − θ*| "
          f"{c_checks['err']:.3e}, last step {c_checks['last_res']:.3e}; "
          f"rounds to relative error {CHEB_TOL}: plain {c['plain_rounds']}, "
          f"Chebyshev {c['cheb_rounds']}", flush=True)
    print(f"chebyshev launches: {json.dumps(c_launches)}")

    launches = dict(run["launches"], dekrr_step_masked=a_launches[
        "dekrr_step_masked"], dekrr_async_solve=a_launches[
        "dekrr_async_solve"], dekrr_cheb_solve=c_launches["dekrr_cheb_solve"])
    rows = timings(run["packed"], run) + chain_timings(run, a, c)
    for row in rows:
        row["max_abs_err"] = errs[row["name"]]
        row["launches"] = launches[row["name"]]
        print(f"time [{card}] {row['name']}: {row['ms']:.4f} ms, plain "
              f"{row['plain_ms']:.4f} ms, torch yardstick "
              f"{row['library_ms']:.4f} ms, bound {row['bound_ms']:.4f} ms "
              f"({row['bound_by']})")
    print(f"total: {time.perf_counter() - t_start:.1f} s")
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err",
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    print(card)
    print(json.dumps({"kernels": [{k: r[k] for k in keys} for r in rows]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": count}}))
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--cpu-rehearsal", action="store_true",
                    help="run the main path on the CPU at a small size")
    args = ap.parse_args(argv)
    try:
        return rehearse_on_cpu() if args.cpu_rehearsal else run_on_card()
    except PhaseError as exc:
        print(f"chip_smoke: FAILED: {exc}", file=sys.stderr)
        return 1


if __name__ == "__main__":
    sys.exit(main())
