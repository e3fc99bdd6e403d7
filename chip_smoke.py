"""Drive the PyTorch/CUDA port's main path on one NVIDIA card.

    python3 chip_smoke.py

1. Card: name and power limit (nvidia-smi), TF32 switched off.
2. Build: the three CUDA kernels from ``src/repro_torch/kernels/csrc``
   (one nvcc per source, in parallel), with each ``-Xptxas -v`` report.
3. Kernel phases: each kernel against its plain PyTorch version on the
   card, at the main path's shapes, in float64 and float32.
4. Main path at the paper's full width (Table 2, ``wave``): N = 63,600,
   d = 148, noniid_y over J = 10 nodes of circulant(10, (1, 2)), D_j = 200
   energy-selected DDRF features from D0 = 4,000 candidates per node,
   σ = 1, λ = 1e-6, c_nei = 0.01·N. pack_problem → solve_batched
   (cuda_fused, tol 1e-10) → solve_batched (cuda, the same rounds) →
   predict → RSE, checked against the port's own references.
5. Launch counts of the main path, zeroed just before it.
6. Kernel times by CUDA events beside their plain versions, a PyTorch
   yardstick and the least time the card could take.

The last line is ``{"ok": true, "device": {...}}``; any failed phase
exits non-zero before it. Without a CUDA device the script exits
non-zero. ``--cpu-rehearsal`` runs step 4 on the CPU at a small size
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
    scale = want.abs().max().item()
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
    return dict(exact_err=err, exact_bound=bound, rho=rho, last_res=last)


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
        launches=run["launches"]["rff_gram"],
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
        launches=run["launches"]["dekrr_step"],
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
        launches=run["launches"]["dekrr_solve"],
        ms=cuda_ms(lambda: dekrr_solve_cuda(*lay, out, res, work,
                                            num_rounds=CHUNK, dy=dy)),
        plain_ms=cuda_ms(lambda: dekrr_solve_reference(
            *lay, num_rounds=CHUNK, dy=dy, trace=True), reps=5),
        bound_ms=bms, bound_by=by,
        library_ms=cuda_ms(lambda: library_solve(run["theta"]), reps=5)))
    return rows


def check_launches(run: dict) -> None:
    got, rounds = run["launches"], run["rounds"]
    want = {"rff_gram": 2, "dekrr_solve": -(-rounds // CHUNK),
            "dekrr_step": rounds}
    if got != want:
        raise PhaseError(f"main path launch counts {got}, expected {want}")


# ------------------------------------------------------------------- main
def rehearse_on_cpu() -> int:
    """The main path on the CPU at a small size (plain kernel versions)."""
    run = main_path("cpu", subsample=2000, d_per_node=12, num_iters=200)
    checks = check_main_path(run)
    summary = dict(rounds=run["rounds"], rse=run["rse"],
                   launches=run["launches"], **checks)
    print(json.dumps({"cpu_rehearsal": summary}))
    return 0


def run_on_card() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available (torch.cuda."
              "is_available() is False); this script runs only on the card",
              file=sys.stderr)
        return 2
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

    rows = timings(run["packed"], run)
    for row in rows:
        row["max_abs_err"] = errs[row["name"]]
        print(f"time [{card}] {row['name']}: {row['ms']:.4f} ms, plain "
              f"{row['plain_ms']:.4f} ms, torch yardstick "
              f"{row['library_ms']:.4f} ms, bound {row['bound_ms']:.4f} ms "
              f"({row['bound_by']})")
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
