"""Drive the PyTorch/CUDA port's main paths on one NVIDIA card.

    python3 chip_smoke.py

1. Card: name and power limit (nvidia-smi), TF32 switched off.
2. Build: the seven CUDA sources of ``src/repro_torch/kernels/csrc``
   (one nvcc per source, in parallel), with each ``-Xptxas -v`` report,
   a summary of registers and spills of each kernel of ``rff_gram``
   (both routes), the round kernel and the three cluster chains
   (``dekrr_solve``, ``dekrr_async_solve``, ``dekrr_cheb_solve``),
   ``rff_gram``'s launch plans at the main path's shapes and at F = 600
   (the wide route) and the chains' ``chain_plan`` at J = 10 and 40.
3. Kernel phases: each solve-path kernel against its plain PyTorch
   version on the card, at the main path's shapes, in float64 and
   float32, with the invariants that hold bit for bit (``rff_gram``,
   F ∈ {561, 600, 1,100} on its wide route in f64 and F ∈ {1,025, 1,100}
   in f32 among the shapes, F = 600 at B = 10, N = 3,180 in three N
   chunks: two launches give the same bits and G == Gᵀ exactly; a solve
   launch
   == round launches; the masked round at all ones == the unmasked one;
   an async-chain launch == masked round launches plus the delivery
   rule; chunked Chebyshev launches == one launch), and the three
   cluster chains at J = 40, past the clusters the card holds at once,
   == round launches bit for bit (the Chebyshev chain == the scan of
   round launches with torch's elementwise update, `chebyshev_scan`).
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
   cuda, then chebyshev_solve_packed on cuda_fused, == cuda bit for bit,
   and strictly fewer rounds than plain Jacobi to the same error.
7. The featurize kernel (``rff_features``) against its plain versions:
   f64 and f32 at D = 200, d = 148, N ∈ {8, 64, 512} and a ragged
   D = 37, d = 5, N = 13 (f64 at rtol 1e-9); bf16 (``rff_features_lowp``)
   bit-equal to the plain bf16 version at 99% of the entries or more,
   and within the forward-error model bound of the f64 value at every
   entry. Then one launch for many nodes (the serving wave, J = 10 at
   N = 512, and a ragged D_j of 37, 200 and 64 in one launch) against
   the batched plain versions with the same checks, padded rows exact
   zeros, and each node bit-equal to its own launch in f64, f32, bf16.
8. Serving at full width: θ of the main path's cuda_fused solve and the
   DDRF maps taken into a ServeSnapshot (staleness residual from one
   more round), published to a SnapshotRegistry, and 512 test-split
   queries (widths 1–8, half network-mean, half per-node) answered by a
   2-replica DeKRRReplicaServer at each precision (None, bf16, int8):
   full precision == solver.predict at rtol 1e-9, replicas == one
   engine, every low-precision answer within the f32 GEMV's rounding of
   the same answer computed by the plain versions on the card, and
   within its attached bound, a second publish (θ after one more round)
   served as version 2, and one featurize launch per wave for all ten
   nodes (plus one calibration-stripe launch on the low-precision
   paths); p50, p99 and qps per precision, and at full precision on 1
   replica.
9. The decode-attention kernel (``flash_decode``) against its split plain
   version (the kernel's chunks, combined in chunk order) and its one-pass
   plain version at DECODE_SHAPES (2e-5), one long request (B 1, S 32,768)
   among them; two calls give the same bits, the cache beyond cur_index
   set to ±999 changes no bit, and a CUDA-graph replay gives the eager
   call's bits.
10. LLM serving at qwen1.5-0.5b's full width and depth (24 layers,
   d_model 1024, 16 heads, vocab 151,936; the port's seeded weights, no
   checkpoint): ServeEngine(batch 8, max_seq 512, backend cuda) serves
   16 requests (prompts of 16–128 seeded tokens, 32 new tokens each, two
   waves); the same requests again give the same tokens, one request
   alone equals sequential decode_step calls, the first wave's tokens
   teacher-forced through decode_step give logits on backend torch
   within LLM_LOGIT_TOL of backend cuda and with the int8 cache within
   5%, and flash_decode launches 24 times per decode step; tokens/s,
   p50/p99 per request and ms per decode step; one decode step's device
   time at the serving cache and at one long request (B 1, S 32,768, the
   last position: a 6.4 GB f32 cache) by CUDA-graph replay.
11. The paper's experiments (``repro_torch.paper``) at the synthetic
   stand-ins' full N: (a) Table 2's wave setting built with
   ``gram_fn=ops.gram_fn_for_solver`` (40 ``rff_gram`` launches at B 1,
   F 200, f32), θ from solve_exact within 2e-4 of the default solver's,
   one Gram block against its plain version, and one DKLA run timed;
   (b) Table 2 (DKLA, DKLA-DDRF, DeKRR-DDRF on the six stand-ins, three
   seeds, the mean improvement beside the paper's 25.5%); (c) its houses
   row for seed 0 from one set of CPU draws on the card and on the CPU,
   the RSEs at rtol 1e-9 and the same c; (d) the iteration cost
   (``pack_problem`` through ``rff_gram``, then ``solve_batched`` on
   ``cuda_fused``), µs and bytes a round; (e) CentralizedKRR on wave's
   31,800 pooled training columns (test RSE, time, peak memory), and at
   1,000 columns against the CPU.
12. Launch counts of each path and run, zeroed just before it, and
   ``pack_problem`` repeated warm.
13. Kernel times by CUDA events (timed on the device, behind a spin that
   lets the host queue the launches first) beside their plain versions,
   a PyTorch yardstick and the least time the card could take; the
   featurize kernel at the wave and at one node, ``rff_gram`` at the
   shape ``gram_fn_for_solver`` gives it (row ``rff_gram@gram_fn``),
   ``rff_gram``'s wide route at D_j = 600 with its two phases apart (the profiler's device
   time per kernel), and ``flash_decode`` at S 32,768 for B 8 and B 1 and
   at the serving cache (cur 128 and 512), there both warm (one cache
   launched again) and cold (24 distinct caches launched in turn, the 805
   MB a decode step's layers pass through L2), beside the fastest SDPA
   call. ``dekrr_solve`` and ``dekrr_async_solve``
   are timed in turns with their yardsticks (CHAIN_PAIRS pairs, the
   median of each), and each chain's time per round is printed beside
   the round kernel's.

The last line is ``{"ok": true, "device": {...}}``; any failed phase
exits non-zero before it. Without a CUDA device the script exits
non-zero. ``--cpu-rehearsal`` runs steps 4–6, 8, 10 and 11 on the CPU at
a small size (the kernels' plain versions; the LLM path on the reduced
qwen1.5-0.5b; Table 2 on two stand-ins at 600 samples), for the tests. ``--decode-timings [--src DIR]`` runs only
the ``flash_decode`` timings and the two decode steps of step 10 on the
card, with the ``repro_torch`` package of DIR/.. (``src`` by default), so
one call can time an earlier tree's kernel beside this one's.
"""
from __future__ import annotations

import argparse
import dataclasses
import itertools
import json
import math
import os
import re
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "src"))

# H100 SXM published peaks (NVIDIA data sheet): HBM3 bandwidth, the f64
# tensor-core rate (f32 outside the tensor cores has the same rate) and
# the dense bf16 tensor-core rate.
PEAK_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {torch.float64: 67e12, torch.float32: 67e12,
              torch.bfloat16: 989e12}

TOL = {torch.float64: 1e-9, torch.float32: 1e-4}
# rff_gram's phase (B, F, d, N): the main path's two calls (own blocks,
# slot blocks), N inside one column tile, ragged 16-row blocks, F past
# one group of Gram blocks; F = 561 and 600, past the clusters' shared
# memory in f64 (the wide route), at B = 10, N = 3,180 in three N chunks
# of the workspace; F = 1,025 and 1,100, the wide route in f32 too
GRAM_SHAPES = ((10, 200, 148, 3180), (40, 200, 148, 3180), (2, 200, 148, 21),
               (3, 70, 13, 300), (2, 330, 21, 700), (3, 561, 148, 333),
               (2, 600, 148, 700), (10, 600, 148, 3180), (1, 1025, 148, 700),
               (1, 1100, 148, 700))
# the wide route timed at the main path's own-block call with D_j = 600
GRAM_WIDE_TIMING = (10, 600, 148, 3180)
SPIN_CYCLES = 20_000_000    # ~10 ms at the H100's ~1.98 GHz SM clock

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
# J past the clusters the card holds at once (280 blocks of 1,024 threads
# at D = 200), so the cluster chains loop over nodes
J_LOOPED = 40
CHAIN_PAIRS = 5     # kernel / yardstick pairs timed in turns per chain
CHEB_TOL = 1e-8     # relative error of the rounds-to-tolerance comparison

# Serving: the featurize kernel's phase shapes (D, d, N), its batched
# cases (D_j per node, d, N: the serving wave and a ragged launch), and the
# replica server's load.
FEATURE_SHAPES = ((D_PER_NODE, 148, 8), (D_PER_NODE, 148, 64),
                  (D_PER_NODE, 148, 512), (37, 5, 13))
FEATURE_BATCHES = (((D_PER_NODE,) * J_NODES, 148, 512), ((37, 200, 64), 148, 13))
SERVE_N = 512       # the column bucket of the serving waves
SERVE_QUERIES = 512
SERVE_REPLICAS = 2
SERVE_BATCH = 64
PRECISIONS = (None, "bf16", "int8")
U_BF16 = 2.0 ** -8
U_F32 = 2.0 ** -24
BIT_EQUAL_SHARE = 0.99   # bf16 kernel vs its plain version (sum order)

# Decode attention: (B, H, K, dh, S, cur) of the kernel's phase — the
# five cases of tests/test_kernels_decode.py, then the heads of
# qwen1.5-0.5b (MHA), smollm-135m (GQA 3:1) and granite-3-8b (GQA 4:1,
# dh 128) at the serving batch and cache length, and one long request of
# qwen1.5-0.5b (B 1, S 32,768: 64 chunks of 512 positions) at its whole
# length and one past a chunk edge — and its timing shapes (B, H, K, dh,
# S): the registry's decode_32k length with the batch cut from 128 to 8 so
# the f32 cache (2.15 GB) fits beside the rest, and one long request.
DECODE_SHAPES = (
    (2, 8, 8, 64, 256, 200), (2, 8, 2, 64, 512, 512),
    (1, 16, 16, 128, 1024, 37), (4, 4, 1, 80, 300, 123),
    (3, 6, 3, 32, 96, 50),
    (8, 16, 16, 64, 512, 1), (8, 16, 16, 64, 512, 37),
    (8, 16, 16, 64, 512, 512),
    (8, 9, 3, 64, 512, 37), (8, 9, 3, 64, 512, 512),
    (8, 32, 8, 128, 512, 37), (8, 32, 8, 128, 512, 512),
    (1, 16, 16, 64, 32768, 32768), (1, 16, 16, 64, 32768, 513))
DECODE_TOL = 2e-5     # the reference kernel's own tolerance (sum order)
DECODE_TIMING = (8, 16, 16, 64, 32768)
DECODE_LONG = (1, 16, 16, 64, 32768)
# distinct serving caches launched in turn for the cold timing: one per
# layer of qwen1.5-0.5b, 805 MB at B 8, S 512, so each launch finds its
# cache evicted from the 50 MB L2 by the others, as a decode step does
DECODE_COLD_CACHES = 24

# LLM serving at qwen1.5-0.5b's full width and depth (seeded weights):
# 16 requests, prompts of 16–128 tokens, 32 new tokens each, 8 slots over
# a 512-position cache (2 waves).
LLM_ARCH = "qwen1_5_0_5b"
LLM_REQUESTS = 16
LLM_BATCH = 8
LLM_MAX_SEQ = 512
LLM_PROMPT = (16, 128)
LLM_NEW_TOKENS = 32
# cuda vs torch decode logits, as a share of max|logit|: the same f32
# function with sums in another order, amplified through 24 layers
LLM_LOGIT_TOL = 1e-3
# int8 vs f32 cache, the bound of test_int8_kv_cache_decode_close_to_bf16
INT8_LOGIT_TOL = 0.05

# the paper's experiments (repro_torch.paper): θ of a gram_fn solver
# against the default one, the reference's tolerance for this pairing
# (tests/test_kernels_rff.py::test_gram_fn_for_solver_integration)
GRAM_FN_TOL = 2e-4
PAPER_DBAR_WAVE = 200           # Table 2's D̄ for wave (paper.common)
PAPER_PAIR = ("houses", 0)      # the Table 2 row run on the card and the CPU
PAPER_RTOL = 1e-9               # card against CPU, float64
KRR_CHECK_SUBSAMPLE = 2000      # CentralizedKRR card against CPU


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
        raise PhaseError(f"{name}: disagrees beyond rtol {rtol:g} (max abs "
                         f"err {max_err:.3e}, max |ref| {scale:.3e})")
    return max_err


def cuda_ms(fn, *, reps: int = 20, warmup: int = 3) -> float:
    """Mean device time of fn by CUDA events. The device spins ~10 ms
    before the start event, so the host has queued the timed launches by
    then: a launch shorter than its host-side call is timed on the
    device, not at the pace the host enqueues it."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(SPIN_CYCLES)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def paired_ms(kernel, yardstick, *, pairs: int = CHAIN_PAIRS, reps: int,
              yardstick_reps: int, warmup: int = 1) -> tuple[float, float]:
    """Medians of `pairs` cuda_ms readings of a kernel and of its
    yardstick, taken in turns, so a drift of the card over the call falls
    on both alike."""
    ks, ys = [], []
    for _ in range(pairs):
        ks.append(cuda_ms(kernel, reps=reps, warmup=warmup))
        ys.append(cuda_ms(yardstick, reps=yardstick_reps, warmup=warmup))
    return statistics.median(ks), statistics.median(ys)


def bound_ms(nbytes: float, flops: float, dtype: torch.dtype):
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[dtype] * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                 else "operations")


def kernel_name(mangled: str) -> str:
    """``name<f64>`` of a kernel template's mangled entry name
    (``_ZN<len><namespace><len><name>I{d,f}E...``)."""
    m = re.match(r"_ZN(\d+)", mangled)
    if not m:
        return mangled
    rest = mangled[m.end() + int(m.group(1)):]
    m = re.match(r"(\d+)", rest)
    if not m:
        return mangled
    name = rest[m.end():m.end() + int(m.group(1))]
    kind = {"IdE": "f64", "IfE": "f32"}.get(
        rest[m.end() + int(m.group(1)):][:3])
    return f"{name}<{kind}>" if kind else name


def ptxas_summary(report: str) -> list[str]:
    """Registers, spills and static shared memory of each kernel entry in
    an ``nvcc -Xptxas -v`` report, one line per entry."""
    out, name = [], None
    for line in report.splitlines():
        if "Compiling entry function" in line:
            name = kernel_name(line.split("'")[1])
        elif "spill stores" in line and name:
            spill = line.strip()
        elif "Used" in line and "registers" in line and name:
            out.append(f"{name}: {line.split('info    :')[-1].strip()}; "
                       f"{spill}")
            name = None
    return out


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
        for shape in GRAM_SHAPES:
            args = gram_operands(*shape, dtype, seed=sum(shape))
            gram, zy = ops.rff_gram_batched(*args)
            gref, zref = rff_gram_batched_reference(*args)
            again = ops.rff_gram_batched(*args)
            torch.cuda.synchronize()
            tag = f"(B, F, d, N)={shape} {dtype}"
            e = max(compare(f"rff_gram {tag}", gram, gref, dtype),
                    compare(f"rff_gram zy {tag}", zy, zref, dtype))
            if not (torch.equal(again[0], gram) and torch.equal(again[1], zy)):
                raise PhaseError(f"rff_gram: two launches differ ({tag})")
            if not torch.equal(gram, gram.transpose(1, 2)):
                raise PhaseError(f"rff_gram: G ≠ Gᵀ ({tag})")
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
        # J past the clusters the card holds: clusters loop over nodes
        args = dekrr_operands(J_LOOPED, 4, D_PER_NODE, 1, J_LOOPED, dtype,
                              seed=J_LOOPED)
        ident = torch.arange(J_LOOPED, device="cuda", dtype=torch.int32)
        args = args[:6] + (ident,) + args[7:]
        seq = args[4]
        for _ in range(PHASE_ROUNDS):
            seq = ops.dekrr_step(*args[:4], seq, *args[5:])
        fused, res = ops.dekrr_solve(*args, num_rounds=PHASE_ROUNDS,
                                     trace=True)
        want, wres = dekrr_solve_reference(*_raw_layout(args),
                                           num_rounds=PHASE_ROUNDS, dy=1,
                                           trace=True)
        torch.cuda.synchronize()
        case = f"J={J_LOOPED} {dtype}"
        e = max(compare(f"dekrr_solve {case}", fused, want, dtype),
                compare(f"dekrr_solve trace {case}", res, wres, dtype))
        if f64:
            errs["dekrr_solve"] = max(errs["dekrr_solve"], e)
        if not torch.equal(seq, fused):
            raise PhaseError(f"dekrr_solve ≠ {PHASE_ROUNDS} dekrr_step "
                             f"launches bit for bit ({case})")
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
    from repro_torch.kernels import ops
    from repro_torch.kernels.dekrr_solve import dekrr_async_solve_reference
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
                    _check_async_scanned(got, a_args, gossip, censored, tag)
            # kernel 6: the Chebyshev chain
            g, d, s, p, theta, nbr_idx, self_idx, nbr_mask = args
            gen = torch.Generator(device="cuda").manual_seed(seed + 2)
            kw = dict(dtype=dtype, device="cuda", generator=gen)
            delta = torch.randn(tuple(d.shape), **kw)
            alphas = 0.5 + torch.rand((rounds,), **kw)
            betas = 0.3 * torch.rand((rounds,), **kw)
            c_args = (g, d, s, p, theta, delta, nbr_idx, self_idx, nbr_mask,
                      alphas, betas)
            note("dekrr_cheb_solve", _check_cheb_chain(c_args, dy, case))
            if t_rows == J_NODES:
                ident = torch.arange(J_NODES, dtype=torch.int32,
                                     device="cuda")
                note("dekrr_cheb_solve", _check_cheb_chain(
                    c_args[:7] + (ident,) + c_args[8:], dy, case))
        # the async chain at J past the clusters the card holds at once
        a_args = async_operands(J_LOOPED, 4, D_PER_NODE, 1, J_LOOPED, dtype,
                                rounds, seed=J_LOOPED)
        got = ops.dekrr_async_solve(*a_args, censored=True, trace=True)
        w = dekrr_async_solve_reference(*_async_raw(a_args), censored=True,
                                        edge_gossip=False, dy=1, trace=True)
        case = f"J={J_LOOPED} censored {dtype}"
        want = (w[0], w[1], w[2].reshape(a_args[6].shape), w[3][:rounds])
        for what, a, b in zip(("θ", "sent", "buffers", "res"), got[:4], want):
            note("dekrr_async_solve",
                 compare(f"dekrr_async_solve {what} {case}", a, b, dtype))
        if not torch.equal(got[4], w[4][:rounds]):
            raise PhaseError(f"dekrr_async_solve broadcast flags differ "
                             f"({case})")
        _check_async_scanned(got, a_args, "bernoulli", True, case)
        # the Chebyshev chain at J past the clusters the card holds at once
        g, d, s, p, theta, nbr_idx, _, nbr_mask = dekrr_operands(
            J_LOOPED, 4, D_PER_NODE, 1, J_LOOPED, dtype, seed=J_LOOPED + 1)
        gen = torch.Generator(device="cuda").manual_seed(J_LOOPED + 2)
        kw = dict(dtype=dtype, device="cuda", generator=gen)
        c_args = (g, d, s, p, theta, torch.randn(tuple(d.shape), **kw),
                  nbr_idx, torch.arange(J_LOOPED, device="cuda",
                                        dtype=torch.int32), nbr_mask,
                  0.5 + torch.rand((rounds,), **kw),
                  0.3 * torch.rand((rounds,), **kw))
        note("dekrr_cheb_solve",
             _check_cheb_chain(c_args, 1, f"J={J_LOOPED} {dtype}"))
        print(f"chain kernel phases {dtype}: pass", flush=True)
    return errs


def _check_cheb_chain(c_args, dy: int, case: str) -> float:
    """The Chebyshev chain against its plain version; where self_idx is
    the identity over T = J rows, also chunked launches == one launch and
    == `chebyshev_scan` over round launches (the per-round `cuda`
    backend's arithmetic), bit for bit. Returns the largest error."""
    from repro_torch.core.acceleration import chebyshev_scan
    from repro_torch.kernels import ops
    from repro_torch.kernels.dekrr_solve import dekrr_cheb_solve_reference

    g, d, s, p, theta, delta, nbr_idx, self_idx, nbr_mask, al, be = c_args
    dtype, ndim, j_nodes = d.dtype, d.ndim, d.shape[0]
    lay = _raw_layout((g, d, s, p, theta, nbr_idx, self_idx, nbr_mask))
    got = ops.dekrr_cheb_solve(*c_args, trace=True)
    w = dekrr_cheb_solve_reference(*lay[:5], ops._flatten_dy(delta),
                                   *lay[5:], al, be, dy=dy, trace=True)
    want = (ops._unflatten_dy(w[0], dy, ndim),
            ops._unflatten_dy(w[1], dy, ndim), w[2])
    torch.cuda.synchronize()
    err = max(compare(f"dekrr_cheb_solve {what} {case}", a, b, dtype)
              for what, a, b in zip(("θ", "p", "res"), got, want))
    ident = torch.arange(j_nodes, dtype=torch.int32, device="cuda")
    if theta.shape[0] != j_nodes or not torch.equal(self_idx, ident):
        return err
    first = ops.dekrr_cheb_solve(*c_args[:9], al[:3], be[:3], trace=True)
    rest = ops.dekrr_cheb_solve(*c_args[:4], first[0], first[1],
                                *c_args[6:9], al[3:], be[3:], trace=True)
    scanned = chebyshev_scan(
        lambda th: ops.dekrr_step(g, d, s, p, th, nbr_idx, ident, nbr_mask),
        theta, al, be, p0=delta, record_deltas=True)
    torch.cuda.synchronize()
    if not (torch.equal(rest[0], got[0]) and torch.equal(rest[1], got[1])
            and torch.equal(torch.cat([first[2], rest[2]]), got[2])):
        raise PhaseError(f"dekrr_cheb_solve chunked ≠ unchunked bit for bit "
                         f"({case})")
    if not (torch.equal(scanned[0], got[0]) and torch.equal(scanned[1], got[1])
            and torch.equal(scanned[3], got[2].amax(dim=1))):
        raise PhaseError(f"dekrr_cheb_solve ≠ {al.shape[0]} dekrr_step "
                         f"launches with chebyshev_scan's update bit for bit "
                         f"({case})")
    return err


def _check_async_scanned(got, a_args, gossip: str, censored: bool,
                         case: str) -> None:
    """One async-chain launch of R rounds == R masked round launches
    followed by the delivery rule (the per-round `cuda` backend), bit for
    bit. a_args as `async_operands` makes them, with T = J."""
    from repro_torch.dist import (AsyncGossipState, PackedProblem,
                                  async_step_batched)
    g, d, s, p, theta, sent, bufs, nbr_idx, nbr_mask, act, thr = a_args
    packed = PackedProblem(
        g=g, d=d, s=s, p=p,
        theta_mask=torch.ones_like(d[..., 0] if d.ndim == 3 else d),
        nbr_idx=nbr_idx, nbr_mask=nbr_mask)
    state = AsyncGossipState(theta, sent, bufs)
    for r in range(act.shape[0]):
        state, _ = async_step_batched(packed, state, act[r], thr[r],
                                      gossip=gossip, censored=censored,
                                      backend="cuda")
    torch.cuda.synchronize()
    if not (torch.equal(got[0], state.theta)
            and torch.equal(got[1], state.sent)
            and torch.equal(got[2], state.buffers)):
        raise PhaseError(f"dekrr_async_solve ≠ {act.shape[0]} "
                         f"dekrr_step_masked rounds bit for bit ({case})")


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
                launches=launches, n_train=n_train, preds=preds, test=test)


def warm_pack_ms(run: dict, repeats: int = 3) -> list[float]:
    """Host-clock ms of `pack_problem` on the main path's solver, repeated
    after the timed (cold) first call; the launches it makes are not the
    main path's."""
    from repro_torch.dist import pack_problem
    out = []
    for _ in range(repeats):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        pack_problem(run["solver"], gram_backend="cuda", device="cuda")
        torch.cuda.synchronize()
        out.append((time.perf_counter() - t0) * 1e3)
    return out


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
    if not torch.equal(theta, c["per_round"][0]):
        raise PhaseError("Chebyshev cuda_fused ≠ cuda bit for bit")
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


# ------------------------------------------------------------ featurize
def _lowp_bound(omega, bias, x, scale):
    """s·((3u + γ_d)(|Ω||x| + |b|) + 3u), the bf16 featurize model bound
    per entry, u = 2⁻⁸, in float64."""
    dim = omega.shape[1]
    nu = min(dim * U_BF16, 0.5)
    mag = omega.abs() @ x.abs() + bias.abs()[:, None]
    return scale * ((3 * U_BF16 + nu / (1 - nu)) * mag + 3 * U_BF16)


def features_phase() -> dict[str, float]:
    """The featurize kernel against its plain versions on the card:
    f64/f32 at rtol TOL[dtype]; bf16 bit-equal to the plain bf16 version
    at a share of at least BIT_EQUAL_SHARE of the entries (the f32 sums
    may run in another order), and within the model bound of the f64
    value. Returns the largest f64 error and the largest bf16 difference
    from the plain bf16 version."""
    from repro_torch.kernels import ops
    from repro_torch.kernels.rff_features import (rff_features_lowp_reference,
                                                  rff_features_reference)

    errs = {"rff_features": 0.0, "rff_features_lowp": 0.0}
    shares = []
    for d_feat, dim, n in FEATURE_SHAPES:
        gen = torch.Generator(device="cuda").manual_seed(d_feat * n)
        kw = dict(dtype=torch.float64, device="cuda", generator=gen)
        omega = torch.randn((d_feat, dim), **kw) / SIGMA
        bias = torch.rand((d_feat,), **kw) * (2 * math.pi)
        x = torch.randn((dim, n), **kw)
        scale = math.sqrt(2.0 / d_feat)
        case = f"D={d_feat} d={dim} N={n}"
        for dtype in (torch.float64, torch.float32):
            args = [t.to(dtype) for t in (omega, bias, x)]
            got = ops.rff_features(*args, scale=scale)
            want = rff_features_reference(*args, scale=scale)
            torch.cuda.synchronize()
            e = compare(f"rff_features {case} {dtype}", got, want, dtype)
            if dtype == torch.float64:
                errs["rff_features"] = max(errs["rff_features"], e)
        x32 = x.float()
        got = ops.rff_features_lowp(omega, bias, x32, scale=scale)
        plain = rff_features_lowp_reference(omega, bias, x32, scale=scale)
        exact = torch.cos(omega @ x32.double() + bias[:, None]) * scale
        bound = _lowp_bound(omega, bias, x32.double(), scale)
        torch.cuda.synchronize()
        err = (got.double() - exact).abs()
        if not (torch.isfinite(got).all() and (err <= bound).all()):
            worst = (err / bound).max().item()
            raise PhaseError(f"rff_features_lowp {case}: an entry lies "
                             f"outside the bf16 model bound (max "
                             f"|err|/bound {worst:.3f})")
        share = (got == plain).double().mean().item()
        if share < BIT_EQUAL_SHARE:
            raise PhaseError(f"rff_features_lowp {case}: only {share:.4f} "
                             f"of the entries are bit-equal to the plain "
                             f"bf16 version (needs {BIT_EQUAL_SHARE})")
        errs["rff_features_lowp"] = max(errs["rff_features_lowp"],
                                        (got - plain).abs().max().item())
        shares.append((case, share, (err / bound).max().item()))
    for d_feats, dim, n in FEATURE_BATCHES:
        e, e_lo, share, worst = batched_features_case(d_feats, dim, n)
        errs["rff_features"] = max(errs["rff_features"], e)
        errs["rff_features_lowp"] = max(errs["rff_features_lowp"], e_lo)
        shares.append((f"J={len(d_feats)} D_j={sorted(set(d_feats))} "
                       f"d={dim} N={n}", share, worst))
    print("featurize phase: pass (f64/f32 vs plain; batched == per-node "
          "launches bit for bit in f64, f32 and bf16; bf16 share bit-equal "
          "to plain and max |err|/model bound: "
          + ", ".join(f"{c}: {sh:.4f}, {r:.3g}" for c, sh, r in shares)
          + ")", flush=True)
    return errs


def batched_features_case(d_feats, dim, n):
    """One launch for J nodes of D_j features against the batched plain
    versions (f64/f32 at TOL, bf16 by BIT_EQUAL_SHARE and the model bound),
    padded rows exact zeros, and every node bit-equal to its own launch in
    f64, f32 and bf16. The padded Ω rows hold NaN, which must not reach Z.
    Returns the largest f64 error, the largest bf16 difference from the
    plain version, the bf16 share bit-equal to it and the largest
    |err|/model bound."""
    from repro_torch.kernels import ops
    from repro_torch.kernels.rff_features import (
        rff_features_batched_reference, rff_features_bf16_batched_reference)

    gen = torch.Generator(device="cuda").manual_seed(sum(d_feats) + n)
    kw = dict(dtype=torch.float64, device="cuda", generator=gen)
    j, d_max = len(d_feats), max(d_feats)
    omega = torch.full((j, d_max, dim), float("nan"), dtype=torch.float64,
                       device="cuda")
    bias = torch.zeros((j, d_max), dtype=torch.float64, device="cuda")
    for i, dj in enumerate(d_feats):
        omega[i, :dj] = torch.randn((dj, dim), **kw) / SIGMA
        bias[i, :dj] = torch.rand((dj,), **kw) * (2 * math.pi)
    x = torch.randn((dim, n), **kw)
    scales = [math.sqrt(2.0 / dj) for dj in d_feats]
    case = f"batched J={j} D_j={sorted(set(d_feats))} d={dim} N={n}"

    def per_node_equal(got, one, tag):
        for i, dj in enumerate(d_feats):
            if not torch.equal(got[i, dj:], torch.zeros_like(got[i, dj:])):
                raise PhaseError(f"{tag} {case}: padded rows of node {i} "
                                 f"are not exact zeros")
            if not torch.equal(got[i, :dj], one(i, dj)):
                raise PhaseError(f"{tag} {case}: node {i} differs from its "
                                 f"own launch")

    err = 0.0
    for dtype in (torch.float64, torch.float32):
        om, bi, xx = (t.to(dtype) for t in (omega, bias, x))
        got = ops.rff_features_batched(om, bi, xx, scale=scales,
                                       d_feat=d_feats)
        want = rff_features_batched_reference(om, bi, xx, scale=scales,
                                              d_feat=d_feats)
        torch.cuda.synchronize()
        e = compare(f"rff_features {case} {dtype}", got, want, dtype)
        if dtype == torch.float64:
            err = e
        per_node_equal(got, lambda i, dj: ops.rff_features(
            om[i, :dj], bi[i, :dj], xx, scale=scales[i]),
            f"rff_features {dtype}")
    x32 = x.float()
    bf16 = torch.bfloat16
    got = ops.rff_features_lowp_batched(omega, bias, x32, scale=scales,
                                        d_feat=d_feats)
    plain = rff_features_bf16_batched_reference(
        omega.to(bf16), bias.to(bf16), x32.to(bf16), d_feat=d_feats).float()
    torch.cuda.synchronize()
    per_node_equal(got, lambda i, dj: ops.rff_features_lowp(
        omega[i, :dj], bias[i, :dj], x32, scale=scales[i]),
        "rff_features_lowp")
    equal, worst, diff = 0, 0.0, 0.0
    for i, (dj, s) in enumerate(zip(d_feats, scales)):
        mine, ref = got[i, :dj], plain[i, :dj] * s
        exact = torch.cos(omega[i, :dj] @ x32.double()
                          + bias[i, :dj, None]) * s
        bound = _lowp_bound(omega[i, :dj], bias[i, :dj], x32.double(), s)
        e = (mine.double() - exact).abs()
        if not (torch.isfinite(mine).all() and (e <= bound).all()):
            raise PhaseError(f"rff_features_lowp {case}: an entry of node "
                             f"{i} lies outside the bf16 model bound")
        worst = max(worst, (e / bound).max().item())
        equal += (mine == ref).sum().item()
        diff = max(diff, (mine - ref).abs().max().item())
    share = equal / (sum(d_feats) * n)
    if share < BIT_EQUAL_SHARE:
        raise PhaseError(f"rff_features_lowp {case}: only {share:.4f} of "
                         f"the entries are bit-equal to the plain bf16 "
                         f"version (needs {BIT_EQUAL_SHARE})")
    return err, diff, share, worst


# -------------------------------------------------------------- serving
def serve_snapshot(run: dict, theta: torch.Tensor, version: int):
    """A ServeSnapshot of the packed θ with the main path's DDRF maps and
    StalenessBound(version, 0, 0, max|F(θ) − θ|); also returns F(θ), the
    θ after one more round (its residual round, on the cuda backend)."""
    from repro_torch.dist import step_batched, unpack_theta
    from repro_torch.stream import ServeSnapshot, StalenessBound

    packed = run["packed"]
    nxt = step_batched(packed, theta, backend="cuda")
    residual = (nxt - theta).abs().max().item()
    snap = ServeSnapshot(
        feature_maps=tuple(run["solver"].feature_maps),
        theta=tuple(unpack_theta(packed, theta)),
        staleness=StalenessBound(version, 0, 0, residual))
    return snap, nxt


def serve_queries(test, count: int, seed: int, uid0: int = 0) -> list:
    """``count`` queries of 1–8 test-split columns: even uids ask for the
    network mean (columns from any node), odd ones for node j's local
    predictor (columns from node j's split). Width-1 queries are 1-D."""
    from repro_torch.serve import KernelQuery

    rng = np.random.default_rng(seed)
    xs = [nd.x.cpu().numpy() for nd in test]
    out = []
    for i in range(count):
        j = int(rng.integers(len(xs)))
        width = int(rng.integers(1, 9))
        cols = rng.integers(0, xs[j].shape[1], width)
        x = xs[j][:, cols]
        out.append(KernelQuery(uid=uid0 + i, x=x[:, 0] if width == 1 else x,
                               node=None if i % 2 == 0 else j))
    return out


def serve_path(run: dict, *, queries: int, seed: int = 1) -> dict:
    """The serving tier on the main path's solution: snapshot → registry
    → a replica server per precision, then a second publish."""
    from repro_torch.serve import DeKRRReplicaServer, DeKRRServeEngine
    from repro_torch.stream import SnapshotRegistry

    snap, theta2 = serve_snapshot(run, run["theta"], version=1)
    registry = SnapshotRegistry()
    registry.publish(snap)
    test = run["test"]
    out = dict(snap=snap, registry=registry, runs={})
    for precision in PRECISIONS:
        srv = DeKRRReplicaServer(registry, replicas=SERVE_REPLICAS,
                                 batch_size=SERVE_BATCH, backend="cuda",
                                 precision=precision)
        srv.run(serve_queries(test, SERVE_BATCH, seed + 100))   # warm-up
        before = srv.waves_served
        qs = serve_queries(test, queries, seed)
        _, secs, launches = _launched(lambda: srv.run(qs))
        out["runs"][precision] = dict(queries=qs, report=srv.report(),
                                      waves=srv.waves_served - before,
                                      secs=secs, launches=launches)
    out["engine"] = DeKRRServeEngine(registry, batch_size=SERVE_BATCH,
                                     backend="cuda").run(
        serve_queries(test, queries, seed))
    # the same full-precision load on one replica, beside the two above
    one = DeKRRReplicaServer(registry, replicas=1, batch_size=SERVE_BATCH,
                             backend="cuda")
    one.run(serve_queries(test, SERVE_BATCH, seed + 100))     # warm-up
    one.run(serve_queries(test, queries, seed))
    out["one_replica"] = one.report()
    snap2, _ = serve_snapshot(run, theta2, version=2)
    out["version2"] = registry.publish(snap2)
    out["snap2"] = snap2
    srv = DeKRRReplicaServer(registry, replicas=SERVE_REPLICAS,
                             batch_size=SERVE_BATCH, backend="cuda")
    out["after"] = srv.run(serve_queries(test, SERVE_BATCH, seed + 1,
                                         uid0=queries))
    return out


def _predict_all(solver, theta, queries) -> list:
    """solver.predict on each query's columns, one call per node choice."""
    groups: dict = {}
    for i, q in enumerate(queries):
        groups.setdefault(q.node, []).append(i)
    want = [None] * len(queries)
    for node, idx in groups.items():
        blocks = [np.asarray(queries[i].x).reshape(
            queries[i].x.shape[0], -1) for i in idx]
        x = torch.as_tensor(np.concatenate(blocks, axis=1),
                            device=theta[0].device)
        pred = solver.predict(theta, x, node=node).cpu().numpy()
        start = 0
        for i, blk in zip(idx, blocks):
            want[i] = pred[start:start + blk.shape[1]]
            start += blk.shape[1]
    return want


def _answers(queries) -> np.ndarray:
    return np.concatenate([np.atleast_1d(np.asarray(q.prediction,
                                                    dtype=np.float64))
                           for q in queries])


def _plain_lowp(snap, queries, precision: str):
    """The low-precision answers to ``queries`` computed by the plain
    versions on the snapshot's device, column by column: bf16 features
    (`rff_features_lowp_reference`; the bf16 `featurize` for cos_sin
    maps), then the f32 GEMV (bf16) or the int8 quantization of θ and of
    each feature column with an exact product (int8). Returns the answers
    and, per answer entry, the rounding two orders of the f32 sums may
    differ by: 2γ_D·|θ₃₂|ᵀ|z| per node plus 4u·Σ|f_j| for the mean."""
    from repro_torch.core.rff import FeatureMap, featurize
    from repro_torch.kernels.rff_features import rff_features_lowp_reference

    blocks = [np.asarray(q.x, dtype=np.float64).reshape(q.x.shape[0], -1)
              for q in queries]
    x32 = torch.as_tensor(np.concatenate(blocks, axis=1),
                          device=snap.device).float()
    bf16 = torch.bfloat16
    fs, tols = [], []
    for fm, theta in zip(snap.feature_maps, snap.theta):
        t32 = (theta[:, None] if theta.ndim == 1 else theta).float()
        d_feat = t32.shape[0]
        if fm.kind == "cos_bias":
            z = rff_features_lowp_reference(
                fm.omega, fm.bias, x32,
                scale=math.sqrt(2.0 / fm.num_frequencies))
        else:
            lo = FeatureMap(omega=fm.omega.to(bf16), bias=None, kind=fm.kind)
            z = featurize(lo, x32.to(bf16)).float()
        if precision == "int8":
            tscale = t32.abs().max(dim=0).values.clamp_min(1e-30) / 127.0
            tq = torch.clamp(torch.round(t32 / tscale), -127, 127)
            c = z.abs().max(dim=0).values.clamp_min(1e-30) / 127.0
            zq = torch.clamp(torch.round(z / c), -127, 127)
            f = (tq.T.double() @ zq.double()).float() * tscale[:, None] \
                * c[None, :]
        else:
            f = t32.T @ z
        nu = min(d_feat * U_F32, 0.5)
        fs.append(f.double())
        tols.append(2 * nu / (1 - nu) * (t32.abs().T @ z.abs()).double())
    fs, tols = torch.stack(fs), torch.stack(tols)     # [J, Dyy, columns]
    mean_tol = tols.mean(dim=0) + 4 * U_F32 * fs.abs().mean(dim=0)
    want, tol, start = [], [], 0
    for q, blk in zip(queries, blocks):
        sl = slice(start, start + blk.shape[1])
        start += blk.shape[1]
        if q.node is None:
            want.append(fs.mean(dim=0)[:, sl])
            tol.append(mean_tol[:, sl])
        else:
            want.append(fs[q.node][:, sl])
            tol.append(tols[q.node][:, sl])
    flat = lambda ts: np.concatenate([t.cpu().numpy().ravel() for t in ts])
    return flat(want), flat(tol)


def check_serve_path(sv: dict, run: dict, on_card: bool) -> dict:
    """The serving checks; raises on failure."""
    solver = run["solver"]
    runs = sv["runs"]
    full = runs[None]["queries"]
    hi = _answers(full)
    want = np.concatenate(_predict_all(solver, sv["snap"].theta, full))
    as_t = torch.from_numpy
    err = compare("full-precision answers vs solver.predict", as_t(hi),
                  as_t(want), torch.float64)
    compare("2 replicas vs one engine", as_t(hi),
            as_t(_answers(sv["engine"])), torch.float64)
    if any(q.staleness != sv["snap"].staleness for q in full):
        raise PhaseError("a full-precision answer carries another "
                         "staleness than its snapshot's")
    n_bias = sum(fm.kind == "cos_bias" for fm in solver.feature_maps)
    out = dict(err=err, bounds={}, plain={}, scale=float(np.abs(hi).max()))
    for precision, r in runs.items():
        if len(r["queries"]) != len(full) or not all(
                q.done for q in r["queries"]):
            raise PhaseError(f"precision {precision}: not every query "
                             f"was answered")
        waves = r["waves"]
        if precision is None:
            expect = {"rff_features": waves if n_bias else 0}
        else:
            lo = _answers(r["queries"])
            sizes = [np.atleast_1d(np.asarray(q.prediction)).size
                     for q in r["queries"]]
            bound = np.repeat([q.staleness.precision for q in r["queries"]],
                              sizes)
            plain, tol = _plain_lowp(sv["snap"], r["queries"], precision)
            off = np.abs(lo - plain)
            if not (off <= tol).all():
                raise PhaseError(f"precision {precision}: an answer differs "
                                 f"from the plain versions' by more than "
                                 f"the f32 sums' rounding (max "
                                 f"|f_lo − plain|/tol "
                                 f"{(off / tol).max():.3f})")
            out["plain"][precision] = (float(off.max()),
                                       float((off / tol).max()))
            gap = np.abs(lo - hi)
            if not (np.isfinite(lo).all() and (gap <= bound).all()):
                raise PhaseError(f"precision {precision}: an answer lies "
                                 f"outside its attached bound (max "
                                 f"|f_lo − f_hi|/bound "
                                 f"{(gap / bound).max():.3f})")
            out["bounds"][precision] = (float(gap.max()),
                                        float(bound.min()),
                                        float(bound.max()))
            expect = {"rff_features_lowp": waves if n_bias else 0,
                      "rff_features": waves if n_bias else 0}
        got = {k: v for k, v in r["launches"].items() if v}
        expect = {k: v for k, v in expect.items() if v}
        if got != (expect if on_card else {}):
            raise PhaseError(f"serving precision={precision}: launch "
                             f"counts {got} over {waves} waves, expected "
                             f"{expect if on_card else {}}")
    after = sv["after"]
    if sv["version2"] != 2 or any(
            q.staleness.theta_version != 2 for q in after):
        raise PhaseError("queries submitted after the second publish were "
                         "not served from version 2")
    compare("version-2 answers vs solver.predict", as_t(_answers(after)),
            as_t(np.concatenate(_predict_all(solver, sv["snap2"].theta,
                                             after))), torch.float64)
    return out


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
        # the projection, and the Gram's upper triangle (G is symmetric)
        flops += 2 * f * d_in * n_live + f * (f + 1) * n_live
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
    ms, library_ms = paired_ms(
        lambda: dekrr_solve_cuda(*lay, out, res, work, num_rounds=CHUNK,
                                 dy=dy),
        lambda: library_solve(run["theta"]), reps=20, yardstick_reps=5)
    # where a chain round's time goes: the same launch without the trace,
    # and CHUNK round launches replayed from a CUDA graph (no host between)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(2):
            dekrr_step_cuda(*lay, out, dy=dy)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(CHUNK):
            dekrr_step_cuda(*lay, out, dy=dy)
    rows.append(dict(
        name="dekrr_solve", route="cuda",
        source="src/repro_torch/kernels/csrc/dekrr_solve.cu",
        replaces="src/repro/kernels/dekrr_solve.py:204", ms=ms,
        plain_ms=cuda_ms(lambda: dekrr_solve_reference(
            *lay, num_rounds=CHUNK, dy=dy, trace=True), reps=5),
        bound_ms=bms, bound_by=by, library_ms=library_ms, rounds=CHUNK,
        untraced_ms=cuda_ms(lambda: dekrr_solve_cuda(
            *lay, out, None, work, num_rounds=CHUNK, dy=dy)),
        graph_round_ms=cuda_ms(graph.replay) / CHUNK))
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
    ms, library_ms = paired_ms(
        lambda: dekrr_async_solve_cuda(
            *raw, *outs, work, flags, censored=True, edge_gossip=False,
            dy=dy),
        lambda: async_solve_batched(
            packed, rounds, masks, config=config, backend="torch",
            return_trace=True), reps=3, yardstick_reps=1)
    rows_out.append(dict(
        name="dekrr_async_solve", route="cuda",
        source="src/repro_torch/kernels/csrc/dekrr_async_solve.cu",
        replaces="src/repro/kernels/dekrr_solve.py:457", ms=ms,
        plain_ms=cuda_ms(lambda: dekrr_async_solve_reference(
            *raw, censored=True, edge_gossip=False, dy=dy, trace=True),
            reps=2, warmup=1),
        bound_ms=bms, bound_by=by, library_ms=library_ms, rounds=rounds))

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
            return_trace=True), reps=3, warmup=1), rounds=c["rounds"]))
    return rows_out


def feature_timings(run: dict) -> list[dict]:
    """The featurize kernel by CUDA events, f64 and bf16 (bf16 operands at
    unit scale, as the low-precision path launches it), on N = 512 test
    columns (the column bucket of the serving waves): at one node's shape
    (D = 200, d = 148; rows ``rff_features`` and ``rff_features_lowp``,
    timed as in earlier runs) and at the wave shape the main path gives
    it (the ten maps in one launch; rows ``…@wave``, with the cost of the
    ten single-node launches a wave made before, ``per_node_ms``)."""
    from repro_torch.kernels.ops import _node_table
    from repro_torch.kernels.rff_features import (
        rff_features_batched_reference, rff_features_bf16_batched_reference,
        rff_features_cuda)

    fmaps = run["solver"].feature_maps
    omega = torch.stack([fm.omega for fm in fmaps]).contiguous()
    bias = torch.stack([fm.bias for fm in fmaps]).contiguous()
    x = torch.cat([nd.x for nd in run["test"]], dim=1)[:, :SERVE_N]
    x = x.contiguous()
    j, d_feat, dim = omega.shape
    n = x.shape[1]
    scales = [math.sqrt(2.0 / fm.num_frequencies) for fm in fmaps]
    d_feats = [fm.num_frequencies for fm in fmaps]
    dev = omega.device
    # the product, the bias add and the scale of one map (cosines not
    # counted)
    flops = 2 * d_feat * dim * n + 2 * d_feat * n
    src = dict(route="cuda",
               source="src/repro_torch/kernels/csrc/rff_features.cu",
               replaces="src/repro/kernels/rff_features.py:33")

    def rows(name, om, bi, xx, sc, plain, library, dtype):
        """The single-node row and the wave row of one precision."""
        out = []
        for k in (1, j):
            z = torch.empty((k, d_feat, n), dtype=dtype, device=dev)
            cnt = _node_table(tuple(d_feats[:k]), torch.int32, dev)
            tab = None if sc is None \
                else _node_table(tuple(sc[:k]), dtype, dev)
            bms, by = bound_ms(nbytes(om[:k], bi[:k], xx, z), k * flops,
                               dtype)
            out.append(dict(
                name=name if k == 1 else f"{name}@wave", kernel=name, **src,
                shape=dict(J=k, D=d_feat, d=dim, N=n),
                ms=cuda_ms(lambda: rff_features_cuda(om[:k], bi[:k], xx,
                                                     tab, cnt, z)),
                plain_ms=cuda_ms(lambda: plain(k)), bound_ms=bms,
                bound_by=by, library_ms=cuda_ms(lambda: library(k))))
        one_cnt = _node_table((d_feat,), torch.int32, dev)
        one = [None if sc is None else _node_table((sc[i],), dtype, dev)
               for i in range(j)]
        z1 = torch.empty((1, d_feat, n), dtype=dtype, device=dev)
        out[1]["per_node_ms"] = cuda_ms(lambda: [
            rff_features_cuda(om[i:i + 1], bi[i:i + 1], xx, one[i],
                              one_cnt, z1) for i in range(j)])
        return out

    sc64 = torch.tensor(scales, dtype=omega.dtype, device=dev)[:, None, None]
    f64 = rows(
        "rff_features", omega, bias, x, scales,
        lambda k: rff_features_batched_reference(
            omega[:k], bias[:k], x, scale=scales[:k], d_feat=d_feats[:k]),
        lambda k: torch.cos(torch.baddbmm(
            bias[:k, :, None], omega[:k], x.expand(k, dim, n))) * sc64[:k],
        omega.dtype)
    bf16 = torch.bfloat16
    ob, bb, xb = omega.to(bf16), bias.to(bf16), x.float().to(bf16)
    lowp = rows(
        "rff_features_lowp", ob, bb, xb, None,
        lambda k: rff_features_bf16_batched_reference(
            ob[:k], bb[:k], xb, d_feat=d_feats[:k]),
        lambda k: torch.cos(torch.baddbmm(
            bb[:k, :, None], ob[:k], xb.expand(k, dim, n))),
        bf16)
    return [f64[0], lowp[0], f64[1], lowp[1]]


def profiled_ms(fn, kernels, calls: int = 5) -> dict[str, float]:
    """Device ms per call of fn of each kernel whose name holds one of
    `kernels`, summed over its launches, by torch.profiler; empty where
    the profiler records no device time."""
    try:
        from torch.profiler import ProfilerActivity, profile
        fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        events = prof.key_averages()
    except Exception as exc:                      # the profiler is optional
        print(f"profiler: not recorded ({type(exc).__name__})")
        return {}
    out = {}
    for e in events:
        us = getattr(e, "device_time_total", getattr(e, "cuda_time_total", 0))
        for kernel in kernels:
            if kernel in e.key and us > 0:
                out[kernel] = out.get(kernel, 0.0) + us / 1e3 / calls
    return out


def gram_wide_timing() -> dict:
    """rff_gram's wide route (F past the clusters' shared memory) at
    GRAM_WIDE_TIMING in f64, by CUDA events, beside its plain version, the
    `cos(baddbmm)` + `bmm` yardstick and its bound (the projection and the
    upper triangle); and its two phases apart, the Z launches and the Gram
    launches of one call, by the profiler's device time per kernel."""
    from repro_torch.kernels import ops
    from repro_torch.kernels.rff_gram import (gram_plan,
                                              rff_gram_batched_reference)

    b, f, dim, n = GRAM_WIDE_TIMING
    args = gram_operands(b, f, dim, n, torch.float64, seed=f)
    plan = gram_plan(b, f, dim, n, item=8)
    n_live = args[4].sum().item()
    flops = 2 * f * dim * n_live + f * (f + 1) * n_live
    byts = nbytes(*args) + (b * f * f + b * f) * 8
    bms, by = bound_ms(byts, flops, torch.float64)

    def library(om, bi, x, y, cm):
        z = torch.cos(torch.baddbmm(bi[..., None], om, x)) * cm[:, None]
        return z @ z.transpose(1, 2), (z @ y[..., None])[..., 0]

    phases = profiled_ms(lambda: ops.rff_gram_batched(*args),
                         ("rff_gram_z_kernel", "rff_gram_wide_kernel"))
    return dict(shape=GRAM_WIDE_TIMING, plan=plan,
                ms=cuda_ms(lambda: ops.rff_gram_batched(*args), reps=5),
                plain_ms=cuda_ms(lambda: rff_gram_batched_reference(*args),
                                 reps=5),
                library_ms=cuda_ms(lambda: library(*args), reps=5),
                bound_ms=bms, bound_by=by, phases=phases)


# ------------------------------------------------------------ decode attention
def _decode_operands(b, h, kh, dh, s, seed):
    gen = torch.Generator(device="cuda").manual_seed(seed)
    kw = dict(dtype=torch.float32, device="cuda", generator=gen)
    return (torch.randn((b, 1, h, dh), **kw),
            torch.randn((b, s, kh, dh), **kw),
            torch.randn((b, s, kh, dh), **kw))


def flash_decode_phase() -> dict[str, float]:
    """The decode-attention kernel against its split plain version (the
    kernel's chunks, merged in chunk order) and its one-pass plain version
    on the card at DECODE_SHAPES, |got − plain| ≤ DECODE_TOL·(1 + |plain|);
    at each shape a second call gives the same bits and, with a stale tail,
    the cache set to ±999 beyond cur_index gives the same output bit for
    bit; at one long request a CUDA-graph replay gives the eager call's
    bits. Returns the largest error."""
    from repro_torch.kernels import ops
    from repro_torch.kernels.decode_attention import (
        flash_decode_reference, flash_decode_split_reference)

    worst = 0.0
    for b, h, kh, dh, s, cur in DECODE_SHAPES:
        case = f"B={b} H={h} K={kh} dh={dh} S={s} cur={cur}"
        q, k, v = _decode_operands(b, h, kh, dh, s, seed=s + cur)
        got = ops.flash_decode(q, k, v, cur)
        lens = torch.full((b * kh,), cur, dtype=torch.int32, device="cuda")
        for plain in (flash_decode_split_reference, flash_decode_reference):
            want = plain(q, k, v, lens)
            torch.cuda.synchronize()
            err = (got - want).abs()
            if not (torch.isfinite(got).all()
                    and (err <= DECODE_TOL * (1 + want.abs())).all()):
                raise PhaseError(f"flash_decode {case}: disagrees with "
                                 f"{plain.__name__} beyond {DECODE_TOL:g} "
                                 f"(max abs err {err.max().item():.3e})")
            worst = max(worst, err.max().item())
        if not torch.equal(ops.flash_decode(q, k, v, cur), got):
            raise PhaseError(f"flash_decode {case}: two calls gave other bits")
        if cur < s:
            k[:, cur:] = 999.0
            v[:, cur:] = -999.0
            if not torch.equal(ops.flash_decode(q, k, v, cur), got):
                raise PhaseError(f"flash_decode {case}: the cache beyond "
                                 f"cur_index changed the output")
    b, h, kh, dh, s = DECODE_LONG
    q, k, v = _decode_operands(b, h, kh, dh, s, seed=3)
    eager = ops.flash_decode(q, k, v, s)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        ops.flash_decode(q, k, v, s)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        replayed = ops.flash_decode(q, k, v, s)
    for _ in range(2):
        replayed.zero_()
        graph.replay()
        torch.cuda.synchronize()
        if not torch.equal(replayed, eager):
            raise PhaseError("flash_decode: a CUDA-graph replay gave other "
                             "bits than the eager call")
    print(f"flash_decode phase: pass ({len(DECODE_SHAPES)} shapes, max abs "
          f"err {worst:.3e} against the split and one-pass plain versions, "
          f"two calls, the stale tail and graph replays bit for bit)",
          flush=True)
    return {"flash_decode": worst}


# ------------------------------------------------------------- LLM serving
def llm_requests(cfg, count: int, seed: int, *, prompt=LLM_PROMPT,
                 new_tokens=LLM_NEW_TOKENS) -> list:
    from repro_torch.serve import Request

    rng = np.random.default_rng(seed)
    return [Request(uid=i, prompt=rng.integers(
        0, cfg.vocab_size, int(rng.integers(prompt[0], prompt[1] + 1)))
        .tolist(), max_new_tokens=new_tokens) for i in range(count)]


def _token_plan(wave, batch: int) -> list[list[int]]:
    """The engine's input tokens per step for one wave: each slot feeds
    prompt + output (its next token while active), then 0, as do the
    slots the wave leaves empty."""
    seqs = [list(r.prompt) + list(r.output) for r in wave]
    steps = max(len(s) for s in seqs) - 1
    return [[s[t] if t < len(s) - 1 else 0 for s in seqs]
            + [0] * (batch - len(seqs)) for t in range(steps)]


def llm_path(device: str, cfg, *, requests: int, batch: int, max_seq: int,
             prompt=LLM_PROMPT, new_tokens=LLM_NEW_TOKENS) -> dict:
    """The LLM serving path: ServeEngine (backend cuda) with the port's
    seeded weights serves `requests` greedy requests twice, the repeat
    run timed with the launch counts zeroed just before; then one request
    alone against sequential decode_step calls, and the first wave's
    tokens teacher-forced through decode_step on both backends and with
    the int8 cache."""
    from repro_torch.models.model import Model
    from repro_torch.serve import Request, ServeEngine

    engine = ServeEngine(cfg, batch_size=batch, max_seq=max_seq, seed=0,
                         device=device, backend="cuda")
    kw = dict(prompt=prompt, new_tokens=new_tokens)
    # the first run meets a cold model (first cuBLAS handles, allocator
    # growth); the repeat run is the one timed and counted
    first, cold_secs, _ = _launched(
        lambda: engine.run(llm_requests(cfg, requests, seed=7, **kw)))
    done, secs, launches = _launched(
        lambda: engine.run(llm_requests(cfg, requests, seed=7, **kw)))
    out = dict(engine=engine, done=done, secs=secs, launches=launches,
               steps=engine.decode_steps, report=engine.latency.report(),
               again=first, cold_secs=cold_secs)

    first = done[0]
    solo = Request(uid=99, prompt=first.prompt[:prompt[0]],
                   max_new_tokens=8)
    [solo] = engine.run([solo])
    model = engine.model
    cache = model.init_cache(batch, max_seq)
    seq = []
    with torch.inference_mode():
        for t in range(len(solo.prompt) + 7):
            tok = solo.prompt[t] if t < len(solo.prompt) else seq[-1]
            toks = torch.zeros((batch, 1), dtype=torch.long, device=device)
            toks[0, 0] = tok
            logits, cache = model.decode_step(cache, toks, t)
            if t >= len(solo.prompt) - 1:
                seq.append(int(logits[0].argmax()))
    out["solo"], out["sequential"] = solo.output, seq

    # teacher forcing the first wave: cuda vs torch, and the int8 cache
    wave = done[:batch]
    int8 = Model(dataclasses.replace(cfg, kv_cache_dtype="int8"),
                 engine.params)
    runs = {"cuda": (model, "cuda"), "torch": (model, "torch"),
            "int8": (int8, "cuda")}
    caches = {k: m.init_cache(batch, max_seq) for k, (m, _) in runs.items()}
    diff = {"torch": 0.0, "int8": 0.0}
    scale, mismatches = 0.0, 0
    plan = _token_plan(wave, batch)
    with torch.inference_mode():
        for t, col in enumerate(plan):
            toks = torch.tensor(col, dtype=torch.long, device=device)[:, None]
            lg = {}
            for k, (m, backend) in runs.items():
                lg[k], caches[k] = m.decode_step(caches[k], toks, t,
                                                 backend=backend)
            scale = max(scale, lg["cuda"].abs().max().item())
            for k in diff:
                diff[k] = max(diff[k],
                              (lg[k] - lg["cuda"]).abs().max().item())
            nxt = lg["cuda"].argmax(dim=-1).tolist()
            for i, r in enumerate(wave):
                g = t - (len(r.prompt) - 1)
                if 0 <= g < len(r.output) and nxt[i] != r.output[g]:
                    mismatches += 1
    out.update(diff=diff, scale=scale, replay_mismatches=mismatches,
               replay_steps=len(plan))
    return out


def graph_step_ms(model, batch: int, max_seq: int, pos: int) -> float:
    """Device time of one eager decode step at ``pos``: the step captured
    into a CUDA graph and replayed, timed by CUDA events (the same
    launches as the eager step, without the host's time between them)."""
    cache = model.init_cache(batch, max_seq)
    toks = torch.zeros((batch, 1), dtype=torch.long, device="cuda")
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.inference_mode():
        with torch.cuda.stream(side):
            for _ in range(2):
                model.decode_step(cache, toks, pos)
        torch.cuda.current_stream().wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            model.decode_step(cache, toks, pos)
    return cuda_ms(graph.replay)


def check_llm_path(llm: dict, cfg, on_card: bool) -> None:
    done, again = llm["done"], llm["again"]
    n_tokens = sum(len(r.output) for r in done)
    if not all(r.done and r.output for r in done):
        raise PhaseError("LLM serving: a request finished without output")
    if [r.output for r in done] != [r.output for r in again]:
        raise PhaseError("LLM serving: the same requests run again gave "
                         "other tokens")
    if llm["solo"] != llm["sequential"]:
        raise PhaseError(f"LLM serving: one request alone {llm['solo']} "
                         f"differs from sequential decode_step calls "
                         f"{llm['sequential']}")
    if llm["replay_mismatches"]:
        raise PhaseError(f"LLM serving: teacher forcing the engine's tokens "
                         f"on the cuda backend gave {llm['replay_mismatches']}"
                         f" other argmax tokens")
    rel = {k: v / llm["scale"] for k, v in llm["diff"].items()}
    if not rel["torch"] <= LLM_LOGIT_TOL:
        raise PhaseError(f"LLM serving: cuda and torch logits differ by "
                         f"{rel['torch']:.3e} of max|logit| (tolerance "
                         f"{LLM_LOGIT_TOL:g})")
    if not rel["int8"] < INT8_LOGIT_TOL:
        raise PhaseError(f"LLM serving: int8-cache logits differ by "
                         f"{rel['int8']:.3e} of max|logit| from the f32 cache "
                         f"(tolerance {INT8_LOGIT_TOL:g})")
    got = {k: v for k, v in llm["launches"].items() if v}
    want = {"flash_decode": cfg.num_layers * llm["steps"]} if on_card else {}
    if got != want:
        raise PhaseError(f"LLM serving launch counts {got}, expected {want}")
    llm.update(tokens=n_tokens, rel=rel)


def sdpa_yardsticks(q, k, v, want, cur: int) -> dict:
    """PyTorch's scaled_dot_product_attention computing the kernel's
    function at cur on the same cache views ([B, S, K, dh] transposed to
    [B, K, S, dh], no copy): the call with the length mask and
    enable_gqa, and the plain call on the views up to cur (H = K here),
    each under every SDPA backend that takes it, beside the plain call on
    contiguous [B, K, cur, dh] copies (another layout, timed for reference
    only). Only calls within DECODE_TOL·(1 + |want|) of `want` count.
    Returns {"ms": fastest on the same inputs, "call": its label, "table":
    {label: {backend: ms}}, "default": {label: kernels the default
    dispatch launched}}."""
    import warnings

    import torch.nn.functional as F
    from torch.nn.attention import SDPBackend, sdpa_kernel

    s = k.shape[1]
    mask = (torch.arange(s, device="cuda") < cur)[None, None, None, :]
    qt, kt, vt = q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)
    k_cur, v_cur = kt[:, :, :cur], vt[:, :, :cur]
    calls = {
        "views, mask, enable_gqa": lambda: F.scaled_dot_product_attention(
            qt, kt, vt, attn_mask=mask, enable_gqa=True),
        "views": lambda: F.scaled_dot_product_attention(qt, k_cur, v_cur),
    }
    backends = [getattr(SDPBackend, n) for n in (
        "FLASH_ATTENTION", "EFFICIENT_ATTENTION", "CUDNN_ATTENTION", "MATH")
        if hasattr(SDPBackend, n)]
    want_t = want.transpose(1, 2)

    def agrees(got):
        return bool((got - want_t).abs().le(
            DECODE_TOL * (1 + want_t.abs())).all())

    def table(calls):
        out = {}
        for label, fn in calls.items():
            out[label] = {}
            for be in backends:
                def run(fn=fn, be=be):
                    with sdpa_kernel([be]):
                        return fn()
                try:
                    with warnings.catch_warnings():
                        warnings.simplefilter("ignore")
                        ok = agrees(run())
                except RuntimeError:
                    continue
                if ok:
                    out[label][be.name] = cuda_ms(run, reps=5, warmup=1)
        return out

    def default_kernels(fn):
        try:
            from torch.profiler import ProfilerActivity, profile
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                fn()
                torch.cuda.synchronize()
            names = [e.key for e in prof.key_averages()
                     if getattr(e, "device_time_total",
                                getattr(e, "cuda_time_total", 0)) > 0]
            return sorted(names)[:6] or ["not recorded"]
        except Exception as exc:                  # the profiler is optional
            return [f"not recorded ({type(exc).__name__})"]

    same = table(calls)
    default = {label: default_kernels(fn) for label, fn in calls.items()}
    best = min(((ms, f"{label} [{be}]") for label, row in same.items()
                for be, ms in row.items()), default=(float("nan"), "none"))
    qc, kc, vc = qt.contiguous(), k_cur.contiguous(), v_cur.contiguous()
    same.update(table({"contiguous copies": lambda: (
        F.scaled_dot_product_attention(qc, kc, vc))}))
    return dict(ms=best[0], call=best[1], table=same, default=default)


def decode_kernel_ms(b, h, kh, dh, s, cur, *, caches: int = 1) -> dict:
    """flash_decode_cuda by CUDA events at (B, H, K, dh, S) and cur over
    `caches` distinct caches launched in turn (1: the same cache again,
    warm in L2 where it fits; DECODE_COLD_CACHES: each launch finds its
    cache evicted by the others'), beside the least time the card could
    take: K and V up to cur read once, q and lens read, out written, the
    two products (softmax arithmetic not counted)."""
    from repro_torch.kernels.decode_attention import flash_decode_cuda

    sets = [_decode_operands(b, h, kh, dh, s, seed=1 + i)
            for i in range(caches)]
    q = sets[0][0]
    lens = torch.full((b * kh,), cur, dtype=torch.int32, device="cuda")
    out = torch.empty_like(q)
    turn = itertools.cycle(sets)

    def launch():
        qi, ki, vi = next(turn)
        flash_decode_cuda(qi, ki, vi, lens, out)

    bms, by = bound_ms(2 * b * cur * kh * dh * 4 + nbytes(q, lens, out),
                       4 * b * h * cur * dh, torch.float32)
    ms = cuda_ms(launch, reps=max(20, 2 * caches))
    return dict(ms=ms, bound_ms=bms, bound_by=by, operands=sets[0],
                lens=lens, out=out)


def decode_timings(*, yardsticks: bool = True) -> list[dict]:
    """The decode-attention kernel by CUDA events at DECODE_TIMING (the
    registry's decode_32k length, cur = S) and DECODE_LONG (one long
    request), each beside its plain version (the split one, the kernel's
    chunks) and the fastest scaled_dot_product_attention call on the same
    inputs (`sdpa_yardsticks`); and at the serving cache (S = LLM_MAX_SEQ,
    cur a quarter of it and all of it) warm and cold beside the fastest
    SDPA call there (warm). Without `yardsticks`, the kernel's times
    only."""
    rows = []
    for name, (b, h, kh, dh, s) in (("flash_decode", DECODE_TIMING),
                                    ("flash_decode@long", DECODE_LONG)):
        t = decode_kernel_ms(b, h, kh, dh, s, s)
        row = dict(name=name, kernel="flash_decode", route="cuda",
                   source="src/repro_torch/kernels/csrc/flash_decode.cu",
                   replaces="src/repro/kernels/decode_attention.py:89",
                   shape=[b, h, kh, dh, s, s], ms=t["ms"],
                   bound_ms=t["bound_ms"], bound_by=t["bound_by"])
        if yardsticks:
            from repro_torch.kernels.decode_attention import (
                flash_decode_split_reference)
            q, k, v = t["operands"]
            row["plain_ms"] = cuda_ms(
                lambda: flash_decode_split_reference(q, k, v, t["lens"]),
                reps=5, warmup=1)
            row["sdpa"] = sdpa_yardsticks(q, k, v, t["out"], s)
            row["library_ms"] = row["sdpa"]["ms"]
        rows.append(row)
        del t
    serving = {}
    for cur in (LLM_MAX_SEQ // 4, LLM_MAX_SEQ):
        shape = (LLM_BATCH, 16, 16, 64, LLM_MAX_SEQ, cur)
        warm = decode_kernel_ms(*shape)
        cold = decode_kernel_ms(*shape, caches=DECODE_COLD_CACHES)
        serving[cur] = dict(warm_ms=warm["ms"], cold_ms=cold["ms"],
                            bound_ms=warm["bound_ms"])
        if yardsticks:
            q, k, v = warm["operands"]
            serving[cur]["sdpa"] = sdpa_yardsticks(q, k, v, warm["out"], cur)
        del warm, cold
    rows[0]["serving"] = serving
    return rows


def _decode_model(device: str = "cuda"):
    """qwen1.5-0.5b at full width and depth with the engine's seeded
    weights (ServeEngine(seed=0))."""
    from repro_torch.models.model import Model, init_params

    cfg = _llm_config()
    return Model(cfg, init_params(
        cfg, torch.Generator(device).manual_seed(0)))


def long_step_ms(model) -> float:
    """One decode step's device time at one long request: B 1 over a
    DECODE_LONG-length cache at its last position (CUDA-graph replay)."""
    s = DECODE_LONG[-1]
    ms = graph_step_ms(model, 1, s, s - 1)
    torch.cuda.empty_cache()
    return ms


def decode_timings_only(src: str | None) -> int:
    """``--decode-timings``: the kernel's times of `decode_timings` and two
    decode steps by graph replay (the serving cache at cur 128 and one
    long request), with ``repro_torch`` imported from `src`, as one JSON
    line after the card's line."""
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    if src is not None:
        sys.path.insert(0, os.path.abspath(src))
    import repro_torch

    card = card_line()
    torch.backends.cuda.matmul.allow_tf32 = False
    rows = decode_timings(yardsticks=False)
    model = _decode_model()
    step_ms = graph_step_ms(model, LLM_BATCH, LLM_MAX_SEQ,
                            LLM_MAX_SEQ // 4 - 1)
    long_ms = long_step_ms(model)
    print(card)
    print(json.dumps({
        "package": os.path.dirname(repro_torch.__file__),
        "kernel_ms": {r["name"]: r["ms"] for r in rows},
        "bound_ms": {r["name"]: r["bound_ms"] for r in rows},
        "serving": {str(cur): {k: v for k, v in d.items()}
                    for cur, d in rows[0]["serving"].items()},
        "step_ms": {"serving cache (B 8, S 512, cur 128)": step_ms,
                    "long request (B 1, S 32768, cur 32768)": long_ms}}))
    return 0


# ------------------------------------------------------ the paper's experiments
def _paper_rse_close(name: str, got: float, want: float) -> float:
    if not (math.isfinite(got) and abs(got - want) <= PAPER_RTOL * abs(want)):
        raise PhaseError(f"{name}: RSE {got!r} against {want!r} beyond rtol "
                         f"{PAPER_RTOL:g}")
    return abs(got - want)


def paper_gram_fn(device: str, subsample: int | None, d_feat: int) -> dict:
    """(a) Table 2's wave setting (D_j = 200 on the card, energy DDRF from
    the generator, c = 0.01·N): the solver with `gram_fn_for_solver` (its 40
    neighbour Gram blocks through `rff_gram` in f32) against the default
    solver, θ from solve_exact within GRAM_FN_TOL; one Gram block against
    the plain version in f32 on the same device (rtol 1e-4); and one
    DKLA run (400 iterations) at the same setting, timed."""
    from repro_torch.core import DeKRRConfig, DeKRRSolver, select_features
    from repro_torch.kernels import ops
    from repro_torch.kernels.ref import rff_gram_ref
    from repro_torch.paper import common as C

    ds, train, test = C.load_split("wave", subsample=subsample,
                                   device=device)
    gen = torch.Generator(device=device).manual_seed(0)
    fmaps = [select_features(gen, ds.dim, d_feat, C.SIGMA, nd.x, nd.y,
                             method="energy") for nd in train]
    n = sum(nd.num_samples for nd in train)
    cfg = DeKRRConfig(lam=C.LAM, c_nei=0.01 * n)
    plain = DeKRRSolver(C.TOPOLOGY, fmaps, train, cfg, device=device)
    fused, secs, launches = _launched(lambda: DeKRRSolver(
        C.TOPOLOGY, fmaps, train, cfg, gram_fn=ops.gram_fn_for_solver,
        device=device))
    want = {"rff_gram": sum(C.TOPOLOGY.degree(j) for j in range(C.J))} \
        if device == "cuda" else {}
    got = {k: v for k, v in launches.items() if v}
    if got != want:
        raise PhaseError(f"gram_fn aux build launch counts {got}, "
                         f"expected {want}")
    th_plain = plain.solve_exact().theta
    th_fused = fused.solve_exact().theta
    err = max((a - b).abs().max().item() for a, b in zip(th_fused, th_plain))
    bad = any(((a - b).abs() > GRAM_FN_TOL + GRAM_FN_TOL * b.abs()).any()
              for a, b in zip(th_fused, th_plain))
    if bad or not all(torch.isfinite(a).all() for a in th_fused):
        raise PhaseError(f"gram_fn solver θ differs from the default "
                         f"solver's beyond rtol/atol {GRAM_FN_TOL:g} (max "
                         f"abs err {err:.3e})")
    fm, x = fused.feature_maps[0], fused.data[1].x
    f32 = torch.float32
    operands = (fm.omega.to(f32), fm.bias.to(f32), x.to(f32),
                torch.zeros(x.shape[1], dtype=f32, device=x.device))
    scale = math.sqrt(2.0 / fm.num_frequencies)
    gram_err = compare("rff_gram@gram_fn",
                       ops.gram_fn_for_solver(fm, x).to(f32),
                       rff_gram_ref(*operands, scale=scale)[0], f32)
    dkla = C.run_dkla(ds, train, test, d_feat, seed=50)
    return dict(launches=launches, secs=secs, theta_err=err, dkla=dkla,
                theta_scale=max(b.abs().max().item() for b in th_plain),
                gram_err=gram_err, operands=operands, scale=scale,
                shape=dict(B=1, F=fm.num_frequencies, d=ds.dim,
                           N=x.shape[1]))


def gram_fn_timing(g: dict) -> dict:
    """`rff_gram` at the shape `gram_fn_for_solver` gives it (B 1, F 200,
    f32), by CUDA events, beside its plain version, the `cos(addmm)` +
    matmul yardstick and its bound (the projection and the upper
    triangle)."""
    from repro_torch.kernels import ops
    from repro_torch.kernels.ref import rff_gram_ref

    om, bi, x, y = g["operands"]
    f, dim = om.shape
    n = x.shape[1]
    flops = 2 * f * dim * n + f * (f + 1) * n
    bms, by = bound_ms(nbytes(om, bi, x, y) + (f * f + f) * 4, flops,
                       torch.float32)

    def library():
        z = torch.cos(torch.addmm(bi[:, None], om, x)) * g["scale"]
        return z @ z.T, z @ y

    return dict(name="rff_gram@gram_fn", route="cuda",
                source="src/repro_torch/kernels/csrc/rff_gram.cu",
                replaces="src/repro/kernels/rff_gram.py:70",
                shape=g["shape"],
                ms=cuda_ms(lambda: ops.rff_gram(om, bi, x, y,
                                                scale=g["scale"])),
                plain_ms=cuda_ms(lambda: rff_gram_ref(om, bi, x, y,
                                                      scale=g["scale"])),
                bound_ms=bms, bound_by=by, library_ms=cuda_ms(library))


def paper_pair(devices: tuple, subsample: int | None) -> dict:
    """(c) One Table 2 row (houses, seed 0) from the same draws (a CPU
    generator's, moved to each device) on each device: the three methods'
    RSEs agree at rtol 1e-9 and the same c is chosen."""
    from repro_torch.core import sample_rff
    from repro_torch.paper import common as C

    name, seed = PAPER_PAIR
    dbar = C.PAPER_DBAR[name]
    splits = {dev: C.load_split(name, subsample=subsample, device=dev)
              for dev in devices}
    dim = splits[devices[0]][0].dim
    gen = torch.Generator().manual_seed(seed)
    pools = [sample_rff(gen, dim, 20 * dbar, C.SIGMA) for _ in range(C.J)]
    fmap = sample_rff(gen, dim, dbar, C.SIGMA)
    dd_pool = sample_rff(gen, dim, 20 * dbar, C.SIGMA)
    out = {}
    for dev, (ds, train, test) in splits.items():
        out[dev] = dict(
            dkla=C.run_dkla(ds, train, test, dbar, seed=50 + seed,
                            fmap=fmap),
            dkla_ddrf=C.run_dkla(ds, train, test, dbar, ddrf=True,
                                 seed=50 + seed, candidates=dd_pool),
            ours=C.run_dekrr_ddrf(ds, train, test, dbar, seed=seed,
                                  candidates=pools))
    first, second = (out[d] for d in devices)
    errs = {k: _paper_rse_close(f"{name} seed {seed} {k}", first[k].rse,
                                second[k].rse) for k in first}
    if first["ours"].c != second["ours"].c:
        raise PhaseError(f"{name} seed {seed}: c {first['ours'].c} chosen "
                         f"on {devices[0]}, {second['ours'].c} on "
                         f"{devices[1]}")
    return dict(runs=out, errs=errs, c=first["ours"].c)


def paper_krr(device: str, subsample: int | None) -> dict:
    """(e) CentralizedKRR on wave's pooled training split (31,800 columns
    at full N): test RSE, wall time and peak device memory; the same fit
    at KRR_CHECK_SUBSAMPLE held against the CPU (rtol 1e-9, atol
    1e-11·max|f|: K + λN I is conditioned near 1e6 at that size)."""
    from repro_torch.core import CentralizedKRR, rse
    from repro_torch.data.synthetic import pooled
    from repro_torch.paper import common as C

    def fit(dev, sub):
        _, train, test = C.load_split("wave", subsample=sub, device=dev)
        tr, te = pooled(train), pooled(test)
        model = CentralizedKRR(C.SIGMA, C.LAM).fit(tr.x, tr.y)
        return model.predict(te.x), te.y, tr.x.shape[1]

    small = min(KRR_CHECK_SUBSAMPLE, subsample or KRR_CHECK_SUBSAMPLE)
    got, _, small_cols = fit(device, small)
    want, _, _ = fit("cpu", small)
    err = (got.cpu() - want).abs()
    scale = want.abs().max().item()
    if (err > PAPER_RTOL * want.abs() + 1e-11 * scale).any():
        raise PhaseError(f"CentralizedKRR on {device} differs from the CPU "
                         f"(max abs err {err.max().item():.3e})")
    on_card = device == "cuda"
    if on_card:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    pred, y, cols = fit(device, subsample)
    r = rse(pred, y)
    secs = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() / 2**30 if on_card else None
    if not (math.isfinite(r) and pred.shape == y.shape):
        raise PhaseError(f"CentralizedKRR: RSE {r}, prediction shape "
                         f"{tuple(pred.shape)} for {tuple(y.shape)}")
    del pred
    return dict(rse=r, secs=secs, peak_gib=peak, cols=cols,
                check_err=err.max().item(), check_cols=small_cols)


def paper_phase(device: str, *, subsample: int | None, fast: bool,
                gram: tuple[int | None, int]) -> dict:
    """The paper's experiments through `repro_torch.paper`: (a) gram_fn
    through `rff_gram`, (b) Table 2, (c) one row on the card and the CPU,
    (d) the iteration cost, (e) CentralizedKRR. ``gram`` is (a)'s
    (subsample, D_j). Each part runs with the launch counts zeroed just
    before it and read just after."""
    from repro_torch.paper import comm_costs, table2

    t0 = time.perf_counter()
    g = paper_gram_fn(device, *gram)
    rows, t_table, table_launches = _launched(
        lambda: table2.run(fast=fast, subsample=subsample, device=device))
    pair = paper_pair((device, "cpu"), subsample)
    cost, _, cost_launches = _launched(
        lambda: comm_costs.iteration_cost(subsample=subsample,
                                          device=device))
    if device == "cuda" and not (cost_launches["rff_gram"]
                                 and cost_launches["dekrr_solve"]):
        raise PhaseError(f"iteration_cost launched {cost_launches}: "
                         f"rff_gram and dekrr_solve expected")
    krr = paper_krr(device, subsample)
    for r in rows:
        if not all(math.isfinite(v) for v in r[2:]):
            raise PhaseError(f"Table 2 row {r} is not finite")
    return dict(gram=g, rows=rows, t_table=t_table, subsample=subsample,
                table_launches={k: v for k, v in table_launches.items()
                                if v},
                pair=pair, cost=cost,
                cost_launches={k: v for k, v in cost_launches.items() if v},
                krr=krr, secs=time.perf_counter() - t0)


def print_paper_phase(pp: dict, card: str) -> None:
    g, krr, pair = pp["gram"], pp["krr"], pp["pair"]
    rows = pp["rows"]
    print(f"paper (a) gram_fn [{card}]: wave aux build with "
          f"gram_fn_for_solver {g['secs'] * 1e3:.1f} ms, launches "
          f"{json.dumps({k: v for k, v in g['launches'].items() if v})}; "
          f"θ against the default solver max abs err {g['theta_err']:.3e} "
          f"(max |θ| {g['theta_scale']:.3e}, tolerance {GRAM_FN_TOL:g}); "
          f"one Gram block against rff_gram_ref in f32 max abs err "
          f"{g['gram_err']:.3e}; one DKLA run (400 iterations, D "
          f"{g['shape']['F']}) {g['dkla'].seconds * 1e3:.1f} ms, RSE "
          f"{g['dkla'].rse:.6f}")
    for name, dbar, r_dkla, r_dd, r_ours, imp in rows:
        print(f"paper (b) Table 2 [{card}] {name} D={dbar}: DKLA "
              f"{r_dkla:.6f}, DKLA-DDRF {r_dd:.6f}, DeKRR-DDRF {r_ours:.6f}, "
              f"improvement {imp:.2f}%")
    mean_imp = sum(r[5] for r in rows) / len(rows)
    print(f"paper (b) Table 2 [{card}]: mean improvement over DKLA "
          f"{mean_imp:.2f}% (paper_claims=25.5%), {len(rows)} datasets at "
          + ("full N" if pp["subsample"] is None
             else f"N ≤ {pp['subsample']}")
          + f", wall {pp['t_table']:.1f} s, kernel launches "
          f"{json.dumps(pp['table_launches'])}")
    runs = pair["runs"]
    print(f"paper (c) {PAPER_PAIR[0]} seed {PAPER_PAIR[1]} [{card}] vs CPU "
          f"(same draws): " + "; ".join(
              f"{k} {r.rse:.12f} ({r.seconds:.2f} s, CPU "
              f"{runs['cpu'][k].seconds:.2f} s, |Δ| {pair['errs'][k]:.2e})"
              for k, r in runs[next(iter(runs))].items())
          + f"; c = {pair['c']} on both")
    cost = pp["cost"]
    print(f"paper (d) iteration cost [{card}]: {cost['us_per_round']:.2f} "
          f"µs a round (solve_batched cuda_fused, host clock), "
          f"ppermute {cost['ppermute_bytes']} B and allgather "
          f"{cost['allgather_bytes']} B a round; launches "
          f"{json.dumps(pp['cost_launches'])}")
    wave = next((r[4] for r in rows if r[0] == "wave"), float("nan"))
    print(f"paper (e) CentralizedKRR [{card}] on wave's pooled training "
          f"split ({krr['cols']} columns): test RSE {krr['rse']:.6f} beside "
          f"DeKRR-DDRF {wave:.6f}, {krr['secs']:.2f} s, peak device memory "
          + ("not measured" if krr["peak_gib"] is None
             else f"{krr['peak_gib']:.1f} GiB")
          + f"; against the CPU at {krr['check_cols']} columns max abs err "
          f"{krr['check_err']:.3e}")
    print(f"paper phase [{card}]: {pp['secs']:.1f} s")


def check_launches(run: dict) -> None:
    got = {k: v for k, v in run["launches"].items() if v}
    rounds = run["rounds"]
    want = {"rff_gram": 2, "dekrr_solve": -(-rounds // CHUNK),
            "dekrr_step": rounds}
    if got != want:
        raise PhaseError(f"main path launch counts {got}, expected {want}")


# ------------------------------------------------------------------- main
def _llm_config():
    from repro_torch.configs import get_arch
    return get_arch(LLM_ARCH).config


def rehearse_on_cpu() -> int:
    """The main, async, Chebyshev, serving, LLM serving and paper paths
    on the CPU at a small size (plain kernel versions; the LLM path on
    qwen1.5-0.5b's reduced configuration; the paper's Table 2 on its
    first two datasets)."""
    run = main_path("cpu", subsample=2000, d_per_node=12, num_iters=200)
    checks = check_main_path(run)
    a = async_path(run, rounds=300)
    a_checks = check_async_path(a, run, checks)
    c = cheb_path(run, checks)
    c_checks = check_cheb_path(c, run, checks)
    sv = serve_path(run, queries=128)
    sv_checks = check_serve_path(sv, run, on_card=False)
    llm_cfg = _llm_config().reduced()
    llm = llm_path("cpu", llm_cfg, requests=6, batch=4, max_seq=64,
                   prompt=(4, 16), new_tokens=8)
    check_llm_path(llm, llm_cfg, on_card=False)
    pp = paper_phase("cpu", subsample=600, fast=True, gram=(2000, 12))
    print_paper_phase(pp, "cpu")
    summary = dict(rounds=run["rounds"], rse=run["rse"],
                   launches=run["launches"], exact_err=checks["exact_err"],
                   rho=checks["rho"], async_err=a_checks["err"],
                   async_tol_rounds=a_checks["tol_rounds"],
                   cheb_err=c_checks["err"],
                   cheb_rounds=(c["plain_rounds"], c["cheb_rounds"]),
                   serve_err=sv_checks["err"],
                   serve_plain=sv_checks["plain"],
                   serve_waves={str(p): r["waves"]
                                for p, r in sv["runs"].items()},
                   llm_steps=llm["steps"], llm_tokens=llm["tokens"],
                   llm_logit_rel=llm["rel"],
                   paper_rows=[r[:5] for r in pp["rows"]],
                   paper_krr_rse=pp["krr"]["rse"])
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
    from repro_torch.kernels.dekrr_solve import chain_max_clusters, chain_plan
    from repro_torch.kernels.rff_gram import gram_plan
    t0 = time.perf_counter()
    reports = _build.build_all()
    print(f"build: {time.perf_counter() - t0:.1f} s "
          f"(sources {_build.source_hash()})")
    for src, text in reports.items():
        print(f"--- ptxas {src} ---\n{text.strip()}")
    for src in ("rff_gram", "dekrr_step", "dekrr_solve", "dekrr_async_solve",
                "dekrr_cheb_solve"):
        for line in ptxas_summary(reports[src]):
            print(f"ptxas {src}: {line}")
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    print(f"rff_gram plan at B = {J_NODES}, {4 * J_NODES}: " + "; ".join(
        str(gram_plan(b, D_PER_NODE, 148, 3180, sms=sms))
        for b in (J_NODES, 4 * J_NODES)))
    print(f"rff_gram plan at (B, F, d, N) = {GRAM_WIDE_TIMING}: "
          f"{gram_plan(*GRAM_WIDE_TIMING, sms=sms)}")
    for src in ("dekrr_solve", "dekrr_async_solve", "dekrr_cheb_solve"):
        fits = chain_max_clusters(src, 4, D_PER_NODE, 1, torch.float64)
        print(f"chain_plan {src} f64 (C, rows per block, clusters) at K = 4, "
              f"D = {D_PER_NODE}: " + "; ".join(
                  f"J = {j}: {chain_plan(j, D_PER_NODE, fits)}"
                  for j in (J_NODES, J_LOOPED)))

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
    print(f"pack_problem warm [{card}]: " + ", ".join(
        f"{ms:.1f}" for ms in warm_pack_ms(run)) + " ms")

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

    errs.update(features_phase())
    sv = serve_path(run, queries=SERVE_QUERIES)
    sv_checks = check_serve_path(sv, run, on_card=True)
    serve_launches = {"rff_features": 0, "rff_features_lowp": 0}
    for precision, r in sv["runs"].items():
        rep = r["report"]
        bound = sv_checks["bounds"].get(precision)
        plain = sv_checks["plain"].get(precision)
        print(f"serving [{card}] precision={precision}: {rep.count} "
              f"queries in {r['waves']} waves on {SERVE_REPLICAS} replicas, "
              f"p50 {rep.p50 * 1e3:.3f} ms, p99 {rep.p99 * 1e3:.3f} ms, "
              f"{rep.qps:.1f} qps; launches {json.dumps(r['launches'])}"
              + ("" if bound is None else
                 f"; max |f_lo − f_hi| {bound[0]:.3e}, attached bounds "
                 f"{bound[1]:.3e}–{bound[2]:.3e}, max |f_lo − plain| "
                 f"{plain[0]:.3e} ({plain[1]:.3g} of its tolerance)"),
              flush=True)
        for k in serve_launches:
            serve_launches[k] += r["launches"].get(k, 0)
    one = sv["one_replica"]
    print(f"serving [{card}] precision=None on 1 replica: p50 "
          f"{one.p50 * 1e3:.3f} ms, p99 {one.p99 * 1e3:.3f} ms, "
          f"{one.qps:.1f} qps")
    print(f"serving checks: pass (|f − predict| {sv_checks['err']:.3e}, "
          f"max |f| {sv_checks['scale']:.3e}, snapshot residual "
          f"{sv['snap'].staleness.residual:.3e}, version 2 served to "
          f"{len(sv['after'])} later queries)")

    errs.update(flash_decode_phase())
    cfg = _llm_config()
    llm = llm_path("cuda", cfg, requests=LLM_REQUESTS, batch=LLM_BATCH,
                   max_seq=LLM_MAX_SEQ)
    check_llm_path(llm, cfg, on_card=True)
    step_pos = LLM_MAX_SEQ // 4 - 1
    device_ms = graph_step_ms(llm["engine"].model, LLM_BATCH, LLM_MAX_SEQ,
                              step_pos)
    long_ms = long_step_ms(llm["engine"].model)
    rep = llm["report"]
    print(f"LLM serving [{card}] {cfg.name} (full width, {cfg.num_layers} "
          f"layers, seeded weights): {rep.count} requests in "
          f"{llm['secs']:.2f} s (repeat run; the first, cold run "
          f"{llm['cold_secs']:.2f} s), {llm['steps']} decode steps of "
          f"{LLM_BATCH} slots, {llm['secs'] / llm['steps'] * 1e3:.2f} ms per "
          f"decode step, {llm['tokens'] / llm['secs']:.1f} generated "
          f"tokens/s, per-request p50 {rep.p50 * 1e3:.1f} ms, p99 "
          f"{rep.p99 * 1e3:.1f} ms; launches {json.dumps(llm['launches'])}",
          flush=True)
    print(f"LLM decode step on the device [{card}]: {device_ms:.3f} ms at "
          f"cur={step_pos + 1} (CUDA graph replay of the eager step), "
          f"{device_ms / (llm['secs'] / llm['steps'] * 1e3):.3f} of the "
          f"eager step's wall time; at one long request (B=1, S=cur="
          f"{DECODE_LONG[-1]}, CUDA graph replay) {long_ms:.3f} ms",
          flush=True)
    print(f"LLM serving checks: pass (repeat run equal, one request == "
          f"sequential decode_step, {llm['replay_steps']} teacher-forced "
          f"steps: cuda vs torch max |Δlogit| {llm['rel']['torch']:.3e} of "
          f"max|logit| {llm['scale']:.3f} (tolerance {LLM_LOGIT_TOL:g}), "
          f"int8 cache {llm['rel']['int8']:.3e} (tolerance "
          f"{INT8_LOGIT_TOL:g}))")

    pp = paper_phase("cuda", subsample=None, fast=False,
                     gram=(None, PAPER_DBAR_WAVE))
    print_paper_phase(pp, card)
    errs["rff_gram@gram_fn"] = pp["gram"]["gram_err"]

    launches = dict(run["launches"], dekrr_step_masked=a_launches[
        "dekrr_step_masked"], dekrr_async_solve=a_launches[
        "dekrr_async_solve"], dekrr_cheb_solve=c_launches["dekrr_cheb_solve"],
        flash_decode=llm["launches"]["flash_decode"], **serve_launches)
    launches["rff_gram@gram_fn"] = pp["gram"]["launches"]["rff_gram"]
    rows = timings(run["packed"], run) + chain_timings(run, a, c) \
        + feature_timings(run) + decode_timings() \
        + [gram_fn_timing(pp["gram"])]
    wide = gram_wide_timing()
    plan = wide["plan"]
    print(f"time [{card}] rff_gram wide route at (B, F, d, N)="
          f"{wide['shape']} f64 ({-(-wide['shape'][0] // plan.batch)} "
          f"passes × {plan.chunks} N chunks of {plan.cols} columns, "
          f"{plan.ctas} Gram blocks a launch): {wide['ms']:.4f} ms, plain "
          f"{wide['plain_ms']:.4f} ms, torch yardstick "
          f"{wide['library_ms']:.4f} ms, bound {wide['bound_ms']:.4f} ms "
          f"({wide['bound_by']}); phases by the profiler's device time per "
          f"call: " + (", ".join(f"{k} {v:.4f} ms"
                                 for k, v in wide["phases"].items())
                       or "not recorded"))
    for r in rows:
        if "per_node_ms" in r:
            print(f"time [{card}] {r['name']} (J={J_NODES}, D={D_PER_NODE}, "
                  f"d=148, N={SERVE_N}): one launch {r['ms']:.4f} ms; the "
                  f"same wave as {J_NODES} single-node launches: "
                  f"{r.pop('per_node_ms'):.4f} ms")
    decode = [r for r in rows if r.get("kernel") == "flash_decode"]
    serving = decode[0].pop("serving")
    for r in decode:
        sdpa = r.pop("sdpa")
        print(f"time [{card}] {r['name']} yardstick at (B, H, K, dh, S, "
              f"cur)={tuple(r['shape'])}: the fastest SDPA call on the same "
              f"inputs is {sdpa['call']} at {sdpa['ms']:.4f} ms; every "
              f"backend that agreed (ms): {json.dumps(sdpa['table'])}; "
              f"kernels of the default dispatch: "
              f"{json.dumps(sdpa['default'])}")
    print(f"time [{card}] flash_decode at the serving cache (B={LLM_BATCH}, "
          f"H=K=16, dh=64, S={LLM_MAX_SEQ}; warm: one cache launched again, "
          f"cold: {DECODE_COLD_CACHES} caches launched in turn): " + "; ".join(
              f"cur={cur}: warm {d['warm_ms']:.4f} ms, cold "
              f"{d['cold_ms']:.4f} ms (bound {d['bound_ms']:.4f} ms; the "
              f"fastest SDPA call, warm, {d['sdpa']['call']} "
              f"{d['sdpa']['ms']:.4f} ms, every backend that agreed (ms): "
              f"{json.dumps(d['sdpa']['table'])})"
              for cur, d in serving.items()))
    per_round = {r["name"]: r["ms"] / r.pop("rounds") for r in rows
                 if "rounds" in r}
    step_ms = next(r["ms"] for r in rows if r["name"] == "dekrr_step")
    solve = next(r for r in rows if r["name"] == "dekrr_solve")
    print(f"time [{card}] per round: dekrr_step {step_ms:.4f} ms (one "
          f"launch), {solve.pop('graph_round_ms'):.4f} ms ({CHUNK} launches "
          f"replayed from a CUDA graph); " + "; ".join(
              f"{name} {ms:.4f} ms" for name, ms in per_round.items())
          + f" (dekrr_solve at R = {CHUNK}, "
          f"{solve.pop('untraced_ms') / CHUNK:.4f} ms without its trace; "
          f"dekrr_async_solve at R = {ASYNC_ROUNDS} with its flush; the "
          f"Chebyshev chain at its path's rounds)")
    for row in rows:
        kernel = row.pop("kernel", row["name"])
        row["max_abs_err"] = errs[kernel]
        row["launches"] = launches[kernel]
        print(f"time [{card}] {row['name']}: {row['ms']:.4f} ms, plain "
              f"{row['plain_ms']:.4f} ms, torch yardstick "
              f"{row['library_ms']:.4f} ms, bound {row['bound_ms']:.4f} ms "
              f"({row['bound_by']})")
    print(f"total: {time.perf_counter() - t_start:.1f} s")
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err",
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    print(card)
    print(json.dumps({"kernels": [
        {k: r[k] for k in keys + ("shape",) if k in r} for r in rows]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": count}}))
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--cpu-rehearsal", action="store_true",
                    help="run the main path on the CPU at a small size")
    ap.add_argument("--decode-timings", action="store_true",
                    help="time only flash_decode and two decode steps on "
                         "the card")
    ap.add_argument("--src", help="with --decode-timings: the directory "
                    "that holds the repro_torch package to time")
    args = ap.parse_args(argv)
    try:
        if args.decode_timings:
            return decode_timings_only(args.src)
        return rehearse_on_cpu() if args.cpu_rehearsal else run_on_card()
    except PhaseError as exc:
        print(f"chip_smoke: FAILED: {exc}", file=sys.stderr)
        return 1


if __name__ == "__main__":
    sys.exit(main())
