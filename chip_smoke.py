"""Drive the PyTorch/CUDA port's main paths on one NVIDIA card.

    python3 chip_smoke.py

1. Card: name and power limit (nvidia-smi), TF32 switched off.
2. Build: the seven CUDA sources of ``src/repro_torch/kernels/csrc``
   (one nvcc per source, in parallel), with each ``-Xptxas -v`` report,
   a summary of registers and spills of each kernel of ``rff_gram``
   (both routes), the round kernel and the three cluster chains
   (``dekrr_solve``, ``dekrr_async_solve``, ``dekrr_cheb_solve``, each
   on both routes), ``rff_gram``'s launch plans at the main path's shapes
   and at F = 600 (the wide route), the chains' ``chain_plan`` and the
   route plans (``solve_plan``, ``async_plan``, ``cheb_plan``: resident
   at J = 10, streamed at J = 40) at J = 10 and 40.
3. Kernel phases: each solve-path kernel against its plain PyTorch
   version on the card, at the main path's shapes, in float64 and
   float32, with the invariants that hold bit for bit (``rff_gram``,
   F ∈ {561, 600, 1,100} on its wide route in f64 and F ∈ {1,025, 1,100}
   in f32 among the shapes, F = 600 at B = 10, N = 3,180 in three N
   chunks: two launches give the same bits and G == Gᵀ exactly; a solve
   launch
   == round launches; the masked round at all ones == the unmasked one;
   an async-chain launch == masked round launches plus the delivery
   rule; chunked Chebyshev launches == one launch; the Chebyshev chain's
   resident route == its streamed route forced on the same operands; two
   launches of a chain on equal inputs give equal bits), and the three
   cluster chains
   at J = 40, past the clusters the card holds at once (the streamed
   route), == round launches bit for bit (the Chebyshev chain == the
   scan of round launches with torch's elementwise update,
   `chebyshev_scan`); each phase prints the chains' launches by route.
4. Main path at the paper's full width (Table 2, ``wave``): N = 63,600,
   d = 148, noniid_y over J = 10 nodes of circulant(10, (1, 2)), D_j = 200
   energy-selected DDRF features from D0 = 4,000 candidates per node,
   σ = 1, λ = 1e-6, c_nei = 0.01·N. pack_problem → solve_batched
   (cuda_fused, tol 1e-10: ``dekrr_solve`` on its resident route, which
   the run prints and requires) → solve_batched (cuda, the same rounds)
   → predict → RSE, checked against the port's own references.
5. Asynchronous gossip on the same packed problem: 1,000 rounds at
   p = 0.5 with the reference tests' censor schedule (τ0 = 2e-2, decay
   0.9), masks drawn by a seeded `torch.Generator` on the card;
   cuda_fused (``dekrr_async_solve`` on its resident route, printed and
   required) == cuda bit for bit, both == torch at rtol 1e-9, one
   edge-gossip run, one tol = 1e-10 run.
6. Chebyshev acceleration on the same problem: the spectral interval on
   cuda, then chebyshev_solve_packed on cuda_fused (one
   ``dekrr_cheb_solve`` launch on its resident route, printed and
   required), == cuda bit for bit, and strictly fewer rounds than plain
   Jacobi to the same error.
7. The SPMD solvers on the same packed problem, one node per rank: ten
   ranks started by `repro_torch.dist.ranks.run_ranks` on the one card,
   exchanging θ over gloo through host buffers (NCCL refuses two ranks
   on one device). Sync `cuda` and `cuda_fused` θ == batched `cuda` bit
   for bit in both modes (ppermute ring shifts, allgather), at the main
   path's rounds and at tol 1e-10 (the same rounds), `torch` within rtol
   1e-9, a warm start from the converged θ in ≤ 1 round; async on the
   async path's mask table (p 0.5 censored, edge, tol 1e-10) ==
   `async_solve_batched(cuda)` bit for bit with its wire counts, the
   synchronous schedule == the sync solver; θ bytes a round summed over
   ranks == `comm_bytes_per_round`; dispatches == launches == rounds on
   every rank; ms a round per mode and backend, and a round taken apart
   on rank 0 (exchange, the round on the local table, the wrapper's
   index check).
8. The featurize kernel (``rff_features``) against its plain versions:
   f64 and f32 at D = 200, d = 148, N ∈ {8, 64, 512} and a ragged
   D = 37, d = 5, N = 13 (f64 at rtol 1e-9); bf16 (``rff_features_lowp``)
   bit-equal to the plain bf16 version at 99% of the entries or more,
   and within the forward-error model bound of the f64 value at every
   entry. Then one launch for many nodes (the serving wave, J = 10 at
   N = 512, and a ragged D_j of 37, 200 and 64 in one launch) against
   the batched plain versions with the same checks, padded rows exact
   zeros, and each node bit-equal to its own launch in f64, f32, bf16.
9. Serving at full width: θ of the main path's cuda_fused solve and the
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
10. The decode-attention kernel (``flash_decode``) against its split plain
   version (the kernel's chunks, combined in chunk order) and its one-pass
   plain version at DECODE_SHAPES (2e-5), one long request (B 1, S 32,768)
   among them, in f32 and, where dh is a multiple of 8, in bf16 (plus one
   bf16 ulp of the output); two calls give the same bits, the cache beyond
   cur_index set to ±999 changes no bit, and a CUDA-graph replay gives the
   eager call's bits.
11. LLM serving at qwen1.5-0.5b's full width and depth (24 layers,
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
12. The other mixers (the ``mixers`` phase), each model through the same
   ServeEngine traffic with seeded f32 weights drawn on the card:
   rwkv6-7b at full width and depth (rwkv + rwkv_cmix; 32 layers, d 4096,
   7.5 B parameters), deepseek-moe-16b at full width and 8 of its 28
   layers (attn with flash_decode at dh 128, the moe ffn: 64 routed
   experts top-6 + 2 shared), jamba-1.5-large at its registry reduced()
   size (attn, mamba and moe interleaved) and qwen1.5-0.5b's
   sliding-window variant at full width and 8 of its 24 layers (every
   slot swa, window 8,192). Each: the same requests again give the same tokens,
   one request alone equals sequential decode_step calls, the first
   wave teacher-forced gives the engine's tokens and backend torch
   within LLM_LOGIT_TOL of backend cuda (the swa variant also its attn
   model), decode == the model's own forward (rtol 2e-3, atol 2e-4,
   capacity factor 8), flash_decode launches = attn layers × steps, one
   decode step captured into a CUDA graph (no host sync) and replayed
   for its device time; tokens/s, p50/p99 per request, ms a step, the
   busy share, peak memory. The engine of step 11 is freed first.
12a. Training (the ``train`` phase, after ``mixers``; what came before is
   freed first): (a) qwen1.5-0.5b at full width and depth from seeded
   f32 weights drawn on the card, ``train_loop`` for TRAIN_STEPS steps
   on SyntheticTokenPipeline batches (B 8, S 256, seed 0, made
   beforehand), AdamW lr 3e-4, warmup 5, remat on, deterministic
   algorithms on: every loss finite, the mean of the last 5 below the
   first, grad_norm > 0, every parameter moved; ms a step (host clock
   after a sync, the median after 2 warm-up steps), tokens/s, peak
   memory and train_mfu (6 × matmul parameters × tokens over the step
   and 67 TFLOP/s); (b) the loop's checkpoint of the last step loaded
   back on the card, every tensor bit-equal, and one more step from the
   live and the loaded state bit-equal (with deterministic algorithms
   off, the differences of one step more are printed); (c) the trained
   weights served through ServeEngine with the checks of step 12 (8
   requests, flash_decode 24 × steps, the step captured into a CUDA
   graph); (d) deepseek-moe-16b at full width and 2 of its 28 layers,
   TRAIN_MOE_STEPS steps, its load-balance and router-z losses finite
   and > 0; (e) one step at qwen1.5-0.5b's reduced() size on the card
   against the CPU: the loss, grad_norm and every gradient leaf.
12b. The mesh phase (``repro_torch.launch``, after ``train``): one rank of
   an NCCL group on the card, a 1×1 (data, model) production mesh, and
   qwen1.5-0.5b at full width and depth through ``input_specs`` (bf16
   weights, f32 moments): 3 train steps at B 8 × S 256 with DTensor
   parameters against the plain step from the same draws (deterministic
   algorithms on), the peak memory beside the dry run's for the same pair
   on a fake 1×1 mesh (``python -m repro_torch.launch.dryrun`` in a
   subprocess) within [0.5, 2]×; then 16 serve steps at B 8 over an int8
   cache of 32,768 positions and a bf16 one of 4,096 (filled from a seed),
   flash_decode in bf16 on each rank's shards, 24 launches a step, each
   step against backend torch from the same cache, and the kernel on the
   first layer's inputs against its plain version.
13. The paper's experiments (``repro_torch.paper``) at the synthetic
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
14. The streaming runtime (``repro_torch.stream``) at the main path's
   width, on its maps and training columns with the stream bench's λ
   1e-3, c_nei 0.02·N and tol 1e-8 (``repro_torch.bench.stream_bench``,
   ``cuda_fused``, tol checked every round): init; Woodbury folds at
   b ∈ {8, 32, 128} timed beside the cold rebuild (``pack_problem``) and
   then ingested; four epochs of 16-column batches at nodes 0, 3 and 7,
   each a warm and a cold solve on the same operator (warm fewer rounds
   in every epoch, ``cuda_fused`` == ``cuda`` bit for bit from the same
   θ0, both against the torch backend); a refresh of node 1 at D 200
   and of node 2 grown to 240 (re-pad), every other node's inverse kept
   bit for bit; ``to_packed`` against ``pack_problem`` of the stream's
   ``reference_solver()`` after the ingests and after each refresh at
   rtol 1e-9 where cond(A_j) ≤ 1e6 (cond printed); the sync schedule
   replayed on the CPU through the torch backend, θ and state at rtol
   1e-9; an async epoch (the masked round at tol 1e-8, then 500 rounds
   of the async chain); 512 queries through ``DeKRRServeEngine(rt)``
   equal to ``rt.predict`` at rtol 1e-12, each with the stream's
   staleness; an interleaved ingest–solve–publish loop against a
   2-replica server, every answer equal to a clean serve of the one
   snapshot its staleness names; the path's launches of each kernel.
15. The system benchmarks (``repro_torch.bench``), the ``bench`` phase:
   (a) each backend of the main, async and Chebyshev paths on the main
   path's packed problem (32 rounds, and ``cuda_fused`` in chunks of 10):
   ``repro_torch.obs.dispatch_count`` equal to the contract {torch 0,
   cuda R, cuda_fused ⌈R / chunk⌉} and to the launch counts' delta;
   (b) every kernel's ``repro_torch.analysis.smem`` estimate at the
   paths' shapes equal to the bytes its csrc launcher takes (the
   libraries' ``*_smem_bytes`` exports); (c) the over-budget round (K 4,
   Dy 8, D 640, f64) refused with ``SmemBudgetError``, no launch and no
   CUDA error; (d) the serve bench on the main path's θ (2 replicas,
   waves of 16, 600 closed-loop and 300 open-loop queries at 0.3, 0.6 and
   0.9 of each precision's capacity, every bf16/int8 answer within its
   bound), the solve bench (the reference's cases), the async bench on
   the main path's packed problem, the Chebyshev bench (houses at full
   N) and the multi-output bench, into one registry written as JSONL
   under ``build/chip_bench/`` and rendered by ``repro_torch.obs``; (e)
   the provenance block naming the card and its power limit.
15a. The remaining modules (the ``tools`` phase, after ``bench``): (a)
   the accel bench (``repro_torch.bench.accel_bench``) on houses at full
   N (D_j 30, c_nei 0.005·N): rounds to 1e-3 … 1e-6 plain and Chebyshev
   with the bytes of each, dispatches of the Chebyshev and fused async
   solves on every backend held to {torch 0, cuda R, cuda_fused 1},
   cuda_fused θ == cuda θ bit for bit, solve µs a backend, and
   ``dekrr_cheb_solve``, ``dekrr_async_solve``, ``dekrr_step`` and
   ``rff_gram`` launched; (b) the kernel bench at its three CASES (f32,
   B 1): ``rff_gram`` against its plain version at the f32 tolerance,
   two launches bit for bit, then kernel, plain and yardstick ms beside
   the bounds (rows ``rff_gram@kernel_bench``); (c) the analysis bench,
   clean; (d) the quickstart example on the card against the CPU from
   one set of CPU draws (rtol 1e-9); (e) the readout example's pooled
   features against the CPU's (1e-5 of max|·|, f32), its RSEs printed;
   (f) the perf probe on the mesh phase's pair in a subprocess, started
   after (c) so that its trace shares the host only with (d) and (e),
   which time nothing; its totals == the dry run's record, and
   ``make_report``'s row of the pair.
16. Launch counts of each path and run, zeroed just before it, and
   ``pack_problem`` repeated warm.
17. Kernel times by CUDA events (timed on the device, behind a spin that
   lets the host queue the launches first) beside their plain versions,
   a PyTorch yardstick and the least time the card could take; the
   featurize kernel at the wave and at one node, ``rff_gram`` at the
   shape ``gram_fn_for_solver`` gives it (row ``rff_gram@gram_fn``),
   ``rff_gram``'s wide route at D_j = 600 with its two phases apart (the profiler's device
   time per kernel), and ``flash_decode`` at S 32,768 for B 8 and B 1 and
   at the serving cache (cur 128 and 512) in f32 and bf16 (rows
   ``flash_decode@bf16``, ``flash_decode@bf16,long``, their launches the
   mesh phase's), there both warm (one cache
   launched again) and cold (24 distinct caches launched in turn, the 805
   MB a decode step's layers pass through L2), beside the fastest SDPA
   call, and at deepseek-moe-16b's heads (H = K = 16, dh 128; row
   ``flash_decode@dh128``, its launches the mixers phase's) warm at cur
   128 and 512 beside its split plain version and SDPA; the round kernel, unmasked and masked, at the SPMD shape (J = 1
   over a [1 + K, D] table, rows ``dekrr_step@spmd`` and
   ``dekrr_step_masked@spmd``, their launches the spmd phase's summed
   over ranks). ``dekrr_solve`` and ``dekrr_async_solve``
   are timed in turns with their yardsticks (CHAIN_PAIRS pairs, the
   median of each), and each chain's time per round is printed beside
   the round kernel's.

The last line is ``{"ok": true, "device": {...}}``; any failed phase
exits non-zero before it. Without a CUDA device the script exits
non-zero, and so does a copy of the script without ``src/repro_torch``
beside it, after one line naming where it looked. ``--cpu-rehearsal``
runs steps 4–7, 9, 11–14 (12b on one gloo rank, reduced, without the
dry run), 15 (without its (b)) and 15a (without (f); the accel bench at
300 samples, the readout at 128 × 16) on the CPU at a small
size (the kernels' plain versions; the LLM path on the reduced
qwen1.5-0.5b; the mixers' models reduced, the window 64; the train
phase's (a)–(c) and (e)'s CPU half reduced, 3 steps; Table 2 on
two stand-ins at 600 samples; the stream on the rehearsal's 12 features
a node; the benches at their reduced sizes), for the tests. ``--decode-timings [--src DIR]`` runs only
the ``flash_decode`` timings and the two decode steps of step 11 on the
card, with the ``repro_torch`` package of DIR/.. (``src`` by default), so
one call can time an earlier tree's kernel beside this one's;
``--gram-timings [--src DIR]`` does the same for ``rff_gram`` at rows
3–3‴ of PERF.md's kernel table, ``--features-timings [--src DIR]`` for
``rff_features`` at rows 7 (with the bf16 kernels' registers, spills and
main-loop instruction mix), ``--chain-timings [--src DIR]`` for the round
kernel and the three chains at rows 1, 2, 4, 5 and 6, in turns, each a
median of 5 (with, where the package has them, each chain's split of a
round into phases on both routes by ``%globaltimer``, one L2 hand-off
between two SMs, and the chains' registers and spills).
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import gc
import importlib
import io
import itertools
import json
import math
import os
import re
import shutil
import statistics
import subprocess
import sys
import threading
import time

import numpy as np
import torch

SRC_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "src")
sys.path.insert(0, SRC_DIR)

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
# of the workspace; F = 1,025 and 1,100, the wide route in f32 too; the
# f32 route at B 1: the `gram_fn` shape and the kernel bench's F 512
GRAM_SHAPES = ((10, 200, 148, 3180), (40, 200, 148, 3180), (2, 200, 148, 21),
               (3, 70, 13, 300), (2, 330, 21, 700), (3, 561, 148, 333),
               (2, 600, 148, 700), (10, 600, 148, 3180), (1, 1025, 148, 700),
               (1, 1100, 148, 700), (1, 200, 148, 3180), (1, 512, 96, 30000))
# the wide route timed at the main path's own-block call with D_j = 600
GRAM_WIDE_TIMING = (10, 600, 148, 3180)
# the f32 route's plans printed: the `gram_fn` shape, the kernel bench's
# CASES
GRAM_F32_PLANS = ((1, 200, 148, 3180), (1, 100, 8, 10000),
                  (1, 200, 148, 30000), (1, 512, 96, 30000))

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
# The SPMD phase: one node per rank, all ranks on the one card. NCCL
# refuses two ranks on one device, so the ranks exchange θ over gloo,
# through host buffers.
SPMD_BACKEND = "gloo"
SPMD_MODES = ("ppermute", "allgather")
SPMD_TIMEOUT = 300.0
SPMD_SPLIT_ROUNDS = 200

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

# Streaming: the stream bench's λ 1e-3, c_nei 0.02·N and tol 1e-8
# (repro_torch.bench.stream_bench) on the main path's maps and columns.
STREAM_INGEST = (8, 32, 128)      # minibatch widths folded and timed
STREAM_EPOCHS = 4
STREAM_REFRESHES = ((1, D_PER_NODE), (2, 240))   # (node, D_j after)
STREAM_ASYNC = dict(prob=0.5)
STREAM_ASYNC_ROUNDS = 500         # the async chain's run (tol 0)
STREAM_PUBLISHES = 6              # writer rounds of the interleaved loop
STREAM_THREADED = 256             # queries against the interleaved loop
STREAM_RTOL = 1e-9
STREAM_COND_MAX = 1e6             # rtol 1e-9 where cond(A_j) ≤ this
SERVE_RTOL = 1e-12
# The bench phase: rounds of each dispatch check (and the fused chunk of
# one more), the serve bench's (closed-loop queries, open-loop queries,
# reps) — the reference's full counts — and where its JSONL goes.
BENCH_ROUNDS = 32
BENCH_CHUNK = 10
BENCH_SERVE = (600, 300, 3)
BENCH_OUT = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                         "build", "chip_bench")

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
# bf16 operands: the kernel's f32 sums and the plain versions' f32 sums
# (within DECODE_TOL) are each rounded once to bf16, so the outputs may
# differ by one bf16 ulp (2^-7 of the value) on top of DECODE_TOL
DECODE_TOL_BF16 = 2.0 ** -7
DECODE_TIMING = (8, 16, 16, 64, 32768)
DECODE_LONG = (1, 16, 16, 64, 32768)
# distinct serving caches launched in turn for the cold timing: one per
# layer of qwen1.5-0.5b, 805 MB at B 8, S 512, so each launch finds its
# cache evicted from the 50 MB L2 by the others, as a decode step does
DECODE_COLD_CACHES = 24
# a row's bits at B 1 equal its bits inside B 8 (one chunk, and many
# chunks merged by the last block): (B, H, K, dh, S), cur = S
DECODE_INVARIANCE = ((8, 16, 16, 64, 512), (8, 16, 16, 64, 4096))
# one long request captured into a CUDA graph once, replayed with its
# lengths tensor set to each of these in turn, against eager calls
DECODE_REPLAY = (1, 16, 16, 64, 4096)
DECODE_REPLAY_LENS = (4096, 1000, 1)

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
# bf16 decode at qwen1.5-0.5b's full width and depth: seeded bf16 weights
# and a bf16 cache filled from a seed, LLM_BF16_STEPS steps at the serving
# cache's last positions on backend cuda, each against backend torch from
# a copy of the same cache within MESH_LOGIT_TOL (the mesh phase's bf16
# tolerance, below); then its device ms a step by graph replay
LLM_BF16 = dict(param_dtype="bfloat16", compute_dtype="bfloat16")
LLM_BF16_STEPS = 4

# The mixers phase (repro_torch.models.{moe,ssm,rwkv} and the swa ring):
# each model through ServeEngine at the LLM_* traffic above, seeded f32
# weights drawn on the card. rwkv6-7b at full width and depth;
# qwen1.5-0.5b's sliding-window variant (every slot swa, the registry's
# long-context window of 8,192, as launch/specs.py builds it) at full
# width and MIXER_SWA_LAYERS layers; deepseek-moe-16b
# at full width and 8 of its 28 layers (67.5 GB of f32 weights at full
# depth leaves no room beside the rest of the script); jamba-1.5-large at
# its registry reduced() size (one 8-slot period at d 8192 is ~178 GB).
MIXER_MODELS = ("rwkv6_7b", "deepseek_moe_16b", "jamba_1_5_large_398b",
                "qwen1_5_0_5b-swa")
MIXER_DEEPSEEK_LAYERS = 8
# qwen1.5-0.5b's sliding-window variant at full width and 8 of its 24
# layers: the ring's 8 masked chunks a layer a step took 150 s of the
# script at full depth, and the mesh phase needs the room
MIXER_SWA_LAYERS = 8
MIXER_REHEARSAL_WINDOW = 64    # the rehearsal's window: its max_seq
# decode == own forward, tests/test_arch_smoke.py::
# test_decode_matches_forward: (B, S), (rtol, atol), capacity factor
MIXER_FORWARD = (2, 16)
MIXER_FORWARD_TOL = (2e-3, 2e-4)
MIXER_CAPACITY = 8.0
# flash_decode at deepseek-moe-16b's heads (H = K = 16, dh 128) at the
# serving cache: (B, H, K, dh, S)
DECODE_DH128 = (LLM_BATCH, 16, 16, 128, LLM_MAX_SEQ)

# The train phase (repro_torch.train): qwen1.5-0.5b at full width and
# depth from seeded f32 weights on the synthetic token pipeline, the
# examples/train_lm.py flow (B 8, S 256, seed 0, lr 3e-4, warmup 5, the
# cosine to the phase's last step, remat on as the config has it),
# checkpointed at its last step and served; deepseek-moe-16b at full
# width and 2 of its 28 layers (its MoE aux losses; 26 GB of f32 train
# state); one reduced step on the card against the CPU.
TRAIN_ARCH = "qwen1_5_0_5b"
TRAIN_MOE_ARCH = "deepseek_moe_16b"
TRAIN_MOE_LAYERS = 2
TRAIN_BATCH = 8
TRAIN_SEQ = 256
TRAIN_STEPS = 30
TRAIN_MOE_STEPS = 5
TRAIN_LR = 3e-4
TRAIN_WARMUP = 5
TRAIN_UNTIMED = 2      # warm-up steps left out of the median step
TRAIN_LAST = 5         # the mean of the last 5 losses is below the first
TRAIN_REQUESTS = 8
TRAIN_PROMPT = (16, 32)   # shorter than LLM_PROMPT: one wave of ~60 steps
# card against CPU on one reduced step: tests/test_torch_train.py's
# tolerances (loss rtol 1e-6, each gradient leaf within 1e-4 of its
# max|g|, grad_norm rtol 1e-5)
TRAIN_LOSS_RTOL = 1e-6
TRAIN_GRAD_TOL = 1e-4
TRAIN_NORM_RTOL = 1e-5
# the MFU's peak: f32 outside the tensor cores (TF32 stays off)
TRAIN_PEAK_FLOPS = 67e12
# deterministic mode needs cuBLAS's workspace configuration set before
# the first cuBLAS call; this is the workspace PyTorch already gives
# cuBLAS on sm_90 (4,096 KiB × 8), so no earlier phase changes
CUBLAS_DETERMINISTIC = ":4096:8"
TRAIN_CKPT = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                          "build", "chip_train", "ckpt")

# The mesh phase (slice 10d, repro_torch.launch): one rank of an NCCL group
# on the card (NCCL refuses two ranks on one device), a 1×1 (data, model)
# production mesh, qwen1.5-0.5b at full width and depth from
# launch/specs.py::input_specs (bf16 parameters, f32 moments, pure DP):
# MESH_TRAIN_STEPS train steps at B 8 × S 256 with DTensor parameters
# against the same steps on plain tensors from the same draws (with
# deterministic algorithms on; within MESH_LOSS_RTOL), the peak memory
# beside the dry run's for the same pair on
# a fake 1×1 mesh (in a subprocess) within MESH_PEAK_BAND; then the serve
# step at B 8 over a cache of each MESH_DECODE_SEQS length (S 32,768: int8,
# as input_specs picks past 8 GiB a device; S 4,096: bf16), filled from a
# seed, MESH_DECODE_STEPS steps at its last positions through flash_decode
# in bf16, each step against backend torch from a copy of the same cache.
MESH_TRAIN = (8, 256)
MESH_TRAIN_STEPS = 3
# the mesh path reads the embedding through F.embedding, whose backward
# on the card sums a repeated token's gradients in another order than the
# plain path's index backward: step 1's loss is bit-equal, later ones
# follow bf16 weights that may differ by a rounding (2.4e-4 measured on an
# H100); on the CPU the two are bit-equal
MESH_LOSS_RTOL = 1e-3
MESH_PEAK_BAND = (0.5, 2.0)
MESH_DECODE_BATCH = 8
MESH_DECODE_SEQS = (32768, 4096)
MESH_DECODE_STEPS = 16
# backend cuda (flash_decode on bf16) against backend torch (chunked
# attention in f32, rounded to bf16), the same cache each step: every
# layer's attention output may differ by one bf16 rounding (2^-8), and
# 24 layers of bf16 activations of a random-weight model carry that to
# the logits ~10-fold (3.3-5.3% of max|logit| on an H100 over random int8
# caches at S 32,768; 0 on the CPU at S 2,048), so the check takes 2^-3;
# the kernel itself is held on the step's own layer-0 inputs to its plain
# version at the kernel's tolerance (_decode_agrees)
MESH_LOGIT_TOL = 2.0 ** -3
MESH_OUT = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "build", "chip_mesh")

# the tools phase: the accel, kernel and analysis benches, the examples,
# the perf probe and make_report (repro_torch.bench, .examples,
# .experiments)
TOOLS_READOUT = (600, 32)       # the readout example's sequences × tokens
TOOLS_RTOL = 1e-9               # the quickstart, card against CPU (f64)
TOOLS_FEATURE_TOL = 1e-5        # pooled logits, card against CPU (f32)
TOOLS_ACCEL_LAUNCHES = ("dekrr_cheb_solve", "dekrr_async_solve",
                        "dekrr_step", "rff_gram")

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
    """Mean device ms of fn by CUDA events, the device spun before the
    timed launches (`repro_torch.bench.common.event_ms`)."""
    from repro_torch.bench.common import event_ms
    return event_ms(fn, reps=reps, warmup=warmup)


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
    (``_ZN<len><namespace><len><name>I…E...``: ``d`` f64, ``f`` f32,
    ``13__nv_bfloat16`` bf16, ``Li3E`` the int 3, e.g.
    ``rff_features_kernel<bf16,4,2,1>``, ``rff_gram_f32_kernel<3>``)."""
    m = re.match(r"_ZN(\d+)", mangled)
    if not m:
        return mangled
    rest = mangled[m.end() + int(m.group(1)):]
    m = re.match(r"(\d+)", rest)
    if not m:
        return mangled
    name = rest[m.end():m.end() + int(m.group(1))]
    args = rest[m.end() + int(m.group(1)):]
    if not args.startswith("I"):
        return name
    out, args = [], args[1:]
    kinds = (("d", "f64"), ("f", "f32"), ("13__nv_bfloat16", "bf16"))
    while args and not args.startswith("E"):
        kind = next((k for k in kinds if args.startswith(k[0])), None)
        value = re.match(r"Li(\d+)E", args)
        nested = re.match(r"N((?:\d+\w+?)+?)E", args)
        if kind:
            out.append(kind[1])
            args = args[len(kind[0]):]
        elif value:
            out.append(value.group(1))
            args = args[value.end():]
        elif nested:   # a class type: N<len><namespace><len><name>E
            parts, rest_ = [], nested.group(1)
            while rest_:
                m = re.match(r"(\d+)", rest_)
                k = int(m.group(1))
                parts.append(rest_[m.end():m.end() + k])
                rest_ = rest_[m.end() + k:]
            out.append(parts[-1])
            args = args[nested.end():]
        else:
            return name
    return f"{name}<{','.join(out)}>"


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


def sass_loop_mix(library: str, match: str) -> list[dict]:
    """Of each kernel in the shared library whose entry name (kernel_name)
    holds ``match``: the instruction mix of its main loop, the basic block
    of ``cuobjdump -sass`` with the most FFMA (blocks start at a label or a
    branch target and end after a branch; NOPs not counted): FFMA, LDS and
    all instructions, and FFMA's share of them."""
    cuobjdump = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    text = subprocess.run([cuobjdump, "-sass", library], capture_output=True,
                          text=True, timeout=120, check=True).stdout
    out = []
    for part in text.split("Function : ")[1:]:
        name = kernel_name(part.split()[0])
        if match not in name:
            continue
        code = [(int(m.group(1), 16), m.group(2)) for m in re.finditer(
            r"/\*([0-9a-f]{4,})\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_]*)"
            r"[^;\n]*", part)]
        targets = {int(t, 16) for t in re.findall(
            r"\bBRA(?:\.\w+)*\s+(0x[0-9a-f]+)", part)}
        blocks, block = [], []
        for addr, op in code:
            if addr in targets and block:
                blocks.append(block)
                block = []
            if op == "NOP":
                continue
            block.append(op)
            if op in ("BRA", "EXIT", "RET", "BRX", "JMP"):
                blocks.append(block)
                block = []
        blocks.append(block)
        loop = max(blocks, key=lambda b: b.count("FFMA"))
        out.append(dict(kernel=name, ffma=loop.count("FFMA"),
                        lds=loop.count("LDS"), instructions=len(loop),
                        ffma_share=loop.count("FFMA") / max(len(loop), 1)))
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
        gram_errs = []
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
            gram_errs.append(f"{shape} {e:.3e}")
            if f64:
                errs["rff_gram"] = max(errs["rff_gram"], e)
        print(f"rff_gram {dtype} against its plain version at rtol "
              f"{TOL[dtype]:g}, two launches bit-equal, G == Gᵀ; max abs "
              f"err by (B, F, d, N): " + "; ".join(gram_errs), flush=True)
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
                again = ops.dekrr_solve(*ops_args, num_rounds=rounds,
                                        trace=True)
                want, wres = dekrr_solve_reference(
                    *lay, num_rounds=rounds, dy=dy, trace=True)
                want = ops._unflatten_dy(want, dy, d.ndim)
                torch.cuda.synchronize()
                if not (torch.equal(again[0], got) and
                        torch.equal(again[1], res)):
                    raise PhaseError(f"dekrr_solve R={rounds}: two launches "
                                     f"on equal inputs differ ({case})")
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
        print(f"kernel phases {dtype}: pass (chain routes so far: "
              f"{json.dumps(route_counts())})", flush=True)
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
                    again = ops.dekrr_async_solve(*a_args, gossip=gossip,
                                                  censored=censored,
                                                  trace=True)
                    if not all(torch.equal(x, y) for x, y in zip(got, again)):
                        raise PhaseError(f"dekrr_async_solve: two launches "
                                         f"on equal inputs differ ({tag})")
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
            _check_cheb_routes(c_args, dy, case)
            if t_rows == J_NODES:
                ident = torch.arange(J_NODES, dtype=torch.int32,
                                     device="cuda")
                note("dekrr_cheb_solve", _check_cheb_chain(
                    c_args[:7] + (ident,) + c_args[8:], dy, case))
                _check_cheb_routes(c_args[:7] + (ident,) + c_args[8:], dy,
                                   case)
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
        print(f"chain kernel phases {dtype}: pass (chain routes so far: "
              f"{json.dumps(route_counts())})", flush=True)
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


def _check_cheb_routes(c_args, dy: int, case: str) -> None:
    """At the paper's J and D the Chebyshev chain takes the resident
    route; the streamed route, forced on the same operands, gives the same
    θ, p and trace bit for bit."""
    from repro_torch.kernels import ops
    from repro_torch.kernels.dekrr_solve import (cheb_plan,
                                                 dekrr_cheb_solve_cuda,
                                                 streamed_plan)

    g, d, s, p, theta, delta, nbr_idx, self_idx, nbr_mask, al, be = c_args
    lay = _raw_layout((g, d, s, p, theta, nbr_idx, self_idx, nbr_mask))
    j_nodes, d_feat, dtype = d.shape[0], d.shape[1], d.dtype
    plan = cheb_plan(lay[5], lay[6], lay[7], d_feat=d_feat, dy=dy,
                     dtype=dtype, rounds=al.shape[0])
    if plan.route != "resident":
        raise PhaseError(f"dekrr_cheb_solve took the {plan.route} route at "
                         f"J {j_nodes}, D {d_feat} ({case}): {plan.why}")
    raw = lay[:5] + (ops._flatten_dy(delta),) + lay[5:] + (al, be)
    kw = dict(dtype=dtype, device="cuda")
    outs = []
    for pl in (plan, streamed_plan("dekrr_cheb_solve", j_nodes,
                                   lay[3].shape[1], d_feat, dy, dtype)):
        o = (torch.empty((j_nodes * dy, d_feat), **kw),
             torch.empty((j_nodes * dy, d_feat), **kw),
             torch.empty((al.shape[0], j_nodes), **kw))
        dekrr_cheb_solve_cuda(*raw, *o, torch.empty(
            (2,) + tuple(lay[4].shape), **kw), dy=dy, plan=pl)
        outs.append(o)
    torch.cuda.synchronize()
    for what, a, b in zip(("θ", "p", "res"), *outs):
        if not torch.equal(a, b):
            raise PhaseError(f"dekrr_cheb_solve {what}: resident ≠ streamed "
                             f"route bit for bit ({case})")


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
    before = route_counts()
    t0 = time.perf_counter()
    theta, rounds, trace = solve_batched(
        packed, num_iters, backend="cuda_fused", tol=SOLVE_TOL,
        return_rounds=True, return_trace=True)
    sync()
    t_solve = time.perf_counter() - t0
    routes = route_counts(before)
    theta_step = solve_batched(packed, rounds, backend="cuda")
    preds = torch.cat([solver.predict(unpack_theta(packed, theta), nd.x,
                                      node=j) for j, nd in enumerate(test)])
    test_rse = rse(preds, torch.cat([nd.y for nd in test]))
    sync()
    launches = ops.launch_counts()
    return dict(solver=solver, packed=packed, theta=theta,
                theta_step=theta_step, rounds=rounds, trace=trace,
                rse=test_rse, t_pack=t_pack, t_solve=t_solve,
                launches=launches, n_train=n_train, preds=preds, test=test,
                routes=routes)


def route_counts(before: dict | None = None) -> dict:
    """The chains' launches by route (`kernels.dekrr_solve.ROUTE_LAUNCHES`,
    "name@route"), less ``before`` where given."""
    from repro_torch.kernels.dekrr_solve import ROUTE_LAUNCHES
    now = {f"{name}@{route}": n for (name, route), n in ROUTE_LAUNCHES.items()}
    if before is None:
        return now
    return {k: v - before.get(k, 0) for k, v in now.items()
            if v - before.get(k, 0)}


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
    before = route_counts()
    fused = solve(masks, config, "cuda_fused", **wire)
    return dict(
        masks=masks, config=config, rounds=rounds, edge_masks=edge_masks,
        edge_config=edge_config, fused=fused,
        fused_routes=route_counts(before) if packed.device.type == "cuda"
        else {},
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
    before = route_counts()
    fused = _launched(lambda: chebyshev_solve_packed(
        packed, hi, lo, num_iters=rounds, backend="cuda_fused",
        return_trace=True))
    fused_routes = route_counts(before) if packed.device.type == "cuda" \
        else {}
    per_round = _launched(lambda: chebyshev_solve_packed(
        packed, hi, lo, num_iters=rounds, backend="cuda"))
    theta_star = pack_theta(packed, checks["exact"])
    plain_rounds, cheb_rounds = rounds_to_tolerance(
        packed, theta_star, tol=CHEB_TOL, max_rounds=2 * rounds,
        mu_max=hi, mu_min=lo, backend="cuda")
    return dict(mu=(lo, hi), rounds=rounds, interval=interval, fused=fused,
                fused_routes=fused_routes, per_round=per_round,
                plain_rounds=plain_rounds, cheb_rounds=cheb_rounds)


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
    if c["fused_routes"] != {"dekrr_cheb_solve@resident": 1}:
        raise PhaseError(f"the Chebyshev path's fused solve did not make one "
                         f"resident dekrr_cheb_solve launch: "
                         f"{c['fused_routes']}")
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

    from repro_torch.kernels.dekrr_solve import dekrr_solve_cuda, solve_plan
    plan = solve_plan(lay[5], lay[6], lay[7], d_feat=d_feat, dy=dy,
                      dtype=dtype, rounds=CHUNK)
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
                                 dy=dy, plan=plan),
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
            *lay, out, None, work, num_rounds=CHUNK, dy=dy, plan=plan)),
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
    from repro_torch.kernels.dekrr_solve import (async_plan, cheb_plan,
                                                 dekrr_async_solve_cuda,
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
    plan = async_plan(raw[7], raw[8], d_feat=d_feat, dy=dy, dtype=dtype,
                      rounds=rounds)
    ms, library_ms = paired_ms(
        lambda: dekrr_async_solve_cuda(
            *raw, *outs, work, flags, censored=True, edge_gossip=False,
            dy=dy, plan=plan),
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
    plan = cheb_plan(lay[5], lay[6], lay[7], d_feat=d_feat, dy=dy,
                     dtype=dtype, rounds=c["rounds"])
    rows_out.append(dict(
        name="dekrr_cheb_solve", route="cuda",
        source="src/repro_torch/kernels/csrc/dekrr_cheb_solve.cu",
        replaces="src/repro/kernels/dekrr_solve.py:620",
        ms=cuda_ms(lambda: dekrr_cheb_solve_cuda(*craw, *couts, work,
                                                 dy=dy, plan=plan), reps=5),
        plain_ms=cuda_ms(lambda: dekrr_cheb_solve_reference(
            *craw, dy=dy, trace=True), reps=3, warmup=1),
        bound_ms=bms, bound_by=by,
        library_ms=cuda_ms(lambda: chebyshev_solve_packed(
            packed, hi, lo, num_iters=c["rounds"], backend="torch",
            return_trace=True), reps=3, warmup=1), rounds=c["rounds"]))
    return rows_out


def feature_timings(run: dict) -> list[dict]:
    """`feature_rows` on the main path's ten maps and the first SERVE_N
    test columns (the column bucket of the serving waves)."""
    fmaps = run["solver"].feature_maps
    omega = torch.stack([fm.omega for fm in fmaps]).contiguous()
    bias = torch.stack([fm.bias for fm in fmaps]).contiguous()
    x = torch.cat([nd.x for nd in run["test"]], dim=1)[:, :SERVE_N]
    return feature_rows(omega, bias, x.contiguous(),
                        [fm.num_frequencies for fm in fmaps])


def feature_rows(omega, bias, x, d_feats) -> list[dict]:
    """The featurize kernel by CUDA events, f64 and bf16 (bf16 operands at
    unit scale, as the low-precision path launches it), on f64 maps
    omega [J, D, d], bias [J, D] of ``d_feats`` features and columns x
    [d, N]: at one node's shape (rows ``rff_features`` and
    ``rff_features_lowp``, timed as in earlier runs) and at the wave (the
    J maps in one launch; rows ``…@wave``, with the cost of the J
    single-node launches a wave made before, ``per_node_ms``)."""
    from repro_torch.kernels.ops import _node_table
    from repro_torch.kernels.rff_features import (
        rff_features_batched_reference, rff_features_bf16_batched_reference,
        rff_features_cuda)

    j, d_feat, dim = omega.shape
    n = x.shape[1]
    scales = [math.sqrt(2.0 / dj) for dj in d_feats]
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
def _decode_operands(b, h, kh, dh, s, seed, dtype=torch.float32):
    gen = torch.Generator(device="cuda").manual_seed(seed)
    kw = dict(dtype=torch.float32, device="cuda", generator=gen)
    return tuple(t.to(dtype) for t in (torch.randn((b, 1, h, dh), **kw),
                                       torch.randn((b, s, kh, dh), **kw),
                                       torch.randn((b, s, kh, dh), **kw)))


def _decode_agrees(got, want, dtype) -> bool:
    """|got − want| ≤ DECODE_TOL·(1 + |want|), plus one bf16 ulp of want
    for bf16 operands."""
    got, want = got.float(), want.float()
    bound = DECODE_TOL * (1 + want.abs())
    if dtype == torch.bfloat16:
        bound = bound + DECODE_TOL_BF16 * want.abs()
    return bool(torch.isfinite(got).all() and ((got - want).abs()
                                               <= bound).all())


def bf16_decode_edges() -> list[tuple]:
    """bf16 shapes at every edge of the bf16 split (dh 64, one query head
    a kv head): lengths 1, a chunk less one, a chunk, a chunk and one, and
    the merge's window of chunks and one past it (the last block folds the
    row's partials in windows staged in its ring)."""
    from repro_torch.kernels.decode_attention import decode_plan

    plan = decode_plan(2, 1, 64, 2)
    c, w = plan.chunk, plan.merge_window
    return [(1, 2, 2, 64, (w + 1) * c, cur)
            for cur in (1, c - 1, c, c + 1, w * c, w * c + 1)]


def flash_decode_phase() -> dict[str, float]:
    """The decode-attention kernel against its split plain version (the
    kernel's chunks, merged in chunk order) and its one-pass plain version
    on the card at DECODE_SHAPES in f32 and, where dh is a multiple of 8,
    in bf16, and at the bf16 split's edges (`bf16_decode_edges`)
    (`_decode_agrees`); at each shape a second call gives the same bits
    and, with a stale tail, the cache set to ±999 beyond cur_index gives
    the same output bit for bit; at one long request a CUDA-graph replay
    gives the eager call's bits, and one graph replayed with new lengths
    gives each length's eager bits; a row launched alone gives its bits
    inside B 8 (DECODE_INVARIANCE); in both types. Returns the largest
    error of each type."""
    from repro_torch.kernels import ops
    from repro_torch.kernels.decode_attention import (
        flash_decode_cuda, flash_decode_reference,
        flash_decode_split_reference)

    f32, b16 = torch.float32, torch.bfloat16
    worst = {f32: 0.0, b16: 0.0}
    cases = [(c, f32) for c in DECODE_SHAPES] + [
        (c, b16) for c in DECODE_SHAPES if c[3] % 8 == 0] + [
        (c, b16) for c in bf16_decode_edges()]
    for (b, h, kh, dh, s, cur), dtype in cases:
        case = f"B={b} H={h} K={kh} dh={dh} S={s} cur={cur} {dtype}"
        q, k, v = _decode_operands(b, h, kh, dh, s, seed=s + cur,
                                   dtype=dtype)
        got = ops.flash_decode(q, k, v, cur)
        if got.dtype != dtype:
            raise PhaseError(f"flash_decode {case}: returned {got.dtype}")
        lens = torch.full((b * kh,), cur, dtype=torch.int32, device="cuda")
        for plain in (flash_decode_split_reference, flash_decode_reference):
            want = plain(q, k, v, lens)
            torch.cuda.synchronize()
            err = (got.float() - want.float()).abs()
            if not _decode_agrees(got, want, dtype):
                raise PhaseError(f"flash_decode {case}: disagrees with "
                                 f"{plain.__name__} beyond its tolerance "
                                 f"(max abs err {err.max().item():.3e})")
            worst[dtype] = max(worst[dtype], err.max().item())
        if not torch.equal(ops.flash_decode(q, k, v, cur), got):
            raise PhaseError(f"flash_decode {case}: two calls gave other bits")
        if cur < s:
            k[:, cur:] = 999.0
            v[:, cur:] = -999.0
            if not torch.equal(ops.flash_decode(q, k, v, cur), got):
                raise PhaseError(f"flash_decode {case}: the cache beyond "
                                 f"cur_index changed the output")
    b, h, kh, dh, s = DECODE_LONG
    for dtype in worst:
        q, k, v = _decode_operands(b, h, kh, dh, s, seed=3, dtype=dtype)
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
                raise PhaseError(f"flash_decode {dtype}: a CUDA-graph replay "
                                 f"gave other bits than the eager call")
    b, h, kh, dh, s = DECODE_REPLAY
    for dtype in worst:
        q, k, v = _decode_operands(b, h, kh, dh, s, seed=5, dtype=dtype)
        lens = torch.full((b * kh,), s, dtype=torch.int32, device="cuda")
        out = torch.empty_like(q)
        flash_decode_cuda(q, k, v, lens, out)
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            flash_decode_cuda(q, k, v, lens, out)
        torch.cuda.current_stream().wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            flash_decode_cuda(q, k, v, lens, out)
        for cur in DECODE_REPLAY_LENS:
            lens.fill_(cur)
            out.zero_()
            graph.replay()
            torch.cuda.synchronize()
            if not torch.equal(out, ops.flash_decode(q, k, v, cur)):
                raise PhaseError(f"flash_decode {dtype}: a CUDA-graph replay "
                                 f"with lengths {cur} gave other bits than "
                                 f"the eager call at {cur}")
    for dtype in worst:
        for b, h, kh, dh, s in DECODE_INVARIANCE:
            q, k, v = _decode_operands(b, h, kh, dh, s, seed=7, dtype=dtype)
            whole = ops.flash_decode(q, k, v, s)
            for i in (0, b // 2, b - 1):
                alone = ops.flash_decode(q[i:i + 1], k[i:i + 1], v[i:i + 1],
                                         s)
                if not torch.equal(alone, whole[i:i + 1]):
                    raise PhaseError(
                        f"flash_decode {dtype}: row {i} of B={b} S={s} "
                        f"launched alone gave other bits than inside the "
                        f"batch")
    print(f"flash_decode phase: pass ({len(cases)} shapes and types, max "
          f"abs err {worst[f32]:.3e} in f32, {worst[b16]:.3e} in bf16 "
          f"against the split and one-pass plain versions, two calls, the "
          f"stale tail, graph replays (one at lengths "
          f"{list(DECODE_REPLAY_LENS)}) and B 1 against B "
          f"{DECODE_INVARIANCE[0][0]} bit for bit)", flush=True)
    return {"flash_decode": worst[f32], "flash_decode@bf16": worst[b16]}


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
             prompt=LLM_PROMPT, new_tokens=LLM_NEW_TOKENS,
             variants=None, params=None) -> dict:
    """The LLM serving path: ServeEngine (backend cuda) with the port's
    seeded weights (or `params`) serves `requests` greedy requests twice,
    the repeat run timed with the launch counts zeroed just before; then
    one request alone against sequential decode_step calls, and the
    first wave's tokens teacher-forced through decode_step on both
    backends and through each of `variants` (a name to a function of the
    engine's parameters giving another model, run on backend cuda; by
    default the int8 cache)."""
    from repro_torch.models.model import Model
    from repro_torch.serve import Request, ServeEngine

    if variants is None:
        variants = {"int8": lambda params: Model(
            dataclasses.replace(cfg, kv_cache_dtype="int8"), params)}

    engine = ServeEngine(cfg, params, batch_size=batch, max_seq=max_seq,
                         seed=0, device=device, backend="cuda")
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

    # teacher forcing the first wave: cuda vs torch, and the variants
    wave = done[:batch]
    runs = {"cuda": (model, "cuda"), "torch": (model, "torch")}
    runs.update({k: (make(engine.params), "cuda")
                 for k, make in variants.items()})
    caches = {k: m.init_cache(batch, max_seq) for k, (m, _) in runs.items()}
    diff = {k: 0.0 for k in runs if k != "cuda"}
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
    if "int8" in rel and not rel["int8"] < INT8_LOGIT_TOL:
        raise PhaseError(f"LLM serving: int8-cache logits differ by "
                         f"{rel['int8']:.3e} of max|logit| from the f32 cache "
                         f"(tolerance {INT8_LOGIT_TOL:g})")
    if "attn" in rel and not rel["attn"] <= LLM_LOGIT_TOL:
        raise PhaseError(f"{cfg.name}: the sliding-window logits differ by "
                         f"{rel['attn']:.3e} of max|logit| from the attn "
                         f"model's inside the window (tolerance "
                         f"{LLM_LOGIT_TOL:g})")
    got = {k: v for k, v in llm["launches"].items() if v}
    want = {"flash_decode": attn_layers(cfg) * llm["steps"]} \
        if on_card and attn_layers(cfg) else {}
    if got != want:
        raise PhaseError(f"LLM serving launch counts {got}, expected {want}")
    llm.update(tokens=n_tokens, rel=rel)


def attn_layers(cfg) -> int:
    """Layers whose mixer is ``attn``: each launches flash_decode once a
    decode step on backend cuda."""
    return cfg.num_groups * sum(s.mixer == "attn" for s in cfg.slots)


def sdpa_yardsticks(q, k, v, want, cur: int) -> dict:
    """PyTorch's scaled_dot_product_attention computing the kernel's
    function at cur on the same cache views ([B, S, K, dh] transposed to
    [B, K, S, dh], no copy): the call with the length mask and
    enable_gqa, and the plain call on the views up to cur (H = K here),
    each under every SDPA backend that takes it, beside the plain call on
    contiguous [B, K, cur, dh] copies (another layout, timed for reference
    only). Only calls within DECODE_TOL·(1 + |want|) of `want` count
    (bf16: plus one bf16 ulp of want and of max|v|, since SDPA rounds each
    probability to bf16 before its product with V).
    Returns {"ms": fastest on the same inputs, "call": its label, "table":
    {label: {backend: ms}}, "default": {label: kernels the default
    dispatch launched}}."""
    import warnings

    import torch.nn.functional as F
    from torch.nn.attention import SDPBackend, sdpa_kernel

    qt, kt, vt = q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)
    k_cur, v_cur = kt[:, :, :cur], vt[:, :, :cur]
    calls = sdpa_calls(q, k, v, cur)
    backends = [getattr(SDPBackend, n) for n in (
        "FLASH_ATTENTION", "EFFICIENT_ATTENTION", "CUDNN_ATTENTION", "MATH")
        if hasattr(SDPBackend, n)]
    want_t = want.transpose(1, 2).float()
    bound = DECODE_TOL * (1 + want_t.abs())
    if q.dtype == torch.bfloat16:
        vmax = v[:, :cur].abs().max().float()
        bound = bound + DECODE_TOL_BF16 * (want_t.abs() + vmax)

    def agrees(got):
        return bool((got.float() - want_t).abs().le(bound).all())

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
    best = min(((ms, label, be) for label, row in same.items()
                for be, ms in row.items()),
               default=(float("nan"), "none", None))
    qc, kc, vc = qt.contiguous(), k_cur.contiguous(), v_cur.contiguous()
    same.update(table({"contiguous copies": lambda: (
        F.scaled_dot_product_attention(qc, kc, vc))}))
    return dict(ms=best[0], call=f"{best[1]} [{best[2]}]", label=best[1],
                backend=best[2], table=same, default=default)


def sdpa_calls(q, k, v, cur: int) -> dict:
    """`sdpa_yardsticks`' calls on one cache, by label."""
    import torch.nn.functional as F

    s = k.shape[1]
    mask = (torch.arange(s, device="cuda") < cur)[None, None, None, :]
    qt, kt, vt = q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)
    k_cur, v_cur = kt[:, :, :cur], vt[:, :, :cur]
    return {
        "views, mask, enable_gqa": lambda: F.scaled_dot_product_attention(
            qt, kt, vt, attn_mask=mask, enable_gqa=True),
        "views": lambda: F.scaled_dot_product_attention(qt, k_cur, v_cur),
    }


def sdpa_cold_ms(sdpa: dict, sets, cur: int) -> float:
    """The fastest SDPA call of `sdpa_yardsticks` (its label and backend,
    picked warm) over the distinct caches ``sets`` launched in turn, as
    `decode_kernel_ms` times the kernel cold."""
    from torch.nn.attention import SDPBackend, sdpa_kernel

    if sdpa["backend"] is None:
        return float("nan")
    fns = itertools.cycle([sdpa_calls(q, k, v, cur)[sdpa["label"]]
                           for q, k, v in sets])
    backend = getattr(SDPBackend, sdpa["backend"])

    def run():
        with sdpa_kernel([backend]):
            return next(fns)()

    return cuda_ms(run, reps=max(20, 2 * len(sets)))


def decode_kernel_ms(b, h, kh, dh, s, cur, *, caches: int = 1,
                     dtype=torch.float32) -> dict:
    """flash_decode_cuda by CUDA events at (B, H, K, dh, S) and cur over
    `caches` distinct caches launched in turn (1: the same cache again,
    warm in L2 where it fits; DECODE_COLD_CACHES: each launch finds its
    cache evicted by the others'), beside the least time the card could
    take: K and V up to cur read once, q and lens read, out written, the
    two products (softmax arithmetic not counted; f32 FMAs in both
    types)."""
    from repro_torch.kernels.decode_attention import flash_decode_cuda

    sets = [_decode_operands(b, h, kh, dh, s, seed=1 + i, dtype=dtype)
            for i in range(caches)]
    q = sets[0][0]
    lens = torch.full((b * kh,), cur, dtype=torch.int32, device="cuda")
    out = torch.empty_like(q)
    turn = itertools.cycle(sets)

    def launch():
        qi, ki, vi = next(turn)
        flash_decode_cuda(qi, ki, vi, lens, out)

    bms, by = bound_ms(2 * b * cur * kh * dh * q.element_size()
                       + nbytes(q, lens, out), 4 * b * h * cur * dh,
                       torch.float32)
    ms = cuda_ms(launch, reps=max(20, 2 * caches))
    return dict(ms=ms, bound_ms=bms, bound_by=by, operands=sets[0],
                sets=sets, lens=lens, out=out)


def decode_timings(*, plain: bool = True,
                   sdpa: tuple = (torch.float32, torch.bfloat16)
                   ) -> list[dict]:
    """The decode-attention kernel by CUDA events at DECODE_TIMING (the
    registry's decode_32k length, cur = S) and DECODE_LONG (one long
    request), each beside its plain version (the split one, the kernel's
    chunks; with `plain`) and, for the types in `sdpa`, the fastest
    scaled_dot_product_attention call on the same inputs
    (`sdpa_yardsticks`); and at the serving cache (S = LLM_MAX_SEQ, cur a
    quarter of it and all of it) warm and cold, beside the fastest SDPA
    call there warm and that call cold (the same caches in turn); in f32
    (rows ``flash_decode``, ``flash_decode@long``) and bf16 (rows
    ``flash_decode@bf16``, ``flash_decode@bf16,long``: the same shapes,
    the bound at 2 bytes a value)."""
    from repro_torch.kernels.decode_attention import (
        flash_decode_split_reference)

    rows = []
    f32, b16 = torch.float32, torch.bfloat16
    cases = [("flash_decode", DECODE_TIMING, f32),
             ("flash_decode@long", DECODE_LONG, f32),
             ("flash_decode@bf16", DECODE_TIMING, b16),
             ("flash_decode@bf16,long", DECODE_LONG, b16)]
    for name, (b, h, kh, dh, s), dtype in cases:
        t = decode_kernel_ms(b, h, kh, dh, s, s, dtype=dtype)
        row = dict(name=name, kernel=("flash_decode" if dtype == f32 else
                                      "flash_decode@bf16"), route="cuda",
                   source="src/repro_torch/kernels/csrc/flash_decode.cu",
                   replaces="src/repro/kernels/decode_attention.py:89",
                   shape=[b, h, kh, dh, s, s], ms=t["ms"],
                   bound_ms=t["bound_ms"], bound_by=t["bound_by"])
        q, k, v = t["operands"]
        if plain:
            row["plain_ms"] = cuda_ms(
                lambda: flash_decode_split_reference(q, k, v, t["lens"]),
                reps=5, warmup=1)
        if dtype in sdpa:
            row["sdpa"] = sdpa_yardsticks(q, k, v, t["out"], s)
            row["library_ms"] = row["sdpa"]["ms"]
        rows.append(row)
        del t, q, k, v
    for dtype, row in ((f32, rows[0]), (b16, rows[2])):
        serving = {}
        for cur in (LLM_MAX_SEQ // 4, LLM_MAX_SEQ):
            shape = (LLM_BATCH, 16, 16, 64, LLM_MAX_SEQ, cur)
            warm = decode_kernel_ms(*shape, dtype=dtype)
            cold = decode_kernel_ms(*shape, caches=DECODE_COLD_CACHES,
                                    dtype=dtype)
            serving[cur] = dict(warm_ms=warm["ms"], cold_ms=cold["ms"],
                                bound_ms=warm["bound_ms"])
            if dtype in sdpa:
                q, k, v = warm["operands"]
                best = sdpa_yardsticks(q, k, v, warm["out"], cur)
                serving[cur]["sdpa"] = best
                serving[cur]["sdpa_cold_ms"] = sdpa_cold_ms(
                    best, cold["sets"], cur)
            del warm, cold
        row["serving"] = serving
    return rows


def _decode_model(device: str = "cuda", *, bf16: bool = False,
                  full: bool = True):
    """qwen1.5-0.5b at full width and depth (its reduced configuration
    unless `full`) with the engine's seeded weights (ServeEngine(seed=0));
    with `bf16`, bf16 parameters and compute (LLM_BF16), so a bf16
    cache."""
    from repro_torch.models.model import Model, init_params

    cfg = _llm_config() if full else _llm_config().reduced()
    if bf16:
        cfg = dataclasses.replace(cfg, **LLM_BF16)
    return Model(cfg, init_params(
        cfg, torch.Generator(device).manual_seed(0)))


def bf16_decode_steps(model, device: str, *, batch: int, max_seq: int,
                      steps: int = LLM_BF16_STEPS, seed: int = 29) -> dict:
    """A bf16 model's decode step over a cache filled from ``seed``:
    ``steps`` steps at the cache's last positions on backend cuda, each
    against backend torch from a copy of the same cache. Returns {rel:
    max |Δlogit| / max|logit| over the steps, scale, finite, launches:
    flash_decode's on the card (dispatches on the CPU) during the cuda
    steps}."""
    from repro_torch.kernels import ops
    from repro_torch.launch.mesh_cases import fill_cache

    on_card = device == "cuda"
    cache = model.init_cache(batch, max_seq)
    fill_cache(cache, seed, torch.device(device))
    gen = torch.Generator(device=device).manual_seed(seed + 1)
    toks = torch.randint(0, model.cfg.vocab_size, (steps, batch, 1),
                         generator=gen, device=device)
    first = max_seq - steps
    counts = ops.launch_counts if on_card else ops.dispatch_counts
    rel, scale, finite, launches = 0.0, 0.0, True, 0
    with torch.inference_mode():
        for i in range(steps):
            copy = {slot: {n: t.clone() for n, t in e.items()}
                    for slot, e in cache.items()}
            before = counts()["flash_decode"]
            got, cache = model.decode_step(cache, toks[i], first + i,
                                           backend="cuda")
            launches += counts()["flash_decode"] - before
            want, _ = model.decode_step(copy, toks[i], first + i,
                                        backend="torch")
            got, want = got.float(), want.float()
            finite = finite and bool(torch.isfinite(got).all())
            step_scale = float(want.abs().max())
            scale = max(scale, step_scale)
            rel = max(rel, float((got - want).abs().max()) / step_scale)
            del copy
    return dict(rel=rel, scale=scale, finite=finite, launches=launches)


def bf16_step_phase(card: str, device: str = "cuda", *, full: bool = True,
                    batch: int = LLM_BATCH, max_seq: int = LLM_MAX_SEQ
                    ) -> dict:
    """qwen1.5-0.5b in bf16 (full width and depth on the card, its
    reduced configuration in the rehearsal): `bf16_decode_steps` gated at
    MESH_LOGIT_TOL with attn layers × steps flash_decode launches, then
    (on the card) its device ms a step by graph replay at the serving
    cache (cur LLM_MAX_SEQ // 4) and at one long request (B 1, S = cur =
    DECODE_LONG's)."""
    model = _decode_model(device, bf16=True, full=full)
    res = bf16_decode_steps(model, device, batch=batch, max_seq=max_seq)
    want = attn_layers(model.cfg) * LLM_BF16_STEPS
    if not res["finite"] or res["rel"] > MESH_LOGIT_TOL \
            or res["launches"] != want:
        raise PhaseError(f"bf16 decode: cuda vs torch {res['rel']:.3e} of "
                         f"max|logit| (tolerance {MESH_LOGIT_TOL:g}), "
                         f"finite {res['finite']}, flash_decode launches "
                         f"{res['launches']} (want {want})")
    if device == "cuda":
        res["serving_ms"] = graph_step_ms(model, batch, max_seq,
                                          max_seq // 4 - 1)
        res["long_ms"] = long_step_ms(model)
    print(f"LLM bf16 decode [{card}] {model.cfg.name} (bf16 weights and "
          f"cache, {model.cfg.num_layers} layers): {LLM_BF16_STEPS} steps "
          f"at B={batch}, S={max_seq}, cuda vs torch max |Δlogit| "
          f"{res['rel']:.3e} of max|logit| {res['scale']:.3f} (tolerance "
          f"{MESH_LOGIT_TOL:g}), flash_decode launches {res['launches']} = "
          f"{attn_layers(model.cfg)} × {LLM_BF16_STEPS}"
          + ("" if device != "cuda" else
             f"; on the device (CUDA graph replay) {res['serving_ms']:.3f} "
             f"ms a step at cur={max_seq // 4}, {res['long_ms']:.3f} ms at "
             f"one long request (B=1, S=cur={DECODE_LONG[-1]})"),
          flush=True)
    del model
    gc.collect()
    if device == "cuda":
        torch.cuda.empty_cache()
    return res



def long_step_ms(model) -> float:
    """One decode step's device time at one long request: B 1 over a
    DECODE_LONG-length cache at its last position (CUDA-graph replay)."""
    s = DECODE_LONG[-1]
    ms = graph_step_ms(model, 1, s, s - 1)
    torch.cuda.empty_cache()
    return ms


def decode_timings_only(src: str | None) -> int:
    """``--decode-timings``: with ``repro_torch`` imported from `src`, the
    kernel's times of `decode_timings` in f32 and bf16 (the bf16 rows
    beside the fastest SDPA call, warm and cold), the f32 kernel at
    deepseek-moe-16b's heads (DECODE_DH128, warm, cur 128 and 512), and
    the decode step by graph replay at the serving cache (cur 128) and at
    one long request, f32 and bf16, as one JSON line after the card's
    line."""
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    if src is not None:
        sys.path.insert(0, os.path.abspath(src))
    import repro_torch

    card = card_line()
    torch.backends.cuda.matmul.allow_tf32 = False
    rows = decode_timings(plain=False, sdpa=(torch.bfloat16,))
    b, h, kh, dh, s = DECODE_DH128
    dh128 = {str(cur): decode_kernel_ms(b, h, kh, dh, s, cur)["ms"]
             for cur in (s // 4, s)}
    steps = {}
    for bf16 in (False, True):
        model = _decode_model(bf16=bf16)
        kind = "bf16" if bf16 else "f32"
        steps[f"{kind} serving cache (B {LLM_BATCH}, S {LLM_MAX_SEQ}, cur "
              f"{LLM_MAX_SEQ // 4})"] = graph_step_ms(
            model, LLM_BATCH, LLM_MAX_SEQ, LLM_MAX_SEQ // 4 - 1)
        steps[f"{kind} long request (B 1, S {DECODE_LONG[-1]}, cur "
              f"{DECODE_LONG[-1]})"] = long_step_ms(model)
        del model
        gc.collect()
        torch.cuda.empty_cache()

    def serving(row):
        return {str(cur): {k: (v["ms"] if k == "sdpa" else v)
                           for k, v in d.items()}
                for cur, d in row["serving"].items()}

    print(card)
    print(json.dumps({
        "package": os.path.dirname(repro_torch.__file__),
        "kernel_ms": {r["name"]: r["ms"] for r in rows},
        "bound_ms": {r["name"]: r["bound_ms"] for r in rows},
        "sdpa_ms": {r["name"]: r["sdpa"]["ms"] for r in rows if "sdpa" in r},
        "serving": serving(rows[0]),
        "serving@bf16": serving(rows[2]),
        "dh128_warm_ms": dh128,
        "step_ms": steps}))
    return 0


def gram_timings_only(src: str | None) -> int:
    """``--gram-timings``: `rff_gram` at PERF.md's rows 3 (f64, the main
    path's two shapes, B 10 and B 40), 3′ (f64, the wide route at
    GRAM_WIDE_TIMING), 3″ (f32, B 1, the `gram_fn` shape) and 3‴ (f32,
    B 1, the kernel bench's CASES), each by CUDA events beside its
    PyTorch yardstick and bound, with ``repro_torch`` imported from `src`,
    as one JSON line after the card's line. Seeded operands of the rows'
    shapes (not the main path's own draws)."""
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    if src is not None:
        sys.path.insert(0, os.path.abspath(src))
    import repro_torch
    from repro_torch.bench import kernel_bench
    from repro_torch.kernels import ops

    card = card_line()
    torch.backends.cuda.matmul.allow_tf32 = False

    def batched(shapes, dtype):
        calls = [gram_operands(*sh, dtype, seed=sum(sh)) for sh in shapes]

        def library():
            for om, bi, x, y, cm in calls:
                z = torch.cos(torch.baddbmm(bi[..., None], om, x)) \
                    * cm[:, None]
                z @ z.transpose(1, 2), (z @ y[..., None])[..., 0]
        flops = sum(b * (2 * f * d * n + f * (f + 1) * n)
                    for b, f, d, n in shapes)
        byts = sum(nbytes(*c) + (c[0].shape[0] * c[0].shape[1] ** 2
                                 + c[0].shape[0] * c[0].shape[1])
                   * c[0].element_size() for c in calls)
        return (lambda: [ops.rff_gram_batched(*c) for c in calls], library,
                bound_ms(byts, flops, dtype)[0])

    def single(f, dim, n):
        om, bi, x, y = kernel_bench.operands(f, dim, n, torch.device("cuda"))
        scale = math.sqrt(2.0 / f)
        return (lambda: ops.rff_gram(om, bi, x, y, scale=scale),
                lambda: kernel_bench.yardstick(om, bi, x, y, scale),
                bound_ms(nbytes(om, bi, x, y) + (f * f + f) * 4,
                         2 * f * dim * n + f * (f + 1) * n,
                         torch.float32)[0])

    cases = [("3", "f64", [(J_NODES, D_PER_NODE, 148, 3180),
                           (4 * J_NODES, D_PER_NODE, 148, 3180)]),
             ("3′", "f64", [GRAM_WIDE_TIMING]),
             ("3″", "f32", [(1, D_PER_NODE, 148, 3180)])] + [
        ("3‴", "f32", [(1,) + tuple(c)]) for c in kernel_bench.CASES]
    rows = []
    for row, kind, shapes in cases:
        if kind == "f64":
            kernel, library, bms = batched(shapes, torch.float64)
        else:
            kernel, library, bms = single(*shapes[0][1:])
        rows.append(dict(row=row, dtype=kind, shapes=shapes,
                         ms=cuda_ms(kernel), library_ms=cuda_ms(library),
                         bound_ms=bms))
    print(card)
    print(json.dumps({"package": os.path.dirname(repro_torch.__file__),
                      "rows": rows}))
    return 0


def features_timings_only(src: str | None, repeats: int = 5) -> int:
    """``--features-timings``: the featurize kernel at PERF.md's rows 7
    (f64 and bf16, one node and the wave: J 10, D 200, d 148, N 512 on
    seeded maps and columns, not the main path's own draws), each the
    median of ``repeats`` `feature_rows` readings beside its yardstick and
    bound, with ``repro_torch`` imported from `src`; then the bf16 kernels'
    registers and spills (``-Xptxas -v``) and their main loop's
    instruction mix (`sass_loop_mix`), as one JSON line after the card's
    line."""
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    if src is not None:
        sys.path.insert(0, os.path.abspath(src))
    import repro_torch
    from repro_torch.kernels import _build

    card = card_line()
    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator(device="cuda").manual_seed(0)
    kw = dict(dtype=torch.float64, device="cuda", generator=gen)
    omega = torch.randn((J_NODES, D_PER_NODE, 148), **kw) / SIGMA
    bias = torch.rand((J_NODES, D_PER_NODE), **kw) * (2 * math.pi)
    x = torch.randn((148, SERVE_N), **kw)
    readings = [feature_rows(omega, bias, x, [D_PER_NODE] * J_NODES)
                for _ in range(repeats)]
    rows = []
    for got in zip(*readings):
        row = {k: got[0][k] for k in ("name", "shape", "bound_ms",
                                      "bound_by")}
        for k in ("ms", "plain_ms", "library_ms", "per_node_ms"):
            if k in got[0]:
                row[k] = statistics.median(r[k] for r in got)
        row["ms_readings"] = [r["ms"] for r in got]
        rows.append(row)
    library = str(_build.ensure_built(("rff_features",))["rff_features"])
    print(card)
    print(json.dumps({
        "package": os.path.dirname(repro_torch.__file__), "rows": rows,
        "ptxas": [line for line in ptxas_summary(
            _build.ptxas_reports.get("rff_features", "")) if "bf16" in line],
        "sass": sass_loop_mix(library, "bf16")}))
    return 0


# ------------------------------------------------------ the chains' timings
def paper_chain_operands(seed: int = 0):
    """Seeded f64 operands of one packed round at the paper shape: J 10
    nodes of circulant(10, (1, 2)) (K 4, every slot live, self_idx the
    identity), D 200, Dy 1; contracting blocks."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    kw = dict(dtype=torch.float64, device="cuda", generator=gen)
    j, k, dd = J_NODES, 4, D_PER_NODE
    scale = 0.5 / dd
    g = torch.randn((j, dd, dd), **kw) * scale
    s = torch.randn((j, dd, dd), **kw) * scale
    p = torch.randn((j, k, dd, dd), **kw) * scale
    d = torch.randn((j, dd), **kw)
    theta = torch.randn((j, dd), **kw)
    offsets = torch.tensor([1, -1, 2, -2], device="cuda")
    nbr_idx = ((torch.arange(j, device="cuda")[:, None] + offsets) % j).to(
        torch.int32)
    self_idx = torch.arange(j, dtype=torch.int32, device="cuda")
    nbr_mask = torch.ones((j, k), dtype=torch.float64, device="cuda")
    return g, d, s, p, theta, nbr_idx, self_idx, nbr_mask


def phase_split(stamps: torch.Tensor, steps: int, names) -> dict:
    """Mean µs a step of each phase of a clocked chain launch (the
    `*_clocked` entry points: stamps [blocks, 1 + steps·phases], 0 where a
    phase did not run), over every block and step: a phase's time is its
    stamp less the block's previous one. Also the launch's µs from the
    first block's start to the last stamp."""
    t = stamps.cpu().numpy().astype(np.int64)
    n = len(names)
    sums = np.zeros(n)
    phase = np.tile(np.arange(n), steps)
    for row in t:
        flat = row[1:]
        nz = flat != 0
        seq = np.concatenate([row[:1], flat[nz]])
        np.add.at(sums, phase[nz], np.diff(seq))
    per_step = sums / (t.shape[0] * steps) / 1e3
    return dict(us_per_step=dict(zip(names, per_step.tolist())),
                step_us=float(per_step.sum()),
                launch_us=float((t[:, 1:].max() - t[:, 0].min()) / 1e3))


def handoff_us(iters: int = 10_000) -> float:
    """µs of one release/acquire hand-off between two SMs through L2 (the
    `dekrr_handoff_probe` export, 2·iters hand-offs)."""
    from repro_torch.kernels import _build
    lib = _build.library("dekrr_solve")
    flags = torch.zeros((2,), dtype=torch.int32, device="cuda")
    out = torch.zeros((1,), dtype=torch.int64, device="cuda")
    _build.check(lib.dekrr_handoff_probe(
        flags.data_ptr(), iters, out.data_ptr(),
        torch.cuda.current_stream().cuda_stream), "dekrr_handoff_probe")
    torch.cuda.synchronize()
    return out.item() / (2 * iters) / 1e3


def chain_launches(seed: int = 0) -> dict:
    """The round kernel (rows 1, 4), `dekrr_solve` at CHUNK rounds with its
    trace (row 2), the async chain over ASYNC_ROUNDS rounds at p 0.5,
    censored on the censor schedule of ASYNC_CONFIG (row 5) and the
    Chebyshev chain over 96 rounds (row 6) on `paper_chain_operands`,
    each as a closure of the imported package's raw launcher, with the
    package's route plans made beforehand where it has them (so no launch
    waits for the host). Returns {name: (launch, rounds)} and the plans
    under "plans" (with the launchers that take a plan and stamps)."""
    from repro_torch.core import censor_schedule
    from repro_torch.kernels import ops
    ds = importlib.import_module("repro_torch.kernels.dekrr_solve")
    from repro_torch.kernels.dekrr_step import dekrr_step_cuda

    args = paper_chain_operands(seed)
    g, d, s, p, theta, nbr_idx, self_idx, nbr_mask = args
    j, dd = d.shape
    f64 = torch.float64
    kw = dict(dtype=f64, device="cuda")
    lay = _raw_layout(args)
    gen = torch.Generator(device="cuda").manual_seed(seed + 1)
    masks = (torch.rand((ASYNC_ROUNDS, j), generator=gen, **kw)
             < ASYNC_CONFIG["prob"]).to(torch.int32)
    thr = censor_schedule(ASYNC_CONFIG["censor_tau"],
                          ASYNC_CONFIG["censor_decay"], ASYNC_ROUNDS,
                          dtype=f64, device=torch.device("cuda"))
    zero = torch.zeros_like(d)
    raw = _async_raw((g, d, s, p, zero, zero, zero[nbr_idx.long()], nbr_idx,
                      nbr_mask, masks, thr))
    cheb_rounds = 96
    al = 0.5 + torch.rand((cheb_rounds,), generator=gen, **kw)
    be = 0.3 * torch.rand((cheb_rounds,), generator=gen, **kw)
    craw = lay[:5] + (ops._flatten_dy(zero),) + lay[5:] + (al, be)
    out = torch.empty_like(lay[1])
    res = torch.empty((CHUNK, j), **kw)
    work = torch.empty((2,) + tuple(lay[4].shape), **kw)
    outs = (torch.empty((j, dd), **kw), torch.empty((j, dd), **kw),
            torch.empty((j * 4, dd), **kw),
            torch.empty((ASYNC_ROUNDS + 1, j), **kw),
            torch.empty((ASYNC_ROUNDS + 1, j), dtype=torch.int32,
                        device="cuda"))
    a_work = torch.empty((2, j, dd), **kw)
    flags = torch.empty((2 * j,), dtype=torch.int32, device="cuda")
    couts = (torch.empty((j, dd), **kw), torch.empty((j, dd), **kw),
             torch.empty((cheb_rounds, j), **kw))
    c_work = torch.empty((2, j, dd), **kw)
    plans = {}
    if hasattr(ds, "solve_plan"):
        plans["dekrr_solve"] = ds.solve_plan(lay[5], lay[6], lay[7],
                                             d_feat=dd, dy=1, dtype=f64,
                                             rounds=CHUNK)
        plans["dekrr_async_solve"] = ds.async_plan(
            raw[7], raw[8], d_feat=dd, dy=1, dtype=f64, rounds=ASYNC_ROUNDS)
    if hasattr(ds, "cheb_plan"):
        plans["dekrr_cheb_solve"] = ds.cheb_plan(
            lay[5], lay[6], lay[7], d_feat=dd, dy=1, dtype=f64,
            rounds=cheb_rounds)

    def solve(plan=None, stamps=None):
        extra = {} if plan is None else dict(plan=plan, stamps=stamps)
        ds.dekrr_solve_cuda(*lay, out, res, work, num_rounds=CHUNK, dy=1,
                            **extra)

    def async_chain(plan=None, stamps=None):
        extra = {} if plan is None else dict(plan=plan, stamps=stamps)
        ds.dekrr_async_solve_cuda(*raw, *outs, a_work, flags, censored=True,
                                  edge_gossip=False, dy=1, **extra)

    def cheb(plan=None, stamps=None):
        extra = {} if plan is None else dict(plan=plan, stamps=stamps)
        ds.dekrr_cheb_solve_cuda(*craw, *couts, c_work, dy=1, **extra)

    return {
        "dekrr_step": (lambda: dekrr_step_cuda(*lay, out, dy=1), 1),
        "dekrr_step_masked": (lambda: dekrr_step_cuda(
            *lay, out, dy=1, active=masks[0]), 1),
        "dekrr_solve": (lambda: solve(plans.get("dekrr_solve")), CHUNK),
        "dekrr_async_solve": (lambda: async_chain(
            plans.get("dekrr_async_solve")), ASYNC_ROUNDS),
        "dekrr_cheb_solve": (lambda: cheb(plans.get("dekrr_cheb_solve")),
                             cheb_rounds),
        "plans": plans, "clocked": {"dekrr_solve": solve,
                                    "dekrr_async_solve": async_chain,
                                    "dekrr_cheb_solve": cheb}}


def chain_phase_splits(launches: dict) -> dict:
    """Each chain of `chain_launches` on each route, once with its phase
    clock on: `phase_split` of the stamps, with the route's plan."""
    ds = importlib.import_module("repro_torch.kernels.dekrr_solve")

    out = {}
    for name, plan in launches["plans"].items():
        rounds = launches[name][1]
        steps = rounds + (name == "dekrr_async_solve")
        routes = {plan.route: plan}
        streamed = ds.streamed_plan(name, J_NODES, 4, D_PER_NODE, 1,
                                    torch.float64)
        routes.setdefault("streamed", streamed)
        for route, pl in routes.items():
            names = ds.CHAIN_PHASES[name, route]
            stamps = torch.zeros((pl.blocks * pl.clusters,
                                  1 + steps * len(names)),
                                 dtype=torch.int64, device="cuda")
            launches["clocked"][name](pl, stamps)
            torch.cuda.synchronize()
            out[f"{name}@{route}"] = dict(
                plan=dict(blocks=pl.blocks, rows=pl.rows,
                          clusters=pl.clusters, threads=pl.threads,
                          smem_bytes=pl.smem_bytes),
                **phase_split(stamps, steps, names))
    return out


def chain_timings_only(src: str | None, repeats: int = 5) -> int:
    """``--chain-timings``: PERF.md's rows 1, 2, 4, 5 and 6 at the paper
    shape (`chain_launches`), in turns, each the median of ``repeats``
    `cuda_ms` readings, with ``repro_torch`` imported from `src`; then,
    where the package has them, each chain's phase split on both routes
    (`chain_phase_splits`), the L2 hand-off (`handoff_us`), the chains'
    routes, and the chain kernels' registers and spills (``-Xptxas -v``),
    as one JSON line after the card's line."""
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    if src is not None:
        sys.path.insert(0, os.path.abspath(src))
    import repro_torch
    from repro_torch.kernels import _build

    card = card_line()
    torch.backends.cuda.matmul.allow_tf32 = False
    launches = chain_launches()
    reps = dict(dekrr_step=20, dekrr_step_masked=20, dekrr_solve=20,
                dekrr_async_solve=3, dekrr_cheb_solve=5)
    readings = {name: [] for name in reps}
    for _ in range(repeats):
        for name in reps:
            readings[name].append(cuda_ms(launches[name][0], reps=reps[name],
                                          warmup=1))
    rows = {name: dict(ms=statistics.median(r), readings=r,
                       rounds=launches[name][1],
                       round_ms=statistics.median(r) / launches[name][1])
            for name, r in readings.items()}
    result = {"package": os.path.dirname(repro_torch.__file__), "rows": rows,
              "routes": {k: v.route for k, v in launches["plans"].items()}}
    if launches["plans"]:
        result["phases"] = chain_phase_splits(launches)
        result["handoff_us"] = handoff_us()
    result["ptxas"] = [line for src_ in ("dekrr_solve", "dekrr_async_solve",
                                         "dekrr_cheb_solve", "dekrr_step")
                       for line in ptxas_summary(
                           _build.ptxas_reports.get(src_, ""))]
    print(card)
    print(json.dumps(result))
    return 0


# ------------------------------------------------------- the other mixers
def mixer_config(name: str, *, full: bool):
    """The configuration of a MIXER_MODELS entry: on the card rwkv6-7b at
    full width and depth, qwen1.5-0.5b's sliding-window variant at full
    width and MIXER_SWA_LAYERS layers, deepseek-moe-16b at full width and
    MIXER_DEEPSEEK_LAYERS layers, jamba
    at its registry reduced() size; ``full=False`` (the rehearsal): every
    one reduced, the window at MIXER_REHEARSAL_WINDOW."""
    from repro_torch.configs import get_arch
    from repro_torch.models.model import SlotSpec

    base, _, variant = name.partition("-")
    spec = get_arch(base)
    cfg = spec.config
    if not full or base == "jamba_1_5_large_398b":
        cfg = cfg.reduced()
    elif base == "deepseek_moe_16b":
        cfg = dataclasses.replace(cfg, num_layers=MIXER_DEEPSEEK_LAYERS)
    if variant == "swa":
        cfg = dataclasses.replace(
            cfg, slots=tuple(SlotSpec("swa" if s.mixer == "attn" else s.mixer,
                                      s.ffn) for s in cfg.slots),
            sliding_window=(spec.long_context_window if full
                            else MIXER_REHEARSAL_WINDOW))
        if full:
            cfg = dataclasses.replace(cfg, num_layers=MIXER_SWA_LAYERS)
    return cfg


def _attn_variant(cfg):
    """The model a sliding-window variant came from: every swa slot attn
    again (the same parameters)."""
    from repro_torch.models.model import Model, SlotSpec

    attn_cfg = dataclasses.replace(
        cfg, slots=tuple(SlotSpec("attn" if s.mixer == "swa" else s.mixer,
                                  s.ffn) for s in cfg.slots),
        sliding_window=None)
    return lambda params: Model(attn_cfg, params)


def decode_matches_forward(model, cfg, device: str, forward) -> float:
    """Teacher-forcing parity of `tests/test_arch_smoke.py`: decode_step
    (backend cuda) at each position of a seeded [B, S] batch against the
    model's own forward, MoE capacity factor MIXER_CAPACITY so no token
    drops, |Δ| ≤ atol + rtol·|forward|. Returns max |Δ|."""
    from repro_torch.models.model import Model

    rtol, atol = MIXER_FORWARD_TOL
    m = Model(dataclasses.replace(cfg, moe_capacity_factor=MIXER_CAPACITY),
              model.params)
    b, s = forward
    toks = torch.from_numpy(np.random.default_rng(11).integers(
        0, cfg.vocab_size, (b, s))).to(device)
    worst = 0.0
    with torch.inference_mode():
        full, aux = m.forward(toks)
        if not all(torch.isfinite(v) for v in aux.values()):
            raise PhaseError(f"{cfg.name}: forward's aux losses are not "
                             f"finite: {aux}")
        cache = m.init_cache(b, s)
        for t in range(s):
            lg, cache = m.decode_step(cache, toks[:, t:t + 1], t)
            err = (lg - full[:, t]).abs()
            if not (torch.isfinite(lg).all()
                    and (err <= atol + rtol * full[:, t].abs()).all()):
                raise PhaseError(f"{cfg.name}: decode diverges from its own "
                                 f"forward at t={t} (max |Δ| "
                                 f"{err.max().item():.3e}, rtol {rtol:g}, "
                                 f"atol {atol:g})")
            worst = max(worst, err.max().item())
    return worst


def mixer_path(device: str, cfg, *, requests: int, batch: int,
               max_seq: int, prompt, new_tokens: int, forward,
               params=None) -> dict:
    """One model of the mixers phase (or the train phase's trained
    `params`): `llm_path` (for a sliding-window
    variant with its attn model as the teacher-forced variant), its
    checks, decode == forward, and on the card one decode step captured
    into a CUDA graph (a host sync on the path makes the capture raise)
    and replayed for its device time, and the peak memory."""
    from repro_torch.models.model import param_count

    on_card = device == "cuda"
    if on_card:
        torch.cuda.reset_peak_memory_stats()
    variants = {"attn": _attn_variant(cfg)} \
        if any(s.mixer == "swa" for s in cfg.slots) else {}
    t0 = time.perf_counter()
    out = llm_path(device, cfg, requests=requests, batch=batch,
                   max_seq=max_seq, prompt=prompt, new_tokens=new_tokens,
                   variants=variants, params=params)
    check_llm_path(out, cfg, on_card)
    model = out.pop("engine").model
    out["forward_err"] = decode_matches_forward(model, cfg, device, forward)
    out["device_ms"] = None
    if on_card:
        pos = max_seq // 4 - 1
        try:
            out["device_ms"] = graph_step_ms(model, batch, max_seq, pos)
        except RuntimeError as exc:
            raise PhaseError(f"{cfg.name}: one decode step did not capture "
                             f"into a CUDA graph (a host sync on the "
                             f"path?): {exc}") from exc
        out["peak_gib"] = torch.cuda.max_memory_allocated() / 2 ** 30
    out["params"] = param_count(model.params)
    out["phase_secs"] = time.perf_counter() - t0
    return out


def mixers_phase(device: str, card: str, *, full: bool, requests: int,
                 batch: int, max_seq: int, prompt=LLM_PROMPT,
                 new_tokens=LLM_NEW_TOKENS, forward=MIXER_FORWARD) -> dict:
    """MIXER_MODELS in turn through `mixer_path`, each freed before the
    next is drawn; one line of metrics and one of checks per model."""
    results = {}
    for name in MIXER_MODELS:
        cfg = mixer_config(name, full=full)
        r = mixer_path(device, cfg, requests=requests, batch=batch,
                       max_seq=max_seq, prompt=prompt,
                       new_tokens=new_tokens, forward=forward)
        rep, step_ms = r["report"], r["secs"] / r["steps"] * 1e3
        dev = "not measured (CPU)" if r["device_ms"] is None else (
            f"{r['device_ms']:.3f} ms a step on the device by CUDA-graph "
            f"replay at cur={max_seq // 4} (busy share "
            f"{r['device_ms'] / step_ms:.3f}), peak memory "
            f"{r['peak_gib']:.2f} GiB")
        print(f"mixers [{card}] {name} = {cfg.name} ({cfg.num_layers} "
              f"layers, d {cfg.d_model}, {r['params'] / 1e9:.3f} B params "
              f"f32, slots {[(s.mixer, s.ffn) for s in cfg.slots]}): "
              f"{rep.count} requests in {r['secs']:.2f} s (repeat run; "
              f"cold {r['cold_secs']:.2f} s), {r['steps']} decode steps of "
              f"{batch} slots, {step_ms:.2f} ms a step eager, "
              f"{r['tokens'] / r['secs']:.1f} generated tokens/s, "
              f"per-request p50 {rep.p50 * 1e3:.1f} ms, p99 "
              f"{rep.p99 * 1e3:.1f} ms; {dev}; launches "
              f"{json.dumps({k: v for k, v in r['launches'].items() if v})};"
              f" phase {r['phase_secs']:.1f} s", flush=True)
        print(f"mixers checks {name}: pass (repeat run equal, one request "
              f"== sequential decode_step, {r['replay_steps']} "
              f"teacher-forced steps equal to the engine's tokens, " +
              ", ".join(f"{k} vs cuda {v:.3e}" for k, v in r["rel"].items())
              + f" of max|logit| {r['scale']:.3f} (tolerance "
              f"{LLM_LOGIT_TOL:g}); decode vs own forward max |Δ| "
              f"{r['forward_err']:.3e} (rtol {MIXER_FORWARD_TOL[0]:g}, atol "
              f"{MIXER_FORWARD_TOL[1]:g}, capacity factor "
              f"{MIXER_CAPACITY:g}); flash_decode launches "
              f"{r['launches'].get('flash_decode', 0)}, on the card "
              f"{attn_layers(cfg)} attn layers × {r['steps']} steps)",
              flush=True)
        results[name] = r
        gc.collect()
        if device == "cuda":
            torch.cuda.empty_cache()
    return results


def decode_dh128_row(launches: int) -> dict:
    """flash_decode at deepseek-moe-16b's heads (DECODE_DH128: H = K = 16,
    dh 128) at the serving cache, warm at cur a quarter of S and all of
    it: each against its split plain version (DECODE_TOL), timed beside
    it and the fastest SDPA call. The row is cur = S / 4, the decode
    step's timed position."""
    from repro_torch.kernels.decode_attention import (
        flash_decode_split_reference)

    b, h, kh, dh, s = DECODE_DH128
    per_cur, worst = {}, 0.0
    for cur in (s // 4, s):
        t = decode_kernel_ms(b, h, kh, dh, s, cur)
        q, k, v = t["operands"]
        want = flash_decode_split_reference(q, k, v, t["lens"])
        err = (t["out"] - want).abs()
        if not (torch.isfinite(t["out"]).all()
                and (err <= DECODE_TOL * (1 + want.abs())).all()):
            raise PhaseError(f"flash_decode at dh {dh}, cur {cur}: disagrees "
                             f"with its split plain version (max abs err "
                             f"{err.max().item():.3e})")
        worst = max(worst, err.max().item())
        per_cur[cur] = dict(
            ms=t["ms"], bound_ms=t["bound_ms"], bound_by=t["bound_by"],
            plain_ms=cuda_ms(lambda: flash_decode_split_reference(
                q, k, v, t["lens"]), reps=5, warmup=1),
            sdpa=sdpa_yardsticks(q, k, v, t["out"], cur))
        del t, q, k, v
    row = per_cur[s // 4]
    return dict(name="flash_decode@dh128", route="cuda",
                source="src/repro_torch/kernels/csrc/flash_decode.cu",
                replaces="src/repro/kernels/decode_attention.py:89",
                shape=[b, h, kh, dh, s, s // 4], ms=row["ms"],
                plain_ms=row["plain_ms"], library_ms=row["sdpa"]["ms"],
                bound_ms=row["bound_ms"], bound_by=row["bound_by"],
                launches=launches, max_abs_err=worst, per_cur=per_cur)


# ------------------------------------------------------------- training
def matmul_params(cfg) -> int:
    """Parameters a token multiplies through: every weight matrix but
    the embedding table (the head included; a tied head once), MoE
    experts at k of E. 6 × this × tokens is a step's FLOPs."""
    from repro_torch.models.model import param_shapes

    total = 0
    for key, shape in param_shapes(cfg).items():
        if key == "embed":
            total += math.prod(shape) if cfg.tie_embeddings else 0
        elif isinstance(shape, dict):
            for name, sh in shape.items():
                if len(sh) < 3:                 # [groups, n]: a vector
                    continue
                share = (cfg.moe_experts_per_token / cfg.moe_num_experts
                         if name.startswith("moe_") else 1.0)
                total += int(math.prod(sh) * share)
        elif len(shape) == 2:
            total += math.prod(shape)
    return total


@contextlib.contextmanager
def deterministic(on: bool = True):
    """torch.use_deterministic_algorithms(on) inside, the mode before
    restored after."""
    before = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(on)
    try:
        yield
    finally:
        torch.use_deterministic_algorithms(before)


def _tensors(tree):
    """(path, tensor) pairs of a nested dict, keys sorted."""
    for key in sorted(tree):
        if isinstance(tree[key], dict):
            for path, t in _tensors(tree[key]):
                yield f"{key}.{path}", t
        else:
            yield key, tree[key]


def train_run(device: str, cfg, *, steps: int, ckpt_path: str | None = None
              ) -> dict:
    """`steps` steps of `train_loop` (log_every 1: each step's metrics
    read back after it, so the history's wall_s are host times after a
    sync) from seeded f32 weights drawn on `device`, over batches of
    SyntheticTokenPipeline(seed 0) made in bulk beforehand, plus one
    batch more; with `ckpt_path` the loop saves {"params", "opt"} at its
    last step. Returns the state, the history and one step's figures:
    the median ms a step after TRAIN_UNTIMED warm-up steps, tokens/s,
    the peak device memory and the MFU."""
    from repro_torch.data.tokens import (SyntheticTokenPipeline,
                                         TokenPipelineConfig)
    from repro_torch.models.model import param_count
    from repro_torch.train.loop import train_loop
    from repro_torch.train.optim import AdamWConfig
    from repro_torch.train.step import train_state_init

    opt = AdamWConfig(lr=TRAIN_LR, warmup_steps=TRAIN_WARMUP,
                      total_steps=steps)
    b, s = (TRAIN_BATCH, TRAIN_SEQ)
    batches = list(SyntheticTokenPipeline(TokenPipelineConfig(
        vocab_size=cfg.vocab_size, batch_size=b, seq_len=s,
        seed=0)).batches(steps + 1))
    state = train_state_init(cfg, opt, torch.Generator(device).manual_seed(0),
                             device=device)
    # on the host: the peak device memory is the training's alone
    initial = {path: t.to("cpu", copy=True)
               for path, t in _tensors(state.params)}
    on_card = device == "cuda"
    if on_card:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    lines: list[str] = []
    t0 = time.perf_counter()
    state, history = train_loop(cfg, opt, iter(batches[:steps]), steps,
                                log_every=1, log_fn=lines.append,
                                state=state, ckpt_path=ckpt_path,
                                ckpt_every=steps)
    loop_s = time.perf_counter() - t0
    walls = [h["wall_s"] for h in history]
    per_step = [walls[0]] + [b_ - a for a, b_ in zip(walls, walls[1:])]
    step_s = statistics.median(per_step[TRAIN_UNTIMED:])
    unchanged = [path for path, t in _tensors(state.params)
                 if torch.equal(t.cpu(), initial[path])]
    del initial
    return dict(
        cfg=cfg, opt=opt, state=state, history=history, lines=lines,
        extra=batches[steps], per_step=per_step, ms=step_s * 1e3,
        tokens_s=b * s / step_s, params=param_count(state.params),
        matmul=matmul_params(cfg),
        mfu=6 * matmul_params(cfg) * b * s / step_s / TRAIN_PEAK_FLOPS,
        peak_gib=(torch.cuda.max_memory_allocated() / 2 ** 30 if on_card
                  else None),
        save_s=loop_s - walls[-1] if ckpt_path else None,
        unchanged=unchanged)


def check_train_run(r: dict, *, moe: bool) -> None:
    """Every loss finite, grad_norm > 0, every parameter leaf moved; a
    dense run's loss falls (the mean of the last TRAIN_LAST below the
    first, examples/train_lm.py's check); an MoE run's aux losses are
    present, finite and > 0 at every step."""
    name, hist = r["cfg"].name, r["history"]
    losses = [h["loss"] for h in hist]
    if not all(math.isfinite(v) for v in losses):
        raise PhaseError(f"train {name}: a loss is not finite: {losses}")
    if not all(h["grad_norm"] > 0 for h in hist):
        raise PhaseError(f"train {name}: grad_norm 0 at a step")
    if r["unchanged"]:
        raise PhaseError(f"train {name}: parameters did not change: "
                         f"{r['unchanged']}")
    if moe:
        for key in ("load_balance_loss", "router_z_loss"):
            vals = [h.get(key, float("nan")) for h in hist]
            if not all(math.isfinite(v) and v > 0 for v in vals):
                raise PhaseError(f"train {name}: {key} not finite and > 0 "
                                 f"at every step: {vals}")
    elif not statistics.fmean(losses[-TRAIN_LAST:]) < losses[0]:
        raise PhaseError(f"train {name}: the loss did not fall: the first "
                         f"{losses[0]:.4f}, the mean of the last "
                         f"{TRAIN_LAST} {statistics.fmean(losses[-TRAIN_LAST:]):.4f}")


def _one_more_step(r: dict, state, device: str) -> torch.Tensor:
    """One train step of `state` on the run's extra batch; its loss."""
    from repro_torch.train.step import make_train_step

    batch = {k: torch.as_tensor(v, device=device)
             for k, v in r["extra"].items()}
    _, m = make_train_step(r["cfg"], r["opt"])(state, batch)
    return m["loss"]


def checkpoint_round_trip(r: dict, device: str) -> dict:
    """(b) The loop's checkpoint of the last step loaded back on
    `device`: every tensor bit-equal to the live state's; then one more
    step from the live and from the loaded state with deterministic
    algorithms on: the same loss, parameters and moments, bit for bit.
    From those two equal states one step more each with deterministic
    algorithms off: the differences of loss and parameters
    (informational). The live state has then taken two steps more."""
    from repro_torch.train.checkpoint import load_checkpoint
    from repro_torch.train.step import TrainState

    live = r["state"]
    t0 = time.perf_counter()
    tree, step = load_checkpoint(TRAIN_CKPT, device=device)
    load_s = time.perf_counter() - t0
    if step != len(r["history"]):
        raise PhaseError(f"checkpoint step {step}, expected "
                         f"{len(r['history'])}")
    want = dict(_tensors({"params": live.params, "opt": live.opt}))
    got = dict(_tensors(tree))
    if set(got) != set(want):
        raise PhaseError(f"checkpoint names differ: "
                         f"{sorted(set(got) ^ set(want))}")
    bad = [p for p in want if not (got[p].dtype == want[p].dtype
                                   and torch.equal(got[p], want[p]))]
    if bad:
        raise PhaseError(f"checkpoint round trip changed {bad}")
    names = len(want)
    size = sum(t.numel() * t.element_size() for t in want.values())
    loaded = TrainState(params=tree["params"], opt=tree["opt"],
                        step=live.step.clone())
    del tree, got, want
    out = repeat_steps(r, live, loaded, device, "the live and the loaded "
                       "state")
    del loaded
    os.remove(TRAIN_CKPT)
    return dict(out, load_s=load_s, names=names, bytes=size)


def repeat_steps(r: dict, a, b, device: str, what: str) -> dict:
    """One step each of two equal train states `a` and `b` on the run's
    extra batch with deterministic algorithms on: the same loss,
    parameters and moments, bit for bit, or PhaseError. Then one step
    more each with them off: the differences of loss and parameters
    (informational: which ops accumulate in an order the run picks)."""
    with deterministic():
        loss_a = _one_more_step(r, a, device)
        loss_b = _one_more_step(r, b, device)
    both = lambda st: {"params": st.params, "opt": st.opt}
    moved = [p for p, t in _tensors(both(a))
             if not torch.equal(t, leaf_of(both(b), p))]
    if not torch.equal(loss_a, loss_b) or moved:
        raise PhaseError(f"{r['cfg'].name}: one more step from {what} "
                         f"differs (deterministic algorithms): loss "
                         f"{loss_a.item()!r} vs {loss_b.item()!r}, tensors "
                         f"{moved}")
    with deterministic(False):
        la = _one_more_step(r, a, device)
        lb = _one_more_step(r, b, device)
    return dict(loss=loss_a.item(), nondet=(
        abs(la.item() - lb.item()),
        max((t - leaf_of(b.params, p)).abs().max().item()
            for p, t in _tensors(a.params))))


def train_profile(r: dict, device: str, steps: int = 2) -> dict | None:
    """Where a train step's time goes, by torch.profiler over `steps`
    steps of the run's state on its extra batch (deterministic
    algorithms on, as in the run; device kernels only, since the
    profiler's host side slows the steps it measures): device ms and
    kernels a step, the busy share (device ms over the run's median
    step) and the kernels of the most device time; then the host-clock
    ms of `steps` steps with deterministic algorithms off. None where
    the profiler records nothing."""
    from repro_torch.train.step import make_train_step

    step = make_train_step(r["cfg"], r["opt"])
    batch = {k: torch.as_tensor(v, device=device)
             for k, v in r["extra"].items()}
    try:
        from torch.profiler import ProfilerActivity, profile
        with deterministic():
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                for _ in range(steps):
                    step(r["state"], batch)
                torch.cuda.synchronize()
        events = prof.key_averages()
    except Exception as exc:                      # the profiler is optional
        print(f"profiler: not recorded ({type(exc).__name__})")
        return None
    dev = lambda e: getattr(e, "self_device_time_total",
                            getattr(e, "self_cuda_time_total", 0))
    kernels = [e for e in events
               if str(getattr(e, "device_type", "")).endswith("CUDA")
               and dev(e) > 0]
    device_ms = sum(dev(e) for e in kernels) / 1e3 / steps
    top = sorted(kernels, key=lambda e: -dev(e))[:8]
    off = []
    with deterministic(False):
        for _ in range(steps):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            step(r["state"], batch)
            torch.cuda.synchronize()
            off.append((time.perf_counter() - t0) * 1e3)
    return dict(device_ms=device_ms, busy=device_ms / r["ms"],
                kernels=sum(e.count for e in kernels) / steps,
                top=[(e.key, dev(e) / 1e3 / steps, e.count // steps)
                     for e in top], off_ms=off)


def print_train_profile(p: dict | None, name: str, card: str) -> None:
    if p is None:
        return
    print(f"train profile [{card}] {name}: {p['device_ms']:.2f} ms a step on "
          f"the device in {p['kernels']:.0f} kernels (busy share "
          f"{p['busy']:.3f} of the run's median step); deterministic "
          f"algorithms off: " + ", ".join(f"{ms:.2f}" for ms in p["off_ms"])
          + " ms a step; the kernels of most device time (ms a step, "
          "launches): " + "; ".join(f"{k[:60]} {ms:.2f} ({n})"
                                    for k, ms, n in p["top"]), flush=True)


def _clone_state(state):
    from repro_torch.train.optim import tree_map
    from repro_torch.train.step import TrainState

    return TrainState(params=tree_map(torch.clone, state.params),
                      opt=tree_map(torch.clone, state.opt),
                      step=state.step.clone())


def leaf_of(tree, path: str):
    for key in path.split("."):
        tree = tree[key]
    return tree


def train_card_vs_cpu(devices: tuple) -> dict:
    """(e) qwen1.5-0.5b at its reduced() size, the same seeded weights
    and batch on each of `devices`: the loss and every gradient leaf
    (`loss_and_grads`), then grad_norm of one train step; on two devices
    the first against the second (the CPU) within the CPU tests'
    tolerances."""
    from repro_torch.configs import get_arch
    from repro_torch.data.tokens import (SyntheticTokenPipeline,
                                         TokenPipelineConfig)
    from repro_torch.models.model import Model, init_params
    from repro_torch.train.optim import AdamWConfig, adamw_init, tree_map
    from repro_torch.train.step import (TrainState, loss_and_grads,
                                        make_train_step)

    cfg = get_arch(TRAIN_ARCH).config.reduced()
    opt = AdamWConfig(lr=TRAIN_LR, warmup_steps=TRAIN_WARMUP,
                      total_steps=TRAIN_STEPS)
    weights = init_params(cfg, torch.Generator("cpu").manual_seed(0))
    batch = next(iter(SyntheticTokenPipeline(TokenPipelineConfig(
        vocab_size=cfg.vocab_size, batch_size=TRAIN_BATCH,
        seq_len=TRAIN_SEQ, seed=0))))
    runs = {}
    for dev in devices:
        params = tree_map(lambda t: t.to(dev, copy=True), weights)
        b = {k: torch.as_tensor(v, device=dev) for k, v in batch.items()}
        loss, _, grads = loss_and_grads(Model(cfg, params), params, b)
        state = TrainState(params, adamw_init(opt, params),
                           torch.zeros((), dtype=torch.int32, device=dev))
        _, m = make_train_step(cfg, opt)(state, b)
        runs[dev] = dict(loss=loss.cpu(), grad_norm=m["grad_norm"].cpu(),
                         grads={p: g.cpu() for p, g in _tensors(grads)})
    out = dict(loss=runs[devices[-1]]["loss"].item(), grad_err=None)
    if len(devices) == 2:
        got, want = runs[devices[0]], runs[devices[1]]
        for key, rtol in (("loss", TRAIN_LOSS_RTOL),
                          ("grad_norm", TRAIN_NORM_RTOL)):
            if not abs(got[key] - want[key]).item() <= rtol * abs(
                    want[key]).item():
                raise PhaseError(f"train step card vs CPU: {key} "
                                 f"{got[key].item()!r} vs "
                                 f"{want[key].item()!r} (rtol {rtol:g})")
        worst = 0.0
        for p, w in want["grads"].items():
            scale = w.abs().max().item()
            err = (got["grads"][p] - w).abs().max().item()
            if not err <= TRAIN_GRAD_TOL * scale:
                raise PhaseError(f"train step card vs CPU: gradient {p} "
                                 f"differs by {err:.3e}, max|g| {scale:.3e} "
                                 f"(tolerance {TRAIN_GRAD_TOL:g} of it)")
            worst = max(worst, err / scale if scale else err)
        out.update(grad_err=worst,
                   loss_rel=abs(got["loss"] - want["loss"]).item()
                   / abs(want["loss"]).item(),
                   norm_rel=abs(got["grad_norm"] - want["grad_norm"]).item()
                   / abs(want["grad_norm"]).item())
    return out


def print_train_run(r: dict, card: str) -> None:
    cfg, hist = r["cfg"], r["history"]
    losses = [h["loss"] for h in hist]
    dev = "not measured (CPU)" if r["peak_gib"] is None else (
        f"peak {r['peak_gib']:.2f} GiB, train_mfu {r['mfu']:.4f} (6 × "
        f"{r['matmul'] / 1e9:.4f} B matmul params × {TRAIN_BATCH * TRAIN_SEQ}"
        f" tokens a step over {TRAIN_PEAK_FLOPS / 1e12:g} TFLOP/s f32)")
    aux = "".join(f", {k} {hist[-1][k]:.4f}" for k in
                  ("load_balance_loss", "router_z_loss") if k in hist[-1])
    print(f"train [{card}] {cfg.name} ({cfg.num_layers} layers, d "
          f"{cfg.d_model}, vocab {cfg.vocab_size}, {r['params'] / 1e9:.4f} B "
          f"params f32, remat {cfg.remat}): {len(hist)} steps of B "
          f"{TRAIN_BATCH} × S {TRAIN_SEQ}, {r['ms']:.2f} ms a step (median "
          f"after {TRAIN_UNTIMED}; step 1 {r['per_step'][0] * 1e3:.1f} ms), "
          f"{r['tokens_s']:.1f} tokens/s, {dev}; loss {losses[0]:.4f} → "
          f"{losses[-1]:.4f} (mean of the last "
          f"{len(losses[-TRAIN_LAST:])} "
          f"{statistics.fmean(losses[-TRAIN_LAST:]):.4f}), grad_norm "
          f"{hist[0]['grad_norm']:.3f} → {hist[-1]['grad_norm']:.3f}, lr "
          f"{hist[-1]['lr']:.3e}{aux}", flush=True)
    print(f"train steps {cfg.name} ms: " + ", ".join(
        f"{v * 1e3:.2f}" for v in r["per_step"]))


def train_phase(device: str, card: str, *, full: bool, steps: int,
                moe_steps: int) -> dict:
    """The train phase: (a) TRAIN_ARCH trained (full width and depth on
    the card, reduced with ``full=False``) under deterministic mode,
    checkpointed at its last step by the loop; (b) the checkpoint round
    trip; (c) the trained weights served through `mixer_path` (the
    engine's checks, decode == forward, flash_decode launches, the
    CUDA-graph capture); (d) TRAIN_MOE_ARCH at full width and
    TRAIN_MOE_LAYERS layers (on the card; reduced in the rehearsal);
    (e) one reduced step on the card against the CPU (the CPU half
    alone in the rehearsal)."""
    from repro_torch.configs import get_arch

    t_phase = time.perf_counter()
    cfg = get_arch(TRAIN_ARCH).config
    moe_cfg = get_arch(TRAIN_MOE_ARCH).config
    if full:
        moe_cfg = dataclasses.replace(moe_cfg, num_layers=TRAIN_MOE_LAYERS)
    else:
        cfg, moe_cfg = cfg.reduced(), moe_cfg.reduced()
    if os.path.exists(TRAIN_CKPT):
        os.remove(TRAIN_CKPT)
    with deterministic():
        r = train_run(device, cfg, steps=steps, ckpt_path=TRAIN_CKPT)
    check_train_run(r, moe=False)
    print_train_run(r, card)
    ck = checkpoint_round_trip(r, device)
    print(f"train checkpoint [{card}] {cfg.name}: {ck['names']} tensors, "
          f"{ck['bytes'] / 1e9:.3f} GB, saved by the loop at step "
          f"{len(r['history'])} in {r['save_s']:.2f} s, loaded in "
          f"{ck['load_s']:.2f} s: every tensor bit-equal; one more step "
          f"from the live and the loaded state (deterministic algorithms): "
          f"loss {ck['loss']:.6f} from both, parameters and moments bit for "
          f"bit; one step more from these equal states with deterministic "
          f"algorithms off: |Δloss| {ck['nondet'][0]:.3e}, max |Δparam| "
          f"{ck['nondet'][1]:.3e}", flush=True)
    prof = train_profile(r, device) if device == "cuda" else None
    print_train_profile(prof, cfg.name, card)
    served = mixer_path(device, cfg,
                        requests=TRAIN_REQUESTS if full else 4,
                        batch=LLM_BATCH if full else 2,
                        max_seq=LLM_MAX_SEQ if full else MIXER_REHEARSAL_WINDOW,
                        prompt=TRAIN_PROMPT if full else (3, 8),
                        new_tokens=LLM_NEW_TOKENS if full else 4,
                        forward=MIXER_FORWARD if full else (2, 6),
                        params=r["state"].params)
    dev = "" if served["device_ms"] is None else (
        f", {served['device_ms']:.3f} ms a step by CUDA-graph replay")
    print(f"train serving [{card}] the trained {cfg.name}: {served['report'].count} "
          f"requests, {served['steps']} decode steps, "
          f"{served['tokens'] / served['secs']:.1f} generated tokens/s"
          f"{dev}; checks pass (repeat run equal, one request == sequential "
          f"decode_step, cuda vs torch {served['rel']['torch']:.3e} of "
          f"max|logit| {served['scale']:.3f} (tolerance {LLM_LOGIT_TOL:g}), "
          f"decode vs own forward {served['forward_err']:.3e} (rtol "
          f"{MIXER_FORWARD_TOL[0]:g}, atol {MIXER_FORWARD_TOL[1]:g}), "
          f"flash_decode launches {served['launches'].get('flash_decode', 0)}"
          f" = {attn_layers(cfg) if device == 'cuda' else 0} × "
          f"{served['steps']})", flush=True)
    del r["state"], r["extra"]
    gc.collect()
    if device == "cuda":
        torch.cuda.empty_cache()
    moe = None
    if full:
        with deterministic():
            moe = train_run(device, moe_cfg, steps=moe_steps)
        check_train_run(moe, moe=True)
        print_train_run(moe, card)
        twin = _clone_state(moe["state"])
        moe["repeat"] = repeat_steps(moe, moe["state"], twin, device,
                                     "two copies of the state")
        del twin
        moe["profile"] = train_profile(moe, device)
        print(f"train repeat [{card}] {moe_cfg.name}: one more step from two "
              f"copies of the state bit-equal (deterministic algorithms); "
              f"one step more with them off: |Δloss| "
              f"{moe['repeat']['nondet'][0]:.3e}, max |Δparam| "
              f"{moe['repeat']['nondet'][1]:.3e}", flush=True)
        print_train_profile(moe["profile"], moe_cfg.name, card)
        del moe["state"], moe["extra"]
        gc.collect()
        torch.cuda.empty_cache()
    cmp = train_card_vs_cpu(("cuda", "cpu") if device == "cuda"
                            else ("cpu",))
    if cmp["grad_err"] is not None:
        print(f"train step card vs CPU [{card}] {TRAIN_ARCH} reduced: loss "
              f"{cmp['loss']:.6f}, |Δloss| {cmp['loss_rel']:.3e} of it (rtol "
              f"{TRAIN_LOSS_RTOL:g}), grad_norm {cmp['norm_rel']:.3e} (rtol "
              f"{TRAIN_NORM_RTOL:g}), every gradient leaf within "
              f"{cmp['grad_err']:.3e} of its max|g| (tolerance "
              f"{TRAIN_GRAD_TOL:g})", flush=True)
    secs = time.perf_counter() - t_phase
    print(f"train phase: pass ({secs:.1f} s)", flush=True)
    return dict(run=r, ckpt=ck, profile=prof, served=served, moe=moe,
                cmp=cmp, secs=secs)


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


# ------------------------------------------------------------- streaming
@contextlib.contextmanager
def uncounted():
    """Launches made inside (checks against plain versions, baselines) are
    not the path's: the counts are put back as they were."""
    from repro_torch.kernels import ops
    saved = ops.launch_counts()
    try:
        yield
    finally:
        with ops._count_lock:
            ops.LAUNCHES.update(saved)


def _stream_close(name: str, got: torch.Tensor, want: torch.Tensor,
                  rtol: float = STREAM_RTOL) -> float:
    """max |got − want|; raises unless |got − want| ≤ rtol·|want| +
    1e-12·max|want| elementwise."""
    got = got.to(want.device)
    err = (got - want).abs()
    scale = want.abs().max().item() if want.numel() else 0.0
    max_err = err.max().item() if err.numel() else 0.0
    if not torch.isfinite(got).all() or (
            err > rtol * want.abs() + 1e-12 * scale).any():
        raise PhaseError(f"{name}: disagrees beyond rtol {rtol:g} (max abs "
                         f"err {max_err:.3e}, max |ref| {scale:.3e})")
    return max_err


def _node_conds(aux) -> list[float]:
    """cond(A_j) of each node's Eq. 17 matrix: its live block of binv."""
    return [torch.linalg.cond(aux.binv[j, :dj, :dj]).item()
            for j, dj in enumerate(aux.node_dims)]


def check_stream_packed(rt, where: str, *, plain_gram: bool = False) -> dict:
    """to_packed(aux) against `pack_problem` of `rt.reference_solver()` on
    the same device, per node at rtol 1e-9 where cond(A_j) ≤ 1e6 (at rtol
    cond·1e-15, Woodbury's agreement with a direct inverse, beyond);
    with ``plain_gram`` also the rebuild through `rff_gram` against the
    one through torch matmuls (the kernel against its plain version)."""
    from repro_torch.dist import pack_problem
    with uncounted():
        ref = rt.reference_solver()
        want = pack_problem(ref, device=rt.device)
        got = rt.packed
        if got.node_dims != want.node_dims:
            raise PhaseError(f"stream {where}: node_dims {got.node_dims} ≠ "
                             f"{want.node_dims}")
        conds = _node_conds(rt.aux)
        err = 0.0
        for j, cond in enumerate(conds):
            rtol = STREAM_RTOL if cond <= STREAM_COND_MAX else cond * 1e-15
            for f in ("g", "d", "s", "p"):
                err = max(err, _stream_close(
                    f"stream {where}: {f}[{j}] (cond(A) {cond:.3e})",
                    getattr(got, f)[j], getattr(want, f)[j], rtol))
        gram_err = None
        if plain_gram:
            plain = pack_problem(ref, gram_backend="torch", device=rt.device)
            gram_err = max(_stream_close(f"stream {where}: rff_gram pack vs "
                                         f"torch pack, {f}",
                                         getattr(want, f), getattr(plain, f))
                           for f in ("g", "d", "s", "p"))
    return dict(err=err, cond=max(conds), gram_err=gram_err)


class _StreamPredictor:
    """`rt.predict` in `solver.predict`'s signature, for `_predict_all`."""

    def __init__(self, rt):
        self.rt = rt

    def predict(self, theta, x, node=None):
        return self.rt.predict(x, node=node)


def _async_checks(rt, theta0, budget: int, tol: float, chain_rounds: int,
                  seed: int) -> dict:
    """The masked round (a tol solve) and the async chain (tol 0) on the
    stream's operator from θ0, on a table of seeded masks, against the
    torch backend (rtol 1e-9); the chain also against the per-round cuda
    backend, bit for bit."""
    from repro_torch.core import activation_masks
    from repro_torch.dist import async_solve_batched
    packed, acfg = rt.packed, rt.config.async_config
    gen = torch.Generator(device=rt.device).manual_seed(seed)

    def solve(backend, rounds, t):
        masks = activation_masks(gen.manual_seed(seed), rounds,
                                 packed.num_nodes, prob=acfg.prob)
        return async_solve_batched(packed, rounds, masks, config=acfg,
                                   theta0=theta0, backend=backend, tol=t,
                                   return_rounds=True)

    with uncounted():
        (fused, r_f), (plain, r_p) = (solve(b, budget, tol)
                                      for b in ("cuda_fused", "torch"))
        if r_f != r_p:
            raise PhaseError(f"stream async tol {tol}: {r_f} rounds on "
                             f"cuda_fused, {r_p} on torch")
        masked_err = _stream_close("stream async: masked rounds vs torch",
                                   fused, plain)
        chain, plain, per_round = (solve(b, chain_rounds, 0.0)[0] for b in
                                   ("cuda_fused", "torch", "cuda"))
        chain_err = _stream_close("stream async: chain vs torch", chain,
                                  plain)
        if not torch.equal(chain, per_round):
            raise PhaseError("stream async: chain ≠ masked round launches "
                             "bit for bit")
    return dict(masked_err=masked_err, masked_rounds=r_f,
                chain_err=chain_err)


def fold_profile(aux, b: int, calls: int = 5) -> dict | None:
    """Where a Woodbury fold's time goes on the card, by torch.profiler:
    device ms and kernels per fold, and the host operators of the most
    self time; None where the profiler records nothing."""
    from repro_torch.stream import ingest
    dim = aux.omega.shape[2]
    xb = torch.randn(dim, b, dtype=aux.zy.dtype, device=aux.device)
    yb = torch.randn(b, dtype=aux.zy.dtype, device=aux.device)
    try:
        from torch.profiler import ProfilerActivity, profile
        ingest(aux, 0, xb, yb)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                ingest(aux, 0, xb, yb)
            torch.cuda.synchronize()
        events = prof.key_averages()
    except Exception as exc:                      # the profiler is optional
        print(f"profiler: not recorded ({type(exc).__name__})")
        return None
    dev = lambda e: getattr(e, "self_device_time_total",
                            getattr(e, "self_cuda_time_total", 0))
    # the kernels themselves: an operator's row repeats its kernels' time
    kernels = [e for e in events
               if str(getattr(e, "device_type", "")).endswith("CUDA")
               and dev(e) > 0]
    host = sorted((e for e in events if e.self_cpu_time_total > 0),
                  key=lambda e: -e.self_cpu_time_total)[:6]
    return dict(device_ms=sum(dev(e) for e in kernels) / 1e3 / calls,
                kernels=sum(e.count for e in kernels) / calls,
                host=[(e.key, e.self_cpu_time_total / calls) for e in host])


def stream_phase(run: dict, *, epochs: int, ingest: tuple,
                 refreshes: tuple, async_rounds: int, queries: int,
                 publishes: int, threaded: int, reps: int,
                 seed: int = 3) -> dict:
    """The streaming runtime at the main path's width (its maps and
    training columns; the stream bench's λ, c_nei, tol): init → ingests →
    warm/cold epochs → refreshes → an async epoch → serving from the live
    stream → an interleaved ingest–solve–publish loop against replicas.
    Launch counts are zeroed at the start and read at the end; the checks
    inside run `uncounted`. The sync part is replayed on the CPU through
    the torch backend (the same minibatches, pools and round counts) and
    held to the device's θ and state."""
    from repro_torch.bench import stream_bench as SB
    from repro_torch.core import AsyncGossipConfig, sample_rff
    from repro_torch.dist import solve_batched, step_batched
    from repro_torch.kernels import ops
    from repro_torch.serve import DeKRRReplicaServer, DeKRRServeEngine
    from repro_torch.stream import SnapshotRegistry

    solver, test = run["solver"], run["test"]
    device = solver.device
    sync = torch.cuda.synchronize if device.type == "cuda" \
        else (lambda: None)
    rng = np.random.default_rng(seed)
    dim = solver.data[0].x.shape[0]
    out = dict(epochs=[], refresh=[], checks={})
    t_phase = time.perf_counter()

    sync()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    rt = SB.stream_runtime(solver.topology, solver.feature_maps,
                           solver.data, backend="cuda_fused", seed=seed,
                           device=device)
    sync()
    out["init_ms"] = (time.perf_counter() - t0) * 1e3
    init = dict(topology=solver.topology, fmaps=list(solver.feature_maps),
                data=list(solver.data))
    log = []                       # the sync schedule, for the CPU replay
    fold, solve = rt.ingest, rt.solve

    def logged_ingest(node, xb, yb):
        log.append(("ingest", node, np.array(xb), np.array(yb)))
        return fold(node, xb, yb)

    def logged_solve(rounds=None, tol=None):
        rep = solve(rounds, tol)
        log.append(("solve", rep.rounds_run))
        return rep

    rt.ingest, rt.solve = logged_ingest, logged_solve
    out["cold0"] = rt.solve()
    with uncounted():
        out["ingest"] = SB.ingest_rows(rt, ingest, reps, rng)
        out["rebuild_us"] = SB.rebuild_us(rt, max(1, reps // 3))
        out["fold_profile"] = (fold_profile(rt.aux, ingest[-1])
                               if device.type == "cuda" else None)
    for node, b in zip((0, 5, 9), ingest):
        xb, yb = rng.normal(size=(dim, b)), rng.normal(size=b)
        if device.type != "cuda":
            rt.ingest(node, xb, yb)
            continue
        # an ingest, host minibatch included, must not wait on the device
        sync()
        torch.cuda.set_sync_debug_mode("error")
        try:
            rt.ingest(node, xb, yb)
        except RuntimeError as exc:
            raise PhaseError(f"stream: an ingest at b {b} synchronized with "
                             f"the device ({exc})") from exc
        finally:
            torch.cuda.set_sync_debug_mode("default")
    out["checks"]["ingests"] = check_stream_packed(rt, "after the ingests",
                                                   plain_gram=True)

    def after(rt, theta0, row):
        cfg = rt.config
        with uncounted():
            per_round, rounds = solve_batched(
                rt.packed, cfg.rounds_per_epoch, theta0, backend="cuda",
                tol=cfg.tol, chunk_rounds=cfg.chunk_rounds,
                return_rounds=True)
            if rounds != row["warm_rounds"] or not torch.equal(per_round,
                                                               rt.theta):
                raise PhaseError(f"stream epoch {row['epoch']}: cuda_fused "
                                 f"≠ cuda bit for bit ({row['warm_rounds']} "
                                 f"and {rounds} rounds)")
            plain = solve_batched(rt.packed, rounds, theta0,
                                  backend="torch")
            row["solve_err"] = _stream_close(
                f"stream epoch {row['epoch']}: warm solve vs torch",
                rt.theta, plain)
            row["step_err"] = _stream_close(
                f"stream epoch {row['epoch']}: dekrr_step vs torch",
                step_batched(rt.packed, rt.theta, backend="cuda"),
                step_batched(rt.packed, rt.theta, backend="torch"))
            row["cond"] = max(_node_conds(rt.aux))
        if row["warm_rounds"] >= row["cold_rounds"]:
            raise PhaseError(f"stream epoch {row['epoch']}: warm "
                             f"{row['warm_rounds']} rounds, not below cold "
                             f"{row['cold_rounds']}")

    out["epochs"] = SB.warm_cold_epochs(rt, epochs, rng, after=after)

    gen = torch.Generator(device=device).manual_seed(seed)
    for node, d_new in refreshes:
        sigma = 1.0 / torch.std(rt.feature_maps[node].omega,
                                correction=0).item()
        pool = sample_rff(gen, dim, rt.config.refresh_candidate_ratio
                          * d_new, sigma, dtype=rt.aux.zy.dtype)
        before = rt.aux.binv.clone()
        sync()
        t0 = time.perf_counter()
        rep = rt.refresh(node, d_new, candidates=pool)
        sync()
        ms = (time.perf_counter() - t0) * 1e3
        log.append(("refresh", node, d_new, pool))
        old = before.shape[1]
        after_binv = rt.aux.binv
        for j in range(rt.num_nodes):
            if j == node:
                continue
            grown = after_binv[j, old:, old:]
            if not (torch.equal(after_binv[j, :old, :old], before[j])
                    and not after_binv[j, :old, old:].any()
                    and torch.equal(grown, torch.eye(
                        grown.shape[0], dtype=grown.dtype,
                        device=grown.device))):
                raise PhaseError(f"stream refresh of node {node}: node "
                                 f"{j}'s inverse changed")
        chk = check_stream_packed(rt, f"after the refresh of node {node}")
        out["refresh"].append(dict(node=node, ms=ms, report=rep, **chk))
    out["after_refresh"] = rt.solve()
    del rt.ingest, rt.solve

    # the sync schedule again on the CPU, torch backend, same round counts
    with uncounted():
        t0 = time.perf_counter()
        cpu = SB.stream_runtime(
            init["topology"], [f.to("cpu") for f in init["fmaps"]],
            [nd.to("cpu") for nd in init["data"]], backend="torch",
            seed=seed, device="cpu")
        for event in log:
            if event[0] == "ingest":
                cpu.ingest(*event[1:])
            elif event[0] == "solve":
                cpu.solve(rounds=event[1], tol=0.0)
            else:
                cpu.refresh(event[1], event[2],
                            candidates=event[3].to("cpu"))
        out["replay_secs"] = time.perf_counter() - t0
        out["replay_err"] = _stream_close(
            "stream: θ on the card vs the CPU replay", rt.theta,
            cpu.theta.to(device))
        for f in ("binv", "zy", "st", "pt"):
            _stream_close(f"stream: {f} on the card vs the CPU replay",
                          getattr(rt.aux, f), getattr(cpu.aux, f).to(device))

    # an async epoch: the masked round (tol > 0), then the chain (tol 0)
    rt.config = dataclasses.replace(
        rt.config, gossip="async", chunk_rounds=None,
        async_config=AsyncGossipConfig(**STREAM_ASYNC))
    for node in SB.EPOCH_NODES:
        rt.ingest(node, rng.normal(size=(dim, SB.EPOCH_BATCH)),
                  rng.normal(size=SB.EPOCH_BATCH))
    out["async_checks"] = _async_checks(
        rt, rt.theta, rt.config.rounds_per_epoch, rt.config.tol,
        async_rounds, seed + 1)
    out["async_tol"] = rt.solve()
    out["async_chain"] = rt.solve(rounds=async_rounds, tol=0.0)
    rt.config = dataclasses.replace(rt.config, gossip="sync",
                                    chunk_rounds=SB.CHUNK)

    # serving from the live stream
    eng = DeKRRServeEngine(rt, batch_size=SERVE_BATCH, backend="cuda")
    eng.run(serve_queries(test, SERVE_BATCH, seed + 100))       # warm-up
    qs = serve_queries(test, queries, seed)
    eng.run(qs)
    out["serve"] = eng.latency.report()
    bound = rt.staleness()
    with uncounted():
        got = _answers(qs)
        want = np.concatenate(_predict_all(_StreamPredictor(rt),
                                           (rt.theta,), qs))
        out["serve_err"] = _stream_close(
            "stream serving vs rt.predict", torch.from_numpy(got),
            torch.from_numpy(want), SERVE_RTOL)
    if any(q.staleness != bound for q in qs):
        raise PhaseError("stream serving: an answer carries another "
                         "staleness than the stream's")

    # interleaved ingest–solve–publish against a 2-replica server
    reg = SnapshotRegistry()
    published = {}

    def publish():
        version = reg.publish_from(rt)
        snap = reg.latest()
        published[version] = (snap, tuple(t.clone() for t in snap.theta))

    publish()
    failure = []
    batches = [(k % rt.num_nodes, rng.normal(size=(dim, 8)),
                rng.normal(size=8)) for k in range(publishes)]

    def writer():
        try:
            for node, xb, yb in batches:
                rt.ingest(node, xb, yb)
                rt.solve()
                publish()
        except Exception as exc:              # re-raised below
            failure.append(exc)

    srv = DeKRRReplicaServer(reg, replicas=SERVE_REPLICAS,
                             batch_size=SERVE_BATCH, backend="cuda")
    tq = serve_queries(test, threaded, seed + 7, uid0=queries)
    thread = threading.Thread(target=writer)
    t0 = time.perf_counter()
    thread.start()
    srv.start()
    try:
        # one slice of the queries per publish, each submitted once that
        # version is out, so the replicas answer across the versions
        for i, part in enumerate(np.array_split(np.arange(len(tq)),
                                                publishes + 1)):
            while reg.version <= i and thread.is_alive():
                time.sleep(1e-4)
            for k in part:
                srv.submit(tq[k])
    finally:
        srv.stop()
        thread.join(timeout=600)
    sync()
    out["threaded_secs"] = time.perf_counter() - t0
    if failure or thread.is_alive():
        raise PhaseError(f"stream writer thread failed: {failure}")
    out["launches"] = ops.launch_counts()
    out["secs"] = time.perf_counter() - t_phase

    with uncounted():
        by_staleness = {snap.staleness: snap
                        for snap, _ in published.values()}
        if len(by_staleness) != len(published):
            raise PhaseError("stream: two published snapshots share one "
                             "staleness")
        for version, (snap, kept) in published.items():
            if not all(torch.equal(t, c) for t, c in zip(snap.theta, kept)):
                raise PhaseError(f"stream: published snapshot {version} was "
                                 f"written after it was published")
        groups: dict = {}
        for q in tq:
            if not q.done or q.staleness not in by_staleness:
                raise PhaseError(f"stream: threaded query {q.uid} answered "
                                 f"from no published snapshot")
            groups.setdefault(q.staleness, []).append(q)
        err = 0.0
        for staleness, group in groups.items():
            clean = [dataclasses.replace(q, prediction=None, staleness=None,
                                         done=False) for q in group]
            DeKRRServeEngine(by_staleness[staleness],
                             batch_size=SERVE_BATCH, backend="cuda").run(clean)
            err = max(err, _stream_close(
                "stream: threaded answer vs a clean serve of its snapshot",
                torch.from_numpy(_answers(group)),
                torch.from_numpy(_answers(clean)), SERVE_RTOL))
    out.update(threaded_err=err, publishes=len(published),
               versions_served=len(groups), threaded=len(tq))
    return out


def check_stream_launches(st: dict, on_card: bool) -> dict:
    """Every kernel of the streaming path launched in its run (none on
    the CPU), and none of another path."""
    got = {k: v for k, v in st["launches"].items() if v}
    want = ("rff_gram", "dekrr_solve", "dekrr_step", "dekrr_step_masked",
            "dekrr_async_solve", "rff_features")
    if not on_card:
        if got:
            raise PhaseError(f"stream on the CPU counted launches {got}")
        return got
    if set(got) != set(want):
        raise PhaseError(f"stream path launch counts {got}: expected "
                         f"launches of exactly {sorted(want)}")
    return got


def print_stream_phase(st: dict, card: str) -> None:
    ing = "; ".join(f"b {r['batch']}: {r['ingest_us']:.1f} µs"
                    for r in st["ingest"])
    print(f"stream [{card}]: init {st['init_ms']:.1f} ms; ingest {ing}; cold "
          f"rebuild (pack_problem) {st['rebuild_us']:.1f} µs; first cold "
          f"solve {st['cold0'].rounds_run} rounds; after the ingests |Δ| vs "
          f"rebuild {st['checks']['ingests']['err']:.3e} (cond(A) ≤ "
          f"{st['checks']['ingests']['cond']:.3e}), rff_gram pack vs torch "
          f"pack {st['checks']['ingests']['gram_err']:.3e}", flush=True)
    prof = st["fold_profile"]
    if prof is not None:
        print(f"stream fold at b {STREAM_INGEST[-1]} by the profiler "
              f"[{card}]: {prof['device_ms']:.4f} ms on the device in "
              f"{prof['kernels']:.0f} kernels a fold; host self time (µs a "
              f"fold): " + ", ".join(f"{k} {us:.1f}"
                                     for k, us in prof["host"]))
    for e in st["epochs"]:
        print(f"stream epoch {e['epoch']} [{card}]: warm {e['warm_rounds']} "
              f"rounds in {e['warm_ms']:.2f} ms, cold {e['cold_rounds']} "
              f"rounds; residual {e['residual']:.3e}; cuda_fused == cuda "
              f"bit for bit; vs torch {e['solve_err']:.3e}, dekrr_step vs "
              f"torch {e['step_err']:.3e} (cond(A) ≤ {e['cond']:.3e})")
    for r in st["refresh"]:
        rep = r["report"]
        print(f"stream refresh of node {r['node']} [{card}]: "
              f"{rep.old_features} → {rep.new_features} features "
              f"(re-padded: {rep.repadded}) in {r['ms']:.1f} ms; other "
              f"nodes' inverses unchanged bit for bit; |Δ| vs rebuild "
              f"{r['err']:.3e} (cond(A) ≤ {r['cond']:.3e})")
    ac = st["async_checks"]
    print(f"stream after the refreshes [{card}]: solve "
          f"{st['after_refresh'].rounds_run} rounds; CPU replay (torch "
          f"backend, {st['replay_secs']:.1f} s) |θ_card − θ_cpu| "
          f"{st['replay_err']:.3e} (cond(A) ≤ {st['refresh'][-1]['cond']:.3e})"
          f"; async epoch: tol {st['async_tol'].rounds_run} "
          f"rounds (masked vs torch {ac['masked_err']:.3e} over "
          f"{ac['masked_rounds']} rounds), chain {st['async_chain'].rounds_run} "
          f"rounds (vs torch {ac['chain_err']:.3e}, == cuda bit for bit)")
    sv = st["serve"]
    print(f"stream serving [{card}]: {sv.count} queries from the live "
          f"stream, p50 {sv.p50 * 1e3:.3f} ms, p99 {sv.p99 * 1e3:.3f} ms, "
          f"{sv.qps:.1f} qps, |f − rt.predict| {st['serve_err']:.3e}; "
          f"interleaved: {st['publishes']} publishes, {st['threaded']} "
          f"queries on {SERVE_REPLICAS} replicas in "
          f"{st['threaded_secs']:.2f} s from {st['versions_served']} "
          f"versions, each equal to a clean serve of its snapshot "
          f"({st['threaded_err']:.3e})")
    print(f"stream launches [{card}]: "
          f"{json.dumps({k: v for k, v in st['launches'].items() if v})}; "
          f"phase {st['secs']:.1f} s", flush=True)


# ------------------------------------------------------------------ bench
def dispatch_checks(run: dict, a: dict, c: dict, rounds: int) -> list[dict]:
    """(a) Each backend of the main (sync), async and Chebyshev paths on
    the main path's packed problem: `dispatch_count` of one solve of
    ``rounds`` rounds against the contract and, on the card, against the
    LAUNCHES delta of the same run (on the CPU every launch count stays
    0: each dispatch runs a plain version)."""
    from repro_torch.core.acceleration import chebyshev_solve_packed
    from repro_torch.dist import async_solve_batched, solve_batched
    from repro_torch.kernels import ops
    from repro_torch.obs import dispatch_count, round_dispatches

    packed = run["packed"]
    on_card = packed.device.type == "cuda"
    lo, hi = c["mu"]
    masks = a["masks"][:rounds]
    paths = {
        "sync": lambda b, **kw: solve_batched(packed, rounds, backend=b,
                                              return_trace=True, **kw),
        "async": lambda b, **kw: async_solve_batched(
            packed, rounds, masks, config=a["config"], backend=b,
            return_stats=True, **kw),
        "chebyshev": lambda b, **kw: chebyshev_solve_packed(
            packed, hi, lo, num_iters=rounds, backend=b, return_trace=True,
            **kw)}
    out = []
    for path, fn in paths.items():
        for backend, chunk in (("torch", None), ("cuda", None),
                               ("cuda_fused", None), ("cuda_fused",
                                                      BENCH_CHUNK)):
            kw = {} if chunk is None else {"chunk_rounds": chunk}
            before = ops.launch_counts()
            count, exact = dispatch_count(fn, backend, **kw)
            if on_card:
                torch.cuda.synchronize()
            after = ops.launch_counts()
            launched = sum(after[k] - before[k] for k in after)
            want = round_dispatches(backend, rounds, chunk_rounds=chunk)
            if not exact or count != want or (
                    launched != (count if on_card else 0)):
                raise PhaseError(
                    f"bench (a) {path} backend={backend} chunk={chunk}: "
                    f"{count} dispatches, {launched} launches; the contract "
                    f"is {want}")
            out.append(dict(path=path, backend=backend, chunk=chunk,
                            dispatches=count, launches=launched,
                            contract=want))
    return out


def smem_checks() -> list[dict]:
    """(b) Each kernel's `repro_torch.analysis.smem` estimate at the
    paths' shapes against the bytes its csrc launcher takes (the
    library's C export)."""
    from repro_torch.analysis import smem

    sms = smem.device_sms(torch.device("cuda"))
    out = []
    for kernel, shape in smem.PATH_SHAPES:
        kw = dict(shape, sms=sms) if kernel in (
            "rff_gram", "rff_features", "serve_wave") else shape
        est = getattr(smem, f"estimate_{kernel}")(**kw)
        got = smem.launcher_bytes(kernel, shape, sms=sms)
        if got != est.bytes or not est.fits:
            raise PhaseError(f"bench (b) {kernel} {shape}: the estimate "
                             f"says {est.bytes} bytes (fits {est.fits}), "
                             f"the launcher takes {got}")
        out.append(dict(kernel=kernel, shape=shape, bytes=got,
                        limit=est.limit, formula=est.formula))
    return out


def over_budget_check(device: str) -> str:
    """(c) The over-budget round (K 4, Dy 8, D 640, f64: 245,760 B a
    block) raises `SmemBudgetError` with no launch and no CUDA error."""
    from repro_torch.analysis import SmemBudgetError
    from repro_torch.kernels import ops

    j, k, d, dy = 2, 4, 640, 8
    z = lambda *s: torch.zeros(s, dtype=torch.float64, device=device)
    nbr = torch.tensor([[1] * k, [0] * k], dtype=torch.int32, device=device)
    own = torch.arange(j, dtype=torch.int32, device=device)
    mask = torch.ones((j, k), dtype=torch.int32, device=device)
    before = ops.launch_counts()
    try:
        ops.dekrr_step(z(j, d, d), z(j, d, dy), z(j, d, d), z(j, k, d, d),
                       z(j, d, dy), nbr, own, mask)
    except SmemBudgetError as exc:
        message = str(exc)
    else:
        raise PhaseError("bench (c): the over-budget round was not refused")
    if device == "cuda":
        torch.cuda.synchronize()
        (torch.ones(4, device=device) * 2).sum().item()
    if ops.launch_counts() != before or "245760" not in message:
        raise PhaseError(f"bench (c): launches moved or the message does "
                         f"not name the bytes: {message}")
    return message


def check_cost_us(calls: int = 2000) -> dict[str, float]:
    """Host µs a call of each wrapper's budget check at the main path's
    shapes (`repro_torch.analysis.smem`; what the check adds to every
    launch), and of one dispatch count."""
    from repro_torch.analysis import smem
    from repro_torch.kernels import ops

    checks = {
        "dekrr_step": lambda: smem.estimate_dekrr_step(
            j_nodes=J_NODES, k_slots=4, d_feat=D_PER_NODE).check(),
        "rff_gram": lambda: smem.estimate_rff_gram(
            b=J_NODES, f=D_PER_NODE, dim=148, n=3180).check(),
        "rff_features": lambda: smem.estimate_rff_features(
            j=J_NODES, d_feat=D_PER_NODE, n=SERVE_N).check(),
        "flash_decode": lambda: smem.estimate_flash_decode(
            rows=LLM_BATCH * 16, groups=1, dh=64, s=LLM_MAX_SEQ).check(),
        "dispatch count": lambda: ops._count_plain("flash_decode"),
    }
    out = {}
    saved = ops.dispatch_counts()
    for name, fn in checks.items():
        fn()
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        out[name] = (time.perf_counter() - t0) / calls * 1e6
    with ops._count_lock:
        ops.DISPATCHES.update(saved)
    return out


def bench_phase(run: dict, a: dict, c: dict, *, fast: bool,
                serve_counts: tuple[int, int, int],
                out_dir: str) -> dict:
    """The system benchmarks (`repro_torch.bench`) on the card: (a)
    dispatch counts, (b) shared-memory estimates against the launchers
    (on the card only), (c) the over-budget round, (d) the serve bench on
    the main path's θ, the solve bench (the reference's CASES), the async
    bench on the main path's packed problem, the Chebyshev bench (houses
    at full N) and the multi-output bench, all into one registry written
    as JSONL under ``out_dir`` and rendered by `repro_torch.obs`, (e)
    provenance naming the card and its power limit."""
    from repro_torch.bench import (async_gossip_bench, chebyshev_bench,
                                   multiout_bench, serve_bench, solve_bench)
    from repro_torch.kernels import ops
    from repro_torch.obs import Registry, recording, span
    from repro_torch.obs.__main__ import load_records, render_report
    from repro_torch.obs.export import provenance, write_jsonl

    device = run["packed"].device
    on_card = device.type == "cuda"
    t0 = time.perf_counter()
    before = route_counts()
    out = dict(dispatch=dispatch_checks(run, a, c, BENCH_ROUNDS))
    out["dispatch_routes"] = route_counts(before)
    out["smem"] = smem_checks() if on_card else []
    out["over_budget"] = over_budget_check(device.type)
    out["check_us"] = check_cost_us()
    snap, _ = serve_snapshot(run, run["theta"], 1)
    xs = run["test"][0].x.cpu().numpy()
    n_cap, n_open, reps = serve_counts
    registry = Registry()
    suites = {
        "serve": lambda: serve_bench.serve_frontier(
            snap, xs, n_cap=n_cap, n_open=n_open, reps=reps,
            registry=registry),
        "solve": lambda: solve_bench.run(fast=fast, device=device,
                                         registry=registry),
        "async": lambda: async_gossip_bench.run(
            fast=fast, device=device, registry=registry,
            packed=run["packed"]),
        "chebyshev": lambda: chebyshev_bench.run(
            fast=fast, device=device, registry=registry,
            subsample=None if on_card else 600),
        "multiout": lambda: multiout_bench.run(fast=fast, device=device,
                                               registry=registry),
    }
    ops.reset_launch_counts()
    before = route_counts()
    results = {}
    with recording(registry):
        for name, fn in suites.items():
            t1 = time.perf_counter()
            try:
                with span(f"bench.{name}", fast=fast):
                    results[name] = fn()
            except (RuntimeError, AssertionError, ValueError) as exc:
                raise PhaseError(f"bench (d) {name}: {exc}") from exc
            registry.histogram("bench.suite_seconds").observe(
                time.perf_counter() - t1)
    out["launches"] = ops.launch_counts()
    out["routes"] = route_counts(before)
    want = ("dekrr_step", "dekrr_solve", "dekrr_async_solve", "rff_gram",
            "rff_features", "rff_features_lowp")
    if on_card and not all(out["launches"][k] for k in want):
        raise PhaseError(f"bench (d): a kernel of the benches never "
                         f"launched: {out['launches']}")
    prov = provenance(plain=not on_card, device=device,
                      extra={"phase": "bench", "fast": fast})
    if on_card and (prov["device_kind"] != torch.cuda.get_device_name(0)
                    or prov["power_limit"] != card_line()):
        raise PhaseError(f"bench (e): provenance {prov} does not name the "
                         f"card and its power limit ({card_line()})")
    os.makedirs(out_dir, exist_ok=True)
    path = write_jsonl(registry, os.path.join(out_dir, "run.jsonl"), prov)
    report = render_report(load_records(path))
    for section in ("provenance", "convergence", "comm frontier",
                    "latency / percentiles"):
        if f"== {section} " not in report:
            raise PhaseError(f"bench (d): the report has no {section} "
                             f"section")
    with open(os.path.join(out_dir, "report.txt"), "w") as f:
        f.write(report + "\n")
    out.update(results=results, prov=prov, jsonl=path, report=report,
               secs=time.perf_counter() - t0)
    return out


def print_bench_phase(b: dict, card: str) -> None:
    for row in b["dispatch"]:
        print(f"bench [{card}] (a) {row['path']} backend={row['backend']}"
              + (f" chunk_rounds={row['chunk']}" if row["chunk"] else "")
              + f": {row['dispatches']} dispatches, {row['launches']} "
              f"launches, contract {row['contract']}")
    print(f"bench [{card}] (a) chain routes "
          f"{json.dumps(b['dispatch_routes'])}")
    for row in b["smem"]:
        print(f"bench [{card}] (b) {row['kernel']} "
              f"{json.dumps(row['shape'])}: {row['bytes']} bytes a block "
              f"(launcher == estimate {row['formula']}; limit "
              f"{row['limit']})")
    print(f"bench [{card}] (c) refused: {b['over_budget']}")
    print(f"bench [{card}] host µs a call of each budget check (and of a "
          f"dispatch count): " + ", ".join(
              f"{k} {v:.2f}" for k, v in b["check_us"].items()))
    r = b["results"]
    cl = r["serve"]["closed_loop"]
    print(f"bench [{card}] (d) serve (main path θ, batch "
          f"{r['serve']['batch_size']}, {r['serve']['replicas']} replicas, "
          f"queries {json.dumps(r['serve']['queries'])}): closed-loop qps "
          f"sequential {cl['single_engine_sequential_qps']:.1f}, batched "
          f"engine {cl['single_engine_batched_qps']:.1f}, replicas "
          f"{cl['replica_qps']:.1f} (medians)")
    for row in r["serve"]["frontier"]:
        print(f"bench [{card}] (d) serve open-loop {row['precision']} at "
              f"{row['offered_qps'] / row['capacity_qps']:.1f} of "
              f"{row['capacity_qps']:.1f} qps: achieved "
              f"{row['achieved_qps']:.1f} qps, p50 {row['p50_ms']:.3f} ms, "
              f"p99 {row['p99_ms']:.3f} ms, max |f_lo − f_hi| "
              f"{row['max_answer_error']:.3e}"
              + (f", max bound {row['max_precision_bound']:.3e}, all "
                 f"within {row['all_within_bound']}"
                 if "max_precision_bound" in row else ""))
    for case in r["solve"]["cases"]:
        print(f"bench [{card}] (d) solve J={case['j_nodes']} "
              f"D={case['d_max']} R={case['rounds']}: " + ", ".join(
                  f"{k} {v / 1e3:.3f} ms ({case['dispatches'][k]} "
                  f"dispatches)" for k, v in case["us"].items())
              + f"; H100 bound {case['h100_bound_us'] / 1e3:.4f} ms")
    for row in r["async"]["schedules"]:
        last = row["frontier"][-1]
        print(f"bench [{card}] (d) async {row['schedule']} R="
              f"{last['rounds']}: rel_err {last['rel_err']:.3e}, "
              f"{last['actual_bytes']} bytes on the wire (model "
              f"{last['expected_bytes']:.0f}), censor fraction "
              f"{last['observed_censor_fraction']:.4f}")
    for row in r["chebyshev"]["rows"]:
        print(f"bench [{card}] (d) chebyshev houses N="
              f"{r['chebyshev']['n_train']} c={row['c_over_n']}N (ρ "
              f"{row['rho']:.6f}, interval [{row['mu_interval'][0]:.6f}, "
              f"{row['mu_interval'][1]:.6f}]): rounds "
              f"to 1e-6 plain {row['rounds_plain']}, Chebyshev "
              f"{row['rounds_chebyshev']}, {row['bytes_per_round']} bytes a "
              f"round, {row['seconds']:.2f} s")
    for row in r["multiout"]["results"]:
        print(f"bench [{card}] (d) multiout Dy={row['dy']}: " + ", ".join(
            f"{k} fused {v['fused_us'] / 1e3:.3f} ms vs loop "
            f"{v['loop_us'] / 1e3:.3f} ms ({v['dispatches_fused']} vs "
            f"{v['dispatches_loop']} dispatches)"
            for k, v in row["backends"].items()))
    print(f"bench [{card}] launches: {json.dumps(b['launches'])}; chain "
          f"routes {json.dumps(b['routes'])}")
    print(f"bench [{card}] (e) provenance: device_kind "
          f"{b['prov']['device_kind']!r}, power_limit "
          f"{b['prov']['power_limit']!r}, torch {b['prov']['torch_version']}"
          f", cuda {b['prov']['cuda_version']}")
    lines = b["report"].splitlines()
    waterfall = [i for i, line in enumerate(lines)
                 if line.startswith("== span waterfall")]
    shown = lines if not waterfall else lines[:waterfall[0]] + [
        line for line in lines[waterfall[0]:]
        if not line.startswith("  ") or "bench." in line
        or line.startswith("  total")]
    print(f"bench [{card}] report of {b['jsonl']} (python -m "
          f"repro_torch.obs; the span waterfall's bench spans only):")
    print("\n".join(shown))
    print(f"bench [{card}] phase {b['secs']:.1f} s", flush=True)


def check_launches(run: dict) -> None:
    got = {k: v for k, v in run["launches"].items() if v}
    rounds = run["rounds"]
    want = {"rff_gram": 2, "dekrr_solve": -(-rounds // CHUNK),
            "dekrr_step": rounds}
    if got != want:
        raise PhaseError(f"main path launch counts {got}, expected {want}")


# ------------------------------------------------------------------ spmd
def _cpu_packed(packed):
    """The packed problem with every tensor on the CPU: the ranks get it
    through shared memory and each moves only its own rows to its device."""
    return dataclasses.replace(packed, **{
        f.name: getattr(packed, f.name).cpu()
        for f in dataclasses.fields(packed)
        if isinstance(getattr(packed, f.name), torch.Tensor)})


def spmd_cases(run: dict, a: dict, *, split_rounds: int) -> list[dict]:
    """The cases each rank runs (`repro_torch.dist.spmd_cases`), named."""
    from repro_torch.core import AsyncGossipConfig

    rounds, j_nodes = run["rounds"], run["packed"].num_nodes
    cases = []
    add = lambda name, **c: cases.append(dict(name=name, **c))  # noqa: E731
    tol_theta = run["spmd_ref"]["tol"][0].cpu()
    for mode in SPMD_MODES:
        for b in ("cuda", "cuda_fused", "torch"):
            add(f"sync/{mode}/{b}", solver="sync", mode=mode, backend=b,
                num_iters=rounds)
        add(f"sync-tol/{mode}", solver="sync", mode=mode, backend="cuda",
            num_iters=NUM_ITERS, kw=dict(tol=SOLVE_TOL, return_rounds=True))
        add(f"sync-warm/{mode}", solver="sync", mode=mode, backend="cuda",
            num_iters=NUM_ITERS, kw=dict(theta0=tol_theta, tol=SOLVE_TOL,
                                         return_rounds=True))
        add(f"async/{mode}", solver="async", mode=mode, backend="cuda",
            num_iters=a["rounds"], kw=dict(masks=a["masks"].cpu(),
                                           config=a["config"],
                                           return_trace=True))
        add(f"async-sync/{mode}", solver="async", mode=mode, backend="cuda",
            num_iters=rounds,
            kw=dict(masks=torch.ones((rounds, j_nodes), dtype=torch.bool),
                    config=AsyncGossipConfig()))
        add(f"split/{mode}", solver="split", mode=mode, backend="cuda",
            num_iters=split_rounds)
    add("async-edge/ppermute", solver="async", mode="ppermute",
        backend="cuda", num_iters=a["rounds"],
        kw=dict(masks=a["edge_masks"].cpu(), config=a["edge_config"],
                return_trace=True))
    add("async-tol/ppermute", solver="async", mode="ppermute",
        backend="cuda", num_iters=a["rounds"],
        kw=dict(masks=a["masks"].cpu(), config=a["config"], tol=ASYNC_TOL,
                return_rounds=True, return_trace=True))
    return cases


def spmd_phase(run: dict, a: dict, *, device: str,
               split_rounds: int = SPMD_SPLIT_ROUNDS) -> dict:
    """The SPMD solvers on the main path's packed problem, one node per
    rank: J ranks started by `run_ranks` on ``device`` (all on the one
    card), exchanging θ over gloo through host buffers."""
    from repro_torch.dist import solve_batched
    from repro_torch.dist.ranks import run_ranks
    from repro_torch.dist.spmd_cases import solve_cases

    packed = run["packed"]
    run["spmd_ref"] = dict(
        cuda=_launched(lambda: solve_batched(packed, run["rounds"],
                                             backend="cuda")),
        tol=solve_batched(packed, NUM_ITERS, backend="cuda", tol=SOLVE_TOL,
                          chunk_rounds=1, return_rounds=True))
    cases = spmd_cases(run, a, split_rounds=split_rounds)
    t0 = time.perf_counter()
    per_rank = run_ranks(solve_cases, packed.num_nodes, backend=SPMD_BACKEND,
                         device=device, timeout=SPMD_TIMEOUT,
                         args=(_cpu_packed(packed), cases, device))
    secs = time.perf_counter() - t0
    return dict(cases=cases, ranks={c["name"]: [r[i] for r in per_rank]
                                    for i, c in enumerate(cases)},
                secs=secs, ranks_n=packed.num_nodes)


def _same(name: str, got, want) -> None:
    if not torch.equal(got.cpu(), want.cpu()):
        raise PhaseError(f"spmd {name}: not bit-equal to its reference "
                         f"(max |Δ| {(got.cpu() - want.cpu()).abs().max():.3e})")


def check_spmd_phase(sp: dict, run: dict, a: dict) -> dict:
    """Every check of the spmd phase; raises on failure. Returns the
    per-round times, the split, the wire and the launches."""
    from repro_torch.dist import comm_bytes_per_round

    packed, rounds = run["packed"], run["rounds"]
    on_card = packed.device.type == "cuda"
    ranks = sp["ranks"]
    for name, per_rank in ranks.items():
        if "error" in per_rank[0]:
            raise PhaseError(f"spmd {name} raised: {per_rank[0]['error']}")
        if "out" in per_rank[0]:
            first = per_rank[0]["out"]
            first = first[0] if isinstance(first, tuple) else first
            for r, res in enumerate(per_rank[1:], 1):
                got = res["out"][0] if isinstance(res["out"], tuple) \
                    else res["out"]
                if not torch.equal(got, first):
                    raise PhaseError(f"spmd {name}: rank {r} returned "
                                     f"another θ than rank 0")
    out = lambda name: ranks[name][0]["out"]                # noqa: E731
    want = run["spmd_ref"]["cuda"][0]
    want_tol, want_tol_rounds = run["spmd_ref"]["tol"]
    (a_theta, a_stats, a_trace) = a["per_round"][0]
    e_theta, e_stats = a["edge_round"][0]
    t_theta, t_rounds, t_stats = a["tol"][0]
    errs, ms, wire, launches = {}, {}, {}, {}
    for mode in SPMD_MODES:
        _same(f"sync/{mode}/cuda", out(f"sync/{mode}/cuda"), want)
        _same(f"sync/{mode}/cuda_fused", out(f"sync/{mode}/cuda_fused"),
              want)
        errs[f"torch/{mode}"] = compare(
            f"spmd sync/{mode}/torch", out(f"sync/{mode}/torch").to(
                want.device), want, torch.float64)
        theta_t, rounds_t = out(f"sync-tol/{mode}")
        if rounds_t != want_tol_rounds:
            raise PhaseError(f"spmd sync-tol/{mode}: {rounds_t} rounds, the "
                             f"batched cuda solve {want_tol_rounds}")
        _same(f"sync-tol/{mode}", theta_t, want_tol)
        if not out(f"sync-warm/{mode}")[1] <= 1:
            raise PhaseError(f"spmd sync-warm/{mode}: the warm start ran "
                             f"{out(f'sync-warm/{mode}')[1]} rounds")
        theta_a, trace_a = out(f"async/{mode}")
        _same(f"async/{mode}", theta_a, a_theta)
        if (int(trace_a.broadcasts.sum()), int(trace_a.deliveries.sum())) \
                != (a_stats.broadcasts, a_stats.deliveries) or not all(
                torch.equal(x.cpu(), y.cpu()) for x, y in zip(
                    trace_a[1:], a_trace[1:])):
            raise PhaseError(f"spmd async/{mode}: wire series differ from "
                             f"async_solve_batched(cuda)'s")
        _same(f"async-sync/{mode}", out(f"async-sync/{mode}"),
              out(f"sync/{mode}/cuda"))
        per_rank = ranks[f"sync/{mode}/cuda"]
        wire[mode] = sum(r["wire_bytes"] for r in per_rank) / rounds
        if wire[mode] != comm_bytes_per_round(packed, mode):
            raise PhaseError(f"spmd {mode}: {wire[mode]} θ bytes a round on "
                             f"the wire, the cost model says "
                             f"{comm_bytes_per_round(packed, mode)}")
        for r, res in enumerate(per_rank):
            if not (res["dispatches"] == rounds
                    == res["launches"]["dekrr_step"] + rounds * (not on_card)):
                raise PhaseError(
                    f"spmd sync/{mode}/cuda rank {r}: {res['dispatches']} "
                    f"dispatches, {res['launches']['dekrr_step']} launches, "
                    f"the contract {rounds}")
        for b in ("cuda", "cuda_fused", "torch"):
            ms[f"sync/{mode}/{b}"] = max(
                r["seconds"] for r in ranks[f"sync/{mode}/{b}"]) \
                / rounds * 1e3
        ms[f"async/{mode}/cuda"] = max(
            r["seconds"] for r in ranks[f"async/{mode}"]) / a["rounds"] * 1e3
    theta_e, trace_e = out("async-edge/ppermute")
    _same("async-edge/ppermute", theta_e, e_theta)
    if (int(trace_e.broadcasts.sum()), int(trace_e.deliveries.sum())) != \
            (e_stats.broadcasts, e_stats.deliveries):
        raise PhaseError("spmd async-edge: wire counts differ")
    theta_t, rounds_t, trace_t = out("async-tol/ppermute")
    if rounds_t != t_rounds:
        raise PhaseError(f"spmd async-tol: {rounds_t} rounds, the batched "
                         f"solve {t_rounds}")
    _same("async-tol/ppermute", theta_t, t_theta)
    for name, per_rank in ranks.items():
        for res in per_rank:
            for k, v in res.get("launches", {}).items():
                launches[k] = launches.get(k, 0) + v
    launches = {k: v for k, v in launches.items() if v}
    if set(launches) != ({"dekrr_step", "dekrr_step_masked"} if on_card
                         else set()):
        raise PhaseError(f"spmd launches {launches}: on the card the phase "
                         f"launches dekrr_step and dekrr_step_masked and "
                         f"nothing else, on the CPU nothing")
    split = {mode: ranks[f"split/{mode}"][0] for mode in SPMD_MODES}
    return dict(errs=errs, ms=ms, wire=wire, launches=launches, split=split,
                batched_ms=run["spmd_ref"]["cuda"][1] / rounds * 1e3,
                tol_rounds=want_tol_rounds,
                async_tol_rounds=rounds_t)


def print_spmd_phase(sp: dict, sc: dict, run: dict, card: str) -> None:
    print(f"spmd [{card}]: backend={SPMD_BACKEND}, host-staged, "
          f"{sp['ranks_n']} ranks on 1 card; J={run['packed'].num_nodes}, "
          f"D={run['packed'].max_features}, {run['rounds']} rounds; "
          f"phase {sp['secs']:.1f} s (spawn and every case)")
    print(f"spmd checks: pass (cuda and cuda_fused θ == batched cuda bit for "
          f"bit in both modes; torch within rtol 1e-9, max |Δ| "
          f"{max(sc['errs'].values()):.3e}; tol {SOLVE_TOL}: "
          f"{sc['tol_rounds']} rounds == batched, θ bit-equal; warm start "
          f"≤ 1 round; async p 0.5 censored, edge and tol "
          f"{ASYNC_TOL} ({sc['async_tol_rounds']} rounds) == "
          f"async_solve_batched(cuda) bit for bit with its wire counts; "
          f"is_synchronous == sync; dispatches == launches == rounds on "
          f"every rank)")
    print(f"spmd wire [{card}]: θ bytes a round summed over ranks " +
          ", ".join(f"{m} {int(v)}" for m, v in sc["wire"].items()) +
          " (== comm_bytes_per_round)")
    print(f"spmd ms a round [{card}] (rank max, wall): " + ", ".join(
        f"{k} {v:.4f}" for k, v in sc["ms"].items())
        + f"; batched cuda {sc['batched_ms']:.4f}, batched cuda_fused "
          f"solve {run['t_solve'] / run['rounds'] * 1e3:.4f}")
    for mode, sp_ in sc["split"].items():
        print(f"spmd split of a round on rank 0 [{card}] {mode}: exchange "
              f"{sp_['exchange_s'] * 1e3:.4f} ms, round on the local table "
              f"{sp_['round_s'] * 1e3:.4f} ms (of it the wrapper's index "
              f"check with its three host copies "
              f"{sp_['index_check_s'] * 1e3:.4f} ms)")
    print(f"spmd launches (summed over ranks): {json.dumps(sc['launches'])}",
          flush=True)


def spmd_step_timings(run: dict, errs: dict) -> list[dict]:
    """The round kernel at the SPMD shape, J = 1 over node 0's [1 + K, D]
    table, unmasked and masked, by CUDA events, beside its plain version,
    one node's gather and three einsums, and its bound; each kernel's
    error against its plain version goes into ``errs``."""
    from repro_torch.kernels.dekrr_step import (dekrr_step_cuda,
                                                dekrr_step_masked_reference,
                                                dekrr_step_reference)

    packed, theta = run["packed"], run["theta"]
    dev, dtype = packed.device, packed.d.dtype
    k_slots, d_feat = packed.num_slots, packed.max_features
    table = torch.cat([theta[:1], theta[packed.nbr_idx[0].long()]])
    local = torch.arange(1, k_slots + 1, dtype=torch.int32, device=dev)[None]
    self_idx = torch.zeros((1,), dtype=torch.int32, device=dev)
    lay = _raw_layout((packed.g[:1], packed.d[:1], packed.s[:1],
                       packed.p[:1], table, local, self_idx,
                       packed.nbr_mask[:1]))
    active = torch.ones((1,), dtype=torch.int32, device=dev)
    out = torch.empty_like(lay[1])
    g, d, s_, p = lay[0], lay[1], lay[2], lay[3]

    def library_node():
        nbr = table[local[0].long()] * packed.nbr_mask[0, :, None]
        acc = d[0] + torch.einsum("ab,b->a", s_[0], table[0]) \
            + torch.einsum("kab,kb->a", p[0], nbr)
        return torch.einsum("ab,b->a", g[0], acc)[None]

    byts = (2 + k_slots) * d_feat * d_feat * lay[0].element_size() \
        + nbytes(d, table, local, self_idx, lay[7], out)
    flops = 2 * (2 + k_slots) * d_feat * d_feat
    rows = []
    for name, replaces, kw, plain in (
            ("dekrr_step@spmd", "src/repro/kernels/dekrr_step.py:192", {},
             lambda: dekrr_step_reference(*lay, dy=1)),
            ("dekrr_step_masked@spmd", "src/repro/kernels/dekrr_step.py:121",
             {"active": active},
             lambda: dekrr_step_masked_reference(*lay, active, dy=1))):
        dekrr_step_cuda(*lay, out, dy=1, **kw)
        errs[name] = compare(f"{name} vs plain", out, plain(), dtype)
        bms, by = bound_ms(byts + (nbytes(active) if kw else 0), flops, dtype)
        rows.append(dict(
            name=name, route="cuda", shape=[1, k_slots, d_feat, 1,
                                            k_slots + 1],
            source="src/repro_torch/kernels/csrc/dekrr_step.cu",
            replaces=replaces,
            ms=cuda_ms(lambda: dekrr_step_cuda(*lay, out, dy=1, **kw),
                       reps=200),
            plain_ms=cuda_ms(plain, reps=50), bound_ms=bms, bound_by=by,
            library_ms=cuda_ms(library_node, reps=50)))
    return rows


# ------------------------------------------------------------------- mesh
def _free_port() -> int:
    import socket
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        return sock.getsockname()[1]


def mesh_decode(rules, spec, seq: int, device: str, *, batch: int,
                steps: int) -> dict:
    """The serve step of input_specs at B ``batch`` over a cache of
    ``seq`` positions through `repro_torch.launch.mesh_cases.
    decode_steps` (filled from a seed; ``steps`` steps on backend cuda,
    each against backend torch from the same cache; the kernel on the
    first layer's inputs against its plain version by `_decode_agrees`),
    raising if that kernel check fails."""
    from repro_torch.configs.registry import ShapeSpec
    from repro_torch.launch.mesh_cases import decode_steps
    from repro_torch.launch.specs import input_specs

    pair = input_specs(spec, ShapeSpec("mesh", seq, batch, "decode"), rules,
                       device=device)
    res = decode_steps(pair, steps, device, seed=seq, agrees=_decode_agrees)
    res.update(seq=seq, layers=attn_layers(pair["cfg"]))
    res.pop("logits")
    del pair
    gc.collect()
    if device == "cuda":
        torch.cuda.empty_cache()
    if not res["kernel_ok"]:
        raise PhaseError(f"mesh: S {seq}: flash_decode on layer 0's inputs "
                         f"differs from its plain version by "
                         f"{res['kernel_err']:.3e}")
    return res


def mesh_phase(card: str, device: str = "cuda", *, full: bool = True,
               train=MESH_TRAIN, steps: int = MESH_TRAIN_STEPS,
               decode_batch: int = MESH_DECODE_BATCH,
               decode_seqs=MESH_DECODE_SEQS,
               decode_steps: int = MESH_DECODE_STEPS) -> dict:
    """The ``mesh`` phase (MESH_* above), on the card over one NCCL rank;
    ``device="cpu"`` (the rehearsal) over one gloo rank, the model
    reduced, without the dry run's memory comparison (no device memory to
    measure). Returns the measurements; raises PhaseError on any failed
    check."""
    import dataclasses as dc

    import torch.distributed as dist

    from repro_torch.configs import get_arch
    from repro_torch.launch import mesh_cases
    from repro_torch.launch.mesh import make_production_mesh
    from repro_torch.launch.sharding import ShardingRules

    on_card = device == "cuda"
    t_phase = time.perf_counter()
    b, seq = train
    out_dir = os.path.join(MESH_OUT, "dryrun")
    dry = subprocess.Popen(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
         TRAIN_ARCH, "--shape", "train_4k", "--batch", str(b), "--seq",
         str(seq), "--mesh", "1x1", "--out", out_dir],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        env=dict(os.environ, PYTHONPATH=SRC_DIR)) if on_card else None
    dist.init_process_group("nccl" if on_card else "gloo",
                            init_method=f"tcp://localhost:{_free_port()}",
                            world_size=1, rank=0)
    try:
        spec = get_arch(TRAIN_ARCH)
        if not full:
            spec = dc.replace(spec, config=spec.config.reduced())
        data = mesh_cases.batches(spec.config.vocab_size, b, seq, steps)
        gc.collect()
        if on_card:
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
            base = torch.cuda.memory_allocated()
        with deterministic(True):
            pair = mesh_cases.mesh_pair(
                TRAIN_ARCH, data=1, model=1, batch=b, seq=seq,
                reduced=not full, device=device, steps=steps)
            t0 = time.perf_counter()
            state, losses = mesh_cases.run_steps(
                pair["fn"], pair["args"][0], data, pair["in_shardings"][1],
                device)
            if on_card:
                torch.cuda.synchronize()
            mesh_s = time.perf_counter() - t0
        peak = ((torch.cuda.max_memory_allocated() - base) / 2**30
                if on_card else None)
        meta = {k: pair[k] for k in ("cfg", "opt_cfg")}
        placed = (str(tuple(state.params["embed"].placements)),
                  pair["rules"].policy, pair["cfg"].param_dtype)
        del state, pair
        gc.collect()
        if on_card:
            torch.cuda.empty_cache()
        with deterministic(True):
            fn, plain = mesh_cases.plain_pair(meta, device=device)
            _, plain_losses = mesh_cases.run_steps(fn, plain, data,
                                                   device=device)
        del plain
        gc.collect()
        worst = max(abs(a - w) / abs(w) for a, w in zip(losses,
                                                        plain_losses))
        if not all(math.isfinite(x) for x in losses) \
                or worst > MESH_LOSS_RTOL:
            raise PhaseError(f"mesh: the 1x1 mesh's losses {losses} differ "
                             f"from the plain step's {plain_losses} beyond "
                             f"rtol {MESH_LOSS_RTOL:g}")
        dry_rec = ratio = dry_peak = None
        if on_card:
            torch.cuda.empty_cache()
            _, derr = dry.communicate(timeout=600)
            if dry.returncode != 0:
                raise PhaseError(f"mesh: the dry run failed:\n"
                                 f"{derr[-2000:]}")
            path = os.path.join(out_dir, f"1x1_{TRAIN_ARCH}_train_4k@b{b}"
                                         f"s{seq}.json")
            with open(path) as f:
                dry_rec = json.load(f)
            dry_peak = dry_rec["peak_memory_per_device"] / 2**30
            ratio = dry_peak / peak
            if not MESH_PEAK_BAND[0] <= ratio <= MESH_PEAK_BAND[1]:
                raise PhaseError(f"mesh: the dry run's peak {dry_peak:.2f} "
                                 f"GiB is {ratio:.3f}x the measured "
                                 f"{peak:.2f} GiB, outside {MESH_PEAK_BAND}")
        rules = ShardingRules(make_production_mesh(data=1, model=1))
        decodes = [mesh_decode(rules, spec, s, device, batch=decode_batch,
                               steps=decode_steps) for s in decode_seqs]
    finally:
        dist.destroy_process_group()
        if dry is not None and dry.poll() is None:
            dry.kill()
            dry.wait()
    want_kv = {32768: "int8", 4096: "bfloat16"} if full else {}
    for d in decodes:
        if d["kv"] != want_kv.get(d["seq"], d["kv"]) \
                or d["cdt"] != "bfloat16":
            raise PhaseError(f"mesh: S {d['seq']} ran a {d['kv']} cache in "
                             f"{d['cdt']}")
        if d["launches"] != d["layers"] * decode_steps or not d["finite"]:
            raise PhaseError(f"mesh: S {d['seq']}: {d['launches']} "
                             f"flash_decode launches, expected "
                             f"{d['layers']} × {decode_steps}")
        if d["rel"] > MESH_LOGIT_TOL:
            raise PhaseError(f"mesh: S {d['seq']}: backend cuda's logits "
                             f"differ from backend torch's by {d['rel']:.3e} "
                             f"of max|logit|, past {MESH_LOGIT_TOL:g}")
    res = dict(losses=losses, plain_losses=plain_losses, worst=worst,
               peak=peak, dry_peak=dry_peak, ratio=ratio, mesh_s=mesh_s,
               placed=placed, decodes=decodes,
               launches=sum(d["launches"] for d in decodes),
               secs=time.perf_counter() - t_phase)
    mem = ("not measured (CPU)" if peak is None else
           f"peak {peak:.3f} GiB measured, dry run {dry_peak:.3f} GiB "
           f"(ratio {ratio:.3f}, band {MESH_PEAK_BAND}; dry run traced in "
           f"{dry_rec['trace_s']} s)")
    size = "full width and depth" if full else "reduced"
    print(f"mesh [{card}] train {TRAIN_ARCH} ({size}; embed placements, "
          f"policy, dtype {placed}; "
          f"1x1 mesh over one rank): {steps} steps at B {b} x S {seq} in "
          f"{mesh_s:.2f} s, losses {losses} vs plain {plain_losses} (max "
          f"rel diff {worst:.3e}, "
          f"{'bit-equal' if losses == plain_losses else 'not bit-equal'}); "
          f"{mem}", flush=True)
    for d in decodes:
        print(f"mesh [{card}] decode S {d['seq']} ({d['kv']} cache, "
              f"{d['cache_gb']:.3f} GB) B {decode_batch}: {decode_steps} "
              f"steps, {d['step_ms']:.2f} ms a step (host clock, backend "
              f"cuda), flash_decode launches {d['launches']} = "
              f"{d['layers']} layers × {decode_steps}, cuda vs torch max "
              f"|dlogit| {d['rel']:.3e} of max|logit| {d['scale']:.3f} "
              f"(tolerance {MESH_LOGIT_TOL:g}); flash_decode on layer 0's "
              f"inputs vs its plain version max abs err "
              f"{d['kernel_err']:.3e}", flush=True)
    print(f"mesh phase: pass ({res['secs']:.1f} s)", flush=True)
    return res


# ------------------------------------------------------------------ tools
def kernel_bench_rows(device: str, fast: bool) -> list[dict]:
    """(b) `repro_torch.bench.kernel_bench` at its CASES, one case a run
    with the launch counts zeroed just before it. On the card each case
    is first held to its plain version (the f32 tolerance, two launches
    bit for bit; those launches do not count) and its row carries the
    kernels line's keys, and `reference_bound_us`: kernel_bench's own
    `h100_bound_us`, from the reference's formulas (the full Gram, where
    `bound_ms` counts its upper triangle); on the CPU the bench times the
    plain version."""
    from repro_torch.bench import kernel_bench
    from repro_torch.kernels import ops
    from repro_torch.kernels.ref import rff_gram_ref

    on_card = device == "cuda"
    rows = []
    for case in kernel_bench.CASES[:1] if fast else kernel_bench.CASES:
        f, dim, n = case
        om, bi, x, y = kernel_bench.operands(*case, device)
        scale = math.sqrt(2.0 / f)
        err = None
        if on_card:
            first = ops.rff_gram(om, bi, x, y, scale=scale)
            second = ops.rff_gram(om, bi, x, y, scale=scale)
            want = rff_gram_ref(om, bi, x, y, scale=scale)
            if not all(torch.equal(a, b) for a, b in zip(first, second)):
                raise PhaseError(f"tools (b) rff_gram at {case}: two "
                                 f"launches differ")
            err = max(compare(f"tools (b) rff_gram {part} at {case}", got,
                              w, torch.float32)
                      for part, got, w in zip(("G", "zy"), first, want))
            torch.cuda.synchronize()
        ops.reset_launch_counts()
        row = kernel_bench.run(fast=fast, device=device,
                               cases=[case])["rows"][0]
        launches = ops.launch_counts()["rff_gram"]
        if on_card and launches == 0:
            raise PhaseError(f"tools (b): the kernel bench never launched "
                             f"rff_gram at {case}")
        # the projection and the Gram's upper triangle; each operand read
        # once, G and zy written once
        bms, by = bound_ms(nbytes(om, bi, x, y) + (f * f + f) * 4,
                           2 * f * dim * n + f * (f + 1) * n, torch.float32)
        rows.append(dict(
            name="rff_gram@kernel_bench", route="cuda",
            source="src/repro_torch/kernels/csrc/rff_gram.cu",
            replaces="src/repro/kernels/rff_gram.py:70", shape=list(case),
            launches=launches, max_abs_err=err, ms=row["ms"],
            plain_ms=row["plain_ms"], bound_ms=bms, bound_by=by,
            library_ms=row["library_ms"],
            reference_bound_us=row["h100_bound_us"]))
    return rows


def readout_features(device: str, num_seqs: int, seq: int) -> dict:
    """(e) The readout example on ``device`` from CPU draws of the
    backbone's weights and tokens (seeds 0 and 1, as the example's)."""
    from repro_torch.configs import get_arch
    from repro_torch.examples import decentralized_readout
    from repro_torch.models.model import init_params

    cfg = get_arch("smollm_135m").config.reduced()
    params = init_params(cfg, torch.Generator().manual_seed(0))
    tokens = torch.randint(0, cfg.vocab_size, (num_seqs, seq),
                           generator=torch.Generator().manual_seed(1))
    params = {k: ({n: t.to(device) for n, t in v.items()}
                  if isinstance(v, dict) else v.to(device))
              for k, v in params.items()}
    return decentralized_readout.run(device=device, params=params,
                                     tokens=tokens)


def tools_phase(card: str, device: str = "cuda", *,
                subsample: int | None = None, fast: bool = False,
                readout=TOOLS_READOUT) -> dict:
    """The ``tools`` phase: (a) the accel bench (houses at ``subsample``
    samples, None: full N), its dispatches on every backend against the
    contract, cuda_fused θ == cuda θ bit for bit and the path's launches;
    (b) the kernel bench (`kernel_bench_rows`); (c) the analysis bench,
    clean; (d) the quickstart on ``device`` against the CPU from one set
    of CPU draws (rtol 1e-9); (e) the readout's pooled features against
    the CPU's (1e-5 of max|·|); (f) on the card, the perf probe in a
    subprocess on the mesh phase's pair (started after (c): its trace
    loads the host), its totals against the dry-run
    record the mesh phase wrote, and make_report's row of that pair.
    Raises PhaseError on any failed check."""
    from repro_torch.bench import accel_bench, analysis_bench
    from repro_torch.examples import quickstart
    from repro_torch.experiments import make_report
    from repro_torch.kernels import ops
    from repro_torch.obs.dispatch import round_dispatches

    on_card = device == "cuda"
    t_phase = time.perf_counter()
    dry_dir = os.path.join(MESH_OUT, "dryrun")
    b, seq = MESH_TRAIN
    shape = f"train_4k@b{b}s{seq}"
    probe_json = os.path.join(MESH_OUT, "probe.json")
    probe, out = None, {}
    try:
        before = route_counts()
        acc, acc_s, acc_launches = _launched(lambda: accel_bench.run(
            fast=fast, device=device, subsample=subsample))
        out["accel_routes"] = route_counts(before)
        iters = acc["solve_us"]["num_iters"]
        for backend, counts in acc["round_dispatches"].items():
            want = round_dispatches(backend, iters)
            if set(counts.values()) != {want}:
                raise PhaseError(f"tools (a): {backend} dispatches {counts}"
                                 f", the contract is {want}")
        if acc["theta_max_abs_diff_vs_cuda"]["cuda_fused"] != 0.0:
            raise PhaseError(f"tools (a): cuda_fused θ ≠ cuda θ: "
                             f"{acc['theta_max_abs_diff_vs_cuda']}")
        if on_card and not all(acc_launches[k]
                               for k in TOOLS_ACCEL_LAUNCHES):
            raise PhaseError(f"tools (a): a kernel of the accel path never "
                             f"launched: {acc_launches}")
        out.update(accel=acc, accel_s=acc_s, accel_launches=acc_launches)
        out["kernel_rows"] = kernel_bench_rows(device, fast)
        out["analysis"] = analysis_bench.run()

        # (f)'s trace loads the host: it starts once (a)-(c) are timed
        if on_card:
            probe = subprocess.Popen(
                [sys.executable, "-m", "repro_torch.experiments.perf_probe",
                 "--arch", TRAIN_ARCH, "--shape", "train_4k", "--mesh",
                 "1x1", "--batch", str(b), "--seq", str(seq),
                 "--json-out", probe_json],
                stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
                env=dict(os.environ, PYTHONPATH=SRC_DIR))
        fmaps, dkla_fmap = quickstart.draw_maps("cpu")
        qs_cpu = quickstart.run("cpu", fmaps=fmaps, dkla_fmap=dkla_fmap)
        qs = (quickstart.run(device, fmaps=fmaps, dkla_fmap=dkla_fmap)
              if on_card else qs_cpu)
        for key, want in qs_cpu.items():
            if not math.isclose(qs[key], want, rel_tol=TOOLS_RTOL):
                raise PhaseError(f"tools (d): quickstart {key} {qs[key]!r} "
                                 f"on {device}, {want!r} on the CPU")
        out["quickstart"] = (qs, qs_cpu)

        ro = readout_features(device, *readout)
        ro_cpu = readout_features("cpu", *readout) if on_card else ro
        scale = ro_cpu["feats"].abs().max().item()
        feat_err = (ro["feats"].cpu() - ro_cpu["feats"]).abs().max().item()
        if not feat_err <= TOOLS_FEATURE_TOL * scale:
            raise PhaseError(f"tools (e): pooled features differ from the "
                             f"CPU's by {feat_err:.3e}, past "
                             f"{TOOLS_FEATURE_TOL:g} of {scale:.3e}")
        out["readout"] = dict(card=ro, cpu=ro_cpu, err=feat_err,
                              scale=scale, shape=readout)

        if on_card:
            _, perr = probe.communicate(timeout=600)
            if probe.returncode != 0:
                raise PhaseError(f"tools (f): the perf probe failed:\n"
                                 f"{perr[-2000:]}")
            with open(probe_json) as f:
                got = json.load(f)
            with open(os.path.join(dry_dir, f"1x1_{TRAIN_ARCH}_{shape}"
                                            f".json")) as f:
                rec = json.load(f)
            want = {"peak": rec["peak_memory_per_device"],
                    "flops": rec["flops_per_device"],
                    "hbm": rec["bytes_per_device"],
                    "coll": rec["collective_bytes_per_device"]}
            if got != want:
                raise PhaseError(f"tools (f): the probe's totals {got} "
                                 f"differ from the dry run's {want}")
            text = io.StringIO()
            with contextlib.redirect_stdout(text):
                make_report.table("1x1", dry_dir)
            row = [line for line in text.getvalue().splitlines()
                   if line.startswith(f"| {TRAIN_ARCH} | {shape} | run |")]
            if len(row) != 1:
                raise PhaseError(f"tools (f): make_report has no row of "
                                 f"{TRAIN_ARCH} × {shape}")
            out.update(probe=got, report_row=row[0])
    finally:
        if probe is not None and probe.poll() is None:
            probe.kill()
            probe.wait()
    out["secs"] = time.perf_counter() - t_phase
    return out


def print_tools_phase(t: dict, card: str) -> None:
    acc = t["accel"]
    print(f"tools [{card}] (a) accel {acc['dataset']} N={acc['n_train']} "
          f"(d_feat {acc['d_feat']}, interval "
          f"[{acc['spectral_interval'][0]:.6f}, "
          f"{acc['spectral_interval'][1]:.6f}], {acc['bytes_per_round']} "
          f"bytes a round) in {t['accel_s']:.2f} s: " + "; ".join(
              f"tol {r['tol']:g} plain {r['rounds_plain']} / Chebyshev "
              f"{r['rounds_chebyshev']} rounds ({r['speedup']}x)"
              for r in acc["rounds_to_tolerance"]))
    print(f"tools [{card}] (a) dispatches "
          f"{json.dumps(acc['round_dispatches'])}; solve µs at "
          f"{acc['solve_us']['num_iters']} rounds: " + ", ".join(
              f"{b} {acc['solve_us'][b]:.1f}" for b in
              ("torch", "cuda", "cuda_fused"))
          + f"; θ max |Δ| vs cuda "
          f"{json.dumps(acc['theta_max_abs_diff_vs_cuda'])}; launches "
          f"{json.dumps({k: v for k, v in t['accel_launches'].items() if v})}"
          f"; chain routes {json.dumps(t['accel_routes'])}")
    for r in t["kernel_rows"]:
        timed = ("plain only (CPU)" if r["ms"] is None else
                 f"{r['ms']:.4f} ms, plain {r['plain_ms']:.4f} ms, "
                 f"yardstick {r['library_ms']:.4f} ms, bound "
                 f"{r['bound_ms']:.4f} ms ({r['bound_by']}), max abs err "
                 f"{r['max_abs_err']:.3e}, {r['launches']} launches")
        print(f"tools [{card}] (b) kernel_bench rff_gram (F, d, N)="
              f"{tuple(r['shape'])} f32: {timed}; kernel_bench's "
              f"h100_bound_us (the full 2F²N Gram) "
              f"{r['reference_bound_us']:.1f}"
              + ("" if r["ms"] is not None else
                 f", plain {r['plain_ms']:.4f} ms"))
    print(f"tools [{card}] (c) analysis clean: " + ", ".join(
        f"{k} {v['seconds']:.2f} s" for k, v in t["analysis"].items()))
    qs, qs_cpu = t["quickstart"]
    print(f"tools [{card}] (d) quickstart: DeKRR-DDRF RSE {qs['rse']!r}, "
          f"limit point {qs['limit_rse']!r}, spectral radius "
          f"{qs['rho']!r}, DKLA RSE {qs['dkla_rse']!r} (CPU: "
          f"{json.dumps(qs_cpu)}; rtol {TOOLS_RTOL:g})")
    ro = t["readout"]
    print(f"tools [{card}] (e) readout (smollm-135m reduced, "
          f"{ro['shape'][0]} × {ro['shape'][1]} tokens): pooled "
          f"features max |card − CPU| {ro['err']:.3e} of max "
          f"{ro['scale']:.3e}; on the device's own draws of w_true, the "
          f"noise and the DDRF pools: readout RSE {ro['card']['rse']:.4f}, "
          f"node 9 local-only {ro['card']['local_rse']:.3f} → consensus "
          f"{ro['card']['consensus_rse']:.3f} (the CPU's draws: "
          f"{ro['cpu']['rse']:.4f}, {ro['cpu']['local_rse']:.3f} → "
          f"{ro['cpu']['consensus_rse']:.3f})")
    if "probe" in t:
        p = t["probe"]
        print(f"tools [{card}] (f) perf probe {TRAIN_ARCH} × train_4k at "
              f"1x1, B {MESH_TRAIN[0]} × S {MESH_TRAIN[1]}: peak "
              f"{p['peak'] / 2**30:.3f} GiB, {p['flops']:.4e} flops, "
              f"{p['hbm']:.4e} bytes (unfused), collectives "
              f"{json.dumps(p['coll'])} == the dry run's record; "
              f"make_report: {t['report_row']}")
    print(f"tools phase: pass ({t['secs']:.1f} s)", flush=True)


# ------------------------------------------------------------------- main
def package_missing(src: str) -> bool:
    """True, after one line on stderr naming where it looked, when the
    port's package is not under ``src``: the script drives the package of
    the checkout it lies in, so a copy of it alone cannot run."""
    path = os.path.join(src, "repro_torch", "__init__.py")
    if os.path.isfile(path):
        return False
    print(f"chip_smoke: the port's package is not at {path}; run this "
          f"script from a checkout of the repository, with src/repro_torch "
          f"beside it", file=sys.stderr)
    return True


def _llm_config():
    from repro_torch.configs import get_arch
    return get_arch(LLM_ARCH).config


def rehearse_on_cpu() -> int:
    """The main, async, Chebyshev, serving, LLM serving, mixers, train
    and paper paths on the CPU at a small size (plain kernel versions;
    the LLM and train paths on qwen1.5-0.5b's reduced configuration; the
    paper's Table 2 on its first two datasets)."""
    run = main_path("cpu", subsample=2000, d_per_node=12, num_iters=200)
    checks = check_main_path(run)
    a = async_path(run, rounds=300)
    a_checks = check_async_path(a, run, checks)
    c = cheb_path(run, checks)
    c_checks = check_cheb_path(c, run, checks)
    sp = spmd_phase(run, a, device="cpu", split_rounds=20)
    sp_checks = check_spmd_phase(sp, run, a)
    print_spmd_phase(sp, sp_checks, run, "cpu")
    sv = serve_path(run, queries=128)
    sv_checks = check_serve_path(sv, run, on_card=False)
    llm_cfg = _llm_config().reduced()
    llm = llm_path("cpu", llm_cfg, requests=6, batch=4, max_seq=64,
                   prompt=(4, 16), new_tokens=8)
    check_llm_path(llm, llm_cfg, on_card=False)
    bf = bf16_step_phase("cpu", "cpu", full=False, batch=2, max_seq=64)
    mx = mixers_phase("cpu", "cpu", full=False, requests=4, batch=2,
                      max_seq=MIXER_REHEARSAL_WINDOW, prompt=(3, 8),
                      new_tokens=4, forward=(2, 6))
    tr = train_phase("cpu", "cpu", full=False, steps=3, moe_steps=0)
    mesh = mesh_phase("cpu", "cpu", full=False, train=(4, 32), steps=2,
                      decode_batch=2, decode_seqs=(64,), decode_steps=3)
    pp = paper_phase("cpu", subsample=600, fast=True, gram=(2000, 12))
    print_paper_phase(pp, "cpu")
    st = stream_phase(run, epochs=2, ingest=(8, 32),
                      refreshes=((1, 12), (2, 16)), async_rounds=50,
                      queries=64, publishes=3, threaded=32, reps=2)
    check_stream_launches(st, on_card=False)
    print_stream_phase(st, "cpu")
    b = bench_phase(run, a, c, fast=True, serve_counts=(64, 32, 2),
                    out_dir=os.path.join(BENCH_OUT, "cpu"))
    print_bench_phase(b, "cpu")
    tl = tools_phase("cpu", "cpu", subsample=300, fast=True,
                     readout=(128, 16))
    print_tools_phase(tl, "cpu")
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
                   bf16_decode=dict(rel=bf["rel"], launches=bf["launches"]),
                   mixer_steps={k: r["steps"] for k, r in mx.items()},
                   mixer_forward_err={k: r["forward_err"]
                                      for k, r in mx.items()},
                   train_losses=[h["loss"] for h in tr["run"]["history"]],
                   train_cpu_loss=tr["cmp"]["loss"],
                   mesh_losses=mesh["losses"],
                   mesh_decode=[(d["seq"], d["launches"], d["rel"])
                                for d in mesh["decodes"]],
                   paper_rows=[r[:5] for r in pp["rows"]],
                   paper_krr_rse=pp["krr"]["rse"],
                   stream_rounds=[(e["warm_rounds"], e["cold_rounds"])
                                  for e in st["epochs"]],
                   stream_replay_err=st["replay_err"],
                   stream_serve_err=st["serve_err"],
                   bench_dispatch=[(r["path"], r["backend"], r["chunk"],
                                    r["dispatches"]) for r in b["dispatch"]],
                   tools_ladder=[(r["tol"], r["rounds_plain"],
                                  r["rounds_chebyshev"]) for r in
                                 tl["accel"]["rounds_to_tolerance"]],
                   tools_quickstart=tl["quickstart"][0],
                   spmd_wire=sp_checks["wire"],
                   spmd_launches=sp_checks["launches"])
    print(json.dumps({"cpu_rehearsal": summary}))
    return 0


def run_on_card() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available (torch.cuda."
              "is_available() is False); this script runs only on the card",
              file=sys.stderr)
        return 2
    t_start = time.perf_counter()
    # before the first cuBLAS call: the train phase's deterministic mode
    # checks it (PyTorch reads it once)
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", CUBLAS_DETERMINISTIC)
    card = card_line()
    name, count = torch.cuda.get_device_name(0), torch.cuda.device_count()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(f"card: {card} | torch {torch.__version__} cuda "
          f"{torch.version.cuda} | {name} x{count}")
    print(f"allow_tf32: matmul={torch.backends.cuda.matmul.allow_tf32} "
          f"cudnn={torch.backends.cudnn.allow_tf32}", flush=True)

    from repro_torch.kernels import _build
    from repro_torch.kernels.decode_attention import decode_plan
    from repro_torch.kernels.dekrr_solve import (async_plan, chain_max_clusters,
                                                 chain_plan, cheb_plan,
                                                 solve_plan)
    from repro_torch.kernels.rff_gram import card_plan, gram_plan
    t0 = time.perf_counter()
    reports = _build.build_all()
    print(f"build: {time.perf_counter() - t0:.1f} s "
          f"(sources {_build.source_hash()})")
    for src, text in reports.items():
        print(f"--- ptxas {src} ---\n{text.strip()}")
    for src in ("rff_gram", "rff_features", "dekrr_step", "dekrr_solve",
                "dekrr_async_solve", "dekrr_cheb_solve", "flash_decode"):
        for line in ptxas_summary(reports[src]):
            print(f"ptxas {src}: {line}")
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    for rows_, s_ in ((LLM_BATCH * 16, LLM_MAX_SEQ), (16, DECODE_LONG[-1])):
        plan = decode_plan(rows_, 1, 64, 2)
        print(f"flash_decode bf16 plan at {rows_} rows, S {s_}: {plan}; "
              f"{plan.blocks(s_)} blocks, {plan.waves(s_, sms):.2f} waves of "
              f"{plan.blocks_per_sm} a SM, merge window {plan.merge_window} "
              f"chunks")
    print(f"rff_gram plan at B = {J_NODES}, {4 * J_NODES}: " + "; ".join(
        str(gram_plan(b, D_PER_NODE, 148, 3180, sms=sms))
        for b in (J_NODES, 4 * J_NODES)))
    print(f"rff_gram plan at (B, F, d, N) = {GRAM_WIDE_TIMING}: "
          f"{gram_plan(*GRAM_WIDE_TIMING, sms=sms)}")
    for shape in GRAM_F32_PLANS:
        print(f"rff_gram f32 plan at (B, F, d, N) = {shape}: "
              f"{card_plan(*shape, torch.float32, torch.device('cuda'))}")
    for src in ("dekrr_solve", "dekrr_async_solve", "dekrr_cheb_solve"):
        fits = chain_max_clusters(src, 4, D_PER_NODE, 1, torch.float64)
        print(f"chain_plan {src} f64 (C, rows per block, clusters) at K = 4, "
              f"D = {D_PER_NODE}: " + "; ".join(
                  f"J = {j}: {chain_plan(j, D_PER_NODE, fits)}"
                  for j in (J_NODES, J_LOOPED)))
    for j in (J_NODES, J_LOOPED):
        offsets = torch.tensor([1, -1, 2, -2])
        nbr = (torch.arange(j)[:, None] + offsets) % j
        ones = torch.ones((j, 4))
        for src, plan in (
                ("dekrr_solve", solve_plan(nbr, torch.arange(j), ones,
                                           d_feat=D_PER_NODE, dy=1,
                                           dtype=torch.float64,
                                           rounds=CHUNK)),
                ("dekrr_async_solve", async_plan(
                    nbr, ones, d_feat=D_PER_NODE, dy=1, dtype=torch.float64,
                    rounds=ASYNC_ROUNDS)),
                ("dekrr_cheb_solve", cheb_plan(
                    nbr, torch.arange(j), ones, d_feat=D_PER_NODE, dy=1,
                    dtype=torch.float64, rounds=CHUNK))):
            print(f"route plan {src} f64 at J = {j}, K = 4, D = "
                  f"{D_PER_NODE}: {plan.route}, {plan.blocks} blocks of "
                  f"{plan.rows} rows, {plan.clusters} clusters, "
                  f"{plan.threads} threads, {plan.smem_bytes} B"
                  + (f"; wait sets {plan.waits[:2]}…" if plan.waits
                     else f" ({plan.why})"))

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
    print(f"main path solve (cuda_fused) routes: {json.dumps(run['routes'])}")
    if not run["routes"].get("dekrr_solve@resident"):
        raise PhaseError(f"the main path's solve did not launch the resident "
                         f"route of dekrr_solve: {run['routes']}")
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
    print(f"async path (cuda_fused) routes: {json.dumps(a['fused_routes'])}")
    if not a["fused_routes"].get("dekrr_async_solve@resident"):
        raise PhaseError(f"the async path did not launch the resident route "
                         f"of dekrr_async_solve: {a['fused_routes']}")

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
    print(f"chebyshev path (cuda_fused) routes: "
          f"{json.dumps(c['fused_routes'])}")

    sp = spmd_phase(run, a, device="cuda:0")
    sp_checks = check_spmd_phase(sp, run, a)
    print_spmd_phase(sp, sp_checks, run, card)

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
    llm.pop("engine")
    gc.collect()
    torch.cuda.empty_cache()
    bf = bf16_step_phase(card)
    print(f"LLM decode step on the device [{card}], f32 beside bf16 (CUDA "
          f"graph replay): {device_ms:.3f} / {bf['serving_ms']:.3f} ms at "
          f"the serving cache (cur={step_pos + 1}), {long_ms:.3f} / "
          f"{bf['long_ms']:.3f} ms at one long request", flush=True)
    mx = mixers_phase("cuda", card, full=True, requests=LLM_REQUESTS,
                      batch=LLM_BATCH, max_seq=LLM_MAX_SEQ)
    gc.collect()
    torch.cuda.empty_cache()
    tr = train_phase("cuda", card, full=True, steps=TRAIN_STEPS,
                     moe_steps=TRAIN_MOE_STEPS)
    gc.collect()
    torch.cuda.empty_cache()
    mesh = mesh_phase(card)

    pp = paper_phase("cuda", subsample=None, fast=False,
                     gram=(None, PAPER_DBAR_WAVE))
    print_paper_phase(pp, card)
    errs["rff_gram@gram_fn"] = pp["gram"]["gram_err"]

    st = stream_phase(run, epochs=STREAM_EPOCHS, ingest=STREAM_INGEST,
                      refreshes=STREAM_REFRESHES,
                      async_rounds=STREAM_ASYNC_ROUNDS,
                      queries=SERVE_QUERIES, publishes=STREAM_PUBLISHES,
                      threaded=STREAM_THREADED, reps=10)
    check_stream_launches(st, on_card=True)
    print_stream_phase(st, card)

    b = bench_phase(run, a, c, fast=False, serve_counts=BENCH_SERVE,
                    out_dir=BENCH_OUT)
    print_bench_phase(b, card)
    tools = tools_phase(card)
    print_tools_phase(tools, card)

    launches = dict(run["launches"], dekrr_step_masked=a_launches[
        "dekrr_step_masked"], dekrr_async_solve=a_launches[
        "dekrr_async_solve"], dekrr_cheb_solve=c_launches["dekrr_cheb_solve"],
        flash_decode=llm["launches"]["flash_decode"], **serve_launches)
    launches["flash_decode@bf16"] = mesh["launches"] + bf["launches"]
    launches["rff_gram@gram_fn"] = pp["gram"]["launches"]["rff_gram"]
    for k in ("dekrr_step", "dekrr_step_masked"):
        launches[f"{k}@spmd"] = sp_checks["launches"][k]
    rows = timings(run["packed"], run) + chain_timings(run, a, c) \
        + feature_timings(run) + decode_timings() \
        + [gram_fn_timing(pp["gram"])] + spmd_step_timings(run, errs) \
        + [decode_dh128_row(mx["deepseek_moe_16b"]["launches"][
            "flash_decode"])]
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
    decode = [r for r in rows
              if r.get("kernel") in ("flash_decode", "flash_decode@bf16")]
    serving = {r["name"]: r.pop("serving") for r in decode
               if "serving" in r}
    for r in decode:
        sdpa = r.pop("sdpa")
        print(f"time [{card}] {r['name']} yardstick at (B, H, K, dh, S, "
              f"cur)={tuple(r['shape'])}: the fastest SDPA call on the same "
              f"inputs is {sdpa['call']} at {sdpa['ms']:.4f} ms; every "
              f"backend that agreed (ms): {json.dumps(sdpa['table'])}; "
              f"kernels of the default dispatch: "
              f"{json.dumps(sdpa['default'])}")
    for row_name, served in serving.items():
        print(f"time [{card}] {row_name} at the serving cache (B={LLM_BATCH}, "
              f"H=K=16, dh=64, S={LLM_MAX_SEQ}; warm: one cache launched "
              f"again, cold: {DECODE_COLD_CACHES} caches launched in turn): "
              + "; ".join(
                  f"cur={cur}: warm {d['warm_ms']:.4f} ms, cold "
                  f"{d['cold_ms']:.4f} ms (bound {d['bound_ms']:.4f} ms; the "
                  f"fastest SDPA call, warm, {d['sdpa']['call']} "
                  f"{d['sdpa']['ms']:.4f} ms, cold {d['sdpa_cold_ms']:.4f} "
                  f"ms, every backend that agreed (ms): "
                  f"{json.dumps(d['sdpa']['table'])})"
                  for cur, d in served.items()))
    dh128 = rows[-1]
    for cur, d in dh128.pop("per_cur").items():
        print(f"time [{card}] flash_decode at deepseek-moe-16b's heads "
              f"(B={DECODE_DH128[0]}, H=K=16, dh=128, S={DECODE_DH128[-1]}, "
              f"warm) cur={cur}: {d['ms']:.4f} ms, split plain version "
              f"{d['plain_ms']:.4f} ms, bound {d['bound_ms']:.4f} ms "
              f"({d['bound_by']}); the fastest SDPA call on the same inputs "
              f"{d['sdpa']['call']} {d['sdpa']['ms']:.4f} ms, every backend "
              f"that agreed (ms): {json.dumps(d['sdpa']['table'])}")
    errs[dh128["name"]] = dh128["max_abs_err"]
    launches[dh128["name"]] = dh128["launches"]
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
    rows += tools["kernel_rows"]
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
    ap.add_argument("--gram-timings", action="store_true",
                    help="time only rff_gram at PERF.md's rows 3-3‴ on "
                         "the card")
    ap.add_argument("--features-timings", action="store_true",
                    help="time only rff_features at PERF.md's rows 7 on "
                         "the card")
    ap.add_argument("--chain-timings", action="store_true",
                    help="time only the round kernel and the three chains "
                         "at PERF.md's rows 1, 2 and 4-6 on the card")
    ap.add_argument("--src", help="with --decode-timings, --gram-timings, "
                    "--features-timings or --chain-timings: the directory "
                    "that holds the repro_torch package to time")
    args = ap.parse_args(argv)
    if package_missing(SRC_DIR if args.src is None
                       else os.path.abspath(args.src)):
        return 3
    try:
        if args.decode_timings:
            return decode_timings_only(args.src)
        if args.gram_timings:
            return gram_timings_only(args.src)
        if args.features_timings:
            return features_timings_only(args.src)
        if args.chain_timings:
            return chain_timings_only(args.src)
        return rehearse_on_cpu() if args.cpu_rehearsal else run_on_card()
    except PhaseError as exc:
        print(f"chip_smoke: FAILED: {exc}", file=sys.stderr)
        return 1


if __name__ == "__main__":
    sys.exit(main())
