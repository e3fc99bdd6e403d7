"""The reference's system benchmarks (`benchmarks/*_bench.py`) as drivers
of the port, and their runner (`python -m repro_torch.bench.run`).

* step_kernel_bench.py  — one Eq. 19 round: the round kernel against the
                          batched matmul round, beside the H100 bound
* solve_bench.py        — whole solves on torch | cuda | cuda_fused, each
                          with its kernel dispatches against the contract
* async_gossip_bench.py — accuracy against bytes on the wire, six
                          activation/censoring schedules
* chebyshev_bench.py    — rounds to 1e-6, plain against Chebyshev
* multiout_bench.py     — the fused Dy-output solve against Dy scalar ones
* serve_bench.py        — closed-loop capacity and a Poisson open-loop
                          frontier per precision, every low-precision
                          answer within its attached bound
* stream_bench.py       — the streaming runtime (ingest, refresh, warm
                          solves, serving from a live stream)
* accel_bench.py        — rounds and bytes to each tolerance, plain
                          against Chebyshev; the fused chains' dispatches
* kernel_bench.py       — `rff_gram` at the reference's CASES beside the
                          H100 bound and the shared-memory budget
* analysis_bench.py     — the static checks' passes, timed
* roofline.py           — the dry run's roofline table
* common.py             — device sync, host timing, the H100 peaks, JSON
* run.py                — the runner: every suite in a span of one
                          registry, JSONL and bench JSON with provenance

Each runs on the CUDA card unless the caller names another device,
prints the reference's CSV rows, and writes its JSON only to a path it
is given (the runner's ``--out-dir``, ``build/bench/`` by default).
"""
