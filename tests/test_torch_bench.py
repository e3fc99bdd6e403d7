"""The port's system benchmarks (`repro_torch.bench`) against the
reference's `benchmarks/` on the reference's own draws: the multi-output
θ and the asynchronous-gossip rows' wire counts at rtol 1e-9, and the
runner end to end on the CPU — a JSONL that `python -m repro_torch.obs`
renders, and every `BENCH_*` file of the repository left as it was."""
import glob
import hashlib
import json
import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

import repro.core as R
from conftest import REPO_ROOT, subprocess_env
from repro.dist import async_solve_batched as ref_async_solve
from repro.dist import comm_bytes_per_round as ref_comm_bytes
from repro.dist import solve_batched as ref_solve
from repro.dist.async_gossip import _packed_edges as ref_packed_edges
from repro_torch import interop
from repro_torch.bench import async_gossip_bench, multiout_bench, solve_bench
from repro_torch.bench.run import suites as run_suites
from repro_torch.bench.step_kernel_bench import synthetic_packed
from repro_torch.dist import solve_batched
from repro_torch.obs import Registry

CPU = "cpu"
TOL = dict(rtol=1e-9, atol=1e-12)


@pytest.fixture(scope="module")
def ref_bench():
    """The reference's `benchmarks/` package, imported from the
    repository root."""
    mp = pytest.MonkeyPatch()
    mp.syspath_prepend(REPO_ROOT)
    import benchmarks.async_gossip_bench as AB
    import benchmarks.multiout_bench as MB
    yield MB, AB
    mp.undo()


def port_packed(ref):
    return interop.packed_from_arrays(
        *(np.asarray(getattr(ref, k)) for k in
          ("g", "d", "s", "p", "theta_mask", "nbr_idx", "nbr_mask")),
        offsets=ref.offsets, node_dims=ref.node_dims,
        num_edges_directed=ref.num_edges_directed, device=CPU)


# --------------------------------------------------------------------------
# Multi-output: the fused Dy solve on the reference's maps and data
# --------------------------------------------------------------------------
@pytest.mark.parametrize("backend", ["torch", "cuda", "cuda_fused"])
@pytest.mark.parametrize("dy", [1, 4])
def test_multiout_theta_matches_reference(ref_bench, dy, backend):
    MB, _ = ref_bench
    j_nodes, d_feat, n, rounds = 6, 16, 40, 10
    ref_fused, _ = MB._build_packs(dy, j_nodes, d_feat, n)
    want = np.asarray(ref_solve(ref_fused, rounds, backend="xla"))
    fmaps = [interop.feature_map_from_arrays(
        np.asarray(f.omega), np.asarray(f.bias), f.kind, device=CPU)
        for f in (R.sample_rff(jax.random.PRNGKey(j), 4, d_feat,
                               MB.C.SIGMA) for j in range(j_nodes))]
    fused, scalars = multiout_bench.build_packs(dy, j_nodes, d_feat, n,
                                                fmaps=fmaps, device=CPU)
    np.testing.assert_allclose(fused.g.numpy(), np.asarray(ref_fused.g),
                               **TOL)
    got = solve_batched(fused, rounds, backend=backend)
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    row = multiout_bench.multiout_row(fused, scalars, rounds,
                                      device=torch.device(CPU), reps=1)
    np.testing.assert_allclose(row["theta"], want, **TOL)
    counts = row["backends"][backend]
    per_solve = {"torch": 0, "cuda": rounds, "cuda_fused": 1}[backend]
    assert (counts["dispatches_fused"], counts["dispatches_loop"]) == \
        (per_solve, dy * per_solve)


# --------------------------------------------------------------------------
# Async gossip: the frontier rows on the reference's problem and masks
# --------------------------------------------------------------------------
@pytest.fixture(scope="module")
def async_problem(ref_bench):
    _, AB = ref_bench
    ref = AB._build_problem(600)
    checkpoints = (10, 25)
    star = ref_solve(ref, 2 * checkpoints[-1] + 1000)
    return ref, port_packed(ref), star, checkpoints


def _schedule_fields(config):
    return (config.prob, config.gossip, config.censor_tau,
            config.censor_decay)


@pytest.mark.parametrize("label", [s[0] for s in
                                   async_gossip_bench.SCHEDULES])
def test_async_rows_match_reference(ref_bench, async_problem, label):
    _, AB = ref_bench
    ref, packed, star, checkpoints = async_problem
    ref_config = dict(AB.SCHEDULES)[label]
    config = dict(async_gossip_bench.SCHEDULES)[label]
    assert _schedule_fields(ref_config) == _schedule_fields(config)
    edges = ref_packed_edges(ref) if ref_config.gossip == "edge" else None
    masks = torch.as_tensor(np.array(R.activation_masks(
        AB.KEY, checkpoints[-1], ref.num_nodes, prob=ref_config.prob,
        gossip=ref_config.gossip, edges=edges)))
    registry = Registry()
    rows = async_gossip_bench.schedule_frontier(
        packed, config, masks, torch.as_tensor(np.array(star)),
        checkpoints, registry=registry, label=label)
    d_max = ref.max_features
    star_norm = float(np.linalg.norm(np.asarray(star)))
    for row, rounds in zip(rows, checkpoints):
        theta, stats = ref_async_solve(ref, rounds, AB.KEY,
                                       config=ref_config, return_stats=True)
        assert (row["broadcasts"], row["deliveries"]) == \
            (int(stats.broadcasts), int(stats.deliveries))
        assert row["actual_bytes"] == int(stats.deliveries) * d_max * 8
        rel_err = float(np.linalg.norm(np.asarray(theta) - np.asarray(star))
                        ) / star_norm
        np.testing.assert_allclose(row["rel_err"], rel_err, rtol=1e-9)
        expected_bytes = rounds * ref_comm_bytes(
            ref, "ppermute", activation_prob=ref_config.prob,
            censor_fraction=row["observed_censor_fraction"],
            gossip=ref_config.gossip)
        np.testing.assert_allclose(row["expected_bytes"],
                                   float(expected_bytes), rtol=1e-9)
    (event,) = registry.events
    assert event["event"] == "trace" and event["label"] == f"async/{label}"
    assert sum(event["deliveries"]) == rows[-1]["deliveries"]


# --------------------------------------------------------------------------
# The solve bench's dispatch contract
# --------------------------------------------------------------------------
def test_solve_row_counts_each_backend():
    packed = synthetic_packed(4, 8, device=CPU)
    registry = Registry()
    row = solve_bench.solve_row(packed, 12, device=torch.device(CPU),
                                reps=1, registry=registry, label="t")
    assert row["dispatches"] == row["dispatch_contract"] == \
        {"torch": 0, "cuda": 12, "cuda_fused": 1}
    assert [e["label"] for e in registry.events] == ["solve/t"]
    assert len(registry.events[0]["residuals"]) == 12


# --------------------------------------------------------------------------
# The runner end to end
# --------------------------------------------------------------------------
def _bench_files():
    out = {}
    for path in sorted(glob.glob(os.path.join(REPO_ROOT, "BENCH_*"))):
        with open(path, "rb") as f:
            out[path] = hashlib.sha256(f.read()).hexdigest()
    return out


def test_runner_writes_jsonl_the_report_renders(tmp_path):
    """Every suite, named with ``--only`` in the reference's order (the
    accel, kernel, roofline and analysis suites among them), on the CPU;
    the roofline reads a dry-run record from ``--dryrun-dir``; nothing is
    written outside ``--out-dir``."""
    # one intra-op thread: the suites are small ops, and other test workers
    # share the CPU
    env = subprocess_env(OMP_NUM_THREADS="1")
    before = _bench_files()
    assert before, "the repository's BENCH_* files are missing"
    root_entries = set(os.listdir(REPO_ROOT))
    out_dir = tmp_path / "bench"
    dryrun_dir = tmp_path / "dryrun"
    dryrun_dir.mkdir()
    (dryrun_dir / "16x16_smollm_135m_decode_32k.json").write_text(
        json.dumps({"arch": "smollm_135m", "shape": "decode_32k",
                    "status": "ok", "plan": "run", "compute_s": 1e-3,
                    "memory_s": 2e-3, "collective_s": 0.0,
                    "dominant": "memory", "peak_memory_per_device": 2**30,
                    "useful_flops_ratio": 0.5}))
    names = list(run_suites())
    assert names[8:] == ["chebyshev", "accel", "kernel", "step", "solve",
                         "async", "multiout", "stream", "serve", "roofline",
                         "analysis"]
    run = subprocess.run(
        [sys.executable, "-m", "repro_torch.bench.run", "--fast", "--device",
         "cpu", "--subsample", "300", "--out-dir", str(out_dir),
         "--only", ",".join(names), "--dryrun-dir", str(dryrun_dir)],
        cwd=REPO_ROOT, env=env, capture_output=True, text=True, timeout=600)
    assert run.returncode == 0, run.stdout[-3000:] + run.stderr[-3000:]
    assert _bench_files() == before
    new_entries = set(os.listdir(REPO_ROOT)) - root_entries
    assert not [n for n in new_entries
                if n.endswith((".json", ".jsonl", ".csv"))], new_entries
    assert "serve/open_int8_f90" in run.stdout
    for name in names:
        assert f"{name}/total," in run.stdout
    assert "roofline/smollm_135m/decode_32k,0.0,compute_ms=1.00;" \
        "memory_ms=2.00;" in run.stdout
    assert "analysis/clean,0.0,1" in run.stdout
    assert "kernel/rff_gram/D100_d8_N10000," in run.stdout
    accel = json.loads((out_dir / "accel.json").read_text())
    assert accel["provenance"]["plain"] is True
    assert accel["round_dispatches"]["cuda_fused"] == {
        "chebyshev_solve_packed": 1, "async_solve_batched": 1}
    assert (out_dir / "roofline.csv").read_text().startswith(
        "roofline/smollm_135m/decode_32k,")
    for name in ("kernel.json", "analysis.json"):
        assert (out_dir / name).is_file()
    records = [json.loads(line) for line in
               (out_dir / "run.jsonl").read_text().splitlines()]
    prov = records[0]
    assert prov["kind"] == "provenance" and prov["plain"] is True
    assert prov["platform"] == "cpu" and prov["fast"] is True
    spans = {r["name"] for r in records if r["kind"] == "span"}
    assert {"bench.table2", "bench.solve", "bench.serve"} <= spans
    assert any(r.get("event") == "latency" for r in records)
    solve = json.loads((out_dir / "solve.json").read_text())
    assert solve["provenance"]["git_sha"] == prov["git_sha"]
    assert solve["cases"][0]["dispatches"]["cuda_fused"] == 1
    report = subprocess.run(
        [sys.executable, "-m", "repro_torch.obs",
         str(out_dir / "run.jsonl")],
        cwd=REPO_ROOT, env=env, capture_output=True, text=True, timeout=120)
    assert report.returncode == 0, report.stderr
    for section in ("provenance", "convergence", "comm frontier",
                    "span waterfall", "counters / gauges",
                    "latency / percentiles"):
        assert f"== {section} " in report.stdout


def test_runner_refuses_an_unknown_suite(tmp_path):
    run = subprocess.run(
        [sys.executable, "-m", "repro_torch.bench.run", "--device", "cpu",
         "--only", "nope", "--out-dir", str(tmp_path)],
        cwd=REPO_ROOT, env=subprocess_env(), capture_output=True, text=True,
        timeout=120)
    assert run.returncode == 2 and "unknown suite" in run.stderr
