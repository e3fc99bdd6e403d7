"""The port's `repro_torch.experiments` against the reference's
`experiments/` scripts: the perf probe's totals against the dry run's
record of the same pair (one subprocess: the fake process group is global
to its process), its top lists, its configuration overrides, and
`make_report`'s tables against the reference's on the same synthetic
dry-run records."""
import importlib.util
import io
import json
import os
import subprocess
import sys
from contextlib import redirect_stdout

import pytest

from conftest import REPO_ROOT, subprocess_env
from repro_torch.experiments import make_report
from repro_torch.experiments.perf_probe import parse_override

PAIR = ["--arch", "smollm_135m", "--shape", "train_4k", "--mesh", "2x2",
        "--batch", "8", "--seq", "256"]

PROBE_SCRIPT = """
import json, sys
from repro_torch.experiments import perf_probe
from repro_torch.launch import dryrun

pair, out = json.loads(sys.argv[1]), sys.argv[2]
traced = []
trace = perf_probe.trace_pair
perf_probe.trace_pair = lambda *a, **k: traced.append(trace(*a, **k)) \\
    or traced[-1]
perf_probe.main(pair + ["--top", "40", "--json-out", out + "/probe.json"])
costs = traced[0][1]
record = dryrun.run_pair("smollm_135m", "train_4k", mesh_grid=(2, 2),
                         batch=8, seq=256, verbose=False)
perf_probe.main(pair + ["--set", "remat=false",
                        "--json-out", out + "/no_remat.json"])
print(json.dumps({
    "record": record,
    "top_collectives": [list(t) for t in costs.top_collectives],
    "coll_entries": len(costs.coll_by_shape),
    "top_memory_ops": [list(t) for t in costs.top_memory_ops],
    "mem_entries": len(costs.mem_by_shape), "bytes": costs.bytes}))
"""


@pytest.fixture(scope="module")
def probed(tmp_path_factory):
    out = tmp_path_factory.mktemp("probe")
    run = subprocess.run(
        [sys.executable, "-c", PROBE_SCRIPT, json.dumps(PAIR), str(out)],
        cwd=REPO_ROOT, env=subprocess_env(OMP_NUM_THREADS="1"),
        capture_output=True, text=True, timeout=600)
    assert run.returncode == 0, run.stdout[-3000:] + run.stderr[-3000:]
    res = json.loads(run.stdout.strip().splitlines()[-1])
    res["probe"] = json.loads((out / "probe.json").read_text())
    res["no_remat"] = json.loads((out / "no_remat.json").read_text())
    res["stdout"] = run.stdout
    return res


def test_probe_totals_equal_the_dry_run_record(probed):
    probe, rec = probed["probe"], probed["record"]
    assert set(probe) == {"peak", "flops", "hbm", "coll"}
    assert probe["peak"] == rec["peak_memory_per_device"]
    assert probe["flops"] == rec["flops_per_device"]
    assert probe["hbm"] == rec["bytes_per_device"]
    assert probe["coll"] == rec["collective_bytes_per_device"]
    assert rec["chips"] == 4 and rec["shape"] == "train_4k@b8s256"
    for line in ("=== smollm_135m × train_4k@b8s256 on 4 ranks",
                 "top collectives (bytes × count):", "top memory ops:"):
        assert line in probed["stdout"]


def test_probe_top_lists_add_up(probed):
    """Each list is sorted, at most 40 entries, counts ≥ 1; with fewer
    than 40 (kind, shape) entries the top collectives sum to the
    collective bytes."""
    for key in ("top_collectives", "top_memory_ops"):
        rows = probed[key]
        assert 0 < len(rows) <= 40
        assert [r[0] for r in rows] == sorted((r[0] for r in rows),
                                              reverse=True)
        assert all(r[3] >= 1 for r in rows)
    tops = probed["top_collectives"]
    assert probed["coll_entries"] < 40
    assert sum(r[0] for r in tops) == sum(probed["probe"]["coll"].values())
    assert {r[1] for r in tops} <= {k for k, v in
                                    probed["probe"]["coll"].items() if v}
    if probed["mem_entries"] < 40:
        assert sum(r[0] for r in probed["top_memory_ops"]) == \
            probed["bytes"]


def test_probe_override_without_remat_raises_the_peak(probed):
    assert probed["no_remat"]["peak"] > probed["probe"]["peak"]
    assert probed["no_remat"]["flops"] <= probed["probe"]["flops"]
    assert "overrides={'remat': False}" in probed["stdout"]


@pytest.mark.parametrize("text,want", [
    ("act_shard=none", ("act_shard", None)),
    ("remat=false", ("remat", False)),
    ("remat=true", ("remat", True)),
    ("moe_groups=4", ("moe_groups", 4)),
    ("rope_theta=5e5", ("rope_theta", 5e5)),
    ("act_shard=(None, 'model', None)",
     ("act_shard", (None, "model", None))),
    ("param_dtype=float32", ("param_dtype", "float32")),
])
def test_parse_override_forms(text, want):
    assert parse_override(text) == want


# --------------------------------------------------------------------------
# make_report against the reference on synthetic records
# --------------------------------------------------------------------------
def _ref_report():
    spec = importlib.util.spec_from_file_location(
        "ref_make_report", os.path.join(REPO_ROOT, "experiments",
                                        "make_report.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _record(arch, shape, mesh, chips, dominant, i):
    return {"arch": arch, "shape": shape, "mesh": mesh, "plan": "run",
            "status": "ok", "chips": chips,
            "peak_memory_per_device": (i + 1) * 1.7e9,
            "compute_s": 1e-3 * (i + 1), "memory_s": 2.5e-3 * i,
            "collective_s": 3e-4 * (i % 3), "dominant": dominant,
            "useful_flops_ratio": 0.1 * (i % 7)}


@pytest.fixture
def records(tmp_path):
    kinds = ("compute", "memory", "collective")
    for mesh, chips in (("16x16", 256), ("2x16x16", 512)):
        i = 0
        for arch in make_report.ARCH_ORDER[:6]:
            for shape in make_report.SHAPE_ORDER[:3]:
                rec = _record(arch, shape, mesh, chips, kinds[i % 3], i)
                if arch == "hubert_xlarge" and shape == "decode_32k":
                    rec = {"arch": arch, "shape": shape, "mesh": mesh,
                           "plan": "skip", "status": "skip"}
                (tmp_path / f"{mesh}_{arch}_{shape}.json").write_text(
                    json.dumps(rec))
                i += 1
    return tmp_path


def _render(table, *args, **kwargs):
    buf = io.StringIO()
    with redirect_stdout(buf):
        table(*args, **kwargs)
    return buf.getvalue().splitlines()


@pytest.mark.parametrize("mesh", ["16x16", "2x16x16"])
def test_make_report_equals_the_reference_but_the_lever(records, mesh):
    ref = _render(_ref_report().table, mesh, dirname=str(records))
    got = _render(make_report.table, mesh, str(records))
    assert len(got) == len(ref) > 40
    levers = set()
    for g, r in zip(got, ref):
        if g.startswith("| ") and g.count("|") == 11:
            assert g.split("|")[:-2] == r.split("|")[:-2]
            levers.add((g.split("|")[-2], r.split("|")[-2]))
        else:
            assert g == r
    assert any("MISSING" in line for line in got)
    assert any("skip (encoder-only)" in line for line in got)
    changed = {r for g, r in levers if g != r}
    assert changed == {" raise MXU utilization (larger tiles, fused "
                       "featurize) "}
    assert all("MXU" not in g for g, _ in levers)


def test_make_report_renders_a_cut_pair_and_notes_the_bytes(tmp_path,
                                                             capsys):
    rec = _record("qwen1_5_0_5b", "train_4k@b8s256", "1x1", 1, "memory", 3)
    (tmp_path / "1x1_qwen1_5_0_5b_train_4k@b8s256.json").write_text(
        json.dumps(rec))
    assert make_report.main(["--dryrun-dir", str(tmp_path),
                             "--mesh", "1x1"]) == 0
    out = capsys.readouterr().out
    assert "bytes_model: \"unfused\"" in out.splitlines()[0]
    assert "### Mesh 1x1 (1 chips)" in out
    row = next(line for line in out.splitlines()
               if "train_4k@b8s256" in line)
    assert row.startswith("| qwen1_5_0_5b | train_4k@b8s256 | run | 6.3 |")
