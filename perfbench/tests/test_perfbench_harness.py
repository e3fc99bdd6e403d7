"""The harness as data: names and units of BENCHMARK.json, files found by
name, the fit loop on the CPU, the import guard and the card check."""
import json
import re
import subprocess
import sys

import pytest

from perfbench import run
from perfbench.tests.tinycell import ROOT, make_root

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")


def test_benchmark_json_names_and_files():
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    assert set(bench) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    configs = {c["name"]: c for c in bench["configs"]}
    cells = {w["name"]: w for w in bench["workloads"]}
    e2e = {m["name"] for m in bench["end_to_end"]}
    for c in bench["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and all(NAME.match(k)
                                             for k in c["reduced"])
        cfg = json.loads((ROOT / c["file"]).read_text())
        assert set(c["reduced"]) <= set(cfg["reduced"])
    for w in bench["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["traffic"])
        assert w["config"] in configs and w["chips"] in (1, 4)
        assert len(w["why"]) <= 200
        traffic = json.loads((ROOT / "perfbench/traffic"
                              / f"{w['traffic']}.json").read_text())
        assert (ROOT / "perfbench/generators"
                / f"{traffic['generator']}.py").exists()
        assert (ROOT / "perfbench/limits" / f"{w['name']}.json").exists()
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
        assert set(m.get("workloads", [])) <= set(cells)
    for m in bench["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in (
            "host_clock", "device_trace")
    for m in bench["per_layer"]:
        assert m["moves"] in e2e and "\n" not in m["layer"]
        assert (ROOT / "perfbench/metrics" / f"{m['name']}.py").exists()
    assert bench["command"] == ["python3", "perfbench/run.py"]


def test_added_cell_and_metric_are_found(tmp_path):
    """A configuration, a traffic mix of the fit generator, a limits file
    and a metric reader added as files, with BENCHMARK.json entries, run
    with no other edit."""
    root = make_root(tmp_path, base="fig4-twitter-imbalanced", name="small")
    (root / "perfbench/metrics/fits_seen.py").write_text(
        "def read(rec):\n    return float(len(rec.fits))\n")
    traffic = json.loads((root / "perfbench/traffic/fit-closed-loop.json")
                         .read_text())
    traffic.update(c_grid=[0.01], pools_per_node=2, trace_fits=2)
    (root / "perfbench/traffic/two-pools.json").write_text(
        json.dumps(traffic))
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["workloads"].append(dict(name="small-two", config="small",
                                   traffic="two-pools", chips=1, why="t"))
    (root / "perfbench/limits/small-two.json").write_text(
        (root / "perfbench/limits/small-fit.json").read_text())
    bench["per_layer"].append(dict(
        name="fits_seen", unit="fits", better="higher", source="host_clock",
        layer="whole fit", moves="fit_ms", workloads=["small-two"]))
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    res, lines = run.run_cell(root, "small-two", 5, 0.2, True, device="cpu")
    assert res["correct"] and res["failed"] == 0
    assert res["metrics"]["fits_seen"]["value"] >= 2
    assert [name for name, _, _ in lines] == list(res["check"])


RATE_GENERATOR = '''"""A mix for a test: the fit loop, reporting fits a second besides."""
from perfbench.generators import fitloop
from perfbench.generators.fitloop import build, check, records, warm_up


def window(prob, seed, seconds, trace):
    win = fitloop.window(prob, seed, seconds, trace)
    win.end_to_end["fits_per_s"] = len(win.fits) / (win.t_end - win.t_start)
    return win
'''


def _add_rate_cell(root):
    """A generator, a mix naming it, a cell, its limits and an end-to-end
    metric only its generator reports, all added as files and entries."""
    (root / "perfbench/generators/fitrate.py").write_text(RATE_GENERATOR)
    traffic = json.loads((root / "perfbench/traffic/fit-closed-loop.json")
                         .read_text())
    traffic.update(generator="fitrate", c_grid=[0.05])
    (root / "perfbench/traffic/fit-rate.json").write_text(json.dumps(traffic))
    (root / "perfbench/limits/tiny-rate.json").write_text(
        (root / "perfbench/limits/tiny-fit.json").read_text())
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["workloads"].append(dict(name="tiny-rate", config="tiny",
                                   traffic="fit-rate", chips=1, why="t"))
    bench["end_to_end"].append(dict(
        name="fits_per_s", unit="fits/s", better="higher", bound=0.05,
        source="host_clock", workloads=["tiny-rate"]))
    (root / "BENCHMARK.json").write_text(json.dumps(bench))


def test_added_generator_and_end_to_end_metric_are_found(tmp_path):
    """A mix with a generator of its own and an end-to-end metric that
    only it reports run with no existing file edited."""
    root = make_root(tmp_path)
    before = {p: p.read_bytes() for p in (root / "perfbench").rglob("*")
              if p.is_file()}
    _add_rate_cell(root)
    for p, content in before.items():
        assert p.read_bytes() == content
    res, _ = run.run_cell(root, "tiny-rate", 17, 0.2, False, device="cpu")
    assert res["correct"] and res["failed"] == 0
    assert set(res["metrics"]) == {"setup_s", "fit_ms", "fit_p95_ms",
                                   "fits_per_s"}
    assert res["metrics"]["fits_per_s"]["value"] > 0
    res, _ = run.run_cell(root, "tiny-fit", 17, 0.2, False, device="cpu")
    assert "fits_per_s" not in res["metrics"]


def test_end_to_end_metric_no_generator_reports_is_refused(tmp_path):
    root = make_root(tmp_path)
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["end_to_end"].append(dict(
        name="fits_per_s", unit="fits/s", better="higher", bound=0.05,
        source="host_clock", workloads=["tiny-fit"]))
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    with pytest.raises(KeyError, match="fits_per_s"):
        run.run_cell(root, "tiny-fit", 17, 0.2, False, device="cpu")


def test_fit_loop_runs_on_cpu(tmp_path):
    root = make_root(tmp_path)
    res, lines = run.run_cell(root, "tiny-fit", 2**31 + 5, 0.3, False,
                              device="cpu")
    assert res["correct"] and res["failed"] == 0 and res["attempted"] >= 1
    assert set(res["metrics"]) == {"setup_s", "fit_ms", "fit_p95_ms"}
    assert list(res)[-1] == "check"
    assert all(v <= lim for _, v, lim in lines)


def _run_py(args, cwd, env_extra=None):
    import os

    env = dict(os.environ, JAX_PLATFORMS="cpu", **(env_extra or {}))
    return subprocess.run([sys.executable, *args], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=300)


def test_no_jax_after_a_fit(tmp_path):
    """In a fresh process: a traced fit loop on the CPU leaves no module
    whose top-level name is exactly jax, jaxlib, flax or repro."""
    root = make_root(tmp_path)
    code = (
        "import sys; from pathlib import Path\n"
        f"sys.path[:0] = [{str(ROOT)!r}, {str(ROOT / 'src')!r}]\n"
        "from perfbench import run\n"
        f"res, _ = run.run_cell(Path({str(root)!r}), 'tiny-fit', 1, 0.2, "
        "True, device='cpu')\n"
        "assert res['correct'], res\n"
        "assert 'repro_torch' in sys.modules\n"
        "print('FOUND', run.forbidden_modules())\n")
    out = _run_py(["-c", code], tmp_path)
    assert out.returncode == 0, out.stderr[-2000:]
    assert "FOUND []" in out.stdout


def test_forbidden_names_are_whole_top_level_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "repro_torchlike", sys)
    assert "repro" not in run.forbidden_modules()
    monkeypatch.setitem(sys.modules, "repro.core", sys)
    assert "repro" in run.forbidden_modules()


def test_command_refuses_without_a_card():
    import torch

    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    out = _run_py(["perfbench/run.py", "--workload", "wave-fit", "--seed",
                   "1", "--seconds", "1", "--trace", "0"], ROOT)
    assert out.returncode != 0 and out.stdout.strip() == ""


def test_command_fails_without_the_program(tmp_path):
    import shutil

    shutil.copytree(ROOT / "perfbench", tmp_path / "perfbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    out = _run_py(["perfbench/run.py", "--workload", "wave-fit", "--seed",
                   "1", "--seconds", "1", "--trace", "0"], tmp_path,
                  {"PYTHONPATH": ""})
    assert out.returncode != 0 and not out.stdout.strip().startswith("{")
