"""The port stands alone: nothing in `src/repro_torch` or `chip_smoke.py`
imports JAX, the JAX package `repro`, or `msgpack` (the card's machine
has none; the port's checkpoints carry their own codec)."""
import ast
import os
import subprocess
import sys

import pytest

from conftest import REPO_ROOT, subprocess_env

FORBIDDEN = ("jax", "jaxlib", "repro", "msgpack")


def _port_files():
    root = os.path.join(REPO_ROOT, "src", "repro_torch")
    for dirpath, _, filenames in os.walk(root):
        for fn in sorted(filenames):
            if fn.endswith(".py"):
                yield os.path.join(dirpath, fn)
    yield os.path.join(REPO_ROOT, "chip_smoke.py")


def _imported_roots(path):
    with open(path, encoding="utf-8") as f:
        tree = ast.parse(f.read(), filename=path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield node.lineno, alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.lineno, node.module.split(".")[0]


@pytest.mark.parametrize("path", list(_port_files()),
                         ids=lambda p: os.path.relpath(p, REPO_ROOT))
def test_no_jax_or_reference_import(path):
    bad = [(line, mod) for line, mod in _imported_roots(path)
           if mod in FORBIDDEN]
    assert not bad, f"{os.path.relpath(path, REPO_ROOT)} imports {bad}"


def test_importing_the_port_loads_no_jax():
    code = ("import repro_torch, repro_torch.core, repro_torch.data.synthetic,"
            " repro_torch.dist, repro_torch.kernels, repro_torch.interop, "
            "repro_torch.core.acceleration, repro_torch.obs, "
            "repro_torch.obs.metrics, repro_torch.obs.spans, "
            "repro_torch.stream, repro_torch.serve, "
            "repro_torch.serve.dekrr, repro_torch.kernels.rff_features, "
            "repro_torch.models, repro_torch.configs, "
            "repro_torch.serve.engine, repro_torch.launch.serve, "
            "repro_torch.kernels.decode_attention, "
            "repro_torch.bench.stream_bench, repro_torch.data.tokens, "
            "repro_torch.train, repro_torch.train.optim, "
            "repro_torch.train.step, repro_torch.train.checkpoint, "
            "repro_torch.train.loop, repro_torch.launch.train, "
            "repro_torch.bench.accel_bench, repro_torch.bench.kernel_bench, "
            "repro_torch.bench.analysis_bench, repro_torch.bench.run, "
            "repro_torch.experiments.perf_probe, "
            "repro_torch.experiments.make_report, "
            "repro_torch.examples.quickstart, "
            "repro_torch.examples.decentralized_readout; "
            "import sys; bad = [m for m in sys.modules if m in ('jax', "
            "'msgpack') or m.startswith(('jax.', 'repro.', 'msgpack.'))]; "
            "assert not bad, bad")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO_ROOT,
                         env=subprocess_env(), capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr


def test_quickstart_runs_with_jax_and_the_reference_blocked():
    """The quickstart end to end on the CPU while importing `jax`,
    `jaxlib`, `repro` or `msgpack` raises ImportError."""
    code = ("import runpy, sys\n"
            "for name in ('jax', 'jaxlib', 'repro', 'msgpack'):\n"
            "    sys.modules[name] = None\n"
            "sys.argv = ['quickstart', '--device', 'cpu']\n"
            "runpy.run_module('repro_torch.examples.quickstart', "
            "run_name='__main__')\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO_ROOT,
                         env=subprocess_env(), capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    lines = out.stdout.splitlines()
    assert lines[0] == "dataset d=8 N=2000, J=10, |N_j|=4"
    assert lines[-1].startswith("DKLA (RFF)   RSE = ")
