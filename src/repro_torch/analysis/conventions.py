"""AST-based linter for the port's house contracts.

The port's own copy of the reference's `repro.analysis.conventions`,
linting `src/repro_torch/` and `tests/test_torch_*.py` (pure Python, no
torch import). Rules:

  R001  Public solver entry points expose ``backend=`` — the torch/cuda/
        cuda_fused switch is the port's central API contract; an entry
        point without it silently forks the backend matrix.
  R004  Kernels are launched only through the ops wrappers: a raw
        ``*_cuda(…)`` launcher call outside ``src/repro_torch/kernels/``
        bypasses the wrappers' checks (devices, shapes, the
        shared-memory budget, index bounds) and their launch and dispatch
        counters (the reference's rule bans raw ``*_pallas(…,
        interpret=…)`` calls for the same reason).
  R005  No bare ``except:`` — swallowing KeyboardInterrupt/SystemExit in
        long solver runs makes hangs unkillable.
  R006  No bare ``time.time()`` / ``time.perf_counter()`` in
        ``src/repro_torch/`` outside ``repro_torch/obs/`` — host timing
        goes through `repro_torch.obs.metrics.perf_clock` / `wall_clock`
        so spans, latency recorders and benches share one monotonic clock
        (and tests can swap in a `FakeClock`). ``time.sleep`` is not a
        timing read and stays allowed.

Not ported, because PyTorch code has no traced program for them to
guard: R002 (no ``.item()``/``float()`` on a tracer inside jitted code)
and R003 (tests asserting rtol ≤ 1e-6 enable JAX's x64 mode; the port
passes float64 dtypes explicitly).

A finding can be waived on its line with ``# analysis: ignore[R00x]``
(or a blanket ``# analysis: ignore``) — every waiver is visible in the
diff, unlike a lint that was never run.
"""
from __future__ import annotations

import ast
import os
from typing import Iterable

from repro_torch.analysis.report import Finding

# R001 — the packed/SPMD solver surface that must carry the backend switch.
SOLVER_ENTRY_POINTS = frozenset({
    "step_batched", "solve_batched",
    "async_step_batched", "async_solve_batched",
    "make_spmd_solver", "make_async_spmd_solver",
})


def _waived(source_lines: list[str], lineno: int, rule: str) -> bool:
    if not 1 <= lineno <= len(source_lines):
        return False
    line = source_lines[lineno - 1]
    return (f"analysis: ignore[{rule}]" in line
            or ("analysis: ignore" in line and "[" not in
                line.split("analysis: ignore", 1)[1][:1]))


def _callee_name(call: ast.Call) -> str | None:
    f = call.func
    if isinstance(f, ast.Name):
        return f.id
    if isinstance(f, ast.Attribute):
        return f.attr
    return None


def _check_backend_exposure(tree: ast.Module, rel: str,
                            lines: list[str]) -> list[Finding]:
    findings = []
    for node in ast.walk(tree):
        if not isinstance(node, ast.FunctionDef):
            continue
        if node.name not in SOLVER_ENTRY_POINTS:
            continue
        if _waived(lines, node.lineno, "R001"):
            continue
        a = node.args
        names = {x.arg for x in a.args + a.kwonlyargs + a.posonlyargs}
        if "backend" not in names:
            findings.append(Finding(
                "conventions", "R001", f"{rel}:{node.lineno}",
                f"solver entry point `{node.name}` does not expose "
                f"`backend=` — every public solver must carry the "
                f"torch/cuda/cuda_fused switch"))
    return findings


def _check_raw_kernel_calls(tree: ast.Module, rel: str, path: str,
                            lines: list[str]) -> list[Finding]:
    norm = os.path.abspath(path).replace(os.sep, "/")
    if "/repro_torch/kernels/" in norm:
        return []
    findings = []
    for node in ast.walk(tree):
        if not isinstance(node, ast.Call):
            continue
        callee = _callee_name(node)
        if callee is None or not callee.endswith("_cuda") \
                or callee.startswith("_"):
            continue
        if _waived(lines, node.lineno, "R004"):
            continue
        findings.append(Finding(
            "conventions", "R004", f"{rel}:{node.lineno}",
            f"raw kernel launch `{callee}(…)` outside "
            f"src/repro_torch/kernels/ — route through the "
            f"repro_torch.kernels.ops wrappers (they own the checks, the "
            f"shared-memory budget and the launch/dispatch counts)"))
    return findings


# R006 — the two stdlib clock reads the obs clock shims wrap.
_CLOCK_READS = frozenset({"time", "perf_counter"})


def _check_clock_usage(tree: ast.Module, rel: str, path: str,
                       lines: list[str]) -> list[Finding]:
    norm = os.path.abspath(path).replace(os.sep, "/")
    if "/repro_torch/" not in norm or "/repro_torch/obs/" in norm:
        return []
    findings = []
    for node in ast.walk(tree):
        if not isinstance(node, ast.Call):
            continue
        f = node.func
        if not (isinstance(f, ast.Attribute) and f.attr in _CLOCK_READS
                and isinstance(f.value, ast.Name) and f.value.id == "time"):
            continue
        if _waived(lines, node.lineno, "R006"):
            continue
        shim = "wall_clock" if f.attr == "time" else "perf_clock"
        findings.append(Finding(
            "conventions", "R006", f"{rel}:{node.lineno}",
            f"bare `time.{f.attr}()` outside repro_torch/obs/ — use "
            f"`repro_torch.obs.metrics.{shim}` so spans/latency/bench "
            f"share one injectable clock"))
    return findings


def _check_bare_except(tree: ast.Module, rel: str,
                       lines: list[str]) -> list[Finding]:
    findings = []
    for node in ast.walk(tree):
        if isinstance(node, ast.ExceptHandler) and node.type is None \
                and not _waived(lines, node.lineno, "R005"):
            findings.append(Finding(
                "conventions", "R005", f"{rel}:{node.lineno}",
                "bare `except:` — catches KeyboardInterrupt/SystemExit "
                "and makes long solver runs unkillable; catch Exception "
                "or narrower"))
    return findings


def lint_file(path: str, *, repo_root: str | None = None,
              source: str | None = None) -> list[Finding]:
    """Lint one Python file; `source` overrides reading from disk (used by
    the seeded-violation tests)."""
    if source is None:
        with open(path, encoding="utf-8") as f:
            source = f.read()
    rel = (os.path.relpath(path, repo_root) if repo_root
           else os.path.basename(path))
    try:
        tree = ast.parse(source, filename=path)
    except SyntaxError as exc:
        return [Finding("conventions", "R000", f"{rel}:{exc.lineno}",
                        f"syntax error: {exc.msg}")]
    lines = source.splitlines()
    findings = []
    findings += _check_backend_exposure(tree, rel, lines)
    findings += _check_raw_kernel_calls(tree, rel, path, lines)
    findings += _check_bare_except(tree, rel, lines)
    findings += _check_clock_usage(tree, rel, path, lines)
    return findings


def iter_python_files(paths: Iterable[str]) -> Iterable[str]:
    for p in paths:
        if os.path.isfile(p):
            if p.endswith(".py"):
                yield p
            continue
        for dirpath, dirnames, filenames in os.walk(p):
            dirnames[:] = [d for d in dirnames
                           if d not in ("__pycache__", ".git")]
            for fn in sorted(filenames):
                if fn.endswith(".py"):
                    yield os.path.join(dirpath, fn)


def default_paths(repo_root: str) -> list[str]:
    """What the pass lints by default: the port's package and its tests."""
    tests = os.path.join(repo_root, "tests")
    return [os.path.join(repo_root, "src", "repro_torch")] + sorted(
        os.path.join(tests, fn) for fn in os.listdir(tests)
        if fn.startswith("test_torch_") and fn.endswith(".py"))


def run_pass(paths: Iterable[str], *,
             repo_root: str | None = None) -> list[Finding]:
    findings = []
    for path in iter_python_files(paths):
        findings += lint_file(path, repo_root=repo_root)
    return findings
