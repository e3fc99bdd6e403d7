"""Build and load the port's CUDA kernels.

Each ``csrc/*.cu`` file is compiled on its own by ``nvcc`` into a shared
library with a plain C interface and loaded with `ctypes`:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
         -Xcompiler -fPIC -Xptxas -v -o <name>.so <name>.cu

Libraries go under ``build/repro_torch/<hash>/`` at the repository root,
keyed by a hash of every source in ``csrc/`` (headers included), so an
edit rebuilds and an unchanged tree reuses what is there. Nothing is
built at import: the first call that needs a kernel builds it, and
`build_all` builds every source at once, one ``nvcc`` process each.

Every C entry point returns ``cudaGetLastError()`` (or the error of the
CUDA call that failed); `check` raises on anything but 0.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_ROOT = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
SOURCES = ("dekrr_step", "dekrr_solve", "dekrr_async_solve",
           "dekrr_cheb_solve", "rff_gram", "rff_features", "flash_decode")

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
# C signatures of the entry points, by library. Every pointer and the
# stream are c_void_p so ctypes never truncates them to 32 bits.
SIGNATURES = {
    "dekrr_step": {
        "dekrr_step_f64": [_P] * 10 + [_I] * 6 + [_P],
        "dekrr_step_f32": [_P] * 10 + [_I] * 6 + [_P],
    },
    "dekrr_solve": {
        "dekrr_solve_f64": [_P] * 11 + [_I] * 9 + [_P],
        "dekrr_solve_f32": [_P] * 11 + [_I] * 9 + [_P],
        "dekrr_solve_max_clusters_f64": [_I] * 4,
        "dekrr_solve_max_clusters_f32": [_I] * 4,
    },
    "dekrr_async_solve": {
        "dekrr_async_solve_f64": [_P] * 18 + [_I] * 11 + [_P],
        "dekrr_async_solve_f32": [_P] * 18 + [_I] * 11 + [_P],
        "dekrr_async_solve_max_clusters_f64": [_I] * 4,
        "dekrr_async_solve_max_clusters_f32": [_I] * 4,
    },
    "dekrr_cheb_solve": {
        "dekrr_cheb_solve_f64": [_P] * 15 + [_I] * 9 + [_P],
        "dekrr_cheb_solve_f32": [_P] * 15 + [_I] * 9 + [_P],
        "dekrr_cheb_solve_max_clusters_f64": [_I] * 4,
        "dekrr_cheb_solve_max_clusters_f32": [_I] * 4,
    },
    "rff_gram": {
        "rff_gram_f64": [_P] * 9 + [_I] * 4 + [ctypes.c_double]
        + [_I] * 7 + [_P],
        "rff_gram_f32": [_P] * 9 + [_I] * 4 + [ctypes.c_double]
        + [_I] * 7 + [_P],
        "rff_gram_wide_f64": [_P] * 8 + [_I] * 4 + [ctypes.c_double]
        + [_I] * 2 + [_P],
        "rff_gram_wide_f32": [_P] * 8 + [_I] * 4 + [ctypes.c_double]
        + [_I] * 2 + [_P],
    },
    "rff_features": {
        "rff_features_f64": [_P] * 6 + [_I] * 8 + [_P],
        "rff_features_f32": [_P] * 6 + [_I] * 8 + [_P],
        "rff_features_bf16": [_P] * 6 + [_I] * 8 + [_P],
    },
    "flash_decode": {
        "flash_decode_f32": [_P] * 7 + [_L] * 4 + [_I] * 9
        + [ctypes.c_double, _P],
    },
}

_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}
# nvcc's -Xptxas -v report per source, from the build that made the library
ptxas_reports: dict[str, str] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError(
        "nvcc was not found (neither on PATH nor at /usr/local/cuda/bin): "
        "the CUDA kernels of repro_torch are built from source at first "
        "use and need the CUDA toolkit")


def source_hash() -> str:
    h = hashlib.sha256()
    for path in sorted(CSRC.iterdir()):
        if path.suffix in (".cu", ".cuh"):
            h.update(path.name.encode())
            h.update(path.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return h.hexdigest()[:16]


def _build_dir() -> Path:
    out = BUILD_ROOT / source_hash()
    out.mkdir(parents=True, exist_ok=True)
    return out


def _start(name: str, out: Path) -> subprocess.Popen | None:
    """Start nvcc for one source unless its library is already built."""
    if (out / f"{name}.so").exists():
        return None
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(out / f"{name}.so.tmp"),
           str(CSRC / f"{name}.cu")]
    return subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)


def _finish(name: str, out: Path, proc: subprocess.Popen | None) -> None:
    if proc is None:
        report = out / f"{name}.ptxas.txt"
        ptxas_reports[name] = report.read_text() if report.exists() else ""
        return
    log, _ = proc.communicate()
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on csrc/{name}.cu "
                           f"(exit {proc.returncode}):\n{log}")
    (out / f"{name}.ptxas.txt").write_text(log)
    os.replace(out / f"{name}.so.tmp", out / f"{name}.so")
    ptxas_reports[name] = log


def build_all() -> dict[str, str]:
    """Build every source at once (one nvcc each) and load them. Returns
    the ``-Xptxas -v`` report per source."""
    with _lock:
        out = _build_dir()
        todo = [n for n in SOURCES if n not in _libs]
        procs = {n: _start(n, out) for n in todo}
        try:
            for n in todo:
                _finish(n, out, procs[n])
        finally:
            for proc in procs.values():
                if proc is not None and proc.poll() is None:
                    proc.kill()
                    proc.wait()
        for n in todo:
            _libs[n] = _load(out / f"{n}.so", n)
    return dict(ptxas_reports)


def _load(path: Path, name: str) -> ctypes.CDLL:
    lib = ctypes.CDLL(str(path))
    for fn, argtypes in SIGNATURES[name].items():
        f = getattr(lib, fn)
        f.argtypes = argtypes
        f.restype = ctypes.c_int
    return lib


def library(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built on first use."""
    lib = _libs.get(name)
    if lib is not None:
        return lib
    with _lock:
        if name not in _libs:
            out = _build_dir()
            _finish(name, out, _start(name, out))
            _libs[name] = _load(out / f"{name}.so", name)
        return _libs[name]


def check(code: int, what: str) -> None:
    """Raise if a C entry point returned a CUDA error."""
    if code != 0:
        raise RuntimeError(f"{what} failed with CUDA error {code}")
