"""Build and load the port's CUDA kernels.

Each ``csrc/*.cu`` file is compiled on its own by ``nvcc`` into a shared
library with a plain C interface and loaded with `ctypes`:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
         -Xcompiler -fPIC -Xptxas -v -o <name>.so <name>.cu

Libraries go under ``build/repro_torch/<hash>/`` at the repository root
(under ``$REPRO_TORCH_BUILD_ROOT/<hash>/`` where that is set), keyed by a
hash of every source in ``csrc/`` (headers included), so an
edit rebuilds and an unchanged tree reuses what is there. Nothing is
built at import: the first call that needs a kernel builds it, and
`build_all` builds every source at once, one ``nvcc`` process each.
Processes that reach a kernel at once (the ranks of an SPMD solve) take
a file lock in the build directory around the check and the build, and
nvcc writes to a name of its own process before the library is moved
into place, so one process builds and the others load what it built.

Every C entry point returns ``cudaGetLastError()`` (or the error of the
CUDA call that failed); `check` raises on anything but 0.
"""
from __future__ import annotations

import contextlib
import ctypes
import fcntl
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
        "dekrr_step_smem_bytes_f64": [_I] * 3,
        "dekrr_step_smem_bytes_f32": [_I] * 3,
    },
    "dekrr_solve": {
        "dekrr_solve_f64": [_P] * 11 + [_I] * 9 + [_P],
        "dekrr_solve_f32": [_P] * 11 + [_I] * 9 + [_P],
        "dekrr_solve_max_clusters_f64": [_I] * 4,
        "dekrr_solve_max_clusters_f32": [_I] * 4,
        "dekrr_solve_smem_bytes_f64": [_I] * 3,
        "dekrr_solve_smem_bytes_f32": [_I] * 3,
        "dekrr_solve_clocked_f64": [_P] * 12 + [_I] * 9 + [_P],
        "dekrr_solve_resident_f64": [_P] * 14 + [_I] * 9 + [_P],
        "dekrr_solve_resident_f32": [_P] * 14 + [_I] * 9 + [_P],
        "dekrr_solve_resident_clocked_f64": [_P] * 15 + [_I] * 9 + [_P],
        "dekrr_solve_resident_max_clusters_f64": [_I] * 3,
        "dekrr_solve_resident_max_clusters_f32": [_I] * 3,
        "dekrr_solve_resident_smem_bytes_f64": [_I] * 4,
        "dekrr_solve_resident_smem_bytes_f32": [_I] * 4,
        "dekrr_handoff_probe": [_P, _I, _P, _P],
    },
    "dekrr_async_solve": {
        "dekrr_async_solve_f64": [_P] * 18 + [_I] * 11 + [_P],
        "dekrr_async_solve_f32": [_P] * 18 + [_I] * 11 + [_P],
        "dekrr_async_solve_max_clusters_f64": [_I] * 4,
        "dekrr_async_solve_max_clusters_f32": [_I] * 4,
        "dekrr_async_solve_smem_bytes_f64": [_I] * 3,
        "dekrr_async_solve_smem_bytes_f32": [_I] * 3,
        "dekrr_async_solve_clocked_f64": [_P] * 19 + [_I] * 11 + [_P],
        "dekrr_async_solve_resident_f64": [_P] * 20 + [_I] * 11 + [_P],
        "dekrr_async_solve_resident_f32": [_P] * 20 + [_I] * 11 + [_P],
        "dekrr_async_solve_resident_clocked_f64": [_P] * 21 + [_I] * 11
        + [_P],
        "dekrr_async_solve_resident_max_clusters_f64": [_I] * 3,
        "dekrr_async_solve_resident_max_clusters_f32": [_I] * 3,
        "dekrr_async_solve_resident_smem_bytes_f64": [_I] * 4,
        "dekrr_async_solve_resident_smem_bytes_f32": [_I] * 4,
    },
    "dekrr_cheb_solve": {
        "dekrr_cheb_solve_f64": [_P] * 15 + [_I] * 9 + [_P],
        "dekrr_cheb_solve_f32": [_P] * 15 + [_I] * 9 + [_P],
        "dekrr_cheb_solve_max_clusters_f64": [_I] * 4,
        "dekrr_cheb_solve_max_clusters_f32": [_I] * 4,
        "dekrr_cheb_solve_smem_bytes_f64": [_I] * 3,
        "dekrr_cheb_solve_smem_bytes_f32": [_I] * 3,
        "dekrr_cheb_solve_clocked_f64": [_P] * 16 + [_I] * 9 + [_P],
        "dekrr_cheb_solve_resident_f64": [_P] * 18 + [_I] * 9 + [_P],
        "dekrr_cheb_solve_resident_f32": [_P] * 18 + [_I] * 9 + [_P],
        "dekrr_cheb_solve_resident_clocked_f64": [_P] * 19 + [_I] * 9 + [_P],
        "dekrr_cheb_solve_resident_max_clusters_f64": [_I] * 3,
        "dekrr_cheb_solve_resident_max_clusters_f32": [_I] * 3,
        "dekrr_cheb_solve_resident_smem_bytes_f64": [_I] * 4,
        "dekrr_cheb_solve_resident_smem_bytes_f32": [_I] * 4,
    },
    "rff_gram": {
        "rff_gram_f64": [_P] * 9 + [_I] * 4 + [ctypes.c_double]
        + [_I] * 7 + [_P],
        "rff_gram_f32": [_P] * 8 + [_I] * 4 + [ctypes.c_double]
        + [_I] * 9 + [_P],
        "rff_gram_wide_f64": [_P] * 8 + [_I] * 4 + [ctypes.c_double]
        + [_I] * 2 + [_P],
        "rff_gram_wide_f32": [_P] * 8 + [_I] * 4 + [ctypes.c_double]
        + [_I] * 2 + [_P],
        "rff_gram_f32_max_clusters": [_I] * 3,
        "rff_gram_smem_bytes": [_I] * 6,
        "rff_gram_wide_smem_bytes": [_I] * 2,
    },
    "rff_features": {
        "rff_features_f64": [_P] * 6 + [_I] * 8 + [_P],
        "rff_features_f32": [_P] * 6 + [_I] * 8 + [_P],
        "rff_features_bf16": [_P] * 5 + [_I] * 10 + [_P],
        "rff_features_smem_bytes": [_I] * 4,
        "rff_features_bf16_smem_bytes": [_I] * 2,
    },
    "flash_decode": {
        "flash_decode_f32": [_P] * 7 + [_L] * 4 + [_I] * 9
        + [ctypes.c_double, _P],
        "flash_decode_bf16": [_P] * 7 + [_L] * 4 + [_I] * 10
        + [ctypes.c_double, _P],
        "flash_decode_smem_bytes": [_I] * 5,
    },
}

_lock = threading.RLock()
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
    root = Path(os.environ.get("REPRO_TORCH_BUILD_ROOT", BUILD_ROOT))
    out = root / source_hash()
    out.mkdir(parents=True, exist_ok=True)
    return out


def _start(name: str, out: Path) -> subprocess.Popen | None:
    """Start nvcc for one source unless its library is already built. The
    output goes to a name of this process's own, so builds in other
    processes never write the same file."""
    if (out / f"{name}.so").exists():
        return None
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(_tmp_path(name, out)),
           str(CSRC / f"{name}.cu")]
    return subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)


def _tmp_path(name: str, out: Path) -> Path:
    return out / f"{name}.so.{os.getpid()}.tmp"


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
    os.replace(_tmp_path(name, out), out / f"{name}.so")
    ptxas_reports[name] = log


@contextlib.contextmanager
def _locked(out: Path):
    """Hold the build directory against other threads (the threading lock)
    and other processes (``flock`` on its lock file; the kernel drops it
    when a holder dies, so a file left behind blocks nobody)."""
    with _lock, open(out / "build.lock", "w") as fh:
        fcntl.flock(fh, fcntl.LOCK_EX)
        try:
            yield
        finally:
            fcntl.flock(fh, fcntl.LOCK_UN)


def ensure_built(names, out: Path | None = None) -> dict[str, Path]:
    """Build the named sources whose libraries are missing from ``out``
    (the build directory of this tree by default), one nvcc each, all at
    once, under the cross-process lock: of many processes that ask at
    once, one builds and the others find its libraries. Returns the
    library path of each name."""
    out = _build_dir() if out is None else Path(out)
    with _locked(out):
        procs = {n: _start(n, out) for n in names}
        try:
            for n in names:
                _finish(n, out, procs[n])
        finally:
            for n, proc in procs.items():
                if proc is not None and proc.poll() is None:
                    proc.kill()
                    proc.wait()
                _tmp_path(n, out).unlink(missing_ok=True)
    return {n: out / f"{n}.so" for n in names}


def build_all() -> dict[str, str]:
    """Build every source at once (one nvcc each) and load them. Returns
    the ``-Xptxas -v`` report per source."""
    with _lock:
        todo = [n for n in SOURCES if n not in _libs]
        for n, path in ensure_built(todo).items():
            _libs[n] = _load(path, n)
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
            _libs[name] = _load(ensure_built((name,))[name], name)
        return _libs[name]


def check(code: int, what: str) -> None:
    """Raise if a C entry point returned a CUDA error."""
    if code != 0:
        raise RuntimeError(f"{what} failed with CUDA error {code}")
