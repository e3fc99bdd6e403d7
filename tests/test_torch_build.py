"""The kernel build's concurrency (`repro_torch.kernels._build`), with a
stand-in compiler: nvcc does not exist on the CPU machine, so a script
named ``nvcc`` first on PATH takes its place. It logs each call, sleeps,
then writes its ``-o`` file, so two processes that ask for the same
libraries at once overlap inside the build."""
import ctypes
import os
import re
import stat
import sys
import textwrap

import pytest

from repro_torch.dist.ranks import run_ranks
from repro_torch.kernels import _build

NAMES = ("dekrr_step", "rff_gram")

STANDIN = textwrap.dedent("""\
    #!{python}
    import os, sys, time
    out = sys.argv[sys.argv.index("-o") + 1]
    src = os.path.basename(sys.argv[-1])
    with open({log!r}, "a") as fh:
        fh.write(src + "\\n")
    time.sleep(1.0)
    with open(out, "w") as fh:
        fh.write("stand-in library of " + src)
        fh.flush()
        if {fail!r}:
            sys.exit(1)
    print("ptxas info    : stand-in for " + src)
""")


@pytest.fixture
def standin(tmp_path, monkeypatch):
    """(install(fail) → log path): put a stand-in nvcc first on PATH."""
    def install(fail=False):
        bindir = tmp_path / "bin"
        bindir.mkdir(exist_ok=True)
        log = tmp_path / "nvcc.log"
        script = bindir / "nvcc"
        script.write_text(STANDIN.format(python=sys.executable,
                                         log=str(log), fail=fail))
        script.chmod(script.stat().st_mode | stat.S_IEXEC)
        monkeypatch.setenv("PATH", f"{bindir}{os.pathsep}"
                                   f"{os.environ.get('PATH', '')}")
        return log
    return install


def test_two_processes_build_each_library_once(standin, tmp_path):
    log = standin()
    out = tmp_path / "build"
    out.mkdir()
    first, second = run_ranks(_build.ensure_built, 2, args=(NAMES, out),
                              timeout=60.0)
    assert first == second == {n: out / f"{n}.so" for n in NAMES}
    calls = log.read_text().split()
    assert sorted(calls) == sorted(f"{n}.cu" for n in NAMES)
    for n in NAMES:
        assert (out / f"{n}.so").read_text() == \
            f"stand-in library of {n}.cu"
        assert "stand-in" in (out / f"{n}.ptxas.txt").read_text()
    assert list(out.glob("*.tmp")) == []
    # built once: a later call finds the libraries and runs no compiler
    assert _build.ensure_built(NAMES, out) == first
    assert log.read_text().split() == calls


def test_a_failed_build_leaves_no_library_or_temporary(standin, tmp_path):
    standin(fail=True)
    out = tmp_path / "build"
    out.mkdir()
    with pytest.raises(RuntimeError, match="nvcc failed on csrc/dekrr_step"):
        _build.ensure_built(NAMES, out)
    assert list(out.glob("*.so")) == [] and list(out.glob("*.tmp")) == []


_C_TYPES = {"void*": ctypes.c_void_p, "int": ctypes.c_int,
            "long long": ctypes.c_longlong, "double": ctypes.c_double}


def _c_entry_points(name):
    """{function: [ctypes type of each parameter]} of the ``extern "C"``
    block of ``csrc/<name>.cu``, read from the source."""
    src = (_build.CSRC / f"{name}.cu").read_text()
    block = src[src.index('extern "C" {'):]
    out = {}
    for m in re.finditer(r"^int\s+(\w+)\s*\(([^)]*)\)\s*\{", block, re.M):
        types = []
        for param in m.group(2).split(","):
            words = param.replace("const", "").split()
            kind = " ".join(words[:-1]) if not words[-1].endswith("*") \
                else " ".join(words)
            types.append(_C_TYPES[re.sub(r"\s*\*.*", "*", kind)])
        out[m.group(1)] = types
    return out


@pytest.mark.parametrize("name", _build.SOURCES)
def test_signatures_match_the_c_entry_points(name):
    """`SIGNATURES` names every C entry point of each source with its
    parameters' types in order: a pointer or the stream passed as a 32-bit
    int, or a missing argument, would show only on the card."""
    assert _c_entry_points(name) == _build.SIGNATURES[name]
