"""Build and load the port's hand-written CUDA kernels.

Each ``csrc/<name>.cu`` has a plain C interface. At first use it is compiled
with ``nvcc`` for ``sm_90a`` into a shared library under ``_build/`` (listed
in ``.gitignore``; the package's ``_build/``, beside the host row codec's
library) and loaded with ctypes. The library's file name carries a
hash of its source and flags, so an edited source never loads a stale
build. A failed compile raises with the compiler's output; there is no
fallback.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v",
)
KERNEL_SOURCES = ("grouped_sums",)

_MU = threading.Lock()
_LIBS: dict[tuple, ctypes.CDLL] = {}


def nvcc_path() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    for cand in (os.path.join(home, "bin", "nvcc") if home else None, shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: set CUDA_HOME or put the CUDA toolkit's bin/ on PATH")


def library_path(name: str, defines=()) -> Path:
    """Where the library for ``csrc/<name>.cu`` built with ``-D``
    ``defines`` lives."""
    flags = NVCC_FLAGS + tuple(f"-D{d}" for d in defines)
    tag = hashlib.sha1((CSRC / f"{name}.cu").read_bytes() + " ".join(flags).encode()).hexdigest()[:12]
    return BUILD_DIR / f"lib{name}-{tag}.so"


def _start(name: str, defines=()):
    """(path, Popen or None): start nvcc for ``name`` unless already built.
    The compiler writes to a private temporary name, renamed into place on
    success, so concurrent builders never load a half-written library."""
    out = library_path(name, defines)
    if out.exists():
        return out, None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.{threading.get_ident()}.tmp")
    cmd = [nvcc_path(), *NVCC_FLAGS, *(f"-D{d}" for d in defines), "-o", str(tmp), str(CSRC / f"{name}.cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    proc.tmp = tmp  # type: ignore[attr-defined]
    return out, proc


def _finish(name: str, out: Path, proc) -> str:
    """Wait for one build; raise with the compiler's output on failure.
    Returns what the compiler printed (ptxas register and shared-memory
    report) and keeps it beside the library."""
    if proc is None:
        log = out.with_suffix(".log")
        return log.read_text() if log.exists() else ""
    text, _ = proc.communicate()
    if proc.returncode != 0:
        proc.tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed for csrc/{name}.cu (exit {proc.returncode}):\n{text}")
    out.with_suffix(".log").write_text(text)
    os.replace(proc.tmp, out)
    return text


def build_all(extra=()) -> tuple[float, dict[str, str]]:
    """Compile every kernel source, plus ``extra`` builds given as
    ``(name, defines)``, at once (one nvcc per library, all started
    together). Returns (seconds, {name: compiler report}); an extra build's
    name carries its defines."""
    t0 = time.perf_counter()
    specs = [(n, ()) for n in KERNEL_SOURCES] + [(n, tuple(d)) for n, d in extra]
    with _MU:
        started = [(" ".join((n, *d)), n, *_start(n, d)) for n, d in specs]
        reports = {label: _finish(n, out, proc) for label, n, out, proc in started}
    return time.perf_counter() - t0, reports


def load(name: str, defines=()) -> ctypes.CDLL:
    """The loaded library for ``name`` (see :func:`library_path`), built on
    first use."""
    key = (name, tuple(defines))
    with _MU:
        lib = _LIBS.get(key)
        if lib is None:
            out, proc = _start(name, defines)
            _finish(name, out, proc)
            lib = ctypes.CDLL(str(out))
            _LIBS[key] = lib
        return lib
