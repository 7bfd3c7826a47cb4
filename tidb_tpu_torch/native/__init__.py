"""Native (C++) runtime components.

Reference parity: the reference's storage/compute engines are native
(TiKV/Rust, TiFlash/C++ — SURVEY §2.2); here the host-side hot paths that
sit outside XLA — bulk row/key encoding and packed-row decoding — are C++
behind a ctypes C ABI, compiled on first use with the toolchain's g++.

Falls back to the pure-Python encoders transparently when no compiler is
available (``lib()`` returns None); all callers must keep working either way.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading

_mu = threading.Lock()
_lib = None
_tried = False

_SRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "src", "rowcodec.cc")
# the package's git-ignored build directory, shared with the CUDA kernels
# (native/cuda.py)
_OUT_DIR = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "_build")
_OUT = os.path.join(_OUT_DIR, "libtidbtpu_native.so")


def _build() -> str | None:
    os.makedirs(_OUT_DIR, exist_ok=True)
    # rebuild only when the source is newer than the cached .so
    if os.path.exists(_OUT) and os.path.getmtime(_OUT) >= os.path.getmtime(_SRC):
        return _OUT
    # per-process tmp name: concurrent builders each publish a complete .so
    # atomically instead of interleaving writes into one shared tmp file
    tmp = f"{_OUT}.{os.getpid()}.tmp"
    cmd = ["g++", "-O3", "-shared", "-fPIC", "-std=c++17", _SRC, "-o", tmp]
    try:
        subprocess.run(cmd, check=True, capture_output=True, timeout=120)
        os.replace(tmp, _OUT)
    except Exception:
        try:
            os.remove(tmp)
        except OSError:
            pass
        return None
    return _OUT


def lib():
    """The loaded native library, or None when unavailable."""
    global _lib, _tried
    with _mu:
        if _tried:
            return _lib
        _tried = True
        if os.environ.get("TIDB_TPU_NO_NATIVE"):
            return None
        path = _build()
        if path is None:
            return None
        try:
            lb = ctypes.CDLL(path)
        except OSError:
            return None
        lb.tpu_encode_rows_size.restype = ctypes.c_int64
        lb.tpu_encode_rows_size.argtypes = [
            ctypes.c_int64,
            ctypes.c_int32,
            ctypes.POINTER(ctypes.c_int32),
            ctypes.POINTER(ctypes.c_void_p),
            ctypes.POINTER(ctypes.c_void_p),
            ctypes.c_void_p,
        ]
        lb.tpu_encode_rows.restype = None
        lb.tpu_encode_rows.argtypes = [
            ctypes.c_int64,
            ctypes.c_int32,
            ctypes.POINTER(ctypes.c_int32),
            ctypes.POINTER(ctypes.c_void_p),
            ctypes.POINTER(ctypes.c_void_p),
            ctypes.POINTER(ctypes.c_void_p),
            ctypes.c_void_p,
            ctypes.c_void_p,
            ctypes.c_int64,
            ctypes.c_void_p,
            ctypes.c_void_p,
        ]
        lb.tpu_decode_fixed.restype = None
        lb.tpu_decode_fixed.argtypes = [
            ctypes.c_int64,
            ctypes.c_void_p,
            ctypes.c_void_p,
            ctypes.c_int32,
            ctypes.POINTER(ctypes.c_int32),
            ctypes.POINTER(ctypes.c_int32),
            ctypes.POINTER(ctypes.c_void_p),
            ctypes.POINTER(ctypes.c_void_p),
        ]
        _lib = lb
        return _lib
