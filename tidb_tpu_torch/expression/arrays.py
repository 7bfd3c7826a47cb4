"""numpy's spelling over torch tensors: the array namespace the ``gpu``
engine hands every builtin body in ``expression/eval.py``.

The builtin bodies are written once against an array namespace ``xp``:
numpy on the host engine, and this module on the device (``eval_expr``
maps ``torch`` to it). Plain ``torch`` is the wrong namespace for them:

- torch's functions take no Python scalars, and a builtin's constant
  argument arrives as one;
- a Python float meeting an integer tensor, and ``/`` between integer
  tensors, give torch's default float32, where numpy and the reference's
  ``jax.numpy`` under x64 give float64;
- the spellings differ (``arcsin``, ``power``, ``clip``,
  ``zeros(n, bool)``, ``.astype``).

So every function here first lowers a Python scalar to a 0-d tensor of
its own width (bool, int64, float64). Within one kind a 0-d tensor yields
to the lane it meets, as a Python scalar does in numpy (an int32 lane
stays int32); across kinds its float64 wins. A 0-d CPU tensor may meet
CUDA tensors in any elementwise op, so a constant needs no device. Every
float function computes in float64.

The helpers below the namespace (``astype``, ``to_f64``, ``true_div``,
``dec_to_f64``, ``to_i64``, ``zeros_n``, ``logical_shr``, ``popcount64``)
take the namespace as their first argument. For numpy they compute
exactly what the reference's body computes, so the host engine's results
stay the reference's bit for bit. No function reads a tensor's value on
the host: a body never synchronises with the card.
"""

from __future__ import annotations

import sys

_I64_MAX = (1 << 63) - 1
_I64_MIN = -(1 << 63)


def _torch():
    import torch

    return torch


def __getattr__(name):
    # the dtype spellings the bodies use (xp.int32, xp.int64) resolve to
    # torch's lazily: importing this module must not import torch
    if name in ("int32", "int64"):
        return getattr(_torch(), name)
    raise AttributeError(name)


def is_device(xp) -> bool:
    """True when ``xp`` is this namespace or torch itself (the body runs on
    tensors)."""
    return xp is sys.modules[__name__] or getattr(xp, "__name__", "") == "torch"


def _dtype(dtype):
    torch = _torch()
    if isinstance(dtype, torch.dtype):
        return dtype
    if dtype is bool or dtype == "bool":
        return torch.bool
    return getattr(torch, str(dtype))


def _t(x):
    torch = _torch()
    if isinstance(x, torch.Tensor):
        return x
    if isinstance(x, bool):
        return torch.tensor(x)
    if isinstance(x, int):
        return torch.tensor(x, dtype=torch.int64)
    if isinstance(x, float):
        return torch.tensor(x, dtype=torch.float64)
    return torch.as_tensor(x)  # numpy scalars and arrays keep their dtype


def _f(x):
    t = _t(x)
    return t if t.is_floating_point() else t.to(_torch().float64)


# -- the namespace -------------------------------------------------------------


def asarray(x, dtype=None):
    t = _t(x)
    return t if dtype is None else t.to(_dtype(dtype))


def where(c, a, b):
    return _torch().where(_t(c), _t(a), _t(b))


def sum(x):  # noqa: A001  (numpy's name; a 0-d int64 count for a bool lane)
    return _torch().sum(_t(x))


def broadcast_to(x, shape):
    t = _t(x)
    # a constant stays a 0-d CPU tensor: it broadcasts against the lanes it
    # meets on any device, where a CPU tensor expanded to n rows would not
    return t if t.dim() == 0 and t.device.type == "cpu" else t.expand(shape)


def abs(x):  # noqa: A001  (numpy's name)
    return _t(x).abs()


def sign(x):
    return _t(x).sign()


def floor(x):
    return _f(x).floor()


def ceil(x):
    return _f(x).ceil()


def trunc(x):
    return _f(x).trunc()


def sqrt(x):
    return _f(x).sqrt()


def exp(x):
    return _f(x).exp()


def log(x):
    return _f(x).log()


def log2(x):
    return _f(x).log2()


def log10(x):
    return _f(x).log10()


def sin(x):
    return _f(x).sin()


def cos(x):
    return _f(x).cos()


def tan(x):
    return _f(x).tan()


def arcsin(x):
    return _f(x).asin()


def arccos(x):
    return _f(x).acos()


def arctan(x):
    return _f(x).atan()


def arctan2(y, x):
    return _torch().atan2(_f(y), _f(x))


def power(a, b):
    return _torch().pow(_f(a), _f(b))


def fmod(a, b):
    return _torch().fmod(_t(a), _t(b))


def maximum(a, b):
    return _torch().maximum(*_common(a, b))


def minimum(a, b):
    return _torch().minimum(*_common(a, b))


def clip(x, lo, hi):
    return _t(x).clamp(lo, hi)


def _common(a, b):
    # torch.maximum/minimum want one dtype; promote as an elementwise op would
    ta, tb = _t(a), _t(b)
    dt = _torch().result_type(ta, tb)
    return ta.to(dt), tb.to(dt)


# -- helpers shared by numpy and this namespace --------------------------------


_PY = {"int32": int, "int64": int, "float64": float, "bool": bool}


def astype(xp, x, dtype):
    """``x.astype(dtype)``, and a Python scalar converted (``dtype`` a
    name: "int32", "int64", "float64" or "bool"; or numpy's type)."""
    if is_device(xp):
        return _t(x).to(_dtype(dtype))
    if hasattr(x, "astype"):
        return x.astype(dtype)
    return _PY[getattr(dtype, "__name__", dtype)](x)


def to_f64(xp, x):
    """``x`` as float64 before any arithmetic (numpy: ``x * 1.0``, which
    widens an integer exactly as numpy's promotion would)."""
    if is_device(xp):
        return _t(x).to(_torch().float64)
    return x * 1.0


def true_div(xp, a, b):
    """``a / b``, correctly rounded. On a card torch divides by a CPU scalar
    (a Python number, a 0-d CPU tensor) as a product with its reciprocal,
    one bit short of the quotient numpy and XLA give; the device divides by
    a 0-d tensor on the dividend's device instead."""
    if not is_device(xp):
        return a / b
    torch = _torch()
    a = _t(a)
    if not isinstance(b, torch.Tensor) or (b.dim() == 0 and b.device != a.device):
        b = torch.full((), float(b), dtype=torch.float64, device=a.device)
    return a / b


def dec_to_f64(xp, d, scale: int):
    """A decimal's scaled integer ``d`` as float64: ``d / 10**scale``. A
    Python integer divides in Python, correctly rounded, as it does under
    numpy; a tensor widens to float64 first (torch would divide an integer
    tensor in float32)."""
    if is_device(xp) and isinstance(d, _torch().Tensor):
        return true_div(xp, d.to(_torch().float64), 10**scale)
    return d / (10**scale)


def to_i64(xp, x):
    """``x.astype("int64")``. From a float, numpy casts as C does (out of
    range and NaN give INT64_MIN on x86); the device saturates and maps NaN
    to 0, as the reference's XLA conversion does (a plain torch cast
    differs between the CPU and the card)."""
    if not is_device(xp):
        return x.astype("int64") if hasattr(x, "astype") else int(x)
    torch = _torch()
    x = _t(x)
    if not x.is_floating_point():
        return x.to(torch.int64)
    inner = torch.where(torch.isnan(x), 0.0, x).clamp(float(_I64_MIN), 9223372036854774784.0)
    return torch.where(x >= 9223372036854775808.0, _I64_MAX, inner.to(torch.int64))


def zeros_n(xp, n: int, dtype, like=None):
    """``xp.zeros(n, dtype)``, on the device of the first tensor in ``like``."""
    if not is_device(xp):
        return xp.zeros(n, dtype)
    torch = _torch()
    dev = next((t.device for t in (like or ()) if isinstance(t, torch.Tensor)), None)
    return torch.zeros(n, dtype=_dtype(dtype), device=dev)


def logical_shr(xp, a, s):
    """``a >> s`` on the unsigned 64-bit pattern of int64 ``a``, for
    0 <= s <= 63 (numpy: through a uint64 view; the device: an arithmetic
    shift masked to the low 64 - s bits, since torch's uint64 lacks
    kernels on the card)."""
    if not is_device(xp):
        return (a.astype(xp.uint64) >> s.astype(xp.uint64)).astype(xp.int64)
    torch = _torch()
    a, s = _t(a).to(torch.int64), _t(s).to(torch.int64)
    s1 = s.clamp(1, 63)
    return torch.where(s == 0, a, (a >> s1) & (_I64_MAX >> (s1 - 1)))


def popcount64(xp, d):
    """Set bits of the two's-complement 64-bit pattern (MySQL
    BIT_COUNT(-1) = 64) → int64. torch has no bitwise_count: SWAR over the
    two 32-bit halves, each held non-negative so no shift sees a sign bit."""
    if not is_device(xp):
        import numpy as np

        arr = np.atleast_1d(np.asarray(d, dtype=np.int64)).view(np.uint64)
        return np.unpackbits(arr.view(np.uint8)).reshape(len(arr), 64).sum(axis=1).astype(np.int64)
    d = _t(d).to(_torch().int64)
    total = 0
    for half in (d & 0xFFFFFFFF, (d >> 32) & 0xFFFFFFFF):
        x = half - ((half >> 1) & 0x55555555)
        x = (x & 0x33333333) + ((x >> 2) & 0x33333333)
        x = (x + (x >> 4)) & 0x0F0F0F0F
        total = total + (((x * 0x01010101) & 0xFFFFFFFF) >> 24)
    return _torch().atleast_1d(total)
