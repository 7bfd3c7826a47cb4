"""Every builtin the reference may run on its ``tpu`` engine, held body by
body against the port on the same inputs.

Each case (``chip_smoke.BUILTIN_CASES``: per builtin its argument
signatures over ints up to ±2^62 with zeros and negatives, DECIMAL(12,2)
and DECIMAL(20,6), doubles up to 1e300, dates from 0001-01-01 to
9999-12-31 with Feb 29 and month ends, datetimes, durations, int32 lanes,
constants and NULL constants) builds one ``ScalarFunc`` in both packages
and evaluates it three ways over the same 512-row columns with NULLs, made
from ``np.random.default_rng``:

- the reference with ``jax.numpy`` under x64, as its ``tpu`` engine traces it;
- the port with ``torch`` on the CPU, as its ``gpu`` engine runs it;
- the port with ``numpy``, as its ``host`` engine runs it.

Integer, decimal, date and boolean lanes must be exact and validity equal;
doubles agree to a relative 1e-12 (``_REL``). A double result must be
float64 on the torch path. The port's numpy path must stay the reference's
numpy path bit for bit, because the port's host engine runs the same bodies.
Data under a NULL row is not compared: no engine reads it.
"""

import os
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke  # noqa: E402
import tidb_tpu.expression.expr as ref_expr  # noqa: E402
import tidb_tpu_torch.expression.expr as port_expr  # noqa: E402
from tidb_tpu.expression.registry import REGISTRY as REF_REGISTRY  # noqa: E402
from tidb_tpu.types import FieldType as RefFT, TypeKind as RefTK  # noqa: E402
from tidb_tpu_torch.expression.registry import REGISTRY as PORT_REGISTRY  # noqa: E402
from tidb_tpu_torch.types import FieldType as PortFT, TypeKind as PortTK  # noqa: E402

N = 512
_REL = 1e-12

TPU_LEGAL = sorted(n for n, s in REF_REGISTRY.items() if "tpu" in s.engines)


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The lanes are small; one intra-op thread keeps this module from
    loading every core of the machine the other test workers share."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _build(pkg, name, lanes, ret=None):
    if pkg == "ref":
        return chip_smoke.builtin_expr(ref_expr, RefFT, RefTK, name, lanes, ret)
    return chip_smoke.builtin_expr(port_expr, PortFT, PortTK, name, lanes, ret)


def _run(pkg, xp, name, lanes, ret=None):
    e = _build(pkg, name, lanes, ret)
    expr_mod = ref_expr if pkg == "ref" else port_expr
    cols = []
    for lane in lanes:
        if lane[0] != "col":
            continue
        d, v = lane[2], lane[3]
        if xp is torch:
            cols.append((torch.from_numpy(d.copy()), torch.from_numpy(v.copy())))
        elif xp is jnp:
            cols.append((jnp.asarray(d), jnp.asarray(v)))
        else:
            cols.append((d.copy(), v.copy()))
    batch = expr_mod.EvalBatch(cols, [None] * len(cols), N)
    d, v, _ = expr_mod.eval_expr(e, batch, xp)
    return d, v, e.ftype


def _np(x):
    return np.asarray(x.numpy() if isinstance(x, torch.Tensor) else x)


def _norm(d, v):
    d = np.broadcast_to(_np(d), (N,))
    if v is None or v is True:
        v = np.ones(N, bool)
    elif v is False:
        v = np.zeros(N, bool)
    else:
        v = np.broadcast_to(_np(v).astype(bool), (N,))
    return d, v


_TINY = 2.2250738585072014e-308  # the least normal double

# Loosenings, each for one name and one reason:
# - jax on the CPU flushes subnormal doubles to zero (XLA's FTZ); torch and
#   numpy keep them, so a subnormal result compares as zero (every float
#   name against jnp);
# - ``mod`` on doubles: where |x / y| overflows a double, numpy and CUDA's
#   fmod stay exact, XLA's CPU fmod returns 0 and torch's vectorized CPU
#   fmod NaN; those rows are not compared against jnp;
# - ``last_day`` and ``date_add_months`` on DATETIME: the reference's jnp
#   body keeps its day numbers in int32 (``jnp.where(m > 2, -3, 9)`` is a
#   weak int, where numpy's is int64) and wraps ``days * 86_400_000_000``,
#   a reference defect; the port is held against the reference's numpy
#   body there, which is also what the reference's host engine returns.
JNP_WRAPS_I32 = {("last_day", "ts"), ("date_add_months", "ts")}


def _skip_rows(name, lanes):
    if name != "mod":
        return None
    vals = [np.broadcast_to(np.asarray(ln[2] if ln[0] == "col" else (ln[2] or 0), dtype=np.float64), (N,)) for ln in lanes]
    with np.errstate(all="ignore"):
        return np.isinf(vals[0] / vals[1]) & np.isfinite(vals[0])


def _same(name, label, got, want, is_float, exact=False, skip=None):
    (gd, gv), (wd, wv) = _norm(*got), _norm(*want)
    assert np.array_equal(gv, wv), f"{name} {label}: validity differs at rows {np.nonzero(gv != wv)[0][:8]}"
    if is_float:
        gd, wd = gd.astype(np.float64), wd.astype(np.float64)
        if exact:
            close = (gd.view(np.int64) == wd.view(np.int64)) | (np.isnan(gd) & np.isnan(wd))
        else:
            gd = np.where(np.abs(gd) < _TINY, 0.0, gd)
            wd = np.where(np.abs(wd) < _TINY, 0.0, wd)
            close = np.isclose(gd, wd, rtol=_REL, atol=0.0, equal_nan=True) | (gd == wd)
    else:
        assert gd.dtype.kind in "iub" and wd.dtype.kind in "iub", f"{name} {label}: {gd.dtype} vs {wd.dtype}"
        close = gd.astype(np.int64) == wd.astype(np.int64)
    if skip is not None:
        close = close | skip
    bad = np.nonzero(~close & wv)[0]
    assert not len(bad), f"{name} {label}: rows {bad[:6]}: {gd[bad[:6]]} != {wd[bad[:6]]}"


def test_every_tpu_builtin_has_cases():
    assert sorted(chip_smoke.BUILTIN_CASES) == TPU_LEGAL


def test_gpu_legal_set_equals_tpu_legal_set():
    gpu = sorted(n for n, s in PORT_REGISTRY.items() if "gpu" in s.engines)
    assert len(TPU_LEGAL) == 91
    assert gpu == TPU_LEGAL
    for name, spec in REF_REGISTRY.items():
        want = {"gpu" if e == "tpu" else e for e in spec.engines}
        assert set(PORT_REGISTRY[name].engines) == want, name


@pytest.mark.parametrize("name", TPU_LEGAL)
def test_builtin_matches_reference(name):
    for ci, (sig, ret) in enumerate(chip_smoke.builtin_cases(name)):
        lanes = chip_smoke.builtin_lanes(sig, np.random.default_rng(1000 * TPU_LEGAL.index(name) + ci), N)
        label = f"{sig}" + (f" -> DECIMAL{ret}" if ret else "")
        ref_j = _run("ref", jnp, name, lanes, ret)
        ref_n = _run("ref", np, name, lanes, ret)
        port_t = _run("port", torch, name, lanes, ret)
        port_n = _run("port", np, name, lanes, ret)
        is_float = ref_j[2].kind == RefTK.FLOAT
        assert not isinstance(port_t[0], np.ndarray), f"{name} {label}: the torch path returned numpy"
        if is_float and isinstance(port_t[0], torch.Tensor):
            assert port_t[0].dtype == torch.float64, f"{name} {label}: torch computed {port_t[0].dtype}"
        want = ref_n if (name, sig[0]) in JNP_WRAPS_I32 else ref_j
        _same(name, label + " torch vs reference", port_t[:2], want[:2], is_float, skip=_skip_rows(name, lanes))
        _same(name, label + " numpy vs reference numpy", port_n[:2], ref_n[:2], is_float, exact=True)


@pytest.mark.parametrize("name", TPU_LEGAL)
def test_builtin_keeps_to_its_lanes_device(name):
    """Every case with its columns on torch's ``meta`` device: no body may
    put a lane-sized tensor on the CPU beside a device lane (on a card that
    raises), nor read a tensor's value on the host. A Python constant may
    stay a 0-d CPU tensor, which torch lets meet any device."""
    for sig, ret in chip_smoke.builtin_cases(name):
        lanes = chip_smoke.builtin_lanes(sig, np.random.default_rng(0), 64)
        e = _build("port", name, lanes, ret)
        cols = [(torch.from_numpy(ln[2]).to("meta"), torch.from_numpy(ln[3]).to("meta")) for ln in lanes if ln[0] == "col"]
        d, v, _ = port_expr.eval_expr(e, port_expr.EvalBatch(cols, [None] * len(cols), 64), torch)
        for x in (d, v):
            if isinstance(x, torch.Tensor) and x.dim() > 0:
                assert x.device.type == "meta", f"{name} {sig}: a lane on {x.device}"
