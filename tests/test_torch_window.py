"""The window program of the PyTorch port (tidb_tpu_torch.ops.window_core
and ops/window_kernel.py) against the reference's, on the CPU.

The same seeded numpy batches go through the reference's
``window_program(jax, jnp, ...)`` (and its jitted ``get_window_fn``) and the
port's. Every ``SUPPORTED`` function runs under each frame tag (whole
partition, ROWS and RANGE UNBOUNDED..CURRENT, and bounded ROWS frames with
every start and end kind), over the int32 packed sort, the int64 packed
sort and the chain of stable argsorts (a float order key, no bounds), with
descending keys, NULL partition and order keys, dead rows (padding and
filtered rows), lead and lag with a NULL and a constant default, and extra
lanes that ride the sort. The permutation, the sorted live mask and every
integer, decimal, ``percent_rank`` and ``cume_dist`` lane are exact; the
float SUM and AVG lanes are held to a relative 1e-12 of the prefix
magnitude (a cumulative sum may associate differently).
"""

import os
import sys
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke  # noqa: E402
from tidb_tpu.expression import expr as ref_expr  # noqa: E402
from tidb_tpu.ops import window_core as ref_wc  # noqa: E402
from tidb_tpu.ops import window_kernel as ref_wk  # noqa: E402
from tidb_tpu.types import field_type as ref_ft  # noqa: E402
from tidb_tpu_torch.expression import expr as port_expr  # noqa: E402
from tidb_tpu_torch.ops import window_core as wc  # noqa: E402
from tidb_tpu_torch.ops import window_kernel as wk  # noqa: E402
from tidb_tpu_torch.types import field_type as port_ft  # noqa: E402

FLOAT_REL = 1e-12

FRAMES = [
    "whole",
    "rows_cur",
    "range_cur",
    ("rows", "unbounded", 0, "current", 0),
    ("rows", "unbounded", 0, "unbounded", 0),
    ("rows", "preceding", 3, "following", 1),
    ("rows", "preceding", 5, "preceding", 2),
    ("rows", "preceding", 2, "current", 0),
    ("rows", "current", 0, "following", 2),
    ("rows", "current", 0, "unbounded", 0),
    ("rows", "following", 1, "following", 4),
    ("rows", "following", 2, "unbounded", 0),
    ("rows", "preceding", 4, "unbounded", 0),
]

# (name, has_arg, arg_is_float, c0, c1, c2_is_float) and the arg lane it reads
FUNCS = chip_smoke.WINDOW_SPECS


def _batch(sort: str, n: int, seed: int, n_part: int):
    """(mask, part lanes, order lanes, descs, arg lanes by kind, bounds)."""
    return chip_smoke.window_batch(sort, n, seed, n_part)


def _reference(mask, parts, orders, descs, frame, specs, arg_lanes, n, bounds, extra=None):
    j = lambda p: (jnp.asarray(p[0]), jnp.asarray(p[1]))  # noqa: E731
    with jax.enable_x64(True):
        res = ref_wc.window_program(
            jax, jnp, mask=jnp.asarray(mask), part_lanes=[j(p) for p in parts],
            order_lanes=[j(p) for p in orders], order_descs=descs, frame_tag=frame, specs=specs,
            arg_lanes=[j(a) if a is not None else None for a in arg_lanes], n=n, bounds=bounds,
            extra_lanes=[j(e) for e in extra] if extra is not None else None,
        )
        return jax.tree_util.tree_map(np.asarray, res)


def _port(mask, parts, orders, descs, frame, specs, arg_lanes, n, bounds, extra=None):
    t = lambda p: (torch.from_numpy(p[0]), torch.from_numpy(p[1]))  # noqa: E731
    res = wc.window_program(
        mask=torch.from_numpy(mask), part_lanes=[t(p) for p in parts], order_lanes=[t(p) for p in orders],
        order_descs=descs, frame_tag=frame, specs=specs,
        arg_lanes=[t(a) if a is not None else None for a in arg_lanes], n=n, bounds=bounds,
        extra_lanes=[t(e) for e in extra] if extra is not None else None,
    )
    out = [[(d.numpy(), v.numpy()) for d, v in res[0]], res[1].numpy(), res[2].numpy()]
    if extra is not None:
        out.append([(d.numpy(), v.numpy()) for d, v in res[3]])
    return out


def _assert_lane(spec, got, want, arg):
    name, _has_arg, is_f = spec[:3]
    (gd, gv), (wd, wv) = got, want
    assert np.array_equal(gv, wv), spec
    gd, wd = np.where(wv, gd, 0), np.where(wv, wd, 0)
    if is_f and name in ("sum", "avg"):
        mag = max(float(np.abs(arg[0][arg[1]]).sum()), 1.0)
        assert np.allclose(gd, wd, rtol=0, atol=FLOAT_REL * mag), spec
    elif wd.dtype.kind == "f" or gd.dtype.kind == "f":
        assert np.array_equal(gd.astype(np.float64), wd.astype(np.float64)), spec
    else:
        assert np.array_equal(gd.astype(np.int64), wd.astype(np.int64)), spec


def _check(sort, frame, funcs, n=2000, seed=0, n_part=1, extra=None):
    mask, parts, orders, descs, args, bounds = _batch(sort, n, seed, n_part)
    specs = tuple(f for f, _ in funcs)
    arg_lanes = [args[k] if k else None for _, k in funcs]
    if sort != "multilane":
        assert wc.packed_bits(bounds, n) is not None
    want = _reference(mask, parts, orders, descs, frame, specs, arg_lanes, n, bounds, extra)
    got = _port(mask, parts, orders, descs, frame, specs, arg_lanes, n, bounds, extra)
    assert np.array_equal(got[1], want[1].astype(np.int64)), "sort permutation"
    assert np.array_equal(got[2], want[2]), "sorted live mask"
    for (spec, k), g, w in zip(funcs, got[0], want[0]):
        _assert_lane(spec, g, w, args[k] if k else (np.zeros(n), mask))
    return got, want


def _frame_funcs(frame):
    if isinstance(frame, tuple):  # sliding MIN/MAX is a host sweep (derive_specs)
        return [f for f in FUNCS if f[0][0] not in ("min", "max")]
    return FUNCS


@pytest.mark.parametrize("frame", FRAMES, ids=str)
@pytest.mark.parametrize("sort", ["int32", "int64", "multilane"])
def test_window_program_matches_reference(sort, frame):
    _check(sort, frame, _frame_funcs(frame), seed=len(str(frame)))


@pytest.mark.parametrize("n_part", [0, 2])
@pytest.mark.parametrize("sort", ["int32", "multilane"])
def test_partition_count_matches_reference(sort, n_part):
    # no partition key (one partition of every live row) and two keys
    _check(sort, "range_cur", FUNCS, n=1500, seed=3 + n_part, n_part=n_part)


@pytest.mark.parametrize("sort", ["int32", "int64", "multilane"])
def test_extra_lanes_ride_the_sort(sort):
    rng = np.random.default_rng(11)
    n = 1800
    extra = [
        (rng.integers(-50, 50, n), rng.random(n) > 0.2),
        (rng.random(n), np.ones(n, dtype=bool)),
    ]
    got, want = _check(sort, "rows_cur", FUNCS[:6], n=n, seed=5, extra=extra)
    for (gd, gv), (wd, wv) in zip(got[3], want[3]):
        assert np.array_equal(gd, wd) and np.array_equal(gv, wv)


def test_sort_kinds_take_their_routes():
    """The three cases reach the int32 key, the int64 key and the chain."""
    for sort, want_bits in (("int32", range(2, 32)), ("int64", range(32, 63))):
        mask, parts, orders, descs, _args, bounds = _batch(sort, 2000, 0, 1)
        widths = wc.packed_bits(bounds, 2000)
        total = 1 + sum(max(int(w - 1).bit_length(), 1) for w in widths)
        assert total in want_bits, (sort, total)
        t = lambda p: (torch.from_numpy(p[0]), torch.from_numpy(p[1]))  # noqa: E731
        key_lanes = [t(p) for p in parts + orders]
        perm, skey, _spans, _ = wc.packed_sort(torch.from_numpy(mask), key_lanes, [False] + descs, 2000, bounds)
        assert skey is not None and np.array_equal(perm.numpy(), wc.sort_perm(
            torch.from_numpy(mask), key_lanes, [False] + descs, 2000, bounds).numpy())
    mask, parts, orders, descs, _args, bounds = _batch("multilane", 2000, 0, 1)
    assert bounds is None


@pytest.mark.parametrize("n", [1, 2, 7, 1000, 4096])
@pytest.mark.parametrize("case", [
    [(0, 3), (0, 100)],
    [(-5, 5)],
    [(0, 0)],
    [(3, 2)],  # hi < lo
    [(0, 1 << 20), (-(1 << 19), 1 << 19)],
    [(0, 1 << 30), (0, 1 << 30)],  # past 62 bits
    [(0, 7), None],
    [],
    None,
])
def test_packed_bits_matches_reference(case, n):
    assert wc.packed_bits(case, n) == ref_wc.packed_bits(case, n)


def test_widen_bounds_matches_reference():
    cases = [None, (0, 0), (0, 1), (-1, 0), (-1000, 1000), (5, 7), (-(1 << 40), 1 << 33), (-3, -2)]
    assert wc.widen_bounds(cases) == ref_wc.widen_bounds(cases)


def _desc(mod_expr, mod_ft, name, args, ret):
    """One WindowFuncDesc-like in either package: args as (kind, value)."""
    types = {
        "int": mod_ft.bigint_type(),
        "float": mod_ft.double_type(),
        "dec": mod_ft.decimal_type(12, 2),
        "str": mod_ft.string_type(),
        "date": mod_ft.date_type(),
    }
    out = []
    for kind, val in args:
        if kind == "col":
            out.append(mod_expr.ColumnRef(0, types[val]))
        else:
            out.append(mod_expr.Constant(val, types[kind]))
    ret_ft = mod_ft.decimal_type(16, 6) if ret == "dec6" else types[ret]
    return SimpleNamespace(name=name, args=out, ftype=ret_ft)


DERIVE_CASES = [
    ("row_number", [], "int"),
    ("rank", [], "int"),
    ("percent_rank", [], "float"),
    ("ntile", [("int", 4)], "int"),
    ("ntile", [("int", 0)], "int"),  # k <= 0: host
    ("ntile", [("int", None)], "int"),
    ("ntile", [("col", "int")], "int"),  # not a constant: host
    ("lead", [("col", "int")], "int"),
    ("lead", [("col", "int"), ("int", 3)], "int"),
    ("lag", [("col", "int"), ("int", 2), ("int", -7)], "int"),
    ("lag", [("col", "dec"), ("int", 1), ("dec", "1.25")], "dec"),
    ("lag", [("col", "float"), ("int", 1), ("float", 2.5)], "float"),
    ("lag", [("col", "int"), ("int", 1), ("int", None)], "int"),
    ("lag", [("col", "date"), ("int", 1), ("date", "2020-01-02")], "date"),
    ("lag", [("col", "int"), ("int", 1), ("str", "x")], "int"),  # string default: host
    ("lag", [("col", "int"), ("col", "int")], "int"),  # offset not a constant: host
    ("lead", [("col", "int"), ("int", None)], "int"),
    ("first_value", [("col", "str")], "str"),  # string argument: host
    ("last_value", [("col", "float")], "float"),
    ("count", [], "int"),
    ("sum", [("col", "dec")], "dec"),
    ("avg", [("col", "dec")], "dec6"),
    ("avg", [("col", "float")], "float"),
    ("min", [("col", "int")], "int"),
    ("max", [("col", "float")], "float"),
    ("nth_value", [("col", "int"), ("int", 2)], "int"),  # unsupported name
]


@pytest.mark.parametrize("frame", [None, ("preceding", 2, "following", 1)], ids=str)
@pytest.mark.parametrize("whole,rows,order_is_string", [(True, False, False), (False, True, False),
                                                         (False, False, False), (False, False, True)])
@pytest.mark.parametrize("case", range(len(DERIVE_CASES)))
def test_derive_specs_matches_reference(case, whole, rows, order_is_string, frame):
    name, args, ret = DERIVE_CASES[case]
    kw = dict(whole_partition=whole, rows_frame=rows, frame=frame, order_is_string=order_is_string)
    want = ref_wc.derive_specs([_desc(ref_expr, ref_ft, name, args, ret)], **kw)
    got = wc.derive_specs([_desc(port_expr, port_ft, name, args, ret)], **kw)
    assert got == want


def test_derive_specs_matrix_of_several_functions():
    funcs = [DERIVE_CASES[i] for i in (0, 3, 9, 10, 20, 21, 23)]
    kw = dict(whole_partition=False, rows_frame=False, frame=None, order_is_string=False)
    want = ref_wc.derive_specs([_desc(ref_expr, ref_ft, *f) for f in funcs], **kw)
    got = wc.derive_specs([_desc(port_expr, port_ft, *f) for f in funcs], **kw)
    assert got == want and got is not None and len(got[1]) == len(funcs)


@pytest.mark.parametrize("sort", ["int32", "int64", "multilane"])
@pytest.mark.parametrize("frame", ["range_cur", ("rows", "preceding", 3, "following", 1)], ids=str)
def test_window_fn_restores_row_order_like_the_reference(sort, frame):
    """get_window_fn: the program plus the inverse permutation, against the
    reference's jitted window function on the same padded lanes."""
    n = 2048
    mask, parts, orders, descs, args, bounds = _batch(sort, n, 21, 1)
    nvalid = int(np.flatnonzero(mask).max()) + 1
    funcs = [f for f in _frame_funcs(frame) if f[0][0] != "ntile" or f[0][3] == 4]
    specs = tuple(f for f, _ in funcs)
    spec = (len(parts), tuple(descs), frame, specs)
    arg_lanes = [args[k] for _, k in funcs if k]
    bkey = tuple(bounds) if bounds is not None else None
    j = lambda p: (jnp.asarray(p[0]), jnp.asarray(p[1]))  # noqa: E731
    t = lambda p: (torch.from_numpy(p[0]), torch.from_numpy(p[1]))  # noqa: E731
    with jax.enable_x64(True):
        want = [np.asarray(x) for x in ref_wk.get_window_fn(spec, n, bkey)(
            tuple(j(p) for p in parts), tuple(j(p) for p in orders), tuple(j(a) for a in arg_lanes), np.int64(nvalid))]
    got = [x.numpy() for x in wk.get_window_fn(spec, n, bkey)(
        tuple(t(p) for p in parts), tuple(t(p) for p in orders), tuple(t(a) for a in arg_lanes), nvalid, "cpu")]
    assert len(got) == len(want) == 2 * len(funcs)
    for i, (f, k) in enumerate(funcs):
        _assert_lane(f, (got[2 * i], got[2 * i + 1]), (want[2 * i], want[2 * i + 1]), args[k] if k else None)


@pytest.mark.parametrize("n,lanes,funcs", [(1_000, 2, 1), (100_000, 3, 2), (5_000_000, 3, 5), (1 << 24, 1, 1)])
def test_cost_model_is_monotone_in_rows(n, lanes, funcs):
    """The device's fixed cost loses on a tiny batch and wins on a large
    one; the choice flips once as n grows."""
    assert not wk.device_beats_host(1, lanes, funcs)
    if wk.device_beats_host(n, lanes, funcs):
        assert wk.device_beats_host(2 * n, lanes, funcs)
