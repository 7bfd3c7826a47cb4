"""The lex-sort grouped aggregation of the PyTorch port
(tidb_tpu_torch.ops.dag_kernel, route "lex") against the reference.

Unit parity of the two segmented helpers (``window_core.seg_value_sorted``
and ``_seg_running``) with the reference's on seeded numpy inputs; then every
partial kind — COUNT, SUM, AVG's (count, sum), the variance lanes' sumsq,
MIN/MAX by order statistics, BIT_AND/OR/XOR, first_row — over NULL keys,
all-NULL groups, negative and float values, through the port's engine and
the reference's device and host engines; and a region with more groups than
the starting agg cap, which regrows. Integer, decimal and bit lanes are
exact; float lanes (SUM and sum of squares of a DOUBLE) are held to a
relative 1e-12, since a cumulative sum may associate differently.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import test_torch_engine as te
import torch

import tidb_tpu
from tidb_tpu.copr import host_engine, tpu_engine
from tidb_tpu.executor.load import bulk_load
from tidb_tpu.ops import window_core as ref_wc
from tidb_tpu_torch.copr import gpu_engine
from tidb_tpu_torch.copr.binder import Binder
from tidb_tpu_torch.expression.expr import AggDesc, expr_from_pb
from tidb_tpu_torch.ops import dag_kernel
from tidb_tpu_torch.ops import window_core as wc

FLOAT_RTOL = 1e-12


@pytest.mark.parametrize("dtype", [np.int64, np.int32, np.float64])
@pytest.mark.parametrize("seed", [0, 1])
def test_seg_value_sorted_matches_reference(dtype, seed):
    rng = np.random.default_rng(seed)
    n = 3000
    seg = np.sort(rng.integers(0, 200, n))
    lane = rng.integers(-1000, 1000, n).astype(dtype)
    top = np.inf if dtype == np.float64 else np.iinfo(dtype).max
    lane = np.where(rng.random(n) < 0.2, top, lane).astype(dtype)  # masked rows
    want = np.asarray(ref_wc.seg_value_sorted(jnp, jnp.asarray(lane), jnp.asarray(seg)))
    got = wc.seg_value_sorted(torch.from_numpy(lane), torch.from_numpy(seg)).numpy()
    assert got.dtype == want.dtype and np.array_equal(got, want)


@pytest.mark.parametrize("op", ["bitwise_and", "bitwise_or", "bitwise_xor"])
@pytest.mark.parametrize("n", [1, 7, 1000, 4099])
def test_seg_running_matches_reference(op, n):
    rng = np.random.default_rng(n)
    x = rng.integers(-(1 << 62), 1 << 62, n, dtype=np.int64)
    boundary = rng.random(n) < 0.1
    boundary[0] = True
    ps = np.maximum.accumulate(np.where(boundary, np.arange(n, dtype=np.int32), -1)).astype(np.int32)
    with jax.enable_x64(True):
        want = np.asarray(ref_wc._seg_running(jax, jnp, jnp.asarray(x), jnp.asarray(ps), getattr(jnp, op), n))
    got = wc._seg_running(torch.from_numpy(x), torch.from_numpy(ps), getattr(torch, op), n).numpy()
    assert np.array_equal(got, want)
    # the plain definition: op over the row's group prefix
    fold = {"bitwise_and": np.bitwise_and, "bitwise_or": np.bitwise_or, "bitwise_xor": np.bitwise_xor}[op]
    plain = np.array([fold.reduce(x[ps[i] : i + 1]) for i in range(n)], dtype=np.int64)
    assert np.array_equal(got, plain)


QUERIES = {
    "minmax": """SELECT k, COUNT(a), MIN(a), MAX(a), MIN(f), MAX(f), MIN(b), MAX(b), MIN(s), MAX(s)
  FROM t GROUP BY k""",
    "sums": "SELECT k, s, SUM(a), AVG(a), SUM(f), AVG(f), SUM(b), COUNT(*) FROM t GROUP BY k, s",
    "variance": "SELECT k, VAR_POP(a), STDDEV_SAMP(f), VAR_SAMP(b) FROM t GROUP BY k",
    "bits": "SELECT s, k, BIT_AND(b), BIT_OR(b), BIT_XOR(b) FROM t GROUP BY s, k",
    "bits_scalar": "SELECT BIT_AND(b), BIT_OR(b), BIT_XOR(b), COUNT(*) FROM t WHERE k >= 6",
    "bits_empty": "SELECT BIT_AND(b), BIT_OR(b), BIT_XOR(b) FROM t WHERE k >= 1000",
    "first_row": "SELECT k, ANY_VALUE(s), ANY_VALUE(a), COUNT(*) FROM t GROUP BY k",
    "filtered": "SELECT k, MIN(f), MAX(a), SUM(b) FROM t WHERE a < 0 GROUP BY k",
    # the same lanes on the equality-mask route (a 4-value string key)
    "variance_eqmask": "SELECT s, VAR_POP(a), STDDEV_SAMP(f), VAR_SAMP(b), MIN(a), MAX(f) FROM t GROUP BY s",
}


@pytest.fixture(scope="module")
def tdb():
    """NULL keys; k = 7 has only NULL a and f (all-NULL MIN/MAX groups),
    k = -3 only NULL b; negative decimals, floats and 41-bit ints."""
    db = tidb_tpu.open(region_split_keys=1 << 62)
    db.execute("CREATE TABLE t (k BIGINT, s VARCHAR(4), a DECIMAL(12,2), f DOUBLE, b BIGINT)")
    rng = np.random.default_rng(11)
    n = 3000
    k = rng.integers(-20, 21, n)
    s = np.array([b"aa", b"bb", b"cc", b"dd"], dtype="S2")[rng.integers(0, 4, n)]
    a = rng.integers(-99_999, 100_000, n)
    f = np.round(rng.normal(0, 1000, n), 3)
    b = rng.integers(-(1 << 40), 1 << 40, n)
    null = lambda p: rng.random(n) < p  # noqa: E731
    kn, sn, an, fn, bn = null(0.05), null(0.05), null(0.1), null(0.1), null(0.1)
    cols = [
        [None if kn[i] else int(k[i]) for i in range(n)],
        [None if sn[i] else s[i] for i in range(n)],
        [None if an[i] or k[i] == 7 else int(a[i]) for i in range(n)],
        [None if fn[i] or k[i] == 7 else float(f[i]) for i in range(n)],
        [None if bn[i] or k[i] == -3 else int(b[i]) for i in range(n)],
    ]
    bulk_load(db, "t", cols)
    caps = te._capture(db, QUERIES)
    dag, region, _ranges, ts = caps["sums"]
    return db, caps, te._carry_region(db, dag, region, ts)


def _close(got, want):
    if isinstance(want, float) and isinstance(got, float):
        return math.isclose(got, want, rel_tol=FLOAT_RTOL, abs_tol=1e-9)
    return got == want


def _rows_close(got, want):
    return len(got) == len(want) and all(
        len(g) == len(w) and all(_close(x, y) for x, y in zip(g, w)) for g, w in zip(got, want)
    )


@pytest.mark.parametrize("name", list(QUERIES))
def test_lex_aggregation_matches_reference_engines(tdb, name):
    db, caps, reg = tdb
    dag, region, ranges, ts = caps[name]
    ref = tpu_engine._execute_dag_device(db.store, dag, region, ranges, ts).rows()
    host = host_engine.execute_dag(db.store, dag, region, ranges, ts).rows()
    stats = {}
    got = gpu_engine.execute_region(reg, te._port_dag(dag), te._port_ranges(ranges), device="cpu", stats=stats).rows()
    assert stats["routes"] == (("eqmask",) if name.endswith("_eqmask") else ("lex",))
    assert _rows_close(got, ref)
    if name == "bits_empty":
        # no live row: the sort path reports no group, the host engine one
        # row of the identities (-1, 0, 0) the root's merge starts from
        assert got == [] and host == [(-1, 0, 0)]
        return
    assert _rows_close(sorted(got, key=repr), sorted(host, key=repr))
    if name == "minmax":
        # k = 7: no a or f, so COUNT(a) 0 and NULL extremes (the key is last)
        (k7,) = [r for r in got if r[-1] == 7]
        assert k7[:5] == (0, None, None, None, None) and k7[5] is not None


def test_partial_kinds_cover_every_lane(tdb):
    """The query set reaches every partial kind the program computes."""
    _db, caps, _reg = tdb
    kinds = set()
    for dag, *_ in caps.values():
        for a in dag.executors[-1].aggs:
            kinds.update(AggDesc.from_pb(a).partial_kinds)
    assert kinds == {"count", "sum", "sumsq", "min", "max", "bit_and", "bit_or", "bit_xor", "first_row"}


def test_agg_cap_regrows_past_4096_groups(monkeypatch):
    """5,999 distinct prices over 6,000 rows: the program reruns from a cap
    of 4,096 to 8,192 (the padded row count) and still equals the reference."""
    db = te._lineitem_db()
    caps = te._capture(db, {"prices": "SELECT l_extendedprice, COUNT(*), SUM(l_quantity) FROM lineitem GROUP BY l_extendedprice"})
    dag, region, ranges, ts = caps["prices"]
    reg = te._carry_region(db, dag, region, ts)
    ref = tpu_engine._execute_dag_device(db.store, dag, region, ranges, ts).rows()
    stats = {}
    got = gpu_engine.execute_region(reg, te._port_dag(dag), te._port_ranges(ranges), device="cpu", stats=stats).rows()
    assert len(got) > 4096 and stats["regrows"] == 1 and stats["routes"] == ("lex",)
    assert got == ref


def test_band_takes_the_lex_route_over_one_sf1_region():
    """One SF1 region fuses two 4,194,304-row blocks: n = 8,388,608 exceeds
    K1's 8,000,000 rows, so the 160-bucket band query sorts; the new DAGs
    sort at any size."""
    import json
    import os

    from tidb_tpu_torch.copr import carry

    cols = te.chip_smoke.lineitem_sf1(seed=1, n=3000)
    (reg, _ranges), _ = te.chip_smoke.make_regions(cols, 100)
    for name, n, want in (("band", 1 << 23, "lex"), ("band", 1 << 22, "k1"), ("q18sub", 1 << 23, "lex"),
                          ("q15rev", 1024, "lex"), ("extremes", 1 << 22, "lex")):
        with open(os.path.join(te.FIXTURES, f"{name}.json")) as f:
            dag = carry.dag_from_pb(json.load(f))
        scan = dag.executors[0]
        bound = Binder(reg.cache, scan.table_id, scan.columns, reg.entry).bind_dag(dag)
        ex = bound.executors[-1]
        route, _doms = dag_kernel.agg_route(
            ex, [expr_from_pb(g) for g in ex.group_by], [AggDesc.from_pb(a) for a in ex.aggs],
            bound.executors[0], n, 4096,
        )
        assert route == want, (name, n)
