"""MPP shape breadth on the port, held against the reference: the
statements of ``tests/test_mpp_shapes.py`` (outer, semi and anti joins,
MIN/MAX, string join keys over unified dictionaries, partitioned tables,
right outer joins under both exchanges, distinct aggregates) through both
packages at forced widths 1 and 4 (``test_torch_sql_mpp.check``)."""

import os
import sys

import numpy as np
import pytest

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import test_torch_sql_mpp as sm  # noqa: E402
from tidb_tpu.parallel import gather as ref_gather  # noqa: E402
from tidb_tpu_torch.parallel import gather  # noqa: E402

one_torch_thread = sm.one_torch_thread


def _shapes_db(db, bulk_load):
    rng = np.random.default_rng(11)
    n_orders, nj = 3000, 40000
    db.execute("CREATE TABLE orders (o_orderkey BIGINT PRIMARY KEY, o_odate BIGINT, o_tag VARCHAR(4))")
    db.execute("CREATE TABLE li (l_orderkey BIGINT, l_price DECIMAL(12,2), l_tag VARCHAR(4))")
    tags = np.array([b"aa", b"bb", b"cc", b"dd"], dtype="S2")
    bulk_load(db, "orders", [np.arange(n_orders), 8036 + rng.integers(0, 50, n_orders), tags[rng.integers(0, 4, n_orders)]])
    # some probe keys reference nothing (order keys past n_orders): outer/anti shapes
    bulk_load(db, "li", [rng.integers(0, n_orders + 500, nj), rng.integers(1000, 90000, nj), tags[rng.integers(0, 4, nj)]])
    db.execute("INSERT INTO li VALUES (NULL, 5.00, NULL)")
    db.execute("ANALYZE TABLE orders")
    db.execute("ANALYZE TABLE li")
    db.execute("CREATE TABLE pli (l_orderkey BIGINT, l_price DECIMAL(12,2)) PARTITION BY HASH (l_orderkey) PARTITIONS 4")
    prng = np.random.default_rng(3)
    db.execute(
        "INSERT INTO pli VALUES "
        + ",".join(f"({int(k)}, {int(v)}.00)" for k, v in zip(prng.integers(0, 3000, 3000), prng.integers(1, 900, 3000)))
    )
    db.execute("ANALYZE TABLE pli")
    db.execute("CREATE TABLE dates (d_date BIGINT PRIMARY KEY, d_week BIGINT)")
    bulk_load(db, "dates", [np.arange(8036, 8086), np.arange(50) // 7])
    db.execute("CREATE TABLE dates2 (d_date BIGINT PRIMARY KEY, d_week BIGINT)")
    bulk_load(db, "dates2", [np.arange(8036, 8086), np.arange(50) % 5])
    db.execute("CREATE TABLE pagg (k BIGINT, v BIGINT) PARTITION BY HASH (k) PARTITIONS 4")
    arng = np.random.default_rng(5)
    bulk_load(db, "pagg", [arng.integers(0, 50, 5000), arng.integers(1, 100, 5000)])


@pytest.fixture(scope="module")
def db():
    return sm.both_open(_shapes_db, region_split_keys=1 << 62)


ENFORCE = {"session_sql": ("SET tidb_enforce_mpp = 1",)}
SHAPES = {
    "left_outer_agg": ("SELECT o_odate, COUNT(*), SUM(l_price) FROM li LEFT JOIN orders"
                       " ON l_orderkey = o_orderkey GROUP BY o_odate ORDER BY o_odate", {"ordered": True}),
    "min_max": ("SELECT o_odate, MIN(l_price), MAX(l_price), COUNT(*) FROM li, orders"
                " WHERE l_orderkey = o_orderkey GROUP BY o_odate ORDER BY o_odate", {"ordered": True}),
    "anti_join": ("SELECT COUNT(*), SUM(l_price) FROM li"
                  " WHERE NOT EXISTS (SELECT 1 FROM orders WHERE o_orderkey = l_orderkey)", {}),
    "string_join_keys": ("SELECT o_tag, COUNT(*), SUM(l_price) FROM li, orders"
                         " WHERE l_tag = o_tag GROUP BY o_tag ORDER BY o_tag", {"ordered": True}),
    "partitioned_probe": ("SELECT o_odate, COUNT(*), SUM(l_price) FROM pli, orders"
                          " WHERE l_orderkey = o_orderkey GROUP BY o_odate ORDER BY o_odate", {"ordered": True}),
    "left_after_inner": ("SELECT d_week, COUNT(*) FROM li JOIN orders ON l_orderkey = o_orderkey"
                         " LEFT JOIN dates ON o_odate = d_date GROUP BY d_week ORDER BY d_week", {"ordered": True}),
    "right_outer_unique": ("SELECT o_odate, COUNT(*), COUNT(l_price), SUM(l_price) FROM li"
                           " RIGHT JOIN orders ON l_orderkey = o_orderkey GROUP BY o_odate ORDER BY o_odate",
                           {"ordered": True}),
    "right_outer_expand": ("SELECT COUNT(*), COUNT(o_odate), SUM(l_price) FROM orders"
                           " RIGHT JOIN li ON o_orderkey = l_orderkey", {}),
    "count_distinct_single_table": ("SELECT o_odate, COUNT(DISTINCT o_tag), COUNT(*) FROM orders"
                                    " GROUP BY o_odate ORDER BY o_odate", {"ordered": True, **ENFORCE}),
    "distinct_over_join": ("SELECT o_odate, COUNT(DISTINCT l_price), COUNT(*), SUM(l_price) FROM li, orders"
                           " WHERE l_orderkey = o_orderkey GROUP BY o_odate ORDER BY o_odate", {"ordered": True}),
    "sum_avg_distinct": ("SELECT o_odate, SUM(DISTINCT l_price), AVG(DISTINCT l_price) FROM li, orders"
                         " WHERE l_orderkey = o_orderkey GROUP BY o_odate ORDER BY o_odate", {"ordered": True}),
    "scalar_count_distinct": ("SELECT COUNT(DISTINCT o_tag) FROM orders", ENFORCE),
    "partitioned_single_table": ("SELECT k, COUNT(*), SUM(v) FROM pagg GROUP BY k ORDER BY k",
                                 {"ordered": True, **ENFORCE}),
}
# the reference plans these on the root (the subquery rewrite decides)
ROOT = {
    "semi_join": "SELECT COUNT(*), SUM(l_price) FROM li WHERE l_orderkey IN (SELECT o_orderkey FROM orders)",
    "inner_after_semi": "SELECT d_week, COUNT(*), SUM(l_price) FROM li"
    " JOIN orders ON l_orderkey = o_orderkey JOIN dates2 ON o_odate = d_date"
    " WHERE l_orderkey IN (SELECT o_orderkey FROM orders WHERE o_odate >= 8040)"
    " GROUP BY d_week ORDER BY d_week",
}


@pytest.mark.parametrize("name", list(SHAPES))
def test_shape_statements(db, name):
    sql, kw = SHAPES[name]
    sm.check(db, sql, **kw)


@pytest.mark.parametrize("name", list(ROOT))
def test_statements_the_reference_keeps_on_the_root(db, name):
    ref, port = db
    plan = sm._plan(ref.session(), ROOT[name])
    mpp = "PhysMPPGather" in "\n".join(plan)
    if mpp:
        sm.check(db, ROOT[name])
    else:
        assert sm._plan(port.session(), ROOT[name]) == [ln.replace("[tpu]", "[gpu]") for ln in plan]
        assert sm._canon(port.session().query(ROOT[name])) == sm._canon(ref.session().query(ROOT[name]))


def test_right_outer_forced_hash_exchange(db, monkeypatch):
    monkeypatch.setattr(ref_gather, "FORCE_EXCHANGE", "hash")
    monkeypatch.setattr(gather, "FORCE_EXCHANGE", "hash")
    sm.check(
        db,
        "SELECT o_odate, COUNT(*), COUNT(l_price) FROM li RIGHT JOIN orders ON l_orderkey = o_orderkey"
        " GROUP BY o_odate ORDER BY o_odate",
        ordered=True,
    )
