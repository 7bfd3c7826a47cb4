"""Partitioned tables on the port, held against the reference.

``planner/partition.py`` is a copy: ``prune_partitions`` must keep the same
partitions in both packages over RANGE and HASH conditions. The cases of
``tests/test_partition.py`` run on ``tidb_tpu.open()`` and
``tidb_tpu_torch.open(device="cpu")`` and give equal rows; the port's
device session runs one ``gpu`` task per partition the planner keeps, as
the reference's runs one ``tpu`` task each. A join over a partitioned
table plans one ``PhysMPPGather`` in both.
"""

import os
import sys
import types

import numpy as np
import pytest

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import tidb_tpu  # noqa: E402
import tidb_tpu_torch  # noqa: E402
from tidb_tpu.executor.load import bulk_load as ref_bulk_load  # noqa: E402
from tidb_tpu.expression import expr as ref_expr  # noqa: E402
from tidb_tpu.planner.partition import prune_partitions as ref_prune  # noqa: E402
from tidb_tpu_torch.executor.load import bulk_load as port_bulk_load  # noqa: E402
from tidb_tpu_torch.expression import expr as port_expr  # noqa: E402
from tidb_tpu_torch.planner.partition import prune_partitions as port_prune  # noqa: E402

PKGS = {
    "ref": (lambda: tidb_tpu.open(), ref_expr, ref_prune, ref_bulk_load, "tpu"),
    "port": (lambda: tidb_tpu_torch.open(device="cpu"), port_expr, port_prune, port_bulk_load, "gpu"),
}

SALES = """CREATE TABLE sales (id BIGINT PRIMARY KEY, amt BIGINT, yr BIGINT, note VARCHAR(20))
           PARTITION BY RANGE (yr) (
             PARTITION p0 VALUES LESS THAN (2000),
             PARTITION p1 VALUES LESS THAN (2010),
             PARTITION p2 VALUES LESS THAN MAXVALUE)"""
SALES_ROWS = (
    "INSERT INTO sales VALUES (1, 10, 1995, 'a'), (2, 20, 2005, 'b'), "
    "(3, 30, 2015, 'c'), (4, 40, 2007, 'd'), (5, 50, NULL, 'e')"
)


def _sales(pkg):
    db = PKGS[pkg][0]()
    db.execute(SALES)
    db.execute(SALES_ROWS)
    return db


@pytest.fixture(scope="module")
def prune_tables():
    """Each package's RANGE (bounds 10, 20, 30, MAXVALUE) and HASH (4)
    table infos, and its expression module."""
    out = {}
    for pkg, (opener, expr, prune, _load, _eng) in PKGS.items():
        db = opener()
        db.execute(
            "CREATE TABLE r (k BIGINT, b BIGINT) PARTITION BY RANGE (k) (PARTITION p0 VALUES LESS THAN (10), "
            "PARTITION p1 VALUES LESS THAN (20), PARTITION p2 VALUES LESS THAN (30), PARTITION p3 VALUES LESS THAN MAXVALUE)"
        )
        db.execute("CREATE TABLE h (k BIGINT, b BIGINT) PARTITION BY HASH (k) PARTITIONS 4")
        out[pkg] = {name: db.catalog.table("test", name) for name in ("r", "h")}, expr, prune
    return out


# conditions as (sig, left, right): "k" and "b" are columns, None is NULL
PRUNE_CASES = {
    "eq": [("eq", "k", 15)],
    "lt": [("lt", "k", 10)],
    "le": [("le", "k", 10)],
    "gt": [("gt", "k", 19)],
    "ge": [("ge", "k", 20)],
    "flipped": [("gt", 15, "k")],
    "flipped_eq": [("eq", 7, "k")],
    "between": [("ge", "k", 12), ("lt", "k", 25)],
    "contradictory": [("gt", "k", 25), ("lt", "k", 5)],
    "null": [("eq", "k", None)],
    "other_column": [("eq", "b", 3)],
    "negative": [("lt", "k", -3)],
    "past_the_last_bound": [("ge", "k", 1000)],
    "eq_and_range": [("eq", "k", 33), ("ge", "k", 30)],
}


def _cond(t, expr, sig, a, b):
    ft = t.columns[0].ftype

    def arg(x):
        if x in ("k", "b"):
            return expr.ColumnRef(0 if x == "k" else 1, ft, x)
        return expr.Constant(x, ft)

    return expr.ScalarFunc(sig, [arg(a), arg(b)], ft)


def _kept(tables, expr, prune, table, conds):
    t = tables[table]
    schema = [types.SimpleNamespace(slot=i) for i in range(len(t.columns))]
    views = prune(t, schema, [_cond(t, expr, *c) for c in conds])
    if views is None:
        return "all"
    ids = [d.id for d in t.partition.defs]
    return [ids.index(v.id) for v in views]


@pytest.mark.parametrize("table", ["r", "h"])
@pytest.mark.parametrize("case", sorted(PRUNE_CASES))
def test_prune_partitions_keeps_the_references_partitions(prune_tables, table, case):
    got = {pkg: _kept(*prune_tables[pkg], table, PRUNE_CASES[case]) for pkg in PKGS}
    assert got["port"] == got["ref"]


def test_prune_partitions_answers(prune_tables):
    """The port's answers themselves, on a few cases of each kind."""
    kept = lambda table, case: _kept(*prune_tables["port"], table, PRUNE_CASES[case])  # noqa: E731
    assert kept("r", "eq") == [1]
    assert kept("r", "between") == [1, 2]
    assert kept("r", "flipped") == [0, 1]
    assert kept("r", "contradictory") == []
    assert kept("r", "null") == "all" and kept("r", "other_column") == "all"
    assert kept("h", "flipped_eq") == [3]
    assert kept("h", "between") == "all"


def _run(db, script):
    """Each statement's rows (a query) or None, or the error's type name."""
    out = []
    s = db.session()
    for sql in script:
        try:
            r = s.execute(sql)
            out.append(r.rows if r.columns else None)
        except Exception as e:  # both packages must refuse alike
            out.append(type(e).__name__)
    return out


# the statements of tests/test_partition.py's cases, over its sales table
PARTITION_CASES = {
    "read_all_and_strings": [
        "SELECT COUNT(*), SUM(amt) FROM sales",
        "SELECT id FROM sales WHERE yr IS NULL",
        "SELECT note FROM sales ORDER BY note",
        "SELECT yr, COUNT(*) FROM sales WHERE yr IS NOT NULL GROUP BY yr ORDER BY yr",
    ],
    "pruning": [
        "SELECT id FROM sales WHERE yr >= 2010 ORDER BY id",
        "SELECT id FROM sales WHERE yr = 2005",
        "SELECT id FROM sales WHERE yr < 2000 ORDER BY id",
        "SELECT id FROM sales WHERE yr > 2011 AND amt > 0",
    ],
    "dml": [
        "UPDATE sales SET yr = 1990 WHERE id = 3",
        "SELECT id FROM sales WHERE yr < 2000 ORDER BY id",
        "SELECT COUNT(*) FROM sales",
        "DELETE FROM sales WHERE yr = 2005",
        "SELECT COUNT(*) FROM sales",
        "BEGIN",
        "UPDATE sales SET amt = amt + 1000",
        "SELECT SUM(amt) FROM sales",
        "ROLLBACK",
        "SELECT SUM(amt) FROM sales",
    ],
    "hash": [
        "CREATE TABLE h (k BIGINT, v BIGINT) PARTITION BY HASH (k) PARTITIONS 4",
        "INSERT INTO h VALUES (0, 1), (1, 2), (2, 3), (3, 4), (4, 5), (NULL, 6)",
        "SELECT COUNT(*), SUM(v) FROM h",
        "SELECT v FROM h WHERE k = 2",
        "SELECT v FROM h WHERE k IS NULL",
    ],
    "alter": [
        "ALTER TABLE sales ADD PARTITION (PARTITION p3 VALUES LESS THAN (2020))",
        "CREATE TABLE r (a BIGINT, b BIGINT) PARTITION BY RANGE (a) (PARTITION p0 VALUES LESS THAN (10))",
        "ALTER TABLE r ADD PARTITION (PARTITION p1 VALUES LESS THAN (20))",
        "INSERT INTO r VALUES (5, 1), (15, 2)",
        "SELECT COUNT(*) FROM r",
        "INSERT INTO r VALUES (25, 3)",
        "ALTER TABLE r TRUNCATE PARTITION p0",
        "SELECT b FROM r",
        "ALTER TABLE r DROP PARTITION p1",
        "SELECT COUNT(*) FROM r",
    ],
}


@pytest.mark.parametrize("case", sorted(PARTITION_CASES))
def test_partition_case_gives_the_references_rows(case):
    got = {pkg: _run(_sales(pkg), PARTITION_CASES[case]) for pkg in PKGS}
    assert got["port"] == got["ref"]
    assert any(isinstance(r, list) and r for r in got["port"])


@pytest.mark.parametrize("pkg", sorted(PKGS))
def test_partition_metadata(pkg):
    t = _sales(pkg).catalog.table("test", "sales")
    assert t.partition is not None and t.partition.type == "range"
    assert [d.name for d in t.partition.defs] == ["p0", "p1", "p2"]
    ids = {d.id for d in t.partition.defs}
    assert len(ids) == 3 and t.id not in ids


def test_bulk_load_routes_and_analyze_agree():
    """``bulk_load`` routes rows to their partitions and ``ANALYZE`` merges
    the table's stats, alike in both packages."""
    got = {}
    for pkg, (_o, _e, _p, load, eng) in PKGS.items():
        db = _sales(pkg)
        db.execute(
            "CREATE TABLE big (id BIGINT PRIMARY KEY, g BIGINT) "
            "PARTITION BY RANGE (g) (PARTITION a VALUES LESS THAN (500), PARTITION b VALUES LESS THAN MAXVALUE)"
        )
        n = 5000
        load(db, "big", [np.arange(n, dtype=np.int64), np.arange(n, dtype=np.int64) % 1000])
        s = db.session()
        s.execute(f"SET tidb_isolation_read_engines = '{eng}'")
        rows = [s.query("SELECT COUNT(*) FROM big"), s.query("SELECT COUNT(*) FROM big WHERE g < 500")]
        assert s.exec_summary.engines == {eng: 1}
        db.execute("ANALYZE TABLE big")
        got[pkg] = rows, db.stats.get(db.catalog.table("test", "big").id).row_count
    assert got["port"] == got["ref"] == ([[(5000,)], [(2500,)]], 5000)


# (statement, partitions left after pruning) over the sales table
DEVICE_READS = [
    ("SELECT COUNT(*), SUM(amt) FROM sales", 3),
    ("SELECT SUM(amt) FROM sales WHERE yr >= 2010", 1),
    ("SELECT SUM(amt) FROM sales WHERE yr = 2005", 1),
    ("SELECT COUNT(*) FROM sales WHERE yr < 2010", 2),
    ("SELECT SUM(amt) FROM sales WHERE yr > 2011 AND amt > 0", 1),
    ("SELECT COUNT(*) FROM sales WHERE yr IS NULL", 3),
    ("SELECT SUM(amt) FROM sales WHERE yr > 2020 AND yr < 1990", 0),
    ("SELECT SUM(amt) FROM sales PARTITION (p0, p2)", 2),
    ("SELECT yr, SUM(amt) FROM sales WHERE yr >= 2000 GROUP BY yr ORDER BY yr", 2),
]


@pytest.mark.parametrize("sql,k", DEVICE_READS)
def test_device_session_runs_one_task_per_unpruned_partition(sql, k):
    got = {}
    for pkg, (_o, _e, _p, _l, eng) in PKGS.items():
        s = _sales(pkg).session()
        s.execute(f"SET tidb_isolation_read_engines = '{eng}'")
        rows = s.query(sql)
        summ = s.exec_summary
        engines = {} if summ is None else dict(summ.engines)
        assert engines == ({eng: k} if k else {}), (pkg, engines)
        assert summ is None or not summ.degraded
        got[pkg] = rows
    assert got["port"] == got["ref"]


def test_mpp_join_over_a_partitioned_table():
    """A join of a HASH-partitioned fact table with a dimension table plans
    one ``PhysMPPGather`` in both packages, with equal rows."""
    q = "SELECT cat, SUM(v) FROM pl, dm WHERE k = d_id GROUP BY cat ORDER BY cat"
    got = {}
    for pkg, (opener, _e, _p, _l, eng) in PKGS.items():
        db = opener()
        s = db.session()
        s.execute("CREATE TABLE pl (id BIGINT PRIMARY KEY, k BIGINT, v BIGINT) PARTITION BY HASH(id) PARTITIONS 4")
        s.execute("CREATE TABLE dm (d_id BIGINT PRIMARY KEY, cat BIGINT)")
        s.execute("INSERT INTO pl VALUES " + ", ".join(f"({i}, {i % 40}, {i})" for i in range(300)))
        s.execute("INSERT INTO dm VALUES " + ", ".join(f"({i}, {i % 5})" for i in range(200)))
        plan = "\n".join(r[0] for r in s.query("EXPLAIN " + q))
        assert plan.count("PhysMPPGather") == 1, plan
        rows = s.query(q)
        assert len(s.mpp_details) == 1
        got[pkg] = rows, plan.replace(f"[{eng}]", "[dev]")
    assert got["port"] == got["ref"]
    want = {}
    for i in range(300):
        want[(i % 40) % 5] = want.get((i % 40) % 5, 0) + i
    assert got["port"][0] == sorted(want.items())
