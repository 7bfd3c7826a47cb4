"""Partition global stats on the port (``statistics/globalstats.py``, a
copy), held against the reference: ``ANALYZE TABLE t PARTITION (...)``
over the same rows merges to the same global stats in both packages (row
and null counts, NDV, TopN, histogram bounds and counts, index NDV), a
fresh SQL layer loads them alike, and the merged stats flip the MPP join
exchange from broadcast to hash in both (``tests/test_globalstats.py``)."""

import os
import sys

import numpy as np
import pytest

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import tidb_tpu  # noqa: E402
import tidb_tpu_torch  # noqa: E402
from tidb_tpu.session.session import DB as RefDB  # noqa: E402
from tidb_tpu_torch.session.session import DB as PortDB  # noqa: E402

PKGS = {
    "ref": (lambda: tidb_tpu.open(), RefDB, "tpu"),
    "port": (lambda: tidb_tpu_torch.open(device="cpu"), PortDB, "gpu"),
}

PT = (
    "CREATE TABLE pt (id BIGINT PRIMARY KEY, g BIGINT, v BIGINT, n BIGINT, KEY kg (g), KEY kgv (g, v)) "
    "PARTITION BY HASH(id) PARTITIONS 4"
)


def _pt(pkg):
    db = PKGS[pkg][0]()
    s = db.session()
    s.execute(PT)
    rows = ", ".join(f"({i}, {i % 700}, {i % 13}, {'NULL' if i % 9 == 0 else i % 100})" for i in range(3000))
    s.execute("INSERT INTO pt VALUES " + rows)
    return db, s


def _arr(a):
    return np.asarray(a).tolist()


def _summary(st):
    """Everything the merge decides, as plain lists."""
    cols = {}
    for off, cs in sorted(st.cols.items()):
        cols[off] = {
            "null_count": cs.null_count,
            "ndv": cs.ndv,
            "topn": (_arr(cs.topn.values), _arr(cs.topn.counts)),
            "hist": (_arr(cs.hist.lowers), _arr(cs.hist.uppers), _arr(cs.hist.cum_counts), _arr(cs.hist.repeats), cs.hist.ndv),
            "cm_total": int(np.asarray(cs.cm.table).sum()) if getattr(cs.cm, "table", None) is not None else None,
        }
    idxs = {iid: ix.ndv for iid, ix in sorted(st.idxs.items())}
    return st.row_count, cols, idxs


@pytest.mark.parametrize(
    "batches",
    [("p0, p1", "p2, p3"), ("p0, p1, p2, p3",), ("p3", "p0, p2", "p1")],
    ids=["two_halves", "all_at_once", "three_steps"],
)
def test_partition_analyze_merges_equal_global_stats(batches):
    got = {}
    for pkg in PKGS:
        db, s = _pt(pkg)
        t = db.catalog.table("test", "pt")
        for i, b in enumerate(batches):
            s.execute(f"ANALYZE TABLE pt PARTITION {b}")
            if i < len(batches) - 1:
                assert db.stats.get(t.id) is None, "a partial ANALYZE must not refresh the global stats"
        gs = db.stats.get(t.id)
        parts = [_summary(db.stats.get(d.id)) for d in t.partition.defs]
        got[pkg] = _summary(gs), parts
    assert got["port"] == got["ref"]
    rows, cols, idxs = got["port"][0]
    assert rows == 3000
    assert 560 <= cols[1]["ndv"] <= 1000 and cols[1]["null_count"] == 0
    assert cols[3]["null_count"] == 334
    assert all(560 <= ndv <= 3000 for ndv in idxs.values())
    topn_vals, topn_counts = cols[1]["topn"]
    assert abs(sum(topn_counts) + cols[1]["hist"][2][-1] - 3000) <= 1


def test_fresh_sql_layer_loads_the_merged_stats():
    got = {}
    for pkg, (_open, DB, _eng) in PKGS.items():
        db, s = _pt(pkg)
        s.execute("ANALYZE TABLE pt PARTITION p0, p1, p2, p3")
        t = db.catalog.table("test", "pt")
        st = DB(store=db.store).stats.load_sync(t.id)
        got[pkg] = _summary(st)
        assert got[pkg] == _summary(db.stats.get(t.id))
    assert got["port"] == got["ref"]


def test_global_stats_flip_exchange_choice():
    """Merged global stats flip the MPP join exchange from broadcast to
    hash, alike in both packages."""
    q = "EXPLAIN SELECT cat, SUM(v) FROM pl, dm WHERE k = d_id GROUP BY cat ORDER BY cat"
    got = {}
    for pkg, (opener, _DB, eng) in PKGS.items():
        db = opener()
        s = db.session()
        s.execute("CREATE TABLE pl (id BIGINT PRIMARY KEY, k BIGINT, v BIGINT) PARTITION BY HASH(id) PARTITIONS 4")
        s.execute("CREATE TABLE dm (d_id BIGINT PRIMARY KEY, cat BIGINT)")
        s.execute("INSERT INTO pl VALUES " + ", ".join(f"({i}, {i % 40}, {i})" for i in range(300)))
        s.execute("INSERT INTO dm VALUES " + ", ".join(f"({i}, {i % 5})" for i in range(2000)))
        before = "\n".join(r[0] for r in s.query(q))
        s.execute("ANALYZE TABLE dm")
        s.execute("ANALYZE TABLE pl PARTITION p0, p1, p2, p3")
        after = "\n".join(r[0] for r in s.query(q))
        rows = s.query(q[len("EXPLAIN "):])
        got[pkg] = before.replace(f"[{eng}]", "[dev]"), after.replace(f"[{eng}]", "[dev]"), rows
    assert got["port"] == got["ref"]
    before, after, _rows = got["port"]
    assert "broadcast join exchange" in before and "hash join exchange" in after
