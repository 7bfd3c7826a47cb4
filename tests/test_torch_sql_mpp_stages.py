"""Staged fragment pipelines on the port, held against the reference: the
statements of ``tests/test_mpp_stagechain.py`` through both packages at
forced widths 1 and 4 (``test_torch_sql_mpp.check``): a subplan
aggregate runs as a device stage inside the consumer's program, so the
gather reports 2 stages, one stage-byte count, and moves no
intermediate bytes through the host, as the reference's does."""

import os
import re
import sys

import numpy as np
import pytest

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import test_torch_sql_mpp as sm  # noqa: E402
from tidb_tpu_torch.utils import metrics as port_metrics  # noqa: E402

one_torch_thread = sm.one_torch_thread


def _stage_db(db, bulk_load):
    rng = np.random.default_rng(15)
    n_l, n_p, n_o = 4000, 200, 3000
    db.execute("CREATE TABLE li (l_partkey BIGINT, l_qty BIGINT, l_price BIGINT)")
    db.execute("CREATE TABLE part (p_partkey BIGINT PRIMARY KEY, p_brand BIGINT)")
    db.execute("CREATE TABLE fact (fk BIGINT, v BIGINT)")
    db.execute("CREATE TABLE dim (dk BIGINT PRIMARY KEY, g BIGINT)")
    db.execute("CREATE TABLE outer_t (ok BIGINT, w BIGINT)")
    bulk_load(db, "li", [rng.integers(0, n_p + 10, n_l), rng.integers(1, 50, n_l), rng.integers(100, 9000, n_l)])
    bulk_load(db, "part", [np.arange(n_p), rng.integers(0, 9, n_p)])
    bulk_load(db, "fact", [rng.integers(0, n_p, n_l), rng.integers(0, 100, n_l)])
    bulk_load(db, "dim", [np.arange(n_p), rng.integers(0, 30, n_p)])
    bulk_load(db, "outer_t", [rng.integers(0, 30, n_o), rng.integers(0, 50, n_o)])
    # adversarial rows: NULL join keys, NULL agg args, NULL group keys
    db.execute("INSERT INTO li VALUES (NULL, 10, 500), (3, NULL, NULL)")
    db.execute("INSERT INTO fact VALUES (NULL, 7), (5, NULL)")
    db.execute("INSERT INTO outer_t VALUES (NULL, 9)")
    for t in ("li", "part", "fact", "dim", "outer_t"):
        db.execute(f"ANALYZE TABLE {t}")


@pytest.fixture(scope="module")
def db():
    return sm.both_open(_stage_db, region_split_keys=1 << 62)


Q17_SHAPE = (
    "SELECT SUM(l_price) FROM li, part WHERE p_partkey = l_partkey "
    "AND p_brand = 3 AND l_qty < (SELECT 0.2 * AVG(l_qty) FROM li WHERE l_partkey = p_partkey)"
)
STAGED = {
    "q17_shape": Q17_SHAPE,
    "agg_over_join_restaged": "SELECT SUM(w * c) FROM outer_t JOIN "
    "(SELECT g, SUM(v + g) c FROM fact JOIN dim ON fk = dk GROUP BY g) sub ON ok = sub.g",
    "min_max_count_lanes": "SELECT SUM(w + mx) FROM outer_t JOIN "
    "(SELECT g, MIN(v + g) mn, MAX(v - g) mx, COUNT(*) c FROM fact JOIN dim ON fk = dk GROUP BY g) sub "
    "ON ok = sub.g WHERE w > 2",
    "null_keys": "SELECT SUM(l_price) FROM li, part WHERE p_partkey = l_partkey "
    "AND l_qty < (SELECT 2 + AVG(l_qty) FROM li WHERE l_partkey = p_partkey)",
}


@pytest.mark.parametrize("name", list(STAGED))
def test_staged_statements(db, name):
    before = port_metrics.MPP_HOST_INTERMEDIATE.total()
    sm.check(db, STAGED[name], stages=2)
    assert port_metrics.MPP_HOST_INTERMEDIATE.total() == before  # nothing crossed the host


def test_explain_analyze_reports_the_stage_count(db):
    sm.set_ndev(4)
    try:
        text = "\n".join(r[0] for r in db[1].session().execute("EXPLAIN ANALYZE " + Q17_SHAPE).rows)
    finally:
        sm.set_ndev(None)
    m = re.search(r"mpp_task: \{fragments: \d+, stages: (\d+),", text)
    assert m and int(m.group(1)) == 2, text
    assert "stage_bytes: [" in text, text


def test_program_cache_spans_the_stage_chain(db):
    """A repeat of one staged shape builds no program: the cache counts a
    hit, and the gather reports no build."""
    s = db[1].session()
    sql = (
        "SELECT SUM(w * c) FROM outer_t JOIN "
        "(SELECT g, COUNT(*) c, SUM(v + g) sv FROM fact JOIN dim ON fk = dk GROUP BY g) sub ON ok = sub.g"
    )
    s.query(sql)
    miss0 = port_metrics.MPP_PROGRAM_CACHE.get(result="miss")
    hit0 = port_metrics.MPP_PROGRAM_CACHE.get(result="hit")
    s.query(sql)
    assert port_metrics.MPP_PROGRAM_CACHE.get(result="miss") == miss0
    assert port_metrics.MPP_PROGRAM_CACHE.get(result="hit") == hit0 + 1
    det = s.mpp_details[-1]
    assert det.stages == 2 and det.compiles == 0
