"""The port's MPP gather through its SQL front, held against the reference.

Every statement runs through ``tidb_tpu.open()`` and
``tidb_tpu_torch.open(device="cpu")`` over the same data, with
``FORCE_NDEV`` set on both packages' ``parallel.mesh`` to 1 and then 4
shards (the reference on the conftest's 8-device CPU mesh, the port on
virtual shards). For each statement and width (``check``):

- ``EXPLAIN`` gives the reference's plan, ``[gpu]`` where it says
  ``[tpu]``, with a ``PhysMPPGather``;
- the rows are equal (a LIMIT without ORDER BY: as many rows, each a row
  of the whole join);
- the gather reports the reference's fragments, stages and width;
- ``MPP_HOST_INTERMEDIATE`` moves by the reference's bytes;
- with ``tidb_allow_mpp = 0`` the port gives the same rows.

The statements are those of ``tests/test_mpp.py`` (here) and of
``tests/test_mpp_stagechain.py`` and ``tests/test_mpp_shapes.py`` (in
``test_torch_sql_mpp_stages.py`` and ``test_torch_sql_mpp_shapes.py``),
and ``chip_smoke.MPP_QUERIES`` (bench.py's Q3, TPC-H Q3 and Q17, a TopN
over a join) at a small scale. Further cases: the grow-and-retry after a
hash exchange overflows, the re-plan without MPP when every attempt
fails, a complete-mode DAG through ``gpu_engine.execute_region`` against
the reference's ``tpu_engine``, and ``gather_to_pb``/``gather_from_pb``.
"""

import json
import os
import random
import sys
import time

import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke  # noqa: E402
import tidb_tpu  # noqa: E402
import tidb_tpu_torch  # noqa: E402
from tidb_tpu.copr import tpu_engine  # noqa: E402
from tidb_tpu.executor.load import bulk_load as ref_bulk_load  # noqa: E402
from tidb_tpu.parallel import gather as ref_gather  # noqa: E402
from tidb_tpu.parallel import mesh as ref_mesh  # noqa: E402
from tidb_tpu.parallel import mpptask as ref_mpptask  # noqa: E402
from tidb_tpu.utils import metrics as ref_metrics  # noqa: E402
from tidb_tpu_torch.copr import dagpb, gpu_engine  # noqa: E402
from tidb_tpu_torch.executor.load import bulk_load  # noqa: E402
from tidb_tpu_torch.parallel import gather  # noqa: E402
from tidb_tpu_torch.parallel import mesh as port_mesh  # noqa: E402
from tidb_tpu_torch.parallel import mpptask  # noqa: E402
from tidb_tpu_torch.utils import eventlog, failpoint  # noqa: E402
from tidb_tpu_torch.utils import metrics as port_metrics  # noqa: E402

import test_torch_engine as te  # noqa: E402

NDEVS = (1, 4)


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """Small statements: one intra-op thread keeps this module from loading
    every core of the machine the other test workers share."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def set_ndev(nd):
    ref_mesh.FORCE_NDEV = port_mesh.FORCE_NDEV = nd


def _plan(s, sql):
    return [r[0] for r in s.query("EXPLAIN " + sql)]


def _canon(rows):
    return sorted(map(repr, rows))


def both_open(setup, **kw):
    """The same DDL and data in a reference and a port handle: ``setup(db,
    bulk_load)`` runs on each."""
    ref = tidb_tpu.open(**kw)
    setup(ref, ref_bulk_load)
    port = tidb_tpu_torch.open(device="cpu", **kw)
    setup(port, bulk_load)
    return ref, port


def check(pair, sql, ndevs=NDEVS, mpp=True, ordered=False, limit_rows=None, stages=None, session_sql=()):
    """``sql`` on both packages at each forced width (the module docstring's
    checks). ``limit_rows``: the statement is a LIMIT without ORDER BY over
    a join whose full rows ``limit_rows`` gives. ``mpp=False``: the
    reference plans no gather, and the port's plan is the reference's. ``session_sql``:
    statements run first in both sessions. → the port's rows at the last
    width."""
    ref, port = pair
    got = None
    for nd in ndevs:
        set_ndev(nd)
        try:
            rs, ps = ref.session(), port.session()
            for q in session_sql:
                rs.execute(q)
                ps.execute(q)
            rplan, pplan = _plan(rs, sql), _plan(ps, sql)
            assert pplan == [ln.replace("[tpu]", "[gpu]") for ln in rplan], (pplan, rplan)
            assert ("PhysMPPGather" in "\n".join(rplan)) == mpp, rplan
            if not mpp:
                continue  # the plan is the claim (tests/test_mpp.py runs none of these)
            r0, p0 = ref_metrics.MPP_HOST_INTERMEDIATE.total(), port_metrics.MPP_HOST_INTERMEDIATE.total()
            want = rs.query(sql)
            got = ps.query(sql)
            r_moved = ref_metrics.MPP_HOST_INTERMEDIATE.total() - r0
            p_moved = port_metrics.MPP_HOST_INTERMEDIATE.total() - p0
            if limit_rows is not None:
                full = _canon(limit_rows)
                assert len(got) == len(want) and all(repr(r) in full for r in got)
            elif ordered:
                assert got == want
            else:
                assert _canon(got) == _canon(want)
            if mpp:
                rd, pd = rs.mpp_details[-1], ps.mpp_details[-1]
                assert (pd.n_fragments, pd.stages, pd.ndev, pd.retries) == (rd.n_fragments, rd.stages, rd.ndev, 0)
                assert pd.ndev == nd and len(pd.stage_bytes) == len(rd.stage_bytes)
                assert p_moved == r_moved
                if stages is not None:
                    assert pd.stages == stages
            ps.execute("SET tidb_allow_mpp = 0")
            host = ps.query(sql)
            if limit_rows is not None:
                assert len(host) == len(got)
            else:
                assert (host == got) if ordered else (_canon(host) == _canon(got))
        finally:
            set_ndev(None)
    return got


# -- tests/test_mpp.py's statements ------------------------------------------------


def _fact_dim(db, _bulk):
    db.execute("CREATE TABLE fact (cid BIGINT, qty BIGINT, price DECIMAL(10,2))")
    db.execute("CREATE TABLE dim (id BIGINT PRIMARY KEY, cat VARCHAR(8))")
    rnd = random.Random(7)
    db.execute("INSERT INTO dim VALUES " + ",".join(f"({i},'c{i % 5}')" for i in range(40)))
    db.execute(
        "INSERT INTO fact VALUES "
        + ",".join(f"({rnd.randint(0, 39)},{rnd.randint(1, 9)},{rnd.randint(100, 999) / 100})" for _ in range(500))
    )
    db.execute("INSERT INTO fact VALUES (NULL, 5, 1.00), (3, NULL, 2.00)")
    # all rows on one dim id: a hash exchange overflows its first row cap
    db.execute("CREATE TABLE skew (cid BIGINT, qty BIGINT)")
    db.execute("INSERT INTO skew VALUES " + ",".join("(7, 1)" for _ in range(300)))


def _q3db(db, _bulk):
    db.execute("CREATE TABLE customer (c_custkey BIGINT PRIMARY KEY, c_mktsegment BIGINT)")
    db.execute("CREATE TABLE orders (o_orderkey BIGINT PRIMARY KEY, o_custkey BIGINT, o_odate BIGINT)")
    db.execute("CREATE TABLE lineitem (l_orderkey BIGINT, l_extendedprice DECIMAL(10,2))")
    rnd = random.Random(11)
    db.execute("INSERT INTO customer VALUES " + ",".join(f"({i},{i % 3})" for i in range(30)))
    db.execute(
        "INSERT INTO orders VALUES " + ",".join(f"({i},{rnd.randint(0, 29)},{8000 + i % 50})" for i in range(200))
    )
    db.execute(
        "INSERT INTO lineitem VALUES "
        + ",".join(f"({rnd.randint(0, 199)},{rnd.randint(100, 99999) / 100})" for _ in range(1500))
    )
    db.execute("CREATE TABLE tags (okey BIGINT, tag BIGINT)")
    db.execute("INSERT INTO tags VALUES " + ",".join(f"({rnd.randint(0, 199)},{i % 7})" for i in range(400)))
    db.execute("CREATE TABLE dup (k BIGINT, v BIGINT)")
    db.execute("INSERT INTO dup VALUES " + ",".join(f"(7,{i})" for i in range(200)))
    db.execute("CREATE TABLE probe (k BIGINT)")
    db.execute("INSERT INTO probe VALUES " + ",".join("(7)" for _ in range(50)))
    for t in ("customer", "orders", "lineitem", "tags", "dup", "probe"):
        db.execute(f"ANALYZE TABLE {t}")


@pytest.fixture(scope="module")
def fact_dim():
    return both_open(_fact_dim)


@pytest.fixture(scope="module")
def q3db():
    return both_open(_q3db)


MPPQ = (
    "SELECT cat, COUNT(*), SUM(qty), AVG(price) FROM fact JOIN dim ON fact.cid = dim.id"
    " WHERE qty > 2 GROUP BY cat ORDER BY cat"
)
Q3FULL = (
    "SELECT o_odate, SUM(l_extendedprice) AS rev FROM lineitem"
    " JOIN orders ON l_orderkey = o_orderkey"
    " JOIN customer ON o_custkey = c_custkey"
    " WHERE c_mktsegment = 1 GROUP BY o_odate ORDER BY rev DESC, o_odate LIMIT 10"
)

FACT_DIM = {
    "join_agg": (MPPQ, {"ordered": True}),
    "scalar_agg": ("SELECT COUNT(*), SUM(qty) FROM fact JOIN dim ON fact.cid = dim.id", {}),
    "non_unique_key": (
        "SELECT COUNT(*) FROM fact JOIN dim ON fact.qty = dim.id + 0 GROUP BY fact.cid", {"mpp": False}
    ),
    "enforce_single_table": (
        "SELECT cid, COUNT(*), SUM(qty) FROM fact GROUP BY cid ORDER BY cid",
        {"ordered": True, "session_sql": ("SET tidb_enforce_mpp = 1",)},
    ),
    "enforce_scalar": (
        "SELECT COUNT(*), SUM(qty), AVG(qty) FROM fact WHERE qty > 2",
        {"session_sql": ("SET tidb_enforce_mpp = 1",)},
    ),
}


@pytest.mark.parametrize("name", list(FACT_DIM))
def test_fact_dim_statements(fact_dim, name):
    sql, kw = FACT_DIM[name]
    check(fact_dim, sql, **kw)


def _builds(pair, sql, nd=4):
    """(reference, port) fragment programs built for ``sql`` at width
    ``nd``, from empty program caches: one per grow-and-retry attempt."""
    ref, port = pair
    set_ndev(nd)
    try:
        ref_gather._MPP_FN_CACHE.clear()
        gather._MPP_FN_CACHE.clear()
        rs, ps = ref.session(), port.session()
        assert ps.query(sql) == rs.query(sql)
        return rs.mpp_details[-1].compiles, ps.mpp_details[-1].compiles
    finally:
        set_ndev(None)


def test_hash_exchange_and_overflow_retry(fact_dim, monkeypatch):
    """Forced hash exchange (both packages' ``FORCE_EXCHANGE``, as
    tests/test_mpp.py's overflow test sets it): every skew row routes to
    one owner, and the gather builds as many programs as the reference."""
    monkeypatch.setattr(ref_gather, "FORCE_EXCHANGE", "hash")
    monkeypatch.setattr(gather, "FORCE_EXCHANGE", "hash")
    q = "SELECT cat, COUNT(*) FROM skew JOIN dim ON skew.cid = dim.id GROUP BY cat"
    check(fact_dim, MPPQ, ordered=True)
    assert check(fact_dim, q) == [("c2", 300)]
    assert "hash join exchange" in "\n".join(_plan(fact_dim[1].session(), q))
    ref_builds, port_builds = _builds(fact_dim, q)
    assert port_builds == ref_builds


Q3DB = {
    "q3_full_chain": (Q3FULL, {"ordered": True}),
    "non_unique_build": (
        "SELECT tag, COUNT(*), SUM(o_odate) FROM orders JOIN tags ON o_orderkey = okey GROUP BY tag ORDER BY tag",
        {"ordered": True},
    ),
    "non_unique_overflow": ("SELECT COUNT(*) FROM probe JOIN dup ON probe.k = dup.k", {}),
    # the SUM reads the build side, so no partial agg folds the probe rows
    # first: 50 x 200 joined rows pass the first expansion capacity
    "expand_overflow": ("SELECT SUM(v) FROM probe JOIN dup ON probe.k = dup.k", {}),
    "topn_over_join": (
        "SELECT o_odate, l_extendedprice FROM lineitem JOIN orders ON l_orderkey = o_orderkey"
        " ORDER BY l_extendedprice DESC LIMIT 7",
        {"ordered": True},
    ),
}


@pytest.mark.parametrize("name", list(Q3DB))
def test_q3db_statements(q3db, name):
    sql, kw = Q3DB[name]
    got = check(q3db, sql, **kw)
    if name == "non_unique_overflow":
        assert got == [(10000,)]
    if name == "expand_overflow":
        # the gather grows the capacity and reruns, as the reference does
        assert got == [(50 * sum(range(200)),)]
        for nd in NDEVS:
            ref_builds, port_builds = _builds(q3db, sql, nd)
            assert port_builds == ref_builds >= 2


def test_limit_over_join_without_order(q3db):
    full = q3db[1].session().query("SELECT o_odate FROM lineitem JOIN orders ON l_orderkey = o_orderkey")
    got = check(q3db, "SELECT o_odate FROM lineitem JOIN orders ON l_orderkey = o_orderkey LIMIT 9", limit_rows=full)
    assert len(got) == 9


# -- chip_smoke.MPP_QUERIES at a small scale ----------------------------------------

N_LINE, N_PART, N_CUST = 20_000, 2_000, 1_500


@pytest.fixture(scope="module")
def tpch():
    cols = chip_smoke.lineitem_sf1(5, n=N_LINE)
    partkey = np.random.default_rng(9).integers(1, N_PART + 1, N_LINE)
    tables = chip_smoke.mpp_tables(cols, partkey, 5, n_part=N_PART, n_cust=N_CUST)
    pair = both_open(lambda db, bl: chip_smoke.mpp_sql(db, bl, tables), region_split_keys=1 << 62)
    return pair, tables


@pytest.mark.parametrize("name", list(chip_smoke.MPP_QUERIES))
def test_tpch_statements(tpch, name):
    pair, tables = tpch
    sql = chip_smoke.MPP_QUERIES[name]
    frags, stages = chip_smoke.MPP_PLANS[name]
    got = check(pair, sql, ordered=True, stages=stages)
    assert chip_smoke.mpp_rows_match(name, got, chip_smoke.mpp_oracle(name, tables), chip_smoke.MPP_LIMITS[name])
    s = pair[1].session()
    s.query(sql)
    assert s.mpp_details[-1].n_fragments == frags


# -- retry, re-plan, complete mode, the wire form ----------------------------------------


def test_exhausted_retries_replan_without_mpp(fact_dim):
    """Every attempt fails at the ``mpp_run_fragment`` failpoint: the gather
    gives up after the reference's two attempts, the session re-plans
    without MPP, answers the host join's rows and logs the fallback."""
    _ref, port = fact_dim
    want = check(fact_dim, MPPQ, ndevs=(4,), ordered=True)
    calls = []

    def boom(mesh):
        calls.append(mesh.devices.size)
        raise RuntimeError("shard OOM: injected")

    t0 = time.time()
    failpoint.enable("mpp_run_fragment", boom)
    set_ndev(4)
    try:
        rows = port.session().query(MPPQ)
    finally:
        failpoint.disable("mpp_run_fragment")
        set_ndev(None)
    assert calls == [4, 4]
    assert rows == want
    events = [ev[3] for ev in eventlog.get().search(since=t0, component="mpp")]
    assert "host_join_fallback" in events


COMPLETE = {
    # few groups: the equality-mask route
    "eqmask": """SELECT l_returnflag, AVG(l_quantity), AVG(l_extendedprice), VAR_POP(l_discount),
    VAR_SAMP(l_tax), STDDEV_POP(l_quantity), STDDEV_SAMP(l_extendedprice), COUNT(*) FROM lineitem
  GROUP BY l_returnflag""",
    # no dictionary domain: the lex-sort route
    "lex": """SELECT l_suppkey, AVG(l_quantity), VAR_SAMP(l_discount), STDDEV_POP(l_extendedprice),
    STDDEV_SAMP(l_tax), COUNT(*) FROM lineitem GROUP BY l_suppkey""",
}


@pytest.fixture(scope="module")
def engine_setup():
    db = te._lineitem_db()
    caps = te._capture(db, COMPLETE)
    dag0, region, _, read_ts = caps["eqmask"]
    return db, caps, te._carry_region(db, dag0, region, read_ts)


@pytest.mark.parametrize("name", list(COMPLETE))
def test_complete_mode_dag_matches_tpu_engine(engine_setup, name):
    """The captured DAG with its aggregation switched to complete mode (what
    an MPP task sends): every AVG, VAR and STDDEV finalized on the device
    equals the reference ``tpu_engine``'s, decimals exact, doubles within a
    relative 1e-12."""
    db, caps, reg = engine_setup
    dag, region, ranges, read_ts = caps[name]
    for ex in dag.executors[1:]:
        if ex.tp in (dagpb.AGGREGATION, dagpb.STREAM_AGG):
            ex.agg_mode = dagpb.AGG_COMPLETE
    want = tpu_engine.execute_dag(db.store, dag, region, ranges, read_ts).rows()
    stats = {}
    got = gpu_engine.execute_region(reg, te._port_dag(dag), te._port_ranges(ranges), device="cpu", stats=stats).rows()
    assert stats["routes"] == (name,)
    assert len(got) == len(want) > 1
    assert chip_smoke.rows_match(sorted(got, key=repr), sorted(want, key=repr), rel=1e-12)


def test_gather_wire_form_round_trips(q3db):
    """``gather_to_pb`` of the port's Q3 gather equals the reference's, and
    ``gather_from_pb`` rebuilds a gather that answers the same rows."""
    ref, port = q3db
    plans = {}

    def spy(mod, key):
        real = mod.MPPGatherExec.execute

        def execute(self):
            plans[key] = self.plan
            return real(self)

        return real, execute

    r_real, r_spy = spy(ref_gather, "ref")
    p_real, p_spy = spy(gather, "port")
    ref_gather.MPPGatherExec.execute, gather.MPPGatherExec.execute = r_spy, p_spy
    try:
        ref.session().query(Q3FULL)
        ps = port.session()
        want = ps.query(Q3FULL)
    finally:
        ref_gather.MPPGatherExec.execute, gather.MPPGatherExec.execute = r_real, p_real
    pb = mpptask.gather_to_pb(plans["port"], 256, schema_ver=port.catalog.schema_version)
    assert json.loads(json.dumps(pb)) == pb
    want = ref_mpptask.gather_to_pb(plans["ref"], 256, schema_ver=ref.catalog.schema_version)
    assert pb == json.loads(json.dumps(want).replace('"store": "tpu"', '"store": "gpu"'))
    tables = {port.catalog.table("test", t).id: ("test", port.catalog.table("test", t)) for t in ("customer", "orders", "lineitem")}
    plan2, cap = mpptask.gather_from_pb(pb, tables.__getitem__)
    assert cap == 256
    assert mpptask.gather_to_pb(plan2, 256, schema_ver=port.catalog.schema_version) == pb
    chunk = gather.MPPGatherExec(plan2, port.session()).execute()
    first = gather.MPPGatherExec(plans["port"], port.session()).execute()
    assert _canon(chunk.rows()) == _canon(first.rows())
    assert want
