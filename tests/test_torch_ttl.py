"""TTL and the timer framework on the port (``ttl/``, ``utils/timer.py``,
copies), held against the reference: the cases of ``tests/test_ttl.py``
run on ``tidb_tpu.open()`` and ``tidb_tpu_torch.open(device="cpu")``, and
after a sweep deletes rows the port's ``gpu`` read (the deletions reach
the device as the delta operand) equals the reference's ``tpu`` read."""

import dataclasses
import datetime
import os
import sys
import time
import types

import pytest

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import tidb_tpu  # noqa: E402
import tidb_tpu_torch  # noqa: E402
from tidb_tpu import config as ref_config  # noqa: E402
from tidb_tpu_torch import config as port_config  # noqa: E402
from tidb_tpu.utils.timer import TimerRuntime as RefTimerRuntime  # noqa: E402
from tidb_tpu_torch.utils.timer import TimerRuntime as PortTimerRuntime  # noqa: E402

PKGS = {
    "ref": types.SimpleNamespace(open=lambda: tidb_tpu.open(), timer=RefTimerRuntime, eng="tpu"),
    "port": types.SimpleNamespace(open=lambda: tidb_tpu_torch.open(device="cpu"), timer=PortTimerRuntime, eng="gpu"),
}


def _day(days_ago: int) -> str:
    return (datetime.date.today() - datetime.timedelta(days=days_ago)).isoformat()


def _dev(db, eng):
    s = db.session()
    s.execute(f"SET tidb_isolation_read_engines = '{eng}'")
    return s


def case_expires_rows(P):
    db = P.open()
    db.execute("CREATE TABLE ev (id BIGINT PRIMARY KEY, created DATE, v BIGINT) TTL = created + INTERVAL 30 DAY")
    rows = ", ".join(f"({i}, {'NULL' if i % 7 == 0 else repr(_day(i % 90))}, {i})" for i in range(1, 301))
    db.execute(f"INSERT INTO ev VALUES {rows}")
    dev = _dev(db, P.eng)
    before = dev.query("SELECT COUNT(*), SUM(v) FROM ev")
    out = [db.run_ttl()]
    after = dev.query("SELECT COUNT(*), SUM(v), MIN(id), MAX(id) FROM ev")
    tasks = dict(dev.exec_summary.engines)
    out.append(db.run_ttl())
    ids = db.query("SELECT id FROM ev WHERE created IS NULL ORDER BY id")
    assert tasks == {P.eng: 1}
    return before, out, after, ids


def case_enable_toggle_and_alter(P):
    db = P.open()
    db.execute("CREATE TABLE ev (id BIGINT PRIMARY KEY, created DATE) TTL = created + INTERVAL 1 DAY TTL_ENABLE = 'OFF'")
    db.execute(f"INSERT INTO ev VALUES (1, '{_day(10)}')")
    out = [db.run_ttl()]
    db.execute("ALTER TABLE ev TTL_ENABLE = 'ON'")
    out.append(db.run_ttl())
    db.execute("CREATE TABLE ev2 (id BIGINT PRIMARY KEY, d DATETIME)")
    db.execute("ALTER TABLE ev2 TTL = d + INTERVAL 1 WEEK")
    t = db.catalog.table("test", "ev2")
    out.append((t.ttl_days, t.ttl_col_offset))
    db.execute("ALTER TABLE ev2 REMOVE TTL")
    out.append(db.catalog.table("test", "ev2").ttl_col_offset)
    with pytest.raises(Exception) as ei:
        db.execute("CREATE TABLE bad (id BIGINT) TTL = id + INTERVAL 1 DAY")
    out.append(type(ei.value).__name__)
    return out


def case_on_partitioned_table(P):
    db = P.open()
    db.execute(
        "CREATE TABLE pv (id BIGINT PRIMARY KEY, d DATE, g BIGINT) "
        "PARTITION BY HASH (g) PARTITIONS 3 TTL = d + INTERVAL 5 DAY"
    )
    rows = ", ".join(f"({i}, '{_day(9 if i % 3 else 0)}', {i % 5})" for i in range(1, 61))
    db.execute(f"INSERT INTO pv VALUES {rows}")
    swept = db.run_ttl()
    dev = _dev(db, P.eng)
    after = dev.query("SELECT g, COUNT(*), SUM(id) FROM pv GROUP BY g ORDER BY g")
    assert dev.exec_summary.engines == {P.eng: 3}
    return swept, after


def case_timer_runtime(P):
    tr = P.timer()
    hits = []
    tr.register("a", 0.0, lambda: hits.append("a"))
    tr.register("boom", 0.0, lambda: 1 / 0)
    ran = sorted(tr.tick(force=True))
    boom = next(t for t in tr.timers() if t.name == "boom")
    tr2 = P.timer()
    tr2.register("slow", 9999, lambda: hits.append("slow"))
    tr2.timers()[0].last_run = time.monotonic()
    return ran, hits, "division" in boom.last_error, tr2.tick()


def case_background_domain_loop(P):
    db = P.open()
    db.execute("CREATE TABLE ev (id BIGINT PRIMARY KEY, created DATE) TTL = created + INTERVAL 1 DAY")
    db.execute(f"INSERT INTO ev VALUES (1, '{_day(5)}'), (2, '{_day(0)}')")
    dev = _dev(db, P.eng)
    db.start_background(ttl_interval_s=0.0, analyze_interval_s=9999, gc_interval_s=9999)
    try:
        deadline = time.time() + 10
        while time.time() < deadline and dev.query("SELECT COUNT(*) FROM ev") != [(1,)]:
            time.sleep(0.1)
        return dev.query("SELECT id FROM ev")
    finally:
        db.stop_background()


CASES = {name[5:]: fn for name, fn in sorted(globals().items()) if name.startswith("case_")}


@pytest.mark.parametrize("case", sorted(CASES))
def test_ttl_case_gives_the_references_answer(case):
    got = {pkg: CASES[case](P) for pkg, P in PKGS.items()}
    assert got["port"] == got["ref"]


def test_sweep_then_gpu_read_answers():
    before, sweeps, after, null_ids = case_expires_rows(PKGS["port"])
    assert before == [(300, 45150)]
    assert sweeps[1] == {} and sweeps[0]["test.ev"] > 0
    assert after[0][0] == 300 - sweeps[0]["test.ev"]
    assert null_ids == [(i,) for i in range(7, 301, 7)]  # NULL never expires


@pytest.fixture
def small_deltas():
    """Delta knobs small enough that a sweep of a few hundred rows stays a
    pending delta operand (graftfuzz's own per-case pin), in both packages."""
    olds = [(cfg, cfg.current()) for cfg in (ref_config, port_config)]
    for cfg, old in olds:
        cfg.set_current(dataclasses.replace(old, device_delta_min_rows=1, device_delta_cap=1024, device_delta_merge_rows=512))
    yield
    for cfg, old in olds:
        cfg.set_current(old)


def test_swept_rows_reach_the_device_as_the_delta_operand(small_deltas):
    """A device read builds the columns, the sweep deletes rows, and the
    next device read folds the deletions in as a delta: the port's gpu
    task and the reference's tpu task read the same delta rows and give
    the same answer."""
    got = {}
    for pkg, P in PKGS.items():
        db = P.open()
        db.execute("CREATE TABLE ev (id BIGINT PRIMARY KEY, created DATE, v BIGINT) TTL = created + INTERVAL 30 DAY")
        db.execute("INSERT INTO ev VALUES " + ", ".join(f"({i}, '{_day(i % 60)}', {i})" for i in range(1, 2001)))
        dev = _dev(db, P.eng)
        q = "SELECT COUNT(*), SUM(v) FROM ev"
        base = dev.query(q)
        swept = db.run_ttl()
        after = dev.query(q)
        summ = dev.exec_summary
        assert summ.engines == {P.eng: 1} and summ.delta_rows > 0, (pkg, summ.delta_rows)
        got[pkg] = base, swept, after, summ.delta_rows
    assert got["port"] == got["ref"]
    assert got["port"][2][0][0] == 2000 - got["port"][1]["test.ev"]
