"""The inspection rules and the diag bundle on the port
(``utils/inspection.py``: a copy with one seam; ``tools/diag.py``: a
copy), held against the reference.

The cases of tests/test_diagnostics.py run on the port: every rule reaches
warning and critical on synthetic contexts (with the reference's rows on
the same contexts), the ``inspection_result`` / ``inspection_rules``
tables, a byte-deterministic bundle, and a SIGKILLed store of a
three-process port fleet diagnosed through SQL. The seam: the hbm-pressure
rule judges the device cache against ``gpu_engine.planning_budget(store)``,
the budget the planner weighs it against, read without opening a CUDA
context; everything else in a bundle is the reference's.
"""

import dataclasses
import hashlib
import json
import os
import re
import signal
import subprocess
import sys
import threading
import time

import jax
import jax.experimental
import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke  # noqa: E402
import tidb_tpu  # noqa: E402
import tidb_tpu_torch  # noqa: E402
from tidb_tpu.utils import inspection as ref_inspection  # noqa: E402
from tidb_tpu_torch.copr import gpu_engine  # noqa: E402
from tidb_tpu_torch.kv.remote import RemoteStore, StoreServer  # noqa: E402
from tidb_tpu_torch.kv.sharded import ShardedStore  # noqa: E402
from tidb_tpu_torch.session.session import DB  # noqa: E402
from tidb_tpu_torch.tools import diag  # noqa: E402
from tidb_tpu_torch.utils import eventlog as _ev  # noqa: E402
from tidb_tpu_torch.utils import inspection  # noqa: E402
from tidb_tpu_torch.utils.inspection import InspectionContext, inspect, rules_catalog  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RULES = ("store-liveness", "store-skew", "plan-cache", "hbm-pressure", "mpp-straggler", "backoff-storm",
         "delta-backlog")


@pytest.fixture
def fresh_log():
    _ev.reset()
    yield
    _ev.reset()


def _by_rule(rows):
    out = {}
    for r in rows:
        out.setdefault(r[0], []).append(r)
    return out


WARN_CTX = dict(
    health={"tikv:a": {"ok": True}}, stale={"tikv:a": True}, staleness_s={"tikv:a": 90.0}, weights=[30.0, 10.0],
    skew_ratio=2.0, plan_cache={"hit": 40, "miss": 60}, cache_bytes={"tikv:a": 85}, hbm_budget=100,
    mpp_shards={"count": 20, "sum": 1.0, "buckets": [[0.01, 10], [0.05, 19], ["+Inf", 20]]},
    backoff_rate=10.0, delta_rows=3000.0, delta_merge_rows=2048,
    region_traffic={("tikv:a", 1, 7): 500, ("tikv:a", 2, 7): 100, ("tikv:a", 3, 7): 100},
)
CRIT_CTX = dict(
    health={"tikv:b": {"ok": False, "error": "connection refused"}}, stale={"tikv:b": True}, weights=[100.0, 10.0],
    skew_ratio=2.0, plan_cache={"hit": 1, "miss": 99}, cache_bytes={"tikv:b": 96}, hbm_budget=100,
    mpp_shards={"count": 20, "sum": 5.0, "buckets": [[0.01, 10], [1.0, 19], ["+Inf", 20]]},
    backoff_rate=100.0, delta_rows=10_000.0, delta_merge_rows=2048,
    region_traffic={("tikv:b", 1, 7): 5000, ("tikv:b", 2, 7): 100, ("tikv:b", 3, 7): 100},
)


@pytest.mark.parametrize("level,kw", [("warning", WARN_CTX), ("critical", CRIT_CTX)])
def test_every_rule_reaches_its_level_as_the_reference(fresh_log, level, kw):
    rows = inspect(ctx=InspectionContext(**kw))
    assert rows == ref_inspection.inspect(ctx=ref_inspection.InspectionContext(**kw), echo=False)
    by = _by_rule(rows)
    for rule in RULES + ("hot-region",):
        assert any(r[2] == level for r in by[rule]), (rule, by[rule])
    echoed = {e[3] for e in _ev.get().search(component="inspection", min_level=_ev.ERROR, limit=None)}
    if level == "critical":
        assert ("store-liveness", "tikv:b") in {(r[0], r[1]) for r in by["store-liveness"]}
        assert echoed >= set(RULES)
    else:
        assert echoed == set()


def test_the_rules_catalog_is_the_references_but_the_budget_it_names():
    port, ref = rules_catalog(), ref_inspection.rules_catalog()
    assert [(n, t) for n, t, _c in port] == [(n, t) for n, t, _c in ref]
    differ = [(p[0], p[2], r[2]) for p, r in zip(port, ref) if p[2] != r[2]]
    assert [d[0] for d in differ] == ["hbm-pressure"]
    assert "TIDB_TPU_HBM_GB" in differ[0][2] and "TIDB_TPU_HBM_GB" not in differ[0][1]


def test_inspection_tables_and_catalog(fresh_log):
    db = DB()
    s = db.session()
    db.health.sweep(sections=())
    rules = dict((r[0], r[1]) for r in s.query("SELECT NAME, TYPE FROM information_schema.inspection_rules"))
    assert set(rules) == {n for n, _t, _c in rules_catalog()}
    rows = s.query("SELECT RULE, ITEM, STATUS FROM information_schema.inspection_result")
    assert {r[0] for r in rows} == set(rules)
    assert all(r[2] in ("ok", "warning", "critical") for r in rows)


def _budget_row(db):
    rows = db.query("SELECT ITEM, DETAIL FROM information_schema.inspection_result WHERE RULE = 'hbm-pressure'")
    m = re.fullmatch(r"(\d+) bytes resident of (\d+) budget", rows[0][1])
    return rows[0][0], int(m.group(1)), int(m.group(2))


@pytest.mark.parametrize("device,budget", [("cpu", 8 << 30), ("cuda", 40 << 30)])
def test_hbm_budget_is_the_planning_budget_without_a_cuda_context(monkeypatch, device, budget):
    """The hbm-pressure budget is ``planning_budget(store)`` for a CPU store
    and for a store whose device is ``"cuda"``: half of an 80 GB card.
    Nothing opens a CUDA context on the way (every entry into torch's CUDA
    initialisation raises here)."""

    def no_cuda(*a, **k):
        raise AssertionError("the inspection touched the card")

    for name in ("_lazy_init", "init", "mem_get_info", "current_device", "synchronize"):
        monkeypatch.setattr(torch.cuda, name, no_cuda)
    db = tidb_tpu_torch.open(device=device)
    ctx = InspectionContext.from_db(db)
    assert ctx.hbm_budget == gpu_engine.planning_budget(db.store) == budget
    assert _budget_row(db)[2] == budget
    assert not torch.cuda.is_initialized()


def test_resident_bytes_are_the_references(tmp_path, monkeypatch):
    """After the same lineitem is read on each package's device engine, the
    hbm-pressure rule reads the same resident bytes in both (the column
    cache's, as the reference counts them) and only the budget differs:
    the reference's TIDB_TPU_HBM_GB default (12 GiB), the port's
    planning budget (8 GiB on a CPU store)."""
    # the reference's Pallas kernel imports enable_x64 from jax.experimental,
    # which this jax no longer has (the frozen JAX package is not edited)
    monkeypatch.setattr(jax.experimental, "enable_x64", jax.enable_x64, raising=False)
    cols = chip_smoke.lineitem_sf1(seed=61, n=2000)
    p = tmp_path / "li.csv"
    p.write_text(chip_smoke.lineitem_csv(cols))
    got = {}
    for pkg, db in (("ref", tidb_tpu.open()), ("port", tidb_tpu_torch.open(device="cpu"))):
        db.execute(chip_smoke.SQL_SCHEMA)
        db.execute(f"LOAD DATA INFILE '{p}' INTO TABLE lineitem FIELDS TERMINATED BY ','")
        for sql in chip_smoke.SQL_QUERIES.values():
            db.query(sql)
        _item, resident, budget = _budget_row(db)
        got[pkg] = (resident, budget)
        db.stop_background()
    assert got["port"][0] == got["ref"][0] > 0
    assert (got["ref"][1], got["port"][1]) == (12 << 30, 8 << 30)


def test_diag_bundle_byte_determinism(fresh_log, tmp_path):
    db = DB()
    db.session().query("SELECT 1")
    db.health.sweep()
    _ev.get().emit(_ev.WARN, "mpp", "redispatch", trace_id="t1", attempt=1)
    p1 = diag.write_bundle(db, str(tmp_path / "a"))
    p2 = diag.write_bundle(db, str(tmp_path / "b"))
    names = [os.path.basename(p) for p in p1]
    assert {"logs.json", "inspection.json", "sys_reports.json", "config.json", "versions.json",
            "slow_queries.json", "metrics_history.json"} == set(names)
    for a, b in zip(p1, p2):
        assert hashlib.sha256(open(a, "rb").read()).digest() == hashlib.sha256(open(b, "rb").read()).digest(), a
    logs = json.loads(open(os.path.join(str(tmp_path / "a"), "logs.json")).read())
    assert any(e["component"] == "mpp" and e["trace_id"] == "t1" for e in logs)


_BOTH_BUNDLES = r"""
import json, sys
sys.path.insert(0, {repo!r})
import jax
jax.config.update("jax_platforms", "cpu")
from tidb_tpu.session.session import DB as RefDB
from tidb_tpu.tools import diag as ref_diag
from tidb_tpu_torch.session.session import DB as PortDB
from tidb_tpu_torch.tools import diag as port_diag
from tidb_tpu_torch.kv.sharded import ShardedStore
out = {{}}
for name, DB, diag in (("ref", RefDB, ref_diag), ("port", PortDB, port_diag)):
    DB().session().query("SELECT 1")  # the first statement's imports stay out of the slow log
    db = DB()
    db.session().query("SELECT 1")
    db.health.sweep()
    inst = ShardedStore.instance_name(db.store)
    text = json.dumps(diag.collect(db), sort_keys=True, default=str)
    out[name] = json.loads(text.replace(inst, "<instance>"))
print(json.dumps(out))
"""


def _timeless(x):
    """A bundle without what the clock sets: the store's start time and the
    buckets and sums of the duration histograms (their counts stay)."""
    if isinstance(x, list):
        return [_timeless(v) for v in x]
    if not isinstance(x, dict):
        return x
    out = {}
    for k, v in x.items():
        if k == "start_time":
            continue
        if k.endswith("_seconds") and isinstance(v, dict) and v.get("kind") == "histogram":
            v = {"kind": "histogram", "count": v["count"]}
        out[k] = _timeless(v)
    return out


def test_bundles_differ_from_the_references_only_in_the_budget():
    """The same fresh DB in each package, in a fresh process: the two
    bundles are equal file by file (the store's instance name and what the
    clock sets aside), but for the hbm-pressure row's budget and the
    rule's comment naming it."""
    env = {**os.environ, "JAX_PLATFORMS": "cpu"}
    env.pop("PYTHONPATH", None)
    res = subprocess.run([sys.executable, "-c", _BOTH_BUNDLES.format(repo=REPO)], capture_output=True, text=True,
                         timeout=300, env=env)
    assert res.returncode == 0, res.stderr[-2000:]
    out = {p: _timeless(b) for p, b in json.loads(res.stdout.strip().splitlines()[-1]).items()}
    assert sorted(out["port"]) == sorted(out["ref"])
    differ = sorted(k for k in out["port"] if out["port"][k] != out["ref"][k])
    assert differ == ["inspection.json"]
    budgets = {p: re.search(r"of (\d+) budget", json.dumps(out[p]["inspection.json"])).group(1) for p in out}
    assert budgets == {"ref": str(12 << 30), "port": str(40 << 30)}  # DB() opens on the card's budget
    port, ref = out["port"]["inspection.json"], out["ref"]["inspection.json"]
    for b in (port, ref):
        for r in b["results"]:
            if r["rule"] == "hbm-pressure":
                r["detail"] = re.sub(r"of \d+ budget", "of <budget> budget", r["detail"])
        for r in b["rules"]:
            if r["name"] == "hbm-pressure":
                r["comment"] = "<budget>"
    assert port == ref


def _diag_cli(tmp_path, *extra):
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    out = tmp_path / "bundle"
    res = subprocess.run([sys.executable, "-m", "tidb_tpu_torch.tools.diag", "--out", str(out), *extra],
                         capture_output=True, text=True, timeout=300, cwd=REPO, env=env)
    assert res.returncode == 0, res.stderr[-2000:]
    files = sorted(os.path.basename(p) for p in res.stdout.split())
    assert files == sorted(os.listdir(out)) and len(files) == 7
    return json.loads((out / "inspection.json").read_text())


def test_diag_cli_on_an_embedded_db(tmp_path):
    """``python -m tidb_tpu_torch.tools.diag --out DIR``: a fresh embedded
    DB (the card's budget: ``DB()`` opens no device) writes its seven
    files."""
    res = _diag_cli(tmp_path)
    hbm = [r for r in res["results"] if r["rule"] == "hbm-pressure"]
    assert hbm and hbm[0]["detail"].endswith(f"of {40 << 30} budget")


def test_diag_cli_on_a_store_server(tmp_path):
    """``--store HOST:PORT``: the bundle of a port store server on a thread
    of this process, its health swept over the wire."""
    db = tidb_tpu_torch.open(device="cpu")
    srv = StoreServer(db.store)
    port = srv.start()
    try:
        res = _diag_cli(tmp_path, "--store", f"127.0.0.1:{port}")
        live = [r for r in res["results"] if r["rule"] == "store-liveness"]
        assert live == [{"detail": "", "item": f"127.0.0.1:{port}", "reference": "ok", "rule": "store-liveness",
                         "status": "ok", "value": "up"}]
    finally:
        srv.shutdown()
        db.stop_background()


_SERVER_SCRIPT = r"""
import sys, time
sys.path.insert(0, {repo!r})
from tidb_tpu_torch.kv.memstore import MemStore
from tidb_tpu_torch.kv.remote import StoreServer

store = MemStore(region_split_keys=100_000)
store.device = "cpu"  # the store's gpu engine on its plain path: no card here
srv = StoreServer(store)
print(f"PORT {{srv.start()}}", flush=True)
while True:
    time.sleep(1)
"""


def _spawn():
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    return subprocess.Popen([sys.executable, "-c", _SERVER_SCRIPT.format(repo=REPO)], stdout=subprocess.PIPE,
                            stderr=subprocess.DEVNULL, text=True, env=env)


def _port(proc):
    got: list = []

    def reader():
        for line in proc.stdout:
            if line.startswith("PORT "):
                got.append(int(line.split()[1]))
                return

    t = threading.Thread(target=reader, daemon=True, name="diag-port-reader")
    t.start()
    t.join(timeout=120)
    if not got:
        proc.kill()
        raise RuntimeError("store server did not report a port within 120s")
    return got[0]


@pytest.mark.chaos
def test_chaos_sigkill_diagnosed_through_sql(fresh_log):
    """tests/test_diagnostics.py's postmortem on a three-process port fleet:
    one store SIGKILLed, the survivors keep answering, and
    ``inspection_result`` names the dead instance while ``cluster_log``
    shows the inspection finding and the backoff trail."""
    procs = [_spawn(), _spawn(), _spawn()]
    try:
        ports = [_port(p) for p in procs]
        stores = [RemoteStore("127.0.0.1", p, retry_budget_ms=250, backoff_seed=0) for p in ports]
        db = DB(store=ShardedStore(stores))
        db.store.device = "cpu"
        s = db.session()
        for i, name in enumerate(("da", "db_", "dc")):
            s.execute(f"CREATE TABLE {name} (id BIGINT PRIMARY KEY, v BIGINT)")
            s.execute(f"INSERT INTO {name} VALUES " + ",".join(f"({j},{j})" for j in range(100 + i)))
        shard_of = {name: db.store.shard_of_table(db.catalog.table("test", name).id) for name in ("da", "db_", "dc")}
        db.health.sweep()
        victim = shard_of["da"]
        dead_addr = f"127.0.0.1:{ports[victim]}"
        procs[victim].send_signal(signal.SIGKILL)
        procs[victim].wait(timeout=10)
        time.sleep(0.2)
        survivor = next(n for n, sh in shard_of.items() if sh != victim)
        expect = 100 + ("da", "db_", "dc").index(survivor)
        assert s.query(f"SELECT COUNT(*) FROM {survivor}") == [(expect,)]
        t0 = time.time()
        with pytest.raises(Exception):
            s.query("SELECT COUNT(*) FROM da")
        assert time.time() - t0 < 30
        db.health.sweep()
        rows = s.query("SELECT RULE, ITEM, STATUS FROM information_schema.inspection_result WHERE STATUS = 'critical'")
        assert ("store-liveness", dead_addr, "critical") in rows, rows
        comps = {r[0] for r in s.query(
            "SELECT COMPONENT, EVENT FROM information_schema.cluster_log WHERE LEVEL = 'error'")}
        assert {"inspection", "backoff"} <= comps
        assert s.query(f"SELECT COUNT(*) FROM {survivor}") == [(expect,)]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait(timeout=10)


def test_the_seam_reads_no_environment_knob(monkeypatch):
    """The reference's TIDB_TPU_HBM_GB does not reach the port's budget."""
    monkeypatch.setenv("TIDB_TPU_HBM_GB", "1")
    db = tidb_tpu_torch.open(device="cpu")
    assert InspectionContext.from_db(db).hbm_budget == 8 << 30
    assert ref_inspection.InspectionContext.from_db(tidb_tpu.open()).hbm_budget == 1 << 30
    assert [f.name for f in dataclasses.fields(InspectionContext)] == [
        f.name for f in dataclasses.fields(ref_inspection.InspectionContext)]
    assert inspection._RULES and len(inspection._RULES) == len(ref_inspection._RULES)
