"""PLAN REPLAYER DUMP and LOAD on the port (``tools/replayer.py``: a copy),
held against the reference.

tests/test_observability2.py::test_plan_replayer_roundtrip runs on both
packages: a fresh database loaded from a dump plans the dumped statement as
its source did, without ANALYZE. A port dump carries
``tidb_isolation_read_engines = "gpu,host"`` and replays to the same
``[gpu]`` readers; a reference dump carries ``"tpu,host"``, which names no
engine of the port, so the port plans it on the host engine (no
translation: the reference has none). The default dump directory is under
``HOME``, which the tests point at a temporary directory.
"""

import io
import json
import os
import sys
import types
import zipfile

import jax
import jax.experimental
import pytest

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke  # noqa: E402
import tidb_tpu  # noqa: E402
import tidb_tpu_torch  # noqa: E402
from tidb_tpu.executor.load import bulk_load as ref_bulk_load  # noqa: E402
from tidb_tpu.kv.tablecodec import record_key as ref_record_key  # noqa: E402
from tidb_tpu.parallel import mesh as ref_mesh  # noqa: E402
from tidb_tpu.tools import replayer as ref_replayer  # noqa: E402
from tidb_tpu_torch.executor.load import bulk_load as port_bulk_load  # noqa: E402
from tidb_tpu_torch.kv.tablecodec import record_key as port_record_key  # noqa: E402
from tidb_tpu_torch.parallel import mesh as port_mesh  # noqa: E402
from tidb_tpu_torch.tools import replayer as port_replayer  # noqa: E402

PKGS = {
    "ref": types.SimpleNamespace(open=lambda **kw: tidb_tpu.open(**kw), replayer=ref_replayer,
                                 bulk_load=ref_bulk_load, record_key=ref_record_key, eng="tpu"),
    "port": types.SimpleNamespace(open=lambda **kw: tidb_tpu_torch.open(device="cpu", **kw), replayer=port_replayer,
                                  bulk_load=port_bulk_load, record_key=port_record_key, eng="gpu"),
}


@pytest.fixture(autouse=True)
def _home(monkeypatch, tmp_path):
    # PLAN REPLAYER DUMP writes under ~/.tidb_tpu_replayer
    monkeypatch.setenv("HOME", str(tmp_path / "home"))
    monkeypatch.setattr(jax.experimental, "enable_x64", jax.enable_x64, raising=False)


def _roundtrip(P, d):
    db = P.open()
    s = db.session()
    s.execute("CREATE TABLE f (k BIGINT, v BIGINT)")
    s.execute("CREATE TABLE d (k BIGINT PRIMARY KEY, g BIGINT)")
    s.execute("INSERT INTO d VALUES (0, 10), (1, 11), (2, 12)")
    s.execute("INSERT INTO f VALUES (0, 1), (1, 2), (1, 3), (2, 4), (0, 5)")
    s.execute("ANALYZE TABLE f")
    s.execute("ANALYZE TABLE d")
    q = "SELECT g, SUM(v) FROM f, d WHERE f.k = d.k GROUP BY g"
    plan_src = "\n".join(r[0] for r in s.execute("EXPLAIN " + q).rows)
    path = P.replayer.dump(s, q, out_dir=str(d))
    tok = s.execute(f"PLAN REPLAYER DUMP EXPLAIN {q}").rows[0][0]
    assert tok.endswith(".zip") and tok.startswith(os.path.join(os.environ["HOME"], ".tidb_tpu_replayer"))
    s2 = P.open().session()
    loaded = s2.execute(f"PLAN REPLAYER LOAD '{path}'").rows[0][0]
    assert loaded == q and s2.execute("SHOW CREATE TABLE f").rows
    plan_dst = "\n".join(r[0] for r in s2.execute("EXPLAIN " + q).rows)
    t = s2._db.catalog.table("test", "f")
    row_count = s2._db.stats.get(t.id).row_count
    assert plan_dst == plan_src and row_count == 5
    return plan_dst.replace(f"[{P.eng}]", "[dev]"), row_count, sorted(s2.query(q))


def test_plan_replayer_roundtrip_answers_as_the_reference(tmp_path, monkeypatch):
    # the exchange a join plans follows the mesh width: the same in both
    for mesh in (ref_mesh, port_mesh):
        monkeypatch.setattr(mesh, "FORCE_NDEV", 4)
    out = {}
    for pkg, P in PKGS.items():
        d = tmp_path / pkg
        d.mkdir()
        out[pkg] = _roundtrip(P, d)
    assert out["port"] == out["ref"]


def _band_db(P, cols):
    db = P.open(region_split_keys=1 << 62)
    chip_smoke.lineitem_sql(db, P.bulk_load, P.record_key, cols, parts=2)
    db.session().execute("ANALYZE TABLE lineitem")
    return db


def _readers(plan):
    return [ln.strip() for ln in plan if "TableReader" in ln]


@pytest.mark.parametrize("name", ["band", "q6", "q1"])
def test_a_port_dump_replays_to_the_same_gpu_readers(tmp_path, name):
    """A port dump of a statement over lineitem (two regions, ANALYZEd)
    carries ``gpu,host`` and loads into a fresh port DB whose EXPLAIN shows
    the same ``[gpu]`` readers; the reference's round trip gives the same
    plan with ``[tpu]``."""
    cols = chip_smoke.lineitem_sf1(seed=51, n=2000)
    sql = chip_smoke.SQL_QUERIES[name]
    plans = {}
    for pkg, P in PKGS.items():
        s = _band_db(P, cols).session()
        src = [r[0] for r in s.query("EXPLAIN " + sql)]
        path = P.replayer.dump(s, sql, out_dir=str(tmp_path / pkg))
        with zipfile.ZipFile(path) as z:
            engines = json.loads(z.read("variables.json"))["tidb_isolation_read_engines"]
        s2 = P.open().session()
        assert s2.execute(f"PLAN REPLAYER LOAD '{path}'").rows[0][0] == sql
        dst = [r[0] for r in s2.query("EXPLAIN " + sql)]
        assert dst == src
        assert _readers(dst) and all(f"[{P.eng}]" in ln for ln in _readers(dst))
        plans[pkg] = (engines, [ln.replace(f"[{P.eng}]", "[dev]") for ln in dst])
    assert plans["port"][0] == "gpu,host" and plans["ref"][0] == "tpu,host"
    assert plans["port"][1] == plans["ref"][1]


def test_a_reference_dump_plans_on_the_host_in_the_port(tmp_path):
    """A reference dump names ``tpu,host``. Loaded into the port, the
    session reads only the engines it names, and the port has no ``tpu``:
    the band statement plans ``[host]`` readers and answers the oracle on
    the host engine. Pinned as it is; the port adds no translation."""
    cols = chip_smoke.lineitem_sf1(seed=52, n=2000)
    sql = chip_smoke.SQL_QUERIES["band"]
    s = _band_db(PKGS["ref"], cols).session()
    path = ref_replayer.dump(s, sql, out_dir=str(tmp_path))
    port = tidb_tpu_torch.open(device="cpu", region_split_keys=1 << 62)
    s2 = port.session()
    assert s2.execute(f"PLAN REPLAYER LOAD '{path}'").rows[0][0] == sql
    assert s2.query("SELECT @@tidb_isolation_read_engines") == [("tpu,host",)]
    readers = _readers(r[0] for r in s2.query("EXPLAIN " + sql))
    assert readers and all("[host]" in ln for ln in readers)
    # the schema arrived empty: load the rows, read them on the replayed engines
    port.execute("DROP TABLE lineitem")
    chip_smoke.lineitem_sql(port, port_bulk_load, port_record_key, cols, parts=2)
    assert chip_smoke.sql_rows("band", s2.query(sql)) == chip_smoke.sql_oracle("band", cols)
    assert s2.exec_summary.engines == {"host": 2}
    port.stop_background()


def test_the_dump_is_a_zip_of_the_reference_layout(tmp_path):
    """The port's dump holds the reference's six members, with the same
    schema text, SQL and statistics (but their version, a timestamp)."""
    cols = chip_smoke.lineitem_sf1(seed=53, n=1000)
    members = {}
    for pkg, P in PKGS.items():
        s = _band_db(P, cols).session()
        path = P.replayer.dump(s, chip_smoke.SQL_QUERIES["q6"], out_dir=str(tmp_path / pkg))
        with zipfile.ZipFile(path) as z:
            members[pkg] = {n: z.read(n).decode() for n in z.namelist()}
    assert sorted(members["port"]) == sorted(members["ref"]) == [
        "explain.txt", "meta.json", "schema.sql", "sql.sql", "stats.json", "variables.json",
    ]
    for n in ("schema.sql", "sql.sql"):
        assert members["port"][n] == members["ref"][n]
    stats = {pkg: json.load(io.StringIO(m["stats.json"])) for pkg, m in members.items()}
    for st in stats.values():
        st["test.lineitem"].pop("version")  # the ANALYZE's timestamp
    assert stats["port"] == stats["ref"]
