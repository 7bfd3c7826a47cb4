"""BACKUP and RESTORE on the port (``tools/brie.py``, ``tools/storage.py``:
copies), held against the reference.

The cases of tests/test_tools.py (round trip, snapshot consistency) and
tests/test_external_storage.py (the ``memory://`` bucket, a ``file://``
URL, a cloud scheme) run on ``tidb_tpu.open()`` and
``tidb_tpu_torch.open(device="cpu")`` with the same outcome. A restored
lineitem is read on the port's ``gpu`` engine (its plain kernels here)
under a fresh table id and equals its source, the reference's engines and
the oracle. The row codec is a copy, so a backup written by one package
restores in the other to the same rows, both ways.
"""

import os
import sys
import types

import jax
import jax.experimental
import pytest

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke  # noqa: E402
import tidb_tpu  # noqa: E402
import tidb_tpu_torch  # noqa: E402
from tidb_tpu.tools import brie as ref_brie  # noqa: E402
from tidb_tpu.tools import storage as ref_storage  # noqa: E402
from tidb_tpu_torch.tools import brie as port_brie  # noqa: E402
from tidb_tpu_torch.tools import storage as port_storage  # noqa: E402

PKGS = {
    "ref": types.SimpleNamespace(open=lambda **kw: tidb_tpu.open(**kw), brie=ref_brie, storage=ref_storage, eng="tpu"),
    "port": types.SimpleNamespace(
        open=lambda **kw: tidb_tpu_torch.open(device="cpu", **kw), brie=port_brie, storage=port_storage, eng="gpu",
    ),
}
LI_QUERIES = chip_smoke.table_queries("li")


@pytest.fixture(autouse=True)
def _reference_pallas(monkeypatch):
    # the reference's Pallas kernel imports enable_x64 from jax.experimental,
    # which this jax no longer has; the test provides the name (the frozen
    # JAX package is not edited)
    monkeypatch.setattr(jax.experimental, "enable_x64", jax.enable_x64, raising=False)


def _emp_db(P):
    d = P.open()
    d.execute("CREATE TABLE emp (id BIGINT PRIMARY KEY, name VARCHAR(40), sal DECIMAL(10,2), hired DATE, dept BIGINT)")
    d.execute("CREATE INDEX idx_dept ON emp (dept)")
    d.execute("INSERT INTO emp VALUES (1, 'ann', 100.50, '2020-01-01', 10), "
              "(2, 'bob', 200.25, '2021-06-15', 20), (3, NULL, NULL, NULL, 10)")
    d.execute("CREATE TABLE plog (id BIGINT PRIMARY KEY, yr BIGINT) PARTITION BY RANGE (yr) "
              "(PARTITION p0 VALUES LESS THAN (2000), PARTITION p1 VALUES LESS THAN MAXVALUE)")
    d.execute("INSERT INTO plog VALUES (1, 1999), (2, 2020)")
    return d


def _bs_db(P):
    db = P.open()
    s = db.session()
    s.execute("CREATE TABLE bs (id BIGINT PRIMARY KEY, name VARCHAR(8), v BIGINT, KEY kv (v))")
    s.execute("INSERT INTO bs VALUES " + ", ".join(f"({i}, 'n{i % 5}', {i * 3})" for i in range(200)))
    return db


def _roundtrip(P, d):
    db = _emp_db(P)
    dest = str(d / "bk")
    backed = sorted(r[1] for r in db.execute(f"BACKUP DATABASE test TO '{dest}'").rows)
    assert backed == ["emp", "plog"] and os.path.exists(os.path.join(dest, "backupmeta.json"))
    restored = dict((r[0], r[1]) for r in db.execute(f"RESTORE DATABASE restored FROM '{dest}'").rows)
    s = db.session()
    a = s.query("SELECT * FROM test.emp ORDER BY id")
    b = s.query("SELECT * FROM restored.emp ORDER BY id")
    out = [backed, restored, a, b, s.query("SELECT id FROM restored.plog WHERE yr < 2000"),
           s.query("SELECT id FROM restored.emp WHERE dept = 10 ORDER BY id")]
    with pytest.raises(Exception) as e:
        db.execute(f"RESTORE DATABASE restored FROM '{dest}'")
    out.append(type(e.value).__name__)
    assert restored == {"emp": 3, "plog": 2} and a == b and out[4:6] == [[(1,)], [(1,), (3,)]]
    return out


def _snapshot_consistent(P, d):
    db = _emp_db(P)
    dest = str(d / "bk2")
    db.execute(f"BACKUP TABLE emp TO '{dest}'")
    db.execute("INSERT INTO emp VALUES (9, 'late', 1.00, '2024-01-01', 30)")
    db.execute(f"RESTORE DATABASE r2 FROM '{dest}'")
    s = db.session()
    out = [s.query("SELECT COUNT(*) FROM r2.emp"), s.query("SELECT COUNT(*) FROM test.emp")]
    assert out == [[(3,)], [(4,)]]
    return out


def _memory_bucket(P, d):
    db = _bs_db(P)
    url = "memory://brtest/run1"
    meta = P.brie.backup_database(db, "test", url)
    files = sorted(P.storage.MemStorage("brtest", "run1").list_files())
    db2 = P.open()
    out, _ = P.brie.restore_database(db2, url)
    res = [meta["tables"]["bs"]["rows"], files, out, db2.query("SELECT COUNT(*), SUM(v) FROM bs"),
           db2.query("SELECT id FROM bs WHERE v = 30")]
    assert res == [200, ["backup.checkpoint.json", "backupmeta.json", "test.bs.rows"], {"bs": 200},
                   [(200, sum(i * 3 for i in range(200)))], [(10,)]]
    return res


def _file_url(P, d):
    db = _bs_db(P)
    url = f"file://{d}/bk"
    P.brie.backup_database(db, "test", url)
    db2 = P.open()
    out, _ = P.brie.restore_database(db2, url)
    assert out == {"bs": 200}
    return out, db2.query("SELECT * FROM bs ORDER BY id")


def _cloud_scheme(P, d):
    with pytest.raises(ValueError, match="cloud client") as e:
        P.storage.open_storage("s3://bucket/prefix")
    return str(e.value).replace("tidb_tpu_torch.", "tidb_tpu.")


CASES = {
    "backup_restore_roundtrip": _roundtrip,
    "backup_is_snapshot_consistent": _snapshot_consistent,
    "backup_restore_through_memory_bucket": _memory_bucket,
    "backup_restore_file_url": _file_url,
    "cloud_scheme_names_the_seam": _cloud_scheme,
}


@pytest.mark.parametrize("case", list(CASES))
def test_brie_case_answers_as_the_reference(case, tmp_path):
    out = {}
    for pkg, P in PKGS.items():
        d = tmp_path / pkg
        d.mkdir()
        out[pkg] = CASES[case](P, d)
    assert out["port"] == out["ref"]


def _li_db(P):
    db = P.open(region_split_keys=1000)
    s = db.session()
    s.execute(chip_smoke.SQL_SCHEMA.replace("lineitem", "li", 1))
    return db, s


def _load_li(s, tmp_path, cols):
    p = tmp_path / "li.csv"
    p.write_text(chip_smoke.lineitem_csv(cols))
    s.execute(f"LOAD DATA INFILE '{p}' INTO TABLE li FIELDS TERMINATED BY ','")


def _read_all(s, engine, table):
    s.execute(f"SET tidb_isolation_read_engines='{engine}'")
    out = {}
    for name, sql in chip_smoke.table_queries(table).items():
        out[name] = chip_smoke.sql_rows(name, s.query(sql))
        assert set(s.exec_summary.engines) == {engine} and not s.exec_summary.degraded, (engine, table, name)
    return out


def test_restore_read_on_the_device_engine_equals_the_source(tmp_path):
    """lineitem (2,400 rows, two regions at region_split_keys = 1,000)
    read on the device engine, backed up and restored into database r: the
    restored table has a new physical id, and the seven statements over it
    on the port's gpu engine equal the source's, the reference's tpu and
    host engines and the oracle."""
    cols = chip_smoke.lineitem_sf1(seed=31, n=2400)
    want = {name: chip_smoke.sql_oracle(name, cols) for name in LI_QUERIES}
    for pkg, P in PKGS.items():
        d = tmp_path / pkg
        d.mkdir()
        db, s = _li_db(P)
        _load_li(s, d, cols)
        assert _read_all(s, P.eng, "li") == want
        s.execute(f"BACKUP DATABASE test TO 'file://{d}/bk'")
        assert s.execute(f"RESTORE DATABASE r FROM 'file://{d}/bk'").rows == [("li", 2400)]
        assert db.catalog.table("r", "li").id != db.catalog.table("test", "li").id
        for engine in (P.eng, "host"):
            assert _read_all(s, engine, "r.li") == want, (pkg, engine)
        assert _read_all(s, P.eng, "li") == want
        db.stop_background()


@pytest.mark.parametrize("direction", ["ref_to_port", "port_to_ref"])
def test_a_backup_restores_in_the_other_package(tmp_path, direction):
    """A backup written by one package (an indexed table, a partitioned one,
    lineitem) restores in the other to the same rows, read on its device
    engine and on the host engine, with the restored index answering."""
    src, dst = (PKGS["ref"], PKGS["port"]) if direction == "ref_to_port" else (PKGS["port"], PKGS["ref"])
    cols = chip_smoke.lineitem_sf1(seed=32, n=1500)
    db = _emp_db(src)
    s = db.session()
    s.execute(chip_smoke.SQL_SCHEMA.replace("lineitem", "li", 1))
    _load_li(s, tmp_path, cols)
    url = f"file://{tmp_path}/bk"
    src.brie.backup_database(db, "test", url)
    db2 = dst.open(region_split_keys=1000)
    out, _ = dst.brie.restore_database(db2, url)
    assert out == {"emp": 3, "plog": 2, "li": 1500}
    s2 = db2.session()
    for engine in (dst.eng, "host"):
        s2.execute(f"SET tidb_isolation_read_engines='{engine}'")
        for q in ("SELECT * FROM emp ORDER BY id", "SELECT id FROM emp WHERE dept = 10 ORDER BY id",
                  "SELECT * FROM plog ORDER BY id", "SELECT id FROM plog WHERE yr < 2000"):
            assert s2.query(q) == s.query(q), (engine, q)
        for name, sql in LI_QUERIES.items():
            assert chip_smoke.sql_rows(name, s2.query(sql)) == chip_smoke.sql_oracle(name, cols), (engine, name)
    db.stop_background()
    db2.stop_background()
