"""The logical dump on the port (``tools/dumpling.py``, a copy), held
against the reference: ``SHOW CREATE TABLE`` of a partitioned, indexed
table (its ``PARTITION BY`` tail included), ``information_schema.COLUMNS``
and dumpling's SQL and CSV files give the reference's text, and a SQL
dump loads back into a fresh port DB whose ``gpu`` reads equal the
source's."""

import os
import sys
import types

import pytest

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import tidb_tpu  # noqa: E402
import tidb_tpu_torch  # noqa: E402
from tidb_tpu.tools import dumpling as ref_dumpling  # noqa: E402
from tidb_tpu_torch.tools import dumpling as port_dumpling  # noqa: E402

PKGS = {
    "ref": types.SimpleNamespace(open=lambda: tidb_tpu.open(), dumpling=ref_dumpling, eng="tpu"),
    "port": types.SimpleNamespace(open=lambda: tidb_tpu_torch.open(device="cpu"), dumpling=port_dumpling, eng="gpu"),
}

TABLES = [
    """CREATE TABLE sales (id BIGINT PRIMARY KEY, amt DECIMAL(12,2) NOT NULL, yr BIGINT,
         note VARCHAR(20) COLLATE utf8mb4_general_ci, d DATE, ts DATETIME, f DOUBLE,
         KEY kyr (yr), UNIQUE KEY unote (note, yr))
       PARTITION BY RANGE (yr) (
         PARTITION p0 VALUES LESS THAN (2000),
         PARTITION p1 VALUES LESS THAN (2010),
         PARTITION p2 VALUES LESS THAN MAXVALUE)""",
    "CREATE TABLE h (k BIGINT, v VARCHAR(8), KEY kv (v)) PARTITION BY HASH (k) PARTITIONS 4",
    "CREATE TABLE plain (a BIGINT PRIMARY KEY, b VARCHAR(10), c DECIMAL(10,3))",
]
ROWS = [
    "INSERT INTO sales VALUES (1, 10.50, 1995, 'a,b', '2020-01-02', '2020-01-02 03:04:05', 1.5), "
    "(2, 20.00, 2005, 'it''s', NULL, NULL, NULL), (3, 30.25, 2015, 'c\"d', '1999-12-31', NULL, -2.25), "
    "(4, 0.01, NULL, NULL, NULL, NULL, 0)",
    "INSERT INTO h VALUES (0, 'x'), (1, NULL), (2, 'y'), (NULL, 'z'), (7, 'x')",
    "INSERT INTO plain VALUES (1, 'one', 1.125), (2, NULL, NULL)",
]


def _db(P):
    db = P.open()
    for stmt in TABLES + ROWS:
        db.execute(stmt)
    return db


@pytest.mark.parametrize("table", ["sales", "h", "plain"])
def test_show_create_table_matches(table):
    got = {pkg: _db(P).query(f"SHOW CREATE TABLE {table}") for pkg, P in PKGS.items()}
    assert got["port"] == got["ref"]
    if table != "plain":
        assert "PARTITION BY" in got["port"][0][1]


def test_information_schema_columns_match():
    q = (
        "SELECT TABLE_NAME, COLUMN_NAME, ORDINAL_POSITION, DATA_TYPE, COLUMN_TYPE, IS_NULLABLE "
        "FROM information_schema.COLUMNS WHERE TABLE_SCHEMA = 'test' ORDER BY TABLE_NAME, ORDINAL_POSITION"
    )
    got = {pkg: _db(P).query(q) for pkg, P in PKGS.items()}
    assert got["port"] == got["ref"]
    assert len(got["port"]) == 12


def _files(path):
    return {name: open(os.path.join(path, name), encoding="utf-8").read() for name in sorted(os.listdir(path))}


@pytest.mark.parametrize("fmt", ["sql", "csv"])
def test_dump_files_match(tmp_path, fmt):
    got = {}
    for pkg, P in PKGS.items():
        dest = str(tmp_path / pkg)
        counts = P.dumpling.dump_database(_db(P), "test", dest, fmt=fmt)
        got[pkg] = counts, _files(dest)
    assert got["port"] == got["ref"]
    assert got["port"][0] == {"sales": 4, "h": 5, "plain": 2}


def test_sql_dump_loads_back_and_reads_on_gpu(tmp_path):
    P = PKGS["port"]
    src = _db(P)
    P.dumpling.dump_database(src, "test", str(tmp_path), fmt="sql")
    dst = P.open()
    P.dumpling.load_dump(dst, str(tmp_path), "test")
    for q in ("SELECT COUNT(*), SUM(amt) FROM sales WHERE yr >= 2000", "SELECT v, COUNT(*) FROM h GROUP BY v ORDER BY v"):
        rows = []
        for db in (src, dst):
            s = db.session()
            s.execute("SET tidb_isolation_read_engines = 'gpu'")
            rows.append(s.query(q))
            assert set(s.exec_summary.engines) == {"gpu"}
        assert rows[0] == rows[1], q
    assert dst.query("SHOW CREATE TABLE sales") == src.query("SHOW CREATE TABLE sales")
