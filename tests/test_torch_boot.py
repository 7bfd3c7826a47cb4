"""``python -m tidb_tpu_torch --device cpu`` booted as a process, as
``tests/test_bootable_server.py`` boots ``python -m tidb_tpu``: embedded
with the status server, from a TOML config, and the two-process topology
(a SQL layer over ``--store-server``). Each process answers through the
MySQL wire, exits 0 on SIGTERM and imports no ``jax`` and no ``tidb_tpu``
module: it runs under ``-X importtime``, whose report of every module the
process imported goes to a file the test reads after the exit."""

import os
import re
import signal
import subprocess
import sys
import urllib.request

import pytest

from tidb_tpu_torch.server.client import Client

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_IMPORT = re.compile(r"^import time:\s+\d+ \|\s+\d+ \|\s*(\S+)\s*$")


def _boot(tmp_path, args):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    log = open(tmp_path / f"imports_{len(list(tmp_path.iterdir()))}.txt", "w")
    proc = subprocess.Popen(
        [sys.executable, "-X", "importtime", "-m", "tidb_tpu_torch", "--device", "cpu", *args],
        stdout=subprocess.PIPE, stderr=log, text=True, cwd=REPO, env=env,
    )
    proc.import_log = log.name
    line = proc.stdout.readline()
    if not line.startswith("ready"):
        proc.kill()
        raise RuntimeError(f"server did not report ready: {line!r}")
    parts = dict(kv.split("=") for kv in line.split()[1:])
    return proc, {k: int(v) for k, v in parts.items()}


def _stop(proc):
    """SIGTERM → rc 0, and no jax or tidb_tpu module was ever imported."""
    if proc.poll() is None:
        proc.send_signal(signal.SIGTERM)
        try:
            proc.wait(timeout=20)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.wait()
    with open(proc.import_log) as f:
        mods = [m.group(1) for ln in f if (m := _IMPORT.match(ln))]
    assert "tidb_tpu_torch.__main__" in mods or "tidb_tpu_torch" in mods
    bad = [m for m in mods if m.split(".")[0] in ("jax", "jaxlib", "tidb_tpu")]
    assert bad == [], bad
    assert proc.returncode == 0  # SIGTERM → clean shutdown


def test_boot_embedded_and_query(tmp_path):
    proc, ports = _boot(tmp_path, ["--port", "0", "--status-port", "0"])
    try:
        c = Client("127.0.0.1", ports["port"])
        c.query("CREATE TABLE bb (a BIGINT PRIMARY KEY, b VARCHAR(8))")
        c.query("INSERT INTO bb VALUES (1, 'x'), (2, 'y')")
        assert c.query("SELECT a, b FROM bb ORDER BY a") == [("1", "x"), ("2", "y")]
        assert c.query("SELECT COUNT(*), SUM(a) FROM bb") == [("2", "3")]
        c.close()
        with urllib.request.urlopen(f"http://127.0.0.1:{ports['status']}/status", timeout=5) as r:
            assert b"tidb-tpu" in r.read()
    finally:
        _stop(proc)


def test_boot_toml_config(tmp_path):
    cfg = tmp_path / "tidb.toml"
    cfg.write_text(
        """
[server]
port = 0

[status]
report-status = false

[session.variables]
tidb_allow_mpp = 0
"""
    )
    proc, ports = _boot(tmp_path, ["--config", str(cfg)])
    try:
        c = Client("127.0.0.1", ports["port"])
        assert c.query("SELECT @@tidb_allow_mpp") == [("0",)]
        assert "status" not in ports
        c.close()
    finally:
        _stop(proc)


def test_boot_two_process_topology(tmp_path):
    """The SQL layer plans; the store process runs the cop tasks (a grouped
    SELECT over the wire equals the embedded port's answer)."""
    import tidb_tpu_torch

    store_proc, store_ports = _boot(tmp_path, ["--store-server", "--port", "0"])
    sql_proc = None
    stmts = [
        "CREATE TABLE tt (a BIGINT PRIMARY KEY, g BIGINT, v DECIMAL(8,2))",
        "INSERT INTO tt VALUES " + ", ".join(f"({i}, {i % 3}, {i}.25)" for i in range(1, 41)),
    ]
    query = "SELECT g, COUNT(*), SUM(v) FROM tt GROUP BY g ORDER BY g"
    try:
        sql_proc, sql_ports = _boot(
            tmp_path, ["--store", "remote", "--path", f"127.0.0.1:{store_ports['port']}", "--port", "0", "--no-status"]
        )
        c = Client("127.0.0.1", sql_ports["port"])
        for st in stmts:
            c.query(st)
        got = c.query(query)
        assert c.query("SELECT SUM(v) FROM tt") == [("830.00",)]
        c.close()
    finally:
        if sql_proc is not None:
            _stop(sql_proc)
        _stop(store_proc)
    db = tidb_tpu_torch.open(device="cpu")
    for st in stmts:
        db.execute(st)
    want = [tuple(None if v is None else str(v) for v in row) for row in db.query(query)]
    db.stop_background()
    assert got == want
    assert [(int(g), int(n)) for g, n, _v in got] == [(0, 13), (1, 14), (2, 13)]


@pytest.mark.parametrize("role", ["sql", "store"])
def test_device_flag_reaches_open(monkeypatch, role):
    """``--device`` is parsed before the config (which never sees it) and
    handed to ``open()`` in both roles; it defaults to cuda."""
    import tidb_tpu_torch
    from tidb_tpu_torch import __main__ as boot

    seen = []

    def fake_open(**kw):
        seen.append(kw["device"])
        raise SystemExit(0)

    monkeypatch.setattr(tidb_tpu_torch, "open", fake_open)
    args = ["--port", "0", "--no-status"] + (["--store-server"] if role == "store" else [])
    for extra in (["--device", "cpu"], ["--device", "cuda:1"], []):
        with pytest.raises(SystemExit):
            boot.main(extra + args)
    assert seen == ["cpu", "cuda:1", "cuda"]
