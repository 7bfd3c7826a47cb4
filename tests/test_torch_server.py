"""The port's MySQL wire server, its client and its HTTP status server held
against the reference's (``tests/test_server.py``, ``tests/test_status_server.py``).

Each case runs the same statements against the reference's ``Server``
over ``tidb_tpu.open()`` and the port's over ``tidb_tpu_torch.open(device=
"cpu")``, each through its own package's ``Client``, and the transcripts
must be equal statement for statement, besides the reference test's own
expectations. One case crosses the packages: the reference's ``Client``
against the port's ``Server`` (the same protocol on the wire).
"""

import datetime
import json
import os
import re
import shutil
import sys
import threading
import urllib.error
import urllib.request

import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import tidb_tpu  # noqa: E402
import tidb_tpu.server as ref_server  # noqa: E402
import tidb_tpu.server.client as ref_client  # noqa: E402
import tidb_tpu.server.status as ref_status  # noqa: E402
import tidb_tpu_torch  # noqa: E402
import tidb_tpu_torch.server as port_server  # noqa: E402
import tidb_tpu_torch.server.client as port_client  # noqa: E402
import tidb_tpu_torch.server.status as port_status  # noqa: E402
from tidb_tpu.utils import metrics as ref_metrics  # noqa: E402
from tidb_tpu_torch.utils import metrics as port_metrics  # noqa: E402

# (name, open, Server, Client, MySQLError, StatusServer, metrics)
PKGS = {
    "ref": (tidb_tpu.open, ref_server.Server, ref_server.Client, ref_client.MySQLError, ref_status.StatusServer, ref_metrics),
    "port": (lambda: tidb_tpu_torch.open(device="cpu"), port_server.Server, port_server.Client,
             port_client.MySQLError, port_status.StatusServer, port_metrics),
}


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


class _Side:
    def __init__(self, name):
        self.open, self.Server, self.Client, self.MySQLError, self.StatusServer, self.metrics = PKGS[name]
        self.db = self.open()
        self.db.execute("CREATE TABLE t (id BIGINT PRIMARY KEY, s VARCHAR(20), f DOUBLE, d DATE)")
        self.db.execute("INSERT INTO t VALUES (1, 'hello', 1.5, '2024-03-04'), (2, NULL, NULL, NULL)")
        self.server = self.Server(self.db)
        self.port = self.server.start()

    def client(self, **kw):
        return self.Client(port=self.port, **kw)

    def close(self):
        self.server.close()
        self.db.stop_background()


@pytest.fixture()
def sides():
    pair = {name: _Side(name) for name in PKGS}
    yield pair
    for side in pair.values():
        side.close()


def _transcripts(sides, scenario):
    """``scenario(side)`` on both packages → the port's transcript, after
    checking it equals the reference's."""
    ref, port = scenario(sides["ref"]), scenario(sides["port"])
    assert port == ref
    return port


def _raises(side, fn, match=None, err=None):
    """The MySQL error class and code ``fn`` raises (None if it does not);
    ``err`` is the client's error class (default: the side's package's)."""
    try:
        fn()
    except err or side.MySQLError as e:
        assert match is None or re.search(match, str(e)), str(e)
        return ("MySQLError", e.code)
    except Exception as e:  # noqa: BLE001  (the reference test accepts any)
        assert match is None or re.search(match, str(e)), str(e)
        return (type(e).__name__, None)
    return None


def test_query_roundtrip(sides):
    def run(side):
        c = side.client()
        out = [c.ping(), c.query("SELECT id, s, f, d FROM t ORDER BY id"), list(c.columns)]
        out.append(c.query("INSERT INTO t VALUES (3, 'x', 0.25, '2020-01-01')"))
        out.append(c.query("SELECT COUNT(*) FROM t"))
        c.close()
        return out

    out = _transcripts(sides, run)
    assert out == [True, [("1", "hello", "1.5", "2024-03-04"), ("2", None, None, None)], ["id", "s", "f", "d"], 1, [("3",)]]


def test_error_and_use(sides):
    def run(side):
        c = side.client()
        out = [_raises(side, lambda: c.query("SELECT * FROM nonexistent")), _raises(side, lambda: c.use("nodb"))]
        c.query("CREATE DATABASE other")
        c.use("other")
        c.query("CREATE TABLE o (a BIGINT)")
        c.query("INSERT INTO o VALUES (7)")
        out.append(c.query("SELECT a FROM o"))
        c.close()
        return out

    out = _transcripts(sides, run)
    assert out[0][0] == out[1][0] == "MySQLError" and out[2] == [("7",)]


def test_connect_with_db(sides):
    def run(side):
        c = side.client(db="test")
        rows = c.query("SELECT id FROM t WHERE id = 1")
        c.close()
        return rows

    assert _transcripts(sides, run) == [("1",)]


def test_concurrent_connections_and_txn_isolation(sides):
    def run(side):
        c1, c2 = side.client(), side.client()
        c1.query("BEGIN")
        c1.query("INSERT INTO t VALUES (10, 'staged', 0.0, NULL)")
        out = [c1.query("SELECT COUNT(*) FROM t"), c2.query("SELECT COUNT(*) FROM t")]
        c1.query("COMMIT")
        out.append(c2.query("SELECT COUNT(*) FROM t"))
        c1.close()
        c2.close()
        return out

    assert _transcripts(sides, run) == [[("3",)], [("2",)], [("3",)]]


def test_processlist_and_kill(sides):
    def run(side):
        c1, c2 = side.client(), side.client()
        rows = c1.query("SHOW PROCESSLIST")
        my_id = next(r[0] for r in rows if "PROCESSLIST" in (r[4] or ""))
        other = next(r[0] for r in rows if r[0] != my_id)
        out = [len(rows) >= 2, c1.query(f"KILL QUERY {other}")]
        out.append(_raises(side, lambda: c2.query("SELECT COUNT(*) FROM t")))
        out.append(c2.query("SELECT COUNT(*) FROM t"))
        c1.close()
        c2.close()
        return out

    out = _transcripts(sides, run)
    assert out[:2] == [True, 0] and out[2][0] == "MySQLError" and out[3] == [("2",)]


def test_many_threads(sides):
    # the reference bootstraps its grant tables lazily and unlocked, so a
    # concurrent first login may find mysql.user without its root row and
    # be denied; its side logs in once first (the port's runs cold:
    # test_concurrent_first_logins_see_the_root_user)
    sides["ref"].db.ensure_priv_bootstrap()

    def run(side):
        errs, counts = [], []

        def worker():
            try:
                c = side.client()
                for _ in range(5):
                    counts.append(c.query("SELECT COUNT(*) FROM t"))
                c.close()
            except Exception as e:  # noqa: BLE001
                errs.append(e)

        threads = [threading.Thread(target=worker) for _ in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=30)
        return errs, counts

    errs, counts = _transcripts(sides, run)
    assert errs == [] and counts == [[("2",)]] * 40


def test_concurrent_first_logins_see_the_root_user(monkeypatch):
    """Eight first logins at once on a fresh port server, the grant tables'
    bootstrap held open between creating mysql.user and inserting root:
    every login sees root (the bootstrap runs under one lock)."""
    import time

    from tidb_tpu_torch.session.session import Session

    real = Session.execute

    def slow(self, sql):
        if sql.startswith("INSERT INTO mysql.user"):
            time.sleep(0.3)
        return real(self, sql)

    monkeypatch.setattr(Session, "execute", slow)
    side = _Side("port")
    errs = []

    def login():
        try:
            side.client().close()
        except Exception as e:  # noqa: BLE001
            errs.append(e)

    try:
        threads = [threading.Thread(target=login) for _ in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=30)
    finally:
        side.close()
    assert errs == []


def test_binary_prepared_protocol(sides):
    def run(side):
        c = side.client()
        c.query("CREATE TABLE bp (id BIGINT PRIMARY KEY, v DECIMAL(8,2), s VARCHAR(16), d DATE, t DATETIME, du TIME)")
        sid, nparams = c.prepare("INSERT INTO bp VALUES (?, ?, ?, ?, ?, ?)")
        out = [nparams, c.last_prepare_cols]
        out.append(c.execute(sid, [1, "12.50", "hello", "2024-03-05", "2024-03-05 10:00:01", "08:30:00"]))
        out.append(c.execute(sid, [2, None, None, None, None, None]))
        c.stmt_close(sid)
        sid2, np2 = c.prepare("SELECT id, v, s, d, t, du FROM bp WHERE id >= ? ORDER BY id")
        out += [np2, c.last_prepare_cols, c.execute(sid2, [1]), c.execute(sid2, [2])]
        c.stmt_close(sid2)
        out.append(_raises(side, lambda: c.execute(sid2, [1])))
        c.close()
        return out

    out = _transcripts(sides, run)
    assert out[:6] == [6, 0, 1, 1, 1, 6]
    assert out[6] == [
        (1, "12.50", "hello", datetime.date(2024, 3, 5),
         datetime.datetime(2024, 3, 5, 10, 0, 1), datetime.timedelta(hours=8, minutes=30)),
        (2, None, None, None, None, None),
    ]
    assert out[7] == [(2, None, None, None, None, None)] and out[8][0] == "MySQLError"


def test_binary_protocol_param_types(sides):
    def run(side):
        c = side.client()
        c.query("CREATE TABLE bt (a BIGINT, b DOUBLE)")
        sid, _ = c.prepare("INSERT INTO bt VALUES (?, ?)")
        c.execute(sid, [-5, 2.25])
        sid2, _ = c.prepare("SELECT a, b FROM bt WHERE a = ? AND b < ?")
        rows = c.execute(sid2, [-5, 3.0])
        c.close()
        return rows

    assert _transcripts(sides, run) == [(-5, 2.25)]


def test_caching_sha2_password_auth(sides):
    def run(side):
        root = side.client()
        root.query("CREATE USER 'sha2u'@'%' IDENTIFIED WITH 'caching_sha2_password' BY 'secret2'")
        root.query("GRANT SELECT ON *.* TO 'sha2u'@'%'")
        c = side.client(user="sha2u", password="secret2", auth_plugin="caching_sha2_password")
        c2 = side.client(user="sha2u", password="secret2")  # the auth-switch leg
        out = [c.query("SELECT 1 + 1"), c2.query("SELECT 2 + 2")]
        out.append(_raises(side, lambda: side.client(user="sha2u", password="wrong", auth_plugin="caching_sha2_password"),
                           match="Access denied"))
        return out

    out = _transcripts(sides, run)
    assert out[:2] == [[("2",)], [("4",)]] and out[2] is not None


@pytest.mark.skipif(shutil.which("openssl") is None, reason="the TLS server makes its certificate with openssl")
@pytest.mark.parametrize("pkg", list(PKGS))
def test_tls_roundtrip(pkg):
    """Encrypted wire on each package: SSLRequest upgrade, auth and
    queries, caching_sha2 over TLS, plaintext clients, and a clear error
    for TLS against a plaintext server."""
    open_db, Server, Client, MySQLError, _st, _m = PKGS[pkg]
    db = open_db()
    db.execute("CREATE TABLE tlst (id BIGINT PRIMARY KEY, v VARCHAR(8))")
    db.execute("INSERT INTO tlst VALUES (1, 'enc')")
    server = Server(db, tls=True)
    port = server.start()
    try:
        c = Client(port=port, tls=True)
        assert c.tls
        assert c.query("SELECT v FROM tlst WHERE id = 1") == [("enc",)]
        c.query("CREATE USER 'tu'@'%' IDENTIFIED WITH 'caching_sha2_password' BY 'pw9'")
        c.query("GRANT SELECT ON *.* TO 'tu'@'%'")
        c2 = Client(port=port, user="tu", password="pw9", tls=True, auth_plugin="caching_sha2_password")
        assert c2.query("SELECT COUNT(*) FROM tlst") == [("1",)]
        assert Client(port=port).query("SELECT 5") == [("5",)]
        plain = Server(open_db())
        pport = plain.start()
        try:
            with pytest.raises(MySQLError, match="TLS"):
                Client(port=pport, tls=True)
        finally:
            plain.close()
    finally:
        server.close()


def test_warning_count_on_the_wire(sides):
    def run(side):
        c = side.client()
        out = [c.query("SELECT 1/0"), c.warning_count]
        c.query("CREATE TABLE ww (x DECIMAL(6,2), i BIGINT)")
        c.query("INSERT INTO ww VALUES (1.005, '9zz')")
        out += [c.warning_count, len(c.query("SHOW WARNINGS"))]
        c.query("SELECT 1")
        out.append(c.warning_count)
        c.close()
        return out

    out = _transcripts(sides, run)
    assert out[1:] == [1, 2, 2, 0] and out[0][0][0] is None


def test_reference_client_against_the_port_server(sides):
    """The reference's ``Client`` speaks to the port's ``Server`` and gets
    what it gets from the reference's: text and binary result sets, auth
    and errors are the same bytes on the wire."""

    def run(side):
        c = ref_server.Client(port=side.port)
        out = [c.query("SELECT id, s, f, d FROM t ORDER BY id")]
        sid, n = c.prepare("SELECT id, d FROM t WHERE id = ?")
        out += [n, c.execute(sid, [1])]
        out.append(_raises(side, lambda: c.query("SELECT * FROM nonexistent"), err=ref_client.MySQLError))
        c.query("CREATE USER 'xu'@'%' IDENTIFIED BY 'pw'")
        c.query("GRANT SELECT ON test.* TO 'xu'@'%'")
        c.close()
        c2 = ref_server.Client(port=side.port, user="xu", password="pw")
        out.append(c2.query("SELECT COUNT(*) FROM t"))
        out.append(_raises(side, lambda: c2.query("INSERT INTO t VALUES (9, 'no', 0.0, NULL)"), err=ref_client.MySQLError))
        c2.close()
        return out

    ref, port = run(sides["ref"]), run(sides["port"])
    assert port == ref
    assert port[0] == [("1", "hello", "1.5", "2024-03-04"), ("2", None, None, None)]
    assert port[1] == 1 and port[4] == [("2",)] and port[3] is not None and port[5] is not None


# -- the HTTP status server (tests/test_status_server.py) -----------------------------

_SAMPLE = re.compile(r"^([a-zA-Z_:][a-zA-Z0-9_:]*)(\{.*\})? (\S+)$")


def _assert_exposition(body: str) -> int:
    n = 0
    for line in body.splitlines():
        if not line or line.startswith("#"):
            continue
        m = _SAMPLE.match(line)
        assert m, f"unparseable exposition line: {line!r}"
        float(m.group(3))
        n += 1
    return n


def _get(port, path):
    return urllib.request.urlopen(f"http://127.0.0.1:{port}{path}", timeout=10).read()


@pytest.mark.parametrize("pkg", list(PKGS))
def test_metrics_parseable_under_concurrent_writes(pkg):
    open_db, _S, _C, _E, StatusServer, metrics = PKGS[pkg]
    db = open_db()
    db.execute("CREATE TABLE m (id BIGINT PRIMARY KEY)")
    st = StatusServer(db)
    port = st.start()
    c = metrics.REGISTRY.counter("test_concurrent_writes_total", "scratch", ("k",))
    h = metrics.REGISTRY.histogram("test_concurrent_writes_seconds", "scratch")
    stop = threading.Event()

    def writer():
        i = 0
        while not stop.is_set():
            c.inc(k=f"v{i % 7}")
            h.observe((i % 100) / 1000.0)
            i += 1

    threads = [threading.Thread(target=writer) for _ in range(4)]
    for t in threads:
        t.start()
    try:
        for _ in range(10):
            body = _get(port, "/metrics").decode()
            assert _assert_exposition(body) > 0
            assert "test_concurrent_writes_total" in body
    finally:
        stop.set()
        for t in threads:
            t.join()
        st.close()


def test_label_values_escaped_in_exposition():
    """The same exposition text from both packages' Counter and Gauge for
    label values with quotes, backslashes and newlines."""
    out = {}
    for pkg, (*_rest, metrics) in PKGS.items():
        c = metrics.Counter("esc_total", "scratch", ("reason",))
        c.inc(reason='bad "quote" back\\slash new\nline')
        g = metrics.Gauge("esc_gauge", "scratch", ("k",))
        g.set(1.0, k='x"y\nz')
        out[pkg] = (c.render(), g.render())
    assert out["port"] == out["ref"]
    for body in out["port"]:
        lines = [ln for ln in body.splitlines() if not ln.startswith("#")]
        assert len(lines) == 1 and _SAMPLE.match(lines[0]), lines


@pytest.mark.parametrize("pkg", list(PKGS))
def test_slowlog_and_topsql_return_valid_json(pkg):
    open_db, _S, _C, _E, StatusServer, _m = PKGS[pkg]
    db = open_db()
    db.execute("CREATE TABLE s1 (id BIGINT PRIMARY KEY, v BIGINT)")
    db.execute("INSERT INTO s1 VALUES (1, 2), (2, 4)")
    s = db.session()
    s.execute("SET tidb_slow_log_threshold = 0")
    s.query("SELECT SUM(v) FROM s1")
    s.execute("SET tidb_slow_log_threshold = 300")
    st = StatusServer(db)
    port = st.start()
    try:
        slow = json.loads(_get(port, "/slowlog"))
        assert isinstance(slow, list) and slow
        assert {"query", "query_time", "digest", "plan_digest", "cop_tasks"} <= set(slow[0])
        assert isinstance(json.loads(_get(port, "/topsql")), list)
        assert isinstance(json.loads(_get(port, "/election")), dict)
        assert b"tidb-tpu" in _get(port, "/status")
    finally:
        st.close()


@pytest.mark.parametrize("pkg", list(PKGS))
def test_unknown_path_404(pkg):
    open_db, _S, _C, _E, StatusServer, _m = PKGS[pkg]
    st = StatusServer(open_db())
    port = st.start()
    try:
        with pytest.raises(urllib.error.HTTPError) as ei:
            _get(port, "/definitely-not-a-path")
        assert ei.value.code == 404
    finally:
        st.close()
