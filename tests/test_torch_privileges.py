"""The port's privileges (``privilege/``) held against the reference's:
``tests/test_privileges.py``'s grant enforcement, SHOW GRANTS / DROP USER
and wire authentication cases, each run on both packages with the same
statements, and the outcomes of the two compared step by step."""

import pytest
import torch

import tidb_tpu
import tidb_tpu.privilege.privileges as ref_priv
import tidb_tpu.server as ref_server
import tidb_tpu.server.client as ref_client
import tidb_tpu_torch
import tidb_tpu_torch.privilege.privileges as port_priv
import tidb_tpu_torch.server as port_server
import tidb_tpu_torch.server.client as port_client

PKGS = {
    "ref": (tidb_tpu.open, ref_priv.PrivilegeError, ref_server, ref_client.MySQLError),
    "port": (lambda: tidb_tpu_torch.open(device="cpu"), port_priv.PrivilegeError, port_server, port_client.MySQLError),
}


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _db(pkg):
    d = PKGS[pkg][0]()
    d.execute("CREATE TABLE t (id BIGINT PRIMARY KEY, v BIGINT)")
    d.execute("INSERT INTO t VALUES (1, 10), (2, 20)")
    return d


def _outcome(fn, *errors):
    """What ``fn()`` gave: its value, or the name of the error it raised."""
    try:
        return ("ok", fn())
    except errors as e:
        return ("raised", type(e).__name__)


def _grant_enforcement(pkg):
    db = _db(pkg)
    perr = PKGS[pkg][1]
    db.execute("CREATE USER 'alice'@'%' IDENTIFIED BY 'pw1'")
    s = db.session()
    s.user, s.host = "alice", "127.0.0.1"
    steps = [
        _outcome(lambda: s.query("SELECT * FROM t"), perr),
        _outcome(lambda: s.execute("INSERT INTO t VALUES (3, 30)").affected, perr),
        _outcome(lambda: s.execute("CREATE TABLE t2 (a BIGINT)").affected, perr),
    ]
    db.execute("GRANT SELECT ON test.t TO 'alice'@'%'")
    steps += [
        _outcome(lambda: s.query("SELECT v FROM t WHERE id = 1"), perr),
        _outcome(lambda: s.execute("INSERT INTO t VALUES (3, 30)").affected, perr),
    ]
    db.execute("GRANT INSERT, UPDATE ON test.* TO 'alice'@'%'")
    steps += [
        _outcome(lambda: s.execute("INSERT INTO t VALUES (3, 30)").affected, perr),
        _outcome(lambda: s.execute("UPDATE t SET v = 31 WHERE id = 3").affected, perr),
        _outcome(lambda: s.execute("DELETE FROM t WHERE id = 3").affected, perr),
    ]
    db.execute("REVOKE INSERT ON test.* FROM 'alice'@'%'")
    steps.append(_outcome(lambda: s.execute("INSERT INTO t VALUES (4, 40)").affected, perr))
    db.execute("GRANT ALL ON *.* TO 'alice'@'%'")
    steps += [
        _outcome(lambda: s.execute("DELETE FROM t WHERE id = 3").affected, perr),
        _outcome(lambda: s.execute("CREATE TABLE t2 (a BIGINT)").affected, perr),
        _outcome(lambda: db.query("SELECT id, v FROM t ORDER BY id"), perr),
    ]
    db.stop_background()
    return steps


def test_create_user_grant_enforcement():
    steps = _grant_enforcement("port")
    assert steps == _grant_enforcement("ref")
    kinds = [k for k, _v in steps]
    assert kinds == ["raised"] * 3 + ["ok", "raised", "ok", "ok", "raised", "raised", "ok", "ok", "ok"]
    assert steps[3][1] == [(10,)] and steps[-1][1] == [(1, 10), (2, 20)]


def _grants_and_drop(pkg):
    db = _db(pkg)
    db.execute("CREATE USER 'bob'@'%'")
    db.execute("GRANT SELECT ON test.* TO 'bob'@'%'")
    out = [sorted(r[0] for r in db.query("SHOW GRANTS FOR 'bob'@'%'"))]
    db.execute("DROP USER 'bob'@'%'")
    out.append(db.query("SELECT 1 FROM mysql.user WHERE User = 'bob'"))
    out.append(_outcome(lambda: db.execute("DROP USER 'bob'@'%'").affected, Exception)[0])
    out.append(_outcome(lambda: db.execute("DROP USER IF EXISTS 'bob'@'%'").affected, Exception)[0])
    db.stop_background()
    return out


def test_show_grants_and_drop_user():
    out = _grants_and_drop("port")
    assert out == _grants_and_drop("ref")
    text = "\n".join(out[0])
    assert "GRANT USAGE ON *.*" in text and "GRANT SELECT ON test.*" in text
    assert out[1:] == [[], "raised", "ok"]


def _wire_auth(pkg):
    db = _db(pkg)
    _open, _perr, server_mod, mysql_error = PKGS[pkg]
    db.execute("CREATE USER 'dave'@'%' IDENTIFIED BY 'secret'")
    db.execute("GRANT SELECT ON test.* TO 'dave'@'%'")
    server = server_mod.Server(db)
    port = server.start()
    Client = server_mod.Client

    def code(fn):
        try:
            fn()
        except mysql_error as e:
            return e.code
        return None

    try:
        c = Client(port=port, user="dave", password="secret")
        out = [c.query("SELECT v FROM t WHERE id = 2"), code(lambda: c.query("INSERT INTO t VALUES (9, 90)"))]
        c.close()
        out.append(code(lambda: Client(port=port, user="dave", password="wrong")))
        out.append(code(lambda: Client(port=port, user="nobody", password="")))
        c = Client(port=port)
        out.append(c.query("SELECT COUNT(*) FROM t"))
        c.close()
    finally:
        server.close()
        db.stop_background()
    return out


def test_wire_auth():
    out = _wire_auth("port")
    assert out == _wire_auth("ref")
    assert out[0] == [("20",)] and out[1] is not None and out[2] == 1045 and out[3] is not None
    assert out[4] == [("2",)]
