"""MySQL-compatible privileges over real mysql.* grant tables.

Reference parity: session bootstrap creates the grant tables
(session/bootstrap.go:795); the privilege checker is a cache rebuilt from
them on every GRANT/REVOKE/CREATE USER (privileges/cache.go:87 — the
reference reloads on a notification channel; here the cache keys on a
version counter bumped by the mutating statements).

Auth implements mysql_native_password: the stored hash is
``*HEX(SHA1(SHA1(password)))`` and the wire token is
``SHA1(password) XOR SHA1(salt + SHA1(SHA1(password)))``.
"""

from __future__ import annotations

import hashlib
from dataclasses import dataclass, field

ALL_PRIVS = ["select", "insert", "update", "delete", "create", "drop", "index", "alter", "super"]
_PRIV_COL = {p: f"{p.capitalize()}_priv" for p in ALL_PRIVS}


class PrivilegeError(Exception):
    pass


def _sha1(b: bytes) -> bytes:
    return hashlib.sha1(b).digest()


def encode_password(pw: str) -> str:
    """→ mysql.user.authentication_string format."""
    if not pw:
        return ""
    return "*" + _sha1(_sha1(pw.encode())).hex().upper()


def _sha256(b: bytes) -> bytes:
    return hashlib.sha256(b).digest()


def encode_password_with(pw: str, plugin: str) -> str:
    """→ mysql.user.authentication_string for the given auth plugin.
    caching_sha2_password stores the fast-auth cache entry
    SHA256(SHA256(password)) hex (a documented divergence from MySQL's
    $A$-crypt storage: this build always fast-auths, never falling back to
    the full RSA/plain exchange)."""
    if plugin == "caching_sha2_password":
        if not pw:
            return ""
        return "$2$" + _sha256(_sha256(pw.encode())).hex().upper()
    return encode_password(pw)


def sha2_auth_token(pw: str, nonce: bytes) -> bytes:
    """Client side of caching_sha2_password fast auth:
    XOR(SHA256(pw), SHA256(SHA256(SHA256(pw)) || nonce))."""
    if not pw:
        return b""
    h1 = _sha256(pw.encode())
    h2 = _sha256(h1)
    mix = _sha256(h2 + nonce)
    return bytes(a ^ b for a, b in zip(h1, mix))


def verify_sha2_password(stored: str, token: bytes, nonce: bytes) -> bool:
    """Server side: token XOR SHA256(cache || nonce) must SHA256 to the
    stored cache entry (ref: caching_sha2 fast-auth verification)."""
    if not stored:
        return not token
    if not token:
        return False
    cache = bytes.fromhex(stored[3:]) if stored.startswith("$2$") else b""
    mix = _sha256(cache + nonce)
    h1 = bytes(a ^ b for a, b in zip(token, mix))
    return _sha256(h1) == cache


def native_auth_token(pw: str, salt: bytes) -> bytes:
    """Client side: the 20-byte token sent in HandshakeResponse."""
    if not pw:
        return b""
    h1 = _sha1(pw.encode())
    h2 = _sha1(h1)
    mix = _sha1(salt + h2)
    return bytes(a ^ b for a, b in zip(h1, mix))


def verify_native_password(stored: str, token: bytes, salt: bytes) -> bool:
    """Server side: token XOR SHA1(salt+stage2) must SHA1 to stage2."""
    if not stored:
        return not token
    if not token:
        return False
    stage2 = bytes.fromhex(stored.lstrip("*"))
    mix = _sha1(salt + stage2)
    h1 = bytes(a ^ b for a, b in zip(token, mix))
    return _sha1(h1) == stage2


def bootstrap_priv_tables(db) -> None:
    """Create the mysql schema + grant tables and the root superuser
    (ref: bootstrap.go doDDLWorks/doDMLWorks)."""
    if "mysql" in db.catalog.databases() and "user" in db.catalog.tables("mysql"):
        return
    s = db.session()
    s.execute("CREATE DATABASE IF NOT EXISTS mysql")
    priv_cols = ", ".join(f"{_PRIV_COL[p]} VARCHAR(1)" for p in ALL_PRIVS)
    s.execute(
        f"CREATE TABLE IF NOT EXISTS mysql.user (Host VARCHAR(255), User VARCHAR(32), "
        f"authentication_string VARCHAR(128), plugin VARCHAR(32), {priv_cols})"
    )
    s.execute(
        f"CREATE TABLE IF NOT EXISTS mysql.db (Host VARCHAR(255), DB VARCHAR(64), "
        f"User VARCHAR(32), {priv_cols})"
    )
    s.execute(
        "CREATE TABLE IF NOT EXISTS mysql.tables_priv (Host VARCHAR(255), DB VARCHAR(64), "
        "User VARCHAR(32), Table_name VARCHAR(64), Table_priv VARCHAR(255))"
    )
    ys = ", ".join(["'Y'"] * len(ALL_PRIVS))
    s.execute(f"INSERT INTO mysql.user VALUES ('%', 'root', '', 'mysql_native_password', {ys})")
    db.priv_version += 1


@dataclass
class _UserRec:
    host: str
    user: str
    auth: str
    privs: set = field(default_factory=set)
    plugin: str = "mysql_native_password"


class PrivChecker:
    """Privilege cache: rebuilt lazily when db.priv_version moves."""

    def __init__(self, db):
        self._db = db
        self._version = -1
        self._users: list[_UserRec] = []
        self._db_privs: list[tuple[str, str, str, set]] = []  # host, db, user, privs
        self._tbl_privs: list[tuple[str, str, str, str, set]] = []

    def _refresh(self) -> None:
        if self._version == self._db.priv_version:
            return
        s = self._db.session()
        s.user, s.host = "root", "%"  # internal reader bypasses checks
        users = []
        for row in s.query("SELECT * FROM mysql.user"):
            host, user, auth = row[0], row[1], row[2] or ""
            plugin = row[3] or "mysql_native_password"
            privs = {p for p, v in zip(ALL_PRIVS, row[4:]) if v == "Y"}
            users.append(_UserRec(host, user, auth, privs, plugin))
        dbp = []
        for row in s.query("SELECT * FROM mysql.db"):
            host, dbn, user = row[0], row[1], row[2]
            privs = {p for p, v in zip(ALL_PRIVS, row[3:]) if v == "Y"}
            dbp.append((host, dbn, user, privs))
        tbp = []
        for row in s.query("SELECT * FROM mysql.tables_priv"):
            host, dbn, user, tbl, ps = row
            privs = {p.strip().lower() for p in (ps or "").split(",") if p.strip()}
            tbp.append((host, dbn, user, tbl, privs))
        self._users, self._db_privs, self._tbl_privs = users, dbp, tbp
        self._version = self._db.priv_version

    @staticmethod
    def _host_match(pattern: str, host: str) -> bool:
        return pattern == "%" or pattern == host

    def find_user(self, user: str, host: str):
        self._refresh()
        for u in self._users:
            if u.user == user and self._host_match(u.host, host):
                return u
        return None

    def auth(self, user: str, host: str, token: bytes, salt: bytes) -> bool:
        u = self.find_user(user, host)
        if u is None:
            return False
        if u.plugin == "caching_sha2_password":
            return verify_sha2_password(u.auth, token, salt)
        return verify_native_password(u.auth, token, salt)

    def check(self, user: str, host: str, db: str, table: str, priv: str) -> bool:
        """RequestVerification analog: user-level → db-level → table-level."""
        self._refresh()
        u = self.find_user(user, host)
        if u is None:
            return False
        if priv in u.privs or "super" in u.privs:
            return True
        db = (db or "").lower()
        for h, d, usr, privs in self._db_privs:
            if usr == user and self._host_match(h, host) and d.lower() == db and priv in privs:
                return True
        table = (table or "").lower()
        for h, d, usr, tbl, privs in self._tbl_privs:
            if (
                usr == user
                and self._host_match(h, host)
                and d.lower() == db
                and tbl.lower() == table
                and priv in privs
            ):
                return True
        return False

    def require(self, user: str, host: str, db: str, table: str, priv: str) -> None:
        if not self.check(user, host, db, table, priv):
            raise PrivilegeError(
                f"{priv.upper()} command denied to user '{user}'@'{host}' for table '{db}.{table}'"
            )

    def grants_for(self, user: str, host: str) -> list[str]:
        """SHOW GRANTS rows."""
        self._refresh()
        out = []
        u = self.find_user(user, host)
        if u is None:
            return out
        if u.privs:
            names = "ALL PRIVILEGES" if set(ALL_PRIVS) <= u.privs else ", ".join(sorted(p.upper() for p in u.privs))
            out.append(f"GRANT {names} ON *.* TO '{user}'@'{host}'")
        else:
            out.append(f"GRANT USAGE ON *.* TO '{user}'@'{host}'")
        for h, d, usr, privs in self._db_privs:
            if usr == user and self._host_match(h, host) and privs:
                out.append(f"GRANT {', '.join(sorted(p.upper() for p in privs))} ON {d}.* TO '{user}'@'{host}'")
        for h, d, usr, tbl, privs in self._tbl_privs:
            if usr == user and self._host_match(h, host) and privs:
                out.append(f"GRANT {', '.join(sorted(p.upper() for p in privs))} ON {d}.{tbl} TO '{user}'@'{host}'")
        return out
