"""The TCP server (ref: pkg/server/server.go accept loop + conn.go:1045
clientConn.Run): one thread per connection, each owning a Session; a
connection registry backs SHOW PROCESSLIST and cross-connection KILL
(ref: util/globalconn + server.Kill)."""

from __future__ import annotations

import socket
import struct
import threading
import time
from typing import Optional

from tidb_tpu_torch.server import protocol as p


def _nonce() -> bytes:
    """20-byte NUL-free auth nonce (clients parse the greeting's salt halves
    positionally, but NULs would break drivers that scan for terminators)."""
    import os as _os

    return bytes((b % 255) + 1 for b in _os.urandom(20))


class ClientConn:
    def __init__(self, server: "Server", sock, conn_id: int):
        self.server = server
        self.sock = sock
        self.conn_id = conn_id
        # open read-only cursors: stmt id → (remaining rows iterively
        # drained by COM_STMT_FETCH, ftypes) (ref: conn_stmt.go cursor mode)
        self.cursors: dict[int, list] = {}
        self.session = server.db.session()
        self.session.conn_id = conn_id
        self.user = ""
        self.current_sql: Optional[str] = None
        self.connected_at = time.time()
        self.authed = False  # set after a successful handshake
        self.tls = False  # flipped by the SSLRequest upgrade
        # binary-protocol prepared statements: stmt_id → (name, n_params,
        # param types from the last execute) (ref: conn.go stmts map)
        self.stmts: dict[int, list] = {}
        self._next_stmt_id = 1

    # -- handshake (protocol v10) ------------------------------------------
    def handshake(self, io: p.PacketIO) -> bool:
        salt = _nonce()
        caps_adv = p.SERVER_CAPS | (p.CLIENT_SSL if self.server.tls_ctx else 0)
        pkt = (
            bytes([10])
            + b"8.0.11-tidb-tpu\x00"
            + struct.pack("<I", self.conn_id)
            + salt[:8]
            + b"\x00"
            + struct.pack("<H", caps_adv & 0xFFFF)
            + bytes([33])  # utf8_general_ci
            + struct.pack("<H", 2)  # status: autocommit
            + struct.pack("<H", (caps_adv >> 16) & 0xFFFF)
            + bytes([21])
            + b"\x00" * 10
            + salt[8:] + b"\x00"
            + b"mysql_native_password\x00"
        )
        io.write(pkt)
        resp = io.read()
        caps = struct.unpack_from("<I", resp, 0)[0]
        if caps & p.CLIENT_SSL and len(resp) <= 32:
            # SSLRequest: upgrade the raw socket to TLS, then redo the
            # response read over the encrypted channel (ref: conn.go TLS
            # upgrade on the same sequence numbering)
            if self.server.tls_ctx is None:
                io.write(p.err_packet(1045, "TLS not enabled on this server", "28000"))
                return False
            self.sock = self.server.tls_ctx.wrap_socket(self.sock, server_side=True)
            io.sock = self.sock
            resp = io.read()
            caps = struct.unpack_from("<I", resp, 0)[0]
            self.tls = True
        off = 4 + 4 + 1 + 23
        end = resp.index(b"\x00", off)
        self.user = resp[off:end].decode()
        off = end + 1
        if caps & p.CLIENT_SECURE_CONNECTION:
            alen = resp[off]
            token = resp[off + 1 : off + 1 + alen]
            off += 1 + alen
        else:
            end = resp.index(b"\x00", off)
            token = resp[off:end]
            off = end + 1
        db_off = off
        client_plugin = "mysql_native_password"
        if caps & p.CLIENT_CONNECT_WITH_DB and off < len(resp):
            end = resp.index(b"\x00", off)
            db_off, off = off, end + 1  # remembered for the db-select below
        if caps & p.CLIENT_PLUGIN_AUTH and off < len(resp) and b"\x00" in resp[off:]:
            end = resp.index(b"\x00", off)
            client_plugin = resp[off:end].decode() or client_plugin
        # per-user plugin dispatch with AuthSwitch when the client guessed
        # wrong (ref: conn.go auth-switch handling)
        checker = self.server.db.priv_checker
        u = checker.find_user(self.user, "127.0.0.1")
        want = u.plugin if u is not None else "mysql_native_password"
        if u is not None and client_plugin != want:
            salt = _nonce()
            io.write(bytes([0xFE]) + want.encode() + b"\x00" + salt + b"\x00")
            token = io.read()
        if not checker.auth(self.user, "127.0.0.1", token, salt):
            io.write(
                p.err_packet(1045, f"Access denied for user '{self.user}'@'127.0.0.1'", "28000")
            )
            self.server._conn_event("rejected", self)
            return False
        if want == "caching_sha2_password":
            io.write(b"\x01\x03")  # AuthMoreData: fast-auth success
        self.session.user = self.user
        self.session.host = "127.0.0.1"
        self.authed = True
        self.server._conn_event("connected", self)
        if caps & p.CLIENT_CONNECT_WITH_DB and db_off < len(resp):
            end = resp.index(b"\x00", db_off)
            dbname = resp[db_off:end].decode()
            if dbname:
                try:
                    self.session.catalog.db(dbname)
                    self.session.current_db = dbname.lower()
                except Exception:
                    io.write(p.err_packet(1049, f"Unknown database '{dbname}'", "42000"))
                    return False
        io.write(p.ok_packet())
        return True

    # -- command loop -------------------------------------------------------
    def run(self) -> None:
        io = p.PacketIO(self.sock)
        try:
            try:
                if not self.handshake(io):
                    return
            except Exception:
                return  # port-scan: dropped client or garbage handshake bytes
            while True:
                io.reset_seq()
                try:
                    pkt = io.read()
                except (ConnectionError, OSError):
                    return
                if not pkt:
                    continue
                cmd, data = pkt[0], pkt[1:]
                if cmd == p.COM_QUIT:
                    return
                if cmd == p.COM_PING:
                    io.write(p.ok_packet())
                elif cmd == p.COM_INIT_DB:
                    self._run_sql(io, f"USE `{data.decode()}`")
                elif cmd == p.COM_QUERY:
                    self._run_sql(io, data.decode("utf-8"))
                elif cmd == p.COM_STMT_PREPARE:
                    self._stmt_prepare(io, data.decode("utf-8"))
                elif cmd == p.COM_STMT_EXECUTE:
                    self._stmt_execute(io, data)
                elif cmd == p.COM_STMT_CLOSE:
                    sid = struct.unpack_from("<I", data, 0)[0]
                    self.cursors.pop(sid, None)
                    st = self.stmts.pop(sid, None)
                    if st is not None:
                        self.session.prepared.pop(st[0], None)
                    # COM_STMT_CLOSE sends no response (protocol)
                elif cmd == p.COM_STMT_SEND_LONG_DATA:
                    pass  # protocol: no response; long data unsupported → the
                    # execute fails cleanly on the missing parameter
                elif cmd == p.COM_STMT_FETCH:
                    self._stmt_fetch(io, data)
                elif cmd == p.COM_STMT_RESET:
                    self.cursors.pop(struct.unpack_from("<I", data, 0)[0], None)
                    io.write(p.ok_packet())
                else:
                    io.write(p.err_packet(1047, f"Unknown command {cmd}", "08S01"))
        finally:
            if self.authed:  # rejected/aborted handshakes never "connected"
                self.server._conn_event("disconnected", self)
            self.server._deregister(self.conn_id)
            try:
                self.sock.close()
            except OSError:
                pass

    # -- binary prepared protocol (ref: conn.go:1281-1428 COM_STMT_*) --------
    def _stmt_prepare(self, io: p.PacketIO, sql: str) -> None:
        try:
            name = f"__bin_{self._next_stmt_id}"
            self.session.prepare(sql, name)
            ps = self.session.prepared[name]
        except Exception as e:
            io.write(p.err_packet(1105, str(e)))
            return
        sid = self._next_stmt_id
        self._next_stmt_id += 1
        self.stmts[sid] = [name, ps.n_params, None]
        # real prepare-time column definitions when the schema is derivable
        # (drivers like libmysqlclient read result metadata here); falls back
        # to 0 columns for DML / parameter-dependent schemas
        meta = self.session.prepared_result_schema(name)
        ncols = len(meta[0]) if meta else 0
        io.write(p.stmt_prepare_ok(sid, ncols, ps.n_params))
        if ps.n_params:
            for i in range(ps.n_params):
                io.write(p.column_def(f"?{i}", p.T_VAR_STRING))
            io.write(p.eof_packet())
        if ncols:
            for cname, ft in zip(meta[0], meta[1]):
                if ft is not None:
                    tc, ln, dec = p.type_for(ft)
                else:
                    tc, ln, dec = p.T_VAR_STRING, 255, 0
                io.write(p.column_def(str(cname), tc, ln, dec))
            io.write(p.eof_packet())

    def _stmt_execute(self, io: p.PacketIO, data: bytes) -> None:
        sid = struct.unpack_from("<I", data, 0)[0]
        st = self.stmts.get(sid)
        if st is None:
            io.write(p.err_packet(1243, f"Unknown prepared statement handler ({sid})", "HY000"))
            return
        name, n_params, prev_types = st
        cursor_flags = data[4] if len(data) > 4 else 0
        # MySQL closes any open cursor on re-execute: a stale one would feed
        # COM_STMT_FETCH rows from the PREVIOUS execution
        self.cursors.pop(sid, None)
        try:
            vals, types = p.decode_binary_params(data, 9, n_params, prev_types)
            st[2] = types
            self.current_sql = f"EXECUTE {name}"
            res = self.session.execute_prepared(name, vals)
        except Exception as e:
            io.write(p.err_packet(1105, str(e)))
            return
        finally:
            self.current_sql = None
        wc = min(len(self.session.warnings), 0xFFFF)
        if not res.columns:
            io.write(p.ok_packet(affected=res.affected, last_insert_id=res.last_insert_id, warnings=wc))
            return
        ftypes = getattr(res, "ftypes", None)
        io.write(p.lenc_int(len(res.columns)))
        for i, cname in enumerate(res.columns):
            if ftypes is not None and i < len(ftypes) and ftypes[i] is not None:
                tc, ln, dec = p.type_for(ftypes[i])
            else:
                tc, ln, dec = p.T_VAR_STRING, 255, 0
            io.write(p.column_def(str(cname), tc, ln, dec))
        if cursor_flags & p.CURSOR_TYPE_READ_ONLY:
            # cursor mode (ref: conn_stmt.go): park the result server-side;
            # the client drains it in COM_STMT_FETCH batches
            self.cursors[sid] = [list(res.rows), ftypes]
            io.write(p.eof_packet(status=2 | p.SERVER_STATUS_CURSOR_EXISTS, warnings=wc))
            return
        io.write(p.eof_packet())
        for row in res.rows:
            io.write(p.binary_row(row, ftypes))
        io.write(p.eof_packet(warnings=wc))

    def _stmt_fetch(self, io: p.PacketIO, data: bytes) -> None:
        """COM_STMT_FETCH: stream the next n rows of an open cursor (ref:
        conn_stmt.go handleStmtFetch; EOF carries LAST_ROW_SENT once
        drained)."""
        sid, nrows = struct.unpack_from("<II", data, 0)
        cur = self.cursors.get(sid)
        if cur is None:
            io.write(p.err_packet(1243, f"Unknown cursor for statement ({sid})", "HY000"))
            return
        rows, ftypes = cur
        batch, cur[0] = rows[:nrows], rows[nrows:]
        for row in batch:
            io.write(p.binary_row(row, ftypes))
        if cur[0]:
            io.write(p.eof_packet(status=2 | p.SERVER_STATUS_CURSOR_EXISTS))
        else:
            self.cursors.pop(sid, None)
            io.write(p.eof_packet(status=2 | p.SERVER_STATUS_LAST_ROW_SENT))

    def _run_sql(self, io: p.PacketIO, sql: str) -> None:
        self.current_sql = sql
        try:
            res = self.session.execute(sql)
        except Exception as e:
            io.write(p.err_packet(1105, str(e)))
            return
        finally:
            self.current_sql = None
        wc = min(len(self.session.warnings), 0xFFFF)
        if not res.columns:
            io.write(p.ok_packet(affected=res.affected, last_insert_id=res.last_insert_id, warnings=wc))
            return
        out = [p.lenc_int(len(res.columns))]
        ftypes = getattr(res, "ftypes", None)
        for i, name in enumerate(res.columns):
            if ftypes is not None and i < len(ftypes) and ftypes[i] is not None:
                tc, ln, dec = p.type_for(ftypes[i])
            else:
                tc, ln, dec = p.T_VAR_STRING, 255, 0
            out.append(p.column_def(str(name), tc, ln, dec))
        out.append(p.eof_packet())
        for row in res.rows:
            rb = bytearray()
            for v in row:
                tv = p.text_value(v)
                rb += b"\xfb" if tv is None else p.lenc_str(tv)
            out.append(bytes(rb))
        out.append(p.eof_packet(warnings=wc))
        for pkt in out:
            io.write(pkt)


class Server:
    """server.NewServer + Run analog. ``Server(db).start()`` returns the
    bound port; connections are thread-per-conn like the reference's
    goroutine-per-conn."""

    def __init__(self, db, host: str = "127.0.0.1", port: int = 0, tls: bool = False):
        self.db = db
        self.host = host
        self.port = port
        self._lsock: Optional[socket.socket] = None
        self._conns: dict[int, ClientConn] = {}
        self._next_id = 1
        self._mu = threading.Lock()
        self._accept_thread: Optional[threading.Thread] = None
        self._stopping = False
        # TLS: a per-server self-signed certificate (openssl) — clients
        # upgrade via the SSLRequest leg of the handshake (ref: conn.go TLS)
        self.tls_ctx = self._make_tls_ctx() if tls else None
        db.server = self  # processlist/kill hook for sessions

    @staticmethod
    def _make_tls_ctx():
        import ssl
        import subprocess
        import tempfile

        import shutil

        d = tempfile.mkdtemp(prefix="tidb_tpu_tls_")
        try:
            cert, key = f"{d}/server.crt", f"{d}/server.key"
            subprocess.run(
                [
                    "openssl", "req", "-x509", "-newkey", "rsa:2048", "-nodes",
                    "-keyout", key, "-out", cert, "-days", "30",
                    "-subj", "/CN=tidb-tpu-test",
                ],
                check=True,
                capture_output=True,
            )
            ctx = ssl.SSLContext(ssl.PROTOCOL_TLS_SERVER)
            ctx.load_cert_chain(cert, key)
            return ctx
        finally:
            # the context holds the loaded key; the PRIVATE KEY must not
            # linger on disk
            shutil.rmtree(d, ignore_errors=True)

    # global connection ids: (server_id << _GCONN_SHIFT) | local id — every
    # SQL node's ids are cluster-unique, so KILL routes across nodes (ref:
    # pkg/util/globalconn/globalconn.go)
    _GCONN_SHIFT = 24
    _GSRV_NEXT = b"gsrv:next"
    _GSRV_REG = b"gsrv:reg:"
    _GKILL = b"gkill:"

    # MySQL's handshake carries a 4-byte thread id, so server ids must stay
    # under 2^(32 - _GCONN_SHIFT) — dead registrations are REUSED first
    _GSRV_MAX = (1 << (32 - 24)) - 1  # 255

    def _alloc_server_id(self) -> int:
        """Cluster-unique server id from the store (the PD allocation role);
        an embedded bench store without raw_cas just gets id 1. Ids of
        closed servers (blank registration) are reclaimed so a long-lived
        store never exhausts the 8-bit id space."""
        store = self.db.store
        if not hasattr(store, "raw_cas"):
            return 1
        from tidb_tpu_torch.kv.kv import KeyRange

        # reclaim a dead slot: registration blanked by close_registration
        for k, v in store.raw_scan(KeyRange(self._GSRV_REG, self._GSRV_REG + b"\xff")):
            if v == b"":
                sid = int(k[len(self._GSRV_REG):])
                if store.raw_cas(k, b"", b"alive"):
                    return sid
        while True:
            raw = store.raw_get(self._GSRV_NEXT)
            nxt = int(raw) if raw else 1
            if nxt > self._GSRV_MAX:
                raise RuntimeError(
                    f"server id space exhausted ({self._GSRV_MAX} live SQL nodes)"
                )
            if store.raw_cas(self._GSRV_NEXT, raw, str(nxt + 1).encode()):
                store.raw_put(self._GSRV_REG + str(nxt).encode(), b"alive")
                return nxt

    def start(self) -> int:
        s = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        s.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        s.bind((self.host, self.port))
        s.listen(64)
        self.port = s.getsockname()[1]
        self._lsock = s
        self.server_id = self._alloc_server_id()
        self._accept_thread = threading.Thread(
            target=self._accept_loop, daemon=True, name="mysql-accept"
        )
        self._accept_thread.start()
        self._kill_thread = threading.Thread(
            target=self._kill_poll_loop, daemon=True, name="mysql-kill-poll"
        )
        self._kill_thread.start()
        return self.port

    def _accept_loop(self) -> None:
        while not self._stopping:
            try:
                sock, _ = self._lsock.accept()
            except OSError:
                return
            with self._mu:
                # wrap the local counter inside its 24-bit field, skipping
                # still-live ids — a bleed into the server-id bits would
                # misroute cross-node KILL
                local_mask = (1 << self._GCONN_SHIFT) - 1
                while True:
                    local = self._next_id & local_mask
                    self._next_id = (self._next_id + 1) & local_mask or 1
                    cid = (self.server_id << self._GCONN_SHIFT) | local
                    if local and cid not in self._conns:
                        break
                conn = ClientConn(self, sock, cid)
                self._conns[cid] = conn
            threading.Thread(
                target=conn.run, daemon=True, name=f"mysql-conn-{cid}"
            ).start()

    # -- cross-node KILL (ref: tests/globalkilltest; util/globalconn) --------
    def _kill_poll_loop(self) -> None:
        """Consume kill markers addressed to this server id: another SQL
        node's KILL of a global conn id lands as a store row this node's
        poller picks up (the store replaces etcd as the signalling plane)."""
        import time as _t

        from tidb_tpu_torch.kv.kv import KeyRange

        store = self.db.store
        while not self._stopping:
            _t.sleep(0.2)
            try:
                rows = store.raw_scan(KeyRange(self._GKILL, self._GKILL + b"\xff"))
                for k, v in rows:
                    if not v:
                        continue  # consumed
                    try:
                        cid = int(k[len(self._GKILL):])
                    except ValueError:
                        continue
                    if cid >> self._GCONN_SHIFT != self.server_id:
                        continue
                    self.kill(cid, query_only=v == b"q")
                    store.raw_delete(k)  # consumed markers must not pile up
            except ConnectionError:
                continue  # store briefly unreachable: retry next tick

    def kill_global(self, conn_id: int, query_only: bool = True) -> bool:
        """KILL for a conn id this node does not own: post a marker the
        owning node's poller consumes. True if the target server is known."""
        store = self.db.store
        if not hasattr(store, "raw_scan"):
            return False
        sid = conn_id >> self._GCONN_SHIFT
        if sid == self.server_id:
            # our own prefix and Server.kill already failed → the conn is
            # gone; posting a marker to ourselves would fake success
            return False
        if store.raw_get(self._GSRV_REG + str(sid).encode()) != b"alive":
            return False
        store.raw_put(self._GKILL + str(conn_id).encode(), b"q" if query_only else b"c")
        return True

    def close_registration(self) -> None:
        try:
            self.db.store.raw_put(self._GSRV_REG + str(self.server_id).encode(), b"")
        except ConnectionError:
            pass

    def _conn_event(self, event: str, conn: "ClientConn") -> None:
        # wire-level connection observability: the open-connection gauge
        # tracks authenticated sessions (ref: server connections metric)
        if event in ("connected", "disconnected"):
            from tidb_tpu_torch.utils.metrics import SERVER_CONNS

            SERVER_CONNS.inc(1 if event == "connected" else -1)
        from tidb_tpu_torch.utils import eventlog as _ev

        lg = _ev.on(_ev.INFO)
        if lg is not None:
            lg.emit(_ev.INFO, "server", event, conn=conn.conn_id, user=conn.user)
        exts = getattr(self.db, "extensions", None)
        if exts is not None and exts.have:
            import time as _t

            from tidb_tpu_torch.extension import ConnEvent

            exts.notify_conn(ConnEvent(_t.time(), event, conn.user, "127.0.0.1", conn.conn_id))

    def _deregister(self, conn_id: int) -> None:
        with self._mu:
            self._conns.pop(conn_id, None)

    # -- processlist / kill (ref: SHOW PROCESSLIST + conn.Kill) -------------
    def processlist(self) -> list[tuple]:
        with self._mu:
            conns = list(self._conns.values())
        out = []
        for c in conns:
            sql = c.current_sql
            out.append(
                (
                    c.conn_id,
                    c.user or "root",
                    c.session.current_db,
                    "Query" if sql else "Sleep",
                    (sql or "")[:100],
                )
            )
        return out

    def kill(self, conn_id: int, query_only: bool = True) -> bool:
        with self._mu:
            conn = self._conns.get(conn_id)
        if conn is None:
            return False
        conn.session.kill()
        if not query_only:
            try:
                conn.sock.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass
        return True

    def close(self) -> None:
        self._stopping = True
        if getattr(self, "server_id", None) is not None:
            self.close_registration()
        if self._lsock is not None:
            try:
                self._lsock.close()
            except OSError:
                pass
        with self._mu:
            conns = list(self._conns.values())
        for c in conns:
            try:
                c.sock.close()
            except OSError:
                pass
