"""Minimal MySQL text-protocol client (the benchdb/test driver analog and
the in-repo stand-in for mysql-client/pymysql in hermetic tests)."""

from __future__ import annotations

import socket
import struct
from typing import Optional

from tidb_tpu_torch.server import protocol as p


class MySQLError(Exception):
    def __init__(self, code: int, msg: str):
        super().__init__(f"({code}) {msg}")
        self.code = code


class Client:
    def __init__(
        self,
        host: str = "127.0.0.1",
        port: int = 4000,
        user: str = "root",
        password: str = "",
        db: str = "",
        tls: bool = False,
        auth_plugin: str = "mysql_native_password",
        connect_timeout: Optional[float] = None,
        read_timeout: Optional[float] = None,
    ):
        # split connect/read deadlines sourced from config (mirrors the store
        # RPC client, kv/remote.py): a dead server fails the dial fast, while
        # an ALIVE server gets the long read deadline first-query JIT
        # compiles and big scans legitimately need
        from tidb_tpu_torch import config as _config

        dflt = _config.current()
        ct = connect_timeout if connect_timeout is not None else dflt.connect_timeout_s
        rt = read_timeout if read_timeout is not None else dflt.read_timeout_s
        self.sock = socket.create_connection((host, port), timeout=ct)
        self.sock.settimeout(rt)
        self.io = p.PacketIO(self.sock)
        self.tls = False
        self._handshake(user, password, db, tls, auth_plugin)

    @staticmethod
    def _token_for(plugin: str, password: str, nonce: bytes) -> bytes:
        if plugin == "caching_sha2_password":
            from tidb_tpu_torch.privilege import sha2_auth_token

            return sha2_auth_token(password, nonce)
        from tidb_tpu_torch.privilege import native_auth_token

        return native_auth_token(password, nonce)

    def _handshake(self, user: str, password: str, db: str, tls: bool, auth_plugin: str) -> None:
        greeting = self.io.read()
        if greeting[0] != 10:
            raise ConnectionError(f"unexpected protocol version {greeting[0]}")
        # salt = 8 bytes after ver+thread_id, then 12 more past the caps block
        off = 1 + greeting.index(b"\x00", 1) + 4
        salt1 = greeting[off : off + 8]
        off2 = off + 8 + 1 + 2 + 1 + 2 + 2 + 1 + 10
        salt2 = greeting[off2 : off2 + 12]
        nonce = salt1 + salt2
        caps = p.CLIENT_PROTOCOL_41 | p.CLIENT_SECURE_CONNECTION | p.CLIENT_PLUGIN_AUTH
        if db:
            caps |= p.CLIENT_CONNECT_WITH_DB
        if tls:
            import ssl

            srv_caps_lo = struct.unpack_from("<H", greeting, off2 - 1 - 2 - 1 - 2 - 2 - 10)[0]
            if not srv_caps_lo & p.CLIENT_SSL:
                raise MySQLError(2026, "server does not support TLS")

            caps |= p.CLIENT_SSL
            # SSLRequest leg, then wrap the socket (self-signed test certs:
            # no verification, like --ssl-mode=REQUIRED without CA pinning)
            self.io.write(struct.pack("<IIB", caps, 1 << 24, 33) + b"\x00" * 23)
            ctx = ssl.SSLContext(ssl.PROTOCOL_TLS_CLIENT)
            ctx.check_hostname = False
            ctx.verify_mode = ssl.CERT_NONE
            self.sock = ctx.wrap_socket(self.sock)
            self.io.sock = self.sock
            self.tls = True
        token = self._token_for(auth_plugin, password, nonce)
        resp = (
            struct.pack("<IIB", caps, 1 << 24, 33)
            + b"\x00" * 23
            + user.encode() + b"\x00"
            + bytes([len(token)]) + token
            + ((db.encode() + b"\x00") if db else b"")
            + auth_plugin.encode() + b"\x00"
        )
        self.io.write(resp)
        pkt = self.io.read()
        if pkt and pkt[0] == 0xFE and len(pkt) > 1:
            # AuthSwitchRequest: plugin name NUL nonce NUL
            end = pkt.index(b"\x00", 1)
            plugin = pkt[1:end].decode()
            new_nonce = pkt[end + 1 :].rstrip(b"\x00")
            self.io.write(self._token_for(plugin, password, new_nonce))
            pkt = self.io.read()
        if pkt and pkt[0] == 0x01:  # AuthMoreData (sha2 fast-auth success)
            pkt = self.io.read()
        if pkt and pkt[0] == 0xFF:
            raise self._err(pkt)

    def _err(self, pkt: bytes) -> MySQLError:
        code = struct.unpack_from("<H", pkt, 1)[0]
        off = 3
        if pkt[off : off + 1] == b"#":
            off += 6
        return MySQLError(code, pkt[off:].decode("utf-8", "replace"))

    def query(self, sql: str):
        """→ list of tuples of str|None (text protocol), or affected count."""
        self.io.reset_seq()
        self.io.write(bytes([p.COM_QUERY]) + sql.encode("utf-8"))
        pkt = self.io.read()
        if pkt[0] == 0xFF:
            raise self._err(pkt)
        if pkt[0] == 0x00:  # OK
            affected, off = p.read_lenc_int(pkt, 1)
            _lii, off = p.read_lenc_int(pkt, off)
            # status u16, warnings u16 (ref: OK_Packet warning count)
            self.warning_count = struct.unpack_from("<H", pkt, off + 2)[0] if len(pkt) >= off + 4 else 0
            return affected
        ncols, _ = p.read_lenc_int(pkt, 0)
        cols = []
        for _ in range(ncols):
            cols.append(self._parse_coldef(self.io.read()))
        self._expect_eof()
        rows = []
        while True:
            pkt = self.io.read()
            if pkt[0] == 0xFE and len(pkt) < 9:
                self.warning_count = struct.unpack_from("<H", pkt, 1)[0]
                break
            if pkt[0] == 0xFF:
                raise self._err(pkt)
            rows.append(self._parse_row(pkt, ncols))
        self.columns = cols
        return rows

    def _parse_coldef(self, pkt: bytes, with_type: bool = False):
        off = 0
        vals = []
        for _ in range(6):  # catalog, schema, table, org_table, name, org_name
            ln, off = p.read_lenc_int(pkt, off)
            vals.append(pkt[off : off + ln])
            off += ln
        name = vals[4].decode()
        if with_type:
            # fixed block: 0x0c marker, charset u16, length u32, then type
            return name, pkt[off + 1 + 2 + 4]
        return name

    def _parse_row(self, pkt: bytes, ncols: int) -> tuple:
        off = 0
        out = []
        for _ in range(ncols):
            if pkt[off] == 0xFB:
                out.append(None)
                off += 1
            else:
                ln, off = p.read_lenc_int(pkt, off)
                out.append(pkt[off : off + ln].decode("utf-8", "replace"))
                off += ln
        return tuple(out)

    def _expect_eof(self) -> None:
        pkt = self.io.read()
        if pkt[0] != 0xFE:
            raise ConnectionError(f"expected EOF packet, got {pkt[0]:#x}")

    # -- binary prepared protocol (COM_STMT_*; what real drivers use for
    # parameterized queries — PyMySQL/Connector-J prepare by default) -------
    def prepare(self, sql: str) -> tuple[int, int]:
        """→ (stmt_id, n_params)."""
        self.io.reset_seq()
        self.io.write(bytes([p.COM_STMT_PREPARE]) + sql.encode("utf-8"))
        pkt = self.io.read()
        if pkt[0] == 0xFF:
            raise self._err(pkt)
        stmt_id, ncols, nparams = struct.unpack_from("<IHH", pkt, 1)
        for _ in range(nparams):
            self.io.read()  # param defs
        if nparams:
            self._expect_eof()
        for _ in range(ncols):
            self.io.read()  # column defs
        if ncols:
            self._expect_eof()
        # prepare-time result metadata (mysql_stmt_result_metadata analog)
        self.last_prepare_cols = ncols
        return stmt_id, nparams

    def execute(self, stmt_id: int, params: list = ()):
        """Binary execute → list of decoded python tuples, or affected count."""
        body = bytearray(struct.pack("<IBI", stmt_id, 0, 1))
        n = len(params)
        if n:
            nb = bytearray((n + 7) // 8)
            types = bytearray()
            vals = bytearray()
            for i, v in enumerate(params):
                if v is None:
                    nb[i // 8] |= 1 << (i % 8)
                    types += struct.pack("<H", p.T_NULL)
                elif isinstance(v, bool):
                    types += struct.pack("<H", p.T_TINY)
                    vals += struct.pack("<b", int(v))
                elif isinstance(v, int):
                    types += struct.pack("<H", p.T_LONGLONG)
                    vals += struct.pack("<q", v)
                elif isinstance(v, float):
                    types += struct.pack("<H", p.T_DOUBLE)
                    vals += struct.pack("<d", v)
                else:
                    b = v.encode("utf-8") if isinstance(v, str) else bytes(v)
                    types += struct.pack("<H", p.T_VAR_STRING)
                    vals += p.lenc_str(b)
            body += bytes(nb) + b"\x01" + bytes(types) + bytes(vals)
        self.io.reset_seq()
        self.io.write(bytes([p.COM_STMT_EXECUTE]) + bytes(body))
        pkt = self.io.read()
        if pkt[0] == 0xFF:
            raise self._err(pkt)
        if pkt[0] == 0x00:  # OK (a resultset column count is never 0)
            affected, _ = p.read_lenc_int(pkt, 1)
            return affected
        ncols, _ = p.read_lenc_int(pkt, 0)
        coltypes = []
        cols = []
        for _ in range(ncols):
            name, tc = self._parse_coldef(self.io.read(), with_type=True)
            cols.append(name)
            coltypes.append(tc)
        self._expect_eof()
        rows = []
        while True:
            pkt = self.io.read()
            if pkt[0] == 0xFE and len(pkt) < 9:
                break
            if pkt[0] == 0xFF:
                raise self._err(pkt)
            rows.append(self._parse_binary_row(pkt, coltypes))
        self.columns = cols
        return rows

    def execute_cursor(self, stmt_id: int, params: list = ()):
        """Binary execute in CURSOR mode: the server parks the result; rows
        arrive via fetch(). Returns the column names."""
        if params:
            raise ValueError("cursor demo client: parameterless statements only")
        body = struct.pack("<IBI", stmt_id, p.CURSOR_TYPE_READ_ONLY, 1)
        self.io.reset_seq()
        self.io.write(bytes([p.COM_STMT_EXECUTE]) + body)
        pkt = self.io.read()
        if pkt[0] == 0xFF:
            raise self._err(pkt)
        if pkt[0] == 0x00:
            # OK packet: no result set (DML) → no cursor to drain
            raise MySQLError(0, "statement returned no result set; cursor not opened")
        ncols, _ = p.read_lenc_int(pkt, 0)
        self._cursor_types = []
        cols = []
        for _ in range(ncols):
            name, tc = self._parse_coldef(self.io.read(), with_type=True)
            cols.append(name)
            self._cursor_types.append(tc)
        eof = self.io.read()
        status = struct.unpack_from("<H", eof, 3)[0]
        if not status & p.SERVER_STATUS_CURSOR_EXISTS:
            raise ConnectionError("server did not open a cursor")
        self.columns = cols
        return cols

    def fetch(self, stmt_id: int, n: int):
        """COM_STMT_FETCH: (rows, done) — up to n rows of the open cursor."""
        self.io.reset_seq()
        self.io.write(bytes([p.COM_STMT_FETCH]) + struct.pack("<II", stmt_id, n))
        rows = []
        while True:
            pkt = self.io.read()
            if pkt[0] == 0xFF:
                raise self._err(pkt)
            if pkt[0] == 0xFE and len(pkt) < 9:
                status = struct.unpack_from("<H", pkt, 3)[0]
                return rows, bool(status & p.SERVER_STATUS_LAST_ROW_SENT)
            rows.append(self._parse_binary_row(pkt, self._cursor_types))

    def stmt_close(self, stmt_id: int) -> None:
        self.io.reset_seq()
        self.io.write(bytes([p.COM_STMT_CLOSE]) + struct.pack("<I", stmt_id))

    def _parse_binary_row(self, pkt: bytes, coltypes: list) -> tuple:
        import datetime as _dt

        n = len(coltypes)
        nb_len = (n + 9) // 8
        nb = pkt[1 : 1 + nb_len]
        off = 1 + nb_len
        out = []
        for i, t in enumerate(coltypes):
            if nb[(i + 2) // 8] & (1 << ((i + 2) % 8)):
                out.append(None)
                continue
            if t == p.T_LONGLONG:
                out.append(struct.unpack_from("<q", pkt, off)[0])
                off += 8
            elif t == p.T_DOUBLE:
                out.append(struct.unpack_from("<d", pkt, off)[0])
                off += 8
            elif t == p.T_DATE:
                ln = pkt[off]
                off += 1
                y, mo, d = struct.unpack_from("<HBB", pkt, off) if ln >= 4 else (0, 1, 1)
                out.append(_dt.date(y, mo, d))
                off += ln
            elif t == p.T_DATETIME:
                ln = pkt[off]
                off += 1
                y = mo = d = h = mi = s = us = 0
                if ln >= 4:
                    y, mo, d = struct.unpack_from("<HBB", pkt, off)
                if ln >= 7:
                    h, mi, s = struct.unpack_from("<BBB", pkt, off + 4)
                if ln >= 11:
                    us = struct.unpack_from("<I", pkt, off + 7)[0]
                out.append(_dt.datetime(y, mo, d, h, mi, s, us))
                off += ln
            elif t == p.T_TIME:
                ln = pkt[off]
                off += 1
                if ln == 0:
                    out.append(_dt.timedelta(0))
                else:
                    neg, days, h, mi, s = struct.unpack_from("<BIBBB", pkt, off)
                    us = struct.unpack_from("<I", pkt, off + 8)[0] if ln >= 12 else 0
                    td = _dt.timedelta(days=days, hours=h, minutes=mi, seconds=s, microseconds=us)
                    out.append(-td if neg else td)
                off += ln
            else:  # lenc-encoded (decimal/string/json)
                ln, off = p.read_lenc_int(pkt, off)
                out.append(pkt[off : off + ln].decode("utf-8", "replace"))
                off += ln
        return tuple(out)

    def ping(self) -> bool:
        self.io.reset_seq()
        self.io.write(bytes([p.COM_PING]))
        return self.io.read()[0] == 0x00

    def use(self, db: str) -> None:
        self.io.reset_seq()
        self.io.write(bytes([p.COM_INIT_DB]) + db.encode())
        pkt = self.io.read()
        if pkt[0] == 0xFF:
            raise self._err(pkt)

    def close(self) -> None:
        try:
            self.io.reset_seq()
            self.io.write(bytes([0x01]))  # COM_QUIT
        except OSError:
            pass
        self.sock.close()
