"""MySQL client/server protocol encoding primitives (ref: pkg/server/packetio
+ the MySQL protocol text-resultset layout that conn.go writeResultSet emits).
"""

from __future__ import annotations

import struct
from typing import Optional

# capability flags (the subset we speak)
CLIENT_LONG_PASSWORD = 0x1
CLIENT_PROTOCOL_41 = 0x200
CLIENT_CONNECT_WITH_DB = 0x8
CLIENT_SSL = 0x800
CLIENT_SECURE_CONNECTION = 0x8000
CLIENT_PLUGIN_AUTH = 0x80000
CLIENT_DEPRECATE_EOF = 0x1000000

SERVER_CAPS = (
    CLIENT_LONG_PASSWORD
    | CLIENT_PROTOCOL_41
    | CLIENT_CONNECT_WITH_DB
    | CLIENT_SECURE_CONNECTION
    | CLIENT_PLUGIN_AUTH
)

# command bytes
COM_QUIT = 0x01
COM_INIT_DB = 0x02
COM_QUERY = 0x03
COM_PING = 0x0E

# column type codes (protocol::ColumnType)
T_DOUBLE = 5
T_LONGLONG = 8
T_DATE = 10
T_TIME = 11
T_DATETIME = 12
T_VAR_STRING = 253
T_NEWDECIMAL = 246
T_JSON = 245


def lenc_int(n: int) -> bytes:
    if n < 251:
        return bytes([n])
    if n < 1 << 16:
        return b"\xfc" + struct.pack("<H", n)
    if n < 1 << 24:
        return b"\xfd" + struct.pack("<I", n)[:3]
    return b"\xfe" + struct.pack("<Q", n)


def lenc_str(b: bytes) -> bytes:
    return lenc_int(len(b)) + b


def read_lenc_int(buf: bytes, off: int) -> tuple[int, int]:
    first = buf[off]
    if first < 251:
        return first, off + 1
    if first == 0xFC:
        return struct.unpack_from("<H", buf, off + 1)[0], off + 3
    if first == 0xFD:
        return struct.unpack("<I", buf[off + 1 : off + 4] + b"\x00")[0], off + 4
    return struct.unpack_from("<Q", buf, off + 1)[0], off + 9


class PacketIO:
    """3-byte length + 1-byte sequence framing over a socket."""

    def __init__(self, sock):
        self.sock = sock
        self.seq = 0

    def read(self) -> bytes:
        hdr = self._recvn(4)
        ln = hdr[0] | (hdr[1] << 8) | (hdr[2] << 16)
        self.seq = (hdr[3] + 1) & 0xFF
        return self._recvn(ln)

    def write(self, payload: bytes) -> None:
        out = bytearray()
        off = 0
        while True:
            part = payload[off : off + 0xFFFFFF]
            out += struct.pack("<I", len(part))[:3] + bytes([self.seq])
            out += part
            self.seq = (self.seq + 1) & 0xFF
            off += len(part)
            if off >= len(payload) and len(part) != 0xFFFFFF:
                break
        self.sock.sendall(bytes(out))

    def reset_seq(self) -> None:
        self.seq = 0

    def _recvn(self, n: int) -> bytes:
        buf = b""
        while len(buf) < n:
            part = self.sock.recv(n - len(buf))
            if not part:
                raise ConnectionError("connection closed")
            buf += part
        return buf


def ok_packet(affected: int = 0, last_insert_id: int = 0, status: int = 2, info: bytes = b"", warnings: int = 0) -> bytes:
    return b"\x00" + lenc_int(affected) + lenc_int(last_insert_id) + struct.pack("<HH", status, warnings) + info


def err_packet(code: int, msg: str, sqlstate: str = "HY000") -> bytes:
    return b"\xff" + struct.pack("<H", code) + b"#" + sqlstate.encode() + msg.encode("utf-8")


def eof_packet(status: int = 2, warnings: int = 0) -> bytes:
    return b"\xfe" + struct.pack("<HH", warnings, status)


def column_def(name: str, col_type: int, col_len: int = 255, decimals: int = 0, charset: int = 33) -> bytes:
    """Column definition 41 (ref: writeColumnInfo)."""

    def ls(s: bytes) -> bytes:
        return lenc_str(s)

    nm = name.encode("utf-8")
    return (
        ls(b"def") + ls(b"") + ls(b"") + ls(b"") + ls(nm) + ls(nm)
        + b"\x0c" + struct.pack("<HIBHB", charset, col_len, col_type, 0, decimals) + b"\x00\x00"
    )


def type_for(ft) -> tuple[int, int, int]:
    """FieldType → (protocol type, display length, decimals)."""
    from tidb_tpu_torch.types import TypeKind

    k = ft.kind
    if k in (TypeKind.INT, TypeKind.UINT):
        return T_LONGLONG, 20, 0
    if k == TypeKind.FLOAT:
        return T_DOUBLE, 22, 31
    if k == TypeKind.DECIMAL:
        return T_NEWDECIMAL, ft.length + 2, ft.scale
    if k == TypeKind.DATE:
        return T_DATE, 10, 0
    if k == TypeKind.DATETIME:
        return T_DATETIME, 26, 0
    if k == TypeKind.DURATION:
        return T_TIME, 10, 0
    if k == TypeKind.JSON:
        return T_JSON, 1 << 16, 0
    return T_VAR_STRING, max(ft.length, 0) or 255, 0


def text_value(v) -> Optional[bytes]:
    """Python value → text-protocol bytes (None = SQL NULL)."""
    if v is None:
        return None
    if isinstance(v, bytes):
        return v
    if isinstance(v, bool):
        return b"1" if v else b"0"
    if isinstance(v, float):
        return repr(v).encode()
    if hasattr(v, "isoformat"):
        if hasattr(v, "hour") and hasattr(v, "year"):
            return v.isoformat(sep=" ").encode()
        return v.isoformat().encode()
    return str(v).encode("utf-8")


# -- binary (prepared-statement) protocol ------------------------------------
# ref: conn.go:1281-1428 COM_STMT_* dispatch + MySQL binary resultset rows

COM_STMT_PREPARE = 0x16
COM_STMT_EXECUTE = 0x17
COM_STMT_SEND_LONG_DATA = 0x18
COM_STMT_CLOSE = 0x19
COM_STMT_RESET = 0x1A
COM_STMT_FETCH = 0x1C

# cursor status flags (ref: mysql SERVER_STATUS_*; conn_stmt.go cursor mode)
SERVER_STATUS_CURSOR_EXISTS = 0x0040
SERVER_STATUS_LAST_ROW_SENT = 0x0080
CURSOR_TYPE_READ_ONLY = 0x01

T_TINY = 1
T_SHORT = 2
T_LONG = 3
T_FLOAT = 4
T_NULL = 6
T_INT24 = 9
T_YEAR = 13
T_VARCHAR = 15
T_BLOB = 252
T_STRING = 254


def stmt_prepare_ok(stmt_id: int, num_cols: int, num_params: int) -> bytes:
    return b"\x00" + struct.pack("<IHH", stmt_id, num_cols, num_params) + b"\x00" + struct.pack("<H", 0)


def decode_binary_params(data: bytes, off: int, n_params: int, prev_types=None):
    """COM_STMT_EXECUTE payload → python values (ref: parseExecArgs /
    binary protocol value layout). Returns (values, types) — types persist
    across executions when new_params_bound is 0."""
    if n_params == 0:
        return [], prev_types
    nb_len = (n_params + 7) // 8
    null_bitmap = data[off : off + nb_len]
    off += nb_len
    new_bound = data[off]
    off += 1
    if new_bound:
        types = [struct.unpack_from("<H", data, off + 2 * i)[0] for i in range(n_params)]
        off += 2 * n_params
    else:
        types = prev_types
        if types is None:
            raise ValueError("binary execute without parameter types")
    vals: list = []
    for i in range(n_params):
        if null_bitmap[i // 8] & (1 << (i % 8)):
            vals.append(None)
            continue
        t = types[i] & 0xFF
        unsigned = bool(types[i] & 0x8000)
        if t in (T_TINY,):
            vals.append(struct.unpack_from("<b", data, off)[0])
            off += 1
        elif t in (T_SHORT, T_YEAR):
            vals.append(struct.unpack_from("<h", data, off)[0])
            off += 2
        elif t in (T_LONG, T_INT24):
            vals.append(struct.unpack_from("<i", data, off)[0])
            off += 4
        elif t == T_LONGLONG:
            fmt = "<Q" if unsigned else "<q"
            vals.append(struct.unpack_from(fmt, data, off)[0])
            off += 8
        elif t == T_FLOAT:
            vals.append(struct.unpack_from("<f", data, off)[0])
            off += 4
        elif t == T_DOUBLE:
            vals.append(struct.unpack_from("<d", data, off)[0])
            off += 8
        elif t == T_NULL:
            vals.append(None)
        elif t in (T_DATE, T_DATETIME, 7):  # 7 = TIMESTAMP
            import datetime as _dt

            ln = data[off]
            off += 1
            y = mo = d = h = mi = s = us = 0
            if ln >= 4:
                y, mo, d = struct.unpack_from("<HBB", data, off)
            if ln >= 7:
                h, mi, s = struct.unpack_from("<BBB", data, off + 4)
            if ln >= 11:
                us = struct.unpack_from("<I", data, off + 7)[0]
            off += ln
            if t == T_DATE and ln <= 4:
                vals.append(_dt.date(y, mo, d) if ln else None)
            else:
                vals.append(_dt.datetime(y, mo, d, h, mi, s, us) if ln else None)
        elif t == T_TIME:
            import datetime as _dt

            ln = data[off]
            off += 1
            if ln == 0:
                vals.append(_dt.timedelta(0))
            else:
                neg, days, h, mi, s = struct.unpack_from("<BIBBB", data, off)
                us = struct.unpack_from("<I", data, off + 8)[0] if ln >= 12 else 0
                td = _dt.timedelta(days=days, hours=h, minutes=mi, seconds=s, microseconds=us)
                vals.append(-td if neg else td)
            off += ln
        else:  # lenc string/blob/decimal
            v, off = read_lenc_int(data, off)
            raw = data[off : off + v]
            off += v
            vals.append(raw.decode("utf-8", "surrogateescape"))
    return vals, types


def binary_row(row, ftypes) -> bytes:
    """One binary-protocol resultset row (ref: writeBinaryRow): 0x00 header,
    null bitmap with offset 2, then per-type values."""
    n = len(row)
    nb = bytearray((n + 9) // 8)
    body = bytearray()
    for i, v in enumerate(row):
        if v is None:
            nb[(i + 2) // 8] |= 1 << ((i + 2) % 8)
            continue
        ft = ftypes[i] if ftypes is not None and i < len(ftypes) and ftypes[i] is not None else None
        tc = type_for(ft)[0] if ft is not None else T_VAR_STRING
        if tc == T_LONGLONG:
            body += struct.pack("<q", int(v) if int(v) < 1 << 63 else int(v) - (1 << 64))
        elif tc == T_DOUBLE:
            body += struct.pack("<d", float(v))
        elif tc == T_DATE:
            body += bytes([4]) + struct.pack("<HBB", v.year, v.month, v.day)
        elif tc == T_DATETIME:
            body += bytes([11]) + struct.pack("<HBBBBB", v.year, v.month, v.day, v.hour, v.minute, v.second) + struct.pack("<I", v.microsecond)
        elif tc == T_TIME:
            total_us = int(v.total_seconds() * 1_000_000)
            neg = total_us < 0
            a = abs(total_us)
            days, rem = divmod(a, 86_400_000_000)
            h, rem = divmod(rem, 3_600_000_000)
            mi, rem = divmod(rem, 60_000_000)
            s, us = divmod(rem, 1_000_000)
            body += bytes([12]) + struct.pack("<BIBBB", int(neg), days, h, mi, s) + struct.pack("<I", us)
        else:  # decimal/string/json → lenc text
            body += lenc_str(text_value(v) or b"")
    return b"\x00" + bytes(nb) + bytes(body)
