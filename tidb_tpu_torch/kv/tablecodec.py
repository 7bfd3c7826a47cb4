"""Record-key layout (port of the record-key half of tidb_tpu/kv/tablecodec.py).

record key: ``t`` + enc_int(table_id) + ``_r`` + enc_int(handle), where
enc_int is 8-byte big-endian with the sign bit flipped (memcomparable), so
the engine accepts the same ``KeyRange``s the SQL layer sends.
"""

from __future__ import annotations

import struct
from dataclasses import dataclass

TABLE_PREFIX = b"t"
RECORD_SEP = b"_r"
_SIGN_MASK = 1 << 63
_I64_MAX = 2**63 - 1


@dataclass(frozen=True)
class KeyRange:
    """Half-open [start, end)."""

    start: bytes
    end: bytes


def encode_int_raw(v: int) -> bytes:
    return struct.pack(">Q", (v ^ _SIGN_MASK) & 0xFFFFFFFFFFFFFFFF)


def decode_int_raw(b: bytes, off: int = 0) -> int:
    (u,) = struct.unpack_from(">Q", b, off)
    u ^= _SIGN_MASK
    if u >= _SIGN_MASK:
        u -= 1 << 64
    return u


def record_key(table_id: int, handle: int) -> bytes:
    return TABLE_PREFIX + encode_int_raw(table_id) + RECORD_SEP + encode_int_raw(handle)


def record_prefix(table_id: int) -> bytes:
    return TABLE_PREFIX + encode_int_raw(table_id) + RECORD_SEP


def record_range(table_id: int) -> KeyRange:
    """Full-table scan range: [t{id}_r, t{id}_s)."""
    p = record_prefix(table_id)
    return KeyRange(p, p[:-1] + bytes([p[-1] + 1]))


def handle_range(table_id: int, lo: int | None, hi: int | None) -> KeyRange:
    """Range over handles [lo, hi] inclusive (None = unbounded)."""
    full = record_range(table_id)
    start = record_key(table_id, lo) if lo is not None else full.start
    end = record_key(table_id, hi + 1) if hi is not None else full.end
    return KeyRange(start, end)


def range_to_handles(kr: KeyRange, table_id: int) -> tuple[int, int]:
    """Project a key range onto handle space → [lo, hi) over int64 handles,
    saturating at the int64 bounds."""
    p = record_prefix(table_id)

    def project(k: bytes) -> int:
        # smallest handle whose record key is >= k, saturated
        if k <= p:
            return -(2**63)
        if not k.startswith(p):
            return _I64_MAX  # k is past this table's record space
        body = k[len(p) :]
        if len(body) >= 8:
            h = decode_int_raw(body[:8])
            if len(body) > 8:  # key extends past the handle → next handle up
                h = min(h + 1, _I64_MAX)
            return h
        return decode_int_raw(body + b"\x00" * (8 - len(body)))

    return project(kr.start), project(kr.end)
