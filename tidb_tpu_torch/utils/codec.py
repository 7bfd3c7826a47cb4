"""Memcomparable key codec.

Reference parity: pkg/util/codec (EncodeInt/EncodeBytes/...). The algorithm is
the standard order-preserving encoding used by TiKV-family stores, implemented
here from its published semantics:

- ints: 8-byte big-endian with the sign bit flipped (so byte order == numeric
  order across negatives);
- floats: IEEE bits; positive values flip the sign bit, negative values flip
  all bits;
- bytes: chunked into 8-byte zero-padded groups, each followed by a marker
  byte: 0xFF when the group is full and more data follows, else
  0xFF - pad_count. memcmp order == byte-string order, and encodings are
  prefix-free.
- every encoded datum is prefixed by a flag byte so heterogeneous tuples sort
  type-major (NIL < bytes < int < uint < float is NOT the MySQL order, so we
  use the reference's flag values: NIL=0, BYTES=1, INT=3, UINT=4, FLOAT=5).
"""

from __future__ import annotations

import struct

SIGN_MASK = 0x8000000000000000

NIL_FLAG = 0x00
BYTES_FLAG = 0x01
INT_FLAG = 0x03
UINT_FLAG = 0x04
FLOAT_FLAG = 0x05

_ENC_GROUP_SIZE = 8
_ENC_MARKER = 0xFF
_ENC_PAD = 0x00


def encode_int_raw(v: int) -> bytes:
    """8-byte big-endian, sign bit flipped (no flag)."""
    return struct.pack(">Q", (v ^ SIGN_MASK) & 0xFFFFFFFFFFFFFFFF)


def decode_int_raw(b: bytes, off: int = 0) -> int:
    (u,) = struct.unpack_from(">Q", b, off)
    u ^= SIGN_MASK
    if u >= SIGN_MASK:
        u -= 1 << 64
    return u


def decode_uint_raw(b: bytes, off: int = 0) -> int:
    (u,) = struct.unpack_from(">Q", b, off)
    return u


def encode_bytes_raw(data: bytes) -> bytes:
    """Group encoding: emit 8 data bytes (zero-padded) + marker byte
    (0xFF if full group and not last; else 247+len_of_valid)."""
    out = bytearray()
    i = 0
    n = len(data)
    while True:
        group = data[i : i + _ENC_GROUP_SIZE]
        pad = _ENC_GROUP_SIZE - len(group)
        out += group
        out += bytes([_ENC_PAD]) * pad
        if pad == 0:
            out.append(_ENC_MARKER)
        else:
            out.append(_ENC_MARKER - pad)
            break
        i += _ENC_GROUP_SIZE
        if i == n:
            # exactly consumed; need a terminating empty group
            out += bytes([_ENC_PAD]) * _ENC_GROUP_SIZE
            out.append(_ENC_MARKER - _ENC_GROUP_SIZE)
            break
    return bytes(out)


def decode_bytes_raw(b: bytes, off: int = 0) -> tuple[bytes, int]:
    """Returns (data, new_offset)."""
    out = bytearray()
    while True:
        group = b[off : off + _ENC_GROUP_SIZE]
        marker = b[off + _ENC_GROUP_SIZE]
        off += _ENC_GROUP_SIZE + 1
        if marker == _ENC_MARKER:
            out += group
        else:
            pad = _ENC_MARKER - marker
            out += group[: _ENC_GROUP_SIZE - pad]
            return bytes(out), off


def _float_to_ordered_u64(f: float) -> int:
    (u,) = struct.unpack(">Q", struct.pack(">d", f))
    if u & SIGN_MASK:
        u = (~u) & 0xFFFFFFFFFFFFFFFF
    else:
        u |= SIGN_MASK
    return u


def _ordered_u64_to_float(u: int) -> float:
    if u & SIGN_MASK:
        u &= ~SIGN_MASK & 0xFFFFFFFFFFFFFFFF
    else:
        u = (~u) & 0xFFFFFFFFFFFFFFFF
    return struct.unpack(">d", struct.pack(">Q", u))[0]


# -- flagged datum encoding (index key values) ------------------------------


def encode_key_int(v: int) -> bytes:
    return bytes([INT_FLAG]) + encode_int_raw(v)


def encode_key_float(v: float) -> bytes:
    return bytes([FLOAT_FLAG]) + struct.pack(">Q", _float_to_ordered_u64(v))


def encode_key_bytes(v: bytes) -> bytes:
    return bytes([BYTES_FLAG]) + encode_bytes_raw(v)


def encode_key_nil() -> bytes:
    return bytes([NIL_FLAG])


def decode_key_one(b: bytes, off: int = 0):
    """Decode one flagged datum → (value, new_offset). NULL → None."""
    flag = b[off]
    off += 1
    if flag == NIL_FLAG:
        return None, off
    if flag == INT_FLAG:
        return decode_int_raw(b, off), off + 8
    if flag == UINT_FLAG:
        return decode_uint_raw(b, off), off + 8
    if flag == FLOAT_FLAG:
        (u,) = struct.unpack_from(">Q", b, off)
        return _ordered_u64_to_float(u), off + 8
    if flag == BYTES_FLAG:
        return decode_bytes_raw(b, off)
    raise ValueError(f"unknown datum flag {flag:#x}")


