"""Table/index key layout (ref: pkg/tablecodec/tablecodec.go:50-51,111).

Layout (memcomparable, same shape as the reference so range semantics match):

- record key:  ``t`` + enc_int(table_id) + ``_r`` + enc_int(handle)
- index key:   ``t`` + enc_int(table_id) + ``_i`` + enc_int(index_id) + flagged datums
- meta keys live under the ``m`` prefix (tidb_tpu.catalog.meta)
"""

from __future__ import annotations

from tidb_tpu_torch.kv.kv import KeyRange
from tidb_tpu_torch.utils import codec

TABLE_PREFIX = b"t"
RECORD_SEP = b"_r"
INDEX_SEP = b"_i"

_RECORD_KEY_LEN = 1 + 8 + 2 + 8


def record_key(table_id: int, handle: int) -> bytes:
    return TABLE_PREFIX + codec.encode_int_raw(table_id) + RECORD_SEP + codec.encode_int_raw(handle)


def record_prefix(table_id: int) -> bytes:
    return TABLE_PREFIX + codec.encode_int_raw(table_id) + RECORD_SEP


def table_prefix(table_id: int) -> bytes:
    return TABLE_PREFIX + codec.encode_int_raw(table_id)


def decode_record_key(key: bytes) -> tuple[int, int]:
    """→ (table_id, handle). Raises on non-record keys."""
    if len(key) != _RECORD_KEY_LEN or key[:1] != TABLE_PREFIX or key[9:11] != RECORD_SEP:
        raise ValueError(f"not a record key: {key!r}")
    return codec.decode_int_raw(key, 1), codec.decode_int_raw(key, 11)


def is_record_key(key: bytes) -> bool:
    return len(key) == _RECORD_KEY_LEN and key[:1] == TABLE_PREFIX and key[9:11] == RECORD_SEP


def table_id_of(key: bytes) -> int:
    """table_id of ANY table-space key (record, index, or bare prefix);
    -1 for keys outside the ``t`` keyspace (meta, election, placement)."""
    if key[:1] != TABLE_PREFIX or len(key) < 9:
        return -1
    return codec.decode_int_raw(key, 1)


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
    saturating at the int64 bounds (a row at handle INT64_MAX is not
    addressable by a half-open int64 range — the autoid allocator never
    hands it out, matching the reference's IntHandle edge)."""
    p = record_prefix(table_id)
    i64_max = 2**63 - 1

    def project(k: bytes) -> int:
        # smallest handle whose record key is >= k, saturated
        if k <= p:
            return -(2**63)
        if not k.startswith(p):
            return i64_max  # k is past this table's record space
        body = k[len(p) :]
        if len(body) >= 8:
            h = codec.decode_int_raw(body[:8])
            if len(body) > 8:  # key extends past the handle → next handle up
                h = min(h + 1, i64_max)
            return h
        return codec.decode_int_raw(body + b"\x00" * (8 - len(body)))

    return project(kr.start), project(kr.end)


def index_key(table_id: int, index_id: int, encoded_values: bytes, handle: int | None = None) -> bytes:
    """Non-unique indexes append the handle to make keys unique; unique
    indexes omit it (handle lives in the value)."""
    k = TABLE_PREFIX + codec.encode_int_raw(table_id) + INDEX_SEP + codec.encode_int_raw(index_id) + encoded_values
    if handle is not None:
        k += codec.encode_int_raw(handle)
    return k


def index_prefix(table_id: int, index_id: int) -> bytes:
    return TABLE_PREFIX + codec.encode_int_raw(table_id) + INDEX_SEP + codec.encode_int_raw(index_id)


def index_range(table_id: int, index_id: int, low: bytes = b"", high: bytes | None = None) -> KeyRange:
    """Range over encoded index values [low, high); None high = whole index."""
    p = index_prefix(table_id, index_id)
    if high is None:
        return KeyRange(p + low, p + b"\xff" * 9 + b"\x00")  # past any flagged datum
    return KeyRange(p + low, p + high)
