"""Row value codec — fixed-slot layout with vectorized bulk decode.

Reference parity: pkg/util/rowcodec (compact row format v2, encoder.go). The
reference optimizes for byte compactness; this rebuild optimizes for
*vectorized decode into device-ready columns*:

    row := version(1B) | null_bitmap(ceil(n/8) B) | fixed_slots(8B × n_fixed)
           | varlen_section( for each string col: u32 len + bytes )

All fixed-width columns (int64/float64 physical) sit at schema-constant byte
offsets, so a batch of rows decodes with one numpy gather per column —
``decode_fixed_bulk`` — instead of a per-row loop. String columns decode in a
per-column loop and dictionary-encode at columnar-cache build time.

The column set and order come from the table schema version; rows embed only
the schema version, not column ids (compactness + self-description traded for
decode speed; schema history lives in the catalog).
"""

from __future__ import annotations

import struct
from typing import Sequence

import numpy as np

from tidb_tpu_torch.types import FieldType, TypeKind

ROW_VERSION = 1


class RowSchema:
    """Decode plan for one table schema version: which physical slot each
    column occupies."""

    def __init__(self, ftypes: Sequence[FieldType]):
        self.ftypes = list(ftypes)
        self.n = len(self.ftypes)
        self.bitmap_len = (self.n + 7) // 8
        self.fixed_idx: list[int] = []  # column positions with fixed slots
        self.string_idx: list[int] = []  # column positions in varlen section
        for i, ft in enumerate(self.ftypes):
            if ft.kind in (TypeKind.STRING, TypeKind.JSON):
                self.string_idx.append(i)
            else:
                self.fixed_idx.append(i)
        self.fixed_base = 1 + self.bitmap_len
        self.varlen_base = self.fixed_base + 8 * len(self.fixed_idx)
        # column position → slot number among fixed
        self._fixed_slot = {c: s for s, c in enumerate(self.fixed_idx)}
        self._string_slot = {c: s for s, c in enumerate(self.string_idx)}

    def fixed_offset(self, col: int) -> int:
        return self.fixed_base + 8 * self._fixed_slot[col]

    def string_slot(self, col: int) -> int:
        return self._string_slot[col]


def encode_row(schema: RowSchema, values: Sequence) -> bytes:
    """``values`` are *physical* values (int/float per FieldType.device_dtype)
    or None for NULL; string columns take raw ``bytes``."""
    out = bytearray([ROW_VERSION])
    bitmap = bytearray(schema.bitmap_len)
    for i, v in enumerate(values):
        if v is None:
            bitmap[i >> 3] |= 1 << (i & 7)
    out += bitmap
    for c in schema.fixed_idx:
        v = values[c]
        if v is None:
            out += b"\x00" * 8
        elif schema.ftypes[c].kind == TypeKind.FLOAT:
            out += struct.pack("<d", float(v))
        else:
            out += struct.pack("<q", int(v))
    for c in schema.string_idx:
        v = values[c]
        if v is None:
            out += struct.pack("<I", 0)
        else:
            if isinstance(v, str):
                v = v.encode("utf-8")
            out += struct.pack("<I", len(v))
            out += v
    return bytes(out)


def decode_row(schema: RowSchema, buf: bytes) -> list:
    """Single-row decode (write path read-modify, point gets)."""
    if buf[0] != ROW_VERSION:
        raise ValueError(f"bad row version {buf[0]:#x} (corrupt or foreign encoding)")
    vals: list = [None] * schema.n
    bitmap = buf[1 : 1 + schema.bitmap_len]
    off = schema.fixed_base
    for c in schema.fixed_idx:
        if not (bitmap[c >> 3] >> (c & 7)) & 1:
            if schema.ftypes[c].kind == TypeKind.FLOAT:
                vals[c] = struct.unpack_from("<d", buf, off)[0]
            else:
                vals[c] = struct.unpack_from("<q", buf, off)[0]
        off += 8
    off = schema.varlen_base
    for c in schema.string_idx:
        (ln,) = struct.unpack_from("<I", buf, off)
        off += 4
        if (bitmap[c >> 3] >> (c & 7)) & 1:
            vals[c] = None
        else:
            vals[c] = buf[off : off + ln]
        off += ln
    return vals


def decode_fixed_bulk(
    schema: RowSchema, buf: bytes, starts: np.ndarray, cols: Sequence[int]
) -> tuple[list[np.ndarray], list[np.ndarray]]:
    """Vectorized decode of fixed-width columns for many rows.

    ``buf`` is the concatenation of row values; ``starts[i]`` is the byte
    offset of row i. Returns ([data...], [validity...]) per requested col.
    """
    from tidb_tpu_torch.native.bulk import decode_fixed as native_decode_fixed

    nat = native_decode_fixed(buf, starts, schema, cols) if len(starts) else None
    if nat is not None:
        datas, valids = [], []
        for (data, valid), c in zip(nat, cols):
            if schema.ftypes[c].kind == TypeKind.FLOAT:
                data = data.view("<f8")
            datas.append(data)
            valids.append(valid)
        return datas, valids
    arr = np.frombuffer(buf, dtype=np.uint8)
    n = len(starts)
    datas, valids = [], []
    # null bitmap bytes: gather bitmap region once
    bm = arr[starts[:, None] + (1 + np.arange(schema.bitmap_len))[None, :]] if schema.bitmap_len else None
    for c in cols:
        ft = schema.ftypes[c]
        byte_idx = c >> 3
        bit = c & 7
        null = ((bm[:, byte_idx] >> bit) & 1).astype(bool) if bm is not None else np.zeros(n, bool)
        off = schema.fixed_offset(c)
        raw = arr[starts[:, None] + (off + np.arange(8))[None, :]]
        raw = np.ascontiguousarray(raw)
        if ft.kind == TypeKind.FLOAT:
            data = raw.view("<f8").ravel().astype(np.float64)
        else:
            data = raw.view("<i8").ravel().astype(np.int64)
        data = np.where(null, 0, data)
        datas.append(data)
        valids.append(~null)
    return datas, valids


def decode_strings_bulk(
    schema: RowSchema, buf: bytes, starts: np.ndarray, col: int
) -> tuple[list[bytes | None], np.ndarray]:
    """Per-row loop over the varlen section for one string column."""
    slot = schema.string_slot(col)
    out: list[bytes | None] = []
    validity = np.ones(len(starts), dtype=bool)
    for i in range(len(starts)):
        off = int(starts[i]) + schema.varlen_base
        bitmap_off = int(starts[i]) + 1
        for s in range(slot + 1):
            (ln,) = struct.unpack_from("<I", buf, off)
            off += 4
            if s == slot:
                c = schema.string_idx[s]
                if (buf[bitmap_off + (c >> 3)] >> (c & 7)) & 1:
                    out.append(None)
                    validity[i] = False
                else:
                    out.append(buf[off : off + ln])
                break
            off += ln
    return out, validity
