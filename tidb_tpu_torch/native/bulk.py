"""Python orchestration over the native bulk codec (see src/rowcodec.cc).

``encode_rows`` turns columnar logical data into (record keys, row values)
with one C call; ``decode_fixed`` is the inverse for the colcache build loop.
Both return None when the native library is unavailable so callers can fall
back to the pure-Python encoders.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Sequence

import numpy as np

from tidb_tpu_torch.native import lib
from tidb_tpu_torch.types import TypeKind

_KIND_INT = 0
_KIND_FLOAT = 1
_KIND_STRING = 2

_KEY_LEN = 19


def _voidp_array(ptrs: list[Optional[int]]):
    arr = (ctypes.c_void_p * len(ptrs))()
    for i, p in enumerate(ptrs):
        arr[i] = p
    return arr


def encode_rows(table, phys_cols: Sequence, handles: np.ndarray):
    """→ (keys_buf: bytes, rows_buf: bytes, row_starts: np.ndarray) or None.

    ``phys_cols[c]`` holds *physical* values: np.int64/np.float64 arrays, or
    Python lists with None for NULLs (fixed kinds), or lists of bytes/None
    (string kinds) — the same inputs executor.load feeds encode_row.
    """
    lb = lib()
    if lb is None:
        return None
    n = len(handles)
    ncols = len(table.columns)
    kinds = (ctypes.c_int32 * ncols)()
    data_ptrs: list[Optional[int]] = [None] * ncols
    null_ptrs: list[Optional[int]] = [None] * ncols
    soff_ptrs: list[Optional[int]] = [None] * ncols
    keep = []  # keep numpy temporaries alive across the C calls

    for c, col in enumerate(table.columns):
        k = col.ftype.kind
        vals = phys_cols[c]
        if k in (TypeKind.STRING, TypeKind.JSON):
            kinds[c] = _KIND_STRING
            nulls = np.fromiter((1 if v is None else 0 for v in vals), dtype=np.uint8, count=n)
            lens = np.fromiter((0 if v is None else len(v) for v in vals), dtype=np.int64, count=n)
            offs = np.zeros(n + 1, dtype=np.int64)
            np.cumsum(lens, out=offs[1:])
            blob = b"".join(v for v in vals if v is not None)
            blob_arr = np.frombuffer(blob, dtype=np.uint8) if blob else np.zeros(1, dtype=np.uint8)
            keep += [nulls, offs, blob_arr]
            data_ptrs[c] = blob_arr.ctypes.data
            soff_ptrs[c] = offs.ctypes.data
            if nulls.any():
                null_ptrs[c] = nulls.ctypes.data
        else:
            kinds[c] = _KIND_FLOAT if k == TypeKind.FLOAT else _KIND_INT
            if isinstance(vals, np.ndarray):
                arr = vals.astype(np.float64 if k == TypeKind.FLOAT else np.int64, copy=False)
                nulls = None
            else:
                nulls = np.fromiter((1 if v is None else 0 for v in vals), dtype=np.uint8, count=n)
                dt = np.float64 if k == TypeKind.FLOAT else np.int64
                arr = np.fromiter((0 if v is None else v for v in vals), dtype=dt, count=n)
                if not nulls.any():
                    nulls = None
            arr = np.ascontiguousarray(arr)  # BEFORE keep: the copy must outlive the C call
            keep.append(arr)
            data_ptrs[c] = arr.ctypes.data
            if nulls is not None:
                keep.append(nulls)
                null_ptrs[c] = nulls.ctypes.data

    null_arr = _voidp_array(null_ptrs)
    soff_arr = _voidp_array(soff_ptrs)
    data_arr = _voidp_array(data_ptrs)

    row_starts = np.zeros(n + 1, dtype=np.int64)
    total = lb.tpu_encode_rows_size(
        n, ncols, kinds, null_arr, soff_arr, row_starts.ctypes.data
    )
    rows_buf = np.zeros(max(int(total), 1), dtype=np.uint8)
    keys_buf = np.zeros(max(n * _KEY_LEN, 1), dtype=np.uint8)
    h = np.ascontiguousarray(np.asarray(handles, dtype=np.int64))
    lb.tpu_encode_rows(
        n,
        ncols,
        kinds,
        data_arr,
        null_arr,
        soff_arr,
        row_starts.ctypes.data,
        rows_buf.ctypes.data,
        int(table.id),
        h.ctypes.data,
        keys_buf.ctypes.data,
    )
    return keys_buf.tobytes(), rows_buf.tobytes(), row_starts


def split_encoded(keys_buf: bytes, rows_buf: bytes, row_starts: np.ndarray):
    """Yield (key, value) pairs out of the packed native buffers."""
    n = len(row_starts) - 1
    for r in range(n):
        yield (
            keys_buf[r * _KEY_LEN : (r + 1) * _KEY_LEN],
            rows_buf[row_starts[r] : row_starts[r + 1]],
        )


def decode_fixed(buf: bytes, starts: np.ndarray, schema, cols: Sequence[int]):
    """Native bulk decode of fixed columns → [(int64 data, bool valid)] per
    requested column, or None when the library is unavailable."""
    lb = lib()
    if lb is None:
        return None
    n = len(starts)
    nreq = len(cols)
    cols_arr = (ctypes.c_int32 * nreq)(*[int(c) for c in cols])
    offs_arr = (ctypes.c_int32 * nreq)(*[schema.fixed_offset(int(c)) for c in cols])
    outs = [np.zeros(n, dtype=np.int64) for _ in range(nreq)]
    valids = [np.zeros(n, dtype=np.uint8) for _ in range(nreq)]
    out_ptrs = _voidp_array([o.ctypes.data for o in outs])
    val_ptrs = _voidp_array([v.ctypes.data for v in valids])
    b = np.frombuffer(buf, dtype=np.uint8) if buf else np.zeros(1, dtype=np.uint8)
    s = np.ascontiguousarray(np.asarray(starts, dtype=np.int64))
    lb.tpu_decode_fixed(
        n, b.ctypes.data, s.ctypes.data, nreq, cols_arr, offs_arr, out_ptrs, val_ptrs
    )
    return [(o, v.astype(bool)) for o, v in zip(outs, valids)]
