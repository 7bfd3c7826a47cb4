"""Columnar result format (port of tidb_tpu/utils/chunk.py).

A ``Column`` is a fixed-width numpy lane plus a validity mask; strings are
int32 codes against a ``Dictionary``. A ``Chunk`` is a list of equal-length
Columns. Results leave the device as numpy arrays, so the same host-side
format serves the CPU and the GPU paths.
"""

from __future__ import annotations

import threading
from dataclasses import dataclass, field
from typing import Sequence

import numpy as np

from tidb_tpu_torch.types import TypeKind
from tidb_tpu_torch.types.datum import days_to_date, micros_to_datetime, micros_to_duration
from tidb_tpu_torch.types.field_type import FieldType


class Dictionary:
    """Append-only bytes→code dictionary.

    Codes are dense int32 from 0. After ``compact()`` the dictionary is
    sorted and codes are order-preserving (rank == code), which legalizes
    device-side string comparisons; an out-of-order append clears
    ``sorted`` again.
    """

    __slots__ = ("_values", "_index", "sorted", "_mu")

    def __init__(self, values: Sequence[bytes] = ()):
        self._values: list[bytes] = list(values)
        self._index: dict[bytes, int] = {v: i for i, v in enumerate(self._values)}
        if len(self._index) != len(self._values):
            raise ValueError("dictionary values must be distinct")
        self.sorted = self._values == sorted(self._values)
        self._mu = threading.Lock()

    def __len__(self) -> int:
        return len(self._values)

    def encode(self, value: "bytes | str") -> int:
        if isinstance(value, str):
            value = value.encode("utf-8")
        code = self._index.get(value)
        if code is not None:
            return code
        with self._mu:
            code = self._index.get(value)
            if code is None:
                code = len(self._values)
                self._values.append(value)
                self._index[value] = code
                if self.sorted and code > 0 and self._values[code - 1] > value:
                    self.sorted = False
        return code

    def try_encode(self, value: "bytes | str") -> int:
        """Code of ``value`` or -1 when absent (a constant that names no
        stored value can never match)."""
        if isinstance(value, str):
            value = value.encode("utf-8")
        return self._index.get(value, -1)

    def decode(self, code: int) -> bytes:
        return self._values[code]

    def values_array(self) -> list[bytes]:
        return list(self._values)

    def compact(self) -> np.ndarray:
        """Sort values by bytes; return the old-code→new-code remap."""
        order = sorted(range(len(self._values)), key=lambda i: self._values[i])
        remap = np.empty(len(order), dtype=np.int32)
        for new, old in enumerate(order):
            remap[old] = new
        self._values = [self._values[i] for i in order]
        self._index = {v: i for i, v in enumerate(self._values)}
        self.sorted = True
        return remap


@dataclass
class Column:
    """Fixed-width data lane + validity mask (+ dictionary for strings)."""

    data: np.ndarray
    validity: np.ndarray  # bool, True = not NULL
    ftype: FieldType
    dictionary: Dictionary | None = None

    def __post_init__(self):
        if self.data.shape != self.validity.shape:
            raise ValueError(
                f"data/validity length mismatch: {self.data.shape} vs {self.validity.shape}"
            )

    def __len__(self) -> int:
        return len(self.data)

    def logical_value(self, i: int):
        """Decode row i back to a logical Python value."""
        if not self.validity[i]:
            return None
        v = self.data[i]
        k = self.ftype.kind
        if k == TypeKind.STRING:
            return self.dictionary.decode(int(v)).decode("utf-8", "replace")
        if k == TypeKind.DECIMAL:
            s = self.ftype.scale
            iv = int(v)
            if s == 0:
                return iv
            from decimal import Decimal

            # scaleb keeps the declared scale (5.00, not 5) like MySQL
            return Decimal(iv).scaleb(-s)
        if k == TypeKind.DATE:
            return days_to_date(int(v))
        if k == TypeKind.DATETIME:
            return micros_to_datetime(int(v))
        if k == TypeKind.DURATION:
            return micros_to_duration(int(v))
        if k == TypeKind.FLOAT:
            return float(v)
        if k == TypeKind.UINT and v < 0:
            return int(v) + (1 << 64)  # undo two's complement wrap
        return int(v)

    @staticmethod
    def concat(cols: Sequence["Column"]) -> "Column":
        if not cols:
            raise ValueError("Column.concat of an empty sequence")
        first = cols[0]
        # raw codes concatenate only under one shared dictionary object
        for c in cols[1:]:
            if c.dictionary is not first.dictionary:
                raise ValueError("concat across dictionaries requires re-encode")
        return Column(
            np.concatenate([c.data for c in cols]),
            np.concatenate([c.validity for c in cols]),
            first.ftype,
            first.dictionary,
        )


@dataclass
class Chunk:
    """Equal-length list of Columns (ref: chunk.Chunk)."""

    columns: list[Column] = field(default_factory=list)

    def __len__(self) -> int:
        return len(self.columns[0]) if self.columns else 0

    def row(self, i: int) -> tuple:
        return tuple(c.logical_value(i) for c in self.columns)

    def rows(self) -> list[tuple]:
        return [self.row(i) for i in range(len(self))]

    @staticmethod
    def concat(chunks: Sequence["Chunk"]) -> "Chunk":
        if not chunks:
            raise ValueError("Chunk.concat of an empty sequence")
        ncols = len(chunks[0].columns)
        return Chunk([Column.concat([ch.columns[i] for ch in chunks]) for i in range(ncols)])


_MIN_BUCKET = 1024


def bucket_size(n: int) -> int:
    """Smallest power of two ≥ n (min 1024): the padded row count of a
    region's device arrays, so one program serves a size class."""
    b = _MIN_BUCKET
    while b < n:
        b <<= 1
    return b
