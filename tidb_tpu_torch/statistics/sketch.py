"""Count-min and Flajolet-Martin sketches (ref: pkg/statistics/cmsketch.go,
fmsketch.go) — vectorized over int64 value lanes."""

from __future__ import annotations

import numpy as np

# 64-bit mix constants (splitmix64 finalizer)
_M1 = np.uint64(0xBF58476D1CE4E5B9)
_M2 = np.uint64(0x94D049BB133111EB)


def _mix64(x: np.ndarray, seed: int) -> np.ndarray:
    v = x.astype(np.int64).view(np.uint64) + np.uint64(seed)
    v ^= v >> np.uint64(30)
    v *= _M1
    v ^= v >> np.uint64(27)
    v *= _M2
    v ^= v >> np.uint64(31)
    return v


class CMSketch:
    """Count-min sketch over int64 lanes (decimal/date/string-code values all
    have an int64 physical form; floats hash their bit pattern)."""

    def __init__(self, depth: int = 5, width: int = 2048):
        self.depth = depth
        self.width = width
        self.table = np.zeros((depth, width), dtype=np.int64)
        self.count = 0

    def insert_many(self, values: np.ndarray) -> None:
        v = values if values.dtype == np.int64 else values.view(np.int64)
        self.count += len(v)
        for d in range(self.depth):
            idx = (_mix64(v, d * 0x9E3779B9 + 1) % np.uint64(self.width)).astype(np.int64)
            np.add.at(self.table[d], idx, 1)

    def query(self, value: int | float) -> int:
        v = np.array([value])
        v = v if v.dtype == np.int64 else v.astype(np.int64) if v.dtype.kind == "i" else np.array([value], dtype=np.float64).view(np.int64)
        est = min(
            int(self.table[d][int(_mix64(v, d * 0x9E3779B9 + 1)[0] % np.uint64(self.width))])
            for d in range(self.depth)
        )
        return est


class FMSketch:
    """Flajolet-Martin distinct-count sketch (ref: fmsketch.go). Used when
    merging per-shard ANALYZE results where exact NDV union is unavailable."""

    def __init__(self, max_size: int = 1024):
        self.max_size = max_size
        self.mask = np.uint64(0)
        self.hashset: set[int] = set()

    def insert_many(self, values: np.ndarray) -> None:
        v = values if values.dtype == np.int64 else values.view(np.int64)
        h = _mix64(v, 0x1234567)
        for x in h:
            x = np.uint64(x)
            if x & self.mask == 0:
                self.hashset.add(int(x))
                if len(self.hashset) > self.max_size:
                    self.mask = (self.mask << np.uint64(1)) | np.uint64(1)
                    self.hashset = {y for y in self.hashset if np.uint64(y) & self.mask == 0}

    def ndv(self) -> int:
        return (int(self.mask) + 1) * len(self.hashset)

    def merge(self, other: "FMSketch") -> None:
        mask = max(self.mask, other.mask)
        merged = {y for y in (self.hashset | other.hashset) if np.uint64(y) & mask == 0}
        while len(merged) > self.max_size:
            mask = (mask << np.uint64(1)) | np.uint64(1)
            merged = {y for y in merged if np.uint64(y) & mask == 0}
        self.mask, self.hashset = mask, merged
