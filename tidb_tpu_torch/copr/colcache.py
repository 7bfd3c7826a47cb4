"""Host-side region state (port of the parts of tidb_tpu/copr/colcache.py
the binder and the engine read).

A :class:`Region` is one region's rows of one table, sorted by handle, as
decoded columns (``RegionColumns``), plus the :class:`ColumnCache` it shares
with the table's other regions: the per-(table, slot) string dictionaries —
codes are table-global, so group keys agree across regions — and the device
column LRUs. MVCC building, the delta overlay and merging are not ported;
the state arrives already decoded (``carry.region_from_arrays``).
"""

from __future__ import annotations

import threading
from dataclasses import dataclass, field

import numpy as np

from tidb_tpu_torch.utils.chunk import Dictionary

# the reference engine's device block (tidb_tpu/copr/colcache.py:45): a
# region of more rows runs as several blocks of this many padded rows
DEVICE_BLOCK_ROWS = 1 << 22


@dataclass
class RegionColumns:
    """One region's decoded rows for one table: sorted-by-handle columns."""

    handles: np.ndarray  # int64, ascending
    n: int
    # storage slot → (data, validity)
    cols: dict[int, tuple[np.ndarray, np.ndarray]] = field(default_factory=dict)
    data_version: int = 0
    # per-slot (min, max) over valid values, computed lazily
    _minmax: dict = field(default_factory=dict)

    def vtag_span(self, lo: int, hi: int) -> int:
        """Device-cache version tag for rows [lo, hi). The reference carries
        per-block tags across delta merges, so a clean block keeps its device
        arrays; with no merge ported every block of an entry shares the
        entry's own version (the reference's fallback)."""
        return self.data_version

    def minmax(self, slot: int) -> tuple[int, int]:
        mm = self._minmax.get(slot)
        if mm is None:
            d, v = self.cols[slot]
            lv = d[v]
            mm = (int(lv.min()), int(lv.max())) if lv.size else (0, 0)
            self._minmax[slot] = mm
        return mm


class ColumnCache:
    """Dictionaries and device caches shared by the regions of one store."""

    def __init__(self):
        self._mu = threading.Lock()
        self._dicts: dict[tuple[int, int], Dictionary] = {}
        self._regions: list["Region"] = []
        # bumped whenever a dictionary is compacted: device copies must drop
        self.epoch = 0
        # device string → the engine's HBM-budgeted column LRU
        self.device_lrus: dict = {}

    def dictionary(self, table_id: int, slot: int) -> Dictionary:
        with self._mu:
            return self._dicts.setdefault((table_id, slot), Dictionary())

    def ensure_sorted_dict(self, table_id: int, slot: int, ci: bool = False) -> Dictionary:
        """Rank-compact a dictionary so codes become order-preserving; remaps
        the codes of every region of this table that holds the slot."""
        if ci:
            from tidb_tpu_torch.copr.binder import UnsupportedForDevice

            raise UnsupportedForDevice("ci-collation ordering is not ported")
        with self._mu:
            dic = self._dicts.setdefault((table_id, slot), Dictionary())
            if dic.sorted:
                return dic
            remap = dic.compact()
            for r in self._regions:
                entry = r.entry
                if r.table_id == table_id and slot in entry.cols:
                    data, valid = entry.cols[slot]
                    entry.cols[slot] = (remap[data], valid)
                    entry._minmax.pop(slot, None)
            self.epoch += 1
            return dic

    def add_region(self, region: "Region") -> None:
        with self._mu:
            if any(r.region_id == region.region_id for r in self._regions):
                raise ValueError(f"region id {region.region_id} already in this cache")
            self._regions.append(region)

    def next_region_id(self) -> int:
        with self._mu:
            return 1 + max((r.region_id for r in self._regions), default=0)


@dataclass
class Region:
    """One region of one table: its key bounds, its rows and its cache."""

    region_id: int
    table_id: int
    start: bytes
    end: bytes
    entry: RegionColumns
    cache: ColumnCache
