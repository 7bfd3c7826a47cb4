"""Stats containers + in-memory stats cache (ref: statistics.Table,
handle.Handle — the cache/loader; SURVEY §2.4)."""

from __future__ import annotations

import threading
from dataclasses import dataclass, field
from typing import Optional

from tidb_tpu_torch.statistics.histogram import Histogram, TopN
from tidb_tpu_torch.statistics.sketch import CMSketch, FMSketch


@dataclass
class ColumnStats:
    offset: int  # storage slot
    null_count: int
    ndv: int
    topn: TopN
    hist: Histogram
    cm: CMSketch
    fm: FMSketch
    # string columns estimate over sorted-dictionary codes
    is_string: bool = False
    dictionary: object = None  # the sorted Dictionary codes refer to

    def est_eq(self, v, total_rows: int) -> float:
        c = self.topn.count_of(v)
        if c is not None:
            return float(c)
        h = self.hist.est_eq(v)
        if h > 0:
            return h
        if self.ndv > 0:
            return max(total_rows / self.ndv, 1.0)
        return 0.0


@dataclass
class IndexStats:
    index_id: int
    ndv: int  # distinct full-tuple count
    # FM sketch over combined key-tuple hashes: the mergeable NDV carrier
    # for partition global-stats union (ref: globalstats index merge)
    fm: object = None


@dataclass
class TableStats:
    table_id: int
    version: int  # commit ts the snapshot was read at
    row_count: int
    cols: dict[int, ColumnStats] = field(default_factory=dict)
    idxs: dict[int, IndexStats] = field(default_factory=dict)


STATS_KEY_PREFIX = b"m:stats:"


class StatsHandle:
    """Per-DB stats cache + modification counters driving auto-analyze
    (ref: handle.Handle + autoanalyze.go). With a store attached, ANALYZE
    results PERSIST under ``m:stats:<table_id>`` and cache misses trigger an
    ASYNC background load (ref: handle/syncload/stats_syncload.go) — the
    first query after a restart plans on pseudo stats, the next on the
    loaded real ones; ``load_sync`` is the blocking variant."""

    _REPROBE_S = 10.0  # at most one store probe per table per this window

    def __init__(self):
        self._mu = threading.Lock()
        self._tables: dict[int, TableStats] = {}
        self._mod_counts: dict[int, int] = {}
        self.auto_analyze_ratio = 0.5  # ref: tidb_auto_analyze_ratio default
        # bumped on every stats change; plan caches key on it so ANALYZE
        # invalidates cached access-path choices
        self.version = 0
        self._store = None
        self._dict_resolver = None
        self._probed: dict[int, float] = {}  # table_id → monotonic probe time
        self._loading: set[int] = set()

    def attach_store(self, store, dict_resolver=None) -> None:
        self._store = store
        self._dict_resolver = dict_resolver

    def get(self, table_id: int) -> Optional[TableStats]:
        with self._mu:
            got = self._tables.get(table_id)
            if got is not None or self._store is None:
                return got
            import time as _t

            now = _t.monotonic()
            if table_id in self._loading or now - self._probed.get(table_id, -1e9) < self._REPROBE_S:
                return None
            self._probed[table_id] = now
            self._loading.add(table_id)
        threading.Thread(
            target=self._load_bg, args=(table_id,), daemon=True, name=f"stats-load-{table_id}"
        ).start()
        return None

    def _load_bg(self, table_id: int) -> None:
        try:
            self.load_sync(table_id)
        # missing/corrupt persisted stats: stay on pseudo stats — the
        # planner's documented degraded mode, re-probed on the next miss
        except Exception:  # graftcheck: off=except-swallow
            pass
        finally:
            with self._mu:
                self._loading.discard(table_id)

    def load_sync(self, table_id: int) -> Optional[TableStats]:
        """Blocking load from the store (the reference's sync-load path)."""
        if self._store is None:
            return self.get(table_id)
        raw = self._store.raw_get(STATS_KEY_PREFIX + str(table_id).encode())
        if raw is None:
            return None
        st = _stats_from_pb(raw)
        if self._dict_resolver is not None:
            # string histograms/TopN live in sorted-dictionary CODE space;
            # re-attach the table's dictionary so string predicates estimate
            # against real stats after a restart (codes are value-ordered
            # ranks, deterministic for unchanged data — the same staleness
            # class as the stats themselves)
            for cs in st.cols.values():
                if cs.is_string:
                    try:
                        cs.dictionary = self._dict_resolver(table_id, cs.offset)
                    # no dictionary (column never decoded on this node):
                    # string estimates fall back to containment heuristics
                    except Exception:  # graftcheck: off=except-swallow
                        pass
        with self._mu:
            if table_id in self._tables:
                # an in-process put() (ANALYZE) raced the background load:
                # the freshly-computed stats win over the persisted blob
                return self._tables[table_id]
            self._tables[table_id] = st
            self.version += 1
        return st

    def put(self, stats: TableStats) -> None:
        with self._mu:
            self._tables[stats.table_id] = stats
            self._mod_counts[stats.table_id] = 0
            self.version += 1
        if self._store is not None:
            try:
                self._store.raw_put(
                    STATS_KEY_PREFIX + str(stats.table_id).encode(), _stats_to_pb(stats)
                )
            except ConnectionError:
                pass  # cache stays warm; persistence catches up next ANALYZE

    def drop(self, table_id: int) -> None:
        with self._mu:
            self._tables.pop(table_id, None)
            self._mod_counts.pop(table_id, None)
            self.version += 1
        if self._store is not None and hasattr(self._store, "raw_delete"):
            try:
                self._store.raw_delete(STATS_KEY_PREFIX + str(table_id).encode())
            except ConnectionError:
                pass

    def note_mods(self, table_id: int, n: int) -> None:
        """DML bumps the modify counter (ref: stats delta dumping)."""
        with self._mu:
            self._mod_counts[table_id] = self._mod_counts.get(table_id, 0) + n

    def needs_analyze(self, table_id: int) -> bool:
        with self._mu:
            st = self._tables.get(table_id)
            mods = self._mod_counts.get(table_id, 0)
        if st is None:
            return mods > 0
        base = max(st.row_count, 1)
        return mods / base >= self.auto_analyze_ratio

    def stale_tables(self) -> list[int]:
        with self._mu:
            ids = set(self._mod_counts) | set(self._tables)
        return [tid for tid in ids if self.needs_analyze(tid)]


# -- persistence codec (ref: stats stored in mysql.stats_* system tables;
# here one JSON blob per table under m:stats:<id>) -------------------------
def _stats_to_pb(st: TableStats) -> bytes:
    import json

    import numpy as np

    def arr(a):
        return np.asarray(a).tolist()

    cols = {}
    for off, cs in st.cols.items():
        cols[str(off)] = {
            "null": cs.null_count,
            "ndv": cs.ndv,
            "topn": [arr(cs.topn.values), arr(cs.topn.counts)],
            "hist": [
                arr(cs.hist.lowers), arr(cs.hist.uppers),
                arr(cs.hist.cum_counts), arr(cs.hist.repeats), cs.hist.ndv,
            ],
            "cm": [cs.cm.depth, cs.cm.width, cs.cm.count, arr(cs.cm.table.reshape(-1))],
            "fm": [int(cs.fm.mask), sorted(cs.fm.hashset), cs.fm.max_size],
            "str": cs.is_string,
        }
    idxs = {
        str(iid): {
            "ndv": ix.ndv,
            "fm": [int(ix.fm.mask), sorted(ix.fm.hashset), ix.fm.max_size] if ix.fm is not None else None,
        }
        for iid, ix in st.idxs.items()
    }
    return json.dumps(
        {"tid": st.table_id, "ver": st.version, "rows": st.row_count, "cols": cols, "idxs": idxs}
    ).encode()


def _stats_from_pb(raw: bytes) -> TableStats:
    import json

    import numpy as np

    pb = json.loads(raw.decode())
    st = TableStats(table_id=pb["tid"], version=pb["ver"], row_count=pb["rows"])
    for off_s, c in pb["cols"].items():
        lowers, uppers, cums, reps, hndv = c["hist"]
        depth, width, ccount, flat = c["cm"]
        cm = CMSketch(depth, width)
        cm.table = np.asarray(flat, dtype=np.int64).reshape(depth, width)
        cm.count = ccount
        fmask, fset, fmax = c["fm"]
        fm = FMSketch(fmax)
        fm.mask = np.uint64(fmask)
        fm.hashset = set(fset)
        st.cols[int(off_s)] = ColumnStats(
            offset=int(off_s),
            null_count=c["null"],
            ndv=c["ndv"],
            topn=TopN(np.asarray(c["topn"][0]), np.asarray(c["topn"][1], np.int64)),
            hist=Histogram(
                np.asarray(lowers), np.asarray(uppers),
                np.asarray(cums, np.int64), np.asarray(reps, np.int64), hndv,
            ),
            cm=cm,
            fm=fm,
            is_string=c["str"],
            dictionary=None,  # re-resolved lazily from the column cache
        )
    for iid_s, ix in pb["idxs"].items():
        fm = None
        if ix["fm"] is not None:
            fmask, fset, fmax = ix["fm"]
            fm = FMSketch(fmax)
            fm.mask = np.uint64(fmask)
            fm.hashset = set(fset)
        st.idxs[int(iid_s)] = IndexStats(index_id=int(iid_s), ndv=ix["ndv"], fm=fm)
    return st
