"""ANALYZE: build table statistics in one columnar pass (ref: ANALYZE
executors + statistics/builder.go; redesigned — the engine already
materializes full columns, so stats come from vectorized numpy ops instead
of streamed samples)."""

from __future__ import annotations

import numpy as np

from tidb_tpu_torch.catalog.schema import TableInfo
from tidb_tpu_torch.statistics.histogram import build_topn_and_histogram
from tidb_tpu_torch.statistics.sketch import CMSketch, FMSketch
from tidb_tpu_torch.statistics.stats import ColumnStats, IndexStats, TableStats
from tidb_tpu_torch.types import TypeKind


def analyze_table(session, db_name: str, t: TableInfo) -> TableStats:
    """Full-table scan through the host engine → per-column TopN + histogram
    + CM/FM sketches + NDV, per-index tuple NDV."""
    from tidb_tpu_torch.copr.colcache import cache_for
    from tidb_tpu_torch.executor.executors import TableReaderExec
    from tidb_tpu_torch.kv.kv import StoreType
    from tidb_tpu_torch.planner.plans import OutCol, PhysTableReader

    cache = cache_for(session.store)
    for c in t.columns:
        if c.ftype.kind == TypeKind.STRING:
            # order-preserving codes: histograms over codes estimate string
            # ranges correctly (ref: string stats use bytes ordering). A ci
            # column's canonical order is the general_ci WEIGHT order — the
            # same order the device MIN/MAX compaction uses; requesting byte
            # order here would ping-pong full-cache remaps (and epoch bumps)
            # against every ci MIN/MAX query
            cache.ensure_sorted_dict(t.id, c.offset, ci=c.ftype.collation == "ci")
    reader = PhysTableReader(
        db=db_name,
        table=t,
        store_type=StoreType.HOST,
        scan_slots=[c.offset for c in t.columns],
        schema=[OutCol(c.name, c.ftype, slot=c.offset) for c in t.columns],
    )
    chunk = TableReaderExec(reader, session).execute()
    n = len(chunk)
    stats = TableStats(table_id=t.id, version=session.read_ts(), row_count=n)
    for c, col in zip(t.columns, chunk.columns):
        lane = col.data
        if lane.dtype != np.float64:
            lane = lane.astype(np.int64, copy=False)
        vals = lane[col.validity]
        sorted_vals = np.sort(vals)
        topn, hist = build_topn_and_histogram(sorted_vals)
        cm = CMSketch()
        fm = FMSketch()
        if len(vals):
            cm.insert_many(vals)
            fm.insert_many(vals)
        ndv = int(len(np.unique(vals)))
        stats.cols[c.offset] = ColumnStats(
            offset=c.offset,
            null_count=int(n - len(vals)),
            ndv=ndv,
            topn=topn,
            hist=hist,
            cm=cm,
            fm=fm,
            is_string=c.ftype.kind == TypeKind.STRING,
            dictionary=col.dictionary,
        )
    for idx in t.indexes:
        lanes = []
        for off in idx.column_offsets:
            pos = next(i for i, c in enumerate(t.columns) if c.offset == off)
            col = chunk.columns[pos]
            lanes.append(col.data)
            lanes.append(col.validity)
        if lanes and n:
            tuples = np.rec.fromarrays(lanes)
            ndv = int(len(np.unique(tuples)))
        else:
            ndv = 0
        fm = FMSketch()
        if lanes and n:
            # combined key-tuple hash: mergeable NDV for global-stats union
            from tidb_tpu_torch.statistics.sketch import _mix64

            h = np.zeros(n, dtype=np.uint64)
            for li, lane in enumerate(lanes[::2]):  # data lanes only
                lv = np.asarray(lane)
                if lv.dtype != np.int64:
                    lv = lv.astype(np.int64, copy=False) if lv.dtype.kind in "iub" else lv.view(np.int64)
                h ^= _mix64(lv, 0x51ED2701 + li)
            fm.insert_many(h.view(np.int64))
        stats.idxs[idx.id] = IndexStats(index_id=idx.id, ndv=ndv, fm=fm)
    return stats
