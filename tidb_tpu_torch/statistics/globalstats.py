"""Partition global-stats merge (ref: pkg/statistics/handle/globalstats/
global_stats.go) — per-partition ANALYZE results combine into ONE
table-level TableStats so partitioned plans cost with table-level NDV and
row counts instead of per-partition guesses.

Merge rules mirror the reference: row/null counts add; NDV unions through
the FM sketches (never adds — repeated values across partitions must not
double-count); CM sketches add element-wise (same dimensions by
construction); TopN entries sum per value with evicted remainders folded
back into the histogram mass; histograms merge by bucket concatenation and
equi-depth re-compression.
"""

from __future__ import annotations

import numpy as np

from tidb_tpu_torch.statistics.histogram import Histogram, TopN
from tidb_tpu_torch.statistics.sketch import CMSketch, FMSketch
from tidb_tpu_torch.statistics.stats import ColumnStats, IndexStats, TableStats

_N_TOP = 20
_N_BUCKETS = 64


def _merge_topn(parts: list[ColumnStats]) -> tuple[TopN, list[tuple[int, int]]]:
    """Sum per-value TopN counts across partitions; keep the heaviest
    ``_N_TOP``. Returns (merged TopN, evicted (value, count) remainders that
    must fold into the histogram so total row mass is conserved)."""
    acc: dict = {}
    for cs in parts:
        for v, c in zip(cs.topn.values, cs.topn.counts):
            key = v.item()  # native python value: float lanes keep floats
            acc[key] = acc.get(key, 0) + int(c)
    if not acc:
        return TopN(), []
    items = sorted(acc.items(), key=lambda kv: -kv[1])
    kept, evicted = items[:_N_TOP], items[_N_TOP:]
    vals = np.asarray([v for v, _ in kept])
    cnts = np.array([c for _, c in kept], dtype=np.int64)
    return TopN(vals, cnts), evicted


def _merge_hists(parts: list[ColumnStats], evicted: list[tuple[int, int]]) -> Histogram:
    """Concatenate every partition's buckets (plus TopN-evicted point
    masses), sort by bound, and re-compress into equi-depth buckets."""
    spans: list[tuple[float, float, int, int]] = []  # (lower, upper, count, repeats)
    for cs in parts:
        h = cs.hist
        prev = 0
        for i in range(h.num_buckets):
            cnt = int(h.cum_counts[i]) - prev
            prev = int(h.cum_counts[i])
            spans.append((float(h.lowers[i]), float(h.uppers[i]), cnt, int(h.repeats[i])))
    for v, c in evicted:
        spans.append((float(v), float(v), c, c))
    if not spans:
        empty = np.empty(0, np.int64)
        return Histogram(empty, empty, empty, empty, 0)
    spans.sort(key=lambda s: (s[1], s[0]))
    total = sum(s[2] for s in spans)
    depth = max(total // _N_BUCKETS, 1)
    lowers, uppers, cums, reps = [], [], [], []
    cur_lo, cur_hi, cur_cnt, cur_rep = spans[0][0], spans[0][1], 0, 0
    cum = 0
    for lo, hi, cnt, rep in spans:
        cur_cnt += cnt
        cur_hi = max(cur_hi, hi)
        cur_rep = rep  # repeats of the (current) upper bound
        if cur_cnt >= depth:
            cum += cur_cnt
            lowers.append(cur_lo)
            uppers.append(cur_hi)
            cums.append(cum)
            reps.append(cur_rep)
            cur_lo, cur_cnt, cur_rep = cur_hi, 0, 0
    if cur_cnt:
        cum += cur_cnt
        lowers.append(cur_lo)
        uppers.append(max(cur_hi, lowers[-1]))
        cums.append(cum)
        reps.append(cur_rep)
    ndv = sum(cs.hist.ndv for cs in parts)  # upper bound; FM refines col NDV
    return Histogram(
        np.asarray(lowers), np.asarray(uppers),
        np.asarray(cums, dtype=np.int64), np.asarray(reps, dtype=np.int64), ndv,
    )


def merge_global_stats(logical_id: int, version: int, parts: list[TableStats]) -> TableStats:
    """Per-partition TableStats → table-level global stats."""
    out = TableStats(
        table_id=logical_id,
        version=version,
        row_count=sum(p.row_count for p in parts),
    )
    offsets = sorted({off for p in parts for off in p.cols})
    for off in offsets:
        col_parts = [p.cols[off] for p in parts if off in p.cols]
        fm = FMSketch()
        for cs in col_parts:
            fm.merge(cs.fm)
        cm = CMSketch()
        for cs in col_parts:
            if cs.cm.table.shape == cm.table.shape:
                cm.table += cs.cm.table
                cm.count += cs.cm.count
        topn, evicted = _merge_topn(col_parts)
        hist = _merge_hists(col_parts, evicted)
        # FM union is the authoritative NDV (adding per-partition NDVs would
        # double-count values present in several partitions); exact
        # per-partition NDVs lower-bound it
        ndv = max(fm.ndv(), max((cs.ndv for cs in col_parts), default=0))
        ndv = min(ndv, out.row_count) if out.row_count else ndv
        hist.ndv = min(hist.ndv, max(ndv - len(topn.values), 0)) or hist.ndv
        out.cols[off] = ColumnStats(
            offset=off,
            null_count=sum(cs.null_count for cs in col_parts),
            ndv=ndv,
            topn=topn,
            hist=hist,
            cm=cm,
            fm=fm,
            is_string=col_parts[0].is_string,
            dictionary=col_parts[0].dictionary,
        )
    idx_ids = sorted({iid for p in parts for iid in p.idxs})
    for iid in idx_ids:
        idx_parts = [p.idxs[iid] for p in parts if iid in p.idxs]
        fm = FMSketch()
        have_fm = all(getattr(ip, "fm", None) is not None for ip in idx_parts)
        if have_fm:
            for ip in idx_parts:
                fm.merge(ip.fm)
            ndv = max(fm.ndv(), max(ip.ndv for ip in idx_parts))
        else:
            # no sketches: the union is between max (all overlap) and sum
            # (disjoint); cap by row count
            ndv = min(sum(ip.ndv for ip in idx_parts), out.row_count)
        out.idxs[iid] = IndexStats(index_id=iid, ndv=min(ndv, out.row_count), fm=fm if have_fm else None)
    return out
