"""Equi-depth histogram + TopN (ref: pkg/statistics/histogram.go,
cmsketch.go TopN). Built in one vectorized pass over a SORTED physical lane
(int64 or float64; strings use order-preserving dictionary codes)."""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np


@dataclass
class TopN:
    """Most frequent values with exact counts (ref: statistics.TopN)."""

    values: np.ndarray = field(default_factory=lambda: np.empty(0, np.int64))
    counts: np.ndarray = field(default_factory=lambda: np.empty(0, np.int64))

    def count_of(self, v) -> int | None:
        hit = np.nonzero(self.values == v)[0]
        return int(self.counts[hit[0]]) if len(hit) else None

    @property
    def total(self) -> int:
        return int(self.counts.sum()) if len(self.counts) else 0


@dataclass
class Histogram:
    """Equi-depth buckets over values NOT covered by the TopN. Bounds are
    physical lane values; cumulative counts like the reference's buckets."""

    lowers: np.ndarray  # per-bucket lower bound
    uppers: np.ndarray  # per-bucket upper bound (inclusive)
    cum_counts: np.ndarray  # cumulative row count through each bucket
    repeats: np.ndarray  # occurrences of each bucket's upper bound
    ndv: int = 0  # distinct values across the histogram

    @property
    def total(self) -> int:
        return int(self.cum_counts[-1]) if len(self.cum_counts) else 0

    @property
    def num_buckets(self) -> int:
        return len(self.uppers)

    def est_eq(self, v) -> float:
        if self.total == 0 or self.ndv == 0:
            return 0.0
        i = int(np.searchsorted(self.uppers, v))
        if i >= len(self.uppers) or v < self.lowers[i]:
            return 0.0  # falls between buckets / outside range
        if v == self.uppers[i]:
            return float(self.repeats[i])
        return float(self.total) / self.ndv

    def est_range(self, lo, hi, lo_incl: bool, hi_incl: bool) -> float:
        """Rows in [lo, hi] with open/closed bounds; None = unbounded."""
        if self.total == 0:
            return 0.0
        left = self._cum_below(lo, include_eq=not lo_incl) if lo is not None else 0.0
        right = (
            self._cum_below(hi, include_eq=hi_incl)
            if hi is not None
            else float(self.total)
        )
        return max(right - left, 0.0)

    def _cum_below(self, v, include_eq: bool) -> float:
        """Estimated #rows with value < v (or <= v when include_eq)."""
        if len(self.uppers) == 0:
            return 0.0
        i = int(np.searchsorted(self.uppers, v))
        if i >= len(self.uppers):
            return float(self.total)
        prev = float(self.cum_counts[i - 1]) if i > 0 else 0.0
        lo_b, hi_b = float(self.lowers[i]), float(self.uppers[i])
        in_bucket = float(self.cum_counts[i]) - prev - float(self.repeats[i])
        fv = float(v)
        if fv < lo_b:
            return prev
        if fv >= hi_b:
            return prev + in_bucket + (float(self.repeats[i]) if include_eq else 0.0)
        frac = (fv - lo_b) / (hi_b - lo_b) if hi_b > lo_b else 0.0
        return prev + in_bucket * frac


def build_topn_and_histogram(
    sorted_vals: np.ndarray, n_top: int = 20, n_buckets: int = 64
) -> tuple[TopN, Histogram]:
    """One pass over a sorted non-null lane: exact value/run-length stats →
    TopN of the heaviest values, equi-depth histogram over the rest
    (ref: BuildHistAndTopN, statistics/builder.go)."""
    n = len(sorted_vals)
    if n == 0:
        empty = np.empty(0, np.int64)
        return TopN(), Histogram(empty, empty, empty, empty, 0)
    # run-length encode the sorted lane
    change = np.empty(n, dtype=bool)
    change[0] = True
    change[1:] = sorted_vals[1:] != sorted_vals[:-1]
    starts = np.flatnonzero(change)
    uniq = sorted_vals[starts]
    counts = np.diff(np.r_[starts, n])
    # TopN: values strictly more frequent than the average make the cut
    k = min(n_top, len(uniq))
    if k > 0:
        top_idx = np.argpartition(counts, -k)[-k:]
        avg = n / len(uniq)
        top_idx = top_idx[counts[top_idx] > max(avg, 1)]
    else:
        top_idx = np.empty(0, np.int64)
    top_mask = np.zeros(len(uniq), dtype=bool)
    top_mask[top_idx] = True
    order = np.argsort(-counts[top_idx], kind="stable") if len(top_idx) else []
    topn = TopN(uniq[top_idx][order].copy(), counts[top_idx][order].copy())
    rest_vals = uniq[~top_mask]
    rest_counts = counts[~top_mask]
    if len(rest_vals) == 0:
        empty = np.empty(0, np.int64)
        return topn, Histogram(empty, empty, empty, empty, 0)
    # equi-depth bucketing over remaining (value, count) runs
    nb = min(n_buckets, len(rest_vals))
    total_rest = int(rest_counts.sum())
    target = max(total_rest / nb, 1.0)
    cum = np.cumsum(rest_counts)
    bucket_of = np.minimum((cum - 1) // target, nb - 1).astype(np.int64)
    # bucket boundaries where bucket id changes
    bchange = np.empty(len(rest_vals), dtype=bool)
    bchange[0] = True
    bchange[1:] = bucket_of[1:] != bucket_of[:-1]
    bstarts = np.flatnonzero(bchange)
    bends = np.r_[bstarts[1:], len(rest_vals)] - 1
    lowers = rest_vals[bstarts].copy()
    uppers = rest_vals[bends].copy()
    cum_counts = cum[bends].copy()
    repeats = rest_counts[bends].copy()
    return topn, Histogram(lowers, uppers, cum_counts, repeats, ndv=len(rest_vals))
