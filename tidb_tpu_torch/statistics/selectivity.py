"""Selectivity estimation from table stats (ref: planner/cardinality —
Selectivity(), pseudo rates from statistics.PseudoTable)."""

from __future__ import annotations

import datetime

import numpy as np

from tidb_tpu_torch.expression.expr import ColumnRef, Constant, Expression, ScalarFunc
from tidb_tpu_torch.statistics.stats import ColumnStats, TableStats
from tidb_tpu_torch.types import TypeKind
from tidb_tpu_torch.types.datum import date_to_days, datetime_to_micros

# ref: statistics pseudo rates (pseudoEqualRate etc.)
PSEUDO_EQ = 1 / 1000
PSEUDO_LESS = 1 / 3
PSEUDO_BETWEEN = 1 / 40
DEFAULT_SEL = 0.8  # planner's SelectionFactor


def estimate_selectivity(conds: list[Expression], schema, stats: TableStats | None) -> float:
    """Fraction of rows satisfying all ``conds``. ``schema`` maps ColumnRef
    index → OutCol (for the storage slot); independence assumed across
    conjuncts like the reference's default path."""
    sel = 1.0
    for c in conds:
        sel *= _cond_sel(c, schema, stats)
    return min(max(sel, 0.0), 1.0)


def _col_stats(ref: ColumnRef, schema, stats: TableStats | None) -> ColumnStats | None:
    if stats is None or ref.index >= len(schema):
        return None
    return stats.cols.get(schema[ref.index].slot)


def _phys(value, ftype, cs: ColumnStats | None):
    """Logical constant → physical lane value; None when unmappable and
    ("miss", rank) when a string constant is absent from the dictionary."""
    if value is None:
        return None
    k = ftype.kind
    try:
        if k == TypeKind.DECIMAL:
            return int(round(float(value) * (10**ftype.scale)))
        if k == TypeKind.DATE:
            return date_to_days(value) if not isinstance(value, (int, np.integer)) else int(value)
        if k == TypeKind.DATETIME:
            return (
                datetime_to_micros(value)
                if isinstance(value, (str, datetime.datetime))
                else int(value)
            )
        if k == TypeKind.STRING:
            if cs is None or cs.dictionary is None:
                return None
            code = cs.dictionary.try_encode(value)
            if code >= 0:
                return code
            return ("miss", cs.dictionary.rank_lower(value))
        if k == TypeKind.FLOAT:
            return float(value)
        return int(value)
    except (TypeError, ValueError):
        return None


def _cond_sel(c: Expression, schema, stats: TableStats | None) -> float:
    total = stats.row_count if stats is not None else 0
    if isinstance(c, Constant):
        return 1.0 if c.value else 0.0
    if not isinstance(c, ScalarFunc):
        return DEFAULT_SEL
    sig = c.sig
    if sig == "and":
        return _cond_sel(c.args[0], schema, stats) * _cond_sel(c.args[1], schema, stats)
    if sig == "or":
        a = _cond_sel(c.args[0], schema, stats)
        b = _cond_sel(c.args[1], schema, stats)
        return min(a + b - a * b, 1.0)
    if sig == "not":
        return 1.0 - _cond_sel(c.args[0], schema, stats)
    if sig == "isnull":
        ref = c.args[0]
        if isinstance(ref, ColumnRef):
            cs = _col_stats(ref, schema, stats)
            if cs is not None and total > 0:
                return cs.null_count / total
        return 0.05
    if sig == "in" and isinstance(c.args[0], ColumnRef):
        cs = _col_stats(c.args[0], schema, stats)
        if cs is None or total == 0:
            return min(PSEUDO_EQ * max(len(c.args) - 1, 1), 1.0)
        rows = 0.0
        for item in c.args[1:]:
            if isinstance(item, Constant):
                v = _phys(item.value, c.args[0].ftype, cs)
                if v is None or isinstance(v, tuple):
                    continue
                rows += cs.est_eq(v, total)
        return min(rows / total, 1.0) if total else 0.0
    if sig in ("eq", "ne", "lt", "le", "gt", "ge"):
        left, right = c.args
        flip = {"lt": "gt", "le": "ge", "gt": "lt", "ge": "le", "eq": "eq", "ne": "ne"}
        if isinstance(left, Constant) and isinstance(right, ColumnRef):
            left, right, sig = right, left, flip[sig]
        if isinstance(left, ColumnRef) and isinstance(right, Constant):
            cs = _col_stats(left, schema, stats)
            if cs is None or total == 0:
                return PSEUDO_EQ if sig in ("eq",) else PSEUDO_LESS if sig != "ne" else 1 - PSEUDO_EQ
            v = _phys(right.value, left.ftype, cs)
            if v is None:
                return PSEUDO_EQ if sig == "eq" else PSEUDO_LESS
            missing_rank = None
            if isinstance(v, tuple):  # absent string: eq can't match
                missing_rank = v[1]
                if sig == "eq":
                    return 0.0
                if sig == "ne":
                    return 1.0
                v = missing_rank - 0.5  # between codes rank-1 and rank
            non_null = max(total - cs.null_count, 1)
            if sig == "eq":
                return min(cs.est_eq(v, total) / non_null, 1.0)
            if sig == "ne":
                return max(1.0 - cs.est_eq(v, total) / non_null - cs.null_count / total, 0.0)
            lo = hi = None
            lo_incl = hi_incl = False
            if sig == "lt":
                hi, hi_incl = v, False
            elif sig == "le":
                hi, hi_incl = v, True
            elif sig == "gt":
                lo, lo_incl = v, False
            else:
                lo, lo_incl = v, True
            rows = cs.hist.est_range(lo, hi, lo_incl, hi_incl)
            # TopN values are outside the histogram — add those in range
            for tv, tc in zip(cs.topn.values, cs.topn.counts):
                if (lo is None or tv > lo or (lo_incl and tv == lo)) and (
                    hi is None or tv < hi or (hi_incl and tv == hi)
                ):
                    rows += int(tc)
            return min(rows / total, 1.0) if total else PSEUDO_LESS
    return DEFAULT_SEL


def estimate_join_rows(lcs, rcs, l_rows: float, r_rows: float) -> float:
    """Equi-join output cardinality (ref: cardinality estimation over
    histograms + TopN in pkg/planner/cardinality): the containment baseline
    l*r/max(ndv) refined with exact TopN skew — each heavy build value
    contributes probe.est_eq(v) * its count, and the remaining mass joins at
    the baseline rate. Skewed keys make the baseline wildly wrong in both
    directions; the TopN term is what lets the exchange/expansion choices
    see the skew."""
    if not l_rows or not r_rows:
        return 0.0
    ndv_l = max(lcs.ndv, 1) if lcs is not None else 1
    ndv_r = max(rcs.ndv, 1) if rcs is not None else 1
    base_rate = 1.0 / max(ndv_l, ndv_r)
    if lcs is None or rcs is None:
        return l_rows * r_rows * base_rate
    out = 0.0
    r_topn_mass = 0
    l_topn_matched = 0.0
    for v, c in zip(rcs.topn.values, rcs.topn.counts):
        lc = lcs.est_eq(v, int(l_rows))
        out += lc * int(c)
        r_topn_mass += int(c)
        l_topn_matched += lc
    tail_l = max(l_rows - l_topn_matched, 0.0)
    tail_r = max(r_rows - r_topn_mass, 0.0)
    out += tail_l * tail_r * base_rate
    return max(out, 1.0)
