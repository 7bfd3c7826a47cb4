"""Partition pruning (ref: core/rule/rule_partition_processor.go).

Intersects simple top-level comparisons on the partitioning column with each
partition's value range (RANGE) or routes equality to one bucket (HASH).
Conservative: anything unrecognized keeps all partitions — pruning only ever
removes provably-empty reads.
"""

from __future__ import annotations

from typing import Optional

from tidb_tpu_torch.catalog.schema import TableInfo
from tidb_tpu_torch.expression.expr import ColumnRef, Constant, ScalarFunc

_FLIP = {"lt": "gt", "le": "ge", "gt": "lt", "ge": "le", "eq": "eq"}


def prune_partitions(t: TableInfo, scan_schema, conds) -> Optional[list[TableInfo]]:
    """→ pruned partition views, or None for "scan all" (also when the table
    is not partitioned). ``conds`` are resolved pushdown conditions over
    ``scan_schema`` positions."""
    p = t.partition
    if p is None:
        return None
    positions = [i for i, oc in enumerate(scan_schema) if getattr(oc, "slot", -1) == p.col_offset]
    if not positions:
        return None
    pos = positions[0]

    lo, hi = None, None  # inclusive bounds on the partition column
    for c in conds:
        if not (isinstance(c, ScalarFunc) and c.sig in _FLIP):
            continue
        a, b = c.args
        sig = c.sig
        if isinstance(b, ColumnRef) and isinstance(a, Constant):
            a, b = b, a
            sig = _FLIP[sig]
        if not (isinstance(a, ColumnRef) and a.index == pos and isinstance(b, Constant)):
            continue
        if b.value is None:
            continue
        try:
            v = int(b.value)
        except (TypeError, ValueError):
            continue
        if sig == "eq":
            lo = v if lo is None else max(lo, v)
            hi = v if hi is None else min(hi, v)
        elif sig == "lt":
            hi = v - 1 if hi is None else min(hi, v - 1)
        elif sig == "le":
            hi = v if hi is None else min(hi, v)
        elif sig == "gt":
            lo = v + 1 if lo is None else max(lo, v + 1)
        elif sig == "ge":
            lo = v if lo is None else max(lo, v)

    if lo is None and hi is None:
        return None
    if lo is not None and hi is not None and lo > hi:
        return []

    if p.type == "hash":
        if lo is not None and lo == hi:
            return [t.partition_view(p.defs[lo % len(p.defs)].id)]
        return None

    # RANGE: partition d covers [prev_bound, d.less_than)
    out = []
    prev: Optional[int] = None
    for d in p.defs:
        p_lo = prev  # None = -inf
        p_hi = None if d.less_than is None else d.less_than - 1  # inclusive
        prev = d.less_than if d.less_than is not None else prev
        if lo is not None and p_hi is not None and lo > p_hi:
            continue
        if hi is not None and p_lo is not None and hi < p_lo:
            continue
        out.append(t.partition_view(d.id))
    # NULLs live in the first partition; a NULL-matching predicate can't be
    # a comparison (those never match NULL), so no extra handling needed
    return out
