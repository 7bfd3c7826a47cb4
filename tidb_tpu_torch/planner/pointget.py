"""Point-get fast path: `SELECT ... FROM t WHERE pk = const`.

Reference parity: planner TryFastPlan (core/point_get_plan.go:957) — the
planner is bypassed entirely for single-row primary-key lookups; the row is
fetched with one KV get (PointGetExecutor analog) instead of a coprocessor
scan. Only clustered integer primary keys (pk_is_handle) qualify, matching
the reference's handle fast path.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

from tidb_tpu_torch.catalog.schema import TableInfo
from tidb_tpu_torch.parser import ast


@dataclass
class PointGetPlan:
    db: str
    table: TableInfo
    # one handle = Point_Get; several = Batch_Point_Get (ref:
    # BatchPointGetPlan for pk IN (...) lists)
    handles: list[int]
    # projected column offsets, in output order
    out_offsets: list[int]
    out_names: list[str]

    @property
    def handle(self) -> int:
        return self.handles[0]


def _const_int(node: ast.Node) -> Optional[int]:
    if isinstance(node, ast.Literal) and node.hint == "" and isinstance(node.value, int) and not isinstance(node.value, bool):
        return node.value
    if (
        isinstance(node, ast.UnaryOp)
        and node.op == "unaryminus"
        and isinstance(node.operand, ast.Literal)
        and isinstance(node.operand.value, int)
    ):
        return -node.operand.value
    return None


def detect_point_get(catalog, current_db: str, stmt: ast.Node) -> Optional[PointGetPlan]:
    """Return a PointGetPlan when the statement is exactly a clustered-PK
    single-row lookup; None means take the regular planner path."""
    if not isinstance(stmt, ast.Select):
        return None
    if (
        stmt.ctes
        or stmt.group_by
        or stmt.having is not None
        or stmt.order_by
        or stmt.distinct
        or stmt.for_update
        or stmt.offset
        or stmt.limit == 0
    ):
        return None
    if not isinstance(stmt.from_, ast.TableRef):
        return None
    if stmt.from_.as_of is not None:
        return None  # stale reads take the planner path
    if stmt.where is None:
        return None
    # WHERE must be exactly `pk = const` / `const = pk` / `pk IN (consts)`
    w = stmt.where
    try:
        t = catalog.table(stmt.from_.db or current_db, stmt.from_.name)
    except Exception:
        return None
    if not t.pk_is_handle or t.pk_offset < 0:
        return None
    if t.partition is not None:
        return None  # partitioned point lookups take the planner path
    pk_name = t.columns[t.pk_offset].name.lower()
    alias = (stmt.from_.alias or stmt.from_.name).lower()

    def is_pk_col(n):
        return (
            isinstance(n, ast.ColumnName)
            and n.name.lower() == pk_name
            and (not n.table or n.table.lower() == alias)
        )

    handles: Optional[list[int]] = None
    if isinstance(w, ast.BinaryOp) and w.op == "eq":
        h = None
        if is_pk_col(w.left):
            h = _const_int(w.right)
        elif is_pk_col(w.right):
            h = _const_int(w.left)
        if h is not None:
            handles = [h]
    elif isinstance(w, ast.InList) and not w.negated and is_pk_col(w.operand):
        vals = [_const_int(x) for x in w.items]
        if all(v is not None for v in vals):
            # MySQL batch point get preserves the IN-list order, deduped
            handles = list(dict.fromkeys(vals))  # type: ignore[arg-type]
    if handles is None:
        return None

    # select list: plain columns or *
    out_offsets: list[int] = []
    out_names: list[str] = []
    for it in stmt.items:
        if isinstance(it.expr, ast.Wildcard):
            if it.expr.table and it.expr.table.lower() != alias:
                return None
            for c in t.columns:
                out_offsets.append(c.offset)
                out_names.append(c.name)
            continue
        if isinstance(it.expr, ast.ColumnName):
            if it.expr.table and it.expr.table.lower() != alias:
                return None
            c = t.column(it.expr.name)
            if c is None:
                return None
            out_offsets.append(c.offset)
            out_names.append(it.alias or c.name)
            continue
        return None
    if not out_offsets:
        return None
    return PointGetPlan(stmt.from_.db or current_db, t, handles, out_offsets, out_names)


def _to_logical(v, ft):
    """Storage repr → logical Python value (mirrors Column.logical_value)."""
    from tidb_tpu_torch.types import TypeKind
    from tidb_tpu_torch.types.datum import days_to_date, micros_to_datetime

    if v is None:
        return None
    k = ft.kind
    if k == TypeKind.STRING:
        return v.decode("utf-8", "replace")
    if k == TypeKind.DECIMAL:
        if ft.scale == 0:
            return int(v)
        from decimal import Decimal

        return Decimal(int(v)).scaleb(-ft.scale)
    if k == TypeKind.DATE:
        return days_to_date(int(v))
    if k == TypeKind.DATETIME:
        return micros_to_datetime(int(v))
    if k == TypeKind.FLOAT:
        return float(v)
    if k == TypeKind.UINT and v < 0:
        return int(v) + (1 << 64)
    return int(v)


def run_point_get(session, plan: PointGetPlan) -> list[tuple]:
    """KV gets for the plan's handles through the txn-aware read path
    (membuffer overlay first, then MVCC snapshot at the session read ts).
    Autocommit snapshot reads ride the cross-session point-get batcher:
    concurrent sessions' lookups coalesce into one multi-key store dispatch
    (TiKV batch-commands idiom) instead of one RPC each."""
    from tidb_tpu_torch.kv import tablecodec
    from tidb_tpu_torch.kv.rowcodec import RowSchema, decode_row

    txn = session._txn
    schema = RowSchema(plan.table.storage_schema)
    keys = [tablecodec.record_key(plan.table.id, h) for h in plan.handles]
    if txn is None:
        from tidb_tpu_torch.copr.client import batched_point_get

        raws = batched_point_get(session.store, session.read_ts(), keys)
    else:
        # dirty-txn gets ride the batcher too: membuffer overlay first, then
        # one coalesced dispatch for the snapshot misses (Txn.batch_get)
        raws = txn.batch_get(keys)
    out: list[tuple] = []
    for raw in raws:
        if raw is None:
            continue
        vals = decode_row(schema, raw)
        out.append(
            tuple(_to_logical(vals[o], plan.table.columns[o].ftype) for o in plan.out_offsets)
        )
    return out
