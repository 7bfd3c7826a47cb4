"""DAG request "protobuf" — the wire contract between SQL layer and engines.

Reference parity: pingcap/tipb DAGRequest + Executor messages, as consumed by
unistore's cophandler (closure_exec.go:72-149 dispatch on tipb.ExecType_*).
Plain JSON-able dataclasses instead of protobuf — the process boundary in
this build is a function call or (multi-host) a serialized dict.

An executor list is a linear chain bottom-up: executors[0] is always a scan.
(Joins/exchanges appear only in MPP fragments, tidb_tpu.parallel.)
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Optional

from tidb_tpu_torch.types import FieldType, TypeKind
from tidb_tpu_torch.expression.expr import _ft_pb, _ft_from_pb  # shared FieldType wire form

# executor types (ref: tipb.ExecType)
TABLE_SCAN = "table_scan"
INDEX_SCAN = "index_scan"
SELECTION = "selection"
AGGREGATION = "aggregation"  # hash agg
STREAM_AGG = "stream_agg"
TOPN = "topn"
LIMIT = "limit"
PROJECTION = "projection"
EXCHANGE_SENDER = "exchange_sender"
EXCHANGE_RECEIVER = "exchange_receiver"
JOIN = "join"
EXPAND = "expand"
WINDOW = "window"

# aggregation modes (two-phase aggregation)
AGG_PARTIAL = "partial"
AGG_FINAL = "final"
AGG_COMPLETE = "complete"


@dataclass
class ColumnInfoPB:
    """One scanned column (ref: tipb.ColumnInfo)."""

    column_id: int
    ftype: FieldType
    # the rowid/handle pseudo-column (ref: model.ExtraHandleID == -1)
    is_handle: bool = False

    def to_pb(self) -> dict:
        return {"id": self.column_id, "ft": _ft_pb(self.ftype), "handle": self.is_handle}

    @staticmethod
    def from_pb(pb: dict) -> "ColumnInfoPB":
        return ColumnInfoPB(pb["id"], _ft_from_pb(pb["ft"]), pb["handle"])


@dataclass
class ExecutorPB:
    tp: str
    # table_scan / index_scan
    table_id: int = 0
    columns: list[ColumnInfoPB] = field(default_factory=list)
    desc: bool = False
    # index_scan: which index, and the storage offsets of its key columns in
    # key order (drives flagged-datum decode; ref: tipb.IndexScan)
    index_id: int = 0
    index_col_offsets: list[int] = field(default_factory=list)
    unique: bool = False
    # full storage-slot schema of the table (rowcodec is schema-versioned,
    # not self-describing — decode needs every slot's type)
    storage_schema: list[FieldType] = field(default_factory=list)
    # per-scan-output value-domain size (dictionary length for string codes;
    # -1 unknown). Set by the device binder; enables dense no-sort group-by.
    domains: list[int] = field(default_factory=list)
    # selection: conditions (ExprPB dicts), implicitly AND-ed
    conditions: list[dict] = field(default_factory=list)
    # binder-stamped int32 narrow-eval proof per condition (see
    # Binder.narrow_safe); participates in to_pb — the compiled kernel bakes
    # the lane widths in, so stale flags must change the fingerprint
    narrow_ok: list = field(default_factory=list)
    # aggregation
    group_by: list[dict] = field(default_factory=list)
    aggs: list[dict] = field(default_factory=list)  # AggDesc pb
    agg_mode: str = AGG_COMPLETE
    # binder-stamped exact (lo, hi) per agg argument (None = unbounded) —
    # static magnitude proofs for the MXU grouped-sum path; participates in
    # to_pb so kernels never reuse stale bounds
    arg_bounds: list = field(default_factory=list)
    # binder-stamped int32 narrow-eval proofs (group keys / agg arguments)
    group_narrow: list = field(default_factory=list)
    arg_narrow: list = field(default_factory=list)
    # GROUP BY ... WITH ROLLUP pushdown: the engine computes EVERY prefix
    # grouping set in one pass, emitting NULLed keys + GROUPING() flags
    rollup: bool = False
    # topn: order_by = [(ExprPB, desc: bool)]
    order_by: list = field(default_factory=list)
    limit: int = 0
    # projection
    exprs: list[dict] = field(default_factory=list)
    # window (ref: tipb.Window — funcs over one OVER spec; partition_by +
    # order_by reuse ExprPB; frame is the window_core frame tag, JSON-able)
    partition_by: list[dict] = field(default_factory=list)
    frame: Any = "range_cur"
    win_funcs: list[dict] = field(default_factory=list)  # {name, args, ft}
    # per (partition_by + order_by) sort lane: [lo, hi] integer value bounds
    # or None — stamped by the device binder from column-cache min/max to
    # enable the packed single-key sort (window_core.sort_perm)
    sort_bounds: list = field(default_factory=list)
    # exchange (MPP)
    exchange_type: str = ""  # hash | broadcast | passthrough
    hash_keys: list[dict] = field(default_factory=list)
    target_tasks: list[int] = field(default_factory=list)
    # join (MPP)
    join_type: str = ""  # inner | left | semi ...
    left_keys: list[dict] = field(default_factory=list)
    right_keys: list[dict] = field(default_factory=list)

    def to_pb(self) -> dict:
        d = {"tp": self.tp}
        if self.tp == TABLE_SCAN:
            d.update(
                table_id=self.table_id,
                columns=[c.to_pb() for c in self.columns],
                desc=self.desc,
                storage_schema=[_ft_pb(ft) for ft in self.storage_schema],
                domains=list(self.domains),
            )
        elif self.tp == INDEX_SCAN:
            d.update(
                table_id=self.table_id,
                index_id=self.index_id,
                index_col_offsets=list(self.index_col_offsets),
                unique=self.unique,
                columns=[c.to_pb() for c in self.columns],
                desc=self.desc,
                storage_schema=[_ft_pb(ft) for ft in self.storage_schema],
            )
        elif self.tp == SELECTION:
            d.update(conditions=self.conditions, narrow_ok=list(self.narrow_ok))
        elif self.tp in (AGGREGATION, STREAM_AGG):
            d.update(
                group_by=self.group_by,
                aggs=self.aggs,
                agg_mode=self.agg_mode,
                arg_bounds=[list(b) if b is not None else None for b in self.arg_bounds],
                group_narrow=list(self.group_narrow),
                arg_narrow=list(self.arg_narrow),
                rollup=self.rollup,
            )
        elif self.tp == TOPN:
            d.update(
                order_by=self.order_by,
                limit=self.limit,
                # binder-stamped value bounds are baked into the compiled
                # kernel — they MUST participate in fingerprint() or a data
                # change reuses a kernel with stale bounds
                sort_bounds=[list(b) if b is not None else None for b in self.sort_bounds],
            )
        elif self.tp == LIMIT:
            d.update(limit=self.limit)
        elif self.tp == PROJECTION:
            d.update(exprs=self.exprs)
        elif self.tp == WINDOW:
            d.update(
                partition_by=self.partition_by,
                order_by=[list(o) for o in self.order_by],
                frame=list(self.frame) if isinstance(self.frame, tuple) else self.frame,
                win_funcs=self.win_funcs,
                sort_bounds=[list(b) if b is not None else None for b in self.sort_bounds],
            )
        return d

    @staticmethod
    def from_pb(pb: dict) -> "ExecutorPB":
        e = ExecutorPB(pb["tp"])
        if e.tp == TABLE_SCAN:
            e.table_id = pb["table_id"]
            e.columns = [ColumnInfoPB.from_pb(c) for c in pb["columns"]]
            e.desc = pb.get("desc", False)
            e.storage_schema = [_ft_from_pb(f) for f in pb.get("storage_schema", [])]
            e.domains = pb.get("domains", [])
        elif e.tp == INDEX_SCAN:
            e.table_id = pb["table_id"]
            e.index_id = pb["index_id"]
            e.index_col_offsets = pb["index_col_offsets"]
            e.unique = pb.get("unique", False)
            e.columns = [ColumnInfoPB.from_pb(c) for c in pb["columns"]]
            e.desc = pb.get("desc", False)
            e.storage_schema = [_ft_from_pb(f) for f in pb.get("storage_schema", [])]
        elif e.tp == SELECTION:
            e.conditions = pb["conditions"]
            e.narrow_ok = pb.get("narrow_ok", [])
        elif e.tp in (AGGREGATION, STREAM_AGG):
            e.group_by, e.aggs, e.agg_mode = pb["group_by"], pb["aggs"], pb["agg_mode"]
            e.arg_bounds = [tuple(b) if b is not None else None for b in pb.get("arg_bounds", [])]
            e.group_narrow = pb.get("group_narrow", [])
            e.arg_narrow = pb.get("arg_narrow", [])
            e.rollup = pb.get("rollup", False)
        elif e.tp == TOPN:
            e.order_by, e.limit = pb["order_by"], pb["limit"]
            e.sort_bounds = [tuple(b) if b is not None else None for b in pb.get("sort_bounds", [])]
        elif e.tp == LIMIT:
            e.limit = pb["limit"]
        elif e.tp == PROJECTION:
            e.exprs = pb["exprs"]
        elif e.tp == WINDOW:
            e.partition_by = pb["partition_by"]
            e.order_by = [tuple(o) for o in pb["order_by"]]
            f = pb.get("frame", "range_cur")
            e.frame = tuple(f) if isinstance(f, list) else f
            e.win_funcs = pb["win_funcs"]
            e.sort_bounds = [tuple(b) if b is not None else None for b in pb.get("sort_bounds", [])]
        return e


@dataclass
class DAGRequest:
    """ref: tipb.DAGRequest + kv.Request.Data."""

    executors: list[ExecutorPB]
    # offsets into the final executor's output schema the client wants back
    output_offsets: list[int] = field(default_factory=list)
    collect_execution_summaries: bool = False

    def to_pb(self) -> dict:
        return {
            "executors": [e.to_pb() for e in self.executors],
            "output_offsets": list(self.output_offsets),
        }

    @staticmethod
    def from_pb(pb: dict) -> "DAGRequest":
        return DAGRequest([ExecutorPB.from_pb(e) for e in pb["executors"]], pb["output_offsets"])

    def fingerprint(self) -> str:
        """Structural identity for kernel-compilation caching."""
        import hashlib
        import json

        return hashlib.sha1(json.dumps(self.to_pb(), sort_keys=True).encode()).hexdigest()
