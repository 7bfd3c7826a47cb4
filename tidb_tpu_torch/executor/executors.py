"""Read-path executors (ref: pkg/executor table_reader.go, aggregate/,
sortexec/, join/ — collapsed to chunk-materializing operators)."""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np

from tidb_tpu_torch.copr import dagpb
from tidb_tpu_torch.copr.host_engine import _aggregate as host_aggregate  # complete-mode agg
from tidb_tpu_torch.copr.host_engine import _selection as host_selection
from tidb_tpu_torch.copr.host_engine import finalize_agg, sort_perm
from tidb_tpu_torch.expression.expr import AggDesc, ColumnRef, Constant, EvalBatch, eval_to_column
from tidb_tpu_torch.kv import tablecodec
from tidb_tpu_torch.kv.kv import Request, RequestType, StoreType
from tidb_tpu_torch.kv.rowcodec import RowSchema, decode_row
from tidb_tpu_torch.planner.plans import (
    PhysDistinct,
    PhysDual,
    PhysFinalAgg,
    PhysHashJoin,
    PhysIndexJoin,
    PhysMergeJoin,
    PhysIndexLookUp,
    PhysIndexMerge,
    PhysIndexReader,
    PhysLimit,
    PhysMemSource,
    PhysPointGet,
    PhysProjection,
    PhysSelection,
    PhysSetOp,
    PhysSort,
    PhysTableReader,
    PhysWindow,
)
from tidb_tpu_torch.types import TypeKind
from tidb_tpu_torch.types.field_type import bigint_type
from tidb_tpu_torch.utils.chunk import Chunk, Column, Dictionary


class ExecError(Exception):
    pass


class Executor:
    schema: list

    def execute(self) -> Chunk:
        raise NotImplementedError


def build_executor(plan, session) -> Executor:
    """ref: executorBuilder.build (builder.go:164). When the session carries a
    RuntimeStatsColl (EXPLAIN ANALYZE), every built node is instrumented."""
    e = _build_executor(plan, session)
    coll = getattr(session, "runtime_stats", None)
    if coll is not None:
        from tidb_tpu_torch.utils.execdetails import instrument

        instrument(e, plan, coll)
    return e


def _build_executor(plan, session) -> Executor:
    if isinstance(plan, PhysTableReader):
        return TableReaderExec(plan, session)
    if isinstance(plan, PhysSelection):
        return SelectionExec(plan, build_executor(plan.children[0], session), session)
    if isinstance(plan, PhysProjection):
        return ProjectionExec(plan, build_executor(plan.children[0], session), session)
    if isinstance(plan, PhysFinalAgg):
        return FinalAggExec(plan, build_executor(plan.children[0], session))
    if isinstance(plan, PhysSort):
        return SortExec(plan, build_executor(plan.children[0], session))
    if isinstance(plan, PhysLimit):
        return LimitExec(plan, build_executor(plan.children[0], session))
    if isinstance(plan, PhysHashJoin):
        return HashJoinExec(plan, build_executor(plan.children[0], session), build_executor(plan.children[1], session))
    if isinstance(plan, PhysMergeJoin):
        return MergeJoinExec(plan, build_executor(plan.children[0], session), build_executor(plan.children[1], session))
    if isinstance(plan, PhysIndexJoin):
        return IndexJoinExec(plan, build_executor(plan.children[0], session), session)
    if isinstance(plan, PhysDistinct):
        return DistinctExec(build_executor(plan.children[0], session))
    if isinstance(plan, PhysSetOp):
        return SetOpExec(plan, [build_executor(c, session) for c in plan.children])
    if isinstance(plan, PhysWindow):
        return WindowExec(plan, build_executor(plan.children[0], session), session)
    if isinstance(plan, PhysDual):
        return DualExec(plan)
    if isinstance(plan, PhysMemSource):
        return MemSourceExec(plan)
    if isinstance(plan, PhysPointGet):
        return PointGetExec(plan, session)
    if isinstance(plan, PhysIndexReader):
        return IndexReaderExec(plan, session)
    if isinstance(plan, PhysIndexLookUp):
        return IndexLookUpExec(plan, session)
    if isinstance(plan, PhysIndexMerge):
        return IndexMergeExec(plan, session)
    from tidb_tpu_torch.parallel.gather import MPPGatherExec, PhysMPPGather

    if isinstance(plan, PhysMPPGather):
        return MPPGatherExec(plan, session)
    raise ExecError(f"no executor for {type(plan).__name__}")


def _window_pb(w) -> dagpb.ExecutorPB:
    """Serialize a pushed LogicalWindow into the DAG wire form (ref: the
    tipb.Window message TiFlash consumes)."""
    from tidb_tpu_torch.expression.expr import _ft_pb

    if w.frame is not None:
        frame = ("rows",) + tuple(w.frame)
    elif w.whole_partition:
        frame = "whole"
    elif w.rows_frame:
        frame = "rows_cur"
    else:
        frame = "range_cur"
    return dagpb.ExecutorPB(
        dagpb.WINDOW,
        partition_by=[e.to_pb() for e in w.partition_by],
        order_by=[(e.to_pb(), d) for e, d in w.order_by],
        frame=frame,
        win_funcs=[
            {"name": f.name, "args": [a.to_pb() for a in f.args], "ft": _ft_pb(f.ftype)}
            for f in w.funcs
        ],
    )


def _empty_chunk(schema) -> Chunk:
    cols = []
    for oc in schema:
        dt = {TypeKind.FLOAT: np.float64, TypeKind.STRING: np.int32}.get(oc.ftype.kind, np.int64)
        cols.append(Column(np.empty(0, dt), np.empty(0, bool), oc.ftype))
    return Chunk(cols)


@dataclass
class TableReaderExec(Executor):
    plan: PhysTableReader
    session: object
    # index executors run their table phase through a SYNTHETIC reader; the
    # sidecars must land on the visible plan node (the IndexLookUp/IndexMerge
    # row of EXPLAIN ANALYZE), not on the synthetic one nobody renders
    detail_target: object = None

    def __post_init__(self):
        self.schema = self.plan.schema

    def execute(self) -> Chunk:
        from tidb_tpu_torch.utils import failpoint

        # test hook: park a reader mid-statement (cross-node KILL tests);
        # receives the executor so hooks can filter by plan/table
        failpoint.inject("table_reader_begin", self)
        p = self.plan
        if p.table.partition is not None:
            # one request per partition (each is its own physical table —
            # ref: kv.Request.PartitionIDAndRanges); chunks concat like
            # multi-region partials
            from tidb_tpu_torch.copr.colcache import cache_for

            cache = cache_for(self.session.store)
            views = p.partitions if p.partitions is not None else p.table.partition_views()
            for view in views:
                cache.set_table_alias(view.id, p.table.id)
            self.session.check_killed()
            if len(views) > 1:
                # partitions fan out like region tasks (ref: partitioned
                # scans sharing the distsql concurrency budget); numpy/XLA
                # release the GIL so tasks overlap for real
                from concurrent.futures import ThreadPoolExecutor

                budget = int(self.session.vars.get("tidb_distsql_scan_concurrency", 8))
                conc = max(1, min(budget, len(views)))
                # partitions share (not multiply) the scan budget: each
                # per-partition request gets its slice of workers
                self._conc_override = max(1, budget // conc)
                try:
                    with ThreadPoolExecutor(max_workers=conc, thread_name_prefix="part") as pool:
                        results = list(pool.map(lambda v: self._execute_one(v, self._translate_ranges(v)), views))
                finally:
                    self._conc_override = None
                self.session.check_killed()
                chunks = [ch for ch in results if len(ch)]
            else:
                chunks = [ch for ch in (self._execute_one(v, self._translate_ranges(v)) for v in views) if len(ch)]
            if not chunks:
                return _empty_chunk(p.schema)
            return Chunk.concat(chunks) if len(chunks) > 1 else chunks[0]
        t = p.table
        ranges = p.ranges if p.ranges is not None else [tablecodec.record_range(t.id)]
        return self._execute_one(t, ranges)

    def _translate_ranges(self, view) -> list:
        """Planner ranges are handle ranges in logical-table key space —
        re-encode them for the partition's physical id."""
        p = self.plan
        if p.ranges is None:
            return [tablecodec.record_range(view.id)]
        out = []
        for kr in p.ranges:
            lo, hi = tablecodec.range_to_handles(kr, p.table.id)
            if lo < hi:
                out.append(tablecodec.handle_range(view.id, lo, hi - 1))
        return out

    def _execute_one(self, t, ranges) -> Chunk:
        from tidb_tpu_torch.utils import metrics as _m

        p = self.plan
        _m.COP_TASKS.inc(engine=p.store_type.value if hasattr(p.store_type, "value") else str(p.store_type))
        scan = dagpb.ExecutorPB(
            dagpb.TABLE_SCAN,
            table_id=t.id,
            columns=[
                dagpb.ColumnInfoPB(slot, t.columns[slot].ftype)
                if slot >= 0
                else dagpb.ColumnInfoPB(-1, bigint_type(nullable=False), is_handle=True)
                for slot in p.scan_slots
            ],
            storage_schema=t.storage_schema,
        )
        executors = [scan]
        if p.pushed_conditions:
            executors.append(dagpb.ExecutorPB(dagpb.SELECTION, conditions=[c.to_pb() for c in p.pushed_conditions]))
        if p.pushed_window is not None:
            executors.append(_window_pb(p.pushed_window))
        if p.pushed_agg is not None:
            executors.append(
                dagpb.ExecutorPB(
                    dagpb.AGGREGATION,
                    group_by=[g.to_pb() for g in p.pushed_agg.group_by],
                    aggs=[a.to_pb() for a in p.pushed_agg.aggs],
                    agg_mode=dagpb.AGG_PARTIAL if p.pushed_agg_mode == "partial" else dagpb.AGG_COMPLETE,
                    rollup=getattr(p.pushed_agg, "rollup", False),
                )
            )
        if p.pushed_topn is not None:
            by, limit = p.pushed_topn
            executors.append(
                dagpb.ExecutorPB(dagpb.TOPN, order_by=[[e.to_pb(), d] for e, d in by], limit=limit)
            )
        if p.pushed_limit is not None:
            executors.append(dagpb.ExecutorPB(dagpb.LIMIT, limit=p.pushed_limit))
        dag = dagpb.DAGRequest(executors=executors)
        if not ranges:
            return _empty_chunk(p.schema)
        if self.session._txn_dirty():
            # union-scan path (ref: UnionScanExec): scan through the txn's
            # membuffer overlay and replay pushed operators host-side
            return self._union_scan(dag, ranges, t)
        host_tail: list = []
        if p.pushed_window is not None:
            # windows need every partition row in ONE computation; a table
            # spanning multiple regions splits into independent cop tasks, so
            # run the scan prefix remotely and the window (plus anything
            # above it) host-side over the gathered rows
            n_regions = sum(1 for _ in self.session.store.pd.regions_in_ranges(ranges))
            if n_regions > 1:
                widx = next(i for i, ex in enumerate(executors) if ex.tp == dagpb.WINDOW)
                host_tail = executors[widx:]
                dag = dagpb.DAGRequest(executors=executors[:widx])
        req = Request(
            tp=RequestType.DAG,
            data=dag,
            ranges=ranges,
            store_type=p.store_type,
            start_ts=self.session.read_ts(),
            concurrency=getattr(self, "_conc_override", None)
            or int(self.session.vars.get("tidb_distsql_scan_concurrency", 8)),
            keep_order=p.keep_order,
            warn=self.session.append_warning,
            tracer=self.session.tracer,
        )
        client = self.session.store.get_client()
        # gather through a spillable container accounted against the query's
        # memory tracker (ref: copr worker results → memory.Tracker; spill =
        # chunk_in_disk host-RAM offload), checking the kill flag per task
        from tidb_tpu_torch.utils.rowcontainer import RowContainer

        rc = RowContainer(getattr(self.session, "mem_tracker", None), "cop-gather")
        try:
            for res in client.send(req):
                self.session.check_killed()
                # per-task ExecDetails sidecar → the statement aggregate
                # (slow log / statements_summary) and, under EXPLAIN
                # ANALYZE, this reader node's cop_task execution-info line
                if res.details is not None:
                    self.session.record_cop_detail(self.detail_target or p, res.details)
                rc.add(res.chunk)
            out = rc.to_chunk()
        finally:
            rc.close()
        if out is None:
            return _empty_chunk(p.schema)
        if host_tail:
            from tidb_tpu_torch.copr.host_engine import run_operators

            out = run_operators(out, host_tail, [])
        # string columns may carry per-region-identical dictionaries (table-
        # level, shared) — concat requires the same object, which holds here
        return out

    def _union_scan(self, dag, ranges, t=None) -> Chunk:
        from tidb_tpu_torch.copr.host_engine import run_operators
        from tidb_tpu_torch.executor.write import _rows_to_chunk, _scan_visible_rows

        if t is None:
            t = self.plan.table
        handles, rows, _ = _scan_visible_rows(self.session, t)
        # restrict by handle ranges
        keep = []
        bounds = [tablecodec.range_to_handles(kr, t.id) for kr in ranges]
        for i, h in enumerate(handles):
            if any(lo <= h < hi for lo, hi in bounds):
                keep.append(i)
        rows = [rows[i] for i in keep]
        handles = [handles[i] for i in keep]
        full = _rows_to_chunk(self.session, t, rows)
        cols = []
        for slot in self.plan.scan_slots:
            if slot == -1:
                cols.append(Column(np.asarray(handles, np.int64), np.ones(len(handles), bool), bigint_type(nullable=False)))
            else:
                cols.append(full.columns[slot])
        chunk = Chunk(cols)
        out = run_operators(chunk, dag.executors[1:], dag.output_offsets)
        return out if len(out.columns) else _empty_chunk(self.plan.schema)


def _union_scan_fallback(session, table, scan_slots, conditions, schema, target=None) -> Chunk:
    """Dirty-txn path shared by the index executors: index contents may lag
    the membuffer, so read through a membuffer-merged table scan instead
    (ref: UnionScanExec wrapping IndexReader/IndexLookUp). ``target`` keeps
    any cop sidecars attributed to the visible index plan node."""
    reader = PhysTableReader(
        db="",
        table=table,
        store_type=StoreType.HOST,
        pushed_conditions=list(conditions),
        scan_slots=list(scan_slots),
        schema=schema,
    )
    return TableReaderExec(reader, session, detail_target=target).execute()


def _gather_index_chunks(session, plan, req) -> list:
    """One index-side cop fan-out with the TableReaderExec sidecar
    discipline: every task's wire-shipped ExecDetails folds into the
    statement aggregate and — under EXPLAIN ANALYZE — into ``plan``'s own
    ``cop_task:`` execution-info line (the index executors used to drop
    these on the floor; ROADMAP named the gap)."""
    chunks = []
    for res in session.store.get_client().send(req):
        session.check_killed()
        if res.details is not None:
            session.record_cop_detail(plan, res.details)
        if len(res.chunk):
            chunks.append(res.chunk)
    return chunks


def _coalesce_handle_ranges(table_id: int, handles: np.ndarray) -> list:
    """Sorted handles → minimal list of contiguous [lo, hi] key ranges."""
    if len(handles) == 0:
        return []
    hs = np.unique(handles)  # sorts
    breaks = np.nonzero(np.diff(hs) != 1)[0]
    starts = np.concatenate(([0], breaks + 1))
    ends = np.concatenate((breaks, [len(hs) - 1]))
    return [tablecodec.handle_range(table_id, int(hs[s]), int(hs[e])) for s, e in zip(starts, ends)]


@dataclass
class IndexReaderExec(Executor):
    """Covering-index read (ref: IndexReaderExecutor, distsql.go)."""

    plan: PhysIndexReader
    session: object

    def __post_init__(self):
        self.schema = self.plan.schema

    def execute(self) -> Chunk:
        p = self.plan
        if self.session._txn_dirty():
            return _union_scan_fallback(
                self.session, p.table, [oc.slot for oc in p.schema], p.all_conditions, p.schema,
                target=p,
            )
        if not p.ranges:
            return _empty_chunk(p.schema)
        t = p.table
        cols = []
        for pos, slot in enumerate(p.output_slots):
            if slot == -1:
                cols.append(dagpb.ColumnInfoPB(-1, bigint_type(nullable=False), is_handle=True))
            else:
                cols.append(dagpb.ColumnInfoPB(slot, t.columns[slot].ftype))
        scan = dagpb.ExecutorPB(
            dagpb.INDEX_SCAN,
            table_id=t.id,
            index_id=p.index.id,
            index_col_offsets=list(p.index.column_offsets),
            unique=p.index.unique,
            columns=cols,
            storage_schema=t.storage_schema,
        )
        executors = [scan]
        if p.pushed_conditions:
            executors.append(dagpb.ExecutorPB(dagpb.SELECTION, conditions=[c.to_pb() for c in p.pushed_conditions]))
        req = Request(
            tp=RequestType.DAG,
            data=dagpb.DAGRequest(executors=executors),
            ranges=p.ranges,
            store_type=StoreType.HOST,
            start_ts=self.session.read_ts(),
            concurrency=int(self.session.vars.get("tidb_distsql_scan_concurrency", 8)),
            keep_order=True,
            warn=self.session.append_warning,
            tracer=self.session.tracer,
        )
        chunks = _gather_index_chunks(self.session, p, req)
        if not chunks:
            return _empty_chunk(p.schema)
        return Chunk.concat(chunks) if len(chunks) > 1 else chunks[0]


@dataclass
class IndexLookUpExec(Executor):
    """Index scan → handle collection → batched table row fetch
    (ref: IndexLookUpExecutor's index worker + table worker pipeline)."""

    plan: PhysIndexLookUp
    session: object

    def __post_init__(self):
        self.schema = self.plan.schema

    def execute(self) -> Chunk:
        p = self.plan
        if self.session._txn_dirty():
            return _union_scan_fallback(
                self.session, p.table, p.scan_slots, p.all_conditions, p.schema, target=p
            )
        if not p.ranges:
            return _empty_chunk(p.schema)
        t = p.table
        # phase 1: index side — handles only
        scan = dagpb.ExecutorPB(
            dagpb.INDEX_SCAN,
            table_id=t.id,
            index_id=p.index.id,
            index_col_offsets=list(p.index.column_offsets),
            unique=p.index.unique,
            columns=[dagpb.ColumnInfoPB(-1, bigint_type(nullable=False), is_handle=True)],
            storage_schema=t.storage_schema,
        )
        req = Request(
            tp=RequestType.DAG,
            data=dagpb.DAGRequest(executors=[scan]),
            ranges=p.ranges,
            store_type=StoreType.HOST,
            start_ts=self.session.read_ts(),
            concurrency=int(self.session.vars.get("tidb_distsql_scan_concurrency", 8)),
            warn=self.session.append_warning,
            tracer=self.session.tracer,
        )
        handle_chunks = _gather_index_chunks(self.session, p, req)
        if not handle_chunks:
            return _empty_chunk(p.schema)
        handles = np.concatenate([c.columns[0].data for c in handle_chunks])
        # phase 2: table side — fetch rows by coalesced handle ranges with
        # residual filters pushed (ref: buildTableReaderForIndexJoin); its
        # cop sidecars attribute to THIS plan node's execution-info line
        reader = PhysTableReader(
            db=p.db,
            table=t,
            store_type=StoreType.HOST,
            pushed_conditions=list(p.residual_conditions),
            scan_slots=list(p.scan_slots),
            ranges=_coalesce_handle_ranges(t.id, handles),
            schema=p.schema,
        )
        return TableReaderExec(reader, self.session, detail_target=p).execute()


@dataclass
class IndexMergeExec(Executor):
    """Union/intersection of per-path handle sets feeding one table lookup
    (ref: IndexMergeReaderExecutor, executor/index_merge_reader.go:88 —
    partial index/table workers → handle union → table worker). Paths run
    concurrently on the cop pool; the table side re-applies the FULL
    condition list, so over-approximating paths stay correct."""

    plan: "PhysIndexMerge"
    session: object

    def __post_init__(self):
        self.schema = self.plan.schema

    def _path_handles(self, path) -> np.ndarray:
        p = self.plan
        t = p.table
        if path[0] == "table":
            scan = dagpb.ExecutorPB(
                dagpb.TABLE_SCAN,
                table_id=t.id,
                columns=[dagpb.ColumnInfoPB(-1, bigint_type(nullable=False), is_handle=True)],
                storage_schema=t.storage_schema,
            )
            ranges = path[1]
        else:
            idx = path[1]
            scan = dagpb.ExecutorPB(
                dagpb.INDEX_SCAN,
                table_id=t.id,
                index_id=idx.id,
                index_col_offsets=list(idx.column_offsets),
                unique=idx.unique,
                columns=[dagpb.ColumnInfoPB(-1, bigint_type(nullable=False), is_handle=True)],
                storage_schema=t.storage_schema,
            )
            ranges = path[2]
        if not ranges:
            return np.empty(0, np.int64)
        req = Request(
            tp=RequestType.DAG,
            data=dagpb.DAGRequest(executors=[scan]),
            ranges=ranges,
            store_type=StoreType.HOST,
            start_ts=self.session.read_ts(),
            concurrency=int(self.session.vars.get("tidb_distsql_scan_concurrency", 8)),
            warn=self.session.append_warning,
            tracer=self.session.tracer,
        )
        chunks = _gather_index_chunks(self.session, self.plan, req)
        if not chunks:
            return np.empty(0, np.int64)
        return np.concatenate([c.columns[0].data for c in chunks])

    def execute(self) -> Chunk:
        p = self.plan
        if self.session._txn_dirty():
            return _union_scan_fallback(
                self.session, p.table, p.scan_slots, p.all_conditions, p.schema, target=p
            )
        from concurrent.futures import ThreadPoolExecutor

        if len(p.paths) > 1:
            with ThreadPoolExecutor(max_workers=min(4, len(p.paths)), thread_name_prefix="imerge") as pool:
                handle_sets = list(pool.map(self._path_handles, p.paths))
        else:
            handle_sets = [self._path_handles(path) for path in p.paths]
        if p.intersection:
            handles = handle_sets[0]
            for h in handle_sets[1:]:
                handles = np.intersect1d(handles, h)
        else:
            handles = np.unique(np.concatenate(handle_sets)) if handle_sets else np.empty(0, np.int64)
        if not len(handles):
            return _empty_chunk(p.schema)
        reader = PhysTableReader(
            db=p.db,
            table=p.table,
            store_type=StoreType.HOST,
            pushed_conditions=list(p.residual_conditions),
            scan_slots=list(p.scan_slots),
            ranges=_coalesce_handle_ranges(p.table.id, handles),
            schema=p.schema,
        )
        return TableReaderExec(reader, self.session, detail_target=p).execute()


@dataclass
class SelectionExec(Executor):
    plan: PhysSelection
    child: Executor
    session: object = None

    def __post_init__(self):
        self.schema = self.plan.schema

    def execute(self) -> Chunk:
        chunk = self.child.execute()
        warn = self.session.append_warning if self.session is not None else None
        return host_selection(chunk, [c.to_pb() for c in self.plan.conditions], warn=warn)


@dataclass
class ProjectionExec(Executor):
    plan: PhysProjection
    child: Executor
    session: object = None

    def __post_init__(self):
        self.schema = self.plan.schema

    def execute(self) -> Chunk:
        chunk = self.child.execute()
        warn = self.session.append_warning if self.session is not None else None
        batch = EvalBatch.from_chunk(chunk, warn=warn)
        if len(chunk) == 0:
            return _empty_chunk(self.plan.schema)
        return Chunk([eval_to_column(e, batch, np) for e in self.plan.exprs])


@dataclass
class FinalAggExec(Executor):
    plan: PhysFinalAgg
    child: Executor
    session: object = None

    # engage the partial/final worker pipeline past this input size
    PARALLEL_MIN_ROWS = 200_000

    def __post_init__(self):
        self.schema = self.plan.schema

    def execute(self) -> Chunk:
        chunk = self.child.execute()
        aggs = self.plan.aggs
        # rollup partials interleave GROUPING() flags after the keys — the
        # merge identity is (keys, flags) and both pass through
        ngroup = len(self.plan.group_by) * (2 if getattr(self.plan, "rollup", False) else 1)
        if not self.plan.partial_input:
            splittable = not any(a.distinct or a.name == "group_concat" for a in aggs)
            if splittable and len(chunk) >= self.PARALLEL_MIN_ROWS:
                return self._partial_final_pipeline(chunk)
            ex = dagpb.ExecutorPB(
                dagpb.AGGREGATION,
                group_by=[g.to_pb() for g in self.plan.group_by],
                aggs=[a.to_pb() for a in aggs],
                agg_mode=dagpb.AGG_COMPLETE,
            )
            return host_aggregate(chunk, ex)
        return merge_partials(chunk, aggs, ngroup)

    def _partial_final_pipeline(self, chunk: Chunk) -> Chunk:
        """Partial/final worker pipeline (ref: parallel HashAgg,
        aggregate/agg_hash_executor.go:94): slices aggregate to partial
        state concurrently; partials spill through a tracker-registered
        RowContainer (ref: agg_spill.go) before the final merge."""
        from concurrent.futures import ThreadPoolExecutor

        from tidb_tpu_torch.utils.rowcontainer import RowContainer

        p = self.plan
        n = len(chunk)
        conc = 4
        tracker = None
        if self.session is not None:
            from tidb_tpu_torch.session.session import executor_concurrency

            conc = executor_concurrency(self.session.vars, "tidb_hashagg_partial_concurrency")
            tracker = getattr(self.session, "mem_tracker", None)
        per = max((n + conc - 1) // conc, 65536)
        bounds = [(i, min(i + per, n)) for i in range(0, n, per)]
        pex = dagpb.ExecutorPB(
            dagpb.AGGREGATION,
            group_by=[g.to_pb() for g in p.group_by],
            aggs=[a.to_pb() for a in p.aggs],
            agg_mode=dagpb.AGG_PARTIAL,
        )
        rc = RowContainer(tracker, "agg-partials")
        try:
            if len(bounds) > 1:
                with ThreadPoolExecutor(max_workers=min(conc, len(bounds)), thread_name_prefix="agg") as pool:
                    parts = list(pool.map(lambda b: host_aggregate(chunk.slice(*b), pex), bounds))
            else:
                parts = [host_aggregate(chunk.slice(*b), pex) for b in bounds]
            for part in parts:
                rc.add(part)
            merged = rc.to_chunk()
        finally:
            rc.close()
        if merged is None or not len(merged):
            # empty input: fall through to the complete-mode scalar handling
            ex = dagpb.ExecutorPB(
                dagpb.AGGREGATION,
                group_by=[g.to_pb() for g in p.group_by],
                aggs=[a.to_pb() for a in p.aggs],
                agg_mode=dagpb.AGG_COMPLETE,
            )
            return host_aggregate(chunk, ex)
        return merge_partials(merged, p.aggs, len(p.group_by))


def merge_partials(chunk: Chunk, aggs: list[AggDesc], ngroup: int) -> Chunk:
    """Merge per-region partial-state chunks into final values (ref: the
    final-mode HashAgg above a partial cop agg, aggregate/agg_hash_executor)."""
    ncols = chunk.num_cols
    key_cols = chunk.columns[ncols - ngroup :] if ngroup else []
    n = len(chunk)
    # group rows by key columns; ci string keys group by their general_ci
    # WEIGHT class (per-region partials may split 'a'/'A'/'á' — the merge
    # is where they collapse, ref: collate-aware final HashAgg)
    def _key_lane(c) -> np.ndarray:
        from tidb_tpu_torch.utils.collate import canon_codes, is_ci_string

        if is_ci_string(c):
            return canon_codes(c.data, c.validity, c.dictionary)
        return c.data

    if ngroup and n:
        key_lanes = [_key_lane(c) for c in key_cols]
        lanes = []
        for c, kd in zip(key_cols, key_lanes):
            lanes.append(kd)
            lanes.append(~c.validity)
        perm = np.lexsort(tuple(reversed(lanes)))
        boundary = np.zeros(n, dtype=bool)
        boundary[0] = True
        for c, kd in zip(key_cols, key_lanes):
            ds, vs = kd[perm], c.validity[perm]
            boundary[1:] |= ds[1:] != ds[:-1]
            boundary[1:] |= vs[1:] != vs[:-1]
        seg = np.cumsum(boundary) - 1
        ngroups = int(seg[-1]) + 1
    else:
        perm = np.arange(n)
        seg = np.zeros(n, dtype=np.int64)
        ngroups = 1 if (n or not ngroup) else 0
        boundary = np.zeros(n, dtype=bool)
        if n:
            boundary[0] = True

    state_cols: list[Column] = []
    i = 0
    for a in aggs:
        for pk in a.partial_kinds:
            c = chunk.columns[i]
            i += 1
            data, valid = c.data[perm], c.validity[perm]
            if pk in ("count",):
                out = np.bincount(seg, weights=data, minlength=ngroups).astype(np.int64)
                state_cols.append(Column(out, np.ones(ngroups, bool), c.ftype))
            elif pk == "sum":
                w = np.where(valid, data, 0)
                if data.dtype == np.float64:
                    out = np.bincount(seg, weights=w, minlength=ngroups)
                else:
                    out = np.zeros(ngroups, dtype=np.int64)
                    np.add.at(out, seg, w)
                anyv = np.zeros(ngroups, dtype=bool)
                np.logical_or.at(anyv, seg, valid)
                state_cols.append(Column(out.astype(data.dtype), anyv, c.ftype))
            elif pk in ("min", "max"):
                from tidb_tpu_torch.copr.host_engine import (
                    _string_minmax,
                    minmax_sentinel,
                    string_minmax_needs_rank,
                )

                if string_minmax_needs_rank(c.ftype, c.dictionary):
                    # partial states carry dictionary CODES; merging them raw
                    # has the same misordering as the cop-side reduce (ci
                    # weight order / unsorted dictionary — see host_engine)
                    out, cntv = _string_minmax(
                        pk, data, valid, seg, ngroups, c.dictionary,
                        c.ftype.collation == "ci",
                    )
                    state_cols.append(Column(out, cntv > 0, c.ftype, c.dictionary))
                else:
                    sentinel = minmax_sentinel(pk, data.dtype)
                    d = np.where(valid, data, sentinel).astype(data.dtype)
                    out = np.full(ngroups, sentinel, dtype=data.dtype)
                    (np.minimum if pk == "min" else np.maximum).at(out, seg, d)
                    anyv = np.zeros(ngroups, dtype=bool)
                    np.logical_or.at(anyv, seg, valid)
                    state_cols.append(Column(out, anyv, c.ftype, c.dictionary))
            elif pk == "first_row":
                first_idx = np.nonzero(boundary)[0] if n else np.empty(0, np.int64)
                # first VALID row per group preferred
                out = np.zeros(ngroups, dtype=data.dtype)
                anyv = np.zeros(ngroups, dtype=bool)
                # walk groups: take first valid value
                order = np.lexsort((np.arange(n), ~valid, seg)) if n else np.empty(0, np.int64)
                if n:
                    b2 = np.ones(n, dtype=bool)
                    b2[1:] = seg[order][1:] != seg[order][:-1]
                    firsts = order[b2]
                    out[seg[firsts]] = data[firsts]
                    anyv[seg[firsts]] = valid[firsts]
                state_cols.append(Column(out, anyv, c.ftype, c.dictionary))
            elif pk == "sumsq":
                # partial sums of squares (double) merge by addition
                out = np.bincount(seg, weights=np.where(valid, data, 0.0), minlength=ngroups)
                anyv = np.zeros(ngroups, dtype=bool)
                np.logical_or.at(anyv, seg, valid)
                state_cols.append(Column(out, anyv, c.ftype))
            elif pk in ("bit_and", "bit_or", "bit_xor"):
                from tidb_tpu_torch.copr.host_engine import bit_reduce

                out = bit_reduce(pk, data, valid, seg, ngroups)
                state_cols.append(Column(out, np.ones(ngroups, bool), c.ftype))
            elif pk == "group_concat":
                # group_concat never pushes partials (planner gate); merging
                # would need value-order metadata the lanes don't carry
                raise ValueError("group_concat cannot merge as a partial aggregate")
    # key outputs: value at first row of each group
    out_keys: list[Column] = []
    if ngroup and n:
        firsts = np.nonzero(boundary)[0]
        for c in key_cols:
            out_keys.append(Column(c.data[perm][firsts], c.validity[perm][firsts], c.ftype, c.dictionary))
    elif ngroup:
        out_keys = [Column(np.empty(0, c.data.dtype), np.empty(0, bool), c.ftype, c.dictionary) for c in key_cols]
    partial = Chunk(state_cols + out_keys)
    if ngroups == 0 and ngroup == 0:
        # scalar agg over empty input: synthesize the empty-partial row
        pass
    group_fts = [c.ftype for c in key_cols]
    group_dicts = [c.dictionary for c in key_cols]
    return finalize_agg(partial, aggs, group_fts, group_dicts)


@dataclass
class SortExec(Executor):
    plan: PhysSort
    child: Executor

    def __post_init__(self):
        self.schema = self.plan.schema

    def execute(self) -> Chunk:
        chunk = self.child.execute()
        if len(chunk) == 0:
            return chunk
        perm = sort_perm(chunk, [[e.to_pb(), d] for e, d in self.plan.by])
        return chunk.take(perm)


@dataclass
class LimitExec(Executor):
    plan: PhysLimit
    child: Executor

    def __post_init__(self):
        self.schema = self.plan.schema

    def execute(self) -> Chunk:
        chunk = self.child.execute()
        return chunk.slice(min(self.plan.offset, len(chunk)), min(self.plan.offset + self.plan.limit, len(chunk)))


@dataclass
class DistinctExec(Executor):
    child: Executor

    def __post_init__(self):
        self.schema = self.child.schema

    def execute(self) -> Chunk:
        chunk = self.child.execute()
        n = len(chunk)
        if n == 0:
            return chunk

        def key_of(c) -> np.ndarray:
            # codes identify values within one dictionary; ci collations
            # dedupe by general_ci WEIGHT class ('a' ≡ 'A' ≡ 'á')
            from tidb_tpu_torch.utils.collate import canon_codes, is_ci_string

            if is_ci_string(c):
                return canon_codes(c.data, c.validity, c.dictionary)
            return c.data

        keys = [key_of(c) for c in chunk.columns]
        lanes = []
        for c, kd in zip(chunk.columns, keys):
            lanes.append(kd)
            lanes.append(~c.validity)
        perm = np.lexsort(tuple(reversed(lanes)))
        # keep the first row of each distinct key tuple
        diff = np.zeros(n, dtype=bool)
        diff[0] = True
        for c, kd in zip(chunk.columns, keys):
            ds, vs = kd[perm], c.validity[perm]
            diff[1:] |= ds[1:] != ds[:-1]
            diff[1:] |= vs[1:] != vs[:-1]
        return chunk.take(np.sort(perm[diff]))


@dataclass
class WindowExec(Executor):
    """Window functions (ref: pkg/executor WindowExec + pipelined window
    workers, collapsed to a sorted-partition sweep). Supported frames: whole
    partition, RANGE UNBOUNDED..CURRENT (peers share the frame — the MySQL
    default with ORDER BY) and ROWS UNBOUNDED..CURRENT."""

    plan: PhysWindow
    child: Executor
    session: object = None

    def __post_init__(self):
        self.schema = self.plan.schema

    def execute(self) -> Chunk:
        p = self.plan
        chunk = self.child.execute()
        n = len(chunk)
        if n == 0:
            return Chunk(
                list(chunk.columns)
                + [
                    Column(np.empty(0, _np_dtype(f.ftype)), np.empty(0, bool), f.ftype)
                    for f in p.funcs
                ]
            )
        dev = self._try_device(chunk, n)
        if dev is not None:
            return dev
        keys = [[e.to_pb(), False] for e in p.partition_by] + [
            [e.to_pb(), d] for e, d in p.order_by
        ]
        perm = sort_perm(chunk, keys) if keys else np.arange(n)
        batch = EvalBatch.from_chunk(chunk)
        part_start = np.zeros(n, dtype=bool)
        part_start[0] = True
        for e in p.partition_by:
            c = eval_to_column(e, batch, np)
            # mask NULL slots: computed-expression garbage must not split a
            # NULL partition (same rule as the device kernel)
            d, v = np.where(c.validity, c.data, 0)[perm], c.validity[perm]
            part_start[1:] |= (d[1:] != d[:-1]) | (v[1:] != v[:-1])
        # order-key peer groups: ranking functions always use these, whatever
        # the frame says (MySQL ignores frames for ranking)
        peer_start = part_start.copy()
        for e, _ in p.order_by:
            c = eval_to_column(e, batch, np)
            d, v = np.where(c.validity, c.data, 0)[perm], c.validity[perm]
            peer_start[1:] |= (d[1:] != d[:-1]) | (v[1:] != v[:-1])
        pbounds = np.flatnonzero(part_start).tolist() + [n]
        out_cols = []
        for f in p.funcs:
            argcols = [eval_to_column(a, batch, np) for a in f.args]
            sdata, svalid = self._compute(f, argcols, perm, pbounds, peer_start)
            data = np.empty(n, dtype=sdata.dtype)
            valid = np.empty(n, dtype=bool)
            data[perm] = sdata
            valid[perm] = svalid
            dic = (
                argcols[0].dictionary
                if argcols and argcols[0].ftype.kind == TypeKind.STRING
                else None
            )
            out_cols.append(Column(data, valid, f.ftype, dic))
        return Chunk(list(chunk.columns) + out_cols)

    def _try_device(self, chunk: Chunk, n: int):
        """Window evaluation on the store's card through ops/window_kernel
        (the sorted-batch segment program) when the shape qualifies; None →
        the host sweep. None only for the shape, the engines, the size gate
        or the cost model: a device failure raises."""
        import torch

        from tidb_tpu_torch.copr import gpu_engine
        from tidb_tpu_torch.ops import window_core as wc
        from tidb_tpu_torch.ops import window_kernel as wk
        from tidb_tpu_torch.utils import metrics as _metrics

        p = self.plan
        if self.session is None or n > wk.DEVICE_MAX_ROWS:
            return None
        engines = str(self.session.vars.get("tidb_isolation_read_engines", "gpu,host"))
        if "gpu" not in engines:
            return None
        # phase 1: reject on static structure only (expression ftypes and
        # plan-time constants) — no column evaluation until the shape is
        # known-supported, so fallbacks don't pay O(n) twice
        spec_res = wc.derive_specs(
            p.funcs,
            whole_partition=p.whole_partition,
            rows_frame=p.rows_frame,
            frame=p.frame,
            # dict codes are not ORDER-comparable at this layer (the cop
            # binder legalizes them with sorted dictionaries; here the chunk
            # may carry arbitrary-order codes)
            order_is_string=any(e.ftype.kind == TypeKind.STRING for e, _ in p.order_by),
        )
        if spec_res is None:
            return None
        frame_tag, specs = spec_res
        # measured-cost routing: the device wins when its fixed cost, the
        # copies and its per-row work undercut the host sweep
        n_lanes_up = len(p.partition_by) + len(p.order_by) + sum(1 for _n, ha, *_ in specs if ha)
        if not wk.device_beats_host(n, n_lanes_up, len(p.funcs)):
            return None

        # phase 2: evaluate lanes (shape is supported from here on)
        batch = EvalBatch.from_chunk(chunk)

        def lane_of(e):
            c = eval_to_column(e, batch, np)
            return (c.data.astype(np.float64 if c.ftype.kind == TypeKind.FLOAT else np.int64), c.validity)

        # partition keys need only identity → dictionary codes qualify
        part = [lane_of(e) for e in p.partition_by]
        order = [lane_of(e) for e, _ in p.order_by]
        arg_lanes = [lane_of(f.args[0]) if sp[1] else None for f, sp in zip(p.funcs, specs)]

        from tidb_tpu_torch.utils.chunk import bucket_size

        n_pad = bucket_size(n)
        # integer sort-lane bounds (one numpy pass) enable the packed
        # single-key sort; past MULTILANE_MAX_ROWS an unpackable sort stays
        # on the host sweep
        bounds = []
        for d, v in part + order:
            if np.issubdtype(d.dtype, np.floating):
                bounds.append(None)
                continue
            lv = d[v]
            bounds.append((int(lv.min()), int(lv.max())) if lv.size else (0, 0))
        bounds = wc.widen_bounds(bounds)
        if wc.packed_bits(bounds, n_pad) is None:
            if n > wk.MULTILANE_MAX_ROWS:
                return None
            bounds = None

        dev = gpu_engine.store_device(self.session.store)
        h2d = 0

        def up(pair):
            nonlocal h2d
            d, v = pair
            pd = np.zeros(n_pad, dtype=d.dtype)
            pd[:n] = d
            pv = np.zeros(n_pad, dtype=bool)
            pv[:n] = v
            h2d += pd.nbytes + pv.nbytes
            return (torch.from_numpy(pd).to(dev), torch.from_numpy(pv).to(dev))

        spec = (len(part), tuple(d for _, d in p.order_by), frame_tag, tuple(specs))
        fn = wk.get_window_fn(spec, n_pad, tuple(bounds) if bounds is not None else None)
        flat = fn(
            tuple(up(x) for x in part),
            tuple(up(x) for x in order),
            # only real arg lanes travel: they ride the sort as payloads
            tuple(up(x) for x in arg_lanes if x is not None),
            n,
            dev,
        )
        _metrics.DEVICE_TRANSFER.inc(h2d, dir="h2d")
        # one copy off the card: every lane as int64 rows (a float lane's
        # bits reinterpreted), cut to the live rows
        rows = [x.view(torch.int64) if x.is_floating_point() else x.to(torch.int64) for x in flat]
        got = gpu_engine._d2h(torch.stack(rows)[:, :n])
        out_cols = []
        for i, f in enumerate(p.funcs):
            data = got[2 * i].view(np.float64) if flat[2 * i].is_floating_point() else got[2 * i]
            valid = got[2 * i + 1].astype(bool)
            dt = _np_dtype(f.ftype)
            out_cols.append(Column(data.astype(dt, copy=False), valid, f.ftype))
        return Chunk(list(chunk.columns) + out_cols)

    def _compute(self, f, argcols, perm, pbounds, peer_start):
        """Returns (data, validity) arrays in sorted-row order."""
        p = self.plan
        n = len(perm)
        dt = _np_dtype(f.ftype)
        out = np.zeros(n, dtype=dt)
        valid = np.ones(n, dtype=bool)
        av = argcols[0].data[perm] if argcols else None
        vv = argcols[0].validity[perm] if argcols else None
        mm_rank = mm_codes = None  # lazily-built MIN/MAX comparison lanes
        for s, e in zip(pbounds, pbounds[1:]):
            m = e - s
            ps = peer_start[s:e]
            starts = np.flatnonzero(ps)
            ends = np.r_[starts[1:], m]
            sizes = ends - starts
            # frame [fs, fe) per row under the supported frames
            fs = np.zeros(m, dtype=np.int64)
            if p.frame is not None:
                skind, sn, ekind, en = p.frame
                idx = np.arange(m, dtype=np.int64)
                if skind == "unbounded":
                    fs = np.zeros(m, dtype=np.int64)
                elif skind == "current":
                    fs = idx
                elif skind == "preceding":
                    fs = np.maximum(idx - sn, 0)
                else:  # following
                    fs = np.minimum(idx + sn, m)
                if ekind == "unbounded":
                    fe = np.full(m, m, dtype=np.int64)
                elif ekind == "current":
                    fe = idx + 1
                elif ekind == "preceding":
                    fe = np.maximum(idx - en + 1, 0)
                else:  # following
                    fe = np.minimum(idx + en + 1, m)
                fe = np.maximum(fe, fs)  # empty frames: fe == fs
            elif p.whole_partition:
                fe = np.full(m, m, dtype=np.int64)
            elif p.rows_frame:
                fe = np.arange(1, m + 1, dtype=np.int64)
            else:  # RANGE ..CURRENT: peers share the frame
                fe = np.repeat(ends, sizes)
            name = f.name
            if name == "row_number":
                out[s:e] = np.arange(1, m + 1)
            elif name == "rank":
                out[s:e] = np.repeat(starts + 1, sizes)
            elif name == "dense_rank":
                out[s:e] = np.repeat(np.arange(1, len(starts) + 1), sizes)
            elif name == "percent_rank":
                r = np.repeat(starts, sizes).astype(np.float64)
                out[s:e] = r / (m - 1) if m > 1 else 0.0
            elif name == "cume_dist":
                out[s:e] = np.repeat(ends, sizes) / float(m)
            elif name == "ntile":
                k = int(av[s])
                q, rem = divmod(m, k)
                bsizes = np.array([q + 1] * rem + [q] * (k - rem), dtype=np.int64)
                out[s:e] = np.repeat(np.arange(1, k + 1), bsizes)[:m]
            elif name in ("lead", "lag"):
                # offset/default are plan-time constants (builder enforces)
                off = int(argcols[1].data[0]) if len(argcols) > 1 else 1
                shift = -off if name == "lead" else off
                src = np.arange(m) - shift
                ok = (src >= 0) & (src < m)
                idx = np.clip(src, 0, m - 1)
                out[s:e] = np.where(ok, av[s:e][idx], 0)
                valid[s:e] = np.where(ok, vv[s:e][idx], False)
                if len(argcols) > 2:  # explicit default
                    dcol = argcols[2]
                    dvalid = bool(dcol.validity[0])
                    if argcols[0].ftype.kind == TypeKind.STRING and dvalid:
                        # re-encode into the argument's dictionary — the
                        # constant's private dictionary codes don't transfer
                        dv = argcols[0].dictionary.encode(dcol.logical_value(0))
                    else:
                        dv = dcol.data[0]
                    out[s:e] = np.where(ok, out[s:e], dv)
                    valid[s:e] = np.where(ok, valid[s:e], dvalid)
            elif name == "first_value":
                nonempty = fe > fs
                fs_c = np.clip(fs, 0, m - 1)
                out[s:e] = np.where(nonempty, av[s:e][fs_c], 0)
                valid[s:e] = np.where(nonempty, vv[s:e][fs_c], False)
            elif name == "last_value":
                nonempty = fe > fs
                fe_c = np.clip(fe - 1, 0, m - 1)
                out[s:e] = np.where(nonempty, av[s:e][fe_c], 0)
                valid[s:e] = np.where(nonempty, vv[s:e][fe_c], False)
            elif name in ("count", "sum", "avg", "min", "max"):
                if name == "count" and not argcols:
                    out[s:e] = fe - fs
                    continue
                pvv = vv[s:e]
                c0 = np.r_[0, np.cumsum(pvv.astype(np.int64))]
                cnt = c0[fe] - c0[fs]
                if name == "count":
                    out[s:e] = cnt
                    continue
                pav = av[s:e]
                if name in ("min", "max"):
                    if mm_rank is None:
                        mm_rank, mm_codes = _cmp_lanes(argcols[0], av)
                    rank = mm_rank[s:e]
                    if rank.dtype == np.float64:
                        fill = np.inf if name == "min" else -np.inf
                    else:
                        fill = np.iinfo(np.int64).max if name == "min" else np.iinfo(np.int64).min
                    lane = np.where(pvv, rank, fill)
                    if p.frame is None:
                        acc = (np.minimum if name == "min" else np.maximum).accumulate(lane)
                        best = acc[np.maximum(fe - 1, 0)]
                    else:
                        best = _sliding_extreme(lane, fs, fe, name == "min", fill)
                    if mm_codes is not None:
                        # all-NULL frames carry the sentinel — mask before the
                        # rank→code fancy index, not after
                        best = np.where(cnt > 0, best, 0)
                        res = mm_codes[best.astype(np.int64)]
                    else:
                        res = best
                    out[s:e] = np.where(cnt > 0, res.astype(dt, copy=False), 0)
                    valid[s:e] = cnt > 0
                    continue
                filled = np.where(pvv, pav, 0)
                s0 = np.r_[
                    0, np.cumsum(filled.astype(np.float64 if dt == np.float64 else np.int64))
                ]
                cum = s0[fe] - s0[fs]
                if name == "sum":
                    out[s:e] = np.where(cnt > 0, cum.astype(dt, copy=False), 0)
                    valid[s:e] = cnt > 0
                else:  # avg
                    safe = np.maximum(cnt, 1)
                    if f.ftype.kind == TypeKind.DECIMAL:
                        scale_up = 10 ** (f.ftype.scale - argcols[0].ftype.scale)
                        out[s:e] = np.where(
                            cnt > 0, np.round(cum * scale_up / safe).astype(np.int64), 0
                        )
                    else:
                        out[s:e] = np.where(cnt > 0, cum / safe, 0.0)
                    valid[s:e] = cnt > 0
            else:
                raise ExecError(f"unsupported window function {name}")
        return out, valid


def _sliding_extreme(lane, fs, fe, is_min: bool, fill):
    """MIN/MAX over sliding [fs, fe) frames via a monotonic deque (frame
    bounds are nondecreasing for ROWS frames → O(n) total)."""
    from collections import deque

    m = len(lane)
    out = np.full(m, fill, dtype=lane.dtype)
    dq: deque = deque()  # indices, lane values monotonic
    lo = 0
    hi = 0
    better = (lambda a, b: a <= b) if is_min else (lambda a, b: a >= b)
    for i in range(m):
        while hi < fe[i]:
            v = lane[hi]
            while dq and better(v, lane[dq[-1]]):
                dq.pop()
            dq.append(hi)
            hi += 1
        while lo < fs[i]:
            if dq and dq[0] == lo:
                dq.popleft()
            lo += 1
        if dq and fe[i] > fs[i]:
            out[i] = lane[dq[0]]
    return out


def _np_dtype(ftype):
    return {TypeKind.FLOAT: np.float64, TypeKind.STRING: np.int32}.get(ftype.kind, np.int64)


def _cmp_lanes(col, data):
    """(comparison lane, rank→code lookup) for cumulative MIN/MAX: plain
    lanes compare directly; unsorted-dictionary strings compare by value
    rank, mapped back to codes afterwards."""
    if col.ftype.kind == TypeKind.STRING and col.dictionary is not None and not col.dictionary.sorted:
        vals = col.dictionary.decode_many(data)
        order = {v: i for i, v in enumerate(sorted(set(vals)))}
        rank = np.fromiter((order[v] for v in vals), dtype=np.int64, count=len(vals))
        code_for_rank = np.zeros(len(order), dtype=np.int64)
        for v, c in zip(vals, data):
            code_for_rank[order[v]] = c
        return rank, code_for_rank
    return data.astype(np.int64, copy=False) if data.dtype != np.float64 else data, None


@dataclass
class SetOpExec(Executor):
    """UNION / INTERSECT / EXCEPT with multiset (ALL) or set semantics
    (ref: UnionExec + set-operation rewrites). Row identity uses logical
    values, so NULLs compare equal as MySQL set ops require."""

    plan: PhysSetOp
    childs: list

    def __post_init__(self):
        self.schema = self.plan.schema

    def execute(self) -> Chunk:
        from collections import Counter

        l, r = (c.execute() for c in self.childs)
        op, all_ = self.plan.op, self.plan.all
        if op == "union" and all_ and self._concat_ok(l, r):
            return Chunk.concat([l, r])
        lrows, rrows = l.rows(), r.rows()
        if op == "union":
            rows = lrows + rrows
            if not all_:
                rows = list(dict.fromkeys(rows))
        elif op == "intersect":
            rc = Counter(rrows)
            rows = []
            if all_:
                for t in lrows:
                    if rc[t] > 0:
                        rows.append(t)
                        rc[t] -= 1
            else:
                seen: set = set()
                for t in lrows:
                    if rc[t] > 0 and t not in seen:
                        rows.append(t)
                        seen.add(t)
        else:  # except
            rc = Counter(rrows)
            rows = []
            if all_:
                for t in lrows:
                    if rc[t] > 0:
                        rc[t] -= 1
                    else:
                        rows.append(t)
            else:
                seen = set()
                for t in lrows:
                    if rc[t] == 0 and t not in seen:
                        rows.append(t)
                        seen.add(t)
        cols = [
            Column.from_values([row[i] for row in rows], oc.ftype)
            for i, oc in enumerate(self.schema)
        ]
        return Chunk(cols)

    @staticmethod
    def _concat_ok(l: Chunk, r: Chunk) -> bool:
        """Physical concat is sound unless string lanes use different
        dictionaries (codes would collide)."""
        for lc, rc in zip(l.columns, r.columns):
            if lc.ftype.kind == TypeKind.STRING and lc.dictionary is not rc.dictionary:
                return False
        return True


@dataclass
class HashJoinExec(Executor):
    plan: PhysHashJoin
    left: Executor
    right: Executor
    session: object = None

    def __post_init__(self):
        self.schema = self.plan.schema

    def _key_array(self, chunk: Chunk, idx: int):
        c = chunk.columns[idx]
        if c.ftype.kind == TypeKind.STRING and c.dictionary is not None:
            # cross-table joins: dictionaries differ → join on bytes
            return np.array([None if not c.validity[i] else c.dictionary.decode(int(c.data[i])) for i in range(len(c))], dtype=object)
        return c.data

    def execute(self) -> Chunk:
        p = self.plan
        lc = self.left.execute()
        rc = self.right.execute()
        if p.kind in ("semi", "anti"):
            return self._semi_anti(lc, rc)
        if p.kind == "cross" and not p.eq_conds:
            li = np.repeat(np.arange(len(lc)), len(rc))
            ri = np.tile(np.arange(len(rc)), len(lc))
            joined = Chunk(
                [c.take(li) for c in lc.columns] + [c.take(ri) for c in rc.columns]
            )
            return self._apply_other(joined)
        # grace-join spill (ref: join/hash_join_spill.go): when the inputs
        # exceed a share of the memory quota, partition both sides by key
        # hash and join partition-by-partition, accumulating output through
        # a tracker-registered spillable container — peak memory is bounded
        # by one partition plus spilled output pages
        tracker = getattr(self.session, "mem_tracker", None) if self.session is not None else None
        quota = tracker.limit if tracker is not None and tracker.limit > 0 else -1
        if quota > 0 and p.eq_conds:
            in_bytes = sum(
                c.data.nbytes + c.validity.nbytes for c in list(lc.columns) + list(rc.columns)
            )
            numeric = not any(
                lc.columns[l].ftype.kind == TypeKind.STRING or rc.columns[r].ftype.kind == TypeKind.STRING
                for l, r in p.eq_conds
            )
            if in_bytes > quota // 4 and numeric:
                return self._partitioned_join(lc, rc, in_bytes, quota, tracker)
        return self._join_pair(lc, rc)

    def _partitioned_join(self, lc: Chunk, rc: Chunk, in_bytes: int, quota: int, tracker) -> Chunk:
        from tidb_tpu_torch.utils.rowcontainer import RowContainer

        p = self.plan
        K = 2
        while K < 64 and in_bytes // K > max(quota // 8, 1):
            K *= 2
        MIX = np.int64(-7046029254386353131)

        def owners(chunk, poss):
            with np.errstate(over="ignore"):
                h = chunk.columns[poss[0]].data.astype(np.int64).copy()
                for pos in poss[1:]:
                    h = h * MIX + chunk.columns[pos].data.astype(np.int64)
            return (np.abs(h) % K).astype(np.int64)

        lown = owners(lc, [l for l, _ in p.eq_conds])
        rown = owners(rc, [r for _, r in p.eq_conds])
        out = RowContainer(tracker, "join-output")
        try:
            for k in range(K):
                lsub = lc.take(np.nonzero(lown == k)[0])
                rsub = rc.take(np.nonzero(rown == k)[0])
                if len(lsub) == 0 and (p.kind != "right" or len(rsub) == 0):
                    continue
                part = self._join_pair(lsub, rsub)
                if len(part):
                    out.add(part)
            merged = out.to_chunk()
        finally:
            out.close()
        return merged if merged is not None else _empty_chunk(self.schema)

    def _join_pair(self, lc: Chunk, rc: Chunk) -> Chunk:
        p = self.plan
        # build on right, probe left (ref: hash_join build/probe)
        rkeys = [self._key_array(rc, r) for _, r in p.eq_conds]
        rvalid = [rc.columns[r].validity for _, r in p.eq_conds]
        lkeys = [self._key_array(lc, l) for l, _ in p.eq_conds]
        lvalid = [lc.columns[l].validity for l, _ in p.eq_conds]
        vec = self._vector_match(lkeys, lvalid, rkeys, rvalid)
        if vec is not None:
            li, ri, rmatched, lmatched = vec
            lmiss = list(np.nonzero(~lmatched)[0])
        else:
            table: dict = {}
            for j in range(len(rc)):
                if all(v[j] for v in rvalid):
                    k = tuple(ka[j] for ka in rkeys)
                    table.setdefault(k, []).append(j)
            li_list: list[int] = []
            ri_list: list[int] = []
            lmiss = []
            rmatched = np.zeros(len(rc), dtype=bool)
            for i in range(len(lc)):
                if all(v[i] for v in lvalid):
                    k = tuple(ka[i] for ka in lkeys)
                    hits = table.get(k)
                    if hits:
                        for j in hits:
                            li_list.append(i)
                            ri_list.append(j)
                            rmatched[j] = True
                        continue
                lmiss.append(i)
            li = np.asarray(li_list, dtype=np.int64)
            ri = np.asarray(ri_list, dtype=np.int64)
        cols = [c.take(li) for c in lc.columns] + [c.take(ri) for c in rc.columns]
        joined = Chunk(cols)
        joined = self._apply_other(joined)
        if p.kind == "left" and lmiss:
            lm = np.asarray(lmiss, dtype=np.int64)
            null_right = [
                Column(np.zeros(len(lm), c.data.dtype), np.zeros(len(lm), bool), c.ftype, c.dictionary)
                for c in rc.columns
            ]
            miss = Chunk([c.take(lm) for c in lc.columns] + null_right)
            joined = Chunk.concat([joined, miss]) if len(joined) else miss
        elif p.kind == "right":
            rmiss = np.nonzero(~rmatched)[0]
            if len(rmiss):
                null_left = [
                    Column(np.zeros(len(rmiss), c.data.dtype), np.zeros(len(rmiss), bool), c.ftype, c.dictionary)
                    for c in lc.columns
                ]
                miss = Chunk(null_left + [c.take(rmiss) for c in rc.columns])
                joined = Chunk.concat([joined, miss]) if len(joined) else miss
        return joined

    @staticmethod
    def _vector_match(lkeys, lvalid, rkeys, rvalid):
        """Vectorized equi-match for numeric keys: mix key lanes, sort the
        build side, expand probe matches via searchsorted + cumsum (the host
        analog of the MPP expansion join) with exact per-component
        verification. Returns (li, ri, rmatched, lmatched) or None when any
        key lane is non-numeric (object dtype → generic dict path).
        Replaces a per-row Python build/probe loop that cost ~15s/M rows."""
        if any(k.dtype == object for k in lkeys + rkeys):
            return None
        MIX = np.int64(-7046029254386353131)
        with np.errstate(over="ignore"):
            lk = lkeys[0].astype(np.int64).copy()
            rk = rkeys[0].astype(np.int64).copy()
            for a in lkeys[1:]:
                lk = lk * MIX + a.astype(np.int64)
            for a in rkeys[1:]:
                rk = rk * MIX + a.astype(np.int64)
        lval = np.ones(len(lk), dtype=bool)
        for v in lvalid:
            lval &= v
        rval = np.ones(len(rk), dtype=bool)
        for v in rvalid:
            rval &= v
        rperm = np.argsort(np.where(rval, rk, np.iinfo(np.int64).max), kind="stable")
        rk_s = np.where(rval, rk, np.iinfo(np.int64).max)[rperm]
        pk = np.where(lval, lk, np.iinfo(np.int64).max - 1)
        lo = np.searchsorted(rk_s, pk, side="left")
        hi = np.searchsorted(rk_s, pk, side="right")
        cnt = np.where(lval, hi - lo, 0)
        total = int(cnt.sum())
        li = np.repeat(np.arange(len(lk)), cnt)
        base = np.repeat(np.cumsum(cnt) - cnt, cnt)
        ri_s = np.repeat(lo, cnt) + (np.arange(total) - base)
        ri = rperm[ri_s]
        # exact verification: a mix collision must not fabricate a match, and
        # a legal probe key equal to the int64 sentinel must not range over
        # NULL build slots (mirrors _local_expand_join's rvalid mask)
        live = rval[ri]
        for la, ra in zip(lkeys, rkeys):
            live &= la[li] == ra[ri]
        li, ri = li[live], ri[live]
        rmatched = np.zeros(len(rk), dtype=bool)
        rmatched[ri] = True
        lmatched = np.zeros(len(lk), dtype=bool)
        lmatched[li] = True
        return li, ri, rmatched, lmatched

    def _semi_anti(self, lc: Chunk, rc: Chunk) -> Chunk:
        """[NOT] EXISTS / [NOT] IN rewrites (ref: semi-join executors). The
        output is the matching (semi) or non-matching (anti) LEFT rows."""
        p = self.plan
        if p.kind == "anti" and p.null_aware:
            return self._null_aware_anti(lc, rc)
        if p.other_conds:
            return self._semi_anti_other(lc, rc)
        rkeys = [self._key_array(rc, r) for _, r in p.eq_conds]
        rvalid = [rc.columns[r].validity for _, r in p.eq_conds]
        table: set = set()
        for j in range(len(rc)):
            if all(v[j] for v in rvalid):
                table.add(tuple(ka[j] for ka in rkeys))
        lkeys = [self._key_array(lc, l) for l, _ in p.eq_conds]
        lvalid = [lc.columns[l].validity for l, _ in p.eq_conds]
        keep: list[int] = []
        for i in range(len(lc)):
            key_valid = all(v[i] for v in lvalid)
            matched = key_valid and tuple(ka[i] for ka in lkeys) in table
            if (p.kind == "semi") == matched:
                keep.append(i)
        return Chunk([c.take(np.asarray(keep, dtype=np.int64)) for c in lc.columns])

    def _semi_anti_other(self, lc: Chunk, rc: Chunk) -> Chunk:
        """Semi/anti with non-equality join conditions (ref: the reference's
        Apply → semi join with otherConds): expand candidate pairs on the eq
        keys (all pairs when none — the nested-loop Apply shape), filter the
        joined rows through other_conds, then EXISTS-reduce per left row."""
        p = self.plan
        n_l, n_r = len(lc), len(rc)
        matched = np.zeros(n_l, dtype=bool)

        def probe_pairs(li: np.ndarray, ri: np.ndarray) -> None:
            if not len(li):
                return
            joined = Chunk([c.take(li) for c in lc.columns] + [c.take(ri) for c in rc.columns])
            from tidb_tpu_torch.expression.expr import EvalBatch, eval_to_column, expr_from_pb

            batch = EvalBatch.from_chunk(joined)
            keep = np.ones(len(joined), dtype=bool)
            for c in p.other_conds:
                col = eval_to_column(expr_from_pb(c.to_pb()), batch, np)
                keep &= (col.data != 0) & col.validity
            matched[li[keep]] = True

        # cap the materialized pair batch — the nested loop is O(n_l*n_r)
        # time either way, but memory stays bounded (ref: Apply executor's
        # chunked probing)
        PAIR_BATCH = 1 << 20
        if p.eq_conds:
            rkeys = [self._key_array(rc, r) for _, r in p.eq_conds]
            rvalid = [rc.columns[r].validity for _, r in p.eq_conds]
            table: dict = {}
            for j in range(n_r):
                if all(v[j] for v in rvalid):
                    table.setdefault(tuple(ka[j] for ka in rkeys), []).append(j)
            lkeys = [self._key_array(lc, l) for l, _ in p.eq_conds]
            lvalid = [lc.columns[l].validity for l, _ in p.eq_conds]
            li_list, ri_list = [], []
            for i in range(n_l):
                if all(v[i] for v in lvalid):
                    for j in table.get(tuple(ka[i] for ka in lkeys), ()):
                        li_list.append(i)
                        ri_list.append(j)
                if len(li_list) >= PAIR_BATCH:
                    probe_pairs(np.asarray(li_list, dtype=np.int64), np.asarray(ri_list, dtype=np.int64))
                    li_list, ri_list = [], []
            probe_pairs(np.asarray(li_list, dtype=np.int64), np.asarray(ri_list, dtype=np.int64))
        elif n_r:  # pure non-eq correlation: blocked nested loop
            rows_per_block = max(PAIR_BATCH // n_r, 1)
            for i0 in range(0, n_l, rows_per_block):
                i1 = min(i0 + rows_per_block, n_l)
                li = np.repeat(np.arange(i0, i1, dtype=np.int64), n_r)
                ri = np.tile(np.arange(n_r, dtype=np.int64), i1 - i0)
                probe_pairs(li, ri)
        want = matched if p.kind == "semi" else ~matched
        sel = np.nonzero(want)[0]
        return Chunk([c.take(sel) for c in lc.columns])

    def _null_aware_anti(self, lc: Chunk, rc: Chunk) -> Chunk:
        """NOT IN semantics per correlation group (ref: null-aware anti join,
        hash_join null-aware variants). By construction (builder rewrite) the
        FIRST eq pair is the IN operand; the rest are correlation keys.

        For each left row with correlation group G (right rows whose
        correlation keys match): NOT IN is TRUE iff G is empty, or (operand
        is non-NULL, no NULL among G's IN-column values, and operand ∉ G).
        """
        p = self.plan
        (in_l, in_r), corr = p.eq_conds[0], p.eq_conds[1:]
        rin = self._key_array(rc, in_r)
        rin_valid = rc.columns[in_r].validity
        rcorr = [self._key_array(rc, r) for _, r in corr]
        rcorr_valid = [rc.columns[r].validity for _, r in corr]
        groups: dict = {}  # corr key → [set of in-values, has_null]
        for j in range(len(rc)):
            if not all(v[j] for v in rcorr_valid):
                continue  # NULL correlation key never matches any left row
            g = groups.setdefault(tuple(ka[j] for ka in rcorr), [set(), False])
            if rin_valid[j]:
                g[0].add(rin[j])
            else:
                g[1] = True
        lin = self._key_array(lc, in_l)
        lin_valid = lc.columns[in_l].validity
        lcorr = [self._key_array(lc, l) for l, _ in corr]
        lcorr_valid = [lc.columns[l].validity for l, _ in corr]
        keep: list[int] = []
        for i in range(len(lc)):
            if all(v[i] for v in lcorr_valid):
                g = groups.get(tuple(ka[i] for ka in lcorr))
            else:
                g = None  # NULL correlation key → empty group
            if g is None:
                keep.append(i)  # NOT IN (empty) is TRUE even for NULL operand
                continue
            vals, has_null = g
            if not lin_valid[i] or has_null or lin[i] in vals:
                continue  # NULL operand / NULL in list / match → not TRUE
            keep.append(i)
        return Chunk([c.take(np.asarray(keep, dtype=np.int64)) for c in lc.columns])

    def _apply_other(self, joined: Chunk) -> Chunk:
        if not self.plan.other_conds or len(joined) == 0:
            return joined
        return host_selection(joined, [c.to_pb() for c in self.plan.other_conds])


@dataclass
class MergeJoinExec(Executor):
    """Sort-merge join over handle-ordered reader inputs (ref: executor/join/
    merge_join.go): both children stream ascending on the single join key, so
    matching is two searchsorted sweeps + a cumsum expansion — no hash table."""

    plan: "PhysMergeJoin"
    left: Executor
    right: Executor

    def __post_init__(self):
        self.schema = self.plan.schema

    def execute(self) -> Chunk:
        p = self.plan
        lc = self.left.execute()
        rc = self.right.execute()
        l_pos, r_pos = p.eq_conds[0]
        lk = lc.columns[l_pos]
        rk = rc.columns[r_pos]
        # planner guarantees ascending keys (pk-as-handle readers); NULL keys
        # never match an inner join
        lo = np.searchsorted(rk.data, lk.data, side="left")
        hi = np.searchsorted(rk.data, lk.data, side="right")
        cnt = np.where(lk.validity, hi - lo, 0)
        total = int(cnt.sum())
        li = np.repeat(np.arange(len(lc)), cnt)
        base = np.repeat(np.cumsum(cnt) - cnt, cnt)
        ri = np.repeat(lo, cnt) + (np.arange(total) - base)
        joined = Chunk([c.take(li) for c in lc.columns] + [c.take(ri) for c in rc.columns])
        keep = np.ones(len(joined), dtype=bool)
        if p.other_conds and len(joined):
            from tidb_tpu_torch.expression.expr import EvalBatch, eval_to_column, expr_from_pb

            batch = EvalBatch.from_chunk(joined)
            for c in p.other_conds:
                col = eval_to_column(expr_from_pb(c.to_pb()), batch, np)
                keep &= (col.data != 0) & col.validity
            joined = joined.take(np.nonzero(keep)[0])
        if p.kind == "left":
            matched = np.zeros(len(lc), dtype=bool)
            matched[li[keep]] = True
            miss = np.nonzero(~matched)[0]
            if len(miss):
                null_right = [
                    Column(np.zeros(len(miss), c.data.dtype), np.zeros(len(miss), bool), c.ftype, c.dictionary)
                    for c in rc.columns
                ]
                extra = Chunk([c.take(miss) for c in lc.columns] + null_right)
                joined = Chunk.concat([joined, extra]) if len(joined) else extra
        return joined


@dataclass
class _ChunkSource(Executor):
    """Executor over an already-materialized chunk (index-join inner feed)."""

    chunk: Chunk

    def __post_init__(self):
        self.schema = []

    def execute(self) -> Chunk:
        return self.chunk


# past this many distinct PK probes a coalesced range scan beats point gets
_INNER_POINT_BATCH_MAX = 4096


def _inner_point_rows(session, inner_tpl, t, handles) -> Chunk:
    """Index-join inner PK probes as BATCHED point reads through the
    cross-session point-get batcher (copr/client.PointGetBatcher): one store
    dispatch for the probe set, membuffer-overlaid inside a transaction
    (Txn.batch_get), residual pushed conditions re-applied host-side."""
    from tidb_tpu_torch.copr.client import batched_point_get
    from tidb_tpu_torch.copr.host_engine import run_operators
    from tidb_tpu_torch.executor.write import _rows_to_chunk
    from tidb_tpu_torch.kv.rowcodec import RowSchema, decode_row
    from tidb_tpu_torch.kv.txn import retry_locked

    keys = [tablecodec.record_key(t.id, int(h)) for h in handles]
    txn = session._txn
    if txn is not None:
        raws = txn.batch_get(keys)
    else:
        read_ts = session.read_ts()
        raws = retry_locked(
            session.store, lambda: batched_point_get(session.store, read_ts, keys)
        )
    schema = RowSchema(t.storage_schema)
    rows = [decode_row(schema, raw) for raw in raws if raw is not None]
    live_handles = [h for h, raw in zip(handles, raws) if raw is not None]
    full = _rows_to_chunk(session, t, rows)
    cols = []
    for slot in inner_tpl.scan_slots:
        if slot == -1:
            cols.append(
                Column(
                    np.asarray(live_handles, np.int64),
                    np.ones(len(live_handles), bool),
                    bigint_type(nullable=False),
                )
            )
        else:
            cols.append(full.columns[slot])
    chunk = Chunk(cols)
    if inner_tpl.pushed_conditions:
        sel = dagpb.ExecutorPB(
            dagpb.SELECTION, conditions=[c.to_pb() for c in inner_tpl.pushed_conditions]
        )
        chunk = run_operators(chunk, [sel], [])
    return chunk if len(chunk.columns) else _empty_chunk(inner_tpl.schema)


@dataclass
class IndexJoinExec(Executor):
    """Index nested-loop join (ref: index_lookup_join.go): outer rows drive
    point reads into the inner table via PK or a secondary index, so only
    matching inner rows are fetched; the in-memory match reuses the hash
    join over the (small) fetched set."""

    plan: "PhysIndexJoin"
    outer: Executor
    session: object

    def __post_init__(self):
        self.schema = self.plan.schema

    def execute(self) -> Chunk:
        from tidb_tpu_torch.kv.kv import KeyRange
        from tidb_tpu_torch.planner.plans import PhysIndexLookUp
        from tidb_tpu_torch.planner.ranger import _encode_datum, prefix_next

        p = self.plan
        oc = self.outer.execute()
        inner_tpl = p.children[1]
        t = inner_tpl.table
        # distinct non-NULL outer key tuples → point ranges
        keys: set = set()
        kcols = [oc.columns[l] for l, _ in p.eq_conds]
        for i in range(len(oc)):
            if all(c.validity[i] for c in kcols):
                keys.add(tuple(int(c.data[i]) for c in kcols))
        if p.inner_index is None:
            handles = sorted(k[0] for k in keys)
            if handles and len(handles) <= _INNER_POINT_BATCH_MAX:
                # PK probes through the cross-session point-get batcher: ONE
                # batched store dispatch for the whole probe set (concurrent
                # sessions' probes coalesce too) instead of a cop fan-out —
                # the index-lookup inner per-key gap PERF.md named
                ic = _inner_point_rows(self.session, inner_tpl, t, handles)
            elif handles:
                ranges = [
                    KeyRange(tablecodec.record_key(t.id, h), tablecodec.record_key(t.id, h + 1))
                    for h in handles
                ]
                inner_plan = PhysTableReader(
                    db=inner_tpl.db,
                    table=t,
                    # point lookups are the row-store role (ref: index joins
                    # read through TiKV, never the columnar engine)
                    store_type=StoreType.HOST,
                    pushed_conditions=list(inner_tpl.pushed_conditions),
                    scan_slots=list(inner_tpl.scan_slots),
                    ranges=ranges,
                    schema=inner_tpl.schema,
                )
                ic = TableReaderExec(inner_plan, self.session).execute()
            else:
                ic = _empty_chunk(inner_tpl.schema)
        else:
            idx = p.inner_index
            p0 = tablecodec.index_prefix(t.id, idx.id)
            key_fts = [t.columns[off].ftype for off in idx.column_offsets[: len(p.eq_conds)]]
            ranges = []
            for k in sorted(keys):
                enc = p0 + b"".join(_encode_datum(v, ft) for v, ft in zip(k, key_fts))
                ranges.append(KeyRange(enc, prefix_next(enc)))
            lookup = PhysIndexLookUp(
                db=inner_tpl.db,
                table=t,
                index=idx,
                ranges=ranges,
                scan_slots=list(inner_tpl.scan_slots),
                residual_conditions=list(inner_tpl.pushed_conditions),
                all_conditions=list(inner_tpl.pushed_conditions),
                schema=inner_tpl.schema,
            )
            ic = IndexLookUpExec(lookup, self.session).execute() if ranges else _empty_chunk(inner_tpl.schema)
        # match in memory over the fetched inner subset
        hj = PhysHashJoin(
            kind=p.kind,
            eq_conds=p.eq_conds,
            other_conds=p.other_conds,
            schema=p.schema,
        )
        return HashJoinExec(hj, _ChunkSource(oc), _ChunkSource(ic)).execute()


@dataclass
class DualExec(Executor):
    plan: PhysDual

    def __post_init__(self):
        self.schema = self.plan.schema

    def execute(self) -> Chunk:
        # one dummy row so projections above evaluate constants once
        c = Column(np.zeros(1, np.int64), np.ones(1, bool), bigint_type(nullable=False))
        return Chunk([c])


@dataclass
class MemSourceExec(Executor):
    """Materialized in-memory rowset (recursive-CTE results, memtables)."""

    plan: object  # PhysMemSource

    def __post_init__(self):
        self.schema = self.plan.schema

    def execute(self) -> Chunk:
        rows = self.plan.rows
        return Chunk(
            [
                Column.from_values([r[i] for r in rows], oc.ftype)
                for i, oc in enumerate(self.plan.schema)
            ]
        )


@dataclass
class PointGetExec(Executor):
    plan: PhysPointGet
    session: object

    def __post_init__(self):
        self.schema = self.plan.schema

    def execute(self) -> Chunk:
        t = self.plan.table
        txn = self.session.txn_for_read()
        rk = tablecodec.record_key(t.id, self.plan.handle)
        if txn.membuf.contains(rk):
            raw = txn.membuf.get(rk)
        else:
            # honors current-read overrides (FOR UPDATE at for_update_ts)
            raw = txn._retry_locked(lambda: self.session.store.get_snapshot(self.session.read_ts()).get(rk))
        slots = getattr(self.plan, "scan_slots", list(range(len(t.columns))))
        if raw is None:
            return _empty_chunk(self.plan.schema)
        vals = decode_row(RowSchema(t.storage_schema), raw)
        cols = []
        from tidb_tpu_torch.copr.colcache import cache_for

        cache = cache_for(self.session.store)
        for pos, slot in enumerate(slots):
            ci = t.columns[slot]
            v = vals[slot]
            if ci.ftype.kind == TypeKind.STRING:
                dic = cache.dictionary(t.id, slot)
                data = np.array([0 if v is None else dic.encode(v)], dtype=np.int32)
                cols.append(Column(data, np.array([v is not None]), ci.ftype, dic))
            else:
                dt = np.float64 if ci.ftype.kind == TypeKind.FLOAT else np.int64
                data = np.array([0 if v is None else v], dtype=dt)
                cols.append(Column(data, np.array([v is not None]), ci.ftype))
        return Chunk(cols)
