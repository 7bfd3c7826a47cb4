"""information_schema memtables (ref: pkg/infoschema/tables.go +
perfschema): virtual tables materialized from catalog/runtime state at query
time, fed to the planner as memtable sources (the reference's
createInfoSchemaTable → memtableRetriever path)."""

from __future__ import annotations

from typing import Optional

from tidb_tpu_torch.types.field_type import bigint_type, string_type

_S = lambda n=64: string_type(n)  # noqa: E731
_I = bigint_type


def memtable_rows(db, session, name: str, hints=()) -> Optional[tuple[list, list, list]]:
    """→ (column names, ftypes, rows) for information_schema.<name>.

    ``hints`` are simple WHERE conjuncts the builder extracted —
    ``(column_lower, op, literal)`` triples with op ∈ eq/ne/lt/le/gt/ge.
    They are a pure OPTIMIZATION: the full WHERE still applies as a
    LogicalSelection above the memtable source, so a consumer may honor any
    subset (the log sweeps use them to push time/level/instance filters into
    the wire fan-out so rings never ship whole)."""
    fn = {
        "schemata": _schemata,
        "tables": _tables,
        "columns": _columns,
        "statistics": _statistics,
        "partitions": _partitions,
        "processlist": _processlist,
        "session_variables": _variables,
        "engines": _engines,
        "statements_summary": _statements_summary,
        "slow_query": _slow_query,
        "trace_reservoir": _trace_reservoir,
        # the cluster observability plane: fleet-wide memtables materialized
        # from a live sys_snapshot sweep (dead stores degrade to a session
        # warning + partial rows — TiDB's cluster_* semantics)
        "cluster_info": _cluster_info,
        "cluster_load": _cluster_load,
        "cluster_placement": _cluster_placement,
        "cluster_slow_query": _cluster_slow_query,
        "cluster_statements_summary": _cluster_statements_summary,
        "cluster_trace_reservoir": _cluster_trace_reservoir,
        "metrics_history": _metrics_history,
        "cluster_metrics_history": _cluster_metrics_history,
        "resource_groups": _resource_groups,
        "resource_group_usage": _resource_group_usage,
        "runaway_watches": _runaway_watches,
        # workload attribution: per-(region, table) traffic rings sampled in
        # the stores, swept fleet-wide (the Key Visualizer substrate; also
        # GET /keyviz and the balancer's hot-shard boost)
        "keyspace_heatmap": _keyspace_heatmap,
        "cluster_keyspace_heatmap": _cluster_keyspace_heatmap,
        "views": _views,
        "key_column_usage": _key_column_usage,
        "table_constraints": _table_constraints,
        "referential_constraints": _referential_constraints,
        "character_sets": _character_sets,
        "collations": _collations,
        "tidb_top_sql": _top_sql,
        # the diagnostics plane (utils/eventlog + utils/inspection): the
        # structured event log, its fleet-wide sweep, and the rule engine
        "tidb_log": _tidb_log,
        "cluster_log": _cluster_log,
        "inspection_result": _inspection_result,
        "inspection_rules": _inspection_rules,
    }.get(name)
    if fn is None:
        return None
    if name in ("tidb_log", "cluster_log"):
        return fn(db, session, hints)
    return fn(db, session)


def _schemata(db, session):
    cols = ["CATALOG_NAME", "SCHEMA_NAME", "DEFAULT_CHARACTER_SET_NAME", "DEFAULT_COLLATION_NAME"]
    rows = [("def", d, "utf8mb4", "utf8mb4_bin") for d in sorted(db.catalog.databases())]
    rows.append(("def", "information_schema", "utf8mb4", "utf8mb4_bin"))
    return cols, [_S()] * 4, rows


def _iter_tables(db):
    for dname in sorted(db.catalog.databases()):
        for tname in sorted(db.catalog.tables(dname)):
            yield dname, db.catalog.table(dname, tname)


def _tables(db, session):
    cols = ["TABLE_CATALOG", "TABLE_SCHEMA", "TABLE_NAME", "TABLE_TYPE", "ENGINE", "TABLE_ROWS", "TIDB_TABLE_ID", "CREATE_OPTIONS"]
    fts = [_S(), _S(), _S(), _S(), _S(), _I(), _I(), _S()]
    rows = []
    for dname, t in _iter_tables(db):
        st = db.stats.get(t.id)
        nrows = st.row_count if st is not None else 0
        opts = "partitioned" if t.partition is not None else ""
        rows.append(("def", dname, t.name, "BASE TABLE", "tpu", nrows, t.id, opts))
    for dname in sorted(db.catalog.databases()):
        for vname in db.catalog.views(dname):
            rows.append(("def", dname, vname, "VIEW", None, None, None, ""))
    return cols, fts, rows


def _columns(db, session):
    from tidb_tpu_torch.tools.dumpling import _sql_type

    cols = ["TABLE_SCHEMA", "TABLE_NAME", "COLUMN_NAME", "ORDINAL_POSITION", "COLUMN_DEFAULT", "IS_NULLABLE", "DATA_TYPE", "COLUMN_TYPE", "COLUMN_KEY"]
    fts = [_S(), _S(), _S(), _I(), _S(), _S(3), _S(), _S(), _S(3)]
    rows = []
    for dname, t in _iter_tables(db):
        for c in t.columns:
            key = "PRI" if (t.pk_is_handle and c.offset == t.pk_offset) else ""
            full = _sql_type(c.ftype)
            rows.append(
                (
                    dname,
                    t.name,
                    c.name,
                    c.offset + 1,
                    None if c.default is None else str(c.default),
                    "YES" if c.ftype.nullable else "NO",
                    full.split("(")[0].lower(),
                    full.lower(),
                    key,
                )
            )
    return cols, fts, rows


def _statistics(db, session):
    cols = ["TABLE_SCHEMA", "TABLE_NAME", "NON_UNIQUE", "INDEX_NAME", "SEQ_IN_INDEX", "COLUMN_NAME"]
    fts = [_S(), _S(), _I(), _S(), _I(), _S()]
    rows = []
    for dname, t in _iter_tables(db):
        if t.pk_is_handle:
            rows.append((dname, t.name, 0, "PRIMARY", 1, t.columns[t.pk_offset].name))
        for idx in t.indexes:
            if idx.state != "public":
                continue
            for seq, off in enumerate(idx.column_offsets):
                rows.append((dname, t.name, 0 if idx.unique else 1, idx.name, seq + 1, t.columns[off].name))
    return cols, fts, rows


def _partitions(db, session):
    cols = ["TABLE_SCHEMA", "TABLE_NAME", "PARTITION_NAME", "PARTITION_ORDINAL_POSITION", "PARTITION_METHOD", "PARTITION_EXPRESSION", "PARTITION_DESCRIPTION", "TIDB_PARTITION_ID"]
    fts = [_S(), _S(), _S(), _I(), _S(), _S(), _S(), _I()]
    rows = []
    for dname, t in _iter_tables(db):
        if t.partition is None:
            rows.append((dname, t.name, None, None, None, None, None, t.id))
            continue
        p = t.partition
        col = t.columns[p.col_offset].name
        for i, d in enumerate(p.defs):
            desc = None
            if p.type == "range":
                desc = "MAXVALUE" if d.less_than is None else str(d.less_than)
            rows.append((dname, t.name, d.name, i + 1, p.type.upper(), f"`{col}`", desc, d.id))
    return cols, fts, rows


def _processlist(db, session):
    cols = ["ID", "USER", "HOST", "DB", "COMMAND", "TIME", "STATE", "INFO"]
    fts = [_I(), _S(), _S(), _S(), _S(), _I(), _S(), _S(256)]
    server = getattr(db, "server", None)
    rows = []
    if server is not None:
        for cid, user, dbn, cmd, info in server.processlist():
            rows.append((cid, user, "127.0.0.1", dbn, cmd, 0, "", info))
    return cols, fts, rows


def _variables(db, session):
    cols = ["VARIABLE_NAME", "VARIABLE_VALUE"]
    rows = sorted((k, str(v)) for k, v in session.vars.items())
    return cols, [_S(), _S(256)], rows


def _statements_summary_shape():
    from tidb_tpu_torch.types.field_type import double_type

    cols = ["DIGEST", "DIGEST_TEXT", "EXEC_COUNT", "SUM_LATENCY", "MAX_LATENCY",
            "AVG_LATENCY", "SUM_ROWS", "QUERY_SAMPLE_TEXT", "PLAN_DIGEST",
            "SUM_COP_TASKS", "SUM_BACKOFF", "MAX_MEM", "SUM_RU", "RESOURCE_GROUP"]
    fts = [_S(80), _S(256), _I(), double_type(), double_type(), double_type(),
           _I(), _S(256), _S(80), _I(), double_type(), _I(), double_type(), _S(32)]
    return cols, fts


def _stmt_stats_row(st):
    d, _, norm = st.digest.partition("|")
    return (d, norm, st.exec_count, st.sum_latency, st.max_latency,
            st.avg_latency, st.sum_rows, st.sample, st.plan_digest,
            st.sum_cop_tasks, st.sum_backoff, st.max_mem, st.sum_ru,
            st.resource_group)


def _statements_summary(db, session):
    cols, fts = _statements_summary_shape()
    rows = [_stmt_stats_row(st) for st in db.stmt_summary.stats()]
    return cols, fts, rows


def _top_sql(db, session):
    """Trailing-minute per-digest CPU attribution (ref: util/topsql
    reporter; the dashboard's Top SQL page). TRACE_ID cross-links to the
    trace reservoir when a sampled statement contributed samples."""
    from tidb_tpu_torch.types.field_type import double_type
    from tidb_tpu_torch.utils.topsql import collector

    from tidb_tpu_torch.utils import eventlog as _evlog

    cols = ["SQL_DIGEST", "PLAN_DIGEST", "QUERY_SAMPLE_TEXT", "CPU_TIME_SEC",
            "SAMPLES", "TRACE_ID", "EVENTS", "RU"]
    fts = [_S(80), _S(80), _S(256), double_type(), _I(), _S(80), _I(),
           double_type()]
    # EVENTS resolves at read time: the count of event-log rows carrying the
    # row's sampled trace_id — the Top-SQL ↔ cluster_log pivot
    lg = _evlog.get()
    rows = [
        (d, p, s, c, n, t, len(lg.for_trace(t)) if t else 0, ru)
        for d, p, s, c, n, t, ru in collector().top_sql()
    ]
    return cols, fts, rows


def _slow_query_shape():
    from tidb_tpu_torch.types.field_type import double_type

    cols = ["TIME", "QUERY", "QUERY_TIME", "RESULT_ROWS", "USER", "DIGEST",
            "PLAN_DIGEST", "COP_TASKS", "COP_PROC_MAX", "BACKOFF_TIME",
            "RESPLITS", "MAX_TASK_STORE", "COP_SUMMARY", "TRACE_ID", "MEM_MAX",
            "EVENTS", "FIRST_ERROR", "RU", "RESOURCE_GROUP"]
    fts = [double_type(), _S(512), double_type(), _I(), _S(), _S(80), _S(80),
           _I(), double_type(), double_type(), _I(), _S(64), _S(256), _S(80), _I(),
           _I(), _S(64), double_type(), _S(32)]
    return cols, fts


def _slow_entry_row(e):
    return (e.time, e.sql, e.latency_s, e.rows, e.user, e.digest, e.plan_digest,
            e.cop_tasks, e.cop_proc_max_ms / 1000.0, e.backoff_ms / 1000.0,
            e.resplits, e.max_task_store, e.cop_summary, e.trace_id, e.mem_max,
            e.events, e.first_error, e.ru, e.resource_group)


def _slow_query(db, session):
    """The slow log ring with its structured exec-detail fields (ref: the
    slow query log's Plan_digest/Cop_time/Backoff_time/Mem_max columns, fed
    from the wire-shipped cop-task sidecars + the statement mem tracker)."""
    cols, fts = _slow_query_shape()
    rows = [_slow_entry_row(e) for e in db.stmt_summary.slow_queries()]
    return cols, fts, rows


def _trace_reservoir(db, session):
    """The always-on sampled-trace reservoir (utils/tracing.TraceReservoir):
    one row per retained trace — recent sampled statements plus tail-keep
    slow outliers. The full span tree is served by ``GET /traces?id=...``."""
    from tidb_tpu_torch.types.field_type import double_type

    cols = ["TRACE_ID", "TIME", "QUERY", "QUERY_TIME", "DIGEST", "SLOW", "SPANS"]
    fts = [_S(80), double_type(), _S(512), double_type(), _S(80), _I(), _I()]
    res = getattr(db, "trace_reservoir", None)
    rows = [
        (e.trace_id, e.time, e.sql, e.duration_s, e.digest,
         1 if e.slow else 0, len(e.spans))
        for e in (res.traces() if res is not None else [])
    ]
    return cols, fts, rows


def _resource_groups(db, session):
    from tidb_tpu_torch.types.field_type import double_type

    cols = ["NAME", "RU_PER_SEC", "BURSTABLE", "QUERY_LIMIT", "RU_CONSUMED"]
    fts = [_S(), _I(), _S(3), _S(128), double_type()]
    rows = []
    for g in db.resource_groups.list():
        ql = ""
        if g.exec_elapsed_s:
            ql = f"EXEC_ELAPSED={g.exec_elapsed_s}s ACTION={g.action}"
        rows.append((g.name, g.ru_per_sec, "YES" if g.burstable else "NO", ql, g.ru_consumed))
    return cols, fts, rows


def _runaway_watches(db, session):
    from tidb_tpu_torch.types.field_type import double_type

    cols = ["TIME", "RESOURCE_GROUP_NAME", "ACTION", "SAMPLE_SQL"]
    fts = [double_type(), _S(), _S(16), _S(256)]
    rows = [(r.time, r.group, r.action, r.sql) for r in db.resource_groups.runaway_log]
    return cols, fts, rows


def _resource_group_usage(db, session):
    """Per-group cumulative metered usage (workload attribution: which
    tenant is spending the fleet's RUs, and on what — reads vs writes vs
    compute vs transfer). Counters accumulate from statement finalization
    (session.execute → ResourceGroupManager.charge); metering only, no
    admission control."""
    from tidb_tpu_torch.types.field_type import double_type

    _D = double_type
    cols = ["RESOURCE_GROUP", "STATEMENTS", "RU", "RRU", "WRU", "WALL_MS",
            "CPU_MS", "DEVICE_MS", "HOST_MS", "H2D_BYTES", "D2H_BYTES",
            "KEYS_SCANNED", "BYTES_SCANNED", "KEYS_WRITTEN", "BYTES_WRITTEN",
            "COP_RPCS", "BACKOFF_MS", "MPP_EXCHANGE_BYTES", "ROWS_RETURNED"]
    fts = [_S(32), _I(), _D(), _D(), _D(), _D(), _D(), _D(), _D(), _I(), _I(),
           _I(), _I(), _I(), _I(), _I(), _D(), _I(), _I()]
    rows = []
    for g in db.resource_groups.list():
        u = g.usage
        rows.append((g.name, u.statements, u.ru, u.rru, u.wru, u.wall_ms,
                     u.cpu_ms, u.device_ms, u.host_ms, u.h2d_bytes,
                     u.d2h_bytes, u.keys_scanned, u.bytes_scanned,
                     u.keys_written, u.bytes_written, u.cop_rpcs,
                     u.backoff_ms, u.mpp_exchange_bytes, u.rows_returned))
    return cols, fts, rows


def _table_names(db) -> dict:
    names = {}
    for dname, t in _iter_tables(db):
        names[t.id] = f"{dname}.{t.name}"
        for v in t.partition_views():
            names.setdefault(v.id, f"{dname}.{t.name}")
    return names


def _keyspace_heatmap(db, session):
    """Window totals of the stores' per-(region, table) traffic rings — the
    "which region is hot, and whose table is it" view (ref: the dashboard
    Key Visualizer; per-bucket detail is cluster_keyspace_heatmap, raw JSON
    is GET /keyviz). A dead store degrades to a warning + partial rows."""
    cols = ["INSTANCE", "REGION_ID", "TABLE_ID", "TABLE_NAME", "READ_KEYS",
            "READ_BYTES", "WRITE_KEYS", "WRITE_BYTES"]
    fts = [_S(), _I(), _I(), _S(128), _I(), _I(), _I(), _I()]
    names = _table_names(db)
    rows = []
    for o in _cluster_sweep(db, session, sections=("heatmap",)):
        if not o["ok"]:
            continue
        for ent in o["report"].get("heatmap", ()):
            rk = rb = wk = wb = 0
            for _, brk, brb, bwk, bwb in ent["buckets"]:
                rk += brk
                rb += brb
                wk += bwk
                wb += bwb
            rows.append((o["instance"], ent["region_id"], ent["table_id"],
                         names.get(ent["table_id"], ""), rk, rb, wk, wb))
    return cols, fts, rows


def _cluster_keyspace_heatmap(db, session):
    """The same rings at full bucket resolution: one row per retained
    (instance, region, table, bucket) — traffic-over-time as SQL."""
    from tidb_tpu_torch.types.field_type import double_type

    cols = ["INSTANCE", "BUCKET_TS", "REGION_ID", "TABLE_ID", "TABLE_NAME",
            "READ_KEYS", "READ_BYTES", "WRITE_KEYS", "WRITE_BYTES"]
    fts = [_S(), double_type(), _I(), _I(), _S(128), _I(), _I(), _I(), _I()]
    names = _table_names(db)
    rows = []
    for o in _cluster_sweep(db, session, sections=("heatmap",)):
        if not o["ok"]:
            continue
        for ent in o["report"].get("heatmap", ()):
            tn = names.get(ent["table_id"], "")
            for ts, rk, rb, wk, wb in ent["buckets"]:
                rows.append((o["instance"], ts, ent["region_id"],
                             ent["table_id"], tn, rk, rb, wk, wb))
    return cols, fts, rows


def _engines(db, session):
    cols = ["ENGINE", "SUPPORT", "COMMENT"]
    rows = [
        ("tpu", "DEFAULT", "XLA columnar coprocessor engine over the TPU mesh"),
        ("host", "YES", "NumPy reference coprocessor engine"),
    ]
    return cols, [_S(), _S(), _S(256)], rows


def _views(db, session):
    cols = ["TABLE_CATALOG", "TABLE_SCHEMA", "TABLE_NAME", "VIEW_DEFINITION", "IS_UPDATABLE", "DEFINER"]
    rows = []
    for dname in sorted(db.catalog.databases()):
        for vname in sorted(db.catalog.views(dname)):
            v = db.catalog.view(dname, vname)
            rows.append(("def", dname, vname, v.text, "NO", "root@%"))
    return cols, [_S(256)] * 6, rows


def _key_column_usage(db, session):
    """PK/unique/FK key columns (ref: infoschema keyColumnUsage memtable)."""
    cols = ["CONSTRAINT_SCHEMA", "CONSTRAINT_NAME", "TABLE_SCHEMA", "TABLE_NAME",
            "COLUMN_NAME", "ORDINAL_POSITION", "REFERENCED_TABLE_SCHEMA",
            "REFERENCED_TABLE_NAME", "REFERENCED_COLUMN_NAME"]
    fts = [_S(), _S(), _S(), _S(), _S(), _I(), _S(), _S(), _S()]
    rows = []
    for dname, t in _iter_tables(db):
        if t.pk_is_handle:
            rows.append((dname, "PRIMARY", dname, t.name, t.columns[t.pk_offset].name, 1, None, None, None))
        for idx in t.indexes:
            if idx.state != "public" or not (idx.unique or idx.primary):
                continue
            name = "PRIMARY" if idx.primary else idx.name
            for seq, off in enumerate(idx.column_offsets):
                rows.append((dname, name, dname, t.name, t.columns[off].name, seq + 1, None, None, None))
        for fk in t.foreign_keys:
            if fk.state != "public":
                continue  # mid-DDL constraints stay invisible, like indexes
            for seq, (off, rname) in enumerate(zip(fk.col_offsets, fk.ref_col_names)):
                rows.append((dname, fk.name, dname, t.name, t.columns[off].name, seq + 1,
                             fk.ref_db or dname, fk.ref_table, rname))
    return cols, fts, rows


def _table_constraints(db, session):
    cols = ["CONSTRAINT_SCHEMA", "CONSTRAINT_NAME", "TABLE_SCHEMA", "TABLE_NAME", "CONSTRAINT_TYPE"]
    rows = []
    for dname, t in _iter_tables(db):
        if t.pk_is_handle:
            rows.append((dname, "PRIMARY", dname, t.name, "PRIMARY KEY"))
        for idx in t.indexes:
            if idx.state != "public":
                continue
            if idx.primary:
                rows.append((dname, "PRIMARY", dname, t.name, "PRIMARY KEY"))
            elif idx.unique:
                rows.append((dname, idx.name, dname, t.name, "UNIQUE"))
        for fk in t.foreign_keys:
            if fk.state != "public":
                continue  # mid-DDL constraints stay invisible, like indexes
            rows.append((dname, fk.name, dname, t.name, "FOREIGN KEY"))
    return cols, [_S()] * 5, rows


def _referential_constraints(db, session):
    cols = ["CONSTRAINT_SCHEMA", "CONSTRAINT_NAME", "UNIQUE_CONSTRAINT_SCHEMA",
            "REFERENCED_TABLE_NAME", "UPDATE_RULE", "DELETE_RULE", "TABLE_NAME"]
    rows = []
    for dname, t in _iter_tables(db):
        for fk in t.foreign_keys:
            if fk.state != "public":
                continue  # mid-DDL constraints stay invisible, like indexes
            rows.append((dname, fk.name, fk.ref_db or dname, fk.ref_table,
                         (fk.on_update or "restrict").replace("_", " ").upper(),
                         (fk.on_delete or "restrict").replace("_", " ").upper(), t.name))
    return cols, [_S()] * 7, rows


# the single source of truth for supported charsets/collations — SHOW
# COLLATION/CHARSET (session.py) and these memtables must never diverge
CHARSETS = [
    ("utf8mb4", "UTF-8 Unicode", "utf8mb4_bin", 4),
    ("binary", "Binary pseudo charset", "binary", 1),
]
COLLATIONS = [
    ("utf8mb4_bin", "utf8mb4", 46, "Yes", "Yes", 1),
    ("utf8mb4_general_ci", "utf8mb4", 45, "", "Yes", 1),
    ("binary", "binary", 63, "Yes", "Yes", 1),
]


# -- the cluster observability plane ------------------------------------------
# Fleet-wide memtables (ref: infoschema's cluster_* tables served over the
# coprocessor memory-table endpoint, rpc_server.go:96): each query runs ONE
# live sys_snapshot sweep through the DB's StoreHealthRegistry, merges the
# LOCAL instance's rows with every store's wire-shipped rows under an
# INSTANCE tag, and degrades an unreachable store to a session warning plus
# partial results — never a failed query.


def _local_instance(db) -> str:
    return f"tidb:{db.node_id[:8]}"


def _cluster_sweep(db, session, hist=None, sections=None):
    """One fan-out sweep; failures become session warnings (TiDB's
    partial-result semantics) and the good outcomes return. ``sections``
    names the heavy report parts this memtable actually reads — a load/info
    probe never serializes whole slow rings over the wire."""
    outs = db.health.sweep(hist=hist, sections=sections)
    for o in outs:
        if not o["ok"]:
            session.append_warning(
                "Warning", 1105,
                f"cluster memtable: instance {o['instance']} unreachable: {o['error']}",
            )
    return outs


def _cluster_info(db, session):
    from tidb_tpu_torch.types.field_type import double_type
    from tidb_tpu_torch.utils.metricshist import PROC_START

    import time as _time

    cols = ["INSTANCE", "TYPE", "ADDRESS", "VERSION", "START_TIME", "UPTIME_S", "STATUS"]
    fts = [_S(), _S(16), _S(), _S(), double_type(), double_type(), _S(16)]
    me = _local_instance(db)
    rows = [(me, "tidb", me, "8.0.11-tidb-tpu", PROC_START,
             round(_time.time() - PROC_START, 3), "up")]
    for o in _cluster_sweep(db, session, sections=()):
        if o["ok"]:
            rep = o["report"]
            rows.append((o["instance"], "store", rep.get("addr", o["instance"]),
                         rep.get("version"), rep.get("start_time"),
                         rep.get("uptime_s"), "up"))
        else:
            rows.append((o["instance"], "store", o["instance"], None, None, None, "down"))
    return cols, fts, rows


def _load_row(instance, rep):
    return (instance, float(rep.get("qps", 0.0)), float(rep.get("cop_qps", 0.0)),
            int(rep.get("conns", 0)), int(rep.get("cop_queue", 0)),
            int(rep.get("cop_pool", 0)), int(rep.get("stmts", 0)),
            int(rep.get("cop_tasks", 0)), int(rep.get("device_cache_bytes", 0)),
            int(rep.get("delta_rows", 0)), float(rep.get("uptime_s", 0.0)))


def _cluster_load(db, session):
    """Per-instance load signals (the balancer/overload-controller substrate
    in SQL form): recent QPS needs the metrics-history recorder running on
    the reporting process; cumulative counters are always live."""
    from tidb_tpu_torch.kv.memstore import MemStore
    from tidb_tpu_torch.types.field_type import double_type

    cols = ["INSTANCE", "QPS", "COP_QPS", "CONNS", "COP_QUEUE", "COP_POOL",
            "STMTS", "COP_TASKS", "DEVICE_CACHE_BYTES", "DELTA_ROWS", "UPTIME_S"]
    fts = [_S(), double_type(), double_type(), _I(), _I(), _I(), _I(), _I(),
           _I(), _I(), double_type()]
    from tidb_tpu_torch.kv.remote import sys_report

    local = sys_report(store=db.store if isinstance(db.store, MemStore) else None, sections=())
    # the local QPS estimator is live even when the recorder is not running
    local["qps"] = round(db.health.recent_qps(), 3)
    rows = [_load_row(_local_instance(db), local)]
    for o in _cluster_sweep(db, session, sections=()):
        if o["ok"]:
            rows.append(_load_row(o["instance"], o["report"]))
    return cols, fts, rows


def _cluster_placement(db, session):
    """The elastic-placement plane (kv/placement.py): every table's current
    binding (shard, owner instance, placement epoch), the epoch HISTORY
    this node has observed (one row per transition, STATE='history'), and
    in-flight moves (STATE='moving src→dst'). Epoch 0 = static hash/pin
    placement a migration never touched. Empty on a non-sharded store."""
    from tidb_tpu_torch.types.field_type import double_type

    cols = ["TABLE_ID", "TABLE_NAME", "SHARD", "INSTANCE", "EPOCH", "STATE", "SINCE"]
    fts = [_I(), _S(128), _I(), _S(), _I(), _S(32), double_type()]
    store = db.store
    snap_fn = getattr(store, "placement_snapshot", None)
    if snap_fn is None:
        return cols, fts, []
    snap = snap_fn()
    from tidb_tpu_torch.kv.sharded import ShardedStore

    names = {}
    for dname, t in _iter_tables(db):
        names[t.id] = f"{dname}.{t.name}"
        for v in t.partition_views():
            names.setdefault(v.id, f"{dname}.{t.name}")
    inst = lambda si: ShardedStore.instance_name(store.stores[si])  # noqa: E731
    rows = []
    moving = snap.get("moving", {})
    for tid in sorted(names):
        si = store.shard_of_table(tid)
        epoch = snap["tables"].get(tid, {}).get("epoch", 0)
        mv = moving.get(tid)
        state = f"moving {mv['src']}→{mv['dst']}" if mv else "settled"
        hist = snap.get("history", {}).get(tid, ())
        since = hist[-1][2] if hist else None
        rows.append((tid, names[tid], si, inst(si), epoch, state, since))
        for e, s, ts in hist[:-1] if hist else ():
            rows.append((tid, names[tid], s, inst(s), e, "history", ts))
    return cols, fts, rows


def _cluster_slow_query(db, session):
    """Every instance's slow ring in one table: the LOCAL statement slow log
    plus each store's wire-shipped cop slow log ([observability]
    store-slow-cop-ms), INSTANCE-tagged."""
    from tidb_tpu_torch.utils.stmtsummary import SlowEntry

    cols, fts = _slow_query_shape()
    cols = ["INSTANCE"] + cols
    fts = [_S()] + fts
    me = _local_instance(db)
    rows = [(me,) + _slow_entry_row(e) for e in db.stmt_summary.slow_queries()]
    for o in _cluster_sweep(db, session, sections=("slow",)):
        if not o["ok"]:
            continue
        for e in o["report"].get("slow", ()):
            # rebuild the real record from the wire dict: _slow_entry_row is
            # the ONE field-order home for local and fan-out rows alike
            rows.append((o["instance"],) + _slow_entry_row(SlowEntry.from_pb(e)))
    return cols, fts, rows


def _cluster_statements_summary(db, session):
    from tidb_tpu_torch.utils.stmtsummary import StmtStats

    cols, fts = _statements_summary_shape()
    cols = ["INSTANCE"] + cols
    fts = [_S()] + fts
    me = _local_instance(db)
    rows = [(me,) + _stmt_stats_row(st) for st in db.stmt_summary.stats()]
    for o in _cluster_sweep(db, session, sections=("statements",)):
        if not o["ok"]:
            continue
        for s in o["report"].get("statements", ()):
            rows.append((o["instance"],) + _stmt_stats_row(StmtStats.from_pb(s)))
    return cols, fts, rows


def _cluster_trace_reservoir(db, session):
    """The trace reservoirs of every SQL instance, INSTANCE-tagged. Store
    processes record spans only under a propagated context (they keep no
    reservoir of their own), so fan-out rows appear only from instances
    whose report ships a ``traces`` section."""
    from tidb_tpu_torch.types.field_type import double_type

    cols = ["INSTANCE", "TRACE_ID", "TIME", "QUERY", "QUERY_TIME", "DIGEST", "SLOW", "SPANS"]
    fts = [_S(), _S(80), double_type(), _S(512), double_type(), _S(80), _I(), _I()]
    me = _local_instance(db)
    res = getattr(db, "trace_reservoir", None)
    rows = [
        (me, e.trace_id, e.time, e.sql, e.duration_s, e.digest,
         1 if e.slow else 0, len(e.spans))
        for e in (res.traces() if res is not None else [])
    ]
    for o in _cluster_sweep(db, session, sections=("traces",)):
        if not o["ok"]:
            continue
        for t in o["report"].get("traces", ()):
            rows.append((o["instance"], t.get("trace_id"), t.get("time"),
                         t.get("sql"), t.get("duration_s"), t.get("digest"),
                         t.get("slow", 0), t.get("spans", 0)))
    return cols, fts, rows


def _metrics_history_shape():
    from tidb_tpu_torch.types.field_type import double_type

    cols = ["NAME", "LABELS", "TS", "VALUE"]
    fts = [_S(128), _S(256), double_type(), double_type()]
    return cols, fts


def _metrics_history(db, session):
    """This process's in-process metrics history (utils/metricshist): one
    row per retained sample — "what did qps look like five minutes ago" as
    SQL, with no external Prometheus."""
    from tidb_tpu_torch.utils.metricshist import recorder

    cols, fts = _metrics_history_shape()
    return cols, fts, list(recorder().series())


def _cluster_metrics_history(db, session):
    """Every instance's metrics history: the local rings plus each store's,
    shipped inside the sys_snapshot report (``hist=True`` sweep)."""
    from tidb_tpu_torch.utils.metricshist import recorder

    cols, fts = _metrics_history_shape()
    cols = ["INSTANCE"] + cols
    fts = [_S()] + fts
    me = _local_instance(db)
    rows = [(me,) + tuple(r) for r in recorder().series()]
    for o in _cluster_sweep(db, session, hist=True, sections=()):
        if not o["ok"]:
            continue
        for r in o["report"].get("history", ()):
            rows.append((o["instance"],) + tuple(r))
    return cols, fts, rows


# -- the diagnostics plane ----------------------------------------------------
# tidb_log / cluster_log (ref: infoschema's cluster_log served by the
# diagnostics log-search RPC): the structured event rings as SQL, with WHERE
# time/level/component/instance predicates pushed into the search so rings
# never materialize (or ship) whole; inspection_result is the rule engine.


def _hint_eq(hints, col):
    """The literal of a ``col = value`` conjunct, if the builder saw one."""
    for c, op, v in hints:
        if c == col and op == "eq":
            return v
    return None


def _hint_bounds(hints, col):
    """(lo, hi) bounds from ``col >/>=/</<= literal`` conjuncts (half-open
    vs closed is ignored — hints are superset filters, the real WHERE
    re-applies above)."""
    lo = hi = None
    for c, op, v in hints:
        if c != col or not isinstance(v, (int, float)):
            continue
        if op in ("gt", "ge"):
            lo = v if lo is None else max(lo, v)
        elif op in ("lt", "le"):
            hi = v if hi is None else min(hi, v)
        elif op == "eq":
            lo = v if lo is None else max(lo, v)
            hi = v if hi is None else min(hi, v)
    return lo, hi


def _log_search_args(hints):
    """Translate builder hints into eventlog.search kwargs. LEVEL equality
    becomes min_level — a SUPERSET (higher severities ride along; the real
    WHERE trims them), which keeps the pushdown monotone-safe."""
    from tidb_tpu_torch.utils import eventlog as _evlog

    since, until = _hint_bounds(hints, "ts")
    min_level = _evlog.DEBUG
    lv = _hint_eq(hints, "level")
    if isinstance(lv, str):
        min_level = min(_evlog.level_from_name(lv), _evlog.ERROR)
    comp = _hint_eq(hints, "component")
    return {
        "since": since,
        "until": until,
        "min_level": min_level,
        "component": comp if isinstance(comp, str) else None,
    }


def _log_shape():
    from tidb_tpu_torch.types.field_type import double_type

    cols = ["TS", "LEVEL", "COMPONENT", "EVENT", "FIELDS", "TRACE_ID"]
    fts = [double_type(), _S(16), _S(32), _S(64), _S(512), _S(80)]
    return cols, fts


def _log_row(ev):
    import json as _json

    from tidb_tpu_torch.utils import eventlog as _evlog

    ts, level, component, event, fields, trace_id = ev
    return (ts, _evlog.level_name(int(level)), component, event,
            _json.dumps(fields, sort_keys=True, default=str), trace_id or "")


def _tidb_log(db, session, hints=()):
    """THIS process's event ring (the local flight recorder)."""
    from tidb_tpu_torch.utils import eventlog as _evlog

    cols, fts = _log_shape()
    rows = [_log_row(e) for e in _evlog.get().search(limit=None, **_log_search_args(hints))]
    return cols, fts, rows


def _cluster_log(db, session, hints=()):
    """Every instance's event ring in one table: local rows plus the
    ``log_search`` wire fan-out, INSTANCE-tagged, with the WHERE hints
    applied server-side (a dead store degrades to a session warning plus
    partial rows, like every cluster_* memtable)."""
    from tidb_tpu_torch.utils import eventlog as _evlog

    cols, fts = _log_shape()
    cols = ["INSTANCE"] + cols
    fts = [_S()] + fts
    args = _log_search_args(hints)
    me = _local_instance(db)
    inst = _hint_eq(hints, "instance")
    want_local = inst is None or inst == me
    rows = []
    if want_local:
        rows = [(me,) + _log_row(e) for e in _evlog.get().search(limit=None, **args)]
    if inst is not None and inst == me:
        return cols, fts, rows
    store = db.store
    sweep = getattr(store, "log_search_all", None)
    if sweep is not None:
        outs = sweep(instances={inst} if inst is not None else None, **args)
    elif hasattr(store, "log_search"):
        # a single remote store (no fleet): probe it directly, same outcome
        # shape, dead-store tolerant
        from tidb_tpu_torch.kv.sharded import ShardedStore

        addr = ShardedStore.instance_name(store)
        if inst is not None and inst != addr:
            outs = []
        else:
            try:
                outs = [{"instance": addr, "shard": 0, "ok": True,
                         "rows": store.log_search(**args)}]
            except (ConnectionError, OSError) as e:
                outs = [{"instance": addr, "shard": 0, "ok": False, "error": str(e)}]
    else:
        outs = []
    for o in outs:
        if not o["ok"]:
            session.append_warning(
                "Warning", 1105,
                f"cluster_log: instance {o['instance']} unreachable: {o['error']}",
            )
            continue
        rows.extend((o["instance"],) + _log_row(e) for e in o.get("rows", ()))
    return cols, fts, rows


def _inspection_result(db, session):
    """The rule engine's verdicts (ref: inspection_result): one row per
    (rule, item) evaluated over DB.health + metrics history + the event
    log — status ok|warning|critical with value/reference/detail."""
    from tidb_tpu_torch.utils.inspection import inspect

    cols = ["RULE", "ITEM", "STATUS", "VALUE", "REFERENCE", "DETAIL"]
    fts = [_S(32), _S(64), _S(16), _S(64), _S(64), _S(256)]
    return cols, fts, inspect(db)


def _inspection_rules(db, session):
    """The rule catalog (ref: inspection_rules): what inspect() evaluates."""
    from tidb_tpu_torch.utils.inspection import rules_catalog

    cols = ["NAME", "TYPE", "COMMENT"]
    fts = [_S(32), _S(16), _S(256)]
    return cols, fts, rules_catalog()


def _character_sets(db, session):
    cols = ["CHARACTER_SET_NAME", "DEFAULT_COLLATE_NAME", "DESCRIPTION", "MAXLEN"]
    rows = [(name, default, desc, maxlen) for name, desc, default, maxlen in CHARSETS]
    return cols, [_S(), _S(), _S(), _I()], rows


def _collations(db, session):
    cols = ["COLLATION_NAME", "CHARACTER_SET_NAME", "ID", "IS_DEFAULT", "IS_COMPILED", "SORTLEN"]
    return cols, [_S(), _S(), _I(), _S(), _S(), _I()], list(COLLATIONS)
