"""Session: the statement state machine.

ref call path being mirrored: clientConn.Run → session.ExecuteStmt →
Compiler.Compile (planner.Optimize) → ExecStmt.Exec → executor tree
(SURVEY §3.2). Reads inside a dirty explicit transaction take the union-scan
path: the reader scans through the txn membuffer and replays the pushed
operators host-side (ref: UnionScanExec merging membuffer over snapshot).
"""

from __future__ import annotations

import threading
import time
from collections import OrderedDict
from dataclasses import dataclass, field
from typing import Any, Optional

from tidb_tpu_torch.catalog import Catalog, CatalogError
from tidb_tpu_torch.kv.memstore import MemStore
from tidb_tpu_torch.kv.txn import Txn
from tidb_tpu_torch.parser import ast, parse
from tidb_tpu_torch.planner.builder import Builder
from tidb_tpu_torch.planner.optimizer import optimize
from tidb_tpu_torch.planner.plans import PlanError, explain_plan
from tidb_tpu_torch.utils import eventlog as _ev
from tidb_tpu_torch.utils import sysvar_int
from tidb_tpu_torch.utils import tracing as _tracing
from tidb_tpu_torch.utils.chunk import Chunk

_PRIV_BOOTSTRAP_MU = threading.RLock()

DEFAULT_SYSVARS = {
    # engine isolation (ref: vardef tidb_isolation_read_engines :631);
    # preference order matters: first legal engine wins
    "tidb_isolation_read_engines": "gpu,host",
    "tidb_distsql_scan_concurrency": 8,  # ref: tidb_vars.go:302 (default 15)
    "autocommit": 1,
    "tidb_current_ts": 0,
    "sql_mode": "",
    "max_error_count": 64,
    "max_execution_time": 0,
    # ref: vardef TiDBTxnMode (pessimistic is the reference default)
    "tidb_txn_mode": "pessimistic",
    "innodb_lock_wait_timeout": 3,  # seconds (shortened for embedded use)
    "tidb_gc_life_time": 600,  # seconds (ref: 10m default)
    # MPP gating (ref: tidb_vars.go:399 tidb_allow_mpp, :415 tidb_enforce_mpp)
    "tidb_allow_mpp": 1,
    "tidb_enforce_mpp": 0,
    # hybrid shards × devices: a gather whose tables straddle store shards
    # runs the staged program on the coordinator's mesh with per-owner wire
    # reads (0 restores the old re-plan-without-MPP fallback)
    "tidb_mpp_hybrid": 1,
    # slow query log threshold in ms (ref: tidb_slow_log_threshold)
    "tidb_slow_log_threshold": 300,
    # always-on sampled tracing (Dapper-style): the fraction of statements
    # that record a full distributed trace into the reservoir (0..1; 0 keeps
    # the strict tracer-is-None zero-cost path). The seed makes the sampling
    # coin deterministic ("" = nondeterministic; tests set an integer).
    "tidb_tpu_trace_sample_rate": 0,
    "tidb_tpu_trace_sample_seed": "",
    # Top-SQL sampling attribution; OFF by default like the reference —
    # the digest + sampler cost stays off the hot path until enabled
    "tidb_enable_top_sql": 0,
    # session resource group (ref: tidb_resource_control + resource groups)
    "tidb_resource_group": "default",
    # IMPORT INTO via the distributed task framework (ref:
    # tidb_enable_dist_task; default off — direct load is faster in-process)
    "tidb_enable_dist_task": 0,
    # stale reads: negative seconds back for autocommit statements
    # (ref: tidb_read_staleness)
    "tidb_read_staleness": 0,
    # per-query memory quota in bytes (ref: tidb_mem_quota_query, 1GB default)
    "tidb_mem_quota_query": 1 << 30,
    # CANCEL kills the query on quota excess after spill actions run
    # (ref: tidb_mem_oom_action)
    "tidb_mem_oom_action": "CANCEL",
    # session plan cache capacity (ref: tidb_prepared_plan_cache_size)
    "tidb_prepared_plan_cache_size": 100,
    # instance-level (cross-session) plan/AST cache (ref:
    # tidb_enable_instance_plan_cache): ON by default here — short-lived
    # connections are the serving shape this repro optimizes for; 0 restores
    # strictly per-session caching
    "tidb_enable_instance_plan_cache": 1,
    # 1 when the previous statement's plan came from the plan cache
    # (ref: last_plan_from_cache status var)
    "last_plan_from_cache": 0,
    # -- executor concurrency family (ref: vardef executor concurrency
    # knobs; tidb_executor_concurrency is the unified default the split
    # knobs fall back to, exactly the reference's layering) --
    "tidb_executor_concurrency": 4,
    "tidb_hash_join_concurrency": -1,  # -1 → tidb_executor_concurrency
    "tidb_hashagg_partial_concurrency": -1,
    "tidb_hashagg_final_concurrency": -1,
    "tidb_window_concurrency": -1,
    "tidb_streamagg_concurrency": 1,
    "tidb_index_lookup_concurrency": -1,
    "tidb_index_lookup_join_concurrency": -1,
    "tidb_index_serial_scan_concurrency": 1,
    "tidb_projection_concurrency": -1,
    "tidb_ddl_reorg_worker_cnt": 4,
    "tidb_ddl_reorg_batch_size": 256,
    # -- memory/spill family (ref: mem-quota + spill knobs) --
    "tidb_mem_quota_apply_cache": 32 << 20,
    "tidb_enable_tmp_storage_on_oom": 1,
    "tidb_mem_quota_binding_cache": 64 << 20,
    "tidb_server_memory_limit": 0,  # 0 = unlimited (embedded default)
    "tidb_enable_rate_limit_action": 0,
    # -- planner/stats family --
    "tidb_auto_analyze_ratio": 0.5,
    "tidb_enable_index_merge": 1,
    "tidb_broadcast_join_threshold_count": 100_000,
    # 1 = WITH ROLLUP fuses every grouping set into one device pass (the
    # Expand fusion); 0 = the per-set union rewrite (comparison/debug)
    "tidb_opt_fused_rollup": 1,
    # -- txn/retry family --
    "tidb_retry_limit": 10,
    "tidb_disable_txn_auto_retry": 1,
    "tidb_constraint_check_in_place": 0,
    "foreign_key_checks": 1,
    # -- misc MySQL-compat knobs the wire surface reports (accepted,
    # surfaced by SHOW VARIABLES, not consulted by the engine) --
    "tidb_opt_agg_push_down": 1,
    "tidb_opt_distinct_agg_push_down": 0,
    "tidb_build_stats_concurrency": 4,
    "tidb_stats_cache_mem_quota": 0,
    "tidb_opt_mpp_outer_join_fixed_build_side": 0,
    "tidb_broadcast_join_threshold_size": 100 << 20,
    "max_allowed_packet": 64 << 20,
    "version_comment": "tidb-tpu",
    "character_set_server": "utf8mb4",
    "collation_server": "utf8mb4_bin",
    "time_zone": "SYSTEM",
    "wait_timeout": 28800,
}


def executor_concurrency(vars: dict, knob: str) -> int:
    """Split concurrency knobs default to the unified
    tidb_executor_concurrency when set to -1 (ref: vardef fallback)."""
    v = sysvar_int(vars, knob, -1)
    if v > 0:
        return v
    return max(sysvar_int(vars, "tidb_executor_concurrency", 4), 1)


@dataclass
class PreparedStmt:
    """PREPARE'd statement: parsed AST + ``?`` count (ref: PlanCacheStmt)."""

    name: str
    text: str
    stmt: Any
    n_params: int


class _CachedStmt:
    """One statement fast-lane entry: the parsed (binding-substituted) AST
    plus everything needed to re-execute without touching the lexer/parser
    (ref: the non-prepared plan cache, core/plan_cache_lru.go). The AST is
    reused by REFERENCE — safe because SELECT planning never mutates its
    input (CTE statements, which expand destructively, are never cached).
    ``digest`` fills lazily on first stmt-summary/Top-SQL use."""

    __slots__ = ("stmt", "stype", "epoch", "exec_sql", "digest")

    def __init__(self, stmt, stype, epoch, exec_sql):
        self.stmt = stmt
        self.stype = stype
        self.epoch = epoch
        self.exec_sql = exec_sql
        self.digest: Optional[str] = None


def _has_ctes(node) -> bool:
    """True when any (sub)query carries a WITH clause — expand_ctes rewrites
    those IN PLACE, so their ASTs must not be cached for reuse."""
    import dataclasses as _dc

    if isinstance(node, ast.Node):
        if getattr(node, "ctes", None):
            return True
        if _dc.is_dataclass(node):
            return any(_has_ctes(getattr(node, f.name)) for f in _dc.fields(node))
        return False
    if isinstance(node, (list, tuple)):
        return any(_has_ctes(x) for x in node)
    return False


@dataclass
class Result:
    columns: list[str] = field(default_factory=list)
    rows: list[tuple] = field(default_factory=list)
    affected: int = 0
    last_insert_id: int = 0
    # column FieldTypes when known (wire protocol column definitions)
    ftypes: Optional[list] = None

    def scalar(self):
        return self.rows[0][0] if self.rows else None


class SessionError(Exception):
    pass


def _setop_has_for_update(node) -> bool:
    if isinstance(node, ast.Select):
        return node.for_update
    if isinstance(node, ast.SetOp):
        return _setop_has_for_update(node.left) or _setop_has_for_update(node.right)
    return False


class Session:
    def __init__(self, db: "DB"):
        self._db = db
        self.store: MemStore = db.store
        self.catalog: Catalog = db.catalog
        self.vars: dict[str, Any] = dict(DEFAULT_SYSVARS)
        self.current_db = "test"
        # identity for privilege checks (root@% bypasses, like the
        # reference's embedded/bootstrap sessions before grant data exists)
        self.user = "root"
        self.host = "%"
        self._txn: Optional[Txn] = None
        self._explicit = False
        # current-read override: FOR UPDATE reads at for_update_ts
        self._read_ts_override: Optional[int] = None
        # table_id → row mods staged by the open txn (flushed at commit)
        self._pending_mods: dict[int, int] = {}
        # first AUTO_INCREMENT value generated by the last INSERT
        # (ref: LastInsertID in the session vars / OK packet)
        self.last_insert_id = 0
        # EXPLAIN ANALYZE per-operator stats (ref: util/execdetails)
        self.runtime_stats = None
        # TRACE statement span collector (None = tracing off)
        self.tracer = None
        # always-on sampled tracing state: the tracer this statement's
        # sampling coin armed (deposited into the DB's trace reservoir at
        # statement end), plus the seeded coin RNG
        self._sampled_tracer = None
        self._trace_rng = None
        self._trace_rng_seed = None
        # distributed exec-details (ref: util/execdetails CopTasksDetails):
        # the statement's cop-task sidecar aggregate + MPP gather details —
        # always on (allocation-light), reset per statement; feeds the slow
        # log, statements_summary, and EXPLAIN ANALYZE
        self.exec_summary = None  # CopTasksSummary, allocated on first task
        self.mpp_details: list = []
        # cop sidecars arrive from CONCURRENT workers (partition fan-out,
        # index-merge paths): the aggregate's check-then-create and its +=
        # folds must not race
        self._detail_mu = threading.Lock()
        self._last_plan = None  # the finished statement's physical plan
        # per-statement memory tracker + kill flag (ref: memory.Tracker root
        # at the session, sqlkiller checked at executor boundaries)
        self.mem_tracker = None
        # the finished statement's tracker peak (bytes): _select captures it
        # before dropping the tracker; slow_query.MEM_MAX / MAX_MEM read it
        self._last_mem_peak = 0
        self._killed = False
        self._deadline: Optional[float] = None
        # per-statement write-side accounting (WRU inputs): accumulated from
        # Txn.write_keys/write_bytes at _finish_txn, reset per statement —
        # an explicit COMMIT statement carries the whole txn's writes
        self._stmt_write_keys = 0
        self._stmt_write_bytes = 0
        # DRYRUN runaway observation: (deadline, group_name) armed by _select
        # for groups whose QUERY_LIMIT action is DRYRUN — check_killed records
        # the breach WITHOUT killing (observational only; KILL keeps its
        # enforcing deadline in self._deadline)
        self._runaway_obs: Optional[tuple] = None
        self._runaway_fired = False  # this statement already logged a runaway
        self._cur_sql = ""  # current statement text (runaway record sample)
        # session-scoped plan bindings (override globals; ref: bindinfo scope)
        self.bindings: dict[str, tuple[str, str]] = {}
        # user variables (@x) and prepared statements (session-scoped)
        self.user_vars: dict[str, Any] = {}
        self.prepared: dict[str, PreparedStmt] = {}
        # session LRU plan cache (ref: core/plan_cache_lru.go:44); key
        # includes schema/stats versions so DDL and ANALYZE invalidate it
        self._plan_cache: OrderedDict[tuple, Any] = OrderedDict()
        # statement fast lane (ref: the non-prepared plan cache): raw SQL
        # text → parsed AST, skipping the lexer/parser on warm repeats;
        # entries self-invalidate via the _stmt_epoch snapshot
        self._stmt_cache: OrderedDict[str, _CachedStmt] = OrderedDict()
        # bumped on session-scoped CREATE/DROP BINDING (fast-lane epoch)
        self.bindings_ver = 0
        # value-agnostic prepared-plan lane state (see _execute_prepared_select)
        self._prep_capture: Optional[dict] = None
        self._prep_pg_keys: set = set()
        self._prep_va_refused: set = set()
        # SHOW WARNINGS buffer [(level, code, message)] + statement counter
        self.warnings: list[tuple] = []
        # the buffer as of the LAST statement — @@warning_count reads this
        # (the reading statement already cleared self.warnings)
        self._prev_warnings: list[tuple] = []
        self._stmt_count = 0

    def append_warning(self, level: str, code: int, msg: str) -> None:
        """Statement-context warning accumulation (ref: stmtctx.go:1025
        AppendWarning), capped at max_error_count like MySQL."""
        cap = 64
        try:
            cap = int(self.vars.get("max_error_count", 64))
        except (TypeError, ValueError):
            pass
        cap = min(cap, 65535)  # the wire count field is a u16 (MySQL clamps)
        if len(self.warnings) < cap:
            self.warnings.append((level, code, msg))

    # -- txn lifecycle (ref: LazyTxn) ---------------------------------------
    def txn(self) -> Txn:
        if self._txn is None:
            self._txn = self.store.begin()
        return self._txn

    def txn_for_read(self) -> Txn:
        return self.txn()

    def read_ts(self) -> int:
        if self._read_ts_override is not None:
            return self._read_ts_override
        if self._txn is not None:
            return self._txn.start_ts
        # tidb_read_staleness: negative seconds → bounded-staleness autocommit
        # reads (ref: staleread/provider.go + tidb_read_staleness)
        stale = float(self.vars.get("tidb_read_staleness", 0) or 0)
        if stale:
            import time

            return max(0, int((time.time() + stale) * 1000)) << 18
        return self.store.current_ts()

    def _txn_dirty(self) -> bool:
        return self._txn is not None and len(self._txn.membuf) > 0

    def begin(self, mode: str = "") -> None:
        self._finish_txn(commit=True)
        self._explicit = True
        mode = mode or str(self.vars.get("tidb_txn_mode", "pessimistic"))
        from tidb_tpu_torch.kv.txn import Txn

        self._txn = Txn(self.store, pessimistic=(mode == "pessimistic"))

    def lock_for_write(self, keys: list[bytes]) -> None:
        """Statement-time pessimistic locking for DML/FOR UPDATE keys
        (ref: executor lockRows → client-go LockKeys). Autocommit single
        statements skip it: 2PC conflict detection already covers them."""
        if not self._explicit or self._txn is None or not self._txn.pessimistic:
            return
        wait_ms = int(float(self.vars.get("innodb_lock_wait_timeout", 3)) * 1000)
        self._txn.lock_keys(keys, wait_timeout_ms=wait_ms)

    def commit(self) -> None:
        self._finish_txn(commit=True)
        self._explicit = False

    def rollback(self) -> None:
        self._finish_txn(commit=False)
        self._explicit = False

    def _finish_txn(self, commit: bool) -> None:
        if self._txn is not None:
            t, self._txn = self._txn, None
            if commit:
                t.commit()
                self._stmt_write_keys += getattr(t, "write_keys", 0)
                self._stmt_write_bytes += getattr(t, "write_bytes", 0)
                # stats deltas flush at commit, not per statement (ref:
                # stats delta dumping) — rolled-back mods never count
                for tid, n in self._pending_mods.items():
                    self._db.stats.note_mods(tid, n)
            else:
                t.rollback()
        self._pending_mods.clear()

    def kill(self) -> None:
        """Cross-thread query cancel (ref: util/sqlkiller)."""
        self._killed = True

    def check_killed(self) -> None:
        """Called at executor boundaries (chunk/task granularity)."""
        import time

        from tidb_tpu_torch.utils.memory import QueryKilledError

        if self._killed:
            self._killed = False
            raise QueryKilledError("Query execution was interrupted")
        if self._deadline is not None and time.monotonic() > self._deadline:
            raise QueryKilledError("Query execution was interrupted, maximum statement execution time exceeded")
        if self._runaway_obs is not None and time.monotonic() > self._runaway_obs[0]:
            # DRYRUN runaway: record + WARN event, never kill (observational)
            _, gname = self._runaway_obs
            self._runaway_obs = None
            self._runaway_fired = True
            self._db.resource_groups.record_runaway(gname, "DRYRUN", self._cur_sql[:256])

    # -- tracing (ref: util/tracing StartRegionEx call sites) ----------------
    def span(self, name: str):
        # no statement tracer: a span on the window while one records
        # (tracing.start_window), else the shared null context
        tr = self.tracer if self.tracer is not None else _tracing.window()
        return _tracing.NULL_SPAN if tr is None else tr.span(name)

    def _sample_tracer(self):
        """The per-statement sampling coin (ref: Dapper §4 uniform
        sampling): rate from ``tidb_tpu_trace_sample_rate``, optionally
        seeded by ``tidb_tpu_trace_sample_seed`` so tests get a
        deterministic accept/reject sequence. Returns a sampled Tracer or
        None. Only called when the rate sysvar is truthy — the rate-0 hot
        path never reaches this."""
        try:
            r = float(self.vars.get("tidb_tpu_trace_sample_rate", 0) or 0)
        except (TypeError, ValueError):
            return None
        if r <= 0:
            return None
        # adaptive clamp (ROADMAP 4a): under load pressure the effective
        # rate scales toward 0 (bounded sampled-statements/sec), restoring
        # itself as soon as the recent-QPS signal falls back under the knob
        from tidb_tpu_torch import config as _config

        clamp = _config.current().trace_clamp_qps
        if clamp > 0:
            from tidb_tpu_torch.utils.tracing import clamp_rate

            r = clamp_rate(r, self._db.health.recent_qps(), clamp)
            if r <= 0:
                return None
        if r < 1.0:
            seed = str(self.vars.get("tidb_tpu_trace_sample_seed", "") or "").strip()
            if self._trace_rng is None or seed != self._trace_rng_seed:
                import random as _random

                try:
                    self._trace_rng = _random.Random(int(seed)) if seed else _random.Random()
                except ValueError:
                    self._trace_rng = _random.Random(seed)
                self._trace_rng_seed = seed
            if self._trace_rng.random() >= r:
                return None
        from tidb_tpu_torch.utils.tracing import Tracer

        return Tracer(sampled=True)

    def _deposit_trace(self, tracer, dt_s: float, sql: str) -> None:
        """Finished sampled statement → the DB's trace reservoir. Tail-keep:
        a statement over the slow-log threshold pins its trace (the slow log
        entry carries the same trace id, so an operator pivots slow-log →
        full span tree)."""
        import time as _time

        from tidb_tpu_torch.utils import metrics as _m
        from tidb_tpu_torch.utils.stmtsummary import digest as _digest
        from tidb_tpu_torch.utils.tracing import TraceEntry

        try:
            thr = float(self.vars.get("tidb_slow_log_threshold", 300)) / 1000.0
        except (TypeError, ValueError):
            thr = 0.3
        slow = dt_s >= thr
        self._db.trace_reservoir.add(
            TraceEntry(
                tracer.trace_id, _time.time(), sql[:512],
                _digest(sql).partition("|")[0], dt_s, slow, tracer.dump(),
            )
        )
        _m.TRACE_SAMPLED.inc(kind="slow" if slow else "ok")

    # -- distributed exec-details collection (ref: util/execdetails) ---------
    def record_cop_detail(self, plan, detail) -> None:
        """One cop task's wire-shipped/locally-collected ExecDetails sidecar:
        into the statement aggregate and, under EXPLAIN ANALYZE, the plan
        node's cop_task execution-info line. Locked: partition fan-out and
        index-merge path workers record concurrently — an unlocked
        check-then-create would drop whole workers' sidecars."""
        with self._detail_mu:
            ed = self.exec_summary
            if ed is None:
                from tidb_tpu_torch.utils.execdetails import CopTasksSummary

                ed = self.exec_summary = CopTasksSummary()
            ed.add(detail)
            if self.runtime_stats is not None:
                self.runtime_stats.record_cop(plan, detail)

    def record_mpp_detail(self, plan, detail) -> None:
        """One MPP gather's exec-details (local mesh or remote dispatch)."""
        self.mpp_details.append(detail)
        if self.runtime_stats is not None:
            self.runtime_stats.record_mpp(plan, detail)

    def _assemble_usage(self, dt_s: float, cpu_ms: float, rows: int):
        """Fold the statement's exec-details sidecars and write accounting
        into one ResourceUsage record (the RU metering input). Reads only
        per-statement state — call after the statement finishes, before the
        next one resets the sidecars."""
        from tidb_tpu_torch.resourcegroup.groups import ResourceUsage

        u = ResourceUsage(wall_ms=dt_s * 1000.0, cpu_ms=cpu_ms, rows_returned=rows)
        cs = self.exec_summary
        if cs is not None and cs.num:
            u.cop_rpcs = cs.num
            u.device_ms = cs.device_ms
            u.host_ms = cs.host_ms
            u.h2d_bytes = cs.h2d_bytes
            u.d2h_bytes = cs.d2h_bytes
            u.backoff_ms = cs.backoff_ms
            u.keys_scanned = cs.keys_scanned
            u.bytes_scanned = cs.bytes_scanned
        for m in self.mpp_details:
            for s in m.shards:
                if len(s) > 3:
                    u.mpp_exchange_bytes += int(s[3])
            u.mpp_exchange_bytes += sum(int(b) for b in m.stage_bytes)
        u.keys_written = self._stmt_write_keys
        u.bytes_written = self._stmt_write_bytes
        return u.finalize()

    def _audit_stmt(self, sql: str, event: str, duration_s: float, error: str = "") -> None:
        if not self._db.extensions.have:
            return
        import time as _time

        from tidb_tpu_torch.extension import StmtEvent

        self._db.extensions.notify_stmt(
            StmtEvent(
                _time.time(), f"{self.user}@{self.host}", self.current_db,
                sql[:512], event, error=error[:256], duration_s=duration_s,
            )
        )

    # -- entry points --------------------------------------------------------
    def _instance_cache_on(self) -> bool:
        """Cross-session plan/AST reuse (ref: tidb_enable_instance_plan_cache)."""
        return bool(sysvar_int(self.vars, "tidb_enable_instance_plan_cache", 1))

    def _inst_stmt_key(self, sql: str) -> tuple:
        """Instance AST-cache key: everything session-shaped that changes
        what ``parse`` + binding substitution would produce rides the KEY
        (validity epochs ride the entry — see execute())."""
        return (
            sql,
            self.current_db,
            str(self.vars.get("tidb_isolation_read_engines")),
            str(self.vars.get("sql_mode", "")),
        )

    def _stmt_epoch(self) -> tuple:
        """Statement fast-lane validity snapshot: any change here (DDL,
        ANALYZE, binding create/drop, engine isolation, sql_mode, schema
        context) invalidates cached ASTs — a fast-lane hit must never serve
        anything the full parse path would not have produced."""
        return (
            self.catalog.schema_version,
            self._db.stats.version,
            self.bindings_ver,
            self._db.bindings_ver,
            self.current_db,
            str(self.vars.get("tidb_isolation_read_engines")),
            str(self.vars.get("sql_mode", "")),
        )

    def execute(self, sql: str) -> Result:
        # the statement's root span while a window records
        # (tracing.start_window): every span the statement opens, on any
        # thread, carries this root's id
        win = _tracing.window()
        with win.span("statement") if win is not None else _tracing.NULL_SPAN:
            return self._execute_sql(sql)

    def _execute_sql(self, sql: str) -> Result:
        import time as _time

        from tidb_tpu_torch.utils import metrics as _m

        t0 = _time.perf_counter()
        # -- always-on sampled tracing: ONE dict read when the rate is 0, so
        # the tracer-is-None zero-cost path stays strictly intact
        if self._sampled_tracer is not None:
            # a prior statement died between arming and deposit (e.g. the
            # schema-lease check raised mid-window): discard the orphan so
            # nothing leaks across statements
            self.tracer = None
            self._sampled_tracer = None
        s_span = None
        if self.tracer is None and self.vars.get("tidb_tpu_trace_sample_rate", 0):
            tr = self._sample_tracer()
            if tr is not None:
                self.tracer = self._sampled_tracer = tr
                s_span = tr.span("statement")
                s_span.__enter__()
        entry: Optional[_CachedStmt] = None
        cached = self._stmt_cache.get(sql)
        if cached is not None:
            # lease first: a catalog reload here bumps schema_version, which
            # the epoch comparison below must observe
            self._db.ensure_schema_lease()
            if cached.epoch == self._stmt_epoch():
                self._stmt_cache.move_to_end(sql)
                entry = cached
            else:
                self._stmt_cache.pop(sql, None)
        # instance (cross-session) AST lane: a FRESH session reuses the warm
        # AST another session parsed — the short-lived-connection shape.
        # ASTs bake nothing schema/stats-shaped (planning re-derives from the
        # live catalog), so the entry's only epoch is the GLOBAL binding
        # version; session-local bindings bypass the shared lane entirely.
        inst_stmt_key = None
        inst_entry: Optional[_CachedStmt] = None
        if entry is None and not self.bindings and self._instance_cache_on():
            inst_stmt_key = self._inst_stmt_key(sql)
            ie = self._db.inst_stmt_cache.get(inst_stmt_key)
            if ie is not None:
                self._db.ensure_schema_lease()
                if ie.epoch == (self._db.bindings_ver,):
                    _m.INSTANCE_PLAN_CACHE.inc(result="ast_hit")
                    inst_entry = ie
                    entry = _CachedStmt(ie.stmt, ie.stype, self._stmt_epoch(), ie.exec_sql)
                    entry.digest = ie.digest
                    self._stmt_cache[sql] = entry
                    cap = sysvar_int(self.vars, "tidb_prepared_plan_cache_size", 100)
                    while len(self._stmt_cache) > cap:
                        self._stmt_cache.popitem(last=False)
                else:
                    self._db.inst_stmt_cache.pop(inst_stmt_key)
        if entry is not None:
            stmt, stype, exec_sql = entry.stmt, entry.stype, entry.exec_sql
        else:
            try:
                with self.span("parse"):
                    stmt = parse(sql)
            except Exception as exc:
                # failed parses still reach the audit trail (probing attempts)
                _m.STMT_TOTAL.inc(type="ParseError")
                self._audit_stmt(sql, "error", _time.perf_counter() - t0, str(exc))
                if self._sampled_tracer is not None:
                    # nothing executed — a parse-error trace is noise
                    self.tracer = None
                    self._sampled_tracer = None
                raise
            stype = type(stmt).__name__
            exec_sql = sql
            # plan bindings: a bound statement with a matching digest replaces
            # the incoming one (ref: bindinfo matching by normalized digest)
            cacheable_ast = isinstance(stmt, (ast.Select, ast.SetOp))
            if cacheable_ast and (self.bindings or self._db.bindings):
                from tidb_tpu_torch.utils.stmtsummary import digest as _digest

                d = _digest(sql)
                bound = self.bindings.get(d) or self._db.bindings.get(d)
                if bound is not None:
                    exec_sql = bound[1]
                    stmt = parse(exec_sql)
            # schema-validator lease: cross-node DDL becomes visible at most
            # one lease behind; past the lease with an unreachable store the
            # node refuses to answer from its stale catalog
            self._db.ensure_schema_lease()
            if cacheable_ast and not _has_ctes(stmt):
                entry = _CachedStmt(stmt, stype, self._stmt_epoch(), exec_sql)
                self._stmt_cache[sql] = entry
                cap = sysvar_int(self.vars, "tidb_prepared_plan_cache_size", 100)
                while len(self._stmt_cache) > cap:
                    self._stmt_cache.popitem(last=False)
                if inst_stmt_key is not None:
                    # this probe missed above → publish for other sessions
                    _m.INSTANCE_PLAN_CACHE.inc(result="ast_miss")
                    inst_entry = _CachedStmt(stmt, stype, (self._db.bindings_ver,), exec_sql)
                    self._db.inst_stmt_cache.put(inst_stmt_key, inst_entry)
        # one digest per statement, shared by bindings/Top-SQL/stmt-summary
        # (previously computed up to three times per statement); the memo
        # writes through to the INSTANCE entry too, so the whole fleet of
        # short-lived sessions sharing one AST computes the digest once
        digest_cache = [entry.digest if entry is not None else None]

        def sql_digest() -> str:
            if digest_cache[0] is None:
                from tidb_tpu_torch.utils.stmtsummary import digest as _digest

                digest_cache[0] = _digest(exec_sql)
                if entry is not None:
                    entry.digest = digest_cache[0]
                if inst_entry is not None:
                    inst_entry.digest = digest_cache[0]
            return digest_cache[0]

        self._stmt_count += 1
        # per-statement exec-details lifecycle (cheap: three attribute sets)
        self.exec_summary = None
        self.mpp_details = []
        self._last_plan = None
        self._last_mem_peak = 0
        self._stmt_write_keys = 0
        self._stmt_write_bytes = 0
        self._runaway_fired = False
        self._cur_sql = exec_sql
        t0_cpu = _time.thread_time()
        if not isinstance(stmt, ast.Show):  # SHOW WARNINGS must see them
            self._prev_warnings = self.warnings
            self.warnings = []
        # Top-SQL attribution: samples taken while this thread executes the
        # statement land on its digest (ref: topsql.AttachSQLInfo)
        topsql = None
        if self.vars.get("tidb_enable_top_sql", 0):
            from tidb_tpu_torch.utils.topsql import collector as _topsql

            topsql = _topsql()
            topsql.attach(
                sql_digest().split("|")[0], "", exec_sql,
                trace_id=(self._sampled_tracer.trace_id if self._sampled_tracer is not None else ""),
            )
        try:
            res = self._execute_stmt(stmt, sql_text=exec_sql)
            if not self._explicit and self._txn is not None:
                self._finish_txn(commit=True)
            dt = _time.perf_counter() - t0
            _m.STMT_TOTAL.inc(type=stype)
            _m.QUERY_DURATION.observe(dt)
            pd = ""
            if self._last_plan is not None:
                from tidb_tpu_torch.utils.execdetails import plan_digest as _plan_digest

                # memoized on the plan object — cached plans pay this once
                pd = _plan_digest(self._last_plan)
            # workload attribution: fold the statement's sidecars + write
            # accounting into a measured ResourceUsage → RUs (metering only;
            # ref: the resource-control RU model + RunawayChecker at
            # adapter.go:553)
            from tidb_tpu_torch.resourcegroup import groups as _rg

            gname = str(self.vars.get("tidb_resource_group", "default"))
            g = self._db.resource_groups.get(gname)
            usage = None
            ru = 0.0
            if _rg.METERING_ENABLED:
                usage = self._assemble_usage(
                    dt, (_time.thread_time() - t0_cpu) * 1000.0,
                    len(res.rows) or res.affected,
                )
                ru = usage.ru
            self._db.stmt_summary.record(
                exec_sql, dt, len(res.rows) or res.affected, f"{self.user}@{self.host}",
                float(self.vars.get("tidb_slow_log_threshold", 300)) / 1000.0,
                digest_val=sql_digest(),
                plan_digest=pd,
                cop=self.exec_summary,
                # slow-log → reservoir pivot: the sampled trace's id rides
                # the structured SlowEntry
                trace_id=(self._sampled_tracer.trace_id if self._sampled_tracer is not None else ""),
                mem_max=self._last_mem_peak,
                ru=ru,
                resource_group=(g.name if g is not None else gname),
            )
            if topsql is not None and ru:
                topsql.note_ru(sql_digest().split("|")[0], ru)
            if g is not None:
                if usage is not None:
                    g.consume(ru)
                    self._db.resource_groups.charge(g.name, usage)
                if g.exec_elapsed_s and dt > g.exec_elapsed_s and not self._runaway_fired:
                    self._db.resource_groups.record_runaway(g.name, g.action, exec_sql[:256])
            self._audit_stmt(exec_sql, "ok", dt)
            return res
        except Exception as exc:
            _m.STMT_TOTAL.inc(type=f"{stype}:error")
            self._audit_stmt(exec_sql, "error", _time.perf_counter() - t0, str(exc))
            g = self._db.resource_groups.get(str(self.vars.get("tidb_resource_group", "default")))
            if (
                g is not None and g.exec_elapsed_s
                and (_time.perf_counter() - t0) >= g.exec_elapsed_s
                and not self._runaway_fired
            ):
                self._db.resource_groups.record_runaway(g.name, g.action, exec_sql[:256])
            if not self._explicit and self._txn is not None:
                # autocommit statement failed → roll back its staged writes
                self._finish_txn(commit=False)
            elif self._explicit and self._txn is not None:
                # statement-level atomicity inside explicit txn is handled by
                # membuffer staging in _execute_stmt for DML
                pass
            raise
        finally:
            if topsql is not None:
                topsql.detach()
            if self._sampled_tracer is not None:
                tr, self._sampled_tracer = self._sampled_tracer, None
                if s_span is not None:
                    s_span.__exit__(None, None, None)
                if self.tracer is tr:
                    self.tracer = None
                self._deposit_trace(tr, _time.perf_counter() - t0, sql)

    def query(self, sql: str) -> list[tuple]:
        return self.execute(sql).rows

    # -- dispatch ------------------------------------------------------------
    def _execute_stmt(self, stmt: ast.Node, sql_text: Optional[str] = None) -> Result:
        if isinstance(stmt, (ast.Select, ast.SetOp)):
            return self._select(stmt, cache_key=sql_text)
        if isinstance(stmt, (ast.Insert, ast.Update, ast.Delete)):
            from tidb_tpu_torch.executor import write

            fn = {
                ast.Insert: write.execute_insert,
                ast.Update: write.execute_update,
                ast.Delete: write.execute_delete,
            }[type(stmt)]
            priv = {ast.Insert: "insert", ast.Update: "update", ast.Delete: "delete"}[type(stmt)]
            self.require_priv(stmt.table.db or self.current_db, stmt.table.name, priv)
            t = self.catalog.table(stmt.table.db or self.current_db, stmt.table.name)
            res = self._dml(lambda: fn(self, stmt))
            if isinstance(stmt, ast.Insert):
                res.last_insert_id = getattr(self, "_stmt_insert_id", 0)
            # stats modify counter feeds auto-analyze (ref: stats delta dump)
            self.note_table_mods(t.id, res.affected)
            return res
        if isinstance(stmt, ast.CreateSequence):
            self.require_priv(stmt.db or self.current_db, stmt.name, "create")
            self.catalog.create_sequence(
                stmt.db or self.current_db, stmt.name, stmt.start, stmt.increment, stmt.if_not_exists
            )
            return Result()
        if isinstance(stmt, ast.DropSequence):
            for nm in stmt.names:
                self.require_priv(self.current_db, nm, "drop")
                self.catalog.drop_sequence(self.current_db, nm, stmt.if_exists)
            return Result()
        if isinstance(stmt, ast.CreateView):
            self.require_priv(stmt.table.db or self.current_db, stmt.table.name, "create")
            self.catalog.create_view(stmt.table.db or self.current_db, stmt)
            return Result()
        if isinstance(stmt, ast.DropView):
            for tr in stmt.tables:
                self.require_priv(tr.db or self.current_db, tr.name, "drop")
                self.catalog.drop_view(tr.db or self.current_db, tr.name, stmt.if_exists)
            return Result()
        if isinstance(stmt, ast.CreateTable):
            self.require_priv(stmt.table.db or self.current_db, stmt.table.name, "create")
            self.catalog.create_table(stmt.table.db or self.current_db, stmt)
            return Result()
        if isinstance(stmt, ast.DropTable):
            for tr in stmt.tables:
                self.require_priv(tr.db or self.current_db, tr.name, "drop")
                self.catalog.drop_table(tr.db or self.current_db, tr.name, if_exists=stmt.if_exists)
            return Result()
        if isinstance(stmt, ast.TruncateTable):
            self.require_priv(stmt.table.db or self.current_db, stmt.table.name, "drop")
            self.catalog.truncate_table(stmt.table.db or self.current_db, stmt.table.name)
            return Result()
        if isinstance(stmt, ast.AlterTable):
            self.require_priv(stmt.table.db or self.current_db, stmt.table.name, "alter")
            self.catalog.alter_table(stmt.table.db or self.current_db, stmt)
            return Result()
        if isinstance(stmt, ast.CreateIndex):
            alter = ast.AlterTable(stmt.table, action="add_index", index=stmt.index)
            self.catalog.alter_table(stmt.table.db or self.current_db, alter)
            return Result()
        if isinstance(stmt, ast.DropIndex):
            alter = ast.AlterTable(stmt.table, action="drop_index", name=stmt.name)
            self.catalog.alter_table(stmt.table.db or self.current_db, alter)
            return Result()
        if isinstance(stmt, ast.CreateDatabase):
            self.catalog.create_database(stmt.name, stmt.if_not_exists)
            return Result()
        if isinstance(stmt, ast.DropDatabase):
            self.catalog.drop_database(stmt.name, stmt.if_exists)
            return Result()
        if isinstance(stmt, ast.UseDatabase):
            if stmt.name.lower() != "information_schema":
                self.catalog.db(stmt.name)  # raises if unknown
            self.current_db = stmt.name.lower()
            return Result()
        if isinstance(stmt, ast.SetVariable):
            return self._set_var(stmt)
        if isinstance(stmt, ast.Show):
            return self._show(stmt)
        if isinstance(stmt, ast.RenameTables):
            # all-or-nothing like MySQL: simulate the left-to-right chain
            # against a name snapshot before touching the catalog
            names: dict = {}
            for old, new in stmt.pairs:
                odb = (old.db or self.current_db).lower()
                ndb = (new.db or self.current_db).lower()
                if odb != ndb:
                    raise SessionError("RENAME TABLE across databases is not supported")
                live = names.setdefault(odb, set(self.catalog.tables(odb)) | set(self.catalog.views(odb)))
                if old.name.lower() not in live:
                    raise SessionError(f"Table '{odb}.{old.name}' doesn't exist")
                if new.name.lower() in live:
                    raise SessionError(f"Table '{new.name}' already exists")
                live.discard(old.name.lower())
                live.add(new.name.lower())
            for old, new in stmt.pairs:
                alter = ast.AlterTable(ast.TableRef(old.name), action="rename", name=new.name)
                self.catalog.alter_table((old.db or self.current_db).lower(), alter)
            return Result()
        if isinstance(stmt, ast.DoStmt):
            # DO evaluates for side effects and discards results (errors
            # still surface, unlike SELECT's result shipping)
            self._select(ast.Select(items=[ast.SelectItem(e) for e in stmt.exprs]))
            return Result()
        if isinstance(stmt, ast.ChecksumTable):
            return self._checksum(stmt)
        if isinstance(stmt, ast.Begin):
            self.begin(stmt.mode)
            return Result()
        if isinstance(stmt, ast.Commit):
            self.commit()
            return Result()
        if isinstance(stmt, ast.Rollback):
            self.rollback()
            return Result()
        if isinstance(stmt, ast.Explain):
            return self._explain(stmt)
        if isinstance(stmt, ast.AnalyzeTable):
            return self._analyze(stmt)
        if isinstance(stmt, ast.CreateBinding):
            from tidb_tpu_torch.utils.stmtsummary import digest as _digest

            store = self._db.bindings if stmt.is_global else self.bindings
            store[_digest(stmt.for_text)] = (stmt.for_text, stmt.using_text)
            self._note_bindings_changed(stmt.is_global)
            return Result()
        if isinstance(stmt, ast.DropBinding):
            from tidb_tpu_torch.utils.stmtsummary import digest as _digest

            store = self._db.bindings if stmt.is_global else self.bindings
            store.pop(_digest(stmt.for_text), None)
            self._note_bindings_changed(stmt.is_global)
            return Result()
        if isinstance(stmt, ast.RecoverTable):
            self.require_priv(stmt.table.db or self.current_db, stmt.table.name, "create")
            self.catalog.recover_table(stmt.table.db or self.current_db, stmt.table.name, stmt.new_name)
            return Result()
        if isinstance(stmt, ast.Admin):
            return self._admin(stmt)
        if isinstance(stmt, ast.ResourceGroupStmt):
            from tidb_tpu_torch.resourcegroup import ResourceGroup

            mgr = self._db.resource_groups
            if stmt.op == "drop":
                mgr.drop(stmt.name, stmt.if_exists)
            else:
                g = ResourceGroup(
                    stmt.name,
                    ru_per_sec=stmt.ru_per_sec,
                    burstable=stmt.burstable,
                    exec_elapsed_s=stmt.exec_elapsed_s,
                    action=stmt.action,
                )
                if stmt.op == "create":
                    mgr.create(g, stmt.if_not_exists)
                else:
                    mgr.alter(g)
            return Result()
        if isinstance(stmt, ast.SetResourceGroup):
            if self._db.resource_groups.get(stmt.name) is None:
                raise SessionError(f"unknown resource group {stmt.name!r}")
            self.vars["tidb_resource_group"] = stmt.name
            return Result()
        if isinstance(stmt, ast.Trace):
            from tidb_tpu_torch.utils.tracing import Tracer

            self.tracer = Tracer()
            try:
                with self.tracer.span(type(stmt.stmt).__name__.lower()):
                    self._execute_stmt(stmt.stmt)
            finally:
                tracer, self.tracer = self.tracer, None
            return Result(columns=["operation", "startTS", "duration"], rows=tracer.rows())
        if isinstance(stmt, ast.CreateUser):
            return self._create_user(stmt)
        if isinstance(stmt, ast.DropUser):
            return self._drop_user(stmt)
        if isinstance(stmt, ast.AlterUser):
            return self._alter_user(stmt)
        if isinstance(stmt, ast.PlanReplayer):
            from tidb_tpu_torch.tools import replayer

            if stmt.kind == "dump":
                path = replayer.dump(self, stmt.sql)
                return Result(columns=["File_token"], rows=[(path,)])
            sql = replayer.load(self, stmt.path)
            return Result(columns=["Loaded_SQL"], rows=[(sql,)])
        if isinstance(stmt, ast.Grant):
            return self._grant(stmt)
        if isinstance(stmt, ast.Kill):
            server = getattr(self._db, "server", None)
            if server is not None and server.kill(stmt.conn_id, stmt.query_only):
                return Result()
            # not local: route by the global conn id's server prefix (ref:
            # util/globalconn — KILL works across SQL nodes)
            if server is not None and server.kill_global(stmt.conn_id, stmt.query_only):
                return Result()
            raise SessionError(f"Unknown thread id: {stmt.conn_id}")
        if isinstance(stmt, ast.LoadData):
            return self._load_data(stmt)
        if isinstance(stmt, ast.ImportInto):
            from tidb_tpu_torch.tools.importer import import_into, import_into_disttask

            if sysvar_int(self.vars, "tidb_enable_dist_task", 0):
                import_into = import_into_disttask
            n = import_into(
                self._db,
                stmt.table.db or self.current_db,
                stmt.table.name,
                stmt.path,
                skip_header=(bool(int(stmt.options["skip_header"])) if "skip_header" in stmt.options else None),
                delimiter=str(stmt.options.get("delimiter", ",")),
            )
            t = self.catalog.table(stmt.table.db or self.current_db, stmt.table.name)
            self._db.stats.note_mods(t.id, n)  # feeds auto-analyze directly
            return Result(affected=n)
        if isinstance(stmt, ast.Backup):
            from tidb_tpu_torch.tools.brie import backup_database

            if stmt.tables:
                db_name = stmt.tables[0].db or self.current_db
                meta = backup_database(self._db, db_name, stmt.dest, [tr.name for tr in stmt.tables])
            else:
                meta = backup_database(self._db, stmt.db or self.current_db, stmt.dest)
            rows = [(stmt.dest, name, tm["rows"]) for name, tm in meta["tables"].items()]
            return Result(columns=["Destination", "Table", "Rows"], rows=rows)
        if isinstance(stmt, ast.Restore):
            from tidb_tpu_torch.tools.brie import restore_database

            out, _ = restore_database(self._db, stmt.src, stmt.db or None)
            return Result(columns=["Table", "Rows"], rows=sorted(out.items()))
        if isinstance(stmt, ast.Prepare):
            return self._prepare(stmt)
        if isinstance(stmt, ast.ExecutePrepared):
            return self._execute_prepared(stmt)
        if isinstance(stmt, ast.Deallocate):
            if stmt.name not in self.prepared:
                raise SessionError(f"unknown prepared statement '{stmt.name}'")
            del self.prepared[stmt.name]
            return Result()
        raise SessionError(f"unsupported statement {type(stmt).__name__}")

    # -- ADMIN statements (ref: executor/admin.go) ---------------------------
    def _admin(self, stmt: ast.Admin) -> Result:
        from tidb_tpu_torch.catalog.ddl import admin_check_index

        if stmt.kind == "show_ddl_jobs":
            rows = [
                (j.id, j.tp, j.state, j.db, j.table_id)
                for j in reversed(self.catalog.ddl.history())
            ]
            return Result(columns=["JOB_ID", "JOB_TYPE", "STATE", "DB_NAME", "TABLE_ID"], rows=rows)
        t = self.catalog.table(stmt.table.db or self.current_db, stmt.table.name)
        if stmt.kind == "check_index":
            idx = next((i for i in t.indexes if i.name == stmt.index), None)
            if idx is None:
                raise SessionError(f"unknown index {stmt.index!r}")
            for view in t.partition_views():
                admin_check_index(self.store, view, idx)
            return Result()
        # check_table: every public index
        for idx in t.indexes:
            if idx.state != "public":
                continue
            for view in t.partition_views():
                admin_check_index(self.store, view, idx)
        return Result()

    # -- privileges (ref: executor/grant.go, revoke.go, simple.go users) -----
    def require_priv(self, db: str, table: str, priv: str) -> None:
        if self.user == "root":
            return  # embedded/bootstrap superuser fast path
        self._db.priv_checker.require(self.user, self.host, db, table, priv)

    def _internal_root(self) -> "Session":
        s = self._db.session()
        s.user, s.host = "root", "%"
        return s

    @staticmethod
    def _sq(v) -> str:
        """Escape a value for single-quoted INTERNAL SQL: user/host names can
        contain quotes, and the privileged internal session must not be
        injectable through them."""
        return str(v).replace("\\", "\\\\").replace("'", "\\'")

    def _create_user(self, stmt: ast.CreateUser) -> Result:
        from tidb_tpu_torch.privilege import ALL_PRIVS, encode_password_with

        self.require_priv("mysql", "user", "insert")
        self._db.ensure_priv_bootstrap()
        s = self._internal_root()
        for u in stmt.users:
            exists = s.query(
                f"SELECT 1 FROM mysql.user WHERE User = '{self._sq(u.name)}' AND Host = '{self._sq(u.host)}'"
            )
            if exists:
                if stmt.if_not_exists:
                    continue
                raise SessionError(f"Operation CREATE USER failed for '{self._sq(u.name)}'@'{self._sq(u.host)}'")
            if u.plugin not in ("mysql_native_password", "caching_sha2_password"):
                raise SessionError(f"unknown auth plugin {u.plugin!r}")
            ns = ", ".join(["'N'"] * len(ALL_PRIVS))
            s.execute(
                f"INSERT INTO mysql.user VALUES ('{self._sq(u.host)}', '{self._sq(u.name)}', "
                f"'{encode_password_with(u.password, u.plugin)}', '{u.plugin}', {ns})"
            )
        self._db.priv_version += 1
        return Result()

    def _alter_user(self, stmt) -> Result:
        from tidb_tpu_torch.privilege import encode_password_with

        self.require_priv("mysql", "user", "update")
        self._db.ensure_priv_bootstrap()
        s = self._internal_root()
        for u in stmt.users:
            if not s.query(
                f"SELECT 1 FROM mysql.user WHERE User = '{self._sq(u.name)}' AND Host = '{self._sq(u.host)}'"
            ):
                if stmt.if_exists:
                    continue
                raise SessionError(f"Operation ALTER USER failed for '{self._sq(u.name)}'@'{self._sq(u.host)}'")
            if not u.has_auth:
                continue  # no IDENTIFIED clause: leave the credential alone
            if u.plugin not in ("mysql_native_password", "caching_sha2_password"):
                raise SessionError(f"unknown auth plugin {u.plugin!r}")
            s.execute(
                f"UPDATE mysql.user SET authentication_string = "
                f"'{encode_password_with(u.password, u.plugin)}', plugin = '{u.plugin}' "
                f"WHERE User = '{self._sq(u.name)}' AND Host = '{self._sq(u.host)}'"
            )
        self._db.priv_version += 1
        return Result()

    def _drop_user(self, stmt: ast.DropUser) -> Result:
        self.require_priv("mysql", "user", "delete")
        self._db.ensure_priv_bootstrap()
        s = self._internal_root()
        for u in stmt.users:
            n = s.execute(
                f"DELETE FROM mysql.user WHERE User = '{self._sq(u.name)}' AND Host = '{self._sq(u.host)}'"
            ).affected
            if not n and not stmt.if_exists:
                raise SessionError(f"Operation DROP USER failed for '{self._sq(u.name)}'@'{self._sq(u.host)}'")
            s.execute(f"DELETE FROM mysql.db WHERE User = '{self._sq(u.name)}' AND Host = '{self._sq(u.host)}'")
            s.execute(f"DELETE FROM mysql.tables_priv WHERE User = '{self._sq(u.name)}' AND Host = '{self._sq(u.host)}'")
        self._db.priv_version += 1
        return Result()

    def _grant(self, stmt: ast.Grant) -> Result:
        from tidb_tpu_torch.privilege import ALL_PRIVS

        self.require_priv("mysql", "user", "update")
        self._db.ensure_priv_bootstrap()
        privs = [p for p in ALL_PRIVS if p != "super"] if stmt.privs == ["all"] else stmt.privs
        s = self._internal_root()
        if not s.query(f"SELECT 1 FROM mysql.user WHERE User = '{self._sq(stmt.user)}' AND Host = '{self._sq(stmt.host)}'"):
            raise SessionError(f"unknown user '{self._sq(stmt.user)}'@'{self._sq(stmt.host)}'")
        val = "'N'" if stmt.revoke else "'Y'"
        db = stmt.db or (self.current_db if stmt.table else "")
        if not db and not stmt.table:
            # global level → mysql.user flags
            sets = ", ".join(f"{p.capitalize()}_priv = {val}" for p in privs)
            s.execute(f"UPDATE mysql.user SET {sets} WHERE User = '{self._sq(stmt.user)}' AND Host = '{self._sq(stmt.host)}'")
        elif not stmt.table:
            # db level → mysql.db row upsert
            if not s.query(f"SELECT 1 FROM mysql.db WHERE User = '{self._sq(stmt.user)}' AND Host = '{self._sq(stmt.host)}' AND DB = '{self._sq(db)}'"):
                ns = ", ".join(["'N'"] * len(ALL_PRIVS))
                s.execute(f"INSERT INTO mysql.db VALUES ('{self._sq(stmt.host)}', '{self._sq(db)}', '{self._sq(stmt.user)}', {ns})")
            sets = ", ".join(f"{p.capitalize()}_priv = {val}" for p in privs)
            s.execute(
                f"UPDATE mysql.db SET {sets} WHERE User = '{self._sq(stmt.user)}' AND Host = '{self._sq(stmt.host)}' AND DB = '{self._sq(db)}'"
            )
        else:
            # table level → mysql.tables_priv SET-string merge
            cur = s.query(
                f"SELECT Table_priv FROM mysql.tables_priv WHERE User = '{self._sq(stmt.user)}' AND Host = '{self._sq(stmt.host)}' AND DB = '{self._sq(db)}' AND Table_name = '{self._sq(stmt.table)}'"
            )
            have = set()
            if cur:
                have = {p.strip().lower() for p in (cur[0][0] or "").split(",") if p.strip()}
            have = have - set(privs) if stmt.revoke else have | set(privs)
            ps = ",".join(sorted(p.capitalize() for p in have))
            if cur:
                s.execute(
                    f"UPDATE mysql.tables_priv SET Table_priv = '{ps}' WHERE User = '{self._sq(stmt.user)}' AND Host = '{self._sq(stmt.host)}' AND DB = '{self._sq(db)}' AND Table_name = '{self._sq(stmt.table)}'"
                )
            else:
                s.execute(
                    f"INSERT INTO mysql.tables_priv VALUES ('{self._sq(stmt.host)}', '{self._sq(db)}', '{self._sq(stmt.user)}', '{self._sq(stmt.table)}', '{ps}')"
                )
        self._db.priv_version += 1
        return Result()

    # -- prepared statements (ref: executor/prepared.go) ---------------------
    def _prepare(self, stmt: ast.Prepare) -> Result:
        from tidb_tpu_torch.parser import parse_with_params

        text = stmt.text
        if text is None:
            v = self.user_vars.get(stmt.from_var)
            if v is None:
                raise SessionError(f"user variable @{stmt.from_var} is not set")
            text = v.decode() if isinstance(v, bytes) else str(v)
        inner, n_params = parse_with_params(text)
        if isinstance(inner, (ast.Prepare, ast.ExecutePrepared, ast.Deallocate)):
            raise SessionError("cannot prepare a PREPARE/EXECUTE statement")
        self.prepared[stmt.name] = PreparedStmt(stmt.name, text, inner, n_params)
        return Result()

    def prepare(self, sql: str, name: str = "__lib") -> str:
        """Programmatic prepare; returns the statement name."""
        self._prepare(ast.Prepare(name, text=sql))
        return name

    def prepared_result_schema(self, name: str):
        """Prepare-time result metadata: plan the SELECT with NULL parameters
        and return (columns, ftypes); None for non-SELECTs or statements
        whose schema can't be derived before execution (ref: conn.go
        returning real column definitions in the COM_STMT_PREPARE response)."""
        ps = self.prepared.get(name)
        if ps is None or not isinstance(ps.stmt, (ast.Select, ast.SetOp)):
            return None
        import copy

        try:
            bound = copy.deepcopy(ps.stmt)
            if ps.n_params:
                bound = ast.bind_params(bound, [None] * ps.n_params)
            plan = self._plan_select(bound, cache_key=None)
        except Exception:
            return None
        return [oc.name for oc in plan.schema], [oc.ftype for oc in plan.schema]

    def execute_prepared(self, name: str, params: Optional[list] = None) -> Result:
        ps = self.prepared.get(name)
        if ps is None:
            raise SessionError(f"unknown prepared statement '{name}'")
        params = list(params or [])
        if len(params) != ps.n_params:
            raise SessionError(
                f"prepared statement '{name}' expects {ps.n_params} parameters, got {len(params)}"
            )
        if not ps.n_params:
            return self._execute_stmt(ps.stmt, sql_text=("__prep__", ps.text))
        if isinstance(ps.stmt, (ast.Select, ast.SetOp)):
            # value-agnostic lane: one cached plan per statement/type
            # signature, scan ranges rebuilt from the fresh parameters
            # (ref: plan_cache.go caching across parameter values)
            return self._execute_prepared_select(ps, params)
        # parameterized DML takes no plan cache — bind and run
        return self._execute_stmt(ast.bind_params(ps.stmt, params), sql_text=None)

    def _execute_prepared_select(self, ps: PreparedStmt, params: list) -> Result:
        """EXECUTE of a parameterized SELECT under the value-agnostic plan
        cache: point-gets keep their fast path (reported as cache hits on
        repeats), template hits skip parse/build/optimize entirely, and
        statements whose plans provably bake values (folded parameters,
        index merges, partition pruning, subquery snapshots) fall back to
        the old value-keyed cache after the first miss."""
        from tidb_tpu_torch.planner import prepcache
        from tidb_tpu_torch.utils import metrics as _m

        sig = tuple(prepcache.param_sig(p) for p in params)
        va_key = self._plan_cache_key(("__va__", ps.text, sig))
        # refusals are epoch-scoped: DDL/ANALYZE can change the plan shape
        # (drop an index merge, remove partitioning) into a templatable one,
        # so a refusal must not outlive the schema/stats that caused it
        refuse_key = (ps.text, sig, self.catalog.schema_version, self._db.stats.version)
        # instance (cross-session) template lane: the same epoch-carrying key
        # a session would use, plus sql_mode (sessions were previously the
        # isolation boundary for it). Disabled → the session-local store.
        inst_on = self._instance_cache_on()
        inst_key = None
        if inst_on:
            inst_key = self._plan_cache_key(
                ("__iva__", ps.text, sig, str(self.vars.get("sql_mode", "")))
            )
            tmpl = self._db.inst_plan_cache.get(inst_key)
        else:
            tmpl = self._plan_cache.get(va_key)
        if isinstance(tmpl, prepcache.PlanTemplate):
            # copy-on-execute: rebind a private clone of the shared template
            # (param constants + range/partition/path state), so concurrent
            # sessions executing the same template never race and the cached
            # template bytes never change
            inst = prepcache.instantiate(tmpl)
            if prepcache.rebind(inst, params):
                if inst_on:
                    _m.INSTANCE_PLAN_CACHE.inc(result="hit")
                else:
                    self._plan_cache.move_to_end(va_key)
                cap = {
                    "outer_stmt": ps.stmt,
                    "cached_plan": inst.plan,
                    "n_params": len(params),
                    "rebind": lambda: ast.bind_params(ps.stmt, params),
                }
                prev, self._prep_capture = self._prep_capture, cap
                try:
                    return self._execute_stmt(ps.stmt, sql_text=None)
                finally:
                    self._prep_capture = prev
            # the new values shifted the range derivation (e.g. a NULL
            # dropped an access condition): the cached plan can't serve THIS
            # execution — re-plan below (and republish, overwriting). The
            # shared entry stays for the sessions whose values keep the
            # original shape: one session's atypical parameters must not
            # keep destroying every other session's cache.
        if inst_on:
            _m.INSTANCE_PLAN_CACHE.inc(result="miss")
        if refuse_key in self._prep_va_refused:
            # statement proven non-agnostic: old behavior, values in the key
            bound = ast.bind_params(ps.stmt, params)
            key = ("__prep__", ps.text, tuple(repr(p) for p in params))
            return self._execute_stmt(bound, sql_text=key)
        bound = ast.bind_params(ps.stmt, params, mark=True)
        cap = {
            "outer_stmt": bound,
            "n_params": len(params),
            "pg_warm": va_key in self._prep_pg_keys,
        }
        prev, self._prep_capture = self._prep_capture, cap
        try:
            res = self._execute_stmt(bound, sql_text=None)
        finally:
            self._prep_capture = prev
        if cap.get("template") is not None:
            if inst_on:
                # publish for EVERY session of this instance; the template
                # keeps the first execution's plan pristine (clone-on-hit)
                self._db.inst_plan_cache.put(inst_key, cap["template"])
            else:
                self._plan_cache[va_key] = cap["template"]
                cap_n = sysvar_int(self.vars, "tidb_prepared_plan_cache_size", 100)
                while len(self._plan_cache) > cap_n:
                    self._plan_cache.popitem(last=False)
        elif cap.get("point_get"):
            if len(self._prep_pg_keys) > 512:
                self._prep_pg_keys.clear()
            self._prep_pg_keys.add(va_key)
        else:
            if len(self._prep_va_refused) > 512:
                self._prep_va_refused.clear()
            self._prep_va_refused.add(refuse_key)
        return res

    def _execute_prepared(self, stmt: ast.ExecutePrepared) -> Result:
        vals = []
        for vn in stmt.using:
            vals.append(self.user_vars.get(vn))
        return self.execute_prepared(stmt.name, vals)

    def _dml(self, fn) -> Result:
        txn = self.txn()
        txn.membuf.stage()
        try:
            affected = fn()
        except Exception:
            txn.membuf.rollback_stage()
            raise
        txn.membuf.release_stage()
        return Result(affected=affected)

    # -- SELECT ---------------------------------------------------------------
    def _select(self, stmt, cache_key=None) -> Result:
        # value-agnostic prepared lane: only the OUTERMOST select of the
        # EXECUTE interacts with the capture context (subquery/CTE runners
        # re-enter _select with inner statements)
        cap = self._prep_capture
        is_outer = cap is not None and stmt is cap.get("outer_stmt")
        # point-get fast path first (ref: TryFastPlan, point_get_plan.go:957)
        from tidb_tpu_torch.planner.pointget import detect_point_get, run_point_get

        pg = detect_point_get(self.catalog, self.current_db, stmt)
        if pg is not None:
            self.require_priv(pg.db, pg.table.name, "select")
            # a repeated prepared point-get reports as a cache hit like the
            # reference's cached PointGetPlan (no parse, no planner ran)
            self.vars["last_plan_from_cache"] = 1 if (is_outer and cap.get("pg_warm")) else 0
            if is_outer:
                cap["point_get"] = True
            return Result(columns=pg.out_names, rows=run_point_get(self, pg))
        if getattr(stmt, "ctes", None):
            from tidb_tpu_torch.planner.cte import expand_ctes

            # CTE expansion can materialize data (recursive fixpoints) into
            # the AST — such plans must never be cached
            cache_key = None
            is_outer = False
            stmt = expand_ctes(stmt, self._cte_runner)
        if isinstance(stmt, ast.SetOp) and _setop_has_for_update(stmt):
            raise SessionError("FOR UPDATE is not supported inside set operations")
        as_of_ts = self._resolve_as_of(stmt)
        if as_of_ts is not None:
            is_outer = False  # stale reads re-resolve their ts per execution
            if self._txn_dirty():
                raise SessionError("AS OF TIMESTAMP inside a dirty transaction is not allowed")
            if getattr(stmt, "for_update", False):
                raise SessionError("AS OF TIMESTAMP can't be used with FOR UPDATE")
            cache_key = None  # stale plans bake nothing, but reads must re-ts
            self._read_ts_override = as_of_ts
        if getattr(stmt, "for_update", False):
            is_outer = False  # locking reads are txn-state-dependent
            self._lock_select_rows(stmt)
            if self._explicit and self._txn is not None and self._txn.pessimistic:
                # locking read returns latest committed values (current read)
                self._read_ts_override = self._txn.for_update_ts
        import time

        from tidb_tpu_torch.utils.memory import Tracker

        self.mem_tracker = Tracker("query", sysvar_int(self.vars, "tidb_mem_quota_query", 1 << 30))
        met = float(self.vars.get("max_execution_time", 0) or 0)
        for hname, hargs in getattr(stmt, "hints", []) or []:
            if hname == "max_execution_time" and hargs:
                try:
                    met = float(hargs[0])
                except ValueError:
                    pass
        limits = [met / 1000.0] if met > 0 else []
        # runaway KILL rule arms the same statement deadline (ref: runaway
        # checker registering a kill timer)
        g = self._db.resource_groups.get(str(self.vars.get("tidb_resource_group", "default")))
        if g is not None and g.exec_elapsed_s and g.action == "KILL":
            limits.append(g.exec_elapsed_s)
        self._deadline = (time.monotonic() + min(limits)) if limits else None
        # DRYRUN arms an OBSERVATIONAL deadline on the same check_killed()
        # seam: past it the statement is recorded as a runaway (+ WARN
        # event) but keeps running — metering, not enforcement
        self._runaway_obs = None
        if g is not None and g.exec_elapsed_s and g.action == "DRYRUN":
            self._runaway_obs = (time.monotonic() + g.exec_elapsed_s, g.name)
        try:
            with self.span("plan"):
                plan = self._plan_select(stmt, cache_key=cache_key, capture=is_outer)
            from tidb_tpu_torch.executor import build_executor

            from tidb_tpu_torch.parallel.probe import MPPRetryExhausted

            try:
                with self.span("execute"):
                    ex = build_executor(plan, self)
                    chunk = ex.execute()
            except MPPRetryExhausted as mpp_err:
                # MPP gave up (device failures) → re-plan without MPP and run
                # on the surviving engines (ref: mpp retry exhaustion falling
                # back rather than failing the statement)
                lg = _ev.on(_ev.WARN)
                if lg is not None:
                    lg.emit(
                        _ev.WARN,
                        "mpp",
                        "host_join_fallback",
                        trace_id=getattr(self.tracer, "trace_id", None),
                        reason=str(mpp_err),
                    )
                prev = self.vars.get("tidb_allow_mpp", 1)
                self.vars["tidb_allow_mpp"] = 0
                # on the cached-plan prepared lane `stmt` still carries its
                # parameter markers — rebind before re-planning
                replan_stmt = stmt
                if is_outer and cap.get("cached_plan") is not None and cap.get("rebind") is not None:
                    replan_stmt = cap["rebind"]()
                try:
                    with self.span("mpp-fallback"):
                        plan = self._plan_select(replan_stmt, cache_key=None)
                        ex = build_executor(plan, self)
                        chunk = ex.execute()
                finally:
                    self.vars["tidb_allow_mpp"] = prev
        finally:
            self._read_ts_override = None
            self._deadline = None
            self._runaway_obs = None
            if self.mem_tracker is not None:
                # max over every _select of the statement (subqueries/CTEs
                # run their own tracker before the outer one finishes)
                self._last_mem_peak = max(self._last_mem_peak, self.mem_tracker.max_consumed)
            self.mem_tracker = None
        self._last_plan = plan  # outermost select wins (inner selects ran already)
        names = [oc.name for oc in plan.schema]
        return Result(columns=names, rows=chunk.rows(), ftypes=[oc.ftype for oc in plan.schema])

    def _resolve_as_of(self, stmt) -> Optional[int]:
        """Collect AS OF TIMESTAMP from the statement's table refs → TSO ts
        (ref: calculateTsExpr in staleread). All refs must agree."""
        exprs: list = []
        n_refs = [0]

        def walk(node):
            if isinstance(node, ast.TableRef):
                n_refs[0] += 1
                if node.as_of is not None:
                    exprs.append(node.as_of)
            elif isinstance(node, ast.Join):
                walk(node.left)
                walk(node.right)
            elif isinstance(node, ast.SubquerySource):
                walk(node.select)
            elif isinstance(node, ast.SetOp):
                walk(node.left)
                walk(node.right)
            elif isinstance(node, ast.Select):
                if node.from_ is not None:
                    walk(node.from_)

        if isinstance(stmt, ast.SetOp):
            walk(stmt)
        elif getattr(stmt, "from_", None) is not None:
            walk(stmt.from_)
        if not exprs:
            return None
        if len({repr(e) for e in exprs}) > 1 or len(exprs) != n_refs[0]:
            raise SessionError("can not set different time in the as of")
        builder = Builder(self.catalog, self.current_db)
        from tidb_tpu_torch.expression.expr import Constant
        from tidb_tpu_torch.planner.builder import BuildCtx
        from tidb_tpu_torch.types.datum import datetime_to_micros

        e = builder.resolve(exprs[0], BuildCtx([]))
        if not isinstance(e, Constant):
            raise SessionError("AS OF TIMESTAMP must be a constant expression")
        v = e.value
        if isinstance(v, bytes):
            v = v.decode()
        if isinstance(v, (int, float)) and not isinstance(v, bool):
            ms = int(float(v) * 1000)  # unix seconds
        else:
            ms = datetime_to_micros(str(v)) // 1000
        return ms << 18

    def _lock_select_rows(self, stmt: ast.Select) -> None:
        """SELECT ... FOR UPDATE: pessimistically lock the matched rows'
        record keys (ref: SelectLockExec, executor/executor.go). Single-table
        FROM only; other shapes execute without locking (round-1 divergence)."""
        if not (self._explicit and self._txn is not None and self._txn.pessimistic):
            return
        if not isinstance(stmt.from_, ast.TableRef):
            return
        from tidb_tpu_torch.executor.executors import TableReaderExec
        from tidb_tpu_torch.kv import tablecodec
        from tidb_tpu_torch.kv.kv import StoreType
        from tidb_tpu_torch.planner.plans import OutCol, PhysTableReader
        from tidb_tpu_torch.types.field_type import bigint_type

        db_name = stmt.from_.db or self.current_db
        t = self.catalog.table(db_name, stmt.from_.name)
        alias = stmt.from_.alias or stmt.from_.name
        schema = [OutCol(c.name, c.ftype, table=alias, slot=c.offset) for c in t.columns]
        conds = []
        if stmt.where is not None:
            builder = Builder(self.catalog, self.current_db, subquery_runner=self._subquery_runner)
            from tidb_tpu_torch.planner.builder import BuildCtx

            conds = builder._split_conj(builder.resolve(stmt.where, BuildCtx(schema)))
        reader = PhysTableReader(
            db=db_name,
            table=t,
            store_type=StoreType.HOST,
            pushed_conditions=conds,
            scan_slots=[c.offset for c in t.columns] + [-1],
            schema=schema + [OutCol("_handle", bigint_type(nullable=False))],
        )
        chunk = TableReaderExec(reader, self).execute()
        handles = chunk.columns[-1].data
        keys = [tablecodec.record_key(t.id, int(h)) for h in handles]
        self.lock_for_write(keys)

    def _plan_cache_key(self, cache_key):
        return (
            cache_key,
            self.current_db,
            str(self.vars["tidb_isolation_read_engines"]),
            self.catalog.schema_version,
            self._db.stats.version,
            self.vars.get("tidb_allow_mpp"),
            self.vars.get("tidb_enforce_mpp"),
            self.vars.get("tidb_enable_index_merge"),
            self.vars.get("tidb_broadcast_join_threshold_count"),
            self.vars.get("tidb_opt_fused_rollup"),
        )

    def _plan_select(self, stmt, cache_key=None, capture=False):
        from tidb_tpu_torch.utils import metrics as _m

        # value-agnostic prepared lane, hit side: the template's plan was
        # already re-pointed at this execution's parameters (prepcache.rebind)
        cap = self._prep_capture if capture else None
        if cap is not None and cap.get("cached_plan") is not None:
            _m.PLAN_CACHE.inc(result="hit")
            self.vars["last_plan_from_cache"] = 1
            return cap["cached_plan"]
        # session LRU plan cache (ref: core/plan_cache_lru.go); FOR UPDATE
        # and WITH queries never cache (txn-state/plan-time-dependent)
        key = None
        if (
            cache_key is not None
            and not getattr(stmt, "for_update", False)
            and not getattr(stmt, "ctes", None)
        ):
            key = self._plan_cache_key(cache_key)
            hit = self._plan_cache.get(key)
            if hit is not None:
                _m.PLAN_CACHE.inc(result="hit")
                self._plan_cache.move_to_end(key)
                self.vars["last_plan_from_cache"] = 1
                return hit
            _m.PLAN_CACHE.inc(result="miss")
        elif cap is not None:
            _m.PLAN_CACHE.inc(result="miss")
        self.vars["last_plan_from_cache"] = 0

        from tidb_tpu_torch.planner.cte import expand_ctes

        stmt = expand_ctes(stmt, self._cte_runner)
        builder = Builder(
            self.catalog,
            self.current_db,
            subquery_runner=self._subquery_runner,
            user_vars=self.user_vars,
            sys_vars=self.vars,
            global_vars=self._db.global_vars,
            memtable_provider=self._memtable_provider,
            scan_checker=lambda db, tbl: self.require_priv(db, tbl, "select"),
            dyn_sys_vars={
                "warning_count": len(self._prev_warnings),
                "error_count": sum(1 for w in self._prev_warnings if w[0] == "Error"),
                "last_insert_id": self.last_insert_id,
            },
            warn=self.append_warning,
        )
        logical = builder.build_query(stmt)
        engines = [e.strip() for e in str(self.vars["tidb_isolation_read_engines"]).split(",") if e.strip()]
        # READ_FROM_STORAGE hint overrides engine isolation for the statement
        # (ref: isolation-read + read_from_storage hint interplay)
        for hname, hargs in getattr(stmt, "hints", []) or []:
            if hname == "read_from_storage" and hargs:
                hinted = []
                for a in hargs:
                    eng = a.split("[")[0].strip().lower()
                    if eng in ("gpu", "host", "tikv", "tiflash") and eng not in hinted:
                        hinted.append({"tikv": "host", "tiflash": "gpu"}.get(eng, eng))
                if hinted:
                    engines = hinted
        plan = optimize(logical, engines, stats=self._db.stats, vars=self.vars)
        from tidb_tpu_torch.parallel.gather import try_mpp_rewrite

        plan = try_mpp_rewrite(
            plan, self.vars, stats=self._db.stats, store=self.store, health=self._db.health
        )
        if key is not None and not builder.uncacheable:
            self._plan_cache[key] = plan
            cap_n = sysvar_int(self.vars, "tidb_prepared_plan_cache_size", 100)
            while len(self._plan_cache) > cap_n:
                self._plan_cache.popitem(last=False)
        if (
            cap is not None
            and not builder.uncacheable
            and not getattr(stmt, "for_update", False)
        ):
            # value-agnostic prepared lane, miss side: try to template the
            # finished plan for parameter-independent reuse
            from tidb_tpu_torch.planner import prepcache

            tmpl = prepcache.make_template(plan, cap.get("n_params", 0))
            if tmpl is not None:
                cap["template"] = tmpl
        return plan

    def _run_select_ast(self, stmt) -> list[tuple]:
        return self._select(stmt).rows

    def _subquery_runner(self, sel) -> list[tuple]:
        return self._run_select_ast(sel)

    def _memtable_provider(self, name: str, hints=()):
        from tidb_tpu_torch.catalog.infoschema import memtable_rows

        return memtable_rows(self._db, self, name, hints)

    def _cte_runner(self, sel):
        """Plan+run one CTE part; returns (rows, schema) for the fixpoint
        driver (ref: cte.go seed/recursive part execution)."""
        plan = self._plan_select(sel)
        from tidb_tpu_torch.executor import build_executor

        chunk = build_executor(plan, self).execute()
        return chunk.rows(), plan.schema

    # -- misc -----------------------------------------------------------------
    def _set_var(self, stmt: ast.SetVariable) -> Result:
        builder = Builder(self.catalog, self.current_db)
        from tidb_tpu_torch.planner.builder import BuildCtx

        e = builder.resolve(stmt.value, BuildCtx([]))
        from tidb_tpu_torch.expression.expr import Constant

        if not isinstance(e, Constant):
            raise SessionError("SET value must be constant")
        v = e.value
        if isinstance(v, bytes):
            v = v.decode()
        if stmt.name.startswith("@"):
            self.user_vars[stmt.name[1:]] = v
            return Result()
        if stmt.scope == "global":
            self._db.global_vars[stmt.name] = v
        self.vars[stmt.name] = v
        return Result()

    def _checksum(self, stmt) -> Result:
        """CHECKSUM TABLE: a stable CRC over every row's text form (MySQL's
        live checksum analog; ADMIN CHECK TABLE does the integrity pass)."""
        import zlib

        rows = []
        for ref in stmt.tables:
            db = (ref.db or self.current_db).lower()
            try:
                self.catalog.table(db, ref.name)
            except CatalogError:
                rows.append((f"{db}.{ref.name}", None))
                continue
            data = self.query(f"SELECT * FROM `{db}`.`{ref.name}`")
            acc = 0
            for r in data:
                acc = zlib.crc32(repr(r).encode(), acc)
            rows.append((f"{db}.{ref.name}", acc))
        return Result(columns=["Table", "Checksum"], rows=rows)

    @staticmethod
    def _like_filter(rows, pat, key=0):
        """SHOW ... LIKE filtering over rows by rows[i][key]."""
        if not pat:
            return rows
        import re

        from tidb_tpu_torch.expression.eval import like_to_regex

        rx = re.compile(like_to_regex(pat))
        return [r for r in rows if rx.match(r[key])]

    def _show(self, stmt: ast.Show) -> Result:
        if stmt.kind in ("stats_histograms", "stats_topn", "stats_buckets"):
            return self._show_stats(stmt.kind)
        if stmt.kind == "bindings":
            rows = []
            for scope, store in (("session", self.bindings), ("global", self._db.bindings)):
                for d, (for_text, using_text) in store.items():
                    rows.append((for_text, using_text, scope))
            return Result(columns=["Original_sql", "Bind_sql", "Scope"], rows=rows)
        if stmt.kind == "grants":
            if stmt.target:
                user, _, host = stmt.target.partition("@")
            else:
                user, host = self.user, self.host
            rows = [(g,) for g in self._db.priv_checker.grants_for(user, host)]
            return Result(columns=[f"Grants for {user}@{host}"], rows=rows)
        if stmt.kind == "processlist":
            server = getattr(self._db, "server", None)
            rows = server.processlist() if server is not None else []
            return Result(columns=["Id", "User", "db", "Command", "Info"], rows=rows)
        if stmt.kind == "tables":
            names = sorted(set(self.catalog.tables(self.current_db)) | set(self.catalog.views(self.current_db)))
            rows = [(t,) for t in names]
            rows = self._like_filter(rows, stmt.like)
            return Result(columns=[f"Tables_in_{self.current_db}"], rows=rows)
        if stmt.kind == "databases":
            return Result(columns=["Database"], rows=[(d,) for d in self.catalog.databases()])
        if stmt.kind == "variables":
            rows = sorted((k, str(v)) for k, v in self.vars.items())
            rows = self._like_filter(rows, stmt.like)
            return Result(columns=["Variable_name", "Value"], rows=rows)
        if stmt.kind == "columns":
            tdb, _, tname = stmt.target.rpartition(".")
            t = self.catalog.table(tdb or self.current_db, tname)
            rows = [
                (c.name, str(c.ftype), "YES" if c.ftype.nullable else "NO", str(c.default or ""))
                for c in t.columns
            ]
            return Result(columns=["Field", "Type", "Null", "Default"], rows=rows)
        if stmt.kind == "create_table":
            from tidb_tpu_torch.tools.dumpling import _create_table_sql

            dbn, _, tn = stmt.target.rpartition(".")
            dbn = dbn or self.current_db
            view = self.catalog.view(dbn, tn)
            if view is not None:
                # SHOW CREATE TABLE on a view → View/Create View row
                # (ref: executor/show.go fetchShowCreateTable4View)
                cols = f" ({', '.join(f'`{c}`' for c in view.columns)})" if view.columns else ""
                create = f"CREATE VIEW `{view.name}`{cols} AS {view.text}"
                return Result(
                    columns=["View", "Create View", "character_set_client", "collation_connection"],
                    rows=[(view.name, create, "utf8mb4", "utf8mb4_bin")],
                )
            t = self.catalog.table(dbn, tn)
            return Result(
                columns=["Table", "Create Table"],
                rows=[(t.name, _create_table_sql(t, dbn).rstrip().rstrip(";"))],
            )
        if stmt.kind == "table_status":
            import datetime

            rows = []
            for name in sorted(self.catalog.tables(self.current_db)):
                t = self.catalog.table(self.current_db, name)
                st = self._db.stats.get(t.id)
                nrows = st.row_count if st is not None else 0
                rows.append((name, "tidb-tpu", 10, "Fixed", nrows, 0, 0, None,
                             "utf8mb4_bin", ""))
            rows = self._like_filter(rows, stmt.like)
            return Result(
                columns=["Name", "Engine", "Version", "Row_format", "Rows",
                         "Avg_row_length", "Data_length", "Auto_increment",
                         "Collation", "Comment"],
                rows=rows,
            )
        if stmt.kind == "create_database":
            self.catalog.db(stmt.target)  # raises if unknown
            return Result(
                columns=["Database", "Create Database"],
                rows=[(stmt.target, f"CREATE DATABASE `{stmt.target}` /*!40100 DEFAULT CHARACTER SET utf8mb4 */")],
            )
        if stmt.kind == "collation":
            from tidb_tpu_torch.catalog.infoschema import COLLATIONS

            rows = list(COLLATIONS)
            rows = self._like_filter(rows, stmt.like)
            return Result(
                columns=["Collation", "Charset", "Id", "Default", "Compiled", "Sortlen"],
                rows=rows,
            )
        if stmt.kind == "charset":
            from tidb_tpu_torch.catalog.infoschema import CHARSETS

            rows = list(CHARSETS)
            rows = self._like_filter(rows, stmt.like)
            return Result(
                columns=["Charset", "Description", "Default collation", "Maxlen"], rows=rows
            )
        if stmt.kind == "engines":
            return Result(
                columns=["Engine", "Support", "Comment", "Transactions", "XA", "Savepoints"],
                rows=[("tidb-tpu", "DEFAULT", "TPU-native columnar engine + host reference engine", "YES", "NO", "NO")],
            )
        if stmt.kind == "triggers":
            return Result(columns=["Trigger", "Event", "Table", "Statement", "Timing"], rows=[])
        if stmt.kind == "status":
            from tidb_tpu_torch.utils.metrics import STMT_TOTAL

            total = sum(STMT_TOTAL._vals.values())
            rows = [
                ("Queries", str(self._stmt_count)),
                ("Questions", str(int(total))),
                ("Threads_connected", "1"),
                ("Uptime", "0"),
            ]
            rows = self._like_filter(rows, stmt.like)
            return Result(columns=["Variable_name", "Value"], rows=rows)
        if stmt.kind in ("warnings", "errors"):
            src = self.warnings if stmt.kind == "warnings" else [
                w for w in self.warnings if w[0] == "Error"
            ]
            return Result(columns=["Level", "Code", "Message"], rows=list(src))
        if stmt.kind in ("warning_count", "error_count"):
            src = self.warnings if stmt.kind == "warning_count" else [
                w for w in self.warnings if w[0] == "Error"
            ]
            col = "@@session.warning_count" if stmt.kind == "warning_count" else "@@session.error_count"
            return Result(columns=[col], rows=[(len(src),)])
        if stmt.kind == "index":
            t = self.catalog.table(self.current_db, stmt.target)
            rows = []
            if t.pk_is_handle:
                rows.append((t.name, 0, "PRIMARY", 1, t.columns[t.pk_offset].name, "BTREE"))
            for idx in t.indexes:
                if idx.state != "public":
                    continue
                for seq, off in enumerate(idx.column_offsets):
                    rows.append((t.name, 0 if idx.unique else 1, idx.name, seq + 1, t.columns[off].name, "BTREE"))
            return Result(
                columns=["Table", "Non_unique", "Key_name", "Seq_in_index", "Column_name", "Index_type"],
                rows=rows,
            )
        raise SessionError(f"unsupported SHOW {stmt.kind}")

    def _show_stats(self, kind: str) -> Result:
        """SHOW STATS_HISTOGRAMS / STATS_TOPN / STATS_BUCKETS (ref: the
        mysql.stats_* inspection statements)."""
        rows: list[tuple] = []
        for tname in self.catalog.tables(self.current_db):
            t = self.catalog.table(self.current_db, tname)
            st = self._db.stats.get(t.id)
            if st is None:
                continue
            for c in t.columns:
                cs = st.cols.get(c.offset)
                if cs is None:
                    continue
                if kind == "stats_histograms":
                    rows.append((tname, c.name, st.row_count, cs.ndv, cs.null_count, cs.hist.num_buckets))
                elif kind == "stats_topn":
                    for v, cnt in zip(cs.topn.values, cs.topn.counts):
                        if cs.is_string and cs.dictionary is not None:
                            v = cs.dictionary.decode(int(v)).decode("utf-8", "replace")
                        rows.append((tname, c.name, v, int(cnt)))
                else:
                    for b in range(cs.hist.num_buckets):
                        lo, hi = cs.hist.lowers[b], cs.hist.uppers[b]
                        if cs.is_string and cs.dictionary is not None:
                            lo = cs.dictionary.decode(int(lo)).decode("utf-8", "replace")
                            hi = cs.dictionary.decode(int(hi)).decode("utf-8", "replace")
                        rows.append((tname, c.name, b, int(cs.hist.cum_counts[b]), int(cs.hist.repeats[b]), lo, hi))
        cols = {
            "stats_histograms": ["Table", "Column", "Row_count", "Distinct_count", "Null_count", "Buckets"],
            "stats_topn": ["Table", "Column", "Value", "Count"],
            "stats_buckets": ["Table", "Column", "Bucket", "Cum_count", "Repeats", "Lower", "Upper"],
        }[kind]
        return Result(columns=cols, rows=rows)

    def _explain(self, stmt: ast.Explain) -> Result:
        inner = stmt.stmt
        if not isinstance(inner, (ast.Select, ast.SetOp)):
            raise SessionError("EXPLAIN supports SELECT only")
        from tidb_tpu_torch.planner.pointget import detect_point_get

        pg = detect_point_get(self.catalog, self.current_db, inner)
        if pg is not None and not stmt.analyze:
            if len(pg.handles) > 1:
                line = f"Batch_Point_Get  table:{pg.table.name}, handles:{pg.handles}"
            else:
                line = f"Point_Get  table:{pg.table.name}, handle:{pg.handle}"
            return Result(columns=["plan"], rows=[(line,)])
        plan = self._plan_select(inner)
        self._last_plan = plan  # EXPLAIN [ANALYZE] records a plan digest too
        if stmt.analyze:
            from tidb_tpu_torch.executor import build_executor
            from tidb_tpu_torch.utils.execdetails import RuntimeStatsColl

            self.runtime_stats = RuntimeStatsColl()
            try:
                build_executor(plan, self).execute()
            finally:
                coll, self.runtime_stats = self.runtime_stats, None
            text = explain_plan(plan, stats=coll)
            from tidb_tpu_torch.resourcegroup import groups as _rg

            if _rg.METERING_ENABLED:
                # the RU the run just metered, as a trailing plan row (the
                # wall/cpu terms belong to execute(); this shows the
                # statement-shape charge: scans, cop RPCs, exchanges)
                text += f"\nru: {self._assemble_usage(0.0, 0.0, 0).ru:.2f}"
        else:
            text = explain_plan(plan)
        return Result(columns=["plan"], rows=[(line,) for line in text.split("\n")])

    def _load_data(self, stmt: "ast.LoadData") -> Result:
        """LOAD DATA INFILE: CSV file → the bulk import path (ref:
        pkg/executor/load_data.go; shares the IMPORT INTO conversion +
        columnar/txn ingest). LOCAL reads the file from this process —
        the wire server runs in-process with the session, so client-side
        and server-side paths coincide here."""
        import csv as _csv

        from tidb_tpu_torch.tools.importer import import_rows_slice

        db_name = stmt.table.db or self.current_db
        self.require_priv(db_name, stmt.table.name, "insert")
        if stmt.dup_mode == "replace":
            raise SessionError("LOAD DATA ... REPLACE is not supported yet")
        t = self.catalog.table(db_name, stmt.table.name)
        kw = {"delimiter": stmt.fields_terminated or "\t"}
        if stmt.fields_enclosed:
            kw["quotechar"] = stmt.fields_enclosed
        else:
            # MySQL's default is NO enclosure: quotes are data, not wrappers
            kw["quoting"] = _csv.QUOTE_NONE
        with open(stmt.path, newline="") as f:
            # IGNORE n LINES counts PHYSICAL lines (blank ones included)
            all_lines = list(_csv.reader(f, **kw))
        raw = [r for r in all_lines[stmt.ignore_lines :] if r]
        if stmt.columns:
            # explicit column list: reorder/pad to the full table width
            pos = {c.name.lower(): i for i, c in enumerate(t.columns)}
            for cname in stmt.columns:
                if cname not in pos:
                    raise SessionError(f"Unknown column '{cname}' in field list")
            width = len(t.columns)
            mapped = []
            for r in raw:
                if len(r) < len(stmt.columns):
                    raise SessionError("Row does not contain data for all fields")
                full = ["\\N"] * width
                for cname, v in zip(stmt.columns, r):
                    full[pos[cname]] = v
                mapped.append(full)
            raw = mapped
        on_existing = "skip" if stmt.dup_mode == "ignore" else None
        n = (
            import_rows_slice(self._db, db_name, stmt.table.name, raw, on_existing=on_existing)
            if raw
            else 0
        )
        self.note_table_mods(t.id, n)
        res = Result(affected=n)
        return res

    def _analyze(self, stmt: ast.AnalyzeTable) -> Result:
        """ANALYZE TABLE: build histograms/TopN/CM-FM sketches per column and
        NDV per index; results land in the DB's stats cache and drive the
        cost-based access-path choice (ref: ANALYZE executors +
        statistics/handle)."""
        from tidb_tpu_torch.statistics import analyze_table

        for tr in stmt.tables:
            db_name = tr.db or self.current_db
            t = self.catalog.table(db_name, tr.name)
            if getattr(tr, "partitions", None):
                # partition-level analyze: per-partition stats land under the
                # partition's physical id, then every analyzed partition's
                # stats merge into table-level GLOBAL stats (ref:
                # statistics/handle/globalstats/global_stats.go)
                from tidb_tpu_torch.statistics.globalstats import merge_global_stats

                if t.partition is None:
                    raise SessionError(f"table '{t.name}' is not partitioned")
                by_name = {d.name.lower(): d for d in t.partition.defs}
                for pn in tr.partitions:
                    d = by_name.get(pn)
                    if d is None:
                        raise SessionError(f"Unknown partition '{pn}' in table '{t.name}'")
                    view = t.partition_view(d.id)
                    self._db.stats.put(analyze_table(self, db_name, view))
                part_stats = [
                    ps
                    for d in t.partition.defs
                    # sync load: persisted per-partition stats from a prior
                    # process must count toward merge completeness (ANALYZE
                    # is a cold path; blocking here is fine)
                    if (ps := self._db.stats.get(d.id) or self._db.stats.load_sync(d.id)) is not None
                ]
                if len(part_stats) == len(t.partition.defs):
                    # all partitions analyzed → refresh table-level globals
                    self._db.stats.put(
                        merge_global_stats(t.id, self.read_ts(), part_stats)
                    )
                continue
            self._db.stats.put(analyze_table(self, db_name, t))
        return Result()

    def note_table_mods(self, table_id: int, n: int) -> None:
        if n:
            self._pending_mods[table_id] = self._pending_mods.get(table_id, 0) + n

    def _note_bindings_changed(self, is_global: bool) -> None:
        """Binding create/drop invalidates the statement fast lane (cached
        ASTs bake the binding substitution that matched at cache time)."""
        if is_global:
            self._db.bindings_ver += 1
        else:
            self.bindings_ver += 1


class StoreHealthRegistry:
    """Last-seen per-store health/load reports with staleness timestamps —
    the SQL layer's cache over the fleet's ``sys_snapshot`` introspection
    verb, and the load-signal substrate the placement balancer and overload
    controller (ROADMAP items 3/4) will consume. A sweep fans out with
    dead-store tolerance (per-store outcomes); a store that fails keeps its
    LAST good report but its staleness clock stops advancing, so consumers
    can distinguish "fresh", "stale", and "never seen"."""

    def __init__(self, db: "DB"):
        self._db = db
        self._mu = threading.Lock()
        # instance → {"report", "ts" (last OK), "checked" (last attempt),
        #             "ok", "error", "shard"}
        self._reports: dict[str, dict] = {}
        # local recent-QPS estimator state (EWMA over STMT_TOTAL deltas)
        self._qps_t: float = time.monotonic()
        self._qps_total: "float | None" = None
        self._qps: float = 0.0

    def _outcomes(self, hist=None, sections=None) -> list[dict]:
        store = self._db.store
        all_fn = getattr(store, "sys_snapshot_all", None)
        if all_fn is not None:
            return all_fn(hist=hist, sections=sections)
        from tidb_tpu_torch.kv.remote import sys_report
        from tidb_tpu_torch.kv.sharded import ShardedStore

        addr = ShardedStore.instance_name(store)
        fn = getattr(store, "sys_snapshot", None)
        try:
            rep = (
                fn(hist=hist, sections=sections)
                if fn is not None
                else sys_report(store=store, hist=hist, sections=sections)
            )
            return [{"instance": addr, "shard": 0, "ok": True, "report": rep}]
        except (ConnectionError, OSError) as e:
            return [{"instance": addr, "shard": 0, "ok": False, "error": str(e)}]

    def sweep(self, hist=None, sections=None) -> list[dict]:
        """One full-fleet introspection sweep: fan out, cache, return the
        per-store outcomes (never raises for a dead store — its outcome says
        so). ``sections`` limits the heavy report parts a consumer actually
        reads (see ``sys_report``). Benchdaily's ``cluster_snapshot_ms``
        lane guards this wall."""
        from tidb_tpu_torch.utils import metrics as _m

        t0 = time.perf_counter()
        outs = self._outcomes(hist=hist, sections=sections)
        _m.CLUSTER_SNAPSHOT_SECONDS.observe(time.perf_counter() - t0)
        now = time.time()
        with self._mu:
            for o in outs:
                if o["ok"]:
                    self._reports[o["instance"]] = {
                        "report": o["report"], "ts": now, "checked": now,
                        "ok": True, "error": "", "shard": o["shard"],
                    }
                else:
                    prev = self._reports.get(o["instance"])
                    ent = dict(prev) if prev else {"report": None, "ts": 0.0, "shard": o["shard"]}
                    ent.update(ok=False, error=o["error"], checked=now)
                    self._reports[o["instance"]] = ent
        return outs

    def reports(self) -> dict[str, dict]:
        """Cached last-seen state per instance (shallow copies)."""
        with self._mu:
            return {k: dict(v) for k, v in self._reports.items()}

    def staleness_s(self, instance: str) -> "float | None":
        """Seconds since the last GOOD report from ``instance`` (None =
        never seen one)."""
        with self._mu:
            ent = self._reports.get(instance)
        if ent is None or not ent["ts"]:
            return None
        return time.time() - ent["ts"]

    def is_stale(self, instance: str, max_age_s: float = 60.0) -> bool:
        """True when ``instance`` has no fresh report: its last sweep failed
        or its newest good report is older than ``max_age_s``."""
        with self._mu:
            ent = self._reports.get(instance)
        if ent is None:
            return True
        if not ent["ok"]:
            return True
        return (time.time() - ent["ts"]) > max_age_s

    def recent_qps(self) -> float:
        """This instance's recent statement rate: an EWMA (~5s horizon) over
        STMT_TOTAL deltas, recomputed at most every 250ms — cheap enough for
        the trace-sampling clamp to read per sampled-statement attempt."""
        from tidb_tpu_torch.utils import metrics as _m

        now = time.monotonic()
        with self._mu:
            total = _m.STMT_TOTAL.total()
            if self._qps_total is None:
                self._qps_t, self._qps_total = now, total
                return self._qps
            dt = now - self._qps_t
            if dt < 0.25:
                return self._qps
            inst = max(total - self._qps_total, 0.0) / dt
            alpha = min(dt / 5.0, 1.0)
            self._qps += alpha * (inst - self._qps)
            self._qps_t, self._qps_total = now, total
            return self._qps


class DB:
    """Embedded database handle (testkit.CreateMockStore analog). With
    ``store`` given (e.g. a kv.remote.RemoteStore), this process is a pure
    SQL layer: catalog, planner, and executors run here; every byte of data
    lives behind the store's wire (the TiDB-process-over-TiKV shape)."""

    def __init__(self, region_split_keys: int = 500_000, store=None):
        self.store = store if store is not None else MemStore(region_split_keys=region_split_keys)
        self.catalog = Catalog(self.store)
        self.global_vars: dict[str, Any] = {}
        self._mu = threading.Lock()
        # this SQL node's cluster identity (owner campaigns, schema lease)
        import uuid as _uuid

        self.node_id = _uuid.uuid4().hex[:12]
        # schema-validator lease (ref: domain/schema_validator.go): a SQL
        # node re-checks the persisted catalog version at most this often;
        # past the lease with an UNREACHABLE store it refuses reads rather
        # than serve a stale catalog
        self.schema_lease_s = 1.5
        self._schema_checked = time.monotonic()
        # owner-election lease ([cluster] owner-lease-s): how long this node
        # may act as a background singleton between keepalive refreshes
        from tidb_tpu_torch import config as _config

        self.owner_lease_s = _config.current().owner_lease_s
        # per-key fence events: set when a running sweep's ownership was lost
        # (deposed or lease expired unrefreshed) — see _owner_gated
        self._owner_fences: dict[str, threading.Event] = {}
        from tidb_tpu_torch.kv.gcworker import GCWorker
        from tidb_tpu_torch.statistics import StatsHandle

        self.gc_worker = GCWorker(self.store)
        self.stats = StatsHandle()
        # persisted ANALYZE results load lazily from the store (syncload);
        # string stats re-attach their sorted dictionaries from the cache
        def _dict_resolver(tid, off):
            from tidb_tpu_torch.copr.colcache import cache_for

            return cache_for(self.store).dictionary(tid, off)

        self.stats.attach_store(self.store, _dict_resolver)
        from tidb_tpu_torch.resourcegroup import ResourceGroupManager
        from tidb_tpu_torch.utils.stmtsummary import StmtSummary

        from tidb_tpu_torch.extension import ExtensionRegistry

        self.stmt_summary = StmtSummary()
        self.resource_groups = ResourceGroupManager()
        self.extensions = ExtensionRegistry()
        # always-on sampled tracing: the bounded trace store ([observability]
        # trace-reservoir-size; tail-keep pins slow-statement traces), plus
        # the config-file default for the sampling-rate sysvar
        from tidb_tpu_torch.utils.tracing import TraceReservoir

        _res_cap = _config.current().trace_reservoir_size
        self.trace_reservoir = TraceReservoir(_res_cap, max(_res_cap // 2, 1))
        if _config.current().trace_sample_rate:
            self.global_vars.setdefault(
                "tidb_tpu_trace_sample_rate", _config.current().trace_sample_rate
            )
        # instance-level (cross-session) serving caches (ref:
        # tidb_enable_instance_plan_cache): statement-text → AST and the
        # value-agnostic prepared-plan templates, shared by every session of
        # this DB. Lock-striped LRUs; entries carry validity epochs in their
        # keys (templates) or entry epoch (ASTs), so invalidation is
        # miss-and-rebuild, never a global flush.
        from tidb_tpu_torch.planner.instcache import InstancePlanCache

        _icap = _config.current().instance_plan_cache_size
        self.inst_stmt_cache = InstancePlanCache(_icap)
        self.inst_plan_cache = InstancePlanCache(_icap)
        # global SQL plan bindings: digest → (for_text, using_text)
        # (ref: pkg/bindinfo binding_handle)
        self.bindings: dict[str, tuple[str, str]] = {}
        # bumped on global CREATE/DROP BINDING — every session's statement
        # fast lane re-checks bindings past this version
        self.bindings_ver = 0
        # privilege state: grant tables bootstrap lazily (first auth/grant);
        # the cache keys on priv_version (ref: privilege reload notification)
        self.priv_version = 0
        self._priv_checker = None
        # fleet health/load registry: cached sys_snapshot reports per store
        # with staleness (the cluster_* memtable substrate; ROADMAP 3/4's
        # load signals read from here)
        self.health = StoreHealthRegistry(self)
        self._rec_started = False

    def ensure_priv_bootstrap(self) -> None:
        from tidb_tpu_torch.privilege import bootstrap_priv_tables

        # one bootstrap at a time: a concurrent first login would otherwise
        # see mysql.user created before its root row and deny root
        with _PRIV_BOOTSTRAP_MU:
            bootstrap_priv_tables(self)

    @property
    def priv_checker(self):
        if self._priv_checker is None:
            from tidb_tpu_torch.privilege import PrivChecker

            self.ensure_priv_bootstrap()
            self._priv_checker = PrivChecker(self)
        return self._priv_checker

    def run_auto_analyze(self) -> list[str]:
        """One auto-analyze sweep (ref: autoanalyze.go:296 — tables whose
        modify ratio crossed tidb_auto_analyze_ratio get re-analyzed).
        Returns the names of analyzed tables."""
        from tidb_tpu_torch.statistics import analyze_table

        s = self.session()
        analyzed: list[str] = []
        try:
            self.stats.auto_analyze_ratio = float(
                self.global_vars.get("tidb_auto_analyze_ratio", DEFAULT_SYSVARS["tidb_auto_analyze_ratio"])
            )
        except (TypeError, ValueError):
            pass
        stale = set(self.stats.stale_tables())
        for db_name in self.catalog.databases():
            for tname in self.catalog.tables(db_name):
                t = self.catalog.table(db_name, tname)
                if t.id in stale:
                    self.stats.put(analyze_table(s, db_name, t))
                    analyzed.append(f"{db_name}.{tname}")
        return analyzed

    def run_ttl(self) -> dict:
        """One TTL sweep (ref: ttlworker jobs)."""
        from tidb_tpu_torch.ttl import run_ttl_once

        return run_ttl_once(self)

    def ensure_schema_lease(self) -> None:
        """Schema-validator lease check, run per statement: within the lease
        the cached catalog serves reads; past it, the persisted version is
        re-checked (cross-node DDL becomes visible here, bounded by the
        lease) and an UNREACHABLE store makes this node refuse the read
        instead of answering from a stale catalog (ref:
        domain/schema_validator.go ErrInfoSchemaExpired)."""
        now = time.monotonic()
        if now - self._schema_checked <= self.schema_lease_s:
            return
        try:
            ver = self.catalog.persisted_version()
        except ConnectionError as e:
            raise SessionError(
                f"schema validator lease expired and the store is unreachable ({e}); refusing stale reads"
            )
        if ver != self.catalog.schema_version:
            self.catalog.reload()
        self._schema_checked = time.monotonic()

    def owner_fenced(self, key: str) -> bool:
        """True when the LAST owner-gated sweep of ``key`` on this node lost
        its lease mid-flight (observability for tests and operators)."""
        ev = self._owner_fences.get(key)
        return ev.is_set() if ev is not None else False

    def _owner_gated(self, key: str, fn):
        """Run ``fn`` only while this node holds the cluster-singleton lease
        for ``key`` — with a store-backed election, N SQL nodes sharing one
        store run each background owner exactly once (ref: owner.Manager
        campaigns guarding the domain workers). A keepalive refreshes the
        lease at ``lease/3`` while ``fn`` runs, so a sweep longer than the
        lease cannot lose the singleton mid-flight (the etcd
        session-keepalive role).

        The keepalive carries the FENCING TOKEN (term) granted with the
        lease: a renewal rejected because the term moved means another node
        was elected — this node self-fences observably (the sweep's result
        is wrapped in ``{"fenced": ...}`` and :meth:`owner_fenced` trips).
        Fencing is COOPERATIVE, not preemptive: the wrapper never interrupts
        a running ``fn``, so a sweep long enough to outlive a lost lease
        should poll :meth:`owner_fenced` between batches and stop writing —
        detection plus the wrapped result is what this layer guarantees. An
        UNREACHABLE election keyspace keeps the last verdict until the lease
        runs out, then fences too."""
        campaign = getattr(self.store, "owner_campaign", None)
        if campaign is None:
            return fn()
        lease_s = self.owner_lease_s
        try:
            if not campaign(key, self.node_id, lease_s):
                return {"skipped": "not owner"}
        except ConnectionError as e:
            return {"skipped": f"election keyspace unreachable: {e}"}
        granted = time.monotonic()
        # the fencing token of the grant above: the quorum backend caches it
        # locally (owner_granted_term), sparing a second majority sweep;
        # owner_term (a fleet read) is the fallback for remote stores
        term = None
        granted_term = getattr(self.store, "owner_granted_term", None)
        if granted_term is not None:
            term = granted_term(key, self.node_id)
        if term is None:
            term_of = getattr(self.store, "owner_term", None)
            try:
                term = term_of(key) if term_of is not None else None
            except ConnectionError:
                term = None
        done = threading.Event()
        fenced = threading.Event()
        self._owner_fences[key] = fenced

        def keepalive():
            deadline = granted + lease_s
            while not done.wait(lease_s / 3.0):
                asked = time.monotonic()
                try:
                    if term is not None:
                        ok = campaign(key, self.node_id, lease_s, term=term)
                    else:
                        ok = campaign(key, self.node_id, lease_s)
                except ConnectionError:
                    # quorum unreachable: the lease keeps its last verdict —
                    # but only until it expires unrefreshed
                    if time.monotonic() > deadline:
                        fenced.set()
                        lg = _ev.on(_ev.ERROR)
                        if lg is not None:
                            lg.emit(
                                _ev.ERROR,
                                "owner",
                                "self_fence",
                                key=key,
                                node=self.node_id,
                                reason="lease expired, election keyspace unreachable",
                            )
                        return
                    continue
                if ok:
                    deadline = asked + lease_s
                else:
                    # the term moved on (another node won) — self-fence NOW
                    fenced.set()
                    lg = _ev.on(_ev.WARN)
                    if lg is not None:
                        lg.emit(
                            _ev.WARN,
                            "owner",
                            "deposed",
                            key=key,
                            node=self.node_id,
                            term=term,
                        )
                    return

        ka = threading.Thread(target=keepalive, daemon=True, name=f"owner-ka-{key}")
        ka.start()
        try:
            out = fn()
        finally:
            done.set()
            ka.join(timeout=5)
        if fenced.is_set():
            return {"fenced": f"lost ownership of {key!r} (term {term}) mid-sweep", "result": out}
        return out

    def start_background(self, ttl_interval_s: float = 60, analyze_interval_s: float = 60, gc_interval_s: float = 120, colmerge_interval_s: float = 30, balancer_interval_s: Optional[float] = None) -> None:
        """Start the Domain-style background loops (ref: domain.Start —
        TTL, auto-analyze, GC workers on the timer framework). Each sweep
        first campaigns for its owner key, so only one SQL node per cluster
        actually runs it. The placement balancer rides the same framework
        (``[cluster] balancer-interval-s``; one mover per cluster by the
        owner gate, at most one region move per tick)."""
        from tidb_tpu_torch import config as _config
        from tidb_tpu_torch.utils.timer import TimerRuntime

        if getattr(self, "timers", None) is None:
            self.timers = TimerRuntime()
        self.timers.register("ttl", ttl_interval_s, lambda: self._owner_gated("ttl", self.run_ttl))
        self.timers.register(
            "auto_analyze", analyze_interval_s, lambda: self._owner_gated("stats", self.run_auto_analyze)
        )
        self.timers.register("gc", gc_interval_s, lambda: self._owner_gated("gc", self.run_gc))
        self.timers.register(
            "colmerge", colmerge_interval_s, lambda: self._owner_gated("colmerge", self.run_delta_merge)
        )
        if balancer_interval_s is None:
            balancer_interval_s = _config.current().balancer_interval_s
        if balancer_interval_s > 0 and hasattr(self.store, "placement_cache"):
            self.timers.register(
                "balancer", balancer_interval_s,
                lambda: self._owner_gated("balancer", self.run_balancer),
            )
        self.timers.start()
        # the in-process metrics history recorder rides the background
        # lifecycle (refcounted process singleton; thread "metrics-history"
        # dies with stop_background — the thread-hygiene guard covers it)
        if not self._rec_started:
            from tidb_tpu_torch.utils.metricshist import recorder

            recorder().start()
            self._rec_started = True

    def run_delta_merge(self) -> int:
        """One compactor sweep of the delta+merge device column cache: fold
        every delta overlay past its merge threshold into its base entry
        (TiFlash's background delta-tree merge). Owner-gated like the other
        sweeps; cooperative with fencing — the region loop stops as soon as
        :meth:`owner_fenced` trips. Embedded stores only: a remote store's
        server process runs its own merges on the query-path threshold."""
        if not isinstance(self.store, MemStore):
            return 0
        from tidb_tpu_torch.copr.colcache import cache_for

        return cache_for(self.store).merge_pending(
            should_stop=lambda: self.owner_fenced("colmerge")
        )

    def run_balancer(self) -> dict:
        """One placement-balancer pass (kv/placement.py balancer_sweep):
        move the heaviest movable table off the most loaded shard when the
        fleet's load skew crosses ``[cluster] balancer-skew-ratio``. Owner-
        gated like the other sweeps, so N SQL nodes run exactly one mover;
        a non-sharded store is a cheap no-op."""
        from tidb_tpu_torch.kv.placement import balancer_sweep

        return balancer_sweep(self)

    def stop_background(self) -> None:
        if getattr(self, "timers", None) is not None:
            self.timers.stop()
        if self._rec_started:
            from tidb_tpu_torch.utils.metricshist import recorder

            recorder().stop()
            self._rec_started = False

    def run_gc(self, safe_point: Optional[int] = None) -> int:
        """One synchronous MVCC GC cycle (tests / admin). Honors the
        tidb_gc_life_time global (seconds)."""
        life_s = float(self.global_vars.get("tidb_gc_life_time", DEFAULT_SYSVARS["tidb_gc_life_time"]))
        if hasattr(self.store, "run_gc"):  # remote-backed: GC where the data lives
            pruned, sp = self.store.run_gc(safe_point, life_ms=int(life_s * 1000))
            # dropped-table snapshots past the safe point are gone server-side
            self.catalog.purge_recycle_bin(sp)
            return pruned
        self.gc_worker.life_ms = int(life_s * 1000)
        pruned = self.gc_worker.run_once(safe_point)
        # dropped-table snapshots become unrecoverable past the safe point
        self.catalog.purge_recycle_bin(self.gc_worker.safe_point)
        return pruned

    def session(self) -> Session:
        s = Session(self)
        s.vars.update(self.global_vars)
        return s

    # convenience single-session surface
    _default: Optional[Session] = None

    def _ses(self) -> Session:
        if self._default is None:
            self._default = self.session()
        return self._default

    def execute(self, sql: str) -> Result:
        return self._ses().execute(sql)

    def query(self, sql: str) -> list[tuple]:
        return self._ses().query(sql)


def open_db(region_split_keys: int = 500_000, remote: "str | None" = None, device="cuda") -> DB:
    """``remote="host:port"`` attaches this process as a SQL layer to a
    running kv.remote.StoreServer instead of embedding a MemStore. A comma-
    separated list ("h1:p1,h2:p2") shards the keyspace across N store
    servers (table-granular placement, kv/sharded.py).

    ``device`` is where the ``gpu`` engine runs its cop tasks ("cuda",
    "cuda:N" or "cpu"). The store carries it; the engine resolves it on
    the first device task, so with no card a default handle raises there
    and never runs on the CPU. Over a remote store the store process owns
    its card and runs the cop tasks and MPP fragments; ``device`` is then
    where this process runs its own device work (the root window, a
    fleet's hybrid gather)."""
    if remote is not None:
        from tidb_tpu_torch.kv.remote import RemoteStore

        endpoints = [e.strip() for e in remote.split(",") if e.strip()]
        stores = []
        for ep in endpoints:
            host, _, port = ep.rpartition(":")
            stores.append(RemoteStore(host or "127.0.0.1", int(port)))
        if len(stores) == 1:
            db = DB(store=stores[0])
        else:
            from tidb_tpu_torch.kv.sharded import ShardedStore

            db = DB(store=ShardedStore(stores))
        db.store.device = device
        return db
    db = DB(region_split_keys=region_split_keys)
    db.store.device = device
    return db
