"""Statement summary + slow query log (ref: util/stmtsummary — per-digest
aggregates surfaced via information_schema.statements_summary; and the slow
query log surfaced via information_schema.slow_query)."""

from __future__ import annotations

import threading
import time
from collections import OrderedDict, deque
from dataclasses import asdict, dataclass, field, fields


# digest memo: normalizing re-tokenizes the whole statement (a full lexer
# pass — as costly as a parse), and the hot path needs it per statement for
# stmt-summary/bindings/Top-SQL; warm statements take a dict hit instead
_DIGEST_MEMO: "OrderedDict[str, str]" = OrderedDict()
_DIGEST_MEMO_CAP = 512
_DIGEST_MU = threading.Lock()


def digest(sql: str) -> str:
    """Normalized SQL digest: literals → '?', whitespace folded, lowercased
    keywords (ref: parser/digester.go). Memoized per statement text."""
    with _DIGEST_MU:
        hit = _DIGEST_MEMO.get(sql)
        if hit is not None:
            _DIGEST_MEMO.move_to_end(sql)
            return hit
    d = _digest_uncached(sql)
    with _DIGEST_MU:
        _DIGEST_MEMO[sql] = d
        while len(_DIGEST_MEMO) > _DIGEST_MEMO_CAP:
            _DIGEST_MEMO.popitem(last=False)
    return d


def _digest_uncached(sql: str) -> str:
    import hashlib

    from tidb_tpu_torch.parser.lexer import tokenize

    try:
        toks = tokenize(sql)
    except Exception:
        return hashlib.sha256(sql.encode()).hexdigest()[:16] + "|" + sql[:64]
    parts = []
    for t in toks:
        if t.kind in ("int", "float", "str"):
            parts.append("?")
        elif t.kind == "eof":
            break
        elif t.kind == "ident":
            parts.append(t.value.lower())
        else:
            parts.append(str(t.value))
    norm = " ".join(parts)
    return hashlib.sha256(norm.encode()).hexdigest()[:16] + "|" + norm[:256]


@dataclass
class StmtStats:
    digest: str
    sample: str
    exec_count: int = 0
    sum_latency: float = 0.0
    max_latency: float = 0.0
    sum_rows: int = 0
    last_seen: float = field(default_factory=time.time)
    # distributed exec-details (ref: statements_summary SUM_BACKOFF_TIME /
    # SUM_COP_TASK_NUM columns), fed from the wire-shipped sidecars
    plan_digest: str = ""
    sum_backoff: float = 0.0  # seconds
    sum_cop_tasks: int = 0
    # peak per-statement memory (utils/memory.Tracker root max_consumed) —
    # the statements_summary MAX_MEM column (OOM forensics without a repro)
    max_mem: int = 0
    # workload attribution: request units this digest consumed and the
    # resource group its sessions ran under (statements_summary SUM_RU /
    # RESOURCE_GROUP; metering only)
    sum_ru: float = 0.0
    resource_group: str = ""

    @property
    def avg_latency(self) -> float:
        return self.sum_latency / self.exec_count if self.exec_count else 0.0

    def to_pb(self) -> dict:
        """Wire form for the sys_snapshot introspection verb (the fleet-wide
        cluster_statements_summary rows travel as these dicts)."""
        d = asdict(self)
        d["avg_latency"] = self.avg_latency
        return d

    @classmethod
    def from_pb(cls, pb: dict) -> "StmtStats":
        """Inverse of ``to_pb`` (derived/unknown keys ignored, missing keys
        default) — the cluster_* memtables rebuild real records from wire
        dicts so the dataclass is the ONE home of the field set."""
        names = {f.name for f in fields(cls)}
        d = {k: v for k, v in pb.items() if k in names}
        d.setdefault("digest", "")
        d.setdefault("sample", "")
        return cls(**d)


@dataclass
class SlowEntry:
    """One slow-log ring record (ref: the slow query log's structured
    fields — Plan_digest, Cop_time, Backoff_time, the max-task store)."""

    time: float
    sql: str
    latency_s: float
    rows: int
    user: str
    digest: str = ""
    plan_digest: str = ""
    cop_tasks: int = 0
    cop_proc_max_ms: float = 0.0
    backoff_ms: float = 0.0
    resplits: int = 0
    max_task_store: str = ""
    cop_summary: str = ""
    # when the statement was trace-sampled, the reservoir key an operator
    # pivots to for the full span tree (GET /traces?id=<trace_id>)
    trace_id: str = ""
    # the statement's memory-tracker peak (bytes) — slow_query.MEM_MAX
    mem_max: int = 0
    # event-log cross-links, captured at record time when the statement was
    # trace-sampled: how many events carried its trace_id, and the first
    # ERROR-level one (component.event) — the "what went wrong first" pivot
    events: int = 0
    first_error: str = ""
    # workload attribution: the statement's metered request units and its
    # session's resource group (slow_query RU / RESOURCE_GROUP)
    ru: float = 0.0
    resource_group: str = ""

    def __iter__(self):
        # legacy 5-tuple shape for pre-structured consumers
        return iter((self.time, self.sql, self.latency_s, self.rows, self.user))

    def to_pb(self) -> dict:
        """Wire form for the sys_snapshot verb (cluster_slow_query rows)."""
        return asdict(self)

    @classmethod
    def from_pb(cls, pb: dict) -> "SlowEntry":
        """Inverse of ``to_pb`` (see StmtStats.from_pb)."""
        names = {f.name for f in fields(cls)}
        d = {k: v for k, v in pb.items() if k in names}
        for req, dflt in (("time", 0.0), ("sql", ""), ("latency_s", 0.0),
                          ("rows", 0), ("user", "")):
            d.setdefault(req, dflt)
        return cls(**d)


class StmtSummary:
    def __init__(self, capacity: int = 200, slow_capacity: int = 512):
        self._mu = threading.Lock()
        self._stats: OrderedDict[str, StmtStats] = OrderedDict()
        self.capacity = capacity
        # slow log ring of SlowEntry records
        self._slow: deque = deque(maxlen=slow_capacity)

    def record(
        self,
        sql: str,
        latency_s: float,
        rows: int,
        user: str,
        slow_threshold_s: float,
        digest_val: "str | None" = None,
        plan_digest: str = "",
        cop=None,
        trace_id: str = "",
        mem_max: int = 0,
        ru: float = 0.0,
        resource_group: str = "",
    ) -> None:
        # the session computes one digest per statement and threads it here
        # (plus Top-SQL/bindings) instead of re-normalizing per consumer;
        # ``cop`` is the statement's CopTasksSummary (or None)
        d = digest_val if digest_val is not None else digest(sql)
        with self._mu:
            st = self._stats.get(d)
            if st is None:
                st = StmtStats(d, sql[:256])
                self._stats[d] = st
                while len(self._stats) > self.capacity:
                    self._stats.popitem(last=False)
            st.exec_count += 1
            st.sum_latency += latency_s
            st.max_latency = max(st.max_latency, latency_s)
            st.sum_rows += rows
            st.last_seen = time.time()
            st.max_mem = max(st.max_mem, int(mem_max))
            st.sum_ru += ru
            if resource_group:
                st.resource_group = resource_group
            if plan_digest:
                st.plan_digest = plan_digest
            if cop is not None and cop.num:
                st.sum_backoff += cop.backoff_ms / 1000.0
                st.sum_cop_tasks += cop.num
            self._stats.move_to_end(d)
            if latency_s >= slow_threshold_s:
                e = SlowEntry(
                    time.time(), sql[:512], latency_s, rows, user,
                    digest=d.partition("|")[0], plan_digest=plan_digest,
                    trace_id=trace_id, mem_max=int(mem_max),
                    ru=ru, resource_group=resource_group,
                )
                if cop is not None and cop.num:
                    e.cop_tasks = cop.num
                    e.cop_proc_max_ms = cop.max_proc_ms
                    e.backoff_ms = cop.backoff_ms
                    e.resplits = cop.resplits
                    e.max_task_store = cop.max_task_store
                    e.cop_summary = cop.render()
                if trace_id:
                    # slow statements are rare — a ring scan here is fine,
                    # and the cross-link makes the entry self-diagnosing
                    from tidb_tpu_torch.utils import eventlog as _evlog

                    evs = _evlog.get().for_trace(trace_id)
                    e.events = len(evs)
                    for ev in evs:
                        if ev[1] >= _evlog.ERROR:
                            e.first_error = f"{ev[2]}.{ev[3]}"
                            break
                self._slow.append(e)

    def stats(self) -> list[StmtStats]:
        with self._mu:
            return list(self._stats.values())

    def slow_queries(self) -> list[SlowEntry]:
        with self._mu:
            return list(self._slow)

    def clear(self) -> None:
        with self._mu:
            self._stats.clear()
            self._slow.clear()
