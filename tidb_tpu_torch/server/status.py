"""HTTP status server (ref: pkg/server/http_status.go:213-260): /metrics
(Prometheus text), /status (JSON health), /schema (catalog dump)."""

from __future__ import annotations

import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional


class StatusServer:
    def __init__(self, db, host: str = "127.0.0.1", port: int = 0):
        self.db = db
        outer = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *a):  # quiet
                pass

            def do_GET(self):
                if self.path == "/metrics":
                    from tidb_tpu_torch.utils.metrics import REGISTRY

                    body = REGISTRY.render().encode()
                    ctype = "text/plain; version=0.0.4"
                elif self.path.startswith("/metrics/history"):
                    # the in-process metrics history recorder
                    # (utils/metricshist): ?name=<metric> filters one series
                    # family, ?seconds=<s> bounds the lookback — the HTTP
                    # face of information_schema.metrics_history
                    import time as _time
                    from urllib.parse import parse_qs, urlparse

                    from tidb_tpu_torch.utils.metricshist import recorder

                    q = parse_qs(urlparse(self.path).query)
                    name = q.get("name", [None])[0]
                    secs = q.get("seconds", [None])[0]
                    try:
                        since = _time.time() - float(secs) if secs else None
                    except ValueError:
                        self.send_response(400)
                        self.end_headers()
                        return
                    body = json.dumps(
                        [
                            {"name": n, "labels": lbl, "ts": t, "value": v}
                            for n, lbl, t, v in recorder().series(name=name, since=since)
                        ]
                    ).encode()
                    ctype = "application/json"
                elif self.path.startswith("/cluster"):
                    # fleet-wide introspection: one live sys_snapshot sweep
                    # (dead stores degrade to per-instance error entries)
                    # plus the health registry's staleness view — the HTTP
                    # face of information_schema.cluster_info/cluster_load.
                    # sections=() keeps the heavy report parts off the wire
                    # entirely; the filter below only strips history rings a
                    # hist sweep may have cached alongside.
                    outs = outer.db.health.sweep(sections=())
                    slim = []
                    for o in outs:
                        ent = {"instance": o["instance"], "shard": o["shard"], "ok": o["ok"]}
                        if o["ok"]:
                            ent["report"] = {
                                k: v for k, v in o["report"].items()
                                if k not in ("metrics", "history", "statements", "slow", "traces", "heatmap")
                            }
                        else:
                            ent["error"] = o["error"]
                        slim.append(ent)
                    reg = {
                        inst: {"ok": ent["ok"], "error": ent.get("error", ""),
                               "staleness_s": outer.db.health.staleness_s(inst),
                               "stale": outer.db.health.is_stale(inst)}
                        for inst, ent in outer.db.health.reports().items()
                    }
                    body = json.dumps({"instances": slim, "registry": reg}).encode()
                    ctype = "application/json"
                elif self.path == "/status":
                    body = json.dumps(
                        {"connections": len(getattr(outer.db, "server", None)._conns) if getattr(outer.db, "server", None) else 0,
                         "version": "8.0.11-tidb-tpu", "git_hash": "tpu-native"}
                    ).encode()
                    ctype = "application/json"
                elif self.path == "/schema":
                    out = {}
                    for d in outer.db.catalog.databases():
                        out[d] = {t: outer.db.catalog.table(d, t).to_pb() for t in outer.db.catalog.tables(d)}
                    body = json.dumps(out).encode()
                    ctype = "application/json"
                elif self.path == "/election":
                    # owner-election observability (kv/election.py): per-key
                    # owner, fencing term, and lease remaining — from the
                    # quorum keyspace on a sharded fleet, the local
                    # OwnerManager on an embedded store
                    el = getattr(outer.db.store, "election", None)
                    if el is not None:
                        try:
                            snap = el.snapshot()
                        except ConnectionError as e:
                            snap = {"error": str(e)}
                    else:
                        om = getattr(outer.db.store, "owner_mgr", None)
                        snap = om.snapshot() if om is not None else {}
                    body = json.dumps(snap).encode()
                    ctype = "application/json"
                elif self.path.startswith("/slowlog"):
                    # the slow-log ring with its structured exec-detail
                    # fields (see information_schema.slow_query for the SQL
                    # surface of the same data); trace_id pivots to /traces
                    body = json.dumps(
                        [
                            {"time": e.time, "query": e.sql,
                             "query_time": e.latency_s, "rows": e.rows,
                             "user": e.user, "digest": e.digest,
                             "plan_digest": e.plan_digest,
                             "cop_tasks": e.cop_tasks,
                             "cop_proc_max_ms": e.cop_proc_max_ms,
                             "backoff_ms": e.backoff_ms,
                             "resplits": e.resplits,
                             "max_task_store": e.max_task_store,
                             "cop_summary": e.cop_summary,
                             "trace_id": e.trace_id,
                             "events": e.events,
                             "first_error": e.first_error,
                             "ru": e.ru,
                             "resource_group": e.resource_group}
                            for e in outer.db.stmt_summary.slow_queries()
                        ]
                    ).encode()
                    ctype = "application/json"
                elif self.path.startswith("/logs"):
                    # the structured event log (utils/eventlog): ?since=<ts>
                    # / ?seconds=<lookback> bound the window, ?level=<name>
                    # sets the floor, ?component= and ?pattern= filter, and
                    # ?limit= caps rows (newest kept) — the HTTP face of
                    # information_schema.tidb_log; trace_id pivots to /traces
                    import time as _time
                    from urllib.parse import parse_qs, urlparse

                    from tidb_tpu_torch.utils import eventlog as _evlog

                    q = parse_qs(urlparse(self.path).query)
                    try:
                        since = q.get("since", [None])[0]
                        since = float(since) if since else None
                        secs = q.get("seconds", [None])[0]
                        if secs:
                            since = _time.time() - float(secs)
                        until = q.get("until", [None])[0]
                        until = float(until) if until else None
                        limit = int(q.get("limit", ["256"])[0])
                    except ValueError:
                        self.send_response(400)
                        self.end_headers()
                        return
                    rows = _evlog.get().search(
                        since=since,
                        until=until,
                        min_level=_evlog.level_from_name(
                            q.get("level", ["debug"])[0]
                        ),
                        component=q.get("component", [None])[0],
                        pattern=q.get("pattern", [None])[0],
                        limit=limit,
                    )
                    body = json.dumps(
                        [
                            {"ts": ts, "level": _evlog.level_name(lv),
                             "component": comp, "event": ev,
                             "fields": fields, "trace_id": tid}
                            for ts, lv, comp, ev, fields, tid in rows
                        ]
                    ).encode()
                    ctype = "application/json"
                elif self.path.startswith("/topsql"):
                    # ref: the dashboard Top-SQL API fed by util/topsql
                    from tidb_tpu_torch.utils.topsql import collector

                    body = json.dumps(
                        [
                            {"sql_digest": d, "plan_digest": p, "sample": s,
                             "cpu_time_sec": c, "samples": n, "trace_id": t,
                             "ru": ru}
                            for d, p, s, c, n, t, ru in collector().top_sql()
                        ]
                    ).encode()
                    ctype = "application/json"
                elif self.path.startswith("/keyviz"):
                    # the keyspace traffic heatmap, raw (the Key Visualizer
                    # substrate; information_schema.keyspace_heatmap is the
                    # SQL face of the same sweep): one live heatmap-only
                    # sys_snapshot sweep, ?seconds=<s> trims each ring to
                    # the trailing window; dead stores degrade to error
                    # entries, never a failed response
                    import time as _time
                    from urllib.parse import parse_qs, urlparse

                    q = parse_qs(urlparse(self.path).query)
                    secs = q.get("seconds", [None])[0]
                    try:
                        since = _time.time() - float(secs) if secs else 0.0
                    except ValueError:
                        self.send_response(400)
                        self.end_headers()
                        return
                    outs = outer.db.health.sweep(sections=("heatmap",))
                    ents = []
                    for o in outs:
                        ent = {"instance": o["instance"], "ok": o["ok"]}
                        if o["ok"]:
                            ent["heatmap"] = [
                                {**e, "buckets": [b for b in e["buckets"] if b[0] >= since]}
                                for e in o["report"].get("heatmap", ())
                            ]
                        else:
                            ent["error"] = o["error"]
                        ents.append(ent)
                    body = json.dumps({"instances": ents}).encode()
                    ctype = "application/json"
                elif self.path.startswith("/traces"):
                    # the always-on sampled-trace reservoir (utils/tracing
                    # .TraceReservoir): ?id=<trace_id> serves one retained
                    # trace (the slow-log/Top-SQL pivot), bare /traces lists
                    # every retained entry with its full span tree
                    from urllib.parse import parse_qs, urlparse

                    res = getattr(outer.db, "trace_reservoir", None)
                    tid = parse_qs(urlparse(self.path).query).get("id", [None])[0]
                    if res is None:
                        entries = []
                    elif tid is not None:
                        hit = res.get(tid)
                        entries = [hit] if hit is not None else []
                    else:
                        entries = res.traces()
                    body = json.dumps(
                        [
                            {"trace_id": e.trace_id, "time": e.time,
                             "query": e.sql, "query_time": e.duration_s,
                             "digest": e.digest, "slow": e.slow,
                             # [name, start_ms, duration_ms, depth, node]
                             "spans": e.spans}
                            for e in entries
                        ]
                    ).encode()
                    ctype = "application/json"
                elif self.path.startswith("/debug/pprof/profile") or self.path.startswith("/profile"):
                    # collapsed-stack text, flamegraph.pl input format
                    # (ref: util/cpuprofile's shared continuous profiler)
                    from tidb_tpu_torch.utils.topsql import collector

                    body = "\n".join(f"{s} {n}" for s, n in collector().profile()).encode()
                    ctype = "text/plain"
                else:
                    self.send_response(404)
                    self.end_headers()
                    return
                self.send_response(200)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

        self._httpd = ThreadingHTTPServer((host, port), Handler)
        self.port = self._httpd.server_address[1]
        self._thread: Optional[threading.Thread] = None

    def start(self) -> int:
        self._thread = threading.Thread(
            target=self._httpd.serve_forever, daemon=True, name="status-http"
        )
        self._thread.start()
        return self.port

    def close(self) -> None:
        self._httpd.shutdown()
        self._httpd.server_close()
