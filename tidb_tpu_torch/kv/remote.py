"""The process boundary: a storage server and its remote store client.

Reference parity: the TiDB↔TiKV seam — `kv.Storage` backed by gRPC
(pkg/store/driver/tikv_driver.go) with coprocessor DAGs executed store-side
(pkg/store/copr/coprocessor.go:87 CopClient.Send → gRPC Cop; MPP dispatch
pkg/kv/mpp.go:189-199). Here the wire is a length-framed JSON+blob protocol
over TCP, and the payloads are the SAME contracts the in-process path uses:
`dagpb.DAGRequest.to_pb()` travels out, `utils.chunk.encode_chunk` travels
back, percolator verbs (prewrite/commit/rollback/resolve) ship mutation
lists. A SQL-layer process built on :class:`RemoteStore` plans and runs the
Volcano tree locally while every byte of data — and the device engine —
lives in the server process, exactly the TiKV-serves-the-region role.

Frame layout: 8-byte little-endian total length, then 4-byte header length,
the JSON header, and the blobs (each 8-byte length + bytes) the header's
``nblobs`` declares. Short keys ride the header base64; row payloads ride
blobs.
"""

from __future__ import annotations

import base64
import json
import socket
import struct
import threading
import time
from typing import Optional, Sequence

from tidb_tpu_torch.kv.kv import (
    KeyLockedError,
    KeyRange,
    RegionError,
    Request,
    RequestType,
    StoreType,
    TxnAbortedError,
    UndeterminedError,
    WriteConflictError,
)
from tidb_tpu_torch.kv.memstore import OP_DEL, OP_PUT, Lock, MemStore, Mutation, Region
from tidb_tpu_torch.utils import eventlog as _ev
from tidb_tpu_torch.utils import execdetails as _ed
from tidb_tpu_torch.utils import failpoint
from tidb_tpu_torch.utils import tracing as _tracing
from tidb_tpu_torch.utils.backoff import Backoffer, BackoffExhausted, boRPC


def _b(x: bytes) -> str:
    return base64.b64encode(x).decode()


def _ub(s: str) -> bytes:
    return base64.b64decode(s)


def _send_frame(sock: socket.socket, header: dict, blobs: Sequence[bytes] = ()) -> None:
    h = json.dumps({**header, "nblobs": len(blobs)}).encode()
    parts = [struct.pack("<I", len(h)), h]
    for b in blobs:
        parts.append(struct.pack("<Q", len(b)))
        parts.append(b)
    payload = b"".join(parts)
    sock.sendall(struct.pack("<Q", len(payload)) + payload)


def _recv_exact(sock: socket.socket, n: int) -> bytes:
    out = bytearray()
    while len(out) < n:
        got = sock.recv(n - len(out))
        if not got:
            raise ConnectionError("peer closed")
        out.extend(got)
    return bytes(out)


def _recv_frame(sock: socket.socket) -> tuple[dict, list[bytes]]:
    (total,) = struct.unpack("<Q", _recv_exact(sock, 8))
    payload = _recv_exact(sock, total)
    (hlen,) = struct.unpack_from("<I", payload, 0)
    header = json.loads(payload[4 : 4 + hlen])
    blobs = []
    off = 4 + hlen
    for _ in range(header.get("nblobs", 0)):
        (blen,) = struct.unpack_from("<Q", payload, off)
        off += 8
        blobs.append(payload[off : off + blen])
        off += blen
    return header, blobs


def _lock_pb(lock: Lock) -> dict:
    return {
        "primary": _b(lock.primary),
        "start_ts": lock.start_ts,
        "op": lock.op,
        "value": _b(lock.value),
        "ttl_ms": lock.ttl_ms,
        "created_ms": lock.created_ms,
    }


def _lock_from_pb(pb: dict) -> Lock:
    return Lock(_ub(pb["primary"]), pb["start_ts"], pb["op"], _ub(pb["value"]), pb["ttl_ms"], pb["created_ms"])


def _migrate_items_blob(items) -> bytes:
    """Pack migrate_export items: per item 1B op (0=put 1=del), 4B klen,
    key, 8B vlen, value, 8B commit_ts, 8B start_ts."""
    buf = bytearray()
    for k, op, v, cts, sts in items:
        buf += bytes([0 if op == OP_PUT else 1])
        buf += struct.pack("<I", len(k)) + k
        buf += struct.pack("<Q", len(v)) + v
        buf += struct.pack("<QQ", cts, sts)
    return bytes(buf)


def _migrate_items_unpack(buf: bytes) -> list:
    items = []
    off = 0
    while off < len(buf):
        op = OP_PUT if buf[off] == 0 else OP_DEL
        off += 1
        (klen,) = struct.unpack_from("<I", buf, off)
        off += 4
        k = buf[off : off + klen]
        off += klen
        (vlen,) = struct.unpack_from("<Q", buf, off)
        off += 8
        v = buf[off : off + vlen]
        off += vlen
        cts, sts = struct.unpack_from("<QQ", buf, off)
        off += 16
        items.append((k, op, v, cts, sts))
    return items


def _cursor_pb(cur):
    """Migration cursor → JSON-able (dict-phase cursors carry a raw key)."""
    if cur is None:
        return None
    if cur[0] == "dict":
        return ["dict", _b(cur[1])]
    return ["stable", cur[1], cur[2]]


def _cursor_from_pb(pb):
    if pb is None:
        return None
    if pb[0] == "dict":
        return ("dict", _ub(pb[1]))
    return ("stable", int(pb[1]), int(pb[2]))


# every section name sys_report's request side may select — the graftcheck
# sys-sections rule asserts each _want("...") literal below is declared here,
# so a new heavy section cannot silently ship to load probes that asked for
# nothing (the sections=() discipline)
SYS_SECTIONS = frozenset({"metrics", "statements", "slow", "heatmap"})


def sys_report(store=None, server=None, hist=None, sections=None) -> dict:
    """One process's introspection report — what the replay-safe
    ``sys_snapshot`` verb ships fleet-wide (ref: the gRPC coprocessor
    endpoint for memory tables serving ``information_schema.cluster_*``,
    rpc_server.go:96). Walks the process-global metrics registry, the
    store-side StmtSummary ring (``server`` given), cop-pool depth,
    device-cache residency, uptime, and process info into one JSON-able
    dict; ``hist`` additionally attaches the metrics-history rings (True =
    every series, a string = that metric only). ``sections`` selects the
    HEAVY parts (any of "metrics"/"statements"/"slow"): None ships them
    all, an iterable ships only those named — cluster_info/cluster_load
    sweeps and GET /cluster request ``sections=()`` so a load probe never
    serializes whole slow rings over the wire."""
    import os as _os

    from tidb_tpu_torch.utils import metrics as _m
    from tidb_tpu_torch.utils import metricshist as _mh

    want = None if sections is None else set(sections)

    def _want(k: str) -> bool:
        return want is None or k in want

    now = time.time()
    rec = _mh.recorder()
    rep: dict = {
        "pid": _os.getpid(),
        "version": "8.0.11-tidb-tpu",
        "start_time": _mh.PROC_START,
        "uptime_s": round(now - _mh.PROC_START, 3),
        "stmts": _m.STMT_TOTAL.total(),
        "cop_tasks": _m.COP_TASKS.total(),
        "conns": int(_m.SERVER_CONNS.get()),
        # recent rates need the history recorder running (default on for
        # server processes); 0.0 with no samples — never an error
        "qps": round(rec.rate("tidb_tpu_executor_statement_total"), 3),
        "cop_qps": round(rec.rate("tidb_tpu_copr_task_total"), 3),
        "delta_rows": _m.DEVICE_DELTA_ROWS.get(),
    }
    if _want("metrics"):
        rep["metrics"] = _m.REGISTRY.snapshot()
    from tidb_tpu_torch.copr.client import cop_pool_stats

    rep["cop_pool"], rep["cop_queue"] = cop_pool_stats()
    if store is not None and isinstance(store, MemStore):
        from tidb_tpu_torch.copr.colcache import cache_for

        rep["device_cache_bytes"] = cache_for(store).resident_bytes()
        ring = getattr(store, "cop_ring", None)
        if ring is not None and _want("statements"):
            # embedded fleet member: its per-store cop-digest ring ships in
            # the same section a store server's StmtSummary would, so the
            # balancer's hot-table boost works in-process too
            rep["statements"] = [st.to_pb() for st in ring.stats()[-64:]]
        if _want("heatmap"):
            # keyspace traffic rings (Key Visualizer substrate) — heavy like
            # statements/slow, so only shipped when asked for
            rep["heatmap"] = store.traffic.snapshot()
    if server is not None:
        rep["addr"] = f"{server.host}:{server.port}"
        with server._conns_mu:
            rep["conns"] = len(server._conns)
        if _want("statements"):
            rep["statements"] = [st.to_pb() for st in server.stmt_summary.stats()[-64:]]
        if _want("slow"):
            rep["slow"] = [e.to_pb() for e in server.stmt_summary.slow_queries()[-128:]]
    if hist:
        rep["history"] = [
            list(r) for r in rec.series(name=hist if isinstance(hist, str) else None)
        ]
    return rep


class StoreServer:
    """Serves one MemStore (and its engines) to remote SQL-layer processes."""

    def __init__(self, store: MemStore, host: str = "127.0.0.1", port: int = 0):
        self.store = store
        self._sock = socket.create_server((host, port))
        self.host, self.port = self._sock.getsockname()[:2]
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._accept_loop, daemon=True, name="store-server")
        self._mpp = None  # lazy MPPTaskManager (first dispatch pays SQL-context open)
        self._mpp_mu = threading.Lock()
        # live client connections, so shutdown() behaves like process death:
        # in-flight requests see a reset, not a silent hang (chaos tests kill
        # and resurrect in-process servers this way)
        self._conns: set[socket.socket] = set()
        self._conns_mu = threading.Lock()
        # store-side cop slow log (the TiKV-slow-log analog): every cop task
        # records into this ring; tasks over [observability] store-slow-cop-ms
        # pin a SlowEntry. Served fleet-wide via the sys_snapshot verb.
        from tidb_tpu_torch.utils.stmtsummary import StmtSummary

        self.stmt_summary = StmtSummary(capacity=64, slow_capacity=128)

    def _mpp_mgr(self):
        with self._mpp_mu:
            if self._mpp is None:
                from tidb_tpu_torch.parallel.mpptask import MPPTaskManager

                self._mpp = MPPTaskManager(self.store)
            return self._mpp

    def start(self) -> int:
        # the in-process metrics history rides along (default on, refcounted
        # — shared with any embedded DB's background loops in this process)
        from tidb_tpu_torch.utils.metricshist import recorder

        recorder().start()
        self._rec_started = True
        self._thread.start()
        # background delta-merge sweep (the embedded DB's owner-gated
        # 'colmerge' timer mirrored onto the storage tier): this server is
        # the single owner of its store's column cache by construction, so
        # the gate is just the server's own stop event — without it a store
        # only folds deltas when a query crosses the merge threshold
        from tidb_tpu_torch import config as _config

        interval = _config.current().store_colmerge_interval_s
        if interval > 0:
            self._colmerge = threading.Thread(
                target=self._colmerge_loop, args=(interval,), daemon=True,
                name="store-colmerge",
            )
            self._colmerge.start()
        return self.port

    def _colmerge_loop(self, interval: float) -> None:
        from tidb_tpu_torch.copr.colcache import cache_for

        while not self._stop.wait(interval):
            try:
                cache_for(self.store).merge_pending(should_stop=self._stop.is_set)
            # a failed sweep retries next tick; queries still merge on the
            # query-path threshold, so nothing is lost — only deferred
            except Exception:  # graftcheck: off=except-swallow
                pass

    def shutdown(self) -> None:
        if getattr(self, "_rec_started", False) and not self._stop.is_set():
            from tidb_tpu_torch.utils.metricshist import recorder

            recorder().stop()
        self._stop.set()
        cm = getattr(self, "_colmerge", None)
        if cm is not None and cm is not threading.current_thread():
            cm.join(timeout=5)  # a mid-sweep merge stops at the next region
        try:
            # wake the blocked accept() (it holds the listener's file
            # description, so close() alone would leave the port accepting)
            self._sock.shutdown(socket.SHUT_RDWR)
        except OSError:
            pass
        try:
            self._sock.close()
        except OSError:
            pass
        with self._conns_mu:
            conns, self._conns = list(self._conns), set()
        for c in conns:
            try:
                # SHUT_RDWR, not just close(): a serve thread blocked in
                # recv holds the open file description, so close() alone
                # neither wakes it nor sends the peer a FIN
                c.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass
            try:
                c.close()
            except OSError:
                pass

    def _accept_loop(self) -> None:
        while not self._stop.is_set():
            try:
                conn, _ = self._sock.accept()
            except OSError:
                return
            # the stop re-check must happen INSIDE the registry lock:
            # shutdown() sets _stop before draining _conns, so either it
            # drains this conn or we observe _stop here — an unlocked check
            # lets a conn accepted pre-shutdown slip into the fresh set and
            # keep a "dead" server answering one client
            with self._conns_mu:
                if self._stop.is_set():  # raced shutdown: refuse, don't serve
                    try:
                        conn.close()
                    except OSError:
                        pass
                    return
                self._conns.add(conn)
            lg = _ev.on(_ev.DEBUG)
            if lg is not None:
                lg.emit(_ev.DEBUG, "store", "conn_open", port=self.port)
            threading.Thread(
                target=self._serve, args=(conn,), daemon=True, name="store-conn"
            ).start()

    def _serve(self, conn: socket.socket) -> None:
        try:
            while True:
                header, blobs = _recv_frame(conn)
                try:
                    reply, rblobs = self._dispatch(header, blobs)
                except RegionError as e:
                    # typed for EVERY verb (not just cop): a placement-fenced
                    # table refuses reads/writes/commits with RegionMiss and
                    # the client re-resolves routing under boRegionMiss —
                    # never a Generic error, never an UndeterminedError
                    reply, rblobs = {"err": "RegionMiss", "region_id": getattr(e, "region_id", -1)}, []
                except KeyLockedError as e:
                    reply, rblobs = {"err": "KeyLocked", "key": _b(e.key), "lock": _lock_pb(e.lock)}, []
                except WriteConflictError as e:
                    reply, rblobs = {
                        "err": "WriteConflict",
                        "key": _b(e.key),
                        "conflict_ts": e.conflict_ts,
                        "start_ts": e.start_ts,
                    }, []
                except TxnAbortedError as e:
                    reply, rblobs = {"err": "TxnAborted", "msg": str(e)}, []
                except Exception as e:  # surfaced to the caller, not the server log
                    # the kind travels with the message so the client can
                    # re-type semantically load-bearing errors (a KILL/OOM
                    # verdict must never be mistaken for an engine failure
                    # and re-run on another engine — see run_task_resilient)
                    reply, rblobs = {
                        "err": "Generic",
                        "kind": type(e).__name__,
                        "msg": f"{type(e).__name__}: {e}",
                    }, []
                _send_frame(conn, reply, rblobs)
        except (ConnectionError, OSError):
            pass
        finally:
            with self._conns_mu:
                self._conns.discard(conn)
            lg = _ev.on(_ev.DEBUG)
            if lg is not None:
                lg.emit(_ev.DEBUG, "store", "conn_close", port=self.port)
            try:
                conn.close()
            except OSError:
                pass

    def _dispatch(self, h: dict, blobs: list[bytes]):
        st = self.store
        cmd = h["cmd"]
        if cmd == "ping":
            return {"ok": 1}, []
        if cmd == "sys_snapshot":
            # the store-introspection verb (replay-safe: a pure read of
            # process state) — one JSON-able health/load report per store,
            # the substrate of information_schema.cluster_* and the
            # SQL layer's StoreHealthRegistry
            return {
                "report": sys_report(
                    store=st, server=self, hist=h.get("hist"),
                    sections=h.get("sections"),
                )
            }, []
        if cmd == "log_search":
            # fleet log search (replay-safe: a pure read of the process's
            # event rings) — ALL filtering happens server-side so a ring
            # never ships whole: time range, min level, component, regex,
            # and the row cap travel in the header
            from tidb_tpu_torch.utils import eventlog as _evlog

            lim = h.get("limit", 256)
            rows = _evlog.get().search(
                since=h.get("since"),
                until=h.get("until"),
                min_level=int(h.get("min_level", _evlog.DEBUG)),
                component=h.get("component"),
                pattern=h.get("pattern"),
                limit=int(lim) if lim is not None else None,
            )
            return {"rows": [list(r) for r in rows]}, []
        if cmd == "current_ts":
            return {"ts": st.current_ts()}, []
        if cmd == "tso":
            return {"ts": st.tso.ts()}, []
        if cmd == "raw_get":
            v = st.raw_get(_ub(h["key"]))
            return ({"hit": v is not None}, [v] if v is not None else [])
        if cmd == "raw_put":
            st.raw_put(_ub(h["key"]), blobs[0])
            return {"ok": 1}, []
        if cmd == "raw_delete":
            st.raw_delete(_ub(h["key"]))
            return {"ok": 1}, []
        if cmd == "raw_cas":
            expected = blobs[0] if h["has_expected"] else None
            ok = st.raw_cas(_ub(h["key"]), expected, blobs[-1])
            return {"ok": int(ok)}, []
        if cmd == "raw_scan":
            pairs = st.raw_scan(KeyRange(_ub(h["start"]), _ub(h["end"])), limit=h.get("limit", 2**62))
            out = bytearray()
            for k, v in pairs:
                out += struct.pack("<II", len(k), len(v)) + k + v
            return {"n": len(pairs)}, [bytes(out)]
        if cmd == "run_gc":
            from tidb_tpu_torch.kv.gcworker import GCWorker

            w = GCWorker(st, life_ms=h.get("life_ms", 600_000))
            pruned = w.run_once(h.get("safe_point"))
            return {"pruned": pruned, "safe_point": w.safe_point}, []
        if cmd == "snap_get":
            v = st.get_snapshot(h["ts"]).get(_ub(h["key"]))
            return ({"hit": v is not None}, [v] if v is not None else [])
        if cmd == "snap_batch_get":
            # batched point reads (TiKV batch-commands idiom): N keys, one
            # RPC, one vectorized store lookup. Per-key lock conflicts ship
            # as per-key verdicts — one locked key must not fail the batch.
            outs = st.snap_batch_get([(ts, _ub(kb)) for ts, kb in h["gets"]])
            results = []
            vals = []
            for v in outs:
                if isinstance(v, KeyLockedError):
                    results.append({"err": "KeyLocked", "key": _b(v.key), "lock": _lock_pb(v.lock)})
                elif v is None:
                    results.append({"hit": 0})
                else:
                    results.append({"hit": 1})
                    vals.append(v)
            return {"gets": results}, vals
        if cmd == "snap_scan":
            kr = KeyRange(_ub(h["start"]), _ub(h["end"]))
            pairs = st.get_snapshot(h["ts"]).scan(kr, limit=h.get("limit", 2**63), reverse=h.get("reverse", False))
            out = bytearray()
            for k, v in pairs:
                out += struct.pack("<II", len(k), len(v)) + k + v
            return {"n": len(pairs)}, [bytes(out)]
        if cmd == "prewrite":
            # muts blob: per mutation 1B op (0=put 1=del) + 4B klen + key + 8B vlen + value
            muts = []
            buf = blobs[0]
            off = 0
            while off < len(buf):
                op = buf[off]
                off += 1
                (klen,) = struct.unpack_from("<I", buf, off)
                off += 4
                key = buf[off : off + klen]
                off += klen
                (vlen,) = struct.unpack_from("<Q", buf, off)
                off += 8
                val = buf[off : off + vlen]
                off += vlen
                muts.append(Mutation(OP_PUT if op == 0 else OP_DEL, key, val))
            counts = st.prewrite(muts, _ub(h["primary"]), h["start_ts"])
            # write-side accounting rides the reply headers (RU metering)
            return {"ok": 1, **(counts or {})}, []
        if cmd == "commit":
            counts = st.commit([_ub(k) for k in h["keys"]], h["start_ts"], h["commit_ts"])
            return {"ok": 1, **(counts or {})}, []
        if cmd == "rollback":
            st.rollback([_ub(k) for k in h["keys"]], h["start_ts"])
            return {"ok": 1}, []
        if cmd == "drop_stable":
            st.drop_stable(h["table_id"])
            return {"ok": 1}, []
        if cmd == "owner_campaign":
            # the fencing token ("term") rides the wire so a renewal by a
            # deposed owner is rejected server-side (kv/owner.py term check)
            ok = st.owner_campaign(h["key"], h["node_id"], h.get("lease_s"), term=h.get("term"))
            return {"ok": int(ok)}, []
        if cmd == "owner_of":
            return {"owner": st.owner_of(h["key"])}, []
        if cmd == "owner_resign":
            st.owner_resign(h["key"], h["node_id"])
            return {"ok": 1}, []
        if cmd == "owner_term":
            return {"term": st.owner_term(h["key"])}, []
        if cmd == "placement_propose":
            # quorum placement replica verb (kv/placement.py): idempotent —
            # re-proposing an accepted binding re-accepts, so replay-safe
            ok, epoch = st.placement_propose(h["tid"], h["shard"], h["epoch"])
            return {"ok": int(ok), "epoch": epoch}, []
        if cmd == "placement_read":
            if h.get("tid") is None:
                recs = st.placement_read(None)
                return {"recs": [[tid, e, s] for tid, e, s in recs]}, []
            epoch, shard = st.placement_read(h["tid"])
            return {"epoch": epoch, "shard": shard}, []
        if cmd == "fence_table":
            # placement cutover fence (idempotent → replay-safe): reads and
            # writes of the table now answer RegionMiss until unfenced
            st.fence_table(h["tid"], h.get("ttl_s"))
            return {"ok": 1}, []
        if cmd == "unfence_table":
            st.unfence_table(h["tid"])
            return {"ok": 1}, []
        if cmd == "migrate_export":
            # region-move page read (pure read → replay-safe)
            page = st.migrate_export(
                h["tid"], after_ts=h.get("after_ts", 0), upto_ts=h.get("upto_ts"),
                cursor=_cursor_from_pb(h.get("cursor")), limit=h.get("limit", 4096),
                include_locks=bool(h.get("locks")),
            )
            return {
                "cursor": _cursor_pb(page["cursor"]),
                "locks": [[_b(k), _lock_pb(l)] for k, l in page["locks"]],
            }, [_migrate_items_blob(page["items"])]
        if cmd == "migrate_region":
            # region-move apply (idempotent per (key, commit_ts) → replay-
            # safe): installs migrated versions + in-flight prewrite locks
            n = st.migrate_apply(
                _migrate_items_unpack(blobs[0]) if blobs else [],
                [(_ub(k), _lock_from_pb(l)) for k, l in h.get("locks", ())],
            )
            return {"applied": n}, []
        if cmd == "purge_table":
            st.purge_table(h["tid"])
            return {"ok": 1}, []
        if cmd == "election_propose":
            # quorum election replica verb (kv/election.py): idempotent —
            # re-proposing an accepted record re-accepts, so replay-safe
            ok, term = st.election_propose(h["key"], h["node_id"], h["term"], h["deadline"])
            return {"ok": int(ok), "term": term}, []
        if cmd == "election_read":
            term, owner, deadline = st.election_read(h["key"])
            return {"term": term, "owner": owner, "deadline": deadline}, []
        if cmd == "check_txn_status":
            status, commit_ts = st.check_txn_status(_ub(h["primary"]), h["start_ts"])
            return {"status": status, "commit_ts": commit_ts}, []
        if cmd == "pessimistic_rollback":
            st.pessimistic_rollback([_ub(k) for k in h["keys"]], h["start_ts"])
            return {"ok": 1}, []
        if cmd == "acquire_lock":
            st.acquire_pessimistic_lock(
                [_ub(k) for k in h["keys"]], _ub(h["primary"]), h["start_ts"], h["for_update_ts"], h["wait_ms"]
            )
            return {"ok": 1}, []
        if cmd == "resolve_lock":
            st.resolve_lock(_ub(h["key"]), _lock_from_pb(h["lock"]))
            return {"ok": 1}, []
        if cmd == "detector_cleanup":
            st.detector.clean_up(h["start_ts"])
            return {"ok": 1}, []
        if cmd == "regions_in_ranges":
            ranges = [KeyRange(_ub(a), _ub(b)) for a, b in h["ranges"]]
            out = []
            for region, krs in st.pd.regions_in_ranges(ranges):
                out.append(
                    {
                        "id": region.region_id,
                        "start": _b(region.start),
                        "end": _b(region.end),
                        "ver": region.data_version,
                        "krs": [[_b(kr.start), _b(kr.end)] for kr in krs],
                    }
                )
            return {"regions": out}, []
        if cmd == "ingest":
            # bulk committed-row ingest (restore path): pairs ride one blob
            buf = blobs[0]
            keys, vals = [], []
            off = 0
            for _ in range(h["n"]):
                klen, vlen = struct.unpack_from("<IQ", buf, off)
                off += 12
                keys.append(buf[off : off + klen])
                off += klen
                vals.append(buf[off : off + vlen])
                off += vlen
            ts = st.ingest(keys, vals)
            return {"ts": ts}, []
        if cmd == "ingest_columnar":
            # the lightning-style columnar ingest crossing the process
            # boundary (ref: lightning local backend writing into TiKV)
            import numpy as _np

            from tidb_tpu_torch.expression.expr import _ft_from_pb
            from tidb_tpu_torch.kv.rowcodec import RowSchema
            from tidb_tpu_torch.utils.chunk import Dictionary

            n = h["n"]
            handles = _np.frombuffer(blobs[0], dtype=_np.int64).copy()
            cols = {}
            bi = 1
            for slot, dt in h["slots"]:
                data = _np.frombuffer(blobs[bi], dtype=_np.dtype(dt)).copy()
                valid = _np.frombuffer(blobs[bi + 1], dtype=_np.bool_).copy()
                cols[slot] = (data, valid)
                bi += 2
            dicts = {}
            for slot in h["dict_slots"]:
                buf = blobs[bi]
                bi += 1
                vals = []
                off = 0
                while off < len(buf):
                    (ln,) = struct.unpack_from("<I", buf, off)
                    off += 4
                    vals.append(buf[off : off + ln])
                    off += ln
                dicts[slot] = Dictionary(vals)
            schema = RowSchema([_ft_from_pb(f) for f in h["schema"]])
            ts = st.ingest_columnar(
                h["table_id"], handles[:n], cols, schema, dicts,
                on_existing=h.get("on_existing"),
            )
            return {"ts": ts}, []
        if cmd == "mpp_ndev":
            return {"ndev": self._mpp_mgr().ndev()}, []
        if cmd == "mpp_dispatch":
            # DispatchMPPTask analog (ref: kv/mpp.go:189): the gather spec
            # arrives as table ids + expression pbs; execution starts on a
            # worker thread against the LOCAL store + mesh. An incoming
            # trace context makes the task session record real spans that
            # ship home with the result (Dapper-style propagation).
            task_id = self._mpp_mgr().dispatch(h["spec"], h["read_ts"], trace=h.get("trace"))
            return {"task_id": task_id}, []
        if cmd == "mpp_conn":
            # EstablishMPPConns analog: long-poll for the merged result frame
            done, blob, kind, msg, warns, exec_pb, spans = self._mpp_mgr().conn(
                h["task_id"], h.get("wait_s", 1.0)
            )
            if not done:
                return {"done": 0}, []
            if kind:
                return {"done": 1, "err_kind": kind, "msg": msg}, []
            reply = {"done": 1, "warnings": warns}
            if exec_pb:
                reply["exec"] = exec_pb
            if spans:
                reply["spans"] = spans
            return reply, [blob]
        if cmd == "mpp_cancel":
            self._mpp_mgr().cancel(h["task_id"])
            return {"ok": 1}, []
        if cmd == "cop":
            # the coprocessor boundary: DAG in, chunk out (ref: Cop gRPC)
            from tidb_tpu_torch.copr import dagpb
            from tidb_tpu_torch.copr.client import _engines
            from tidb_tpu_torch.utils.chunk import encode_chunk

            dag = dagpb.DAGRequest.from_pb(h["dag"])
            region = next((r for r in st.regions() if r.region_id == h["region_id"]), None)
            if region is None:
                # typed region error, not Generic: the client re-resolves
                # routing and re-splits the task (ref: errorpb.RegionNotFound)
                return {"err": "RegionMiss", "region_id": h["region_id"]}, []
            ranges = [KeyRange(_ub(a), _ub(b)) for a, b in h["ranges"]]
            engine = _engines()[StoreType(h["store_type"])]
            # engine warnings ride the response header, the per-
            # SelectResponse warning carriage of the reference (tipb)
            warns: list = []
            # ExecDetails sidecar (ref: tipb ExecDetails inside every cop
            # response): store-side processing wall + the engines' device/
            # host/compile/transfer attribution, shipped home in the header.
            # A propagated trace context additionally opens REAL spans here
            # that travel back for the caller to graft into its trace.
            det = _ed.CopExecDetails(region_id=h["region_id"])
            tracer = None
            tctx = None
            if h.get("trace"):
                from tidb_tpu_torch.utils.tracing import TraceContext, Tracer

                tctx = TraceContext.from_pb(h["trace"])
            if tctx is not None and tctx.sampled:
                tracer = Tracer(trace_id=tctx.trace_id)
            t0 = time.perf_counter()
            with _ed.collecting(det, tracer=tracer):
                with _ed.trace_span(f"cop.r{h['region_id']}"):
                    chunk = engine(
                        st, dag, region, ranges, h["read_ts"],
                        warn=lambda lv, code, msg: len(warns) < 64 and warns.append([lv, code, msg]),
                    )
            det.proc_ms = (time.perf_counter() - t0) * 1000.0
            # store-side cop slow log: record the task into THIS process's
            # ring (digest per TABLE so repeats aggregate across regions and
            # shapes; the fleet reads it via sys_snapshot → cluster_slow_query)
            from tidb_tpu_torch import config as _config

            tid = dag.executors[0].table_id if dag.executors else 0
            text = f"cop table={tid} region={h['region_id']}"
            self.stmt_summary.record(
                text,
                det.proc_ms / 1000.0,
                len(chunk),
                user="store",
                slow_threshold_s=_config.current().store_slow_cop_ms / 1000.0,
                digest_val=f"cop:{tid}|cop table={tid}",
            )
            reply = {"ok": 1, "warnings": warns, "exec": det.to_pb()}
            if tracer is not None:
                reply["spans"] = tracer.to_pb()
            return reply, [encode_chunk(chunk)]
        raise ValueError(f"unknown command {cmd!r}")


class _RemoteTSO:
    def __init__(self, store: "RemoteStore"):
        self._store = store

    def ts(self) -> int:
        return self._store._call({"cmd": "tso"})[0]["ts"]


class _RemoteDetector:
    def __init__(self, store: "RemoteStore"):
        self._store = store

    def clean_up(self, start_ts: int) -> None:
        self._store._call({"cmd": "detector_cleanup", "start_ts": start_ts})


class _RemotePD:
    def __init__(self, store: "RemoteStore"):
        self._store = store

    def regions_in_ranges(self, ranges: Sequence[KeyRange]):
        h, _ = self._store._call(
            {"cmd": "regions_in_ranges", "ranges": [[_b(r.start), _b(r.end)] for r in ranges]}
        )
        out = []
        for r in h["regions"]:
            region = Region(r["id"], _ub(r["start"]), _ub(r["end"]))
            region.data_version = r["ver"]
            out.append((region, [KeyRange(_ub(a), _ub(b)) for a, b in r["krs"]]))
        return out


class _RemoteSnapshot:
    def __init__(self, store: "RemoteStore", ts: int):
        self._store = store
        self.read_ts = ts

    def get(self, key: bytes) -> Optional[bytes]:
        h, blobs = self._store._call({"cmd": "snap_get", "ts": self.read_ts, "key": _b(key)})
        return blobs[0] if h["hit"] else None

    def scan(self, kr: KeyRange, limit: int = 2**63, reverse: bool = False):
        h, blobs = self._store._call(
            {
                "cmd": "snap_scan",
                "ts": self.read_ts,
                "start": _b(kr.start),
                "end": _b(kr.end),
                "limit": min(limit, 2**62),
                "reverse": reverse,
            }
        )
        buf = blobs[0] if blobs else b""
        out = []
        off = 0
        for _ in range(h["n"]):
            klen, vlen = struct.unpack_from("<II", buf, off)
            off += 8
            out.append((buf[off : off + klen], buf[off + klen : off + klen + vlen]))
            off += klen + vlen
        return out


class _RemoteCopClient:
    """kv.Client over the wire: region split via the remote PD, one cop RPC
    per region task on a worker pool (ref: copr worker fan-out)."""

    def __init__(self, store: "RemoteStore"):
        self.store = store

    def send(self, req: Request):
        from tidb_tpu_torch.copr.client import CopResponse, CopResult, run_task_resilient
        from tidb_tpu_torch.utils.chunk import decode_chunk

        if req.tp != RequestType.DAG:
            raise ValueError(f"remote cop client handles DAG requests only, got {req.tp}")
        read_ts = req.start_ts or self.store.current_ts()
        tasks = list(self.store.pd.regions_in_ranges(req.ranges))
        if req.desc:
            tasks.reverse()
        if not tasks:
            return CopResponse(iter(()), None)
        dag_pb = req.data.to_pb()
        # per-region responses decode into fresh dictionaries; the gather
        # concatenates chunks, which requires SHARED dictionary objects —
        # unify codes per output column across this request's tasks
        from tidb_tpu_torch.types import TypeKind
        from tidb_tpu_torch.utils.chunk import Chunk, Column, Dictionary

        shared: dict[int, Dictionary] = {}
        share_mu = threading.Lock()

        def unify(chunk: Chunk) -> Chunk:
            import numpy as np

            cols = []
            for i, col in enumerate(chunk.columns):
                if col.ftype.kind == TypeKind.STRING and col.dictionary is not None:
                    with share_mu:
                        dic = shared.setdefault(i, Dictionary())
                        vals = col.dictionary.decode_many(col.data)
                        codes = np.fromiter(
                            (dic.encode(v) for v in vals), dtype=np.int32, count=len(vals)
                        )
                    cols.append(Column(codes, col.validity, col.ftype, dic))
                else:
                    cols.append(col)
            return Chunk(cols)

        # one retry budget for the whole fan-out (ref: copIterator handling
        # region errors under the request's Backoffer)
        bo = Backoffer(budget_ms=self.store._retry_budget_ms, seed=self.store._backoff_seed)
        store_addr = f"{self.store.host}:{self.store.port}"
        # the sampled=0 case: the id may exist for correlation but neither
        # side records spans (nor ships the header) — one rule, one home
        tracer = _tracing.effective(req.tracer)
        parent_span = tracer.current() if tracer is not None else None
        t_submit = time.perf_counter()

        def one_call(region_id, krs, store_type):
            hdr = {
                "cmd": "cop",
                "dag": dag_pb,
                "region_id": region_id,
                "ranges": [[_b(kr.start), _b(kr.end)] for kr in krs],
                "read_ts": read_ts,
                "store_type": store_type.value,
            }
            if tracer is not None:
                # trace-context propagation: the id travels out, the store
                # records spans under it and ships them back (see the server
                # cop handler); merge grafts them under this RPC's span
                hdr["trace"] = tracer.context().to_pb()
                with tracer.span(f"cop-rpc.r{region_id}", parent=parent_span) as sp:
                    h, blobs = self.store._call(hdr)
                if h.get("spans"):
                    tracer.merge_remote(
                        h["spans"], base_s=sp.start_s, node=store_addr, depth=sp.depth + 1
                    )
            else:
                h, blobs = self.store._call(hdr)
            d = _ed.current_cop()
            if d is not None and h.get("exec"):
                d.merge_pb(h["exec"])
            if req.warn is not None:
                for lv, code, msg in h.get("warnings", ()):
                    req.warn(lv, code, msg)
            return unify(decode_chunk(blobs[0]))

        def run_one(st, region, krs):
            return one_call(region.region_id, krs, st)

        from tidb_tpu_torch.utils.memory import QueryKilledError, QueryOOMError

        def run(item):
            ti, (region, krs) = item
            det = _ed.CopExecDetails(region.region_id, store=store_addr)
            det.queue_ms = (time.perf_counter() - t_submit) * 1000.0
            t0 = time.perf_counter()
            # server-side engine failures arrive as RuntimeError ("remote
            # store error: ..."): a CUDA error or a kernel build or launch
            # failure on the store's card fails the statement, as it does in
            # the embedded cop client — no task re-runs on the store's host
            # engine (the store itself answers the shapes the card does not
            # carry on its host engine, recorded as the task's degrade);
            # kill/quota verdicts arrive re-typed by _call and pass through
            with _ed.collecting(det, tracer=tracer):
                chunk = run_task_resilient(
                    bo,
                    run_one,
                    self.store.pd.regions_in_ranges,
                    region,
                    krs,
                    req.store_type,
                    warn=req.warn,
                    degrade_reason="remote",
                    degrade_on=(),
                    never_degrade=(QueryKilledError, QueryOOMError),
                    detail=det,
                    trace_id=tracer.trace_id if tracer is not None else None,
                )
            # proc_ms arrived from the server's sidecar; what remains of the
            # client-observed wall is wire + (de)serialization time
            wall = (time.perf_counter() - t0) * 1000.0
            det.wire_ms = max(wall - det.proc_ms - det.backoff_ms, 0.0)
            return CopResult(chunk, ti, region.region_id, det)

        items = list(enumerate(tasks))
        if req.concurrency <= 1 or len(items) == 1:
            return CopResponse((run(it) for it in items), None)
        # the process-wide cop pool (copr/client.py): worker threads and
        # their pooled per-thread sockets outlive individual queries; the
        # window caps THIS request at its own concurrency
        from tidb_tpu_torch.copr.client import shared_cop_pool, windowed_fanout

        window = min(max(req.concurrency, 1), len(items))
        it, cancel = windowed_fanout(shared_cop_pool(window), run, items, window)
        return CopResponse(it, cancel)


# The wire-verb replay registry. EVERY verb must appear in exactly one of
# these two sets — graftcheck's replay-registry rule cross-checks them
# against the server dispatcher and every client header, and the replay
# gate in RemoteStore._call is fail-closed (``cmd in REPLAYABLE``), so a
# new verb CANNOT silently default to replay-on-reconnect (the PR 1
# mpp_dispatch bug class: replaying a lost reply double-executed a gather).
#
# REPLAYABLE — safe to re-send after the server may have executed it:
# reads are pure; percolator prewrite/rollback/pessimistic_rollback/
# acquire_lock are idempotent under the same start_ts (re-prewrite rewrites
# the same lock); raw_put/raw_delete write the same value; owner/election/
# placement proposes re-assert the same record under the same fencing
# token; fence/unfence/purge/drop_stable are absorbing; migrate_region
# re-installs the same (key, commit_ts) versions; mpp_conn retains the
# final frame server-side precisely so a lost reply can be re-asked;
# mpp_cancel is the idempotent ack.
REPLAYABLE = frozenset(
    {
        "ping", "sys_snapshot", "log_search", "current_ts", "tso",
        "raw_get", "raw_put", "raw_delete", "raw_scan",
        "run_gc", "snap_get", "snap_batch_get", "snap_scan",
        "prewrite", "rollback", "pessimistic_rollback", "acquire_lock",
        "check_txn_status", "resolve_lock", "detector_cleanup",
        "drop_stable", "purge_table",
        "owner_campaign", "owner_of", "owner_resign", "owner_term",
        "election_propose", "election_read",
        "placement_propose", "placement_read",
        "fence_table", "unfence_table", "migrate_export", "migrate_region",
        "regions_in_ranges", "cop",
        "mpp_ndev", "mpp_conn", "mpp_cancel",
    }
)
# NON_REPLAYABLE — a replay after an unacked send could double-apply:
# ``commit`` is the 2PC safety case (UndeterminedError); ``raw_cas``
# replayed after a successful-but-unacked swap would misreport failure;
# the ingest verbs mint a fresh commit_ts per call, so a replay doubles
# the rows; ``mpp_dispatch`` mints a fresh task_id per call — replaying a
# lost reply would double-execute the gather and orphan the first task
# (retry belongs at the gather layer, which can cancel).
NON_REPLAYABLE = frozenset({"commit", "raw_cas", "ingest", "ingest_columnar", "mpp_dispatch"})


class RemoteStore:
    """kv.Storage whose every byte lives in a StoreServer process.

    Per-thread pooled connections (cop fan-out runs parallel region tasks).
    Transient wire failures are retried under a typed Backoffer: the
    connection re-dials with backoff and replay-safe verbs are re-sent
    transparently (ref: client-go Backoffer + RegionRequestSender retry).
    A commit that fails after it may have reached the store surfaces
    :class:`UndeterminedError` — the 2PC undetermined-result rule. A server
    that stays dead past the retry budget surfaces ConnectionError, which
    the session layers report like any region error."""

    def __init__(
        self,
        host: str,
        port: int,
        connect_timeout: Optional[float] = None,
        read_timeout: Optional[float] = None,
        retry_budget_ms: Optional[float] = None,
        backoff_seed: Optional[int] = None,
    ):
        from tidb_tpu_torch import config as _config

        dflt = _config.current()
        self.host, self.port = host, port
        self._timeout = connect_timeout if connect_timeout is not None else dflt.connect_timeout_s
        self._read_timeout = read_timeout if read_timeout is not None else dflt.read_timeout_s
        self._retry_budget_ms = retry_budget_ms if retry_budget_ms is not None else dflt.rpc_retry_budget_ms
        self._backoff_seed = backoff_seed
        self._local = threading.local()
        self.nonce = f"remote:{host}:{port}"
        self.tso = _RemoteTSO(self)
        self.detector = _RemoteDetector(self)
        self.pd = _RemotePD(self)
        # cop fan-out runs on the process-wide shared pool (copr/client.py):
        # its threads (and their pooled per-thread sockets) outlive both
        # individual queries and individual RemoteStore handles
        self._mpp_ndev: Optional[int] = None
        # fail fast on a bad endpoint: zero retry budget, so a dead/refused
        # address raises on the FIRST dial instead of looping out the full
        # boRPC budget (fleet assembly and liveness probes construct these)
        self._call({"cmd": "ping"}, budget_ms=0)

    # -- plumbing ----------------------------------------------------------
    def _conn(self) -> socket.socket:
        c = getattr(self._local, "conn", None)
        if c is None:
            c = socket.create_connection((self.host, self.port), timeout=self._timeout)
            # long deadline: first-query jit compiles + big scans legitimately
            # run minutes; a genuinely dead server still fails fast on connect
            c.settimeout(self._read_timeout)
            self._local.conn = c
        return c

    def _drop_conn(self) -> None:
        """Close the pooled connection so the next attempt re-dials. Closing
        matters even for INJECTED faults: the server may have executed the
        command and its reply is sitting in the socket — reusing the
        connection would desynchronize the frame stream."""
        c = getattr(self._local, "conn", None)
        self._local.conn = None
        if c is not None:
            try:
                c.close()
            except OSError:
                pass

    def _call(self, header: dict, blobs: Sequence[bytes] = (), *, budget_ms: Optional[float] = None):
        """One RPC with reconnect-and-replay under a per-request Backoffer.
        ``budget_ms`` overrides the store's retry budget for THIS call
        (0 = no retries, fail on the first wire error).

        Chaos failpoints (see kv/fault_injection.py wire helpers):
          - ``remote_send(cmd)`` fires BEFORE any byte hits the wire — a
            raised ConnectionError here is retriable for every verb.
          - ``remote_recv(cmd)`` fires after the request went out — raising
            simulates a lost reply: the server executed the command, the
            client never heard. Replay-safe verbs replay; commit surfaces
            UndeterminedError.
        """
        cmd = header["cmd"]
        # fail-closed: replay is an earned property — an undeclared verb is
        # treated as non-replayable (and fails the graftcheck registry scan)
        replayable = cmd in REPLAYABLE
        bo: Optional[Backoffer] = None
        while True:
            maybe_sent = False
            try:
                c = self._conn()
                failpoint.inject("remote_send", cmd)
                maybe_sent = True
                _send_frame(c, header, blobs)
                failpoint.inject("remote_recv", cmd)
                h, rblobs = _recv_frame(c)
                break
            except (ConnectionError, OSError) as e:
                self._drop_conn()
                if not replayable and maybe_sent:
                    if cmd == "commit":
                        raise UndeterminedError(
                            f"commit to store {self.host}:{self.port} failed after send "
                            f"({type(e).__name__}: {e}); transaction outcome UNDETERMINED — "
                            "not retried, not reported as aborted"
                        ) from e
                    raise ConnectionError(
                        f"non-replayable {cmd!r} to {self.host}:{self.port} failed after send: {e}"
                    ) from e
                if bo is None:
                    bo = Backoffer(
                        budget_ms=self._retry_budget_ms if budget_ms is None else budget_ms,
                        seed=self._backoff_seed,
                    )
                try:
                    slept = bo.backoff(boRPC, e)
                except BackoffExhausted as be:
                    raise ConnectionError(
                        f"store server {self.host}:{self.port} unreachable "
                        f"(gave up after {be.attempts} retries / {be.slept_ms:.0f}ms: {e})"
                    ) from e
                # wire-level retries charge the active cop task's sidecar
                # (one thread-local read when nothing is collecting)
                d = _ed.current_cop()
                if d is not None:
                    d.retries += 1
                    d.backoff_ms += slept
        err = h.get("err")
        if err == "KeyLocked":
            raise KeyLockedError(_ub(h["key"]), _lock_from_pb(h["lock"]))
        if err == "WriteConflict":
            raise WriteConflictError(_ub(h["key"]), h["conflict_ts"], h["start_ts"])
        if err == "TxnAborted":
            raise TxnAbortedError(h["msg"])
        if err == "RegionMiss":
            raise RegionError(h.get("region_id", -1))
        if err:
            kind = h.get("kind")
            if kind in ("QueryKilledError", "QueryOOMError"):
                # re-type the kill/quota verdicts (ref: mpp_conn's err_kind
                # mapping): the cop degrade path must see them typed, never
                # as a retriable-looking RuntimeError
                from tidb_tpu_torch.utils.memory import QueryKilledError, QueryOOMError

                cls = QueryKilledError if kind == "QueryKilledError" else QueryOOMError
                raise cls(f"remote store error: {h.get('msg', err)}")
            raise RuntimeError(f"remote store error: {h.get('msg', err)}")
        return h, rblobs

    # -- kv.Storage surface -------------------------------------------------
    def current_ts(self) -> int:
        return self._call({"cmd": "current_ts"})[0]["ts"]

    def raw_get(self, key: bytes) -> Optional[bytes]:
        h, blobs = self._call({"cmd": "raw_get", "key": _b(key)})
        return blobs[0] if h["hit"] else None

    def raw_put(self, key: bytes, value: bytes) -> None:
        self._call({"cmd": "raw_put", "key": _b(key)}, [value])

    def raw_delete(self, key: bytes) -> None:
        self._call({"cmd": "raw_delete", "key": _b(key)})

    def raw_cas(self, key: bytes, expected, value: bytes) -> bool:
        blobs = ([expected] if expected is not None else []) + [value]
        h, _ = self._call(
            {"cmd": "raw_cas", "key": _b(key), "has_expected": expected is not None}, blobs
        )
        return bool(h["ok"])

    def raw_scan(self, kr: KeyRange, limit: int = 2**62):
        h, blobs = self._call(
            {"cmd": "raw_scan", "start": _b(kr.start), "end": _b(kr.end), "limit": min(limit, 2**62)}
        )
        buf = blobs[0] if blobs else b""
        out = []
        off = 0
        for _ in range(h["n"]):
            klen, vlen = struct.unpack_from("<II", buf, off)
            off += 8
            out.append((buf[off : off + klen], buf[off + klen : off + klen + vlen]))
            off += klen + vlen
        return out

    def sys_snapshot(self, hist=None, sections=None) -> dict:
        """The store's introspection report (see ``sys_report``): one
        replay-safe RPC under the usual boRPC Backoffer. ``hist`` attaches
        the store's metrics-history rings (True = all, str = one metric);
        ``sections`` selects the heavy report parts (None = all)."""
        h, _ = self._call(
            {
                "cmd": "sys_snapshot",
                "hist": hist if isinstance(hist, str) else (1 if hist else 0),
                "sections": None if sections is None else list(sections),
            }
        )
        return h["report"]

    def log_search(
        self,
        since=None,
        until=None,
        min_level: int = 0,
        component=None,
        pattern=None,
        limit: int = 256,
    ) -> list:
        """Search the SERVER process's structured event log — filters ship
        in the header and apply store-side, so at most ``limit`` rows cross
        the wire. Replay-safe (a pure read). → [[ts, level, component,
        event, fields, trace_id], ...] oldest-first."""
        h, _ = self._call(
            {
                "cmd": "log_search",
                "since": since,
                "until": until,
                "min_level": min_level,
                "component": component,
                "pattern": pattern,
                "limit": limit,
            }
        )
        return h["rows"]

    def run_gc(self, safe_point=None, life_ms: int = 600_000):
        """MVCC GC runs where the data lives — proxied to the server.
        Returns (pruned, safe_point) so callers can expire recoverables."""
        h, _ = self._call({"cmd": "run_gc", "safe_point": safe_point, "life_ms": life_ms})
        return h["pruned"], h.get("safe_point", 0)

    def get_snapshot(self, ts: int) -> _RemoteSnapshot:
        return _RemoteSnapshot(self, ts)

    def snap_batch_get(self, pairs) -> list:
        """Batched snapshot point reads: ``[(read_ts, key)]`` →
        ``[bytes | None | KeyLockedError]``. ONE replay-safe RPC instead of
        one per key — the wire half of the cross-session point-get batcher
        (N sessions pay one round trip + one store dispatch)."""
        if not pairs:
            return []
        h, blobs = self._call(
            {"cmd": "snap_batch_get", "gets": [[ts, _b(k)] for ts, k in pairs]}
        )
        out: list = []
        bi = 0
        for r in h["gets"]:
            if r.get("err") == "KeyLocked":
                out.append(KeyLockedError(_ub(r["key"]), _lock_from_pb(r["lock"])))
            elif r.get("hit"):
                out.append(blobs[bi])
                bi += 1
            else:
                out.append(None)
        return out

    def begin(self):
        from tidb_tpu_torch.kv.txn import Txn

        return Txn(self)

    def get_client(self) -> _RemoteCopClient:
        return _RemoteCopClient(self)

    # -- bulk ingest (ref: lightning local backend → TiKV ingest RPCs) -----
    def ingest(self, keys: Sequence[bytes], values: Sequence[bytes]) -> int:
        buf = bytearray()
        for k, v in zip(keys, values):
            buf += struct.pack("<IQ", len(k), len(v)) + k + v
        h, _ = self._call({"cmd": "ingest", "n": len(keys)}, [bytes(buf)])
        return h["ts"]

    def ingest_columnar(self, table_id: int, handles, cols: dict, schema, dicts=None, on_existing: str | None = None) -> int:
        import numpy as np

        from tidb_tpu_torch.expression.expr import _ft_pb

        handles = np.ascontiguousarray(np.asarray(handles, dtype=np.int64))
        blobs = [handles.tobytes()]
        slots = []
        for slot, (data, valid) in cols.items():
            data = np.ascontiguousarray(data)
            slots.append([slot, data.dtype.str])
            blobs.append(data.tobytes())
            blobs.append(np.ascontiguousarray(valid, dtype=np.bool_).tobytes())
        dict_slots = []
        for slot, dic in (dicts or {}).items():
            dict_slots.append(slot)
            buf = bytearray()
            for v in dic._values:
                buf += struct.pack("<I", len(v)) + v
            blobs.append(bytes(buf))
        h, _ = self._call(
            {
                "cmd": "ingest_columnar",
                "table_id": table_id,
                "on_existing": on_existing,
                "n": len(handles),
                "slots": slots,
                "dict_slots": dict_slots,
                "schema": [_ft_pb(f) for f in schema.ftypes],
            },
            blobs,
        )
        return h["ts"]

    # -- MPP dispatch (ref: kv/mpp.go DispatchMPPTask/EstablishMPPConns) ----
    def mpp_ndev(self) -> int:
        """Mesh size of the server's device mesh — the remote planner's
        exchange-cost model needs the REAL ndev, not this process's."""
        if self._mpp_ndev is None:
            self._mpp_ndev = int(self._call({"cmd": "mpp_ndev"})[0]["ndev"])
        return self._mpp_ndev

    def mpp_dispatch(self, spec: dict, read_ts: int, trace: Optional[dict] = None) -> str:
        hdr = {"cmd": "mpp_dispatch", "spec": spec, "read_ts": read_ts}
        if trace:
            hdr["trace"] = trace
        h, _ = self._call(hdr)
        return h["task_id"]

    def mpp_conn(self, task_id: str, check_killed=None, warn=None, on_exec=None):
        """Block until the task's merged chunk arrives (long-poll loop so a
        client-side KILL propagates as mpp_cancel). Raises the task's error
        with its original kind when the server reports one. ``on_exec(exec,
        spans)`` receives the server's MPP exec-details sidecar + any spans
        it recorded under a propagated trace context."""
        while True:
            h, blobs = self._call({"cmd": "mpp_conn", "task_id": task_id, "wait_s": 1.0})
            if h["done"]:
                break
            if check_killed is not None:
                try:
                    check_killed()
                except BaseException:
                    try:
                        self._call({"cmd": "mpp_cancel", "task_id": task_id})
                    except ConnectionError:
                        pass
                    raise
        # ack: the final frame is safely client-side — release the server's
        # retained copy now (it is kept after collection only so a LOST
        # final frame can be replayed; mpp_cancel is the idempotent ack)
        try:
            self._call({"cmd": "mpp_cancel", "task_id": task_id})
        except ConnectionError:
            pass  # the server's dispatch-time sweep reclaims it
        if h.get("err_kind"):
            from tidb_tpu_torch.parallel.probe import MPPRetryExhausted, MPPTaskLostError
            from tidb_tpu_torch.utils.memory import QueryKilledError, QueryOOMError

            if h["err_kind"] == "RegionError":
                # the server's gather hit a placement fence (the table moved
                # mid-dispatch): typed so the gather re-resolves placement
                # and re-dispatches to the new owner (kv/placement.py)
                raise RegionError(-1, f"remote mpp task failed: {h['msg']}")
            kinds = {
                "MPPRetryExhausted": MPPRetryExhausted,
                # the server no longer knows this task (it restarted between
                # dispatch and conn): the gather re-dispatches — the
                # client-go mpp_probe lost-task recovery idiom
                "MPPTaskLost": MPPTaskLostError,
                "QueryKilledError": QueryKilledError,
                "QueryOOMError": QueryOOMError,
            }
            raise kinds.get(h["err_kind"], RuntimeError)(
                f"remote mpp task failed: {h['msg']}"
            )
        from tidb_tpu_torch.utils.chunk import decode_chunk

        if warn is not None:
            for lv, code, msg in h.get("warnings", ()):
                warn(lv, code, msg)
        if on_exec is not None:
            on_exec(h.get("exec"), h.get("spans"))
        return decode_chunk(blobs[0])

    def mpp_cancel(self, task_id: str) -> None:
        self._call({"cmd": "mpp_cancel", "task_id": task_id})

    def drop_stable(self, table_id: int) -> None:
        """Discard a table's stable columnar blocks (reorg DDL rewrote the
        rows into the delta layer server-side)."""
        self._call({"cmd": "drop_stable", "table_id": table_id})

    # -- owner election: the store process is the etcd analog ----------------
    def owner_campaign(
        self, key: str, node_id: str, lease_s: Optional[float] = None, term: Optional[int] = None
    ) -> bool:
        h, _ = self._call(
            {"cmd": "owner_campaign", "key": key, "node_id": node_id, "lease_s": lease_s, "term": term}
        )
        return bool(h["ok"])

    def owner_of(self, key: str):
        return self._call({"cmd": "owner_of", "key": key})[0]["owner"]

    def owner_resign(self, key: str, node_id: str) -> None:
        self._call({"cmd": "owner_resign", "key": key, "node_id": node_id})

    def owner_term(self, key: str) -> int:
        return self._call({"cmd": "owner_term", "key": key})[0]["term"]

    # -- quorum placement replica verbs + region-move verbs (kv/placement.py:
    # this server hosts one replica of the fleet's placement keyspace and
    # serves region migration; every verb here is replay-safe — proposes and
    # applies are idempotent, exports and fences are pure/absorbing) --------
    def placement_propose(self, table_id: int, shard: int, epoch: int):
        h, _ = self._call(
            {"cmd": "placement_propose", "tid": table_id, "shard": shard, "epoch": epoch}
        )
        return bool(h["ok"]), h["epoch"]

    def placement_read(self, table_id: Optional[int] = None):
        if table_id is None:
            h, _ = self._call({"cmd": "placement_read", "tid": None})
            return [(tid, e, s) for tid, e, s in h["recs"]]
        h, _ = self._call({"cmd": "placement_read", "tid": table_id})
        return h["epoch"], h["shard"]

    def fence_table(self, table_id: int, ttl_s: Optional[float] = None) -> None:
        self._call({"cmd": "fence_table", "tid": table_id, "ttl_s": ttl_s})

    def unfence_table(self, table_id: int) -> None:
        self._call({"cmd": "unfence_table", "tid": table_id})

    def migrate_export(self, table_id: int, after_ts: int = 0, upto_ts: Optional[int] = None,
                       cursor=None, limit: int = 4096, include_locks: bool = False) -> dict:
        h, blobs = self._call(
            {
                "cmd": "migrate_export", "tid": table_id, "after_ts": after_ts,
                "upto_ts": upto_ts, "cursor": _cursor_pb(cursor), "limit": limit,
                "locks": int(include_locks),
            }
        )
        return {
            "items": _migrate_items_unpack(blobs[0]) if blobs else [],
            "locks": [(_ub(k), _lock_from_pb(l)) for k, l in h.get("locks", ())],
            "cursor": _cursor_from_pb(h.get("cursor")),
        }

    def migrate_apply(self, items, locks=()) -> int:
        h, _ = self._call(
            {"cmd": "migrate_region", "locks": [[_b(k), _lock_pb(l)] for k, l in locks]},
            [_migrate_items_blob(items)],
        )
        return h["applied"]

    def purge_table(self, table_id: int) -> None:
        self._call({"cmd": "purge_table", "tid": table_id})

    # -- quorum election replica verbs (kv/election.py: this server hosts one
    # replica of the fleet's election keyspace; both verbs are replay-safe) --
    def election_propose(self, key: str, node_id: str, term: int, deadline: float):
        h, _ = self._call(
            {"cmd": "election_propose", "key": key, "node_id": node_id, "term": term, "deadline": deadline}
        )
        return bool(h["ok"]), h["term"]

    def election_read(self, key: str):
        h, _ = self._call({"cmd": "election_read", "key": key})
        return h["term"], h["owner"], h["deadline"]

    # -- percolator verbs (ref: unistore mvcc server surface) ---------------
    def check_txn_status(self, primary: bytes, start_ts: int):
        """→ ("committed"|"rolled_back"|"locked", commit_ts) — the cross-
        store lock-resolution primitive (ref: kvproto CheckTxnStatus)."""
        h, _ = self._call({"cmd": "check_txn_status", "primary": _b(primary), "start_ts": start_ts})
        return h["status"], h["commit_ts"]

    def prewrite(self, mutations: Sequence[Mutation], primary: bytes, start_ts: int) -> dict:
        buf = bytearray()
        for m in mutations:
            buf += bytes([0 if m.op == OP_PUT else 1])
            buf += struct.pack("<I", len(m.key)) + m.key
            buf += struct.pack("<Q", len(m.value)) + m.value
        h, _ = self._call({"cmd": "prewrite", "primary": _b(primary), "start_ts": start_ts}, [bytes(buf)])
        return {"keys": int(h.get("keys", 0)), "bytes": int(h.get("bytes", 0))}

    def commit(self, keys: Sequence[bytes], start_ts: int, commit_ts: int) -> dict:
        h, _ = self._call({"cmd": "commit", "keys": [_b(k) for k in keys], "start_ts": start_ts, "commit_ts": commit_ts})
        return {"keys": int(h.get("keys", 0)), "bytes": int(h.get("bytes", 0))}

    def rollback(self, keys: Sequence[bytes], start_ts: int) -> None:
        self._call({"cmd": "rollback", "keys": [_b(k) for k in keys], "start_ts": start_ts})

    def pessimistic_rollback(self, keys: Sequence[bytes], start_ts: int) -> None:
        self._call({"cmd": "pessimistic_rollback", "keys": [_b(k) for k in keys], "start_ts": start_ts})

    def acquire_pessimistic_lock(
        self, keys: Sequence[bytes], primary: bytes, start_ts: int, for_update_ts: int, wait_timeout_ms: int = 3000
    ) -> None:
        self._call(
            {
                "cmd": "acquire_lock",
                "keys": [_b(k) for k in keys],
                "primary": _b(primary),
                "start_ts": start_ts,
                "for_update_ts": for_update_ts,
                "wait_ms": wait_timeout_ms,
            }
        )

    def resolve_lock(self, key: bytes, lock: Lock) -> None:
        self._call({"cmd": "resolve_lock", "key": _b(key), "lock": _lock_pb(lock)})
