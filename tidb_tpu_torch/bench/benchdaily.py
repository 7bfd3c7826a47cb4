"""benchdaily: registered micro-benchmarks serialized to JSON for trend
tracking (ref: pkg/util/benchdaily/bench_daily.go — the daily-regression
harness CI feeds from).

    python -m tidb_tpu_torch.bench.benchdaily --out bench_daily.json
    python -m tidb_tpu_torch.bench.benchdaily --check yesterday.json   # regression guard
    python -m tidb_tpu_torch.bench.benchdaily --device cpu --only BenchmarkPointGet

Every lane opens its databases and stores on ``--device`` (``DEVICE``;
default ``cuda``): with no card a lane raises at its first device task and
never runs on the CPU unasked. The scaling lanes run one shard per card up
to the card count on a machine with several cards, and virtual shards of
the one card otherwise (``_scaling_curve``).

Two metric kinds: throughput benches record ``ops_per_sec`` (higher is
better); benches whose registered name ends in ``_ms`` record ``ms``
latency (lower is better). ``--check`` compares against a previous JSON and
exits non-zero past ``--tolerance`` — the guard that would have caught the
q3_join_mpp_ms 161.6→207.6 ms drift VERDICT round 5 flagged."""

from __future__ import annotations

import argparse
import datetime
import json
import time
from typing import Callable

_BENCHES: dict[str, Callable[[], float]] = {}

# the device every lane's databases and stores run their device work on
# ("cuda", "cuda:N" or "cpu"); main() sets it from --device
DEVICE = "cuda"

# the last curve of each scaling lane: {name: {"cards", "gate",
# "rows_per_s": {width: rows/s}}}, written before the lane's gates
SCALING_CURVES: dict[str, dict] = {}


def _on_device(store):
    """``store`` with the lanes' device on it, as ``open_db`` sets it."""
    store.device = DEVICE
    return store


def register(name: str):
    def deco(fn):
        _BENCHES[name] = fn
        return fn

    return deco


def _time_ops(fn, n: int) -> float:
    t0 = time.perf_counter()
    fn()
    dt = time.perf_counter() - t0
    return n / dt if dt > 0 else float("inf")


@register("BenchmarkBulkLoad")
def bench_bulk_load() -> float:
    import numpy as np

    import tidb_tpu_torch
    from tidb_tpu_torch.executor.load import bulk_load

    db = tidb_tpu_torch.open(device=DEVICE)
    db.execute("CREATE TABLE b (id BIGINT PRIMARY KEY, v BIGINT, s VARCHAR(16))")
    n = 200_000
    cols = [
        np.arange(n, dtype=np.int64),
        np.arange(n, dtype=np.int64) * 2,
        [b"abcdefgh"] * n,
    ]
    return _time_ops(lambda: bulk_load(db, "b", cols), n)


@register("BenchmarkPointGet")
def bench_point_get() -> float:
    import tidb_tpu_torch

    db = tidb_tpu_torch.open(device=DEVICE)
    db.execute("CREATE TABLE p (id BIGINT PRIMARY KEY, v BIGINT)")
    db.execute("INSERT INTO p VALUES " + ",".join(f"({i},{i})" for i in range(1000)))
    s = db.session()
    n = 2000

    def run():
        for i in range(n):
            s.query(f"SELECT v FROM p WHERE id = {i % 1000}")

    return _time_ops(run, n)


@register("BenchmarkHostAggQ1")
def bench_host_agg() -> float:
    import numpy as np

    import tidb_tpu_torch
    from tidb_tpu_torch.executor.load import bulk_load

    db = tidb_tpu_torch.open(device=DEVICE)
    db.execute("CREATE TABLE a (id BIGINT PRIMARY KEY, g BIGINT, v BIGINT)")
    n = 200_000
    rng = np.random.default_rng(0)
    bulk_load(db, "a", [np.arange(n, dtype=np.int64), rng.integers(0, 5, n), rng.integers(0, 1000, n)])
    s = db.session()
    s.execute("SET tidb_isolation_read_engines = 'host'")

    def run():
        for _ in range(5):
            s.query("SELECT g, COUNT(*), SUM(v) FROM a GROUP BY g")

    return _time_ops(run, 5 * n)


@register("BenchmarkChunkCodec")
def bench_chunk_codec() -> float:
    import numpy as np

    from tidb_tpu_torch.types.field_type import bigint_type
    from tidb_tpu_torch.utils.chunk import Chunk, Column, decode_chunk, encode_chunk

    n = 500_000
    ch = Chunk([Column(np.arange(n, dtype=np.int64), np.ones(n, bool), bigint_type())] * 4)

    def run():
        for _ in range(10):
            decode_chunk(encode_chunk(ch))

    return _time_ops(run, 10 * n)


@register("q3_join_mpp_ms")
def bench_q3_join_mpp() -> float:
    """Q3-shaped MPP join latency (ms, lower is better) — the metric whose
    161.6→207.6 ms drift slipped through round 5 unguarded."""
    import time as _t

    import numpy as np

    import tidb_tpu_torch
    from tidb_tpu_torch.executor.load import bulk_load

    db = tidb_tpu_torch.open(device=DEVICE)
    db.execute("CREATE TABLE q3o (o_orderkey BIGINT PRIMARY KEY, o_odate BIGINT)")
    db.execute("CREATE TABLE q3l (l_orderkey BIGINT, l_price BIGINT)")
    rng = np.random.default_rng(3)
    n_o, n_l = 5_000, 50_000
    bulk_load(db, "q3o", [np.arange(n_o, dtype=np.int64), 8000 + rng.integers(0, 30, n_o)])
    bulk_load(db, "q3l", [rng.integers(0, n_o, n_l), rng.integers(100, 10_000, n_l)])
    s = db.session()
    s.execute("ANALYZE TABLE q3o")
    s.execute("ANALYZE TABLE q3l")
    s.execute("SET tidb_enforce_mpp = 1")
    q = (
        "SELECT o_odate, SUM(l_price) FROM q3l, q3o "
        "WHERE l_orderkey = o_orderkey GROUP BY o_odate ORDER BY o_odate"
    )
    s.query(q)  # warm: compile cache paid outside the measurement
    best = float("inf")
    for _ in range(3):
        t0 = _t.perf_counter()
        s.query(q)
        best = min(best, (_t.perf_counter() - t0) * 1000)
    return best


@register("q17_subquery_mpp_ms")
def bench_q17_subquery_mpp() -> float:
    """Q17-shaped correlated-aggregate MPP latency (ms, lower is better):
    ``l_qty < 0.2 * AVG per part`` decorrelates into an agg-over-join whose
    build side is the materialized per-key aggregate and whose comparison
    runs as a post-join chain filter inside the fragment — the join-heavy
    TPC-H tier this lane keeps honest (warm: program + device lanes
    resident)."""
    import time as _t

    import numpy as np

    import tidb_tpu_torch
    from tidb_tpu_torch.executor.load import bulk_load

    db = tidb_tpu_torch.open(region_split_keys=1 << 62, device=DEVICE)
    db.execute("CREATE TABLE q17l (l_partkey BIGINT, l_qty BIGINT, l_price BIGINT)")
    db.execute("CREATE TABLE q17p (p_partkey BIGINT PRIMARY KEY, p_brand BIGINT)")
    rng = np.random.default_rng(17)
    n_l, n_p = 50_000, 2_000
    bulk_load(db, "q17l", [rng.integers(0, n_p, n_l), rng.integers(1, 50, n_l),
                           rng.integers(100, 10_000, n_l)])
    bulk_load(db, "q17p", [np.arange(n_p, dtype=np.int64), rng.integers(0, 9, n_p)])
    s = db.session()
    s.execute("ANALYZE TABLE q17l")
    s.execute("ANALYZE TABLE q17p")
    q = (
        "SELECT SUM(l_price) FROM q17l, q17p WHERE p_partkey = l_partkey "
        "AND p_brand = 3 AND l_qty < (SELECT 0.2 * AVG(l_qty) FROM q17l WHERE l_partkey = p_partkey)"
    )
    plan = "\n".join(str(r[0]) for r in s.query("EXPLAIN " + q))
    if "fragments" not in plan:  # never inside an assert (python -O)
        raise RuntimeError(f"q17 shape fell off the MPP path:\n{plan}")
    s.query(q)  # warm: compile + subplan materialization cache paid
    best = float("inf")
    for _ in range(3):
        t0 = _t.perf_counter()
        s.query(q)
        best = min(best, (_t.perf_counter() - t0) * 1000)
    return best


@register("mpp_program_reuse_ms")
def bench_mpp_program_reuse() -> float:
    """Warm-shape CROSS-QUERY program reuse (ms, lower is better): after a
    Q3-shaped gather compiles on one table pair, the SAME shape over a
    DIFFERENT table pair at a different (same power-of-two bucket) size must
    ride the cached fragment program — the lane times that first cross-query
    execution and HARD-FAILS if it compiled a new program (the
    tidb_tpu_mpp_program_cache_total counter must not record a miss)."""
    import time as _t

    import numpy as np

    import tidb_tpu_torch
    from tidb_tpu_torch.executor.load import bulk_load
    from tidb_tpu_torch.utils import metrics as _m

    db = tidb_tpu_torch.open(region_split_keys=1 << 62, device=DEVICE)
    rng = np.random.default_rng(33)
    for t, (n_o, n_l) in (("a", (4_000, 40_000)), ("b", (3_000, 36_000))):
        db.execute(f"CREATE TABLE ro_{t} (o_orderkey BIGINT PRIMARY KEY, o_odate BIGINT)")
        db.execute(f"CREATE TABLE rl_{t} (l_orderkey BIGINT, l_price BIGINT)")
        bulk_load(db, f"ro_{t}", [np.arange(n_o, dtype=np.int64), 8000 + rng.integers(0, 30, n_o)])
        bulk_load(db, f"rl_{t}", [rng.integers(0, n_o, n_l), rng.integers(100, 10_000, n_l)])
        db.execute(f"ANALYZE TABLE ro_{t}")
        db.execute(f"ANALYZE TABLE rl_{t}")
    s = db.session()
    s.execute("SET tidb_enforce_mpp = 1")

    def q(t):
        return (
            f"SELECT o_odate, SUM(l_price) FROM rl_{t}, ro_{t} "
            f"WHERE l_orderkey = o_orderkey GROUP BY o_odate ORDER BY o_odate"
        )

    s.query(q("a"))  # pays the one compile for the shape
    miss0 = _m.MPP_PROGRAM_CACHE.get(result="miss")
    t0 = _t.perf_counter()
    s.query(q("b"))  # different tables, different size, same bucketed shape
    dt_ms = (_t.perf_counter() - t0) * 1000
    missed = _m.MPP_PROGRAM_CACHE.get(result="miss") - miss0
    if missed:  # never inside an assert (python -O)
        raise RuntimeError(f"cross-query shape reuse broke: {missed} program compiles")
    return dt_ms


def _warm_count_best(table: str, region_split_keys: "int | None" = None, setup_sql: "list | None" = None) -> float:
    """Best-of-30 warm ``SELECT COUNT(*)`` latency over a fresh 10k-row
    table — the shared harness of the fixed-cost lanes below.
    ``setup_sql``: session knobs applied before warming (e.g. a sampling
    rate for the traced lane)."""
    import time as _t

    import numpy as np

    import tidb_tpu_torch
    from tidb_tpu_torch.executor.load import bulk_load

    db = tidb_tpu_torch.open(**({"region_split_keys": region_split_keys} if region_split_keys else {}), device=DEVICE)
    db.execute(f"CREATE TABLE {table} (id BIGINT PRIMARY KEY, v BIGINT)")
    n = 10_000
    bulk_load(db, table, [np.arange(n, dtype=np.int64), np.arange(n, dtype=np.int64)])
    s = db.session()
    for stmt in setup_sql or ():
        s.execute(stmt)
    q = f"SELECT COUNT(*) FROM {table}"
    s.query(q)
    s.query(q)  # warm: statement + plan + engine caches
    best = float("inf")
    for _ in range(30):
        t0 = _t.perf_counter()
        s.query(q)
        best = min(best, (_t.perf_counter() - t0) * 1000)
    return best


@register("fixed_overhead_ms")
def bench_fixed_overhead() -> float:
    """Warm COUNT(*) end-to-end latency (ms, lower is better): near-zero
    engine compute, so this IS the per-query SQL-layer tax — parse, plan,
    dispatch, accounting. The statement fast lane (parse/plan reuse, shared
    cop pool, memoized digest) exists to drive this down; the guard keeps
    later PRs from quietly re-adding fixed cost."""
    return _warm_count_best("fo")


@register("trace_off_overhead_ms")
def bench_trace_off_overhead() -> float:
    """Warm MULTI-REGION COUNT(*) with tracing disabled (ms, lower is
    better): the exec-details sidecar pipeline rides every cop task even
    when TRACE is off, so this lane times exactly the path instrumentation
    could re-tax — several region tasks per statement, sidecar allocation +
    aggregation included, spans strictly absent. Guarded next to PR 3's
    ``fixed_overhead_ms`` (single-region) under the same --check gate, so
    observability can never quietly re-add fixed cost to the hot path."""
    return _warm_count_best("tof", region_split_keys=2000)


@register("trace_sampled_overhead_ms")
def bench_trace_sampled_overhead() -> float:
    """Warm multi-region COUNT(*) with EVERY statement trace-sampled (ms,
    lower is better): the worst-case cost of the always-on sampled tracer —
    span recording on each cop task, the statement root span, and the
    reservoir deposit. GWP's rule that an always-on profiler needs an
    ENFORCED overhead budget, not a hoped-for one: this lane sits under the
    same --check gate as ``trace_off_overhead_ms`` so the sampled path's tax
    is measured and guarded, while the off lane proves rate-0 stays free."""
    return _warm_count_best(
        "tson", region_split_keys=2000,
        setup_sql=["SET tidb_tpu_trace_sample_rate = 1"],
    )


@register("graftcheck_runtime_overhead_ms")
def bench_lockcheck_overhead() -> float:
    """Warm COUNT(*) latency (ms, lower is better) with the runtime
    lock-order detector (utils/lockcheck, TIDB_TPU_LOCKCHECK=1) ACTIVE —
    the always-on cost of running tier-1 as a standing deadlock-freedom
    proof. When this lane starts from an uninstrumented process (the
    standalone benchdaily run) it first measures the plain path and
    HARD-FAILS if instrumentation costs more than 5% (+0.15 ms timer
    grace) on the warm fixed-overhead path — the same enforced-budget rule
    the tracing lanes follow (an unbudgeted checker quietly becomes the
    regression it exists to catch). Under tier-1 the process is already
    instrumented, so the lane just records the instrumented latency for
    the --check trend gate."""
    from tidb_tpu_torch.utils import lockcheck

    pre_installed = lockcheck.installed()
    plain = None if pre_installed else _warm_count_best("gco_plain")
    lockcheck.install(force=True)
    try:
        # a FRESH db/session so its locks are created post-instrumentation
        inst = _warm_count_best("gco_inst")
    finally:
        if not pre_installed:
            lockcheck.uninstall()
    if plain is not None and inst > plain * 1.05 + 0.15:
        raise RuntimeError(
            f"lockcheck overhead breached the 5% budget: plain {plain:.3f}ms "
            f"-> instrumented {inst:.3f}ms"
        )
    return inst


@register("log_overhead_ms")
def bench_log_overhead() -> float:
    """Warm multi-region COUNT(*) with the structured event log at its
    default ``info`` floor (ms, lower is better), HARD-FAILED against the
    same query with the log OFF when the gap breaches 5% (+0.15 ms timer
    grace) — the enforced-budget rule the tracing and lockcheck lanes
    follow. The ``on(level)`` gate is two loads + a compare and the hot
    query path emits nothing at info, so this lane should sit within noise
    of ``trace_off_overhead_ms``; any drift means an instrumented seam
    started allocating on the fast path."""
    from tidb_tpu_torch.utils import eventlog as _ev

    prev = _ev.min_level()
    _ev.set_level(_ev.OFF)
    try:
        off = _warm_count_best("lgo_off", region_split_keys=2000)
    finally:
        _ev.set_level(prev)
    _ev.set_level("info")
    try:
        on = _warm_count_best("lgo_on", region_split_keys=2000)
    finally:
        _ev.set_level(prev)
    if on > off * 1.05 + 0.15:
        raise RuntimeError(
            f"event-log overhead breached the 5% budget: off {off:.3f}ms "
            f"-> info {on:.3f}ms"
        )
    return on


@register("metering_overhead_ms")
def bench_metering_overhead() -> float:
    """Warm multi-region COUNT(*) with workload attribution ON (ms, lower is
    better) — per-statement ResourceUsage assembly, the RU fold into the
    session's resource group, AND the store-side keyspace traffic rings —
    HARD-FAILED against the same query with both switched off
    (``METERING_ENABLED = False``, ``keyviz-interval-s = 0``) when the gap
    breaches 5% (+0.15 ms timer grace). Same enforced-budget rule as the
    tracing/lockcheck/eventlog lanes: always-on accounting that taxes every
    statement is exactly the regression it exists to attribute."""
    import dataclasses

    from tidb_tpu_torch import config as _config
    from tidb_tpu_torch.resourcegroup import groups as _rg

    prev_cfg = _config.current()
    prev_on = _rg.METERING_ENABLED
    _rg.METERING_ENABLED = False
    # fresh stores built inside _warm_count_best read config.current() at
    # TrafficStats construction, so interval 0 yields disabled rings
    _config.set_current(dataclasses.replace(prev_cfg, keyviz_interval_s=0.0))
    try:
        off = _warm_count_best("mto_off", region_split_keys=2000)
    finally:
        _rg.METERING_ENABLED = prev_on
        _config.set_current(prev_cfg)
    on = _warm_count_best("mto_on", region_split_keys=2000)
    if on > off * 1.05 + 0.15:
        raise RuntimeError(
            f"metering overhead breached the 5% budget: off {off:.3f}ms "
            f"-> metered {on:.3f}ms"
        )
    return on


@register("qps_point_select")
def bench_qps_point_select() -> float:
    """Concurrent point-select throughput (ops/s, higher is better): N
    threads × N sessions EXECUTE a prepared ``pk = ?`` with rotating
    parameters against one DB — the serving shape the value-agnostic
    prepared-plan cache and the shared cop pool exist for."""
    import tidb_tpu_torch
    from tidb_tpu_torch.bench.qps import concurrent_qps

    db = tidb_tpu_torch.open(device=DEVICE)
    db.execute("CREATE TABLE qp (id BIGINT PRIMARY KEY, v BIGINT)")
    db.execute("INSERT INTO qp VALUES " + ",".join(f"({i},{i * 3})" for i in range(500)))

    def setup(s, i):
        s.prepare("SELECT v FROM qp WHERE id = ?", name="pt")
        s.execute_prepared("pt", [i])  # warm per-session caches

    def worker(s, i, k):
        rows = s.execute_prepared("pt", [(i * 131 + k) % 500]).rows
        if len(rows) != 1:  # never inside an assert: python -O strips it
            raise RuntimeError(f"point select returned {len(rows)} rows")

    return concurrent_qps(db, worker, 4, 250, setup=setup)


@register("qps_point_select_cold")
def bench_qps_point_select_cold() -> float:
    """COLD-session point-select throughput (ops/s, higher is better): a
    FRESH session per query over text SQL — the short-lived-connection
    shape that dominates at millions-of-users scale. Exercises exactly the
    instance-level serving architecture: the cross-session AST cache skips
    the parse every fresh session used to pay, and concurrent lookups
    coalesce in the point-get batcher. Guarded under --check next to
    ``qps_point_select`` so cold-path serving throughput cannot regress
    silently."""
    import tidb_tpu_torch
    from tidb_tpu_torch.bench.qps import concurrent_qps

    db = tidb_tpu_torch.open(device=DEVICE)
    db.execute("CREATE TABLE qc (id BIGINT PRIMARY KEY, v BIGINT)")
    db.execute("INSERT INTO qc VALUES " + ",".join(f"({i},{i * 3})" for i in range(500)))
    # rotate over a small statement set so the text-keyed instance cache
    # warms in the first few queries and stays hot (matching a production
    # workload's finite statement population)
    db.query("SELECT v FROM qc WHERE id = 0")

    def worker(_s, i, k):
        s2 = db.session()  # the cold connection: no per-session warm state
        rows = s2.query(f"SELECT v FROM qc WHERE id = {(i * 7 + k) % 16}")
        if len(rows) != 1:  # never inside an assert: python -O strips it
            raise RuntimeError(f"cold point select returned {len(rows)} rows")

    return concurrent_qps(db, worker, 4, 250)


def _delta_bench_env(block_rows: int, cap: int, merge_rows: int):
    """Context manager shrinking the device block + delta knobs so the daily
    lanes exercise the multi-block delta/merge machinery at bench scale."""
    import contextlib

    from tidb_tpu_torch import config as _config
    from tidb_tpu_torch.copr import colcache, gpu_engine

    @contextlib.contextmanager
    def ctx():
        import dataclasses

        old_block = (gpu_engine._BLOCK, colcache.DEVICE_BLOCK_ROWS)
        old_cfg = _config.current()
        gpu_engine._BLOCK = colcache.DEVICE_BLOCK_ROWS = block_rows
        _config.set_current(
            dataclasses.replace(
                old_cfg,
                device_delta_cap=cap,
                device_delta_merge_rows=merge_rows,
                device_delta_min_rows=1,
            )
        )
        try:
            yield
        finally:
            gpu_engine._BLOCK, colcache.DEVICE_BLOCK_ROWS = old_block
            _config.set_current(old_cfg)

    return ctx()


@register("freshness_lag_ms")
def bench_freshness_lag() -> float:
    """DML → first fresh ``gpu``-engine read (ms, lower is better): a warm
    aggregation over a loaded table, a point-UPDATE burst, then the clock
    times the NEXT gpu query — which must return the fresh sum through the
    delta operand with NO full re-upload (asserted via the H2D counter; a
    regression to invalidate-and-reload fails the lane outright)."""
    import time as _t

    import numpy as np

    import tidb_tpu_torch
    from tidb_tpu_torch.executor.load import bulk_load
    from tidb_tpu_torch.utils import metrics as _m

    with _delta_bench_env(block_rows=1 << 22, cap=1024, merge_rows=512):
        db = tidb_tpu_torch.open(device=DEVICE)
        db.execute("CREATE TABLE fl (id BIGINT PRIMARY KEY, v BIGINT)")
        n = 200_000
        bulk_load(db, "fl", [np.arange(n, dtype=np.int64), np.full(n, 3, dtype=np.int64)])
        s = db.session()
        s.execute("SET tidb_isolation_read_engines = 'gpu'")
        q = "SELECT COUNT(*), SUM(v) FROM fl"
        s.query(q)
        base = s.query(q)  # warm: device columns resident
        burst = 200
        s.execute(f"UPDATE fl SET v = v + 1 WHERE id < {burst}")
        h2d0 = _m.DEVICE_TRANSFER.get(dir="h2d")
        t0 = _t.perf_counter()
        fresh = s.query(q)
        dt_ms = (_t.perf_counter() - t0) * 1000
        h2d = _m.DEVICE_TRANSFER.get(dir="h2d") - h2d0
        if fresh[0][1] != base[0][1] + burst:  # never inside an assert (python -O)
            raise RuntimeError(f"stale read after DML: {fresh} vs base {base}")
        if h2d >= n * 8:  # a full column re-upload = the old invalidate path
            raise RuntimeError(f"freshness read re-uploaded the base ({h2d} bytes)")
        return dt_ms


@register("incremental_load_ms")
def bench_incremental_load() -> float:
    """Append 1% rows to a warm multi-block table, re-run the aggregation
    (ms, lower is better): the merge must carry clean-block device arrays
    and re-upload ONLY the dirty tail block — asserted against the warm-up
    upload volume via the H2D counter."""
    import time as _t

    import numpy as np

    import tidb_tpu_torch
    from tidb_tpu_torch.executor.load import bulk_load
    from tidb_tpu_torch.utils import metrics as _m

    with _delta_bench_env(block_rows=65536, cap=1024, merge_rows=512):
        db = tidb_tpu_torch.open(region_split_keys=1 << 62, device=DEVICE)
        db.execute("CREATE TABLE il (id BIGINT PRIMARY KEY, v BIGINT)")
        n = 240_000
        bulk_load(db, "il", [np.arange(n, dtype=np.int64), np.arange(n, dtype=np.int64) % 97])
        s = db.session()
        s.execute("SET tidb_isolation_read_engines = 'gpu'")
        q = "SELECT COUNT(*), SUM(v) FROM il"
        h2d_start = _m.DEVICE_TRANSFER.get(dir="h2d")
        s.query(q)
        s.query(q)  # warm
        warm_bytes = _m.DEVICE_TRANSFER.get(dir="h2d") - h2d_start
        extra = n // 100
        bulk_load(db, "il", [np.arange(n, n + extra, dtype=np.int64), np.zeros(extra, dtype=np.int64)])
        h2d0 = _m.DEVICE_TRANSFER.get(dir="h2d")
        t0 = _t.perf_counter()
        out = s.query(q)
        dt_ms = (_t.perf_counter() - t0) * 1000
        h2d = _m.DEVICE_TRANSFER.get(dir="h2d") - h2d0
        if out[0][0] != n + extra:  # never inside an assert (python -O)
            raise RuntimeError(f"append not visible: {out[0][0]} rows")
        if warm_bytes and h2d >= warm_bytes * 0.6:
            raise RuntimeError(
                f"incremental load re-uploaded too much ({h2d}/{warm_bytes} bytes)"
            )
        return dt_ms


@register("qps_q1_concurrent")
def bench_qps_q1_concurrent() -> float:
    """Q1-shaped concurrent analytics throughput (ops/s, higher is better)
    on a scaled-down 2M-row table — the daily regression gate the full-size
    ``qps_q1_concurrent`` headline lane (bench.py) never had: N sessions
    hammer the same warm grouped aggregation on the ``gpu`` engine."""
    import numpy as np

    import tidb_tpu_torch
    from tidb_tpu_torch.bench.qps import concurrent_qps
    from tidb_tpu_torch.executor.load import bulk_load

    db = tidb_tpu_torch.open(region_split_keys=1 << 62, device=DEVICE)
    db.execute("CREATE TABLE q1c (id BIGINT PRIMARY KEY, g VARCHAR(2), v BIGINT)")
    n = 2_000_000
    rng = np.random.default_rng(1)
    bulk_load(
        db,
        "q1c",
        [
            np.arange(n, dtype=np.int64),
            np.array([b"aa", b"bb", b"cc"], dtype="S2")[rng.integers(0, 3, n)],
            rng.integers(0, 1000, n),
        ],
    )
    q = "SELECT g, COUNT(*), SUM(v) FROM q1c GROUP BY g"

    def setup(s, i):
        s.execute("SET tidb_isolation_read_engines = 'gpu'")
        s.query(q)  # warm: compile + device residency per session

    def worker(s, i, k):
        rows = s.query(q)
        if len(rows) != 3:  # never inside an assert (python -O)
            raise RuntimeError(f"q1c returned {len(rows)} groups")

    # 2 × 12 = 24 timed executions: enough samples for a stable ops/s
    # baseline under check_regression (a 6-op window was scheduler noise)
    return concurrent_qps(db, worker, 2, 12, setup=setup)


@register("cluster_snapshot_ms")
def bench_cluster_snapshot() -> float:
    """Full-fleet ``sys_snapshot`` sweep wall (ms, lower is better) over a
    3-store wire fleet: the cost of materializing one
    ``information_schema.cluster_*`` query's substrate — per-store report
    building (registry walk, slow-ring serialization) plus three RPCs. The
    guard keeps the introspection verb itself from growing a tax that makes
    operators afraid to run it."""
    import time as _t

    from tidb_tpu_torch.kv.memstore import MemStore
    from tidb_tpu_torch.kv.remote import RemoteStore, StoreServer
    from tidb_tpu_torch.kv.sharded import ShardedStore
    from tidb_tpu_torch.session.session import DB

    servers = [StoreServer(_on_device(MemStore(region_split_keys=100_000))) for _ in range(3)]
    try:
        stores = [RemoteStore("127.0.0.1", srv.start()) for srv in servers]
        db = DB(store=_on_device(ShardedStore(stores)))
        db.health.sweep()  # warm: sockets dialed, report path imported
        best = float("inf")
        for _ in range(10):
            t0 = _t.perf_counter()
            outs = db.health.sweep()
            best = min(best, (_t.perf_counter() - t0) * 1000)
            if not all(o["ok"] for o in outs):  # never inside an assert (-O)
                raise RuntimeError(f"sweep lost a live store: {outs}")
        return best
    finally:
        for srv in servers:
            srv.shutdown()


@register("inspection_sweep_ms")
def bench_inspection_sweep() -> float:
    """One full diagnosis pass over a 3-store wire fleet (ms, lower is
    better): a fresh ``sys_snapshot`` health sweep plus every inspection
    rule evaluated against it — the cost of one ``SELECT * FROM
    information_schema.inspection_result`` an operator runs mid-incident.
    Guarded next to ``cluster_snapshot_ms`` so the rule engine never grows
    a tax that makes diagnosis itself the slow query."""
    import time as _t

    from tidb_tpu_torch.kv.memstore import MemStore
    from tidb_tpu_torch.kv.remote import RemoteStore, StoreServer
    from tidb_tpu_torch.kv.sharded import ShardedStore
    from tidb_tpu_torch.session.session import DB
    from tidb_tpu_torch.utils.inspection import inspect

    servers = [StoreServer(_on_device(MemStore(region_split_keys=100_000))) for _ in range(3)]
    try:
        stores = [RemoteStore("127.0.0.1", srv.start()) for srv in servers]
        db = DB(store=_on_device(ShardedStore(stores)))
        db.health.sweep()  # warm: sockets dialed, report path imported
        inspect(db, echo=False)
        best = float("inf")
        for _ in range(10):
            t0 = _t.perf_counter()
            db.health.sweep()
            rows = inspect(db, echo=False)
            best = min(best, (_t.perf_counter() - t0) * 1000)
            if not rows:  # never inside an assert (-O)
                raise RuntimeError("inspection returned no rows on a live fleet")
        return best
    finally:
        for srv in servers:
            srv.shutdown()


@register("keyviz_sweep_ms")
def bench_keyviz_sweep() -> float:
    """Heatmap-only ``sys_snapshot`` sweep wall (ms, lower is better) over a
    3-store wire fleet with live traffic rings: the substrate of one
    ``information_schema.keyspace_heatmap`` query, ``GET /keyviz``, or the
    balancer's hot-weight read — ring serialization per store plus three
    RPCs, with the heavy metrics/statements/slow sections deselected.
    Guarded next to ``cluster_snapshot_ms`` so the traffic substrate stays
    cheap enough to poll at dashboard cadence."""
    import time as _t

    import numpy as np

    from tidb_tpu_torch.executor.load import bulk_load
    from tidb_tpu_torch.kv.memstore import MemStore
    from tidb_tpu_torch.kv.remote import RemoteStore, StoreServer
    from tidb_tpu_torch.kv.sharded import ShardedStore
    from tidb_tpu_torch.session.session import DB

    servers = [StoreServer(_on_device(MemStore(region_split_keys=100_000))) for _ in range(3)]
    try:
        stores = [RemoteStore("127.0.0.1", srv.start()) for srv in servers]
        db = DB(store=_on_device(ShardedStore(stores)))
        db.execute("CREATE TABLE kvz (id BIGINT PRIMARY KEY, v BIGINT)")
        n = 5_000
        bulk_load(db, "kvz", [np.arange(n, dtype=np.int64), np.arange(n, dtype=np.int64)])
        s = db.session()
        for _ in range(5):  # populate the rings on the owning stores
            s.query("SELECT SUM(v) FROM kvz")
        db.health.sweep(sections=("heatmap",))  # warm: sockets + report path
        best = float("inf")
        for _ in range(10):
            t0 = _t.perf_counter()
            outs = db.health.sweep(sections=("heatmap",))
            best = min(best, (_t.perf_counter() - t0) * 1000)
            if not all(o["ok"] for o in outs):  # never inside an assert (-O)
                raise RuntimeError(f"heatmap sweep lost a live store: {outs}")
        return best
    finally:
        for srv in servers:
            srv.shutdown()


@register("metrics_history_overhead_ms")
def bench_metrics_history_overhead() -> float:
    """Warm COUNT(*) latency WHILE the metrics-history recorder samples at a
    deliberately hostile 20ms interval (ms, lower is better): the recorder
    runs off-thread, so any query-path tax it adds is lock contention on the
    registry — this lane, gated next to fixed_overhead_ms, keeps the
    always-on recorder honest about 'small footprint'."""
    from tidb_tpu_torch.utils.metricshist import recorder

    rec = recorder()
    old = rec.interval_s
    rec.interval_s = 0.02
    rec.start()
    try:
        return _warm_count_best("mho")
    finally:
        rec.stop()
        rec.interval_s = old


@register("shard_probe_overhead_ms")
def bench_shard_probe_overhead() -> float:
    """Host-callback tax of the per-shard straggler probes (ms, lower is
    better): the SAME warm MPP gather timed with probes built in vs the
    probe-free program variant (gather.PROBES_ENABLED=False builds the
    program without its per-shard rows and bytes outputs and skips the
    host-side probe) — the carried OBSERVABILITY.md gap,
    finally a number. Clamped at 0 (scheduler noise can favor either)."""
    import time as _t

    import numpy as np

    import tidb_tpu_torch
    from tidb_tpu_torch.executor.load import bulk_load
    from tidb_tpu_torch.parallel import gather

    db = tidb_tpu_torch.open(device=DEVICE)
    db.execute("CREATE TABLE spo (id BIGINT PRIMARY KEY, g BIGINT, v BIGINT)")
    rng = np.random.default_rng(7)
    n = 50_000
    bulk_load(db, "spo", [np.arange(n, dtype=np.int64), rng.integers(0, 5, n),
                          rng.integers(0, 1000, n)])
    s = db.session()
    s.execute("ANALYZE TABLE spo")
    s.execute("SET tidb_enforce_mpp = 1")
    q = "SELECT g, COUNT(*), SUM(v) FROM spo GROUP BY g"

    def best_of(k: int) -> float:
        best = float("inf")
        for _ in range(k):
            t0 = _t.perf_counter()
            s.query(q)
            best = min(best, (_t.perf_counter() - t0) * 1000)
        return best

    try:
        s.query(q)  # warm: compile the probed variant
        with_probes = best_of(5)
        gather.PROBES_ENABLED = False
        s.query(q)  # warm: compile the probe-free variant
        without = best_of(5)
    finally:
        gather.PROBES_ENABLED = True
    return max(with_probes - without, 0.0)


@register("owner_failover_ms")
def bench_owner_failover() -> float:
    """Owner-election failover latency (ms, lower is better): a 3-shard
    fleet loses the shard 0 replica while node-a holds the lease and stops
    renewing; the clock runs until node-b's campaign is granted. Bounded
    below by the lease (50 ms here) — the guarded quantity is the election
    machinery's overhead on top of it (quorum sweeps past a dead shard)."""
    import time as _t

    from tidb_tpu_torch.kv.memstore import MemStore
    from tidb_tpu_torch.kv.sharded import ShardedStore

    class _DeadStore:
        """Every verb raises — the in-process analog of a SIGKILLed shard."""

        nonce = "dead"

        def __getattr__(self, name):
            def _down(*a, **k):
                raise ConnectionError("bench: store down")

            return _down

    lease_s = 0.05
    best = float("inf")
    for _ in range(3):
        fleet = _on_device(ShardedStore([_on_device(MemStore(region_split_keys=1000)) for _ in range(3)]))
        if not fleet.owner_campaign("bench", "node-a", lease_s=lease_s):
            # never inside an assert: under python -O that would strip the
            # grant and the bench would time an uncontested (~0 ms) election
            raise RuntimeError("baseline grant failed on a fresh fleet")
        fleet.stores[0] = _DeadStore()  # the QuorumElection sees the same list
        t0 = _t.perf_counter()
        while not fleet.owner_campaign("bench", "node-b", lease_s=lease_s):
            _t.sleep(0.002)
        best = min(best, (_t.perf_counter() - t0) * 1000)
    return best


_REGION_MOVE_MEMO: dict = {}


def _region_move_measure() -> dict:
    """Migrate a populated table between stores of an embedded 3-shard
    fleet, twice (there and back), keeping the best run. Memoized so the
    two registered lanes (total wall / cutover blackout) pay one setup."""
    if _REGION_MOVE_MEMO:
        return _REGION_MOVE_MEMO
    from tidb_tpu_torch.kv.memstore import MemStore
    from tidb_tpu_torch.kv.sharded import ShardedStore
    from tidb_tpu_torch.session.session import DB

    fleet = _on_device(ShardedStore([_on_device(MemStore(region_split_keys=100_000)) for _ in range(3)]))
    db = DB(store=fleet)
    s = db.session()
    s.execute("CREATE TABLE mv (id BIGINT PRIMARY KEY, v BIGINT, s VARCHAR(16))")
    for lo in range(0, 20_000, 4000):
        s.execute(
            "INSERT INTO mv VALUES "
            + ",".join(f"({i},{i * 3},'row-{i % 97}')" for i in range(lo, lo + 4000))
        )
    tid = db.catalog.table("test", "mv").id
    src = fleet.shard_of_table(tid)
    best_wall, best_blackout = float("inf"), float("inf")
    for step in (1, 2, 3):
        stats = fleet.migrate_table(tid, (src + step) % 3)
        if not stats["moved"] or stats["rows"] < 20_000:
            raise RuntimeError(f"region-move bench migrated nothing: {stats}")
        best_wall = min(best_wall, stats["wall_ms"])
        best_blackout = min(best_blackout, stats["blackout_ms"])
        # verify the move kept the data whole — a fast-but-lossy migration
        # must fail the lane, not set a record
        n = s.query("SELECT COUNT(*) FROM mv")[0][0]
        if n != 20_000:
            raise RuntimeError(f"region-move bench lost rows: {n} != 20000")
    _REGION_MOVE_MEMO.update(wall_ms=best_wall, blackout_ms=best_blackout)
    return _REGION_MOVE_MEMO


@register("region_move_ms")
def bench_region_move() -> float:
    """Wall clock to migrate a populated 20k-row region between stores (ms,
    lower is better): snapshot copy + catch-up + fenced cutover + purge.
    The cutover blackout rides the separate region_move_blackout_ms lane."""
    return _region_move_measure()["wall_ms"]


@register("region_move_blackout_ms")
def bench_region_move_blackout() -> float:
    """The cutover blackout window alone (ms, lower is better): the stretch
    where the source is fenced and the final catch-up + epoch bump run —
    the only part a concurrent writer ever waits on (readers of the old
    owner retry under boRegionMiss for the same window)."""
    return _region_move_measure()["blackout_ms"]


@register("balancer_converge_s")
def bench_balancer_converge() -> float:
    """Seconds from an induced 3:1 load skew to balanced placement (lower
    is better): three populated tables migrated onto ONE store of a
    3-shard fleet, then balancer sweeps run back-to-back until the sweep
    reports balance under the default skew ratio. Recorded in ms (the _s
    suffix converts) under the same --check gate."""
    import time as _t

    from tidb_tpu_torch.kv.memstore import MemStore
    from tidb_tpu_torch.kv.sharded import ShardedStore
    from tidb_tpu_torch.session.session import DB

    fleet = _on_device(ShardedStore([_on_device(MemStore(region_split_keys=100_000)) for _ in range(3)]))
    db = DB(store=fleet)
    s = db.session()
    hot = None
    for t in ("sk0", "sk1", "sk2"):
        s.execute(f"CREATE TABLE {t} (id BIGINT PRIMARY KEY, v BIGINT)")
        s.execute(
            f"INSERT INTO {t} VALUES " + ",".join(f"({i},{i})" for i in range(4000))
        )
        tid = db.catalog.table("test", t).id
        if hot is None:
            hot = fleet.shard_of_table(tid)
        else:
            fleet.migrate_table(tid, hot)  # induce the skew: all on one store
        s.execute(f"ANALYZE TABLE {t}")
    t0 = _t.perf_counter()
    for _ in range(8):
        if db.run_balancer().get("balanced"):
            break
    else:
        raise RuntimeError("balancer did not converge within 8 sweeps")
    elapsed = _t.perf_counter() - t0
    # converged placement must actually be spread: no shard holds all three
    shards = {
        fleet.shard_of_table(db.catalog.table("test", t).id) for t in ("sk0", "sk1", "sk2")
    }
    if len(shards) < 2:
        raise RuntimeError(f"balancer converged without spreading: {shards}")
    return elapsed


def _scaling_curve(name: str, build, query: str, rows: int, expect_staged: bool = False):
    """Shared harness of the scaling-curve lanes: run ``query`` at every
    mesh width ndev ∈ {1, 2, 4, 8} that fits the devices and HARD-GATE the
    curve. The devices are ``mesh.available_devices(DEVICE)``, each handle
    one card (every card a ``cuda`` store meshes; logical devices stand in
    for cards in the tests). Gates (RuntimeError, never assert — python -O):

    - several cards: the widths are ``d ≤`` the card count (``FORCE_NDEV``
      cuts the card list), and rows/s/chip at every width ≥ 0.5 × the
      1-chip figure;
    - one card: ``mesh.FORCE_DEVICES`` is pinned to its handle and the
      widths are virtual shards of it, so per-chip flatness is
      unmeasurable: TOTAL rows/s at the widest mesh ≥ 0.1 × the 1-shard
      figure — catches superlinear padding/exchange pathologies one device
      can see;
    - ``expect_staged``: the query must run the staged pipeline (stage
      count ≥ 2) and move ZERO intermediate bytes through the host
      (tidb_tpu_mpp_intermediate_host_bytes_total must not grow).

    The curve lands in ``SCALING_CURVES[name]`` before the gates judge it.
    Returns rows/s/chip at the widest mesh (the --check trend metric)."""
    import time as _t

    from tidb_tpu_torch.parallel import mesh as _mesh
    from tidb_tpu_torch.utils import metrics as _m

    db, session_setup = build()
    cards = _mesh.available_devices(DEVICE)
    per_chip = len(cards) > 1
    ndevs = [d for d in (1, 2, 4, 8) if d <= len(cards)] if per_chip else [1, 2, 4, 8]
    curve: dict[int, float] = {}
    host_bytes0 = _m.MPP_HOST_INTERMEDIATE.total()
    old_devices = _mesh.FORCE_DEVICES
    try:
        _mesh.FORCE_DEVICES = cards
        for nd in ndevs:
            _mesh.FORCE_NDEV = nd
            s = db.session()
            session_setup(s)
            s.query(query)  # warm: compile + device lanes for THIS width
            best = float("inf")
            for _ in range(3):
                t0 = _t.perf_counter()
                s.query(query)
                best = min(best, _t.perf_counter() - t0)
            curve[nd] = rows / best
            if expect_staged:
                det = s.mpp_details[-1] if s.mpp_details else None
                if det is None or det.stages < 2:
                    raise RuntimeError(
                        f"{name}: staged pipeline did not engage at ndev={nd} "
                        f"(stages={det.stages if det else None})"
                    )
    finally:
        _mesh.FORCE_NDEV = None
        _mesh.FORCE_DEVICES = old_devices
    SCALING_CURVES[name] = {"cards": len(cards), "gate": "per-chip" if per_chip else "total", "rows_per_s": curve}
    if expect_staged:
        moved = _m.MPP_HOST_INTERMEDIATE.total() - host_bytes0
        if moved:
            raise RuntimeError(
                f"{name}: staged pipeline moved {moved} intermediate bytes "
                "through the host (must be zero)"
            )
    widest = ndevs[-1]
    if len(ndevs) >= 2:
        if not per_chip:
            if curve[widest] < 0.1 * curve[1]:
                raise RuntimeError(
                    f"{name}: total throughput collapsed going wide: "
                    + ", ".join(f"ndev={d}: {curve[d]:,.0f} rows/s" for d in ndevs)
                )
        else:
            for d in ndevs[1:]:
                if curve[d] / d < 0.5 * curve[1]:
                    raise RuntimeError(
                        f"{name}: rows/s/chip degraded at ndev={d}: "
                        f"{curve[d] / d:,.0f} vs {curve[1]:,.0f} at 1 chip"
                    )
    return curve[widest] / widest


@register("scaling_q1_rows_per_s_per_chip")
def bench_scaling_q1() -> float:
    """Q1-shaped single-table MPP agg at ndev ∈ {1, 2, 4, 8}: rows/s/chip
    at the widest mesh, curve-gated (see _scaling_curve)."""
    import numpy as np

    import tidb_tpu_torch
    from tidb_tpu_torch.executor.load import bulk_load

    def build():
        db = tidb_tpu_torch.open(region_split_keys=1 << 62, device=DEVICE)
        db.execute("CREATE TABLE sc1 (id BIGINT PRIMARY KEY, g BIGINT, v BIGINT)")
        n = 400_000
        rng = np.random.default_rng(41)
        bulk_load(db, "sc1", [np.arange(n, dtype=np.int64), rng.integers(0, 6, n),
                              rng.integers(0, 1000, n)])
        db.execute("ANALYZE TABLE sc1")

        def setup(s):
            s.execute("SET tidb_enforce_mpp = 1")

        return db, setup

    return _scaling_curve(
        "scaling_q1", build, "SELECT g, COUNT(*), SUM(v) FROM sc1 GROUP BY g", 400_000
    )


@register("scaling_q3_rows_per_s_per_chip")
def bench_scaling_q3() -> float:
    """Q3-shaped MPP join+agg at ndev ∈ {1, 2, 4, 8}: rows/s/chip at the
    widest mesh, curve-gated."""
    import numpy as np

    import tidb_tpu_torch
    from tidb_tpu_torch.executor.load import bulk_load

    def build():
        db = tidb_tpu_torch.open(region_split_keys=1 << 62, device=DEVICE)
        db.execute("CREATE TABLE sc3o (o_orderkey BIGINT PRIMARY KEY, o_odate BIGINT)")
        db.execute("CREATE TABLE sc3l (l_orderkey BIGINT, l_price BIGINT)")
        rng = np.random.default_rng(43)
        n_o, n_l = 10_000, 100_000
        bulk_load(db, "sc3o", [np.arange(n_o, dtype=np.int64), 8000 + rng.integers(0, 30, n_o)])
        bulk_load(db, "sc3l", [rng.integers(0, n_o, n_l), rng.integers(100, 10_000, n_l)])
        db.execute("ANALYZE TABLE sc3o")
        db.execute("ANALYZE TABLE sc3l")

        def setup(s):
            s.execute("SET tidb_enforce_mpp = 1")

        return db, setup

    return _scaling_curve(
        "scaling_q3",
        build,
        "SELECT o_odate, SUM(l_price) FROM sc3l, sc3o WHERE l_orderkey = o_orderkey "
        "GROUP BY o_odate ORDER BY o_odate",
        100_000,
    )


@register("scaling_q17_rows_per_s_per_chip")
def bench_scaling_q17() -> float:
    """Q17-shaped STAGED two-stage pipeline at ndev ∈ {1, 2, 4, 8}:
    rows/s/chip at the widest mesh. Beyond the curve gate this lane proves
    the staged path end-to-end: stage count ≥ 2 at every width and ZERO
    intermediate bytes through the host (the subplan aggregate stays
    device-resident; its repartition rides all_to_all on ICI)."""
    import numpy as np

    import tidb_tpu_torch
    from tidb_tpu_torch.executor.load import bulk_load

    def build():
        db = tidb_tpu_torch.open(region_split_keys=1 << 62, device=DEVICE)
        db.execute("CREATE TABLE sc17l (l_partkey BIGINT, l_qty BIGINT, l_price BIGINT)")
        db.execute("CREATE TABLE sc17p (p_partkey BIGINT PRIMARY KEY, p_brand BIGINT)")
        rng = np.random.default_rng(47)
        n_l, n_p = 100_000, 4_000
        bulk_load(db, "sc17l", [rng.integers(0, n_p, n_l), rng.integers(1, 50, n_l),
                                rng.integers(100, 10_000, n_l)])
        bulk_load(db, "sc17p", [np.arange(n_p, dtype=np.int64), rng.integers(0, 9, n_p)])
        db.execute("ANALYZE TABLE sc17l")
        db.execute("ANALYZE TABLE sc17p")

        def setup(s):
            pass

        return db, setup

    return _scaling_curve(
        "scaling_q17",
        build,
        "SELECT SUM(l_price) FROM sc17l, sc17p WHERE p_partkey = l_partkey "
        "AND p_brand = 3 AND l_qty < (SELECT 0.2 * AVG(l_qty) FROM sc17l WHERE l_partkey = p_partkey)",
        100_000,
        expect_staged=True,
    )


@register("fuzz_cases_per_s")
def bench_fuzz_throughput() -> float:
    """graftfuzz campaign throughput (cases/s, higher is better): a fixed-
    seed 60-case campaign with the tier-1 smoke lane's narrow query pools.
    Guards the harness's cost model — the oracle set is only CI-viable while
    the kernel-compile amortization holds (pooled DBs, bounded per-profile
    query vocabulary), so a regression here means the smoke lane's 90 s
    budget is rotting. Hard-fails on any divergence: a bench box finding a
    parity bug must not record it as a throughput number."""
    from tidb_tpu_torch.tools.fuzz.harness import run_campaign

    res = run_campaign(seed=1234, cases=60, pool_size=6, do_shrink=False)
    if res.findings or res.errors:
        raise RuntimeError(
            f"fuzz campaign not clean: {len(res.findings)} finding(s), "
            f"{res.errors} harness error(s)\n" + res.findings_json()
        )
    return res.checked / max(res.elapsed_s, 1e-9)


def run_all(names=None) -> list[dict]:
    out = []
    for name, fn in _BENCHES.items():
        if names and name not in names:
            continue
        v = fn()
        rec = {"name": name, "date": datetime.date.today().isoformat()}
        if name.endswith("_ms"):
            rec["ms"] = round(v, 1)
        elif name.endswith("_per_s"):
            # small-magnitude throughput lane (e.g. fuzz cases/s): keep a
            # decimal so the ±25% gate is not quantized away at values < 10
            rec["ops_per_sec"] = round(v, 1)
        elif name.endswith("_s"):
            # seconds-scale latency lane: recorded in ms so check_regression
            # applies its lower-is-better rule unchanged
            rec["ms"] = round(v * 1000.0, 1)
        else:
            rec["ops_per_sec"] = round(v)
        out.append(rec)
    return out


def check_regression(records: list[dict], baseline: list[dict], tolerance: float = 0.25) -> list[str]:
    """Compare a fresh run against a baseline JSON; returns one message per
    regressed metric (latency up or throughput down by more than
    ``tolerance``). Metrics missing from either side are skipped — the guard
    never blocks on a newly added bench."""
    base = {r["name"]: r for r in baseline}
    bad = []
    for r in records:
        b = base.get(r["name"])
        if b is None:
            continue
        if "ms" in r and "ms" in b and b["ms"] > 0:
            if r["ms"] > b["ms"] * (1 + tolerance):
                bad.append(f"{r['name']}: {b['ms']}ms -> {r['ms']}ms (+{r['ms'] / b['ms'] - 1:.0%})")
        elif "ops_per_sec" in r and "ops_per_sec" in b and b["ops_per_sec"] > 0:
            if r["ops_per_sec"] < b["ops_per_sec"] * (1 - tolerance):
                bad.append(
                    f"{r['name']}: {b['ops_per_sec']:,} -> {r['ops_per_sec']:,} ops/s "
                    f"({r['ops_per_sec'] / b['ops_per_sec'] - 1:.0%})"
                )
    return bad


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default="bench_daily.json")
    ap.add_argument("--only", nargs="*", default=None)
    ap.add_argument("--check", default=None, help="baseline JSON; exit 2 on regression")
    ap.add_argument("--tolerance", type=float, default=0.25)
    ap.add_argument(
        "--fuzz-minutes", type=float, default=None,
        help="ALSO run a graftfuzz long campaign for N wall-clock minutes "
        "(nightly lane; full-width query pools, repros under --fuzz-out); "
        "exit 3 on any divergence",
    )
    ap.add_argument("--fuzz-seed", type=int, default=42)
    ap.add_argument("--fuzz-out", default="fuzz_nightly")
    ap.add_argument(
        "--device", default="cuda",
        help="where every lane (and the fuzz campaign) runs its device work: "
        "cuda (default; with no card a lane raises) or cpu",
    )
    args = ap.parse_args(argv)
    # every lane, fuzz_cases_per_s and the nightly campaign open on --device
    global DEVICE
    from tidb_tpu_torch.tools.fuzz import runner as _fuzz_runner

    DEVICE = _fuzz_runner.DEVICE = args.device
    records = run_all(args.only)
    with open(args.out, "w") as f:
        json.dump(records, f, indent=1)
    for r in records:
        if "ms" in r:
            print(f"{r['name']:<28} {r['ms']:>12,.1f} ms")
        else:
            print(f"{r['name']:<28} {r['ops_per_sec']:>12,} ops/s")
    if args.check:
        with open(args.check) as f:
            bad = check_regression(records, json.load(f), args.tolerance)
        if bad:
            for line in bad:
                print(f"REGRESSION {line}")
            raise SystemExit(2)
        print("regression guard: ok")
    if args.fuzz_minutes:
        # nightly long campaign: wall-clock bounded, full-width query pools
        # (the tier-1 smoke lane already covers the narrow ones), shrunk
        # repros + findings.json land under --fuzz-out for triage
        from tidb_tpu_torch.tools.fuzz.harness import run_campaign

        res = run_campaign(
            seed=args.fuzz_seed,
            minutes=args.fuzz_minutes,
            out_dir=args.fuzz_out,
            progress=lambda m: print(f"graftfuzz: {m}"),
        )
        print(
            f"graftfuzz nightly: {res.checked} cases, {len(res.findings)} finding(s), "
            f"{res.errors} harness error(s), {res.checked / max(res.elapsed_s, 1e-9):.1f} cases/s"
        )
        if res.findings or res.errors:
            print(f"divergences/harness errors! shrunk repros in {args.fuzz_out}/ — fix or triage per STATIC_ANALYSIS.md")
            raise SystemExit(3)


if __name__ == "__main__":
    main()
