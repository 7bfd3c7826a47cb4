"""Rule-driven fleet inspection (ref: TiDB's ``information_schema.
inspection_result`` diagnosis framework, executor/inspection_result.go).

A small registry of pure rules reads three local substrates — the
``StoreHealthRegistry`` cache over ``sys_snapshot`` sweeps, the live
metrics registry (+ the metricshist rate reader), and the structured event
log — and turns them into ``(rule, item, status, value, reference,
detail)`` rows. ``status`` is one of ``ok | warning | critical``; every
critical row is echoed into the event log (component ``inspection``) so
the finding itself lands in ``cluster_log`` with a timestamp.

Rules never sweep the wire themselves: they read whatever the health
registry last cached (plus this process's own metrics), so a SELECT from
``information_schema.inspection_result`` stays cheap and deterministic —
run ``db.health.sweep()`` first when fleet freshness matters. Every input
arrives through :class:`InspectionContext`, so tests drive each rule to
warning/critical with synthetic values and zero cluster setup.

Threadless by construction (thread-hygiene): building a context and
evaluating rules spawns nothing and takes no locks beyond the substrates'
own snapshot reads.
"""

from __future__ import annotations

import os
from dataclasses import dataclass, field
from typing import Callable, Optional

from tidb_tpu_torch.utils import eventlog as _ev

OK, WARNING, CRITICAL = "ok", "warning", "critical"


@dataclass
class InspectionContext:
    """Everything the rules read, decoupled from a live DB. ``from_db``
    fills it from the process's real substrates; tests construct it
    directly with synthetic values."""

    # instance → cached health entry ({"ok","error","shard","ts",...})
    health: dict = field(default_factory=dict)
    # instance → is_stale verdict (registry's freshness clock)
    stale: dict = field(default_factory=dict)
    # instance → seconds since last good report (None = never)
    staleness_s: dict = field(default_factory=dict)
    # per-shard placement weights (None = not a sharded fleet)
    weights: Optional[list] = None
    skew_ratio: float = 2.0
    # combined plan-cache outcome counts: {"hit": n, "miss": n}
    plan_cache: dict = field(default_factory=dict)
    # instance → device-cache resident bytes (local process under its
    # instance name when there is no fleet)
    cache_bytes: dict = field(default_factory=dict)
    hbm_budget: int = 0
    # Histogram.snapshot() of MPP_SHARD_SECONDS (or None)
    mpp_shards: Optional[dict] = None
    # recent backoff sleeps per second (metricshist rate)
    backoff_rate: float = 0.0
    # committed rows pending in delta overlays / the compactor threshold
    delta_rows: float = 0.0
    delta_merge_rows: int = 2048
    # (instance, region_id, table_id) → keys touched over the retained
    # traffic window (reads + writes), from cached heatmap report sections
    region_traffic: dict = field(default_factory=dict)

    @classmethod
    def from_db(cls, db) -> "InspectionContext":
        from tidb_tpu_torch import config as _config
        from tidb_tpu_torch.utils import metrics as _m
        from tidb_tpu_torch.copr.gpu_engine import planning_budget
        from tidb_tpu_torch.utils.metricshist import recorder

        cfg = _config.current()
        ctx = cls(
            skew_ratio=cfg.balancer_skew_ratio,
            delta_merge_rows=cfg.device_delta_merge_rows,
            hbm_budget=planning_budget(getattr(db, "store", None)),
            mpp_shards=_m.MPP_SHARD_SECONDS.snapshot(),
            backoff_rate=recorder().rate("tidb_tpu_backoff_total"),
            delta_rows=float(_m.DEVICE_DELTA_ROWS.get()),
        )
        # plan-cache outcomes: session fast lane + instance cache combined
        for ctr in (_m.PLAN_CACHE, _m.INSTANCE_PLAN_CACHE):
            for key, v in ctr.snapshot()["values"]:
                k = key[0] if key else ""
                if k in ("hit", "miss"):
                    ctx.plan_cache[k] = ctx.plan_cache.get(k, 0) + v
        health = getattr(db, "health", None)
        if health is not None:
            ctx.health = health.reports()
            for inst, ent in ctx.health.items():
                ctx.stale[inst] = health.is_stale(inst)
                ctx.staleness_s[inst] = health.staleness_s(inst)
                rep = ent.get("report") or {}
                if "device_cache_bytes" in rep:
                    ctx.cache_bytes[inst] = rep["device_cache_bytes"]
                for hent in rep.get("heatmap", ()):
                    n = sum(b[1] + b[3] for b in hent["buckets"])
                    k = (inst, hent["region_id"], hent["table_id"])
                    ctx.region_traffic[k] = ctx.region_traffic.get(k, 0) + n
        if not ctx.cache_bytes:
            # no fleet cache — read this process's own device cache
            store = getattr(db, "store", None)
            from tidb_tpu_torch.kv.memstore import MemStore

            if isinstance(store, MemStore):
                from tidb_tpu_torch.copr.colcache import cache_for
                from tidb_tpu_torch.kv.sharded import ShardedStore

                ctx.cache_bytes[ShardedStore.instance_name(store)] = (
                    cache_for(store).resident_bytes()
                )
        store = getattr(db, "store", None)
        if hasattr(store, "placement_cache") and len(getattr(store, "stores", ())) >= 2:
            from tidb_tpu_torch.kv.placement import _shard_weights

            try:
                ctx.weights, _ = _shard_weights(db, store)
            # weights ride a health sweep; a dead fleet member must not
            # abort the whole inspection — the skew rule just reports ok
            except Exception:  # graftcheck: off=except-swallow
                ctx.weights = None
        return ctx


# -- registry ---------------------------------------------------------------

# (name, type, comment, fn) in registration order
_RULES: list = []


def rule(name: str, rtype: str, comment: str):
    def deco(fn: Callable):
        _RULES.append((name, rtype, comment, fn))
        return fn

    return deco


def rules_catalog() -> list:
    """→ [(name, type, comment)] — information_schema.inspection_rules."""
    return [(n, t, c) for n, t, c, _fn in _RULES]


def inspect(db=None, ctx: Optional[InspectionContext] = None, echo: bool = True) -> list:
    """Evaluate every rule → [(rule, item, status, value, reference,
    detail)], criticals echoed into the event log. ``echo=False`` keeps the
    evaluation side-effect free — the diag bundle uses it so two bundles of
    the same state stay byte-identical (an echo would land in the second
    bundle's log dump)."""
    if ctx is None:
        ctx = InspectionContext.from_db(db)
    rows = []
    for name, _rtype, _comment, fn in _RULES:
        for item, status, value, reference, detail in fn(ctx):
            rows.append((name, item, status, value, reference, detail))
            if status == CRITICAL and echo:
                lg = _ev.on(_ev.ERROR)
                if lg is not None:
                    lg.emit(
                        _ev.ERROR, "inspection", name,
                        item=item, value=value, detail=detail,
                    )
    return rows


# -- rules ------------------------------------------------------------------


@rule(
    "store-liveness", "fleet",
    "Per-store reachability from the health registry: a failed sweep is "
    "critical, a good-but-old report is a warning",
)
def _store_liveness(ctx: InspectionContext):
    out = []
    for inst, ent in sorted(ctx.health.items()):
        if not ent.get("ok", False):
            out.append((
                inst, CRITICAL, "down", "ok",
                f"last sweep failed: {ent.get('error', '')[:160]}",
            ))
        elif ctx.stale.get(inst, False):
            age = ctx.staleness_s.get(inst)
            out.append((
                inst, WARNING,
                f"stale {age:.0f}s" if age is not None else "never seen",
                "fresh report < 60s old",
                "no fresh sys_snapshot report",
            ))
        else:
            out.append((inst, OK, "up", "ok", ""))
    if not out:
        out.append(("fleet", OK, "no stores swept", "ok", ""))
    return out


@rule(
    "store-skew", "balance",
    "Hot/cold placement-weight ratio vs [cluster] balancer-skew-ratio — "
    "past the threshold the balancer should be moving tables",
)
def _store_skew(ctx: InspectionContext):
    w = ctx.weights
    if not w or len(w) < 2:
        return [("placement", OK, "n/a", f"<= {ctx.skew_ratio:g}", "not a sharded fleet")]
    hot = max(range(len(w)), key=lambda i: w[i])
    cold = min(range(len(w)), key=lambda i: w[i])
    ratio = w[hot] / max(w[cold], 1.0)
    status = OK
    if ratio > 2 * ctx.skew_ratio:
        status = CRITICAL
    elif ratio > ctx.skew_ratio:
        status = WARNING
    return [(
        f"shard-{hot}", status, f"{ratio:.2f}", f"<= {ctx.skew_ratio:g}",
        f"weights {[round(x, 1) for x in w]} (hot shard {hot}, cold shard {cold})",
    )]


@rule(
    "plan-cache", "performance",
    "Plan-cache miss ratio (session fast lane + instance cache) — a high "
    "ratio means queries keep paying parse/optimize walls",
)
def _plan_cache(ctx: InspectionContext):
    hit = ctx.plan_cache.get("hit", 0)
    miss = ctx.plan_cache.get("miss", 0)
    total = hit + miss
    if total < 20:
        return [("plan-cache", OK, f"{total} lookups", "miss ratio <= 0.5",
                 "too few lookups to judge")]
    ratio = miss / total
    status = OK
    if ratio >= 0.9:
        status = CRITICAL
    elif ratio > 0.5:
        status = WARNING
    return [("plan-cache", status, f"{ratio:.2f}", "miss ratio <= 0.5",
             f"{miss} misses / {total} lookups")]


@rule(
    "hbm-pressure", "capacity",
    "Device-cache resident bytes vs the device LRU budget the planner "
    "weighs them against (half of the card's HBM, 8 GiB on the CPU) — "
    "near the ceiling the LRU starts evicting hot columns",
)
def _hbm_pressure(ctx: InspectionContext):
    if not ctx.hbm_budget:
        return [("hbm", OK, "n/a", "<= 80% of budget", "no HBM budget configured")]
    out = []
    for inst, nbytes in sorted(ctx.cache_bytes.items()):
        frac = nbytes / ctx.hbm_budget
        status = OK
        if frac >= 0.95:
            status = CRITICAL
        elif frac >= 0.8:
            status = WARNING
        out.append((
            inst, status, f"{frac:.1%}", "<= 80% of budget",
            f"{nbytes} bytes resident of {ctx.hbm_budget} budget",
        ))
    if not out:
        out.append(("hbm", OK, "0%", "<= 80% of budget", "no device cache"))
    return out


def _quantile(buckets, q: float) -> float:
    """Upper-bound quantile estimate from cumulative histogram buckets
    (``Histogram.snapshot()["buckets"]``). +Inf resolves to the last
    finite bound — good enough for a skew RATIO."""
    total = buckets[-1][1] if buckets else 0
    if total <= 0:
        return 0.0
    target = q * total
    last_finite = 0.0
    for bound, cum in buckets:
        if bound == "+Inf":
            break
        last_finite = float(bound)
        if cum >= target:
            return float(bound)
    return last_finite


@rule(
    "mpp-straggler", "performance",
    "Per-shard MPP fragment wall p95/median skew — a high ratio means one "
    "slow shard gates every gather's barrier",
)
def _mpp_straggler(ctx: InspectionContext):
    snap = ctx.mpp_shards
    if not snap or snap.get("count", 0) < 8:
        return [("mpp", OK, "n/a", "p95/median <= 4",
                 "under 8 shard observations")]
    p50 = _quantile(snap["buckets"], 0.50)
    p95 = _quantile(snap["buckets"], 0.95)
    if p50 <= 0:
        return [("mpp", OK, "n/a", "p95/median <= 4", "median bucket at zero")]
    ratio = p95 / p50
    status = OK
    if ratio >= 16:
        status = CRITICAL
    elif ratio > 4:
        status = WARNING
    return [("mpp", status, f"{ratio:.1f}", "p95/median <= 4",
             f"p95={p95:g}s median={p50:g}s over {snap['count']} shards")]


@rule(
    "hot-region", "balance",
    "Single-region traffic skew from the stores' keyspace heatmap rings — "
    "one region taking a sustained multiple of the others' traffic wants a "
    "split or a balancer move",
)
def _hot_region(ctx: InspectionContext):
    tr = ctx.region_traffic
    if len(tr) < 2:
        return [("regions", OK, "n/a", "hottest/mean-of-rest <= 4",
                 "under 2 regions with traffic")]
    (hk, hot) = max(tr.items(), key=lambda kv: kv[1])
    rest = [v for k, v in tr.items() if k != hk]
    mean_rest = sum(rest) / len(rest)
    if hot <= 0 or mean_rest <= 0:
        return [("regions", OK, "n/a", "hottest/mean-of-rest <= 4",
                 "no traffic in the retained window")]
    ratio = hot / mean_rest
    status = OK
    if ratio > 16:
        status = CRITICAL
    elif ratio > 4:
        status = WARNING
    inst, rid, tid = hk
    return [(
        f"region-{rid}", status, f"{ratio:.1f}", "hottest/mean-of-rest <= 4",
        f"{hot} keys on {inst} table {tid} vs mean {mean_rest:.0f} "
        f"over {len(rest)} other regions",
    )]


@rule(
    "backoff-storm", "resilience",
    "Recent backoff sleeps per second (metrics history rate) — a storm "
    "means the fleet is thrashing on retries instead of serving",
)
def _backoff_storm(ctx: InspectionContext):
    rate = ctx.backoff_rate
    status = OK
    if rate >= 50:
        status = CRITICAL
    elif rate >= 5:
        status = WARNING
    return [("backoff", status, f"{rate:.1f}/s", "< 5/s",
             "tidb_tpu_backoff_total rate over the history window")]


@rule(
    "delta-backlog", "capacity",
    "Committed rows pending in columnar delta overlays vs the compactor "
    "threshold — a backlog means reads pay overlay cost every scan",
)
def _delta_backlog(ctx: InspectionContext):
    pending = ctx.delta_rows
    ref = max(ctx.delta_merge_rows, 1)
    status = OK
    if pending >= 4 * ref:
        status = CRITICAL
    elif pending >= ref:
        status = WARNING
    return [("delta", status, f"{pending:g} rows", f"< {ref} rows",
             f"compactor threshold device-delta-merge-rows={ref}")]
