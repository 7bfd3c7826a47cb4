"""MPP gather: plan rewrite + host-side coordinator executing a join/agg/
topN query as ONE jitted shard_map program over the device mesh.

ref: MPPGather (mpp_gather.go:69) + localMppCoordinator
(local_mpp_coordinator.go) + fragment cutting (fragment.go:48). Redesigned:
fragments do not travel as gRPC DAGs to per-node engines — the whole
fragment tree compiles into collectives (all_to_all / all_gather) on the
mesh's ``dp`` axis (SURVEY §7.7).

Supported shapes (ref mpp_exec.go:63-1162 executor set):
- FinalAgg ← left-deep chain of inner equi-joins over table readers
  (build sides unique OR non-unique — expansion join), aggs count/sum/avg;
- TopN / Limit ← the same join chains (per-shard heads, root-trimmed);
- single-table partial agg under tidb_enforce_mpp.
Anything else stays on the host Volcano path.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional

import numpy as np

from tidb_tpu_torch.expression.expr import (
    AggDesc,
    ColumnRef,
    Constant,
    EvalBatch,
    Expression,
    can_push_down,
    eval_expr,
    expr_from_pb,
)
from tidb_tpu_torch.planner.plans import (
    OutCol,
    PhysFinalAgg,
    PhysHashJoin,
    PhysLimit,
    PhysProjection,
    PhysSelection,
    PhysSort,
    PhysTableReader,
    PhysicalPlan,
    Schema,
)
from tidb_tpu_torch.types import TypeKind
from tidb_tpu_torch.utils import sysvar_int

# structural key → jitted MPP program (see MPPGatherExec.execute)
_MPP_FN_CACHE: dict = {}

# one mesh collective in flight per process: two concurrent shard_map
# programs race for the same device set and the XLA CPU client's collective
# rendezvous starves on small hosts (each program waits for participants the
# other is holding) — concurrent disttask/session threads used to deadlock
# here. Real TPU runs one SPMD program per mesh at a time anyway.
import threading as _threading

_MESH_EXEC_LOCK = _threading.Lock()
# (store, table, slots, region versions, ndev) → padded device input lanes
_MPP_DEV_CACHE: dict = {}
# serializes MUTATIONS of the two module caches above/below: lookups stay
# lock-free (GIL-atomic dict reads; a miss just rebuilds), but the eviction
# sweeps iterate while sizing, and concurrent gathers from different
# sessions insert outside _MESH_EXEC_LOCK — iteration-during-insert raises
# RuntimeError. Never held across a compile or an upload.
_MPP_CACHE_MU = _threading.Lock()

# per-shard straggler observation channel: the fragment program's shard
# probes (mpp.build_dist_pipeline shard_probe) report back through this ONE
# module-level slot — race-free because _MESH_EXEC_LOCK serializes mesh
# programs, and the probe function itself is stable so the compiled-program
# cache (_MPP_FN_CACHE) keeps working across queries
_SHARD_OBS: dict = {"t0": 0.0, "sink": None}

# straggler-probe switch: False compiles probe-FREE fragment programs (the
# jax.debug.callback never enters the jaxpr), so the host-callback tax is
# measurable as on-vs-off latency — benchdaily's shard_probe_overhead_ms
# lane and the driver's multichip dryrun both flip this. Part of the
# compiled-program cache key, so the two variants coexist.
PROBES_ENABLED = True


def _shard_probe(idx, rows, xbytes, wall_ms):
    """Called once per mesh shard after the fragment program: records
    [shard_id, completion ms, rows produced, exchanged bytes]. Completion
    is the shard's worker's stream time over the program (``wall_ms``, CUDA
    events; the host clock on the CPU) — the straggler signal: a worker
    that computed longer reports later. The ``mpp_shard_slow`` failpoint
    lets chaos tests make one shard observably slow without touching the
    program itself (its delay is added)."""
    import time as _t

    from tidb_tpu_torch.utils import failpoint as _fp

    i = int(idx)
    t0 = _t.perf_counter()
    _fp.inject("mpp_shard_slow", i)
    sink = _SHARD_OBS.get("sink")
    if sink is not None:
        sink.append(
            [i, round(wall_ms + (_t.perf_counter() - t0) * 1000.0, 3), int(rows), int(xbytes)]
        )


@dataclass
class MPPJoin:
    """One join step of a left-deep MPP chain: the accumulated probe side
    joins build ``reader[i+1]``. ``eq``: [(accumulated PLAN-schema pos, build
    reader schema pos)]. ``kind``: inner | left | semi | anti (semi/anti
    append no build columns to the plan schema). ``str_keys``: [(probe
    (table_id, slot), build (table_id, slot))] string key pairs whose
    dictionaries unify at execution time. ``other``: non-equality join
    conditions for semi/anti joins (the Q21 ``<>`` idiom) — Expressions over
    the joined [accumulated plan cols ++ build cols] layout, evaluated as a
    pair filter inside the fragment."""

    eq: list
    exchange: str = "hash"  # hash | broadcast
    unique: bool = True
    kind: str = "inner"
    str_keys: list = field(default_factory=list)
    other: list = field(default_factory=list)


@dataclass
class SubplanReader:
    """A join build side that is itself an aggregate subplan — the shape the
    decorrelated correlated-aggregate rewrites produce (Q17's per-key
    0.2*AVG, grouped IN/EXISTS with HAVING, Q20's per-key 0.5*SUM). The
    aggregate MATERIALIZES through the Volcano executor (its reader runs the
    normal cop/device path, so the agg itself is device-accelerated where
    eligible); the JOIN against its output runs inside the fragment program.
    Canonical form [proj] ∘ [having] ∘ FinalAgg ∘ reader — covers the TPC-H
    tier and serializes losslessly for remote dispatch. Output lanes are in
    chunk-physical representation (decimals scaled, etc.), identical to what
    the host executor joins against — parity by construction."""

    plan: object  # the top physical node — the materialization entry point
    reader: PhysTableReader  # base reader: identity, versioning, stats
    agg: PhysFinalAgg
    having: list  # Expressions over the agg output (HAVING residue)
    proj: Optional[list]  # Expressions over the filtered agg output, or None
    schema: Schema = field(default_factory=list)
    # output positions holding ALL the agg group keys (the uniqueness proof:
    # join keys covering them make the build side unique); None = unprovable
    group_pos: Optional[frozenset] = None
    # stage-chain extensions: ``chain`` = (readers, joins, filters) when the
    # agg's input is itself a join chain (agg-over-join build sides — the
    # derived-table shapes that used to refuse MPP outright); ``staged`` =
    # the planner proved the whole subplan runs as a DEVICE stage inside the
    # consumer's fragment program (see mpp.DistStageSpec) — its output slots
    # stay HBM-resident and the consumer join's all_to_all re-partitions
    # them on the new key, no host round-trip
    chain: Optional[tuple] = None
    staged: bool = False

    # duck-typed touch points shared with plain reader build sides
    pushed_agg = None
    pushed_conditions: tuple = ()
    partitions = None
    scan_slots: tuple = ()

    @property
    def table(self):
        return self.reader.table

    def fingerprint(self) -> str:
        """Value identity for device-lane caching and compile keys."""
        rd = self.reader
        rd_agg = None
        if rd.pushed_agg is not None:
            rd_agg = (
                [g.to_pb() for g in rd.pushed_agg.group_by],
                [a.to_pb() for a in rd.pushed_agg.aggs],
                rd.pushed_agg_mode,
            )
        chain_fp = None
        if self.chain is not None:
            readers, joins, filters = self.chain
            chain_fp = (
                [
                    (r.table.id, tuple(r.scan_slots), [c.to_pb() for c in r.pushed_conditions])
                    for r in readers
                ],
                # other/str_keys are compiled into the stage's pair-filter
                # closures — omitting them would collide two staged programs
                # that differ only in a semi/anti pair condition
                [
                    (j.eq, j.exchange, j.unique, j.kind, [c.to_pb() for c in j.other], j.str_keys)
                    for j in joins
                ],
                [(pos, [c.to_pb() for c in cl]) for pos, cl in filters],
            )
        return repr(
            (
                tuple(rd.scan_slots),
                [c.to_pb() for c in rd.pushed_conditions],
                rd_agg,
                [g.to_pb() for g in self.agg.group_by],
                [a.to_pb() for a in self.agg.aggs],
                bool(self.agg.partial_input),
                [c.to_pb() for c in self.having],
                [e.to_pb() for e in self.proj] if self.proj is not None else None,
                chain_fp,
                self.staged,
            )
        )

    def rows_estimate(self, stats):
        """Build-side cardinality for the exchange choice: the agg emits at
        most ∏ group-key NDV rows (64 per unresolvable key), capped by the
        base table's row count."""
        st = stats.get(self.reader.table.id) if stats is not None else None
        if st is None or not st.row_count:
            return None
        npart = len(self.reader.schema) - len(self.agg.group_by)
        ndv = 1.0
        for gi, g in enumerate(self.agg.group_by):
            cs = None
            if isinstance(g, ColumnRef):
                # pushed-partial readers carry source slots on the trailing
                # group OutCols; plain readers on the ref's own position
                pos = npart + gi if self.agg.partial_input else g.index
                oc = self.reader.schema[pos] if 0 <= pos < len(self.reader.schema) else None
                if oc is not None and oc.slot >= 0:
                    cs = st.cols.get(oc.slot)
            ndv *= cs.ndv if cs is not None and cs.ndv else 64
        return max(min(ndv, float(st.row_count)), 1.0)


@dataclass
class PhysMPPGather(PhysicalPlan):
    """Root of an MPP task tree (ref: PhysicalTableReader with mpp task root
    + MPPGather executor)."""

    agg: Optional[PhysFinalAgg]  # None → TopN/limit tail
    readers: list = field(default_factory=list)
    joins: list = field(default_factory=list)
    topn: Optional[tuple] = None  # ([(ColumnRef, desc)], limit)
    # post-join filters: [(position, [Expression])] — position k evaluates
    # over the accumulated plan layout after the k-th join (0 = before any);
    # WHERE residue that compares across join sides lands here
    filters: list = field(default_factory=list)
    schema: Schema = field(default_factory=list)
    children: list = field(default_factory=list)

    # -- compat accessors (EXPLAIN rendering, tests) -----------------------
    @property
    def left(self) -> PhysTableReader:
        return self.readers[0]

    @property
    def right(self) -> Optional[PhysTableReader]:
        return self.readers[1] if len(self.readers) > 1 else None

    @property
    def exchange(self) -> str:
        return self.joins[0].exchange if self.joins else "hash"

    @property
    def fragments(self) -> list[str]:
        out = []
        fi = 1
        if not self.joins:
            out.append(
                f"Fragment#{fi} [mpp] {self.readers[0].table.name}: Scan -> Selection -> PartialAgg -> HashExchange"
            )
            fi += 1
        else:
            probe = self.readers[0].table.name
            for j, join in enumerate(self.joins):
                r = self.readers[j + 1]
                build = r.table.name
                ops = "Scan -> Agg -> Selection" if isinstance(r, SubplanReader) else "Scan -> Selection"
                ex = "BroadcastExchange" if join.exchange == "broadcast" else "HashExchange"
                out.append(f"Fragment#{fi} [mpp] {build}: {ops} -> {ex}")
                fi += 1
            tail = "PartialAgg -> HashExchange" if self.agg is not None else (
                "TopN" if self.topn and self.topn[0] else "Limit"
            )
            joins = " -> ".join(
                "Join -> Filter" if (j.other or any(pos == ji + 1 for pos, _ in self.filters)) else "Join"
                for ji, j in enumerate(self.joins)
            )
            out.append(f"Fragment#{fi} [mpp] {probe}: Scan -> Selection -> {joins} -> {tail}")
            fi += 1
        if self.agg is not None:
            out.append(f"Fragment#{fi} [mpp] MergeAgg -> PassThrough(gather)")
        else:
            out.append(f"Fragment#{fi} [mpp] PassThrough(gather) -> root merge")
        return out


def _right_side_unique(reader: PhysTableReader, key_slots: list[int]) -> bool:
    t = reader.table
    if t.pk_is_handle and key_slots == [t.pk_offset]:
        return True
    for idx in t.indexes:
        if idx.state != "public":
            continue  # a mid-DDL unique index hasn't proven uniqueness yet
        if (idx.unique or idx.primary) and sorted(idx.column_offsets) == sorted(key_slots):
            return True
    return False


def _reader_mpp_ok(reader: PhysTableReader) -> bool:
    return (
        isinstance(reader, PhysTableReader)
        and reader.pushed_agg is None
        and reader.pushed_topn is None
        and reader.pushed_limit is None
        and reader.pushed_window is None
        and all(can_push_down(c, "gpu") for c in reader.pushed_conditions)
    )


def _distinct_handled(a: AggDesc) -> bool:
    """Distinct aggs the fragment dedups via the (g, x) exchange; min/max
    distinct is a no-op and runs as plain min/max."""
    return a.distinct and a.name in ("count", "sum", "avg")


def _agg_mpp_ok(agg: PhysFinalAgg) -> bool:
    if getattr(agg, "rollup", False):
        # grouping sets run the fused one-pass rollup on the cop path (a
        # (G+1)-hot MXU dot); the fragment spec has no Expand yet
        return False
    darg_pb = None
    for a in agg.aggs:
        if a.name not in ("count", "sum", "avg", "min", "max"):
            return False
        if _distinct_handled(a):
            if a.arg is None:
                return False
            if a.arg.ftype.kind == TypeKind.STRING and not (
                a.name == "count" and isinstance(a.arg, ColumnRef) and a.arg.ftype.collation != "ci"
            ):
                # count-distinct over dict codes is exact (code ≡ value,
                # modulo ci folding); sum/avg of codes is meaningless
                return False
            pb = repr(a.arg.to_pb())
            if darg_pb is None:
                darg_pb = pb
            elif pb != darg_pb:
                return False  # one shared distinct tuple per gather
        if a.name in ("min", "max") and a.arg is not None and a.arg.ftype.kind == TypeKind.STRING:
            return False  # dict codes are identities, not an order
        if a.arg is not None and not can_push_down(a.arg, "gpu"):
            return False
    for g in agg.group_by:
        if not can_push_down(g, "gpu"):
            return False
        if g.ftype.kind == TypeKind.STRING and not isinstance(g, ColumnRef):
            return False  # string group keys must map to a table dictionary
    return True


FORCE_EXCHANGE: str | None = None  # test hook: "hash" | "broadcast"


def _choose_exchange(
    l_rows: int | None,
    r_rows: int | None,
    ndev: int,
    bcast_thr: int = 100_000,
    l_resident: bool = False,
    r_resident: bool = False,
    hbm_frac: float = 0.0,
) -> str:
    """Stats-driven exchange choice (ref: fragment.go:235 exchange-type cost):
    broadcast replicates the build side to every shard (moves r*(ndev-1)
    rows); hash shuffles both sides (moves ~(l+r)*(ndev-1)/ndev rows) and
    then pays per-shard routing on the probe side. Broadcast wins whenever
    replicating the build side is cheaper than routing the probe side.
    Without stats on a side, fall back to an absolute build-side cap rather
    than guessing a probe size (a large analyzed build side must not be
    replicated just because the probe is un-analyzed).

    Residency terms (the placement-aware refinement): ``l_resident`` — the
    probe side's columns are already DEVICE-resident, so hash-routing them
    allocates fresh routed buffers and forfeits the residency, while
    broadcast probes them in place (broadcast earns a 2× allowance);
    ``hbm_frac`` — fleet HBM pressure from the health reports; replicating a
    build side ndev× under pressure evicts hot columns, so the broadcast
    cap shrinks 8× past 85% occupancy."""
    if FORCE_EXCHANGE is not None:
        return FORCE_EXCHANGE
    if bcast_thr <= 0:
        return "hash"  # the TiDB idiom: threshold 0 disables broadcast
    thr = bcast_thr // 8 if hbm_frac > 0.85 else bcast_thr
    if r_rows is None or l_rows is None:
        small = r_rows if r_rows is not None else 0
        return "broadcast" if small <= thr else "hash"
    if r_rows > thr:
        return "hash"  # build side exceeds the (pressure-scaled) cap
    bonus = 2 if l_resident and not r_resident else 1
    if r_rows * max(ndev - 1, 1) <= max(l_rows, 1) * bonus:
        return "broadcast"
    return "hash"


def _chain_cond_ok(c: Expression) -> bool:
    """Device admission for a post-join / pair condition evaluated over the
    accumulated fragment lanes: engine-legal and string-free (joined-layout
    references have no single binder dictionary to legalize against)."""
    if not can_push_down(c, "gpu"):
        return False

    def no_str(e) -> bool:
        if isinstance(e, (ColumnRef, Constant)) and e.ftype.kind == TypeKind.STRING:
            return False
        return all(no_str(k) for k in e.children())

    return no_str(c)


def _stage_agg_of(sub: SubplanReader):
    """The COMPLETE (group_by, aggs) a device stage would compute over the
    subplan's RAW scan lanes, or None. Three normal forms: a chain subplan's
    final agg (positions over the accumulated chain schema); a plain
    reader's final agg; a pushed-partial reader's ORIGINAL agg re-rooted
    (the planner pushed the partial below the exchange — the pushed
    LogicalAggregation holds the pre-pushdown shape over scan positions)."""
    rd = sub.reader
    if sub.chain is not None:
        return (sub.agg.group_by, sub.agg.aggs) if not sub.agg.partial_input else None
    if sub.agg.partial_input:
        if rd.pushed_agg is None:
            return None
        return rd.pushed_agg.group_by, rd.pushed_agg.aggs
    if rd.pushed_agg is not None:
        return None
    return sub.agg.group_by, sub.agg.aggs


def _stage_eligible(sub: SubplanReader) -> bool:
    """Device admission for running the WHOLE subplan as a fragment stage:
    every agg, group key, HAVING residue, and projection must evaluate on
    the engine over int/float lanes. Scalar aggregates stay host-side (a
    one-row-even-when-empty contract the padded stage cannot honor)."""
    got = _stage_agg_of(sub)
    if got is None:
        return False
    gb, aggs = got
    if not gb:
        return False
    for a in aggs:
        if a.name not in ("count", "sum", "avg", "min", "max") or a.distinct:
            return False
        if a.arg is not None:
            if not can_push_down(a.arg, "gpu"):
                return False
            if a.arg.ftype.kind == TypeKind.STRING and a.name != "count":
                return False  # codes are identities, not values/an order
    for g in gb:
        if not can_push_down(g, "gpu"):
            return False
        if g.ftype.kind == TypeKind.STRING and not isinstance(g, ColumnRef):
            return False
    if not all(_chain_cond_ok(c) for c in sub.having):
        return False
    if sub.proj is not None and not all(_chain_cond_ok(e) for e in sub.proj):
        return False
    readers = sub.chain[0] if sub.chain is not None else [sub.reader]
    for r in readers:
        if not all(can_push_down(c, "gpu") for c in r.pushed_conditions):
            return False
    return True


def _subplan_side(
    r: PhysicalPlan, stats=None, get_ndev=None, bcast_thr: int = 100_000
) -> Optional[SubplanReader]:
    """Admit an aggregate subplan as a join build side — canonical form
    [PhysProjection] → [PhysSelection] → PhysFinalAgg → (PhysTableReader |
    join chain). The reader form covers the decorrelated correlated-
    aggregate shapes; the chain form covers derived-table agg-over-join
    build sides, admitted ONLY when the whole subplan is stage-eligible
    (it executes as a device stage — there is no host materialization
    contract for a chain). Returns the wrapper or None."""
    top = r
    proj = None
    if isinstance(r, PhysProjection):
        proj, r = r, r.children[0]
    having: list = []
    if isinstance(r, PhysSelection):
        having, r = list(r.conditions), r.children[0]
    chain = None
    if (
        isinstance(r, PhysMPPGather)
        and r.agg is not None
        and r.topn is None
        and r.joins
        and not any(isinstance(x, SubplanReader) for x in r.readers)
        and not any(x.pushed_agg is not None for x in r.readers)
        and not any(j.kind == "right" for j in r.joins)
    ):
        # a bottom-up-rewritten derived table: the walk already lifted the
        # agg-over-join into ITS OWN gather — re-absorb it as a device stage
        # of the consumer, so both fragments compose into ONE program with
        # an on-device repartition instead of two programs and a host hop
        # (right joins pad the accumulated layout mid-chain: not stageable)
        agg = PhysFinalAgg(
            group_by=r.agg.group_by,
            aggs=r.agg.aggs,
            partial_input=False,
            schema=list(r.schema),
            children=[],
        )
        chain = (list(r.readers), list(r.joins), list(r.filters))
        rd = r.readers[0]
    else:
        if not (isinstance(r, PhysFinalAgg) and not getattr(r, "rollup", False)):
            return None
        agg = r
        rd = agg.children[0] if agg.children else None
        if not (
            isinstance(rd, PhysTableReader)
            and rd.pushed_topn is None
            and rd.pushed_limit is None
            and rd.pushed_window is None
        ):
            if rd is None or get_ndev is None or agg.partial_input:
                return None
            flat = _flatten_join_chain(rd, stats, get_ndev, bcast_thr)
            if (
                flat is None
                or not flat[1]
                or any(isinstance(x, SubplanReader) for x in flat[0])
                or any(j.kind == "right" for j in flat[1])
            ):
                return None  # no nested stages; right joins pad the layout
            chain = (flat[0], flat[1], flat[2])
            rd = flat[0][0]
    if any(a.name == "group_concat" for a in agg.aggs):
        return None  # string-valued output lanes have no device identity
    schema = top.schema
    if any(oc.ftype.kind == TypeKind.STRING for oc in schema):
        return None  # derived lanes carry no dictionary
    n_aggs = len(agg.aggs)
    gset = set(range(n_aggs, n_aggs + len(agg.group_by)))
    if proj is None:
        gpos: Optional[frozenset] = frozenset(gset)
    else:
        covered = {e.index for e in proj.exprs if isinstance(e, ColumnRef)}
        gpos = (
            frozenset(
                i for i, e in enumerate(proj.exprs) if isinstance(e, ColumnRef) and e.index in gset
            )
            if gset <= covered
            else None  # a dropped group key: uniqueness unprovable
        )
    sub = SubplanReader(
        plan=top,
        reader=rd,
        agg=agg,
        having=having,
        proj=list(proj.exprs) if proj is not None else None,
        schema=list(schema),
        group_pos=gpos,
        chain=chain,
    )
    sub.staged = _stage_eligible(sub)
    if chain is not None and not sub.staged:
        return None  # chain subplans have no host-materialization fallback
    return sub


def _flatten_join_chain(p: PhysicalPlan, stats, get_ndev, bcast_thr: int = 100_000, res=None):
    """Left-deep chain of equi-joins over MPP-eligible readers →
    (readers, joins, filters, probe_row_estimate) or None. eq_conds left
    positions index the child-0 schema, which for a left-deep chain IS the
    accumulated reader schema, so they carry over unchanged. ``filters``:
    [(position, [conditions])] — Selections interposed in the chain (and
    inner-join other_conds) become post-join fragment filters at the join
    count where they appeared. ``get_ndev`` is lazy: mesh construction (JAX
    backend init) only happens once a candidate matched. ``res``: optional
    (table_id → device-resident?, hbm_frac) residency context feeding the
    exchange-type cost model."""
    if isinstance(p, PhysSelection):
        base = _flatten_join_chain(p.children[0], stats, get_ndev, bcast_thr, res)
        if base is None or not all(_chain_cond_ok(c) for c in p.conditions):
            return None
        readers, joins, filters, rows = base
        return (readers, joins, filters + [(len(joins), list(p.conditions))], rows)
    if isinstance(p, PhysTableReader):
        if not _reader_mpp_ok(p):
            return None
        rows = None
        if stats is not None:
            st = stats.get(p.table.id)
            if st is not None:
                rows = st.row_count
                if p.pushed_conditions and rows:
                    # post-selection cardinality drives the exchange choice:
                    # a selective filter can shrink a "big" build side under
                    # the broadcast threshold (ref: cardinality.Selectivity)
                    from tidb_tpu_torch.statistics.selectivity import estimate_selectivity

                    rows = max(rows * estimate_selectivity(p.pushed_conditions, p.schema, st), 1.0)
        return ([p], [], [], rows)
    if (
        isinstance(p, PhysHashJoin)
        and p.kind in ("inner", "left", "semi", "anti", "right")
        and p.eq_conds
        and not p.null_aware
        and len(p.children) == 2
    ):
        other = list(p.other_conds)
        if other:
            # inner-join other_conds are exactly post-join filters; semi/anti
            # ones gate EXISTENCE per candidate pair (the fragment's filtered
            # expansion). Outer kinds change NULL-extension semantics — host.
            if p.kind not in ("inner", "semi", "anti"):
                return None
            if not all(_chain_cond_ok(c) for c in other):
                return None
        base = _flatten_join_chain(p.children[0], stats, get_ndev, bcast_thr, res)
        if base is None:
            return None
        r = p.children[1]
        eq_conds = list(p.eq_conds)
        nleft_node = len(p.children[0].schema)
        # aggregate subplans admit BEFORE projection peeling: the projection
        # is part of the subplan's OUTPUT contract — peeling it would leave
        # the accumulated layout in agg-output order while the builder
        # resolved later references (outer agg args, post-join filters)
        # against the projection's order
        sub = _subplan_side(r, stats, get_ndev, bcast_thr)
        if sub is not None:
            r = sub
        r_pre_peel = r
        # column-only projections over the build reader (subquery rewrites
        # emit them) just remap the right key positions — and the right-side
        # refs of any other_conds, which the builder resolved against the
        # [left ++ projection-output] joined layout
        while sub is None and isinstance(r, PhysProjection) and all(isinstance(e, ColumnRef) for e in r.exprs):
            eq_conds = [(lp, r.exprs[rp].index) for lp, rp in eq_conds]
            if other:
                if p.kind not in ("semi", "anti"):
                    # a peeled build projection widens the accumulated plan
                    # schema — inner-join post-fold filters would misindex
                    return None
                from tidb_tpu_torch.planner.optimizer import _expr_cols as _oc
                from tidb_tpu_torch.planner.optimizer import _remap_expr

                refs: set = set()
                for c in other:
                    _oc(c, refs)
                mapping = {
                    i: (i if i < nleft_node else nleft_node + r.exprs[i - nleft_node].index)
                    for i in refs
                }
                other = [_remap_expr(c, mapping) for c in other]
            r = r.children[0]
        if sub is None and not (isinstance(r, PhysTableReader) and _reader_mpp_ok(r)):
            if r is r_pre_peel:
                return None  # nothing peeled: the pre-peel probe already said no
            sub = _subplan_side(r, stats, get_ndev, bcast_thr)
            if sub is None:
                return None
            r = sub
        readers, joins, filters, probe_rows = base
        acc_cols = _plan_schema_len(readers, joins)
        if any(lp >= acc_cols or rp >= len(r.schema) for lp, rp in eq_conds):
            return None
        key_slots = [r.schema[rp].slot for _, rp in eq_conds]
        key_types = [r.schema[rp].ftype for _, rp in eq_conds]
        str_keys = []
        for (lp, rp), ft in zip(eq_conds, key_types):
            lsrc = _plan_col_source(readers, joins, lp)
            if ft.kind == TypeKind.STRING or (lsrc is not None and lsrc[2].kind == TypeKind.STRING):
                if (
                    ft.kind != TypeKind.STRING
                    or lsrc is None
                    or lsrc[2].kind != TypeKind.STRING
                    or ft.collation == "ci"
                    or lsrc[2].collation == "ci"
                ):
                    return None  # mixed kinds / ci collation: host join
                str_keys.append(((lsrc[0], lsrc[1]), (r.table.id, r.schema[rp].slot)))
        if sub is not None:
            # an aggregate's output is one row per group: join keys covering
            # every group key ARE a uniqueness proof (scalar agg: one row)
            unique = sub.group_pos is not None and sub.group_pos <= {rp for _, rp in eq_conds}
        else:
            unique = _right_side_unique(r, key_slots)
        # (multi-key semi/anti/left with a non-unique build side no longer
        # fall back to the host join: the fragment's packed-exact composite
        # keys — static-bound packing or rank compression — keep existence
        # semantics collision-free; see mpp._exact_pair_lanes)
        if p.kind == "right" and len(eq_conds) > 1:
            # build-side outer preservation rides exact per-build-row match
            # counts — single-key only (a mixed-hash count could mask a
            # legitimately unmatched build row)
            return None
        r_rows = None
        st = stats.get(r.table.id) if stats is not None else None
        if sub is not None:
            r_rows = sub.rows_estimate(stats)
        elif st is not None:
            r_rows = st.row_count
            if r.pushed_conditions and r_rows:
                from tidb_tpu_torch.statistics.selectivity import estimate_selectivity

                r_rows = max(r_rows * estimate_selectivity(r.pushed_conditions, r.schema, st), 1.0)
        res_fn, hbm_frac = res if res is not None else (None, 0.0)
        # the probe-residency allowance only applies to the FIRST fold: later
        # joins probe an accumulated intermediate (freshly routed buffers),
        # whose base table's residency protects nothing
        l_res = bool(res_fn(readers[0].table.id)) if res_fn is not None and not joins else False
        exchange = _choose_exchange(
            probe_rows,
            r_rows,
            get_ndev(),
            bcast_thr,
            l_resident=l_res,
            r_resident=bool(res_fn(r.table.id)) if res_fn is not None else False,
            hbm_frac=hbm_frac,
        )
        if other and p.kind == "inner":
            # inner-join other_conds filter joined rows AFTER the fold — the
            # builder resolved them over [left ++ right] = the accumulated
            # plan layout once this join appends its build columns
            filters = filters + [(len(joins) + 1, other)]
        joins = joins + [
            MPPJoin(
                eq=list(eq_conds),
                exchange=exchange,
                unique=unique,
                kind=p.kind,
                str_keys=str_keys,
                other=other if p.kind in ("semi", "anti") else [],
            )
        ]
        out_rows = probe_rows
        if p.kind == "inner" and not unique and probe_rows is not None and r_rows is not None:
            # expansion estimate for the NEXT join's exchange-cost
            # comparison: histogram+TopN join cardinality when the single
            # join-key columns are analyzed on both sides, the NDV fan-out
            # heuristic otherwise (ref: cardinality join estimation)
            est = None
            if len(eq_conds) == 1 and st is not None and not str_keys:
                # (string keys: each side's stats store its OWN dictionary's
                # codes — cross-table code comparison is meaningless)
                lp, rp = eq_conds[0]
                lsrc = _plan_col_source(readers, joins[:-1], lp)
                lst = stats.get(lsrc[0]) if lsrc is not None else None
                lcs = lst.cols.get(lsrc[1]) if lst is not None else None
                rcs = st.cols.get(r.schema[rp].slot)
                if lcs is not None and rcs is not None and lst.row_count and st.row_count:
                    from tidb_tpu_torch.statistics.selectivity import estimate_join_rows

                    # estimate over the BASE tables, then scale by how much
                    # each side's effective cardinality (filters, upstream
                    # expansions) differs — TopN counts are base-table counts
                    base_est = estimate_join_rows(
                        lcs, rcs, float(lst.row_count), float(st.row_count)
                    )
                    est = base_est * (probe_rows / lst.row_count) * (r_rows / st.row_count)
            if est is not None:
                out_rows = est
            else:
                ndv = None
                if len(key_slots) == 1 and st is not None:
                    cs = st.cols.get(key_slots[0])
                    ndv = cs.ndv if cs is not None else None
                fan = max(r_rows // max(ndv, 1), 1) if ndv else 2
                out_rows = probe_rows * fan
        return (readers + [r], joins, filters, out_rows)
    return None


def _lane_layout(readers: list, joins: list):
    """Accumulated lane layout over a reader chain: reader k contributes
    2*ncols_k+1 lanes (data/valid interleaved + live). Returns (n_lanes per
    reader, lane_of: accumulated-schema pos → data lane index). Semi/anti
    build readers exist in the INPUT but fold no lanes into the accumulated
    layout, so the offset does not move past them. Shared by the outer plan
    and the join chains inside device stages."""
    n_lanes = [2 * len(r.schema) + 1 for r in readers]
    lane_of = []
    off = 0
    for ri, r in enumerate(readers):
        in_plan = ri == 0 or joins[ri - 1].kind in ("inner", "left", "right")
        if in_plan:
            for i in range(len(r.schema)):
                lane_of.append(off + 2 * i)
            off += 2 * len(r.schema) + 1
    return n_lanes, lane_of


def _plan_schema_len(readers: list, joins: list) -> int:
    """Length of the accumulated PLAN schema: semi/anti joins contribute no
    build columns."""
    n = len(readers[0].schema)
    for ji, j in enumerate(joins):
        if j.kind in ("inner", "left", "right"):
            n += len(readers[ji + 1].schema)
    return n


def _plan_col_source(readers: list, joins: list, pos: int):
    """(table_id, slot, ftype) for accumulated plan-schema position."""
    if pos < len(readers[0].schema):
        oc = readers[0].schema[pos]
        return (readers[0].table.id, oc.slot, oc.ftype)
    pos -= len(readers[0].schema)
    for ji, j in enumerate(joins):
        if j.kind not in ("inner", "left", "right"):
            continue
        r = readers[ji + 1]
        if pos < len(r.schema):
            oc = r.schema[pos]
            return (r.table.id, oc.slot, oc.ftype)
        pos -= len(r.schema)
    return None


def try_mpp_rewrite(plan: PhysicalPlan, vars: dict, stats=None, store=None, health=None) -> PhysicalPlan:
    """Rewrite eligible FinalAgg/TopN/Limit-over-join subtrees into
    PhysMPPGather (ref: the planner preferring mpp task type under
    tidb_allow_mpp). ``health``: the DB's StoreHealthRegistry, feeding the
    exchange-type cost model real residency/HBM signals (placement-aware
    fragment scheduling) — None degrades to the pure row-count model."""
    if not sysvar_int(vars, "tidb_allow_mpp", 1):
        return plan
    enforce = sysvar_int(vars, "tidb_enforce_mpp", 0)

    # residency context for _choose_exchange: per-table device/columnar
    # residency from the locally readable cache (embedded stores and the
    # hybrid sharded coordinator — remote dispatch cannot see server
    # residency and degrades to row counts), plus fleet HBM pressure from
    # the last health sweep. Peeks only: planning must never build a cache.
    def _res_fn(tid: int) -> bool:
        if store is None:
            return False
        try:
            from tidb_tpu_torch.copr.colcache import peek_resident_bytes

            return peek_resident_bytes(store, tid) > 0
        except Exception:  # graftcheck: off=except-swallow
            return False  # residency is advisory; planning must not fail

    hbm_frac = 0.0
    if health is not None:
        try:
            from tidb_tpu_torch.copr.gpu_engine import planning_budget

            budget = float(planning_budget(store))
            for ent in health.reports().values():
                rep = ent.get("report") or {}
                b = float(rep.get("device_cache_bytes") or 0)
                if budget > 0:
                    hbm_frac = max(hbm_frac, b / budget)
        except Exception:  # graftcheck: off=except-swallow
            hbm_frac = 0.0  # pressure is advisory too
    res = (_res_fn, hbm_frac)

    # lazy: mesh construction triggers JAX backend init (seconds of cold
    # start) — only pay it when a query actually matches an MPP shape. A
    # remote-backed SQL layer asks the STORAGE server for its mesh size
    # (the fragment program runs there; this process never touches jax).
    _ndev_memo: list = []

    def get_ndev() -> int:
        if not _ndev_memo:
            try:
                if store is not None and hasattr(store, "mpp_ndev"):
                    _ndev_memo.append(int(store.mpp_ndev()))
                else:
                    from tidb_tpu_torch.parallel import make_mesh

                    _ndev_memo.append(make_mesh().devices.size)
            except Exception:
                _ndev_memo.append(1)
        return _ndev_memo[0]

    def _try_agg_below_join(p: PhysFinalAgg, readers: list, joins: list):
        """Partial-agg pushdown below the join (ref: the aggregation-
        pushdown-through-join rule): when every agg arg reads the probe
        reader only, the probe side pre-aggregates by (join keys ∪ its group
        keys) THROUGH THE COPROCESSOR (device block path) before entering
        the MPP pipeline, and the pipeline sums the partial lanes. A 10:1
        key fan-in turns a 4M-row join into a 400k-row join. Sum-of-partial-
        sums needs no group completeness, so per-region/per-block partial
        duplicates are harmless. Returns the rewritten plan or None."""
        from tidb_tpu_torch.planner.optimizer import _expr_cols as _acc_expr_cols
        from tidb_tpu_torch.planner.optimizer import _partial_schema, _remap_expr
        from tidb_tpu_torch.planner.plans import LogicalAggregation

        r0 = readers[0]
        n0 = len(r0.schema)
        if stats is None or any(j.kind != "inner" for j in joins):
            return None
        if any(_distinct_handled(a) for a in p.aggs):
            return None  # partial pre-agg below the join cannot dedup globally
        st0 = stats.get(r0.table.id)
        if st0 is None or st0.row_count <= 0:
            return None
        # every agg argument must read reader-0 columns only
        arg_cols: set[int] = set()
        for a in p.aggs:
            if a.arg is not None:
                _acc_expr_cols(a.arg, arg_cols)
        if any(c >= n0 for c in arg_cols):
            return None
        # pre-group keys: reader-0 join keys (all joins) + reader-0 group keys
        pre_keys: list[int] = []
        for join in joins:
            for lp, _ in join.eq:
                if lp < n0 and lp not in pre_keys:
                    pre_keys.append(lp)
                elif lp >= n0:
                    pass  # later-join keys on build lanes shift below
        for g in p.group_by:
            if isinstance(g, ColumnRef) and g.index < n0:
                if g.index not in pre_keys:
                    pre_keys.append(g.index)
            else:
                s: set[int] = set()
                _acc_expr_cols(g, s)
                if any(c < n0 for c in s) and not isinstance(g, ColumnRef):
                    return None  # expression group key over probe cols: skip
        if not pre_keys:
            return None
        # only worthwhile when the pre-agg actually collapses rows
        ndv = 1
        for pos in pre_keys:
            cs = st0.cols.get(r0.schema[pos].slot)
            ndv *= cs.ndv if cs is not None and cs.ndv else st0.row_count
        if ndv * 2 > st0.row_count:
            return None
        pushed = LogicalAggregation(
            group_by=[ColumnRef(pos, r0.schema[pos].ftype, r0.schema[pos].name) for pos in pre_keys],
            aggs=list(p.aggs),
            schema=[],
            children=[r0],  # _partial_schema resolves group-key slots here
        )
        pre_schema = _partial_schema(pushed)
        n_lanes_partial = len(pre_schema) - len(pre_keys)
        r0p = PhysTableReader(
            db=r0.db,
            table=r0.table,
            store_type=r0.store_type,
            pushed_conditions=list(r0.pushed_conditions),
            pushed_agg=pushed,
            pushed_agg_mode="partial",
            scan_slots=list(r0.scan_slots),
            ranges=r0.ranges,
            schema=pre_schema,
        )
        delta = len(pre_schema) - n0

        def remap_left(lp: int) -> int:
            if lp < n0:
                return n_lanes_partial + pre_keys.index(lp)
            return lp + delta

        new_joins = [
            MPPJoin(
                eq=[(remap_left(lp), rp) for lp, rp in join.eq],
                exchange=join.exchange,
                unique=join.unique,
            )
            for join in joins
        ]
        new_groups = []
        for g in p.group_by:
            if isinstance(g, ColumnRef) and g.index < n0:
                new_groups.append(ColumnRef(n_lanes_partial + pre_keys.index(g.index), g.ftype, g.name))
            elif isinstance(g, ColumnRef):
                new_groups.append(ColumnRef(g.index + delta, g.ftype, g.name))
            else:
                s = set()
                _acc_expr_cols(g, s)
                new_groups.append(_remap_expr(g, {i: i + delta for i in s}))
        # partial lanes re-reduce by their own kind: count/sum lanes SUM,
        # min/max lanes MIN/MAX (min of mins is exact)
        lane_kinds = []
        for a in p.aggs:
            for pk in a.partial_kinds:
                lane_kinds.append(pk if pk in ("min", "max") else "sum")
        syn_aggs = [
            AggDesc(lane_kinds[j], ColumnRef(j, pre_schema[j].ftype, pre_schema[j].name))
            for j in range(n_lanes_partial)
        ]
        syn = PhysFinalAgg(
            group_by=new_groups, aggs=syn_aggs, partial_input=False, schema=[], children=[]
        )
        from types import SimpleNamespace

        acc_schema = [oc for r in readers for oc in r.schema]
        orig_shape = LogicalAggregation(
            group_by=p.group_by, aggs=p.aggs, schema=[], children=[SimpleNamespace(schema=acc_schema)]
        )
        gather = PhysMPPGather(
            agg=syn,
            readers=[r0p] + readers[1:],
            joins=new_joins,
            schema=_partial_schema(orig_shape),
        )
        return PhysFinalAgg(
            group_by=p.group_by, aggs=p.aggs, partial_input=True, schema=p.schema, children=[gather]
        )

    bcast_thr = sysvar_int(vars, "tidb_broadcast_join_threshold_count", 100_000)

    def walk(p: PhysicalPlan) -> PhysicalPlan:
        for i, c in enumerate(getattr(p, "children", [])):
            p.children[i] = walk(c)
        # TopN/Limit over a join chain: per-shard heads inside the fragment
        if isinstance(p, PhysLimit):
            child = p.children[0]
            total = p.limit + p.offset
            if isinstance(child, PhysSort):
                from tidb_tpu_torch.planner.optimizer import _subst_refs

                below = child.children[0]
                by = list(child.by)
                host_parent, slot = child, 0
                # row-preserving projections between Sort and the join chain:
                # remap sort keys through them into the accumulated schema
                while isinstance(below, PhysProjection):
                    remapped = [(_subst_refs(e, below.exprs), d) for e, d in by]
                    if any(r is None for r, _ in remapped):
                        below = None
                        break
                    by = remapped
                    host_parent, slot = below, 0
                    below = below.children[0]
                flat = _flatten_join_chain(below, stats, get_ndev, bcast_thr, res) if below is not None else None
                if (
                    flat is not None
                    and flat[1]  # single-reader TopN is the coprocessor's job
                    and total <= 4096
                    and all(
                        isinstance(e, ColumnRef) and e.ftype.kind != TypeKind.STRING
                        for e, _ in by
                    )
                ):
                    readers, joins, filters, _ = flat
                    gather = PhysMPPGather(
                        agg=None,
                        readers=readers,
                        joins=joins,
                        topn=(by, total),
                        filters=filters,
                        schema=below.schema,
                    )
                    host_parent.children[slot] = gather
                    return p
            else:
                below = child
                host_parent, slot = p, 0
                while isinstance(below, PhysProjection):
                    host_parent, slot = below, 0
                    below = below.children[0]
                flat = _flatten_join_chain(below, stats, get_ndev, bcast_thr, res)
                if flat is not None and flat[1] and total <= 65536:
                    readers, joins, filters, _ = flat
                    gather = PhysMPPGather(
                        agg=None,
                        readers=readers,
                        joins=joins,
                        topn=([], total),
                        filters=filters,
                        schema=below.schema,
                    )
                    host_parent.children[slot] = gather
                    return p
        if not (isinstance(p, PhysFinalAgg) and _agg_mpp_ok(p)):
            return p
        child = p.children[0]
        if not p.partial_input:
            # row-preserving projections between the agg and the join chain
            # (scalar-subquery rewrites emit them): substitute their exprs
            # into the agg's group keys / arguments so the chain below is
            # reachable (the TopN path's peeling idiom)
            from tidb_tpu_torch.planner.optimizer import _subst_refs

            mpp_agg = p
            below = child
            while isinstance(below, PhysProjection):
                ng = [_subst_refs(g, below.exprs) for g in mpp_agg.group_by]
                na = []
                ok = all(g is not None for g in ng)
                for a in mpp_agg.aggs:
                    if a.arg is None:
                        na.append(a)
                        continue
                    arg = _subst_refs(a.arg, below.exprs)
                    if arg is None:
                        ok = False
                        break
                    na.append(
                        AggDesc(a.name, arg, distinct=a.distinct, sep=a.sep, order_by=a.order_by)
                    )
                if not ok:
                    break
                mpp_agg = PhysFinalAgg(
                    group_by=ng, aggs=na, partial_input=False, schema=p.schema, children=[]
                )
                below = below.children[0]
            if mpp_agg is not p and not _agg_mpp_ok(mpp_agg):
                mpp_agg, below = p, child  # substituted args not device-legal
            flat = _flatten_join_chain(below, stats, get_ndev, bcast_thr, res)
            if flat is not None and flat[1]:
                readers, joins, filters, _ = flat
                if (
                    not filters
                    and not any(j.other for j in joins)
                    and not any(isinstance(r, SubplanReader) for r in readers)
                ):
                    # pre-agg pushdown collapses probe rows BEFORE any
                    # post-join filter could see them — plain chains only
                    pushed_below = _try_agg_below_join(mpp_agg, readers, joins)
                    if pushed_below is not None:
                        return pushed_below
                return PhysMPPGather(
                    agg=mpp_agg, readers=readers, joins=joins, filters=filters, schema=p.schema
                )
            if (
                flat is not None
                and not flat[2]  # interposed Selections would be dropped
                and enforce
                and any(_distinct_handled(a) for a in mpp_agg.aggs)
            ):
                # single-table distinct agg: the coprocessor's per-region
                # partial lanes cannot dedup globally, but the (g, x)
                # exchange can — run the no-join fragment pipeline
                return PhysMPPGather(agg=mpp_agg, readers=list(flat[0]), joins=[], schema=p.schema)
        if (
            enforce
            and p.partial_input
            and isinstance(child, PhysTableReader)
            and child.pushed_agg is not None
            and child.pushed_topn is None
            and child.pushed_limit is None
            and all(can_push_down(c, "gpu") for c in child.pushed_conditions)
        ):
            # single-table MPP agg (exercised mainly by multi-device runs)
            agg = PhysFinalAgg(
                group_by=child.pushed_agg.group_by,
                aggs=child.pushed_agg.aggs,
                partial_input=False,
                schema=p.schema,
                children=[],
            )
            scan_schema = _scan_schema(child)
            reader = PhysTableReader(
                db=child.db,
                table=child.table,
                store_type=child.store_type,
                pushed_conditions=list(child.pushed_conditions),
                scan_slots=[s for s in child.scan_slots],
                schema=scan_schema,
                partitions=child.partitions,  # pruned views scan like regions
            )
            return PhysMPPGather(agg=agg, readers=[reader], joins=[], schema=p.schema)
        return p

    return walk(plan)


def _scan_schema(reader: PhysTableReader) -> Schema:
    t = reader.table
    out = []
    for slot in reader.scan_slots:
        c = t.columns[slot]
        out.append(OutCol(c.name, c.ftype, table=t.name, slot=slot))
    return out


def _make_join_specs(joins, nrows, bounds_acc, bounds_by_reader, lane_of, ndev: int):
    """MPPJoin chain → DistJoinSpec list with power-of-two bucketed caps and
    JOINT per-key value bounds (both sides must pack identically). Shared by
    the outer plan chain and the join chains inside device stages. left_keys
    of later joins need no rebase: after join ji the accumulated lane layout
    = probe lanes + build lanes, and ``lane_of`` is computed over the full
    reader list. Key-validity lanes enforce NULL-key semantics (inner-join
    keys must be non-NULL to match)."""
    from tidb_tpu_torch.parallel.mpp import DistJoinSpec

    shard = lambda n: max(_pow2(2 * ((max(n, 1) + ndev - 1) // ndev)), 64)
    probe_cap = shard(nrows[0])
    specs = []
    for ji, join in enumerate(joins):
        build_cap = shard(nrows[ji + 1])
        lane_eq_l = [lane_of[lp] for lp, _ in join.eq]
        # build reader's local lanes
        lane_eq_r = [2 * rp for _, rp in join.eq]
        kb = []
        for lp, rp in join.eq:
            lb = bounds_acc[lp] if lp < len(bounds_acc) else None
            rb = bounds_by_reader[ji + 1][rp]
            kb.append(
                (min(lb[0], rb[0]), max(lb[1], rb[1])) if lb is not None and rb is not None else None
            )
        specs.append(
            DistJoinSpec(
                left_keys=lane_eq_l,
                right_keys=lane_eq_r,
                kind=join.kind,
                exchange=join.exchange,
                left_row_cap=probe_cap,
                right_row_cap=build_cap,
                unique=join.unique,
                out_cap=max(_pow2(probe_cap), 1024),
                key_bounds=tuple(kb),
            )
        )
        if join.kind == "right":
            # the fragment appends one static build-sized segment of
            # (possibly) unmatched build rows to the accumulated layout
            base = specs[-1].out_cap if not join.unique else probe_cap
            probe_cap = base + build_cap
        elif not join.unique and join.kind in ("inner", "left"):
            probe_cap = specs[-1].out_cap
    for spec in specs:
        spec.left_key_valid = tuple(k + 1 for k in spec.left_keys)
        spec.right_key_valid = tuple(k + 1 for k in spec.right_keys)
    return specs


def _stage_parts_of(sub: SubplanReader):
    """(readers, joins, filters, group_by, aggs) of the device stage a
    staged SubplanReader executes: its RAW input readers, the join chain
    inside the stage, interposed filters, and the COMPLETE agg over the
    accumulated stage schema. A pushed-partial single reader is re-rooted to
    its pre-pushdown shape (raw scan lanes; the pushed LogicalAggregation
    holds the original group/agg expressions over scan positions)."""
    if sub.chain is not None:
        readers, joins, filters = sub.chain
        return list(readers), list(joins), list(filters), sub.agg.group_by, sub.agg.aggs
    rd = sub.reader
    if sub.agg.partial_input:
        gb, aggs = rd.pushed_agg.group_by, rd.pushed_agg.aggs
        bare = PhysTableReader(
            db=rd.db,
            table=rd.table,
            store_type=rd.store_type,
            pushed_conditions=list(rd.pushed_conditions),
            scan_slots=list(rd.scan_slots),
            ranges=rd.ranges,
            schema=_scan_schema(rd),
            partitions=rd.partitions,
        )
        return [bare], [], [], gb, aggs
    return [rd], [], [], sub.agg.group_by, sub.agg.aggs


# ---------------------------------------------------------------------------
# coordinator / executor
# ---------------------------------------------------------------------------


class MPPGatherExec:
    """Materialize shard inputs, jit the fragment pipeline over the mesh,
    merge the replicated partials (or gathered heads) into the result chunk."""

    def __init__(self, plan: PhysMPPGather, session):
        self.plan = plan
        self.session = session
        self.schema = plan.schema

    # -- input materialization ------------------------------------------------
    def _reader_arrays(self, reader: PhysTableReader):
        """Reader materialization for one MPP side, MVCC-consistent at the
        session read ts. Pre-aggregated readers (agg pushed below the join)
        execute AS-IS through the coprocessor — scan, selection, and the
        partial agg all run on the reader's engine (device block path) and
        only the collapsed rows reach the exchange. Plain readers assemble
        columns STRAIGHT from the columnar cache (ref: the in-fragment
        tableScan, cophandler/mpp_exec.go:136) — no Volcano tree, no
        per-region chunk copies, no dictionary re-encoding; their conditions
        evaluate inside the fragment program on device."""
        import numpy as np

        from tidb_tpu_torch.executor.executors import TableReaderExec

        if isinstance(reader, SubplanReader):
            # decorrelated aggregate build side: materialize the whole
            # [proj]∘[having]∘FinalAgg∘reader subplan through the Volcano
            # executor (its reader rides the normal cop/device path) — the
            # chunk is in the same physical representation the host engine
            # joins against, so fragment-side comparisons agree bit-exactly
            if reader.chain is not None:
                # chain subplans are admitted staged-only; the stage path
                # materializes raw reader lanes and never lands here
                from tidb_tpu_torch.parallel.probe import MPPRetryExhausted

                raise MPPRetryExhausted("chain subplan build side has no host materialization")
            if self.session._txn_dirty():
                # the union-scan overlay cannot reach through the agg
                from tidb_tpu_torch.parallel.probe import MPPRetryExhausted

                raise MPPRetryExhausted("mpp subplan build side cannot observe txn-local mutations")
            from tidb_tpu_torch.executor.executors import build_executor

            chunk = build_executor(reader.plan, self.session).execute()
            # an intermediate fragment result crossed the host boundary —
            # the quantity the staged pipeline (SubplanReader.staged) keeps
            # at zero; bench lanes and stage-chain tests assert on it
            from tidb_tpu_torch.utils import metrics as _m

            _m.MPP_HOST_INTERMEDIATE.inc(
                sum(c.data.nbytes + c.validity.nbytes for c in chunk.columns)
            )
            return chunk
        if reader.pushed_agg is not None:
            return TableReaderExec(reader, self.session).execute()
        if self.session._txn_dirty():
            # uncommitted session writes live in the txn buffer, not the
            # columnar cache — route through the executor so the union-scan
            # overlay applies (ref: UnionScanExec over dirty tables)
            from tidb_tpu_torch.kv.kv import StoreType

            bare = PhysTableReader(
                db=reader.db,
                table=reader.table,
                store_type=StoreType.HOST,
                scan_slots=list(reader.scan_slots),
                schema=reader.schema,
                partitions=reader.partitions,
            )
            return TableReaderExec(bare, self.session).execute()
        from tidb_tpu_torch.copr.colcache import cache_for
        from tidb_tpu_torch.kv import tablecodec
        from tidb_tpu_torch.kv.rowcodec import RowSchema
        from tidb_tpu_torch.utils.chunk import Chunk, Column

        store = self.session.store
        cache = cache_for(store)
        read_ts = self.session.read_ts()
        t = reader.table
        views = reader.partitions if reader.partitions is not None else t.partition_views()
        schema = RowSchema(t.storage_schema)
        want = [oc.slot for oc in reader.schema]
        slots = [s for s in want if s >= 0]
        parts: list[list[tuple]] = []  # per region: [(data, valid)] per column
        for v in views:
            cache.set_table_alias(v.id, t.id)
            for region, _krs in store.pd.regions_in_ranges([tablecodec.record_range(v.id)]):
                entry = cache.get(region, v.id, schema, slots, read_ts)
                if entry.n == 0:
                    continue
                parts.append(
                    [
                        (entry.handles, np.ones(entry.n, bool)) if s < 0 else entry.cols[s]
                        for s in want
                    ]
                )
        cols = []
        for ci, oc in enumerate(reader.schema):
            if len(parts) == 1:
                data, valid = parts[0][ci]
            elif parts:
                data = np.concatenate([p[ci][0] for p in parts])
                valid = np.concatenate([p[ci][1] for p in parts])
            else:
                dt = (
                    np.float64
                    if oc.ftype.kind == TypeKind.FLOAT
                    else (np.int32 if oc.ftype.kind == TypeKind.STRING else np.int64)
                )
                data, valid = np.zeros(0, dt), np.zeros(0, bool)
            dic = (
                cache.dictionary(t.id, oc.slot)
                if oc.ftype.kind == TypeKind.STRING and oc.slot >= 0
                else None
            )
            cols.append(Column(data, valid, oc.ftype, dic))
        return Chunk(cols)

    def _bind_conditions(self, reader: PhysTableReader) -> list[Expression]:
        """String constants → dictionary codes (device legalization)."""
        from tidb_tpu_torch.copr import dagpb
        from tidb_tpu_torch.copr.binder import Binder
        from tidb_tpu_torch.copr.colcache import cache_for

        if reader.pushed_agg is not None:
            return []  # conditions already applied inside the cop DAG
        if not reader.pushed_conditions:
            return []
        cache = cache_for(self.session.store)
        scan_cols = [
            dagpb.ColumnInfoPB(oc.slot, oc.ftype) for oc in reader.schema
        ]
        binder = Binder(cache, reader.table.id, scan_cols)
        return [expr_from_pb(binder.bind_expr(c.to_pb())) for c in reader.pushed_conditions]

    # -- lane layout ---------------------------------------------------------
    def _lane_maps(self):
        """Accumulated lane layout over the plan's readers (see
        :func:`_lane_layout`). Lane count follows each reader's OUTPUT
        schema — pre-aggregated readers emit partial lanes + keys, staged
        subplan readers their finalize lanes — not raw scan columns."""
        return _lane_layout(self.plan.readers, self.plan.joins)

    def _col_source(self, pos: int):
        """(table_id, slot) for accumulated PLAN-schema position ``pos``."""
        src = _plan_col_source(self.plan.readers, self.plan.joins, pos)
        return (src[0], src[1]) if src is not None else None

    def execute(self):
        """Attempt the mesh pipeline with failure detection and retry (ref:
        ExecutorWithRetry + MPPFailedStoreProber, executor_with_retry.go:40,
        mpp_probe.go:62): a device failure blacklists the device and the
        next attempt runs on the survivors; unattributable failures get one
        same-mesh retry; exhaustion raises MPPRetryExhausted so the session
        re-plans without MPP. A remote-backed session dispatches the whole
        gather to the storage server instead (DispatchMPPTask analog) —
        BEFORE any jax import: the SQL-layer process must never initialize
        a device backend it does not own."""
        store = self.session.store
        if hasattr(store, "mpp_dispatch"):
            from tidb_tpu_torch.parallel.probe import MPPStraddleError

            try:
                return self._execute_remote()
            except MPPStraddleError:
                # hybrid shards × devices: the gather's tables live on
                # DIFFERENT store shards, so no single owner can serve it.
                # A fleet client can read every shard (the sharded cop/
                # columnar route crosses the wire per owner — today's wire
                # path), so the staged fragment program runs on the
                # coordinator's own mesh instead of degrading to the host
                # join. Single-store remote sessions never straddle, so the
                # never-initialize-a-foreign-backend rule still holds there.
                if not (
                    hasattr(store, "stores")
                    and sysvar_int(self.session.vars, "tidb_mpp_hybrid", 1)
                ):
                    raise
                from tidb_tpu_torch.utils import eventlog as _ev
                from tidb_tpu_torch.utils import metrics as _m

                _m.MPP_HYBRID.inc()
                lg = _ev.on(_ev.INFO)
                if lg is not None:
                    lg.emit(
                        _ev.INFO,
                        "mpp",
                        "straddle_hybrid",
                        trace_id=getattr(self.session.tracer, "trace_id", None),
                    )
                self._hybrid = True
        from tidb_tpu_torch.utils import tracing as _tracing

        # the gather's phases: consecutive spans under ``mpp.gather``
        # (mpp.prepare: the mesh, then the join, stage and agg specs;
        # mpp-inputs; mpp.program; mpp.issue and mpp.drain under
        # mpp-pipeline[Ndev]; mpp.merge); a grow-and-retry or a device
        # retry repeats them
        self._phases = _tracing.Phases(self.session.span)
        with self.session.span("mpp.gather"):
            try:
                return self._execute_local(store)
            finally:
                self._phases.close()

    def _execute_local(self, store):
        """The gather on this process's devices, retried over the
        survivors of a device failure."""
        from tidb_tpu_torch.copr.gpu_engine import store_device
        from tidb_tpu_torch.parallel import make_mesh
        from tidb_tpu_torch.parallel import mesh as _mesh_mod
        from tidb_tpu_torch.parallel.probe import (
            GLOBAL_PROBER,
            MPPRetryExhausted,
            gather_backoffer,
            probe_and_blacklist,
        )
        from tidb_tpu_torch.utils import failpoint
        from tidb_tpu_torch.utils.backoff import BackoffExhausted, boMPP
        from tidb_tpu_torch.utils.memory import QueryKilledError, QueryOOMError

        # ONE shared retry budget per gather (ref: executor_with_retry.go):
        # device re-plans and unattributed retries draw from the same
        # Backoffer instead of ad-hoc attempt counters
        bo = gather_backoffer()
        no_progress = 0
        self._compiles = 0
        while True:
            self._phases.to("mpp.prepare")
            # one shard per live device the store owns: every visible card
            # for a store on ``cuda``, ``cuda:N`` alone, or the CPU (with no
            # card store_device raises: never the CPU). FORCE_NDEV cuts the
            # list as the reference's does; over one device it is that many
            # virtual shards (ndev-parity tests, chip_smoke.py)
            store_device(store)
            devices = GLOBAL_PROBER.alive(_mesh_mod.available_devices(getattr(store, "device", "cuda")))
            if not devices:
                raise MPPRetryExhausted("no alive devices for MPP")
            mesh = make_mesh(devices=devices)
            try:
                failpoint.inject("mpp_run_fragment", mesh)
                import time as _t

                t0 = _t.perf_counter()
                out = self._execute_attempt(mesh)
                # MPP exec-details: the gather's analog of the cop sidecar —
                # feeds EXPLAIN ANALYZE's mpp_task line on this gather node,
                # including the per-shard straggler breakdown the fragment
                # program's shard probes recorded
                from tidb_tpu_torch.utils import metrics as _m
                from tidb_tpu_torch.utils.execdetails import MPPExecDetails

                shards = getattr(self, "_shard_obs", [])
                for sh in shards:
                    _m.MPP_SHARD_SECONDS.observe(sh[1] / 1000.0)
                self.session.record_mpp_detail(
                    self.plan,
                    MPPExecDetails(
                        n_fragments=len(self.plan.fragments),
                        ndev=int(mesh.devices.size),
                        wall_ms=(_t.perf_counter() - t0) * 1000.0,
                        rows=len(out),
                        retries=bo.attempts(),
                        store="hybrid" if getattr(self, "_hybrid", False) else "",
                        shards=shards,
                        compiles=getattr(self, "_compiles", 0),
                        stages=getattr(self, "_n_stages", 1),
                        stage_bytes=getattr(self, "_stage_bytes", []),
                    ),
                )
                return out
            except (MPPRetryExhausted, QueryKilledError, QueryOOMError):
                # kills and quota cancels are statement verdicts, not device
                # failures — retrying would defeat KILL / the memory quota
                raise
            except RuntimeError as exc:  # device loss / per-shard OOM / injected
                bad = getattr(exc, "mpp_device", None)
                if bad is not None:
                    GLOBAL_PROBER.report_failure(bad)
                else:
                    # attribute by probing (MPPAlive analog): any device that
                    # fails the round-trip is blacklisted; the next attempt
                    # runs on the survivors
                    if probe_and_blacklist(devices) == 0:
                        no_progress += 1
                if no_progress >= 2:
                    raise MPPRetryExhausted(
                        f"mpp execution made no progress after {bo.attempts() + 1} attempts: {exc}"
                    ) from exc
                try:
                    bo.backoff(boMPP)  # exc classifies fatal; budget-only pacing
                except BackoffExhausted as be:
                    raise MPPRetryExhausted(
                        f"mpp retry budget exhausted after {be.attempts} attempts: {exc}"
                    ) from exc

    def _execute_remote(self):
        """Ship the gather to the storage-server process (ref: kv/mpp.go
        DispatchMPPTask + EstablishMPPConns): the server owns the data, the
        device cache, and the mesh; this process gets the merged chunk. A
        dirty transaction falls back to the host Volcano path — the server
        cannot see this session's uncommitted buffer (the reference likewise
        keeps MPP off dirty-table reads, which need UnionScan)."""
        from tidb_tpu_torch.parallel.mpptask import gather_to_pb
        from tidb_tpu_torch.parallel.probe import MPPRetryExhausted

        sess = self.session
        if sess._txn_dirty():
            raise MPPRetryExhausted("remote MPP cannot observe txn-local mutations")
        stats = sess._db.stats
        cap = None
        if self.plan.agg is not None:
            rows = None
            st = stats.get(self.plan.readers[0].table.id) if stats is not None else None
            if st is not None:
                rows = st.row_count
            cap = self._initial_group_cap(rows if rows else 1 << 16)
        spec = gather_to_pb(self.plan, cap, schema_ver=sess._db.catalog.schema_version)
        store = sess.store
        import time as _t
        from contextlib import nullcontext

        from tidb_tpu_torch.utils.execdetails import MPPExecDetails

        from tidb_tpu_torch.utils.tracing import effective as _effective_tracer

        tr = _effective_tracer(sess.tracer)
        store_addr = f"{getattr(store, 'host', 'shard')}:{getattr(store, 'port', '?')}"
        exec_pb: list = []
        t0 = _t.perf_counter()
        # placement-aware task-level retry (the client-go mpp_probe recovery
        # idiom): a lost task (server restarted), a fenced owner (the table
        # MOVED mid-query), or a dead owner whose region moved away all
        # RE-DISPATCH the fragment to the surviving/new owner instead of
        # failing the whole gather. The dispatch unit here IS the gather
        # (one fragment program), so re-dispatch = one fresh mpp_dispatch
        # after a placement refresh; a dead owner whose region did NOT move
        # has no surviving copy to serve it — that exhausts as
        # MPPRetryExhausted and the session re-plans without MPP.
        from tidb_tpu_torch.kv.kv import RegionError
        from tidb_tpu_torch.parallel.probe import MPPTaskLostError, gather_backoffer
        from tidb_tpu_torch.utils.backoff import BackoffExhausted, boMPP

        bo = gather_backoffer()
        redispatches = 0
        # the dispatch+conn pair runs under ONE client span; the server's
        # task session records its own spans under the propagated context
        # and they graft in here, tagged with the store that recorded them
        with (tr.span("mpp-gather-rpc") if tr is not None else nullcontext()) as sp:
            # the trace kwarg only appears when tracing is ON — untraced
            # dispatch keeps the plain (spec, read_ts) signature
            kw = {"trace": tr.context().to_pb()} if tr is not None else {}

            def on_exec(e, spans):
                if e:
                    exec_pb.append(e)
                if spans and tr is not None:
                    tr.merge_remote(spans, base_s=sp.start_s, node=store_addr, depth=sp.depth + 1)

            while True:
                try:
                    task_id = store.mpp_dispatch(spec, sess.read_ts(), **kw)
                    chunk = store.mpp_conn(
                        task_id, check_killed=sess.check_killed, warn=sess.append_warning,
                        on_exec=on_exec,
                    )
                    break
                except (ConnectionError, RegionError, MPPTaskLostError) as exc:
                    refresh = getattr(store, "placement_refresh", None)
                    moved = bool(refresh()) if refresh is not None else False
                    if isinstance(exc, ConnectionError) and not moved:
                        # dead owner, region did not move: no surviving
                        # owner can serve this fragment's data
                        raise MPPRetryExhausted(
                            f"remote MPP owner unreachable and its regions did "
                            f"not move: {exc}"
                        ) from exc
                    try:
                        bo.backoff(boMPP, exc)
                    except BackoffExhausted as be:
                        raise MPPRetryExhausted(
                            f"mpp re-dispatch budget exhausted after "
                            f"{be.attempts} attempts: {exc}"
                        ) from exc
                    redispatches += 1
                    from tidb_tpu_torch.utils import eventlog as _ev
                    from tidb_tpu_torch.utils import metrics as _m

                    _m.PLACEMENT_REROUTE.inc(verb="mpp_dispatch")
                    lg = _ev.on(_ev.WARN)
                    if lg is not None:
                        lg.emit(
                            _ev.WARN,
                            "mpp",
                            "redispatch",
                            trace_id=tr.trace_id if tr is not None else None,
                            attempt=redispatches,
                            moved=moved,
                            cause=str(exc),
                        )
        e = exec_pb[0] if exec_pb else {}
        sess.record_mpp_detail(
            self.plan,
            MPPExecDetails(
                n_fragments=int(e.get("fragments", len(self.plan.fragments))),
                ndev=int(e.get("ndev", 0)),
                wall_ms=float(e.get("wall_ms", (_t.perf_counter() - t0) * 1000.0)),
                rows=len(chunk),
                retries=int(e.get("retries", 0)) + redispatches,
                store=store_addr,
                # per-shard breakdown recorded by the SERVER's shard probes
                # (the mesh lives there) — ships home in the exec sidecar
                shards=[list(sh) for sh in (e.get("shards") or [])],
                compiles=int(e.get("compiles", 0)),
                stages=int(e.get("stages", 1)),
                stage_bytes=[int(b) for b in (e.get("stage_bytes") or [])],
            ),
        )
        return chunk

    def _execute_attempt(self, mesh):
        import torch

        from tidb_tpu_torch.copr.gpu_engine import _d2h
        from tidb_tpu_torch.ops.dag_kernel import _bcast, _vmask
        from tidb_tpu_torch.parallel.mpp import (
            DistAggSpec,
            DistJoinSpec,
            DistTopNSpec,
            build_dist_pipeline,
            to_host,
        )

        p = self.plan
        ndev = mesh.devices.size
        # one padded host lane onto the mesh: each worker's shards on its
        # device
        up = mesh.place
        self._stage_bytes = []  # per-device-stage exchanged bytes (psum)
        self._n_stages = 1 + sum(
            1 for r in p.readers if isinstance(r, SubplanReader) and r.staged
        )
        # pinned read ts (stale read / server-side dispatched task): caching
        # stays legal per reader as long as no region committed PAST the pin —
        # checked against region.max_commit_ts in dev_side
        self._pin_ts = self.session._read_ts_override
        self._dev_cacheable = not self.session._txn_dirty() and not float(
            self.session.vars.get("tidb_read_staleness", 0) or 0
        )
        from tidb_tpu_torch.copr.colcache import cache_for as _cache_for

        _cache = _cache_for(self.session.store)
        for join in p.joins:
            for (ta, sa), (tb, sb) in join.str_keys:
                # string join keys compare as dictionary codes: both columns
                # must share ONE dictionary (idempotent after the first query)
                _cache.unify_dictionaries(ta, sa, tb, sb)
        # staged subplan build sides: (readers, joins, filters, group_by,
        # aggs) of the device STAGE, aligned with p.readers (None = plain /
        # host-materialized). Stage join chains unify their own string keys.
        stage_parts = [
            _stage_parts_of(r) if isinstance(r, SubplanReader) and r.staged else None
            for r in p.readers
        ]
        for parts in stage_parts:
            if parts is not None:
                for join in parts[1]:
                    for (ta, sa), (tb, sb) in join.str_keys:
                        _cache.unify_dictionaries(ta, sa, tb, sb)
        conds = [self._bind_conditions(r) for r in p.readers]
        agg = p.agg

        def pad_side(chunk):
            from tidb_tpu_torch.ops.window_core import widen_bounds

            n = len(chunk)
            # power-of-two per-shard padding (masked validity): input SHAPES
            # bucket, so same-shape queries at nearby sizes — and grow-and-
            # retry attempts — trace and compile ONE program
            per = _pow2(max((n + ndev - 1) // ndev, 8))
            tot = per * ndev
            arrays = []
            bounds = []
            for c in chunk.columns:
                d = np.zeros(tot, dtype=c.data.dtype)
                d[:n] = c.data
                v = np.zeros(tot, dtype=bool)
                v[:n] = c.validity
                arrays.append(np.where(v, d, 0))
                arrays.append(v)
                # per-column value bounds power the packed narrow-lane sorts
                # in the fragment program (mpp._pack_keys)
                if np.issubdtype(c.data.dtype, np.floating):
                    bounds.append(None)
                else:
                    lv = c.data[: n][c.validity[: n]]
                    bounds.append((int(lv.min()), int(lv.max())) if lv.size else (0, 0))
            live = np.zeros(tot, dtype=bool)
            live[:n] = True
            arrays.append(live)
            return arrays, n, widen_bounds(bounds)

        def dev_side(reader):
            """Padded device-resident input lanes, cached per table state —
            steady-state MPP queries re-read and re-upload nothing (same
            identity scheme as the coprocessor engine's device cache). Plain
            readers pool lanes PER COLUMN, so two queries scanning
            overlapping column subsets of one table share the overlap
            instead of re-uploading per gather; pre-agg and subplan build
            sides key whole-reader on their structural fingerprint (their
            materialized arrays are query-shape-specific)."""
            base = reader.reader if isinstance(reader, SubplanReader) else reader
            key = ckey = regions = None
            if self._dev_cacheable:
                from tidb_tpu_torch.kv import tablecodec

                _views = (
                    base.partitions
                    if base.partitions is not None
                    else base.table.partition_views()
                )
                prs = [tablecodec.record_range(v.id) for v in _views]
                regions = self.session.store.pd.regions_in_ranges(prs)
                if self._pin_ts is not None and any(
                    getattr(r, "max_commit_ts", 1 << 62) > self._pin_ts for r, _ in regions
                ):
                    # a commit landed past the pinned snapshot: the current-
                    # version arrays are NOT this read's data — run uncached
                    regions = None
            if regions is not None:
                vers = tuple((r.region_id, r.data_version) for r, _ in regions)
                if isinstance(reader, SubplanReader):
                    # the materialized agg output is a function of the whole
                    # subplan — the fingerprint IS the identity
                    key = (
                        self.session.store.nonce,
                        base.table.id,
                        reader.fingerprint(),
                        vers,
                        mesh.placement,
                        _cache.epoch,
                    )
                elif reader.pushed_agg is not None:
                    # pre-agg readers materialize DIFFERENT arrays than raw
                    # scans of the same table — the identity must say so
                    agg_fp = repr(
                        (
                            [g.to_pb() for g in reader.pushed_agg.group_by],
                            [a.to_pb() for a in reader.pushed_agg.aggs],
                            [c.to_pb() for c in reader.pushed_conditions],
                        )
                    )
                    key = (
                        self.session.store.nonce,
                        reader.table.id,
                        tuple(reader.scan_slots),
                        vers,
                        mesh.placement,
                        agg_fp,
                        _cache.epoch,  # dictionary merges/compactions remap codes
                    )
                else:
                    ckey = (
                        self.session.store.nonce,
                        base.table.id,
                        vers,
                        mesh.placement,
                        _cache.epoch,
                    )
            if key is not None:
                hit = _MPP_DEV_CACHE.get(key)
                if hit is not None:
                    return hit
            if ckey is not None:
                pool = _MPP_DEV_CACHE.get(ckey)
                want = [oc.slot for oc in reader.schema]
                if pool is not None and all(s in pool["cols"] for s in want):
                    lanes, bs = [], []
                    for s in want:
                        d, v, b = pool["cols"][s]
                        lanes += [d, v]
                        bs.append(b)
                    return (lanes + [pool["live"]], pool["n"], bs)
            arrays, n, bounds = pad_side(self._reader_arrays(reader))
            if ckey is not None:
                if pool is None:
                    pool = {"n": n, "live": up(arrays[-1]), "cols": {}}
                    with _MPP_CACHE_MU:
                        # a racing gather may have installed the pool first:
                        # adopt the winner so both share one resident copy
                        pool = _MPP_DEV_CACHE.setdefault(ckey, pool)
                lanes = []
                for i, s in enumerate(want):
                    ent = pool["cols"].get(s)
                    if ent is None:
                        # upload ONLY the columns the pool lacks — the
                        # overlap with earlier queries stays resident
                        ent = (up(arrays[2 * i]), up(arrays[2 * i + 1]), bounds[i])
                        pool["cols"][s] = ent
                    lanes += [ent[0], ent[1]]
                dev_lanes = (lanes + [pool["live"]], pool["n"], [pool["cols"][s][2] for s in want])
            else:
                dev_lanes = ([up(a) for a in arrays], n, bounds)
            with _MPP_CACHE_MU:
                if key is not None:
                    _MPP_DEV_CACHE[key] = dev_lanes
                while len(_MPP_DEV_CACHE) > 32:
                    _MPP_DEV_CACHE.pop(next(iter(_MPP_DEV_CACHE)))
            return dev_lanes

        # traced under TRACE (or a propagated remote trace context): the two
        # dominant phases of a gather get their own spans. A STAGED reader
        # materializes its stage readers' RAW lanes (per-column pooled like
        # any plain scan) — the subplan's aggregate never touches the host.
        phases = self._phases
        phases.close()
        with self.session.span("mpp-inputs"):
            sides = [
                [dev_side(sr) for sr in stage_parts[ri][0]]
                if stage_parts[ri] is not None
                else dev_side(r)
                for ri, r in enumerate(p.readers)
            ]
        phases.to("mpp.prepare")  # the join, stage and agg specs
        stats = self.session._db.stats

        def _stage_cap(sub, probe_n: int) -> int:
            """Per-shard group-slot capacity of a stage (compile-key
            component; overflow is detected and retried bigger)."""
            est = sub.rows_estimate(stats)
            if est:
                return max(_pow2(min(int(2 * est), 1 << 16)), 64)
            return max(_pow2(min(probe_n + 1, 1 << 16)), 256)

        stage_caps = [
            _stage_cap(p.readers[ri], sides[ri][0][1]) if stage_parts[ri] is not None else 0
            for ri in range(len(p.readers))
        ]
        all_lanes = []
        nrows = []
        bounds_by_reader = []
        for ri, side in enumerate(sides):
            if stage_parts[ri] is not None:
                for arrays, _, _ in side:
                    all_lanes.extend(arrays)
                # build-row proxy for the consumer join's caps: the stage
                # emits ≤ group_cap live slots per shard
                nrows.append(ndev * stage_caps[ri])
                # finalize lanes carry no static value bounds
                bounds_by_reader.append([None] * len(p.readers[ri].schema))
            else:
                arrays, n, bs = side
                all_lanes.extend(arrays)
                nrows.append(n)
                bounds_by_reader.append(bs)
        # accumulated PLAN-schema position → column bounds (packed sorts);
        # semi/anti build readers contribute no plan columns
        all_bounds = list(bounds_by_reader[0])
        for ji, join in enumerate(p.joins):
            if join.kind in ("inner", "left", "right"):
                all_bounds.extend(bounds_by_reader[ji + 1])
        ncols = [len(r.schema) for r in p.readers]
        n_lanes, lane_of = self._lane_maps()
        # INPUT lane counts differ from the fold-time layout for staged
        # readers: their input block is the stage readers' lanes
        in_lanes = [
            sum(2 * len(sr.schema) + 1 for sr in stage_parts[ri][0])
            if stage_parts[ri] is not None
            else n_lanes[ri]
            for ri in range(len(p.readers))
        ]

        from tidb_tpu_torch.ops.dag_kernel import _DeviceWarnSink

        warn_sink = _DeviceWarnSink()

        def side_selection(cond_list, nc):
            def fn(*cols):
                pairs = [(cols[2 * i], cols[2 * i + 1]) for i in range(nc)]
                live = cols[2 * nc]
                n, dev = live.shape[0], live.device
                batch = EvalBatch(pairs, [None] * nc, n, warn=warn_sink)
                m = live
                for cond in cond_list:
                    d, v, _ = eval_expr(cond, batch, torch)
                    m = m & _bcast(d != 0, n, dev) & _vmask(v, n, dev)
                return m

            return fn

        selections = [side_selection(conds[i], ncols[i]) for i in range(len(p.readers))]

        # agg input mapping over the accumulated lane layout
        total_cols = _plan_schema_len(p.readers, p.joins)

        def lanes_filter(cond_list, _lane_of=None, _total=None):
            """Post-join chain filter over the ACCUMULATED lane layout:
            plan positions resolve through lane_of; lanes of not-yet-folded
            readers are absent, which is fine — a condition placed at chain
            position k only references columns available after k joins.
            ``_lane_of``/``_total`` override the outer layout for filters
            INSIDE a device stage's own chain."""
            lmap = lane_of if _lane_of is None else _lane_of
            ncol = total_cols if _total is None else _total

            def fn(acc):
                nav = len(acc)
                pairs = [
                    (acc[lmap[i]], acc[lmap[i] + 1]) if lmap[i] + 1 < nav else None
                    for i in range(ncol)
                ]
                n, dev = acc[0].shape[0], acc[0].device
                batch = EvalBatch(pairs, [None] * len(pairs), n, warn=warn_sink)
                m = torch.ones(n, dtype=torch.bool, device=dev)
                for cond in cond_list:
                    d, v, _ = eval_expr(cond, batch, torch)
                    m = m & _bcast(d != 0, n, dev) & _vmask(v, n, dev)
                return m

            return fn

        chain_filters = [(pos, lanes_filter(cl)) for pos, cl in p.filters]

        def build_pair_filter(join, ji, _readers=None, _joins=None, _lane_of=None):
            """Semi/anti ``other`` conditions over candidate (probe, build)
            pairs: refs below the accumulated plan width hit probe lanes,
            the rest hit the build reader's local lanes (the builder's
            [left ++ right] joined layout). ``_readers``/``_joins``/
            ``_lane_of`` override the outer plan for joins INSIDE a stage."""
            rds = p.readers if _readers is None else _readers
            jns = p.joins if _joins is None else _joins
            lmap = lane_of if _lane_of is None else _lane_of
            nleft = _plan_schema_len(rds[: ji + 1], jns[:ji])
            nb = len(rds[ji + 1].schema)
            cond_list = list(join.other)

            def fn(out_l, out_r):
                nav = len(out_l)
                pairs = [
                    (out_l[lmap[i]], out_l[lmap[i] + 1]) if lmap[i] + 1 < nav else None
                    for i in range(nleft)
                ]
                pairs += [(out_r[2 * j], out_r[2 * j + 1]) for j in range(nb)]
                n, dev = pairs[-1][0].shape[0], pairs[-1][0].device
                batch = EvalBatch(pairs, [None] * len(pairs), n, warn=warn_sink)
                m = torch.ones(n, dtype=torch.bool, device=dev)
                for cond in cond_list:
                    d, v, _ = eval_expr(cond, batch, torch)
                    m = m & _bcast(d != 0, n, dev) & _vmask(v, n, dev)
                return m

            return fn

        pair_filters = [
            build_pair_filter(j, ji) if j.other else None for ji, j in enumerate(p.joins)
        ]

        # the shared distinct argument (one per gather, _agg_mpp_ok enforces)
        dist_arg = next((a.arg for a in agg.aggs if _distinct_handled(a)), None) if agg else None

        def agg_inputs(joined):
            pairs = [
                (joined[lane_of[i]], joined[lane_of[i] + 1]) for i in range(total_cols)
            ]
            n, dev = pairs[0][0].shape[0], pairs[0][0].device
            batch = EvalBatch(pairs, [None] * len(pairs), n, warn=warn_sink)
            out = []
            if not agg.group_by:
                # scalar aggregate: one synthetic constant group key so the
                # segment/exchange machinery sees exactly one group
                out.append(torch.zeros(n, dtype=torch.int64, device=dev))
                out.append(torch.ones(n, dtype=torch.int64, device=dev))
            for g in agg.group_by:
                d, v, _ = eval_expr(g, batch, torch)
                # int-backed keys (ints, dict codes, dates, decimals) widen
                # to one uniform int64 sort lane; FLOAT keys must keep their
                # dtype — an int64 cast truncates the VALUE (3.25 → 3) and
                # can merge distinct groups. Float lanes carry bounds=None,
                # so they always take the generic dtype-preserving sort path
                # (found by graftfuzz, repro tests/fuzz_corpus/repro_s42_c199.py)
                d = _bcast(d, n, dev)
                d = d.to(torch.float64) if d.is_floating_point() else d.to(torch.int64)
                v = _vmask(v, n, dev)
                out.append(torch.where(v, d, 0))
                out.append(v.to(torch.int64))
            if dist_arg is not None:
                # the distinct argument rides as an extra segment-key pair
                d, v, _ = eval_expr(dist_arg, batch, torch)
                d = _bcast(d, n, dev)
                v = _vmask(v, n, dev)
                out.append(torch.where(v, d, 0))
                out.append(v.to(torch.int64))
            for a in agg.aggs:
                if a.arg is None or _distinct_handled(a):
                    continue
                d, v, _ = eval_expr(a.arg, batch, torch)
                d = _bcast(d, n, dev)
                v = _vmask(v, n, dev)
                if a.name in ("min", "max"):
                    # extremes reduce with sentinels, not zeros: an invalid
                    # row must not look like a legitimate 0
                    if d.is_floating_point():
                        sent = float("inf") if a.name == "min" else float("-inf")
                    else:
                        sent = (
                            torch.iinfo(torch.int64).max if a.name == "min" else torch.iinfo(torch.int64).min
                        )
                    out.append(torch.where(v, d, sent))
                else:
                    out.append(torch.where(v, d, 0))
                out.append(v.to(torch.int64))
            return out

        # per-join capacities: per-side receive capacity from ITS row count;
        # expansion capacity from the probe row count with 2× headroom —
        # power-of-two bucketed so the caps (compile-key components) land on
        # the same grid for nearby sizes and for grow-and-retry attempts
        join_specs = _make_join_specs(
            p.joins, nrows, all_bounds, bounds_by_reader, lane_of, ndev
        )

        # device-stage runtimes: each staged build side carries its own
        # selections, internal join specs, agg-input mapper, and finalize
        # closure (HAVING + projection over the merged group slots). The
        # pure-data DistStageSpec rides the compile key; callables live in
        # the StageRuntime wrapper.
        from tidb_tpu_torch.parallel.mpp import DistStageSpec, StageRuntime

        def _stage_agg_inputs(s_gb, s_aggs, s_lane_of, s_total):
            def fn(joined):
                pairs = [
                    (joined[s_lane_of[i]], joined[s_lane_of[i] + 1]) for i in range(s_total)
                ]
                n, dev = pairs[0][0].shape[0], pairs[0][0].device
                batch = EvalBatch(pairs, [None] * len(pairs), n, warn=warn_sink)
                out = []
                for g in s_gb:
                    d, v, _ = eval_expr(g, batch, torch)
                    # same key-lane dtype discipline as the final agg: int-
                    # backed keys widen to int64, FLOAT keys keep their dtype
                    # (an int64 cast would merge distinct groups)
                    d = _bcast(d, n, dev)
                    d = d.to(torch.float64) if d.is_floating_point() else d.to(torch.int64)
                    v = _vmask(v, n, dev)
                    out.append(torch.where(v, d, 0))
                    out.append(v.to(torch.int64))
                for a in s_aggs:
                    if a.arg is None:
                        continue
                    d, v, _ = eval_expr(a.arg, batch, torch)
                    d = _bcast(d, n, dev)
                    v = _vmask(v, n, dev)
                    if a.name in ("min", "max"):
                        # extremes reduce with sentinels, not zeros
                        if d.is_floating_point():
                            sent = float("inf") if a.name == "min" else float("-inf")
                        else:
                            sent = (
                                torch.iinfo(torch.int64).max if a.name == "min" else torch.iinfo(torch.int64).min
                            )
                        out.append(torch.where(v, d, sent))
                    else:
                        out.append(torch.where(v, d, 0))
                    out.append(v.to(torch.int64))
                return out

            return fn

        def _stage_finalize(sub, s_gb, s_aggs):
            """Merged group slots → the subplan's OUTPUT lanes, with the
            host finalize semantics (finalize_agg) reproduced in torch —
            notably decimal AVG's scale+4 rounded division — then the
            HAVING residue and the projection evaluated device-side."""
            having, proj, n_gk = sub.having, sub.proj, len(s_gb)

            def fn(mkeys, msums, bcnt):
                n, dev = bcnt.shape[0], bcnt.device
                slot_live = bcnt > 0
                pairs = []
                vi = 0
                for a in s_aggs:
                    if a.arg is None:  # COUNT(*)
                        pairs.append((bcnt.to(torch.int64), slot_live))
                        continue
                    vdata, vcnt = msums[2 * vi], msums[2 * vi + 1]
                    vi += 1
                    if a.name == "count":
                        pairs.append((vcnt.to(torch.int64), slot_live))
                    elif a.name == "avg":
                        denom = vcnt.clamp(min=1)
                        if a.arg.ftype.kind == TypeKind.DECIMAL:
                            # sum lane carries arg scale; result scale+4 with
                            # round-half-away (host finalize_agg parity, and
                            # dag_kernel._finalize_device's arithmetic)
                            num = vdata.to(torch.int64) * 10000
                            q = torch.sign(num) * ((num.abs() + denom // 2) // denom)
                            pairs.append((q, vcnt > 0))
                        else:
                            pairs.append((vdata.to(torch.float64) / denom, vcnt > 0))
                    else:  # sum / min / max
                        pairs.append((vdata, vcnt > 0))
                for gi in range(n_gk):
                    pairs.append((mkeys[2 * gi], mkeys[2 * gi + 1].to(torch.bool)))
                live = slot_live
                batch = EvalBatch(pairs, [None] * len(pairs), n, warn=warn_sink)
                for c in having:
                    d, v, _ = eval_expr(c, batch, torch)
                    live = live & _bcast(d != 0, n, dev) & _vmask(v, n, dev)
                outs = []
                if proj is not None:
                    for src in proj:
                        d, v, _ = eval_expr(src, batch, torch)
                        d = _bcast(d, n, dev)
                        vb = _vmask(v, n, dev).to(torch.bool)
                        outs += [torch.where(vb, d, 0), vb]
                else:
                    for d, vb in pairs:
                        d = _bcast(d, n, dev)
                        vb = _vmask(vb, n, dev).to(torch.bool)
                        outs += [torch.where(vb, d, 0), vb]
                return outs, live

            return fn

        stage_runtimes: list = [None] * len(p.readers)
        for ri in range(len(p.readers)):
            if stage_parts[ri] is None:
                continue
            sub = p.readers[ri]
            s_readers, s_joins, s_filters, s_gb, s_aggs = stage_parts[ri]
            blocks = sides[ri]
            s_conds = [self._bind_conditions(sr) for sr in s_readers]
            s_ncols = [len(sr.schema) for sr in s_readers]
            s_selec = [side_selection(s_conds[i], s_ncols[i]) for i in range(len(s_readers))]
            s_nrows = [n for _, n, _ in blocks]
            s_bounds = [bs for _, _, bs in blocks]
            s_nlanes, s_lane_of = _lane_layout(s_readers, s_joins)
            s_acc_bounds = list(s_bounds[0])
            for ji, join in enumerate(s_joins):
                if join.kind in ("inner", "left", "right"):
                    s_acc_bounds.extend(s_bounds[ji + 1])
            s_specs = _make_join_specs(s_joins, s_nrows, s_acc_bounds, s_bounds, s_lane_of, ndev)
            s_total = _plan_schema_len(s_readers, s_joins)
            s_kb = []
            for g in s_gb:
                s_kb.append(
                    s_acc_bounds[g.index]
                    if isinstance(g, ColumnRef) and g.index < len(s_acc_bounds)
                    else None
                )
                s_kb.append((0, 1))
            val_kinds = []
            for a in s_aggs:
                if a.arg is not None:
                    val_kinds.append(a.name if a.name in ("min", "max") else "sum")
                    val_kinds.append("sum")  # the validity/count lane
            nk = 2 * len(s_gb)
            stage_runtimes[ri] = StageRuntime(
                DistStageSpec(
                    n_lanes=list(s_nlanes),
                    joins=s_specs,
                    n_keys=nk,
                    sums=list(range(nk, nk + len(val_kinds))),
                    group_cap=stage_caps[ri],
                    key_bounds=tuple(s_kb),
                    val_kinds=tuple(val_kinds),
                    out_width=len(sub.schema),
                ),
                s_selec,
                _stage_agg_inputs(s_gb, s_aggs, s_lane_of, s_total),
                _stage_finalize(sub, s_gb, s_aggs),
                pair_filters=[
                    build_pair_filter(j, ji, _readers=s_readers, _joins=s_joins, _lane_of=s_lane_of)
                    if j.other
                    else None
                    for ji, j in enumerate(s_joins)
                ],
                chain_filters=[
                    (pos, lanes_filter(cl, _lane_of=s_lane_of, _total=s_total))
                    for pos, cl in s_filters
                ],
            )
        has_stages = any(s is not None for s in stage_runtimes)

        group_cap = 0
        if agg is not None:
            # a dispatching client may ship its stats-informed cap with the
            # task (the server's stats handle starts empty)
            group_cap = _pow2(
                int(getattr(self, "_group_cap_hint", None) or self._initial_group_cap(nrows[0]))
            )
        if agg is not None:
            nk = 2 * len(agg.group_by) if agg.group_by else 2
            ndk = 2 if dist_arg is not None else 0
            n_plain = sum(1 for a in agg.aggs if a.arg is not None and not _distinct_handled(a))
            sums_idx = list(range(nk + ndk, nk + ndk + 2 * n_plain))
            dmask = tuple(_distinct_handled(a) for a in agg.aggs if a.arg is not None)
            val_kinds = []
            for a in agg.aggs:
                if a.arg is not None and not _distinct_handled(a):
                    val_kinds.append(a.name if a.name in ("min", "max") else "sum")
                    val_kinds.append("sum")  # the validity/count lane
            # group-key lanes interleave (data, valid); bounded data lanes
            # let the fragment pack the whole group key into one narrow sort
            if agg.group_by:
                agg_kb = []
                for g in agg.group_by:
                    agg_kb.append(all_bounds[g.index] if isinstance(g, ColumnRef) and g.index < len(all_bounds) else None)
                    agg_kb.append((0, 1))
            else:
                agg_kb = [(0, 0), (1, 1)]  # synthetic constant group key
            if dist_arg is not None:
                agg_kb.append(
                    all_bounds[dist_arg.index]
                    if isinstance(dist_arg, ColumnRef) and dist_arg.index < len(all_bounds)
                    else None
                )
                agg_kb.append((0, 1))
        while True:
            phases.to("mpp.program")  # the program key, the cache lookup or build
            spec = (
                DistAggSpec(
                    n_keys=nk,
                    sums=sums_idx,
                    group_cap=group_cap,
                    key_bounds=tuple(agg_kb),
                    val_kinds=tuple(val_kinds),
                    n_dkeys=ndk,
                    distinct_mask=dmask if ndk else (),
                )
                if agg is not None
                else None
            )
            topn_spec = None
            if agg is None:
                by, limit = p.topn
                order = [
                    (lane_of[e.index], lane_of[e.index] + 1, desc) for e, desc in by
                ]
                out_lanes = [(lane_of[i], lane_of[i] + 1) for i in range(total_cols)]
                # a per-shard head of `limit` rows is ALWAYS sufficient — for
                # plain LIMIT any `limit` live rows do, for TopN the per-shard
                # best `limit` rows form a global-topN superset — so the head
                # size is fixed and this path can never overflow-loop
                topn_spec = DistTopNSpec(
                    order=order,
                    limit=_pow2(limit),
                    out_lanes=out_lanes,
                    out_cap=max(_pow2(limit), 1024),
                )
            # program cache: the built pipeline is pure structure —
            # keyed on specs + bound-condition fingerprints, NOT data (row
            # caps and padded shapes are power-of-two bucketed above, so
            # same-shape queries at different sizes produce THE SAME key).
            # Without this every query pays a full XLA mesh compile (~10s+
            # on TPU).
            fn_key = (
                id(mesh),
                repr(join_specs),
                repr(spec),
                repr(topn_spec),
                tuple(n_lanes),
                tuple(in_lanes),
                tuple(repr([c.to_pb() for c in cl]) for cl in conds),
                repr([g.to_pb() for g in agg.group_by]) if agg is not None else "",
                repr([a.to_pb() for a in agg.aggs]) if agg is not None else "",
                tuple(ncols),
                repr([(pos, [c.to_pb() for c in cl]) for pos, cl in p.filters]),
                repr([[c.to_pb() for c in j.other] for j in p.joins]),
                # staged build sides: the stage spec (caps/bounds/joins) plus
                # the subplan's value fingerprint (conds/agg/having/proj)
                tuple(repr(s.spec) if s is not None else "" for s in stage_runtimes),
                tuple(
                    r.fingerprint() if isinstance(r, SubplanReader) and r.staged else ""
                    for r in p.readers
                ),
                PROBES_ENABLED,
            )
            from tidb_tpu_torch.utils import metrics as _met

            cached = _MPP_FN_CACHE.get(fn_key)
            if cached is None:
                _met.MPP_PROGRAM_CACHE.inc(result="miss")
                self._compiles = getattr(self, "_compiles", 0) + 1
                fn = build_dist_pipeline(
                    mesh,
                    join_specs,
                    spec,
                    n_lanes=in_lanes,
                    selections=selections,
                    agg_inputs=agg_inputs if agg is not None else None,
                    topn=topn_spec,
                    warn_sink=warn_sink,
                    shard_stats=PROBES_ENABLED,
                    pair_filters=pair_filters,
                    chain_filters=chain_filters,
                    stages=stage_runtimes if has_stages else None,
                )
                # the sink is baked into the built program's closures: a
                # cache hit must attribute warn counts via the ORIGINAL sink
                with _MPP_CACHE_MU:
                    _MPP_FN_CACHE[fn_key] = (fn, warn_sink)
                    while len(_MPP_FN_CACHE) > 64:
                        _MPP_FN_CACHE.pop(next(iter(_MPP_FN_CACHE)))
            else:
                _met.MPP_PROGRAM_CACHE.inc(result="hit")
                fn, warn_sink = cached
            phases.close()
            with self.session.span(f"mpp-pipeline[{ndev}dev]"), _MESH_EXEC_LOCK:
                shard_obs: list = []
                walls: list = []
                with self.session.span("mpp.issue"):  # the host enqueuing the program
                    outs = fn(*all_lanes, walls=walls)
                # ONE device→host copy per worker for every output lane (one
                # buffer, counted as D2H bytes) — and blocking inside the
                # lock keeps the program's device work drained before the
                # next one
                with self.session.span("mpp.drain"):
                    arrs = to_host(outs, copy=_d2h)
                    if PROBES_ENABLED:
                        # the per-shard probe on the host, after the program,
                        # from each shard's live rows and exchanged bytes and its
                        # worker's stream time
                        rows, xbytes = arrs.pop()
                        _SHARD_OBS["sink"] = shard_obs
                        try:
                            for first, k, timer in walls:
                                wall_ms = timer.ms
                                for i in range(first, first + k):
                                    _shard_probe(i, rows[i], xbytes[i], wall_ms)
                        finally:
                            _SHARD_OBS["sink"] = None
                # grow-and-retry attempts overwrite: the SUCCESSFUL run wins
                self._shard_obs = sorted(shard_obs)
            wtotal = int(arrs.pop())  # the warn-count slot (always present)
            if has_stages:
                # per-stage exchanged bytes (staged-reader order) — feeds
                # EXPLAIN ANALYZE's mpp_task line and the multichip dryrun
                self._stage_bytes = [int(x) for x in np.asarray(arrs.pop())]
            dropped = int(arrs[-2])
            overflow = int(arrs[-1])
            if dropped == 0 and overflow == 0:
                # emit only for the SUCCESSFUL attempt — grow-and-retry
                # attempts re-run the same rows and would duplicate warnings
                if wtotal > 0:
                    # single-slot attribution: the traced sites' (code, msg) —
                    # one distinct code covers the practical case (div0);
                    # emit up to the MySQL warning cap
                    seen_codes = list(dict.fromkeys((c, m) for c, m, _ in warn_sink.items)) or [
                        (1365, "Division by 0")
                    ]
                    code, msg = seen_codes[0]
                    for _ in range(min(wtotal, 64)):
                        self.session.append_warning("Warning", code, msg)
                break
            # grow-on-overflow, like coprocessor paging (skewed owners can
            # exceed either side's 2× headroom; the counters are shared, so
            # grow everything that can overflow — stage caps included)
            if dropped:
                for s in join_specs:
                    s.left_row_cap *= 4
                    s.right_row_cap *= 4
                for st in stage_runtimes:
                    if st is not None:
                        for s in st.spec.joins:
                            s.left_row_cap *= 4
                            s.right_row_cap *= 4
            if overflow:
                group_cap *= 4
                for s in join_specs:
                    s.out_cap *= 4
                for st in stage_runtimes:
                    if st is not None:
                        st.spec.group_cap *= 4
                        for s in st.spec.joins:
                            s.out_cap *= 4
        with self.session.span("mpp.merge"):
            if agg is not None:
                return self._merge(arrs[:-2], agg)
            return self._rows_chunk(arrs[:-2])

    def _initial_group_cap(self, n_left_rows: int) -> int:
        """Static per-shard group capacity: NDV-product estimate with a
        ×2 margin when ANALYZE stats exist, else a conservative bound on the
        probe row count. Undersizing is safe — overflow is detected and the
        coordinator retries bigger."""
        keys = list(self.plan.agg.group_by)
        # the distinct argument multiplies the stage-1 (g, x) slot count
        keys += [a.arg for a in self.plan.agg.aggs if _distinct_handled(a)][:1]
        if not keys:
            return 8  # scalar aggregate: one synthetic group
        stats = self.session._db.stats
        est = 1
        have = False
        for gi, g in enumerate(keys):
            if not isinstance(g, ColumnRef):
                est *= 64
                continue
            src = self._col_source(g.index)
            ndv = None
            if src is not None and stats is not None:
                st = stats.get(src[0])
                cs = st.cols.get(src[1]) if st is not None else None
                if cs is not None:
                    ndv, have = cs.ndv, True
            est *= ndv if ndv else 64
        if have:
            return max(_pow2(min(2 * est, 1 << 16)), 64)
        return max(_pow2(min(n_left_rows + 1, 1 << 16)), 256)

    def _rows_chunk(self, arrs):
        """Gathered TopN/limit head lanes → rows chunk (live-filtered); the
        root Sort/Limit above re-sorts and trims the candidate union."""
        from tidb_tpu_torch.copr.colcache import cache_for
        from tidb_tpu_torch.utils.chunk import Chunk, Column

        cache = cache_for(self.session.store)
        total_cols = len(self.schema)
        live = np.asarray(arrs[2 * total_cols]).astype(bool)
        cols = []
        for i, oc in enumerate(self.schema):
            data = np.asarray(arrs[2 * i])[live]
            valid = np.asarray(arrs[2 * i + 1])[live].astype(bool)
            dic = None
            if oc.ftype.kind == TypeKind.STRING:
                src = self._col_source(i)
                if src is not None:
                    dic = cache.dictionary(*src)
                data = data.astype(np.int32)
            elif oc.ftype.kind == TypeKind.FLOAT:
                data = data.astype(np.float64)
            else:
                data = data.astype(np.int64)
            cols.append(Column(data, valid, oc.ftype, dic))
        return Chunk(cols)

    def _merge(self, outs, agg: PhysFinalAgg):
        """Replicated (group lanes…, sum lanes…, count) → final agg chunk via
        the shared partial-merge path."""
        from tidb_tpu_torch.executor.executors import merge_partials
        from tidb_tpu_torch.utils.chunk import Chunk, Column
        from tidb_tpu_torch.types.field_type import bigint_type

        n_groups_lanes = 2 * len(agg.group_by) if agg.group_by else 2
        n_val_lanes = 2 * sum(1 for a in agg.aggs if a.arg is not None)
        arrs = [np.asarray(o) for o in outs]
        cnt = arrs[n_groups_lanes + n_val_lanes]
        live = cnt > 0
        # assemble the partial chunk in _partial_schema layout
        cols = []
        vi = 0
        for a in agg.aggs:
            if a.arg is None:  # count(*)
                cols.append(Column(cnt[live].astype(np.int64), np.ones(live.sum(), bool), bigint_type(nullable=False)))
                continue
            vdata = arrs[n_groups_lanes + 2 * vi][live]
            vcount = arrs[n_groups_lanes + 2 * vi + 1][live]
            vi += 1
            for pk in a.partial_kinds:
                if pk == "count":
                    cols.append(Column(vcount.astype(np.int64), np.ones(live.sum(), bool), bigint_type(nullable=False)))
                elif pk in ("min", "max"):
                    ft = a.arg.ftype  # string extremes are host-only (codes
                    # are identity, not order) — _agg_mpp_ok rejects them
                    dt = np.float64 if ft.kind == TypeKind.FLOAT else np.int64
                    cols.append(Column(vdata.astype(dt), vcount > 0, ft))
                else:  # sum lane
                    ft = AggDesc("sum", a.arg).ftype
                    dt = np.float64 if ft.kind == TypeKind.FLOAT else np.int64
                    cols.append(Column(vdata.astype(dt), vcount > 0, ft))
        from tidb_tpu_torch.copr.colcache import cache_for

        cache = cache_for(self.session.store)
        for gi, g in enumerate(agg.group_by):
            kdata = arrs[2 * gi][live]
            kvalid = arrs[2 * gi + 1][live].astype(bool)
            dic = None
            if g.ftype.kind == TypeKind.STRING and isinstance(g, ColumnRef):
                src = self._col_source(g.index)
                if src is not None:
                    dic = cache.dictionary(*src)
            dt = np.float64 if g.ftype.kind == TypeKind.FLOAT else (np.int32 if g.ftype.kind == TypeKind.STRING else np.int64)
            cols.append(Column(kdata.astype(dt), kvalid, g.ftype, dic))
        chunk = Chunk(cols)
        return merge_partials(chunk, agg.aggs, len(agg.group_by))


def _pow2(n: int) -> int:
    b = 1
    while b < n:
        b <<= 1
    return b
