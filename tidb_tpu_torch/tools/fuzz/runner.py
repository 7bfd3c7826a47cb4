"""graftfuzz runner: execute one CaseSpec through the oracle phases.

Phase order mirrors a serving lifecycle: **cold** (freshly loaded columns),
**fresh** (after a committed DML round — the device reads base⊕delta), and
**merged** (after ``DB.run_delta_merge`` folded the delta into blocks). The
delta knobs are pinned small for the duration of a case so even toy tables
exercise the delta operand and the merge path (the production default
``device-delta-min-rows`` would keep them on the rebuild path).

``run_repro`` executes the dict form the shrinker emits into repro files /
``tests/fuzz_corpus/`` — see shrink.py for the writer.
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Optional

from tidb_tpu_torch.tools.fuzz.gen import CaseSpec, Query, ci_rep_positions, insert_sql
from tidb_tpu_torch.tools.fuzz.oracles import (
    Divergence,
    compare_differential,
    compare_tlp,
    run_query,
)

# pinned per-case delta knobs: small enough that a handful of DML rows
# engages the delta operand, merge threshold low enough that run_delta_merge
# always folds; cap fixed campaign-wide so the delta kernel variant compiles
# once per DAG shape
_DELTA_KNOBS = {"device_delta_min_rows": 1, "device_delta_cap": 64, "device_delta_merge_rows": 4}


@contextlib.contextmanager
def _delta_config():
    from tidb_tpu_torch import config as _config

    old = _config.current()
    _config.set_current(dataclasses.replace(old, **_DELTA_KNOBS))
    try:
        yield
    finally:
        _config.set_current(old)


def _load_rows(db, spec: CaseSpec) -> None:
    for t in spec.tables:
        for stmt in insert_sql(t, spec.rows.get(t.name, [])):
            db.execute(stmt)


# the device every DB of a campaign, its shrinker probes and its repro
# replays is opened on: the card unless the caller asks for the CPU
DEVICE = "cuda"


@contextlib.contextmanager
def on_device(device: str):
    """Open the DBs of every case, probe and repro inside on ``device``."""
    global DEVICE
    old, DEVICE = DEVICE, device
    try:
        yield
    finally:
        DEVICE = old


# what the device sessions of the campaign's cases ran on: cop tasks by
# engine, degraded tasks by reason, MPP gathers, and the MPP cases checked
TALLY = {"engines": {}, "degraded": {}, "gathers": 0, "mpp_cases": 0}


def reset_tally() -> None:
    TALLY.update(engines={}, degraded={}, gathers=0, mpp_cases=0)


def _run_dev(dev, sql: str):
    out = run_query(dev, sql)
    cs = dev.exec_summary
    if cs is not None:
        for key in ("engines", "degraded"):
            for k, n in getattr(cs, key).items():
                TALLY[key][k] = TALLY[key].get(k, 0) + n
    TALLY["gathers"] += len(dev.mpp_details)
    return out


def _build_db(spec: CaseSpec):
    import tidb_tpu_torch

    db = tidb_tpu_torch.open(region_split_keys=spec.region_split_keys, device=DEVICE)
    for t in spec.tables:
        db.execute(t.create_sql())
    _load_rows(db, spec)
    return db


class DBPool:
    """One live DB per schema profile for the duration of a campaign.

    Device-kernel fingerprints (dagpb) cover table/column ids, so a fresh DB
    per case would recompile every query no matter how bounded the query
    vocabulary is — measured 7 XLA compiles/case, ~10× the whole oracle
    cost. Sharing the DB pins the table ids and lets the kernel/plan caches
    amortize campaign-wide; each case resets data with ``DELETE FROM`` +
    re-insert (which itself keeps churning the delta/changelog path).
    The shrinker and repro replays never use the pool — a committed repro
    must reproduce from an empty store.
    """

    def __init__(self):
        self._dbs: dict = {}

    def sessions_for(self, spec: CaseSpec):
        """(db, dev, host, writer) with data reset to the case's rows. The
        sessions persist with the DB so their statement/plan caches stay
        warm across cases — a campaign pays parse+plan once per pool query,
        which also keeps the serving fast lane itself under fuzz."""
        ent = self._dbs.get(spec.profile_key)
        if ent is None:
            db = _build_db(spec)
            dev, host = _sessions(db, spec.mpp)
            writer = _writer_session(db)
            ent = (db, dev, host, writer)
            self._dbs[spec.profile_key] = ent
            return ent
        db, dev, host, writer = ent
        for t in spec.tables:
            writer.execute(f"DELETE FROM {t.name}")
        _load_rows(db, spec)
        # fold the wipe's tombstones+inserts into base NOW: the case's cold
        # phase must run the plain kernel variant (fresh-build semantics);
        # only the case's own DML round should put delta operands in play
        db.run_delta_merge()
        return ent


def _sessions(db, mpp: bool):
    dev = db.session()
    host = db.session()
    host.execute("SET tidb_isolation_read_engines = 'host'")
    host.execute("SET tidb_allow_mpp = 0")
    if mpp:
        # mesh case: the device side keeps the default engine pair and MPP
        # enabled, so join/agg shapes route through build_dist_pipeline
        dev.execute("SET tidb_allow_mpp = 1")
    else:
        dev.execute("SET tidb_isolation_read_engines = 'gpu'")
        dev.execute("SET tidb_allow_mpp = 0")
    return dev, host


def _writer_session(db):
    # DML reads (UPDATE/DELETE scans) stay on the host engine: write paths
    # are not the oracle's subject, and device-compiling them would bill
    # arbitrary constants against the kernel cache
    writer = db.session()
    writer.execute("SET tidb_isolation_read_engines = 'host'")
    writer.execute("SET tidb_allow_mpp = 0")
    return writer


def _differential_round(dev, host, queries, tables, oracle: str, phase: str) -> Optional[Divergence]:
    for q in queries:
        sql = q.sql()
        fold, free = ci_rep_positions(q, tables)
        d = compare_differential(
            sql, ordered=bool(q.order_by), device=_run_dev(dev, sql),
            host=run_query(host, sql), oracle=oracle, phase=phase,
            ci_lax_positions=fold, ci_free_positions=free,
        )
        if d is not None:
            return d
    return None


def _tlp_round(dev, host, q: Query, pred: str, phase: str, engines=("gpu", "host")) -> Optional[Divergence]:
    sql = q.sql()
    parts_sql = [
        q.sql_with_extra_where(pred),
        q.sql_with_extra_where(f"NOT ({pred})"),
        q.sql_with_extra_where(f"({pred}) IS NULL"),
    ]
    for engine, ses in (("gpu", dev), ("host", host)):
        if engine not in engines:
            continue
        run = _run_dev if ses is dev else run_query
        whole = run(ses, sql)
        parts = [run(ses, p) for p in parts_sql]
        d = compare_tlp(sql, whole, parts, pred, engine, phase)
        if d is not None:
            return d
    return None


def _forced_ndev(mpp: bool, ndev: int):
    """Pin the MPP mesh width for one case/repro (0 = every device) — the
    campaign's width and its repro replays MUST agree, so both run through
    this one pin. A forced width is virtual shards of one card: the mesh's
    devices are pinned to ``DEVICE``'s handle (``mesh.FORCE_DEVICES``), so
    a case and its replay run one layout on a machine of any card count."""
    from contextlib import contextmanager

    @contextmanager
    def ctx():
        from tidb_tpu_torch.parallel import mesh as _mesh

        old = _mesh.FORCE_NDEV, _mesh.FORCE_DEVICES
        if mpp and ndev:
            _mesh.FORCE_NDEV = int(ndev)
            _mesh.FORCE_DEVICES = [_mesh.handle(DEVICE)]
        try:
            yield
        finally:
            _mesh.FORCE_NDEV, _mesh.FORCE_DEVICES = old

    return ctx()


def check_case(spec: CaseSpec, pool: Optional[DBPool] = None) -> Optional[Divergence]:
    """Run every phase; the FIRST divergence wins (the shrinker re-drives
    this same function on reduced specs, always without a pool). Mesh cases
    with a forced ``ndev`` pin the MPP mesh width for the whole case."""
    with _delta_config(), _forced_ndev(spec.mpp, getattr(spec, "ndev", 0)):
        if pool is not None and spec.profile_key:
            db, dev, host, writer = pool.sessions_for(spec)
            TALLY["mpp_cases"] += bool(spec.mpp)
        else:
            db = _build_db(spec)
            dev, host = _sessions(db, spec.mpp)
            writer = None
        d = _differential_round(dev, host, spec.queries, spec.tables, "differential", "cold")
        if d is not None:
            return d
        if spec.tlp_pred and spec.queries and not spec.queries[0].agg:
            # campaign runs: alternate which engine pays the 4-query TLP
            # round (both engines still TLP-checked across the campaign);
            # shrinker probes (no pool) check both so a finding never
            # escapes minimization by landing on the other engine
            engines = ("gpu", "host")
            if pool is not None:
                engines = ("gpu",) if (spec.index // 2) % 2 == 0 else ("host",)
            d = _tlp_round(dev, host, spec.queries[0], spec.tlp_pred, "cold", engines=engines)
            if d is not None:
                return d
        if spec.dml:
            if writer is None:
                writer = _writer_session(db)
            for stmt in spec.dml:
                try:
                    writer.execute(stmt)
                # a DML statement the engine rejects (e.g. NULL into a
                # partition-routing column) is not a parity signal; the
                # surviving statements still drive the delta path
                except Exception:  # graftcheck: off=except-swallow
                    continue
            # freshness re-runs the FIRST query only: the base⊕delta kernel
            # variant is a fresh compile per DAG shape, so re-running the
            # whole list would triple the campaign's compile bill for the
            # same delta-path coverage (which query sits first varies)
            d = _differential_round(dev, host, spec.queries[:1], spec.tables, "freshness", "fresh")
            if d is not None:
                return d
            if spec.merge:
                db.run_delta_merge()
                d = _differential_round(dev, host, spec.queries[:1], spec.tables, "freshness", "merged")
                if d is not None:
                    return d
    return None


# -- repro dict form ---------------------------------------------------------
#
# Repro files carry a plain-dict SPEC (no dataclass imports, so a years-old
# corpus file keeps loading even if the IR grows fields):
#
#   {"setup": [sql...], "dml": [sql...], "merge": bool, "mpp": bool,
#    "region_split_keys": int, "oracle": "differential"|"tlp",
#    "query": sql, "ordered": bool, "tlp_pred": pred (tlp only),
#    "phase": "cold"|"fresh"|"merged"}


def spec_to_repro(spec: CaseSpec, div: Divergence) -> dict:
    setup = []
    for t in spec.tables:
        setup.append(t.create_sql())
        setup.extend(insert_sql(t, spec.rows.get(t.name, [])))
    # pin the DIVERGING query: after shrinking it is queries[0], but an
    # unshrunk spec (--no-shrink, or an isolation probe that failed to
    # reproduce) may have diverged on a later query
    q = next((x for x in spec.queries if x.sql() == div.query), spec.queries[0])
    rep = {
        "setup": setup,
        "dml": list(spec.dml) if div.phase != "cold" else [],
        "merge": bool(spec.merge and div.phase == "merged"),
        "mpp": bool(spec.mpp),
        "ndev": int(getattr(spec, "ndev", 0)),
        "region_split_keys": int(spec.region_split_keys),
        "oracle": div.oracle if div.oracle != "freshness" else "differential",
        "phase": div.phase,
        "query": q.sql(),
        "ordered": bool(q.order_by),
        "ci_lax": list(ci_rep_positions(q, spec.tables)[0]),
        "ci_free": list(ci_rep_positions(q, spec.tables)[1]),
    }
    if div.oracle == "tlp":
        rep["tlp_pred"] = spec.tlp_pred
        rep["tlp_engine"] = div.engine or "gpu"
        rep["tlp_parts"] = [
            q.sql_with_extra_where(spec.tlp_pred),
            q.sql_with_extra_where(f"NOT ({spec.tlp_pred})"),
            q.sql_with_extra_where(f"({spec.tlp_pred}) IS NULL"),
        ]
    return rep


def run_repro(spec: dict) -> None:
    """Execute a repro SPEC; raises AssertionError on divergence (so a repro
    file is an ordinary failing-until-fixed pytest)."""
    from tidb_tpu_torch.tools.fuzz.oracles import canon_rows

    with _delta_config(), _forced_ndev(bool(spec.get("mpp")), int(spec.get("ndev", 0))):
        import tidb_tpu_torch

        db = tidb_tpu_torch.open(region_split_keys=spec.get("region_split_keys", 1 << 62), device=DEVICE)
        for stmt in spec["setup"]:
            db.execute(stmt)
        dev, host = _sessions(db, spec.get("mpp", False))
        writer = _writer_session(db)  # mirror check_case: DML reads stay host-side
        for stmt in spec.get("dml", ()):
            try:
                writer.execute(stmt)
            # mirror of check_case's DML policy: rejected statements are
            # not a parity signal, the repro replays the survivors
            except Exception:  # graftcheck: off=except-swallow
                continue
        if spec.get("merge"):
            db.run_delta_merge()
        sql = spec["query"]
        if spec.get("oracle") == "tlp":
            # the reference's corpus names the device session tpu
            ses = dev if spec.get("tlp_engine", "gpu") in ("gpu", "tpu") else host
            whole = run_query(ses, sql)
            parts = [run_query(ses, p) for p in spec["tlp_parts"]]
            d = compare_tlp(sql, whole, parts, spec.get("tlp_pred", ""), spec.get("tlp_engine", "gpu"), spec.get("phase", "cold"))
            if d is not None:  # explicit raise: repros must fire under -O too
                raise AssertionError(d.detail)
        else:
            a = run_query(dev, sql)
            b = run_query(host, sql)
            d = compare_differential(
                sql, spec.get("ordered", False), a, b, "differential", spec.get("phase", "cold"),
                ci_lax_positions=tuple(spec.get("ci_lax", ())),
                ci_free_positions=tuple(spec.get("ci_free", ())),
            )
            if d is not None:  # explicit raise: repros must fire under -O too
                raise AssertionError(d.detail)
