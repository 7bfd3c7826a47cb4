"""graftfuzz shrinker: delta-debugging a diverging case to a one-screen repro.

Zeller-style ddmin over three axes, all driven by the same oracle probe
(``runner.check_case`` on a candidate spec):

1. **scenario**: drop the DML round / the merge step / the mesh flag /
   unreferenced tables, then ddmin the surviving DML statements and each
   table's row list;
2. **query**: structurally drop select items, WHERE conjuncts, GROUP BY
   keys, ORDER BY items, LIMIT, the join tail — the query is an IR of SQL
   fragments (gen.Query), so every drop re-renders to valid-shaped SQL (a
   drop that happens to render an invalid query errors identically on both
   engines, which the oracle reads as agreement, so the pass self-rejects);
3. **schema**: drop indexes, the partition clause, the PK, and any column
   no remaining SQL references (column names are campaign-unique, so a
   substring scan is exact).

A candidate is accepted iff it still yields a divergence of the same oracle
family (differential/freshness vs tlp) — the classic allowance for bug
slippage inside one oracle, none across oracles (a float-canon artifact
must not morph into the TLP finding being minimized). Probes are bounded
(``_MAX_PROBES``) so a pathological case degrades to a bigger repro, never
a hung campaign. Everything is deterministic: pass order is fixed and the
probe itself re-seeds nothing.
"""

from __future__ import annotations

import math
from dataclasses import replace
from typing import Callable, Optional

from tidb_tpu_torch.tools.fuzz.gen import CaseSpec, TableSpec
from tidb_tpu_torch.tools.fuzz.oracles import Divergence
from tidb_tpu_torch.tools.fuzz.runner import check_case

_MAX_PROBES = 500


def _family(oracle: str) -> str:
    return "tlp" if oracle == "tlp" else "differential"


class _Prober:
    def __init__(self, family: str):
        self.family = family
        self.probes = 0
        self.last: Optional[Divergence] = None

    def fails(self, spec: CaseSpec) -> bool:
        if self.probes >= _MAX_PROBES:
            return False
        self.probes += 1
        try:
            d = check_case(spec)
        except Exception:
            # a reduction that crashes the *harness* (not the engines —
            # those are caught per-query) is rejected, not propagated
            return False
        if d is not None and _family(d.oracle) == self.family:
            self.last = d
            return True
        return False


def _ddmin(items: list, keeps_failing: Callable[[list], bool]) -> list:
    """Classic ddmin on a list: smallest subset (under chunk granularity)
    that still fails. ``keeps_failing`` must already be True for ``items``."""
    n = 2
    while len(items) >= 2:
        chunk = math.ceil(len(items) / n)
        reduced = False
        for i in range(0, len(items), chunk):
            cand = items[:i] + items[i + chunk :]
            if keeps_failing(cand):
                items = cand
                n = max(n - 1, 2)
                reduced = True
                break
        if not reduced:
            if n >= len(items):
                break
            n = min(n * 2, len(items))
    if len(items) == 1 and keeps_failing([]):
        items = []
    return items


def _referenced(name: str, spec: CaseSpec) -> bool:
    texts = [q.sql() for q in spec.queries] + list(spec.dml) + [spec.tlp_pred]
    for t in spec.tables:
        texts.append(t.partition)
        for ix in t.indexes:
            texts.extend(ix)
    return any(name in s for s in texts if s)


def _drop_column(t: TableSpec, j: int) -> TableSpec:
    cols = t.columns[:j] + t.columns[j + 1 :]
    name = t.columns[j].name
    idx = [ix for ix in t.indexes if name not in ix]
    part = "" if name in t.partition else t.partition
    return replace(t, columns=cols, indexes=idx, partition=part, pk=t.pk and j != 0)


def _query_passes(spec: CaseSpec, prober: _Prober) -> CaseSpec:
    """Structural drops on the (single) remaining query, to fixpoint."""
    changed = True
    while changed and prober.probes < _MAX_PROBES:
        changed = False
        q = spec.queries[0]
        candidates = []
        for fld in ("where", "select", "group_by", "order_by"):
            vals = getattr(q, fld)
            for i in range(len(vals) - 1, -1, -1):
                if fld == "select" and len(vals) == 1:
                    continue
                candidates.append(replace(q, **{fld: vals[:i] + vals[i + 1 :]}))
        if q.limit:
            candidates.append(replace(q, limit=""))
        if q.join:
            candidates.append(replace(q, join=""))
        for cand in candidates:
            s2 = replace(spec, queries=[cand])
            if prober.fails(s2):
                spec = s2
                changed = True
                break
    return spec


def shrink(spec: CaseSpec, div: Divergence):
    """Returns (shrunk_spec, final_divergence). The shrunk spec has exactly
    one query — the diverging one."""
    prober = _Prober(_family(div.oracle))
    prober.last = div

    # isolate the failing query (TLP always targets queries[0])
    failing = spec.queries[0]
    for q in spec.queries:
        if q.sql() == div.query or (div.oracle == "tlp" and q is spec.queries[0]):
            failing = q
            break
    base = replace(
        spec,
        queries=[failing],
        tlp_pred=spec.tlp_pred if _family(div.oracle) == "tlp" else "",
    )
    if prober.fails(base):
        spec = base
    else:  # isolation changed the outcome (phase interplay): keep the original
        prober.last = div

    # scenario: no DML at all → cold repro; else no merge; default mesh
    # width; plain mesh/regions
    for cand in (
        replace(spec, dml=[], merge=False),
        replace(spec, merge=False),
        replace(spec, ndev=0),
        replace(spec, mpp=False, ndev=0, region_split_keys=1 << 62),
    ):
        if (
            cand.dml != spec.dml
            or cand.merge != spec.merge
            or cand.mpp != spec.mpp
            or cand.ndev != spec.ndev
        ) and prober.fails(cand):
            spec = cand

    if spec.dml:
        kept = _ddmin(list(spec.dml), lambda d: prober.fails(replace(spec, dml=d)))
        spec = replace(spec, dml=kept)

    # rows: ddmin each table's row list
    for t in spec.tables:
        rows = list(spec.rows.get(t.name, ()))
        if rows:
            def probe_rows(r, tname=t.name):
                return prober.fails(replace(spec, rows={**spec.rows, tname: r}))

            kept = _ddmin(rows, probe_rows)
            spec = replace(spec, rows={**spec.rows, t.name: kept})

    spec = _query_passes(spec, prober)

    # schema: drop unreferenced tables, then indexes/partition/pk, then
    # unreferenced columns (row tuples shrink with them)
    for t in list(spec.tables):
        if len(spec.tables) > 1 and not _referenced(t.name, spec):
            cand = replace(
                spec,
                tables=[x for x in spec.tables if x.name != t.name],
                rows={k: v for k, v in spec.rows.items() if k != t.name},
            )
            if prober.fails(cand):
                spec = cand

    changed = True
    while changed and prober.probes < _MAX_PROBES:
        changed = False
        for ti, t in enumerate(spec.tables):
            slims = []
            if t.indexes:
                slims.append(replace(t, indexes=[]))
            if t.partition:
                slims.append(replace(t, partition=""))
            if t.pk:
                slims.append(replace(t, pk=False))
            for cand_t in slims:
                cand = replace(spec, tables=[cand_t if i == ti else x for i, x in enumerate(spec.tables)])
                if prober.fails(cand):
                    spec = cand
                    changed = True
                    break
            if changed:
                break
            for j in range(len(t.columns) - 1, -1, -1):
                if len(t.columns) == 1 or _referenced(t.columns[j].name, spec):
                    continue
                cand_t = _drop_column(t, j)
                new_rows = [r[:j] + r[j + 1 :] for r in spec.rows.get(t.name, ())]
                cand = replace(
                    spec,
                    tables=[cand_t if i == ti else x for i, x in enumerate(spec.tables)],
                    rows={**spec.rows, t.name: new_rows},
                )
                if prober.fails(cand):
                    spec = cand
                    changed = True
                    break
            if changed:
                break

    # re-run the query passes once more: schema drops may have freed fragments
    spec = _query_passes(spec, prober)
    return spec, (prober.last or div)
