"""Value-agnostic prepared-plan reuse.

Reference parity: pkg/planner/core plan_cache.go — a prepared statement
caches ONE physical plan regardless of the bound parameter values
(``RebuildPlan4CachedPlan``): parameters live in the plan as ``Constant``
objects carrying their parameter index, and each EXECUTE (a) rewrites those
constants' values and (b) re-runs the ranger derivation
(``planner/ranger.py``) so scan ranges follow the new values.

The template is built once per (statement text, parameter-type signature)
by walking the finished physical plan:

- every ``Constant`` with ``param_idx >= 0`` is collected per parameter;
- every range-bearing node contributes a rebuild hook: ``range_maker``
  (handle/index ranges), ``partition_pruner`` (pruned-partition plans) and
  ``path_makers`` (index-merge paths), attached by the optimizer at
  derivation time as PURE functions of a condition tuple the node carries;
- shapes whose ranges cannot be re-derived safely (a parameter folded away
  by constant folding, an explicit PARTITION (...) selection, an unknown
  plan node) refuse the template — the session falls back to value-keyed
  caching, exactly the pre-refinement behavior.

**Copy-on-execute** (the instance-plan-cache concurrency discipline): the
cached template is IMMUTABLE. Each EXECUTE first clones the plan graph
(:func:`instantiate`) — sharing every frozen leaf (schemas, table/index
infos, key ranges, ndarrays) and every pure hook, deep-copying only the
mutable spine (plan nodes, expressions, containers) — then rebinds
parameters into the CLONE. Two sessions executing one cached template
concurrently therefore never observe each other's parameters, and the
template bytes never change (``plan_fingerprint`` is the audit primitive).

Rebuild safety for index paths: the detachment may consume a DIFFERENT
subset of conditions under new values (e.g. a parameter turning NULL drops
an IN-list from the access path). The residual split baked into the plan
would then be stale, so ``rebind`` compares the consumed-condition POSITION
set against the plan-time snapshot and reports failure — the caller
re-plans from scratch for that execution.
"""

from __future__ import annotations

import copy
import dataclasses
import datetime
import enum
from decimal import Decimal
from typing import Optional

import numpy as np

from tidb_tpu_torch.catalog.schema import ColumnInfo, IndexInfo, TableInfo
from tidb_tpu_torch.expression.expr import Constant, Expression
from tidb_tpu_torch.kv.kv import KeyRange
from tidb_tpu_torch.planner.plans import (
    OutCol,
    PhysIndexLookUp,
    PhysIndexMerge,
    PhysIndexReader,
    PhysTableReader,
)
from tidb_tpu_torch.types import FieldType

# traversal leaves: never hold parameter constants, never need rebuilding
_ATOMS = (
    str,
    bytes,
    int,
    float,
    bool,
    complex,
    type(None),
    Decimal,
    datetime.date,
    datetime.time,
    datetime.timedelta,
    enum.Enum,
    np.ndarray,
    np.generic,
    KeyRange,
    FieldType,
    TableInfo,
    IndexInfo,
    ColumnInfo,
    OutCol,
    frozenset,
)


def param_sig(p) -> object:
    """Parameter-type signature component: plans are typed from the bound
    value's Python type at first EXECUTE (builder._literal), so a cached
    plan is only reusable for parameters that would type identically."""
    if isinstance(p, Decimal):
        return ("Decimal", p.as_tuple().exponent)
    return type(p).__name__


@dataclasses.dataclass
class PlanTemplate:
    """One cached value-agnostic plan + its parameter rewrite points.

    The cached (shared) template is never rebound directly — callers go
    through :func:`instantiate` and rebind the per-execution clone."""

    plan: object
    # param idx → every Constant in the plan carrying that parameter
    param_consts: dict[int, list[Constant]]
    # (rebuild_fn, node) per range-bearing node — ``rebuild_fn(node) ->
    # bool``, False = split shifted, re-plan. Node references (not bound
    # closures) so :func:`instantiate` can remap them through the clone memo
    rebuilders: list


class _Walk:
    __slots__ = ("seen", "consts", "rebuilders", "ok")

    def __init__(self):
        self.seen: set[int] = set()
        self.consts: dict[int, list[Constant]] = {}
        self.rebuilders: list = []
        self.ok = True


def _rebuild_table(node: PhysTableReader) -> bool:
    # table ranges only narrow the scan — the pushed conditions still
    # filter exactly — so every derivation outcome (incl. None = full
    # scan) is safe to install
    node.ranges = node.range_maker(node.range_conds)
    return True


def _rebuild_partitions(node: PhysTableReader) -> bool:
    # re-prune per execution: None = scan every partition (a safe
    # superset — the conditions still filter), a list re-routes the
    # scan to exactly the partitions the new values can touch
    node.partitions = node.partition_pruner(node.partition_conds)
    return True


def _rebuild_index(node) -> bool:
    acc = node.range_maker(node.range_conds)
    if acc is None:
        return False
    used = {id(c) for c in acc.used}
    pos = frozenset(i for i, c in enumerate(node.range_conds) if id(c) in used)
    if pos != node.range_used_pos:
        return False  # used/residual split shifted under the new values
    node.ranges = acc.ranges
    return True


def _rebuild_merge(node: PhysIndexMerge) -> bool:
    new_paths = []
    for maker, cs, old in zip(node.path_makers, node.path_conds, node.paths):
        p = maker(cs)
        if p is None or p[0] != old[0]:
            return False  # a disjunct lost its access-path shape
        if p[0] == "idx" and p[1] is not old[1]:
            return False  # the winning index flipped under new values
        new_paths.append(p)
    node.paths = new_paths
    return True


def _walk(obj, st: _Walk) -> None:
    if not st.ok or obj is None or isinstance(obj, _ATOMS):
        return
    oid = id(obj)
    if oid in st.seen:
        return
    st.seen.add(oid)
    if isinstance(obj, Constant):
        if obj.param_idx >= 0:
            st.consts.setdefault(obj.param_idx, []).append(obj)
        return
    if isinstance(obj, (list, tuple)):
        for x in obj:
            _walk(x, st)
        return
    if isinstance(obj, dict):
        for v in obj.values():
            _walk(v, st)
        return
    if isinstance(obj, PhysIndexMerge):
        if obj.path_makers is None or obj.path_conds is None:
            st.ok = False  # pre-hook plan shape: not value-agnostic
            return
        st.rebuilders.append((_rebuild_merge, obj))
        # fall through to the field walk — the conditions carry the params
    elif isinstance(obj, PhysTableReader):
        if obj.partition_pruner is not None and obj.partition_conds is not None:
            st.rebuilders.append((_rebuild_partitions, obj))
        elif obj.partitions is not None:
            # an explicit PARTITION (p, ...) selection baked the set by hand
            st.ok = False
            return
        if obj.range_maker is not None:
            if obj.range_conds is None:
                st.ok = False
                return
            st.rebuilders.append((_rebuild_table, obj))
        elif obj.ranges is not None:
            st.ok = False  # ranges of unknown provenance can't be rebuilt
            return
    elif isinstance(obj, (PhysIndexReader, PhysIndexLookUp)):
        if obj.range_maker is None or obj.range_used_pos is None or obj.range_conds is None:
            st.ok = False
            return
        st.rebuilders.append((_rebuild_index, obj))
    if dataclasses.is_dataclass(obj):
        for f in dataclasses.fields(obj):
            v = getattr(obj, f.name, None)
            if callable(v) and not isinstance(v, Expression):
                continue  # rebuild hooks / warn sinks
            _walk(v, st)
        return
    if callable(obj):
        return
    # an unrecognized plan shape: refuse rather than risk a stale bake
    st.ok = False


def make_template(plan, n_params: int) -> Optional[PlanTemplate]:
    """Build a reuse template for ``plan``, or None when the plan is not
    provably value-agnostic (some parameter folded into an untraceable
    position, or a range/partition shape we cannot re-derive)."""
    if n_params <= 0:
        return None
    st = _Walk()
    _walk(plan, st)
    if not st.ok:
        return None
    if set(st.consts) != set(range(n_params)):
        # a parameter vanished (constant-folded / baked into a limit):
        # its value is burned into the plan — not reusable
        return None
    return PlanTemplate(plan, st.consts, st.rebuilders)


# -- copy-on-execute --------------------------------------------------------


def _clone(obj, memo: dict):
    """Structural clone of the plan graph: plan nodes, expressions and
    containers copy; atoms (``_ATOMS``) and pure callables (rebuild hooks,
    engine functions) share. The memo preserves ALIASING — the same
    Constant reachable from both ``pushed_conditions`` and ``range_conds``
    stays one object in the clone, which is what makes the rebuild hooks
    see the rebound parameter values."""
    if obj is None or isinstance(obj, _ATOMS):
        return obj
    oid = id(obj)
    got = memo.get(oid)
    if got is not None:
        return got
    if isinstance(obj, list):
        new: list = []
        memo[oid] = new
        new.extend(_clone(x, memo) for x in obj)
        return new
    if isinstance(obj, tuple):
        new = tuple(_clone(x, memo) for x in obj)
        memo[oid] = new
        return new
    if isinstance(obj, dict):
        nd: dict = {}
        memo[oid] = nd
        for k, v in obj.items():
            nd[k] = _clone(v, memo)
        return nd
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        cp = copy.copy(obj)  # shallow: non-field attrs (digest memos) ride along
        memo[oid] = cp
        for f in dataclasses.fields(obj):
            v = getattr(obj, f.name, None)
            if v is None or (callable(v) and not isinstance(v, Expression)):
                continue  # pure hooks shared; they read the clone's conds
            setattr(cp, f.name, _clone(v, memo))
        return cp
    # callables and anything make_template's walk vetted as shareable
    return obj


def instantiate(tmpl: PlanTemplate) -> PlanTemplate:
    """One execution's private plan instance: clone the template's plan
    graph and remap its parameter constants and rebuild nodes through the
    clone memo — one traversal, and a mapping that cannot silently diverge
    (an unreachable constant/node would raise, not drop a rebuilder). The
    shared template is never touched — rebinding the instance cannot race
    another session's execution of the same template."""
    memo: dict = {}
    plan2 = _clone(tmpl.plan, memo)
    consts = {
        idx: [memo[id(c)] for c in cs] for idx, cs in tmpl.param_consts.items()
    }
    rebuilders = [(fn, memo[id(node)]) for fn, node in tmpl.rebuilders]
    return PlanTemplate(plan2, consts, rebuilders)


def plan_fingerprint(plan) -> tuple:
    """Deterministic snapshot of every mutable leaf a rebind may touch —
    parameter constants, scan ranges, pruned partitions, index-merge paths —
    in traversal order. The plan-immutability audit compares a template's
    fingerprint before/after concurrent executions: equal fingerprints mean
    the shared bytes never changed."""
    out: list = []
    seen: set[int] = set()

    def go(obj):
        if obj is None or isinstance(obj, _ATOMS):
            return
        if id(obj) in seen:
            return
        seen.add(id(obj))
        if isinstance(obj, Constant):
            out.append(("const", obj.param_idx, repr(obj.value)))
            return
        if isinstance(obj, (list, tuple)):
            for x in obj:
                go(x)
            return
        if isinstance(obj, dict):
            for v in obj.values():
                go(v)
            return
        if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
            if isinstance(obj, (PhysTableReader, PhysIndexReader, PhysIndexLookUp)):
                out.append(("ranges", repr(getattr(obj, "ranges", None))))
            if isinstance(obj, PhysTableReader):
                parts = getattr(obj, "partitions", None)
                out.append(
                    ("partitions", repr([getattr(v, "id", v) for v in parts]) if parts is not None else "None")
                )
            if isinstance(obj, PhysIndexMerge):
                out.append(
                    ("paths", repr([(p[0], repr(p[1:])) for p in obj.paths]))
                )
            for f in dataclasses.fields(obj):
                v = getattr(obj, f.name, None)
                if callable(v) and not isinstance(v, Expression):
                    continue
                go(v)

    go(plan)
    return tuple(out)


def _plan_value(p):
    """A parameter's PLAN-TIME value: route through the same literal
    conversion the builder applied at template build (date → day number,
    datetime/timedelta → microseconds, bool → int). Assigning the raw
    Python value would desynchronize the cached plan from what a fresh
    bind would have produced."""
    from tidb_tpu_torch.parser import ast
    from tidb_tpu_torch.planner.builder import _literal_const

    return _literal_const(ast.Literal(p)).value


def rebind(tmpl: PlanTemplate, params: list) -> bool:
    """Point a plan INSTANCE's parameter constants at ``params`` and
    re-derive every dependent range/partition/path set. Callers hand this an
    :func:`instantiate` clone, never the shared cached template. False =
    this plan cannot serve these values (the caller must re-plan); the
    cached template stays structurally valid for values that keep the
    original derivation shape."""
    for idx, consts in tmpl.param_consts.items():
        v = _plan_value(params[idx])
        for c in consts:
            c.value = v
    for fn, node in tmpl.rebuilders:
        if not fn(node):
            return False
    return True
