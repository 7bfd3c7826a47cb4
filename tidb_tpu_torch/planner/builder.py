"""AST → logical plan with name resolution, type coercion and constant
folding (ref: pkg/planner/core/logical_plan_builder.go + expression
rewriter)."""

from __future__ import annotations

from dataclasses import dataclass, replace
from decimal import Decimal
from typing import Callable, Optional

import numpy as np

from tidb_tpu_torch.catalog import Catalog
from tidb_tpu_torch.expression.expr import (
    AggDesc,
    AGG_FUNCS,
    ColumnRef,
    Constant,
    EvalBatch,
    Expression,
    ScalarFunc,
    eval_to_column,
    func,
)
from tidb_tpu_torch.parser import ast
from tidb_tpu_torch.planner.plans import (
    LogicalAggregation,
    LogicalDistinct,
    LogicalDual,
    LogicalJoin,
    LogicalLimit,
    LogicalPlan,
    LogicalProjection,
    LogicalScan,
    LogicalSelection,
    LogicalSetOp,
    LogicalSort,
    OutCol,
    PlanError,
)
from tidb_tpu_torch.types import FieldType, TypeKind
from tidb_tpu_torch.types.field_type import bigint_type, bool_type, decimal_type, double_type, string_type
from tidb_tpu_torch.types.datum import date_to_days, datetime_to_micros

# parser func name → registry sig aliases
_FN_ALIAS = {
    "power": "pow",
    "log": "ln",
    "char_length": "length",
    "character_length": "length",
    "substr": "substring",
    "mid": "substring",
    "day": "dayofmonth",
    "lcase": "lower",
    "ucase": "upper",
    "ceiling": "ceil",
    "std": "stddev_pop",
    "stddev": "stddev_pop",
    "variance": "var_pop",
    "adddate": "date_add_days",
    "position": "locate",
}


# builtins whose first argument is a date/datetime (string literals coerce —
# else dictionary codes would be read as day counts) or a time
_DATE_ARG0_FNS = {
    "year", "month", "quarter", "dayofmonth", "dayofweek", "weekday", "week",
    "dayofyear", "to_days", "last_day", "date", "monthname", "dayname",
    "date_format", "unix_timestamp", "yearweek", "weekofyear",
}
_TIME_ARG0_FNS = {"hour", "minute", "second", "time_to_sec"}


def _common_type(l: FieldType, r: FieldType) -> FieldType:
    """Result type of a set-operation column pair (ref: unionJoinFieldType,
    expression/util.go aggFieldType): numeric promotion, else exact kind."""
    nullable = l.nullable or r.nullable
    if l.kind == TypeKind.NULLTYPE:
        return replace(r, nullable=True)
    if r.kind == TypeKind.NULLTYPE:
        return replace(l, nullable=True)
    if l.kind == r.kind:
        if l.kind == TypeKind.DECIMAL and l.scale != r.scale:
            return replace(decimal_type(18, max(l.scale, r.scale)), nullable=nullable)
        return replace(l, nullable=nullable)
    numeric = {TypeKind.INT, TypeKind.UINT, TypeKind.FLOAT, TypeKind.DECIMAL}
    if l.kind in numeric and r.kind in numeric:
        if TypeKind.FLOAT in (l.kind, r.kind):
            return replace(double_type(), nullable=nullable)
        if TypeKind.DECIMAL in (l.kind, r.kind):
            d = l if l.kind == TypeKind.DECIMAL else r
            return replace(decimal_type(18, d.scale), nullable=nullable)
        return replace(bigint_type(), nullable=nullable)
    raise PlanError(f"incompatible set-operand column types {l.kind.name} vs {r.kind.name}")


# known collation names → the engine's two-way collation model
# (catalog/infoschema.py COLLATIONS is the introspection mirror of this)
_COLLATION_MAP = {"utf8mb4_bin": "bin", "utf8mb4_general_ci": "ci", "binary": "bin"}


def _collate_expr(e: Expression, name: str) -> Expression:
    """expr COLLATE name / BINARY expr: override the expression's collation.

    Explicit collation is the strongest coercibility level — comparisons
    propagate it to the other operand (ref: expression/collation.go
    deriveCollation; CoercibilityExplicit wins)."""
    import copy as _copy
    from dataclasses import replace as _dc_replace

    if name not in _COLLATION_MAP:
        raise PlanError(f"Unknown collation: '{name}'")
    coll = _COLLATION_MAP[name]
    out = _copy.copy(e)
    if out.ftype.kind == TypeKind.STRING:
        out.ftype = _dc_replace(out.ftype, collation=coll)
    out._explicit_collation = coll  # type: ignore[attr-defined]
    return out


def _apply_explicit_collation(a: Expression, b: Expression):
    """If either comparison operand carries an explicit COLLATE, it governs
    the whole comparison: rewrite BOTH operands' string collation to it."""
    import copy as _copy
    from dataclasses import replace as _dc_replace

    coll = getattr(a, "_explicit_collation", None) or getattr(b, "_explicit_collation", None)
    if coll is None:
        return a, b
    out = []
    for e in (a, b):
        if e.ftype.kind == TypeKind.STRING and e.ftype.collation != coll:
            e = _copy.copy(e)
            e.ftype = _dc_replace(e.ftype, collation=coll)
        out.append(e)
    return out[0], out[1]


def _cast_expr(e: Expression, target: ast.TypeDef) -> Expression:
    """CAST target mapping (shared by the plain and mixed resolvers)."""
    tname = target.name
    if tname in ("signed", "int", "integer", "bigint", "unsigned"):
        return func("cast_int", e)
    if tname in ("double", "float", "real"):
        return func("cast_float", e)
    if tname in ("decimal", "numeric"):
        ft = decimal_type(target.length if target.length > 0 else 10, target.scale)
        return func("cast_decimal", e, ret=ft)
    if tname in ("char", "varchar", "binary", "nchar"):
        # ret_type.length carries CHAR(n)'s truncation length to the eval
        return func("cast_string", e, ret=string_type(length=target.length))
    if tname == "date":
        return func("cast_date", e)
    if tname == "datetime":
        return func("cast_datetime", e)
    raise PlanError(f"unsupported CAST target {tname}")


@dataclass
class BuildCtx:
    """Name-resolution scope."""

    schema: list  # list[OutCol]
    # aggregation context: when set, agg funcalls resolve into it
    agg_list: Optional[list[AggDesc]] = None
    agg_base: Optional[list] = None  # schema under the agg (for agg args)
    # alias → expression over current schema (SELECT aliases in HAVING/ORDER)
    aliases: Optional[dict[str, Expression]] = None


class Builder:
    def __init__(
        self,
        catalog: Catalog,
        current_db: str,
        subquery_runner: Optional[Callable] = None,
        user_vars: Optional[dict] = None,
        sys_vars: Optional[dict] = None,
        global_vars: Optional[dict] = None,
        memtable_provider: Optional[Callable] = None,
        scan_checker: Optional[Callable] = None,
        dyn_sys_vars: Optional[dict] = None,
        warn: Optional[Callable] = None,
    ):
        self.dyn_sys_vars = dyn_sys_vars
        self.warn = warn
        self.catalog = catalog
        self.db = current_db
        self.subquery_runner = subquery_runner
        self.user_vars = user_vars
        self.sys_vars = sys_vars
        self.global_vars = global_vars if global_vars is not None else sys_vars
        self.memtable_provider = memtable_provider
        self.scan_checker = scan_checker  # privilege hook per scanned table
        self._view_depth = 0
        self.hints: list = []  # current query block's optimizer hints
        # set when the built plan bakes in plan-time state (subquery results,
        # variable reads) and must not enter the plan cache
        self.uncacheable = False
        # ast window-call node id → ColumnRef into a LogicalWindow's output
        self._win_map: dict[int, Expression] = {}

    # -- statements ---------------------------------------------------------
    def build_query(self, node) -> LogicalPlan:
        """SELECT or a UNION/INTERSECT/EXCEPT compound (ref: buildSetOpr in
        logical_plan_builder.go)."""
        if isinstance(node, ast.Select):
            return self.build_select(node)
        if isinstance(node, ast.SetOp):
            return self._build_setop(node)
        raise PlanError(f"unsupported query {type(node).__name__}")

    def _build_setop(self, node: ast.SetOp) -> LogicalPlan:
        left = self.build_query(node.left)
        right = self.build_query(node.right)
        if len(left.schema) != len(right.schema):
            raise PlanError("set operands have a different number of columns")
        # unify column types: numeric promotion, else exact-kind match
        target: list[FieldType] = []
        for lc, rc in zip(left.schema, right.schema):
            target.append(_common_type(lc.ftype, rc.ftype))
        left = self._cast_to(left, target)
        right = self._cast_to(right, target)
        schema = [
            OutCol(left.schema[i].name, target[i]) for i in range(len(target))
        ]
        plan: LogicalPlan = LogicalSetOp(
            op=node.op, all=node.all, schema=schema, children=[left, right]
        )
        if node.order_by:
            by = []
            for oi in node.order_by:
                by.append((self._resolve_order(oi.expr, plan.schema, {}), oi.desc))
            plan = LogicalSort(by=by, children=[plan])
        if node.limit is not None:
            plan = LogicalLimit(limit=node.limit, offset=node.offset, children=[plan])
        return plan

    def _cast_to(self, plan: LogicalPlan, target: list[FieldType]) -> LogicalPlan:
        """Wrap ``plan`` in a projection casting each column to the target
        kind where it differs."""
        exprs: list[Expression] = []
        changed = False
        for i, (oc, ft) in enumerate(zip(plan.schema, target)):
            e: Expression = ColumnRef(i, oc.ftype, oc.name)
            scale_diff = ft.kind == TypeKind.DECIMAL and oc.ftype.scale != ft.scale
            if oc.ftype.kind != ft.kind or scale_diff:
                changed = True
                if ft.kind == TypeKind.FLOAT:
                    e = func("cast_float", e)
                elif ft.kind == TypeKind.DECIMAL:
                    e = func("cast_decimal", e, ret=ft)
                elif ft.kind in (TypeKind.INT, TypeKind.UINT):
                    e = func("cast_int", e)
                else:
                    raise PlanError(
                        f"cannot unify set-operand column types {oc.ftype.kind} vs {ft.kind}"
                    )
            exprs.append(e)
        if not changed:
            return plan
        proj = LogicalProjection(exprs=exprs, children=[plan])
        proj.schema = [
            OutCol(plan.schema[i].name, exprs[i].ftype, plan.schema[i].table, plan.schema[i].slot)
            for i in range(len(exprs))
        ]
        return proj

    def build_select(self, sel: ast.Select) -> LogicalPlan:
        prev_hints = self.hints
        prev_sub_map = getattr(self, "_scalar_sub_map", None)
        self.hints = getattr(sel, "hints", []) or prev_hints
        try:
            return self._build_select(sel)
        finally:
            self.hints = prev_hints
            self._scalar_sub_map = prev_sub_map

    def _build_select(self, sel: ast.Select) -> LogicalPlan:
        if sel.from_ is None:
            plan: LogicalPlan = LogicalDual()
        else:
            # the WHERE travels down to memtable sources as pushdown HINTS
            # (simple col-vs-literal conjuncts only): the log memtables use
            # them to filter their wire sweep server-side. Saved/restored —
            # derived tables re-enter here with their own WHERE.
            prev_w = getattr(self, "_mt_where", None)
            self._mt_where = sel.where
            try:
                plan = self._build_from(sel.from_)
            finally:
                self._mt_where = prev_w

        if sel.where is not None:
            residual: list[ast.Node] = []
            scalar_conds: list[Expression] = []
            pre_width = len(plan.schema)  # semi/anti joins keep the schema
            for cj in _split_ast_conj(sel.where):
                if isinstance(cj, ast.QuantifiedCmp):
                    cj = _quantified_to_exists(cj)
                elif isinstance(cj, ast.UnaryOp) and cj.op == "not" and isinstance(cj.operand, ast.QuantifiedCmp):
                    cj = ast.UnaryOp("not", _quantified_to_exists(cj.operand))
                joined = self._try_subquery_join(plan, cj)
                if joined is not None:
                    plan = joined
                    continue
                scalar = self._try_scalar_corr_join(plan, cj)
                if scalar is not None:
                    plan, cond = scalar
                    scalar_conds.append(cond)
                    continue
                residual.append(cj)
            conds: list[Expression] = list(scalar_conds)
            for cj in residual:
                conds.extend(self._split_conj(self.resolve(cj, BuildCtx(plan.schema))))
            if conds:
                plan = LogicalSelection(conditions=conds, children=[plan])
            if len(plan.schema) > pre_width:
                # trim correlated-scalar agg columns appended by the joins
                tp = LogicalProjection(
                    exprs=[
                        ColumnRef(i, plan.schema[i].ftype, plan.schema[i].name)
                        for i in range(pre_width)
                    ],
                    children=[plan],
                )
                tp.schema = plan.schema[:pre_width]
                plan = tp

        # correlated scalar subqueries in the SELECT list (ref: scalar Apply
        # decorrelation in projections, rule_decorrelate.go): each expands to
        # a LEFT JOIN against the per-key inner aggregate; the item resolves
        # to the joined agg column via _scalar_sub_map
        pre_sub_width = len(plan.schema)
        sub_map_saved = getattr(self, "_scalar_sub_map", None)
        self._scalar_sub_map = dict(sub_map_saved or {})
        for it in sel.items:
            if isinstance(it.expr, ast.Wildcard):
                continue
            for sub in _scalar_subquery_nodes(it.expr):
                if isinstance(sub.select, ast.Select) and self._is_correlated(sub.select, plan.schema):
                    got = self._scalar_corr_expand(plan, sub)
                    if got is not None:
                        plan, e = got
                        self._scalar_sub_map[id(sub)] = e

        # aggregation detection
        has_agg = bool(sel.group_by) or any(
            _contains_agg(it.expr) for it in sel.items
        ) or (sel.having is not None and _contains_agg(sel.having))

        # window functions (ref: buildWindowFunctions): one LogicalWindow per
        # distinct OVER spec, each appending result columns to the schema
        win_calls: list = []
        for it in sel.items:
            if not isinstance(it.expr, ast.Wildcard):
                _collect_windows(it.expr, win_calls)
        for oi in sel.order_by:
            _collect_windows(oi.expr, win_calls)
        # SELECT * must expand to the pre-window, pre-scalar-join schema only
        wild_n = pre_sub_width
        if win_calls:
            if has_agg:
                raise PlanError(
                    "window functions combined with GROUP BY/aggregates are not supported yet"
                )
            plan = self._build_windows(plan, win_calls)

        aliases: dict[str, Expression] = {}
        hidden = 0
        order_agg_map: dict[int, int] = {}  # order-item idx → hidden agg col
        order_hidden_map: dict[int, int] = {}  # order-item idx → hidden proj col
        order_agg_base = 0
        if has_agg:
            base_schema = plan.schema
            aggs: list[AggDesc] = []
            # GROUP BY accepts select-item aliases (MySQL extension):
            # an unresolvable bare name retries as the aliased expression
            alias_map: dict = {}
            dup_aliases: set = set()
            for it in sel.items:
                if it.alias:
                    a = it.alias.lower()
                    if a in alias_map:
                        dup_aliases.add(a)
                    alias_map[a] = it.expr

            def resolve_group(g):
                try:
                    return self.resolve(g, BuildCtx(base_schema))
                except PlanError:
                    if isinstance(g, ast.ColumnName) and not g.table and g.name.lower() in alias_map:
                        if g.name.lower() in dup_aliases:
                            raise PlanError(
                                f"Column '{g.name}' in group statement is ambiguous"
                            )
                        return self.resolve(alias_map[g.name.lower()], BuildCtx(base_schema))
                    raise

            group_exprs = [resolve_group(g) for g in sel.group_by]
            agg_ctx = BuildCtx(schema=[], agg_list=aggs, agg_base=base_schema)

            # first pass: group-key expressions resolve positionally
            def agg_schema():
                cols = []
                for i, a in enumerate(aggs):
                    cols.append(OutCol(f"agg#{i}", a.ftype))
                for i, g in enumerate(group_exprs):
                    name = sel.group_by[i].name if isinstance(sel.group_by[i], ast.ColumnName) else f"gb#{i}"
                    src = _source_outcol(g, base_schema)
                    cols.append(OutCol(name, g.ftype, table=src.table if src else "", slot=src.slot if src else -1))
                return cols

            proj_exprs: list[Expression] = []
            names: list[str] = []
            for it in sel.items:
                if isinstance(it.expr, ast.Wildcard):
                    raise PlanError("SELECT * with GROUP BY is not supported")
                e = self._resolve_in_agg(it.expr, base_schema, aggs, group_exprs, sel.group_by, rollup=sel.rollup)
                proj_exprs.append(e)
                nm = it.alias or _display_name(it.expr)
                names.append(nm)
                if it.alias:
                    aliases[it.alias.lower()] = e
            agg = LogicalAggregation(group_by=group_exprs, aggs=aggs, children=[plan])
            plan = agg
            having_conds: list[Expression] = []
            if sel.having is not None:
                h = self._resolve_in_agg(sel.having, base_schema, aggs, group_exprs, sel.group_by, aliases, rollup=sel.rollup)
                having_conds = self._split_conj(h)
            # ORDER BY items containing aggregates resolve against the agg
            # (may append new aggs, so this must precede finalization); they
            # ride as hidden projection columns trimmed after the sort
            order_agg_exprs: list[Expression] = []
            if sel.order_by:
                for i_o, oi in enumerate(sel.order_by):
                    # aggregates AND group-by expressions (ORDER BY YEAR(dt)
                    # after GROUP BY YEAR(dt)) resolve against the agg — the
                    # projection schema no longer carries the base columns
                    if _contains_agg(oi.expr) or _contains_group_expr(oi.expr, sel.group_by or []):
                        e_o = self._resolve_in_agg(oi.expr, base_schema, aggs, group_exprs, sel.group_by, aliases, rollup=sel.rollup)
                        order_agg_map[i_o] = len(order_agg_exprs)
                        order_agg_exprs.append(e_o)
            # agg list is final now: patch deferred group-key refs everywhere
            agg.schema = agg_schema()
            ng = len(group_exprs)
            proj_exprs = [_patch_group_refs(e, len(aggs), ng) for e in proj_exprs]
            having_conds = [_patch_group_refs(e, len(aggs), ng) for e in having_conds]
            order_agg_exprs = [_patch_group_refs(e, len(aggs), ng) for e in order_agg_exprs]
            for a in aliases:
                aliases[a] = _patch_group_refs(aliases[a], len(aggs), ng)
            if sel.rollup:
                # GROUP BY ... WITH ROLLUP: mark the agg and extend its
                # schema with the GROUPING() flag columns — the OPTIMIZER
                # picks between the fused one-pass device rollup and the
                # per-set union fallback (_expand_rollup); the deferred
                # schema layout matches the union's exactly, so every
                # downstream reference (incl. patched GROUPING() sentinels)
                # is route-independent
                import dataclasses as _dc

                agg.rollup = True
                flag_ft = bigint_type(nullable=False)
                rolled_schema = list(agg.schema)
                for j in range(ng):
                    oc = rolled_schema[len(aggs) + j]
                    if not oc.ftype.nullable:
                        rolled_schema[len(aggs) + j] = _dc.replace(
                            oc, ftype=_dc.replace(oc.ftype, nullable=True)
                        )
                agg.schema = rolled_schema + [
                    OutCol(f"grouping#{j}", flag_ft) for j in range(ng)
                ]
                plan = agg
            if having_conds:
                plan = LogicalSelection(conditions=having_conds, children=[plan])
            proj = LogicalProjection(exprs=proj_exprs, children=[plan])
            proj.schema = []
            for i in range(len(proj_exprs)):
                src = _source_outcol(proj_exprs[i], plan.schema)
                proj.schema.append(
                    OutCol(
                        names[i],
                        proj_exprs[i].ftype,
                        table=src.table if src else "",
                        slot=src.slot if src else -1,
                    )
                )
            if order_agg_exprs:
                order_agg_base = len(proj.schema)
                for k, e_o in enumerate(order_agg_exprs):
                    proj.exprs.append(e_o)
                    proj.schema.append(OutCol(f"__agg_order#{k}", e_o.ftype))
                hidden += len(order_agg_exprs)
            plan = proj
        else:
            # plain projection
            proj_exprs, names, srcs = [], [], []
            for it in sel.items:
                if isinstance(it.expr, ast.Wildcard):
                    for i, oc in enumerate(plan.schema[:wild_n]):
                        if it.expr.table and oc.table.lower() != it.expr.table.lower():
                            continue
                        proj_exprs.append(ColumnRef(i, oc.ftype, oc.name))
                        names.append(oc.name)
                        srcs.append(oc)
                    continue
                e = self.resolve(it.expr, BuildCtx(plan.schema))
                proj_exprs.append(e)
                names.append(it.alias or _display_name(it.expr))
                srcs.append(_source_outcol(e, plan.schema))
                if it.alias:
                    aliases[it.alias.lower()] = e
            if not proj_exprs:
                raise PlanError("empty select list")
            proj = LogicalProjection(exprs=proj_exprs, children=[plan])
            proj.schema = [
                OutCol(
                    names[i],
                    proj_exprs[i].ftype,
                    table=srcs[i].table if srcs[i] else "",
                    slot=srcs[i].slot if srcs[i] else -1,
                )
                for i in range(len(proj_exprs))
            ]
            # ORDER BY may reference non-projected columns → hidden extras
            if sel.order_by and sel.from_ is not None:
                base = plan.schema
                for i_o, oi in enumerate(sel.order_by):
                    if self._order_needs_hidden(oi.expr, proj.schema, aliases):
                        e = self.resolve(oi.expr, BuildCtx(base))
                        src = _source_outcol(e, base)
                        # the sort must target this slot directly — the order
                        # expression references BASE columns the projection no
                        # longer carries (ORDER BY COALESCE(v,-1) where only
                        # the alias survives), so re-resolving it against the
                        # projection schema would fail
                        order_hidden_map[i_o] = len(proj.schema)
                        # name the hidden column after its source so ORDER BY
                        # resolution finds it (duplicates with visible items
                        # are impossible — those wouldn't need a hidden col)
                        hname = src.name if src else (oi.expr.name if isinstance(oi.expr, ast.ColumnName) else f"__hidden#{hidden}")
                        proj.exprs.append(e)
                        proj.schema.append(
                            OutCol(
                                hname,
                                e.ftype,
                                table=src.table if src else "",
                                slot=src.slot if src else -1,
                            )
                        )
                        hidden += 1
            plan = proj
            if self._win_map:
                # ORDER BY resolves over the projection's schema — retarget
                # window refs (pre-projection space) onto the projected column
                for key, ref in list(self._win_map.items()):
                    for j, pe in enumerate(proj.exprs):
                        if isinstance(pe, ColumnRef) and pe.index == ref.index:
                            self._win_map[key] = ColumnRef(j, ref.ftype, ref.name)
                            break

        if sel.distinct:
            plan = LogicalDistinct(children=[plan])

        if sel.order_by:
            by = []
            for i_o, oi in enumerate(sel.order_by):
                if i_o in order_agg_map:
                    idx = order_agg_base + order_agg_map[i_o]
                    e: Expression = ColumnRef(idx, plan.schema[idx].ftype, plan.schema[idx].name)
                elif i_o in order_hidden_map:
                    idx = order_hidden_map[i_o]
                    e = ColumnRef(idx, plan.schema[idx].ftype, plan.schema[idx].name)
                else:
                    e = self._resolve_order(oi.expr, plan.schema, aliases)
                by.append((e, oi.desc))
            plan = LogicalSort(by=by, children=[plan])

        if sel.limit is not None:
            plan = LogicalLimit(limit=sel.limit, offset=sel.offset, children=[plan])

        if hidden:
            # trim hidden sort columns with a final projection
            vis = len(plan.schema) - hidden
            tp = LogicalProjection(
                exprs=[ColumnRef(i, plan.schema[i].ftype, plan.schema[i].name) for i in range(vis)],
                children=[plan],
            )
            tp.schema = plan.schema[:vis]
            plan = tp
        return plan

    # -- correlated subqueries → semi/anti join (ref: decorrelation rules,
    # core/rule/rule_decorrelate.go; only equality correlation is supported,
    # the common EXISTS/IN shape) --------------------------------------------
    def _try_subquery_join(self, plan: LogicalPlan, cj: ast.Node) -> Optional[LogicalPlan]:
        """If ``cj`` is a correlated [NOT] EXISTS / [NOT] IN-subquery
        predicate, rewrite it into a semi/anti join against ``plan`` and
        return the join; otherwise return None (the eager uncorrelated path
        in _resolve handles it)."""
        negated = False
        node = cj
        if isinstance(node, ast.UnaryOp) and node.op == "not":
            negated, node = True, node.operand
        operand_ast = None
        null_aware = False
        if isinstance(node, ast.SubqueryExpr) and node.modifier == "exists":
            inner = node.select
        elif (
            isinstance(node, ast.InList)
            and len(node.items) == 1
            and isinstance(node.items[0], ast.SubqueryExpr)
        ):
            inner = node.items[0].select
            operand_ast = node.operand
            negated = negated != node.negated
            null_aware = negated
        else:
            return None
        if not isinstance(inner, ast.Select):
            return None  # set-op subqueries stay on the eager path
        if not self._is_correlated(inner, plan.schema):
            return None
        if inner.limit is not None or inner.order_by:
            raise PlanError("correlated subquery with ORDER BY/LIMIT is not supported")
        # rewrite a private copy — probe builds must never see a mutated AST
        import copy as _copy

        inner = _copy.deepcopy(inner)
        # split the inner WHERE into correlation equalities vs local filters;
        # a probe builder resolves without executing nested subqueries
        probe = Builder(self.catalog, self.db, subquery_runner=lambda _sel: [])
        inner_from = probe._build_from(inner.from_) if inner.from_ is not None else LogicalDual()
        inner_schema = inner_from.schema
        corr: list[tuple[ast.Node, ast.Node]] = []  # (outer side, inner side)
        keep: list[ast.Node] = []
        corr_other: list[ast.Node] = []  # correlated NON-equality conjuncts
        for c in _split_ast_conj(inner.where) if inner.where is not None else []:
            pair = self._corr_eq_pair(c, inner_schema, plan.schema, probe)
            if pair is not None:
                corr.append(pair)
            elif self._conj_is_mixed(c, inner_schema, plan.schema, probe):
                # e.g. `x.v > outer.v`: becomes a join other-condition over
                # the joined row (ref: Apply/semi-join otherConds in the
                # reference's decorrelation; rule_decorrelate.go keeps
                # non-eq correlated filters on the join)
                corr_other.append(c)
            else:
                keep.append(c)
        inner_has_agg = bool(inner.group_by) or any(
            not isinstance(it.expr, ast.Wildcard) and _contains_agg(it.expr) for it in inner.items
        )
        if inner_has_agg:
            if operand_ast is None and not inner.group_by:
                # EXISTS over an ungrouped aggregate: exactly one row always
                # exists — but the stripped body must still be valid SQL
                inner.where = _and_join_ast(keep)
                try:
                    probe.build_select(inner)
                except PlanError as err:
                    if "Unknown column" in str(err) and _unknown_col_in_schema(str(err), plan.schema):
                        raise PlanError(
                            "unsupported correlated subquery: correlation must be a plain equality"
                        )
                    raise
                if not negated:
                    return plan
                return LogicalSelection(conditions=[Constant(0, bool_type())], children=[plan])
            # grouped inner / IN-with-agg: decorrelate by pulling the
            # correlation keys into GROUP BY (agg-over-join; ref:
            # rule_decorrelate.go aggregate pull-up). For a fixed outer key k
            # the (g, k)-groups of the key-stripped inner ARE the original
            # per-k groups — the extra keys split nothing — so HAVING stays a
            # local group filter and the join tests existence per (operand,
            # corr keys). NULL-key inner rows form their own groups and match
            # no outer row, exactly like the stripped equality dropped them.
            if corr_other:
                # a correlated NON-equality conjunct filters rows BEFORE the
                # aggregate — it cannot move above the agg with the keys
                raise PlanError("unsupported correlated subquery with aggregation")
            if not corr and operand_ast is None:
                raise PlanError("unsupported correlated subquery (no equality correlation)")
            if not inner.group_by:
                # An UNGROUPED aggregate yields one row even for outer keys
                # with no inner match (COUNT()=0, AVG()=NULL); the grouped
                # rewrite forms NO group there, so refuse exactly the cases
                # where that phantom row is observable: negated operands
                # (the missing {NULL}/{0} row flips NOT IN from UNKNOWN to
                # TRUE) and aggregates whose empty-set value is non-NULL
                # (COUNT and the BIT_* family — `x = 0` must see the 0).
                names: set = set()
                for it in inner.items:
                    if not isinstance(it.expr, ast.Wildcard):
                        _agg_names(it.expr, names)
                if inner.having is not None:
                    _agg_names(inner.having, names)
                if negated or names & {"count", "bit_and", "bit_or", "bit_xor"}:
                    raise PlanError("unsupported correlated subquery with aggregation")
            inner.group_by = list(inner.group_by or []) + [s for _, s in corr]
        if not corr and operand_ast is None and not corr_other:
            raise PlanError("unsupported correlated subquery (no equality correlation)")
        if corr_other and negated and null_aware:
            raise PlanError("NOT IN with non-equality correlation is not supported")
        inner.where = _and_join_ast(keep)
        base_items = len(inner.items)
        # inner-side columns the non-eq conjuncts reference must be projected
        # (before the corr items, which stay the LAST n_extra of the schema).
        # Each gets a synthetic __corr#k alias and the conjunct's references
        # rewrite to it: MySQL scoping says an unqualified name that exists
        # in BOTH scopes binds to the INNER one, and the alias sidesteps the
        # joined-layout resolver calling it ambiguous.
        corr_other = [_copy.deepcopy(c) for c in corr_other]
        inner_refs: list[ast.Node] = []
        for c in corr_other:
            for col_node in _column_nodes(c):
                if _resolves(probe, col_node, inner_schema):
                    for j, prev in enumerate(inner_refs):
                        if _ast_eq(col_node, prev):
                            k = j
                            break
                    else:
                        k = len(inner_refs)
                        inner_refs.append(_copy.deepcopy(col_node))
                        inner.items.append(ast.SelectItem(inner_refs[k], alias=f"__corr#{k}"))
                    # rewrite IN PLACE to the aliased projection
                    col_node.name, col_node.table, col_node.db = f"__corr#{k}", "", ""
        for _, inner_side in corr:
            inner.items.append(ast.SelectItem(inner_side))
        try:
            inner_plan = self.build_select(inner)
        except PlanError as err:
            if "Unknown column" in str(err) and _unknown_col_in_schema(str(err), plan.schema):
                raise PlanError(
                    "unsupported correlated subquery: correlation must be a plain equality"
                )
            raise  # a genuine unknown column — keep the original message
        n_extra = len(corr)
        eq_conds: list[tuple[int, int]] = []
        if operand_ast is not None:
            op_e = self.resolve(operand_ast, BuildCtx(plan.schema))
            if not isinstance(op_e, ColumnRef):
                raise PlanError("IN-subquery operand must be a column for correlated rewrite")
            if base_items != 1:
                raise PlanError("IN subquery must select exactly one column")
            eq_conds.append((op_e.index, 0))
        first_extra = len(inner_plan.schema) - n_extra
        for i, (outer_side, _) in enumerate(corr):
            oe = self.resolve(outer_side, BuildCtx(plan.schema))
            if not isinstance(oe, ColumnRef):
                raise PlanError("correlated comparison must reference a plain outer column")
            eq_conds.append((oe.index, first_extra + i))
        other_exprs = []
        if corr_other:
            # resolve over the JOINED layout [outer cols ++ inner cols] —
            # table aliases disambiguate same-named columns across sides
            joined_schema = list(plan.schema) + list(inner_plan.schema)
            for c in corr_other:
                other_exprs.append(self.resolve(c, BuildCtx(joined_schema)))
        return LogicalJoin(
            kind="anti" if negated else "semi",
            eq_conds=eq_conds,
            other_conds=other_exprs,
            null_aware=null_aware,
            schema=[OutCol(c.name, c.ftype, c.table, c.slot) for c in plan.schema],
            children=[plan, inner_plan],
        )

    def _try_scalar_corr_join(self, plan: LogicalPlan, cj: ast.Node):
        """Correlated *scalar* subquery in a comparison —
        ``outer.x CMP (SELECT agg(..) FROM t2 WHERE t2.k = outer.k)`` —
        rewritten by aggregate pull-up (ref: rule_decorrelate.go pulling the
        agg above a left outer join): the inner aggregates per correlation
        key, LEFT JOINs onto the outer, and the comparison becomes a filter
        over the joined agg column (NULL when no inner row, which the
        comparison correctly rejects; COUNT wraps in IFNULL(.., 0))."""
        if not (isinstance(cj, ast.BinaryOp) and cj.op in ("eq", "ne", "lt", "le", "gt", "ge")):
            return None
        for side, flip in (("right", False), ("left", True)):
            sub = getattr(cj, side)
            if isinstance(sub, ast.SubqueryExpr) and sub.modifier == "":
                other_ast = cj.left if side == "right" else cj.right
                break
        else:
            return None
        if not (isinstance(sub.select, ast.Select) and self._is_correlated(sub.select, plan.schema)):
            return None
        got = self._scalar_corr_expand(plan, sub)
        if got is None:
            return None
        join, sub_ref = got
        other_e = self.resolve(other_ast, BuildCtx(join.schema))
        a, b = (sub_ref, other_e) if flip else (other_e, sub_ref)
        return join, func(cj.op, a, b)

    def _scalar_corr_expand(self, plan: LogicalPlan, sub: ast.SubqueryExpr):
        """Expand one correlated scalar-aggregate subquery into a LEFT JOIN
        of ``plan`` against the per-correlation-key inner aggregate.
        → (join_plan, Expression for the scalar value) or None when the node
        isn't an expandable scalar subquery. Shared by the WHERE-comparison
        and SELECT-item paths."""
        inner = sub.select
        if not isinstance(inner, ast.Select) or len(inner.items) != 1:
            return None
        if inner.group_by or inner.limit is not None or inner.order_by or inner.having is not None:
            raise PlanError("correlated scalar subquery with GROUP BY/ORDER BY/LIMIT is not supported")
        item = inner.items[0]
        if isinstance(item.expr, ast.Wildcard) or not _contains_agg(item.expr):
            # non-aggregated correlated scalar: can yield >1 row — unsupported
            raise PlanError("correlated scalar subquery must be an aggregate")
        import copy as _copy

        inner = _copy.deepcopy(inner)
        probe = Builder(self.catalog, self.db, subquery_runner=lambda _sel: [])
        inner_from = probe._build_from(inner.from_) if inner.from_ is not None else LogicalDual()
        inner_schema = inner_from.schema
        corr: list[tuple[ast.Node, ast.Node]] = []
        keep: list[ast.Node] = []
        for c in _split_ast_conj(inner.where) if inner.where is not None else []:
            pair = self._corr_eq_pair(c, inner_schema, plan.schema, probe)
            if pair is not None:
                corr.append(pair)
            else:
                keep.append(c)
        if not corr:
            raise PlanError("unsupported correlated subquery (no equality correlation)")
        inner.where = _and_join_ast(keep)
        inner.group_by = [inner_side for _, inner_side in corr]
        for inner_side in inner.group_by:
            inner.items.append(ast.SelectItem(inner_side))
        try:
            inner_plan = self.build_select(inner)
        except PlanError as err:
            if "Unknown column" in str(err) and _unknown_col_in_schema(str(err), plan.schema):
                raise PlanError(
                    "unsupported correlated subquery: correlation must be a plain equality"
                )
            raise
        base_width = len(plan.schema)
        eq_conds: list[tuple[int, int]] = []
        for i, (outer_side, _) in enumerate(corr):
            oe = self.resolve(outer_side, BuildCtx(plan.schema))
            if not isinstance(oe, ColumnRef):
                raise PlanError("correlated comparison must reference a plain outer column")
            eq_conds.append((oe.index, 1 + i))
        join_schema = [OutCol(c.name, c.ftype, c.table, c.slot) for c in plan.schema] + [
            OutCol(f"__ssub#{base_width + i}", c.ftype) for i, c in enumerate(inner_plan.schema)
        ]
        join = LogicalJoin(
            kind="left",
            eq_conds=eq_conds,
            schema=join_schema,
            children=[plan, inner_plan],
        )
        agg_ft = inner_plan.schema[0].ftype
        sub_ref: Expression = ColumnRef(base_width, agg_ft, join_schema[base_width].name)
        if isinstance(item.expr, ast.FuncCall) and _FN_ALIAS.get(item.expr.name, item.expr.name) == "count":
            # COUNT over no rows is 0, not NULL
            sub_ref = func("ifnull", sub_ref, Constant(0, agg_ft))
        return join, sub_ref

    def _is_correlated(self, inner: ast.Select, outer_schema) -> bool:
        """True when the subquery fails to resolve alone but its unknown
        columns exist in the outer scope. The probe's nested subqueries
        resolve against empty results so nothing executes twice."""
        probe = Builder(self.catalog, self.db, subquery_runner=lambda _sel: [])
        try:
            probe.build_select(inner)
            return False
        except PlanError as err:
            if "Unknown column" not in str(err):
                raise
            if _unknown_col_in_schema(str(err), outer_schema):
                return True
            raise

    def _conj_is_mixed(self, c: ast.Node, inner_schema, outer_schema, probe: "Builder") -> bool:
        """True when ``c`` references BOTH scopes (a correlated non-eq
        conjunct) — every column resolves somewhere, at least one per side."""
        saw_inner = saw_outer = False
        for node in _column_nodes(c):
            if _resolves(probe, node, inner_schema):
                saw_inner = True
            elif _resolves(probe, node, outer_schema):
                saw_outer = True
            else:
                return False  # a genuinely unknown column: not ours to claim
        return saw_inner and saw_outer

    def _corr_eq_pair(self, c: ast.Node, inner_schema, outer_schema, probe: "Builder"):
        """(outer_ast, inner_ast) when ``c`` is `inner_col = outer_col` (either
        orientation), else None. ``probe`` resolves without executing."""
        if not (isinstance(c, ast.BinaryOp) and c.op == "eq"):
            return None

        def scope(x: ast.Node) -> str:
            try:
                probe.resolve(x, BuildCtx(inner_schema))
                return "inner"
            except PlanError:
                pass
            try:
                probe.resolve(x, BuildCtx(outer_schema))
                return "outer"
            except PlanError:
                return "none"

        ls, rs = scope(c.left), scope(c.right)
        if ls == "inner" and rs == "outer":
            return (c.right, c.left)
        if ls == "outer" and rs == "inner":
            return (c.left, c.right)
        return None

    def _build_windows(self, plan: LogicalPlan, win_calls: list) -> LogicalPlan:
        from tidb_tpu_torch.planner.plans import LogicalWindow, WindowFuncDesc

        groups: dict[str, list] = {}
        seen: set[int] = set()
        for fc in win_calls:
            if id(fc) in seen:
                continue
            seen.add(id(fc))
            groups.setdefault(fc.over.key(), []).append(fc)
        for calls in groups.values():
            spec = calls[0].over
            ctx = BuildCtx(plan.schema)
            part = [self.resolve(e, ctx) for e in spec.partition_by]
            order = [(self.resolve(oi.expr, ctx), oi.desc) for oi in spec.order_by]
            base_n = len(plan.schema)
            funcs: list[WindowFuncDesc] = []
            for fc in calls:
                if fc.distinct:
                    raise PlanError("DISTINCT in a window function is not supported")
                name = _FN_ALIAS.get(fc.name, fc.name)
                args = [] if (name == "count" and fc.star) else [self.resolve(a, ctx) for a in fc.args]
                if name in ("lead", "lag"):
                    for extra in args[1:]:  # offset and default
                        if not isinstance(extra, Constant):
                            raise PlanError(f"{name}() offset/default must be constant")
                if name == "ntile":
                    if not (args and isinstance(args[0], Constant)):
                        raise PlanError("ntile() bucket count must be constant")
                    if int(args[0].value or 0) < 1:
                        raise PlanError("ntile() bucket count must be positive")
                funcs.append(WindowFuncDesc(name, args, _window_ftype(name, args, order)))
            win = LogicalWindow(
                funcs=funcs,
                partition_by=part,
                order_by=order,
                whole_partition=spec.whole_partition or (not spec.order_by and spec.frame is None),
                rows_frame=spec.rows_frame,
                frame=spec.frame,
                children=[plan],
            )
            win.schema = list(plan.schema) + [
                OutCol(f"win#{base_n + i}", f.ftype) for i, f in enumerate(funcs)
            ]
            for i, fc in enumerate(calls):
                self._win_map[id(fc)] = ColumnRef(base_n + i, funcs[i].ftype, _display_name(fc))
            plan = win
        return plan

    # -- FROM ---------------------------------------------------------------
    def _build_from(self, node: ast.Node) -> LogicalPlan:
        if isinstance(node, ast.TableRef):
            db = node.db or self.db
            if db.lower() == "information_schema" and self.memtable_provider is not None:
                mem = self.memtable_provider(
                    node.name.lower(),
                    _memtable_hints(getattr(self, "_mt_where", None)),
                )
                if mem is None:
                    raise PlanError(f"Unknown table 'information_schema.{node.name}'")
                names, ftypes, rows = mem
                self.uncacheable = True  # memtables snapshot runtime state
                from tidb_tpu_torch.planner.plans import LogicalMemSource

                alias = node.alias or node.name
                ms = LogicalMemSource(
                    rows=rows,
                    schema=[OutCol(nm, ft, table=alias) for nm, ft in zip(names, ftypes)],
                )
                return ms
            view = self.catalog.view(db, node.name) if hasattr(self.catalog, "view") else None
            if view is not None:
                # expand the view definition as a derived table (ref:
                # planbuilder BuildDataSourceFromView)
                if self._view_depth >= 8:
                    raise PlanError(f"view nesting too deep at '{node.name}'")
                from tidb_tpu_torch.parser import parse

                self._view_depth += 1
                try:
                    sub = self.build_query(parse(view.text))
                finally:
                    self._view_depth -= 1
                alias = node.alias or node.name
                if view.columns:
                    if len(view.columns) != len(sub.schema):
                        raise PlanError(f"view '{node.name}' column count mismatch")
                    for oc, nm in zip(sub.schema, view.columns):
                        oc.name = nm
                for oc in sub.schema:
                    oc.table = alias
                self.uncacheable = True  # definition text can change
                return sub
            t = self.catalog.table(db, node.name)
            if self.scan_checker is not None:
                self.scan_checker(db, node.name)
            alias = node.alias or node.name
            scan = LogicalScan(db=db, table=t, alias=alias)
            if node.partitions is not None:
                if t.partition is None:
                    raise PlanError(f"PARTITION () clause on nonpartitioned table '{t.name}'")
                known_parts = {d.name.lower() for d in t.partition.defs}
                for pn in node.partitions:
                    if pn not in known_parts:
                        raise PlanError(f"Unknown partition '{pn}' in table '{t.name}'")
                scan.partition_select = list(node.partitions)
            for hname, hargs in self.hints:
                if hname in ("use_index", "ignore_index") and len(hargs) >= 2:
                    if hargs[0].strip().lower() in (alias.lower(), node.name.lower()):
                        hnames = [a.strip().lower() for a in hargs[1:]]
                        if hname == "use_index":
                            scan.use_index = hnames[0]
                            scan.allowed_indexes = frozenset(hnames) | (scan.allowed_indexes or frozenset())
                        else:
                            scan.ignored_indexes = scan.ignored_indexes | frozenset(hnames)
                elif hname == "use_index_merge" and hargs:
                    if hargs[0].strip().lower() in (alias.lower(), node.name.lower()):
                        scan.use_index_merge = True
            known = {i.name for i in t.indexes} | ({"primary"} if t.pk_is_handle else set())
            for kind, names in node.index_hints or []:
                # table-level USE/IGNORE/FORCE INDEX (...) — MySQL merges
                # every clause on the reference: USE/FORCE union into the
                # candidate restriction (empty = USE INDEX () = table scan)
                # with cost choosing among the candidates, IGNORE unions
                # into the exclusion set, FORCE additionally demotes the
                # table scan to a last resort (ref: the tableHintInfo →
                # path pruning in planbuilder.go)
                for nm in names:
                    if nm not in known:
                        # ER_KEY_DOES_NOT_EXIST — a typo must not silently
                        # disable every index on the table
                        raise PlanError(f"Key '{nm}' doesn't exist in table '{t.name}'")
                if kind in ("use", "force"):
                    scan.allowed_indexes = frozenset(names) | (scan.allowed_indexes or frozenset())
                    if kind == "force":
                        scan.force_index = True
                else:
                    scan.ignored_indexes = scan.ignored_indexes | frozenset(names)
            scan.schema = [
                OutCol(c.name, c.ftype, table=alias, slot=c.offset) for c in t.columns
            ]
            return scan
        if isinstance(node, ast.SubquerySource):
            sub = self.build_query(node.select)
            alias = node.alias or "subquery"
            if node.col_aliases:
                if len(node.col_aliases) != len(sub.schema):
                    raise PlanError(
                        f"derived table '{alias}' has {len(node.col_aliases)} column "
                        f"aliases for {len(sub.schema)} columns"
                    )
                for oc, nm in zip(sub.schema, node.col_aliases):
                    oc.name = nm
            for oc in sub.schema:
                oc.table = alias
            return sub
        if isinstance(node, ast.ValuesSource):
            from tidb_tpu_torch.planner.plans import LogicalMemSource

            alias = node.alias or "values"
            schema = [
                OutCol(nm, ft, table=alias) for nm, ft in zip(node.names, node.ftypes)
            ]
            return LogicalMemSource(rows=node.rows, schema=schema)
        if isinstance(node, ast.Join):
            left = self._build_from(node.left)
            right = self._build_from(node.right)
            schema = [OutCol(c.name, c.ftype, c.table, c.slot) for c in left.schema] + [
                OutCol(c.name, c.ftype, c.table, c.slot) for c in right.schema
            ]
            join = LogicalJoin(kind=node.kind, schema=schema, children=[left, right])
            if node.on is not None:
                conds = self._split_conj(self.resolve(node.on, BuildCtx(schema)))
                nleft = len(left.schema)
                for c in conds:
                    pair = _as_equi_pair(c, nleft)
                    if pair is not None:
                        join.eq_conds.append(pair)
                    else:
                        join.other_conds.append(c)
            # join-algorithm hints (ref: HASH_JOIN/MERGE_JOIN/INL_JOIN hints,
            # planner hint handling). Scope: the build/inner (right) side's
            # tables, plus the left side only when it is a single base table —
            # a chain's upper joins must not match a lower join's table just
            # because its columns flow through the accumulated schema
            tables = {c.table.lower() for c in right.schema if c.table}
            left_tables = {c.table.lower() for c in left.schema if c.table}
            if len(left_tables) == 1:
                tables |= left_tables
            for hname, hargs in self.hints:
                h = hname.lower()
                alg = {"hash_join": "hash", "merge_join": "merge", "inl_join": "index", "index_join": "index"}.get(h)
                if alg and any(a.strip().lower() in tables for a in hargs):
                    join.preferred = alg
            return join
        raise PlanError(f"unsupported FROM clause {type(node).__name__}")

    # -- expression resolution ----------------------------------------------
    def _fold_warn(self, level, code, msg):
        # a fold-time warning is data-independent but STATEMENT-scoped: the
        # plan must not be cached, or repeats would silently stop warning
        self.uncacheable = True
        if self.warn is not None:
            self.warn(level, code, msg)

    def resolve(self, node: ast.Node, ctx: BuildCtx) -> Expression:
        e = self._resolve(node, ctx)
        return _fold(e, self._fold_warn)

    def _resolve(self, node: ast.Node, ctx: BuildCtx) -> Expression:
        if isinstance(node, ast.Literal):
            return _literal(node)
        if isinstance(node, ast.ParamMarker):
            raise PlanError("parameter marker outside PREPARE/EXECUTE")
        if isinstance(node, ast.UserVar):
            # user/system variable reads fold to constants at plan time →
            # such plans must not be cached (ref: plan-cache skips them)
            self.uncacheable = True
            if node.sys:
                if self.dyn_sys_vars is not None and node.name in self.dyn_sys_vars:
                    # statement-scope dynamics (@@warning_count/@@error_count
                    # — ref: session.go variable read hooks)
                    return _literal(ast.Literal(self.dyn_sys_vars[node.name]))
                src = self.sys_vars if node.scope != "global" else self.global_vars
                if src is None or node.name not in src:
                    raise PlanError(f"unknown system variable '{node.name}'")
                return _literal(ast.Literal(src[node.name]))
            val = (self.user_vars or {}).get(node.name)
            if isinstance(val, str):
                val = val.encode()
            return _literal(ast.Literal(val))
        if isinstance(node, ast.ColumnName):
            return self._resolve_column(node, ctx)
        if isinstance(node, ast.BinaryOp):
            # date ± INTERVAL n unit (ref: MySQL date arithmetic)
            if node.op in ("plus", "minus"):
                for side, other in ((node.right, node.left), (node.left, node.right)):
                    if isinstance(side, ast.FuncCall) and side.name == "interval":
                        if side is node.left and node.op == "minus":
                            raise PlanError("INTERVAL - date is invalid")
                        n = self._resolve(side.args[0], ctx)
                        unit = side.args[1].value
                        base = self._resolve(other, ctx)
                        neg = node.op == "minus"
                        return self._date_interval(base, n, unit, neg)
            left = self._resolve(node.left, ctx)
            right = self._resolve(node.right, ctx)
            return self._binary(node.op, left, right)
        if isinstance(node, ast.UnaryOp):
            if node.op == "not":
                return func("not", self._resolve(node.operand, ctx))
            if node.op == "unaryminus":
                return func("unaryminus", self._resolve(node.operand, ctx))
            if node.op == "bitneg":
                return func("bitneg", self._resolve(node.operand, ctx))
            raise PlanError(f"unsupported unary op {node.op}")
        if isinstance(node, ast.IsNull):
            e = func("isnull", self._resolve(node.operand, ctx))
            return func("not", e) if node.negated else e
        if isinstance(node, ast.InList):
            if len(node.items) == 1 and isinstance(node.items[0], ast.SubqueryExpr):
                vals = self._run_subquery(node.items[0].select, expect_cols=1)
                items = [_const_like(v[0]) for v in vals]
                if not items:
                    return Constant(0 if not node.negated else 1, bool_type())
            else:
                items = [self._resolve(x, ctx) for x in node.items]
            operand = self._resolve(node.operand, ctx)
            items = [self._coerce_to(operand.ftype, it) for it in items]
            e = func("in", operand, *items)
            return func("not", e) if node.negated else e
        if isinstance(node, ast.Between):
            operand = self._resolve(node.operand, ctx)
            lo = self._coerce_to(operand.ftype, self._resolve(node.low, ctx))
            hi = self._coerce_to(operand.ftype, self._resolve(node.high, ctx))
            e = func("and", self._binary("ge", operand, lo), self._binary("le", operand, hi))
            return func("not", e) if node.negated else e
        if isinstance(node, ast.Like):
            sig = "regexp" if node.regexp else "like"
            operand = self._resolve(node.operand, ctx)
            pattern = self._resolve(node.pattern, ctx)
            operand, pattern = _apply_explicit_collation(operand, pattern)
            e = func(sig, operand, pattern)
            return func("not", e) if node.negated else e
        if isinstance(node, ast.Collate):
            return _collate_expr(self._resolve(node.operand, ctx), node.collation)
        if isinstance(node, ast.FuncCall) and node.name in ("date_add", "date_sub", "adddate", "subdate") and len(node.args) == 2 and isinstance(node.args[1], ast.FuncCall) and node.args[1].name == "interval":
            base = self._resolve(node.args[0], ctx)
            iv = node.args[1]
            n = self._resolve(iv.args[0], ctx)
            return self._date_interval(base, n, iv.args[1].value, node.name in ("date_sub", "subdate"))
        if isinstance(node, ast.FuncCall):
            if self._win_map and id(node) in self._win_map:
                return self._win_map[id(node)]
            return self._func_call(node, ctx)
        if isinstance(node, ast.CaseWhen):
            args: list[Expression] = []
            for cond, val in node.branches:
                c = self._resolve(cond, ctx)
                if node.operand is not None:
                    c = self._binary("eq", self._resolve(node.operand, ctx), c)
                args.append(c)
                args.append(self._resolve(val, ctx))
            if node.else_value is not None:
                args.append(self._resolve(node.else_value, ctx))
            return func("case_when", *args)
        if isinstance(node, ast.Cast):
            return _cast_expr(self._resolve(node.operand, ctx), node.target)
        if isinstance(node, ast.QuantifiedCmp):
            return self._resolve_quantified(node, ctx)
        if isinstance(node, ast.SubqueryExpr):
            m = getattr(self, "_scalar_sub_map", None)
            if m and id(node) in m:
                return m[id(node)]  # pre-expanded correlated scalar join col
            if node.modifier == "exists":
                vals = self._run_subquery(node.select, limit=1)
                return Constant(1 if vals else 0, bool_type())
            vals = self._run_subquery(node.select, expect_cols=1, limit=2)
            if len(vals) > 1:
                raise PlanError("scalar subquery returned more than one row")
            return _const_like(vals[0][0]) if vals else Constant(None, FieldType(TypeKind.NULLTYPE))
        raise PlanError(f"unsupported expression {type(node).__name__}")

    def _resolve_quantified(self, node: "ast.QuantifiedCmp", ctx: BuildCtx) -> Expression:
        """Value-context `left OP ANY|ALL (S)` with full three-valued-logic
        semantics: S runs eagerly (uncorrelated) and the result folds to a
        comparison against the relevant extreme, OR/AND-ed with NULL when S
        contains NULLs — so SELECT-list uses return NULL exactly where MySQL
        does (ref: expression_rewriter.go buildQuantifierPlan min/max form)."""
        # eq ANY ≡ IN, ne ALL ≡ NOT IN — exact, reuse those paths
        if node.op == "eq" and not node.is_all:
            return self._resolve(ast.InList(node.left, [ast.SubqueryExpr(node.select, "in")]), ctx)
        if node.op == "ne" and node.is_all:
            return self._resolve(
                ast.InList(node.left, [ast.SubqueryExpr(node.select, "in")], negated=True), ctx
            )
        vals = self._run_subquery(node.select, expect_cols=1)
        left = self._resolve(node.left, ctx)
        xs = [v[0] for v in vals]
        has_null = any(x is None for x in xs)
        nn = sorted({x for x in xs if x is not None})
        null_c = Constant(None, FieldType(TypeKind.NULLTYPE))
        if not nn:
            if not vals:  # empty set: ALL vacuously TRUE, ANY FALSE
                return Constant(1 if node.is_all else 0, bool_type())
            return null_c  # only NULLs: every comparison is NULL
        if node.op in ("lt", "le", "gt", "ge"):
            if node.is_all:
                ext = nn[0] if node.op in ("lt", "le") else nn[-1]
            else:
                ext = nn[-1] if node.op in ("lt", "le") else nn[0]
            base = self._binary(node.op, left, _const_like(ext))
            if has_null:
                return func("and" if node.is_all else "or", base, null_c)
            return base
        if node.op == "eq":  # eq ALL: all values must equal left
            base = self._binary("eq", left, _const_like(nn[0]))
            if len(nn) > 1:  # two distinct values: FALSE for any non-NULL left
                base = func("and", base, self._binary("eq", left, _const_like(nn[1])))
            return func("and", base, null_c) if has_null else base
        # ne ANY: some value differs from left
        base = self._binary("ne", left, _const_like(nn[0]))
        if len(nn) > 1:
            base = func("or", base, self._binary("ne", left, _const_like(nn[1])))
        return func("or", base, null_c) if has_null else base

    def _date_interval(self, base, n, unit: str, negate: bool):
        """date ± INTERVAL n unit → the date_add_* builtins (ref: MySQL
        date arithmetic units; day-ish units in days, sub-day in micros,
        month-ish via calendar month math with day clamping)."""
        from tidb_tpu_torch.expression.expr import Constant
        from tidb_tpu_torch.types.field_type import bigint_type

        def times(e, k: int):
            if k == 1:
                return e
            return func("mul", e, Constant(k, bigint_type(nullable=False)))

        if base.ftype.kind == TypeKind.STRING:
            if not isinstance(base, Constant):
                # no runtime string→temporal cast yet: dictionary-code
                # arithmetic would be garbage — fail loudly instead
                raise PlanError("INTERVAL arithmetic needs a DATE/DATETIME operand (CAST the string column)")
            v = base.value.decode() if isinstance(base.value, bytes) else str(base.value)
            kind = TypeKind.DATETIME if ":" in v else TypeKind.DATE
            base = self._coerce_to(FieldType(kind), base)
        if negate:
            n = func("unaryminus", n)
        u = unit.lower()
        if u in ("day", "week"):
            return func("date_add_days", base, times(n, 7 if u == "week" else 1))
        if u in ("month", "quarter", "year"):
            k = {"month": 1, "quarter": 3, "year": 12}[u]
            return func("date_add_months", base, times(n, k))
        if u in ("hour", "minute", "second", "microsecond"):
            k = {"hour": 3_600_000_000, "minute": 60_000_000, "second": 1_000_000, "microsecond": 1}[u]
            return func("date_add_micros", base, times(n, k))
        raise PlanError(f"unsupported INTERVAL unit {unit}")

    def _resolve_column(self, node: ast.ColumnName, ctx: BuildCtx) -> Expression:
        name = node.name.lower()
        tbl = node.table.lower()
        matches = [
            i
            for i, oc in enumerate(ctx.schema)
            if oc.name.lower() == name and (not tbl or oc.table.lower() == tbl)
        ]
        if not matches and ctx.aliases and not tbl and name in ctx.aliases:
            return ctx.aliases[name]
        if not matches:
            raise PlanError(f"Unknown column '{node}'")
        if len(matches) > 1:
            raise PlanError(f"Column '{node}' is ambiguous")
        oc = ctx.schema[matches[0]]
        return ColumnRef(matches[0], oc.ftype, oc.name)

    def _func_call(self, node: ast.FuncCall, ctx: BuildCtx) -> Expression:
        name = _FN_ALIAS.get(node.name, node.name)
        if node.over is not None:
            raise PlanError(f"window function {name}() is not allowed in this clause")
        if name in PURE_WINDOW_FUNCS:
            raise PlanError(f"{name}() requires an OVER clause")
        if name in AGG_FUNCS or (name == "count" and node.star):
            # agg calls are intercepted by _resolve_in_agg's rewrite pass;
            # reaching here means an agg in a pure scalar context
            raise PlanError(f"aggregate {name}() used outside aggregation context")
        if name == "interval":
            raise PlanError("INTERVAL outside date arithmetic")
        if name in ("nextval", "setval"):
            # sequence functions allocate at resolve time (each INSERT row
            # resolves separately, so every row draws a fresh value)
            self.uncacheable = True
            if not node.args or not isinstance(node.args[0], ast.ColumnName):
                raise PlanError(f"{name}() takes a sequence name")
            ref = node.args[0]
            seq_db = ref.table or self.db
            if name == "nextval":
                v = self.catalog.sequence_nextval(seq_db, ref.name)
            else:
                if len(node.args) != 2:
                    raise PlanError("setval(seq, value)")
                arg = self.resolve(node.args[1], ctx)
                if not isinstance(arg, Constant):
                    raise PlanError("setval value must be constant")
                v = self.catalog.sequence_setval(seq_db, ref.name, int(arg.value))
            return Constant(v, bigint_type(nullable=False))
        if name in ("now", "current_timestamp"):
            import datetime

            return Constant(datetime.datetime.now(), FieldType(TypeKind.DATETIME, nullable=False))
        if name in ("curdate", "current_date"):
            import datetime

            return Constant(datetime.date.today(), FieldType(TypeKind.DATE, nullable=False))
        if name in ("curtime", "current_time"):
            import datetime

            t = datetime.datetime.now().time()
            us = ((t.hour * 3600 + t.minute * 60 + t.second) * 1_000_000) + t.microsecond
            return Constant(us, FieldType(TypeKind.DURATION, nullable=False))
        if name in ("utc_date", "utc_timestamp", "utc_time"):
            import datetime

            u = datetime.datetime.now(datetime.timezone.utc).replace(tzinfo=None, microsecond=0)
            if name == "utc_date":
                return Constant(u.date(), FieldType(TypeKind.DATE, nullable=False))
            if name == "utc_timestamp":
                return Constant(u, FieldType(TypeKind.DATETIME, nullable=False))
            us = ((u.hour * 3600 + u.minute * 60 + u.second) * 1_000_000) + u.microsecond
            return Constant(us, FieldType(TypeKind.DURATION, nullable=False))
        if name == "pi" and not node.args:
            return Constant(3.141592653589793, FieldType(TypeKind.FLOAT, nullable=False))
        if name == "last_insert_id" and not node.args:
            self.uncacheable = True  # session-scope dynamic, like @@warning_count
            v = (self.dyn_sys_vars or {}).get("last_insert_id", 0)
            return Constant(int(v), bigint_type(nullable=False))
        if name == "any_value" and len(node.args) == 1:
            # MySQL: suppresses ONLY_FULL_GROUP_BY checking; value passthrough
            return self._resolve(node.args[0], ctx)
        if name in ("timestampdiff", "timestampadd") and len(node.args) == 3:
            return self._timestamp_func(name, node, ctx, self._resolve)
        if name == "str_to_date" and len(node.args) == 2:
            # result kind depends on the format string: time specifiers →
            # DATETIME, else DATE (ref: builtin_time.go strToDate)
            args = [self._resolve(a, ctx) for a in node.args]
            fmt = args[1]
            if isinstance(fmt, Constant) and isinstance(fmt.value, (str, bytes)):
                from tidb_tpu_torch.expression.eval import str_to_date_has_time

                f = fmt.value.decode() if isinstance(fmt.value, bytes) else fmt.value
                kind = TypeKind.DATETIME if str_to_date_has_time(f) else TypeKind.DATE
                return func("str_to_date", *args, ret=FieldType(kind, nullable=True))
            return func("str_to_date", *args)
        if name in ("datediff", "timediff", "addtime", "subtime"):
            # string-literal operands coerce to the temporal kind MySQL
            # implies: dates for DATEDIFF; for the time functions a literal
            # with a date part reads as DATETIME, else as a DURATION
            def time_like(e):
                if not (isinstance(e, Constant) and e.ftype.kind == TypeKind.STRING):
                    return e
                v = e.value.decode() if isinstance(e.value, bytes) else str(e.value)
                kind = TypeKind.DATETIME if ("-" in v.lstrip("-") or " " in v.strip()) else TypeKind.DURATION
                return self._coerce_to(FieldType(kind), e)

            args = [self._resolve(a, ctx) for a in node.args]
            if len(args) == 2:
                a, b = args
                if name == "datediff":
                    tgt = FieldType(TypeKind.DATE)
                    a = self._coerce_to(tgt, a) if a.ftype.kind == TypeKind.STRING else a
                    b = self._coerce_to(tgt, b) if b.ftype.kind == TypeKind.STRING else b
                else:  # addtime/subtime/timediff: both sides time-like
                    a = time_like(a)
                    b = time_like(b)
                return func(name, a, b)
            return func(name, *args)
        if name == "nullif":
            a = self._resolve(node.args[0], ctx)
            b = self._resolve(node.args[1], ctx)
            return func("case_when", self._binary("eq", a, b), Constant(None, FieldType(TypeKind.NULLTYPE)), a)
        args = [self._resolve(a, ctx) for a in node.args]
        if name in _DATE_ARG0_FNS and args and isinstance(args[0], Constant) and args[0].ftype.kind == TypeKind.STRING:
            v = args[0].value.decode() if isinstance(args[0].value, bytes) else str(args[0].value)
            kind = TypeKind.DATETIME if ":" in v else TypeKind.DATE
            args[0] = self._coerce_to(FieldType(kind), args[0])
        elif name in _TIME_ARG0_FNS and args and isinstance(args[0], Constant) and args[0].ftype.kind == TypeKind.STRING:
            args[0] = self._coerce_to(FieldType(TypeKind.DURATION), args[0])
        try:
            return func(name, *args)
        except KeyError:
            raise PlanError(f"unknown function {node.name}()")

    def _binary(self, op: str, left: Expression, right: Expression) -> Expression:
        if op in ("eq", "ne", "lt", "le", "gt", "ge"):
            left, right = self._coerce_cmp(left, right)
            left, right = _apply_explicit_collation(left, right)
        return func(op, left, right)

    def _coerce_cmp(self, a: Expression, b: Expression):
        """Implicit comparison casts (MySQL type-conversion rules):
        temporal vs string constant parses the literal; numeric vs string
        compares as floating point (both sides to DOUBLE)."""
        for x, y in ((a, b), (b, a)):
            if x.ftype.is_temporal and isinstance(y, Constant) and y.ftype.kind == TypeKind.STRING:
                conv = self._coerce_to(x.ftype, y)
                if x is a:
                    return a, conv
                return conv, b
        numeric = {TypeKind.INT, TypeKind.UINT, TypeKind.FLOAT, TypeKind.DECIMAL}
        for x, y in ((a, b), (b, a)):
            if x.ftype.kind in numeric and y.ftype.kind == TypeKind.STRING and not x.ftype.is_temporal:
                conv = func("cast_float", y)
                if x is a:
                    return a, conv
                return conv, b
        return a, b

    def _coerce_to(self, ft: FieldType, e: Expression) -> Expression:
        if not isinstance(e, Constant) or e.value is None:
            return e
        v = e.value
        if ft.kind == TypeKind.DATE and isinstance(v, (str, bytes)):
            s = v.decode() if isinstance(v, bytes) else v
            return Constant(date_to_days(s), ft.not_null())
        if ft.kind == TypeKind.DATETIME and isinstance(v, (str, bytes)):
            s = v.decode() if isinstance(v, bytes) else v
            try:
                return Constant(datetime_to_micros(s), ft.not_null())
            except ValueError:
                return Constant(datetime_to_micros(s + " 00:00:00"), ft.not_null())
        if ft.kind == TypeKind.DURATION and isinstance(v, (str, bytes)):
            from tidb_tpu_torch.types.datum import duration_to_micros

            s = v.decode() if isinstance(v, bytes) else v
            return Constant(duration_to_micros(s), ft.not_null())
        return e

    # -- agg resolution -------------------------------------------------------
    def _resolve_in_agg(self, node, base_schema, aggs, group_exprs, group_asts, aliases=None, rollup=False):
        """Resolve an expression in SELECT/HAVING of an aggregated query:
        agg calls → refs into the agg output; group-by exprs → group key refs;
        bare columns → implicit first_row (MySQL non-strict)."""
        agg_schema_len = lambda: len(aggs)  # noqa: E731

        def walk(n):
            # whole-expression matches a group-by item? (deferred index: agg
            # count isn't final yet — ColumnRef(-1-gi) is patched afterwards)
            for gi, gast in enumerate(group_asts):
                if _ast_eq(n, gast):
                    e = group_exprs[gi]
                    return ColumnRef(-1 - gi, e.ftype, f"gb#{gi}")
            if isinstance(n, ast.FuncCall):
                name = _FN_ALIAS.get(n.name, n.name)
                if name == "grouping" and len(n.args) == 1:
                    # GROUPING(g): 1 on super-aggregate (rolled-up) rows,
                    # 0 otherwise (ref: expression.grouping + Expand). Only
                    # meaningful under WITH ROLLUP; resolves to a deferred
                    # flag-column ref the rollup rewrite materializes.
                    if not rollup:
                        raise PlanError("GROUPING() is only valid with GROUP BY ... WITH ROLLUP")
                    for gi, gast in enumerate(group_asts):
                        if _ast_eq(n.args[0], gast):
                            return ColumnRef(-20001 - gi, bigint_type(nullable=False), f"grouping#{gi}")
                    raise PlanError("GROUPING() argument must be a GROUP BY expression")
                if name in AGG_FUNCS or n.star:
                    if n.star:
                        desc = AggDesc("count", None)
                    else:
                        if name == "group_concat" and len(n.args) > 1:
                            # GROUP_CONCAT(a, b, ...) concatenates the values
                            # per row first (MySQL semantics)
                            parts = [self.resolve(a, BuildCtx(base_schema)) for a in n.args]
                            parts = [
                                p if p.ftype.kind == TypeKind.STRING else func("cast_string", p, ret=string_type())
                                for p in parts
                            ]
                            arg = func("concat", *parts)
                        else:
                            arg = self.resolve(n.args[0], BuildCtx(base_schema))
                        gc_order = []
                        if name == "group_concat" and n.order_by:
                            gc_order = [
                                (self.resolve(e, BuildCtx(base_schema)), d) for e, d in n.order_by
                            ]
                        desc = AggDesc(
                            name,
                            arg,
                            distinct=n.distinct,
                            sep=n.separator if n.separator is not None else ",",
                            order_by=gc_order,
                        )
                    for i, existing in enumerate(aggs):
                        if repr(existing) == repr(desc):
                            return ColumnRef(i, existing.ftype, f"agg#{i}")
                    aggs.append(desc)
                    return ColumnRef(len(aggs) - 1, desc.ftype, f"agg#{len(aggs) - 1}")
                if name in ("timestampdiff", "timestampadd") and len(n.args) == 3:
                    # args[0] is the unit keyword, not a column
                    return ast.FuncCall(n.name, [n.args[0], walk(n.args[1]), walk(n.args[2])])
                if name == "any_value" and len(n.args) == 1:
                    return walk(n.args[0])
                return ast.FuncCall(n.name, [walk(a) for a in n.args], n.distinct, n.star)
            if isinstance(n, ast.BinaryOp):
                return ast.BinaryOp(n.op, walk(n.left), walk(n.right))
            if isinstance(n, ast.UnaryOp):
                return ast.UnaryOp(n.op, walk(n.operand))
            if isinstance(n, ast.ColumnName):
                # group key column? (matched above); SELECT alias (HAVING/
                # ORDER BY)? else implicit first_row (MySQL non-strict)
                if not n.table and aliases and n.name.lower() in aliases:
                    return aliases[n.name.lower()]
                arg = self.resolve(n, BuildCtx(base_schema))
                desc = AggDesc("first_row", arg)
                for i, existing in enumerate(aggs):
                    if repr(existing) == repr(desc):
                        return ColumnRef(i, existing.ftype, f"agg#{i}")
                aggs.append(desc)
                return ColumnRef(len(aggs) - 1, desc.ftype, f"agg#{len(aggs) - 1}")
            if isinstance(n, ast.SubqueryExpr):
                m = getattr(self, "_scalar_sub_map", None)
                if m and id(n) in m:
                    # pre-expanded correlated scalar: functionally dependent
                    # on its correlation keys — implicit first_row per group
                    desc = AggDesc("first_row", m[id(n)])
                    for i, existing in enumerate(aggs):
                        if repr(existing) == repr(desc):
                            return ColumnRef(i, existing.ftype, f"agg#{i}")
                    aggs.append(desc)
                    return ColumnRef(len(aggs) - 1, desc.ftype, f"agg#{len(aggs) - 1}")
                return n
            if isinstance(n, (ast.Literal, Expression)):
                return n
            if isinstance(n, ast.CaseWhen):
                return ast.CaseWhen(
                    walk(n.operand) if n.operand else None,
                    [(walk(c), walk(v)) for c, v in n.branches],
                    walk(n.else_value) if n.else_value else None,
                )
            if isinstance(n, ast.IsNull):
                return ast.IsNull(walk(n.operand), n.negated)
            if isinstance(n, ast.InList):
                return ast.InList(walk(n.operand), [walk(x) for x in n.items], n.negated)
            if isinstance(n, ast.Between):
                return ast.Between(walk(n.operand), walk(n.low), walk(n.high), n.negated)
            if isinstance(n, ast.Cast):
                return ast.Cast(walk(n.operand), n.target)
            return n

        rewritten = walk(node)
        # now resolve the rewritten tree against the agg output schema;
        # embedded Expression nodes pass through untouched
        agg_out = []
        for i, a in enumerate(aggs):
            agg_out.append(OutCol(f"agg#{i}", a.ftype))
        for gi, g in enumerate(group_exprs):
            agg_out.append(OutCol(f"gb#{gi}", g.ftype))
        # NOTE: group-key refs stay negative (deferred) — the caller patches
        # them once the agg list stops growing (after all items + HAVING)
        return self._resolve_mixed(rewritten, BuildCtx(agg_out, aliases=aliases))


    _TS_UNIT_US = {
        "microsecond": 1,
        "second": 1_000_000,
        "minute": 60_000_000,
        "hour": 3_600_000_000,
        "day": 86_400_000_000,
        "week": 7 * 86_400_000_000,
    }

    def _timestamp_func(self, name, node, ctx, rfn):
        """TIMESTAMPDIFF/TIMESTAMPADD(unit, ...) — shared by the plain and
        the aggregate resolution paths (``rfn`` resolves the non-unit args;
        the unit arrives as a bare identifier, never a column)."""
        u = node.args[0]
        unit = u.name.lower() if isinstance(u, ast.ColumnName) and not u.table else None
        if unit and unit.startswith("sql_tsi_"):
            unit = unit[8:]
        if unit is None or (unit not in self._TS_UNIT_US and unit not in ("month", "quarter", "year")):
            raise PlanError(f"unknown interval unit for {name.upper()}")

        def dt_coerce(e):
            if isinstance(e, Constant) and e.ftype.kind == TypeKind.STRING:
                v = e.value.decode() if isinstance(e.value, bytes) else str(e.value)
                kind = TypeKind.DATETIME if ":" in v else TypeKind.DATE
                return self._coerce_to(FieldType(kind), e)
            return e

        if name == "timestampadd":
            nexp = rfn(node.args[1], ctx)
            base = dt_coerce(rfn(node.args[2], ctx))
            return self._date_interval(base, nexp, unit, False)
        a = dt_coerce(rfn(node.args[1], ctx))
        b = dt_coerce(rfn(node.args[2], ctx))
        if unit in ("month", "quarter", "year"):
            months = func("tsdiff_months", a, b)
            if unit == "month":
                return months
            per = 3 if unit == "quarter" else 12
            return func("intdiv", months, Constant(per, bigint_type(nullable=False)))
        diff = func("tsdiff_micros", a, b)
        if self._TS_UNIT_US[unit] == 1:
            return diff
        return func("intdiv", diff, Constant(self._TS_UNIT_US[unit], bigint_type(nullable=False)))

    def _resolve_mixed(self, node, ctx: BuildCtx) -> Expression:
        if isinstance(node, Expression):
            return node
        if isinstance(node, ast.BinaryOp):
            return self._binary(node.op, self._resolve_mixed(node.left, ctx), self._resolve_mixed(node.right, ctx))
        if isinstance(node, ast.UnaryOp):
            op = "not" if node.op == "not" else node.op
            return func(op if op != "unaryplus" else "plus", self._resolve_mixed(node.operand, ctx))
        if isinstance(node, ast.FuncCall):
            name = _FN_ALIAS.get(node.name, node.name)
            if name in ("timestampdiff", "timestampadd") and len(node.args) == 3:
                return self._timestamp_func(name, node, ctx, self._resolve_mixed)
            if name == "any_value" and len(node.args) == 1:
                return self._resolve_mixed(node.args[0], ctx)
            args = [self._resolve_mixed(a, ctx) for a in node.args]
            return func(name, *args)
        if isinstance(node, ast.CaseWhen):
            args = []
            for c, v in node.branches:
                cc = self._resolve_mixed(c, ctx)
                if node.operand is not None:
                    cc = self._binary("eq", self._resolve_mixed(node.operand, ctx), cc)
                args.append(cc)
                args.append(self._resolve_mixed(v, ctx))
            if node.else_value is not None:
                args.append(self._resolve_mixed(node.else_value, ctx))
            return func("case_when", *args)
        if isinstance(node, ast.IsNull):
            e = func("isnull", self._resolve_mixed(node.operand, ctx))
            return func("not", e) if node.negated else e
        if isinstance(node, ast.InList):
            e = func("in", self._resolve_mixed(node.operand, ctx), *[self._resolve_mixed(x, ctx) for x in node.items])
            return func("not", e) if node.negated else e
        if isinstance(node, ast.Between):
            operand = self._resolve_mixed(node.operand, ctx)
            e = func(
                "and",
                self._binary("ge", operand, self._resolve_mixed(node.low, ctx)),
                self._binary("le", operand, self._resolve_mixed(node.high, ctx)),
            )
            return func("not", e) if node.negated else e
        if isinstance(node, ast.Cast):
            return _cast_expr(self._resolve_mixed(node.operand, ctx), node.target)
        return _fold(self._resolve(node, ctx))

    def _order_needs_hidden(self, node, proj_schema, aliases) -> bool:
        if isinstance(node, ast.Literal):
            return False
        if isinstance(node, ast.ColumnName):
            name = node.name.lower()
            if not node.table and aliases and name in aliases:
                return False
            for oc in proj_schema:
                if oc.name.lower() == name and (not node.table or oc.table.lower() == node.table.lower()):
                    return False
            return True
        return True  # complex order expr → compute as hidden column

    def _resolve_order(self, node, schema, aliases) -> Expression:
        if isinstance(node, ast.Literal) and isinstance(node.value, int):
            idx = node.value - 1  # ORDER BY ordinal
            if not (0 <= idx < len(schema)):
                raise PlanError(f"ORDER BY position {node.value} out of range")
            return ColumnRef(idx, schema[idx].ftype, schema[idx].name)
        return self.resolve(node, BuildCtx(schema, aliases=aliases))

    def _split_conj(self, e: Expression) -> list[Expression]:
        if isinstance(e, ScalarFunc) and e.sig == "and":
            return self._split_conj(e.args[0]) + self._split_conj(e.args[1])
        return [e]

    def _run_subquery(self, sel: ast.Select, expect_cols: Optional[int] = None, limit: Optional[int] = None):
        if self.subquery_runner is None:
            raise PlanError("subqueries not supported in this context")
        self.uncacheable = True  # plan bakes in subquery results as of now
        rows = self.subquery_runner(sel)
        if expect_cols is not None and rows and len(rows[0]) != expect_cols:
            raise PlanError("Operand should contain 1 column(s)")
        if limit is not None:
            rows = rows[:limit]
        return rows


def _expand_rollup(agg: "LogicalAggregation") -> "LogicalSetOp":
    """GROUP BY a, b WITH ROLLUP → UNION ALL of the grouping-set branches
    (a, b), (a), () — each a plain aggregation whose projection NULL-extends
    the rolled-up keys and emits the GROUPING() flags.

    Ref: the reference's MPP Expand executor (cophandler/mpp_exec.go:422-466)
    replicates every input row once per grouping set before a single shared
    aggregation. Redesigned for the device path: row replication multiplies
    the HBM working set by the set count, while branch aggregations re-read
    the SAME cached device lanes (the fragment/device caches key on table
    state, not plan), so each extra set costs one more tiny reduction over
    resident data instead of a full copy."""
    import copy

    from tidb_tpu_torch.planner.plans import LogicalProjection, LogicalSetOp
    from tidb_tpu_torch.types.field_type import bigint_type

    A = len(agg.aggs)
    G = len(agg.group_by)
    flag_ft = bigint_type(nullable=False)
    out_schema = list(agg.schema) + [OutCol(f"grouping#{j}", flag_ft) for j in range(G)]
    # rolled-up key columns turn nullable in the union output
    for j in range(G):
        oc = out_schema[A + j]
        if not oc.ftype.nullable:
            import dataclasses

            out_schema[A + j] = dataclasses.replace(
                oc, ftype=dataclasses.replace(oc.ftype, nullable=True)
            )
    branches = []
    for k in range(G, -1, -1):
        aggs_b = copy.deepcopy(agg.aggs)
        if k == 0:
            # the () grand-total branch is a scalar aggregation, which always
            # yields one row — MySQL semantics want one row IFF the input is
            # non-empty, and want it even with no aggregate functions at all:
            # a hidden COUNT(*) provides both (filtered below, not projected)
            aggs_b.append(AggDesc("count", None))
        b: "LogicalPlan" = LogicalAggregation(
            group_by=[copy.deepcopy(g) for g in agg.group_by[:k]],
            aggs=aggs_b,
            children=[copy.deepcopy(agg.children[0])],
        )
        b.schema = [OutCol(f"agg#{i}", a.ftype) for i, a in enumerate(aggs_b)] + [
            agg.schema[A + j] for j in range(k)
        ]
        if k == 0:
            from tidb_tpu_torch.expression.expr import func as _func
            from tidb_tpu_torch.planner.plans import LogicalSelection

            b = LogicalSelection(
                conditions=[
                    _func("gt", ColumnRef(A, bigint_type(nullable=False)), Constant(0, bigint_type(nullable=False)))
                ],
                children=[b],
            )
        exprs: list[Expression] = [
            ColumnRef(i, agg.schema[i].ftype, agg.schema[i].name) for i in range(A)
        ]
        for j in range(G):
            oc = out_schema[A + j]
            if j < k:
                exprs.append(ColumnRef(A + j, oc.ftype, oc.name))
            else:
                exprs.append(Constant(None, oc.ftype))
        for j in range(G):
            exprs.append(Constant(0 if j < k else 1, flag_ft))
        branches.append(LogicalProjection(exprs=exprs, schema=list(out_schema), children=[b]))
    # the set-op executor is binary: fold into a left-deep UNION ALL chain
    plan = branches[0]
    for nxt in branches[1:]:
        plan = LogicalSetOp(op="union", all=True, schema=out_schema, children=[plan, nxt])
    return plan


def _patch_group_refs(e: Expression, n_aggs: int, n_groups: int = 0) -> Expression:
    """Rewrite deferred group-key refs (negative indices) now that the agg
    lane count is final: ColumnRef(-1-gi) → ColumnRef(n_aggs+gi); deferred
    GROUPING flags ColumnRef(-20001-gi) → ColumnRef(n_aggs+n_groups+gi)
    (the rollup rewrite appends one flag column per group key)."""
    if isinstance(e, ColumnRef) and e.index <= -20001:
        gi = -20001 - e.index
        return ColumnRef(n_aggs + n_groups + gi, e.ftype, e.name)
    if isinstance(e, ColumnRef) and e.index < 0:
        gi = -1 - e.index
        return ColumnRef(n_aggs + gi, e.ftype, e.name)
    if isinstance(e, ScalarFunc):
        return ScalarFunc(e.sig, [_patch_group_refs(a, n_aggs, n_groups) for a in e.args], e.ftype)
    return e


# -- helpers ----------------------------------------------------------------


def _literal(node: ast.Literal) -> Constant:
    c = _literal_const(node)
    if node.param_idx >= 0:
        # keep EXECUTE-parameter provenance: the value-agnostic prepared-plan
        # cache mutates these Constants in place on later executions
        c.param_idx = node.param_idx
    return c


def _literal_const(node: ast.Literal) -> Constant:
    v = node.value
    if node.hint == "date":
        return Constant(date_to_days(v), FieldType(TypeKind.DATE, nullable=False))
    if node.hint in ("timestamp", "time"):
        return Constant(datetime_to_micros(v), FieldType(TypeKind.DATETIME, nullable=False))
    if node.hint == "decimal":
        d = Decimal(v)
        exp = d.as_tuple().exponent
        scale = -exp if exp < 0 else 0
        return Constant(d, decimal_type(max(len(d.as_tuple().digits), scale + 1), scale, nullable=False))
    if v is None:
        return Constant(None, FieldType(TypeKind.NULLTYPE))
    if isinstance(v, bool):
        return Constant(int(v), bool_type().not_null())
    if isinstance(v, int):
        return Constant(v, bigint_type(nullable=False))
    if isinstance(v, float):
        return Constant(v, double_type(nullable=False))
    import datetime

    if isinstance(v, datetime.timedelta):
        from tidb_tpu_torch.types.datum import duration_to_micros

        return Constant(duration_to_micros(v), FieldType(TypeKind.DURATION, nullable=False))
    if isinstance(v, datetime.datetime):
        return Constant(datetime_to_micros(v), FieldType(TypeKind.DATETIME, nullable=False))
    if isinstance(v, datetime.date):
        return Constant(date_to_days(v), FieldType(TypeKind.DATE, nullable=False))
    return Constant(v, string_type(nullable=False))


def _const_like(v) -> Constant:
    if v is None:
        return Constant(None, FieldType(TypeKind.NULLTYPE))
    if isinstance(v, bool):
        return Constant(int(v), bool_type().not_null())
    if isinstance(v, int):
        return Constant(v, bigint_type(nullable=False))
    if isinstance(v, float):
        return Constant(v, double_type(nullable=False))
    if isinstance(v, Decimal):
        exp = -v.as_tuple().exponent
        return Constant(v, decimal_type(38, max(exp, 0), nullable=False))
    import datetime

    if isinstance(v, datetime.datetime):
        return Constant(datetime_to_micros(v), FieldType(TypeKind.DATETIME, nullable=False))
    if isinstance(v, datetime.date):
        return Constant(date_to_days(v), FieldType(TypeKind.DATE, nullable=False))
    if isinstance(v, datetime.timedelta):
        from tidb_tpu_torch.types.datum import duration_to_micros

        return Constant(duration_to_micros(v), FieldType(TypeKind.DURATION, nullable=False))
    return Constant(v, string_type(nullable=False))


def _contains_group_expr(node, group_asts) -> bool:
    """Does the expression contain a subtree matching a GROUP BY item?
    (bare column names excluded — the projection path already handles them)"""
    if not group_asts:
        return False
    if not isinstance(node, ast.ColumnName) and any(_ast_eq(node, g) for g in group_asts):
        return True
    if isinstance(node, ast.FuncCall):
        return any(_contains_group_expr(a, group_asts) for a in node.args)
    for attr in ("left", "right", "operand", "low", "high", "else_value"):
        v = getattr(node, attr, None)
        if v is not None and isinstance(v, ast.Node) and _contains_group_expr(v, group_asts):
            return True
    if isinstance(node, ast.CaseWhen):
        return any(
            _contains_group_expr(c, group_asts) or _contains_group_expr(v, group_asts)
            for c, v in node.branches
        )
    return False


def _contains_agg(node) -> bool:
    if isinstance(node, ast.FuncCall):
        name = _FN_ALIAS.get(node.name, node.name)
        # GROUPING() resolves against the agg output like an aggregate
        if node.over is None and (name in AGG_FUNCS or node.star or name == "grouping"):
            return True
        return any(_contains_agg(a) for a in node.args)
    for attr in ("left", "right", "operand", "low", "high", "pattern", "else_value"):
        v = getattr(node, attr, None)
        if v is not None and isinstance(v, ast.Node) and _contains_agg(v):
            return True
    if isinstance(node, ast.CaseWhen):
        return any(_contains_agg(c) or _contains_agg(v) for c, v in node.branches)
    if isinstance(node, ast.InList):
        return any(_contains_agg(x) for x in node.items)
    return False


def _agg_names(node, out: set) -> None:
    """Collect the (alias-normalized) aggregate function names under
    ``node`` — the decorrelation guard needs to know WHICH aggregates an
    ungrouped subquery computes, not just that one exists."""
    if isinstance(node, ast.FuncCall):
        name = _FN_ALIAS.get(node.name, node.name)
        if node.over is None and (name in AGG_FUNCS or node.star):
            out.add("count" if node.star else name)
        for a in node.args:
            _agg_names(a, out)
        return
    for attr in ("left", "right", "operand", "low", "high", "pattern", "else_value"):
        v = getattr(node, attr, None)
        if v is not None and isinstance(v, ast.Node):
            _agg_names(v, out)
    if isinstance(node, ast.CaseWhen):
        for c, v in node.branches:
            _agg_names(c, out)
            _agg_names(v, out)
    if isinstance(node, ast.InList):
        for x in node.items:
            _agg_names(x, out)


def _unknown_col_in_schema(err_msg: str, schema) -> bool:
    """Does the column named in an 'Unknown column' PlanError exist in
    ``schema``? (used to distinguish correlation from typos)"""
    name = err_msg.split("'")[1] if "'" in err_msg else ""
    col = name.split(".")[-1].lower()
    tbl = name.split(".")[0].lower() if "." in name else ""
    return any(
        oc.name.lower() == col and (not tbl or oc.table.lower() == tbl) for oc in schema
    )


def _quantified_to_exists(q: "ast.QuantifiedCmp") -> ast.Node:
    """WHERE-context lowering of `left OP ANY|ALL (S)` (ref:
    expression_rewriter.go):

    - OP ANY (S)  ⇔  EXISTS (SELECT 1 FROM (S) q WHERE left OP q.v)
    - OP ALL (S)  ⇔  NOT EXISTS (SELECT 1 FROM (S) q WHERE
                       NOT(left OP q.v) OR (left OP q.v) IS NULL)

    Exact in WHERE context: ANY is TRUE iff some comparison is TRUE; ALL is
    not-TRUE iff some comparison is FALSE or NULL (vacuously TRUE on empty).
    Value contexts need the NULL-distinguishing form instead (_resolve)."""
    import copy as _copy

    sel = _copy.deepcopy(q.select)
    sel.items[0].alias = "__qv"
    src = ast.SubquerySource(sel, alias="__qsub")
    cmp = ast.BinaryOp(q.op, q.left, ast.ColumnName("__qv", table="__qsub"))
    if q.is_all:
        cond: ast.Node = ast.BinaryOp("or", ast.UnaryOp("not", cmp), ast.IsNull(cmp))
        inner = ast.Select([ast.SelectItem(ast.Literal(1))], from_=src, where=cond)
        return ast.UnaryOp("not", ast.SubqueryExpr(inner, "exists"))
    inner = ast.Select([ast.SelectItem(ast.Literal(1))], from_=src, where=cmp)
    return ast.SubqueryExpr(inner, "exists")


def _scalar_subquery_nodes(node) -> list:
    """All bare scalar SubqueryExpr nodes (modifier '') in an expression,
    excluding those nested inside deeper selects (their own build handles
    them)."""
    out = []
    if isinstance(node, ast.SubqueryExpr):
        if node.modifier == "":
            out.append(node)
        return out  # don't descend into the subquery body
    if isinstance(node, ast.Select):
        return out
    if isinstance(node, (list, tuple)):
        for x in node:
            out.extend(_scalar_subquery_nodes(x))
        return out
    if hasattr(node, "__dataclass_fields__"):
        for f in node.__dataclass_fields__:
            out.extend(_scalar_subquery_nodes(getattr(node, f)))
    return out


def _column_nodes(node) -> list:
    """All ast.ColumnName nodes inside an expression tree (dataclass walk)."""
    out = []
    if isinstance(node, ast.ColumnName):
        out.append(node)
        return out
    if isinstance(node, (list, tuple)):
        for x in node:
            out.extend(_column_nodes(x))
        return out
    if hasattr(node, "__dataclass_fields__"):
        for f in node.__dataclass_fields__:
            out.extend(_column_nodes(getattr(node, f)))
    return out


def _resolves(probe: "Builder", node, schema) -> bool:
    try:
        probe.resolve(node, BuildCtx(schema))
        return True
    except PlanError:
        return False


def _split_ast_conj(node: ast.Node) -> list:
    if isinstance(node, ast.BinaryOp) and node.op == "and":
        return _split_ast_conj(node.left) + _split_ast_conj(node.right)
    return [node]


def _memtable_hints(where) -> list:
    """Extract ``(column_lower, op, literal)`` triples from the simple
    col-vs-literal conjuncts of a WHERE — the memtable pushdown hints.
    Strictly advisory: the full WHERE still evaluates as a LogicalSelection
    above the source, so dropping a conjunct here never changes results —
    only how many rows a cluster sweep ships."""
    if where is None:
        return []
    flip = {"lt": "gt", "le": "ge", "gt": "lt", "ge": "le", "eq": "eq", "ne": "ne"}
    out = []
    for cj in _split_ast_conj(where):
        if not isinstance(cj, ast.BinaryOp) or cj.op not in flip:
            continue
        le, ri = cj.left, cj.right
        if isinstance(le, ast.ColumnName) and isinstance(ri, ast.Literal):
            out.append((le.name.lower(), cj.op, ri.value))
        elif isinstance(ri, ast.ColumnName) and isinstance(le, ast.Literal):
            out.append((ri.name.lower(), flip[cj.op], le.value))
    return out


def _and_join_ast(conds: list):
    if not conds:
        return None
    e = conds[0]
    for c in conds[1:]:
        e = ast.BinaryOp("and", e, c)
    return e


def _collect_windows(node, out: list) -> None:
    """Collect FuncCall nodes with an OVER clause, outermost first."""
    if not isinstance(node, ast.Node):
        return
    if isinstance(node, ast.FuncCall):
        if node.over is not None:
            out.append(node)
        for a in node.args:
            _collect_windows(a, out)
        return
    for attr in ("left", "right", "operand", "low", "high", "pattern", "else_value", "expr"):
        v = getattr(node, attr, None)
        if isinstance(v, ast.Node):
            _collect_windows(v, out)
    if isinstance(node, ast.CaseWhen):
        for c, v in node.branches:
            _collect_windows(c, out)
            _collect_windows(v, out)
    if isinstance(node, ast.InList):
        for x in node.items:
            _collect_windows(x, out)


# window functions beyond the aggregate set (ref: ast.WindowFuncs)
PURE_WINDOW_FUNCS = {
    "row_number",
    "rank",
    "dense_rank",
    "percent_rank",
    "cume_dist",
    "ntile",
    "lead",
    "lag",
    "first_value",
    "last_value",
}


def _window_ftype(name: str, args: list, win_order: list) -> FieldType:
    if name in ("row_number", "rank", "dense_rank", "ntile"):
        return bigint_type(nullable=False)
    if name in ("percent_rank", "cume_dist"):
        return replace(double_type(), nullable=False)
    if name in ("lead", "lag", "first_value", "last_value"):
        if not args:
            raise PlanError(f"{name}() needs an argument")
        return replace(args[0].ftype, nullable=True)
    if name == "count":
        return bigint_type(nullable=False)
    if name in ("sum", "avg", "min", "max"):
        return AggDesc(name, args[0]).ftype
    raise PlanError(f"unsupported window function {name}()")


def _ast_eq(a, b) -> bool:
    return type(a) is type(b) and a == b


def _display_name(node) -> str:
    if isinstance(node, ast.ColumnName):
        return node.name
    if isinstance(node, ast.FuncCall):
        inner = "*" if node.star else ", ".join(_display_name(a) for a in node.args)
        return f"{node.name}({inner})"
    if isinstance(node, ast.Literal):
        return str(node.value)
    if isinstance(node, ast.BinaryOp):
        return f"{_display_name(node.left)} {node.op} {_display_name(node.right)}"
    return type(node).__name__.lower()


def _source_outcol(e: Expression, schema) -> Optional[OutCol]:
    if isinstance(e, ColumnRef) and e.index < len(schema):
        return schema[e.index]
    return None


def _as_equi_pair(cond: Expression, nleft: int):
    if isinstance(cond, ScalarFunc) and cond.sig == "eq":
        a, b = cond.args
        if isinstance(a, ColumnRef) and isinstance(b, ColumnRef):
            if a.index < nleft <= b.index:
                return (a.index, b.index - nleft)
            if b.index < nleft <= a.index:
                return (b.index, a.index - nleft)
    return None


def _fold(e: Expression, warn=None) -> Expression:
    """Constant folding: all-constant scalar funcs evaluate at build time.
    ``warn`` receives fold-time diagnostics (SELECT 1/0 → 1365) so constant
    expressions warn like row expressions do."""
    if isinstance(e, ScalarFunc):
        e = ScalarFunc(e.sig, [_fold(a, warn) for a in e.args], e.ftype)
        if e.sig != "like" and all(isinstance(a, Constant) for a in e.args):
            batch = EvalBatch([], [], 1, warn)
            try:
                col = eval_to_column(e, batch, np)
            except Exception:
                return e
            return Constant(col.logical_value(0), e.ftype)
    return e
