"""Common table expressions: WITH inlining + WITH RECURSIVE fixpoint.

Reference parity: pkg/planner/core/logical_plan_builder.go (buildWith /
buildCte / buildRecursiveCTE) and the CTEExec iterate-until-empty executor
(pkg/executor/cte.go). Redesigned for this planner:

- Non-recursive CTEs are *inlined* at each reference site as a derived table
  (the reference does this too under tidb_opt_force_inline_cte; our engine
  caches pushed fragments per table so repeated inline scans stay cheap).
- Recursive CTEs are materialized bottom-up before planning: the seed part
  runs once, then each recursive part re-runs with the CTE reference bound to
  the previous iteration's delta rows until no new rows appear (semi-naive
  evaluation, exactly CTEExec's computeRecursivePart loop). The final rowset
  lands in the plan as an in-memory values source.

Expansion is a pure AST→AST rewrite, so CTE references work anywhere a table
can appear (joins, subqueries, set operations, nested WITH with shadowing).
"""

from __future__ import annotations

import copy
import dataclasses
from typing import Callable

from tidb_tpu_torch.parser import ast
from tidb_tpu_torch.planner.plans import PlanError

# hard stop for runaway recursion (MySQL cte_max_recursion_depth default)
MAX_RECURSION_DEPTH = 1000

# runner(select_ast) -> (rows, schema: list[OutCol])
Runner = Callable[[ast.Node], tuple]


def expand_ctes(stmt: ast.Node, runner: Runner) -> ast.Node:
    """Rewrite every WITH clause in ``stmt`` away. Idempotent."""
    _expand(stmt, runner)
    return stmt


def _expand(node: ast.Node, runner: Runner) -> None:
    if isinstance(node, (ast.Select, ast.SetOp)) and node.ctes:
        ctes, node.ctes = node.ctes, []
        names_seen = set()
        for cte in ctes:
            if cte.name.lower() in names_seen:
                raise PlanError(f"Duplicate query name '{cte.name}' in WITH clause")
            names_seen.add(cte.name.lower())
        bindings: list[tuple[str, tuple]] = []
        for cte in ctes:
            # earlier CTEs in the same WITH list are visible to later bodies
            for bname, b in bindings:
                _substitute(cte.query, bname, b)
            if cte.recursive and _references(cte.query, cte.name):
                binding = _materialize_recursive(cte, runner)
            else:
                if _references(cte.query, cte.name):
                    raise PlanError(
                        f"Table '{cte.name}' doesn't exist (self-reference requires WITH RECURSIVE)"
                    )
                binding = ("inline", cte.query, cte.columns)
            bindings.append((cte.name, binding))
        for bname, b in bindings:
            _substitute(node, bname, b)
    for child in _ast_children(node):
        _expand(child, runner)


# ---------------------------------------------------------------------------
# generic AST walking (all nodes are dataclasses)
# ---------------------------------------------------------------------------


def _ast_children(node: ast.Node):
    if not dataclasses.is_dataclass(node):
        return
    for f in dataclasses.fields(node):
        v = getattr(node, f.name)
        if isinstance(v, ast.Node):
            yield v
        elif isinstance(v, list):
            for item in v:
                if isinstance(item, ast.Node):
                    yield item
                elif isinstance(item, tuple):
                    for x in item:
                        if isinstance(x, ast.Node):
                            yield x


def _map_node(node: ast.Node, fn) -> ast.Node:
    """Replace each child c with fn(c), in place; returns fn(node)'s result
    for the node itself is handled by callers."""
    for f in dataclasses.fields(node):
        v = getattr(node, f.name)
        if isinstance(v, ast.Node):
            setattr(node, f.name, fn(v))
        elif isinstance(v, list):
            for i, item in enumerate(v):
                if isinstance(item, ast.Node):
                    v[i] = fn(item)
                elif isinstance(item, tuple):
                    v[i] = tuple(fn(x) if isinstance(x, ast.Node) else x for x in item)
    return node


def _shadows(node: ast.Node, name: str) -> bool:
    return isinstance(node, (ast.Select, ast.SetOp)) and any(
        c.name == name for c in node.ctes
    )


def _substitute(root: ast.Node, name: str, binding: tuple) -> None:
    """Replace every unqualified TableRef ``name`` in table-source position
    with the binding (inline derived table or materialized values). Nested
    query blocks that define their own CTE of the same name shadow it."""

    def visit(n: ast.Node) -> ast.Node:
        if isinstance(n, ast.TableRef) and not n.db and n.name.lower() == name:
            return _make_source(binding, n)
        if _shadows(n, name):
            return n
        return _map_node(n, visit)

    _map_node(root, visit)


def _make_source(binding: tuple, ref: ast.TableRef) -> ast.Node:
    alias = ref.alias or ref.name
    if binding[0] == "inline":
        _, body, cols = binding
        return ast.SubquerySource(copy.deepcopy(body), alias=alias, col_aliases=list(cols))
    _, rows, names, ftypes = binding
    return ast.ValuesSource(rows=rows, names=names, ftypes=ftypes, alias=alias)


def _reference_count(root: ast.Node, name: str) -> int:
    count = 0

    def visit(n: ast.Node) -> ast.Node:
        nonlocal count
        if isinstance(n, ast.TableRef) and not n.db and n.name.lower() == name:
            count += 1
            return n
        if _shadows(n, name):
            return n
        return _map_node(n, visit)

    _map_node(root, visit)
    return count


def _references(root: ast.Node, name: str) -> bool:
    return _reference_count(root, name) > 0


# ---------------------------------------------------------------------------
# recursive CTE: semi-naive fixpoint (ref: executor/cte.go computeSeedPart /
# computeRecursivePart)
# ---------------------------------------------------------------------------


def _flatten_union(node: ast.Node) -> tuple[list[ast.Node], bool]:
    """Flatten a top-level UNION chain into operands. Returns (operands,
    distinct) where distinct is True if any link is UNION DISTINCT."""
    if isinstance(node, ast.SetOp):
        if node.op != "union":
            raise PlanError(
                "recursive CTE body must be a UNION of a seed part and a recursive part"
            )
        if node.order_by or node.limit is not None:
            raise PlanError("ORDER BY/LIMIT over a recursive CTE body is not supported")
        lops, ldist = _flatten_union(node.left)
        rops, rdist = _flatten_union(node.right)
        return lops + rops, ldist or rdist or not node.all
    return [node], False


def _union_all(operands: list[ast.Node]) -> ast.Node:
    node = operands[0]
    for op in operands[1:]:
        node = ast.SetOp(node, op, "union", all=True)
    return node


def _materialize_recursive(cte: ast.CTEDef, runner: Runner) -> tuple:
    operands, distinct = _flatten_union(cte.query)
    seed_ops = [op for op in operands if not _references(op, cte.name)]
    rec_ops = [op for op in operands if _references(op, cte.name)]
    if not seed_ops:
        raise PlanError(f"recursive CTE '{cte.name}' needs a non-recursive seed part")
    for op in rec_ops:
        if not isinstance(op, ast.Select):
            raise PlanError("recursive part of a recursive CTE must be a plain SELECT")
        if op.group_by or op.distinct or op.order_by or op.limit is not None:
            raise PlanError(
                f"Recursive Common Table Expression '{cte.name}' can contain neither "
                "aggregation nor ORDER BY/LIMIT/DISTINCT in its recursive part"
            )
        if _reference_count(op, cte.name) > 1:
            # semi-naive delta substitution is wrong for self-joins; MySQL
            # rejects multiple references in the recursive member too
            raise PlanError(
                f"In recursive query block of Recursive Common Table Expression "
                f"'{cte.name}', the recursive table must be referenced only once"
            )

    rows, schema = runner(_union_all([copy.deepcopy(op) for op in seed_ops]))
    names = cte.columns or [oc.name for oc in schema]
    if len(names) != len(schema):
        raise PlanError(
            f"WITH column list of '{cte.name}' has {len(names)} names for {len(schema)} columns"
        )
    ftypes = [oc.ftype for oc in schema]

    seen: set = set()
    if distinct:
        deduped = []
        for r in rows:
            if r not in seen:
                seen.add(r)
                deduped.append(r)
        rows = deduped
    all_rows = list(rows)
    delta = rows
    iters = 0
    while delta and rec_ops:
        iters += 1
        if iters > MAX_RECURSION_DEPTH:
            raise PlanError(
                f"Recursive query aborted after {MAX_RECURSION_DEPTH} iterations "
                "(cte_max_recursion_depth)"
            )
        produced: list[tuple] = []
        for op in rec_ops:
            op2 = copy.deepcopy(op)
            _substitute(op2, cte.name, ("values", delta, names, ftypes))
            # the recursive operand may still be correlated/nested — one plain
            # query per iteration with the previous delta as a memsource
            r, rschema = runner(op2)
            if len(rschema) != len(names):
                raise PlanError(
                    f"The recursive part of CTE '{cte.name}' returns "
                    f"{len(rschema)} columns, expected {len(names)}"
                )
            produced.extend(r)
        if distinct:
            fresh = []
            for r in produced:
                if r not in seen:
                    seen.add(r)
                    fresh.append(r)
        else:
            fresh = produced
        all_rows.extend(fresh)
        delta = fresh
    return ("values", all_rows, names, ftypes)
