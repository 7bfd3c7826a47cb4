"""Planner.

Reference parity: pkg/planner (~101k LoC) collapsed to the load-bearing
spine: AST → logical plan (builder.py, ref core/logical_plan_builder.go),
rule-based optimization in the reference's rule order — column pruning,
predicate pushdown, aggregation/topN/limit pushdown (optimizer.py, ref
core/optimizer.go:84 rule list) — then physical planning where the
engine-isolation hook decides which store executes the pushed fragment
(ref core/planbuilder.go:1357 filterPathByIsolationRead).
"""

from tidb_tpu_torch.planner.plans import PlanError
from tidb_tpu_torch.planner.optimizer import optimize

__all__ = ["optimize", "PlanError"]
