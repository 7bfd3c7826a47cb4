"""Expression layer.

Reference parity: pkg/expression (~84k LoC). Collapsed to its essentials:
- an expression tree (ColumnRef / Constant / ScalarFunc) with MySQL-ish type
  inference (expr.py);
- ONE evaluation path — vectorized, mask-carried three-valued logic — written
  against an array-namespace parameter so the same builtin code runs under
  numpy (host engine) and jax.numpy (TPU engine, jit-traced) (eval.py; ref:
  VecExpr expression.go:117, builtin_*_vec.go);
- per-engine pushdown legality derived from the builtin registry (ref:
  infer_pushdown.go:85 canScalarFuncPushDown / :266 scalarExprSupportedByFlash);
- aggregate descriptors with partial/final decomposition for two-phase
  aggregation (aggregation.py; ref: pkg/expression/aggregation).
"""

from tidb_tpu_torch.expression.expr import (
    AggDesc,
    ColumnRef,
    Constant,
    Expression,
    ScalarFunc,
    can_push_down,
    col,
    const,
    func,
)
from tidb_tpu_torch.expression.registry import REGISTRY, FuncSpec

__all__ = [
    "AggDesc",
    "ColumnRef",
    "Constant",
    "Expression",
    "ScalarFunc",
    "REGISTRY",
    "FuncSpec",
    "can_push_down",
    "col",
    "const",
    "func",
]
