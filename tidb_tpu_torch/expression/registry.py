"""Builtin function registry: implementation + type inference + engine support.

Reference parity: the builtin tables in pkg/expression (funcs map) and the
per-engine legality switches (infer_pushdown.go:160 scalarExprSupportedByTiKV,
:266 scalarExprSupportedByFlash). An entry declares which engines may execute
it; the planner refuses to push a fragment containing an unsupported builtin
to that engine (expression.can_push_down).

Implementations receive ``(xp, args, ctx)``:
- ``xp``: numpy or jax.numpy — the ONLY difference between host and TPU
  execution of a scalar builtin;
- ``args``: list of (data, validity) pairs, validity=None meaning all-valid;
- ``ctx``: EvalContext (row count, scale info, string dictionaries host-side).

Returns (data, validity) with MySQL NULL semantics (validity=None allowed).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Optional

from tidb_tpu_torch.types import FieldType, TypeKind
from tidb_tpu_torch.types.field_type import bool_type, double_type, merge_types

ALL_ENGINES = frozenset({"host", "gpu"})
HOST_ONLY = frozenset({"host"})


@dataclass
class FuncSpec:
    name: str
    impl: Callable  # (xp, args, ctx) -> (data, validity)
    infer: Callable  # (arg_ftypes) -> FieldType
    engines: frozenset = ALL_ENGINES
    # TPU support may be conditional (e.g. string compares need sorted dicts);
    # checked at DAG-bind time, not plan time
    variadic: bool = False
    arity: int = 2


REGISTRY: dict[str, FuncSpec] = {}


def register(name: str, infer, engines=ALL_ENGINES, variadic=False, arity=2):
    def deco(fn):
        REGISTRY[name] = FuncSpec(name, fn, infer, engines, variadic, arity)
        return fn

    return deco


# -- validity helpers -------------------------------------------------------


def and_valid(xp, *vs):
    """Combine validity masks (None = all valid)."""
    out = None
    for v in vs:
        if v is None:
            continue
        out = v if out is None else (out & v)
    return out


# -- type inference helpers -------------------------------------------------


def infer_bool(args):
    return bool_type()


def infer_double(args):
    return double_type()


def infer_first(args):
    return args[0]


def infer_merge(args):
    t = args[0]
    for a in args[1:]:
        t = merge_types(t, a)
    return t
