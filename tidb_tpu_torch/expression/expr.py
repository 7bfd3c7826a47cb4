"""Expression tree + evaluator (port of tidb_tpu/expression/expr.py).

``eval_expr`` walks the tree over an ``EvalBatch`` of (data, validity)
pairs. On the device path those are torch tensors on the caller's device;
the binder's exact corner evaluation passes numpy object arrays. Wire form
(``to_pb`` / ``expr_from_pb``) is the reference's, byte for byte.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from decimal import Decimal
from typing import Any, Optional

import tidb_tpu_torch.expression.eval  # noqa: F401  (populates REGISTRY)
from tidb_tpu_torch.expression.registry import REGISTRY
from tidb_tpu_torch.types import Datum, FieldType, TypeKind
from tidb_tpu_torch.types.field_type import bigint_type, decimal_type, double_type
from tidb_tpu_torch.utils.chunk import Dictionary


class Expression:
    ftype: FieldType

    def to_pb(self) -> dict:
        raise NotImplementedError


@dataclass
class ColumnRef(Expression):
    """Offset into the input schema of the operator evaluating this expr."""

    index: int
    ftype: FieldType

    def to_pb(self) -> dict:
        return {"tp": "col", "idx": self.index, "ft": _ft_pb(self.ftype)}


@dataclass
class Constant(Expression):
    value: Any  # logical python value; None == NULL
    ftype: FieldType

    def to_pb(self) -> dict:
        v = self.value
        if isinstance(v, bytes):
            v = v.decode("utf-8", "surrogateescape")
        elif hasattr(v, "isoformat"):
            v = v.isoformat()
        if isinstance(v, Decimal):
            v = str(v)
        return {"tp": "const", "val": v, "ft": _ft_pb(self.ftype)}


@dataclass
class ScalarFunc(Expression):
    sig: str
    args: list[Expression]
    ftype: FieldType

    def to_pb(self) -> dict:
        return {"tp": "func", "sig": self.sig, "children": [a.to_pb() for a in self.args], "ft": _ft_pb(self.ftype)}


def _ft_pb(ft: FieldType) -> list:
    return [int(ft.kind), ft.length, ft.scale, int(ft.nullable), ft.collation, int(ft.json)]


def _ft_from_pb(v: list) -> FieldType:
    return FieldType(
        TypeKind(v[0]),
        length=v[1],
        scale=v[2],
        nullable=bool(v[3]),
        collation=v[4],
        json=bool(v[5]) if len(v) > 5 else False,
    )


def expr_from_pb(pb: dict) -> Expression:
    tp = pb["tp"]
    if tp == "col":
        return ColumnRef(pb["idx"], _ft_from_pb(pb["ft"]))
    if tp == "const":
        ft = _ft_from_pb(pb["ft"])
        v = pb["val"]
        if isinstance(v, str) and ft.kind == TypeKind.STRING:
            v = v.encode("utf-8", "surrogateescape")
        return Constant(v, ft)
    if tp == "func":
        return ScalarFunc(pb["sig"], [expr_from_pb(c) for c in pb["children"]], _ft_from_pb(pb["ft"]))
    raise ValueError(f"bad expr pb {pb!r}")


@dataclass
class EvalBatch:
    """Input columns for one operator: parallel (data, validity) pairs.
    validity None = all valid; ``dicts[i]`` is set for string columns."""

    cols: list[tuple]
    dicts: list[Optional[Dictionary]]
    n: int
    warn: Optional[object] = None


class _Ctx:
    __slots__ = ("args", "arg_types", "arg_dicts", "ret_type", "ret_dict", "n", "warn")

    def __init__(self, args, arg_types, arg_dicts, ret_type, ret_dict, n, warn=None):
        self.args = args
        self.arg_types = arg_types
        self.arg_dicts = arg_dicts
        self.ret_type = ret_type
        self.ret_dict = ret_dict
        self.n = n
        self.warn = warn


def _const_physical(c: Constant, xp):
    """Lower a constant to its device scalar. Strings yield raw bytes — the
    binder maps them onto a dictionary."""
    if c.value is None:
        return 0, False
    if c.ftype.kind == TypeKind.STRING:
        v = c.value
        if isinstance(v, str):
            v = v.encode("utf-8")
        return v, None
    return Datum(c.value, c.ftype).physical(), None


def eval_expr(expr: Expression, batch: EvalBatch, xp=None):
    """→ (data, validity, dictionary|None)."""
    if isinstance(expr, ColumnRef):
        d, v = batch.cols[expr.index]
        return d, v, batch.dicts[expr.index]
    if isinstance(expr, Constant):
        pv, valid = _const_physical(expr, xp)
        if isinstance(pv, bytes):
            dic = Dictionary()
            return dic.encode(pv), valid, dic
        return pv, valid, None
    if isinstance(expr, ScalarFunc):
        spec = REGISTRY.get(expr.sig)
        if spec is None:
            raise NotImplementedError(f"builtin {expr.sig} is not ported")
        args = []
        dicts = []
        for a in expr.args:
            d, v, dic = eval_expr(a, batch, xp)
            args.append((d, v))
            dicts.append(dic)
        ret_dict = Dictionary() if expr.ftype.kind == TypeKind.STRING else None
        ctx = _Ctx(args, [a.ftype for a in expr.args], dicts, expr.ftype, ret_dict, batch.n, batch.warn)
        d, v = spec.impl(xp, args, ctx)
        return d, v, ret_dict
    raise TypeError(f"cannot evaluate {expr!r}")


# aggregates (descriptors; execution lives in ops/dag_kernel.py)
VAR_AGGS = {"stddev_pop", "stddev_samp", "var_pop", "var_samp"}
BIT_AGGS = {"bit_and", "bit_or", "bit_xor"}


@dataclass
class AggDesc:
    """ref: pkg/expression/aggregation.AggFuncDesc. ``partial_kinds`` names
    the state lanes the partial stage produces."""

    name: str
    arg: Optional[Expression]  # None for COUNT(*)
    distinct: bool = False
    sep: str = ","
    order_by: list = field(default_factory=list)

    @property
    def ftype(self) -> FieldType:
        if self.name == "count":
            return bigint_type(nullable=False)
        if self.name == "group_concat":
            from tidb_tpu_torch.types import string_type

            return string_type()
        at = self.arg.ftype
        if self.name == "sum":
            if at.kind == TypeKind.DECIMAL:
                return decimal_type(38, at.scale)
            if at.kind == TypeKind.FLOAT:
                return double_type()
            return bigint_type()
        if self.name == "avg":
            if at.kind == TypeKind.DECIMAL:
                return decimal_type(38, min(at.scale + 4, 30))
            return double_type()
        if self.name in VAR_AGGS:
            return double_type()
        if self.name in BIT_AGGS:
            return FieldType(TypeKind.UINT, nullable=False)
        return at  # min/max/first_row

    @property
    def partial_kinds(self) -> list[str]:
        if self.name == "count":
            return ["count"]
        if self.name == "sum":
            return ["sum"]
        if self.name == "avg":
            return ["count", "sum"]
        if self.name in ("min", "max", "first_row"):
            return [self.name]
        if self.name in VAR_AGGS:
            return ["count", "sum", "sumsq"]
        if self.name in BIT_AGGS:
            return [self.name]
        if self.name == "group_concat":
            return ["group_concat"]
        raise ValueError(self.name)

    def to_pb(self) -> dict:
        return {
            "name": self.name,
            "arg": self.arg.to_pb() if self.arg is not None else None,
            "distinct": self.distinct,
            "sep": self.sep,
            "order_by": [(e.to_pb(), d) for e, d in self.order_by],
        }

    @staticmethod
    def from_pb(pb: dict) -> "AggDesc":
        return AggDesc(
            pb["name"],
            expr_from_pb(pb["arg"]) if pb["arg"] is not None else None,
            pb["distinct"],
            pb.get("sep", ","),
            order_by=[(expr_from_pb(e), d) for e, d in pb.get("order_by", [])],
        )
