"""Vectorized builtins (port of the tidb_tpu/expression/eval.py subset the
first slice's DAGs use: ``plus``/``minus``/``mul`` and ``lt``/``le``/``ge``).

Mask-carried three-valued logic: args and results are (data, validity),
validity None meaning all valid. Decimal lanes are int64 scaled by 10**scale
and rescale exactly as the reference does (``_coerce_pair``).
"""

from __future__ import annotations

import bisect

import numpy as np

from tidb_tpu_torch.expression.registry import and_valid, infer_bool, infer_merge, register
from tidb_tpu_torch.types import TypeKind
from tidb_tpu_torch.types.field_type import decimal_type


def _as_i64(res):
    """Boolean compare result → int64 lane (torch, numpy or Python)."""
    if hasattr(res, "to"):
        import torch

        return res.to(torch.int64)
    if hasattr(res, "astype"):
        return res.astype(np.int64)
    return int(res)


def _coerce_pair(xp, ctx, i, j):
    """Bring args i and j to a common physical representation per their
    logical types (decimal rescale, int→float)."""
    (da, va), (db, vb) = ctx.args[i], ctx.args[j]
    ta, tb = ctx.arg_types[i], ctx.arg_types[j]
    if ta.kind == TypeKind.DECIMAL or tb.kind == TypeKind.DECIMAL:
        if ta.kind == TypeKind.FLOAT or tb.kind == TypeKind.FLOAT:
            da = da / (10**ta.scale) if ta.kind == TypeKind.DECIMAL else da * 1.0
            db = db / (10**tb.scale) if tb.kind == TypeKind.DECIMAL else db * 1.0
        else:
            sa = ta.scale if ta.kind == TypeKind.DECIMAL else 0
            sb = tb.scale if tb.kind == TypeKind.DECIMAL else 0
            s = max(sa, sb)
            da = da * (10 ** (s - sa))
            db = db * (10 ** (s - sb))
    elif ta.kind == TypeKind.FLOAT or tb.kind == TypeKind.FLOAT:
        da = da * 1.0
        db = db * 1.0
    return da, va, db, vb


@register("plus", infer_merge)
def _plus(xp, args, ctx):
    da, va, db, vb = _coerce_pair(xp, ctx, 0, 1)
    return da + db, and_valid(xp, va, vb)


@register("minus", infer_merge)
def _minus(xp, args, ctx):
    da, va, db, vb = _coerce_pair(xp, ctx, 0, 1)
    return da - db, and_valid(xp, va, vb)


def infer_mul(args):
    a, b = args[0], args[1]
    if a.kind == TypeKind.DECIMAL and b.kind == TypeKind.DECIMAL:
        return decimal_type(min(a.length + b.length, 65), a.scale + b.scale)
    return infer_merge(args)


@register("mul", infer_mul)
def _mul(xp, args, ctx):
    (da, va), (db, vb) = args
    ta, tb = ctx.arg_types
    if ta.kind == TypeKind.DECIMAL and tb.kind == TypeKind.DECIMAL:
        # scales add; ret_type carries s1+s2 — raw int multiply is exact
        return da * db, and_valid(xp, va, vb)
    da, va, db, vb = _coerce_pair(xp, ctx, 0, 1)
    return da * db, and_valid(xp, va, vb)


def _cmp(xp, ctx, op, sig):
    ta, tb = ctx.arg_types[0], ctx.arg_types[1]
    if ta.kind == TypeKind.STRING or tb.kind == TypeKind.STRING:
        # the binder rewrites device string compares into code/rank compares
        # on INT lanes; only a dictionary-backed col-vs-const shape is left
        fast = _cmp_const_fast(xp, ctx, sig)
        if fast is None:
            raise NotImplementedError("string comparison without an order-preserving dictionary")
        return fast
    da, va, db, vb = _coerce_pair(xp, ctx, 0, 1)
    return _as_i64(op(da, db)), and_valid(xp, va, vb)


def _cmp_const_fast(xp, ctx, sig):
    """String col vs string constant → code/rank comparison against the
    column's sorted dictionary. None when the shape doesn't fit."""
    for ci, ki in ((0, 1), (1, 0)):
        dcol, vcol = ctx.args[ci]
        dconst, vconst = ctx.args[ki]
        if getattr(dcol, "ndim", 0) != 1 or getattr(dconst, "ndim", 0) == 1:
            continue
        col_dict, const_dict = ctx.arg_dicts[ci], ctx.arg_dicts[ki]
        if col_dict is None or const_dict is None or ctx.arg_types[ci].kind != TypeKind.STRING:
            return None
        if not col_dict.sorted:
            return None  # ordering needs order-preserving codes
        val = const_dict.decode(int(dconst))
        # flip the operator when the constant is on the left
        s = sig if ci == 0 else {"lt": "gt", "le": "ge", "ge": "le"}[sig]
        vals = col_dict.values_array()
        if s == "lt":
            res = dcol < bisect.bisect_left(vals, val)
        elif s == "le":
            res = dcol < bisect.bisect_right(vals, val)
        elif s == "gt":
            res = dcol >= bisect.bisect_right(vals, val)
        else:  # ge
            res = dcol >= bisect.bisect_left(vals, val)
        return _as_i64(res), and_valid(xp, vcol, vconst)
    return None


@register("lt", infer_bool)
def _lt(xp, args, ctx):
    return _cmp(xp, ctx, lambda a, b: a < b, "lt")


@register("le", infer_bool)
def _le(xp, args, ctx):
    return _cmp(xp, ctx, lambda a, b: a <= b, "le")


@register("ge", infer_bool)
def _ge(xp, args, ctx):
    return _cmp(xp, ctx, lambda a, b: a >= b, "ge")
