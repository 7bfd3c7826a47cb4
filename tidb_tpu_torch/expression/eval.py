"""Vectorized builtin implementations — backend-agnostic (numpy | jax.numpy).

Every function is mask-carried three-valued logic: args and results are
(data, validity) with validity possibly None (all valid) or a scalar bool.
MySQL semantics implemented here (not IEEE/Python):
- division by zero → NULL (both / and DIV and %)
- NULL propagates through arithmetic/comparison
- AND/OR use Kleene logic (FALSE AND NULL = FALSE, TRUE OR NULL = TRUE)
- % takes the sign of the dividend (C fmod, not Python floor-mod)

Ref: pkg/expression/builtin_arithmetic_vec.go, builtin_compare_vec.go,
builtin_op_vec.go, builtin_time_vec.go (YEAR/MONTH/DAY via civil-from-days
integer calendar math so temporal extraction stays on-device).
"""

from __future__ import annotations

from tidb_tpu_torch.types import TypeKind
from tidb_tpu_torch.types.field_type import FieldType, bool_type, double_type, bigint_type, decimal_type, string_type
from tidb_tpu_torch.expression.arrays import astype, dec_to_f64, logical_shr, popcount64, to_f64, to_i64, true_div, zeros_n
from tidb_tpu_torch.expression.registry import (
    ALL_ENGINES,
    HOST_ONLY,
    and_valid,
    infer_bool,
    infer_double,
    infer_first,
    infer_merge,
    register,
)


# ---------------------------------------------------------------------------
# numeric coercion helpers
# ---------------------------------------------------------------------------


def _coerce_pair(xp, ctx, i, j):
    """Bring args i and j to a common physical representation per their
    logical types (decimal rescale, int→float)."""
    (da, va), (db, vb) = ctx.args[i], ctx.args[j]
    ta, tb = ctx.arg_types[i], ctx.arg_types[j]
    if ta.kind == TypeKind.DECIMAL or tb.kind == TypeKind.DECIMAL:
        if ta.kind == TypeKind.FLOAT or tb.kind == TypeKind.FLOAT:
            da = dec_to_f64(xp, da, ta.scale) if ta.kind == TypeKind.DECIMAL else to_f64(xp, da)
            db = dec_to_f64(xp, db, tb.scale) if tb.kind == TypeKind.DECIMAL else to_f64(xp, db)
        else:
            sa = ta.scale if ta.kind == TypeKind.DECIMAL else 0
            sb = tb.scale if tb.kind == TypeKind.DECIMAL else 0
            s = max(sa, sb)
            da = da * (10 ** (s - sa))
            db = db * (10 ** (s - sb))
    elif ta.kind == TypeKind.FLOAT or tb.kind == TypeKind.FLOAT:
        da = to_f64(xp, da)
        db = to_f64(xp, db)
    return da, va, db, vb


def infer_arith(args):
    t = infer_merge(args)
    return t


def infer_div(args):
    # MySQL: `/` over exact types yields decimal; we yield FLOAT unless both
    # are DECIMAL (then scale+4 like MySQL's div_precision_increment)
    a, b = args[0], args[1]
    if a.kind == TypeKind.DECIMAL and b.kind in (TypeKind.DECIMAL, TypeKind.INT, TypeKind.UINT):
        return decimal_type(a.length + 4, a.scale + 4)
    return double_type()


@register("plus", infer_arith)
def _plus(xp, args, ctx):
    da, va, db, vb = _coerce_pair(xp, ctx, 0, 1)
    return da + db, and_valid(xp, va, vb)


@register("minus", infer_arith)
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


def _warn_div0(xp, ctx, nz, va, vb):
    """MySQL 1365 per offending row (ref: stmtctx.AppendWarning via
    builtin_arithmetic division). On the host the count is concrete and
    warnings append immediately; under a jitted trace the count is a traced
    scalar handed to a device warn sink (dag_kernel packs it into the
    kernel's meta row as an extra output — the "overflow/invalid masks as
    kernel outputs" device-warning channel)."""
    import numpy as _np

    warn = getattr(ctx, "warn", None)
    if warn is None:
        return
    bad = ~xp.asarray(nz)
    for v in (va, vb):
        if v is not None and v is not True:
            bad = bad & xp.asarray(v)
    if xp is _np:
        # a scalar-constant zero denominator offends EVERY row of the batch
        cnt = int(bad.sum()) if bad.ndim else (ctx.n if bool(bad) else 0)
        for _ in range(cnt):
            warn("Warning", 1365, "Division by 0")
        return
    if hasattr(warn, "add_traced"):  # device sink: traced per-row count
        warn.add_traced(1365, "Division by 0", xp.sum(bad))


@register("div", infer_div)
def _div(xp, args, ctx):
    (da, va), (db, vb) = args
    ta, tb = ctx.arg_types
    nz = db != 0
    _warn_div0(xp, ctx, nz, va, vb)
    if ctx.ret_type.kind == TypeKind.DECIMAL:
        # decimal/decimal: result scale = sa+4; numerator rescaled so the int
        # division is exact to the target scale. Truncate toward zero, then
        # round half away from zero (floor-div would over-round negatives).
        sb = tb.scale if tb.kind == TypeKind.DECIMAL else 0
        num = da * (10 ** (4 + sb))
        den = xp.where(nz, db, 1)
        absq = xp.abs(num) // xp.abs(den)
        rem = xp.abs(num) - absq * xp.abs(den)
        absq = absq + (2 * rem >= xp.abs(den))
        q = xp.sign(num) * xp.sign(den) * absq
        return q, and_valid(xp, va, vb, nz)
    da = dec_to_f64(xp, da, ta.scale) if ta.kind == TypeKind.DECIMAL else to_f64(xp, da)
    db = dec_to_f64(xp, db, tb.scale) if tb.kind == TypeKind.DECIMAL else to_f64(xp, db)
    return xp.where(nz, true_div(xp, da, xp.where(nz, db, 1.0)), 0.0), and_valid(xp, va, vb, nz)


@register("intdiv", lambda args: bigint_type())
def _intdiv(xp, args, ctx):
    da, va, db, vb = _coerce_pair(xp, ctx, 0, 1)
    nz = db != 0
    _warn_div0(xp, ctx, nz, va, vb)
    den = xp.where(nz, db, 1)
    if ctx.arg_types[0].kind == TypeKind.FLOAT or ctx.arg_types[1].kind == TypeKind.FLOAT:
        q = to_i64(xp, true_div(xp, da, den))
    else:
        # MySQL DIV truncates toward zero
        q = xp.sign(da) * xp.sign(den) * (xp.abs(da) // xp.abs(den))
    return q, and_valid(xp, va, vb, nz)


@register("mod", infer_arith)
def _mod(xp, args, ctx):
    da, va, db, vb = _coerce_pair(xp, ctx, 0, 1)
    nz = db != 0
    _warn_div0(xp, ctx, nz, va, vb)
    den = xp.where(nz, db, 1)
    r = xp.fmod(da, den)  # sign of dividend, MySQL semantics
    return r, and_valid(xp, va, vb, nz)


@register("unaryminus", infer_first, arity=1)
def _unaryminus(xp, args, ctx):
    (d, v) = args[0]
    return -d, v


# ---------------------------------------------------------------------------
# comparisons (binder guarantees numeric/physical-comparable inputs)
# ---------------------------------------------------------------------------


def _cmp(xp, ctx, op, sig=None):
    ta, tb = ctx.arg_types[0], ctx.arg_types[1]
    if ta.kind == TypeKind.STRING or tb.kind == TypeKind.STRING:
        da, va = ctx.args[0]
        db, vb = ctx.args[1]
        dict_a, dict_b = ctx.arg_dicts[0], ctx.arg_dicts[1]
        if "ci" in (ta.collation, tb.collation):
            # case-insensitive collation: compare WEIGHT STRINGS (the
            # general_ci transform — accent + case folding per codepoint;
            # ref: collate.generalCICollator; host-only — pushdown legality
            # keeps these off the device)
            import numpy as np

            from tidb_tpu_torch.utils.collate import weight_bytes

            sa, _ = _decode_strs(ctx, 0)
            sb, _ = _decode_strs(ctx, 1)
            out = np.zeros(max(len(sa), len(sb)), dtype=np.int64)
            for i in range(len(out)):
                x = sa[i if len(sa) > 1 else 0]
                y = sb[i if len(sb) > 1 else 0]
                if x is not None and y is not None:
                    out[i] = int(op(weight_bytes(x), weight_bytes(y)))
            return out, and_valid(xp, va, vb)
        if ta.kind == tb.kind == TypeKind.STRING and dict_a is dict_b and dict_a is not None and dict_a.sorted:
            # same sorted dictionary: codes are order-preserving
            res = op(da, db)
            return res.astype("int64"), and_valid(xp, va, vb)
        # col-vs-constant fast path: bind the constant into the column's
        # dictionary once and compare codes/ranks vectorized (the host
        # analog of binder._bind_code_compare / _bind_rank_compare)
        fast = _cmp_const_fast(xp, ctx, sig)
        if fast is not None:
            return fast
        # general path: decode and compare bytes lexicographically
        import numpy as np

        sa, _ = _decode_strs(ctx, 0)
        sb, _ = _decode_strs(ctx, 1)
        out = np.zeros(max(len(sa), len(sb)), dtype=np.int64)
        for i in range(len(out)):
            x = sa[i if len(sa) > 1 else 0]
            y = sb[i if len(sb) > 1 else 0]
            if x is not None and y is not None:
                out[i] = int(op(x, y))
        return out, and_valid(xp, va, vb)
    da, va, db, vb = _coerce_pair(xp, ctx, 0, 1)
    return astype(xp, op(da, db), "int64"), and_valid(xp, va, vb)


def _cmp_const_fast(xp, ctx, sig):
    """String col vs string constant → vectorized code/rank comparison.
    Returns None when the shape doesn't fit (col-vs-col, no dictionary)."""
    import numpy as np

    for ci, ki in ((0, 1), (1, 0)):
        dcol, vcol = ctx.args[ci]
        dconst, vconst = ctx.args[ki]
        if not (hasattr(dcol, "ndim") and getattr(dcol, "ndim", 0) == 1):
            continue
        if hasattr(dconst, "ndim") and getattr(dconst, "ndim", 0) == 1:
            continue
        col_dict = ctx.arg_dicts[ci]
        const_dict = ctx.arg_dicts[ki]
        if col_dict is None or const_dict is None or ctx.arg_types[ci].kind != TypeKind.STRING:
            return None
        val = const_dict.decode(int(dconst))
        # flip operator when the constant is on the left
        s = sig if ci == 0 else {"lt": "gt", "le": "ge", "gt": "lt", "ge": "le", "eq": "eq", "ne": "ne"}[sig]
        if s in ("eq", "ne"):
            code = col_dict.try_encode(val)
            res = (dcol == code) if s == "eq" else (dcol != code)
            return res.astype("int64"), and_valid(xp, vcol, vconst)
        if not col_dict.sorted:
            return None  # ordering needs order-preserving codes
        import bisect

        vals = col_dict.values_array()
        if s == "lt":
            res = dcol < bisect.bisect_left(vals, val)
        elif s == "le":
            res = dcol < bisect.bisect_right(vals, val)
        elif s == "gt":
            res = dcol >= bisect.bisect_right(vals, val)
        else:  # ge
            res = dcol >= bisect.bisect_left(vals, val)
        return res.astype("int64"), and_valid(xp, vcol, vconst)
    return None


@register("eq", infer_bool)
def _eq(xp, args, ctx):
    return _cmp(xp, ctx, lambda a, b: a == b, "eq")


@register("ne", infer_bool)
def _ne(xp, args, ctx):
    return _cmp(xp, ctx, lambda a, b: a != b, "ne")


@register("lt", infer_bool)
def _lt(xp, args, ctx):
    return _cmp(xp, ctx, lambda a, b: a < b, "lt")


@register("le", infer_bool)
def _le(xp, args, ctx):
    return _cmp(xp, ctx, lambda a, b: a <= b, "le")


@register("gt", infer_bool)
def _gt(xp, args, ctx):
    return _cmp(xp, ctx, lambda a, b: a > b, "gt")


@register("ge", infer_bool)
def _ge(xp, args, ctx):
    return _cmp(xp, ctx, lambda a, b: a >= b, "ge")


@register("in", infer_bool, variadic=True)
def _in(xp, args, ctx):
    (d, v) = args[0]
    is_string = ctx.arg_types[0].kind == TypeKind.STRING
    col_dict = ctx.arg_dicts[0] if is_string else None
    hit = None
    any_null = False
    for i, (cd, cv) in enumerate(args[1:], start=1):
        if cv is False:  # NULL literal in the IN list
            any_null = True
            continue
        if is_string:
            # constants carry their own dictionaries — re-encode against the
            # column's dictionary so code comparison is meaningful
            const_dict = ctx.arg_dicts[i]
            if const_dict is not col_dict and const_dict is not None:
                cd = col_dict.try_encode(const_dict.decode(int(cd))) if col_dict is not None else -1
        h = d == cd
        hit = h if hit is None else (hit | h)
    if hit is None:
        hit = d == d  # empty list after nulls: all False
        hit = hit & False
    res = astype(xp, hit, "int64")
    validity = v
    if any_null:
        # x IN (..., NULL): FALSE becomes NULL
        validity = and_valid(xp, v, hit)
    return res, validity


# ---------------------------------------------------------------------------
# logic (Kleene)
# ---------------------------------------------------------------------------


def _truth(xp, d, v):
    """(is_true, is_false, is_null) masks for a bool-ish (data, validity)."""
    d = xp.asarray(d)  # constants arrive as python scalars
    t = d != 0
    if v is None:
        return t, ~t, None
    v = xp.asarray(v)
    return t & v, (~t) & v, ~v


@register("and", infer_bool)
def _and(xp, args, ctx):
    (da, va), (db, vb) = args
    ta, fa, na = _truth(xp, da, va)
    tb, fb, nb = _truth(xp, db, vb)
    res = ta & tb
    is_false = fa | fb
    valid = is_false | (ta & tb)
    return astype(xp, res, "int64"), valid if (na is not None or nb is not None) else None


@register("or", infer_bool)
def _or(xp, args, ctx):
    (da, va), (db, vb) = args
    ta, fa, na = _truth(xp, da, va)
    tb, fb, nb = _truth(xp, db, vb)
    res = ta | tb
    is_true = res
    valid = is_true | (fa & fb)
    return astype(xp, res, "int64"), valid if (na is not None or nb is not None) else None


@register("not", infer_bool, arity=1)
def _not(xp, args, ctx):
    (d, v) = args[0]
    res = d == 0
    # scalar lane from a constant-folded child (e.g. ISNULL on a folded
    # string function) yields a python bool, not an array
    return astype(xp, res, "int64"), v


@register("xor", infer_bool)
def _xor(xp, args, ctx):
    (da, va), (db, vb) = args
    res = xp.asarray((da != 0) ^ (db != 0))  # scalar const ^ const is a bool
    return astype(xp, res, "int64"), and_valid(xp, va, vb)


# ---------------------------------------------------------------------------
# NULL handling
# ---------------------------------------------------------------------------


@register("isnull", infer_bool, arity=1)
def _isnull(xp, args, ctx):
    (d, v) = args[0]
    if v is None or v is True:  # scalar True: constant-folded valid value
        z = d != d  # all False
        return astype(xp, z, "int64"), None
    if v is False:
        return astype(xp, d * 0 + 1, "int64"), None
    return astype(xp, ~v, "int64"), None


def _string_rows(ctx, i):
    """Decoded (bytes|None) per row for arg i (see _decode_strs below)."""
    return _decode_strs(ctx, i)[0]


@register("ifnull", infer_merge)
def _ifnull(xp, args, ctx):
    if ctx.ret_type.kind == TypeKind.STRING and xp.__name__.startswith("numpy"):
        a = _string_rows(ctx, 0)
        b = _string_rows(ctx, 1)
        return _encode_strs(ctx, [x if x is not None else y for x, y in zip(a, b)])
    (da, va), (db, vb) = args
    if va is None:
        return da, None
    return xp.where(va, da, db), (va | vb) if vb is not None else None


@register("coalesce", infer_merge, variadic=True)
def _coalesce(xp, args, ctx):
    if ctx.ret_type.kind == TypeKind.STRING and xp.__name__.startswith("numpy"):
        rows = [_string_rows(ctx, i) for i in range(len(args))]
        out = []
        for tup in zip(*rows):
            out.append(next((x for x in tup if x is not None), None))
        return _encode_strs(ctx, out)
    out_d, out_v = args[-1]
    for (d, v) in reversed(args[:-1]):
        if v is None:
            # this arg is never NULL → everything below is dead
            out_d, out_v = d, None
        else:
            out_d = xp.where(v, d, out_d)
            # row is valid if this arg is valid OR anything below was
            out_v = None if out_v is None else (v | out_v)
    return out_d, out_v


@register("if", lambda args: infer_merge(args[1:]), variadic=True, arity=3)
def _if(xp, args, ctx):
    (dc, vc), (da, va), (db, vb) = args
    if ctx.ret_type.kind == TypeKind.STRING and xp.__name__.startswith("numpy"):
        import numpy as _np

        cond = _np.broadcast_to(_np.asarray((dc != 0) if vc is None else ((dc != 0) & vc)), (ctx.n,))
        a = _string_rows(ctx, 1)
        b = _string_rows(ctx, 2)
        return _encode_strs(ctx, [x if c else y for c, x, y in zip(cond, a, b)])
    cond = (dc != 0) if vc is None else ((dc != 0) & vc)
    data = xp.where(cond, da, db)
    if va is None and vb is None:
        return data, None
    va_ = va if va is not None else cond | True
    vb_ = vb if vb is not None else cond | True
    return data, xp.where(cond, va_, vb_)


@register("nulleq", infer_bool, arity=2)
def _nulleq(xp, args, ctx):
    """<=> NULL-safe equality: never NULL; NULL <=> NULL is 1. The value
    comparison routes through the same coercion/dictionary machinery as
    ``=`` — only the NULL handling differs."""
    (da, va), (db, vb) = args
    eq_d, eq_v = _cmp(xp, ctx, lambda a, b: a == b, "eq")
    null_a = zeros_n(xp, ctx.n, bool, (da, db)) if va is None else ~xp.broadcast_to(xp.asarray(va), (ctx.n,))
    null_b = zeros_n(xp, ctx.n, bool, (da, db)) if vb is None else ~xp.broadcast_to(xp.asarray(vb), (ctx.n,))
    eq = xp.broadcast_to(xp.asarray(eq_d) != 0, (ctx.n,))
    if eq_v is not None and eq_v is not True:
        eq = eq & xp.broadcast_to(xp.asarray(eq_v), (ctx.n,))
    out = xp.where(null_a | null_b, null_a & null_b, eq)
    return astype(xp, out, xp.int64), None


def _infer_case(args):
    # the result type merges the VALUE arms only — conditions are boolean
    has_else = len(args) % 2 == 1
    vals = [args[i] for i in range(1, len(args) - (1 if has_else else 0), 2)]
    if has_else:
        vals.append(args[-1])
    return infer_merge(vals) if vals else args[0]


@register("case_when", _infer_case, variadic=True)
def _case_when(xp, args, ctx):
    """args: cond1, val1, cond2, val2, ..., [else_val]."""
    has_else = len(args) % 2 == 1
    if ctx.ret_type.kind == TypeKind.STRING and xp.__name__.startswith("numpy"):
        import numpy as _np

        n = ctx.n
        conds = []
        vals = []
        for i in range(0, len(args) - (1 if has_else else 0), 2):
            dc, vc = args[i]
            c = _np.broadcast_to(_np.asarray((dc != 0) if vc is None else ((dc != 0) & vc)), (n,))
            conds.append(c)
            vals.append(_string_rows(ctx, i + 1))
        els = _string_rows(ctx, len(args) - 1) if has_else else [None] * n
        out = []
        for r in range(n):
            chosen = els[r]
            for c, vv in zip(conds, vals):
                if c[r]:
                    chosen = vv[r]
                    break
            out.append(chosen)
        return _encode_strs(ctx, out)
    if has_else:
        out_d, out_v = args[-1]
        pairs = args[:-1]
    else:
        d0 = args[1][0]
        out_d, out_v = d0 * 0, False
        pairs = args
    for i in range(len(pairs) - 2, -1, -2):
        (dc, vc), (dv, vv) = pairs[i], pairs[i + 1]
        dc = xp.asarray(dc)
        cond = (dc != 0) if vc is None else ((dc != 0) & vc)
        out_d = xp.where(cond, dv, out_d)
        if vv is None and out_v is None:
            continue  # both branches all-valid
        out_v = xp.where(cond, True if vv is None else vv, True if out_v is None else out_v)
    return out_d, out_v


# ---------------------------------------------------------------------------
# math
# ---------------------------------------------------------------------------


@register("abs", infer_first, arity=1)
def _abs(xp, args, ctx):
    (d, v) = args[0]
    return xp.abs(d), v


@register("ceil", lambda args: bigint_type(), arity=1)
def _ceil(xp, args, ctx):
    (d, v) = args[0]
    t = ctx.arg_types[0]
    if t.kind == TypeKind.DECIMAL:
        f = 10**t.scale
        return -((-d) // f), v
    if t.kind == TypeKind.FLOAT:
        return to_i64(xp, xp.ceil(d)), v
    return d, v


@register("floor", lambda args: bigint_type(), arity=1)
def _floor(xp, args, ctx):
    (d, v) = args[0]
    t = ctx.arg_types[0]
    if t.kind == TypeKind.DECIMAL:
        return d // (10**t.scale), v
    if t.kind == TypeKind.FLOAT:
        return to_i64(xp, xp.floor(d)), v
    return d, v


@register("round", infer_first, variadic=True, arity=1)
def _round(xp, args, ctx):
    (d, v) = args[0]
    t = ctx.arg_types[0]
    nd = 0
    if len(args) > 1:
        nd = int(args[1][0])  # binder guarantees constant
    if t.kind == TypeKind.DECIMAL:
        drop = t.scale - nd
        if drop <= 0:
            return d, v
        f = 10**drop
        q = xp.sign(d) * ((xp.abs(d) + f // 2) // f) * f
        return q, v
    if t.kind == TypeKind.FLOAT:
        f = 10.0**nd
        return true_div(xp, xp.where(d >= 0, xp.floor(d * f + 0.5), xp.ceil(d * f - 0.5)), f), v
    if nd >= 0:
        return d, v
    f = 10 ** (-nd)
    return xp.sign(d) * ((xp.abs(d) + f // 2) // f) * f, v


@register("sqrt", infer_double, arity=1)
def _sqrt(xp, args, ctx):
    (d, v) = args[0]
    d = to_f64(xp, d)
    ok = d >= 0
    return xp.where(ok, xp.sqrt(xp.where(ok, d, 0.0)), 0.0), and_valid(xp, v, ok)


@register("pow", infer_double)
def _pow(xp, args, ctx):
    (da, va), (db, vb) = args
    return xp.power(to_f64(xp, da), to_f64(xp, db)), and_valid(xp, va, vb)


@register("exp", infer_double, arity=1)
def _exp(xp, args, ctx):
    (d, v) = args[0]
    return xp.exp(to_f64(xp, d)), v


def _log_impl(xp, d, v, base_log):
    d = to_f64(xp, d)
    ok = d > 0
    return base_log(xp.where(ok, d, 1.0)), and_valid(xp, v, ok)


@register("ln", infer_double, arity=1)
def _ln(xp, args, ctx):
    (d, v) = args[0]
    return _log_impl(xp, d, v, xp.log)


@register("log2", infer_double, arity=1)
def _log2(xp, args, ctx):
    (d, v) = args[0]
    return _log_impl(xp, d, v, xp.log2)


@register("log10", infer_double, arity=1)
def _log10(xp, args, ctx):
    (d, v) = args[0]
    return _log_impl(xp, d, v, xp.log10)


@register("sign", lambda args: bigint_type(), arity=1)
def _sign(xp, args, ctx):
    (d, v) = args[0]
    return to_i64(xp, xp.sign(d)), v


@register("bit_count", lambda args: bigint_type(), arity=1)
def _bit_count(xp, args, ctx):
    (d, v) = args[0]
    # popcount over the two's-complement uint64 view (MySQL BIT_COUNT(-1)=64)
    return popcount64(xp, d), v


# ---------------------------------------------------------------------------
# casts (ret_type on the ScalarFunc carries the target)
# ---------------------------------------------------------------------------


_NUM_PREFIX = None  # lazily compiled regex


def _str_numeric(ctx, kind_name: str):
    """MySQL string→number coercion: parse the longest numeric prefix,
    warn 1292 per row with trailing garbage (ref: types.StrToFloat /
    strconv with truncation warnings). Integer-looking prefixes stay exact
    Python ints (no float round-trip) so int64-boundary values survive.
    → list[int|float|None]."""
    import re

    global _NUM_PREFIX
    if _NUM_PREFIX is None:
        _NUM_PREFIX = re.compile(rb"^\s*([+-]?)(\d+\.?\d*|\.\d+)([eE][+-]?\d+)?")
    strs, _ = _decode_strs(ctx, 0)
    warn = getattr(ctx, "warn", None)
    out = []
    for s in strs:
        if s is None:
            out.append(None)
            continue
        m = _NUM_PREFIX.match(s)
        if m is None:
            out.append(0.0)
            if warn is not None:
                warn("Warning", 1292, f"Truncated incorrect {kind_name} value: '{s.decode('utf-8', 'replace')}'")
            continue
        if m.group(3) is None and b"." not in m.group(2):
            x = int(m.group(1) + m.group(2))  # exact integer, no float loss
        else:
            try:
                x = float(m.group(0))
            except (ValueError, OverflowError):
                x = 0.0
            if x == float("inf") or x == float("-inf"):  # 1e400 clamps
                x = float("1.7976931348623157e308") * (1 if x > 0 else -1)
        if m.end() < len(s) and s[m.end():].strip():
            if warn is not None:
                warn("Warning", 1292, f"Truncated incorrect {kind_name} value: '{s.decode('utf-8', 'replace')}'")
        out.append(x)
    return out


_I64_LO, _I64_HI = -(2**63), 2**63 - 1


def _clamp_i64(x, warn, kind_name: str):
    """Round to int and clamp to int64 with MySQL 1264 on overflow."""
    if isinstance(x, float):
        if x != x:  # NaN
            x = 0.0
        elif x > 9.3e18 or x < -9.3e18:  # covers inf: clamp before int()
            if warn is not None:
                warn("Warning", 1264, f"Out of range value for {kind_name}")
            return _I64_HI if x > 0 else _I64_LO
    i = int(x + (0.5 if x >= 0 else -0.5)) if isinstance(x, float) else x
    if i > _I64_HI or i < _I64_LO:
        if warn is not None:
            warn("Warning", 1264, f"Out of range value for {kind_name}")
        return _I64_HI if i > 0 else _I64_LO
    return i


@register("cast_int", lambda args: bigint_type(), arity=1)
def _cast_int(xp, args, ctx):
    (d, v) = args[0]
    t = ctx.arg_types[0]
    if t.kind == TypeKind.STRING:
        import numpy as np

        warn = getattr(ctx, "warn", None)
        vals = _str_numeric(ctx, "INTEGER")
        data = np.array(
            [0 if x is None else _clamp_i64(x, warn, "BIGINT") for x in vals],
            dtype=np.int64,
        )
        valid = np.array([x is not None for x in vals], dtype=bool)
        return data, valid
    if t.kind == TypeKind.DECIMAL:
        f = 10**t.scale
        return xp.sign(d) * ((xp.abs(d) + f // 2) // f), v
    if t.kind == TypeKind.FLOAT:
        return to_i64(xp, xp.where(d >= 0, xp.floor(d + 0.5), xp.ceil(d - 0.5))), v
    return d, v


@register("cast_float", infer_double, arity=1)
def _cast_float(xp, args, ctx):
    (d, v) = args[0]
    t = ctx.arg_types[0]
    if t.kind == TypeKind.STRING:
        import numpy as np

        vals = _str_numeric(ctx, "DOUBLE")
        data = np.array([0.0 if x is None else x for x in vals], dtype=np.float64)
        valid = np.array([x is not None for x in vals], dtype=bool)
        return data, valid
    if t.kind == TypeKind.DECIMAL:
        return dec_to_f64(xp, d, t.scale), v
    return to_f64(xp, d), v


@register("cast_decimal", lambda args: args[0], arity=1)
def _cast_decimal(xp, args, ctx):
    (d, v) = args[0]
    t = ctx.arg_types[0]
    target = ctx.ret_type
    if t.kind == TypeKind.STRING:
        import numpy as np

        warn = getattr(ctx, "warn", None)
        vals = _str_numeric(ctx, "DECIMAL")
        f = 10**target.scale
        # DECIMAL(p,s) range: scaled magnitude < 10^p (clamp like MySQL 1264)
        prec = target.length if target.length and target.length > 0 else 18
        cap = 10 ** min(prec, 18) - 1
        out = []
        for x in vals:
            if x is None:
                out.append(0)
                continue
            # cap-clamp below always fires for out-of-range (cap < int64 max),
            # so the inner clamp stays silent to avoid a double 1264
            q = _clamp_i64(x * f, None, "DECIMAL")
            if q > cap or q < -cap:
                if warn is not None:
                    warn("Warning", 1264, "Out of range value for DECIMAL")
                q = cap if q > 0 else -cap
            out.append(q)
        data = np.array(out, dtype=np.int64)
        valid = np.array([x is not None for x in vals], dtype=bool)
        return data, valid
    if t.kind == TypeKind.DECIMAL:
        diff = target.scale - t.scale
        if diff >= 0:
            return d * (10**diff), v
        f = 10 ** (-diff)
        return xp.sign(d) * ((xp.abs(d) + f // 2) // f), v
    if t.kind == TypeKind.FLOAT:
        scaled = d * (10.0**target.scale)
        return to_i64(xp, xp.where(scaled >= 0, xp.floor(scaled + 0.5), xp.ceil(scaled - 0.5))), v
    return d * (10**target.scale), v


# ---------------------------------------------------------------------------
# temporal extraction — civil-from-days (pure integer math, device-legal)
# ---------------------------------------------------------------------------


def _civil_from_days(xp, days):
    # int32 throughout: calendar day counts fit comfortably, and 64-bit
    # integer division is emulated on TPU (each i64 div compiles to a large
    # multiword sequence — a chain of them made WEEK()-style expressions
    # take minutes to compile); 32-bit division lowers natively
    z = astype(xp, xp.asarray(days + 719468), xp.int32)
    era = z // 146097
    doe = z - era * 146097
    yoe = (doe - doe // 1460 + doe // 36524 - doe // 146096) // 365
    y = yoe + era * 400
    doy = doe - (365 * yoe + yoe // 4 - yoe // 100)
    mp = (5 * doy + 2) // 153
    d = doy - (153 * mp + 2) // 5 + 1
    m = mp + xp.where(mp < 10, 3, -9)
    y = y + (m <= 2)
    return y, m, d


def _days_arg(xp, ctx, i):
    (d, v) = ctx.args[i]
    if ctx.arg_types[i].kind == TypeKind.DATETIME:
        d = d // 86_400_000_000  # micros → days
    return d, v


@register("year", lambda args: bigint_type(), arity=1)
def _year(xp, args, ctx):
    d, v = _days_arg(xp, ctx, 0)
    y, _, _ = _civil_from_days(xp, d)
    return y, v


@register("month", lambda args: bigint_type(), arity=1)
def _month(xp, args, ctx):
    d, v = _days_arg(xp, ctx, 0)
    _, m, _ = _civil_from_days(xp, d)
    return m, v


def _fold_extreme(xp, ctx, op):
    """GREATEST/LEAST: normalize every operand to the merged result type's
    physical representation (decimal scales / float conversion), then fold.
    MySQL yields NULL when any argument is NULL."""
    rft = ctx.ret_type
    if rft.kind == TypeKind.STRING:
        rows = [_string_rows(ctx, i) for i in range(len(ctx.args))]
        pick = max if op is xp.maximum else min
        out = []
        for tup in zip(*rows):
            out.append(None if any(x is None for x in tup) else pick(tup))
        return _encode_strs(ctx, out)
    d, v = None, None
    for i, (dd, vv) in enumerate(ctx.args):
        ft = ctx.arg_types[i]
        dd = xp.asarray(dd)
        if rft.kind == TypeKind.FLOAT:
            dd = dec_to_f64(xp, dd, ft.scale) if ft.kind == TypeKind.DECIMAL else to_f64(xp, dd)
        elif rft.kind == TypeKind.DECIMAL:
            ds = ft.scale if ft.kind == TypeKind.DECIMAL else 0
            dd = dd * (10 ** (rft.scale - ds))
        if d is None:
            d, v = dd, vv
        else:
            d = op(d, dd)
            v = and_valid(xp, v, vv)
    return d, v


@register("greatest", infer_merge, variadic=True, arity=2)
def _greatest(xp, args, ctx):
    return _fold_extreme(xp, ctx, xp.maximum)


@register("least", infer_merge, variadic=True, arity=2)
def _least(xp, args, ctx):
    return _fold_extreme(xp, ctx, xp.minimum)


@register("truncate", lambda args: args[0], arity=2)
def _truncate(xp, args, ctx):
    (d, v), (nd, nv) = args
    ft = ctx.arg_types[0]
    k = int(nd if not hasattr(nd, "__len__") else nd[0])
    def _trunc_step(a, step):
        # truncation is toward ZERO (floor division would round negatives
        # away from zero): sign * (|a| // step * step)
        a = xp.asarray(a)
        return xp.sign(a) * (xp.abs(a) // step * step)

    if ft.kind == TypeKind.DECIMAL:
        # physical is scale-s int: zero out digits below 10^(s-k)
        step = 10 ** max(ft.scale - k, 0)
        q = _trunc_step(d, step) if step > 1 else xp.asarray(d)
        return q, and_valid(xp, v, nv)
    if ft.kind == TypeKind.FLOAT:
        m = 10.0 ** k
        return true_div(xp, xp.trunc(xp.asarray(d) * m), m), and_valid(xp, v, nv)
    if k >= 0:
        return d, and_valid(xp, v, nv)
    return _trunc_step(d, 10 ** (-k)), and_valid(xp, v, nv)


@register("quarter", lambda args: bigint_type(), arity=1)
def _quarter(xp, args, ctx):
    d, v = _days_arg(xp, ctx, 0)
    _, m, _ = _civil_from_days(xp, d)
    return (m + 2) // 3, v


@register("dayofmonth", lambda args: bigint_type(), arity=1)
def _dayofmonth(xp, args, ctx):
    d, v = _days_arg(xp, ctx, 0)
    _, _, dd = _civil_from_days(xp, d)
    return dd, v


@register("dayofweek", lambda args: bigint_type(), arity=1)
def _dayofweek(xp, args, ctx):
    d, v = _days_arg(xp, ctx, 0)
    # 1970-01-01 is a Thursday; MySQL DAYOFWEEK: 1=Sunday
    return ((d + 4) % 7) + 1, v


@register("hour", lambda args: bigint_type(), arity=1)
def _hour(xp, args, ctx):
    (d, v) = args[0]
    return (d // 3_600_000_000) % 24, v


@register("minute", lambda args: bigint_type(), arity=1)
def _minute(xp, args, ctx):
    (d, v) = args[0]
    return (d // 60_000_000) % 60, v


@register("second", lambda args: bigint_type(), arity=1)
def _second(xp, args, ctx):
    (d, v) = args[0]
    return (d // 1_000_000) % 60, v


@register("date_add_days", infer_first)
def _date_add_days(xp, args, ctx):
    (da, va), (db, vb) = args
    if ctx.arg_types[0].kind == TypeKind.DATETIME:
        return da + db * 86_400_000_000, and_valid(xp, va, vb)
    return da + db, and_valid(xp, va, vb)


def _dt_micros_ft(args):
    # adding sub-day units promotes DATE to DATETIME (midnight base)
    if args[0].kind == TypeKind.DATE:
        return FieldType(TypeKind.DATETIME, nullable=args[0].nullable)
    return args[0]


@register("date_add_micros", _dt_micros_ft, arity=2)
def _date_add_micros(xp, args, ctx):
    (da, va), (db, vb) = args
    base = da * 86_400_000_000 if ctx.arg_types[0].kind == TypeKind.DATE else da
    return base + db, and_valid(xp, va, vb)


@register("date_add_months", infer_first, arity=2)
def _date_add_months(xp, args, ctx):
    """Calendar month arithmetic with day-of-month clamping (MySQL:
    '2024-01-31' + INTERVAL 1 MONTH = '2024-02-29')."""
    (da, va), (db, vb) = args
    is_dt = ctx.arg_types[0].kind == TypeKind.DATETIME
    days = xp.asarray(da) // 86_400_000_000 if is_dt else xp.asarray(da)
    tod = xp.asarray(da) % 86_400_000_000 if is_dt else 0
    y, m, d = _civil_from_days(xp, days)
    months = (y * 12 + (m - 1)) + xp.asarray(db)
    ny = months // 12
    nm = months % 12 + 1
    # clamp the day to the target month's length
    first = _days_from_civil(xp, ny, nm, 1 + 0 * ny)
    ny2 = xp.where(nm == 12, ny + 1, ny)
    nm2 = xp.where(nm == 12, 1, nm + 1)
    days_in = _days_from_civil(xp, ny2, nm2, 1 + 0 * ny) - first
    out_days = first + xp.minimum(d, days_in) - 1
    out = out_days * 86_400_000_000 + tod if is_dt else out_days
    return out, and_valid(xp, va, vb)


# ---------------------------------------------------------------------------
# strings (host engine only; device string ops happen on dictionary codes and
# are produced by the binder, never through these entry points)
# ---------------------------------------------------------------------------


def _decode_strs(ctx, i):
    (d, v) = ctx.args[i]
    dic = ctx.arg_dicts[i]
    import numpy as np

    from tidb_tpu_torch.types.datum import format_physical

    ft = ctx.arg_types[i]
    n = len(d) if hasattr(d, "__len__") else ctx.n
    out = []
    for k in range(n):
        if v is not None and v is not True and not (v if isinstance(v, bool) else v[k]):
            out.append(None)
            continue
        x = d if not hasattr(d, "__len__") else d[k]
        if dic is not None:
            out.append(dic.decode(int(x)))
        elif ft.kind == TypeKind.STRING:
            # string-valued but dictionary-less (e.g. folded constants)
            out.append(x if isinstance(x, bytes) else str(x).encode())
        else:
            # non-string operand: MySQL coerces to its string form
            out.append(format_physical(x, ft))
    return out, v


def _encode_strs(ctx, strs):
    import numpy as np

    dic = ctx.ret_dict
    data = np.zeros(len(strs), dtype=np.int32)
    valid = np.ones(len(strs), dtype=bool)
    for i, s in enumerate(strs):
        if s is None:
            valid[i] = False
        else:
            data[i] = dic.encode(s)
    return data, valid


@register("cast_string", lambda args: string_type(), engines=HOST_ONLY, arity=1)
def _cast_string(xp, args, ctx):
    """CAST(x AS CHAR) — MySQL-style value formatting."""
    import numpy as np

    from tidb_tpu_torch.types.datum import days_to_date, micros_to_datetime

    maxlen = ctx.ret_type.length  # CHAR(n) truncates; -1 = unbounded
    warn = getattr(ctx, "warn", None)

    def _trunc(b):
        if maxlen < 0 or b is None:
            return b
        if isinstance(b, bytes):
            # CHAR(n) counts characters, not bytes — never split a codepoint
            chars = b.decode("utf-8", "surrogateescape")
            if len(chars) > maxlen and warn is not None:
                warn("Warning", 1292, f"Truncated incorrect CHAR({maxlen}) value: '{chars}'")
            return chars[:maxlen].encode("utf-8", "surrogateescape")
        if len(b) > maxlen and warn is not None:
            warn("Warning", 1292, f"Truncated incorrect CHAR({maxlen}) value: '{b}'")
        return b[:maxlen]

    t = ctx.arg_types[0]
    if t.kind == TypeKind.STRING:
        strs, _ = _decode_strs(ctx, 0)
        return _encode_strs(ctx, [_trunc(s) for s in strs])
    from tidb_tpu_torch.types.datum import format_physical

    (d, v) = args[0]
    n = len(d) if hasattr(d, "__len__") else ctx.n
    out = []
    for k in range(n):
        if v is not None and v is not True and not (v if isinstance(v, bool) else v[k]):
            out.append(None)
            continue
        x = d if not hasattr(d, "__len__") else d[k]
        out.append(_trunc(format_physical(x, t)))
    return _encode_strs(ctx, out)


@register("length", lambda args: bigint_type(), engines=HOST_ONLY, arity=1)
def _length(xp, args, ctx):
    strs, v = _decode_strs(ctx, 0)
    import numpy as np

    return np.array([0 if s is None else len(s) for s in strs], dtype=np.int64), v


@register("lower", lambda args: string_type(), engines=HOST_ONLY, arity=1)
def _lower(xp, args, ctx):
    strs, _ = _decode_strs(ctx, 0)
    return _encode_strs(ctx, [None if s is None else s.lower() for s in strs])


@register("upper", lambda args: string_type(), engines=HOST_ONLY, arity=1)
def _upper(xp, args, ctx):
    strs, _ = _decode_strs(ctx, 0)
    return _encode_strs(ctx, [None if s is None else s.upper() for s in strs])


@register("concat", lambda args: string_type(), engines=HOST_ONLY, variadic=True)
def _concat(xp, args, ctx):
    cols = [_decode_strs(ctx, i)[0] for i in range(len(args))]
    out = []
    for parts in zip(*cols):
        out.append(None if any(p is None for p in parts) else b"".join(parts))
    return _encode_strs(ctx, out)


@register("substring", lambda args: string_type(), engines=HOST_ONLY, variadic=True, arity=3)
def _substring(xp, args, ctx):
    strs, _ = _decode_strs(ctx, 0)
    pos = int(args[1][0])
    ln = int(args[2][0]) if len(args) > 2 else None
    out = []
    for s in strs:
        if s is None:
            out.append(None)
            continue
        # MySQL 1-based; negative pos counts from the end; pos 0, negative
        # length, or |pos| beyond the string → empty
        if pos == 0 or (ln is not None and ln <= 0):
            out.append(b"")
            continue
        start = pos - 1 if pos > 0 else len(s) + pos
        if start < 0:
            out.append(b"")
            continue
        out.append(s[start:] if ln is None else s[start : start + ln])
    return _encode_strs(ctx, out)


def like_to_regex(pat: str) -> str:
    """SQL LIKE → regex: % = .*, _ = ., backslash escapes the next char."""
    import re

    out = []
    i = 0
    while i < len(pat):
        ch = pat[i]
        if ch == "\\" and i + 1 < len(pat):
            out.append(re.escape(pat[i + 1]))
            i += 2
            continue
        if ch == "%":
            out.append(".*")
        elif ch == "_":
            out.append(".")
        else:
            out.append(re.escape(ch))
        i += 1
    return "^" + "".join(out) + "$"


@register("like", infer_bool, engines=HOST_ONLY)
def _like(xp, args, ctx):
    import re

    import numpy as np

    strs, v = _decode_strs(ctx, 0)
    pat_code = int(args[1][0])
    pat = ctx.arg_dicts[1].decode(pat_code).decode("utf-8", "replace")
    ci = ctx.arg_types[0].collation == "ci"
    if ci:
        # ci LIKE folds through general_ci WEIGHTS (accents too, beyond
        # IGNORECASE) — the transform is per-codepoint, so % and _ survive
        from tidb_tpu_torch.utils.collate import weight_str

        pat = weight_str(pat)
    else:
        weight_str = None
    rx = re.compile(like_to_regex(pat), re.DOTALL)
    out = np.zeros(len(strs), dtype=np.int64)
    for i, s in enumerate(strs):
        if s is None:
            continue
        sv = s.decode("utf-8", "replace")
        if ci:
            sv = weight_str(sv)
        if rx.match(sv):
            out[i] = 1
    return out, v


@register("regexp", infer_bool, engines=HOST_ONLY)
def _regexp(xp, args, ctx):
    """a REGEXP p / REGEXP_LIKE(a, p): substring-search semantics (unlike
    LIKE's full match); case sensitivity follows the operand collation
    (ref: builtin_regexp — ICU there, Python re here; an invalid pattern
    raises like MySQL ERROR 3685)."""
    import re

    import numpy as np

    strs, _ = _decode_strs(ctx, 0)
    pats, _ = _decode_strs(ctx, 1)
    # NO re.DOTALL: MySQL/ICU '.' stops at line terminators by default
    # (unlike LIKE, whose '%' must span newlines)
    flags = re.IGNORECASE if ctx.arg_types[0].collation == "ci" else 0
    cache: dict = {}
    n = max(len(strs), len(pats))
    out = np.zeros(n, dtype=np.int64)
    valid = np.ones(n, dtype=bool)
    for i in range(n):
        s = strs[i if len(strs) > 1 else 0]
        p = pats[i if len(pats) > 1 else 0]
        if s is None or p is None:
            valid[i] = False
            continue
        rx = cache.get(p)
        if rx is None:
            from tidb_tpu_torch.utils import mysql_regex

            try:
                rx = cache[p] = mysql_regex.compile(p.decode("utf-8", "replace"), flags)
            except (re.error, ValueError) as e:
                raise ValueError(f"Invalid regular expression: {e}") from None
        out[i] = 1 if rx.search(s.decode("utf-8", "replace")) else 0
    return out, valid


register("regexp_like", infer_bool, engines=HOST_ONLY)(_regexp)


@register("elt", lambda args: string_type(nullable=True), engines=HOST_ONLY, variadic=True)
def _elt(xp, args, ctx):
    """ELT(n, s1, s2, ...): the n-th string, NULL out of range (1-based)."""
    ns = _int_args(args, 0, max(len(a[0]) if hasattr(a[0], "__len__") else 1 for a in args))
    cols = [_decode_strs(ctx, i)[0] for i in range(1, len(args))]
    out = []
    for i, nv in enumerate(ns):
        if nv is None or not (1 <= nv <= len(cols)):
            out.append(None)
        else:
            c = cols[nv - 1]
            out.append(c[i if len(c) > 1 else 0])
    return _encode_strs(ctx, out)


@register("field", lambda args: bigint_type(nullable=False), engines=HOST_ONLY, variadic=True)
def _field(xp, args, ctx):
    """FIELD(x, a, b, ...): 1-based index of the first argument equal to x,
    0 when absent or x is NULL (string comparison under the operand
    collation — general_ci weight strings for ci)."""
    import numpy as np

    from tidb_tpu_torch.utils.collate import weight_bytes

    ci = ctx.arg_types[0].collation == "ci"
    cols = [_decode_strs(ctx, i)[0] for i in range(len(args))]
    n = max(len(c) for c in cols)
    out = np.zeros(n, dtype=np.int64)
    for i in range(n):
        x = cols[0][i if len(cols[0]) > 1 else 0]
        if x is None:
            continue
        if ci:
            x = weight_bytes(x)
        for k, c in enumerate(cols[1:], start=1):
            v = c[i if len(c) > 1 else 0]
            if v is not None and (weight_bytes(v) if ci else v) == x:
                out[i] = k
                break
    return out, np.ones(n, dtype=bool)


# ---------------------------------------------------------------------------
# JSON functions (ref: types/json + expression/builtin_json — documents are
# normalized JSON text on the STRING representation, host-side evaluation)
# ---------------------------------------------------------------------------


def _json_path_get(doc, path: str):
    """Evaluate a '$.a.b[0]' path against a parsed document; returns a
    sentinel (_JSON_MISS) when the path doesn't exist."""
    import re as _re

    cur = doc
    if not path.startswith("$"):
        raise ValueError(f"Invalid JSON path expression {path!r}")
    for m in _re.finditer(r"\.(\w+|\*)|\[(\d+|\*)\]|\.\"([^\"]+)\"", path[1:]):
        key, idx, qkey = m.group(1), m.group(2), m.group(3)
        if cur is _JSON_MISS:
            return _JSON_MISS
        if key is not None or qkey is not None:
            k = key if key is not None else qkey
            if k == "*":
                return cur if isinstance(cur, dict) else _JSON_MISS
            cur = cur.get(k, _JSON_MISS) if isinstance(cur, dict) else _JSON_MISS
        else:
            if idx == "*":
                return cur if isinstance(cur, list) else _JSON_MISS
            i = int(idx)
            cur = cur[i] if isinstance(cur, list) and i < len(cur) else _JSON_MISS
    return cur


class _JsonMiss:
    pass


_JSON_MISS = _JsonMiss()


def _json_dump(v) -> bytes:
    import json as _json

    return _json.dumps(v, separators=(", ", ": "), ensure_ascii=False).encode()


@register("json_extract", lambda args: FieldType(TypeKind.STRING, nullable=True, json=True), engines=HOST_ONLY)
def _json_extract(xp, args, ctx):
    import json as _json

    docs, _ = _decode_strs(ctx, 0)
    paths, _ = _decode_strs(ctx, 1)
    out = []
    for i in range(max(len(docs), len(paths))):
        d = docs[i if len(docs) > 1 else 0]
        p = paths[i if len(paths) > 1 else 0]
        if d is None or p is None:
            out.append(None)
            continue
        try:
            doc = _json.loads(d)
        except Exception:
            out.append(None)
            continue
        got = _json_path_get(doc, (p.decode() if isinstance(p, bytes) else p))
        out.append(None if got is _JSON_MISS else _json_dump(got))
    return _encode_strs(ctx, out)


@register("json_unquote", lambda args: string_type(), engines=HOST_ONLY, arity=1)
def _json_unquote(xp, args, ctx):
    import json as _json

    strs, _ = _decode_strs(ctx, 0)
    out = []
    for s in strs:
        if s is None:
            out.append(None)
            continue
        t = s.decode() if isinstance(s, bytes) else s
        if t.startswith('"') and t.endswith('"'):
            try:
                t = _json.loads(t)
            except ValueError:
                pass  # not valid JSON text: unquote is a no-op, keep as-is
        out.append(t.encode() if isinstance(t, str) else t)
    return _encode_strs(ctx, out)


@register("json_valid", infer_bool, engines=HOST_ONLY, arity=1)
def _json_valid(xp, args, ctx):
    import json as _json
    import numpy as np

    strs, v = _decode_strs(ctx, 0)
    out = np.zeros(len(strs), dtype=np.int64)
    for i, s in enumerate(strs):
        if s is None:
            continue
        try:
            _json.loads(s)
            out[i] = 1
        except Exception:
            out[i] = 0
    return out, v


@register("json_length", lambda args: bigint_type(nullable=True), engines=HOST_ONLY, variadic=True, arity=2)
def _json_length(xp, args, ctx):
    """JSON_LENGTH(doc[, path]): elements of an array, keys of an object,
    1 for scalars; NULL on missing path (ref: builtin_json JSONLength)."""
    import json as _json

    import numpy as np

    docs, _ = _decode_strs(ctx, 0)
    paths = _decode_strs(ctx, 1)[0] if len(args) > 1 else None
    n = max(len(docs), len(paths) if paths else 1)
    out = np.zeros(n, dtype=np.int64)
    valid = np.ones(n, dtype=bool)
    for i in range(n):
        d = docs[i if len(docs) > 1 else 0]
        p = paths[i if len(paths) > 1 else 0] if paths else b"$"
        if d is None or p is None:
            valid[i] = False
            continue
        try:
            doc = _json.loads(d)
        except Exception:
            valid[i] = False
            continue
        got = _json_path_get(doc, p.decode() if isinstance(p, bytes) else p)
        if got is _JSON_MISS:
            valid[i] = False
        elif isinstance(got, (dict, list)):
            out[i] = len(got)
        else:
            out[i] = 1
    return out, valid


@register("json_keys", lambda args: FieldType(TypeKind.STRING, nullable=True, json=True), engines=HOST_ONLY, variadic=True, arity=2)
def _json_keys(xp, args, ctx):
    """JSON_KEYS(doc[, path]): object keys as a JSON array; NULL for
    non-objects or missing paths (ref: builtin_json JSONKeys)."""
    import json as _json

    docs, _ = _decode_strs(ctx, 0)
    paths = _decode_strs(ctx, 1)[0] if len(args) > 1 else None
    out = []
    n = max(len(docs), len(paths) if paths else 1)
    for i in range(n):
        d = docs[i if len(docs) > 1 else 0]
        p = paths[i if len(paths) > 1 else 0] if paths else b"$"
        if d is None or p is None:
            out.append(None)
            continue
        try:
            doc = _json.loads(d)
        except Exception:
            out.append(None)
            continue
        got = _json_path_get(doc, p.decode() if isinstance(p, bytes) else p)
        out.append(_json_dump(list(got.keys())) if isinstance(got, dict) else None)
    return _encode_strs(ctx, out)


@register("json_contains_path", lambda args: bigint_type(nullable=True), engines=HOST_ONLY, variadic=True, arity=3)
def _json_contains_path(xp, args, ctx):
    """JSON_CONTAINS_PATH(doc, 'one'|'all', p1, p2, ...)."""
    import json as _json

    import numpy as np

    docs, _ = _decode_strs(ctx, 0)
    modes, _ = _decode_strs(ctx, 1)
    pcols = [_decode_strs(ctx, i)[0] for i in range(2, len(args))]
    n = max(len(docs), len(modes), *(len(c) for c in pcols))
    out = np.zeros(n, dtype=np.int64)
    valid = np.ones(n, dtype=bool)
    for i in range(n):
        d = docs[i if len(docs) > 1 else 0]
        m = modes[i if len(modes) > 1 else 0]
        if d is None or m is None:
            valid[i] = False
            continue
        m = m.lower()
        if m not in (b"one", b"all"):
            raise ValueError("The oneOrAll argument to json_contains_path may take these values: 'one' or 'all'")
        try:
            doc = _json.loads(d)
        except Exception:
            valid[i] = False
            continue
        hits = []
        for c in pcols:
            p = c[i if len(c) > 1 else 0]
            if p is None:
                valid[i] = False
                break
            hits.append(_json_path_get(doc, p.decode() if isinstance(p, bytes) else p) is not _JSON_MISS)
        else:
            out[i] = int(any(hits) if m == b"one" else all(hits))
    return out, valid


@register("json_type", lambda args: string_type(), engines=HOST_ONLY, arity=1)
def _json_type(xp, args, ctx):
    import json as _json

    strs, _ = _decode_strs(ctx, 0)
    names = {dict: b"OBJECT", list: b"ARRAY", str: b"STRING", bool: b"BOOLEAN", int: b"INTEGER", float: b"DOUBLE", type(None): b"NULL"}
    out = []
    for s in strs:
        if s is None:
            out.append(None)
            continue
        try:
            out.append(names.get(type(_json.loads(s)), b"UNKNOWN"))
        except Exception:
            out.append(None)
    return _encode_strs(ctx, out)


# ---------------------------------------------------------------------------
# everyday date/time surface (ref: builtin_time*.go). Pure integer calendar
# math stays device-legal; string formatting is host-only.
# ---------------------------------------------------------------------------


def _days_from_civil(xp, y, m, d):
    """Inverse of _civil_from_days (Howard Hinnant's civil_from_days).
    int32 math — see _civil_from_days for why."""
    y = astype(xp, xp.asarray(y), xp.int32) - astype(xp, xp.asarray(m <= 2), xp.int32)
    era = xp.where(y >= 0, y, y - 399) // 400
    yoe = y - era * 400
    mp = astype(xp, xp.asarray(m), xp.int32) + xp.where(m > 2, -3, 9)
    doy = (153 * mp + 2) // 5 + astype(xp, xp.asarray(d), xp.int32) - 1
    doe = yoe * 365 + yoe // 4 - yoe // 100 + doy
    return era * 146097 + doe - 719468


def _to_days_any(xp, ctx, i):
    (d, v) = ctx.args[i]
    if ctx.arg_types[i].kind == TypeKind.DATETIME:
        d = d // 86_400_000_000
    return d, v


@register("datediff", lambda args: bigint_type())
def _datediff(xp, args, ctx):
    da, va = _to_days_any(xp, ctx, 0)
    db, vb = _to_days_any(xp, ctx, 1)
    return da - db, and_valid(xp, va, vb)


@register("to_days", lambda args: bigint_type(), arity=1)
def _to_days(xp, args, ctx):
    d, v = _to_days_any(xp, ctx, 0)
    return d + 719528, v  # MySQL day 0 = year 0000-01-01 (proleptic)


@register("dayofyear", lambda args: bigint_type(), arity=1)
def _dayofyear(xp, args, ctx):
    d, v = _to_days_any(xp, ctx, 0)
    y, _, _ = _civil_from_days(xp, d)
    jan1 = _days_from_civil(xp, y, 1 + 0 * y, 1 + 0 * y)
    return d - jan1 + 1, v


@register("weekday", lambda args: bigint_type(), arity=1)
def _weekday(xp, args, ctx):
    d, v = _to_days_any(xp, ctx, 0)
    # 1970-01-01 is a Thursday; MySQL WEEKDAY: 0=Monday
    return (d + 3) % 7, v


def _iso_week(xp, d):
    """ISO 8601 week number (MySQL WEEK mode 3): Monday start, week 1 is the
    week containing the year's first Thursday."""
    dow = (d + 3) % 7  # 0=Monday
    thursday = d - dow + 3
    ty, _, _ = _civil_from_days(xp, thursday)
    jan1 = _days_from_civil(xp, ty, 1 + 0 * ty, 1 + 0 * ty)
    return (thursday - jan1) // 7 + 1


def _calc_week(xp, d, mode: int):
    """MySQL calc_week over epoch-day vectors (ref: sql/time.cc calc_week /
    TiDB types/mytime.go calcWeek), all 8 modes. Returns (week, week_year).

    Mode bits: 1 = Monday-first, 2 = week-year rendering (early January can
    be week 52/53 of the previous year instead of 0), 4 = "week 1 is the
    first week with the start day in it" (vs the ≥4-days rule); per MySQL's
    week_mode(), Sunday-first modes flip bit 4."""
    mf = bool(mode & 1)
    wy0 = bool(mode & 2)
    fw = bool(mode & 4)
    if not mf:
        fw = not fw
    one = 1 + 0 * d
    y, _, _ = _civil_from_days(xp, d)
    jan1 = _days_from_civil(xp, y, one, one)
    wd = (jan1 + (3 if mf else 4)) % 7  # weekday of Jan 1, 0 = week-start day
    early = (d - jan1) < (7 - wd)  # before the year's first full week
    week0 = (wd != 0) if fw else (wd >= 4)
    # days that don't render week 0 borrow the previous year's numbering
    pjan1 = _days_from_civil(xp, y - 1, one, one)
    pwd = (wd + 53 * 7 - (jan1 - pjan1)) % 7
    borrow = early & (True if wy0 else ~week0)
    y_e = xp.where(borrow, y - 1, y)
    jan1_e = xp.where(borrow, pjan1, jan1)
    wd_e = xp.where(borrow, pwd, wd)
    week0_e = (wd_e != 0) if fw else (wd_e >= 4)
    start = xp.where(week0_e, jan1_e + (7 - wd_e), jan1_e - wd_e)
    days = d - start
    week = days // 7 + 1
    # 53-week wrap: a final partial week whose next-year Jan 1 starts a
    # "week 1" renders as next year's week 1 under week-year modes
    wy_eff = borrow | wy0
    diy = _days_from_civil(xp, y_e + 1, one, one) - jan1_e
    wd2 = (wd_e + diy) % 7
    wrap = wy_eff & (days >= 52 * 7) & ((wd2 == 0) if fw else (wd2 < 4))
    week = xp.where(wrap, 1, week)
    wyear = xp.where(wrap, y_e + 1, y_e)
    week = xp.where(early & ~borrow, 0, week)
    return week, wyear


@register("week", lambda args: bigint_type(), variadic=True, arity=1)
def _week(xp, args, ctx):
    """WEEK(date[, mode]) — all 8 MySQL modes via _calc_week. A constant
    mode evaluates once; a per-row mode column selects among the 8 variants
    with where-masks (branch-free, so the tree stays jit-traceable)."""
    d, v = _to_days_any(xp, ctx, 0)
    if len(args) <= 1:
        return _calc_week(xp, d, 0)[0], v
    m0, mv = args[1]
    if not hasattr(m0, "__len__"):
        return _calc_week(xp, d, int(m0) & 7)[0], and_valid(xp, v, mv)
    m = xp.asarray(m0) % 8
    out = 0 * d
    for mode in range(8):
        out = xp.where(m == mode, _calc_week(xp, d, mode)[0], out)
    return out, and_valid(xp, v, mv)


@register("weekofyear", lambda args: bigint_type(), arity=1)
def _weekofyear(xp, args, ctx):
    """WEEKOFYEAR = WEEK(date, 3) — the ISO week number."""
    d, v = _to_days_any(xp, ctx, 0)
    return _iso_week(xp, d), v


@register("last_day", lambda args: args[0], arity=1)
def _last_day(xp, args, ctx):
    d, v = _to_days_any(xp, ctx, 0)
    y, m, _ = _civil_from_days(xp, d)
    ny = xp.where(m == 12, y + 1, y)
    nm = xp.where(m == 12, 1, m + 1)
    out = _days_from_civil(xp, ny, nm, 1 + 0 * ny) - 1
    if ctx.arg_types[0].kind == TypeKind.DATETIME:
        out = out * 86_400_000_000
    return out, v


@register("date", lambda args: FieldType(TypeKind.DATE, nullable=args[0].nullable), arity=1)
def _date(xp, args, ctx):
    d, v = _to_days_any(xp, ctx, 0)
    return d, v


def _cast_temporal(xp, args, ctx, want_date: bool):
    """CAST(x AS DATE/DATETIME): numeric temporals convert arithmetically;
    strings parse on host with NULL + warning 1292 per bad row (ref:
    types.Context truncation warnings, builtin_cast date paths)."""
    import numpy as np

    kind = ctx.arg_types[0].kind
    unit = 86_400_000_000
    if kind == TypeKind.DATE:
        (d, v) = args[0]
        return (d, v) if want_date else (d * unit, v)
    if kind == TypeKind.DATETIME:
        (d, v) = args[0]
        return (d // unit, v) if want_date else (d, v)
    from tidb_tpu_torch.types.datum import date_to_days, datetime_to_micros

    if kind == TypeKind.STRING:
        strs, _ = _decode_strs(ctx, 0)
    else:  # MySQL numeric literal dates: 20240105 / 20240105093000
        (d, v) = args[0]
        n = len(d) if hasattr(d, "__len__") else ctx.n
        ok = v is None or v is True
        # DECIMAL physicals are scaled ints — recover the integer part
        div = 10 ** ctx.arg_types[0].scale if kind == TypeKind.DECIMAL else 1
        strs = [
            (str(int(d if not hasattr(d, "__len__") else d[k]) // div).encode()
             if (ok or (v if isinstance(v, bool) else v[k])) else None)
            for k in range(n)
        ]
    warn = getattr(ctx, "warn", None)
    data = np.zeros(len(strs), dtype=np.int64)
    valid = np.ones(len(strs), dtype=bool)
    for k, s in enumerate(strs):
        if s is None:
            valid[k] = False
            continue
        txt = s.decode("utf-8", "surrogateescape").strip()
        try:
            if len(txt) == 8 and txt.isdigit():
                txt = f"{txt[:4]}-{txt[4:6]}-{txt[6:]}"
            elif len(txt) == 14 and txt.isdigit():
                txt = f"{txt[:4]}-{txt[4:6]}-{txt[6:8]} {txt[8:10]}:{txt[10:12]}:{txt[12:]}"
            has_time = ":" in txt or " " in txt or "T" in txt[10:11]
            if has_time:
                us = datetime_to_micros(txt.replace("T", " ", 1))
                data[k] = us // unit if want_date else us
            else:
                days = date_to_days(txt)
                data[k] = days if want_date else days * unit
        except Exception:
            valid[k] = False
            if warn is not None:
                tn = "date" if want_date else "datetime"
                warn("Warning", 1292, f"Incorrect {tn} value: '{txt}'")
    return data, valid


@register("cast_date", lambda args: FieldType(TypeKind.DATE, nullable=True), arity=1, engines=HOST_ONLY)
def _cast_date(xp, args, ctx):
    return _cast_temporal(xp, args, ctx, want_date=True)


@register("cast_datetime", lambda args: FieldType(TypeKind.DATETIME, nullable=True), arity=1, engines=HOST_ONLY)
def _cast_datetime(xp, args, ctx):
    return _cast_temporal(xp, args, ctx, want_date=False)


@register("unix_timestamp", lambda args: bigint_type(), arity=1)
def _unix_timestamp(xp, args, ctx):
    (d, v) = args[0]
    if ctx.arg_types[0].kind == TypeKind.DATE:
        return d * 86_400, v
    return d // 1_000_000, v


@register("from_unixtime", lambda args: FieldType(TypeKind.DATETIME, nullable=args[0].nullable), arity=1)
def _from_unixtime(xp, args, ctx):
    (d, v) = args[0]
    return d * 1_000_000, v


@register("time_to_sec", lambda args: bigint_type(), arity=1)
def _time_to_sec(xp, args, ctx):
    (d, v) = args[0]
    return xp.sign(d) * (xp.abs(d) // 1_000_000), v


@register("sec_to_time", lambda args: FieldType(TypeKind.DURATION, nullable=args[0].nullable), arity=1)
def _sec_to_time(xp, args, ctx):
    (d, v) = args[0]
    return d * 1_000_000, v


@register("maketime", lambda args: FieldType(TypeKind.DURATION), variadic=True, arity=3)
def _maketime(xp, args, ctx):
    (h, vh), (m, vm), (s, vs) = args
    us = (xp.abs(h) * 3600 + m * 60 + s) * 1_000_000
    return xp.where(h < 0, -us, us), and_valid(xp, vh, vm, vs)


# -- scalar bit operators (ref: builtin_op.go bit builtins; MySQL returns
# BIGINT UNSIGNED — the UINT kind renders wrapped int64 physicals unsigned) --


def _uint_ft(args):
    return FieldType(TypeKind.UINT, nullable=any(a.nullable for a in args))


@register("bitand", _uint_ft, arity=2)
def _bitand(xp, args, ctx):
    (da, va), (db, vb) = args
    return astype(xp, xp.asarray(da), xp.int64) & astype(xp, xp.asarray(db), xp.int64), and_valid(xp, va, vb)


@register("bitor", _uint_ft, arity=2)
def _bitor(xp, args, ctx):
    (da, va), (db, vb) = args
    return astype(xp, xp.asarray(da), xp.int64) | astype(xp, xp.asarray(db), xp.int64), and_valid(xp, va, vb)


@register("bitxor", _uint_ft, arity=2)
def _bitxor(xp, args, ctx):
    (da, va), (db, vb) = args
    return astype(xp, xp.asarray(da), xp.int64) ^ astype(xp, xp.asarray(db), xp.int64), and_valid(xp, va, vb)


@register("bitneg", _uint_ft, arity=1)
def _bitneg(xp, args, ctx):
    (d, v) = args[0]
    return ~astype(xp, xp.asarray(d), xp.int64), v


def _shift(xp, da, db, left: bool):
    a = astype(xp, xp.asarray(da), xp.int64)
    b = astype(xp, xp.asarray(db), xp.int64)
    safe = xp.clip(b, 0, 63)
    out = (a << safe) if left else logical_shr(xp, a, safe)
    # MySQL: shifts outside [0, 64) yield 0 (operands are 64-bit unsigned)
    return xp.where((b < 0) | (b >= 64), 0, out)


@register("shl", _uint_ft, arity=2)
def _shl(xp, args, ctx):
    (da, va), (db, vb) = args
    return _shift(xp, da, db, True), and_valid(xp, va, vb)


@register("shr", _uint_ft, arity=2)
def _shr(xp, args, ctx):
    (da, va), (db, vb) = args
    return _shift(xp, da, db, False), and_valid(xp, va, vb)


_DATETIME_LIKE = (TypeKind.DATETIME, TypeKind.DATE)


def _temporal_micros(xp, ctx, i, args):
    """Physical value of temporal arg ``i`` in microseconds (DATE days →
    epoch micros); None when the kind has no microsecond form."""
    d, v = args[i]
    k = ctx.arg_types[i].kind
    if k == TypeKind.DATE:
        return d * 86_400_000_000, v
    if k in (TypeKind.DATETIME, TypeKind.DURATION):
        return d, v
    return None


def _addtime_ft(args):
    # a DATE first operand is promoted to DATETIME (day 0:00 + the duration)
    if args[0].kind == TypeKind.DATE:
        return FieldType(TypeKind.DATETIME, nullable=True)
    return args[0]


@register("addtime", _addtime_ft)
def _addtime(xp, args, ctx):
    # second operand must be a TIME: mixed kinds (datetime + datetime) are
    # NULL, like the reference's type check (ref: builtin_time.go AddTime)
    if ctx.arg_types[1].kind in _DATETIME_LIKE:
        return args[0][0] * 0, False
    a = _temporal_micros(xp, ctx, 0, args)
    if a is None:
        return args[0][0] * 0, False
    da, va = a
    db, vb = args[1]
    return da + db, and_valid(xp, va, vb)


@register("subtime", _addtime_ft)
def _subtime(xp, args, ctx):
    if ctx.arg_types[1].kind in _DATETIME_LIKE:
        return args[0][0] * 0, False
    a = _temporal_micros(xp, ctx, 0, args)
    if a is None:
        return args[0][0] * 0, False
    da, va = a
    db, vb = args[1]
    return da - db, and_valid(xp, va, vb)


@register("timediff", lambda args: FieldType(TypeKind.DURATION), arity=2)
def _timediff(xp, args, ctx):
    # MySQL returns NULL when the operand kinds differ (time vs datetime):
    # the physicals live in different epochs, so subtraction is meaningless
    # (ref: builtin_time.go TimeDiff type check)
    ka, kb = ctx.arg_types[0].kind, ctx.arg_types[1].kind
    a_dt, b_dt = ka in _DATETIME_LIKE, kb in _DATETIME_LIKE
    if a_dt != b_dt:
        return args[0][0] * 0, False
    a = _temporal_micros(xp, ctx, 0, args)
    b = _temporal_micros(xp, ctx, 1, args)
    if a is None or b is None:
        return args[0][0] * 0, False
    da, va = a
    db, vb = b
    return da - db, and_valid(xp, va, vb)


_MONTH_NAMES = [b"January", b"February", b"March", b"April", b"May", b"June", b"July",
                b"August", b"September", b"October", b"November", b"December"]
_DAY_NAMES = [b"Monday", b"Tuesday", b"Wednesday", b"Thursday", b"Friday", b"Saturday", b"Sunday"]


def _py_civil(days: int):
    from tidb_tpu_torch.types.datum import days_to_date

    return days_to_date(days)


@register("monthname", lambda args: string_type(), engines=HOST_ONLY, arity=1)
def _monthname(xp, args, ctx):
    d, v = _to_days_any(xp, ctx, 0)
    out = []
    n = len(d) if hasattr(d, "__len__") else ctx.n
    for k in range(n):
        ok = v is None or v is True or (v if isinstance(v, bool) else v[k])
        out.append(_MONTH_NAMES[_py_civil(int(d if not hasattr(d, "__len__") else d[k])).month - 1] if ok else None)
    return _encode_strs(ctx, out)


@register("dayname", lambda args: string_type(), engines=HOST_ONLY, arity=1)
def _dayname(xp, args, ctx):
    d, v = _to_days_any(xp, ctx, 0)
    out = []
    n = len(d) if hasattr(d, "__len__") else ctx.n
    for k in range(n):
        ok = v is None or v is True or (v if isinstance(v, bool) else v[k])
        out.append(_DAY_NAMES[_py_civil(int(d if not hasattr(d, "__len__") else d[k])).weekday()] if ok else None)
    return _encode_strs(ctx, out)


def _format_one(dt, fmt: bytes) -> bytes:
    """MySQL DATE_FORMAT specifiers over a python datetime."""
    out = []
    i = 0
    s = fmt.decode("utf-8", "surrogateescape")
    H = dt.hour
    h12 = H % 12 or 12
    while i < len(s):
        c = s[i]
        if c != "%" or i + 1 >= len(s):
            out.append(c)
            i += 1
            continue
        sp = s[i + 1]
        i += 2
        if sp == "Y":
            out.append(f"{dt.year:04d}")
        elif sp == "y":
            out.append(f"{dt.year % 100:02d}")
        elif sp == "m":
            out.append(f"{dt.month:02d}")
        elif sp == "c":
            out.append(str(dt.month))
        elif sp == "d":
            out.append(f"{dt.day:02d}")
        elif sp == "e":
            out.append(str(dt.day))
        elif sp == "H":
            out.append(f"{H:02d}")
        elif sp == "k":
            out.append(str(H))
        elif sp == "h" or sp == "I":
            out.append(f"{h12:02d}")
        elif sp == "l":
            out.append(str(h12))
        elif sp == "i":
            out.append(f"{dt.minute:02d}")
        elif sp == "s" or sp == "S":
            out.append(f"{dt.second:02d}")
        elif sp == "f":
            out.append(f"{dt.microsecond:06d}")
        elif sp == "p":
            out.append("AM" if H < 12 else "PM")
        elif sp == "M":
            out.append(_MONTH_NAMES[dt.month - 1].decode())
        elif sp == "b":
            out.append(_MONTH_NAMES[dt.month - 1].decode()[:3])
        elif sp == "W":
            out.append(_DAY_NAMES[dt.weekday()].decode())
        elif sp == "a":
            out.append(_DAY_NAMES[dt.weekday()].decode()[:3])
        elif sp == "j":
            out.append(f"{dt.timetuple().tm_yday:03d}")
        elif sp == "r":
            out.append(f"{h12:02d}:{dt.minute:02d}:{dt.second:02d} {'AM' if H < 12 else 'PM'}")
        elif sp == "T":
            out.append(f"{H:02d}:{dt.minute:02d}:{dt.second:02d}")
        elif sp == "D":
            d = dt.day
            suf = "th" if 11 <= d % 100 <= 13 else {1: "st", 2: "nd", 3: "rd"}.get(d % 10, "th")
            out.append(f"{d}{suf}")
        elif sp == "%":
            out.append("%")
        else:
            out.append(sp)
    return "".join(out).encode()


@register("date_format", lambda args: string_type(), engines=HOST_ONLY)
def _date_format(xp, args, ctx):
    from tidb_tpu_torch.types.datum import days_to_date, micros_to_datetime
    import datetime as _dt

    (d, v) = args[0]
    fmts, _ = _decode_strs(ctx, 1)
    is_dt = ctx.arg_types[0].kind == TypeKind.DATETIME
    out = []
    n = len(d) if hasattr(d, "__len__") else ctx.n
    for k in range(n):
        ok = v is None or v is True or (v if isinstance(v, bool) else v[k])
        fmt = fmts[k if len(fmts) > 1 else 0]
        if not ok or fmt is None:
            out.append(None)
            continue
        x = int(d if not hasattr(d, "__len__") else d[k])
        dt = micros_to_datetime(x) if is_dt else _dt.datetime.combine(days_to_date(x), _dt.time())
        out.append(_format_one(dt, fmt))
    return _encode_strs(ctx, out)


_STR_TO_DATE_PAT = {
    "Y": r"(?P<Y>\d{4})", "y": r"(?P<y>\d{1,2})", "m": r"(?P<m>\d{1,2})",
    "c": r"(?P<m>\d{1,2})", "d": r"(?P<d>\d{1,2})", "e": r"(?P<d>\d{1,2})",
    "H": r"(?P<H>\d{1,2})", "k": r"(?P<H>\d{1,2})", "h": r"(?P<I>\d{1,2})",
    "l": r"(?P<I>\d{1,2})", "i": r"(?P<M>\d{1,2})", "s": r"(?P<S>\d{1,2})",
    "S": r"(?P<S>\d{1,2})", "f": r"(?P<f>\d{1,6})", "p": r"(?P<p>[AP]M)",
    "M": r"(?P<Mn>[A-Za-z]+)", "b": r"(?P<Mb>[A-Za-z]{3})", "j": r"(?P<j>\d{1,3})",
}


def str_to_date_has_time(fmt: str) -> bool:
    i = 0
    while i < len(fmt) - 1:
        if fmt[i] == "%" and fmt[i + 1] in "HkhlisSfprT":
            return True
        i += 2 if fmt[i] == "%" else 1
    return False


@register("str_to_date", lambda args: FieldType(TypeKind.DATETIME, nullable=True), engines=HOST_ONLY)
def _str_to_date(xp, args, ctx):
    import re
    import datetime as _dt

    from tidb_tpu_torch.types.datum import date_to_days, datetime_to_micros

    strs, _ = _decode_strs(ctx, 0)
    fmts, _ = _decode_strs(ctx, 1)
    want_date = ctx.ret_type.kind == TypeKind.DATE
    import numpy as np

    data = np.zeros(len(strs), dtype=np.int64)
    valid = np.ones(len(strs), dtype=bool)
    pat_cache: dict = {}
    for k, s in enumerate(strs):
        fmt = fmts[k if len(fmts) > 1 else 0]
        if s is None or fmt is None:
            valid[k] = False
            continue
        f = fmt.decode("utf-8", "surrogateescape")
        rx = pat_cache.get(f)
        if rx is None:
            parts = []
            i = 0
            while i < len(f):
                if f[i] == "%" and i + 1 < len(f):
                    sp = f[i + 1]
                    if sp == "T":
                        parts.append(r"(?P<H>\d{1,2}):(?P<M>\d{1,2}):(?P<S>\d{1,2})")
                    elif sp == "r":
                        parts.append(r"(?P<I>\d{1,2}):(?P<M>\d{1,2}):(?P<S>\d{1,2}) (?P<p>[AP]M)")
                    elif sp == "%":
                        parts.append("%")
                    else:
                        parts.append(_STR_TO_DATE_PAT.get(sp, re.escape(sp)))
                    i += 2
                else:
                    parts.append(re.escape(f[i]))
                    i += 1
            rx = pat_cache[f] = re.compile("^" + "".join(parts) + r"\s*$")
        m = rx.match(s.decode("utf-8", "surrogateescape").strip())
        if not m:
            valid[k] = False
            continue
        g = m.groupdict()
        try:
            year = int(g.get("Y") or (2000 + int(g["y"]) if g.get("y") and int(g["y"]) < 70 else (1900 + int(g["y"]) if g.get("y") else 2000)))
            month = int(g.get("m") or 0)
            if g.get("Mn"):
                month = [x.decode().lower() for x in _MONTH_NAMES].index(g["Mn"].lower()) + 1
            if g.get("Mb"):
                month = [x.decode().lower()[:3] for x in _MONTH_NAMES].index(g["Mb"].lower()) + 1
            day = int(g.get("d") or 1)
            if g.get("j"):
                dt0 = _dt.date(year, 1, 1) + _dt.timedelta(days=int(g["j"]) - 1)
                month, day = dt0.month, dt0.day
            hour = int(g.get("H") or 0)
            if g.get("I"):
                hour = int(g["I"]) % 12 + (12 if (g.get("p") or "AM") == "PM" else 0)
            minute = int(g.get("M") or 0)
            sec = int(g.get("S") or 0)
            frac = int(((g.get("f") or "0") + "000000")[:6])
            if want_date:
                data[k] = date_to_days(_dt.date(year, month or 1, day))
            else:
                data[k] = datetime_to_micros(_dt.datetime(year, month or 1, day, hour, minute, sec, frac))
        except (ValueError, IndexError):
            valid[k] = False
    return data, valid


# ---------------------------------------------------------------------------
# everyday string surface (host engine; ref builtin_string*.go)
# ---------------------------------------------------------------------------


@register("trim", lambda args: string_type(), engines=HOST_ONLY, variadic=True, arity=1)
def _trim(xp, args, ctx):
    """trim(s[, remstr, mode]) — mode 0=both 1=leading 2=trailing (the parser
    lowers TRIM([BOTH|LEADING|TRAILING] [remstr] FROM s) into this)."""
    strs, _ = _decode_strs(ctx, 0)
    rems = [b" "]
    mode = 0
    if len(args) > 1:
        rems, _ = _decode_strs(ctx, 1)
        if len(args) > 2:
            m0 = args[2][0]
            mode = int(m0 if not hasattr(m0, "__len__") else m0[0])
    out = []
    for i, s in enumerate(strs):
        rem = rems[i if len(rems) > 1 else 0]
        if s is None or rem is None or not rem:
            out.append(None if s is None or rem is None else s)
            continue
        t = s
        if mode in (0, 1):
            while t.startswith(rem):
                t = t[len(rem):]
        if mode in (0, 2):
            while t.endswith(rem):
                t = t[: len(t) - len(rem)]
        out.append(t)
    return _encode_strs(ctx, out)


@register("ltrim", lambda args: string_type(), engines=HOST_ONLY, arity=1)
def _ltrim(xp, args, ctx):
    strs, _ = _decode_strs(ctx, 0)
    return _encode_strs(ctx, [None if s is None else s.lstrip(b" ") for s in strs])


@register("rtrim", lambda args: string_type(), engines=HOST_ONLY, arity=1)
def _rtrim(xp, args, ctx):
    strs, _ = _decode_strs(ctx, 0)
    return _encode_strs(ctx, [None if s is None else s.rstrip(b" ") for s in strs])


@register("replace", lambda args: string_type(), engines=HOST_ONLY, variadic=True, arity=3)
def _replace(xp, args, ctx):
    strs, _ = _decode_strs(ctx, 0)
    froms, _ = _decode_strs(ctx, 1)
    tos, _ = _decode_strs(ctx, 2)
    out = []
    for i, s in enumerate(strs):
        f = froms[i if len(froms) > 1 else 0]
        t = tos[i if len(tos) > 1 else 0]
        if s is None or f is None or t is None:
            out.append(None)
        elif not f:
            out.append(s)
        else:
            out.append(s.replace(f, t))
    return _encode_strs(ctx, out)


@register("locate", lambda args: bigint_type(), engines=HOST_ONLY, variadic=True, arity=2)
def _locate(xp, args, ctx):
    """LOCATE(substr, str[, pos]) — 1-based, 0 when absent."""
    import numpy as np

    subs, _ = _decode_strs(ctx, 0)
    strs, _ = _decode_strs(ctx, 1)
    n = max(len(subs), len(strs))
    poss = _int_args(args, 2, n) if len(args) > 2 else [1] * n
    data = np.zeros(n, dtype=np.int64)
    valid = np.ones(n, dtype=bool)
    for i in range(n):
        sub = subs[i if len(subs) > 1 else 0]
        s = strs[i if len(strs) > 1 else 0]
        pos = poss[i if len(poss) > 1 else 0]
        if sub is None or s is None or pos is None:
            valid[i] = False
        elif pos < 1:
            data[i] = 0
        else:
            data[i] = s.find(sub, pos - 1) + 1
    return data, valid


@register("instr", lambda args: bigint_type(), engines=HOST_ONLY)
def _instr(xp, args, ctx):
    import numpy as np

    strs, _ = _decode_strs(ctx, 0)
    subs, _ = _decode_strs(ctx, 1)
    n = max(len(subs), len(strs))
    data = np.zeros(n, dtype=np.int64)
    valid = np.ones(n, dtype=bool)
    for i in range(n):
        s = strs[i if len(strs) > 1 else 0]
        sub = subs[i if len(subs) > 1 else 0]
        if sub is None or s is None:
            valid[i] = False
        else:
            data[i] = s.find(sub) + 1
    return data, valid


def _pad(strs, lns, pads, left: bool):
    out = []
    n = max(len(strs), len(lns), len(pads))
    for i in range(n):
        s = strs[i if len(strs) > 1 else 0]
        ln = lns[i if len(lns) > 1 else 0]
        p = pads[i if len(pads) > 1 else 0]
        if s is None or ln is None or p is None or ln < 0:
            out.append(None)
            continue
        ln = int(ln)
        if len(s) >= ln:
            out.append(s[:ln])
            continue
        if not p:
            out.append(None)  # MySQL: empty pad cannot reach the target
            continue
        fill = (p * ((ln - len(s)) // len(p) + 1))[: ln - len(s)]
        out.append(fill + s if left else s + fill)
    return out


def _int_args(args, i, n):
    d, v = args[i]
    out = []
    for k in range(n):
        ok = v is None or v is True or (v if isinstance(v, bool) else (v[k] if hasattr(v, "__len__") else v))
        x = d if not hasattr(d, "__len__") else d[k if len(d) > 1 else 0]
        out.append(int(x) if ok else None)
    return out


@register("lpad", lambda args: string_type(nullable=True), engines=HOST_ONLY, variadic=True, arity=3)
def _lpad(xp, args, ctx):
    strs, _ = _decode_strs(ctx, 0)
    pads, _ = _decode_strs(ctx, 2)
    lns = _int_args(args, 1, max(len(strs), 1))
    return _encode_strs(ctx, _pad(strs, lns, pads, True))


@register("rpad", lambda args: string_type(nullable=True), engines=HOST_ONLY, variadic=True, arity=3)
def _rpad(xp, args, ctx):
    strs, _ = _decode_strs(ctx, 0)
    pads, _ = _decode_strs(ctx, 2)
    lns = _int_args(args, 1, max(len(strs), 1))
    return _encode_strs(ctx, _pad(strs, lns, pads, False))


@register("left", lambda args: string_type(), engines=HOST_ONLY)
def _left(xp, args, ctx):
    strs, _ = _decode_strs(ctx, 0)
    lns = _int_args(args, 1, max(len(strs), 1))
    out = []
    for i, s in enumerate(strs):
        ln = lns[i if len(lns) > 1 else 0]
        out.append(None if s is None or ln is None else (b"" if ln <= 0 else s[:ln]))
    return _encode_strs(ctx, out)


@register("right", lambda args: string_type(), engines=HOST_ONLY)
def _right(xp, args, ctx):
    strs, _ = _decode_strs(ctx, 0)
    lns = _int_args(args, 1, max(len(strs), 1))
    out = []
    for i, s in enumerate(strs):
        ln = lns[i if len(lns) > 1 else 0]
        out.append(None if s is None or ln is None else (b"" if ln <= 0 else s[-ln:]))
    return _encode_strs(ctx, out)


@register("repeat", lambda args: string_type(), engines=HOST_ONLY)
def _repeat(xp, args, ctx):
    strs, _ = _decode_strs(ctx, 0)
    lns = _int_args(args, 1, max(len(strs), 1))
    out = []
    for i, s in enumerate(strs):
        ln = lns[i if len(lns) > 1 else 0]
        out.append(None if s is None or ln is None else s * max(ln, 0))
    return _encode_strs(ctx, out)


@register("reverse", lambda args: string_type(), engines=HOST_ONLY, arity=1)
def _reverse(xp, args, ctx):
    strs, _ = _decode_strs(ctx, 0)
    out = []
    for s in strs:
        out.append(None if s is None else s.decode("utf-8", "surrogateescape")[::-1].encode("utf-8", "surrogateescape"))
    return _encode_strs(ctx, out)


@register("ascii", lambda args: bigint_type(), engines=HOST_ONLY, arity=1)
def _ascii(xp, args, ctx):
    import numpy as np

    strs, v = _decode_strs(ctx, 0)
    return np.array([0 if not s else s[0] for s in [x or b"" for x in strs]], dtype=np.int64), v


@register("strcmp", lambda args: bigint_type(), engines=HOST_ONLY)
def _strcmp(xp, args, ctx):
    import numpy as np

    a, _ = _decode_strs(ctx, 0)
    b, _ = _decode_strs(ctx, 1)
    n = max(len(a), len(b))
    data = np.zeros(n, dtype=np.int64)
    valid = np.ones(n, dtype=bool)
    for i in range(n):
        x = a[i if len(a) > 1 else 0]
        y = b[i if len(b) > 1 else 0]
        if x is None or y is None:
            valid[i] = False
        else:
            data[i] = -1 if x < y else (1 if x > y else 0)
    return data, valid


@register("concat_ws", lambda args: string_type(), engines=HOST_ONLY, variadic=True, arity=2)
def _concat_ws(xp, args, ctx):
    seps, _ = _decode_strs(ctx, 0)
    cols = [_decode_strs(ctx, i)[0] for i in range(1, len(args))]
    n = max(len(c) for c in cols) if cols else len(seps)
    out = []
    for i in range(n):
        sep = seps[i if len(seps) > 1 else 0]
        if sep is None:
            out.append(None)
            continue
        parts = [c[i if len(c) > 1 else 0] for c in cols]
        out.append(sep.join(p for p in parts if p is not None))
    return _encode_strs(ctx, out)


# ---------------------------------------------------------------------------
# trig / angular math (ref: builtin_math.go) — pure elementwise, device-legal
# ---------------------------------------------------------------------------


@register("sin", infer_double, arity=1)
def _sin(xp, args, ctx):
    (d, v) = args[0]
    return xp.sin(to_f64(xp, d)), v


@register("cos", infer_double, arity=1)
def _cos(xp, args, ctx):
    (d, v) = args[0]
    return xp.cos(to_f64(xp, d)), v


@register("tan", infer_double, arity=1)
def _tan(xp, args, ctx):
    (d, v) = args[0]
    return xp.tan(to_f64(xp, d)), v


@register("cot", infer_double, arity=1)
def _cot(xp, args, ctx):
    (d, v) = args[0]
    t = xp.tan(to_f64(xp, d))
    ok = t != 0
    return xp.where(ok, 1.0 / xp.where(ok, t, 1.0), 0.0), and_valid(xp, v, ok)


@register("asin", infer_double, arity=1)
def _asin(xp, args, ctx):
    (d, v) = args[0]
    d = to_f64(xp, d)
    ok = (d >= -1) & (d <= 1)
    return xp.arcsin(xp.where(ok, d, 0.0)), and_valid(xp, v, ok)


@register("acos", infer_double, arity=1)
def _acos(xp, args, ctx):
    (d, v) = args[0]
    d = to_f64(xp, d)
    ok = (d >= -1) & (d <= 1)
    return xp.arccos(xp.where(ok, d, 0.0)), and_valid(xp, v, ok)


@register("atan", infer_double, variadic=True, arity=1)
def _atan(xp, args, ctx):
    (d, v) = args[0]
    if len(args) == 1:
        return xp.arctan(to_f64(xp, d)), v
    (d2, v2) = args[1]  # ATAN(y, x) == ATAN2(y, x)
    return xp.arctan2(to_f64(xp, d), to_f64(xp, d2)), and_valid(xp, v, v2)


@register("atan2", infer_double)
def _atan2(xp, args, ctx):
    (da, va), (db, vb) = args
    return xp.arctan2(to_f64(xp, da), to_f64(xp, db)), and_valid(xp, va, vb)


@register("degrees", infer_double, arity=1)
def _degrees(xp, args, ctx):
    (d, v) = args[0]
    return to_f64(xp, d) * (180.0 / 3.141592653589793), v


@register("radians", infer_double, arity=1)
def _radians(xp, args, ctx):
    (d, v) = args[0]
    return to_f64(xp, d) * (3.141592653589793 / 180.0), v


@register("crc32", lambda args: FieldType(TypeKind.UINT, nullable=True), engines=HOST_ONLY, arity=1)
def _crc32(xp, args, ctx):
    import zlib

    import numpy as np

    strs, v = _decode_strs(ctx, 0)
    out = np.zeros(len(strs), dtype=np.int64)
    for i, s in enumerate(strs):
        if s is not None:
            out[i] = zlib.crc32(s)
    return out, v


def _digest_fn(algo):
    def impl(xp, args, ctx):
        import hashlib

        strs, _ = _decode_strs(ctx, 0)
        out = []
        for s in strs:
            out.append(None if s is None else hashlib.new(algo, s).hexdigest().encode())
        return _encode_strs(ctx, out)

    return impl


register("md5", lambda args: string_type(), engines=HOST_ONLY, arity=1)(_digest_fn("md5"))
register("sha1", lambda args: string_type(), engines=HOST_ONLY, arity=1)(_digest_fn("sha1"))


@register("sha2", lambda args: string_type(nullable=True), engines=HOST_ONLY)
def _sha2(xp, args, ctx):
    import hashlib

    strs, _ = _decode_strs(ctx, 0)
    lens = _int_args(args, 1, len(strs))
    algos = {0: "sha256", 224: "sha224", 256: "sha256", 384: "sha384", 512: "sha512"}
    out = []
    for i, s in enumerate(strs):
        ln = lens[i if len(lens) > 1 else 0]
        a = algos.get(ln if ln is not None else -1)
        out.append(None if s is None or a is None else hashlib.new(a, s).hexdigest().encode())
    return _encode_strs(ctx, out)


# ---------------------------------------------------------------------------
# radix / byte-wrangling string surface (ref: builtin_string.go)
# ---------------------------------------------------------------------------




def _round_int_args(xp, args, ctx, i, n):
    """_int_args with MySQL numeric semantics: DECIMAL physicals descale and
    FLOATs round half away from zero (HEX(2.5) is the hex of 3, not of the
    scale-1 physical 25)."""
    k = ctx.arg_types[i]
    vals = _int_args(args, i, n)
    if k.kind == TypeKind.DECIMAL and k.scale:
        f = 10**k.scale
        return [None if x is None else (abs(x) + f // 2) // f * (1 if x >= 0 else -1) for x in vals]
    if k.kind == TypeKind.FLOAT:
        d, v = args[i]
        out = []
        for j in range(n):
            ok = v is None or v is True or (v if isinstance(v, bool) else (v[j] if hasattr(v, "__len__") else v))
            x = d if not hasattr(d, "__len__") else d[j if len(d) > 1 else 0]
            out.append(int(float(x) + (0.5 if float(x) >= 0 else -0.5)) if ok else None)
        return out
    return vals


@register("hex", lambda args: string_type(), engines=HOST_ONLY, arity=1)
def _hex(xp, args, ctx):
    if ctx.arg_types[0].kind == TypeKind.STRING:
        strs, _ = _decode_strs(ctx, 0)
        return _encode_strs(ctx, [None if s is None else s.hex().upper().encode() for s in strs])
    d, v = args[0]
    vals = _round_int_args(xp, args, ctx, 0, len(d) if hasattr(d, "__len__") else 1)
    return _encode_strs(ctx, [None if x is None else format(x & (2**64 - 1), "X").encode() for x in vals])


@register("unhex", lambda args: string_type(nullable=True), engines=HOST_ONLY, arity=1)
def _unhex(xp, args, ctx):
    strs, _ = _decode_strs(ctx, 0)
    out = []
    for s in strs:
        if s is None:
            out.append(None)
            continue
        try:
            t = s.decode()
            out.append(bytes.fromhex("0" + t if len(t) % 2 else t))
        except ValueError:
            out.append(None)
    return _encode_strs(ctx, out)


def _radix_fn(base):
    def impl(xp, args, ctx):
        n = len(args[0][0]) if hasattr(args[0][0], "__len__") else 1
        vals = _round_int_args(xp, args, ctx, 0, n)
        fmt = {2: "b", 8: "o", 16: "X"}[base]
        return _encode_strs(
            ctx, [None if x is None else format(x & (2**64 - 1), fmt).encode() for x in vals]
        )

    return impl


register("bin", lambda args: string_type(), engines=HOST_ONLY, arity=1)(_radix_fn(2))
register("oct", lambda args: string_type(), engines=HOST_ONLY, arity=1)(_radix_fn(8))


@register("conv", lambda args: string_type(nullable=True), engines=HOST_ONLY, variadic=True, arity=3)
def _conv(xp, args, ctx):
    """CONV(N, from_base, to_base); bases 2..36, negative to_base → signed."""
    strs, _ = _decode_strs(ctx, 0)
    n = len(strs)
    fbs = _int_args(args, 1, n)
    tbs = _int_args(args, 2, n)
    digits = "0123456789ABCDEFGHIJKLMNOPQRSTUVWXYZ"
    out = []
    for i, s in enumerate(strs):
        fb = fbs[i if len(fbs) > 1 else 0]
        tb = tbs[i if len(tbs) > 1 else 0]
        if s is None or fb is None or tb is None or not (2 <= abs(fb) <= 36 and 2 <= abs(tb) <= 36):
            out.append(None)
            continue
        t = s.decode().strip()
        neg_in = t.startswith("-")
        t = t.lstrip("+-")
        k = 0
        while k < len(t) and digits.find(t[k].upper()) not in (-1,) and digits.index(t[k].upper()) < abs(fb):
            k += 1
        val = int(t[:k], abs(fb)) if k else 0  # longest valid prefix (strtoll)
        if neg_in:
            val = -val
        signed = tb < 0
        if not signed:
            val &= 2**64 - 1
        neg = val < 0
        val = abs(val)
        buf = ""
        while True:
            buf = digits[val % abs(tb)] + buf
            val //= abs(tb)
            if not val:
                break
        out.append((("-" if neg and signed else "") + buf).encode())
    return _encode_strs(ctx, out)


@register("char", lambda args: string_type(nullable=True), engines=HOST_ONLY, variadic=True, arity=1)
def _char_fn(xp, args, ctx):
    """CHAR(n, ...): bytes from integer code points (NULL args skipped)."""
    n = max((len(a[0]) if hasattr(a[0], "__len__") else 1) for a in args)
    cols = [_int_args(args, i, n) for i in range(len(args))]
    out = []
    for i in range(n):
        bs = b""
        for c in cols:
            x = c[i if len(c) > 1 else 0]
            if x is None:
                continue
            x &= 2**32 - 1
            bs += bytes(reversed([(x >> (8 * k)) & 0xFF for k in range(4) if x >> (8 * k)])) or b"\x00"
        out.append(bs)
    return _encode_strs(ctx, out)


@register("ord", lambda args: bigint_type(), engines=HOST_ONLY, arity=1)
def _ord(xp, args, ctx):
    """ORD: leading-byte code, multibyte-aware for UTF-8 heads."""
    import numpy as np

    strs, v = _decode_strs(ctx, 0)
    out = np.zeros(len(strs), dtype=np.int64)
    for i, s in enumerate(strs):
        if not s:
            continue
        nb = 1
        b0 = s[0]
        if b0 >= 0xF0:
            nb = 4
        elif b0 >= 0xE0:
            nb = 3
        elif b0 >= 0xC0:
            nb = 2
        acc = 0
        for b in s[:nb]:
            acc = acc * 256 + b
        out[i] = acc
    return out, v


@register("space", lambda args: string_type(nullable=True), engines=HOST_ONLY, arity=1)
def _space(xp, args, ctx):
    n = len(args[0][0]) if hasattr(args[0][0], "__len__") else 1
    vals = _int_args(args, 0, n)
    return _encode_strs(ctx, [None if x is None or x < 0 else b" " * min(int(x), 1 << 20) for x in vals])


@register("quote", lambda args: string_type(), engines=HOST_ONLY, arity=1)
def _quote(xp, args, ctx):
    strs, _ = _decode_strs(ctx, 0)
    out = []
    for s in strs:
        if s is None:
            out.append(b"NULL")
            continue
        q = s.replace(b"\\", b"\\\\").replace(b"'", b"\\'").replace(b"\x00", b"\\0").replace(b"\x1a", b"\\Z")
        out.append(b"'" + q + b"'")
    return _encode_strs(ctx, out)


@register("soundex", lambda args: string_type(), engines=HOST_ONLY, arity=1)
def _soundex(xp, args, ctx):
    codes = {c: d for cs, d in (("BFPV", "1"), ("CGJKQSXZ", "2"), ("DT", "3"), ("L", "4"), ("MN", "5"), ("R", "6")) for c in cs}
    out = []
    strs, _ = _decode_strs(ctx, 0)
    for s in strs:
        if s is None:
            out.append(None)
            continue
        t = "".join(c for c in s.decode("utf-8", "replace").upper() if c.isalpha())
        if not t:
            out.append(b"")
            continue
        res = t[0]
        prev = codes.get(t[0], "")
        for c in t[1:]:
            d = codes.get(c, "")
            if d and d != prev:
                res += d
            if c not in "HW":  # H/W are transparent for adjacency
                prev = d
        out.append((res + "000")[: max(4, len(res))].encode())
    return _encode_strs(ctx, out)


@register("format", lambda args: string_type(nullable=True), engines=HOST_ONLY, variadic=True, arity=2)
def _format(xp, args, ctx):
    """FORMAT(X, D): thousands separators + D decimals (en_US locale)."""
    d, v = args[0]
    scale = ctx.arg_types[0].scale if ctx.arg_types[0].kind == TypeKind.DECIMAL else None
    n = len(d) if hasattr(d, "__len__") else 1
    decs = _int_args(args, 1, n)
    out = []
    for i in range(n):
        ok = v is None or (v if not hasattr(v, "__len__") else v[i])
        x = d if not hasattr(d, "__len__") else d[i]
        dd = decs[i if len(decs) > 1 else 0]
        if not ok or dd is None:
            out.append(None)
            continue
        from decimal import ROUND_HALF_UP, Decimal

        val = Decimal(int(x)).scaleb(-scale) if scale is not None else Decimal(repr(float(x)))
        dd = max(0, min(int(dd), 30))
        q = val.quantize(Decimal(1).scaleb(-dd), rounding=ROUND_HALF_UP)
        out.append(f"{q:,.{dd}f}".encode())
    return _encode_strs(ctx, out)


@register("find_in_set", lambda args: bigint_type(), engines=HOST_ONLY)
def _find_in_set(xp, args, ctx):
    import numpy as np

    needles, _ = _decode_strs(ctx, 0)
    hays, _ = _decode_strs(ctx, 1)
    n = max(len(needles), len(hays))
    out = np.zeros(n, dtype=np.int64)
    valid = np.ones(n, dtype=bool)
    for i in range(n):
        x = needles[i if len(needles) > 1 else 0]
        h = hays[i if len(hays) > 1 else 0]
        if x is None or h is None:
            valid[i] = False
        elif h:
            parts = h.split(b",")
            out[i] = parts.index(x) + 1 if x in parts else 0
    return out, valid


@register("substring_index", lambda args: string_type(), engines=HOST_ONLY, variadic=True, arity=3)
def _substring_index(xp, args, ctx):
    strs, _ = _decode_strs(ctx, 0)
    delims, _ = _decode_strs(ctx, 1)
    n = max(len(strs), len(delims))
    counts = _int_args(args, 2, n)
    out = []
    for i in range(n):
        s = strs[i if len(strs) > 1 else 0]
        dl = delims[i if len(delims) > 1 else 0]
        c = counts[i if len(counts) > 1 else 0]
        if s is None or dl is None or c is None:
            out.append(None)
        elif not dl or c == 0:
            out.append(b"")
        else:
            parts = s.split(dl)
            out.append(dl.join(parts[:c] if c > 0 else parts[c:]))
    return _encode_strs(ctx, out)


@register("export_set", lambda args: string_type(), engines=HOST_ONLY, variadic=True, arity=5)
def _export_set(xp, args, ctx):
    bits = _int_args(args, 0, len(args[0][0]) if hasattr(args[0][0], "__len__") else 1)
    ons, _ = _decode_strs(ctx, 1)
    offs, _ = _decode_strs(ctx, 2)
    seps = _decode_strs(ctx, 3)[0] if len(args) > 3 else [b","]
    n = max(len(bits), len(ons), len(offs))
    nbits = _int_args(args, 4, n) if len(args) > 4 else [64]
    out = []
    for i in range(n):
        b = bits[i if len(bits) > 1 else 0]
        on = ons[i if len(ons) > 1 else 0]
        off = offs[i if len(offs) > 1 else 0]
        sep = seps[i if len(seps) > 1 else 0]
        nb = nbits[i if len(nbits) > 1 else 0]
        if b is None or on is None or off is None or sep is None or nb is None:
            out.append(None)
            continue
        nb = min(max(int(nb), 0), 64)
        out.append(sep.join(on if (b >> k) & 1 else off for k in range(nb)))
    return _encode_strs(ctx, out)


@register("make_set", lambda args: string_type(nullable=True), engines=HOST_ONLY, variadic=True, arity=2)
def _make_set(xp, args, ctx):
    bits = _int_args(args, 0, len(args[0][0]) if hasattr(args[0][0], "__len__") else 1)
    cols = [_decode_strs(ctx, i)[0] for i in range(1, len(args))]
    out = []
    n = max([len(bits)] + [len(c) for c in cols])
    for i in range(n):
        b = bits[i if len(bits) > 1 else 0]
        if b is None:
            out.append(None)
            continue
        parts = []
        for k, c in enumerate(cols):
            v = c[i if len(c) > 1 else 0]
            if (b >> k) & 1 and v is not None:
                parts.append(v)
        out.append(b",".join(parts))
    return _encode_strs(ctx, out)


@register("inet_aton", lambda args: FieldType(TypeKind.UINT, nullable=True), engines=HOST_ONLY, arity=1)
def _inet_aton(xp, args, ctx):
    import numpy as np

    strs, _ = _decode_strs(ctx, 0)
    out = np.zeros(len(strs), dtype=np.int64)
    valid = np.ones(len(strs), dtype=bool)
    for i, s in enumerate(strs):
        if s is None:
            valid[i] = False
            continue
        parts = s.split(b".")
        try:
            octs = [int(p) for p in parts]
        except ValueError:
            valid[i] = False
            continue
        if not 1 <= len(octs) <= 4 or any(not 0 <= o <= 255 for o in octs):
            valid[i] = False
            continue
        # MySQL: 'a.b' == a<<24 | b (short forms widen the LAST octet)
        acc = 0
        for o in octs[:-1]:
            acc = (acc << 8) | o
        out[i] = (acc << (8 * (4 - len(octs) + 1))) | octs[-1] if len(octs) > 1 else octs[0]
    return out, valid


@register("inet_ntoa", lambda args: string_type(nullable=True), engines=HOST_ONLY, arity=1)
def _inet_ntoa(xp, args, ctx):
    n = len(args[0][0]) if hasattr(args[0][0], "__len__") else 1
    vals = _int_args(args, 0, n)
    out = []
    for x in vals:
        if x is None or not 0 <= x <= 2**32 - 1:
            out.append(None)
        else:
            out.append(".".join(str((x >> s) & 0xFF) for s in (24, 16, 8, 0)).encode())
    return _encode_strs(ctx, out)


# ---------------------------------------------------------------------------
# calendar periods + FROM_DAYS/YEARWEEK/TIMESTAMPDIFF internals
# (ref: builtin_time.go periodAdd/periodDiff/fromDays/yearWeek/timestampDiff)
# ---------------------------------------------------------------------------


def _period_to_months(xp, p):
    y = p // 100
    m = p % 100
    y = xp.where(y < 70, y + 2000, xp.where(y < 100, y + 1900, y))
    return y * 12 + m - 1


@register("period_add", lambda args: bigint_type())
def _period_add(xp, args, ctx):
    (p, vp), (n, vn) = args
    months = _period_to_months(xp, p) + n
    return (months // 12) * 100 + months % 12 + 1, and_valid(xp, vp, vn)


@register("period_diff", lambda args: bigint_type())
def _period_diff(xp, args, ctx):
    (p1, v1), (p2, v2) = args
    return _period_to_months(xp, p1) - _period_to_months(xp, p2), and_valid(xp, v1, v2)


@register("from_days", lambda args: FieldType(TypeKind.DATE, nullable=True), arity=1)
def _from_days(xp, args, ctx):
    (d, v) = args[0]
    days = d - 719528  # MySQL day number → epoch days
    ok = (days >= -719162) & (days <= 2932896)  # year 1..9999
    return xp.where(ok, days, 0), and_valid(xp, v, ok)


@register("yearweek", lambda args: bigint_type(), variadic=True, arity=1)
def _yearweek(xp, args, ctx):
    d, v = _to_days_any(xp, ctx, 0)
    mode = 0
    if len(args) > 1:
        m0, mv = args[1]
        mode = int(m0 if not hasattr(m0, "__len__") else m0[0])
        v = and_valid(xp, v, mv)
    # YEARWEEK uses the week-year-coupled modes (WEEK mode | 2 semantics)
    week, wy = _calc_week(xp, d, mode & 7 | 2)
    return wy * 100 + week, v


@register("tsdiff_micros", lambda args: bigint_type())
def _tsdiff_micros(xp, args, ctx):
    a = _temporal_micros(xp, ctx, 0, args)
    b = _temporal_micros(xp, ctx, 1, args)
    if a is None or b is None:
        raise ValueError("TIMESTAMPDIFF needs temporal operands")
    return b[0] - a[0], and_valid(xp, a[1], b[1])


@register("tsdiff_months", lambda args: bigint_type())
def _tsdiff_months(xp, args, ctx):
    """Whole calendar months from arg0 to arg1, truncated toward zero down
    to microseconds (ref: types/mytime.go monthDiff)."""
    da, va = _to_days_any(xp, ctx, 0)
    db, vb = _to_days_any(xp, ctx, 1)
    y1, m1, d1 = _civil_from_days(xp, da)
    y2, m2, d2 = _civil_from_days(xp, db)
    # intra-month position: day-of-month plus time-of-day (0 for DATEs)
    ua = _temporal_micros(xp, ctx, 0, ctx.args)
    ub = _temporal_micros(xp, ctx, 1, ctx.args)
    day_us = 86_400_000_000
    p1 = astype(xp, d1, "int64") * day_us + (ua[0] % day_us if ua is not None else 0)
    p2 = astype(xp, d2, "int64") * day_us + (ub[0] % day_us if ub is not None else 0)
    months = (astype(xp, y2, "int64") - y1) * 12 + (m2 - m1)
    months = months - astype(xp, (months > 0) & (p2 < p1), "int64") + ((months < 0) & (p2 > p1))
    return months, and_valid(xp, va, vb)
