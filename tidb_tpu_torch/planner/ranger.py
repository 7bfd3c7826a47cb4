"""Index/handle range derivation from pushed-down conditions.

Reference parity: pkg/util/ranger (DetachCondAndBuildRangeForIndex /
BuildTableRange). Given the AND-ed conditions on a scan, split them into
(a) an access condition prefix over an index's columns — longest run of
equality/IN conditions, optionally followed by one range condition on the
next column — encoded into memcomparable index key ranges, and (b) the
remaining filter conditions. The same datum encoding as
executor/write.index_entry keeps scan ranges and stored entries aligned.
"""

from __future__ import annotations

from dataclasses import dataclass
from decimal import Decimal
from typing import Optional

from tidb_tpu_torch.catalog.schema import IndexInfo, TableInfo
from tidb_tpu_torch.expression.expr import ColumnRef, Constant, Expression, ScalarFunc
from tidb_tpu_torch.kv import tablecodec
from tidb_tpu_torch.kv.kv import KeyRange
from tidb_tpu_torch.types import TypeKind
from tidb_tpu_torch.utils import codec

_INT_KINDS = (TypeKind.INT, TypeKind.UINT, TypeKind.DATE, TypeKind.DATETIME, TypeKind.DECIMAL, TypeKind.DURATION)

_SWAP = {"lt": "gt", "le": "ge", "gt": "lt", "ge": "le", "eq": "eq"}


def prefix_next(key: bytes) -> bytes:
    """Smallest byte string greater than every string prefixed by ``key``
    (ref: kv.Key.PrefixNext)."""
    b = bytearray(key)
    for i in range(len(b) - 1, -1, -1):
        if b[i] != 0xFF:
            b[i] += 1
            return bytes(b[: i + 1])
    return key + b"\xff" * 9  # all-0xFF: unreachable for flagged datums


@dataclass
class ColBound:
    """Integer/raw bound set for one column: None = unbounded."""

    eq: Optional[list] = None  # list of point values (IN / eq)
    lo: Optional[object] = None  # inclusive low
    hi: Optional[object] = None  # inclusive high
    empty: bool = False


def _as_rational(v) -> Decimal:
    if isinstance(v, Decimal):
        return v
    if isinstance(v, float):
        return Decimal(str(v))
    return Decimal(int(v))


def _int_bound(v, scale: int, side: str) -> Optional[int]:
    """Convert a constant to an integer bound on a 10**scale-scaled column.
    side: 'lo' → ceil, 'hi' → floor, 'eq' → exact or None."""
    r = _as_rational(v) * (10**scale)
    i = int(r)
    if r == i:
        return i
    if side == "eq":
        return None
    if side == "lo":
        return i + 1 if r > 0 else i  # ceil for non-integral
    return i if r > 0 else i - 1  # floor


def _wrap_uint(iv: int, ftype) -> Optional[int]:
    """UNSIGNED columns store values wrapped to signed int64 (see
    executor/write.to_physical); apply the same wrap to point constants.
    Returns None when the value is outside the uint64 domain."""
    if ftype.kind != TypeKind.UINT:
        return iv
    if iv < 0 or iv >= 1 << 64:
        return None
    return iv - (1 << 64) if iv >= 1 << 63 else iv


def _phys_const(v, ftype):
    """Logical constant → physical storage value for key encoding."""
    k = ftype.kind
    if k == TypeKind.STRING:
        if isinstance(v, str):
            return v.encode("utf-8")
        if isinstance(v, bytes):
            return v
        return str(v).encode("utf-8")
    if k == TypeKind.FLOAT:
        return float(v)
    return v  # int-backed kinds handled by _int_bound


def _encode_datum(v, ftype) -> bytes:
    k = ftype.kind
    if v is None:
        return codec.encode_key_nil()
    if k == TypeKind.STRING:
        return codec.encode_key_bytes(_phys_const(v, ftype))
    if k == TypeKind.FLOAT:
        return codec.encode_key_float(float(v))
    return codec.encode_key_int(int(v))


def _extract_col_conds(conds: list[Expression], col_idx: int, ftype) -> tuple[ColBound, list[Expression]]:
    """Collect eq/in/cmp conditions on schema position col_idx.
    Returns (bound, used_conditions)."""
    b = ColBound()
    used: list[Expression] = []
    scale = ftype.scale if ftype.kind == TypeKind.DECIMAL else 0
    int_backed = ftype.kind in _INT_KINDS

    def tighten_lo(v, inclusive: bool):
        if int_backed:
            iv = _int_bound(v, scale, "lo")
            if not inclusive:
                ivx = _int_bound(v, scale, "eq")
                iv = ivx + 1 if ivx is not None else iv
            b.lo = iv if b.lo is None else max(b.lo, iv)
        else:
            pv = _phys_const(v, ftype)
            cur = (pv, inclusive)
            if b.lo is None or cur[0] > b.lo[0] or (cur[0] == b.lo[0] and not inclusive):
                b.lo = cur

    def tighten_hi(v, inclusive: bool):
        if int_backed:
            iv = _int_bound(v, scale, "hi")
            if not inclusive:
                ivx = _int_bound(v, scale, "eq")
                iv = ivx - 1 if ivx is not None else iv
            b.hi = iv if b.hi is None else min(b.hi, iv)
        else:
            pv = _phys_const(v, ftype)
            cur = (pv, inclusive)
            if b.hi is None or cur[0] < b.hi[0] or (cur[0] == b.hi[0] and not inclusive):
                b.hi = cur

    for c in conds:
        if not isinstance(c, ScalarFunc):
            continue
        if c.sig == "in":
            op = c.args[0]
            if isinstance(op, ColumnRef) and op.index == col_idx and all(
                isinstance(a, Constant) and a.value is not None for a in c.args[1:]
            ):
                pts = []
                for a in c.args[1:]:
                    if int_backed:
                        iv = _int_bound(a.value, scale, "eq")
                        if iv is None:
                            continue  # non-representable point matches nothing
                        iv = _wrap_uint(iv, ftype)
                        if iv is None:
                            continue  # out of the uint64 domain
                        pts.append(iv)
                    else:
                        pts.append(_phys_const(a.value, ftype))
                pts = sorted(set(pts))
                b.eq = pts if b.eq is None else sorted(set(b.eq) & set(pts))
                used.append(c)
            continue
        if c.sig not in ("eq", "lt", "le", "gt", "ge"):
            continue
        a0, a1 = c.args
        sig = c.sig
        if isinstance(a1, ColumnRef) and isinstance(a0, Constant):
            a0, a1 = a1, a0
            sig = _SWAP[sig]
        if not (isinstance(a0, ColumnRef) and a0.index == col_idx and isinstance(a1, Constant)):
            continue
        v = a1.value
        if v is None:
            b.empty = True  # cmp with NULL selects nothing
            used.append(c)
            continue
        if ftype.kind == TypeKind.STRING and not isinstance(v, (str, bytes)):
            continue
        if ftype.kind in _INT_KINDS and isinstance(v, (str, bytes)):
            continue
        if ftype.kind == TypeKind.UINT and sig != "eq":
            # sign-wrapped uint storage breaks key order for ranges: leave
            # the condition as a residual filter (correct, just unindexed)
            continue
        used.append(c)
        if sig == "eq":
            if int_backed:
                iv = _int_bound(v, scale, "eq")
                if iv is not None:
                    iv = _wrap_uint(iv, ftype)
                if iv is None:
                    b.empty = True
                    continue
                v = iv
            else:
                v = _phys_const(v, ftype)
            b.eq = [v] if b.eq is None else sorted(set(b.eq) & {v})
        elif sig in ("ge", "gt"):
            tighten_lo(v, sig == "ge")
        else:
            tighten_hi(v, sig == "le")
    # normalize: clamp to the int64 key domain (out-of-domain bounds must
    # not wrap in encode_int_raw), then filter eq points by lo/hi
    i64_min, i64_max = -(2**63), 2**63 - 1
    if int_backed:
        if b.lo is not None:
            if b.lo > i64_max:
                b.empty = True
            b.lo = max(b.lo, i64_min)
        if b.hi is not None:
            if b.hi < i64_min:
                b.empty = True
            b.hi = min(b.hi, i64_max)
    if b.eq is not None:
        if int_backed:
            lo = b.lo if b.lo is not None else i64_min
            hi = b.hi if b.hi is not None else i64_max
            b.eq = [p for p in b.eq if lo <= p <= hi]
        if not b.eq:
            b.empty = True
    elif int_backed and b.lo is not None and b.hi is not None and b.lo > b.hi:
        b.empty = True
    return b, used


@dataclass
class IndexAccess:
    """Result of detaching access conditions for one index."""

    index: IndexInfo
    ranges: list[KeyRange]
    used: list[Expression]  # conditions consumed into ranges
    residual: list[Expression]  # must still be filtered after the scan
    eq_prefix_len: int  # number of leading columns with point conditions
    has_range: bool  # a range condition on the next column
    point_count: int  # total number of point ranges (IN fan-out product)


def detach_index_conditions(
    conds: list[Expression], scan_schema, table: TableInfo, index: IndexInfo
) -> Optional[IndexAccess]:
    """ref: ranger.DetachCondAndBuildRangeForIndex — longest eq/IN prefix,
    then one range column. scan_schema maps schema positions → storage slots
    via OutCol.slot."""
    slot_to_pos = {oc.slot: i for i, oc in enumerate(scan_schema)}
    prefixes: list[list[bytes]] = [b""]  # encoded value prefixes (fan-out via IN)
    used_all: list[Expression] = []
    eq_len = 0
    point_count = 1
    has_range = False
    lo_key_suffix = b""
    hi_key_suffix: Optional[bytes] = None

    for depth, off in enumerate(index.column_offsets):
        pos = slot_to_pos.get(off)
        if pos is None:
            break
        ftype = table.columns[off].ftype
        if ftype.kind == TypeKind.STRING and ftype.collation == "ci":
            # index keys are byte-encoded raw values, but general_ci equality
            # holds across byte-distinct members of a weight class ('a' ≡
            # 'A'): a byte range can only under-select. Stop the usable
            # prefix here — comparisons on this column stay residual filters
            # (which evaluate collation-aware). Found by graftfuzz's TLP
            # oracle on BOTH engines (repro tests/fuzz_corpus/repro_s42_c20.py)
            break
        bound, used = _extract_col_conds(conds, pos, ftype)
        if bound.empty:
            return IndexAccess(index, [], used_all + used, [c for c in conds], eq_len, False, 0)
        if bound.eq is not None:
            new_prefixes = []
            for p in prefixes:
                for v in bound.eq:
                    new_prefixes.append(p + _encode_datum(v, ftype))
            prefixes = new_prefixes
            point_count *= len(bound.eq)
            if point_count > 256:
                # IN fan-out cap: an unbounded range list is worse than a
                # columnar full scan → no index access at all
                return None
            used_all.extend(used)
            eq_len += 1
            continue
        if bound.lo is not None or bound.hi is not None:
            has_range = True
            used_all.extend(used)
            int_backed = ftype.kind in _INT_KINDS
            # comparisons never match NULL: skip NIL-flagged entries (flag
            # 0x00 sorts before every typed datum) when there is no low bound
            lo_key_suffix = bytes([codec.NIL_FLAG + 1])
            if bound.lo is not None:
                if int_backed:
                    lo_key_suffix = _encode_datum(bound.lo, ftype)
                else:
                    v, inc = bound.lo
                    enc = _encode_datum(v, ftype)
                    lo_key_suffix = enc if inc else prefix_next(enc)
            if bound.hi is not None:
                if int_backed:
                    hi_key_suffix = prefix_next(_encode_datum(bound.hi, ftype))
                else:
                    v, inc = bound.hi
                    enc = _encode_datum(v, ftype)
                    hi_key_suffix = prefix_next(enc) if inc else enc
        break  # range column (or nothing) ends the prefix

    if eq_len == 0 and not has_range:
        return None
    ranges: list[KeyRange] = []
    p0 = tablecodec.index_prefix(table.id, index.id)
    for pref in prefixes:
        if has_range:
            start = p0 + pref + lo_key_suffix
            end = p0 + pref + hi_key_suffix if hi_key_suffix is not None else prefix_next(p0 + pref)
        elif pref:
            start = p0 + pref
            end = prefix_next(p0 + pref)
        else:
            continue
        if start < end:
            ranges.append(KeyRange(start, end))
    used_ids = {id(c) for c in used_all}
    # eq/IN conditions are fully enforced by the range; the range-column
    # bounds too (integer bounds are exact). Everything else is residual.
    residual = [c for c in conds if id(c) not in used_ids]
    return IndexAccess(index, ranges, used_all, residual, eq_len, has_range, point_count if prefixes else 0)


def derive_handle_ranges(conds: list[Expression], scan_schema, table: TableInfo) -> Optional[tuple[list[KeyRange], int]]:
    """PK-as-handle table ranges (ref: ranger.BuildTableRange). Returns
    (ranges, eq_prefix_len 0/1) or None when no pk condition exists."""
    if not table.pk_is_handle:
        return None
    pk_pos = None
    for i, oc in enumerate(scan_schema):
        if oc.slot == table.pk_offset:
            pk_pos = i
            break
    if pk_pos is None:
        return None
    ftype = table.columns[table.pk_offset].ftype
    bound, used = _extract_col_conds(conds, pk_pos, ftype)
    if not used:
        return None
    if bound.empty:
        return [], 1
    if bound.eq is not None:
        return [tablecodec.handle_range(table.id, v, v) for v in bound.eq], 1
    lo = bound.lo if bound.lo is not None else None
    hi = bound.hi if bound.hi is not None else None
    return [tablecodec.handle_range(table.id, lo, hi)], 0
