"""Device binder: legalize a DAGRequest for TPU execution.

Strings never travel to the device as bytes — only as dictionary codes. The
binder rewrites every string-touching expression into integer form against
the region-shared dictionaries (ref: the role TiFlash's collation-aware
compiled predicates play; pushdown legality: infer_pushdown.go:266):

- ``eq/ne/in`` on a string column vs constants → compare codes (absent
  constant → code -1, which matches nothing);
- ``lt/le/gt/ge`` → rank-compare, after forcing the dictionary sorted
  (codes become order-preserving; le/gt use bisect_right semantics);
- ORDER BY / MIN / MAX on a string column → force-sort the dictionary;
- anything else string-valued (LIKE, LENGTH, ...) → ``UnsupportedForDevice``
  (the planner's legality table should have kept these off the TPU path).
"""

from __future__ import annotations

import copy
from typing import Optional

from tidb_tpu_torch.copr import dagpb
from tidb_tpu_torch.copr.colcache import ColumnCache
from tidb_tpu_torch.expression.registry import REGISTRY
from tidb_tpu_torch.types import TypeKind
from tidb_tpu_torch.types.field_type import bigint_type


class UnsupportedForDevice(Exception):
    pass


_CMP_REWRITE = {"lt": ("lt", "left"), "le": ("lt", "right"), "gt": ("ge", "right"), "ge": ("ge", "left")}
_INT_FT = [int(TypeKind.INT), 20, 0, 1, "bin"]


class Binder:
    def __init__(self, cache: ColumnCache, table_id: int, scan_cols: list[dagpb.ColumnInfoPB], entry=None):
        self.cache = cache
        self.table_id = table_id
        # scan output offset → (storage slot, ftype)
        self.scan_cols = scan_cols
        # the region's decoded columns (colcache.RegionColumns) — source of
        # per-column min/max for the packed window sort; optional
        self.entry = entry

    def _dict_for_offset(self, offset: int):
        c = self.scan_cols[offset]
        return self.cache.dictionary(self.table_id, c.column_id)

    def bind_dag(self, dag: dagpb.DAGRequest) -> dagpb.DAGRequest:
        out = copy.deepcopy(dag)
        scan_seen = False
        # once an agg/projection rewrites the batch, ColumnRef indexes no
        # longer address scan outputs and column statistics don't apply
        refs_are_scan = True
        for ex in out.executors:
            if ex.tp == dagpb.TABLE_SCAN:
                scan_seen = True
                self._scan_domains = None  # filled below
                # capture value domains: string codes live in [0, len(dict));
                # enables the kernel's dense no-sort group-by fast path
                ex.domains = [
                    len(self.cache.dictionary(self.table_id, c.column_id))
                    if c.ftype.kind == TypeKind.STRING
                    else -1
                    for c in ex.columns
                ]
                self._scan_domains = ex.domains
                continue
            if not scan_seen:
                raise UnsupportedForDevice("DAG must start with a scan")
            if ex.tp == dagpb.SELECTION:
                ex.conditions = [self.bind_expr(c) for c in ex.conditions]
                if refs_are_scan and self.entry is not None:
                    ex.narrow_ok = [self.narrow_safe(c) for c in ex.conditions]
            elif ex.tp in (dagpb.AGGREGATION, dagpb.STREAM_AGG):
                ex.group_by = [self.bind_expr(g, allow_string_ref=True) for g in ex.group_by]
                for a in ex.aggs:
                    if a.get("distinct"):
                        raise UnsupportedForDevice("distinct agg on device")
                    if a["arg"] is not None:
                        allow = a["name"] in ("first_row", "count")
                        if a["name"] in ("min", "max") and self._is_string(a["arg"]):
                            self._force_sorted(a["arg"])
                            allow = True
                        a["arg"] = self.bind_expr(a["arg"], allow_string_ref=allow or a["name"] in ("min", "max"))
                if refs_are_scan:
                    # exact value bounds per SUM argument (corner evaluation
                    # over column min/max) — unlocks the MXU grouped-sum
                    # kernel for expression args the ftype whitelist rejects
                    ex.arg_bounds = [
                        self._corner_bounds(a["arg"]) if a["arg"] is not None else None
                        for a in ex.aggs
                    ]
                    if self.entry is not None:
                        ex.group_narrow = [self.narrow_safe(g) for g in ex.group_by]
                        ex.arg_narrow = [
                            a["arg"] is not None and self.narrow_safe(a["arg"])
                            for a in ex.aggs
                        ]
                if getattr(ex, "rollup", False):
                    self._gate_device_rollup(ex)
                refs_are_scan = False
            elif ex.tp == dagpb.TOPN:
                new_order = []
                for item in ex.order_by:
                    pb, desc = item
                    if self._is_string(pb):
                        self._force_sorted(pb)
                    new_order.append([self.bind_expr(pb, allow_string_ref=True), desc])
                ex.order_by = new_order
                if refs_are_scan:
                    # value bounds let the single-key top_k pack the row index
                    # into the key → exact lowest-index tie-breaking even when
                    # a tie group overflows the candidate window
                    ex.sort_bounds = self._bounds_for([pb for pb, _ in new_order])
            elif ex.tp == dagpb.PROJECTION:
                ex.exprs = [self.bind_expr(e, allow_string_ref=True) for e in ex.exprs]
                refs_are_scan = False
            elif ex.tp == dagpb.WINDOW:
                # partition keys need identity only → string codes qualify
                ex.partition_by = [self.bind_expr(p, allow_string_ref=True) for p in ex.partition_by]
                new_order = []
                for pb, desc in ex.order_by:
                    if self._is_string(pb):
                        # sorted dictionary makes codes order-preserving
                        self._force_sorted(pb)
                    new_order.append((self.bind_expr(pb, allow_string_ref=True), desc))
                ex.order_by = new_order
                for f in ex.win_funcs:
                    f["args"] = [self.bind_expr(a) for a in f["args"]]
                ex.sort_bounds = self._window_bounds(ex)
            elif ex.tp == dagpb.LIMIT:
                pass
            else:
                raise UnsupportedForDevice(f"executor {ex.tp} on device")
        return out

    def _gate_device_rollup(self, ex) -> None:
        """Device WITH ROLLUP runs ONLY as the (G+1)-hot MXU dot: every key
        needs a dictionary domain and every aggregate a bounded COUNT/SUM
        form, with the summed window space inside the dot's bucket cap.
        Anything else is the host engine's loop-over-sets (still one scan)."""
        from tidb_tpu_torch.expression.expr import AggDesc
        from tidb_tpu_torch.ops.dag_kernel import _mxu_aggs_ok
        from tidb_tpu_torch.ops.mxu_groupby import MAX_B

        doms = []
        dmn = getattr(self, "_scan_domains", None) or []
        for g in ex.group_by:
            if g["tp"] == "col" and g["idx"] < len(dmn) and dmn[g["idx"]] > 0:
                doms.append(dmn[g["idx"]])
            else:
                raise UnsupportedForDevice("rollup key without a dictionary domain")
        from tidb_tpu_torch.ops.mxu_groupby import rollup_bucket_space

        b_total = rollup_bucket_space(doms)
        if b_total > MAX_B:
            raise UnsupportedForDevice(f"rollup window space {b_total} exceeds the dot cap")
        aggs = [AggDesc.from_pb(a) for a in ex.aggs]
        if not _mxu_aggs_ok(aggs, getattr(ex, "arg_bounds", ())):
            raise UnsupportedForDevice("rollup aggregate without a bounded COUNT/SUM form")

    def _bounds_for(self, pbs: list) -> list:
        """(lo, hi) per expression from cached column min/max — powers the
        packed single-key sorts (window sort, exact-tie TopN). None per lane
        when the key is an expression, a float, or no region entry is at
        hand; consumers then fall back (multi-lane sort / heuristic top_k /
        host engine)."""
        from tidb_tpu_torch.ops.window_core import widen_bounds

        bounds = []
        for pb in pbs:
            b = None
            if pb["tp"] == "col" and pb["idx"] < len(self.scan_cols):
                b = self._col_stats(pb["idx"])
            bounds.append(b)
        return widen_bounds(bounds)

    def _col_stats(self, offset: int):
        """(min, max) of one scan output column from the region entry /
        dictionary — the single stat source for every bound producer."""
        c = self.scan_cols[offset]
        if c.ftype.kind == TypeKind.STRING:
            return (0, max(len(self._dict_for_offset(offset)) - 1, 0))
        if c.ftype.kind == TypeKind.FLOAT or self.entry is None:
            return None
        if c.is_handle:
            h = self.entry.handles
            return (int(h.min()), int(h.max())) if len(h) else (0, 0)
        try:
            return self.entry.minmax(c.column_id)
        except (KeyError, ValueError):
            return None

    def _window_bounds(self, ex: dagpb.ExecutorPB) -> list:
        return self._bounds_for(ex.partition_by + [p for p, _ in ex.order_by])

    # expression ops whose extremes over a box of inputs occur at the box's
    # corners — interval evaluation by CORNER ENUMERATION through the real
    # evaluator needs no second copy of decimal-scale semantics
    _CORNER_SIGS = frozenset({"plus", "minus", "mul", "unaryminus"})

    def _corner_bounds(self, pb: dict):
        """Magnitude proof for an integer-kind expression: evaluate it on
        every corner combination of its columns' cached min/max. Sound only
        for MULTILINEAR expressions — {+, -, *, unary-} with each column
        occurring AT MOST ONCE (a box's extremes then sit at its corners) —
        and with exact Python-int arithmetic (object-dtype lanes) so int64
        wraparound can't fake a small bound. The result is quantized to a
        power-of-two magnitude envelope so data drift doesn't churn kernel
        fingerprints. None = unbounded/unsupported — callers fall back."""
        import itertools

        import numpy as np

        from tidb_tpu_torch.expression.expr import EvalBatch, eval_expr, expr_from_pb

        if self.entry is None:
            return None
        cols: list[int] = []
        sound = [True]

        def walk(node) -> bool:
            tp = node["tp"]
            if tp == "const":
                return node["ft"][0] != int(TypeKind.STRING)
            if tp == "col":
                ft0 = node["ft"][0]
                if ft0 in (int(TypeKind.STRING), int(TypeKind.FLOAT)):
                    return False
                if node["idx"] >= len(self.scan_cols):
                    return False  # window-appended column: no cached stats
                if node["idx"] in cols:
                    sound[0] = False  # repeated column: not multilinear
                    return False
                cols.append(node["idx"])
                return True
            if tp == "func":
                if node["sig"] not in self._CORNER_SIGS:
                    return False
                return all(walk(k) for k in node["children"])
            return False

        if not walk(pb) or not sound[0] or len(cols) > 6:
            return None
        mms = []
        for off in cols:
            mm = self._col_stats(off)
            if mm is None:
                return None
            mms.append(mm)
        corners = list(itertools.product(*mms)) or [()]
        n = len(corners)
        width = len(self.scan_cols)
        # object dtype = exact Python-int arithmetic: corner products that
        # would wrap int64 surface as huge values instead of small lies
        batch_cols = [
            (np.zeros(n, dtype=object) + 0, np.ones(n, bool)) for _ in range(width)
        ]
        for ci, off in enumerate(cols):
            batch_cols[off] = (
                np.array([int(cr[ci]) for cr in corners], dtype=object),
                np.ones(n, bool),
            )
        try:
            d, v, _ = eval_expr(expr_from_pb(pb), EvalBatch(batch_cols, [None] * width, n), np)
            vals = [int(x) for x in np.broadcast_to(np.asarray(d, dtype=object), (n,))]
        except Exception:
            return None
        m = max(abs(min(vals)), abs(max(vals)), 1)
        m2 = 1 << (m - 1).bit_length()  # pow2 envelope: fingerprint-stable
        # provably-nonnegative expressions keep a zero floor — halving the
        # span unlocks narrower limb plans and the int32 compute lanes
        return (0 if min(vals) >= 0 else -m2, m2)

    # -- int32 narrow-eval proofs -------------------------------------------
    # the kernel evaluates proven expressions on the NARROW (storage-dtype)
    # lanes: int32 VPU ops run native where emulated-pair int64 ops would run
    # 2-3x wider (ref: the per-width column discipline, util/chunk/column.go:74)
    _NARROW_CMP = frozenset({"eq", "ne", "nulleq", "lt", "le", "gt", "ge", "in"})
    _NARROW_LOGIC = frozenset({"and", "or", "not", "isnull"})
    _I32_LO, _I32_HI = -(1 << 31), (1 << 31) - 1

    def narrow_safe(self, pb: dict) -> bool:
        """Proof that evaluating this bound expression over int32 lanes is
        EXACT: every integer subtree's value range (column stats / corner
        bounds) fits int32, so no intermediate can wrap. Comparisons and
        logic over proven operands are width-independent."""
        tp = pb["tp"]
        if tp == "const":
            return self._const_fits_i32(pb)
        if tp == "col":
            ft0 = pb["ft"][0]
            if ft0 == int(TypeKind.STRING):
                return True  # dictionary codes: int32 by construction
            if ft0 == int(TypeKind.FLOAT):
                return False
            mm = self._col_stats(pb["idx"]) if pb["idx"] < len(self.scan_cols) else None
            return mm is not None and self._I32_LO <= mm[0] and mm[1] <= self._I32_HI
        sig = pb["sig"]
        kids = pb["children"]
        if sig in self._NARROW_CMP or sig in self._NARROW_LOGIC:
            return all(self.narrow_safe(k) for k in kids)
        if sig in self._CORNER_SIGS:
            b = self._corner_bounds(pb)
            if b is None or b[0] < self._I32_LO or b[1] > self._I32_HI:
                return False
            return all(self.narrow_safe(k) for k in kids)
        return False

    def _const_fits_i32(self, pb: dict) -> bool:
        from tidb_tpu_torch.expression.expr import _const_physical, expr_from_pb

        try:
            pv, _ = _const_physical(expr_from_pb(pb), None)
        except Exception:
            return False
        return isinstance(pv, int) and self._I32_LO <= pv <= self._I32_HI

    # -- expression rewriting ----------------------------------------------
    def _is_string(self, pb: dict) -> bool:
        return pb["tp"] == "col" and pb["ft"][0] == int(TypeKind.STRING)

    def _force_sorted(self, col_pb: dict):
        slot = self.scan_cols[col_pb["idx"]].column_id
        # ci columns rank-compact under the general_ci WEIGHT order (byte
        # tiebreak) — the only order they ever reduce/compare under; every
        # other collation compacts under byte order. ft pb layout:
        # [kind, length, scale, nullable, collation, json]
        self.cache.ensure_sorted_dict(self.table_id, slot, ci=col_pb["ft"][4] == "ci")

    def bind_expr(self, pb: dict, allow_string_ref: bool = False) -> dict:
        tp = pb["tp"]
        if tp == "col":
            if pb["ft"][0] == int(TypeKind.STRING) and not allow_string_ref:
                raise UnsupportedForDevice("raw string column in device expression")
            return pb
        if tp == "const":
            if pb["ft"][0] == int(TypeKind.STRING):
                raise UnsupportedForDevice("unbound string constant on device")
            return pb
        # func
        sig = pb["sig"]
        spec = REGISTRY.get(sig)
        if spec is None or "gpu" not in spec.engines:
            raise UnsupportedForDevice(f"builtin {sig} not device-legal")
        kids = pb["children"]
        str_kids = [k for k in kids if k["tp"] != "func" and k["ft"][0] == int(TypeKind.STRING)]
        if str_kids:
            if sig in ("eq", "ne", "in"):
                return self._bind_code_compare(pb)
            if sig in _CMP_REWRITE:
                return self._bind_rank_compare(pb)
            if sig in ("isnull", "ifnull", "coalesce", "if", "case_when"):
                pass  # operate on codes + validity; fall through
            else:
                raise UnsupportedForDevice(f"{sig} over strings on device")
        return {**pb, "children": [self.bind_expr(k, allow_string_ref=True) for k in kids]}

    def _col_and_consts(self, pb: dict):
        kids = pb["children"]
        col = next((k for k in kids if k["tp"] == "col"), None)
        if col is None or any(k["tp"] == "func" for k in kids):
            raise UnsupportedForDevice("string comparison must be col-vs-const on device")
        return col, [k for k in kids if k is not col]

    def _bind_code_compare(self, pb: dict) -> dict:
        col, consts = self._col_and_consts(pb)
        dic = self._dict_for_offset(col["idx"])
        new_kids = []
        for k in pb["children"]:
            if k is col:
                new_kids.append({**col, "ft": _INT_FT})
            else:
                v = k["val"]
                if v is None:
                    new_kids.append({**k, "ft": _INT_FT})
                    continue
                code = dic.try_encode(v.encode("utf-8", "surrogateescape") if isinstance(v, str) else v)
                new_kids.append({"tp": "const", "val": int(code), "ft": _INT_FT})
        return {**pb, "children": new_kids}

    def _bind_rank_compare(self, pb: dict) -> dict:
        col, consts = self._col_and_consts(pb)
        if len(consts) != 1 or consts[0]["tp"] != "const":
            raise UnsupportedForDevice("string range compare must be col-vs-one-const")
        if pb["children"][0] is not col:
            # const OP col → flip operator
            flip = {"lt": "gt", "le": "ge", "gt": "lt", "ge": "le"}
            pb = {**pb, "sig": flip[pb["sig"]], "children": [pb["children"][1], pb["children"][0]]}
            col, consts = pb["children"][0], [pb["children"][1]]
        slot = self.scan_cols[col["idx"]].column_id
        dic = self.cache.ensure_sorted_dict(self.table_id, slot)
        v = consts[0]["val"]
        if v is None:
            # comparison with NULL is NULL → planner folds this; encode as
            # never-true with NULL validity via (col != col)... keep simple:
            raise UnsupportedForDevice("range compare with NULL constant")
        vb = v.encode("utf-8", "surrogateescape") if isinstance(v, str) else v
        import bisect

        vals = dic.values_array()
        new_sig, side = _CMP_REWRITE[pb["sig"]]
        rank = bisect.bisect_left(vals, vb) if side == "left" else bisect.bisect_right(vals, vb)
        return {
            "tp": "func",
            "sig": new_sig,
            "children": [{**col, "ft": _INT_FT}, {"tp": "const", "val": int(rank), "ft": _INT_FT}],
            "ft": pb["ft"],
        }
