"""The fused DAG program (port of the single-block subset of
tidb_tpu/ops/dag_kernel.py).

One program per (DAG, padded row count): scan → selection* → aggregation
or TopN over one region's padded columns, packed into one int64 buffer (and
a float64 one when a lane is floating) whose row 0 is the meta row
``[count, ngroups]``. PyTorch runs eagerly, so "compiling" parses the DAG
and fixes every route; the program cache is keyed exactly as the
reference's (``get_kernel``).

Routes ported, chosen by the reference's rule and constants:

- Selection: a row mask (no compaction); the 8-range handle mask unless
  the caller proved the ranges cover the region (``full_scan``).
- Aggregation by dense bucket arithmetic over dictionary-coded keys:
  the equality-mask reduce for B ≤ 32 (and every scalar aggregation), the
  int8 dot (``mxu_groupby``) for B ≤ 64, and K1 (``grouped_sums``, the
  hand-written CUDA kernel) for 64 < B ≤ 512 with n ≤ 8,000,000 rows,
  n % 1024 == 0.
- TopN: the single-key top-k with the rank-code key that packs the row
  position into the value (exact ties), else a stable lexicographic sort.

Everything else — lex-sort grouping, complete-mode finalize, ROLLUP,
LIMIT, PROJECTION, WINDOW, multi-block programs, the delta operand —
raises ``UnsupportedForDevice`` when the program is built.
"""

from __future__ import annotations

import threading
from dataclasses import dataclass
from typing import Callable

import numpy as np
import torch

from tidb_tpu_torch.copr import dagpb
from tidb_tpu_torch.copr.binder import UnsupportedForDevice
from tidb_tpu_torch.expression.expr import AggDesc, ColumnRef, EvalBatch, eval_expr, expr_from_pb
from tidb_tpu_torch.ops.grouped_sums import _BLK, MAX_ROWS, grouped_sums
from tidb_tpu_torch.ops.mxu_groupby import MAX_B as _DOT_MAX_B
from tidb_tpu_torch.ops.mxu_groupby import grouped_sums_dot
from tidb_tpu_torch.types import TypeKind

MAX_RANGES = 8
_I64_MAX = np.iinfo(np.int64).max
_I64_MIN = np.iinfo(np.int64).min
_I32_MIN = np.iinfo(np.int32).min
# the equality-mask reduce does B*n work per lane; past this many buckets the
# int8 dot (≤ MAX_B) or K1 (≤ _DENSE_MXU_MAX) takes over
_DENSE_EQMASK_MAX = 32
_DENSE_MXU_MAX = 512
# TopN key kinds whose physical values never equal the int64 sentinel
_TOPK_KINDS = (
    TypeKind.DECIMAL,
    TypeKind.DATE,
    TypeKind.DATETIME,
    TypeKind.DURATION,
    TypeKind.STRING,
    TypeKind.FLOAT,
)


def _dense_b_total(doms) -> int:
    b = 1
    for dm in doms:
        b *= dm + 1
    return b


def _mxu_aggs_ok(aggs, arg_bounds=()) -> bool:
    """The dense grouped-sum routes cover COUNT/SUM lanes whose values are
    provably < 2^45; the proof is :func:`_pair_bound`, the same function the
    dot route plans its limbs with."""
    for i, a in enumerate(aggs):
        kinds = a.partial_kinds
        if all(pk == "count" for pk in kinds):
            continue  # value lane unused (zeros)
        for pk in kinds:
            if pk == "count":
                continue
            if pk != "sum":
                return False  # min/max/first_row: no matmul form
            if a.arg is None:
                return False
            b = _pair_bound(a, arg_bounds[i] if i < len(arg_bounds) else None)
            if b is None or max(abs(int(b[0])), abs(int(b[1]))) >= (1 << 45):
                return False
    return True


def _pair_bound(a, b):
    """(lo, hi) magnitude proof for one agg's value lane — the binder's
    corner bounds when stamped, else the conservative ftype envelope."""
    if b is not None:
        return (int(b[0]), int(b[1]))
    ft = a.arg.ftype if a.arg is not None else None
    if ft is None:
        return (0, 0)  # count(*): zeros lane
    if ft.kind == TypeKind.DECIMAL and 0 < ft.length <= 13:
        m = 10**ft.length
        return (-m, m)
    if ft.kind == TypeKind.DATE:
        return (0, 1 << 23)
    return None  # int32 dtype envelope inside grouped_sums_dot


def agg_route(ex, group_exprs, aggs, scan, n: int, agg_cap: int):
    """("eqmask" | "dot" | "k1", doms) for one aggregation executor — the
    reference's rule (tidb_tpu/ops/dag_kernel.py:775-823) with its
    constants. Shapes the reference sends to the lex-sort path raise."""
    has_bit = any(pk in ("bit_and", "bit_or", "bit_xor") for a in aggs for pk in a.partial_kinds)
    if has_bit:
        raise UnsupportedForDevice("bit aggregates need the lex-sort path (not ported)")
    if not group_exprs:
        return "eqmask", []
    doms = []
    for g in group_exprs:
        if isinstance(g, ColumnRef) and g.index < len(scan.domains) and scan.domains[g.index] > 0:
            doms.append(scan.domains[g.index])
        else:
            raise UnsupportedForDevice("group key without a dictionary domain: lex-sort path (not ported)")
    bt = _dense_b_total(doms)
    sums_ok = _mxu_aggs_ok(aggs, getattr(ex, "arg_bounds", ()))
    dot_fits = bt <= min(agg_cap, _DOT_MAX_B) and sums_ok
    mxu_fits = bt <= min(agg_cap, _DENSE_MXU_MAX) and sums_ok and n <= MAX_ROWS and n % _BLK == 0
    if (dot_fits or mxu_fits) and (bt > _DENSE_EQMASK_MAX or n >= (1 << 21)):
        return ("dot" if dot_fits else "k1"), doms
    if bt <= min(agg_cap, _DENSE_EQMASK_MAX):
        return "eqmask", doms
    raise UnsupportedForDevice(f"{bt}-bucket group-by needs the lex-sort path (not ported)")


@dataclass
class CompiledKernel:
    fn: Callable  # (handles, cols, ranges, nvalid) -> packed buffer(s)
    kind: str  # "rows" | "agg"
    out_n: int  # static output row capacity
    agg_cap: int
    # written by each run's packing step; every run of one program writes
    # the same values
    _lanes: dict

    @property
    def lane_loc(self):  # per-output ("i"|"f", row index) into packed buffer(s)
        return self._lanes["loc"]

    @property
    def valid_loc(self):  # per-output row index of the valid lane (int buffer)
        return self._lanes["vloc"]

    @property
    def warn_specs(self):  # [(code, msg, meta_slot)]: no ported builtin warns
        return self._lanes.get("warns", ())


_COMPILE_CACHE: dict[tuple, CompiledKernel] = {}
_CACHE_MU = threading.Lock()


def get_kernel(
    dag: dagpb.DAGRequest,
    n_pad: int,
    agg_cap: int,
    nb: int = 1,
    full_scan: bool = False,
    delta_cap: int = 0,
) -> CompiledKernel:
    """``full_scan``: the caller proved every row is inside the requested
    ranges, so the program skips the handle range mask."""
    key = (dag.fingerprint(), n_pad, agg_cap, nb, full_scan, delta_cap)
    with _CACHE_MU:
        k = _COMPILE_CACHE.get(key)
    if k is None:
        k = _build(dag, n_pad, agg_cap, nb, full_scan, delta_cap)
        with _CACHE_MU:
            _COMPILE_CACHE[key] = k
    return k


def _bcast(d, n: int, dev) -> torch.Tensor:
    if isinstance(d, torch.Tensor) and d.dim() == 1:
        return d
    # a Python float is a float64 value, not torch's float32 default
    dtype = torch.float64 if isinstance(d, float) else None
    return torch.as_tensor(d, dtype=dtype, device=dev).expand(n)


def _vmask(v, n: int, dev) -> torch.Tensor:
    if v is None:
        return torch.ones(n, dtype=torch.bool, device=dev)
    if v is False:
        return torch.zeros(n, dtype=torch.bool, device=dev)
    return _bcast(v, n, dev)


def _sortable(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.int8) if x.dtype == torch.bool else x


def _lex_perm(lanes):
    """Stable lexicographic argsort: lanes[0] most significant."""
    perm = torch.argsort(_sortable(lanes[-1]), stable=True)
    for lane in reversed(lanes[:-1]):
        perm = perm[torch.argsort(_sortable(lane)[perm], stable=True)]
    return perm


def _hier_top_k(vals: torch.Tensor, K: int):
    """Two-level top-k: per-row top-k on an (R, C) reshape plus a small
    second-level top-k. Exact: one row can contribute at most K rows to the
    global top-K. Returns (values, global indices)."""
    n = int(vals.shape[0])
    R = min(16384, n // max(2 * K, 128))
    if n < (1 << 21) or R < 8:
        return torch.topk(vals, K)
    C = n // R
    main, tail = vals[: R * C], vals[R * C :]
    v, i = torch.topk(main.reshape(R, C), min(K, C), dim=1)
    gi = (i + (torch.arange(R, device=vals.device) * C)[:, None]).reshape(-1)
    v2 = torch.cat([v.reshape(-1), tail])
    g2 = torch.cat([gi, torch.arange(R * C, n, device=vals.device)])
    vf, sel = torch.topk(v2, K)
    return vf, g2[sel]


def _build(dag: dagpb.DAGRequest, n_pad: int, agg_cap: int, nb: int = 1, full_scan: bool = False, delta_cap: int = 0) -> CompiledKernel:
    if nb != 1:
        raise UnsupportedForDevice("multi-block programs are not ported")
    if delta_cap:
        raise UnsupportedForDevice("the delta operand is not ported")
    executors = dag.executors
    scan = executors[0]
    if scan.tp != dagpb.TABLE_SCAN:
        raise UnsupportedForDevice(f"{scan.tp} scans are not ported")
    n = n_pad
    # parse every executor and fix every route now: the program raises
    # before it touches the device, never halfway through a run
    parsed: list = []
    for ex in executors[1:]:
        if ex.tp == dagpb.SELECTION:
            parsed.append([expr_from_pb(c) for c in ex.conditions])
        elif ex.tp in (dagpb.AGGREGATION, dagpb.STREAM_AGG):
            if ex.agg_mode == dagpb.AGG_COMPLETE:
                raise UnsupportedForDevice("complete-mode finalize is not ported")
            if getattr(ex, "rollup", False):
                raise UnsupportedForDevice("ROLLUP is not ported")
            group_exprs = [expr_from_pb(g) for g in ex.group_by]
            aggs = [AggDesc.from_pb(a) for a in ex.aggs]
            for a in aggs:
                if any(pk not in ("count", "sum", "sumsq", "min", "max", "first_row") for pk in a.partial_kinds):
                    raise UnsupportedForDevice(f"aggregate {a.name} is not ported")
            route, doms = agg_route(ex, group_exprs, aggs, scan, n, agg_cap)
            parsed.append((group_exprs, aggs, route, doms))
        elif ex.tp == dagpb.TOPN:
            parsed.append(([(expr_from_pb(p), d) for p, d in ex.order_by], ex.limit))
        else:
            raise UnsupportedForDevice(f"executor {ex.tp} is not ported")

    agg_is_last = bool(executors[1:]) and executors[-1].tp in (dagpb.AGGREGATION, dagpb.STREAM_AGG)
    topn_like = [ex for ex in executors[1:] if ex.tp == dagpb.TOPN]
    out_n = n
    if agg_is_last:
        out_n = agg_cap
    elif topn_like:
        # tight power-of-two (floor 32): small K keeps top-k candidate sets tiny
        lim = max(ex.limit for ex in topn_like)
        out_n = min(n, max(32, 1 << max(lim - 1, 0).bit_length()))

    lanes_holder: dict = {}

    def _mxu_seg(gvals, doms, mask, B, dev):
        # int32 bucket arithmetic when every key lane is narrow
        seg_dtype = torch.int32 if gvals and all(d.dtype == torch.int32 for d, _ in gvals) else torch.int64
        seg = torch.zeros(n, dtype=seg_dtype, device=dev)
        stride = 1
        strides = []
        for (d, v), dom in zip(reversed(gvals), reversed(doms)):
            adj = torch.where(v, d, dom)  # NULLs → extra bucket
            seg = seg + adj * stride
            strides.append(stride)
            stride *= dom + 1
        strides = list(reversed(strides))  # align with gvals order
        return torch.where(mask, seg, B), strides

    def _mxu_pairs(aggs, arg_bounds, arg_narrow, batch, batch_nw, mask, dev):
        pairs = []
        pair_bounds = []
        lane_of_agg = []
        zero64 = torch.zeros(n, dtype=torch.int64, device=dev)
        arg_memo: dict = {}  # SUM(x) + AVG(x) share one lane set
        for ai, a in enumerate(aggs):
            count_only = all(pk == "count" for pk in a.partial_kinds)
            if a.arg is not None:
                nw = ai < len(arg_narrow) and arg_narrow[ai]
                memo_key = repr(a.arg.to_pb())
                got = arg_memo.get(memo_key)
                if got is None:
                    d0, v0, _ = eval_expr(a.arg, batch_nw if nw else batch, torch)
                    d0 = _bcast(d0, n, dev)
                    # proven-narrow args keep their int32 lanes
                    if not d0.is_floating_point() and d0.dtype != torch.int32:
                        d0 = d0.to(torch.int64)
                    # never-null args share the one mask object: the dot
                    # dedups weight columns by identity
                    w0 = mask if v0 is None else mask & _vmask(v0, n, dev)
                    got = (d0, w0)
                    arg_memo[memo_key] = got
                d, w = got
                if count_only:
                    d = zero64  # COUNT(x) reads only the weight lane
            else:
                d, w = zero64, mask  # COUNT(*): weight = row mask
            lane_of_agg.append(len(pairs))
            pairs.append((d, w))
            pair_bounds.append(
                (0, 0) if count_only else _pair_bound(a, arg_bounds[ai] if ai < len(arg_bounds) else None)
            )
        occ_lane = len(pairs)
        pairs.append((torch.zeros(n, dtype=torch.int64, device=dev), mask))  # occupancy
        pair_bounds.append((0, 0))
        return pairs, pair_bounds, lane_of_agg, occ_lane

    def _mxu_outputs(counts, sums, lane_of_agg, occ_lane, aggs, doms, strides, B, dev):
        out_data, out_valid = [], []
        for a, li in zip(aggs, lane_of_agg):
            cnt = counts[:, li]
            for pk in a.partial_kinds:
                if pk == "count":
                    out_data.append(cnt)
                    out_valid.append(torch.ones(B, dtype=torch.bool, device=dev))
                else:  # sum (gated by _mxu_aggs_ok)
                    out_data.append(sums[:, li])
                    out_valid.append(cnt > 0)
        # group keys decode arithmetically from the bucket index
        bidx = torch.arange(B, device=dev)
        occupied = counts[:, occ_lane] > 0
        for dom, st in zip(doms, strides):
            code = (bidx // st) % (dom + 1)
            kv = (code != dom) & occupied
            out_data.append(torch.where(kv, code, 0).to(torch.int64))
            out_valid.append(kv)
        order = torch.argsort(_sortable(~occupied), stable=True)
        ngroups = occupied.sum()
        out_cap = min(B, agg_cap)
        return [o[order][:out_cap] for o in out_data], [o[order][:out_cap] for o in out_valid], ngroups

    def _eqmask_agg(group_exprs, aggs, doms, gvals, batch, mask, dev):
        B = _dense_b_total(doms)
        seg_dtype = torch.int32 if gvals and all(d.dtype == torch.int32 for d, _ in gvals) else torch.int64
        seg = torch.zeros(n, dtype=seg_dtype, device=dev)
        stride = 1
        for (d, v), dom in zip(reversed(gvals), reversed(doms)):
            adj = torch.where(v, d, dom)  # NULLs → extra bucket
            seg = seg + adj * stride
            stride *= dom + 1
        pos = torch.arange(n, dtype=torch.int32, device=dev)
        onehot = seg[None, :] == torch.arange(B, dtype=seg.dtype, device=dev)[:, None]  # (B, n)
        livem = onehot & mask[None, :]
        live = livem.sum(dim=1) > 0
        first_pos = torch.where(livem, pos[None, :], n).amin(dim=1)
        first_pos_c = first_pos.clamp(0, n - 1).to(torch.int64)
        out_data, out_valid = [], []
        for a in aggs:
            if a.arg is not None:
                d, v, _ = eval_expr(a.arg, batch, torch)
                d, v = _bcast(d, n, dev), _vmask(v, n, dev)
            else:
                d = torch.ones(n, dtype=torch.int64, device=dev)
                v = torch.ones(n, dtype=torch.bool, device=dev)
            wm = livem & v[None, :]
            cnt = wm.sum(dim=1)
            for pk in a.partial_kinds:
                if pk == "count":
                    out_data.append(cnt)
                    out_valid.append(torch.ones(B, dtype=torch.bool, device=dev))
                elif pk == "sum":
                    if a.arg is not None and a.arg.ftype.kind == TypeKind.FLOAT:
                        out_data.append(torch.where(wm, d[None, :] * 1.0, 0.0).sum(dim=1))
                    else:
                        out_data.append(torch.where(wm, d[None, :], 0).sum(dim=1))
                    out_valid.append(cnt > 0)
                elif pk == "sumsq":
                    out_data.append(torch.where(wm, (d[None, :] * 1.0) ** 2, 0.0).sum(dim=1))
                    out_valid.append(cnt > 0)
                elif pk in ("min", "max"):
                    if d.is_floating_point():
                        sentinel = float("inf") if pk == "min" else float("-inf")
                    else:
                        sentinel = _I64_MAX if pk == "min" else _I64_MIN
                    masked = torch.where(wm, d[None, :], sentinel)
                    out_data.append(masked.amin(dim=1) if pk == "min" else masked.amax(dim=1))
                    out_valid.append(cnt > 0)
                else:  # first_row
                    out_data.append(d[first_pos_c])
                    out_valid.append(v[first_pos_c] & (first_pos < n))
        for gd, gv in gvals:
            out_data.append(gd[first_pos_c])
            out_valid.append(gv[first_pos_c] & (first_pos < n))
        if gvals:
            order = torch.argsort(_sortable(~live), stable=True)
            ngroups = live.sum()
        else:
            order = torch.arange(B, device=dev)  # scalar agg: always one group
            ngroups = torch.ones((), dtype=torch.int64, device=dev)
        out_cap = min(B, agg_cap)
        return [o[order][:out_cap] for o in out_data], [o[order][:out_cap] for o in out_valid], ngroups

    def _topn(ex, order, limit, batch, mask, dev):
        cur_n = batch.n
        if len(order) == 1 and out_n <= 4096 and order[0][0].ftype.kind in _TOPK_KINDS:
            # single key: two top-k candidate pulls (value rows, NULL rows)
            # plus an exact lex sort over the 2K candidates
            e, desc = order[0]
            d, v, _ = eval_expr(e, batch, torch)
            d, v = _bcast(d, cur_n, dev), _vmask(v, cur_n, dev)
            K = min(out_n, cur_n)
            isf = d.is_floating_point()
            d0 = torch.where(v, d, 0)  # NULL keys zero
            if desc:
                key = d0
            else:
                # monotone-reversing: negate floats, complement ints
                key = -d0 if isf else ~d0
            sent = float("-inf") if isf else _I64_MIN
            vkey = torch.where(mask & v, key, sent)
            # top-k orders ties arbitrarily: with binder-stamped value bounds
            # the row position packs INTO the key, so even a tie group that
            # overflows the K-candidate window selects exactly the rows the
            # host engine's stable sort does
            b0 = ex.sort_bounds[0] if getattr(ex, "sort_bounds", None) else None
            if b0 is not None and not isf:
                lo_, hi_ = int(b0[0]), int(b0[1])
                span = hi_ - lo_ + 2
                if span * (cur_n + 1) <= (1 << 62):
                    code = (d - lo_ + 1).clamp(1, span - 1)
                    rank_code = code if desc else span - code
                    pidx = torch.arange(cur_n, device=dev)
                    vkey = torch.where(mask & v, rank_code * cur_n + (cur_n - 1 - pidx), _I64_MIN)
            _, idx_val = _hier_top_k(vkey, K)
            # NULL rows in first-index order: the key is the unique position
            pos_n = torch.arange(cur_n, dtype=torch.int32, device=dev)
            _, idx_null = _hier_top_k(torch.where(mask & ~v, -pos_n, _I32_MIN), K)
            cand = torch.cat([idx_val, idx_null])
            # a top-k slot past the true count points at an arbitrary row
            live_c = torch.cat([(mask & v)[idx_val], (mask & ~v)[idx_null]])
            zeros_k = torch.zeros(K, dtype=torch.int64, device=dev)
            ones_k = torch.ones(K, dtype=torch.int64, device=dev)
            tier = torch.cat([zeros_k, ones_k]) if desc else torch.cat([ones_k, zeros_k])  # ASC: NULLs first
            ckey = torch.where(live_c, key[cand], 0)
            perm2 = _lex_perm([~live_c, tier, -ckey if isf else ~ckey, cand])
            head = cand[perm2[:K]]
        else:
            lanes = [~mask]
            for e, desc in order:
                d, v, _ = eval_expr(e, batch, torch)
                d, v = _bcast(d, cur_n, dev), _vmask(v, cur_n, dev)
                if desc:
                    lanes.append(~v)  # NULLs last
                    dd = torch.where(v, d, 0)
                    lanes.append(-dd if dd.is_floating_point() else ~dd)
                else:
                    lanes.append(v)  # NULLs first
                    lanes.append(torch.where(v, d, 0))
            head = _lex_perm(lanes)[: min(out_n, cur_n)]
        head_n = int(head.shape[0])
        batch = EvalBatch(
            [(_bcast(d2, cur_n, dev)[head], _vmask(v2, cur_n, dev)[head]) for d2, v2 in batch.cols],
            batch.dicts,
            head_n,
        )
        count = torch.clamp(mask.sum(), max=limit)
        return batch, torch.arange(head_n, device=dev) < count, count

    def _pack(outs, count, og, dev):
        loc: list = []
        vloc: list = []
        ilanes: list = []
        flanes: list = []
        L = max(max((int(d.shape[0]) if d.dim() else 1) for d, _ in outs) if outs else 2, 2)
        meta = torch.zeros(L, dtype=torch.int64, device=dev)
        meta[0] = count
        meta[1] = og
        ilanes.append(meta)
        for d, v in outs:
            d = d.expand(L) if d.dim() == 0 else d
            if d.shape[0] < L:  # the meta row needs ≥ 2 slots; short lanes pad
                d = torch.nn.functional.pad(d, (0, L - d.shape[0]))
            if d.is_floating_point():
                loc.append(("f", len(flanes)))
                flanes.append(d.to(torch.float64))
            else:
                loc.append(("i", len(ilanes)))
                ilanes.append(d.to(torch.int64))
            vv = _vmask(v, L, dev)
            if vv.shape[0] < L:
                vv = torch.nn.functional.pad(vv, (0, L - vv.shape[0]))
            vloc.append(len(ilanes))
            ilanes.append(vv.to(torch.int64))
        lanes_holder.update({"loc": tuple(loc), "vloc": tuple(vloc), "warns": ()})
        if flanes:
            return torch.stack(ilanes), torch.stack(flanes)
        return torch.stack(ilanes)

    def kernel(handles, cols, ranges, nvalid: int):
        dev = handles.device
        live = torch.arange(n, device=dev) < nvalid
        handles = handles.to(torch.int64)
        # lanes may be stored narrow (int32 dict codes / bounded values). The
        # default batch upcasts integer lanes to int64; binder-proven narrow
        # expressions evaluate on the storage-dtype view instead
        cols_nw = cols
        cols = tuple(
            (d.to(torch.int64) if not d.is_floating_point() and d.dtype != torch.bool else d, v)
            for d, v in cols_nw
        )
        if full_scan:
            mask = live  # the caller proved range coverage
        else:
            # ranges: (MAX_RANGES, 2) host array; empty slots have lo >= hi
            mask = torch.zeros(n, dtype=torch.bool, device=dev)
            for lo, hi in ranges:
                if lo < hi:
                    mask = mask | ((handles >= int(lo)) & (handles < int(hi)))
            mask = mask & live  # padding rows are never live
        batch = EvalBatch(list(cols), [None] * len(cols), n)
        batch_nw = EvalBatch(list(cols_nw), [None] * len(cols_nw), n)
        kind = "rows"
        count = None
        ngroups = None

        for ex, pre in zip(executors[1:], parsed):
            if ex.tp == dagpb.SELECTION:
                nok = getattr(ex, "narrow_ok", [])
                for ci_, cond in enumerate(pre):
                    src = batch_nw if ci_ < len(nok) and nok[ci_] else batch
                    d, v, _ = eval_expr(cond, src, torch)
                    keep = _bcast(d, n, dev) != 0
                    if v is not None:
                        keep = keep & _vmask(v, n, dev)
                    mask = mask & keep
            elif ex.tp in (dagpb.AGGREGATION, dagpb.STREAM_AGG):
                group_exprs, aggs, route, doms = pre
                gnar = getattr(ex, "group_narrow", [])
                gvals = []
                for gi_, g in enumerate(group_exprs):
                    src = batch_nw if gi_ < len(gnar) and gnar[gi_] else batch
                    d, v, _ = eval_expr(g, src, torch)
                    d, v = _bcast(d, n, dev), _vmask(v, n, dev)
                    gvals.append((torch.where(v, d, 0), v))
                if route == "eqmask":
                    out_data, out_valid, ngroups = _eqmask_agg(group_exprs, aggs, doms, gvals, batch, mask, dev)
                else:
                    B = _dense_b_total(doms)
                    seg, strides = _mxu_seg(gvals, doms, mask, B, dev)
                    pairs, pair_bounds, lane_of_agg, occ_lane = _mxu_pairs(
                        aggs, getattr(ex, "arg_bounds", ()), getattr(ex, "arg_narrow", ()), batch, batch_nw, mask, dev
                    )
                    seg32 = seg.to(torch.int32)
                    if route == "dot":
                        counts, sums = grouped_sums_dot(seg32, pairs, B, n, pair_bounds)
                    else:
                        counts, sums = grouped_sums(seg32, pairs, B, n, pair_bounds, device=dev)
                    out_data, out_valid, ngroups = _mxu_outputs(
                        counts, sums, lane_of_agg, occ_lane, aggs, doms, strides, B, dev
                    )
                out_len = int(out_data[0].shape[0])
                gvalid_slot = torch.arange(out_len, device=dev) < ngroups
                out_valid = [ov & gvalid_slot for ov in out_valid]
                batch = EvalBatch(list(zip(out_data, out_valid)), [None] * len(out_data), out_len)
                batch_nw = batch  # lanes rebuilt: the storage-dtype view is stale
                mask = gvalid_slot
                kind = "agg"
            else:  # TOPN
                order, limit = pre
                batch, mask, count = _topn(ex, order, limit, batch, mask, dev)
                batch_nw = batch
                kind = "rows"

        # ngroups travels out so the caller detects agg-cap overflow
        og = ngroups if ngroups is not None else -1
        offsets = dag.output_offsets or list(range(len(batch.cols)))
        if kind == "agg":
            return _pack([batch.cols[i] for i in offsets], ngroups, og, dev)
        cur_n = batch.n
        if count is None:
            # compact selected rows to the front
            perm = torch.argsort(_sortable(~mask), stable=True)
            count = torch.clamp(mask.sum(), max=out_n)
            outs = [(_bcast(d, cur_n, dev)[perm][:out_n], _vmask(v, cur_n, dev)[perm][:out_n]) for d, v in batch.cols]
            return _pack([outs[i] for i in offsets], count, og, dev)
        outs = [(_bcast(d, cur_n, dev), _vmask(v, cur_n, dev)) for d, v in batch.cols]
        return _pack([outs[i] for i in offsets], count, og, dev)

    return CompiledKernel(kernel, "agg" if agg_is_last else "rows", out_n, agg_cap, lanes_holder)
