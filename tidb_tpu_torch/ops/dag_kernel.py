"""The fused DAG program (port of tidb_tpu/ops/dag_kernel.py).

One program per (DAG, padded rows per block, agg cap, blocks, delta cap): scan →
selection* → aggregation / TopN / LIMIT / PROJECTION over one region's
padded columns, packed into one int64 buffer (and a float64 one when a lane
is floating) whose row 0 is the meta row ``[count, ngroups]``. PyTorch runs
eagerly, so "compiling" parses the DAG and fixes every route; the program
cache is keyed exactly as the reference's (``get_kernel``).

Routes ported, chosen by the reference's rule and constants:

- Selection: a row mask (no compaction); the 8-range handle mask unless
  the caller proved the ranges cover the region (``full_scan``).
- Aggregation by dense bucket arithmetic over dictionary-coded keys:
  the equality-mask reduce for B ≤ 32 (and every scalar aggregation), the
  int8 dot (``mxu_groupby``) for B ≤ 64, and K1 (``grouped_sums``, the
  hand-written CUDA kernel) for 64 < B ≤ 512 with n ≤ 8,000,000 rows,
  n % 1024 == 0.
- Aggregation by lex sort for everything else (keys without a small
  dictionary domain, more buckets, the bit aggregates): a stable multi-lane
  sort, segment boundaries, COUNT/SUM by cumulative-sum deltas, MIN/MAX by
  order statistics, BIT_AND/OR/XOR by a segmented log-doubling scan.
- TopN: the single-key top-k with the rank-code key that packs the row
  position into the value (exact ties), else a stable lexicographic sort.
  LIMIT: the first live rows by a top-k on the negated position.
- WITH ROLLUP: every grouping set in one pass, each set owning a window
  of the bucket space and each row one bucket per window, so the int8 dot's
  one-hot becomes (G+1)-hot (``_rollup_layout``).
- Several blocks (``nb > 1``): the blocks concatenate into one program with
  a per-block live mask, or, for an aggregation the int8 dot provably
  carries, accumulate one limb matrix per block (``_blockwise_dot``).
- The delta operand (``delta_cap`` > 0): committed changes pending on the
  region's pinned entry, padded to a fixed capacity. The program masks
  the base rows whose handles it holds, unions its live rows after the
  base rows, and ranks every row in ascending-handle order (``hrank``) so
  that first_row, the sort and TopN tie-breaks, LIMIT and row compaction
  follow the host engine's scan order. The rows in one program are then
  ``n_pad * nb + delta_cap``, and the routes read that count.

- WINDOW: the sorted-batch window program (``window_core.window_program``)
  over every row of the program. An aggregation that follows reads the rows
  in sorted order (no inverse permutation), with the base columns it needs
  sorted along; any other consumer gets the original row order back. A
  window program takes no delta operand: the engine merges the delta first.
- Device warnings: every expression evaluates with a ``_DeviceWarnSink``,
  whose per-site counts (division by zero: 1365) ride the meta row after
  ``[count, ngroups]``; ``CompiledKernel.warn_specs`` names their slots.

- Complete mode (``AGG_COMPLETE``, what an MPP task sends): each route's
  partial lanes collapse on the device to one final lane per aggregate
  (``_finalize_device``) before the group keys.
"""

from __future__ import annotations

import threading
import time
from dataclasses import dataclass
from types import SimpleNamespace
from typing import Callable

import numpy as np
import torch

from tidb_tpu_torch.copr import dagpb
from tidb_tpu_torch.copr.binder import UnsupportedForDevice
from tidb_tpu_torch.expression.expr import AggDesc, ColumnRef, EvalBatch, _ft_from_pb, eval_expr, expr_from_pb
from tidb_tpu_torch.ops.grouped_sums import _BLK, MAX_ROWS, grouped_sums
from tidb_tpu_torch.ops.mxu_groupby import MAX_B as _DOT_MAX_B
from tidb_tpu_torch.ops.mxu_groupby import dot_acc, dot_plan, dot_recombine, grouped_sums_dot
from tidb_tpu_torch.ops.window_core import _seg_running, derive_specs, seg_value_sorted, window_program
from tidb_tpu_torch.types import TypeKind

MAX_RANGES = 8
_I64_MAX = np.iinfo(np.int64).max
_I64_MIN = np.iinfo(np.int64).min
_I32_MIN = np.iinfo(np.int32).min
# the equality-mask reduce does B*n work per lane; past this many buckets the
# int8 dot (≤ MAX_B) or K1 (≤ _DENSE_MXU_MAX) takes over
_DENSE_EQMASK_MAX = 32
_DENSE_MXU_MAX = 512
# below this many rows a bucket space of B ≤ 32 stays on the equality-mask
# reduce: the dense product routes amortize their fixed cost above it
_MXU_MIN_ROWS = 1 << 21
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


def _key_doms(group_exprs, scan):
    """Per-key dictionary domains when every key is a scan column with one,
    else None."""
    doms = []
    for g in group_exprs:
        if isinstance(g, ColumnRef) and g.index < len(scan.domains) and scan.domains[g.index] > 0:
            doms.append(scan.domains[g.index])
        else:
            return None
    return doms


def _rollup_layout(group_exprs, scan):
    """The static grouping-set layout of WITH ROLLUP: the prefix sets
    (g1..gG), ..., (g1), () each own a window of the bucket space, widest
    first → {"doms", "G", "windows": [(k, offset, B_k, strides)],
    "B_total"}, or None when a key has no dictionary domain."""
    doms = _key_doms(group_exprs, scan)
    if doms is None:
        return None
    windows = []
    off = 0
    for k in range(len(doms), -1, -1):
        stride = 1
        strides = []
        for dom in reversed(doms[:k]):
            strides.append(stride)
            stride *= dom + 1
        windows.append((k, off, stride, list(reversed(strides))))
        off += stride
    return {"doms": doms, "G": len(doms), "windows": windows, "B_total": off}


def _has_bit(aggs) -> bool:
    return any(pk in ("bit_and", "bit_or", "bit_xor") for a in aggs for pk in a.partial_kinds)


def agg_route(ex, group_exprs, aggs, scan, n: int, agg_cap: int):
    """("eqmask" | "dot" | "k1" | "lex", doms) for one aggregation executor
    over ``n`` rows — the reference's rule (tidb_tpu/ops/dag_kernel.py:
    775-823) with its constants. Bit aggregates reduce with non-additive
    operators, which only the lex-sort path's segmented scan handles."""
    if _has_bit(aggs):
        return "lex", []
    if not group_exprs:
        return "eqmask", []
    doms = _key_doms(group_exprs, scan)
    if doms is None:
        return "lex", []
    bt = _dense_b_total(doms)
    sums_ok = _mxu_aggs_ok(aggs, getattr(ex, "arg_bounds", ()))
    dot_fits = bt <= min(agg_cap, _DOT_MAX_B) and sums_ok
    mxu_fits = bt <= min(agg_cap, _DENSE_MXU_MAX) and sums_ok and n <= MAX_ROWS and n % _BLK == 0
    if (dot_fits or mxu_fits) and (bt > _DENSE_EQMASK_MAX or n >= _MXU_MIN_ROWS):
        return ("dot" if dot_fits else "k1"), doms
    if bt <= min(agg_cap, _DENSE_EQMASK_MAX):
        return "eqmask", doms
    return "lex", []


class _DeviceWarnSink:
    """The device's warning channel for one program run (the analog of
    stmtctx.AppendWarning): each (code, msg) site an expression body reports
    adds one count, a 0-d int64 tensor on the device that is never read on
    the host inside the program; ``_pack`` writes the counts into the meta
    row and the engine turns nonzero ones into session warnings. Counts are
    per row over valid lanes; rows a later mask drops may be included."""

    def __init__(self):
        self.items: list = []  # [(code, msg, count)]

    def add_traced(self, code: int, msg: str, cnt) -> None:
        self.items.append((code, msg, cnt))

    def __call__(self, level, code, msg):  # a host-style call: count 1
        self.items.append((code, msg, 1))


@dataclass
class CompiledKernel:
    # (handles, cols, ranges, nvalid) -> packed buffer(s); with nb > 1,
    # handles and every column are per-block sequences and nvalid holds one
    # live-row count per block
    fn: Callable
    kind: str  # "rows" | "agg"
    out_n: int  # static output row capacity
    agg_cap: int
    # written by each run's packing step; every run of one program writes
    # the same values
    _lanes: dict
    routes: tuple = ()  # the route of each aggregation executor, in order
    blockwise: bool = False  # multi-block int8 dot: one limb matrix per block

    @property
    def lane_loc(self):  # per-output ("i"|"f", row index) into packed buffer(s)
        return self._lanes["loc"]

    @property
    def valid_loc(self):  # per-output row index of the valid lane (int buffer)
        return self._lanes["vloc"]

    @property
    def warn_specs(self):  # [(code, msg, meta_slot)] packed at meta[slot]
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
    ranges, so the program skips the handle range mask. A newly built
    program carries the first-call build probe (``_arm_compile_probe``)."""
    key = (dag.fingerprint(), n_pad, agg_cap, nb, full_scan, delta_cap)
    with _CACHE_MU:
        k = _COMPILE_CACHE.get(key)
    if k is None:
        k = _build(dag, n_pad, agg_cap, nb, full_scan, delta_cap)
        _arm_compile_probe(k)
        with _CACHE_MU:
            _COMPILE_CACHE[key] = k
    return k


def _arm_compile_probe(k: CompiledKernel) -> None:
    """Attribute a new program's cold cost, keyed like the program cache,
    so "cold" means one thing to the metric and to dispatch. PyTorch runs
    eagerly and compiles nothing ahead: here "compile" is the first call of
    a freshly built program, with the lazy loading of each CUDA module the
    call reaches for the first time (torch's kernels, the int8 GEMM's
    setup) and, when first reached, K1's nvcc build and load
    (``native.cuda``). The first call ends with ``torch.cuda.synchronize``
    on the output's device, so its wall holds that work and not only the
    launches; the sync is part of the cold cost, warm calls pay nothing.
    The wall goes under a ``jit-compile`` trace span into the active cop
    task's ``compile_ms`` and into ``COP_COMPILE_SECONDS``. Exactly one
    caller claims it (a cold fan-out over several regions enters here on
    every worker); the probe then unhooks itself, so warm calls run the
    bare program."""
    inner = k.fn
    claim = threading.Lock()
    state = {"claimed": False}

    def first_call(*args, **kwargs):
        with claim:
            mine = not state["claimed"]
            state["claimed"] = True
        if not mine:
            return inner(*args, **kwargs)
        from tidb_tpu_torch.utils import execdetails as _ed
        from tidb_tpu_torch.utils import metrics as _m

        t0 = time.perf_counter()
        with _ed.trace_span("jit-compile"):
            out = inner(*args, **kwargs)
            dev = (out[0] if isinstance(out, tuple) else out).device
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
        dt = time.perf_counter() - t0
        k.fn = inner  # warm path: no wrapper left behind
        det = _ed.current_cop()
        if det is not None:
            det.compile_ms += dt * 1000.0
        _m.COP_COMPILE_SECONDS.observe(dt)
        return out

    k.fn = first_call


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


def _cat_lane(d: torch.Tensor, dd: torch.Tensor) -> torch.Tensor:
    """Base lane ++ delta lane in their common dtype: a base lane stored
    as int32 widens when a delta value lies outside the int32 envelope."""
    dt = torch.promote_types(d.dtype, dd.dtype)
    return torch.cat([d.to(dt), dd.to(dt)])


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


def _complete(ex) -> bool:
    return ex.agg_mode == dagpb.AGG_COMPLETE


def _finalize_device(aggs, state_data, state_valid):
    """Collapse partial lanes → final values, on device (complete mode):
    decimal AVG at the result's scale (the argument's + 4), rounded half
    away from zero; VAR/STDDEV, pop and samp, from (count, sum, sum of
    squares) in float64. Divisions are tensor by tensor on the lanes'
    device (a CPU scalar divisor would round differently on the card)."""
    out_d, out_v = [], []
    i = 0
    for a in aggs:
        if a.name == "avg":
            cnt, s = state_data[i], state_data[i + 1]
            i += 2
            denom = cnt.clamp(min=1)
            if a.ftype.kind == TypeKind.DECIMAL:
                num = s * (10**4)
                out_d.append(torch.sign(num) * ((num.abs() + denom // 2) // denom))
            else:
                out_d.append(s.to(torch.float64) / denom)
            out_v.append(cnt > 0)
        elif a.name in ("var_pop", "var_samp", "stddev_pop", "stddev_samp"):
            cnt, s, sq = state_data[i], state_data[i + 1], state_data[i + 2]
            i += 3
            scale = 10.0 ** a.arg.ftype.scale if a.arg.ftype.kind == TypeKind.DECIMAL else 1.0
            scale_t = torch.full((), scale, dtype=torch.float64, device=cnt.device)
            nf = cnt.to(torch.float64)
            sv = s.to(torch.float64) / scale_t
            sqv = sq.to(torch.float64) / (scale_t * scale_t)
            mean = sv / nf.clamp(min=1)
            varp = (sqv / nf.clamp(min=1) - mean * mean).clamp(min=0.0)
            if a.name.endswith("_samp"):
                v = varp * nf / (nf - 1).clamp(min=1)
                ok = cnt > 1
            else:
                v, ok = varp, cnt > 0
            out_d.append(torch.sqrt(v) if a.name.startswith("stddev") else v)
            out_v.append(ok)
        else:
            out_d.append(state_data[i])
            out_v.append(state_valid[i])
            i += 1
    return out_d, out_v


def _build(dag: dagpb.DAGRequest, n_pad: int, agg_cap: int, nb: int = 1, full_scan: bool = False, delta_cap: int = 0) -> CompiledKernel:
    executors = dag.executors
    scan = executors[0]
    if scan.tp != dagpb.TABLE_SCAN:
        raise UnsupportedForDevice(f"{scan.tp} scans are not ported")
    D = delta_cap
    if D and any(ex.tp == dagpb.WINDOW for ex in executors[1:]):
        # windows tie-break by row position inside window_core; the engine
        # merges the delta first instead of shipping it
        raise ValueError("window DAG cannot take a delta operand")
    n_total = n_pad * nb  # base rows: every block of a fused region
    n = n_total + D  # rows in one program once the delta unions in
    # parse every executor and fix every route now: the program raises
    # before it touches the device, never halfway through a run
    parsed: list = []
    for ex in executors[1:]:
        if ex.tp == dagpb.SELECTION:
            parsed.append([expr_from_pb(c) for c in ex.conditions])
        elif ex.tp in (dagpb.AGGREGATION, dagpb.STREAM_AGG):
            group_exprs = [expr_from_pb(g) for g in ex.group_by]
            aggs = [AggDesc.from_pb(a) for a in ex.aggs]
            if any("group_concat" in a.partial_kinds for a in aggs):
                raise UnsupportedForDevice("group_concat has no partial state to push down")
            if getattr(ex, "rollup", False):
                # WITH ROLLUP runs only as the (G+1)-hot int8 dot; the
                # binder gates the same conditions (_gate_device_rollup)
                layout = _rollup_layout(group_exprs, scan)
                if (
                    layout is None
                    or layout["B_total"] > _DOT_MAX_B
                    or not _mxu_aggs_ok(aggs, getattr(ex, "arg_bounds", ()))
                ):
                    raise UnsupportedForDevice("device rollup needs dictionary-domain keys and bounded sums")
                parsed.append((group_exprs, aggs, "rollup", layout))
                continue
            route, doms = agg_route(ex, group_exprs, aggs, scan, n, agg_cap)
            parsed.append((group_exprs, aggs, route, doms))
        elif ex.tp == dagpb.TOPN:
            parsed.append(([(expr_from_pb(p), d) for p, d in ex.order_by], ex.limit))
        elif ex.tp == dagpb.LIMIT:
            parsed.append(ex.limit)
        elif ex.tp == dagpb.PROJECTION:
            parsed.append([expr_from_pb(e) for e in ex.exprs])
        elif ex.tp == dagpb.WINDOW:
            funcs_ir = [
                SimpleNamespace(name=f["name"], args=[expr_from_pb(a) for a in f["args"]], ftype=_ft_from_pb(f["ft"]))
                for f in ex.win_funcs
            ]
            fr = ex.frame
            res = derive_specs(
                funcs_ir,
                whole_partition=fr == "whole",
                rows_frame=fr == "rows_cur",
                frame=tuple(fr[1:]) if isinstance(fr, tuple) else None,
                # the binder legalized string order keys to sorted-dictionary
                # codes, so codes ARE order-comparable here
                order_is_string=False,
            )
            if res is None:
                raise ValueError("window shape not device-supported (planner gate missed)")
            parsed.append(
                (
                    [expr_from_pb(p) for p in ex.partition_by],
                    [(expr_from_pb(p), d) for p, d in ex.order_by],
                    res[0],
                    res[1],
                    funcs_ir,
                    [tuple(b) if b is not None else None for b in ex.sort_bounds] or None,
                )
            )
        else:
            raise UnsupportedForDevice(f"executor {ex.tp} is not ported")

    agg_is_last = bool(executors[1:]) and executors[-1].tp in (dagpb.AGGREGATION, dagpb.STREAM_AGG)
    topn_like = [ex for ex in executors[1:] if ex.tp in (dagpb.TOPN, dagpb.LIMIT)]
    out_n = n
    if agg_is_last:
        out_n = agg_cap
    elif topn_like:
        # tight power-of-two (floor 32): small K keeps top-k candidate sets tiny
        lim = max(ex.limit for ex in topn_like)
        out_n = min(n, max(32, 1 << max(lim - 1, 0).bit_length()))
    # a multi-block [scan, selection*, agg-last] DAG whose aggregation rides
    # the int8 dot accumulates one limb matrix per block instead of
    # concatenating the blocks (the reference's _static_dot_route, :522);
    # the delta operand has no per-block shape, so it takes the concat path
    blockwise = (
        nb > 1
        and not D
        and agg_is_last
        and all(ex.tp == dagpb.SELECTION for ex in executors[1:-1])
        and (
            parsed[-1][2] == "dot"
            or (parsed[-1][2] == "rollup" and parsed[-1][3]["B_total"] <= min(agg_cap, _DOT_MAX_B))
        )
    )
    routes = tuple(p[2] for ex, p in zip(executors[1:], parsed) if ex.tp in (dagpb.AGGREGATION, dagpb.STREAM_AGG))

    lanes_holder: dict = {}

    def _range_mask(handles, ranges, live):
        # ranges: (MAX_RANGES, 2) host array; empty slots have lo >= hi
        mask = torch.zeros_like(live)
        for lo, hi in ranges:
            if lo < hi:
                mask = mask | ((handles >= int(lo)) & (handles < int(hi)))
        return mask & live  # padding rows are never live

    def _batches(cols_nw, nn, dws):
        # lanes may be stored narrow (int32 dict codes / bounded values). The
        # default batch upcasts integer lanes to int64; binder-proven narrow
        # expressions evaluate on the storage-dtype view instead
        cols = tuple(
            (d.to(torch.int64) if not d.is_floating_point() and d.dtype != torch.bool else d, v)
            for d, v in cols_nw
        )
        return (
            EvalBatch(list(cols), [None] * len(cols), nn, warn=dws),
            EvalBatch(list(cols_nw), [None] * len(cols_nw), nn, warn=dws),
        )

    def _select(ex, conds, batch, batch_nw, mask, nn, dev):
        nok = getattr(ex, "narrow_ok", [])
        for ci_, cond in enumerate(conds):
            src = batch_nw if ci_ < len(nok) and nok[ci_] else batch
            d, v, _ = eval_expr(cond, src, torch)
            keep = _bcast(d, nn, dev) != 0
            if v is not None:
                keep = keep & _vmask(v, nn, dev)
            mask = mask & keep
        return mask

    def _group_vals(ex, group_exprs, batch, batch_nw, nn, dev):
        gnar = getattr(ex, "group_narrow", [])
        gvals = []
        for gi_, g in enumerate(group_exprs):
            src = batch_nw if gi_ < len(gnar) and gnar[gi_] else batch
            d, v, _ = eval_expr(g, src, torch)
            d, v = _bcast(d, nn, dev), _vmask(v, nn, dev)
            gvals.append((torch.where(v, d, 0), v))
        return gvals

    def _mxu_seg(gvals, doms, mask, B, nn, dev):
        # int32 bucket arithmetic when every key lane is narrow
        seg_dtype = torch.int32 if gvals and all(d.dtype == torch.int32 for d, _ in gvals) else torch.int64
        seg = torch.zeros(nn, dtype=seg_dtype, device=dev)
        stride = 1
        strides = []
        for (d, v), dom in zip(reversed(gvals), reversed(doms)):
            adj = torch.where(v, d, dom)  # NULLs → extra bucket
            seg = seg + adj * stride
            strides.append(stride)
            stride *= dom + 1
        strides = list(reversed(strides))  # align with gvals order
        return torch.where(mask, seg, B), strides

    def _mxu_pairs(aggs, arg_bounds, arg_narrow, batch, batch_nw, mask, nn, dev):
        pairs = []
        pair_bounds = []
        lane_of_agg = []
        zero64 = torch.zeros(nn, dtype=torch.int64, device=dev)
        arg_memo: dict = {}  # SUM(x) + AVG(x) share one lane set
        for ai, a in enumerate(aggs):
            count_only = all(pk == "count" for pk in a.partial_kinds)
            if a.arg is not None:
                nw = ai < len(arg_narrow) and arg_narrow[ai]
                memo_key = repr(a.arg.to_pb())
                got = arg_memo.get(memo_key)
                if got is None:
                    d0, v0, _ = eval_expr(a.arg, batch_nw if nw else batch, torch)
                    d0 = _bcast(d0, nn, dev)
                    # proven-narrow args keep their int32 lanes
                    if not d0.is_floating_point() and d0.dtype != torch.int32:
                        d0 = d0.to(torch.int64)
                    # never-null args share the one mask object: the dot
                    # dedups weight columns by identity
                    w0 = mask if v0 is None else mask & _vmask(v0, nn, dev)
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
        pairs.append((torch.zeros(nn, dtype=torch.int64, device=dev), mask))  # occupancy
        pair_bounds.append((0, 0))
        return pairs, pair_bounds, lane_of_agg, occ_lane

    def _mxu_outputs(counts, sums, lane_of_agg, occ_lane, aggs, doms, strides, B, dev, complete):
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
        if complete:
            out_data, out_valid = _finalize_device(aggs, out_data, out_valid)
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

    def _rollup_segs(layout, gvals, mask, nn, dev):
        # per grouping set a global bucket lane (window offset + local
        # bucket); dead rows point past every window
        B_total = layout["B_total"]
        segs = []
        for k, off, b_k, strides in layout["windows"]:
            seg_dtype = torch.int32 if all(d.dtype == torch.int32 for d, _ in gvals[:k]) else torch.int64
            seg = torch.zeros(nn, dtype=seg_dtype, device=dev)
            for (d, v), dom, st in zip(gvals[:k], layout["doms"][:k], strides):
                seg = seg + torch.where(v, d, dom) * st  # NULLs → their own bucket
            segs.append((torch.where(mask, seg + off, B_total).to(torch.int32), off, off + b_k))
        return segs

    def _rollup_outputs(counts, sums, lane_of_agg, occ_lane, aggs, layout, dev, complete):
        # bucket lanes → [agg partials, keys (NULL where rolled up), GROUPING
        # flags], compacted to the occupied buckets
        B_total, doms = layout["B_total"], layout["doms"]
        out_data, out_valid = [], []
        for a, li in zip(aggs, lane_of_agg):
            cnt = counts[:, li]
            for pk in a.partial_kinds:
                out_data.append(cnt if pk == "count" else sums[:, li])  # sum (gated by _mxu_aggs_ok)
                out_valid.append(torch.ones(B_total, dtype=torch.bool, device=dev) if pk == "count" else cnt > 0)
        if complete:
            out_data, out_valid = _finalize_device(aggs, out_data, out_valid)
        occupied = counts[:, occ_lane] > 0
        flags = []  # the flags follow every key
        for j in range(layout["G"]):
            dparts, vparts, fparts = [], [], []
            for k, off, b_k, strides in layout["windows"]:
                if j < k:
                    code = (torch.arange(b_k, device=dev) // strides[j]) % (doms[j] + 1)
                    kv = (code != doms[j]) & occupied[off : off + b_k]
                    dparts.append(torch.where(kv, code, 0))
                    vparts.append(kv)
                    fparts.append(torch.zeros(b_k, dtype=torch.int64, device=dev))
                else:  # rolled-up key: NULL, flag 1
                    dparts.append(torch.zeros(b_k, dtype=torch.int64, device=dev))
                    vparts.append(torch.zeros(b_k, dtype=torch.bool, device=dev))
                    fparts.append(torch.ones(b_k, dtype=torch.int64, device=dev))
            out_data.append(torch.cat(dparts))
            out_valid.append(torch.cat(vparts))
            flags.append(torch.cat(fparts))
        for f in flags:
            out_data.append(f)
            out_valid.append(torch.ones(B_total, dtype=torch.bool, device=dev))
        order = torch.argsort(_sortable(~occupied), stable=True)
        out_cap = min(B_total, agg_cap)
        return [o[order][:out_cap] for o in out_data], [o[order][:out_cap] for o in out_valid], occupied.sum()

    def _collect_aggs(aggs, eval_arg, reducers, first_pos, first_pos_c, ones_n, dev):
        # the per-partial-kind switch both reduction paths share;
        # reducers(d, v) returns the path's reduce callables
        out_data, out_valid = [], []
        for a in aggs:
            d, v = eval_arg(a)
            red = reducers(d, v)
            cnt = red["count"]()
            for pk in a.partial_kinds:
                if pk == "count":
                    out_data.append(cnt)
                    out_valid.append(torch.ones(ones_n, dtype=torch.bool, device=dev))
                elif pk == "sum":
                    isf = a.arg is not None and a.arg.ftype.kind == TypeKind.FLOAT
                    out_data.append(red["sumf"]() if isf else red["sum"]())
                    out_valid.append(cnt > 0)
                elif pk == "sumsq":
                    out_data.append(red["sumsq"]())
                    out_valid.append(cnt > 0)
                elif pk in ("min", "max"):
                    if d.is_floating_point():
                        sentinel = float("inf") if pk == "min" else float("-inf")
                    else:
                        sentinel = _I64_MAX if pk == "min" else _I64_MIN
                    out_data.append(red[pk](sentinel))
                    out_valid.append(cnt > 0)
                elif pk in ("bit_and", "bit_or", "bit_xor"):
                    out_data.append(red[pk]())
                    out_valid.append(torch.ones(ones_n, dtype=torch.bool, device=dev))
                else:  # first_row
                    out_data.append(d[first_pos_c])
                    out_valid.append(v[first_pos_c] & (first_pos < n))
        return out_data, out_valid

    def _eval_arg(a, batch, dev):
        if a.arg is not None:
            d, v, _ = eval_expr(a.arg, batch, torch)
            return _bcast(d, n, dev), _vmask(v, n, dev)
        return torch.ones(n, dtype=torch.int64, device=dev), torch.ones(n, dtype=torch.bool, device=dev)

    def _eqmask_agg(aggs, doms, gvals, batch, mask, hrank, dev, complete):
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
        if hrank is not None:
            # first_row and the key come from the group's lowest-handle row
            # (the host engine's scan order): delta rows sit at the tail
            minr = torch.where(livem, hrank[None, :], n).amin(dim=1)
            first_pos = torch.where(livem & (hrank[None, :] == minr[:, None]), pos[None, :], n).amin(dim=1)
        else:
            first_pos = torch.where(livem, pos[None, :], n).amin(dim=1)
        first_pos_c = first_pos.clamp(0, n - 1).to(torch.int64)

        def reducers(d, v):
            wm = livem & v[None, :]
            return {
                "count": lambda: wm.sum(dim=1),
                "sum": lambda: torch.where(wm, d[None, :], 0).sum(dim=1),
                "sumf": lambda: torch.where(wm, d[None, :].to(torch.float64), 0.0).sum(dim=1),
                "sumsq": lambda: torch.where(wm, d[None, :].to(torch.float64) ** 2, 0.0).sum(dim=1),
                "min": lambda s: torch.where(wm, d[None, :], s).amin(dim=1),
                "max": lambda s: torch.where(wm, d[None, :], s).amax(dim=1),
            }

        out_data, out_valid = _collect_aggs(
            aggs, lambda a: _eval_arg(a, batch, dev), reducers, first_pos, first_pos_c, B, dev
        )
        if complete:
            out_data, out_valid = _finalize_device(aggs, out_data, out_valid)
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

    def _lex_agg(aggs, gvals, batch, mask, hrank, dev, complete):
        # stable sort by (live first, then per key: NULL last, value); each
        # group becomes one contiguous run, dead rows trail the last group
        lanes = [~mask]
        for d, v in gvals:
            lanes.append(~v)
            lanes.append(d)
        if hrank is not None:
            lanes.append(hrank)  # within a group: handle order (first_row)
        perm = _lex_perm(lanes)
        sm = mask[perm]
        diff = torch.zeros(n, dtype=torch.bool, device=dev)
        for d, v in gvals:
            ds, vs = d[perm], v[perm]
            diff[1:] |= (ds[1:] != ds[:-1]) | (vs[1:] != vs[:-1])
        diff[0] = True
        boundary = sm & diff
        seg = (torch.cumsum(boundary, 0) - 1).clamp(min=0)
        ngroups = boundary.sum()
        ks = torch.arange(agg_cap, device=dev)
        # seg is nondecreasing → group k spans [searchsorted(seg, k, left),
        # searchsorted(seg, k, right))
        starts = torch.searchsorted(seg, ks)
        starts_c = starts.clamp(0, n - 1)
        ends_c = (torch.searchsorted(seg, ks, right=True) - 1).clamp(0, n - 1)
        slot_live = ks < ngroups
        first_pos = torch.where(slot_live, starts, n)
        first_pos_c = starts_c

        def csum_delta(x):
            cs = torch.cumsum(x, 0)
            lo = torch.where(starts_c > 0, cs[(starts_c - 1).clamp(min=0)], 0)
            return torch.where(slot_live, cs[ends_c] - lo, 0)

        # each row's group start, for the bit aggregates' segmented scan;
        # eager PyTorch would compute it even when no lane reads it (XLA
        # drops the unused value in the reference)
        seg_ps = None
        if _has_bit(aggs):
            seg_ps = torch.cummax(
                torch.where(boundary, torch.arange(n, dtype=torch.int32, device=dev), -1), dim=0
            ).values

        def seg_scan_red(x, op):
            return _seg_running(x, seg_ps, op, n)[ends_c]

        def seg_extreme(w, d, which):
            # grouped extreme by order statistics: invalid rows sink under a
            # +max sentinel of the lane's own dtype, so min = the group's
            # start slot, max = start + valid_count - 1
            top = float("inf") if d.is_floating_point() else torch.iinfo(d.dtype).max
            lane2 = seg_value_sorted(torch.where(w, d, top), seg)
            if which == "min":
                return torch.where(slot_live, lane2[starts_c], 0)
            cw = csum_delta(w.to(torch.int64))
            last = (starts + cw - 1).clamp(0, n - 1)
            return torch.where(slot_live, lane2[last], 0)

        def eval_arg(a):
            if a.arg is not None:
                d, v = _eval_arg(a, batch, dev)
                return d[perm], v[perm]
            return _eval_arg(a, batch, dev)

        def reducers(d, v):
            w = sm & v
            return {
                "count": lambda: csum_delta(w.to(torch.int64)),
                "sum": lambda: csum_delta(torch.where(w, d, 0)),
                "sumf": lambda: csum_delta(torch.where(w, d.to(torch.float64), 0.0)),
                "sumsq": lambda: csum_delta(torch.where(w, d.to(torch.float64) ** 2, 0.0)),
                "min": lambda s: seg_extreme(w, d, "min"),
                "max": lambda s: seg_extreme(w, d, "max"),
                "bit_and": lambda: seg_scan_red(torch.where(w, d, -1), torch.bitwise_and),
                "bit_or": lambda: seg_scan_red(torch.where(w, d, 0), torch.bitwise_or),
                "bit_xor": lambda: seg_scan_red(torch.where(w, d, 0), torch.bitwise_xor),
            }

        out_data, out_valid = _collect_aggs(aggs, eval_arg, reducers, first_pos, first_pos_c, agg_cap, dev)
        if complete:
            out_data, out_valid = _finalize_device(aggs, out_data, out_valid)
        for gd, gv in gvals:
            at = perm[first_pos_c]
            out_data.append(gd[at])
            out_valid.append(gv[at] & (first_pos < n))
        return out_data, out_valid, ngroups

    def _dense_agg(aggs, route, doms, gvals, ex, batch, batch_nw, mask, dev):
        B = _dense_b_total(doms)
        seg, strides = _mxu_seg(gvals, doms, mask, B, n, dev)
        pairs, pair_bounds, lane_of_agg, occ_lane = _mxu_pairs(
            aggs, getattr(ex, "arg_bounds", ()), getattr(ex, "arg_narrow", ()), batch, batch_nw, mask, n, dev
        )
        seg32 = seg.to(torch.int32)
        if route == "dot":
            counts, sums = grouped_sums_dot(seg32, pairs, B, n, pair_bounds)
        else:
            counts, sums = grouped_sums(seg32, pairs, B, n, pair_bounds, device=dev)
        return _mxu_outputs(counts, sums, lane_of_agg, occ_lane, aggs, doms, strides, B, dev, _complete(ex))

    def _topn(ex, order, limit, batch, mask, hrank, dev):
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
                    # ties rank by handle order (the row position without a delta)
                    pidx = hrank if hrank is not None else torch.arange(cur_n, device=dev)
                    vkey = torch.where(mask & v, rank_code * cur_n + (cur_n - 1 - pidx), _I64_MIN)
            _, idx_val = _hier_top_k(vkey, K)
            # NULL rows in handle order: the key is the unique position or rank
            pos_n = hrank if hrank is not None else torch.arange(cur_n, dtype=torch.int32, device=dev)
            _, idx_null = _hier_top_k(torch.where(mask & ~v, -pos_n, _I32_MIN), K)
            cand = torch.cat([idx_val, idx_null])
            # a top-k slot past the true count points at an arbitrary row
            live_c = torch.cat([(mask & v)[idx_val], (mask & ~v)[idx_null]])
            zeros_k = torch.zeros(K, dtype=torch.int64, device=dev)
            ones_k = torch.ones(K, dtype=torch.int64, device=dev)
            tier = torch.cat([zeros_k, ones_k]) if desc else torch.cat([ones_k, zeros_k])  # ASC: NULLs first
            ckey = torch.where(live_c, key[cand], 0)
            tie = hrank[cand] if hrank is not None else cand
            perm2 = _lex_perm([~live_c, tier, -ckey if isf else ~ckey, tie])
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
            if hrank is not None:
                lanes.append(hrank)  # ties in handle order
            head = _lex_perm(lanes)[: min(out_n, cur_n)]
        return _take(batch, head, mask, limit, dev)

    def _limit(limit, batch, mask, hrank, dev):
        # the first live rows in handle order, O(n): the key is the unique
        # negated position (or handle rank), so top-k ties cannot arise
        cur_n = batch.n
        pos = hrank if hrank is not None else torch.arange(cur_n, dtype=torch.int32, device=dev)
        _, head = _hier_top_k(torch.where(mask, -pos, _I32_MIN), min(out_n, cur_n))
        return _take(batch, head, mask, limit, dev)

    def _take(batch, head, mask, limit, dev):
        cur_n = batch.n
        head_n = int(head.shape[0])
        batch = EvalBatch(
            [(_bcast(d2, cur_n, dev)[head], _vmask(v2, cur_n, dev)[head]) for d2, v2 in batch.cols],
            batch.dicts,
            head_n,
            warn=batch.warn,
        )
        count = torch.clamp(mask.sum(), max=limit)
        return batch, torch.arange(head_n, device=dev) < count, count

    def _project(exprs, batch, dev):
        cur_n = batch.n
        cols = []
        for e in exprs:
            d, v, _ = eval_expr(e, batch, torch)
            cols.append((_bcast(d, cur_n, dev), _vmask(v, cur_n, dev)))
        return EvalBatch(cols, [None] * len(cols), cur_n, warn=batch.warn)

    def _window(exi, pre, batch, mask, dev):
        part_exprs, order_pairs, frame_tag, specs, funcs_ir, bounds = pre

        def lane(e):
            d, v, _ = eval_expr(e, batch, torch)
            return _bcast(d, n, dev), _vmask(v, n, dev)

        part_lanes = [lane(e) for e in part_exprs]
        order_lanes = [lane(e) for e, _ in order_pairs]
        # None (not a zeros pair) for a function without argument: argument
        # lanes ride the sort as payloads
        arg_lanes = [lane(f.args[0]) if sp[1] else None for f, sp in zip(funcs_ir, specs)]
        base_cols = [(_bcast(d, n, dev), _vmask(v, n, dev)) for d, v in batch.cols]
        agg_next = exi + 1 < len(parsed) and executors[2 + exi].tp in (dagpb.AGGREGATION, dagpb.STREAM_AGG)
        ship: list = []
        if agg_next:
            # only the base columns the aggregation reads ride the sort
            from tidb_tpu_torch.planner.optimizer import _expr_cols

            used: set = set()
            g_exprs, a_descs = parsed[exi + 1][:2]
            for e in g_exprs:
                _expr_cols(e, used)
            for a in a_descs:
                if a.arg is not None:
                    _expr_cols(a.arg, used)
            ship = sorted(i for i in used if i < len(base_cols))
        outs, perm, sm, base_sorted = window_program(
            mask=mask,
            part_lanes=part_lanes,
            order_lanes=order_lanes,
            order_descs=[d for _, d in order_pairs],
            frame_tag=frame_tag,
            specs=specs,
            arg_lanes=arg_lanes,
            n=n,
            bounds=bounds,
            extra_lanes=[base_cols[i] for i in ship],
        )
        if agg_next:
            # an aggregation reads rows in any order: everything stays
            # sorted, and unread columns keep their unsorted lanes (the
            # aggregation never evaluates them)
            new_cols = list(base_cols)
            for i, pair in zip(ship, base_sorted):
                new_cols[i] = pair
            new_cols += outs
            mask = sm
        else:
            inv = torch.empty_like(perm)
            inv[perm] = torch.arange(n, device=dev)
            new_cols = base_cols + [(d[inv], v[inv]) for d, v in outs]
        return EvalBatch(new_cols, list(batch.dicts) + [None] * len(outs), n, warn=batch.warn), mask

    def _pack(outs, count, og, dev, dws):
        loc: list = []
        vloc: list = []
        ilanes: list = []
        flanes: list = []
        # meta row: [count, ngroups, warning counts...]: the warnings ride
        # the same copy off the card as the data
        witems = dws.items
        L = max(max((int(d.shape[0]) if d.dim() else 1) for d, _ in outs) if outs else 2, 2 + len(witems))
        meta = torch.zeros(L, dtype=torch.int64, device=dev)
        meta[0] = count
        meta[1] = og
        for wi, (_code, _msg, cnt) in enumerate(witems):
            meta[2 + wi] = cnt
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
        warns = tuple((code, msg, 2 + wi) for wi, (code, msg, _c) in enumerate(witems))
        lanes_holder.update({"loc": tuple(loc), "vloc": tuple(vloc), "warns": warns})
        if flanes:
            return torch.stack(ilanes), torch.stack(flanes)
        return torch.stack(ilanes)

    def _pack_groups(out_data, out_valid, ngroups, dev, dws):
        out_len = int(out_data[0].shape[0])
        gvalid_slot = torch.arange(out_len, device=dev) < ngroups
        out_valid = [ov & gvalid_slot for ov in out_valid]
        offsets = dag.output_offsets or list(range(len(out_data)))
        return _pack([(out_data[i], out_valid[i]) for i in offsets], ngroups, ngroups, dev, dws)

    def _blockwise_dot(handles_blocks, cols_blocks, ranges, nvalid, dws):
        # one (B, C) limb accumulator carried across the blocks: no
        # concatenation of the region's columns
        group_exprs, aggs, route, doms = parsed[-1]
        agg_ex = executors[-1]
        layout = doms if route == "rollup" else None
        B = layout["B_total"] if layout is not None else _dense_b_total(doms)
        dev = handles_blocks[0].device
        acc = plan = strides = lane_of_agg = occ_lane = n_pairs = None
        for b in range(nb):
            live = torch.arange(n_pad, dtype=torch.int32, device=dev) < int(nvalid[b])
            mask_b = live if full_scan else _range_mask(handles_blocks[b].to(torch.int64), ranges, live)
            batch_b, batch_nw_b = _batches(tuple(c[b] for c in cols_blocks), n_pad, dws)
            for ex, pre in zip(executors[1:-1], parsed[:-1]):
                mask_b = _select(ex, pre, batch_b, batch_nw_b, mask_b, n_pad, dev)
            gvals_b = _group_vals(agg_ex, group_exprs, batch_b, batch_nw_b, n_pad, dev)
            if layout is not None:
                seg, strides_b = _rollup_segs(layout, gvals_b, mask_b, n_pad, dev), None
            else:
                seg, strides_b = _mxu_seg(gvals_b, doms, mask_b, B, n_pad, dev)
                seg = seg.to(torch.int32)
            pairs, pair_bounds, lane_of_agg, occ_lane = _mxu_pairs(
                aggs, getattr(agg_ex, "arg_bounds", ()), getattr(agg_ex, "arg_narrow", ()),
                batch_b, batch_nw_b, mask_b, n_pad, dev,
            )
            if plan is None:
                # one lane plan serves every block: identical code builds each
                # block's pair list, so the dedup pattern cannot differ
                plan = dot_plan(pairs, pair_bounds)
                strides = strides_b
                n_pairs = len(pairs)
            acc = dot_acc(seg, pairs, B, n_pad, plan, acc)
        counts, sums = dot_recombine(acc, plan, n_pairs, B)
        if layout is not None:
            out_data, out_valid, ngroups = _rollup_outputs(
                counts, sums, lane_of_agg, occ_lane, aggs, layout, dev, _complete(agg_ex)
            )
        else:
            out_data, out_valid, ngroups = _mxu_outputs(
                counts, sums, lane_of_agg, occ_lane, aggs, doms, strides, B, dev, _complete(agg_ex)
            )
        return _pack_groups(out_data, out_valid, ngroups, dev, dws)

    def _rollup_agg(ex, aggs, layout, gvals, batch, batch_nw, mask, dev):
        # every grouping set in one (G+1)-hot int8 dot over the rows
        segs = _rollup_segs(layout, gvals, mask, n, dev)
        pairs, pair_bounds, lane_of_agg, occ_lane = _mxu_pairs(
            aggs, getattr(ex, "arg_bounds", ()), getattr(ex, "arg_narrow", ()), batch, batch_nw, mask, n, dev
        )
        plan = dot_plan(pairs, pair_bounds)
        acc = dot_acc(segs, pairs, layout["B_total"], n, plan)
        counts, sums = dot_recombine(acc, plan, len(pairs), layout["B_total"])
        return _rollup_outputs(counts, sums, lane_of_agg, occ_lane, aggs, layout, dev, _complete(ex))

    def _fold_delta(handles, handles_blocks, live, cols, nvalid, dh, dcols, dtomb, dn):
        # dn = (mask_n, union_lo, union_hi): every program masks against the
        # whole delta, and only rows [union_lo, union_hi) union in
        mask_n, u_lo, u_hi = (int(x) for x in dn)
        dev = handles.device
        dh = dh.to(torch.int64)  # sorted; pads hold int64-max
        # 1) a base row whose handle the delta holds is superseded (updated
        # or deleted): the delta carries the fresh verdict
        pos = torch.searchsorted(dh, handles)
        posc = pos.clamp(0, D - 1)
        live = live & ~((dh[posc] == handles) & (posc < mask_n))
        # 2) hrank: each row's place in ascending-handle order over base and
        # delta. A base row's rank is its live index plus the delta handles
        # before it; a delta row's is its index plus the live base handles
        # at or before it (base first on equal handles)
        if nb > 1:
            nv = torch.as_tensor(nvalid, dtype=torch.int32)
            offs = (torch.cumsum(nv, 0) - nv).to(dev)
            iota = torch.arange(n_total, dtype=torch.int32, device=dev)
            li = (iota % n_pad) + offs[iota // n_pad]
            cntb = torch.zeros(D, dtype=torch.int32, device=dev)
            blk = torch.arange(n_pad, device=dev)
            for b in range(nb):
                hb = torch.where(blk < int(nvalid[b]), handles_blocks[b].to(torch.int64), _I64_MAX)
                cntb += torch.searchsorted(hb, dh, right=True).to(torch.int32)
        else:
            li = torch.arange(n_total, dtype=torch.int32, device=dev)
            hsrt = torch.where(li < int(nvalid), handles, _I64_MAX)
            cntb = torch.searchsorted(hsrt, dh, right=True).to(torch.int32)
        diota = torch.arange(D, dtype=torch.int32, device=dev)
        hrank = torch.cat([li + pos.to(torch.int32), diota + cntb])
        # 3) union the fresh rows (tombstones only mask, never union); a
        # narrow base lane widens to its delta lane's dtype
        dlive = (diota >= u_lo) & (diota < u_hi) & ~dtomb
        cols = tuple(
            (_cat_lane(d, dd), torch.cat([v, dv])) for (d, v), (dd, dv) in zip(cols, dcols)
        )
        return torch.cat([handles, dh]), torch.cat([live, dlive]), cols, hrank

    def kernel(handles, cols, ranges, nvalid, dh=None, dcols=None, dtomb=None, dn=None):
        dws = _DeviceWarnSink()  # this run's warnings: runs may overlap in threads
        handles_blocks = None
        if nb > 1:
            if blockwise:
                return _blockwise_dot(handles, cols, ranges, nvalid, dws)
            # the fused program: blocks concatenate, each block's padding
            # stays at its tail and is masked by the block's own count
            handles_blocks = handles
            dev = handles[0].device
            handles = torch.cat(handles)
            cols = tuple((torch.cat([p[0] for p in c]), torch.cat([p[1] for p in c])) for c in cols)
            iota = torch.arange(n_total, dtype=torch.int32, device=dev)
            nv = torch.as_tensor(nvalid, dtype=torch.int32).to(dev)
            live = (iota % n_pad) < nv[iota // n_pad]
        else:
            dev = handles.device
            live = torch.arange(n_total, device=dev) < nvalid
        handles = handles.to(torch.int64)
        hrank = None  # rows' handle order where it differs from their position
        if D:
            handles, live, cols, hrank = _fold_delta(handles, handles_blocks, live, cols, nvalid, dh, dcols, dtomb, dn)
        mask = live if full_scan else _range_mask(handles, ranges, live)  # full_scan: coverage proven
        batch, batch_nw = _batches(cols, n, dws)
        kind = "rows"
        count = None
        ngroups = None

        for exi, (ex, pre) in enumerate(zip(executors[1:], parsed)):
            if ex.tp == dagpb.SELECTION:
                mask = _select(ex, pre, batch, batch_nw, mask, n, dev)
                continue
            if ex.tp in (dagpb.AGGREGATION, dagpb.STREAM_AGG):
                group_exprs, aggs, route, doms = pre
                gvals = _group_vals(ex, group_exprs, batch, batch_nw, n, dev)
                if route == "rollup":
                    out_data, out_valid, ngroups = _rollup_agg(ex, aggs, doms, gvals, batch, batch_nw, mask, dev)
                elif route == "eqmask":
                    out_data, out_valid, ngroups = _eqmask_agg(aggs, doms, gvals, batch, mask, hrank, dev, _complete(ex))
                elif route == "lex":
                    out_data, out_valid, ngroups = _lex_agg(aggs, gvals, batch, mask, hrank, dev, _complete(ex))
                else:
                    out_data, out_valid, ngroups = _dense_agg(aggs, route, doms, gvals, ex, batch, batch_nw, mask, dev)
                out_len = int(out_data[0].shape[0])
                gvalid_slot = torch.arange(out_len, device=dev) < ngroups
                out_valid = [ov & gvalid_slot for ov in out_valid]
                batch = EvalBatch(list(zip(out_data, out_valid)), [None] * len(out_data), out_len, warn=dws)
                mask = gvalid_slot
                kind = "agg"
                hrank = None  # rows rebuilt: no longer the scan's
            elif ex.tp == dagpb.TOPN:
                order, limit = pre
                batch, mask, count = _topn(ex, order, limit, batch, mask, hrank, dev)
                kind = "rows"
                hrank = None
            elif ex.tp == dagpb.LIMIT:
                batch, mask, count = _limit(pre, batch, mask, hrank, dev)
                kind = "rows"
                hrank = None
            elif ex.tp == dagpb.WINDOW:
                batch, mask = _window(exi, pre, batch, mask, dev)
            else:  # PROJECTION: the same rows, hrank still holds
                batch = _project(pre, batch, dev)
            batch_nw = batch  # lanes rebuilt: the storage-dtype view is stale

        # ngroups travels out so the caller detects agg-cap overflow
        og = ngroups if ngroups is not None else -1
        offsets = dag.output_offsets or list(range(len(batch.cols)))
        if kind == "agg":
            return _pack([batch.cols[i] for i in offsets], ngroups, og, dev, dws)
        cur_n = batch.n
        if count is None:
            # compact selected rows to the front, in handle order
            perm = _lex_perm([~mask, hrank]) if hrank is not None else torch.argsort(_sortable(~mask), stable=True)
            count = torch.clamp(mask.sum(), max=out_n)
            outs = [(_bcast(d, cur_n, dev)[perm][:out_n], _vmask(v, cur_n, dev)[perm][:out_n]) for d, v in batch.cols]
            return _pack([outs[i] for i in offsets], count, og, dev, dws)
        outs = [(_bcast(d, cur_n, dev), _vmask(v, cur_n, dev)) for d, v in batch.cols]
        return _pack([outs[i] for i in offsets], count, og, dev, dws)

    return CompiledKernel(kernel, "agg" if agg_is_last else "rows", out_n, agg_cap, lanes_holder, routes, blockwise)
