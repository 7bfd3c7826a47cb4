"""Grouped COUNT/SUM as int8 matrix products (port of
tidb_tpu/ops/mxu_groupby.py: the dense route for B ≤ 64).

Values bias to non-negative by their proven lower bound and split into
8-bit limbs, each re-biased by -128 into [-128, 127] so full bytes ride
signed int8; one (B, rows) one-hot × (rows, C) limb product per ≤ 2^23-row
chunk accumulates exactly in int32 (128 · 2^23 = 2^30), and the chunks sum
in int64. A per-bucket occupancy column undoes the -128 bias at
recombination. The product is ``torch._int_mm``, exact on the CPU and on
the GPU's int8 tensor cores.
"""

from __future__ import annotations

import torch

_CHUNK = 1 << 23  # int32 accumulator headroom: 255 * 2^23 < 2^31
_LIMB_BITS = 8
_LIMB_MASK = (1 << _LIMB_BITS) - 1
_LIMB_BIAS = 1 << (_LIMB_BITS - 1)
MAX_B = 64  # the one-hot is materialized (B, chunk) int8


def rollup_bucket_space(doms) -> int:
    """Total bucket-window space of WITH ROLLUP's prefix grouping sets: the
    binder's device gate reads it, and the program's (G+1)-hot dot
    (``dag_kernel._rollup_layout``) spans exactly this many buckets."""
    total = 0
    for k in range(len(doms), -1, -1):
        b_k = 1
        for dom in doms[:k]:
            b_k *= dom + 1
        total += b_k
    return total


def _limbs_needed(span: int) -> int:
    n = 1
    while span >> (_LIMB_BITS * n):
        n += 1
    return n


def dot_plan(pairs, bounds):
    """Static lane plan: per-lane (bias, limb count, span), the column
    layout, and the weight/limb column assignments (same layout rules as the
    reference: weight columns dedup by lane identity, pairs sharing value
    and weight share limb columns, constant lanes carry none)."""
    L = len(pairs)
    bounds = list(bounds) if bounds is not None else [None] * L
    plans = []
    for (v, _w), b in zip(pairs, bounds):
        if b is not None:
            lo, hi = int(b[0]), int(b[1])
        else:
            # dtype envelope — callers must prove bounds for int64 lanes
            info = torch.iinfo(v.dtype)
            lo, hi = int(info.min), int(info.max)
            if hi - lo >= (1 << 62):
                raise ValueError("unbounded int64 lane: prove bounds before the dot path")
        plans.append((lo, _limbs_needed(max(hi - lo, 0)), max(hi - lo, 0)))

    col_specs = [("occ",)]  # bucket occupancy: the biased-limb corrector
    w_col_of = []
    w_ids: dict[int, int] = {}
    for i, (_v, w) in enumerate(pairs):
        wid = id(w)
        if wid not in w_ids:
            w_ids[wid] = len(col_specs)
            col_specs.append(("w", i))
        w_col_of.append(w_ids[wid])
    limb_cols_of: list[list[int]] = []
    lane_ids: dict[tuple, int] = {}
    for i, (lo, nl, _span) in enumerate(plans):
        if nl == 1 and bounds[i] is not None and int(bounds[i][0]) == int(bounds[i][1]):
            limb_cols_of.append([])  # constant lane: sum = cnt * lo, no limbs
            continue
        key = (id(pairs[i][0]), id(pairs[i][1]), lo, nl)
        dup = lane_ids.get(key)
        if dup is not None:
            limb_cols_of.append(limb_cols_of[dup])
            continue
        lane_ids[key] = i
        cols_i = []
        for k in range(nl):
            cols_i.append(len(col_specs))
            col_specs.append(("limb", i, k))
        limb_cols_of.append(cols_i)
    return (plans, col_specs, w_col_of, limb_cols_of, len(col_specs))


def _pad8(x: int) -> int:
    return -(-x // 8) * 8


def dot_acc(seg, pairs, B: int, n: int, plan, acc=None):
    """Accumulate one batch's grouped int8 products into ``acc`` (B, C)
    int64, chunked so the int32 accumulator never overflows. ``seg`` may
    be a list of grouping-set windows ``(seg lane, lo, hi)``: each row then
    falls in one bucket of each window, and the one-hot becomes one-hot per
    window — every grouping set of a ROLLUP in the same product."""
    plans, col_specs, _w_col_of, _limb_cols_of, C = plan
    windows = seg if isinstance(seg, list) else [(seg, 0, B)]
    dev = windows[0][0].device

    def build_cols(sl):
        cols = []
        shifted = {}
        rows = sl.stop - sl.start
        for spec in col_specs:
            if spec[0] == "occ":
                cols.append(torch.ones(rows, dtype=torch.int8, device=dev))
            elif spec[0] == "w":
                cols.append(pairs[spec[1]][1][sl].to(torch.int8))
            else:
                _, i, k = spec
                if i not in shifted:
                    v, w = pairs[i]
                    lo, _nl, span = plans[i]
                    if v.dtype == torch.int32 and span < (1 << 31) and -(1 << 31) <= lo:
                        # narrow lane + proven span: the bias subtract and
                        # the limb shifts stay in int32
                        vb = torch.where(w[sl], v[sl] - lo, 0)
                    else:
                        vb = torch.where(w[sl], v[sl].to(torch.int64) - lo, 0)
                        if span < (1 << 31):
                            vb = vb.to(torch.int32)
                    shifted[i] = vb
                cols.append((((shifted[i] >> (_LIMB_BITS * k)) & _LIMB_MASK) - _LIMB_BIAS).to(torch.int8))
        return torch.stack(cols, dim=0)  # (C, rows)

    if acc is None:
        acc = torch.zeros(B, C, dtype=torch.int64, device=dev)
    # torch._int_mm on CUDA wants m > 16 and k, n multiples of 8: pad the
    # bucket rows to ≥ 32, the limb columns and the chunk rows to multiples
    # of 8 — padded rows and columns are zero, so they add nothing
    B_pad = max(32, _pad8(B))
    C_pad = _pad8(C)
    bidx = torch.arange(B, dtype=torch.int32, device=dev)
    for start in range(0, n, _CHUNK):
        sl = slice(start, min(start + _CHUNK, n))
        rows = sl.stop - sl.start
        k_pad = _pad8(rows)
        onehot = torch.zeros(B_pad, k_pad, dtype=torch.int8, device=dev)
        for s, lo, hi in windows:
            onehot[lo:hi, :rows] = (s[sl][None, :] == bidx[lo:hi, None]).to(torch.int8)
        limbs = torch.zeros(C_pad, k_pad, dtype=torch.int8, device=dev)
        limbs[:C, :rows] = build_cols(sl)
        # (C, rows) row-major transposed = (rows, C) column-major: the int8
        # GEMM's preferred operand layout
        part = torch._int_mm(onehot, limbs.t())
        acc = acc + part[:B, :C].to(torch.int64)
    return acc


def dot_recombine(acc, plan, L: int, B: int):
    """(B, C) limb accumulator → exact (counts, sums), both (B, L) int64."""
    plans, _col_specs, w_col_of, limb_cols_of, _C = plan
    occ = acc[:, 0]  # rows per bucket (weight-independent)
    counts, sums = [], []
    for i in range(L):
        cnt = acc[:, w_col_of[i]]
        lo, _nl, _span = plans[i]
        s = torch.zeros(B, dtype=torch.int64, device=acc.device)
        for k, cidx in enumerate(limb_cols_of[i]):
            # every bucket-routed row contributed (limb - 128) to this
            # column, so the exact per-bucket correction is occupancy * 128
            s = s + ((acc[:, cidx] + occ * _LIMB_BIAS) << (_LIMB_BITS * k))
        sums.append(s + cnt * lo)
        counts.append(cnt)
    return torch.stack(counts, dim=1), torch.stack(sums, dim=1)


def grouped_sums_dot(seg, pairs, B: int, n: int, bounds=None):
    """Exact grouped COUNT/SUM via int8 products.

    seg    : (n,) int32 — bucket per row in [0, B); dead rows ≥ B.
    pairs  : [(int lane, bool weight lane)].
    bounds : per pair (lo, hi) proven value bounds, or None (dtype envelope).
    → (counts int64 (B, L), sums int64 (B, L)).
    """
    plan = dot_plan(pairs, bounds)
    acc = dot_acc(seg, pairs, B, n, plan)
    return dot_recombine(acc, plan, len(pairs), B)
