"""The sorted-batch window program and the segmented helpers of the lex-sort
aggregation (port of tidb_tpu/ops/window_core.py).

The window program (``window_program``) is shared by the root's
``WindowExec._try_device`` (through ``ops/window_kernel.py``) and the fused
DAG program's WINDOW executor (``ops/dag_kernel.py``). It evaluates
pkg/executor WindowExec's functions over one padded batch:

  sort rows by (live, partition keys, order keys, row index)
  → partition and peer boundaries → ranking by positional arithmetic,
  framed aggregates by prefix-sum differences and segmented scans.

When every sort lane has integer value bounds, the lex order packs into one
key (``packed_sort``): a stable ``torch.sort`` of an int32 key up to 31
bits, of an int64 key up to 62, and the row index breaks ties. Otherwise a
chain of stable argsorts, one per lane, gives the same order. Partition and
peer extents come from a cumulative sum of the boundary mask and one
scatter of the boundary positions, exact integers with no running max.

Every function takes its device from its input tensors.
"""

from __future__ import annotations

from typing import Callable

import torch

# window functions the device program implements (ref: WindowExec func set)
SUPPORTED = {
    "row_number",
    "rank",
    "dense_rank",
    "percent_rank",
    "cume_dist",
    "ntile",
    "lead",
    "lag",
    "first_value",
    "last_value",
    "count",
    "sum",
    "avg",
    "min",
    "max",
}


def derive_specs(funcs, *, whole_partition, rows_frame, frame, order_is_string):
    """Static device-support check and per-function spec, shared by
    WindowExec's device gate, the planner's pushdown gate and the DAG
    program.

    ``funcs``: WindowFuncDesc-likes (.name, .args Expressions, .ftype).
    Returns (frame_tag, specs) or None when the shape is host-only.
    spec = (name, has_arg, arg_is_float, c0, c1, c2_is_float): the
    constants carry the ntile k, the lead/lag offset and default, and avg's
    decimal scale-up."""
    from tidb_tpu_torch.expression.expr import Constant
    from tidb_tpu_torch.types import TypeKind

    if frame is not None:
        frame_tag = ("rows",) + tuple(frame)
    elif whole_partition:
        frame_tag = "whole"
    elif rows_frame:
        frame_tag = "rows_cur"
    else:
        frame_tag = "range_cur"
    bounded = isinstance(frame_tag, tuple)
    if order_is_string:
        return None  # the caller legalizes string order keys first (sorted dictionary)
    specs = []
    for f in funcs:
        if f.name not in SUPPORTED:
            return None
        if bounded and f.name in ("min", "max"):
            return None  # sliding extreme: host sweep only
        has_arg = bool(f.args)
        is_f = bool(f.args) and f.args[0].ftype.kind == TypeKind.FLOAT
        c0 = c1 = 0
        c2f = False
        if has_arg and f.args[0].ftype.kind == TypeKind.STRING:
            return None
        if f.name == "ntile":
            if not isinstance(f.args[0], Constant) or f.args[0].value is None:
                return None
            c0 = int(f.args[0].value)
            has_arg = False
            if c0 <= 0:
                return None
        elif f.name in ("lead", "lag"):
            if len(f.args) > 1:
                if not isinstance(f.args[1], Constant) or f.args[1].value is None:
                    return None
                c0 = int(f.args[1].value)
            else:
                c0 = 1
            if len(f.args) > 2:
                d2 = f.args[2]
                if not isinstance(d2, Constant) or d2.ftype.kind == TypeKind.STRING:
                    return None
                from tidb_tpu_torch.types.datum import Datum

                c2f = d2.value is not None
                c1 = Datum(d2.value, d2.ftype).physical() if c2f else 0
        elif f.name == "avg":
            c0 = 10 ** (f.ftype.scale - f.args[0].ftype.scale) if f.ftype.kind == TypeKind.DECIMAL else 0
        specs.append((f.name, has_arg, is_f, c0, c1, c2f))
    return frame_tag, tuple(specs)


def seg_value_sorted(lane: torch.Tensor, seg: torch.Tensor) -> torch.Tensor:
    """Re-sort ``lane`` by ``(seg, lane)``: the result stays group-contiguous
    with values ascending inside each group. With invalid rows masked to a
    ``+max`` sentinel of the lane's own dtype, a group's minimum sits at its
    first slot and its maximum at ``start + valid_count - 1``."""
    o = torch.argsort(lane, stable=True)
    return lane[o[torch.argsort(seg[o], stable=True)]]


def _seg_running(x: torch.Tensor, ps: torch.Tensor, op: Callable, n: int) -> torch.Tensor:
    """Segmented inclusive running reduce: ``out[i] = op(x[ps[i]], ...,
    x[i])``, by log-doubling gathers (``ceil(log2 n)`` steps). ``op`` is an
    associative elementwise torch function such as ``torch.bitwise_or``."""
    src0 = torch.arange(n, dtype=torch.int32, device=x.device)
    y = x
    step = 1
    while step < n:
        src = src0 - step
        prev = y[src.clamp(min=0)]
        y = torch.where(src >= ps, op(y, prev), y)
        step <<= 1
    return y


def widen_bounds(bounds):
    """Round (lo, hi) outward to power-of-two envelopes so measured bounds
    stay stable across small data changes: bounds are part of a DAG's
    fingerprint, and coarse buckets keep the program cache warm."""
    out = []
    for b in bounds:
        if b is None:
            out.append(None)
            continue
        lo, hi = int(b[0]), int(b[1])
        lo2 = 0 if lo >= 0 else -(1 << (-lo).bit_length())
        hi2 = (1 << (hi + 1).bit_length()) - 1 if hi >= 0 else 0
        out.append((lo2, hi2))
    return out


def packed_bits(bounds, n: int):
    """Per-lane widths for the packed single-key sort. bounds: [(lo, hi)]
    per sort lane (partition lanes, then order lanes); any None → not
    packable. Returns the lane widths (value span + a NULL slot), or None
    when the key with the live bit and a row index would pass 62 bits."""
    if bounds is None or any(b is None for b in bounds):
        return None
    widths = []
    cap = 2 * max(n, 1)  # live bit × index lane
    for lo, hi in bounds:
        if hi < lo:
            hi = lo
        w = (hi - lo) + 2  # one extra slot for NULL
        widths.append(w)
        cap *= w
        if cap > (1 << 62):
            return None
    return widths


def _u8(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.uint8) if x.dtype == torch.bool else x


def sort_perm(mask, key_lanes, descs, n, bounds=None):
    """Permutation ordering rows by (live first, lanes asc/desc with MySQL
    NULL placement, original index); see :func:`packed_sort`."""
    perm, _key, _pb, _pl = packed_sort(mask, key_lanes, descs, n, bounds)
    return perm


def packed_sort(mask, key_lanes, descs, n, bounds=None, payloads=()):
    """Stable sort by (live first, lanes asc/desc, original index) →
    ``(perm, sorted_key, part_bits, sorted_payloads)``.

    Bounded lanes pack into one key without an index suffix: the stable
    sort supplies index order. Up to 31 bits the key sorts as int32, up to
    62 as one int64 (the same order as the reference's two int32 halves).
    ``sorted_key`` comes back so callers read partition and peer boundaries
    from adjacent key bits (partition codes sit above ``part_bits``), and
    ``payloads`` come back gathered into sorted order.

    Unpackable bounds take the chain of stable argsorts, one per lane from
    the least significant, with ``sorted_key=None``."""
    widths = packed_bits(bounds, n)
    if widths is not None:
        total_bits = 1  # live bit
        spans = []
        for w in widths:
            bits = max(int(w - 1).bit_length(), 1)
            spans.append(bits)
            total_bits += bits
        # partition lanes lead in key_lanes, so their bits sit ABOVE the
        # order bits: callers mask with ``spans`` to split part vs peer
        key = (~mask).to(torch.int64)  # live rows first
        for (d, v), desc, w, bits, (lo, _hi) in zip(key_lanes, descs, widths, spans, bounds):
            d64 = d.to(torch.int64) if not d.is_floating_point() else d
            if desc:
                code = torch.where(v, (lo + w - 2) - d64, w - 1)  # descending values, NULLs last
            else:
                code = torch.where(v, d64 - lo + 1, 0)  # ascending values, NULLs first
            code = code.clamp(0, w - 1)  # dead-row garbage stays in-lane
            key = (key << bits) | code.to(torch.int64)
        if total_bits <= 31:
            key = key.to(torch.int32)
        skey, perm = torch.sort(key, stable=True)
        return perm, skey.to(torch.int64), spans, [p[perm] for p in payloads]
    lanes = [~mask]
    for (d, v), desc in zip(key_lanes, descs):
        if desc:
            lanes.append(~v)  # NULLs last
            lanes.append(-d if d.is_floating_point() else ~d)
        else:
            lanes.append(v)  # NULLs first
            lanes.append(d)
    perm = torch.argsort(_u8(lanes[-1]), stable=True)
    for lane in reversed(lanes[:-1]):
        perm = perm[torch.argsort(_u8(lane)[perm], stable=True)]
    return perm, None, None, [p[perm] for p in payloads]


def _seg_extents(boundary: torch.Tensor, iota: torch.Tensor, n: int):
    """Per row, the first row of its segment and the first row of the next
    segment (``n`` past the last): the segment index is the running count
    of boundaries, and each boundary row writes its position into its
    segment's slot. Rows that are not boundaries write to slots past
    ``n``, one each."""
    sid = torch.cumsum(boundary, 0) - 1
    starts = torch.full((2 * n + 1,), n, dtype=torch.int64, device=iota.device)
    starts.scatter_(0, torch.where(boundary, sid, n + 1 + iota), iota)
    return starts[sid], starts[sid + 1]


def window_program(*, mask, part_lanes, order_lanes, order_descs, frame_tag, specs, arg_lanes, n,
                   bounds=None, extra_lanes=None):
    """The device window computation over one padded batch.

    mask: live-row mask in ORIGINAL row order (False = padding or rows a
    selection dropped). part/order/arg lanes: (data, valid) pairs in
    original order; an arg lane is None for a function without argument.
    bounds: per partition + order lane (lo, hi) or None (see packed_sort).
    Returns (outs_sorted, perm, sm): per function (data, valid) in SORTED
    row order, the sort permutation and the sorted live mask; with
    ``extra_lanes``, a fourth item holds those lanes in sorted order."""
    dev = mask.device
    iota = torch.arange(n, dtype=torch.int64, device=dev)
    # NULL slots mask to 0 so computed-expression garbage can't split a NULL
    # partition or peer group
    part_m = [(torch.where(v, d, 0), v) for d, v in part_lanes]
    order_m = [(torch.where(v, d, 0), v) for d, v in order_lanes]
    key_lanes = part_m + order_m
    descs = [False] * len(part_m) + list(order_descs)
    flat_payloads: list = []
    for al in arg_lanes:
        if al is not None:
            flat_payloads += [al[0], al[1]]
    n_arg_pl = len(flat_payloads)
    for d, v in extra_lanes or ():
        flat_payloads += [d, v]
    perm, skey, spans, sorted_pl = packed_sort(mask, key_lanes, descs, n, bounds, payloads=tuple(flat_payloads))
    sorted_extra = [
        (sorted_pl[n_arg_pl + 2 * i], sorted_pl[n_arg_pl + 2 * i + 1]) for i in range(len(extra_lanes or ()))
    ]
    first = iota == 0
    no = torch.zeros(1, dtype=torch.bool, device=dev)
    if skey is not None:
        # boundaries straight from adjacent sorted-key bits: the live bit +
        # partition codes occupy the bits above the order section, and NULL
        # codes are in-band
        order_bits = sum(spans[len(part_m):])
        pkey = skey >> order_bits
        pboundary = first | torch.cat([no, pkey[1:] != pkey[:-1]])
        peer = pboundary | torch.cat([no, skey[1:] != skey[:-1]])
        # live rows sort first (live bit 0): dead iff any upper bit is set
        sm = (skey >> (order_bits + sum(spans[: len(part_m)]))) == 0
    else:
        sm = mask[perm]
        # dead rows sort last; the live→dead transition starts its own
        # "partition" so dead rows never inflate a real partition's extent
        pboundary = first | torch.cat([no, sm[1:] != sm[:-1]])
        for d, v in part_m:
            ds, vs = d[perm], v[perm]
            pboundary = pboundary | torch.cat([no, (ds[1:] != ds[:-1]) | (vs[1:] != vs[:-1])])
        peer = pboundary
        for d, v in order_m:
            ds, vs = d[perm], v[perm]
            peer = peer | torch.cat([no, (ds[1:] != ds[:-1]) | (vs[1:] != vs[:-1])])

    ps, pe = _seg_extents(pboundary, iota, n)  # partition start, next partition's start
    pos = iota - ps
    m = pe - ps
    peer_first, peer_next = _seg_extents(peer, iota, n)
    peer_end = torch.minimum(peer_next, pe)
    cum_peer = torch.cumsum(peer, 0)
    dense = cum_peer - cum_peer[ps] + 1
    rank = peer_first - ps + 1

    # frame [fs, fe) per row
    if frame_tag == "whole":
        fs, fe = ps, pe
    elif frame_tag == "rows_cur":
        fs, fe = ps, iota + 1
    elif frame_tag == "range_cur":
        fs, fe = ps, peer_end
    else:
        _, sk, sn_, ek, en_ = frame_tag
        if sk == "unbounded":
            fs = ps
        elif sk == "current":
            fs = iota
        elif sk == "preceding":
            fs = torch.maximum(iota - sn_, ps)
        else:
            fs = torch.minimum(iota + sn_, pe)
        if ek == "unbounded":
            fe = pe
        elif ek == "current":
            fe = iota + 1
        elif ek == "preceding":
            fe = torch.maximum(iota - en_ + 1, ps)
        else:
            fe = torch.minimum(iota + en_ + 1, pe)
        fe = torch.maximum(fe, fs)

    def take_fe(c):
        # fe = iota + 1 (ROWS ..CURRENT) makes prefix[fe] a slice
        return c[1:] if frame_tag == "rows_cur" else c[fe]

    def prefix(x):
        return torch.cat([torch.zeros(1, dtype=x.dtype, device=dev), torch.cumsum(x, 0)])

    outs = []
    pl_i = 0
    for (name, has_arg, is_f, c0_, c1_, c2f), al in zip(specs, arg_lanes):
        if al is not None:
            av = sorted_pl[pl_i]
            vv = sorted_pl[pl_i + 1] & sm
            pl_i += 2
        else:
            av = torch.zeros(n, dtype=torch.int64, device=dev)
            vv = sm
        if name == "row_number":
            outs.append((pos + 1, sm))
        elif name == "rank":
            outs.append((rank, sm))
        elif name == "dense_rank":
            outs.append((dense, sm))
        elif name == "percent_rank":
            # divide in float64 (MySQL computes in double)
            pr = (rank - 1).to(torch.float64) / torch.clamp(m - 1, min=1).to(torch.float64)
            outs.append((torch.where(m > 1, pr, 0.0), sm))
        elif name == "cume_dist":
            cd = (peer_end - ps).to(torch.float64) / torch.clamp(m, min=1).to(torch.float64)
            outs.append((cd, sm))
        elif name == "ntile":
            k = c0_
            q, rem = m // k, m % k
            big = rem * (q + 1)
            bucket = torch.where(pos < big, pos // (q + 1), rem + (pos - big) // torch.clamp(q, min=1))
            outs.append((bucket + 1, sm))
        elif name in ("lead", "lag"):
            off = -c0_ if name == "lag" else c0_
            src = pos + off
            ok = (src >= 0) & (src < m)
            gidx = torch.clamp(ps + src, 0, n - 1)
            if isinstance(c1_, float) and not av.is_floating_point():
                av = av.to(torch.float64)  # a float default makes the lane double
            d = torch.where(ok, av[gidx], c1_)
            v = torch.where(ok, vv[gidx], bool(c2f))
            outs.append((d, v & sm))
        elif name in ("first_value", "last_value"):
            ne = fe > fs
            g = torch.clamp(fs if name == "first_value" else fe - 1, 0, n - 1)
            outs.append((torch.where(ne, av[g], 0), ne & vv[g] & sm))
        elif name in ("count", "sum", "avg"):
            w = vv if has_arg else sm
            c0 = prefix(w.to(torch.int64))
            cnt = take_fe(c0) - c0[fs]
            if name == "count":
                outs.append((cnt, sm))
                continue
            filled = torch.where(w, av, 0)
            s0 = prefix(filled.to(torch.float64) if is_f else filled.to(torch.int64))
            cum = take_fe(s0) - s0[fs]
            if name == "sum":
                outs.append((torch.where(cnt > 0, cum, 0), (cnt > 0) & sm))
            else:  # avg; c0_ = scale-up (0 → float avg)
                safe = torch.clamp(cnt, min=1).to(torch.float64)
                if c0_:
                    # half to even, as jnp.round
                    val = torch.round((cum * c0_).to(torch.float64) / safe).to(torch.int64)
                else:
                    val = cum.to(torch.float64) / safe
                outs.append((torch.where(cnt > 0, val, 0), (cnt > 0) & sm))
        elif name in ("min", "max"):
            # segmented running extreme (reset at the partition boundary);
            # whole/range_cur read it at the frame end, rows_cur at the row
            if is_f:
                sent = float("inf") if name == "min" else float("-inf")
            else:
                av = av.to(torch.int64)
                sent = torch.iinfo(torch.int64).max if name == "min" else torch.iinfo(torch.int64).min
            lane = torch.where(vv, av, sent)
            run = _seg_running(lane, ps, torch.minimum if name == "min" else torch.maximum, n)
            c0 = prefix(vv.to(torch.int64))
            cnt = take_fe(c0) - c0[fs]
            sel = run if frame_tag == "rows_cur" else run[torch.clamp(fe - 1, 0, n - 1)]
            outs.append((torch.where(cnt > 0, sel, 0), (cnt > 0) & sm))

    if extra_lanes is not None:
        return outs, perm, sm, sorted_extra
    return outs, perm, sm
