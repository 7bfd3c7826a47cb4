"""MPP fragments as one torch program over virtual shards: the distributed
query step.

The canonical two-fragment MPP plan (ref: fragment.go + mpp_exec.go):

  Fragment 1 (per shard): Scan → Selection → PartialAgg
  ── Hash exchange on group keys (all_to_all) ──
  Fragment 2 (per shard): merge partials for owned key range
  ── PassThrough exchange (all_gather) ──
  root: finalize

The reference runs this as one jitted ``shard_map`` over mesh axis ``dp``.
Here every fragment tensor carries a leading shard axis ``[ndev, rows]``
(``mesh.py``), each shard's work is written once over that axis (``sort``,
``searchsorted``, ``cumsum`` and ``gather`` along the last dimension), and
the fragment boundaries are the mesh module's ``all_to_all``,
``all_gather`` and ``psum``. Per-shard counters (dropped rows, overflow,
exchanged bytes) are ``[ndev]`` vectors until the tail sums them.

Expressions (selections, agg inputs, post-join filters, a stage's
finalize) are the caller's callbacks over one lane per column; they see
every shard's rows as one flat lane, which is what row-wise expressions
need, and their results are viewed back as ``[ndev, rows]``.

Where the reference avoids ``searchsorted`` and scatters because of how a
TPU lowers them, this module takes torch's direct op (noted at each site):
the answers are the same.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Sequence

import numpy as np
import torch

from tidb_tpu_torch.parallel.mesh import all_gather, all_to_all, psum

_I64 = torch.int64


@dataclass
class DistAggSpec:
    """A distributed group-by/aggregate over sharded columns.

    ``n_keys`` leading input columns are the group keys (int lanes);
    ``sums``: indices of value columns to SUM; COUNT(*) always included.
    ``group_cap``: static max distinct groups per shard (and per exchange
    bucket). ``key_bounds``: per data key (lo, hi) value bounds or None —
    bounded keys pack into ONE narrow sort lane (int32 when the domain
    fits), replacing the multi-lane stable-argsort chain with a single
    native sort."""

    n_keys: int
    sums: Sequence[int]
    group_cap: int = 256
    key_bounds: tuple = ()
    # per ``sums`` PAIR (data+valid): "sum" | "min" | "max" — how the value
    # lane reduces within a group (and re-reduces across the exchange)
    val_kinds: tuple = ()
    # distinct aggregates (ref: TiFlash two-phase distinct agg): ``n_dkeys``
    # input lanes AFTER the group keys hold the (shared) distinct argument
    # as a (data, valid) pair. Stage 1 groups by (g, x) — deduping x within
    # g — the exchange routes by g only, and a final per-g reduction counts/
    # sums the surviving distinct slots. ``distinct_mask``: per agg-with-arg
    # (output order), True when its (value, count) output pair reads the
    # distinct slot reduction instead of a plain value lane.
    n_dkeys: int = 0
    distinct_mask: tuple = ()


def _sortable(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.int8) if x.dtype == torch.bool else x


def _argsort(x: torch.Tensor) -> torch.Tensor:
    """Per-shard stable argsort along the row axis."""
    return torch.argsort(_sortable(x), dim=-1, stable=True)


def _lex_perm(lanes) -> torch.Tensor:
    """Per-shard stable lexicographic argsort, ``lanes[0]`` most
    significant (the reference's chain of stable argsorts)."""
    perm = _argsort(lanes[-1])
    for lane in reversed(lanes[:-1]):
        perm = perm.gather(-1, _argsort(lane.gather(-1, perm)))
    return perm


def _kept(cond: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """``x`` where ``cond``, else zero, in ``x``'s own dtype (a validity
    lane stays bool)."""
    return torch.where(cond, x, torch.zeros((), dtype=x.dtype, device=x.device))


def _cumsum(x: torch.Tensor) -> torch.Tensor:
    """Per-shard inclusive prefix sum along the row axis, one shard at a
    time: on the card, torch scans the last dimension of a few long rows
    with a kernel far slower than its one-row device-wide scan (on an
    H100, 31.1 of the 42.9 ms of device time of bench.py's Q3 program at
    4 shards; 12.7 ms in all with this loop)."""
    if x.shape[0] == 1:
        return torch.cumsum(x, -1)
    return torch.stack([torch.cumsum(r, 0) for r in x.unbind(0)])


def _rows(x: torch.Tensor, n: int) -> torch.Tensor:
    """Positions 0..n-1 as ``[ndev, n]``, one row per shard of ``x``."""
    return torch.arange(n, device=x.device).expand(x.shape[0], n).contiguous()


def _search(sorted_: torch.Tensor, q: torch.Tensor, right: bool = False) -> torch.Tensor:
    return torch.searchsorted(sorted_.contiguous(), q.contiguous(), right=right)


def _flat(fn, *lane_lists):
    """Call an expression callback over flat lanes (every shard's rows, in
    shard order) and view its one-mask result back as ``[ndev, rows]``."""
    ndev = lane_lists[0][0].shape[0]
    out = fn(*[[x.reshape(-1) for x in lanes] for lanes in lane_lists])
    return out.reshape(ndev, -1)


def _flat_cols(fn, lanes, ndev: int):
    """Call a lane-list callback (``agg_inputs``) over flat lanes; view
    each returned lane as ``[ndev, rows]``."""
    return [o.reshape(ndev, -1) for o in fn([x.reshape(-1) for x in lanes])]


def _pack_keys(keys, bounds):
    """Collision-FREE packing of bounded key components into one sort lane,
    int32 when the domain fits. Returns (lane, n_codes) or None when any
    component is unbounded/out-of-budget; codes occupy [0, n_codes),
    leaving headroom for dead-row sentinels."""
    if not bounds or any(b is None for b in bounds):
        return None
    spans = []
    total = 1
    for lo, hi in bounds:
        s = int(hi) - int(lo) + 1
        if s < 1:
            s = 1
        spans.append(s)
        total *= s
        if total > (1 << 60):
            return None
    acc = None
    for (lo, _hi), k, s in zip(bounds, keys, spans):
        code = (k.to(_I64) - int(lo)).clamp(0, s - 1)
        acc = code if acc is None else acc * s + code
    if total <= (1 << 30):
        return acc.to(torch.int32), total
    return acc, total


def _seg_sorted(lane: torch.Tensor, seg: torch.Tensor) -> torch.Tensor:
    """``window_core.seg_value_sorted`` per shard: the shards' segment ids
    are offset apart, so one flat sort keeps each shard's rows in its own
    row of the result."""
    from tidb_tpu_torch.ops.window_core import seg_value_sorted

    ndev, n = lane.shape
    off = (torch.arange(ndev, device=lane.device) * n)[:, None]
    return seg_value_sorted(lane.reshape(-1), (seg + off).reshape(-1)).view(ndev, n)


def _segment_partial(keys, vals, mask, cap, bounds=(), val_kinds=()):
    """Sort-based grouped partial agg on every shard (same algorithm as
    ops/dag_kernel.py — key-exact, no hash collisions). Returns (keys,
    sums, counts, overflow): ``overflow`` ([ndev]) counts distinct groups
    beyond ``cap`` — results are invalid unless it is zero, so callers
    surface it and retry with a bigger cap."""
    n = keys[0].shape[-1]
    packed = _pack_keys(keys, bounds)
    diff = torch.zeros(mask.shape, dtype=torch.bool, device=mask.device)
    if packed is not None:
        lane, n_codes = packed
        # one stable sort where the reference's is unstable: equal codes
        # are one group either way
        perm = _argsort(torch.where(mask, lane, n_codes))
        sm = mask.gather(-1, perm)
        ls = lane.gather(-1, perm)
        diff[:, 1:] = ls[:, 1:] != ls[:, :-1]
    else:
        perm = _lex_perm([~mask] + list(keys))
        sm = mask.gather(-1, perm)
        for k in keys:
            ks = k.gather(-1, perm)
            diff[:, 1:] |= ks[:, 1:] != ks[:, :-1]
    diff[:, 0] = True
    boundary = sm & diff
    ngroups = boundary.sum(-1)
    overflow = (ngroups - cap).clamp(min=0)
    seg = (_cumsum(boundary) - 1).clamp(min=0)
    # segmented reduction by cumsum deltas between each group's first and
    # last row (seg is nondecreasing, so searchsorted finds both)
    ks = _rows(seg, cap)
    starts = _search(seg, ks)
    starts_c = starts.clamp(0, n - 1)
    ends_c = (_search(seg, ks, right=True) - 1).clamp(0, n - 1)
    slot_live = ks < ngroups[:, None]

    def _csum_delta(x):
        cs = _cumsum(x)
        lo = torch.where(starts_c > 0, cs.gather(-1, (starts_c - 1).clamp(min=0)), 0)
        return torch.where(slot_live, cs.gather(-1, ends_c) - lo, 0)

    cnt = _csum_delta(sm.to(_I64))
    first = perm.gather(-1, starts_c)
    out_keys = [torch.where(slot_live, k.gather(-1, first), 0) for k in keys]
    out_sums = []
    seg_sorted: dict = {}  # one (seg, value)-sort serves both MIN and MAX
    for vi, v in enumerate(vals):
        kind = val_kinds[vi] if vi < len(val_kinds) else "sum"
        vs = v.gather(-1, perm)
        if kind in ("min", "max"):
            # grouped extreme by order statistics: dead rows sink under a
            # +max sentinel, so min = the group's start slot, max = start +
            # live_count - 1
            vs2 = seg_sorted.get(id(v))
            if vs2 is None:
                sent = float("inf") if vs.is_floating_point() else torch.iinfo(vs.dtype).max
                vs2 = _seg_sorted(torch.where(sm, vs, sent), seg)
                seg_sorted[id(v)] = vs2
            if kind == "min":
                out_sums.append(torch.where(slot_live, vs2.gather(-1, starts_c), 0))
            else:
                last_live = (starts_c + cnt - 1).clamp(0, n - 1)
                out_sums.append(torch.where(slot_live, vs2.gather(-1, last_live), 0))
        else:
            out_sums.append(_csum_delta(torch.where(sm, vs, 0)))
    return out_keys, out_sums, cnt, overflow  # slot i valid iff cnt[i] > 0


def to_host(outs, copy=None) -> list:
    """The program's outputs as numpy arrays through ONE copy off the
    device: every output flattened into one int64 buffer (a float lane's
    bits reinterpreted), copied by ``copy`` (default ``.cpu().numpy()``),
    split and restored to its shape and dtype."""
    outs = list(outs)
    if not outs:
        return []
    buf = torch.cat(
        [o.reshape(-1).view(_I64) if o.dtype == torch.float64 else o.reshape(-1).to(_I64) for o in outs]
    )
    host = copy(buf) if copy is not None else buf.cpu().numpy()
    res, off = [], 0
    for o in outs:
        k = o.numel()
        part = host[off : off + k]
        off += k
        if o.dtype == torch.float64:
            part = part.view(np.float64)
        elif o.dtype != _I64:
            part = part.astype(str(o.dtype).replace("torch.", ""))
        res.append(part.reshape(tuple(o.shape)))
    return res


def build_dist_agg(mesh, spec: DistAggSpec, selection: Callable | None = None):
    """→ fn(*sharded_cols) executing the two-fragment MPP agg (the no-join
    specialization of :func:`build_dist_join_agg`).

    Input: one tensor per column (global length = ndev * local_n, shard k
    holding rows [k * local_n, (k + 1) * local_n)). Output (host arrays):
    (keys..., sums..., count, total) of length ndev * group_cap; slots
    with count==0 are padding. Group-cap overflow is never silent: the
    runner retries with a larger cap until the result is exact.
    """
    from dataclasses import replace

    def run(*cols):
        cap = spec.group_cap
        while True:
            fn = build_dist_join_agg(
                mesh,
                None,
                replace(spec, group_cap=cap),
                n_left=len(cols),
                left_selection=selection,
            )
            outs = to_host(fn(*cols))  # one batched transfer
            if int(outs[-1]) == 0:  # overflow lane
                return outs[:-2]  # drop (dropped, overflow) — both zero
            cap *= 4

    return run


@dataclass
class DistJoinSpec:
    """A distributed equi-join between two sharded sides (ref: the MPP
    shuffle/broadcast hash join, mpp_exec.go join + exchange senders).

    ``left_keys``/``right_keys``: column indices of the join keys (int
    lanes) — left indices address the accumulated probe-side lane layout,
    right indices the build reader's local lanes.
    ``exchange``: "hash" (both sides shuffled by key owner — all_to_all) or
    "broadcast" (right side replicated — all_gather).
    ``row_cap``: static per-destination receive capacity for hash exchange
    (overflow is reported, never silently dropped on the result path);
    ``left_row_cap``/``right_row_cap`` size the two sides independently —
    a small build side must not inherit the probe side's capacity.
    ``unique``: build side proven unique on the key (PK/unique index) →
    match-gather probe, no expansion. Otherwise the join expands each probe
    row to its match count, bounded by ``out_cap`` (overflow retried)."""

    left_keys: Sequence[int]
    right_keys: Sequence[int]
    # inner | left | semi | anti (ref: mpp_exec.go join types; outer fills
    # NULL build lanes, semi/anti filter the probe and append nothing)
    kind: str = "inner"
    exchange: str = "hash"  # hash | broadcast
    row_cap: int = 4096
    left_row_cap: int | None = None
    right_row_cap: int | None = None
    unique: bool = True
    out_cap: int = 8192
    # validity lanes of the join keys: inner-join keys must be non-NULL to
    # match (NULL data slots hold 0, which would otherwise equal a real 0)
    left_key_valid: Sequence[int] = ()
    right_key_valid: Sequence[int] = ()
    # JOINT (both sides) per-key (lo, hi) value bounds or () — bounded keys
    # pack into one narrow exact lane (int32 when the domain fits): native
    # sorts, and component re-verification becomes belt-and-braces
    key_bounds: tuple = ()


def _combine_keys(keys):
    """Mix multiple int64 key lanes into one ordering/bucketing lane.
    Components are verified exactly after matching, so a (cosmically rare)
    mix collision can only cost a missed adjacency, never a false match."""
    h = keys[0].to(_I64)
    for k in keys[1:]:
        # 0x9E3779B97F4A7C15 as signed int64 (two's complement); int64
        # products wrap as the reference's do
        h = h * -7046029254386353131 + k.to(_I64)
    return h


def _exact_pair_lanes(lcomps, rcomps):
    """Collision-FREE single-lane encoding of a multi-component join key
    across BOTH sides, per shard: dense ranks over the union of the two
    sides' local values, folded pairwise with re-compression so the
    accumulator never exceeds span² < 2⁶². Tuple equality ⇔ code equality.
    Returns (lcode, rcode, span): codes lie in [0, span), with span =
    n_left + n_right + 1 a static Python int for dead-row sentinels."""
    nl = lcomps[0].shape[-1]
    span = nl + rcomps[0].shape[-1] + 1

    def ranks(lv, rv):
        comb = torch.cat([lv, rv], dim=-1)
        order = _argsort(comb)
        sv = comb.gather(-1, order)
        newg = torch.zeros(sv.shape, dtype=_I64, device=sv.device)
        newg[:, 1:] = (sv[:, 1:] != sv[:, :-1]).to(_I64)
        rk = _cumsum(newg)
        # the inverse permutation by one scatter (the reference argsorts)
        r = torch.empty_like(rk).scatter_(-1, order, rk)
        return r[:, :nl], r[:, nl:]

    accl, accr = ranks(lcomps[0], rcomps[0])
    for lc, rc in zip(lcomps[1:], rcomps[1:]):
        rl, rr = ranks(lc, rc)
        accl, accr = ranks(accl * span + rl, accr * span + rr)
    return accl, accr, span


def _route_rows(arrays, valid, owner, ndev, cap):
    """Hash-exchange rows to owner shards (all_to_all with static per-dest
    capacity). Returns (received arrays, received valid, per-shard locally
    dropped).

    Rows sort by destination, then every send-buffer slot gathers its row
    (slot (d, r) ← sorted position start_d + r). A slot's source index is
    clamped into the shard before the gather and the slot is kept only
    when its row really is the r-th row for d, so rows beyond ``cap`` for
    one destination are counted as dropped and never indexed."""
    if ndev == 1:
        # single-shard mesh: every row is already home — the exchange is the
        # identity and padding to ``cap`` would only add work
        return list(arrays), valid, torch.zeros(1, dtype=_I64, device=valid.device)
    n = valid.shape[-1]
    okey = torch.where(valid, owner, ndev)
    order = _argsort(okey)
    so = okey.gather(-1, order)
    sv = valid.gather(-1, order)
    # per-destination block starts: ndev+1 queries per shard, not n
    starts = _search(so, _rows(so, ndev + 1))
    rank = torch.arange(n, device=valid.device) - starts.gather(-1, so.clamp(0, ndev))
    dropped = (sv & (rank >= cap)).sum(-1)
    j = torch.arange(ndev * cap, device=valid.device)
    dest = (j // cap).expand(ndev, -1)
    src = starts.gather(-1, dest) + j % cap
    src_c = src.clamp(0, n - 1)
    ok = (src < n) & (so.gather(-1, src_c) == dest) & sv.gather(-1, src_c)
    gidx = order.gather(-1, src_c)  # slot → original row, one composed index
    out_arrays = [all_to_all(_kept(ok, x.gather(-1, gidx)), ndev) for x in arrays]
    out_valid = all_to_all(ok, ndev)
    return out_arrays, out_valid, dropped


def _sorted_lookup(rk_s, lkey):
    """Index of the last element of sorted ``rk_s`` that is <= each lkey,
    clamped into [0, m): torch's ``searchsorted`` (right side, minus one),
    where the reference merges two argsorts because a TPU serializes the
    binary search."""
    m = rk_s.shape[-1]
    return (_search(rk_s, lkey, right=True) - 1).clamp(0, m - 1)


def _local_unique_join(lkey, lkeys, lvalid, rkey, rkeys, rcols, rvalid, dead_build=None, dead_probe=None):
    """Per-shard probe of a unique-key build side: for each left row find its
    right match (≤1 by uniqueness). Returns (gathered right cols, match).
    ``dead_build``/``dead_probe``: sentinels above every live key code
    (packed-lane dtype-aware); default to the mixed-key int64 sentinels."""
    db = 2**62 if dead_build is None else dead_build
    rk = torch.where(rvalid, rkey, db)
    rperm = _argsort(rk)
    rk_s = rk.gather(-1, rperm)
    pkey = lkey if dead_probe is None else torch.where(lvalid, lkey, dead_probe)
    idx = _sorted_lookup(rk_s, pkey)
    ridx = rperm.gather(-1, idx)
    match = (rk_s.gather(-1, idx) == pkey) & lvalid & rvalid.gather(-1, ridx)
    # exact component verification (mix collisions can't fabricate a match)
    for lcomp, rcomp in zip(lkeys, rkeys):
        match &= rcomp.gather(-1, ridx) == lcomp
    gathered = [rc.gather(-1, ridx) for rc in rcols]
    return gathered, match


def _sorted_bounds(rk_s, lkey):
    """For each probe key: (lo, hi) = [count of sorted build keys < key,
    count ≤ key): torch's ``searchsorted`` on both sides (the reference
    merges sorts; see _sorted_lookup). Match count per probe row = hi - lo."""
    return _search(rk_s, lkey), _search(rk_s, lkey, right=True)


def _expand_slots(cnt, out_cap):
    """Static ``out_cap`` output slots over per-probe counts: slot j maps to
    (probe row p, ordinal j - base). Returns (cum, total, overflow, j, p_c,
    base)."""
    cum = _cumsum(cnt)
    n = cnt.shape[-1]
    total = cum[:, -1] if n else torch.zeros(cnt.shape[0], dtype=_I64, device=cnt.device)
    overflow = (total - out_cap).clamp(min=0)
    j = _rows(cnt, out_cap)
    p = _search(cum, j, right=True)  # out_cap queries over n probes
    p_c = p.clamp(0, max(n - 1, 0))
    base = torch.where(p_c > 0, cum.gather(-1, (p_c - 1).clamp(min=0)), 0)
    return cum, total, overflow, j, p_c, base


def _local_expand_join(lkey, lkeys, lvalid, rkey, rkeys, rcols, rvalid, lcols, out_cap,
                       dead_build=None, dead_probe=None, left_outer=False, lmatch=None):
    """Per-shard equi-join with a NON-unique build side: each probe row
    expands to its match count. Output is ``out_cap`` static slots; slot j
    maps back to (probe row, match ordinal) through a cumsum of per-probe
    match counts. ``left_outer``: matchless probe rows still emit ONE slot
    with the build lanes zeroed (NULL-extended); ``lmatch`` narrows which
    live probes may MATCH (NULL-key rows emit but never match). Returns
    (probe-lane outputs, build-lane outputs, live, overflow)."""
    big = 2**62 if dead_build is None else dead_build
    big_p = big - 1 if dead_probe is None else dead_probe
    if lmatch is None:
        lmatch = lvalid
    rk = torch.where(rvalid, rkey, big)
    rperm = _argsort(rk)
    rk_s = rk.gather(-1, rperm)
    pkey = torch.where(lmatch, lkey, big_p)  # dead/NULL-key probes match nothing
    lo, hi = _sorted_bounds(rk_s, pkey)
    mcnt = torch.where(lmatch, hi - lo, 0)  # true match count per probe
    cnt = torch.where(lvalid & (mcnt == 0), 1, mcnt) if left_outer else mcnt
    _cum, total, overflow, j, p_c, base = _expand_slots(cnt, out_cap)
    ridx = (lo.gather(-1, p_c) + (j - base)).clamp(0, rk_s.shape[-1] - 1)
    rsrc = rperm.gather(-1, ridx)
    in_total = j < total[:, None]
    matched = in_total & lmatch.gather(-1, p_c) & (mcnt.gather(-1, p_c) > 0) & rvalid.gather(-1, rsrc)
    # exact component verification: a mixed-key collision inside [lo, hi)
    # kills the slot rather than fabricating a joined row
    for lcomp, rcomp in zip(lkeys, rkeys):
        matched &= rcomp.gather(-1, rsrc) == lcomp.gather(-1, p_c)
    out_left = [lc.gather(-1, p_c) for lc in lcols]
    if left_outer:
        live = in_total & lvalid.gather(-1, p_c)
        out_right = [_kept(matched, rc.gather(-1, rsrc)) for rc in rcols]
    else:
        live = matched
        out_right = [rc.gather(-1, rsrc) for rc in rcols]
    return out_left, out_right, live, overflow


def _local_filtered_exists(lkey, lkeys, lvalid, rkey, rkeys, rcols, rvalid, lcols,
                           out_cap, pair_filter, dead_build=None, dead_probe=None):
    """Existence with non-equality join conditions (semi/anti joins carrying
    ``other_conds``, the Q21 ``l2.l_suppkey <> l1.l_suppkey`` idiom): expand
    each probe row to its candidate matches, verify key components exactly,
    evaluate ``pair_filter`` over the joined (probe lanes, build lanes)
    pairs, and reduce back to a per-probe PASSING-match count via a cumsum
    over the probe-ordered slots. Returns (per-probe pass counts, overflow
    vs ``out_cap``)."""
    big = 2**62 if dead_build is None else dead_build
    big_p = big - 1 if dead_probe is None else dead_probe
    rk = torch.where(rvalid, rkey, big)
    rperm = _argsort(rk)
    rk_s = rk.gather(-1, rperm)
    pkey = torch.where(lvalid, lkey, big_p)
    lo, hi = _sorted_bounds(rk_s, pkey)
    mcnt = torch.where(lvalid, hi - lo, 0)
    cum, total, overflow, j, p_c, base = _expand_slots(mcnt, out_cap)
    ridx = (lo.gather(-1, p_c) + (j - base)).clamp(0, rk_s.shape[-1] - 1)
    rsrc = rperm.gather(-1, ridx)
    cand = (j < total[:, None]) & lvalid.gather(-1, p_c) & (mcnt.gather(-1, p_c) > 0) & rvalid.gather(-1, rsrc)
    for lcomp, rcomp in zip(lkeys, rkeys):
        cand &= rcomp.gather(-1, rsrc) == lcomp.gather(-1, p_c)
    out_l = [lc.gather(-1, p_c) for lc in lcols]
    out_r = [rc.gather(-1, rsrc) for rc in rcols]
    passed = cand & _flat(pair_filter, out_l, out_r)
    cs = _cumsum(passed.to(_I64))
    base_i = cum - mcnt
    end_c = (cum - 1).clamp(0, out_cap - 1)
    below = torch.where(base_i > 0, cs.gather(-1, (base_i - 1).clamp(0, out_cap - 1)), 0)
    cnt_pass = torch.where(mcnt > 0, cs.gather(-1, end_c) - below, 0)
    return cnt_pass, overflow


def _local_match_counts(lkey, lkeys, lvalid, rkey, rkeys, rvalid, dead_build=None, dead_probe=None):
    """Per-probe match count against the build side (semi/anti joins need no
    expansion — just existence). Exact for single-component or packed keys;
    for mixed multi-key hashes a count>0 may be a collision, so callers only
    get this path when keys are packed or single."""
    big = 2**62 if dead_build is None else dead_build
    big_p = big - 1 if dead_probe is None else dead_probe
    rk = torch.where(rvalid, rkey, big)
    rk_s = rk.gather(-1, _argsort(rk))
    pkey = torch.where(lvalid, lkey, big_p)
    lo, hi = _sorted_bounds(rk_s, pkey)
    return torch.where(lvalid, hi - lo, 0)


@dataclass
class DistStageSpec:
    """One device-resident pipeline STAGE producing a build side for the
    next fragment (ref: fragment trees whose exchange receivers feed further
    exchange senders, fragment.go stacked fragments). The staged subplan
    (scan → [join chain] → grouped agg → finalize/having/proj) runs inside
    the SAME program as its consumer; its group slots stay on the device
    and the downstream join re-partitions them with ``all_to_all`` on the
    NEW key.

    Pure data (callables ride the StageRuntime wrapper so this spec can be
    part of a program cache key): ``n_lanes`` per stage-reader input lane
    counts; ``joins`` the left-deep chain INSIDE the stage;
    ``n_keys``/``sums``/``group_cap``/``key_bounds``/``val_kinds`` the
    stage's agg spec (same contract as DistAggSpec); ``out_width`` the
    number of output (data, valid) lane pairs the finalize emits."""

    n_lanes: Sequence[int]
    joins: Sequence[DistJoinSpec]
    n_keys: int
    sums: Sequence[int]
    group_cap: int = 256
    key_bounds: tuple = ()
    val_kinds: tuple = ()
    out_width: int = 0


class StageRuntime:
    """DistStageSpec + the callables that close over bound expressions:
    per-stage-reader selections, the agg-input mapper, and the finalize
    (agg outputs → build lanes + live mask, incl. HAVING/proj). Kept OUT
    of the dataclass so ``repr(spec)`` stays a stable cache key."""

    __slots__ = ("spec", "selections", "agg_inputs", "finalize", "pair_filters", "chain_filters")

    def __init__(self, spec, selections, agg_inputs, finalize, pair_filters=None, chain_filters=()):
        self.spec = spec
        self.selections = selections
        self.agg_inputs = agg_inputs
        self.finalize = finalize
        self.pair_filters = pair_filters
        self.chain_filters = chain_filters  # [(chain position, mask fn)]


def _key_valid(lanes, valid_lanes, like):
    ok = torch.ones(like.shape, dtype=torch.bool, device=like.device)
    for vl in valid_lanes:
        ok = ok & lanes[vl].to(torch.bool)
    return ok


def _fold_join(join, ndev, acc, mask, rcols, rvalid, pf):
    """Fold ONE build side into the accumulated probe layout — the per-join
    body of the fragment pipeline, shared by the outer chain and the join
    chains INSIDE device stages. Returns (acc, mask, dropped, overflow,
    xbytes) deltas ([ndev] each) accumulated into the caller's counters."""
    dev = mask.device
    dropped = torch.zeros(ndev, dtype=_I64, device=dev)
    overflow = torch.zeros(ndev, dtype=_I64, device=dev)
    xbytes = torch.zeros(ndev, dtype=_I64, device=dev)
    kb = tuple(join.key_bounds) if join.key_bounds else None

    def join_lane(comps, _kb=kb):
        p = _pack_keys(comps, _kb) if _kb else None
        if p is None:
            return _combine_keys(comps), None
        return p

    kind = join.kind
    lkeys = [acc[i] for i in join.left_keys]
    rkeys = [rcols[i] for i in join.right_keys]
    # probe rows with NULL keys: inner/semi joins drop them up front;
    # left joins must keep them (NULL-extended), anti joins must keep
    # them (a NULL key matches nothing)
    lkv = _key_valid(acc, join.left_key_valid, mask)
    if kind in ("inner", "semi"):
        mask = mask & lkv
    lkey, ncodes = join_lane(lkeys)
    rkey, _ = join_lane(rkeys)
    if join.exchange == "hash":
        # NULL-key survivors route to shard 0 (they match nothing)
        lowner = torch.where(lkv, lkey.abs().to(_I64) % ndev, 0)
        rowner = rkey.abs().to(_I64) % ndev
        lcap = join.left_row_cap or join.row_cap
        rcap = join.right_row_cap or join.row_cap
        xbytes = xbytes + mask.sum(-1) * (8 * len(acc)) + rvalid.sum(-1) * (8 * len(rcols))
        acc, mask, d1 = _route_rows(acc, mask, lowner, ndev, lcap)
        rcols, rvalid, d2 = _route_rows(rcols, rvalid, rowner, ndev, rcap)
        dropped = dropped + d1 + d2
        lkeys = [acc[i] for i in join.left_keys]
        rkeys = [rcols[i] for i in join.right_keys]
        lkv = _key_valid(acc, join.left_key_valid, mask)
        lkey, ncodes = join_lane(lkeys)
        rkey, _ = join_lane(rkeys)
    else:  # broadcast: replicate the build side on every shard
        xbytes = xbytes + rvalid.sum(-1) * (8 * len(rcols) * max(ndev - 1, 0))
        rcols = [all_gather(c) for c in rcols]
        rvalid = all_gather(rvalid)
        rkeys = [rcols[i] for i in join.right_keys]
        rkey, _ = join_lane(rkeys)
    rlive = rvalid  # post-selection build rows (right joins preserve
    # these even with NULL keys — key validity only gates MATCHING)
    for vl in join.right_key_valid:
        rvalid = rvalid & rcols[vl].to(torch.bool)
    # dead-row sentinels above every live key code (packed lanes stay
    # in their narrow dtype; mixed-hash lanes use the int64 bigs)
    dead_b = None if ncodes is None else ncodes + 1
    dead_p = None if ncodes is None else ncodes
    if (
        ncodes is None
        and len(lkeys) > 1
        and not join.unique
        and (kind == "left" or (kind in ("semi", "anti") and pf is None))
    ):
        # count-based existence / left-outer match counts must be
        # EXACT and no static bounds packed the key — rank-compress
        # the composite key over both sides instead (collision-free)
        lkey, rkey, span = _exact_pair_lanes(lkeys, rkeys)
        dead_b, dead_p = span + 1, span
    probe_live = mask & lkv  # rows eligible to match
    if kind == "right":
        # build-side outer (ref: mpp.go:397 right-out join build):
        # matched pairs emit like inner; build rows NO probe row
        # matched emit once with the probe lanes NULL-extended. With
        # hash exchange each build row lives on exactly one shard, so
        # the unmatched flag is local; with broadcast the flag must
        # AND across shards (psum of per-shard match counts) and only
        # shard 0 emits the survivors.
        if join.unique:
            gathered, match = _local_unique_join(
                lkey, lkeys, probe_live, rkey, rkeys, rcols, rvalid, dead_b, dead_p
            )
            macc = acc + gathered
            mmask = match
        else:
            out_l, out_r, mmask, of = _local_expand_join(
                lkey, lkeys, probe_live, rkey, rkeys,
                rcols, rvalid, acc, join.out_cap, dead_b, dead_p,
                left_outer=False, lmatch=probe_live
            )
            overflow = overflow + of
            macc = out_l + out_r
        # per-build-row probe-match counts (roles swapped; exact —
        # the planner admits single-key right joins only)
        cnt_b = _local_match_counts(
            rkey, rkeys, rvalid, lkey, lkeys, probe_live, dead_b, dead_p
        )
        if join.exchange == "broadcast":
            cnt_b = psum(cnt_b)
            emit = (torch.arange(ndev, device=dev) == 0)[:, None]
            unmatched = rlive & (cnt_b == 0) & emit
        else:
            unmatched = rlive & (cnt_b == 0)
        n_probe_lanes = len(acc)
        rn = rlive.shape[-1]
        acc = [
            torch.cat([a, torch.zeros((ndev, rn), dtype=a.dtype, device=dev)], dim=-1)
            for a in macc[:n_probe_lanes]
        ] + [
            torch.cat([a.to(dt), rc.to(dt)], dim=-1)
            for a, rc in zip(macc[n_probe_lanes:], rcols)
            for dt in (torch.promote_types(a.dtype, rc.dtype),)
        ]
        mask = torch.cat([mmask, unmatched], dim=-1)
    elif kind in ("semi", "anti") and pf is not None:
        # existence gated on non-equality pair conditions: expand,
        # verify, filter, reduce (unique build sides ride the same
        # path — the expansion then has ≤1 candidate per probe row)
        cnt_pass, of = _local_filtered_exists(
            lkey, lkeys, probe_live, rkey, rkeys, rcols, rvalid,
            acc, join.out_cap, pf, dead_b, dead_p,
        )
        overflow = overflow + of
        mask = mask & (cnt_pass > 0) if kind == "semi" else mask & (cnt_pass == 0)
    elif kind in ("semi", "anti") and not join.unique:
        cnt = _local_match_counts(
            lkey, lkeys, probe_live, rkey, rkeys, rvalid, dead_b, dead_p
        )
        mask = mask & (cnt > 0) if kind == "semi" else mask & (cnt == 0)
    elif join.unique:
        gathered, match = _local_unique_join(
            lkey, lkeys, probe_live, rkey, rkeys, rcols, rvalid, dead_b, dead_p
        )
        if kind == "inner":
            mask = match
            acc = acc + gathered
        elif kind == "left":
            # NULL-extend the build lanes for matchless probe rows
            acc = acc + [_kept(match, g) for g in gathered]
        elif kind == "semi":
            mask = match
        else:  # anti
            mask = mask & ~match
    else:
        out_l, out_r, newmask, of = _local_expand_join(
            lkey, lkeys, probe_live if kind == "inner" else mask, rkey, rkeys,
            rcols, rvalid, acc, join.out_cap, dead_b, dead_p,
            left_outer=(kind == "left"), lmatch=probe_live
        )
        overflow = overflow + of
        mask = newmask
        acc = out_l + out_r
    return acc, mask, dropped, overflow, xbytes


def _exchange_group_slots(ndev, cap, pkeys, psums, pcnt, route_keys=None):
    """Hash-exchange per-shard group SLOTS to their key owners — the
    fragment-boundary ``all_to_all`` between a partial agg and its merge
    (shared by the final agg tail and inter-stage repartitions). Routes by
    ``route_keys`` (default: every key lane); returns (rxkeys, rxsums,
    rxcnt, slot_overflow).

    Each slot lands at ``owner * cap + rank`` of its shard's send buffer by
    one scatter (the reference's ``.at[].set``); a slot whose rank reaches
    ``cap`` is counted as overflow and written to one spare cell past the
    buffer, which is dropped, so no index leaves the buffer."""
    h = _combine_keys(route_keys if route_keys is not None else pkeys)
    owner = torch.where(pcnt > 0, h.abs() % ndev, ndev - 1)
    order = _argsort(owner)
    so = owner.gather(-1, order)
    rank = torch.arange(cap, device=so.device) - _search(so, so)
    # one dest owning more than ``cap`` group slots overflows the bucket
    fits = rank < cap
    of_slots = ((pcnt.gather(-1, order) > 0) & ~fits).sum(-1)
    idx = torch.where(fits, so * cap + rank, ndev * cap)

    def bucketize(x):
        buf = torch.zeros((ndev, ndev * cap + 1), dtype=x.dtype, device=x.device)
        return buf.scatter_(-1, idx, x.gather(-1, order))[:, : ndev * cap]

    rxkeys = [all_to_all(bucketize(k), ndev) for k in pkeys]
    rxsums = [all_to_all(bucketize(s), ndev) for s in psums]
    rxcnt = all_to_all(bucketize(pcnt), ndev)
    return rxkeys, rxsums, rxcnt, of_slots


def _run_stage(stage: StageRuntime, block, ndev):
    """Execute one DEVICE stage over its readers' input lane block: fold the
    stage's join chain, run the two-phase grouped agg (partial →
    group-owner all_to_all → merge), finalize to build lanes. The returned
    lanes are per-shard ``group_cap`` slots, on the device — the consumer
    join's exchange re-partitions them on the new key without any host
    round-trip. Returns (out_lanes, out_valid, dropped, overflow, xbytes)."""
    spec = stage.spec

    def _chain(pos, acc, mask):
        for fpos, fn in stage.chain_filters:
            if fpos == pos:
                mask = mask & _flat(fn, acc)
        return mask

    soffs = [sum(spec.n_lanes[:i]) for i in range(len(spec.n_lanes) + 1)]
    acc = list(block[soffs[0] : soffs[1]])
    dev = acc[0].device
    mask = torch.ones(acc[0].shape, dtype=torch.bool, device=dev)
    if stage.selections[0] is not None:
        mask = _flat(lambda cols: stage.selections[0](*cols), acc)
    mask = _chain(0, acc, mask)
    dropped = torch.zeros(ndev, dtype=_I64, device=dev)
    overflow = torch.zeros(ndev, dtype=_I64, device=dev)
    xbytes = torch.zeros(ndev, dtype=_I64, device=dev)
    for ji, join in enumerate(spec.joins):
        rcols = list(block[soffs[ji + 1] : soffs[ji + 2]])
        rvalid = torch.ones(rcols[0].shape, dtype=torch.bool, device=dev)
        sel = stage.selections[ji + 1]
        if sel is not None:
            rvalid = _flat(lambda cols, _s=sel: _s(*cols), rcols)
        pf = stage.pair_filters[ji] if stage.pair_filters is not None else None
        acc, mask, d, of, xb = _fold_join(join, ndev, acc, mask, rcols, rvalid, pf)
        dropped, overflow, xbytes = dropped + d, overflow + of, xbytes + xb
        mask = _chain(ji + 1, acc, mask)
    acols = _flat_cols(stage.agg_inputs, acc, ndev)
    keys = list(acols[: spec.n_keys])
    vals = [acols[i] for i in spec.sums]
    pkeys, psums, pcnt, of1 = _segment_partial(
        keys, vals, mask, spec.group_cap, spec.key_bounds, spec.val_kinds
    )
    # the inter-stage repartition: live group slots cross the mesh ONCE,
    # 8 B per lane per slot (keys + sums + count)
    xbytes = xbytes + (pcnt > 0).sum(-1) * (8 * (len(pkeys) + len(psums) + 1))
    rxkeys, rxsums, rxcnt, of_slots = _exchange_group_slots(
        ndev, spec.group_cap, pkeys, psums, pcnt
    )
    mkeys, msums_cnt, _, of3 = _segment_partial(
        rxkeys,
        rxsums + [rxcnt],
        rxcnt > 0,
        spec.group_cap,
        spec.key_bounds,
        tuple(spec.val_kinds) + ("sum",),
    )
    flat = lambda lanes: [x.reshape(-1) for x in lanes]  # noqa: E731
    lanes, live = stage.finalize(flat(mkeys), flat(msums_cnt[:-1]), msums_cnt[-1].reshape(-1))
    out_lanes = [x.reshape(ndev, -1) for x in lanes]
    out_valid = live.reshape(ndev, -1)
    # trailing live lane keeps the block layout identical to a plain
    # reader's (2*ncols data/valid pairs + live), so the accumulated lane
    # offsets downstream stay uniform
    return out_lanes + [out_valid], out_valid, dropped, overflow + of1 + of_slots + of3, xbytes


@dataclass
class DistTopNSpec:
    """Per-shard TopN/Limit/row-gather tail over the joined lane layout.

    ``order``: [(lane index, valid lane index, desc)] — empty = plain
    limit/row gather. ``limit``: static per-shard output rows (None for
    row-gather, sized by ``out_cap``). ``out_lanes``: (data lane, valid lane)
    pairs to emit. The root re-sorts/trims the gathered candidate union, so
    per-shard heads are a superset protocol like coprocessor TopN tasks."""

    order: Sequence[tuple]
    limit: int | None
    out_lanes: Sequence[tuple]
    out_cap: int = 4096


def build_dist_pipeline(
    mesh,
    joins: Sequence[DistJoinSpec],
    agg: DistAggSpec | None,
    *,
    n_lanes: Sequence[int],
    selections: Sequence[Callable | None],
    agg_inputs: Callable | None = None,
    topn: "DistTopNSpec | None" = None,
    warn_sink=None,
    shard_stats: bool = False,
    pair_filters: Sequence[Callable | None] | None = None,
    chain_filters: Sequence[tuple] = (),
    stages: "Sequence[StageRuntime | None] | None" = None,
):
    """The generalized MPP pipeline as ONE program over the mesh's virtual
    shards (ref: §3.3 — fragments: scan→sel→[exchange→join]*→(partial
    agg→hash exchange→merge | topN/limit)→gather; fragment boundaries are
    the mesh module's collectives).

    Inputs: reader 0's ``n_lanes[0]`` sharded lanes, then reader 1's, ...
    (each of global length ndev * rows_per_shard, shard k holding rows
    [k * rows, (k + 1) * rows)). A left-deep join chain folds each build
    reader into the accumulated probe lane layout (probe lanes + gathered
    build lanes per join). The tail is either the two-phase agg (``agg`` +
    ``agg_inputs``) or a per-shard TopN/limit head (``topn``).

    Agg returns (keys..., sums..., count, total, dropped, overflow); TopN
    returns (out lanes..., live, count, total, dropped, overflow) — lanes
    gathered over every shard, counters summed.

    ``stages``: per-reader StageRuntime or None — reader k with a stage runs
    its input block through :func:`_run_stage` and the STAGE OUTPUT slots
    (on the device) become the join's build side; with stages present the
    program emits one extra output, the per-stage exchanged-byte vector
    (ordered by reader index), before the warn count. ``warn_sink``: a
    ``dag_kernel._DeviceWarnSink`` the callbacks report into, emptied at
    the start of every run; the program emits its counts' sum.
    ``shard_stats``: emit last a ``[2, ndev]`` tensor of each shard's live
    rows after the tail's shard-local reduction and its exchanged-byte
    estimate, for the caller's per-shard probe."""
    ndev = mesh.devices.size
    cap = agg.group_cap if agg is not None else 0
    n_readers = len(n_lanes)
    offs = [sum(n_lanes[:i]) for i in range(n_readers + 1)]

    def _apply_chain(pos, acc, mask):
        # post-join filters over the accumulated lane layout (a WHERE
        # residue that compares across join sides — e.g. the decorrelated
        # Q17 ``l_quantity < 0.2*avg`` against the joined subquery lane);
        # position k applies after the k-th join has folded in
        for fpos, fn in chain_filters:
            if fpos == pos:
                mask = mask & _flat(fn, acc)
        return mask

    def step(*cols):
        acc = list(cols[offs[0] : offs[1]])
        dev = acc[0].device
        mask = torch.ones(acc[0].shape, dtype=torch.bool, device=dev)
        if selections[0] is not None:
            mask = _flat(lambda c: selections[0](*c), acc)
        mask = _apply_chain(0, acc, mask)
        dropped = torch.zeros(ndev, dtype=_I64, device=dev)
        overflow = torch.zeros(ndev, dtype=_I64, device=dev)
        # per-shard exchanged-byte estimate (8 B per lane per routed row)
        xbytes = torch.zeros(ndev, dtype=_I64, device=dev)
        # per-stage exchanged bytes (reader order), an output when any
        # stage exists — the dryrun/EXPLAIN per-stage breakdown
        stage_xb: list = []
        for ji, join in enumerate(joins):
            block = list(cols[offs[ji + 1] : offs[ji + 2]])
            stage = stages[ji + 1] if stages is not None else None
            if stage is not None:
                rcols, rvalid, d_s, of_s, xb_s = _run_stage(stage, block, ndev)
                dropped = dropped + d_s
                overflow = overflow + of_s
                xbytes = xbytes + xb_s
                stage_xb.append(xb_s)
            else:
                rcols = block
                rvalid = torch.ones(rcols[0].shape, dtype=torch.bool, device=dev)
                sel = selections[ji + 1]
                if sel is not None:
                    rvalid = _flat(lambda c, _s=sel: _s(*c), rcols)
            pf = pair_filters[ji] if pair_filters is not None else None
            acc, mask, d, of, xb = _fold_join(join, ndev, acc, mask, rcols, rvalid, pf)
            dropped, overflow, xbytes = dropped + d, overflow + of, xbytes + xb
            mask = _apply_chain(ji + 1, acc, mask)
        outs, local_rows = (
            _agg_tail(acc, mask, dropped, overflow)
            if agg is not None
            else _topn_tail(acc, mask, dropped, overflow)
        )
        if stage_xb:
            # per-stage exchange bytes, summed across shards (staged-reader
            # order)
            outs = (*outs, torch.stack(stage_xb).sum(-1))
        if warn_sink is not None:
            # device warnings born inside the fragment (division by 0 in a
            # selection/agg argument) ride ONE count output, converted back
            # to session warnings by the gather (the per-SelectResponse
            # warning carriage); the callbacks saw every shard's rows
            wtotal = torch.zeros((), dtype=_I64, device=dev)
            for _code, _msg, c in warn_sink.items:
                wtotal = wtotal + torch.as_tensor(c, dtype=_I64).to(dev)
            outs = (*outs, wtotal)
        if shard_stats:
            outs = (*outs, torch.stack([local_rows.to(_I64), xbytes]))
        return outs

    def _topn_tail(joined, mask, dropped, overflow):
        n = mask.shape[-1]
        lanes = [~mask]
        for di, vi, desc in topn.order:
            d = joined[di]
            v = joined[vi].to(torch.bool) if vi is not None else torch.ones_like(mask)
            if desc:
                lanes.append(~v)  # NULLs last
                dd = torch.where(v, d, 0)
                lanes.append(-dd if dd.is_floating_point() else ~dd)
            else:
                lanes.append(v)  # NULLs first
                lanes.append(torch.where(v, d, 0))
        perm = _lex_perm(lanes)
        out_n = min(topn.limit if topn.limit is not None else topn.out_cap, n)
        head = perm[:, :out_n]
        cnt = mask.sum(-1)
        if topn.limit is None:
            # plain row gather: exceeding the static cap is an overflow (the
            # runner retries bigger); TopN heads are supersets by protocol
            overflow = overflow + (cnt - out_n).clamp(min=0)
        outs = []
        for di, vi in topn.out_lanes:
            outs.append(joined[di].gather(-1, head).reshape(-1))
            v = joined[vi].gather(-1, head) if vi is not None else torch.ones(head.shape, dtype=_I64, device=head.device)
            outs.append(v.reshape(-1))
        glive = mask.gather(-1, head).reshape(-1)
        return (*outs, glive, cnt.sum(), dropped.sum(), overflow.sum()), cnt

    def _agg_tail(joined, mask, dropped, overflow):
        acols = _flat_cols(agg_inputs, joined, ndev) if agg_inputs is not None else joined
        G, D = agg.n_keys, agg.n_dkeys
        # distinct lanes join the stage-1 segment keys: grouping by (g, x)
        # IS the dedup (ref: TiFlash two-phase distinct aggregation)
        keys = list(acols[: G + D])
        vals = [acols[i] for i in agg.sums]
        pkeys, psums, pcnt, of1 = _segment_partial(keys, vals, mask, cap, agg.key_bounds, agg.val_kinds)
        # route by GROUP keys only: every (g, *) slot lands on g's owner
        # shard, where x dedups globally
        rxkeys, rxsums, rxcnt, of_slots = _exchange_group_slots(
            ndev, cap, pkeys, psums, pcnt, route_keys=pkeys[:G]
        )
        mkeys, msums_cnt, _, of3 = _segment_partial(
            rxkeys, rxsums + [rxcnt], rxcnt > 0, cap, agg.key_bounds, tuple(agg.val_kinds) + ("sum",)
        )
        if D:
            # stage 3: per-g reduction over the deduped (g, x) slots — the
            # distinct output pair is (Σ distinct x, count of distinct x);
            # plain value lanes re-reduce by their own kinds
            bcnt = msums_cnt[-1]
            slot_live = bcnt > 0
            xvalid = mkeys[G + 1].to(torch.bool) & slot_live
            dval = torch.where(xvalid, mkeys[G], 0)
            cvals = list(msums_cnt[:-1]) + [dval, xvalid.to(_I64), bcnt]
            ckinds = tuple(agg.val_kinds) + ("sum", "sum", "sum")
            fkeys, fsums, _, of4 = _segment_partial(
                list(mkeys[:G]), cvals, slot_live, cap, tuple(agg.key_bounds[:G]), ckinds
            )
            of3 = of3 + of4
            nv = len(agg.sums)
            out_sums = []
            vi = 0
            for is_d in agg.distinct_mask:
                if is_d:
                    out_sums += [fsums[nv], fsums[nv + 1]]
                else:
                    out_sums += [fsums[vi], fsums[vi + 1]]
                    vi += 2
            out_keys, gcnt_local = fkeys, fsums[-1]
        else:
            out_keys, out_sums, gcnt_local = mkeys, list(msums_cnt[:-1]), msums_cnt[-1]
        gkeys = [k.reshape(-1) for k in out_keys]
        gsums = [s.reshape(-1) for s in out_sums]
        gcnt = gcnt_local.reshape(-1)
        total = mask.sum()
        goverflow = (overflow + of1 + of_slots + of3).sum()
        # shard-local live groups after the merge stage — the shard probe's
        # "rows produced"
        local_rows = (gcnt_local > 0).sum(-1)
        return (*gkeys, *gsums, gcnt, total, dropped.sum(), goverflow), local_rows

    def run(*cols):
        if warn_sink is not None:
            warn_sink.items.clear()  # this run's counts only
        return step(*[c.reshape(ndev, -1) for c in cols])

    return run


def build_dist_join_agg(
    mesh,
    join: DistJoinSpec | None,
    agg: DistAggSpec,
    *,
    n_left: int,
    n_right: int = 0,
    left_selection: Callable | None = None,
    right_selection: Callable | None = None,
    agg_inputs: Callable | None = None,
):
    """Single-join (or no-join) agg pipeline — the common star-join shape,
    kept as a thin wrapper over :func:`build_dist_pipeline`."""
    if join is None:
        return build_dist_pipeline(
            mesh,
            [],
            agg,
            n_lanes=[n_left],
            selections=[left_selection],
            agg_inputs=agg_inputs,
        )
    return build_dist_pipeline(
        mesh,
        [join],
        agg,
        n_lanes=[n_left, n_right],
        selections=[left_selection, right_selection],
        agg_inputs=agg_inputs,
    )


def finalize_dist_agg(outs, n_keys: int, n_sums: int):
    """Host-side trim of ``to_host``'s arrays: drop padding slots."""
    cnt = np.asarray(outs[n_keys + n_sums])
    live = cnt > 0
    keys = [np.asarray(outs[i])[live] for i in range(n_keys)]
    sums = [np.asarray(outs[n_keys + i])[live] for i in range(n_sums)]
    return keys, sums, cnt[live], int(np.asarray(outs[-1]))
