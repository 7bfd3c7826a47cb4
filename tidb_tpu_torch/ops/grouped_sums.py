"""K1: exact grouped COUNT/SUM for 64 < B ≤ 512 buckets.

Port of tidb_tpu/ops/pallas_groupby.py. ``grouped_sums`` keeps the
reference's call contract — ``seg`` (n_pad,) int32 with dead rows at
seg ≥ B or seg < 0, ``pairs`` of (value lane, bool weight lane), values
with |v| < 2^45, n_pad a multiple of 1024 and at most 8,000,000 rows — and
returns (counts, sums), both (B, L) int64. ``bounds`` takes one proven
``(lo, hi)`` per lane, as ``mxu_groupby.grouped_sums_dot`` does: a lane with
lo == hi is constant (its sum is count × lo and its values are not read),
and a narrower span takes fewer 16-bit pieces in the kernel.

On a CUDA tensor it launches the hand-written kernel ``csrc/grouped_sums.cu``
(see the bound and design note there) or raises; on a CPU tensor it runs
``grouped_sums_plain``, the same function in plain PyTorch. ``LAUNCHES``
counts kernel launches, so a run can show that its main path went through
the kernel.
"""

from __future__ import annotations

import ctypes
from array import array

import torch

from tidb_tpu_torch.device import resolve

_BLK = 1024
MAX_BUCKETS = 512
MAX_ROWS = 8_000_000  # the reference kernel's int32 accumulator headroom
_MAX_ABS = 1 << 45  # the contract: |value| < 2^45
_PIECE_BITS = 16
# per launch (csrc/grouped_sums.cu): K1_MAX_W / K1_MAX_V / K1_MAX_L, and one
# table copy (4-byte cells) within 200 KB of the SM's 227 KB shared memory
_MAX_LANES = 32
_TABLE_BYTES = 200 * 1024

LAUNCHES = 0


def _lane_bounds(v: torch.Tensor, b):
    """(lo, hi, constant): the proven bounds, else the int32 dtype envelope
    or the contract's |v| < 2^45."""
    if b is not None:
        lo, hi = int(b[0]), int(b[1])
        if hi < lo:
            raise ValueError(f"lane bounds ({lo}, {hi}) are empty")
        return lo, hi, lo == hi
    if v.dtype == torch.int32:
        return -(1 << 31), (1 << 31) - 1, False
    return -_MAX_ABS, _MAX_ABS, False


def _pieces(span: int) -> int:
    return min(4, max(1, -(-span.bit_length() // _PIECE_BITS)))


class Launch:
    """One launch of the kernel: its distinct weight columns, its value
    slots (values, lo, weight column, 16-bit pieces; int32 slots first) and
    its lanes (output column, weight column, slot or -1, constant value)."""

    __slots__ = ("weights", "slots", "lanes")

    def __init__(self, weights, slots, lanes):
        self.weights, self.slots, self.lanes = weights, slots, lanes


def _launch_of(weights, slot_of, lanes) -> Launch:
    keys = sorted(slot_of, key=lambda k: slot_of[k][0].dtype != torch.int32)
    index = {k: i for i, k in enumerate(keys)}
    return Launch(
        weights,
        [slot_of[k] for k in keys],
        [(col, wcol, -1 if key is None else index[key], lo) for col, wcol, key, lo in lanes],
    )


def plan(pairs, bounds, B: int) -> list[Launch]:
    """The kernel's launches for these lanes: weight columns dedup by tensor
    identity, lanes sharing (value, weight, lo, pieces) share a slot,
    constant lanes get no slot. A launch holds at most 32 lanes, weight
    columns and slots, and a table copy of at most 200 KB."""
    max_cells = _TABLE_BYTES // (4 * B)
    launches = []
    weights, wcol_of, slot_of, lanes, cells = [], {}, {}, [], 0
    for col, (v, w) in enumerate(pairs):
        lo, hi, constant = _lane_bounds(v, None if bounds is None else bounds[col])
        pieces = 0 if constant else _pieces(hi - lo)
        wid = id(w)
        key = None if constant else (id(v), wid, lo, pieces)
        new_w = wid not in wcol_of
        new_s = key is not None and key not in slot_of
        if lanes and (
            len(lanes) == _MAX_LANES
            or len(weights) + new_w > _MAX_LANES
            or len(slot_of) + new_s > _MAX_LANES
            or cells + new_w + new_s * pieces > max_cells
        ):
            launches.append(_launch_of(weights, slot_of, lanes))
            weights, wcol_of, slot_of, lanes, cells = [], {}, {}, [], 0
            new_w, new_s = True, key is not None
        if new_w:
            wcol_of[wid] = len(weights)
            weights.append(w)
        wcol = wcol_of[wid]
        if new_s:
            slot_of[key] = (v, lo, wcol, pieces)
        cells += new_w + new_s * pieces
        lanes.append((col, wcol, key, lo))
    launches.append(_launch_of(weights, slot_of, lanes))
    return launches


def grouped_sums_plain(seg: torch.Tensor, pairs, B: int, n_pad: int, bounds=None):
    """The same function as the kernel: ``index_add_`` over the live rows;
    a constant lane's sum is its count × lo. The kernel trusts each lane's
    bounds (its pieces cover only hi - lo), so a weighted live value outside
    them raises here."""
    L = len(pairs)
    bounds = list(bounds) if bounds is not None else [None] * L
    counts = torch.zeros(B, L, dtype=torch.int64, device=seg.device)
    sums = torch.zeros(B, L, dtype=torch.int64, device=seg.device)
    live = (seg >= 0) & (seg < B)
    for k, ((v, w), b) in enumerate(zip(pairs, bounds)):
        m = live & w
        idx = seg[m].to(torch.int64)
        x = v[m].to(torch.int64)
        lo, hi, constant = _lane_bounds(v, b)
        if x.numel() and (int(x.min()) < lo or int(x.max()) > hi):
            raise ValueError(f"lane {k}: a weighted live value lies outside the lane's bounds ({lo}, {hi})")
        counts[:, k].index_add_(0, idx, torch.ones_like(idx))
        if constant:
            sums[:, k] = counts[:, k] * lo
        else:
            sums[:, k].index_add_(0, idx, x)
    return counts, sums


def _check(seg, pairs, B: int, n_pad: int, bounds, device: torch.device) -> None:
    if n_pad % _BLK != 0:
        raise ValueError(f"n_pad must be a multiple of the row block ({_BLK}), got {n_pad}")
    if n_pad > MAX_ROWS:
        raise ValueError(f"n_pad {n_pad} exceeds MAX_ROWS {MAX_ROWS}")
    if not 0 < B <= MAX_BUCKETS:
        raise ValueError(f"B must be in [1, {MAX_BUCKETS}], got {B}")
    if not pairs:
        raise ValueError("grouped_sums needs at least one (value, weight) lane")
    if bounds is not None and len(bounds) != len(pairs):
        raise ValueError(f"{len(bounds)} bounds for {len(pairs)} lanes")
    shape = (n_pad,)
    if seg.dtype != torch.int32 or seg.shape != shape:
        raise ValueError(f"seg must be int32 of shape ({n_pad},), got {seg.dtype} {tuple(seg.shape)}")
    if seg.device != device:
        raise ValueError(f"tensor on {seg.device}, expected {device}")
    for k, (v, w) in enumerate(pairs):
        if (v.dtype is not torch.int32 and v.dtype is not torch.int64) or v.shape != shape:
            raise ValueError(f"lane {k}: values must be int32/int64 of shape ({n_pad},)")
        if w.dtype is not torch.bool or w.shape != shape:
            raise ValueError(f"lane {k}: weights must be bool of shape ({n_pad},)")
        if v.device != device or w.device != device:
            raise ValueError(f"lane {k}: tensors on {v.device}/{w.device}, expected {device}")


def _lib():
    from tidb_tpu_torch.native import cuda as native

    return entry(native.load("grouped_sums"))


def entry(lib: ctypes.CDLL):
    """The kernel's C entry point in a loaded library, with its signature."""
    fn = lib.tt_k1_grouped_sums
    if fn.argtypes is None:
        P = ctypes.c_void_p
        fn.argtypes = [P, P, ctypes.c_int, P]
        fn.restype = ctypes.c_int
    return fn


def _aligned(t: torch.Tensor) -> torch.Tensor:
    """The kernel loads 16 bytes at a time from each column's start."""
    t = t.contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()


def launch(fn, seg, pairs, B: int, n_pad: int, bounds=None):
    """Run the kernel entry ``fn`` over every launch of the plan (no
    argument checks: ``grouped_sums`` makes them)."""
    global LAUNCHES
    dev = seg.device
    L = len(pairs)
    out = torch.empty(2, B, L, dtype=torch.int64, device=dev)
    seg = _aligned(seg)
    stream = torch.cuda.current_stream(dev).cuda_stream
    for i, g in enumerate(plan(pairs, bounds, B)):
        keep = [_aligned(w) for w in g.weights]  # alive until the launch is queued
        slots = [(_aligned(v), lo, wcol, pieces) for v, lo, wcol, pieces in g.slots]
        nv4 = sum(v.dtype == torch.int32 for v, *_ in slots)
        desc = array("q", (seg.data_ptr(), n_pad, B, L, len(g.lanes), len(keep), nv4, len(slots) - nv4))
        desc.extend(w.data_ptr() for w in keep)
        for v, lo, wcol, pieces in slots:
            desc.extend((v.data_ptr(), lo, wcol, pieces))
        for lane in g.lanes:
            desc.extend(lane)
        rc = fn(desc.buffer_info()[0], out.data_ptr(), int(i == 0), stream)
        if rc != 0:
            raise RuntimeError(f"grouped_sums kernel launch failed: cudaError {rc}")
        LAUNCHES += 1
    return out[0], out[1]


def grouped_sums(seg: torch.Tensor, pairs, B: int, n_pad: int, bounds=None, device="cuda"):
    """Exact grouped COUNT/SUM for every (value, weight) lane.

    seg    : (n_pad,) int32 — bucket per row; rows with seg ≥ B or seg < 0
             are dead.
    pairs  : [(vals int32/int64 (n_pad,), w bool (n_pad,))].
    bounds : per lane a proven (lo, hi) for its weighted values, or None
             (the int32 envelope, or |v| < 2^45 for int64 lanes).
    → (counts int64 (B, L), sums int64 (B, L)) on ``device``.
    """
    device = resolve(device)
    _check(seg, pairs, B, n_pad, bounds, device)
    if device.type == "cpu":
        return grouped_sums_plain(seg, pairs, B, n_pad, bounds)
    if torch.cuda.current_device() != device.index:
        with torch.cuda.device(device):
            return launch(_lib(), seg, pairs, B, n_pad, bounds)
    return launch(_lib(), seg, pairs, B, n_pad, bounds)
