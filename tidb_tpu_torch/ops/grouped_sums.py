"""K1: exact grouped COUNT/SUM for 64 < B ≤ 512 buckets.

Port of tidb_tpu/ops/pallas_groupby.py. ``grouped_sums`` keeps the
reference's call contract — ``seg`` (n_pad,) int32 with dead rows at
seg ≥ B or seg < 0, ``pairs`` of (value lane, bool weight lane), values
with |v| < 2^45, n_pad a multiple of 1024 and at most 8,000,000 rows — and
returns (counts, sums), both (B, L) int64.

On a CUDA tensor it launches the hand-written kernel ``csrc/grouped_sums.cu``
(see the bound and design note there) or raises; on a CPU tensor it runs
``grouped_sums_plain``, the same function in plain PyTorch. ``LAUNCHES``
counts kernel launches, so a run can show that its main path went through
the kernel.
"""

from __future__ import annotations

import ctypes

import torch

from tidb_tpu_torch.device import resolve

_BLK = 1024
MAX_BUCKETS = 512
MAX_ROWS = 8_000_000  # the reference kernel's int32 accumulator headroom
_MAX_LANES = 16  # lanes per launch: csrc/grouped_sums.cu GS_MAX_LANES
_THREADS = 256
_BLOCKS_PER_SM = 8  # 2048 resident threads per SM / 256

LAUNCHES = 0


def grouped_sums_plain(seg: torch.Tensor, pairs, B: int, n_pad: int):
    """The same function as the kernel: ``index_add_`` over the live rows."""
    L = len(pairs)
    counts = torch.zeros(B, L, dtype=torch.int64, device=seg.device)
    sums = torch.zeros(B, L, dtype=torch.int64, device=seg.device)
    live = (seg >= 0) & (seg < B)
    for k, (v, w) in enumerate(pairs):
        m = live & w
        idx = seg[m].to(torch.int64)
        counts[:, k].index_add_(0, idx, torch.ones_like(idx))
        sums[:, k].index_add_(0, idx, v[m].to(torch.int64))
    return counts, sums


def _check(seg, pairs, B: int, n_pad: int, device: torch.device) -> None:
    if n_pad % _BLK != 0:
        raise ValueError(f"n_pad must be a multiple of the row block ({_BLK}), got {n_pad}")
    if n_pad > MAX_ROWS:
        raise ValueError(f"n_pad {n_pad} exceeds MAX_ROWS {MAX_ROWS}")
    if not 0 < B <= MAX_BUCKETS:
        raise ValueError(f"B must be in [1, {MAX_BUCKETS}], got {B}")
    if not pairs:
        raise ValueError("grouped_sums needs at least one (value, weight) lane")
    if seg.dtype != torch.int32 or seg.shape != (n_pad,):
        raise ValueError(f"seg must be int32 of shape ({n_pad},), got {seg.dtype} {tuple(seg.shape)}")
    for k, (v, w) in enumerate(pairs):
        if v.dtype not in (torch.int32, torch.int64) or v.shape != (n_pad,):
            raise ValueError(f"lane {k}: values must be int32/int64 of shape ({n_pad},)")
        if w.dtype != torch.bool or w.shape != (n_pad,):
            raise ValueError(f"lane {k}: weights must be bool of shape ({n_pad},)")
    for t in [seg] + [x for p in pairs for x in p]:
        if t.device != device:
            raise ValueError(f"tensor on {t.device}, expected {device}")


def _lib():
    from tidb_tpu_torch import native

    lib = native.load("grouped_sums")
    fn = lib.tt_grouped_sums
    if fn.argtypes is None:
        P = ctypes.c_void_p
        fn.argtypes = [P, P, P, P, ctypes.c_int, ctypes.c_longlong, ctypes.c_int, ctypes.c_int, P, P, ctypes.c_int, P]
        fn.restype = ctypes.c_int
    return fn


def _launch(seg, pairs, B: int, n_pad: int):
    global LAUNCHES
    fn = _lib()
    dev = seg.device
    seg = seg.contiguous()
    pairs = [(v.contiguous(), w.contiguous()) for v, w in pairs]
    L = len(pairs)
    counts = torch.zeros(B, L, dtype=torch.int64, device=dev)
    sums = torch.zeros(B, L, dtype=torch.int64, device=dev)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    grid = max(1, min(-(-n_pad // _THREADS), sms * _BLOCKS_PER_SM))
    stream = torch.cuda.current_stream(dev).cuda_stream
    for l0 in range(0, L, _MAX_LANES):
        grp = pairs[l0 : l0 + _MAX_LANES]
        g = len(grp)
        vals = (ctypes.c_void_p * g)(*[v.data_ptr() for v, _ in grp])
        ws = (ctypes.c_void_p * g)(*[w.data_ptr() for _, w in grp])
        vbytes = (ctypes.c_int * g)(*[v.element_size() for v, _ in grp])
        rc = fn(
            seg.data_ptr(), vals, ws, vbytes, g, n_pad, B, L,
            counts.data_ptr() + 8 * l0, sums.data_ptr() + 8 * l0, grid, stream,
        )
        if rc != 0:
            raise RuntimeError(f"grouped_sums kernel launch failed: cudaError {rc}")
        LAUNCHES += 1
    return counts, sums


def grouped_sums(seg: torch.Tensor, pairs, B: int, n_pad: int, device="cuda"):
    """Exact grouped COUNT/SUM for every (value, weight) lane.

    seg   : (n_pad,) int32 — bucket per row; rows with seg ≥ B or seg < 0
            are dead.
    pairs : [(vals int32/int64 (n_pad,), w bool (n_pad,))].
    → (counts int64 (B, L), sums int64 (B, L)) on ``device``.
    """
    device = resolve(device)
    _check(seg, pairs, B, n_pad, device)
    if device.type == "cpu":
        return grouped_sums_plain(seg, pairs, B, n_pad)
    return _launch(seg, pairs, B, n_pad)
