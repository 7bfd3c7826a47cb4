"""The root's device window: one window program per window shape (port of
tidb_tpu/ops/window_kernel.py).

Reference parity: pkg/executor WindowExec + the Shuffle intra-node
repartitioner (shuffle.go:86). Instead of per-partition loops, the whole
operator evaluates as one sorted-batch program over padded lanes
(``window_core.window_program``), then an inverse permutation restores the
original row order. Frames on the device: whole partition, RANGE
UNBOUNDED..CURRENT (peers share), ROWS UNBOUNDED..CURRENT, and bounded ROWS
for the prefix-sum aggregates; ``WindowExec`` sweeps anything else on the
host (bounded-frame MIN/MAX, string order keys, non-constant ntile or
lead/lag arguments).

PyTorch runs eagerly and compiles nothing, so the reference's compile gate
(``COMPILE_GATE_ROWS``, ``is_compiled``) has no counterpart here: the cost
model below weighs the device's fixed cost, the copies and the per-row work
against the host sweep, and ``get_window_fn`` only caches the closure.
"""

from __future__ import annotations

import threading

import torch

from tidb_tpu_torch.ops.window_core import window_program

# The device/host cost model, measured on "NVIDIA H100 80GB HBM3, 700.00 W"
# by chip_smoke.py's window phase (its "window_costs" line: the root window
# of WINDOW_QUERIES["rootwin"], 1,500,449 rows, one function; PERF.md §5):
# the program at 1,024 rows 1.645 ms (eager op issue), at 2,097,152 padded
# rows 1.887 ms; pageable copies 0.170 (up) and 0.172 (down) ns per byte;
# WindowExec's numpy sweep 272.0 ms, 178.3 of it the sort. The model leaves
# out the host-side lane evaluation and padding both sides share in part
# (the device path measured 28.8 ms whole).
DEV_FIXED_S = 1.6e-3
H2D_NS_PER_BYTE = 0.17
D2H_NS_PER_BYTE = 0.17
DEV_ROW_NS_PER_FUNC = 0.16
HOST_ROW_NS_PER_FUNC = 62.0
HOST_SORT_ROW_NS = 119.0
# the packed single-key sort covers one full fused batch; without bounds the
# chain of stable argsorts runs one sort per lane (two per key)
DEVICE_MAX_ROWS = 1 << 25
MULTILANE_MAX_ROWS = 1 << 22


def device_beats_host(n: int, n_lanes_up: int, n_funcs: int) -> bool:
    """Measured-cost device/host choice (ref: the Shuffle concurrency
    choice, shuffle.go:86, redesigned as a device/host cost model)."""
    nf = max(n_funcs, 1)
    dev = DEV_FIXED_S + n * (
        H2D_NS_PER_BYTE * 9 * n_lanes_up  # upload: (data, valid) per lane
        + D2H_NS_PER_BYTE * 16 * nf  # download: one int64 data and valid lane per function
        + DEV_ROW_NS_PER_FUNC * nf
    ) * 1e-9
    host = n * (HOST_ROW_NS_PER_FUNC * nf + HOST_SORT_ROW_NS) * 1e-9
    return dev < host


_CACHE: dict = {}
_MU = threading.Lock()


def get_window_fn(spec: tuple, n_pad: int, bounds: tuple = None):
    key = (spec, n_pad, bounds)
    with _MU:
        fn = _CACHE.get(key)
    if fn is None:
        fn = _build(spec, n_pad, bounds)
        with _MU:
            _CACHE[key] = fn
    return fn


def _build(spec: tuple, n_pad: int, bounds):
    """spec = (n_part_keys, order_descs, frame_tag, funcs), funcs as
    ``window_core.derive_specs`` gives them. ``bounds``: per partition +
    order lane (lo, hi) or None (the packed sort). The returned function
    takes (part_lanes, order_lanes, arg_lanes, nvalid, device), each lane a
    (data, valid) pair of ``n_pad`` rows on ``device``, the arg lanes only
    for the functions that have an argument, and returns (data, valid) per
    function in the original row order, flattened."""
    _n_part, order_descs, frame_tag, funcs = spec
    n = n_pad

    def fn(part_lanes, order_lanes, arg_lanes, nvalid, device):
        mask = torch.arange(n, device=device) < nvalid
        it = iter(arg_lanes)
        full_args = [next(it) if f[1] else None for f in funcs]
        outs, perm, _sm = window_program(
            mask=mask,
            part_lanes=list(part_lanes),
            order_lanes=list(order_lanes),
            order_descs=order_descs,
            frame_tag=frame_tag,
            specs=funcs,
            arg_lanes=full_args,
            n=n,
            bounds=list(bounds) if bounds is not None else None,
        )
        inv = torch.empty_like(perm)
        inv[perm] = torch.arange(n, device=perm.device)
        flat = []
        for d, v in outs:
            flat += [d[inv], v[inv]]
        return tuple(flat)

    return fn
