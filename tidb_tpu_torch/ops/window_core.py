"""Segmented order statistics and running reductions over group-sorted rows
(port of the pieces of tidb_tpu/ops/window_core.py that the lex-sort
grouped aggregation and the binder read; the window program itself is not
ported).

Both take rows already sorted by group, so every group is one contiguous
run: ``seg`` is the nondecreasing group index per row and ``ps`` the
position of the first row of each row's group.
"""

from __future__ import annotations

from typing import Callable

import torch


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
