"""Segmented order statistics and running reductions over group-sorted rows
(port of the two pieces of tidb_tpu/ops/window_core.py that the lex-sort
grouped aggregation reads; the window program itself is not ported).

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
