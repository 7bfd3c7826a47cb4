"""The plain reference: each template's answer from the generated tables,
in numpy, one module per template (``reference/<template>.py``) with
``LIMIT`` (the rows a statement returns at most, or None) and
``rows(tables, params, numeric)``: every row of the statement without its
LIMIT, in its ORDER BY order.

``numeric`` is ``"exact"`` (DECIMAL as scaled int64, the configuration's
guarantee) or a float dtype's name (``"float64"``, ``"float32"``): the
same arithmetic in that precision, the control that has to come out as
not correct. It imports nothing of the program and takes nothing it built.
"""

from __future__ import annotations

import datetime as dt
from decimal import Decimal

import numpy as np

EPOCH = dt.date(1970, 1, 1)


def days(iso: str) -> int:
    return (dt.date.fromisoformat(iso) - EPOCH).days


def date(d) -> dt.date:
    return EPOCH + dt.timedelta(days=int(d))


def lane(x: np.ndarray, numeric: str) -> np.ndarray:
    """A scaled-integer lane in the arithmetic ``numeric`` names."""
    return x.astype(np.int64 if numeric == "exact" else np.dtype(numeric))


def dec(v, scale: int) -> Decimal:
    """A scaled value as a DECIMAL of ``scale`` digits; a float control's
    value rounds to the nearest unit of the last digit."""
    if isinstance(v, (float, np.floating)):
        v = np.rint(v)
    return Decimal(int(v)).scaleb(-scale)


def avg(total, count: int):
    """AVG of a DECIMAL at the argument's scale + 4, as a scaled value:
    rounded half away from zero (count > 0); a float control divides."""
    if isinstance(total, (float, np.floating)):
        return total * 10**4 / count
    num = int(total) * 10**4
    q = (abs(num) + count // 2) // count
    return q if num >= 0 else -q


def by_key(key: np.ndarray, *lanes):
    """(distinct keys, each lane summed over each key's rows)."""
    order = np.argsort(key, kind="stable")
    ks = key[order]
    starts = np.flatnonzero(np.r_[True, ks[1:] != ks[:-1]])
    return ks[starts], [np.add.reduceat(v[order], starts) for v in lanes]


def lookup(keys: np.ndarray, probe: np.ndarray):
    """(index into the sorted unique ``keys`` of each probe, whether found)."""
    i = np.clip(np.searchsorted(keys, probe), 0, len(keys) - 1)
    return i, keys[i] == probe
