"""Scalar values crossing the host boundary (port of the parts of
tidb_tpu/types/datum.py that constants and DATE/DECIMAL output need)."""

from __future__ import annotations

import datetime as _dt
from dataclasses import dataclass
from typing import Any

from tidb_tpu_torch.types.field_type import FieldType, TypeKind

_EPOCH_DATE = _dt.date(1970, 1, 1)
_EPOCH_DT = _dt.datetime(1970, 1, 1)


@dataclass(frozen=True)
class Datum:
    """A typed scalar holding the *logical* Python value."""

    value: Any
    ftype: FieldType

    def physical(self) -> Any:
        """Encode to the device representation (int64/float64)."""
        v = self.value
        if v is None:
            return 0
        k = self.ftype.kind
        if k == TypeKind.UINT:
            v = int(v)
            return v - (1 << 64) if v >= (1 << 63) else v  # two's complement
        if k == TypeKind.INT:
            return int(v)
        if k == TypeKind.FLOAT:
            return float(v)
        if k == TypeKind.DECIMAL:
            return int(round(float(v) * (10 ** self.ftype.scale)))
        if k == TypeKind.DATE:
            if isinstance(v, _dt.date):
                return (v - _EPOCH_DATE).days
            if isinstance(v, str):  # wire form (ISO) from serialized plans
                return date_to_days(v)
            return int(v)
        if k == TypeKind.DATETIME:
            if isinstance(v, _dt.datetime):
                return int((v - _EPOCH_DT).total_seconds() * 1_000_000)
            if isinstance(v, str):
                try:
                    return int((_dt.datetime.fromisoformat(v) - _EPOCH_DT).total_seconds() * 1_000_000)
                except ValueError:
                    v = _dt.datetime.fromisoformat(v + " 00:00:00")
                    return int((v - _EPOCH_DT).total_seconds() * 1_000_000)
            return int(v)
        raise TypeError(f"no physical scalar for {self.ftype}")


def date_to_days(v: "str | _dt.date") -> int:
    if isinstance(v, str):
        v = _dt.date.fromisoformat(v)
    return (v - _EPOCH_DATE).days


def days_to_date(days: int) -> _dt.date:
    return _EPOCH_DATE + _dt.timedelta(days=int(days))


def micros_to_datetime(us: int) -> _dt.datetime:
    return _EPOCH_DT + _dt.timedelta(microseconds=int(us))


def micros_to_duration(us: int) -> _dt.timedelta:
    return _dt.timedelta(microseconds=int(us))
