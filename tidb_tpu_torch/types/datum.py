"""Datum: one scalar value crossing the host boundary (constants, point rows).

Reference parity: pkg/types/datum.go. Heavily simplified: on the device there
are no datums at all — only columns; Datum exists for literals in plans, keys
in point lookups, and row assembly in the write path.
"""

from __future__ import annotations

import datetime as _dt
from dataclasses import dataclass
from typing import Any

from tidb_tpu_torch.types.field_type import FieldType, TypeKind

_EPOCH_DATE = _dt.date(1970, 1, 1)
_EPOCH_DT = _dt.datetime(1970, 1, 1)


class _Null:
    _inst = None

    def __new__(cls):
        if cls._inst is None:
            cls._inst = super().__new__(cls)
        return cls._inst

    def __repr__(self):
        return "NULL"

    def __bool__(self):
        return False


NULL = _Null()


@dataclass(frozen=True)
class Datum:
    """A typed scalar. ``value`` holds the *logical* Python value
    (int/float/str/bytes/date/datetime/None)."""

    value: Any
    ftype: FieldType

    @property
    def is_null(self) -> bool:
        return self.value is None

    def physical(self) -> Any:
        """Encode to the device representation (int64/float64) — strings are
        NOT encodable without a dictionary and raise."""
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
                    return datetime_to_micros(v)
                except ValueError:
                    return datetime_to_micros(v + " 00:00:00")
            return int(v)
        if k == TypeKind.DURATION:
            if isinstance(v, (str, _dt.timedelta)):
                return duration_to_micros(v)
            return int(v)
        raise TypeError(f"no physical scalar for {self.ftype}")


def date_to_days(v: "str | _dt.date") -> int:
    if isinstance(v, str):
        v = _dt.date.fromisoformat(v)
    return (v - _EPOCH_DATE).days


def days_to_date(days: int) -> _dt.date:
    return _EPOCH_DATE + _dt.timedelta(days=int(days))


def datetime_to_micros(v: "str | _dt.datetime") -> int:
    if isinstance(v, str):
        v = _dt.datetime.fromisoformat(v)
    return int((v - _EPOCH_DT).total_seconds() * 1_000_000)


def micros_to_datetime(us: int) -> _dt.datetime:
    return _EPOCH_DT + _dt.timedelta(microseconds=int(us))


def duration_to_micros(v: "str | _dt.timedelta") -> int:
    """MySQL TIME '[-][H]H:MM:SS[.ffffff]' (hours may exceed 23, up to 838)
    → signed microseconds (ref: types/duration.go parsing)."""
    if isinstance(v, _dt.timedelta):
        return int(v.total_seconds() * 1_000_000)
    s = v.strip()
    neg = s.startswith("-")
    if neg:
        s = s[1:]
    frac = 0
    if "." in s:
        s, f = s.split(".", 1)
        frac = int((f + "000000")[:6])
    parts = s.split(":")
    if len(parts) == 3:
        h, m, sec = (int(p) for p in parts)
    elif len(parts) == 2:
        h, m, sec = int(parts[0]), int(parts[1]), 0
    else:
        # bare number: MySQL reads it as [HH]MMSS
        x = int(parts[0])
        h, m, sec = x // 10000, (x // 100) % 100, x % 100
    us = ((h * 3600 + m * 60 + sec) * 1_000_000) + frac
    return -us if neg else us


def micros_to_duration(us: int) -> _dt.timedelta:
    return _dt.timedelta(microseconds=int(us))


def format_physical(x, ftype) -> bytes:
    """MySQL-style text rendering of one physical (non-NULL, non-string)
    value — shared by CAST(... AS CHAR) and GROUP_CONCAT."""
    from tidb_tpu_torch.types.field_type import TypeKind

    k = ftype.kind
    if k == TypeKind.DECIMAL and ftype.scale > 0:
        iv = int(x)
        sign = "-" if iv < 0 else ""
        iv = abs(iv)
        return f"{sign}{iv // 10**ftype.scale}.{iv % 10**ftype.scale:0{ftype.scale}d}".encode()
    if k == TypeKind.FLOAT:
        return repr(float(x)).encode()
    if k == TypeKind.DATE:
        return str(days_to_date(int(x))).encode()
    if k == TypeKind.DATETIME:
        return str(micros_to_datetime(int(x))).encode()
    if k == TypeKind.DURATION:
        us = int(x)
        sign = "-" if us < 0 else ""
        us = abs(us)
        sec, frac = divmod(us, 1_000_000)
        h, rem = divmod(sec, 3600)
        m, s = divmod(rem, 60)
        base = f"{sign}{h:02d}:{m:02d}:{s:02d}"
        return (base + (f".{frac:06d}" if frac else "")).encode()
    return str(int(x)).encode()
