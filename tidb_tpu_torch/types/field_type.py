"""Field types (port of tidb_tpu/types/field_type.py).

Logical kinds with a fixed physical device representation:

=============  =========================  ===========================
TypeKind       logical                    physical (device)
=============  =========================  ===========================
INT            TINYINT..BIGINT (signed)   int64
UINT           unsigned ints              int64 (two's complement)
FLOAT          FLOAT/DOUBLE               float64
DECIMAL        DECIMAL(p,s)               int64 scaled by 10**s
STRING         CHAR/VARCHAR/TEXT/BLOB     int32 dictionary code
DATE           DATE                       int64 days since epoch
DATETIME       DATETIME/TIMESTAMP         int64 microseconds since epoch
DURATION       TIME                       int64 microseconds
=============  =========================  ===========================

NULL travels out-of-band in each column's validity mask.
"""

from __future__ import annotations

import enum
from dataclasses import dataclass, replace


class TypeKind(enum.IntEnum):
    INT = 0
    UINT = 1
    FLOAT = 2
    DECIMAL = 3
    STRING = 4
    DATE = 5
    DATETIME = 6
    DURATION = 7
    JSON = 8
    NULLTYPE = 9  # type of literal NULL


@dataclass(frozen=True)
class FieldType:
    """Logical column type. Immutable; share instances freely."""

    kind: TypeKind
    length: int = -1
    # decimal digits after the point; only DECIMAL uses it for scaling
    scale: int = 0
    nullable: bool = True
    # only binary ("bin") vs case-insensitive ("ci") is distinguished
    collation: str = "bin"
    json: bool = False

    def not_null(self) -> "FieldType":
        return replace(self, nullable=False)


def bigint_type(nullable: bool = True) -> FieldType:
    return FieldType(TypeKind.INT, length=20, nullable=nullable)


def bool_type() -> FieldType:
    # MySQL BOOL == TINYINT(1); predicates evaluate to INT {0,1}
    return FieldType(TypeKind.INT, length=1, nullable=True)


def double_type(nullable: bool = True) -> FieldType:
    return FieldType(TypeKind.FLOAT, nullable=nullable)


def decimal_type(precision: int = 10, scale: int = 0, nullable: bool = True) -> FieldType:
    return FieldType(TypeKind.DECIMAL, length=precision, scale=scale, nullable=nullable)


def string_type(length: int = -1, nullable: bool = True, collation: str = "bin") -> FieldType:
    return FieldType(TypeKind.STRING, length=length, nullable=nullable, collation=collation)


def date_type(nullable: bool = True) -> FieldType:
    return FieldType(TypeKind.DATE, nullable=nullable)


def merge_types(a: FieldType, b: FieldType) -> FieldType:
    """Least common supertype for expression results (same rule as the
    reference's ``merge_types``)."""
    if a.kind == TypeKind.NULLTYPE:
        return b
    if b.kind == TypeKind.NULLTYPE:
        return a
    if a.kind == b.kind:
        if a.kind == TypeKind.DECIMAL:
            scale = max(a.scale, b.scale)
            return decimal_type(max(a.length - a.scale, b.length - b.scale) + scale, scale)
        return a
    ranks = {
        TypeKind.INT: 0,
        TypeKind.UINT: 0,
        TypeKind.DATE: 0,
        TypeKind.DATETIME: 0,
        TypeKind.DURATION: 0,
        TypeKind.DECIMAL: 1,
        TypeKind.FLOAT: 2,
        TypeKind.STRING: 3,
        TypeKind.JSON: 3,
    }
    hi = a if ranks[a.kind] >= ranks[b.kind] else b
    if hi.kind == TypeKind.STRING:
        return double_type()
    if hi.kind == TypeKind.DECIMAL:
        return decimal_type(max(hi.length - hi.scale, 20) + hi.scale, hi.scale)
    return hi
