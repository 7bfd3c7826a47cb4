"""Field types.

Reference parity: pkg/parser/types/field_type.go (FieldType) and pkg/types.
Redesigned: instead of MySQL's ~30 `mysql.Type*` byte codes we keep a small
enum of logical kinds, each with a fixed physical device representation:

=============  =========================  ===========================
TypeKind       logical                    physical (device)
=============  =========================  ===========================
INT            TINYINT..BIGINT (signed)   int64
UINT           unsigned ints              int64 (two's complement)
FLOAT          FLOAT/DOUBLE               float64 (float32 on request)
DECIMAL        DECIMAL(p,s)               int64 scaled by 10**s
STRING         CHAR/VARCHAR/TEXT/BLOB     int32 dictionary code
DATE           DATE                       int64 days since epoch
DATETIME       DATETIME/TIMESTAMP         int64 microseconds since epoch
DURATION       TIME                       int64 microseconds
JSON           JSON                       host-only (no device rep)
=============  =========================  ===========================

NULL is carried out-of-band in each Column's validity mask (three-valued logic
lives in tidb_tpu.expression); there is no NULL sentinel in the data lanes.
"""

from __future__ import annotations

import enum
from dataclasses import dataclass, field, replace


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


# Kinds whose device representation is int64.
_I64_KINDS = frozenset(
    {TypeKind.INT, TypeKind.UINT, TypeKind.DECIMAL, TypeKind.DATE, TypeKind.DATETIME, TypeKind.DURATION}
)


@dataclass(frozen=True)
class FieldType:
    """Logical column type. Immutable; share instances freely."""

    kind: TypeKind
    # display length (MySQL flen); informational
    length: int = -1
    # decimal digits after the point; only DECIMAL uses it for scaling
    scale: int = 0
    nullable: bool = True
    # collation: only binary ("bin") vs case-insensitive ("ci") distinction kept
    collation: str = "bin"
    # CHAR(n) pads; VARCHAR does not — affects comparisons only at the edges
    fixed_char: bool = False
    # JSON documents ride the STRING representation (normalized text) with
    # this marker for display/type functions (ref: types.JSON column flag)
    json: bool = False

    # -- physical mapping -------------------------------------------------
    @property
    def device_dtype(self) -> str:
        if self.kind in _I64_KINDS:
            return "int64"
        if self.kind == TypeKind.FLOAT:
            return "float64"
        if self.kind == TypeKind.STRING:
            return "int32"  # dictionary code
        if self.kind == TypeKind.NULLTYPE:
            return "int64"
        raise TypeError(f"type {self.kind.name} has no device representation")

    @property
    def is_numeric(self) -> bool:
        return self.kind in (TypeKind.INT, TypeKind.UINT, TypeKind.FLOAT, TypeKind.DECIMAL)

    @property
    def is_temporal(self) -> bool:
        return self.kind in (TypeKind.DATE, TypeKind.DATETIME, TypeKind.DURATION)

    @property
    def is_string(self) -> bool:
        return self.kind == TypeKind.STRING

    def not_null(self) -> "FieldType":
        return replace(self, nullable=False)

    def __str__(self) -> str:  # for EXPLAIN / error messages
        base = self.kind.name
        if self.kind == TypeKind.DECIMAL:
            base += f"({self.length},{self.scale})"
        elif self.length >= 0:
            base += f"({self.length})"
        if not self.nullable:
            base += " NOT NULL"
        return base


# -- canonical constructors ------------------------------------------------

def bigint_type(nullable: bool = True) -> FieldType:
    return FieldType(TypeKind.INT, length=20, nullable=nullable)


def bool_type() -> FieldType:
    # MySQL BOOL == TINYINT(1); we evaluate predicates to INT {0,1}
    return FieldType(TypeKind.INT, length=1, nullable=True)


def double_type(nullable: bool = True) -> FieldType:
    return FieldType(TypeKind.FLOAT, nullable=nullable)


def decimal_type(precision: int = 10, scale: int = 0, nullable: bool = True) -> FieldType:
    return FieldType(TypeKind.DECIMAL, length=precision, scale=scale, nullable=nullable)


def string_type(length: int = -1, nullable: bool = True, collation: str = "bin") -> FieldType:
    return FieldType(TypeKind.STRING, length=length, nullable=nullable, collation=collation)


def date_type(nullable: bool = True) -> FieldType:
    return FieldType(TypeKind.DATE, nullable=nullable)


def datetime_type(nullable: bool = True) -> FieldType:
    return FieldType(TypeKind.DATETIME, nullable=nullable)


def duration_type(nullable: bool = True) -> FieldType:
    return FieldType(TypeKind.DURATION, nullable=nullable)


def merge_types(a: FieldType, b: FieldType) -> FieldType:
    """Least common supertype for expression results (ref: pkg/expression
    type inference). DECIMAL ∪ FLOAT → FLOAT; INT ∪ DECIMAL → DECIMAL; any ∪
    STRING → STRING comparisons coerce to FLOAT per MySQL rules (handled in
    expression layer, not here)."""
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
    ra, rb = ranks[a.kind], ranks[b.kind]
    hi = a if ra >= rb else b
    if hi.kind == TypeKind.STRING:
        # mixed string/number arithmetic goes through FLOAT in MySQL
        return double_type()
    if hi.kind == TypeKind.DECIMAL:
        lo = b if hi is a else a
        scale = hi.scale
        return decimal_type(max(hi.length - hi.scale, 20) + scale, scale)
    return hi
