"""Type system: MySQL-flavoured field types mapped onto TPU-friendly storage.

Reference parity: pkg/types (datum/field types) + pkg/parser/types. The rebuild
collapses MySQL's zoo of storage classes onto four device-resident physical
representations (int64 / float64 / int32-dictionary-code / bytes), because the
TPU wants fixed-width lanes; the logical MySQL type survives in ``FieldType``
for semantics (display, coercion, NULL-ability, decimal scale).
"""

from tidb_tpu_torch.types.field_type import (
    FieldType,
    TypeKind,
    bigint_type,
    bool_type,
    date_type,
    datetime_type,
    decimal_type,
    double_type,
    duration_type,
    string_type,
)
from tidb_tpu_torch.types.datum import Datum, NULL

__all__ = [
    "FieldType",
    "TypeKind",
    "Datum",
    "NULL",
    "bigint_type",
    "bool_type",
    "date_type",
    "datetime_type",
    "decimal_type",
    "double_type",
    "duration_type",
    "string_type",
]
