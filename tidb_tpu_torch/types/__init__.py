"""Type system (port of tidb_tpu/types)."""

from tidb_tpu_torch.types.datum import Datum
from tidb_tpu_torch.types.field_type import (
    FieldType,
    TypeKind,
    bigint_type,
    bool_type,
    date_type,
    decimal_type,
    double_type,
    string_type,
)

__all__ = [
    "Datum",
    "FieldType",
    "TypeKind",
    "bigint_type",
    "bool_type",
    "date_type",
    "decimal_type",
    "double_type",
    "string_type",
]
