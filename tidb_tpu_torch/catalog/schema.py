"""Schema objects (ref: pkg/meta/model TableInfo/ColumnInfo/IndexInfo)."""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Optional

from tidb_tpu_torch.parser import ast
from tidb_tpu_torch.types import FieldType, TypeKind
from tidb_tpu_torch.types.field_type import (
    FieldType,
    bigint_type,
    date_type,
    datetime_type,
    decimal_type,
    double_type,
    duration_type,
    string_type,
)
from tidb_tpu_torch.expression.expr import _ft_pb, _ft_from_pb


def typedef_to_ftype(td: ast.TypeDef, not_null: bool = False) -> FieldType:
    name = td.name
    nullable = not not_null
    if name in ("tinyint", "smallint", "mediumint", "int", "integer", "bigint", "bool", "boolean", "serial"):
        ft = FieldType(TypeKind.UINT if td.unsigned else TypeKind.INT, length=td.length if td.length > 0 else 20, nullable=nullable)
    elif name in ("double", "float", "real"):
        ft = double_type(nullable)
    elif name in ("decimal", "numeric"):
        ft = decimal_type(td.length if td.length > 0 else 10, td.scale, nullable)
    elif name in ("varchar", "char", "text", "tinytext", "mediumtext", "longtext", "blob", "varbinary", "binary", "enum"):
        # MySQL: *_ci collations compare case-insensitively (ref: util/collate
        # general_ci — here folded-compare semantics, accent folding omitted)
        coll = "ci" if td.collate.endswith(("_ci", "_ai_ci")) else "bin"
        ft = string_type(td.length, nullable, collation=coll)
    elif name == "date":
        ft = date_type(nullable)
    elif name in ("datetime", "timestamp"):
        ft = datetime_type(nullable)
    elif name == "time":
        ft = duration_type(nullable)
    elif name == "json":
        # JSON stores as normalized text on the STRING path (dictionary
        # codes on device); the flag drives display + json functions
        ft = FieldType(TypeKind.STRING, length=-1, nullable=nullable, json=True)
    else:
        raise ValueError(f"unsupported column type {name!r}")
    return ft


@dataclass
class ColumnInfo:
    id: int  # stable per-table column id
    name: str
    ftype: FieldType
    offset: int  # current storage slot
    default: Any = None  # logical python value
    auto_increment: bool = False

    def to_pb(self) -> dict:
        d = self.default
        if hasattr(d, "isoformat"):
            d = d.isoformat()
        return {
            "id": self.id,
            "name": self.name,
            "ft": _ft_pb(self.ftype),
            "offset": self.offset,
            "default": d,
            "auto_increment": self.auto_increment,
        }

    @staticmethod
    def from_pb(pb: dict) -> "ColumnInfo":
        return ColumnInfo(pb["id"], pb["name"], _ft_from_pb(pb["ft"]), pb["offset"], pb["default"], pb["auto_increment"])


@dataclass
class IndexInfo:
    id: int
    name: str
    column_offsets: list[int]
    unique: bool = False
    primary: bool = False
    # online-DDL schema state (ref: F1 states in ddl/job_worker.go:773):
    # delete_only → write_only → write_reorg → public
    state: str = "public"

    def to_pb(self) -> dict:
        return {"id": self.id, "name": self.name, "cols": self.column_offsets, "unique": self.unique, "primary": self.primary, "state": self.state}

    @staticmethod
    def from_pb(pb: dict) -> "IndexInfo":
        return IndexInfo(pb["id"], pb["name"], pb["cols"], pb["unique"], pb["primary"], pb.get("state", "public"))


@dataclass
class FKInfo:
    """Child-side foreign-key constraint (ref: model.FKInfo +
    planner/core/foreign_key.go:78 plan nodes). ``ref_*`` name the parent by
    (db, table) so renames keep working through catalog lookup at check time;
    offsets address the CHILD's storage slots."""

    id: int
    name: str
    col_offsets: list[int]
    ref_db: str
    ref_table: str
    ref_col_names: list[str]
    on_delete: str = "restrict"  # restrict | cascade | set_null | no_action
    on_update: str = "restrict"
    state: str = "public"  # mid-DDL FKs enforce writes but not reads

    def to_pb(self) -> dict:
        return {
            "id": self.id,
            "name": self.name,
            "cols": self.col_offsets,
            "ref_db": self.ref_db,
            "ref_table": self.ref_table,
            "ref_cols": self.ref_col_names,
            "on_delete": self.on_delete,
            "on_update": self.on_update,
            "state": self.state,
        }

    @staticmethod
    def from_pb(pb: dict) -> "FKInfo":
        return FKInfo(
            pb["id"],
            pb["name"],
            pb["cols"],
            pb["ref_db"],
            pb["ref_table"],
            pb["ref_cols"],
            pb.get("on_delete", "restrict"),
            pb.get("on_update", "restrict"),
            pb.get("state", "public"),
        )


@dataclass
class PartitionDef:
    """One partition: its own physical table id (ref: model.PartitionDefinition
    — partitions are physical tables sharing one schema)."""

    id: int  # physical table id (record/index keys use this)
    name: str
    less_than: Optional[int] = None  # RANGE bound; None = MAXVALUE

    def to_pb(self) -> dict:
        return {"id": self.id, "name": self.name, "less_than": self.less_than}

    @staticmethod
    def from_pb(pb: dict) -> "PartitionDef":
        return PartitionDef(pb["id"], pb["name"], pb["less_than"])


@dataclass
class PartitionInfo:
    """RANGE / HASH partitioning over one integer-kind column
    (ref: model.PartitionInfo; expressions beyond a bare column are a later
    round — the reference's most common shapes are RANGE(col) and HASH(col))."""

    type: str  # "range" | "hash"
    col_offset: int
    defs: list[PartitionDef] = field(default_factory=list)

    def to_pb(self) -> dict:
        return {"type": self.type, "col": self.col_offset, "defs": [d.to_pb() for d in self.defs]}

    @staticmethod
    def from_pb(pb: dict) -> "PartitionInfo":
        return PartitionInfo(pb["type"], pb["col"], [PartitionDef.from_pb(d) for d in pb["defs"]])


@dataclass
class TableInfo:
    id: int
    name: str
    columns: list[ColumnInfo] = field(default_factory=list)
    indexes: list[IndexInfo] = field(default_factory=list)
    # int primary key stored AS the handle (ref: pk_is_handle in model.TableInfo)
    pk_is_handle: bool = False
    pk_offset: int = -1
    next_column_id: int = 1
    next_index_id: int = 1
    partition: Optional[PartitionInfo] = None
    # TTL (ref: model.TTLInfo): rows where col < now - ttl_days expire
    ttl_col_offset: int = -1
    ttl_days: int = 0
    ttl_enable: bool = True
    # child-side foreign keys (ref: model.TableInfo.ForeignKeys)
    foreign_keys: list[FKInfo] = field(default_factory=list)

    def column(self, name: str) -> Optional[ColumnInfo]:
        lname = name.lower()
        for c in self.columns:
            if c.name.lower() == lname:
                return c
        return None

    @property
    def storage_schema(self) -> list[FieldType]:
        return [c.ftype for c in self.columns]

    # -- partition helpers ---------------------------------------------------
    def partition_views(self) -> list["TableInfo"]:
        """One TableInfo clone per partition, with id = the partition's
        physical id (columns/indexes shared). Non-partitioned → [self]."""
        if self.partition is None:
            return [self]
        import dataclasses

        return [dataclasses.replace(self, id=d.id, partition=None) for d in self.partition.defs]

    def partition_view(self, pid: int) -> "TableInfo":
        import dataclasses

        return dataclasses.replace(self, id=pid, partition=None)

    def partition_id_for(self, vals: list) -> int:
        """Route a row to its partition's physical id. NULL routes to the
        first partition (MySQL RANGE semantics)."""
        assert self.partition is not None
        p = self.partition
        v = vals[p.col_offset]
        if p.type == "hash":
            if v is None:
                return p.defs[0].id
            return p.defs[int(v) % len(p.defs)].id
        if v is None:
            return p.defs[0].id
        for d in p.defs:
            if d.less_than is None or int(v) < d.less_than:
                return d.id
        from tidb_tpu_torch.catalog.catalog import CatalogError

        raise CatalogError(f"Table has no partition for value {v}")

    def to_pb(self) -> dict:
        return {
            "id": self.id,
            "name": self.name,
            "columns": [c.to_pb() for c in self.columns],
            "indexes": [i.to_pb() for i in self.indexes],
            "pk_is_handle": self.pk_is_handle,
            "pk_offset": self.pk_offset,
            "next_column_id": self.next_column_id,
            "next_index_id": self.next_index_id,
            "partition": self.partition.to_pb() if self.partition else None,
            "ttl": [self.ttl_col_offset, self.ttl_days, self.ttl_enable],
            "fks": [fk.to_pb() for fk in self.foreign_keys],
        }

    @staticmethod
    def from_pb(pb: dict) -> "TableInfo":
        return TableInfo(
            pb["id"],
            pb["name"],
            [ColumnInfo.from_pb(c) for c in pb["columns"]],
            [IndexInfo.from_pb(i) for i in pb["indexes"]],
            pb["pk_is_handle"],
            pb["pk_offset"],
            pb["next_column_id"],
            pb["next_index_id"],
            PartitionInfo.from_pb(pb["partition"]) if pb.get("partition") else None,
            *(pb.get("ttl") or [-1, 0, True]),
            [FKInfo.from_pb(f) for f in pb.get("fks", [])],
        )


@dataclass
class SequenceInfo:
    """CREATE SEQUENCE state (ref: model.SequenceInfo; single-process, so
    the cache window is just the persisted next value)."""

    name: str
    next_val: int = 1
    increment: int = 1
    start: int = 1

    def to_pb(self) -> dict:
        return {"name": self.name, "next": self.next_val, "inc": self.increment, "start": self.start}

    @staticmethod
    def from_pb(pb: dict) -> "SequenceInfo":
        return SequenceInfo(pb["name"], pb["next"], pb["inc"], pb["start"])


@dataclass
class ViewInfo:
    name: str
    text: str  # the defining SELECT, as SQL
    columns: list[str] = field(default_factory=list)  # optional renames

    def to_pb(self) -> dict:
        return {"name": self.name, "text": self.text, "columns": self.columns}

    @staticmethod
    def from_pb(pb: dict) -> "ViewInfo":
        return ViewInfo(pb["name"], pb["text"], pb.get("columns", []))


@dataclass
class DBInfo:
    name: str
    tables: dict[str, TableInfo] = field(default_factory=dict)
    views: dict[str, ViewInfo] = field(default_factory=dict)
    sequences: dict[str, SequenceInfo] = field(default_factory=dict)

    def to_pb(self) -> dict:
        return {
            "name": self.name,
            "tables": {k: t.to_pb() for k, t in self.tables.items()},
            "views": {k: v.to_pb() for k, v in self.views.items()},
            "sequences": {k: s.to_pb() for k, s in self.sequences.items()},
        }

    @staticmethod
    def from_pb(pb: dict) -> "DBInfo":
        return DBInfo(
            pb["name"],
            {k: TableInfo.from_pb(t) for k, t in pb["tables"].items()},
            {k: ViewInfo.from_pb(v) for k, v in pb.get("views", {}).items()},
            {k: SequenceInfo.from_pb(s) for k, s in pb.get("sequences", {}).items()},
        )
