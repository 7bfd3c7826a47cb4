"""Catalog service: DDL + infoschema cache + id/autoid allocation.

Reference parity: pkg/meta.Mutator (meta.go:184, catalog under the ``m`` KV
prefix), pkg/infoschema (versioned cache), pkg/meta/autoid (batched
auto-increment), pkg/ddl (schema change).

Divergence (round 1, documented): schema changes apply synchronously under a
catalog lock and bump a global schema version; layout-changing ALTERs (add/
drop column) rewrite the table's rows in one transaction instead of running
the online five-state F1 protocol (ddl/job_worker.go:773). The seam for the
async DDL job queue exists (apply methods are already job-shaped).
"""

from __future__ import annotations

import json
import threading
from typing import Callable, Optional

from tidb_tpu_torch.catalog.schema import (
    ColumnInfo,
    DBInfo,
    IndexInfo,
    PartitionDef,
    PartitionInfo,
    TableInfo,
    typedef_to_ftype,
)
from tidb_tpu_torch.kv import KeyRange, tablecodec
from tidb_tpu_torch.kv.memstore import MemStore
from tidb_tpu_torch.kv.rowcodec import RowSchema, decode_row, encode_row
from tidb_tpu_torch.parser import ast
from tidb_tpu_torch.types import TypeKind
from tidb_tpu_torch.types.datum import date_to_days, datetime_to_micros

META_KEY = b"m:catalog"
META_VER_KEY = b"m:catalog_ver"  # bare version int (schema-lease fast path)
META_NEXT_ID = b"m:next_table_id"
AUTOID_PREFIX = b"m:autoid:"
AUTOID_BATCH = 5000


class CatalogError(Exception):
    pass


class Catalog:
    """One per store (all sessions share it)."""

    def __init__(self, store: MemStore):
        self.store = store
        self._mu = threading.RLock()
        self.schema_version = 0
        self._dbs: dict[str, DBInfo] = {}
        self._autoid_cache: dict[int, tuple[int, int]] = {}  # tid → (next, max)
        # dropped/truncated table snapshots awaiting GC (RECOVER TABLE)
        self._recycle: list[dict] = []
        # parent table id → [(child, fk, parent)] memo; DDL (every _persist)
        # drops it — DML calls this once per mutated row, so the raw
        # full-catalog sweep would make bulk deletes O(rows × tables)
        self._fk_ref_cache: dict = {}
        self._load()
        if "test" not in self._dbs:  # bootstrap default db (ref: session bootstrap)
            self._dbs["test"] = DBInfo("test")
            self._persist()

    # -- persistence -------------------------------------------------------
    def _load(self) -> None:
        raw = self.store.raw_get(META_KEY)
        if raw:
            pb = json.loads(raw.decode())
            self.schema_version = pb["version"]
            self._dbs = {k: DBInfo.from_pb(v) for k, v in pb["dbs"].items()}
            self._recycle = pb.get("recycle", [])

    def _persist(self) -> None:
        # cross-process guard (ref: domain schema-validator leases, here as
        # optimistic versioning): the write lands ATOMICALLY only if nobody
        # moved the persisted catalog since this process last read it —
        # otherwise reload and make the caller retry. A read-then-write pair
        # would let two processes erase each other's DDL.
        raw = self.store.raw_get(META_KEY)
        if raw is not None and json.loads(raw.decode()).get("version", 0) != self.schema_version:
            self.reload()
            raise CatalogError(
                "schema changed by another process; catalog reloaded — retry the statement"
            )
        self.schema_version += 1
        self._fk_ref_cache = {}
        pb = {
            "version": self.schema_version,
            "dbs": {k: v.to_pb() for k, v in self._dbs.items()},
            "recycle": self._recycle,
        }
        new = json.dumps(pb).encode()
        # version side-key FIRST: the hint may run AHEAD of the blob (a
        # too-new hint merely triggers a harmless reload) but must never lag
        # it — a crash after the blob-cas with a stale hint would hide the
        # DDL from every other node's schema-lease check indefinitely
        self.store.raw_put(META_VER_KEY, str(self.schema_version).encode())
        if hasattr(self.store, "raw_cas"):
            if not self.store.raw_cas(META_KEY, raw, new):
                self.schema_version -= 1
                self.reload()
                raise CatalogError(
                    "schema changed by another process; catalog reloaded — retry the statement"
                )
        else:
            self.store.raw_put(META_KEY, new)

    def persisted_version(self) -> int:
        """The store's current catalog version — the schema-validator lease
        primitive. Reads the small version key; falls back to the full
        catalog blob for stores written before the key existed."""
        raw = self.store.raw_get(META_VER_KEY)
        if raw is not None:
            return int(raw)
        blob = self.store.raw_get(META_KEY)
        return json.loads(blob.decode()).get("version", 0) if blob else 0

    def reload(self) -> None:
        """Re-read the persisted catalog (another process's DDL landed)."""
        with self._mu:
            self._dbs = {}
            self._recycle = []
            self._load()
            self._fk_ref_cache = {}

    def _next_table_id(self) -> int:
        raw = self.store.raw_get(META_NEXT_ID)
        nid = int(raw) if raw else 100
        self.store.raw_put(META_NEXT_ID, str(nid + 1).encode())
        return nid

    # -- lookup ------------------------------------------------------------
    def db(self, name: str) -> DBInfo:
        d = self._dbs.get(name.lower())
        if d is None:
            raise CatalogError(f"Unknown database '{name}'")
        return d

    def table(self, db: str, name: str) -> TableInfo:
        t = self.db(db).tables.get(name.lower())
        if t is None:
            raise CatalogError(f"Table '{db}.{name}' doesn't exist")
        return t

    def try_table(self, db: str, name: str) -> Optional[TableInfo]:
        d = self._dbs.get(db.lower())
        return d.tables.get(name.lower()) if d else None

    def databases(self) -> list[str]:
        return sorted(self._dbs)

    def tables(self, db: str) -> list[str]:
        return sorted(self.db(db).tables)

    # -- auto increment (ref: pkg/meta/autoid batched allocator) -----------
    def alloc_autoid(self, table_id: int, n: int = 1) -> int:
        """Returns first id of a contiguous block of n."""
        with self._mu:
            nxt, mx = self._autoid_cache.get(table_id, (0, 0))
            if nxt + n > mx:
                key = AUTOID_PREFIX + str(table_id).encode()
                raw = self.store.raw_get(key)
                base = int(raw) if raw else 1
                batch = max(AUTOID_BATCH, n)
                self.store.raw_put(key, str(base + batch).encode())
                nxt, mx = base, base + batch
            self._autoid_cache[table_id] = (nxt + n, mx)
            return nxt

    def rebase_autoid(self, table_id: int, at_least: int) -> None:
        with self._mu:
            nxt, mx = self._autoid_cache.get(table_id, (0, 0))
            if at_least >= nxt:
                self._autoid_cache[table_id] = (at_least, max(mx, at_least))
                key = AUTOID_PREFIX + str(table_id).encode()
                raw = self.store.raw_get(key)
                if not raw or int(raw) < at_least:
                    self.store.raw_put(key, str(at_least).encode())

    # -- DDL ----------------------------------------------------------------
    def create_database(self, name: str, if_not_exists: bool = False) -> None:
        with self._mu:
            lname = name.lower()
            if lname in self._dbs:
                if if_not_exists:
                    return
                raise CatalogError(f"database {name!r} exists")
            self._dbs[lname] = DBInfo(lname)
            self._persist()

    def drop_database(self, name: str, if_exists: bool = False) -> None:
        with self._mu:
            lname = name.lower()
            db = self._dbs.get(lname)
            if db is None:
                if if_exists:
                    return
                raise CatalogError(f"Unknown database '{name}'")
            for t in list(db.tables.values()):
                self._drop_table_data(t)
            del self._dbs[lname]
            self._persist()

    def create_table(self, db: str, stmt: ast.CreateTable) -> TableInfo:
        with self._mu:
            dbi = self.db(db)
            tname = stmt.table.name.lower()
            if tname in dbi.tables:
                if stmt.if_not_exists:
                    return dbi.tables[tname]
                raise CatalogError(f"Table {tname!r} already exists")
            t = TableInfo(id=self._next_table_id(), name=tname)
            pk_cols: list[str] = []
            for cd in stmt.columns:
                ft = typedef_to_ftype(cd.type, cd.not_null or cd.primary_key)
                default = None
                if cd.default is not None:
                    default = _fold_default(cd.default, ft)
                col = ColumnInfo(
                    id=t.next_column_id,
                    name=cd.name.lower(),
                    ftype=ft,
                    offset=len(t.columns),
                    default=default,
                    auto_increment=cd.auto_increment,
                )
                t.next_column_id += 1
                t.columns.append(col)
                if cd.primary_key:
                    pk_cols = [cd.name.lower()]
                if cd.unique:
                    t.indexes.append(IndexInfo(t.next_index_id, f"uq_{col.name}", [col.offset], unique=True))
                    t.next_index_id += 1
            for idx in stmt.indexes:
                if idx.primary:
                    pk_cols = [c.lower() for c in idx.columns]
                    continue
                offs = [self._col_offset(t, c) for c in idx.columns]
                t.indexes.append(IndexInfo(t.next_index_id, idx.name.lower(), offs, unique=idx.unique))
                t.next_index_id += 1
            if pk_cols:
                offs = [self._col_offset(t, c) for c in pk_cols]
                pk_ft = t.columns[offs[0]].ftype
                if len(offs) == 1 and pk_ft.kind in (TypeKind.INT, TypeKind.UINT):
                    t.pk_is_handle = True
                    t.pk_offset = offs[0]
                else:
                    t.indexes.insert(0, IndexInfo(t.next_index_id, "primary", offs, unique=True, primary=True))
                    t.next_index_id += 1
            if stmt.partition_by is not None:
                t.partition = self._build_partition_info(t, stmt.partition_by)
            if stmt.ttl is not None:
                self._set_ttl(t, stmt.ttl, stmt.ttl_enable)
            # register before FK resolution so self-referential FKs resolve;
            # roll the registration back if a constraint is invalid
            dbi.tables[tname] = t
            try:
                for fkd in stmt.foreign_keys:
                    self._install_fk(db, t, fkd, validate_rows=False)
            except Exception:
                del dbi.tables[tname]
                raise
            self._persist()
        if getattr(stmt, "auto_increment_base", None):
            # AUTO_INCREMENT = n table option seeds the allocator
            self.rebase_autoid(t.id, int(stmt.auto_increment_base))
        return t

    def _set_ttl(self, t: TableInfo, ttl: tuple, enable: bool) -> None:
        col, days = ttl
        off = self._col_offset(t, col)
        if t.columns[off].ftype.kind not in (TypeKind.DATE, TypeKind.DATETIME):
            raise CatalogError("TTL column must be DATE or DATETIME")
        t.ttl_col_offset, t.ttl_days, t.ttl_enable = off, days, enable

    def _build_partition_info(self, t: TableInfo, pby: ast.PartitionByDef) -> PartitionInfo:
        """Each partition is a physical table id (ref: model.PartitionInfo;
        indexes are local — unique keys are enforced per partition)."""
        off = self._col_offset(t, pby.column)
        if t.columns[off].ftype.kind not in (TypeKind.INT, TypeKind.UINT, TypeKind.DATE, TypeKind.DATETIME):
            raise CatalogError("partition column must be integer-kind")
        if pby.type == "hash":
            defs = [PartitionDef(self._next_table_id(), f"p{i}") for i in range(pby.num)]
            return PartitionInfo("hash", off, defs)
        defs = []
        prev: int | None = None
        for name, lt in pby.defs:
            if any(d.name == name for d in defs):
                raise CatalogError(f"duplicate partition name {name!r}")
            if prev is not None and lt is not None and lt <= prev:
                raise CatalogError("RANGE partition bounds must be strictly increasing")
            if defs and defs[-1].less_than is None:
                raise CatalogError("MAXVALUE partition must be last")
            defs.append(PartitionDef(self._next_table_id(), name, lt))
            prev = lt if lt is not None else prev
        return PartitionInfo("range", off, defs)

    @staticmethod
    def _col_offset(t: TableInfo, name: str) -> int:
        c = t.column(name)
        if c is None:
            raise CatalogError(f"key column {name!r} doesn't exist")
        return c.offset

    def drop_table(self, db: str, name: str, if_exists: bool = False) -> None:
        """DROP defers data deletion: the definition moves to the recycle bin
        with its rows intact until the GC safe point passes, enabling
        RECOVER/FLASHBACK TABLE (ref: TiDB delayed deletion + recover)."""
        with self._mu:
            dbi = self.db(db)
            t = dbi.tables.get(name.lower())
            if t is None:
                if if_exists:
                    return
                raise CatalogError(f"Unknown table '{name}'")
            # a referenced parent can't be dropped while children point at it
            # (self-references don't count — they drop with the table)
            for cdb, ct, fk in self.referencing_fks(db, name.lower()):
                if ct.id != t.id:
                    raise CatalogError(
                        f"cannot drop table {name!r}: referenced by foreign key "
                        f"{fk.name!r} of {cdb}.{ct.name}"
                    )
            self._recycle.append({"drop_ts": self.store.current_ts(), "db": db.lower(), "table": t.to_pb()})
            del dbi.tables[name.lower()]
            self._persist()

    def referencing_fks(self, db: str, table_name: str) -> list:
        """(child_db, child TableInfo, FKInfo) triples whose FK references
        ``db.table_name`` (ref: infoschema referredFKs lookup)."""
        out = []
        dbl, tnl = db.lower(), table_name.lower()
        for dbn, dbi in self._dbs.items():
            for ct in dbi.tables.values():
                for fk in ct.foreign_keys:
                    if fk.ref_db == dbl and fk.ref_table == tnl:
                        out.append((dbn, ct, fk))
        return out

    def referencing_fks_by_id(self, table_id: int) -> list:
        """(child TableInfo, FKInfo, parent TableInfo) triples whose FK
        resolves to the table with ``table_id`` — the DML parent-side hook.
        Memoized per schema version (cleared by _persist)."""
        hit = self._fk_ref_cache.get(table_id)
        if hit is not None:
            return hit
        out = []
        for dbi in self._dbs.values():
            for ct in dbi.tables.values():
                for fk in ct.foreign_keys:
                    p = self.try_table(fk.ref_db, fk.ref_table)
                    if p is not None and p.id == table_id:
                        out.append((ct, fk, p))
        self._fk_ref_cache[table_id] = out
        return out

    def truncate_table(self, db: str, name: str) -> TableInfo:
        """New table id; the old snapshot goes to the recycle bin
        (ref: TiDB truncate + FLASHBACK-after-truncate)."""
        import copy as _copy

        with self._mu:
            dbi = self.db(db)
            t = self.table(db, name)
            # MySQL: cannot truncate a table referenced by another table's FK
            # (self-references are fine — their rows truncate together)
            for cdb, ct, fk in self.referencing_fks(db, name):
                if ct.id != t.id:
                    raise CatalogError(
                        f"cannot truncate table {name!r}: referenced by foreign key "
                        f"{fk.name!r} of {cdb}.{ct.name}"
                    )
            self._recycle.append(
                {"drop_ts": self.store.current_ts(), "db": db.lower(), "table": _copy.deepcopy(t).to_pb()}
            )
            t.id = self._next_table_id()
            if t.partition is not None:
                for d in t.partition.defs:
                    d.id = self._next_table_id()
            self._persist()
            return t

    def recover_table(self, db: str, name: str, new_name: str = "") -> TableInfo:
        """RECOVER/FLASHBACK TABLE: restore the most recently dropped
        definition (data was never deleted) under its old or a new name."""
        with self._mu:
            dbi = self.db(db)
            for i in range(len(self._recycle) - 1, -1, -1):
                ent = self._recycle[i]
                if ent["db"] == db.lower() and ent["table"]["name"] == name.lower():
                    t = TableInfo.from_pb(ent["table"])
                    target = (new_name or t.name).lower()
                    if target in dbi.tables:
                        raise CatalogError(f"Table {target!r} already exists")
                    t.name = target
                    dbi.tables[target] = t
                    del self._recycle[i]
                    self._persist()
                    return t
            raise CatalogError(f"Can't find dropped table '{name}' in GC safe point range")

    def purge_recycle_bin(self, safe_ts: int) -> int:
        """GC: delete the data of entries dropped before the safe point."""
        with self._mu:
            keep = []
            purged = 0
            for ent in self._recycle:
                if ent["drop_ts"] < safe_ts:
                    self._drop_table_data(TableInfo.from_pb(ent["table"]))
                    purged += 1
                else:
                    keep.append(ent)
            if purged:
                self._recycle = keep
                self._persist()
            return purged

    # -- sequences (ref: ddl sequence.go / model.SequenceInfo) ---------------
    def create_sequence(self, db: str, name: str, start: int, increment: int, if_not_exists: bool) -> None:
        from tidb_tpu_torch.catalog.schema import SequenceInfo

        if increment == 0:
            raise CatalogError("sequence INCREMENT must be non-zero")
        with self._mu:
            dbi = self.db(db)
            if name.lower() in dbi.sequences:
                if if_not_exists:
                    return
                raise CatalogError(f"Sequence {name!r} already exists")
            dbi.sequences[name.lower()] = SequenceInfo(name.lower(), start, increment, start)
            self._persist()

    def drop_sequence(self, db: str, name: str, if_exists: bool = False) -> None:
        with self._mu:
            dbi = self.db(db)
            if name.lower() not in dbi.sequences:
                if if_exists:
                    return
                raise CatalogError(f"Unknown sequence '{name}'")
            del dbi.sequences[name.lower()]
            self._persist()

    def sequence_nextval(self, db: str, name: str) -> int:
        with self._mu:
            dbi = self.db(db)
            seq = dbi.sequences.get(name.lower())
            if seq is None:
                raise CatalogError(f"Unknown sequence '{name}'")
            v = seq.next_val
            seq.next_val += seq.increment
            self._persist()
            return v

    def sequence_setval(self, db: str, name: str, value: int) -> int:
        with self._mu:
            dbi = self.db(db)
            seq = dbi.sequences.get(name.lower())
            if seq is None:
                raise CatalogError(f"Unknown sequence '{name}'")
            seq.next_val = value + seq.increment
            self._persist()
            return value

    def sequences(self, db: str) -> list[str]:
        dbi = self._dbs.get(db.lower())
        return sorted(dbi.sequences.keys()) if dbi else []

    # -- views (ref: ddl CreateView / model.ViewInfo) ------------------------
    def create_view(self, db: str, stmt: ast.CreateView) -> None:
        from tidb_tpu_torch.catalog.schema import ViewInfo

        with self._mu:
            dbi = self.db(db)
            name = stmt.table.name.lower()
            if name in dbi.tables:
                raise CatalogError(f"'{name}' is not a view (a table exists)")
            if name in dbi.views and not stmt.or_replace:
                raise CatalogError(f"View {name!r} already exists")
            dbi.views[name] = ViewInfo(name, stmt.text, stmt.columns)
            self._persist()

    def drop_view(self, db: str, name: str, if_exists: bool = False) -> None:
        with self._mu:
            dbi = self.db(db)
            if name.lower() not in dbi.views:
                if if_exists:
                    return
                raise CatalogError(f"Unknown view '{name}'")
            del dbi.views[name.lower()]
            self._persist()

    def view(self, db: str, name: str):
        dbi = self._dbs.get(db.lower())
        return dbi.views.get(name.lower()) if dbi else None

    def views(self, db: str) -> list[str]:
        dbi = self._dbs.get(db.lower())
        return sorted(dbi.views.keys()) if dbi else []

    def register_restored_table(self, db: str, old: TableInfo) -> TableInfo:
        """RESTORE path: adopt a backed-up table's schema under fresh physical
        ids (ref: BR rewriting table ids on restore)."""
        import dataclasses

        with self._mu:
            dbi = self.db(db)
            if old.name in dbi.tables:
                raise CatalogError(f"Table {old.name!r} already exists")
            t = dataclasses.replace(old, id=self._next_table_id())
            if t.partition is not None:
                t.partition = PartitionInfo(
                    t.partition.type,
                    t.partition.col_offset,
                    [PartitionDef(self._next_table_id(), d.name, d.less_than) for d in t.partition.defs],
                )
            dbi.tables[t.name] = t
            self._persist()
            return t

    def _drop_table_data(self, t: TableInfo) -> None:
        from tidb_tpu_torch.copr.colcache import cache_for

        for view in t.partition_views():
            # stable blocks drop wholesale first — purging them row-by-row
            # would materialize every columnar row as a dict tombstone
            self.store.drop_stable(view.id)
            kr = KeyRange(tablecodec.table_prefix(view.id), tablecodec.table_prefix(view.id + 1))
            txn = self.store.begin()
            for k, _ in txn.scan(kr):
                txn.delete(k)
            txn.commit()
            cache_for(self.store).invalidate_table(view.id)
        if t.partition is not None:
            # shared (logical-id) dictionaries go with the table
            cache_for(self.store).invalidate_table(t.id)

    @property
    def ddl(self):
        """The owner DDL worker (ref: pkg/ddl; owner election is trivial in
        one process — see catalog/ddl.py)."""
        with self._mu:
            if getattr(self, "_ddl", None) is None:
                from tidb_tpu_torch.catalog.ddl import DDLWorker

                self._ddl = DDLWorker(self)
            return self._ddl

    def alter_table(self, db: str, stmt: ast.AlterTable) -> None:
        """ADD/DROP INDEX run as online async DDL jobs through the F1 state
        machine (catalog/ddl.py). Layout-changing ALTERs (add/drop column)
        rewrite the table's rows in one transaction — a documented divergence
        from per-column online states."""
        if stmt.action == "add_fk":
            with self._mu:
                t = self.table(db, stmt.table.name)
                self._install_fk(db, t, stmt.fk, validate_rows=True)
                self._persist()
            return
        if stmt.action == "drop_fk":
            with self._mu:
                t = self.table(db, stmt.table.name)
                before = len(t.foreign_keys)
                t.foreign_keys = [f for f in t.foreign_keys if f.name != stmt.name]
                if len(t.foreign_keys) == before:
                    raise CatalogError(f"foreign key {stmt.name!r} doesn't exist")
                self._persist()
            return
        if stmt.action == "add_index":
            t = self.table(db, stmt.table.name)
            for c in stmt.index.columns:
                self._col_offset(t, c)  # validate before enqueueing
            job = self.ddl.submit(
                "add_index",
                db,
                t.id,
                {"name": stmt.index.name.lower(), "columns": [c.lower() for c in stmt.index.columns], "unique": stmt.index.unique},
            )
            self.ddl.run_job(job)
            return
        if stmt.action == "drop_index":
            t = self.table(db, stmt.table.name)
            job = self.ddl.submit("drop_index", db, t.id, {"name": stmt.name.lower()})
            self.ddl.run_job(job)
            return
        with self._mu:
            t = self.table(db, stmt.table.name)
            if stmt.action == "add_column":
                cd = stmt.column
                ft = typedef_to_ftype(cd.type, cd.not_null)
                default = _fold_default(cd.default, ft) if cd.default is not None else None
                old_schema = RowSchema(t.storage_schema)
                col = ColumnInfo(t.next_column_id, cd.name.lower(), ft, len(t.columns), default, cd.auto_increment)
                t.next_column_id += 1
                t.columns.append(col)
                self._rewrite_rows(t, old_schema, lambda vals: vals + [_physical_default(col)])
            elif stmt.action == "drop_column":
                c = t.column(stmt.name)
                if c is None:
                    raise CatalogError(f"column {stmt.name!r} doesn't exist")
                off = c.offset
                if any(off in fk.col_offsets for fk in t.foreign_keys):
                    raise CatalogError(f"column {stmt.name!r} is used by a foreign key")
                for cdb, ct, fk in self.referencing_fks(db, t.name):
                    if c.name in fk.ref_col_names:
                        raise CatalogError(
                            f"column {stmt.name!r} is referenced by foreign key {fk.name!r} of {cdb}.{ct.name}"
                        )
                # child FK offsets past the dropped column shift down
                for fk in t.foreign_keys:
                    fk.col_offsets = [o - 1 if o > off else o for o in fk.col_offsets]
                old_schema = RowSchema(t.storage_schema)
                t.columns = [x for x in t.columns if x.offset != off]
                for i, x in enumerate(t.columns):
                    x.offset = i
                # indexes referencing the column are dropped; others re-offset
                keep = []
                for idx in t.indexes:
                    if off in idx.column_offsets:
                        continue
                    idx.column_offsets = [o - 1 if o > off else o for o in idx.column_offsets]
                    keep.append(idx)
                t.indexes = keep
                if t.pk_offset == off:
                    t.pk_is_handle, t.pk_offset = False, -1
                elif t.pk_offset > off:
                    t.pk_offset -= 1
                if t.partition is not None:
                    if t.partition.col_offset == off:
                        raise CatalogError("cannot drop the partitioning column")
                    if t.partition.col_offset > off:
                        t.partition.col_offset -= 1
                self._rewrite_rows(t, old_schema, lambda vals: vals[:off] + vals[off + 1 :])
            elif stmt.action == "rename":
                dbi = self.db(db)
                old_name = t.name
                new_name = stmt.name.lower()
                if new_name != old_name and (new_name in dbi.tables or new_name in dbi.views):
                    raise CatalogError(f"Table '{new_name}' already exists")
                del dbi.tables[old_name]
                t.name = stmt.name.lower()
                dbi.tables[t.name] = t
                # children name the parent by (db, table): follow the rename
                for _, ct, fk in self.referencing_fks(db, old_name):
                    fk.ref_table = t.name
            elif stmt.action == "set_ttl":
                self._set_ttl(t, stmt.ttl, True)
            elif stmt.action == "remove_ttl":
                t.ttl_col_offset, t.ttl_days, t.ttl_enable = -1, 0, True
            elif stmt.action == "ttl_enable":
                if t.ttl_col_offset < 0:
                    raise CatalogError("table has no TTL")
                t.ttl_enable = stmt.ttl_enable
            elif stmt.action == "add_partition":
                p = t.partition
                if p is None or p.type != "range":
                    raise CatalogError("ADD PARTITION requires a RANGE-partitioned table")
                if any(d.name == stmt.name for d in p.defs):
                    raise CatalogError(f"duplicate partition name {stmt.name!r}")
                last = p.defs[-1]
                if last.less_than is None:
                    raise CatalogError("cannot add after a MAXVALUE partition")
                if stmt.less_than is not None and stmt.less_than <= last.less_than:
                    raise CatalogError("new partition bound must exceed the last bound")
                p.defs.append(PartitionDef(self._next_table_id(), stmt.name, stmt.less_than))
            elif stmt.action in ("drop_partition", "truncate_partition"):
                p = t.partition
                if p is None:
                    raise CatalogError("table is not partitioned")
                d = next((d for d in p.defs if d.name == stmt.name.lower()), None)
                if d is None:
                    raise CatalogError(f"unknown partition {stmt.name!r}")
                if stmt.action == "drop_partition" and len(p.defs) == 1:
                    raise CatalogError("cannot drop the only partition")
                self._drop_table_data(t.partition_view(d.id))
                if stmt.action == "drop_partition":
                    p.defs.remove(d)
                else:
                    d.id = self._next_table_id()
            else:
                raise CatalogError(f"unsupported ALTER action {stmt.action!r}")
            self._persist()

    # -- foreign keys (ref: model.FKInfo + ddl foreign-key checks) ----------
    def _install_fk(self, db: str, t: TableInfo, fkd, validate_rows: bool) -> None:
        """Resolve + validate an FKDef against the catalog, auto-create the
        child index when none covers the FK prefix (MySQL behavior), and
        attach the FKInfo. ``validate_rows``: ALTER-time check that existing
        child rows all have parents (CREATE TABLE starts empty)."""
        from tidb_tpu_torch.catalog.schema import FKInfo

        if t.partition is not None:
            raise CatalogError("foreign keys on partitioned tables are not supported")
        ref_db = (fkd.ref_table.db or db).lower()
        parent = self.table(ref_db, fkd.ref_table.name)
        if parent.partition is not None:
            raise CatalogError("foreign keys referencing partitioned tables are not supported")
        if not fkd.columns or len(fkd.columns) != len(fkd.ref_columns):
            raise CatalogError("foreign key column count mismatch")
        col_offs = [self._col_offset(t, c) for c in fkd.columns]
        ref_offs = [self._col_offset(parent, c) for c in fkd.ref_columns]
        for co, ro in zip(col_offs, ref_offs):
            if t.columns[co].ftype.kind != parent.columns[ro].ftype.kind:
                raise CatalogError(
                    f"foreign key column {t.columns[co].name!r} is incompatible with "
                    f"referenced column {parent.columns[ro].name!r}"
                )
        if not _fk_parent_indexed(parent, ref_offs):
            raise CatalogError(
                "referenced columns must be the parent's primary key or a unique index"
            )
        fk_name = fkd.name
        if not fk_name:  # unnamed: auto-generate a distinct name (MySQL _ibfk_N)
            n = 1
            while any(f.name == f"fk_{n}" for f in t.foreign_keys):
                n += 1
            fk_name = f"fk_{n}"
        if any(f.name == fk_name for f in t.foreign_keys):
            raise CatalogError(f"duplicate foreign key name {fk_name!r}")
        if (fkd.on_delete == "set_null" or fkd.on_update == "set_null") and any(
            not t.columns[o].ftype.nullable for o in col_offs
        ):
            raise CatalogError("SET NULL actions require nullable foreign key columns")
        # validate BEFORE any mutation: a failed ALTER ... ADD FOREIGN KEY
        # must leave no phantom index behind (validation scans rows directly,
        # so it needs no index)
        if validate_rows:
            self._validate_fk_rows(t, parent, col_offs, ref_offs, fk_name)
        covered = (t.pk_is_handle and col_offs == [t.pk_offset]) or any(
            idx.state == "public" and list(idx.column_offsets[: len(col_offs)]) == col_offs
            for idx in t.indexes
        )
        if not covered:
            # MySQL auto-creates an index on the FK columns when none exists
            t.indexes.append(IndexInfo(t.next_index_id, fk_name, list(col_offs)))
            t.next_index_id += 1
            if validate_rows:
                self._backfill_index_now(t, t.indexes[-1])
        fk_id = max((f.id for f in t.foreign_keys), default=0) + 1
        t.foreign_keys.append(
            FKInfo(
                fk_id,
                fk_name,
                list(col_offs),
                ref_db,
                parent.name,
                [parent.columns[o].name for o in ref_offs],
                fkd.on_delete,
                fkd.on_update,
            )
        )

    def _backfill_index_now(self, t: TableInfo, idx) -> None:
        """Synchronous index backfill for FK auto-indexes (the async F1 path
        serves user ADD INDEX; an FK's supporting index must exist before the
        constraint validates)."""
        from tidb_tpu_torch.executor.write import index_entry

        schema = RowSchema(t.storage_schema)
        txn = self.store.begin()
        for k, v in txn.scan(tablecodec.record_range(t.id)):
            _, handle = tablecodec.decode_record_key(k)
            vals = decode_row(schema, v)
            ik, iv = index_entry(t, idx, vals, handle)
            txn.put(ik, iv)
        txn.commit()
        from tidb_tpu_torch.copr.colcache import cache_for

        cache_for(self.store).invalidate_table(t.id)

    def _validate_fk_rows(self, t: TableInfo, parent: TableInfo, col_offs, ref_offs, fk_name: str) -> None:
        """Every existing child key must have a parent (ref: ALTER TABLE ADD
        FOREIGN KEY validating with foreign_key_checks=ON)."""
        schema_p = RowSchema(parent.storage_schema)
        txn = self.store.begin()
        parent_keys = set()
        for _, v in txn.scan(tablecodec.record_range(parent.id)):
            vals = decode_row(schema_p, v)
            parent_keys.add(tuple(vals[o] for o in ref_offs))
        schema_c = RowSchema(t.storage_schema)
        for _, v in txn.scan(tablecodec.record_range(t.id)):
            vals = decode_row(schema_c, v)
            key = tuple(vals[o] for o in col_offs)
            if any(k is None for k in key):
                continue
            if key not in parent_keys:
                raise CatalogError(
                    f"cannot add foreign key {fk_name!r}: child row {key} has no parent"
                )

    def _rewrite_rows(self, t: TableInfo, old_schema: RowSchema, fn: Callable[[list], list]) -> None:
        from tidb_tpu_torch.copr.colcache import cache_for

        new_schema = RowSchema(t.storage_schema)
        for view in t.partition_views():
            txn = self.store.begin()
            for k, v in txn.scan(tablecodec.record_range(view.id)):
                txn.put(k, encode_row(new_schema, fn(decode_row(old_schema, v))))
            txn.commit()
            # every row (incl. stable ones, surfaced by the merged scan) was
            # just rewritten into the delta layer under the NEW layout; the
            # old-layout blocks would desync slot numbering — drop them
            self.store.drop_stable(view.id)
            cache_for(self.store).invalidate_table(view.id)


def _fk_parent_indexed(parent: TableInfo, ref_offs: list[int]) -> bool:
    """Referenced columns must be the parent PK or exactly a unique index
    (uniqueness makes child→parent lookups point reads and keeps RESTRICT
    semantics unambiguous)."""
    if parent.pk_is_handle and ref_offs == [parent.pk_offset]:
        return True
    for idx in parent.indexes:
        if idx.state != "public" or not (idx.unique or idx.primary):
            continue
        if list(idx.column_offsets) == list(ref_offs):
            return True
    return False


def _fold_default(node: ast.Node, ft) -> object:
    if isinstance(node, ast.Literal):
        v = node.value
    elif isinstance(node, ast.UnaryOp) and node.op == "unaryminus" and isinstance(node.operand, ast.Literal):
        v = -float(node.operand.value) if "." in str(node.operand.value) else -int(node.operand.value)
    elif isinstance(node, ast.FuncCall) and node.name in ("current_timestamp", "now"):
        return "CURRENT_TIMESTAMP"
    else:
        raise CatalogError("unsupported DEFAULT expression")
    return v


def _physical_default(col: ColumnInfo):
    """Default in physical (rowcodec) form for backfill."""
    v = col.default
    if v is None:
        return None
    k = col.ftype.kind
    if k == TypeKind.STRING:
        return v.encode() if isinstance(v, str) else v
    if k == TypeKind.DECIMAL:
        return int(round(float(v) * 10**col.ftype.scale))
    if k == TypeKind.DATE and isinstance(v, str):
        return date_to_days(v)
    if k == TypeKind.DATETIME and isinstance(v, str):
        return datetime_to_micros(v)
    if k == TypeKind.FLOAT:
        return float(v)
    return int(v)
