"""BACKUP / RESTORE (ref: br/ physical backup; SQL surface executor/brie.go).

Destinations are ExternalStorage URLs (tools/storage.py — the
br/pkg/storage seam): ``file:///dir``, a bare directory path, or
``memory://bucket/prefix`` (the hermetic object-store stand-in).

Format: a storage prefix holding
  backupmeta.json        — backup_ts + per-table schema pb (catalog format)
  backup.checkpoint.json — progress: backup_ts + the tables already written
  <db>.<table>.rows      — per physical table: [handle i64][len u32][row bytes]*
Rows are MVCC-consistent at backup_ts. Restore recreates tables (fresh ids),
re-keys rows for the new ids, ingests through the SST-style bulk path, and
rebuilds indexes from row data (so index ids/layout never need to match).

Partial-backup resume (the RESILIENCE.md "mid-BACKUP" gap): the checkpoint
file updates after EVERY completed table, so a backup that dies mid-way can
be re-run against the same destination and skips the tables it already
wrote — re-using the ORIGINAL backup_ts, so finished files and the
remaining scans read the same snapshot (ref: br's checkpoint backup;
restorability is still gated on backupmeta.json, which is written LAST)."""

from __future__ import annotations

import json
import struct

from tidb_tpu_torch.catalog.schema import TableInfo
from tidb_tpu_torch.kv import tablecodec


_CHECKPOINT = "backup.checkpoint.json"


def backup_database(db, db_name: str, dest: str, tables: list[str] | None = None) -> dict:
    """Snapshot-consistent backup of a database (or a table subset) to the
    ``dest`` storage URL; returns the meta dict (incl. backup_ts, per-table
    row counts). Re-running after a mid-backup fault RESUMES from the
    per-table checkpoint: completed tables are skipped (their files are
    already consistent at the checkpointed backup_ts) and only the
    remaining ones re-round-trip."""
    from tidb_tpu_torch.tools.storage import open_storage

    store_out = open_storage(dest)
    names = tables if tables is not None else db.catalog.tables(db_name)
    done: dict = {}
    backup_ts = None
    if store_out.exists(_CHECKPOINT) and not store_out.exists("backupmeta.json"):
        import time as _time

        ck = json.loads(store_out.read_file(_CHECKPOINT).decode())
        try:
            life_s = float(db.global_vars.get("tidb_gc_life_time", 600))
        except (TypeError, ValueError):
            life_s = 600.0
        # resume: keep the ORIGINAL backup_ts — the finished files were
        # written at that snapshot, and mixing snapshots would make the
        # restored database internally inconsistent. A checkpoint older
        # than the GC life is DISCARDED (fresh run at a fresh ts): MVCC GC
        # may have pruned the versions that snapshot needs, and a resumed
        # scan would silently read post-GC state against pre-GC files.
        fresh_enough = _time.time() - ck.get("created", 0.0) < life_s
        if ck.get("db") == db_name and fresh_enough:
            done = {
                n: m for n, m in ck.get("tables", {}).items()
                if store_out.exists(m["file"])
            }
            if done:
                backup_ts = ck["backup_ts"]
    if backup_ts is None:
        backup_ts = db.store.current_ts()
        done = {}
    meta: dict = {"backup_ts": backup_ts, "db": db_name, "tables": {}}
    # go through the store's own snapshot factory (not memstore.Snapshot
    # directly) so backups compose with wrapped stores — fault-injected,
    # remote, sharded — the chaos tests depend on this seam
    snap = db.store.get_snapshot(backup_ts)
    for name in names:
        t = db.catalog.table(db_name, name)
        if t.name in done:
            meta["tables"][t.name] = done[t.name]
            continue
        count = 0
        fname = f"{db_name}.{t.name}.rows"
        with store_out.create(fname) as w:
            for view in t.partition_views():
                for k, v in snap.scan(tablecodec.record_range(view.id)):
                    handle = tablecodec.decode_record_key(k)[1]
                    w.write(struct.pack("<qI", handle, len(v)))
                    w.write(v)
                    count += 1
        meta["tables"][t.name] = {"schema": t.to_pb(), "rows": count, "file": fname}
        done[t.name] = meta["tables"][t.name]
        import time as _time

        store_out.write_file(
            _CHECKPOINT,
            json.dumps(
                {
                    "backup_ts": backup_ts,
                    "db": db_name,
                    "tables": done,
                    # wall clock of the checkpoint: resumes past the GC life
                    # discard it (the snapshot may no longer be readable)
                    "created": _time.time(),
                }
            ).encode(),
        )
    store_out.write_file("backupmeta.json", json.dumps(meta).encode())
    return meta


def restore_database(db, src: str, db_name: str | None = None) -> tuple[dict, dict]:
    """Restore a backup directory; returns ({table: rows}, {old physical
    table id: new id}) — the id map lets PITR log replay re-key entries
    recorded under the ORIGINAL ids. Tables must not already exist (ref: BR
    restore refusing to overwrite)."""
    from tidb_tpu_torch.tools.storage import open_storage

    store_in = open_storage(src)
    meta = json.loads(store_in.read_file("backupmeta.json").decode())
    target_db = db_name or meta["db"]
    if target_db not in db.catalog.databases():
        db.catalog.create_database(target_db, if_not_exists=True)
    from tidb_tpu_torch.catalog.catalog import CatalogError

    for name in meta["tables"]:
        if name in db.catalog.tables(target_db):
            raise CatalogError(f"restore target table {target_db}.{name} already exists")

    out: dict = {}
    id_map: dict[int, int] = {}  # old physical table id → new (PITR replay re-keys)
    for name, tmeta in meta["tables"].items():
        old = TableInfo.from_pb(tmeta["schema"])
        new_t = db.catalog.register_restored_table(target_db, old)
        id_map[old.id] = new_t.id
        for ov, nv in zip(old.partition_views(), new_t.partition_views()):
            id_map[ov.id] = nv.id
        n = _restore_rows(db, new_t, store_in.read_file(tmeta["file"]))
        out[name] = n
    return out, id_map


def _restore_rows(db, t: TableInfo, blob: bytes) -> int:
    from tidb_tpu_torch.executor.write import index_entry
    from tidb_tpu_torch.kv.rowcodec import RowSchema, decode_row

    schema = RowSchema(t.storage_schema)
    has_index = any(i.state == "public" for i in t.indexes)
    keys: list[bytes] = []
    vals: list[bytes] = []
    n = 0
    max_handle = 0
    off = 0
    while True:
        if off + 12 > len(blob):
            break
        handle, ln = struct.unpack_from("<qI", blob, off)
        off += 12
        raw = blob[off : off + ln]
        off += ln
        if t.partition is not None or has_index:
            row = decode_row(schema, raw)
            view = (
                t.partition_view(t.partition_id_for(row)) if t.partition is not None else t
            )
            keys.append(tablecodec.record_key(view.id, handle))
            vals.append(raw)
            for idx in t.indexes:
                if idx.state != "public":
                    continue
                ik, iv = index_entry(view, idx, row, handle)
                keys.append(ik)
                vals.append(iv)
        else:
            keys.append(tablecodec.record_key(t.id, handle))
            vals.append(raw)
        max_handle = max(max_handle, handle)
        n += 1
    if keys:
        db.store.ingest(keys, vals)
    db.catalog.rebase_autoid(t.id, max_handle + 1)
    return n
