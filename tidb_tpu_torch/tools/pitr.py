"""Log backup + point-in-time restore (ref: br/pkg/stream — the log backup
task capturing the KV change stream; br restore point = snapshot restore +
log replay to a target ts).

Layout of a log directory:

  logmeta.json              task state: start_ts, checkpoint_ts
  seg_<from>_<to>.log       change segments, binary frames
                            [klen u32][key][op u8][vlen u32][value][ts u64]

The task flushes the committed change feed (``MemStore.changes_since``)
into segments. Correctness anchors:

- flush captures up to the store's **resolved ts** (not a raw fresh ts), so
  a commit whose ts was drawn but whose writes have not applied yet can
  never be skipped past;
- each flush registers a **GC service safepoint** at the checkpoint, so MVCC
  versions the feed has not captured cannot be pruned out from under it;
- segments land via temp-file + rename (crash leaves the previous state,
  never a torn frame), and the reader bounds-checks every frame.

``restore_point`` restores a full backup, then replays entries with
backup_ts < commit_ts <= target_ts in commit order, re-keying record keys
through the restore's table-id map and recomputing index entries from row
bytes (so index layout never needs to match — same principle as the
snapshot restore). It validates that the log task STARTED at or before the
full backup's ts; a gap between them would silently lose writes.

Honest scope note: DDL after the full backup is NOT replayed (the reference
streams meta keys too); take a fresh full backup after schema changes.
"""

from __future__ import annotations

import json
import os
import struct

from tidb_tpu_torch.kv import tablecodec
from tidb_tpu_torch.kv.memstore import OP_PUT

_PUT_B, _DEL_B = 1, 0  # wire byte in segment frames


class LogBackupTask:
    """One running log-backup task over a store (ref: stream.TaskInfo)."""

    def __init__(self, db, log_dir: str, name: str = "log-backup"):
        self.db = db
        self.dir = log_dir
        self.name = name
        os.makedirs(log_dir, exist_ok=True)
        self._meta_path = os.path.join(log_dir, "logmeta.json")
        if os.path.exists(self._meta_path):
            with open(self._meta_path) as f:
                self.meta = json.load(f)
        else:
            start = db.store.current_ts()
            self.meta = {"start_ts": start, "checkpoint_ts": start}
            self._persist()
        db.store.register_service_safepoint(self.name, self.meta["checkpoint_ts"])

    def _persist(self) -> None:
        tmp = self._meta_path + ".tmp"
        with open(tmp, "w") as f:
            json.dump(self.meta, f)
        os.replace(tmp, self._meta_path)

    @property
    def checkpoint_ts(self) -> int:
        return self.meta["checkpoint_ts"]

    def flush(self) -> int:
        """Capture changes since the checkpoint into a new segment; returns
        the number of entries written. Safe to call on a timer."""
        ckpt = self.meta["checkpoint_ts"]
        # resolved ts: everything at or below it has APPLIED — a drawn-but-
        # unapplied commit still holds prewrite locks and bounds this
        upto = self.db.store.resolved_ts()
        if upto <= ckpt:
            return 0
        entries = self.db.store.changes_since(ckpt, upto)
        if entries:
            path = os.path.join(self.dir, f"seg_{ckpt}_{upto}.log")
            tmp = path + ".tmp"
            with open(tmp, "wb") as f:
                for key, op, value, ts in entries:
                    f.write(struct.pack("<I", len(key)) + key)
                    f.write(bytes([_PUT_B if op == OP_PUT else _DEL_B]))
                    f.write(struct.pack("<I", len(value)) + value)
                    f.write(struct.pack("<Q", ts))
            os.replace(tmp, path)
        self.meta["checkpoint_ts"] = upto
        self._persist()
        self.db.store.register_service_safepoint(self.name, upto)
        return len(entries)

    def stop(self) -> None:
        """End the task: the GC pin lifts (ref: br log backup task removal)."""
        self.db.store.remove_service_safepoint(self.name)


def read_segments(log_dir: str):
    """All log entries across segments, commit-ts ordered. Truncated or torn
    frames (should not happen — segments land by rename) fail loudly."""
    out: list[tuple[bytes, int, bytes, int]] = []
    for name in sorted(os.listdir(log_dir)):
        if not name.startswith("seg_") or name.endswith(".tmp"):
            continue
        with open(os.path.join(log_dir, name), "rb") as f:
            buf = f.read()
        off = 0
        while off < len(buf):
            if off + 4 > len(buf):
                raise ValueError(f"torn frame in {name} at offset {off}")
            (klen,) = struct.unpack_from("<I", buf, off)
            off += 4
            if off + klen + 1 + 4 > len(buf):
                raise ValueError(f"torn frame in {name} at offset {off}")
            key = buf[off : off + klen]
            off += klen
            op = buf[off]
            off += 1
            (vlen,) = struct.unpack_from("<I", buf, off)
            off += 4
            if off + vlen + 8 > len(buf):
                raise ValueError(f"torn frame in {name} at offset {off}")
            value = buf[off : off + vlen]
            off += vlen
            (ts,) = struct.unpack_from("<Q", buf, off)
            off += 8
            out.append((key, op, value, ts))
    out.sort(key=lambda e: e[3])
    return out


def restore_point(db, full_backup_dir: str, log_dir: str, target_ts: int | None = None, db_name: str | None = None) -> dict:
    """Snapshot restore + log replay to ``target_ts`` (default: everything
    captured). Returns {"tables": {table: snapshot rows}, "replayed": n}."""
    from tidb_tpu_torch.kv.rowcodec import RowSchema, decode_row
    from tidb_tpu_torch.executor.write import index_entry
    from tidb_tpu_torch.tools.brie import restore_database

    from tidb_tpu_torch.tools.storage import open_storage

    backup_ts = json.loads(
        open_storage(full_backup_dir).read_file("backupmeta.json").decode()
    )["backup_ts"]
    with open(os.path.join(log_dir, "logmeta.json")) as f:
        logmeta = json.load(f)
    if logmeta["start_ts"] > backup_ts:
        raise ValueError(
            f"log backup started at ts {logmeta['start_ts']}, AFTER the full "
            f"backup's ts {backup_ts}: changes in the gap were never captured "
            "(take the full backup while the log task is running)"
        )
    if target_ts is not None and target_ts > logmeta["checkpoint_ts"]:
        raise ValueError(
            f"target ts {target_ts} is past the log checkpoint "
            f"{logmeta['checkpoint_ts']}: flush the task first"
        )
    tables, id_map = restore_database(db, full_backup_dir, db_name)

    # physical id → (root TableInfo, view, RowSchema): constant per table,
    # built once — the replay loop only looks up
    view_of: dict[int, tuple] = {}
    for dbn in db.catalog.databases():
        for tn in db.catalog.tables(dbn):
            t = db.catalog.table(dbn, tn)
            schema = RowSchema(t.storage_schema)
            for v in t.partition_views():
                view_of[v.id] = (t, v, schema)

    replayed = 0
    max_handle_of: dict[int, int] = {}
    txn = db.store.begin()
    staged = 0
    for key, op, value, ts in read_segments(log_dir):
        if ts <= backup_ts:
            continue  # already inside the snapshot
        if target_ts is not None and ts > target_ts:
            break
        old_tid, handle = tablecodec.decode_record_key(key)
        new_tid = id_map.get(old_tid)
        if new_tid is None:
            continue  # a table outside this backup's scope
        t, view, schema = view_of[new_tid]
        new_key = tablecodec.record_key(new_tid, handle)
        old_raw = txn.get(new_key)
        if old_raw is not None:  # replace/delete: old index entries must go
            old_row = decode_row(schema, old_raw)
            for idx in t.indexes:
                if idx.state == "public":
                    ik, _ = index_entry(view, idx, old_row, handle)
                    txn.delete(ik)
        if op == _PUT_B:
            row = decode_row(schema, value)
            txn.put(new_key, value)
            for idx in t.indexes:
                if idx.state == "public":
                    ik, iv = index_entry(view, idx, row, handle)
                    txn.put(ik, iv)
            max_handle_of[t.id] = max(max_handle_of.get(t.id, 0), handle)
        else:
            txn.delete(new_key)
        replayed += 1
        staged += 1
        if staged >= 10_000:  # bounded txn batches
            txn.commit()
            txn = db.store.begin()
            staged = 0
    txn.commit()
    for tid, mh in max_handle_of.items():
        db.catalog.rebase_autoid(tid, mh + 1)
    return {"tables": dict(tables), "replayed": replayed}
