"""IMPORT INTO — CSV bulk import (ref: pkg/lightning mydump parsing +
disttask/importinto SQL surface). Parses CSV host-side, converts to physical
columns, and loads through the native SST-style ingest (executor/load)."""

from __future__ import annotations

import csv as _csv

from tidb_tpu_torch.types import TypeKind


def import_into(db, db_name: str, table_name: str, path: str, *, skip_header: bool | None = None, delimiter: str = ",") -> int:
    """Load a CSV file into a table; returns rows imported. ``skip_header``
    defaults to auto-detect (header row matching the column names)."""
    t = db.catalog.table(db_name, table_name)
    rows = parse_csv_rows(t, path, skip_header, delimiter)
    if not rows:
        return 0
    return import_rows_slice(db, db_name, table_name, rows)


def parse_csv_rows(t, path: str, skip_header: bool | None, delimiter: str) -> list[list]:
    """CSV → typed row lists (shared by the direct and disttask paths)."""
    with open(path, newline="") as f:
        reader = _csv.reader(f, delimiter=delimiter)
        rows = [r for r in reader if r]
    if not rows:
        return []
    if skip_header is None:
        first = [x.strip().lower() for x in rows[0]]
        skip_header = first == [c.name.lower() for c in t.columns]
    if skip_header:
        rows = rows[1:]
    return rows


def import_rows_slice(db, db_name: str, table_name: str, rows: list[list], handle_base: int | None = None, on_existing: str | None = None) -> int:
    """Convert + load one slice of parsed CSV rows. ``handle_base``/``on_existing``
    make a disttask subtask re-run idempotent (see bulk_load)."""
    t = db.catalog.table(db_name, table_name)
    ncols = len(t.columns)
    cols: list[list] = [[] for _ in range(ncols)]
    for r in rows:
        if len(r) != ncols:
            raise ValueError(f"row has {len(r)} fields, table has {ncols} columns")
        for c, field in enumerate(r):
            ft = t.columns[c].ftype
            if field == "\\N" or (field == "" and ft.kind not in (TypeKind.STRING,)):
                cols[c].append(None)
            else:
                cols[c].append(_convert(field, ft))
    from tidb_tpu_torch.executor.load import bulk_load

    return bulk_load(db, table_name, cols, db_name=db_name, handle_base=handle_base, on_existing=on_existing)


# -- disttask integration (ref: disttask/importinto: the IMPORT INTO SQL
# surface plans row-range subtasks executed by the framework's workers) -----

_SUBTASK_ROWS = 100_000


class _ImportExt:
    steps = [1]

    def plan_subtasks(self, task, step, manager):
        m = task.meta
        t = manager.db.catalog.table(m["db"], m["table"])
        n = len(parse_csv_rows(t, m["path"], m.get("skip_header"), m.get("delimiter", ",")))
        if n == 0:
            return []
        # metas are self-contained (row ranges over a shared file path):
        # an executor node in ANOTHER process re-parses its slice. The whole
        # autoid range is reserved HERE, once — each subtask writes a
        # deterministic handle span, so a lease-expired subtask that re-runs
        # (possibly racing its not-actually-dead first worker) rewrites the
        # SAME keys instead of appending duplicates (ref: lightning
        # checkpoints re-importing a failed engine's deterministic keys)
        hbase = None if t.pk_is_handle else manager.db.catalog.alloc_autoid(t.id, n)
        return [
            {"start": i, "end": min(i + _SUBTASK_ROWS, n),
             "hbase": None if hbase is None else hbase + i}
            for i in range(0, n, _SUBTASK_ROWS)
        ]

    def on_done(self, task, manager):
        pass


class _ImportExec:
    def run_subtask(self, task, subtask, manager):
        from tidb_tpu_torch.utils import failpoint

        m = task.meta
        db = manager.db
        t = db.catalog.table(m["db"], m["table"])
        rows = parse_csv_rows(t, m["path"], m.get("skip_header"), m.get("delimiter", ","))
        failpoint.inject("import_subtask_before_ingest", subtask)
        sl = rows[subtask.meta["start"] : subtask.meta["end"]]
        n = import_rows_slice(
            db, m["db"], m["table"], sl,
            handle_base=subtask.meta.get("hbase"),
            on_existing="skip" if subtask.meta.get("hbase") is not None else "verify",
        )
        return {"rows": n}


def register_import_task_type() -> None:
    """Idempotent registration — every process that may EXECUTE import
    subtasks (SQL layer, storage server, worker pods) calls this."""
    from tidb_tpu_torch.disttask import register_task_type

    register_task_type("import_into", _ImportExt(), _ImportExec())


def import_into_disttask(db, db_name: str, table_name: str, path: str, *, skip_header=None, delimiter=",") -> int:
    """IMPORT INTO through the distributed task framework; returns rows."""
    from tidb_tpu_torch.disttask import DistTaskManager

    register_import_task_type()
    mgr = getattr(db, "_disttask_mgr", None)
    if mgr is None:
        mgr = DistTaskManager(db)
        db._disttask_mgr = mgr
    tid = mgr.submit_task(
        "import_into",
        {"db": db_name, "table": table_name, "path": path, "skip_header": skip_header, "delimiter": delimiter},
    )
    task = mgr.run_task(tid)
    if task.state != "succeed":
        raise RuntimeError(f"IMPORT INTO task {tid} {task.state}: {task.error}")
    return sum(st.summary.get("rows", 0) for st in mgr.subtasks(tid))


def _convert(s: str, ft):
    k = ft.kind
    if k in (TypeKind.STRING,):
        return s.encode()
    if k == TypeKind.FLOAT:
        return float(s)
    if k in (TypeKind.INT, TypeKind.UINT):
        return int(s)
    # decimals / dates / datetimes: bulk_load's to_physical path parses them
    return s
