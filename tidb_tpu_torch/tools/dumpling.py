"""Logical export (ref: dumpling/export): schema + data as SQL files, or
data as CSV. File layout mirrors dumpling's: <db>-schema-create.sql,
<db>.<table>-schema.sql, <db>.<table>.sql / .csv."""

from __future__ import annotations

import os

_BATCH = 1000


def _sql_literal(v) -> str:
    if v is None:
        return "NULL"
    if isinstance(v, bytes):
        v = v.decode("utf-8", "replace")
    if isinstance(v, str):
        return "'" + v.replace("\\", "\\\\").replace("'", "\\'") + "'"
    if hasattr(v, "isoformat"):
        return f"'{v.isoformat(sep=' ') if hasattr(v, 'hour') else v.isoformat()}'"
    return str(v)


def _csv_field(v) -> str:
    if v is None:
        return "\\N"
    if isinstance(v, bytes):
        v = v.decode("utf-8", "replace")
    s = str(v) if not hasattr(v, "isoformat") else (v.isoformat(sep=" ") if hasattr(v, "hour") else v.isoformat())
    if any(c in s for c in ',"\n'):
        s = '"' + s.replace('"', '""') + '"'
    return s


def _sql_type(ft) -> str:
    from tidb_tpu_torch.types import TypeKind

    k = ft.kind
    if k == TypeKind.INT:
        return "BIGINT"
    if k == TypeKind.UINT:
        return "BIGINT UNSIGNED"
    if k == TypeKind.FLOAT:
        return "DOUBLE"
    if k == TypeKind.DECIMAL:
        return f"DECIMAL({ft.length},{ft.scale})"
    if k == TypeKind.STRING:
        if ft.json:
            return "JSON"
        return f"VARCHAR({ft.length})" if ft.length >= 0 else "TEXT"
    if k == TypeKind.DATE:
        return "DATE"
    if k == TypeKind.DATETIME:
        return "DATETIME"
    if k == TypeKind.DURATION:
        return "TIME"
    if k == TypeKind.JSON:
        return "JSON"
    return "BIGINT"


def _create_table_sql(t, db: str = "") -> str:
    """``db``: the table's own database — cross-database FK references get
    qualified so restores bind the constraint to the right table."""
    parts = []
    for c in t.columns:
        line = f"`{c.name}` {_sql_type(c.ftype)}"
        if not c.ftype.nullable:
            line += " NOT NULL"
        if t.pk_is_handle and c.offset == t.pk_offset:
            line += " PRIMARY KEY"
        if c.auto_increment:
            line += " AUTO_INCREMENT"
        parts.append(line)
    for idx in t.indexes:
        if idx.state != "public":
            continue
        cols = ", ".join(f"`{t.columns[o].name}`" for o in idx.column_offsets)
        kw = "UNIQUE KEY" if idx.unique else "KEY"
        parts.append(f"{kw} `{idx.name}` ({cols})")
    for fk in t.foreign_keys:
        cols = ", ".join(f"`{t.columns[o].name}`" for o in fk.col_offsets)
        rcols = ", ".join(f"`{n}`" for n in fk.ref_col_names)
        ref = f"`{fk.ref_table}`" if fk.ref_db == (db or fk.ref_db) else f"`{fk.ref_db}`.`{fk.ref_table}`"
        line = f"CONSTRAINT `{fk.name}` FOREIGN KEY ({cols}) REFERENCES {ref} ({rcols})"
        acts = {"restrict": "RESTRICT", "cascade": "CASCADE", "set_null": "SET NULL", "no_action": "NO ACTION"}
        if fk.on_delete != "restrict":
            line += f" ON DELETE {acts[fk.on_delete]}"
        if fk.on_update != "restrict":
            line += f" ON UPDATE {acts[fk.on_update]}"
        parts.append(line)
    body = ",\n  ".join(parts)
    tail = ""
    if t.partition is not None:
        p = t.partition
        col = t.columns[p.col_offset].name
        if p.type == "hash":
            tail = f"\nPARTITION BY HASH (`{col}`) PARTITIONS {len(p.defs)}"
        else:
            defs = ", ".join(
                f"PARTITION {d.name} VALUES LESS THAN ({d.less_than if d.less_than is not None else 'MAXVALUE'})"
                for d in p.defs
            )
            tail = f"\nPARTITION BY RANGE (`{col}`) ({defs})"
    return f"CREATE TABLE `{t.name}` (\n  {body}\n){tail};\n"


def dump_database(db, db_name: str, dest: str, fmt: str = "sql") -> dict:
    """Export one database. fmt: "sql" (INSERTs) or "csv". Returns
    {table: row_count}."""
    if fmt not in ("sql", "csv"):
        raise ValueError(f"unsupported dump format {fmt!r} (want 'sql' or 'csv')")
    os.makedirs(dest, exist_ok=True)
    with open(os.path.join(dest, f"{db_name}-schema-create.sql"), "w") as f:
        f.write(f"CREATE DATABASE IF NOT EXISTS `{db_name}`;\n")
    s = db.session()
    s.current_db = db_name
    out: dict = {}
    for name in db.catalog.tables(db_name):
        t = db.catalog.table(db_name, name)
        with open(os.path.join(dest, f"{db_name}.{name}-schema.sql"), "w") as f:
            f.write(_create_table_sql(t, db_name))
        rows = s.query(f"SELECT * FROM `{name}`")
        out[name] = len(rows)
        colnames = ", ".join(f"`{c.name}`" for c in t.columns)
        if fmt == "sql":
            with open(os.path.join(dest, f"{db_name}.{name}.sql"), "w") as f:
                for i in range(0, len(rows), _BATCH):
                    batch = rows[i : i + _BATCH]
                    vals = ",\n".join("(" + ", ".join(_sql_literal(v) for v in r) + ")" for r in batch)
                    f.write(f"INSERT INTO `{name}` ({colnames}) VALUES\n{vals};\n")
        else:
            with open(os.path.join(dest, f"{db_name}.{name}.csv"), "w") as f:
                f.write(",".join(c.name for c in t.columns) + "\n")
                for r in rows:
                    f.write(",".join(_csv_field(v) for v in r) + "\n")
    return out


def load_dump(db, src: str, db_name: str) -> None:
    """Replay a SQL-format dump (schema files then data files)."""
    from tidb_tpu_torch.parser import parse_many

    s = db.session()
    s.current_db = db_name
    files = sorted(os.listdir(src))
    for suffix in ("-schema-create.sql", "-schema.sql", ".sql"):
        for fn in files:
            if not fn.endswith(".sql"):
                continue
            is_schema_create = fn.endswith("-schema-create.sql")
            is_schema = fn.endswith("-schema.sql") and not is_schema_create
            is_data = not fn.endswith(("-schema.sql", "-schema-create.sql"))
            if (
                (suffix == "-schema-create.sql" and not is_schema_create)
                or (suffix == "-schema.sql" and not is_schema)
                or (suffix == ".sql" and not is_data)
            ):
                continue
            with open(os.path.join(src, fn)) as f:
                for stmt in parse_many(f.read()):
                    s._execute_stmt(stmt)
            s.commit()  # _execute_stmt stages; flush like autocommit would
