"""DML executors: INSERT / UPDATE / DELETE with index maintenance.

Reference parity: pkg/executor/insert.go, update.go, delete.go +
pkg/table/tables (AddRecord/UpdateRecord/RemoveRecord) + index KV layout
(tablecodec). All writes stage into the session txn's membuffer; constraint
checks read through the txn (so uncommitted rows conflict correctly).
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from tidb_tpu_torch.catalog.schema import IndexInfo, TableInfo
from tidb_tpu_torch.expression.expr import EvalBatch, eval_to_column
from tidb_tpu_torch.kv import tablecodec
from tidb_tpu_torch.kv.rowcodec import RowSchema, decode_row, encode_row
from tidb_tpu_torch.parser import ast
from tidb_tpu_torch.planner.builder import BuildCtx, Builder, _literal
from tidb_tpu_torch.planner.plans import OutCol, PlanError
from tidb_tpu_torch.types import TypeKind
from tidb_tpu_torch.types.datum import date_to_days, datetime_to_micros
from tidb_tpu_torch.utils import codec
from tidb_tpu_torch.utils.chunk import Chunk, Column


class WriteError(Exception):
    pass


class DupKeyError(WriteError):
    def __init__(self, key_desc: str):
        super().__init__(f"Duplicate entry for key '{key_desc}'")


# -- value coercion: literal → physical slot value ---------------------------


def _strict(session) -> bool:
    return "STRICT" in str(session.vars.get("sql_mode", "")).upper()


def _warn_of(session):
    return session.append_warning


def to_physical(v, ftype, warn=None, strict: bool = True, col: str = "") -> object:
    """Logical → storage value. Non-strict mode coerces MySQL-style —
    leading-numeric string prefixes, clamped garbage — and reports through
    ``warn`` (ref: types truncation + stmtctx.AppendWarning: 1265/1366);
    strict mode raises like MySQL's STRICT_TRANS_TABLES."""
    if v is None:
        return None
    k = ftype.kind
    if k in (TypeKind.INT, TypeKind.UINT) and isinstance(v, str):
        import re as _re
        from decimal import ROUND_HALF_UP, Decimal

        num = _re.match(r"\s*([+-]?(?:\d+(?:\.\d*)?|\.\d+)(?:[eE][+-]?\d+)?)\s*$", v)
        if num is not None:
            # clean numeric string: MySQL rounds half away from zero, no
            # warning ('12.5' → 13)
            v = int(Decimal(num.group(1)).to_integral_value(rounding=ROUND_HALF_UP))
        else:
            m = _re.match(r"\s*[+-]?\d+", v)
            if m is not None:
                # numeric prefix + trailing garbage → 1265 Data truncated
                msg = f"Data truncated for column '{col}'"
                code = 1265
            else:
                msg = f"Incorrect integer value: '{v}' for column '{col}'"
                code = 1366
            if strict:
                raise WriteError(msg)
            if warn is not None:
                warn("Warning", code, msg)
            v = int(m.group()) if m else 0
    if k == TypeKind.FLOAT and isinstance(v, str):
        try:
            v = float(v)
        except ValueError:
            msg = f"Incorrect DOUBLE value: '{v}' for column '{col}'"
            if strict:
                raise WriteError(msg)
            if warn is not None:
                warn("Warning", 1366, msg)
            v = 0.0
    if k == TypeKind.DECIMAL:
        from decimal import ROUND_HALF_UP, Decimal, InvalidOperation

        if isinstance(v, (str, Decimal)):
            # exact decimal path: MySQL rounds half AWAY from zero on the
            # decimal digits, which binary floats misrepresent (1.005)
            try:
                d = v if isinstance(v, Decimal) else Decimal(v.strip())
            except InvalidOperation:
                msg = f"Incorrect DECIMAL value: '{v}' for column '{col}'"
                if strict:
                    raise WriteError(msg)
                if warn is not None:
                    warn("Warning", 1366, msg)
                return 0
            scaled = d.scaleb(ftype.scale)
            q = int(scaled.to_integral_value(rounding=ROUND_HALF_UP))
            if warn is not None and scaled != q:
                warn("Note", 1265, f"Data truncated for column '{col}'")
            return q
        try:
            exact = float(v) * (10**ftype.scale)
        except (TypeError, ValueError):
            msg = f"Incorrect DECIMAL value: '{v}' for column '{col}'"
            if strict:
                raise WriteError(msg)
            if warn is not None:
                warn("Warning", 1366, msg)
            return 0
        q = int(round(exact))
        if warn is not None and abs(exact - q) > 1e-9:
            # fractional digits beyond the column scale were rounded away
            warn("Note", 1265, f"Data truncated for column '{col}'")
        return q
    if k == TypeKind.STRING:
        if isinstance(v, str):
            v = v.encode("utf-8")
        elif not isinstance(v, bytes):
            v = str(v).encode("utf-8")
        if ftype.length is not None and ftype.length >= 0 and not ftype.json:
            chars = v.decode("utf-8", "surrogateescape")
            if len(chars) > ftype.length:
                # VARCHAR(n) overflow: strict errors (MySQL 1406) unless only
                # trailing spaces overflow (truncated with a note even in
                # strict mode); non-strict truncates at a character boundary
                only_spaces = chars[ftype.length:].strip(" ") == ""
                if strict and not only_spaces:
                    raise WriteError(f"Data too long for column '{col}'")
                if warn is not None:
                    if only_spaces:
                        warn("Note", 1265, f"Data truncated for column '{col}'")
                    else:
                        warn("Warning", 1265, f"Data truncated for column '{col}'")
                v = chars[: ftype.length].encode("utf-8", "surrogateescape")
        if ftype.json:
            import json as _json

            try:
                v = _json.dumps(
                    _json.loads(v.decode("utf-8")), separators=(", ", ": "), ensure_ascii=False
                ).encode()
            except Exception:
                raise WriteError(f"Invalid JSON text: {v[:60]!r}")
        return v
    if k == TypeKind.DATE:
        if isinstance(v, (int, np.integer)):
            return int(v)
        return date_to_days(v if isinstance(v, str) else v)
    if k == TypeKind.DATETIME:
        if isinstance(v, (int, np.integer)):
            return int(v)
        try:
            return datetime_to_micros(v)
        except ValueError:
            return datetime_to_micros(str(v) + " 00:00:00")
    if k == TypeKind.FLOAT:
        return float(v)
    if k == TypeKind.UINT:
        v = int(v)
        return v - (1 << 64) if v >= 1 << 63 else v
    if k == TypeKind.DURATION and not isinstance(v, (int, np.integer)):
        from tidb_tpu_torch.types.datum import duration_to_micros

        return duration_to_micros(v)
    return int(v)


def index_entry(t: TableInfo, idx: IndexInfo, vals: list, handle: int) -> tuple[bytes, bytes]:
    """Encode one index KV pair. Unique: key has no handle suffix, value
    carries the handle; non-unique: handle in key. NULL-containing unique
    entries get the handle suffix too (MySQL: NULLs don't conflict)."""
    enc = bytearray()
    has_null = False
    for off in idx.column_offsets:
        v = vals[off]
        ft = t.columns[off].ftype
        if v is None:
            has_null = True
            enc += codec.encode_key_nil()
        elif ft.kind == TypeKind.STRING:
            enc += codec.encode_key_bytes(v if isinstance(v, bytes) else str(v).encode())
        elif ft.kind == TypeKind.FLOAT:
            enc += codec.encode_key_float(float(v))
        else:
            enc += codec.encode_key_int(int(v))
    if idx.unique and not has_null:
        return tablecodec.index_key(t.id, idx.id, bytes(enc)), codec.encode_int_raw(handle)
    return tablecodec.index_key(t.id, idx.id, bytes(enc), handle), b"0"


# -- foreign keys (ref: planner/core/foreign_key.go:78 FK check/cascade plan
# nodes + the executor's FK check / FK cascade execs). Checks read through
# the txn membuffer, so same-statement and same-txn rows count. -------------
_FK_MAX_DEPTH = 15  # MySQL cascade depth limit


def _fk_on(session) -> bool:
    try:
        return bool(int(session.vars.get("foreign_key_checks", 1)))
    except (TypeError, ValueError):
        return True


def _encode_fk_key(t: TableInfo, offsets: list[int], key_vals: list) -> bytes:
    """Memcomparable encoding of (non-NULL) FK key values, matching
    index_entry's datum layout."""
    enc = bytearray()
    for off, v in zip(offsets, key_vals):
        ft = t.columns[off].ftype
        if ft.kind == TypeKind.STRING:
            enc += codec.encode_key_bytes(v if isinstance(v, bytes) else str(v).encode())
        elif ft.kind == TypeKind.FLOAT:
            enc += codec.encode_key_float(float(v))
        else:
            enc += codec.encode_key_int(int(v))
    return bytes(enc)


def _fk_resolve(session, fk):
    """(parent TableInfo, ref column offsets) or None when the parent is
    gone (dropped with checks off)."""
    parent = session.catalog.try_table(fk.ref_db, fk.ref_table)
    if parent is None:
        return None
    ref_offs = []
    for n in fk.ref_col_names:
        c = parent.column(n)
        if c is None:
            return None
        ref_offs.append(c.offset)
    return parent, ref_offs


def _fk_parent_exists(session, parent: TableInfo, ref_offs: list[int], key_vals: list) -> bool:
    if parent.pk_is_handle and ref_offs == [parent.pk_offset]:
        return _txn_read(session, tablecodec.record_key(parent.id, int(key_vals[0]))) is not None
    idx = next(
        (
            i
            for i in parent.indexes
            if i.state == "public" and (i.unique or i.primary) and list(i.column_offsets) == list(ref_offs)
        ),
        None,
    )
    if idx is None:  # parent index dropped with checks off: fail open
        return True
    ik = tablecodec.index_key(parent.id, idx.id, _encode_fk_key(parent, ref_offs, key_vals))
    return _txn_read(session, ik) is not None


def _fk_check_child(session, t: TableInfo, vals: list) -> None:
    """INSERT/UPDATE on a child: every non-NULL FK key needs a parent row."""
    if not t.foreign_keys or not _fk_on(session):
        return
    for fk in t.foreign_keys:
        key = [vals[o] for o in fk.col_offsets]
        if any(k is None for k in key):
            continue  # SQL: NULL keys are exempt from the check
        res = _fk_resolve(session, fk)
        if res is None:
            continue
        parent, ref_offs = res
        if not _fk_parent_exists(session, parent, ref_offs, key):
            raise WriteError(
                f"Cannot add or update a child row: a foreign key constraint fails ({fk.name})"
            )


def _fk_child_rows(session, ct: TableInfo, fk, key_vals: list) -> list:
    """[(handle, vals)] of child rows whose FK equals key_vals, read through
    the membuffer via the FK's supporting index (auto-created at DDL time)."""
    from tidb_tpu_torch.kv.kv import KeyRange
    from tidb_tpu_torch.planner.ranger import prefix_next

    txn = session.txn()
    schema = RowSchema(ct.storage_schema)
    if ct.pk_is_handle and fk.col_offsets == [ct.pk_offset]:
        h = int(key_vals[0])
        raw = _txn_read(session, tablecodec.record_key(ct.id, h))
        return [(h, decode_row(schema, raw))] if raw is not None else []
    idx = next(
        (
            i
            for i in ct.indexes
            if i.state == "public"
            and list(i.column_offsets[: len(fk.col_offsets)]) == list(fk.col_offsets)
        ),
        None,
    )
    out = []
    if idx is not None:
        prefix = tablecodec.index_key(ct.id, idx.id, _encode_fk_key(ct, fk.col_offsets, key_vals))
        for k, v in txn.scan(KeyRange(prefix, prefix_next(prefix))):
            # unique non-NULL entries carry the handle in an 8-byte value; a
            # longer key alone does NOT imply a key-tail handle — a unique
            # index extending the FK prefix appends more column datums instead
            if len(v) == 8:
                h = codec.decode_int_raw(v)
            else:  # non-unique / NULL-containing unique: handle rides the key tail
                h = codec.decode_int_raw(k[-8:])
            raw = _txn_read(session, tablecodec.record_key(ct.id, h))
            if raw is not None:
                out.append((h, decode_row(schema, raw)))
        return out
    # no usable index (dropped with checks off): full visible scan
    for k, v in txn.scan(tablecodec.record_range(ct.id)):
        _, h = tablecodec.decode_record_key(k)
        vals = decode_row(schema, v)
        if [vals[o] for o in fk.col_offsets] == list(key_vals):
            out.append((h, vals))
    return out


def _fk_on_parent_delete(session, t: TableInfo, vals: list, depth: int = 0) -> None:
    """DELETE of a (potential) parent row: RESTRICT / CASCADE / SET NULL
    over every referencing child (ref: FK cascade exec)."""
    if not _fk_on(session):
        return
    refs = session.catalog.referencing_fks_by_id(t.id)
    if not refs:
        return
    if depth >= _FK_MAX_DEPTH:
        raise WriteError("foreign key cascade depth exceeded")
    for ct, fk, parent in refs:
        ref_offs = [parent.column(n).offset for n in fk.ref_col_names]
        key = [vals[o] for o in ref_offs]
        if any(k is None for k in key):
            continue
        rows = _fk_child_rows(session, ct, fk, key)
        # a row referencing itself doesn't restrict its own delete
        rows = [(h, cv) for h, cv in rows if not (ct.id == t.id and cv == vals)]
        if not rows:
            continue
        if fk.on_delete in ("restrict", "no_action"):
            raise WriteError(
                f"Cannot delete or update a parent row: a foreign key constraint fails ({fk.name})"
            )
        for h, cvals in rows:
            if fk.on_delete == "cascade":
                _delete_row(session, ct, cvals, h, fk_depth=depth + 1)
            else:  # set_null
                nv = list(cvals)
                for o in fk.col_offsets:
                    nv[o] = None
                _fk_rewrite_child(session, ct, cvals, h, nv, depth + 1)


def _fk_on_parent_update(session, t: TableInfo, old_vals: list, new_vals: list, depth: int = 0) -> None:
    """Referenced key changed on an UPDATE: apply each child FK's ON UPDATE
    action. Runs AFTER the parent's new row is staged, so cascaded child
    rewrites pass their own child-side checks."""
    if not _fk_on(session):
        return
    refs = session.catalog.referencing_fks_by_id(t.id)
    if not refs:
        return
    if depth >= _FK_MAX_DEPTH:
        raise WriteError("foreign key cascade depth exceeded")
    for ct, fk, parent in refs:
        ref_offs = [parent.column(n).offset for n in fk.ref_col_names]
        okey = [old_vals[o] for o in ref_offs]
        nkey = [new_vals[o] for o in ref_offs]
        if okey == nkey or any(k is None for k in okey):
            continue
        rows = _fk_child_rows(session, ct, fk, okey)
        if not rows:
            continue
        if fk.on_update in ("restrict", "no_action"):
            raise WriteError(
                f"Cannot delete or update a parent row: a foreign key constraint fails ({fk.name})"
            )
        for h, cvals in rows:
            nv = list(cvals)
            for o, newv in zip(fk.col_offsets, nkey if fk.on_update == "cascade" else [None] * len(nkey)):
                nv[o] = newv
            _fk_rewrite_child(session, ct, cvals, h, nv, depth + 1)


def _fk_rewrite_child(session, ct: TableInfo, old_vals: list, handle: int, new_vals: list, depth: int) -> None:
    """In-place child row rewrite for cascaded SET NULL / UPDATE: stage the
    rewrite, then propagate to grandchildren (their cascades read the child's
    new key from the membuffer; a RESTRICT aborts the whole statement and the
    stage rolls back)."""
    _delete_row(session, ct, old_vals, handle, fk_depth=None)
    _write_row(session, ct, new_vals, handle)
    _fk_on_parent_update(session, ct, old_vals, new_vals, depth)


def _txn_read(session, key: bytes):
    """Read through the membuffer; in an explicit pessimistic txn the base
    snapshot is for_update_ts (current read), else start_ts. Constraint
    checks must see rows committed after txn start once the key is locked."""
    txn = session.txn()
    if txn.membuf.contains(key):
        return txn.membuf.get(key)
    if session._explicit and txn.pessimistic:
        return session.store.get_snapshot(txn.for_update_ts).get(key)
    return txn.get(key)


def _write_row(session, t: TableInfo, vals: list, handle: int, on_dup=None) -> int:
    """Stage one row + its index entries; returns rows affected. ``on_dup``
    is "replace" | "ignore" | ("update", assignments, db, alias) | None."""
    txn = session.txn()
    schema = RowSchema(t.storage_schema)
    rk = tablecodec.record_key(t.id, handle)
    session.lock_for_write([rk])  # pessimistic stmt-time lock (no-op otherwise)
    existing = _txn_read(session, rk)
    if existing is not None:
        if on_dup == "replace":
            _delete_row(session, t, decode_row(schema, existing), handle)
        elif on_dup == "ignore":
            return 0
        elif isinstance(on_dup, tuple) and on_dup[0] == "update":
            return _apply_on_dup_update(session, t, decode_row(schema, existing), handle, vals, on_dup)
        else:
            raise DupKeyError(f"PRIMARY ({handle})")
    # unique index conflict checks (delete-only indexes don't take writes,
    # so they can't conflict either — ref: F1 state semantics)
    for idx in t.indexes:
        if not idx.unique or idx.state == "delete_only":
            continue
        ik, _ = index_entry(t, idx, vals, handle)
        if any(vals[o] is None for o in idx.column_offsets):
            continue  # NULL never conflicts
        hit = _txn_read(session, ik)
        if hit is not None:
            if on_dup == "replace":
                old_handle = codec.decode_int_raw(hit)
                old_raw = _txn_read(session, tablecodec.record_key(t.id, old_handle))
                if old_raw is not None:
                    _delete_row(session, t, decode_row(schema, old_raw), old_handle)
            elif on_dup == "ignore":
                return 0
            elif isinstance(on_dup, tuple) and on_dup[0] == "update":
                old_handle = codec.decode_int_raw(hit)
                old_raw = _txn_read(session, tablecodec.record_key(t.id, old_handle))
                if old_raw is not None:
                    return _apply_on_dup_update(
                        session, t, decode_row(schema, old_raw), old_handle, vals, on_dup
                    )
            else:
                raise DupKeyError(idx.name)
    _fk_check_child(session, t, vals)
    txn.put(rk, encode_row(schema, vals))
    for idx in t.indexes:
        if idx.state == "delete_only":
            continue  # writes don't maintain delete-only indexes
        ik, iv = index_entry(t, idx, vals, handle)
        txn.put(ik, iv)
    return 1


def _delete_row(session, t: TableInfo, vals: list, handle: int, fk_depth: "int | None" = 0) -> None:
    """``fk_depth``: referential-action recursion depth; None = plain
    storage delete with no FK handling (update paths manage keys themselves)."""
    txn = session.txn()
    session.lock_for_write([tablecodec.record_key(t.id, handle)])
    txn.delete(tablecodec.record_key(t.id, handle))
    for idx in t.indexes:
        ik, _ = index_entry(t, idx, vals, handle)
        txn.delete(ik)
    if fk_depth is not None:
        _fk_on_parent_delete(session, t, vals, fk_depth)


def execute_insert(session, stmt: ast.Insert) -> int:
    db = stmt.table.db or session.current_db
    t = session.catalog.table(db, stmt.table.name)
    cols = t.columns
    if stmt.columns:
        name_to_off = {}
        for cn in stmt.columns:
            c = t.column(cn)
            if c is None:
                raise WriteError(f"Unknown column '{cn}'")
            name_to_off[cn.lower()] = c.offset
        targets = [name_to_off[c.lower()] for c in stmt.columns]
    else:
        targets = list(range(len(cols)))

    rows_values: list[list] = []
    if stmt.select is not None:
        rows = session._run_select_ast(stmt.select)
        for r in rows:
            rows_values.append(list(r))
    else:
        builder = Builder(session.catalog, db, subquery_runner=session._subquery_runner, warn=session.append_warning)
        for row in stmt.values:
            if len(row) != len(targets):
                raise WriteError("Column count doesn't match value count")
            vals = []
            for node in row:
                e = builder.resolve(node, BuildCtx([]))
                from tidb_tpu_torch.expression.expr import Constant

                if not isinstance(e, Constant):
                    raise WriteError("non-constant INSERT value")
                vals.append(e.value if e.ftype.kind != TypeKind.DATE or isinstance(e.value, (int, np.integer)) else e.value)
            rows_values.append(vals)

    affected = 0
    first_auto_id = None  # first generated AUTO_INCREMENT id this statement
    alias = stmt.table.alias or stmt.table.name
    if stmt.on_dup_update:
        on_dup = ("update", stmt.on_dup_update, db, alias)
    else:
        on_dup = "replace" if stmt.replace else ("ignore" if stmt.ignore else None)
    for vals in rows_values:
        full: list = [None] * len(cols)
        for off, v in zip(targets, vals):
            full[off] = (
                to_physical(v, cols[off].ftype, warn=_warn_of(session), strict=_strict(session), col=cols[off].name)
                if not isinstance(v, (bytes,)) or cols[off].ftype.kind == TypeKind.STRING
                else v
            )
        # defaults + auto increment
        handle = None
        for c in cols:
            if full[c.offset] is None and c.offset not in targets:
                if c.auto_increment:
                    nid = session.catalog.alloc_autoid(t.id)
                    full[c.offset] = nid
                    if first_auto_id is None:
                        first_auto_id = int(nid)
                elif c.default is not None and c.default != "CURRENT_TIMESTAMP":
                    full[c.offset] = to_physical(c.default, c.ftype)
                elif c.default == "CURRENT_TIMESTAMP":
                    import datetime

                    full[c.offset] = to_physical(datetime.datetime.now(), c.ftype)
                elif not c.ftype.nullable:
                    raise WriteError(f"Field '{c.name}' doesn't have a default value")
        if t.pk_is_handle:
            pkv = full[t.pk_offset]
            if pkv is None and cols[t.pk_offset].auto_increment:
                pkv = session.catalog.alloc_autoid(t.id)
                full[t.pk_offset] = pkv
                if first_auto_id is None:
                    first_auto_id = int(pkv)
            if pkv is None:
                raise WriteError("primary key cannot be NULL")
            handle = int(pkv)
            if cols[t.pk_offset].auto_increment:
                session.catalog.rebase_autoid(t.id, handle + 1)
        else:
            handle = session.catalog.alloc_autoid(t.id)
        # partitioned tables: route the row to its partition's physical id
        # (ref: table/tables partitionedTable.AddRecord locating the
        # partition before the write)
        wt = t.partition_view(t.partition_id_for(full)) if t.partition is not None else t
        affected += _write_row(session, wt, full, handle, on_dup)
    # OK-packet id is statement-local (0 when nothing was generated);
    # LAST_INSERT_ID() stays sticky across non-generating statements
    # (ref: session vars LastInsertID vs mysql_insert_id())
    session._stmt_insert_id = first_auto_id or 0
    if first_auto_id is not None:
        session.last_insert_id = first_auto_id
    return affected


def _apply_on_dup_update(session, t: TableInfo, old_vals: list, handle: int, cand_vals: list, on_dup: tuple) -> int:
    """ON DUPLICATE KEY UPDATE against the conflicting row (ref:
    executor/insert.go onDuplicateUpdate): assignments see the existing row;
    VALUES(col) reads the would-be inserted value. Affected rows follow
    MySQL: 2 when the row changes, 0 when it is set to its current values."""
    _, assignments, db, alias = on_dup
    from tidb_tpu_torch.planner.pointget import _to_logical

    def subst_values(node):
        # VALUES(col) → literal of the candidate row's value
        if isinstance(node, ast.FuncCall) and node.name == "values" and node.args:
            arg = node.args[0]
            if isinstance(arg, ast.ColumnName):
                c = t.column(arg.name)
                if c is None:
                    raise WriteError(f"Unknown column '{arg.name}' in VALUES()")
                return ast.Literal(_to_logical(cand_vals[c.offset], c.ftype))
        import dataclasses

        if dataclasses.is_dataclass(node) and isinstance(node, ast.Node):
            return type(node)(
                **{
                    f.name: (
                        subst_values(v)
                        if isinstance(v := getattr(node, f.name), ast.Node)
                        else ([subst_values(x) if isinstance(x, ast.Node) else x for x in v] if isinstance(v, list) else v)
                    )
                    for f in dataclasses.fields(node)
                }
            )
        return node

    chunk = _rows_to_chunk(session, t, [old_vals])
    builder = Builder(session.catalog, db, subquery_runner=session._subquery_runner, warn=session.append_warning)
    schema = [OutCol(c.name, c.ftype, table=alias, slot=c.offset) for c in t.columns]
    batch = EvalBatch.from_chunk(chunk, warn=_warn_of(session))
    new_vals = list(old_vals)
    for colname, expr_ast in assignments:
        cname = colname if isinstance(colname, str) else colname.name
        c = t.column(cname)
        if c is None:
            raise WriteError(f"Unknown column '{cname}'")
        e = builder.resolve(subst_values(expr_ast), BuildCtx(schema))
        out = eval_to_column(e, batch, np)
        new_vals[c.offset] = to_physical(
            out.logical_value(0), c.ftype, warn=_warn_of(session), strict=_strict(session), col=c.name
        )
    if new_vals == old_vals:
        return 0
    new_handle = handle
    if t.pk_is_handle and new_vals[t.pk_offset] != old_vals[t.pk_offset]:
        new_handle = int(new_vals[t.pk_offset])
    _delete_row(session, t, old_vals, handle, fk_depth=None)
    _write_row(session, t, new_vals, new_handle)
    _fk_on_parent_update(session, t, old_vals, new_vals)
    return 2


def _scan_visible_rows(session, t: TableInfo):
    """All rows visible to the txn (membuffer overlaid) → (handles, rows,
    row_tables). The base snapshot follows session.read_ts() so FOR UPDATE
    current reads apply inside dirty transactions too. ``row_tables[i]`` is
    the physical table (partition view) each row lives in."""
    txn = session.txn()
    schema = RowSchema(t.storage_schema)
    handles, rows, row_tables = [], [], []
    for view in t.partition_views():
        for k, v in txn.scan(tablecodec.record_range(view.id), read_ts=session.read_ts()):
            handles.append(tablecodec.decode_record_key(k)[1])
            rows.append(decode_row(schema, v))
            row_tables.append(view)
    return handles, rows, row_tables


def _rows_to_chunk(session, t: TableInfo, rows: list[list]) -> Chunk:
    from tidb_tpu_torch.copr.colcache import cache_for

    cache = cache_for(session.store)
    cols = []
    n = len(rows)
    for c in t.columns:
        k = c.ftype.kind
        if k == TypeKind.STRING:
            dic = cache.dictionary(t.id, c.offset)
            data = np.zeros(n, np.int32)
            valid = np.ones(n, bool)
            for i, r in enumerate(rows):
                if r[c.offset] is None:
                    valid[i] = False
                else:
                    data[i] = dic.encode(r[c.offset])
            cols.append(Column(data, valid, c.ftype, dic))
        else:
            dt = np.float64 if k == TypeKind.FLOAT else np.int64
            data = np.zeros(n, dt)
            valid = np.ones(n, bool)
            for i, r in enumerate(rows):
                if r[c.offset] is None:
                    valid[i] = False
                else:
                    data[i] = r[c.offset]
            cols.append(Column(data, valid, c.ftype, None))
    return Chunk(cols)


def _where_mask(session, t: TableInfo, chunk: Chunk, where, db: str, alias: str) -> np.ndarray:
    if where is None:
        return np.ones(len(chunk), dtype=bool)
    builder = Builder(session.catalog, db, subquery_runner=session._subquery_runner, warn=session.append_warning)
    schema = [OutCol(c.name, c.ftype, table=alias, slot=c.offset) for c in t.columns]
    cond = builder.resolve(where, BuildCtx(schema))
    col = eval_to_column(cond, EvalBatch.from_chunk(chunk, warn=_warn_of(session)), np)
    return (col.data != 0) & col.validity


def _pessimistic_current_read(session, t: TableInfo, handles, rows, chunk, idxs, where, db, alias, row_tables=None):
    """Lock the matched rows, then re-read them at for_update_ts and re-apply
    the WHERE filter — the "current read" that makes pessimistic UPDATE/DELETE
    see the latest committed values instead of the start_ts snapshot
    (ref: sessiontxn/isolation pessimistic provider's for-update read).
    Returns (idxs, rows, chunk), possibly updated in place."""
    txn = session._txn
    if not (session._explicit and txn is not None and txn.pessimistic) or len(idxs) == 0:
        return idxs, rows, chunk
    def _tid(i) -> int:
        return row_tables[int(i)].id if row_tables is not None else t.id

    keys = [tablecodec.record_key(_tid(i), handles[int(i)]) for i in idxs]
    session.lock_for_write(keys)
    snap = session.store.get_snapshot(txn.for_update_ts)
    schema = RowSchema(t.storage_schema)
    changed = False
    live = []
    for i in idxs:
        rk = tablecodec.record_key(_tid(i), handles[int(i)])
        if txn.membuf.contains(rk):
            raw = txn.membuf.get(rk)
        else:
            raw = snap.get(rk)
        if raw is None:  # deleted underneath us after the lock
            changed = True
            continue
        fresh = decode_row(schema, raw)
        if fresh != rows[int(i)]:
            rows[int(i)] = fresh
            changed = True
        live.append(i)
    idxs = np.asarray(live, dtype=np.int64)
    if changed:
        chunk = _rows_to_chunk(session, t, rows)
        mask = _where_mask(session, t, chunk, where, db, alias)
        idxs = np.asarray([i for i in idxs if mask[int(i)]], dtype=np.int64)
    return idxs, rows, chunk


def execute_update(session, stmt: ast.Update) -> int:
    db = stmt.table.db or session.current_db
    t = session.catalog.table(db, stmt.table.name)
    alias = stmt.table.alias or stmt.table.name
    handles, rows, row_tables = _scan_visible_rows(session, t)
    if not rows:
        return 0
    chunk = _rows_to_chunk(session, t, rows)
    mask = _where_mask(session, t, chunk, stmt.where, db, alias)
    idxs = np.nonzero(mask)[0]
    if stmt.order_by:
        from tidb_tpu_torch.copr.host_engine import sort_perm

        builder = Builder(session.catalog, db, subquery_runner=session._subquery_runner, warn=session.append_warning)
        schema = [OutCol(c.name, c.ftype, table=alias, slot=c.offset) for c in t.columns]
        by = [[builder.resolve(oi.expr, BuildCtx(schema)).to_pb(), oi.desc] for oi in stmt.order_by]
        sub = chunk.take(idxs)
        idxs = idxs[sort_perm(sub, by)]
    if stmt.limit is not None:
        idxs = idxs[: stmt.limit]
    idxs, rows, chunk = _pessimistic_current_read(
        session, t, handles, rows, chunk, idxs, stmt.where, db, alias, row_tables
    )

    # evaluate assignment expressions over the full chunk (row values)
    builder = Builder(session.catalog, db, subquery_runner=session._subquery_runner, warn=session.append_warning)
    schema = [OutCol(c.name, c.ftype, table=alias, slot=c.offset) for c in t.columns]
    batch = EvalBatch.from_chunk(chunk, warn=_warn_of(session))
    new_cols = {}
    for colname, expr_ast in stmt.assignments:
        c = t.column(colname.name)
        if c is None:
            raise WriteError(f"Unknown column '{colname.name}'")
        e = builder.resolve(expr_ast, BuildCtx(schema))
        out = eval_to_column(e, batch, np)
        new_cols[c.offset] = out

    affected = 0
    rowschema = RowSchema(t.storage_schema)
    for i in idxs:
        old_vals = rows[i]
        new_vals = list(old_vals)
        for off, out in new_cols.items():
            lv = out.logical_value(int(i))
            new_vals[off] = to_physical(
                lv, t.columns[off].ftype, warn=_warn_of(session), strict=_strict(session), col=t.columns[off].name
            )
        if new_vals == old_vals:
            continue
        handle = handles[i]
        new_handle = handle
        if t.pk_is_handle and new_vals[t.pk_offset] != old_vals[t.pk_offset]:
            new_handle = int(new_vals[t.pk_offset])
        old_t = row_tables[i]
        new_t = t.partition_view(t.partition_id_for(new_vals)) if t.partition is not None else t
        _delete_row(session, old_t, old_vals, handle, fk_depth=None)
        _write_row(session, new_t, new_vals, new_handle)
        _fk_on_parent_update(session, t, old_vals, new_vals)
        affected += 1
    return affected


def execute_delete(session, stmt: ast.Delete) -> int:
    db = stmt.table.db or session.current_db
    t = session.catalog.table(db, stmt.table.name)
    alias = stmt.table.alias or stmt.table.name
    handles, rows, row_tables = _scan_visible_rows(session, t)
    if not rows:
        return 0
    chunk = _rows_to_chunk(session, t, rows)
    mask = _where_mask(session, t, chunk, stmt.where, db, alias)
    idxs = np.nonzero(mask)[0]
    if stmt.order_by:
        from tidb_tpu_torch.copr.host_engine import sort_perm

        builder = Builder(session.catalog, db, subquery_runner=session._subquery_runner, warn=session.append_warning)
        schema = [OutCol(c.name, c.ftype, table=alias, slot=c.offset) for c in t.columns]
        by = [[builder.resolve(oi.expr, BuildCtx(schema)).to_pb(), oi.desc] for oi in stmt.order_by]
        sub = chunk.take(idxs)
        idxs = idxs[sort_perm(sub, by)]
    if stmt.limit is not None:
        idxs = idxs[: stmt.limit]
    idxs, rows, chunk = _pessimistic_current_read(
        session, t, handles, rows, chunk, idxs, stmt.where, db, alias, row_tables
    )
    for i in idxs:
        _delete_row(session, row_tables[int(i)], rows[int(i)], handles[int(i)])
    return int(len(idxs))
