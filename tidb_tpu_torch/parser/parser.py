"""Recursive-descent SQL parser (ref: pkg/parser/parser.y, hand-rolled).

Precedence (low→high), mirroring MySQL:
OR/|| → XOR → AND/&& → NOT → comparison (=, <>, <, <=, >, >=, IS, IN,
BETWEEN, LIKE) → | → & → << >> → + - → * / DIV MOD % → unary -+!~ → primary.
"""

from __future__ import annotations

from typing import Optional

from tidb_tpu_torch.parser import ast
from tidb_tpu_torch.parser.lexer import Token, tokenize


class ParseError(Exception):
    def __init__(self, msg: str, tok: Token):
        super().__init__(f"{msg} near {tok.value!r} (offset {tok.pos})")
        self.tok = tok


RESERVED = frozenset(
    """SELECT INSERT UPDATE DELETE REPLACE FROM WHERE GROUP HAVING ORDER LIMIT
    OFFSET BY AND OR XOR NOT AS ON JOIN LEFT RIGHT INNER CROSS OUTER UNION SET
    INTO VALUES CREATE DROP ALTER TABLE INDEX DATABASE USE SHOW EXPLAIN BETWEEN
    LIKE IN IS NULL CASE WHEN THEN ELSE END CAST DISTINCT ASC DESC PRIMARY KEY
    UNIQUE DEFAULT EXISTS COMMIT ROLLBACK BEGIN TRUNCATE ANALYZE""".split()
)


class Parser:
    def __init__(self, sql: str):
        self.sql = sql
        self.toks = tokenize(sql)
        self.i = 0
        self.param_count = 0  # `?` markers seen so far (prepared statements)

    # -- token helpers ------------------------------------------------------
    def peek(self, ahead: int = 0) -> Token:
        return self.toks[min(self.i + ahead, len(self.toks) - 1)]

    def next(self) -> Token:
        t = self.toks[self.i]
        if t.kind != "eof":
            self.i += 1
        return t

    def at_kw(self, *kws: str) -> bool:
        t = self.peek()
        return t.kind == "ident" and t.value.upper() in kws

    def eat_kw(self, *kws: str) -> bool:
        if self.at_kw(*kws):
            self.next()
            return True
        return False

    def expect_kw(self, kw: str) -> None:
        if not self.eat_kw(kw):
            raise ParseError(f"expected {kw}", self.peek())

    def at_op(self, *ops: str) -> bool:
        t = self.peek()
        return t.kind == "op" and t.value in ops

    def eat_op(self, *ops: str) -> bool:
        if self.at_op(*ops):
            self.next()
            return True
        return False

    def expect_op(self, op: str) -> None:
        if not self.eat_op(op):
            raise ParseError(f"expected {op!r}", self.peek())

    def ident(self) -> str:
        t = self.peek()
        if t.kind in ("ident", "qident"):
            self.next()
            return t.value
        raise ParseError("expected identifier", t)

    # -- entry --------------------------------------------------------------
    def parse_statement(self) -> ast.Node:
        t = self.peek()
        if t.kind == "op" and t.value == "(":
            return self.parse_select_stmt()
        if t.kind != "ident":
            raise ParseError("expected statement", t)
        kw = t.value.upper()
        fn = {
            "SELECT": self.parse_select_stmt,
            "WITH": self.parse_select_stmt,
            "INSERT": self.parse_insert,
            "REPLACE": self.parse_insert,
            "UPDATE": self.parse_update,
            "DELETE": self.parse_delete,
            "CREATE": self.parse_create,
            "DROP": self.parse_drop,
            "ALTER": self.parse_alter,
            "TRUNCATE": self.parse_truncate,
            "EXPLAIN": self.parse_explain,
            "DESC": self.parse_explain,
            "DESCRIBE": self.parse_explain,
            "RENAME": self.parse_rename,
            "DO": self.parse_do,
            "CHECKSUM": self.parse_checksum,
            "TABLE": self.parse_table_stmt,
            "SET": self.parse_set,
            "SHOW": self.parse_show,
            "USE": self.parse_use,
            "BEGIN": self.parse_begin,
            "START": self.parse_begin,
            "COMMIT": lambda: (self.next(), ast.Commit())[1],
            "ROLLBACK": lambda: (self.next(), ast.Rollback())[1],
            "ANALYZE": self.parse_analyze,
            "LOAD": self.parse_load_data,
            "PREPARE": self.parse_prepare,
            "EXECUTE": self.parse_execute_stmt,
            "DEALLOCATE": self.parse_deallocate,
            "IMPORT": self.parse_import,
            "BACKUP": self.parse_backup,
            "RESTORE": self.parse_restore,
            "KILL": self.parse_kill,
            "GRANT": self.parse_grant,
            "REVOKE": self.parse_grant,
            "TRACE": lambda: (self.next(), ast.Trace(self.parse_statement()))[1],
            "ADMIN": self.parse_admin,
            "RECOVER": self.parse_recover,
            "FLASHBACK": self.parse_recover,
            "PLAN": self.parse_plan_replayer,
        }.get(kw)
        if fn is None:
            raise ParseError("unsupported statement", t)
        return fn()

    # -- SELECT --------------------------------------------------------------
    def parse_select_stmt(self) -> ast.Node:
        """SELECT optionally chained with UNION/INTERSECT/EXCEPT (ref:
        ast.SetOprStmt; INTERSECT binds tighter per MySQL 8). A trailing
        ORDER BY/LIMIT binds to the whole compound."""
        if self.at_kw("WITH"):
            return self.parse_with()
        node, paren = self._setop_operand()
        # whether the top node came from explicit parentheses (an explicitly
        # grouped SetOp must not be re-associated by INTERSECT precedence)
        node_paren = paren
        last, last_paren = node, paren
        while self.at_kw("UNION", "EXCEPT", "INTERSECT"):
            if (
                not last_paren
                and isinstance(last, ast.Select)
                and (last.order_by or last.limit is not None)
            ):
                raise ParseError(
                    "ORDER BY/LIMIT in a non-final set operand needs parentheses", self.peek()
                )
            op = self.next().value.lower()
            all_ = self.eat_kw("ALL")
            if not all_:
                self.eat_kw("DISTINCT")
            last, last_paren = self._setop_operand()
            if (
                op == "intersect"
                and isinstance(node, ast.SetOp)
                and node.op != "intersect"
                and not node_paren
            ):
                node.right = ast.SetOp(node.right, last, op, all=all_)
            else:
                node = ast.SetOp(node, last, op, all=all_)
                node_paren = False
        if not isinstance(node, ast.SetOp):
            if paren and (self.at_kw("ORDER") or self.at_kw("LIMIT")):
                # (SELECT ... LIMIT 10) ORDER BY/LIMIT — the outer clauses
                # apply to the derived result, after the inner ones
                outer = ast.Select(
                    items=[ast.SelectItem(ast.Wildcard())],
                    from_=ast.SubquerySource(node, "__paren__"),
                )
                if self.at_kw("ORDER"):
                    self.next()
                    self.expect_kw("BY")
                    outer.order_by = self.parse_order_items()
                self._parse_limit(outer)
                return outer
            return node
        if not last_paren and isinstance(last, ast.Select):
            # parse_select consumed the trailing ORDER BY/LIMIT — it belongs
            # to the compound statement
            node.order_by, last.order_by = last.order_by, []
            node.limit, node.offset, last.limit, last.offset = last.limit, last.offset, None, 0
        if self.at_kw("ORDER"):
            self.next()
            self.expect_kw("BY")
            node.order_by = self.parse_order_items()
        self._parse_limit(node)
        return node

    def _parse_limit(self, node) -> None:
        """LIMIT n | LIMIT off, n | LIMIT n OFFSET off — sets node.limit/offset."""
        if not self.eat_kw("LIMIT"):
            return
        a = self._limit_value()
        if self.eat_op(","):
            node.offset = a
            node.limit = self._limit_value()
        else:
            node.limit = a
            if self.eat_kw("OFFSET"):
                node.offset = self._limit_value()

    def _limit_value(self) -> int:
        """MySQL's u64 LIMIT/OFFSET literals (18446744073709551615 = "no
        limit") clamp to int64 max HERE, at the parse boundary — a user
        literal must never reach a jitted computation unclamped (ref:
        ast/misc.go Limit uint64)."""
        return min(int(self.next().value), 2**63 - 1)

    def _paren_select_ahead(self) -> bool:
        """True when the upcoming '('... run of parens wraps a SELECT/WITH (as
        opposed to a parenthesized join or scalar expression)."""
        j = 0
        while self.peek(j).kind == "op" and self.peek(j).value == "(":
            j += 1
        t = self.peek(j)
        return j > 0 and t.kind == "ident" and t.value.upper() in ("SELECT", "WITH")

    def parse_with(self) -> ast.Node:
        """WITH [RECURSIVE] name [(col, ...)] AS (query), ... SELECT ...
        (ref: parser.y WithClause → ast.CommonTableExpression list)."""
        self.expect_kw("WITH")
        recursive = self.eat_kw("RECURSIVE")
        ctes: list[ast.CTEDef] = []
        while True:
            name = self.ident()
            cols: list[str] = []
            if self.at_op("("):
                self.next()
                cols.append(self.ident())
                while self.eat_op(","):
                    cols.append(self.ident())
                self.expect_op(")")
            self.expect_kw("AS")
            self.expect_op("(")
            q = self.parse_select_stmt()
            self.expect_op(")")
            ctes.append(ast.CTEDef(name.lower(), [c.lower() for c in cols], q, recursive))
            if not self.eat_op(","):
                break
        stmt = self.parse_select_stmt()
        stmt.ctes = ctes + list(getattr(stmt, "ctes", []))
        return stmt

    def _setop_operand(self) -> tuple:
        if self._paren_select_ahead():
            self.next()
            inner = self.parse_select_stmt()
            self.expect_op(")")
            return inner, True
        return self.parse_select(), False

    def parse_select(self) -> ast.Select:
        self.expect_kw("SELECT")
        hints = []
        if self.peek().kind == "hint":
            hints = _parse_hints(self.next().value)
        distinct = self.eat_kw("DISTINCT")
        self.eat_kw("ALL")
        items = [self.parse_select_item()]
        while self.eat_op(","):
            items.append(self.parse_select_item())
        sel = ast.Select(items=items, distinct=distinct, hints=hints)
        if self.eat_kw("FROM"):
            sel.from_ = self.parse_table_refs()
        if self.eat_kw("WHERE"):
            sel.where = self.parse_expr()
        if self.at_kw("GROUP"):
            self.next()
            self.expect_kw("BY")
            sel.group_by.append(self.parse_expr())
            while self.eat_op(","):
                sel.group_by.append(self.parse_expr())
            if self.at_kw("WITH"):
                self.next()
                self.expect_kw("ROLLUP")
                sel.rollup = True
        if self.eat_kw("HAVING"):
            sel.having = self.parse_expr()
        if self.at_kw("ORDER"):
            self.next()
            self.expect_kw("BY")
            sel.order_by = self.parse_order_items()
        self._parse_limit(sel)
        if self.eat_kw("FOR"):
            self.expect_kw("UPDATE")
            sel.for_update = True
        return sel

    def parse_select_item(self) -> ast.SelectItem:
        if self.at_op("*"):
            self.next()
            return ast.SelectItem(ast.Wildcard())
        # t.* lookahead
        if self.peek().kind in ("ident", "qident") and self.peek(1).kind == "op" and self.peek(1).value == "." and self.peek(2).value == "*":
            tbl = self.ident()
            self.next()
            self.next()
            return ast.SelectItem(ast.Wildcard(table=tbl))
        e = self.parse_expr()
        alias = ""
        if self.eat_kw("AS"):
            alias = self.ident()
        elif self.peek().kind in ("ident", "qident") and not self.at_kw(
            "FROM", "WHERE", "GROUP", "HAVING", "ORDER", "LIMIT", "UNION", "INTERSECT", "EXCEPT", "INTO", "JOIN", "ON",
            "LEFT", "RIGHT", "INNER", "CROSS", "AS", "SET",
        ):
            alias = self.ident()
        return ast.SelectItem(e, alias)

    def parse_order_items(self) -> list[ast.OrderItem]:
        out = [self._order_item()]
        while self.eat_op(","):
            out.append(self._order_item())
        return out

    def _order_item(self) -> ast.OrderItem:
        e = self.parse_expr()
        desc = False
        if self.eat_kw("DESC"):
            desc = True
        else:
            self.eat_kw("ASC")
        return ast.OrderItem(e, desc)

    def parse_table_refs(self) -> ast.Node:
        left = self.parse_table_factor()
        while True:
            if self.eat_op(","):
                right = self.parse_table_factor()
                left = ast.Join(left, right, kind="cross")
            elif self.at_kw("JOIN", "INNER", "LEFT", "RIGHT", "CROSS"):
                kind = "inner"
                if self.eat_kw("LEFT"):
                    kind = "left"
                    self.eat_kw("OUTER")
                elif self.eat_kw("RIGHT"):
                    kind = "right"
                    self.eat_kw("OUTER")
                elif self.eat_kw("CROSS"):
                    kind = "cross"
                else:
                    self.eat_kw("INNER")
                self.expect_kw("JOIN")
                right = self.parse_table_factor()
                on = None
                if self.eat_kw("ON"):
                    on = self.parse_expr()
                left = ast.Join(left, right, kind=kind, on=on)
            else:
                return left

    def parse_table_factor(self) -> ast.Node:
        if self.at_op("("):
            # subquery or parenthesized join
            if self._paren_select_ahead():
                self.next()
                sel = self.parse_select_stmt()
                self.expect_op(")")
                alias = ""
                self.eat_kw("AS")
                if self.peek().kind in ("ident", "qident"):
                    alias = self.ident()
                return ast.SubquerySource(sel, alias)
            self.next()
            inner = self.parse_table_refs()
            self.expect_op(")")
            return inner
        name = self.ident()
        db = ""
        if self.eat_op("."):
            db, name = name, self.ident()
        partitions = None
        if self.at_kw("PARTITION") and self.peek(1).kind == "op" and self.peek(1).value == "(":
            # t PARTITION (p0, p1) — explicit partition selection
            self.next()
            self.expect_op("(")
            partitions = [self.ident().lower()]
            while self.eat_op(","):
                partitions.append(self.ident().lower())
            self.expect_op(")")
        as_of = None
        alias = ""
        if self.at_kw("AS") and self.peek(1).value.upper() == "OF":
            # stale read: t AS OF TIMESTAMP expr (ref: ast.TableName.AsOf)
            self.next()
            self.next()
            self.expect_kw("TIMESTAMP")
            as_of = self.parse_expr()
        if self.eat_kw("AS"):
            alias = self.ident()
        elif self.peek().kind in ("ident", "qident") and not self.at_kw(
            "WHERE", "GROUP", "HAVING", "ORDER", "LIMIT", "JOIN", "ON", "LEFT", "RIGHT",
            "INNER", "CROSS", "SET", "UNION", "INTERSECT", "EXCEPT", "USING", "FOR",
            "USE", "IGNORE", "FORCE",  # index hints, reserved in MySQL
        ):
            alias = self.ident()
        hints = None
        while self.at_kw("USE", "IGNORE", "FORCE") and self.peek(1).value.upper() in ("INDEX", "KEY"):
            kind = self.next().value.lower()
            self.next()  # INDEX | KEY
            if self.eat_kw("FOR"):
                # FOR JOIN | FOR ORDER BY | FOR GROUP BY — scope qualifiers
                # are accepted and applied globally (single-scan planner)
                if not self.eat_kw("JOIN"):
                    self.next()
                    self.expect_kw("BY")
            self.expect_op("(")
            names = []
            if not self.at_op(")"):
                names.append("primary" if self.eat_kw("PRIMARY") else self.ident().lower())
                while self.eat_op(","):
                    names.append("primary" if self.eat_kw("PRIMARY") else self.ident().lower())
            self.expect_op(")")
            hints = (hints or []) + [(kind, names)]
        return ast.TableRef(name, db=db, alias=alias, as_of=as_of, index_hints=hints, partitions=partitions)

    # -- expressions ---------------------------------------------------------
    def parse_expr(self) -> ast.Node:
        return self._or_expr()

    def _or_expr(self) -> ast.Node:
        left = self._xor_expr()
        while self.at_kw("OR") or self.at_op("||"):
            self.next()
            left = ast.BinaryOp("or", left, self._xor_expr())
        return left

    def _xor_expr(self) -> ast.Node:
        left = self._and_expr()
        while self.at_kw("XOR"):
            self.next()
            left = ast.BinaryOp("xor", left, self._and_expr())
        return left

    def _and_expr(self) -> ast.Node:
        left = self._not_expr()
        while self.at_kw("AND") or self.at_op("&&"):
            self.next()
            left = ast.BinaryOp("and", left, self._not_expr())
        return left

    def _not_expr(self) -> ast.Node:
        if self.at_kw("NOT") or self.at_op("!"):
            self.next()
            return ast.UnaryOp("not", self._not_expr())
        return self._comparison()

    _CMP = {"=": "eq", "<=>": "nulleq", "<>": "ne", "!=": "ne", "<": "lt", "<=": "le", ">": "gt", ">=": "ge"}

    def _comparison(self) -> ast.Node:
        left = self._bitor()
        while True:
            t = self.peek()
            if t.kind == "op" and t.value in self._CMP:
                self.next()
                if self.at_kw("ANY", "SOME", "ALL"):
                    left = self._quantified_cmp(self._CMP[t.value], left)
                    continue
                left = ast.BinaryOp(self._CMP[t.value], left, self._bitor())
                continue
            if self.at_kw("IS"):
                self.next()
                neg = self.eat_kw("NOT")
                if self.at_kw("TRUE", "FALSE", "UNKNOWN"):
                    kind = self.next().value.upper()
                    # IS TRUE ⇔ IFNULL(x,0) <> 0; IS FALSE ⇔ IFNULL(x,1) = 0;
                    # IS UNKNOWN ⇔ IS NULL (ref: builtin_op.go isTrue/isFalse)
                    if kind == "UNKNOWN":
                        e: ast.Node = ast.IsNull(left)
                    elif kind == "TRUE":
                        e = ast.BinaryOp("ne", ast.FuncCall("ifnull", [left, ast.Literal(0)]), ast.Literal(0))
                    else:
                        e = ast.BinaryOp("eq", ast.FuncCall("ifnull", [left, ast.Literal(1)]), ast.Literal(0))
                    left = ast.UnaryOp("not", e) if neg else e
                    continue
                self.expect_kw("NULL")
                left = ast.IsNull(left, negated=neg)
                continue
            neg = False
            save = self.i
            if self.at_kw("NOT"):
                self.next()
                neg = True
            if self.at_kw("IN"):
                self.next()
                self.expect_op("(")
                if self.at_kw("SELECT", "WITH"):
                    sel = self.parse_select_stmt()
                    self.expect_op(")")
                    left = ast.InList(left, [ast.SubqueryExpr(sel, "in")], negated=neg)
                else:
                    items = [self.parse_expr()]
                    while self.eat_op(","):
                        items.append(self.parse_expr())
                    self.expect_op(")")
                    left = ast.InList(left, items, negated=neg)
                continue
            if self.at_kw("BETWEEN"):
                self.next()
                lo = self._bitor()
                self.expect_kw("AND")
                hi = self._bitor()
                left = ast.Between(left, lo, hi, negated=neg)
                continue
            if self.at_kw("LIKE"):
                self.next()
                left = ast.Like(left, self._bitor(), negated=neg)
                continue
            if self.at_kw("REGEXP", "RLIKE"):
                self.next()
                left = ast.Like(left, self._bitor(), negated=neg, regexp=True)
                continue
            if neg:
                self.i = save
            return left

    def _quantified_cmp(self, op: str, left: ast.Node) -> ast.Node:
        """`expr OP ANY|SOME|ALL (subquery)` → QuantifiedCmp, lowered by the
        planner per context (ref: expression_rewriter.go quantified
        comparison handling)."""
        is_all = self.at_kw("ALL")
        self.next()
        self.expect_op("(")
        sel = self.parse_select_stmt()
        self.expect_op(")")
        if len(sel.items) != 1 or isinstance(sel.items[0].expr, ast.Wildcard):
            raise ParseError("quantified subquery must select exactly one column", self.peek())
        return ast.QuantifiedCmp(op, left, sel, is_all)

    def _bitor(self) -> ast.Node:
        left = self._bitand()
        while self.at_op("|"):
            self.next()
            left = ast.BinaryOp("bitor", left, self._bitand())
        return left

    def _bitand(self) -> ast.Node:
        left = self._shift()
        while self.at_op("&"):
            self.next()
            left = ast.BinaryOp("bitand", left, self._shift())
        return left

    def _shift(self) -> ast.Node:
        left = self._additive()
        while self.at_op("<<", ">>"):
            op = "shl" if self.next().value == "<<" else "shr"
            left = ast.BinaryOp(op, left, self._additive())
        return left

    def _additive(self) -> ast.Node:
        left = self._multiplicative()
        while self.at_op("+", "-"):
            op = "plus" if self.next().value == "+" else "minus"
            left = ast.BinaryOp(op, left, self._multiplicative())
        return left

    def _multiplicative(self) -> ast.Node:
        left = self._bitxor()
        while True:
            if self.at_op("*"):
                self.next()
                left = ast.BinaryOp("mul", left, self._bitxor())
            elif self.at_op("/"):
                self.next()
                left = ast.BinaryOp("div", left, self._bitxor())
            elif self.at_op("%") or self.at_kw("MOD"):
                self.next()
                left = ast.BinaryOp("mod", left, self._bitxor())
            elif self.at_kw("DIV"):
                self.next()
                left = ast.BinaryOp("intdiv", left, self._bitxor())
            else:
                return left

    def _bitxor(self) -> ast.Node:
        # MySQL: ^ binds tighter than * (and looser than unary)
        left = self._unary()
        while self.at_op("^"):
            self.next()
            left = ast.BinaryOp("bitxor", left, self._unary())
        return left

    def _postfix_json(self, e: ast.Node) -> ast.Node:
        """col -> '$.path' and col ->> '$.path' (ref: JSON column paths)."""
        while self.at_op("->") or self.at_op("->>"):
            unquote = self.peek().value == "->>"
            self.next()
            t = self.next()
            if t.kind != "str":
                raise ParseError("expected JSON path string", t)
            path = ast.Literal(t.value)
            e = ast.FuncCall("json_extract", [e, path])
            if unquote:
                e = ast.FuncCall("json_unquote", [e])
        return e

    def _unary(self) -> ast.Node:
        if self.at_op("-"):
            self.next()
            return ast.UnaryOp("unaryminus", self._unary())
        if self.at_op("+"):
            self.next()
            return self._unary()
        if self.at_op("~"):
            self.next()
            return ast.UnaryOp("bitneg", self._unary())
        if self.at_kw("BINARY") and not (
            # CAST-style "BINARY(n)" never appears in expression position;
            # bare BINARY here is MySQL's unary collate-to-binary operator
            # (ref: parser.y SimpleExpr "BINARY SimpleExpr")
            self.peek(1).kind == "op" and self.peek(1).value in (")", ",")
        ):
            self.next()
            return ast.Collate(self._unary(), "binary")
        e = self._postfix_json(self._primary())
        # postfix COLLATE binds tightest of all operators
        # (ref: parser.y "Expression COLLATE CollationName")
        while self.eat_kw("COLLATE"):
            e = ast.Collate(e, self.ident().lower())
        return e

    def _primary(self) -> ast.Node:
        t = self.peek()
        if t.kind == "op" and t.value == "?":
            self.next()
            m = ast.ParamMarker(self.param_count)
            self.param_count += 1
            return m
        if t.kind == "op" and t.value == "@":
            self.next()
            if self.at_op("@"):
                self.next()
                scope = "session"
                name = self.ident()
                if name.lower() in ("global", "session") and self.eat_op("."):
                    scope = name.lower()
                    name = self.ident()
                return ast.UserVar(name.lower(), sys=True, scope=scope)
            return ast.UserVar(self.ident().lower())
        if t.kind == "int":
            self.next()
            return ast.Literal(int(t.value))
        if t.kind == "float":
            self.next()
            return ast.Literal(t.value, hint="decimal")
        if t.kind == "str":
            self.next()
            return ast.Literal(t.value)
        if self.at_op("("):
            self.next()
            if self.at_kw("SELECT", "WITH"):
                sel = self.parse_select_stmt()
                self.expect_op(")")
                return ast.SubqueryExpr(sel)
            e = self.parse_expr()
            self.expect_op(")")
            return e
        if t.kind == "qident":
            return self._column_or_call()
        if t.kind != "ident":
            raise ParseError("expected expression", t)
        kw = t.value.upper()
        if kw == "NULL":
            self.next()
            return ast.Literal(None)
        if kw == "TRUE":
            self.next()
            return ast.Literal(True)
        if kw == "FALSE":
            self.next()
            return ast.Literal(False)
        if kw in ("DATE", "TIMESTAMP", "TIME") and self.peek(1).kind == "str":
            self.next()
            lit = self.next()
            return ast.Literal(lit.value, hint=kw.lower())
        if kw == "VALUES" and self.peek(1).value == "(":
            # VALUES(col) inside ON DUPLICATE KEY UPDATE
            self.next()
            self.next()
            col = ast.ColumnName(self.ident())
            self.expect_op(")")
            return ast.FuncCall("values", [col])
        if kw == "CASE":
            return self._case()
        if kw == "CAST":
            self.next()
            self.expect_op("(")
            e = self.parse_expr()
            self.expect_kw("AS")
            td = self.parse_typedef()
            self.expect_op(")")
            return ast.Cast(e, td)
        if kw == "EXISTS" and self.peek(1).value == "(":
            self.next()
            self.next()
            sel = self.parse_select_stmt()
            self.expect_op(")")
            return ast.SubqueryExpr(sel, "exists")
        if kw == "INTERVAL":
            # INTERVAL n DAY — folded into date arithmetic by the planner
            self.next()
            n = self.parse_expr()
            unit = self.ident().lower()
            return ast.FuncCall("interval", [n, ast.Literal(unit)])
        return self._column_or_call()

    def _trim_call(self) -> ast.Node:
        """TRIM([{BOTH|LEADING|TRAILING}] [remstr] FROM str) | TRIM(str) —
        lowered to trim(str[, remstr, mode]) with mode 0=both 1=lead 2=trail."""
        mode = 0
        explicit = False
        if self.eat_kw("BOTH"):
            explicit = True
        elif self.eat_kw("LEADING"):
            mode, explicit = 1, True
        elif self.eat_kw("TRAILING"):
            mode, explicit = 2, True
        rem = None
        if explicit:
            if not self.at_kw("FROM"):
                rem = self.parse_expr()
            self.expect_kw("FROM")
            s = self.parse_expr()
        else:
            first = self.parse_expr()
            if self.eat_kw("FROM"):
                rem, s = first, self.parse_expr()
            else:
                s = first
        self.expect_op(")")
        args = [s]
        if rem is not None or mode != 0:
            args.append(rem if rem is not None else ast.Literal(" "))
            args.append(ast.Literal(mode))
        return ast.FuncCall("trim", args)

    def _column_or_call(self) -> ast.Node:
        t = self.peek()
        if t.kind == "ident" and t.value.upper() in RESERVED:
            # reserved words used as functions (REPLACE(x,..), LEFT(s,n), …)
            if self.peek(1).kind == "op" and self.peek(1).value == "(":
                pass
            else:
                raise ParseError("expected expression", t)
        name = self.ident()
        if self.at_op("("):
            self.next()
            lname = name.lower()
            if lname == "trim":
                return self._trim_call()
            fc = ast.FuncCall(lname)
            if self.at_op("*"):
                self.next()
                fc.star = True
            elif not self.at_op(")"):
                fc.distinct = self.eat_kw("DISTINCT")
                fc.args.append(self.parse_expr())
                while self.eat_op(","):
                    fc.args.append(self.parse_expr())
                if lname == "group_concat" and self.eat_kw("ORDER"):
                    self.expect_kw("BY")
                    fc.order_by = []
                    while True:
                        e = self.parse_expr()
                        desc = bool(self.eat_kw("DESC"))
                        if not desc:
                            self.eat_kw("ASC")
                        fc.order_by.append((e, desc))
                        if not self.eat_op(","):
                            break
                if lname == "group_concat" and self.eat_kw("SEPARATOR"):
                    sep = self.peek()
                    if sep.kind != "str":
                        raise ParseError("SEPARATOR expects a string literal", sep)
                    self.next()
                    fc.separator = sep.value
            self.expect_op(")")
            if self.at_kw("OVER"):
                self.next()
                fc.over = self._window_spec()
            return fc
        table = db = ""
        if self.eat_op("."):
            table, name = name, self.ident()
            if self.eat_op("."):
                db, table, name = table, name, self.ident()
        return ast.ColumnName(name, table=table, db=db)

    def _window_spec(self) -> ast.WindowSpec:
        self.expect_op("(")
        spec = ast.WindowSpec()
        if self.at_kw("PARTITION"):
            self.next()
            self.expect_kw("BY")
            spec.partition_by.append(self.parse_expr())
            while self.eat_op(","):
                spec.partition_by.append(self.parse_expr())
        if self.at_kw("ORDER"):
            self.next()
            self.expect_kw("BY")
            spec.order_by = self.parse_order_items()
        if self.at_kw("ROWS", "RANGE", "GROUPS"):
            unit = self.next().value.upper()

            def bound(is_start: bool):
                if self.eat_kw("UNBOUNDED"):
                    self.expect_kw("PRECEDING" if is_start else "FOLLOWING")
                    return ("unbounded", 0)
                if self.eat_kw("CURRENT"):
                    self.expect_kw("ROW")
                    return ("current", 0)
                t = self.next()
                if t.kind != "int":
                    raise ParseError("expected frame offset", t)
                if self.eat_kw("PRECEDING"):
                    return ("preceding", int(t.value))
                self.expect_kw("FOLLOWING")
                return ("following", int(t.value))

            if self.eat_kw("BETWEEN"):
                start = bound(True)
                self.expect_kw("AND")
                end = bound(False)
            else:
                start = bound(True)
                end = ("current", 0)
            # canonical spellings of the implicit frames
            if start == ("unbounded", 0) and end == ("current", 0):
                spec.rows_frame = unit == "ROWS"
            elif start == ("unbounded", 0) and end[0] == "unbounded":
                spec.whole_partition = True
            elif unit == "ROWS":
                spec.frame = (start[0], start[1], end[0], end[1])
            else:
                raise ParseError("bounded RANGE/GROUPS frames are not supported", self.peek())
        self.expect_op(")")
        return spec

    def _case(self) -> ast.CaseWhen:
        self.expect_kw("CASE")
        operand = None
        if not self.at_kw("WHEN"):
            operand = self.parse_expr()
        branches = []
        while self.eat_kw("WHEN"):
            cond = self.parse_expr()
            self.expect_kw("THEN")
            branches.append((cond, self.parse_expr()))
        else_v = self.parse_expr() if self.eat_kw("ELSE") else None
        self.expect_kw("END")
        return ast.CaseWhen(operand, branches, else_v)

    # -- DML ------------------------------------------------------------------
    def parse_insert(self) -> ast.Insert:
        replace = self.eat_kw("REPLACE")
        if not replace:
            self.expect_kw("INSERT")
        ignore = self.eat_kw("IGNORE")
        self.eat_kw("INTO")
        tbl = self._table_ref_simple()
        ins = ast.Insert(tbl, replace=replace, ignore=ignore)
        if self.at_op("("):
            self.next()
            ins.columns.append(self.ident())
            while self.eat_op(","):
                ins.columns.append(self.ident())
            self.expect_op(")")
        if self.at_kw("VALUES", "VALUE"):
            self.next()
            while True:
                self.expect_op("(")
                row = [] if self.at_op(")") else [self.parse_expr()]
                while self.eat_op(","):
                    row.append(self.parse_expr())
                self.expect_op(")")
                ins.values.append(row)
                if not self.eat_op(","):
                    break
        elif self.at_kw("SELECT", "WITH"):
            ins.select = self.parse_select_stmt()
        if self.at_kw("ON"):
            self.next()
            self.expect_kw("DUPLICATE")
            self.expect_kw("KEY")
            self.expect_kw("UPDATE")
            while True:
                cname = self.ident()
                self.expect_op("=")
                ins.on_dup_update.append((cname, self.parse_expr()))
                if not self.eat_op(","):
                    break
        return ins

    def parse_update(self) -> ast.Update:
        self.expect_kw("UPDATE")
        tbl = self._table_ref_simple(allow_alias=True)
        self.expect_kw("SET")
        upd = ast.Update(tbl)
        while True:
            colname = self._column_or_call()
            if not isinstance(colname, ast.ColumnName):
                raise ParseError("expected column in SET", self.peek())
            self.expect_op("=")
            upd.assignments.append((colname, self.parse_expr()))
            if not self.eat_op(","):
                break
        if self.eat_kw("WHERE"):
            upd.where = self.parse_expr()
        if self.at_kw("ORDER"):
            self.next()
            self.expect_kw("BY")
            upd.order_by = self.parse_order_items()
        if self.eat_kw("LIMIT"):
            upd.limit = self._limit_value()
        return upd

    def parse_delete(self) -> ast.Delete:
        self.expect_kw("DELETE")
        self.expect_kw("FROM")
        tbl = self._table_ref_simple(allow_alias=True)
        d = ast.Delete(tbl)
        if self.eat_kw("WHERE"):
            d.where = self.parse_expr()
        if self.at_kw("ORDER"):
            self.next()
            self.expect_kw("BY")
            d.order_by = self.parse_order_items()
        if self.eat_kw("LIMIT"):
            d.limit = self._limit_value()
        return d

    def _table_ref_simple(self, allow_alias: bool = False) -> ast.TableRef:
        name = self.ident()
        db = ""
        if self.eat_op("."):
            db, name = name, self.ident()
        alias = ""
        if allow_alias:
            if self.eat_kw("AS"):
                alias = self.ident()
            elif self.peek().kind in ("ident", "qident") and not self.at_kw("SET", "WHERE", "ORDER", "LIMIT"):
                alias = self.ident()
        return ast.TableRef(name, db=db, alias=alias)

    # -- DDL ------------------------------------------------------------------
    def parse_typedef(self) -> ast.TypeDef:
        name = self.ident().lower()
        if name == "double" and self.at_kw("PRECISION"):
            self.next()
        td = ast.TypeDef(name)
        if self.at_op("("):
            self.next()
            td.length = int(self.next().value)
            if self.eat_op(","):
                td.scale = int(self.next().value)
            self.expect_op(")")
        if self.eat_kw("UNSIGNED"):
            td.unsigned = True
        self.eat_kw("SIGNED")
        # charset is noise; collation is semantic (ci vs bin compares)
        if self.eat_kw("CHARACTER"):
            self.expect_kw("SET")
            self.ident()
        if self.eat_kw("COLLATE"):
            td.collate = self.ident().lower()
        return td

    def parse_create(self) -> ast.Node:
        self.expect_kw("CREATE")
        if self.eat_kw("USER"):
            return self.parse_create_user()
        if self.at_kw("RESOURCE"):
            return self._resource_group("create")
        if self.at_kw("GLOBAL", "SESSION", "BINDING"):
            is_global = self.eat_kw("GLOBAL")
            if not is_global:
                self.eat_kw("SESSION")
            self.expect_kw("BINDING")
            self.expect_kw("FOR")
            fstart = self.peek().pos
            self.parse_select_stmt()
            if not self.at_kw("USING"):
                raise ParseError("expected USING", self.peek())
            fend = self.peek().pos
            self.next()
            ustart = self.peek().pos
            self.parse_select_stmt()
            return ast.CreateBinding(
                self.sql[fstart:fend].strip(),
                self.sql[ustart:].rstrip().rstrip(";"),
                is_global,
            )
        or_replace = False
        if self.at_kw("OR"):
            self.next()
            self.expect_kw("REPLACE")
            or_replace = True
        if self.eat_kw("VIEW"):
            tbl = self._table_ref_simple()
            cols: list[str] = []
            if self.eat_op("("):
                cols.append(self.ident())
                while self.eat_op(","):
                    cols.append(self.ident())
                self.expect_op(")")
            self.expect_kw("AS")
            start = self.peek().pos
            self.parse_select_stmt()  # validate the definition now
            text = self.sql[start:].rstrip().rstrip(";")
            return ast.CreateView(tbl, [c.lower() for c in cols], text, or_replace)
        if or_replace:
            raise ParseError("OR REPLACE only applies to CREATE VIEW", self.peek())
        if self.eat_kw("SEQUENCE"):
            ine = self._if_not_exists()
            tbl = self._table_ref_simple()
            cs = ast.CreateSequence(tbl.name, db=tbl.db, if_not_exists=ine)
            while self.peek().kind == "ident" and not self.at_op(";"):
                kw = self.ident().upper()
                if kw == "START":
                    self.eat_kw("WITH")
                    self.eat_op("=")
                    cs.start = int(self.next().value)
                elif kw == "INCREMENT":
                    self.eat_kw("BY")
                    self.eat_op("=")
                    cs.increment = int(self.next().value)
                elif kw in ("CACHE", "MINVALUE", "MAXVALUE"):
                    self.next()  # value (ignored: single-process)
                elif kw in ("NOCACHE", "NOCYCLE", "CYCLE"):
                    pass
                else:
                    raise ParseError(f"unknown sequence option {kw!r}", self.peek())
            return cs
        if self.at_kw("DATABASE", "SCHEMA"):
            self.next()
            ine = self._if_not_exists()
            return ast.CreateDatabase(self.ident(), if_not_exists=ine)
        if self.at_kw("UNIQUE", "INDEX"):
            unique = self.eat_kw("UNIQUE")
            self.expect_kw("INDEX")
            iname = self.ident()
            self.expect_kw("ON")
            tbl = self._table_ref_simple()
            self.expect_op("(")
            cols = [self.ident()]
            while self.eat_op(","):
                cols.append(self.ident())
            self.expect_op(")")
            return ast.CreateIndex(ast.IndexDef(iname, cols, unique=unique), tbl)
        self.expect_kw("TABLE")
        ine = self._if_not_exists()
        tbl = self._table_ref_simple()
        ct = ast.CreateTable(tbl, if_not_exists=ine)
        self.expect_op("(")
        while True:
            cons_name = ""
            if self.at_kw("CONSTRAINT"):
                self.next()
                if not self.at_kw("FOREIGN", "PRIMARY", "UNIQUE"):
                    cons_name = self.ident()
            if self.at_kw("FOREIGN"):
                self.next()
                self.expect_kw("KEY")
                if self.peek().kind in ("ident", "qident") and not self.at_op("("):
                    iname = self.ident()  # always consume the index name
                    cons_name = cons_name or iname
                ct.foreign_keys.append(self._fk_tail(cons_name or f"fk_{len(ct.foreign_keys) + 1}"))
            elif self.at_kw("PRIMARY"):
                self.next()
                self.expect_kw("KEY")
                self.expect_op("(")
                cols = [self.ident()]
                while self.eat_op(","):
                    cols.append(self.ident())
                self.expect_op(")")
                ct.indexes.append(ast.IndexDef("primary", cols, unique=True, primary=True))
            elif self.at_kw("UNIQUE", "INDEX", "KEY"):
                unique = self.eat_kw("UNIQUE")
                if not self.eat_kw("INDEX"):
                    self.eat_kw("KEY")
                iname = self.ident() if self.peek().kind in ("ident", "qident") and not self.at_op("(") else ""
                self.expect_op("(")
                cols = [self.ident()]
                while self.eat_op(","):
                    cols.append(self.ident())
                self.expect_op(")")
                ct.indexes.append(ast.IndexDef(iname or f"idx_{len(ct.indexes)}", cols, unique=unique))
            else:
                cname = self.ident()
                td = self.parse_typedef()
                cd = ast.ColumnDef(cname, td)
                while True:
                    if self.eat_kw("NOT"):
                        self.expect_kw("NULL")
                        cd.not_null = True
                    elif self.eat_kw("NULL"):
                        pass
                    elif self.eat_kw("DEFAULT"):
                        cd.default = self._primary() if not self.at_op("-") else self.parse_expr()
                    elif self.at_kw("PRIMARY"):
                        self.next()
                        self.expect_kw("KEY")
                        cd.primary_key = True
                    elif self.eat_kw("UNIQUE"):
                        self.eat_kw("KEY")
                        cd.unique = True
                    elif self.eat_kw("AUTO_INCREMENT"):
                        cd.auto_increment = True
                    elif self.eat_kw("COMMENT"):
                        self.next()
                    else:
                        break
                ct.columns.append(cd)
            if not self.eat_op(","):
                break
        self.expect_op(")")
        if self.at_kw("PARTITION"):
            self.next()
            self.expect_kw("BY")
            if self.eat_kw("HASH"):
                self.expect_op("(")
                col = self.ident().lower()
                self.expect_op(")")
                self.expect_kw("PARTITIONS")
                ntok = self.next()
                if ntok.kind != "int" or int(ntok.value) < 1:
                    raise ParseError("expected partition count", ntok)
                ct.partition_by = ast.PartitionByDef("hash", col, num=int(ntok.value))
            else:
                self.expect_kw("RANGE")
                self.expect_op("(")
                col = self.ident().lower()
                self.expect_op(")")
                self.expect_op("(")
                defs = [self._partition_def()]
                while self.eat_op(","):
                    defs.append(self._partition_def())
                self.expect_op(")")
                ct.partition_by = ast.PartitionByDef("range", col, defs=defs)
        # table options: TTL parsed, everything else swallowed
        while self.peek().kind == "ident" and not self.at_op(";"):
            if self.at_kw("TTL"):
                self.next()
                self.expect_op("=")
                ct.ttl = self._ttl_spec()
                continue
            if self.peek().value.upper() == "TTL_ENABLE":
                self.next()
                self.expect_op("=")
                ct.ttl_enable = self._string_lit().upper() == "ON"
                continue
            if self.at_kw("AUTO_INCREMENT"):
                self.next()
                self.expect_op("=")
                t = self.next()
                ct.auto_increment_base = int(t.value)
                continue
            self.next()
            if self.eat_op("="):
                self.next()
        return ct

    def _ttl_spec(self) -> tuple[str, int]:
        """`col` + INTERVAL n DAY"""
        col = self.ident().lower()
        self.expect_op("+")
        self.expect_kw("INTERVAL")
        t = self.next()
        if t.kind != "int":
            raise ParseError("expected TTL interval count", t)
        unit = self.ident().lower()
        days = int(t.value)
        if unit in ("day", "days"):
            pass
        elif unit in ("week", "weeks"):
            days *= 7
        elif unit in ("month", "months"):
            days *= 30
        else:
            raise ParseError(f"unsupported TTL unit {unit!r}", t)
        return col, days

    def _if_not_exists(self) -> bool:
        if self.at_kw("IF"):
            self.next()
            self.expect_kw("NOT")
            self.expect_kw("EXISTS")
            return True
        return False

    def parse_drop(self) -> ast.Node:
        self.expect_kw("DROP")
        if self.at_kw("RESOURCE"):
            return self._resource_group("drop")
        if self.at_kw("GLOBAL", "SESSION", "BINDING"):
            is_global = self.eat_kw("GLOBAL")
            if not is_global:
                self.eat_kw("SESSION")
            self.expect_kw("BINDING")
            self.expect_kw("FOR")
            fstart = self.peek().pos
            self.parse_select_stmt()
            return ast.DropBinding(self.sql[fstart:].rstrip().rstrip(";"), is_global)
        if self.eat_kw("USER"):
            ie = self._if_exists()
            users = [self._user_spec()]
            while self.eat_op(","):
                users.append(self._user_spec())
            return ast.DropUser(users, ie)
        if self.at_kw("DATABASE", "SCHEMA"):
            self.next()
            ie = self._if_exists()
            return ast.DropDatabase(self.ident(), if_exists=ie)
        if self.at_kw("INDEX"):
            self.next()
            name = self.ident()
            self.expect_kw("ON")
            return ast.DropIndex(name, self._table_ref_simple())
        if self.eat_kw("VIEW"):
            ie = self._if_exists()
            tables = [self._table_ref_simple()]
            while self.eat_op(","):
                tables.append(self._table_ref_simple())
            return ast.DropView(tables, ie)
        if self.eat_kw("SEQUENCE"):
            ie = self._if_exists()
            names = [self.ident().lower()]
            while self.eat_op(","):
                names.append(self.ident().lower())
            return ast.DropSequence(names, ie)
        self.expect_kw("TABLE")
        ie = self._if_exists()
        tables = [self._table_ref_simple()]
        while self.eat_op(","):
            tables.append(self._table_ref_simple())
        return ast.DropTable(tables, if_exists=ie)

    def _if_exists(self) -> bool:
        if self.at_kw("IF"):
            self.next()
            self.expect_kw("EXISTS")
            return True
        return False

    def parse_plan_replayer(self) -> ast.Node:
        """PLAN REPLAYER DUMP EXPLAIN <stmt> | PLAN REPLAYER LOAD '<path>'
        (ref: parser.y PlanReplayerStmt)."""
        self.expect_kw("PLAN")
        self.expect_kw("REPLAYER")
        if self.eat_kw("LOAD"):
            return ast.PlanReplayer("load", path=self._string_lit())
        self.expect_kw("DUMP")
        self.expect_kw("EXPLAIN")
        start = self.peek().pos
        self.parse_statement()  # validate; the dump captures the raw text
        return ast.PlanReplayer("dump", sql=self.sql[start:].strip().rstrip(";"))

    def parse_alter(self):
        self.expect_kw("ALTER")
        if self.at_kw("RESOURCE"):
            return self._resource_group("alter")
        if self.eat_kw("USER"):
            ie = self._if_exists()
            users = [self._user_spec()]
            while self.eat_op(","):
                users.append(self._user_spec())
            return ast.AlterUser(users, ie)
        self.expect_kw("TABLE")
        tbl = self._table_ref_simple()
        at = ast.AlterTable(tbl)
        if self.eat_kw("ADD"):
            if self.at_kw("CONSTRAINT", "FOREIGN"):
                cons_name = ""
                if self.eat_kw("CONSTRAINT") and not self.at_kw("FOREIGN"):
                    cons_name = self.ident()
                self.expect_kw("FOREIGN")
                self.expect_kw("KEY")
                if self.peek().kind in ("ident", "qident") and not self.at_op("("):
                    iname = self.ident()  # always consume the index name
                    cons_name = cons_name or iname
                at.action, at.fk = "add_fk", self._fk_tail(cons_name)
            elif self.at_kw("PARTITION"):
                self.next()
                self.expect_op("(")
                name, lt = self._partition_def()
                self.expect_op(")")
                at.action, at.name, at.less_than = "add_partition", name, lt
            elif self.at_kw("INDEX", "KEY", "UNIQUE"):
                unique = self.eat_kw("UNIQUE")
                if not self.eat_kw("INDEX"):
                    self.eat_kw("KEY")
                iname = self.ident()
                self.expect_op("(")
                cols = [self.ident()]
                while self.eat_op(","):
                    cols.append(self.ident())
                self.expect_op(")")
                at.action, at.index = "add_index", ast.IndexDef(iname, cols, unique=unique)
            else:
                self.eat_kw("COLUMN")
                cname = self.ident()
                td = self.parse_typedef()
                cd = ast.ColumnDef(cname, td)
                if self.eat_kw("NOT"):
                    self.expect_kw("NULL")
                    cd.not_null = True
                if self.eat_kw("DEFAULT"):
                    cd.default = self.parse_expr()
                at.action, at.column = "add_column", cd
        elif self.eat_kw("DROP"):
            if self.at_kw("FOREIGN"):
                self.next()
                self.expect_kw("KEY")
                at.action, at.name = "drop_fk", self.ident().lower()
            elif self.at_kw("PARTITION"):
                self.next()
                at.action, at.name = "drop_partition", self.ident()
            elif self.at_kw("INDEX", "KEY"):
                self.next()
                at.action, at.name = "drop_index", self.ident()
            else:
                self.eat_kw("COLUMN")
                at.action, at.name = "drop_column", self.ident()
        elif self.eat_kw("TRUNCATE"):
            self.expect_kw("PARTITION")
            at.action, at.name = "truncate_partition", self.ident()
        elif self.at_kw("TTL"):
            self.next()
            self.expect_op("=")
            at.action, at.ttl = "set_ttl", self._ttl_spec()
        elif self.peek().value.upper() == "TTL_ENABLE":
            self.next()
            self.expect_op("=")
            at.action, at.ttl_enable = "ttl_enable", self._string_lit().upper() == "ON"
        elif self.eat_kw("REMOVE"):
            self.expect_kw("TTL")
            at.action = "remove_ttl"
        elif self.eat_kw("RENAME"):
            self.eat_kw("TO")
            at.action, at.name = "rename", self.ident()
        else:
            raise ParseError("unsupported ALTER action", self.peek())
        return at

    def _fk_tail(self, name: str) -> "ast.FKDef":
        """(cols) REFERENCES tbl (cols) [ON DELETE act] [ON UPDATE act]
        (ref: parser.y ReferenceDef)."""
        self.expect_op("(")
        cols = [self.ident()]
        while self.eat_op(","):
            cols.append(self.ident())
        self.expect_op(")")
        self.expect_kw("REFERENCES")
        ref = self._table_ref_simple()
        self.expect_op("(")
        rcols = [self.ident()]
        while self.eat_op(","):
            rcols.append(self.ident())
        self.expect_op(")")
        fk = ast.FKDef(name.lower(), [c.lower() for c in cols], ref, [c.lower() for c in rcols])

        def action() -> str:
            if self.eat_kw("RESTRICT"):
                return "restrict"
            if self.eat_kw("CASCADE"):
                return "cascade"
            if self.eat_kw("SET"):
                self.expect_kw("NULL")
                return "set_null"
            self.expect_kw("NO")
            self.expect_kw("ACTION")
            return "no_action"

        while self.at_kw("ON"):
            self.next()
            if self.eat_kw("DELETE"):
                fk.on_delete = action()
            else:
                self.expect_kw("UPDATE")
                fk.on_update = action()
        return fk

    def _partition_def(self) -> tuple[str, "int | None"]:
        """PARTITION name VALUES LESS THAN (n) | MAXVALUE"""
        self.expect_kw("PARTITION")
        name = self.ident().lower()
        self.expect_kw("VALUES")
        self.expect_kw("LESS")
        self.expect_kw("THAN")
        if self.eat_kw("MAXVALUE"):
            return name, None
        self.expect_op("(")
        if self.eat_kw("MAXVALUE"):
            self.expect_op(")")
            return name, None
        neg = self.eat_op("-")
        tok = self.next()
        if tok.kind != "int":
            raise ParseError("expected integer partition bound", tok)
        self.expect_op(")")
        return name, int(tok.value) * (-1 if neg else 1)

    def parse_truncate(self) -> ast.TruncateTable:
        self.expect_kw("TRUNCATE")
        self.eat_kw("TABLE")
        return ast.TruncateTable(self._table_ref_simple())

    # -- misc -----------------------------------------------------------------
    def parse_explain(self):
        self.next()  # EXPLAIN/DESC/DESCRIBE
        analyze = self.eat_kw("ANALYZE")
        # DESCRIBE t / EXPLAIN t: table describe == SHOW COLUMNS FROM t
        t = self.peek()
        if not analyze and t.kind in ("ident", "qident") and t.value.upper() not in (
            "SELECT", "INSERT", "UPDATE", "DELETE", "REPLACE", "WITH", "TABLE", "FORMAT"
        ):
            ref = self._table_ref_simple()
            target = f"{ref.db}.{ref.name}" if ref.db else ref.name
            return ast.Show("columns", target=target)
        return ast.Explain(self.parse_statement(), analyze=analyze)

    def parse_rename(self) -> ast.Node:
        # RENAME TABLE a TO b [, c TO d ...] → validated + applied as a unit
        self.expect_kw("RENAME")
        self.expect_kw("TABLE")
        pairs = []
        while True:
            old = self._table_ref_simple()
            self.expect_kw("TO")
            pairs.append((old, self._table_ref_simple()))
            if not self.eat_op(","):
                break
        return ast.RenameTables(pairs)

    def parse_do(self) -> ast.Node:
        self.expect_kw("DO")
        exprs = [self.parse_expr()]
        while self.eat_op(","):
            exprs.append(self.parse_expr())
        return ast.DoStmt(exprs)

    def parse_checksum(self) -> ast.Node:
        self.expect_kw("CHECKSUM")
        self.expect_kw("TABLE")
        names = [self._table_ref_simple()]
        while self.eat_op(","):
            names.append(self._table_ref_simple())
        return ast.ChecksumTable(names)

    def parse_table_stmt(self) -> ast.Node:
        # MySQL 8.0 TABLE t [ORDER BY ...] [LIMIT ...] == SELECT * FROM t ...
        self.expect_kw("TABLE")
        sel = ast.Select(items=[ast.SelectItem(ast.Wildcard())], from_=self._table_ref_simple())
        if self.eat_kw("ORDER"):
            self.expect_kw("BY")
            sel.order_by = self.parse_order_items()
        self._parse_limit(sel)
        return sel

    def parse_set(self):
        self.expect_kw("SET")
        if self.at_kw("RESOURCE"):
            self.next()
            self.expect_kw("GROUP")
            return ast.SetResourceGroup(self.ident().lower())
        scope = "session"
        if self.eat_kw("GLOBAL"):
            scope = "global"
        elif self.eat_kw("SESSION"):
            pass
        if self.at_op("@"):
            self.next()
            if self.at_op("@"):
                self.next()
                # @@global.x / @@session.x
                name = self.ident()
                if name.lower() in ("global", "session") and self.eat_op("."):
                    scope = name.lower()
                    name = self.ident()
            else:
                name = "@" + self.ident()
        else:
            name = self.ident()
        if not self.eat_op("="):
            self.expect_op(":=")
        val = self.parse_expr()
        return ast.SetVariable(name.lower(), val, scope=scope)

    def _string_lit(self) -> str:
        t = self.next()
        if t.kind != "str":
            raise ParseError("expected string literal", t)
        return t.value.decode() if isinstance(t.value, bytes) else t.value

    def parse_import(self) -> ast.ImportInto:
        self.expect_kw("IMPORT")
        self.expect_kw("INTO")
        tbl = self._table_ref_simple()
        self.expect_kw("FROM")
        path = self._string_lit()
        opts: dict = {}
        if self.eat_kw("WITH"):
            while True:
                name = self.ident().lower()
                if self.eat_op("="):
                    v = self.next()
                    val = v.value.decode() if isinstance(v.value, bytes) else v.value
                else:
                    val = 1
                opts[name] = val
                if not self.eat_op(","):
                    break
        return ast.ImportInto(tbl, path, opts)

    def parse_backup(self) -> ast.Backup:
        self.expect_kw("BACKUP")
        db = ""
        tables: list = []
        if self.eat_kw("DATABASE"):
            db = self.ident().lower()
        else:
            self.expect_kw("TABLE")
            tables = [self._table_ref_simple()]
            while self.eat_op(","):
                tables.append(self._table_ref_simple())
        self.expect_kw("TO")
        return ast.Backup(self._string_lit(), db=db, tables=tables)

    def parse_restore(self) -> ast.Restore:
        self.expect_kw("RESTORE")
        self.expect_kw("DATABASE")
        db = ""
        if not self.at_kw("FROM"):
            db = self.ident().lower()
        self.expect_kw("FROM")
        return ast.Restore(self._string_lit(), db=db)

    def _user_spec(self) -> ast.UserSpec:
        t = self.peek()
        if t.kind == "str":
            self.next()
            name = t.value.decode() if isinstance(t.value, bytes) else t.value
        else:
            name = self.ident()
        host = "%"
        if self.at_op("@"):
            self.next()
            h = self.peek()
            if h.kind == "str":
                self.next()
                host = h.value.decode() if isinstance(h.value, bytes) else h.value
            else:
                host = self.ident()
        spec = ast.UserSpec(name, host)
        if self.eat_kw("IDENTIFIED"):
            spec.has_auth = True
            if self.eat_kw("WITH"):
                t = self.peek()
                if t.kind == "str":
                    self.next()
                    spec.plugin = t.value.decode() if isinstance(t.value, bytes) else t.value
                else:
                    spec.plugin = self.ident()
                if self.eat_kw("BY"):
                    spec.password = self._string_lit()
            else:
                self.expect_kw("BY")
                spec.password = self._string_lit()
        return spec

    def parse_create_user(self) -> ast.CreateUser:
        # caller consumed CREATE USER
        ine = self._if_not_exists()
        users = [self._user_spec()]
        while self.eat_op(","):
            users.append(self._user_spec())
        return ast.CreateUser(users, ine)

    _PRIV_KWS = ("SELECT", "INSERT", "UPDATE", "DELETE", "CREATE", "DROP", "INDEX", "ALTER", "SUPER")

    def parse_grant(self) -> ast.Grant:
        revoke = bool(self.eat_kw("REVOKE"))
        if not revoke:
            self.expect_kw("GRANT")
        privs: list[str] = []
        if self.eat_kw("ALL"):
            self.eat_kw("PRIVILEGES")
            privs = ["all"]
        else:
            while True:
                kw = self.next()
                if kw.value.upper() not in self._PRIV_KWS:
                    raise ParseError(f"unknown privilege {kw.value!r}", kw)
                privs.append(kw.value.lower())
                if not self.eat_op(","):
                    break
        self.expect_kw("ON")
        db = table = ""
        if self.eat_op("*"):
            self.expect_op(".")
            self.expect_op("*")
        else:
            first = self.ident()
            if self.eat_op("."):
                if self.eat_op("*"):
                    db = first.lower()
                else:
                    db, table = first.lower(), self.ident().lower()
            else:
                table = first.lower()  # bare table → current db at exec
        self.expect_kw("FROM" if revoke else "TO")
        spec = self._user_spec()
        return ast.Grant(privs, db, table, spec.name, spec.host, revoke)

    def _resource_group(self, op: str) -> ast.ResourceGroupStmt:
        self.expect_kw("RESOURCE")
        self.expect_kw("GROUP")
        st = ast.ResourceGroupStmt(op, "")
        if op == "create":
            st.if_not_exists = self._if_not_exists()
        if op == "drop":
            st.if_exists = self._if_exists()
        st.name = self.ident().lower()
        if op == "drop":
            return st
        while self.peek().kind == "ident" and not self.at_op(";"):
            kw = self.ident().upper()
            if kw == "RU_PER_SEC":
                self.expect_op("=")
                st.ru_per_sec = int(self.next().value)
            elif kw == "BURSTABLE":
                if self.eat_op("="):
                    self.next()
                st.burstable = True
            elif kw == "QUERY_LIMIT":
                self.expect_op("=")
                self.expect_op("(")
                while not self.eat_op(")"):
                    opt = self.ident().upper()
                    self.expect_op("=")
                    if opt == "EXEC_ELAPSED":
                        st.exec_elapsed_s = _parse_duration(self._string_lit())
                    elif opt == "ACTION":
                        st.action = self.ident().upper()
                    else:
                        raise ParseError(f"unknown QUERY_LIMIT option {opt!r}", self.peek())
                    self.eat_op(",")
            else:
                raise ParseError(f"unknown resource group option {kw!r}", self.peek())
            self.eat_op(",")
        return st

    def parse_recover(self) -> ast.RecoverTable:
        self.next()  # RECOVER | FLASHBACK
        self.expect_kw("TABLE")
        tbl = self._table_ref_simple()
        new_name = ""
        if self.eat_kw("TO"):
            new_name = self.ident().lower()
        return ast.RecoverTable(tbl, new_name)

    def parse_admin(self) -> ast.Admin:
        self.expect_kw("ADMIN")
        if self.eat_kw("CHECK"):
            if self.eat_kw("TABLE"):
                return ast.Admin("check_table", self._table_ref_simple())
            self.expect_kw("INDEX")
            tbl = self._table_ref_simple()
            return ast.Admin("check_index", tbl, self.ident().lower())
        self.expect_kw("SHOW")
        self.expect_kw("DDL")
        self.expect_kw("JOBS")
        return ast.Admin("show_ddl_jobs")

    def parse_kill(self) -> ast.Kill:
        self.expect_kw("KILL")
        query_only = True
        if self.eat_kw("CONNECTION"):
            query_only = False
        else:
            self.eat_kw("QUERY")
        t = self.next()
        if t.kind != "int":
            raise ParseError("expected connection id", t)
        return ast.Kill(int(t.value), query_only)

    def parse_prepare(self) -> ast.Prepare:
        self.expect_kw("PREPARE")
        name = self.ident().lower()
        self.expect_kw("FROM")
        t = self.peek()
        if t.kind == "str":
            self.next()
            text = t.value.decode() if isinstance(t.value, bytes) else t.value
            return ast.Prepare(name, text=text)
        if self.at_op("@"):
            self.next()
            return ast.Prepare(name, from_var=self.ident().lower())
        raise ParseError("expected string literal or @var after FROM", t)

    def parse_execute_stmt(self) -> ast.ExecutePrepared:
        self.expect_kw("EXECUTE")
        name = self.ident().lower()
        using: list[str] = []
        if self.eat_kw("USING"):
            while True:
                self.expect_op("@")
                using.append(self.ident().lower())
                if not self.eat_op(","):
                    break
        return ast.ExecutePrepared(name, using)

    def parse_deallocate(self) -> ast.Deallocate:
        self.expect_kw("DEALLOCATE")
        self.expect_kw("PREPARE")
        return ast.Deallocate(self.ident().lower())

    def parse_show(self) -> ast.Show:
        self.expect_kw("SHOW")
        if self.eat_kw("TABLES"):
            like = None
            if self.eat_kw("LIKE"):
                like = self.next().value
            return ast.Show("tables", like=like)
        if self.eat_kw("DATABASES"):
            return ast.Show("databases")
        if self.eat_kw("PROCESSLIST"):
            return ast.Show("processlist")
        if self.at_kw("GLOBAL", "SESSION", "BINDINGS"):
            self.eat_kw("GLOBAL") or self.eat_kw("SESSION")
            if self.eat_kw("BINDINGS"):
                return ast.Show("bindings")
            if self.eat_kw("VARIABLES"):
                like = None
                if self.eat_kw("LIKE"):
                    like = self.next().value
                return ast.Show("variables", like=like)
            if self.eat_kw("STATUS"):
                like = None
                if self.eat_kw("LIKE"):
                    like = self.next().value
                return ast.Show("status", like=like)
            raise ParseError("expected BINDINGS, VARIABLES, or STATUS", self.peek())
        if self.eat_kw("GRANTS"):
            target = ""
            if self.eat_kw("FOR"):
                spec = self._user_spec()
                target = f"{spec.name}@{spec.host}"
            return ast.Show("grants", target=target)
        if self.eat_kw("FULL") and self.eat_kw("PROCESSLIST"):
            return ast.Show("processlist")
        if self.eat_kw("VARIABLES"):
            like = None
            if self.eat_kw("LIKE"):
                like = self.next().value
            return ast.Show("variables", like=like)
        if self.eat_kw("CREATE"):
            if self.eat_kw("DATABASE") or self.eat_kw("SCHEMA"):
                return ast.Show("create_database", target=self.ident())
            self.expect_kw("TABLE")
            name = self.ident()
            if self.eat_op("."):  # qualified `db`.`table`
                name = f"{name}.{self.ident()}"
            return ast.Show("create_table", target=name)
        if self.at_kw("TABLE") and self.peek(1).value.upper() == "STATUS":
            self.next()
            self.next()
            like = None
            if self.eat_kw("LIKE"):
                like = self.next().value
            return ast.Show("table_status", like=like)
        if self.eat_kw("COLLATION"):
            like = None
            if self.eat_kw("LIKE"):
                like = self.next().value
            return ast.Show("collation", like=like)
        if self.eat_kw("CHARSET") or (self.at_kw("CHARACTER") and self.peek(1).value.upper() == "SET"):
            if self.at_kw("SET"):
                self.next()
            elif self.at_kw("CHARACTER"):
                self.next()
                self.next()
            like = None
            if self.eat_kw("LIKE"):
                like = self.next().value
            return ast.Show("charset", like=like)
        if self.eat_kw("ENGINES"):
            return ast.Show("engines")
        if self.eat_kw("TRIGGERS"):
            return ast.Show("triggers")
        if self.eat_kw("STATUS"):
            like = None
            if self.eat_kw("LIKE"):
                like = self.next().value
            return ast.Show("status", like=like)
        if self.eat_kw("WARNINGS"):
            return ast.Show("warnings")
        if self.eat_kw("ERRORS"):
            return ast.Show("errors")
        if self.at_kw("COUNT"):  # SHOW COUNT(*) WARNINGS | ERRORS
            self.next()
            self.expect_op("(")
            self.expect_op("*")
            self.expect_op(")")
            if self.eat_kw("WARNINGS"):
                return ast.Show("warning_count")
            self.expect_kw("ERRORS")
            return ast.Show("error_count")
        if self.eat_kw("COLUMNS") or self.eat_kw("FIELDS"):
            self.expect_kw("FROM")
            return ast.Show("columns", target=self.ident())
        if self.eat_kw("INDEX") or self.eat_kw("INDEXES") or self.eat_kw("KEYS"):
            self.expect_kw("FROM")
            return ast.Show("index", target=self.ident())
        if self.eat_kw("STATS_HISTOGRAMS"):
            return ast.Show("stats_histograms")
        if self.eat_kw("STATS_TOPN"):
            return ast.Show("stats_topn")
        if self.eat_kw("STATS_BUCKETS"):
            return ast.Show("stats_buckets")
        raise ParseError("unsupported SHOW", self.peek())

    def parse_use(self) -> ast.UseDatabase:
        self.expect_kw("USE")
        return ast.UseDatabase(self.ident())

    def parse_begin(self) -> ast.Begin:
        if self.eat_kw("START"):
            self.expect_kw("TRANSACTION")
        else:
            self.expect_kw("BEGIN")
        mode = ""
        if self.eat_kw("PESSIMISTIC"):
            mode = "pessimistic"
        elif self.eat_kw("OPTIMISTIC"):
            mode = "optimistic"
        return ast.Begin(mode=mode)

    def parse_load_data(self) -> "ast.LoadData":
        """LOAD DATA [LOCAL] INFILE 'path' INTO TABLE t [FIELDS TERMINATED
        BY 'x' [ENCLOSED BY 'y']] [LINES TERMINATED BY 'z'] [IGNORE n
        LINES|ROWS] [(cols)] (ref: parser.y LoadDataStmt)."""
        self.expect_kw("LOAD")
        self.expect_kw("DATA")
        local = self.eat_kw("LOCAL")
        self.expect_kw("INFILE")
        t = self.next()
        if t.kind != "str":
            raise ParseError("expected file path string", t)
        path = t.value
        dup_mode = ""
        if self.eat_kw("IGNORE"):
            dup_mode = "ignore"
        elif self.eat_kw("REPLACE"):
            dup_mode = "replace"
        self.expect_kw("INTO")
        self.expect_kw("TABLE")
        tbl = self._table_ref_simple()
        stmt = ast.LoadData(path=path, table=tbl, local=local, dup_mode=dup_mode)
        if self.eat_kw("FIELDS") or self.eat_kw("COLUMNS"):
            while self.at_kw("TERMINATED", "ENCLOSED", "ESCAPED", "OPTIONALLY"):
                self.eat_kw("OPTIONALLY")
                if self.eat_kw("TERMINATED"):
                    self.expect_kw("BY")
                    stmt.fields_terminated = self.next().value
                elif self.eat_kw("ENCLOSED"):
                    self.expect_kw("BY")
                    stmt.fields_enclosed = self.next().value
                elif self.eat_kw("ESCAPED"):
                    self.expect_kw("BY")
                    self.next()  # accepted; csv module's default escape rules
        if self.eat_kw("LINES"):
            self.expect_kw("TERMINATED")
            self.expect_kw("BY")
            self.next()  # newline terminators only (csv reader)
        if self.eat_kw("IGNORE"):
            stmt.ignore_lines = int(self.next().value)
            if not (self.eat_kw("LINES") or self.eat_kw("ROWS")):
                raise ParseError("expected LINES/ROWS after IGNORE n", self.peek())
        if self.eat_op("("):
            stmt.columns.append(self.ident().lower())
            while self.eat_op(","):
                stmt.columns.append(self.ident().lower())
            self.expect_op(")")
        return stmt

    def parse_analyze(self) -> ast.AnalyzeTable:
        self.expect_kw("ANALYZE")
        self.expect_kw("TABLE")
        tables = [self._table_ref_simple()]
        # ANALYZE TABLE t PARTITION p0[, p1...] — partition-level analyze
        # whose results merge into table-level global stats (ref:
        # statistics/handle/globalstats)
        if self.at_kw("PARTITION"):
            self.next()
            parts = [self.ident().lower()]
            while self.eat_op(","):
                parts.append(self.ident().lower())
            tables[0].partitions = parts
            return ast.AnalyzeTable(tables)
        while self.eat_op(","):
            tables.append(self._table_ref_simple())
        return ast.AnalyzeTable(tables)


def _parse_hints(text: str) -> list:
    """'READ_FROM_STORAGE(TPU[t]), USE_INDEX(t, i)' → [(name, [args])].
    Unknown hints parse fine and are ignored downstream (MySQL semantics)."""
    out = []
    p = Parser(text)
    while p.peek().kind != "eof":
        if p.peek().kind not in ("ident", "qident"):
            p.next()
            continue
        name = p.ident().lower()
        args: list[str] = []
        if p.eat_op("("):
            depth = 1
            buf = ""
            while depth > 0 and p.peek().kind != "eof":
                t = p.next()
                if t.kind == "op" and t.value == "(":
                    depth += 1
                    buf += "("
                elif t.kind == "op" and t.value == ")":
                    depth -= 1
                    if depth > 0:
                        buf += ")"
                elif t.kind == "op" and t.value == "," and depth == 1:
                    args.append(buf.strip())
                    buf = ""
                else:
                    v = t.value
                    buf += (v.decode() if isinstance(v, bytes) else str(v)) + " "
            if buf.strip():
                args.append(buf.strip())
        out.append((name, args))
        p.eat_op(",")
    return out


def _parse_duration(s: str) -> float:
    """'1s' / '500ms' / '2m' → seconds."""
    s = s.strip().lower()
    for suffix, mult in (("ms", 1e-3), ("s", 1.0), ("m", 60.0), ("h", 3600.0)):
        if s.endswith(suffix):
            return float(s[: -len(suffix)]) * mult
    return float(s)


# full lexer+parser invocations since process start — the statement fast
# lane (session._stmt_cache) is asserted against this: a warm repeated
# statement must not move it (see tests/test_fastlane.py)
_N_PARSES = 0


def parse_count() -> int:
    return _N_PARSES


def parse(sql: str) -> ast.Node:
    return parse_with_params(sql)[0]


def parse_with_params(sql: str) -> tuple[ast.Node, int]:
    """Parse one statement; also report how many ``?`` markers it contains
    (prepared-statement surface, ref: ast.ParamMarkerExpr counting)."""
    global _N_PARSES
    _N_PARSES += 1
    p = Parser(sql)
    stmt = p.parse_statement()
    p.eat_op(";")
    if p.peek().kind != "eof":
        raise ParseError("trailing input", p.peek())
    return stmt, p.param_count


def parse_many(sql: str) -> list[ast.Node]:
    p = Parser(sql)
    out = []
    while p.peek().kind != "eof":
        out.append(p.parse_statement())
        while p.eat_op(";"):
            pass
    return out
