"""SQL lexer (ref: pkg/parser/lexer.go). Produces (kind, value, pos) tokens.

Kinds: ident, qident (backquoted), int, float, str, op, eof. Keywords are NOT
a separate kind — the parser matches identifiers case-insensitively, which is
how MySQL treats non-reserved words anyway.
"""

from __future__ import annotations

from dataclasses import dataclass


class LexError(Exception):
    def __init__(self, msg: str, pos: int):
        super().__init__(f"{msg} at offset {pos}")
        self.pos = pos


@dataclass(frozen=True)
class Token:
    kind: str  # ident | qident | int | float | str | hexstr | op | eof
    value: str
    pos: int


_OPS = [
    "->>", "->",
    "<=>", "<<", ">>", "<=", ">=", "<>", "!=", ":=", "||", "&&",
    "(", ")", ",", ".", ";", "+", "-", "*", "/", "%", "=", "<", ">",
    "!", "~", "^", "&", "|", "@", "?", "[", "]",
]


def tokenize(sql: str) -> list[Token]:
    toks: list[Token] = []
    i, n = 0, len(sql)
    while i < n:
        c = sql[i]
        if c in " \t\r\n":
            i += 1
            continue
        # comments
        if c == "-" and sql.startswith("--", i):
            j = sql.find("\n", i)
            i = n if j < 0 else j + 1
            continue
        if c == "#":
            j = sql.find("\n", i)
            i = n if j < 0 else j + 1
            continue
        if c == "/" and sql.startswith("/*", i):
            j = sql.find("*/", i + 2)
            if j < 0:
                raise LexError("unterminated comment", i)
            if sql.startswith("/*+", i):
                # optimizer hint comment → token (ref: parser hint scanning)
                toks.append(Token("hint", sql[i + 3 : j].strip(), i))
            i = j + 2
            continue
        # strings
        if c in ("'", '"'):
            q = c
            j = i + 1
            buf = []
            while j < n:
                ch = sql[j]
                if ch == "\\" and j + 1 < n:
                    esc = sql[j + 1]
                    if esc in ("%", "_"):
                        # \% and \_ keep the backslash: they are LIKE-pattern
                        # escapes resolved at match time, not string escapes
                        # (ref: MySQL string-literal rules for \% \_)
                        buf.append("\\" + esc)
                    else:
                        buf.append({"n": "\n", "t": "\t", "r": "\r", "0": "\0", "\\": "\\", q: q}.get(esc, esc))
                    j += 2
                    continue
                if ch == q:
                    if j + 1 < n and sql[j + 1] == q:  # doubled quote
                        buf.append(q)
                        j += 2
                        continue
                    break
                buf.append(ch)
                j += 1
            if j >= n:
                raise LexError("unterminated string", i)
            toks.append(Token("str", "".join(buf), i))
            i = j + 1
            continue
        # backquoted identifier
        if c == "`":
            j = sql.find("`", i + 1)
            if j < 0:
                raise LexError("unterminated identifier", i)
            toks.append(Token("qident", sql[i + 1 : j], i))
            i = j + 1
            continue
        # numbers
        if c.isdigit() or (c == "." and i + 1 < n and sql[i + 1].isdigit()):
            j = i
            isfloat = False
            if sql.startswith("0x", i) or sql.startswith("0X", i):
                j = i + 2
                while j < n and sql[j] in "0123456789abcdefABCDEF":
                    j += 1
                toks.append(Token("int", str(int(sql[i:j], 16)), i))
                i = j
                continue
            while j < n and sql[j].isdigit():
                j += 1
            if j < n and sql[j] == ".":
                isfloat = True
                j += 1
                while j < n and sql[j].isdigit():
                    j += 1
            if j < n and sql[j] in "eE":
                k = j + 1
                if k < n and sql[k] in "+-":
                    k += 1
                if k < n and sql[k].isdigit():
                    isfloat = True
                    j = k
                    while j < n and sql[j].isdigit():
                        j += 1
            toks.append(Token("float" if isfloat else "int", sql[i:j], i))
            i = j
            continue
        # identifiers / keywords
        if c.isalpha() or c == "_" or c == "$":
            j = i
            while j < n and (sql[j].isalnum() or sql[j] in "_$"):
                j += 1
            toks.append(Token("ident", sql[i:j], i))
            i = j
            continue
        # operators
        for op in _OPS:
            if sql.startswith(op, i):
                toks.append(Token("op", op, i))
                i += len(op)
                break
        else:
            raise LexError(f"unexpected character {c!r}", i)
    toks.append(Token("eof", "", n))
    return toks
