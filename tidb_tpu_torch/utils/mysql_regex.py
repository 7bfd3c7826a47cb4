"""MySQL/ICU regular-expression dialect → Python ``re`` translation.

Reference parity: pkg/expression/builtin_regexp.go (ICU under the hood since
MySQL 8.0). The dialect differences that matter in practice:

- POSIX bracket classes inside character classes: ``[[:alpha:]]``,
  ``[[:digit:]]``, ``[[:space:]]``, ... (ICU and the old Henry Spencer
  engine both accept these; Python ``re`` does not).
- Word-boundary markers ``[[:<:]]`` / ``[[:>:]]`` (legacy MySQL syntax,
  still accepted by MySQL 8 which rewrites them to ``\\b{w}``).

Everything else Python ``re`` shares with ICU closely enough for the
supported surface (alternation, groups, greedy/lazy quantifiers, anchors,
escapes); genuinely ICU-only syntax still raises MySQL error 3685 through
``re.error`` at compile time.
"""

from __future__ import annotations

import re as _re

# Python equivalents of the POSIX classes, for use INSIDE a character class
_CLASS_MAP = {
    "alnum": r"0-9A-Za-z",
    "alpha": r"A-Za-z",
    "blank": r" \t",
    "cntrl": r"\x00-\x1f\x7f",
    "digit": r"0-9",
    "graph": r"\x21-\x7e",
    "lower": r"a-z",
    "print": r"\x20-\x7e",
    "punct": r"!-/:-@\[-`{-~",
    "space": r"\s",
    "upper": r"A-Z",
    "xdigit": r"0-9A-Fa-f",
    "word": r"0-9A-Za-z_",
}


def translate(pattern: str) -> str:
    """MySQL regexp dialect → Python re pattern."""
    out = []
    i = 0
    n = len(pattern)
    while i < n:
        ch = pattern[i]
        if ch == "\\" and i + 1 < n:
            out.append(pattern[i : i + 2])
            i += 2
            continue
        if pattern.startswith("[[:<:]]", i):
            out.append(r"\b(?=\w)")
            i += 7
            continue
        if pattern.startswith("[[:>:]]", i):
            out.append(r"\b(?<=\w)")
            i += 7
            continue
        if ch == "[":
            # character class: scan to its closing ], expanding [:name:]
            j = i + 1
            cls = ["["]
            if j < n and pattern[j] == "^":
                cls.append("^")
                j += 1
            if j < n and pattern[j] == "]":  # leading ] is a literal
                cls.append(r"\]")
                j += 1
            while j < n and pattern[j] != "]":
                if pattern[j] == "[" and pattern.startswith("[:", j):
                    k = pattern.find(":]", j + 2)
                    if k == -1:
                        raise ValueError("Invalid regular expression: unterminated [: :]")
                    name = pattern[j + 2 : k]
                    body = _CLASS_MAP.get(name)
                    if body is None:
                        raise ValueError(f"Invalid regular expression: unknown class [:{name}:]")
                    cls.append(body)
                    j = k + 2
                elif pattern[j] == "\\" and j + 1 < n:
                    cls.append(pattern[j : j + 2])
                    j += 2
                else:
                    cls.append(pattern[j])
                    j += 1
            if j >= n:
                raise ValueError("Invalid regular expression: unterminated [")
            cls.append("]")
            out.append("".join(cls))
            i = j + 1
            continue
        out.append(ch)
        i += 1
    return "".join(out)


def compile(pattern: str, flags: int = 0):
    """Translate + compile; re.error maps to MySQL's 3685 at the caller."""
    return _re.compile(translate(pattern), flags)
