"""Collation weight framework (ref: pkg/util/collate/collate.go — the
Collator/WeightString surface; general_ci weights per
pkg/util/collate/general_ci.go).

utf8mb4_general_ci assigns every codepoint a single weight: the uppercase of
its base letter — accents strip ('é' ≡ 'E'), case folds ('a' ≡ 'A'), and
sharp s maps to 'S' (general_ci is a per-character collation, unlike
unicode_ci's full UCA where 'ß' ≡ 'ss'). Comparing weight strings gives both
equality classes and ordering, so one transform serves =, <, GROUP BY,
ORDER BY, FIELD, and LIKE.

The transform is pure per-codepoint → cached in a translation table; the
device path keeps using dictionary codes, re-ranked through these weights by
the host when a ci comparison forces it.
"""

from __future__ import annotations

import unicodedata
from functools import lru_cache


@lru_cache(maxsize=None)
def _weight_char(ch: str) -> str:
    # decompose, strip combining marks (accent folding), uppercase
    base = "".join(c for c in unicodedata.normalize("NFD", ch) if not unicodedata.combining(c))
    if not base:
        base = ch
    up = base.upper()
    # Python upper() expands ß→SS; general_ci is single-weight per char
    if ch in ("ß", "ẞ"):
        return "S"
    return up[:1] if len(up) > 1 else up


def weight_str(s: str, collation: str = "ci") -> str:
    """Weight string under the collation ('ci' = general_ci semantics;
    anything else is binary identity)."""
    if collation != "ci":
        return s
    return "".join(_weight_char(c) for c in s)


def weight_bytes(b: bytes, collation: str = "ci") -> bytes:
    if collation != "ci":
        return b
    return weight_str(b.decode("utf-8", "surrogateescape")).encode("utf-8", "surrogateescape")


def equal(a: bytes, b: bytes, collation: str = "ci") -> bool:
    return weight_bytes(a, collation) == weight_bytes(b, collation)


def canon_codes(data, validity, dictionary):
    """Map dictionary codes to a per-weight-class representative CODE so
    equality on the result is general_ci equality ('a' ≡ 'A' ≡ 'á').
    Invalid rows may carry garbage codes (computed expressions) — they are
    masked to 0 before decoding and are meaningless afterwards anyway
    (callers carry validity in a separate lane). The shared implementation
    for GROUP BY, DISTINCT, distinct-agg, and partial-merge keys."""
    import numpy as np

    safe = np.where(np.asarray(validity, dtype=bool), data, 0)
    vals = dictionary.decode_many(safe)
    rep: dict[bytes, int] = {}
    out = np.empty(len(vals), dtype=np.int64)
    for i, v in enumerate(vals):
        out[i] = rep.setdefault(weight_bytes(v), int(safe[i]))
    return out


def is_ci_string(col) -> bool:
    """Does this chunk Column need weight-class canonicalization?"""
    from tidb_tpu_torch.types import TypeKind

    return (
        col.ftype.kind == TypeKind.STRING
        and col.ftype.collation == "ci"
        and col.dictionary is not None
    )
