"""graftfuzz oracles: result canonicalization and the three comparison rules.

1. **differential** (engine isolation ``tpu`` vs ``host``): the host engine
   is the executable specification — any canonicalized mismatch is a device
   bug (or a host bug; oracle 2 arbitrates).
2. **metamorphic TLP** (Rigger & Su, Ternary Logic Partitioning): for a
   non-aggregate query ``Q`` and any predicate ``p``, ``Q`` must equal the
   multiset union ``Q WHERE p`` ∪ ``Q WHERE NOT (p)`` ∪ ``Q WHERE (p) IS
   NULL``. Runs on each engine separately, so the host oracle itself is
   cross-checked without a second implementation.
3. **freshness**: after a committed DML round (and again after the delta
   merge), the differential oracle re-runs — the base⊕delta device path and
   the merged path must both still agree with host.

Canonicalization: rows become tuples of canonical scalars (floats rounded
to 9 significant digits — device reductions may legally reassociate;
decimals normalized; bytes decoded). Ordered comparison only when the query
has a top-level ORDER BY: the device engines deliberately preserve host
scan order for ties (PR 10's merged-handle-rank), so tie order is part of
the contract being fuzzed, not noise.
"""

from __future__ import annotations

import decimal
from dataclasses import dataclass, field


def canon_scalar(v):
    if v is None:
        return None
    if isinstance(v, bool):
        return int(v)
    if isinstance(v, int):
        return v
    if isinstance(v, float):
        if v != v:
            return "NaN"
        if v in (float("inf"), float("-inf")):
            return repr(v)
        return float(f"{v:.9g}")
    if isinstance(v, decimal.Decimal):
        return format(v.normalize(), "f")
    if isinstance(v, (bytes, bytearray)):
        return bytes(v).decode("utf-8", "replace")
    try:  # numpy scalars without importing numpy here
        import numpy as np

        if isinstance(v, np.integer):
            return int(v)
        if isinstance(v, np.floating):
            return canon_scalar(float(v))
    except ImportError:  # pragma: no cover - numpy is a hard dep elsewhere
        pass
    return str(v)


def canon_rows(rows, ordered: bool):
    out = [tuple(canon_scalar(v) for v in r) for r in rows]
    if not ordered:
        out.sort(key=repr)
    return out


@dataclass
class RunOutcome:
    rows: list = field(default_factory=list)
    error: str = ""  # "ExcType: msg" when the query raised

    @property
    def ok(self) -> bool:
        return not self.error


def run_query(session, sql: str) -> RunOutcome:
    try:
        return RunOutcome(rows=session.query(sql))
    except Exception as e:  # the oracle compares errors too
        return RunOutcome(error=f"{type(e).__name__}: {e}")


def _err_kind(err: str) -> str:
    return err.split(":", 1)[0]


@dataclass
class Divergence:
    oracle: str  # differential / tlp / freshness
    phase: str  # cold / fresh / merged
    query: str
    detail: str
    engine: str = ""  # tlp: which engine diverged

    def to_pb(self) -> dict:
        d = {"oracle": self.oracle, "phase": self.phase, "query": self.query, "detail": self.detail}
        if self.engine:
            d["engine"] = self.engine
        return d


def _fmt_rows(rows, limit: int = 12) -> str:
    s = "; ".join(repr(r) for r in rows[:limit])
    if len(rows) > limit:
        s += f"; ... ({len(rows)} rows)"
    return s


def _ci_weight(v):
    """general_ci weight key for a canonical scalar (strings only)."""
    if isinstance(v, str):
        from tidb_tpu_torch.utils.collate import weight_str

        return weight_str(v, "ci")
    return v


def _fold_ci(rows, positions, free=frozenset()):
    return [
        tuple(
            "\x00any" if i in free else (_ci_weight(v) if i in positions else v)
            for i, v in enumerate(r)
        )
        for r in rows
    ]


def compare_differential(
    sql: str,
    ordered: bool,
    device: RunOutcome,
    host: RunOutcome,
    oracle: str,
    phase: str,
    ci_lax_positions=(),
    ci_free_positions=(),
):
    """None when the engines agree; a Divergence otherwise. Errors count:
    identical error *types* on both engines agree (the statement is simply
    invalid / unsupported); a one-sided error is a divergence.

    ``ci_lax_positions``: output positions that are grouped-query
    representatives of ci-collated columns. MySQL lets a group's
    representative be ANY member of the general_ci weight class, and the
    two engines legitimately pick different members (host: first in scan
    order; device: first in partial-merge order — see the triage entry in
    STATIC_ANALYSIS.md). On a strict mismatch those positions re-compare by
    weight class, unordered (a representative may also steer ORDER BY), so
    only genuine membership/aggregate differences survive as findings."""
    if device.error or host.error:
        if _err_kind(device.error) == _err_kind(host.error):
            return None
        return Divergence(
            oracle,
            phase,
            sql,
            f"device={device.error or 'ok'} host={host.error or 'ok'}",
        )
    a = canon_rows(device.rows, ordered)
    b = canon_rows(host.rows, ordered)
    if a == b:
        return None
    if ci_lax_positions or ci_free_positions:
        fold, free = set(ci_lax_positions), frozenset(ci_free_positions)
        af = sorted(_fold_ci(a, fold, free), key=repr)
        bf = sorted(_fold_ci(b, fold, free), key=repr)
        if af == bf:
            return None
    return Divergence(oracle, phase, sql, f"device=[{_fmt_rows(a)}] host=[{_fmt_rows(b)}]")


def compare_tlp(sql: str, whole: RunOutcome, parts: list, pred: str, engine: str, phase: str):
    """``whole`` vs the multiset union of the three partitions, one engine."""
    outcomes = [whole] + parts
    errs = {_err_kind(o.error) for o in outcomes}
    if errs != {""}:
        if len(errs) == 1:
            return None  # everything failed the same way: not a logic bug
        return Divergence(
            "tlp", phase, sql, f"partition errors differ: {[o.error or 'ok' for o in outcomes]}", engine
        )
    a = canon_rows(whole.rows, ordered=False)
    union = canon_rows([r for p in parts for r in p.rows], ordered=False)
    if a != union:
        return Divergence(
            "tlp",
            phase,
            sql,
            f"pred=({pred}) whole=[{_fmt_rows(a)}] union=[{_fmt_rows(union)}]",
            engine,
        )
    return None
