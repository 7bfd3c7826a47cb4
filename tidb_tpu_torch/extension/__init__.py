"""Extension points (ref: pkg/extension + pkg/plugin — audit/auth plugin
hooks): extensions register callbacks observing connection and statement
events; the bundled AuditLogger is both the sample extension and the audit
log implementation."""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Optional


@dataclass
class StmtEvent:
    time: float
    user: str
    db: str
    sql: str
    event: str  # "ok" | "error"
    error: str = ""
    duration_s: float = 0.0


@dataclass
class ConnEvent:
    time: float
    event: str  # "connected" | "rejected" | "disconnected"
    user: str
    host: str
    conn_id: int


class Extension:
    """Subclass and override the hooks you need (ref: extension.Manifest)."""

    name = "extension"

    def on_stmt_event(self, ev: StmtEvent) -> None:  # pragma: no cover
        pass

    def on_connection_event(self, ev: ConnEvent) -> None:  # pragma: no cover
        pass


class ExtensionRegistry:
    def __init__(self):
        self._exts: list[Extension] = []

    def register(self, ext: Extension) -> None:
        self._exts.append(ext)

    @property
    def have(self) -> bool:
        return bool(self._exts)

    def list(self) -> list[Extension]:
        return list(self._exts)

    def notify_stmt(self, ev: StmtEvent) -> None:
        for e in self._exts:
            try:
                e.on_stmt_event(ev)
            except Exception:
                _hook_error(e, "stmt")  # extensions never break queries

    def notify_conn(self, ev: ConnEvent) -> None:
        for e in self._exts:
            try:
                e.on_connection_event(ev)
            except Exception:
                _hook_error(e, "conn")


def _hook_error(ext: "Extension", hook: str) -> None:
    """A broken extension must not break queries, but its failures must be
    visible AND attributable: count per (extension, hook) so /metrics names
    the misbehaving plugin instead of it failing silently forever. (Label
    cardinality is the registered-extension set — bounded per process.)"""
    from tidb_tpu_torch.utils import metrics as _m

    _m.EXT_HOOK_ERRORS.inc(ext=getattr(ext, "name", type(ext).__name__), hook=hook)


class AuditLogger(Extension):
    """Audit extension (ref: the enterprise audit plugin surface): ring of
    statement + connection events."""

    name = "audit_log"

    def __init__(self, capacity: int = 1024):
        from collections import deque

        self.stmt_log: "deque[StmtEvent]" = deque(maxlen=capacity)
        self.conn_log: "deque[ConnEvent]" = deque(maxlen=capacity)

    def on_stmt_event(self, ev: StmtEvent) -> None:
        self.stmt_log.append(ev)

    def on_connection_event(self, ev: ConnEvent) -> None:
        self.conn_log.append(ev)
