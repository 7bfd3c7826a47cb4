"""Session layer: parse → plan → execute, txn lifecycle, sysvars.

Reference parity: pkg/session (ExecuteStmt session.go:2022, LazyTxn),
pkg/sessionctx/variable (sysvars). ``tidb_tpu.open()`` returns a DB handle
that hands out sessions sharing one embedded store + catalog — the testkit
CreateMockStore analog (SURVEY §4.2).
"""

from tidb_tpu_torch.session.session import DB, Session, Result, open_db

__all__ = ["DB", "Session", "Result", "open_db"]
