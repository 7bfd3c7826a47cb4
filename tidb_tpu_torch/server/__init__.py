"""MySQL wire-protocol server (ref: pkg/server — conn.go clientConn.Run,
the text protocol subset: handshake v10, COM_QUERY/INIT_DB/PING/QUIT)."""

from tidb_tpu_torch.server.server import Server
from tidb_tpu_torch.server.client import Client

__all__ = ["Server", "Client"]
