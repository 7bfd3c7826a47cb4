"""Bootable server process: ``python -m tidb_tpu_torch [--device D] [flags]``.

Reference parity: `cmd/tidb-server/main.go:262` — config + flags, store
registration, wire server, status server, clean signal shutdown. Two roles:

- SQL server (default): MySQL wire protocol on ``--port``, HTTP status on
  ``--status-port``; storage is an embedded store or a remote StoreServer
  (``--store remote --path host:port`` — the TiDB-over-TiKV shape).
- ``--store-server``: the storage process — serves KV verbs, coprocessor
  DAGs, and MPP dispatch to SQL-layer processes, and owns the device.

Both roles print ``ready port=N [status=M]`` once listening (port 0 binds an
ephemeral port; orchestration reads the line).
"""

from __future__ import annotations

import signal
import sys
import threading


def main(argv=None) -> int:
    import argparse

    from tidb_tpu_torch.config import load

    # ``--device cuda|cuda:N|cpu`` (default cuda): where the gpu engine of
    # this process runs — the store's cop tasks and MPP fragments in the
    # storage role, the root window and the fleet's hybrid gather in the SQL
    # role. With no card a cuda process raises at its first device task.
    dp = argparse.ArgumentParser(add_help=False)
    dp.add_argument("--device", default="cuda")
    dargs, argv = dp.parse_known_args(sys.argv[1:] if argv is None else argv)
    device = dargs.device
    cfg, args = load(argv)
    stop = threading.Event()
    for sig in (signal.SIGINT, signal.SIGTERM):
        try:
            signal.signal(sig, lambda *_: stop.set())
        except ValueError:
            pass  # non-main thread (embedded use)

    if getattr(args, "store_server", False):
        from tidb_tpu_torch.kv.remote import StoreServer

        if getattr(args, "raw_store", False):
            # store-fleet member: an empty store, no embedded SQL bootstrap —
            # the connecting SQL layer owns meta (replicated per shard by
            # kv/sharded.py when the fleet has >1 member)
            from tidb_tpu_torch.kv.memstore import MemStore

            backing = MemStore(region_split_keys=cfg.region_split_keys)
            backing.device = device
        else:
            import tidb_tpu_torch

            backing = tidb_tpu_torch.open(region_split_keys=cfg.region_split_keys, device=device).store
        srv = StoreServer(backing, host=cfg.host, port=cfg.port)
        port = srv.start()
        print(f"ready port={port}", flush=True)
        stop.wait()
        srv.shutdown()
        return 0

    import tidb_tpu_torch
    from tidb_tpu_torch.server import Server
    from tidb_tpu_torch.server.status import StatusServer

    if cfg.store == "remote":
        if not cfg.store_path:
            print("--store remote requires --path host:port", file=sys.stderr)
            return 2
        db = tidb_tpu_torch.open(remote=cfg.store_path, device=device)
    else:
        db = tidb_tpu_torch.open(region_split_keys=cfg.region_split_keys, device=device)
    for k, v in cfg.sysvars.items():
        db.global_vars[k] = v

    # in-process metrics history: default ON for a bootable server (the
    # [observability] metrics-history-* knobs size it; interval <= 0 disables)
    from tidb_tpu_torch.utils.metricshist import recorder

    recorder().start()

    server = Server(db, host=cfg.host, port=cfg.port, tls=cfg.ssl_enabled)
    port = server.start()
    status_port = None
    status = None
    if cfg.status_enabled:
        status = StatusServer(db, host=cfg.host, port=cfg.status_port)
        status_port = status.start()
    extra = f" status={status_port}" if status_port is not None else ""
    print(f"ready port={port}{extra}", flush=True)
    stop.wait()
    server.close()
    if status is not None:
        try:
            status.close()
        except OSError:
            pass  # shutdown: the status socket may already be torn down
    recorder().stop()
    return 0

if __name__ == "__main__":
    sys.exit(main())
