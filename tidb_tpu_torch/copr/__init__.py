"""Coprocessor layer: the engine seam.

Reference parity: pkg/store/copr (client: coprocessor.go) + the server-side
handlers it talks to (unistore cophandler for TiKV-semantics, TiFlash for
columnar). Here both "sides" live in-process:

- ``client.CopClient`` splits key ranges by region, fans tasks out to a
  worker pool, and streams results back (ref: copr/coprocessor.go:334
  buildCopTasks, :684 copIterator).
- ``ENGINES`` maps kv.StoreType → a handler executing a DAG over one
  region's columns: ``host_engine`` (numpy; the unistore-closure-exec
  analog and correctness oracle) and ``tpu_engine`` (jitted XLA kernels;
  the TiFlash analog).
"""

from tidb_tpu_torch.copr import dagpb
from tidb_tpu_torch.copr.client import CopClient, CopResult

__all__ = ["CopClient", "CopResult", "dagpb"]
