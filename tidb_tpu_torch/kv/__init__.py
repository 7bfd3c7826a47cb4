"""Engine-neutral KV contracts.

Reference parity: pkg/kv (kv.go:316 Client, kv.go:533 Request, kv.go:353
StoreType, kv.go:648 Response; mpp.go MPP contracts). The rebuild keeps the
same seam: the planner/executor speak ``Request``/``Response`` and an engine
registry; which silicon executes a DAG fragment is a late-bound config choice.
"""

from tidb_tpu_torch.kv.kv import (
    Client,
    KeyRange,
    Request,
    RequestType,
    Response,
    StoreType,
    Storage,
    TimestampOracle,
)

__all__ = [
    "Client",
    "KeyRange",
    "Request",
    "RequestType",
    "Response",
    "StoreType",
    "Storage",
    "TimestampOracle",
]
