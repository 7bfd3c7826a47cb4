"""Distributed execution over a mesh of virtual shards.

Reference parity: the MPP engine — fragment cutting at exchange boundaries
(pkg/planner/core/fragment.go), exchange types Hash/Broadcast/PassThrough
(tipb.ExchangeType), executed by exchange senders/receivers (unistore
cophandler/mpp_exec.go:609 exchSenderExec streaming to peer tasks).

Mapping onto one card (``mesh.py``):
- one table shard per virtual shard, the leading axis of every fragment
  tensor;
- Hash exchange   → ``mesh.all_to_all`` on hash-bucketed rows/groups;
- Broadcast       → ``mesh.all_gather``;
- PassThrough     → gather-to-root (all_gather + root read);
- scalar merges   → ``mesh.psum``.

The coordinator stays host-side Python (ref: local_mpp_coordinator.go); the
fragment program is torch ops on the session's device.
"""

from tidb_tpu_torch.parallel.mesh import make_mesh

__all__ = ["make_mesh"]
