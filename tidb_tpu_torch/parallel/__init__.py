"""Distributed execution over a mesh of devices.

Reference parity: the MPP engine — fragment cutting at exchange boundaries
(pkg/planner/core/fragment.go), exchange types Hash/Broadcast/PassThrough
(tipb.ExchangeType), executed by exchange senders/receivers (unistore
cophandler/mpp_exec.go:609 exchSenderExec streaming to peer tasks).

Mapping onto CUDA devices (``mesh.py``):
- one table shard per mesh entry; the entries of one device form a slab
  (the leading axis of every fragment tensor), run by one worker thread
  with its own stream; a store on ``cuda`` meshes one shard per card, one
  card keeps virtual shards, and logical devices on one card (or the CPU)
  are distinct workers;
- Hash exchange   → ``Slab.all_to_all`` on hash-bucketed rows/groups;
- Broadcast       → ``Slab.all_gather``;
- PassThrough     → gather-to-root (each worker's outputs copied off its
  device once, concatenated in shard order);
- scalar merges   → ``Slab.psum``.

Across workers the collectives are peer copies ordered by CUDA events
(NVLink where the cards reach each other). The coordinator stays host-side
Python (ref: local_mpp_coordinator.go); the fragment program is torch ops
on each worker's device.
"""

from tidb_tpu_torch.parallel.mesh import make_mesh

__all__ = ["make_mesh"]
