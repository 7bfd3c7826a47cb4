"""The fragment program's mesh: ``ndev`` virtual shards on one device.

The reference runs its fragment program as one ``shard_map`` over a 1-D
device mesh (axis ``dp``), one table shard per TPU chip. Here the shards
are virtual: every fragment tensor carries a leading shard axis,
``[ndev, rows_per_shard]``, on the one card (or the CPU), and the three
collectives of the mesh axis become tensor ops over that axis:

- ``all_to_all``: shard ``s`` sends block ``d`` of its ``[ndev, cap]``
  buffer to shard ``d``, which concatenates the blocks in source order;
- ``all_gather``: every shard sees every shard's lane, concatenated;
- ``psum``: every shard sees the sum over the shards.

Each shard's work is written once over the shard axis, so a width of 1
runs the same code as a width of 4.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch

_MESH_CACHE: dict = {}
_DEVICE_CACHE: dict = {}

# forced mesh width: the ndev-parity tests and chip_smoke.py pin the same
# process to 1 or 4 virtual shards (None = one shard per device)
FORCE_NDEV: Optional[int] = None


class VirtualMesh:
    """``ndev`` shards of one fragment program, all on ``device``.
    ``devices`` holds one entry per shard (``devices.size`` is the mesh
    width, as on the reference's ``Mesh``)."""

    def __init__(self, device: torch.device, ndev: int):
        self.device = device
        self.devices = np.array([device] * ndev, dtype=object)


def available_devices(device=None) -> list:
    """The devices a mesh may use, as stable objects (the prober keys a
    device by its identity): ``device`` alone when given, else every CUDA
    device, else the CPU."""
    if device is not None:
        want = [torch.device(device)]
    elif torch.cuda.is_available():
        want = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    else:
        want = [torch.device("cpu")]
    return [_DEVICE_CACHE.setdefault(str(d), d) for d in want]


def make_mesh(n_devices: Optional[int] = None, devices: Optional[Sequence] = None) -> VirtualMesh:
    """A mesh of ``n_devices`` virtual shards (else ``FORCE_NDEV``, else one
    per device) on the first of ``devices`` (else of
    :func:`available_devices`). A mesh over several CUDA devices with NCCL
    collectives is not built: every shard lives on one device."""
    devs = list(devices) if devices is not None else available_devices()
    if not devs:
        raise RuntimeError("mesh wants at least one device")
    ndev = n_devices if n_devices is not None else (FORCE_NDEV if FORCE_NDEV is not None else len(devs))
    if ndev < 1:
        raise ValueError(f"mesh width must be positive, got {ndev}")
    # one mesh object per (device, width): the program cache keys on the
    # mesh's identity, as the reference's compiled programs do
    key = (str(devs[0]), ndev)
    mesh = _MESH_CACHE.get(key)
    if mesh is None:
        mesh = _MESH_CACHE.setdefault(key, VirtualMesh(devs[0], ndev))
    return mesh


def all_to_all(x: torch.Tensor, ndev: int) -> torch.Tensor:
    """``[ndev (source), ndev * cap]`` send buffers, block ``d`` of each row
    bound for shard ``d`` → ``[ndev (dest), ndev * cap]`` receive buffers,
    the blocks in source order."""
    cap = x.shape[-1] // ndev
    return x.reshape(ndev, ndev, cap).transpose(0, 1).reshape(ndev, ndev * cap)


def all_gather(x: torch.Tensor) -> torch.Tensor:
    """``[ndev, m]`` → every shard's ``[ndev * m]``, concatenated in shard
    order, the same on every shard."""
    ndev = x.shape[0]
    return x.reshape(1, -1).expand(ndev, -1)


def psum(x: torch.Tensor) -> torch.Tensor:
    """``[ndev, ...]`` → the sum over the shards, the same on every shard."""
    return x.sum(dim=0, keepdim=True).expand_as(x)
