"""The fragment program's mesh: shards on devices, one worker per device.

The reference runs its fragment program as one ``shard_map`` over a 1-D
mesh of every device (axis ``dp``), one table shard per TPU chip, its
exchanges riding the interconnect. Here:

- ``mesh.devices`` holds one entry per shard (``devices.size`` is the
  width, as on the reference's ``Mesh``); an entry is a
  :class:`DeviceHandle`, a small object around a ``torch.device``;
- shards whose entries are the same handle form one *slab*, a leading
  shard axis ``[k, rows]`` on that device, run by one worker: a mesh of
  one handle ``k`` times is ``k`` virtual shards on one card;
- distinct handles are distinct workers, each a thread under its device
  with its own CUDA stream (``torch.nn.parallel.parallel_apply``'s rule),
  even when two handles wrap one physical device: four *logical devices*
  on one card or on the CPU run the whole cross-worker path;
- the three collectives of the mesh axis (:class:`Slab`):

  - ``all_to_all``: shard ``s`` sends block ``d`` of its ``[ndev, cap]``
    buffer to shard ``d``, which concatenates the blocks in source order;
  - ``all_gather``: every shard sees every shard's lane, concatenated;
  - ``psum``: every shard sees the sum over the shards, in shard order.

  Inside a slab they are tensor ops over the shard axis (the module
  functions below). Across workers a rendezvous carries them: each worker
  records an event on its stream after writing its send blocks, the
  receiver's stream waits on it, and the blocks move with
  ``Tensor.to(dst, non_blocking=True)`` (peer copies between cards). The
  received blocks are concatenated in shard order, so every layout gives
  the same bits.

The workers take turns at the exchanges (one worker's Python at a time;
their streams run together). A worker that raises aborts the rendezvous:
the others leave their next exchange with an error, and one that never
arrives fails the rest after ``RENDEZVOUS_TIMEOUT_S``. The program is
single-controller, as the reference's is: one process drives every
device, so the gather's coordinator, program cache and device-loss retry
stay in one place.
"""

from __future__ import annotations

import threading
import time
from typing import Optional, Sequence

import numpy as np
import torch

_MESH_CACHE: dict = {}
_DEVICE_CACHE: dict = {}
_STREAMS: dict = {}

# forced mesh width, as the reference's: the ndev-parity tests and
# chip_smoke.py pin the same process to 1 or 4 shards. Over several
# devices it cuts the device list; over one device it is that many
# virtual shards (None = one shard per device)
FORCE_NDEV: Optional[int] = None

# the device list a mesh draws from in place of the machine's (None = the
# machine's): logical devices for the tests and chip_smoke.py
FORCE_DEVICES: Optional[list] = None

# how long a worker waits at an exchange for the others
RENDEZVOUS_TIMEOUT_S = 120.0


class DeviceHandle:
    """One device of a mesh: ``device`` is the physical torch device,
    ``name`` tells logical devices on it apart. Handles are stable for the
    process's life (the prober and the mesh cache key on identity)."""

    __slots__ = ("device", "name")

    def __init__(self, device: torch.device, name: str):
        self.device = device
        self.name = name

    def __str__(self) -> str:
        return str(self.device)

    def __repr__(self) -> str:
        return f"DeviceHandle({self.name})"


def handle(device) -> DeviceHandle:
    """The stable handle of a physical device (a handle passes through)."""
    if isinstance(device, DeviceHandle):
        return device
    d = torch.device(device)
    if d.type == "cuda" and d.index is None:
        d = torch.device("cuda", torch.cuda.current_device())
    return _DEVICE_CACHE.setdefault(str(d), DeviceHandle(d, str(d)))


def logical_devices(device, n: int) -> list:
    """``n`` distinct logical devices on one physical ``device``: each is
    its own worker with its own stream."""
    d = handle(device).device
    return [_DEVICE_CACHE.setdefault(f"{d}#{i}", DeviceHandle(d, f"{d}#{i}")) for i in range(n)]


def available_devices(device=None) -> list:
    """The devices an MPP mesh may use, as stable handles:
    ``FORCE_DEVICES`` when set; else for a CUDA ``device`` with no index
    (or no ``device`` and a card present) every visible card, for
    ``cuda:N`` that card alone, for the CPU the CPU."""
    if FORCE_DEVICES is not None:
        return list(FORCE_DEVICES)
    if device is None:
        device = "cuda" if torch.cuda.is_available() else "cpu"
    d = torch.device(device)
    if d.type == "cuda" and d.index is None:
        return [handle(torch.device("cuda", i)) for i in range(torch.cuda.device_count())]
    return [handle(d)]


class DeviceMesh:
    """``devices``: one handle per shard. ``workers``: (handle, first
    shard, k) per slab, in shard order; ``device`` is the first worker's
    device. ``moved[w]``: bytes worker ``w`` has handed to the other
    workers over the mesh's life."""

    def __init__(self, entries: Sequence[DeviceHandle]):
        self.devices = np.empty(len(entries), dtype=object)
        self.devices[:] = list(entries)
        workers: list = []
        for i, h in enumerate(entries):
            if workers and workers[-1][0] is h:
                workers[-1][2] += 1
            elif any(w[0] is h for w in workers):
                raise ValueError(f"mesh: the shards of {h!r} are not contiguous")
            else:
                workers.append([h, i, 1])
        self.workers = [tuple(w) for w in workers]
        self.device = self.workers[0][0].device
        self.placement = tuple((h.name, k) for h, _f, k in self.workers)
        self.moved = [0] * len(self.workers)

    def place(self, a: np.ndarray):
        """One padded host lane (shard ``s`` at rows ``[s * per, (s + 1) *
        per)``) on the mesh: a tensor on a one-worker mesh, else one part
        per worker, on its device."""
        a = np.ascontiguousarray(a)
        if len(self.workers) == 1:
            return torch.from_numpy(a).to(self.device)
        per = len(a) // self.devices.size
        return tuple(torch.from_numpy(a[f * per : (f + k) * per]).to(h.device) for h, f, k in self.workers)

    def _parts(self, c):
        if isinstance(c, (tuple, list)):
            return c
        rows = c.reshape(self.devices.size, -1)
        return tuple(rows[f : f + k].to(h.device) for h, f, k in self.workers)

    def run(self, body, cols, walls: Optional[list] = None) -> list:
        """``body(slab, *local lanes)`` once per worker over its ``[k,
        rows]`` slab of each lane of ``cols`` (a placed lane, or a whole
        tensor to split) → the workers' results, in shard order.
        ``walls`` gets (first shard, k, timer) per worker: its stream's
        time over the body (``timer.ms``, valid once the results are
        read). One worker runs on the calling thread; several run one
        thread each, taking turns, and a worker's ``RuntimeError`` is
        re-raised carrying ``mpp_device``, that worker's handle."""
        ndev = self.devices.size
        if len(self.workers) == 1:
            h, _f, k = self.workers[0]
            local = [(c[0] if isinstance(c, (tuple, list)) else c).reshape(k, -1) for c in cols]
            timer = _Wall(h.device)
            out = body(Slab(ndev, 0, k, h.device), *local)
            timer.stop()
            if walls is not None:
                walls.append((0, k, timer))
            return [out]
        parts = [self._parts(c) for c in cols]
        rdv = _Rendezvous(self, RENDEZVOUS_TIMEOUT_S)
        W = len(self.workers)
        results: list = [None] * W
        timers: list = [None] * W
        streams = [_stream(h) for h, _f, _k in self.workers]
        for (h, _f, _k), s in zip(self.workers, streams):
            if s is not None:
                # the lanes were placed on the caller's stream
                s.wait_stream(torch.cuda.current_stream(h.device))

        def work(w):
            h, f, k = self.workers[w]
            try:
                rdv.wait_turn(w)
                # the worker's device and stream (a no-op on the CPU)
                with torch.cuda.stream(streams[w]):
                    timer = _Wall(h.device)
                    out = body(Slab(ndev, f, k, h.device, rdv, w), *[p[w].reshape(k, -1) for p in parts])
                    timer.stop()
                results[w], timers[w] = out, timer
                rdv.pass_turn(w, done=True)
            except BaseException as exc:  # noqa: BLE001 — handed to the caller
                rdv.fail(w, exc)

        threads = [
            threading.Thread(target=work, args=(w,), name=f"mpp-worker-{w}", daemon=True) for w in range(W)
        ]
        for t in threads:
            t.start()
        broken_at = None
        for t in threads:
            while t.is_alive():
                t.join(0.05)
                if rdv.aborted:
                    broken_at = broken_at or time.monotonic()
                    if time.monotonic() - broken_at > rdv.timeout:
                        break  # a worker that never returns is left to the prober
        for (h, _f, _k), s in zip(self.workers, streams):
            if s is not None:
                torch.cuda.current_stream(h.device).wait_stream(s)
        if rdv.error is not None:
            w, exc = rdv.error
            if isinstance(exc, RuntimeError) and getattr(exc, "mpp_device", None) is None:
                exc.mpp_device = self.workers[w][0]
            raise exc
        late = [w for w in range(W) if timers[w] is None]
        if late:
            raise RendezvousTimeout(
                f"mpp workers {late} did not reach the exchange within {rdv.timeout} s"
            )
        if walls is not None:
            walls.extend((f, k, timers[w]) for w, (_h, f, k) in enumerate(self.workers))
        return results


class RendezvousTimeout(RuntimeError):
    """Workers waited past ``RENDEZVOUS_TIMEOUT_S`` at an exchange: no
    device is named, so the gather blames one by probing."""


class _PeerFailed(RuntimeError):
    """This worker's exchange was aborted: another worker failed or timed
    out (the caller re-raises that one)."""


class _Rendezvous:
    """The exchanges of one run. The workers take turns: a baton passes in
    worker order at every exchange, so one worker's Python runs at a time
    (the launches of four threads contending for the interpreter lock cost
    more than they issue) while the workers' streams run on their devices
    together. A worker's blocks are kept per exchange until every worker
    has read them."""

    def __init__(self, mesh: DeviceMesh, timeout: float):
        self.mesh = mesh
        self.timeout = timeout
        self.n = len(mesh.workers)
        self.turn = 0
        self.aborted = False
        self.error = None
        self._done: set = set()
        # one condition per worker over one lock: a pass wakes the next
        # worker alone
        mu = threading.Lock()
        self._cv = [threading.Condition(mu) for _ in range(self.n)]
        self._slots: dict = {}  # exchange number → [(blocks, event)] per worker
        self._reads: dict = {}
        self._gen = [0] * self.n

    def fail(self, w: int, exc: BaseException) -> None:
        with self._cv[w]:
            if self.error is None and not isinstance(exc, _PeerFailed):
                self.error = (w, exc)
            self._abort()
            self._done.add(w)

    def _abort(self) -> None:  # under the lock
        self.aborted = True
        for cv in self._cv:
            cv.notify_all()

    def _next(self, w: int) -> int:
        for i in range(1, self.n + 1):
            v = (w + i) % self.n
            if v not in self._done:
                return v
        return w

    def wait_turn(self, w: int) -> None:
        with self._cv[w]:
            if not self._cv[w].wait_for(lambda: self.turn == w or self.aborted, self.timeout):
                self._abort()
            if self.aborted:
                raise _PeerFailed("mpp exchange aborted")

    def pass_turn(self, w: int, done: bool = False) -> None:
        with self._cv[w]:
            if done:
                self._done.add(w)
            self.turn = self._next(w)
            self._cv[self.turn].notify()

    def exchange(self, w: int, sends: list) -> list:
        """Worker ``w`` hands ``sends[v]`` (a list of tensors) to each
        worker ``v`` → what each worker handed ``w``, in worker order."""
        dev = self.mesh.workers[w][0].device
        ev = None
        if dev.type == "cuda":
            ev = torch.cuda.Event()
            ev.record(torch.cuda.current_stream(dev))
        g = self._gen[w]
        self._gen[w] += 1
        self._slots.setdefault(g, [None] * self.n)[w] = (sends, ev)
        self.mesh.moved[w] += sum(
            x.numel() * x.element_size() for v, xs in enumerate(sends) if v != w for x in xs
        )
        # the baton goes round once: every worker has handed its blocks
        self.pass_turn(w)
        self.wait_turn(w)
        got = []
        for v, (src, ev_v) in enumerate(self._slots[g]):
            got.append(src[w] if v == w else [_receive(x, ev_v, dev) for x in src[w]])
        self._reads[g] = self._reads.get(g, 0) + 1
        if self._reads[g] == self.n:
            del self._slots[g], self._reads[g]
        return got


def _receive(x: torch.Tensor, ev, dst: torch.device) -> torch.Tensor:
    """A block another worker wrote, on ``dst``: this thread's stream on
    the sender's card (the receiver's own on a shared card, else that
    card's current stream, which runs the peer copy) waits on the sender's
    event and keeps the block alive until it has read it."""
    if ev is None:
        return x.to(dst)
    s = torch.cuda.current_stream(x.device)
    s.wait_event(ev)
    x.record_stream(s)
    return x.to(dst, non_blocking=True)


def _stream(h: DeviceHandle):
    """The worker stream of a CUDA handle (None on the CPU)."""
    if h.device.type != "cuda":
        return None
    s = _STREAMS.get(h.name)
    if s is None:
        s = _STREAMS.setdefault(h.name, torch.cuda.Stream(device=h.device))
    return s


class _Wall:
    """A worker's time over its body: CUDA events on its stream, or the
    host clock on the CPU. ``ms`` waits for the end event."""

    def __init__(self, device: torch.device):
        self._device = device
        self._cuda = device.type == "cuda"
        if self._cuda:
            self._a = torch.cuda.Event(enable_timing=True)
            self._a.record(torch.cuda.current_stream(device))
        else:
            self._a = time.perf_counter()

    def stop(self) -> None:
        if self._cuda:
            self._b = torch.cuda.Event(enable_timing=True)
            self._b.record(torch.cuda.current_stream(self._device))
        else:
            self._b = time.perf_counter()

    @property
    def ms(self) -> float:
        if self._cuda:
            self._b.synchronize()
            return float(self._a.elapsed_time(self._b))
        return (self._b - self._a) * 1e3


class Slab:
    """What one worker sees of the mesh: shards ``[first, first + k)`` of
    ``ndev``, on ``device``. ``ndev`` is the global width (owner hashes,
    bucket counts), ``k`` the leading axis of every local lane. The
    collectives take one tensor or a list (one exchange for the list)."""

    def __init__(self, ndev: int, first: int, k: int, device=None, rdv: Optional[_Rendezvous] = None, index: int = 0):
        self.ndev = ndev
        self.first = first
        self.k = k
        self.device = device
        self._rdv = rdv
        self._w = index

    @staticmethod
    def of(x) -> "Slab":
        """``x`` itself, or a one-worker slab of ``x`` virtual shards."""
        return x if isinstance(x, Slab) else Slab(int(x), 0, int(x))

    def _many(self, xs, local, across):
        one = isinstance(xs, torch.Tensor)
        xs = [xs] if one else list(xs)
        out = [local(x) for x in xs] if self._rdv is None else across(xs)
        return out[0] if one else out

    def all_to_all(self, xs):
        """``[k (source), ndev * cap]`` send buffers → ``[k (dest), ndev *
        cap]`` receive buffers, the blocks in source order."""

        def across(xs):
            workers = self._rdv.mesh.workers
            cap = [x.shape[-1] // self.ndev for x in xs]
            sends = [
                [x.reshape(self.k, self.ndev, c)[:, f : f + k] for x, c in zip(xs, cap)] for _h, f, k in workers
            ]
            got = self._rdv.exchange(self._w, sends)
            return [
                torch.cat([g[i] for g in got]).transpose(0, 1).reshape(self.k, self.ndev * c)
                for i, c in enumerate(cap)
            ]

        return self._many(xs, lambda x: all_to_all(x, self.ndev), across)

    def _gathered(self, xs):
        got = self._rdv.exchange(self._w, [xs] * len(self._rdv.mesh.workers))
        return [torch.cat([g[i] for g in got]) for i in range(len(xs))]

    def all_gather(self, xs):
        """``[k, m]`` → every shard's ``[ndev * m]``, concatenated in shard
        order, the same on every shard."""
        return self._many(
            xs, all_gather, lambda xs: [a.reshape(1, -1).expand(self.k, -1) for a in self._gathered(xs)]
        )

    def psum(self, xs):
        """``[k, ...]`` → the sum over the ``ndev`` shards, in shard order,
        the same on every shard."""
        return self._many(
            xs,
            psum,
            lambda xs: [a.sum(dim=0, keepdim=True).expand(self.k, *a.shape[1:]) for a in self._gathered(xs)],
        )


def make_mesh(n_devices: Optional[int] = None, devices: Optional[Sequence] = None) -> DeviceMesh:
    """A mesh over ``devices`` (handles or torch devices; else
    :func:`available_devices`), ``n_devices`` shards wide (else
    ``FORCE_NDEV``, else one per entry). One device gives a virtual slab
    that many shards wide; several are cut to the width, as the
    reference's mesh is, and a width past them raises — but for
    ``FORCE_NDEV`` over explicit devices (the survivors of a device loss),
    which takes what there is."""
    devs = [handle(d) for d in devices] if devices is not None else available_devices()
    if not devs:
        raise RuntimeError("mesh wants at least one device")
    n = n_devices if n_devices is not None else FORCE_NDEV
    if n is not None:
        if n < 1:
            raise ValueError(f"mesh width must be positive, got {n}")
        if len(devs) == 1:
            devs = devs * n
        elif n > len(devs) and (n_devices is not None or devices is None):
            raise RuntimeError(f"mesh wants {n} devices, only {len(devs)} available")
        else:
            devs = devs[:n]
    # one mesh object per entry list: the program cache keys on the
    # mesh's identity, as the reference's compiled programs do
    key = tuple(id(h) for h in devs)
    mesh = _MESH_CACHE.get(key)
    if mesh is None:
        mesh = _MESH_CACHE.setdefault(key, DeviceMesh(devs))
    return mesh


def all_to_all(x: torch.Tensor, ndev: int) -> torch.Tensor:
    """One slab: ``[ndev (source), ndev * cap]`` send buffers, block ``d``
    of each row bound for shard ``d`` → ``[ndev (dest), ndev * cap]``
    receive buffers, the blocks in source order."""
    cap = x.shape[-1] // ndev
    return x.reshape(ndev, ndev, cap).transpose(0, 1).reshape(ndev, ndev * cap)


def all_gather(x: torch.Tensor) -> torch.Tensor:
    """One slab: ``[ndev, m]`` → every shard's ``[ndev * m]``,
    concatenated in shard order, the same on every shard."""
    ndev = x.shape[0]
    return x.reshape(1, -1).expand(ndev, -1)


def psum(x: torch.Tensor) -> torch.Tensor:
    """One slab: ``[ndev, ...]`` → the sum over the shards, the same on
    every shard."""
    return x.sum(dim=0, keepdim=True).expand_as(x)
