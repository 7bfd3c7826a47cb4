"""GPU coprocessor engine: region columns → device cache → fused program.

Port of tidb_tpu/copr/tpu_engine.py. The cop client calls
:func:`execute_dag` (the reference's signature) per region task; it takes
the region's columns from the store's ``ColumnCache`` and runs
:func:`execute_region`, which a caller holding decoded columns
(``carry.region_from_arrays``) may call directly. Per region task:

1. keep the region's columns resident on the device in an LRU bounded by
   the card's memory (``_DeviceLRU``), keyed by (region, table, slot, unit,
   version, epoch, rows) where the unit is a block index, "s" for a
   region held as one array or "d" for the delta operand; int64 lanes
   whose values fit int32 are stored narrow (``_narrowed``);
2. bind the DAG (string constants → dictionary codes; ``binder.py``) over
   the base entry's statistics, or over base ⊕ delta (``_BinderView``)
   when committed changes are pending;
3. fetch the program for (DAG, padded rows, agg cap, blocks, delta cap)
   and run it (``dag_kernel``) on one of the reference's paths:
   - a region of at most one device block (``_BLOCK`` rows), or a
     complete-mode aggregation: one padded array, one program
     (``_exec_single``);
   - an aggregation-last DAG over 2..``_FUSE_MAX_NB`` blocks, or a window
     DAG over any number of blocks (a partition's rows must share one
     computation): one program over every block (``_exec_fused_blocks``) —
     the blocks concatenate, or the int8 dot accumulates block by block;
   - anything else over several blocks: one program per block, partial
     results in block (handle) order (``_exec_blocks``); a LIMIT-last DAG
     pages through the blocks and stops once the limit can be met;
4. trim the packed outputs by the program's reported count and re-attach
   string dictionaries → ``Chunk``.

The delta operand: the column cache pins a region's base entry across DML
and returns the committed changes on top of it (``colcache.get_split``) as
a ``DeltaOverlay`` of at most ``device_delta_cap`` handles. It ships padded
to that fixed capacity (``_delta_device_inputs``); the program masks the
base rows it supersedes, unions its live rows and restores handle order
where order matters. On the blocked path every block masks against the
whole delta and each delta row unions into the block whose handle span
holds it, so block outputs stay in handle order. A delta past the capacity
folds into the base through the cache's merge; it never reaches the host
engine. A window DAG takes no delta operand (its ties break by row
position): ``_execute_dag_device`` merges the delta into the base first.

Block results concatenate without a merge: aggregations run in partial
mode (the root merges groups across tasks and blocks), TopN and LIMIT tasks
return per-block candidates the root re-sorts and cuts.

Overflow protocol: if the program reports more groups than its static cap,
rerun with a 4x larger cap. ``execute_region`` has no host fallback: a DAG
shape the port does not carry raises ``UnsupportedForDevice``, and
``execute_dag`` answers that task on the host engine, recorded as the
task's ``degraded`` reason. Nothing else falls back: a CUDA error or a
kernel build or launch failure propagates.
"""

from __future__ import annotations

import dataclasses
import threading
import time
from collections import OrderedDict
from dataclasses import dataclass

import numpy as np
import torch

from tidb_tpu_torch.copr import dagpb, host_engine
from tidb_tpu_torch.copr.binder import Binder, UnsupportedForDevice
from tidb_tpu_torch.copr.colcache import DEVICE_BLOCK_ROWS, ColumnCache, DeltaOverlay, RegionColumns, cache_for
from tidb_tpu_torch.device import resolve
from tidb_tpu_torch.expression.expr import AggDesc, _ft_from_pb, expr_from_pb
from tidb_tpu_torch.kv import tablecodec
from tidb_tpu_torch.kv.kv import KeyRange
from tidb_tpu_torch.kv.rowcodec import RowSchema
from tidb_tpu_torch.ops.dag_kernel import MAX_RANGES, get_kernel
from tidb_tpu_torch.ops.window_core import packed_bits
from tidb_tpu_torch.types import FieldType, TypeKind
from tidb_tpu_torch.types.field_type import bigint_type, double_type
from tidb_tpu_torch.utils import execdetails as _ed
from tidb_tpu_torch.utils import metrics as _metrics
from tidb_tpu_torch.utils.chunk import Chunk, Column, bucket_size

_DEFAULT_AGG_CAP = 4096
_I64_MAX = np.iinfo(np.int64).max
_BLOCK = DEVICE_BLOCK_ROWS
_FUSE_MAX_NB = 8  # fused multi-block programs: the card holds the inputs and their concatenation
# share of the card's memory the column LRU may hold; the rest is the
# programs' working set (one-hot and limb operands, packed outputs)
_HBM_SHARE = 0.5
_HOST_BUDGET = 8 << 30  # device="cpu": the "device" copies are host tensors


def _delta_cap() -> int:
    """The delta operand's fixed row capacity (part of the program key)."""
    from tidb_tpu_torch import config as _config

    return int(getattr(_config.current(), "device_delta_cap", 8192))


@dataclass
class RegionView:
    """One region task's rows of one table: the decoded columns and the
    cache that holds their dictionaries and device copies. ``cacheable``
    is False for an entry built at an older snapshot than the region's
    head, whose device copies must not be kept under the head's version.
    ``delta``, when given, holds the committed changes pending on the
    entry (at most ``device_delta_cap`` handles)."""

    region_id: int
    table_id: int
    entry: RegionColumns
    cache: ColumnCache
    cacheable: bool = True
    delta: DeltaOverlay | None = None


class _BinderView:
    """Statistics over base ⊕ delta for the binder: the min/max behind the
    sort bounds, the K1/dot magnitude proofs and the int32 narrow-eval
    proofs must cover the delta's values, or a fresh row outside the
    base's envelope would break an exactness gate (K1 trusts its bounds)."""

    def __init__(self, base, delta):
        self.base, self.delta = base, delta
        self.n = base.n + delta.n

    @property
    def handles(self):
        # only the endpoints are read (the binder's handle min/max)
        hs = [h for h in (self.base.handles, self.delta.handles) if len(h)]
        if not hs:
            return np.empty(0, np.int64)
        return np.array([min(int(h[0]) for h in hs), max(int(h[-1]) for h in hs)], dtype=np.int64)

    def minmax(self, slot: int) -> tuple[int, int]:
        mm = self.base.minmax(slot)
        dm = self.delta.minmax(slot)
        if dm is None:
            return mm
        return (min(mm[0], dm[0]), max(mm[1], dm[1]))


class _DeviceLRU:
    """Memory-bounded LRU of device-resident column (data, valid) pairs.
    Eviction only drops this reference; a running program keeps its inputs
    alive."""

    def __init__(self, budget_bytes: int):
        self.budget = budget_bytes
        self._mu = threading.Lock()
        self._entries: "OrderedDict[tuple, tuple]" = OrderedDict()  # key → (pair, nbytes)
        self.total = 0

    def get(self, key):
        with self._mu:
            hit = self._entries.get(key)
            if hit is None:
                return None
            self._entries.move_to_end(key)
            return hit[0]

    def put(self, key, pair, nbytes: int):
        with self._mu:
            old = self._entries.pop(key, None)
            if old is not None:
                self.total -= old[1]
            self._entries[key] = (pair, nbytes)
            self.total += nbytes
            while self.total > self.budget and len(self._entries) > 1:
                k, (_, nb) = next(iter(self._entries.items()))
                if k == key:  # never evict the entry just inserted
                    break
                del self._entries[k]
                self.total -= nb

    def evict_superseded(self, ident, ver_epoch):
        """Drop other versions/epochs of the same column: a dictionary
        compaction bumps the epoch, and stale copies would leak memory."""
        with self._mu:
            for k in [
                k
                for k in self._entries
                if k[: len(ident)] == ident and k[len(ident) : len(ident) + 2] != ver_epoch
            ]:
                self.total -= self._entries[k][1]
                del self._entries[k]


def _hbm_budget(device: torch.device) -> int:
    if device.type == "cuda":
        _free, total = torch.cuda.mem_get_info(device)
        return int(total * _HBM_SHARE)
    return _HOST_BUDGET


def _device_lru(cache, device: torch.device) -> _DeviceLRU:
    with cache._mu:
        lru = cache.device_lrus.get(str(device))
        if lru is None:
            lru = cache.device_lrus[str(device)] = _DeviceLRU(_hbm_budget(device))
        return lru


def _device_put_col(lru: _DeviceLRU, key, make_pair, n_pad: int, device: torch.device, cacheable: bool = True, pad=0):
    """One (data, valid) pair on ``device``, data padded to ``n_pad`` with
    ``pad`` and LRU-cached under ``key`` when ``cacheable``. ``make_pair``
    is a thunk: host-side preparation (the int32 narrowing walks the whole
    column) runs only on a miss."""
    det = _ed.current_cop()
    hit = lru.get(key) if cacheable else None
    if hit is not None:
        if det is not None:
            det.dev_cache_hits += 1
        _metrics.DEVICE_CACHE.inc(result="hit")
        return hit
    data, valid = make_pair()
    pd = np.full(n_pad, pad, dtype=data.dtype)
    pd[: len(data)] = data
    pv = np.zeros(n_pad, dtype=bool)
    pv[: len(valid)] = valid
    out = (torch.from_numpy(pd).to(device), torch.from_numpy(pv).to(device))
    if det is not None:
        det.dev_cache_misses += 1
        det.h2d_bytes += pd.nbytes + pv.nbytes
    _metrics.DEVICE_CACHE.inc(result="miss")
    _metrics.DEVICE_TRANSFER.inc(pd.nbytes + pv.nbytes, dir="h2d")
    if not cacheable:
        return out
    # key layout: (region_id, table_id, slot, unit, version, epoch, n_pad);
    # superseded versions are dropped per unit, so a merge that carries
    # clean blocks replaces only the dirty ones
    lru.put(key, out, pd.nbytes + pv.nbytes)
    lru.evict_superseded(key[:4], key[4:6])
    return out


def _narrowed(entry, column_id: int, data: np.ndarray) -> np.ndarray:
    """int64 value lanes whose min/max fit int32 live on the device as
    int32 — bounded DECIMALs, DATE days and small ints read half the bytes.
    Deterministic per data version, so it cannot split the LRU identity."""
    if data.dtype != np.int64:
        return data
    try:
        lo, hi = entry.minmax(column_id)
    except (KeyError, ValueError):
        return data
    if -(2**31) < lo and hi < 2**31 - 1:
        return data.astype(np.int32)
    return data


def _covers_all(rarr: np.ndarray, entry, delta=None) -> bool:
    """True when the (padded) range set provably covers every region row —
    the program then skips the per-row handle range mask. With a delta the
    proof must cover the delta's handle span too."""
    if entry.n == 0:
        return False
    spans = rarr[rarr[:, 0] < rarr[:, 1]]
    if len(spans) != 1:
        return False
    lo, hi = int(entry.handles[0]), int(entry.handles[-1])
    if delta is not None:
        lo, hi = min(lo, int(delta.handles[0])), max(hi, int(delta.handles[-1]))
    return int(spans[0, 0]) <= lo and hi < int(spans[0, 1])


def _n_blocks(n: int) -> int:
    return -(-n // _BLOCK)


def _block_bounds(n: int) -> list[tuple[int, int]]:
    return [(i, min(i + _BLOCK, n)) for i in range(0, n, _BLOCK)]


def _should_fuse_agg(dag: dagpb.DAGRequest, entry) -> bool:
    """An aggregation-last DAG over a region of 2..``_FUSE_MAX_NB`` blocks
    runs as one program: one dispatch, and no partial merge of per-block
    results."""
    agg_last = bool(dag.executors[1:]) and dag.executors[-1].tp in (dagpb.AGGREGATION, dagpb.STREAM_AGG)
    return entry.n > _BLOCK and agg_last and _n_blocks(entry.n) <= _FUSE_MAX_NB


def execute_dag(store, dag: dagpb.DAGRequest, region, ranges: list[KeyRange], read_ts: int, warn=None) -> Chunk:
    """The ``gpu`` cop engine: one pushed-down DAG over one store region
    (``kv.memstore.Region``) at ``read_ts``, on the device the store
    carries (``store.device``, set by ``tidb_tpu_torch.open``). Fills the
    task's ExecDetails sidecar: a ``device-exec`` span, ``device_ms`` and
    ``engine = "gpu"``; a shape the device engine does not carry runs on
    the host engine with ``degraded`` set to the reason."""
    det = _ed.current_cop()
    if det is None:
        try:
            return _execute_dag_device(store, dag, region, ranges, read_ts, warn)
        except UnsupportedForDevice:
            return host_engine.execute_dag(store, dag, region, ranges, read_ts, warn)
    t0 = time.perf_counter()
    h0 = det.host_ms
    try:
        try:
            with _ed.trace_span("device-exec"):
                return _execute_dag_device(store, dag, region, ranges, read_ts, warn)
        except UnsupportedForDevice as e:
            det.degraded = det.degraded or f"unsupported-for-device: {e}"
            return host_engine.execute_dag(store, dag, region, ranges, read_ts, warn)
    finally:
        # device-time attribution, unless the task ran on the host engine
        # (which attributed itself and claimed the engine label)
        if det.host_ms - h0 <= 0.0:
            dev_ms = (time.perf_counter() - t0) * 1000.0
            det.device_ms += dev_ms
            det.engine = "gpu"
            _metrics.COP_DEVICE_SECONDS.observe(dev_ms / 1000.0)


def store_device(store) -> torch.device:
    """The store's device, resolved once (``device.resolve``): with no card
    a CUDA device raises here, on the first device task."""
    dev = getattr(store, "_gpu_device", None)
    if dev is None:
        dev = store._gpu_device = resolve(getattr(store, "device", "cuda"))
    return dev


def _execute_dag_device(store, dag: dagpb.DAGRequest, region, ranges: list[KeyRange], read_ts: int, warn=None) -> Chunk:
    scan = dag.executors[0]
    if scan.desc or len(ranges) > MAX_RANGES:
        # descending scans are order-sensitive row streams, and many-range
        # tasks are point lookups: the host engine slices exactly the
        # requested handles from the same column cache (the reference's
        # split, tpu_engine._execute_dag_device)
        return host_engine.execute_dag(store, dag, region, ranges, read_ts, warn)
    dev = store_device(store)
    schema = RowSchema(scan.storage_schema)
    slots = [c.column_id for c in scan.columns if not c.is_handle]
    cache = cache_for(store)
    # the base stays pinned across DML; committed changes ride as the
    # bounded delta operand the program folds in (get_split merges a delta
    # past the operand capacity into the base)
    entry, delta = cache.get_split(region, scan.table_id, schema, slots, read_ts)
    if delta is not None and delta.n and _has_window(dag):
        # window ties break by row position: fold the delta into the base
        # now; the merge keeps the clean blocks' device copies
        entry, delta = cache.merge_now(region, scan.table_id, schema, slots, read_ts), None
    view = RegionView(region.region_id, scan.table_id, entry, cache, cacheable=entry.complete, delta=delta)
    return execute_region(view, dag, ranges, warn, dev)


def execute_region(region: RegionView, dag: dagpb.DAGRequest, ranges: list[KeyRange], warn=None, device="cuda", stats=None) -> Chunk:
    """Run one pushed-down DAG over one region on ``device`` → Chunk.

    ``ranges`` are the task's record-key ranges (at most ``MAX_RANGES``);
    ``warn(level, code, msg)`` receives the program's warnings (division by
    zero: 1365, counted per row). ``stats``, a dict when given, receives the task's
    engine ``path`` ("single", "fused", "blockwise dot", "per-block
    stacked" or "paged limit"), the ``routes`` of its aggregations, the
    number of agg-cap ``regrows`` and the ``delta_rows`` it folded in
    (``region.delta``). Raises ``UnsupportedForDevice`` for a DAG shape
    the port does not carry or a window sort that does not pack past 2^20
    rows, and ValueError for a window DAG with a delta.
    """
    dev = resolve(device)
    scan = dag.executors[0]
    if scan.table_id != region.table_id:
        raise ValueError(f"DAG scans table {scan.table_id}, region holds table {region.table_id}")
    if scan.desc:
        raise UnsupportedForDevice("descending scans are host-engine work (not ported)")
    if len(ranges) > MAX_RANGES:
        raise UnsupportedForDevice(f"{len(ranges)} ranges: point-lookup tasks are host-engine work (not ported)")
    if region.delta is not None and not region.delta.n:
        region = dataclasses.replace(region, delta=None)
    entry, delta = region.entry, region.delta
    has_window = _has_window(dag)
    if delta is not None and has_window:
        raise ValueError("a window DAG takes no delta operand: merge it first")
    if delta is not None and delta.n > _delta_cap():
        raise ValueError(f"a delta of {delta.n} rows exceeds the operand capacity {_delta_cap()}: merge it first")
    stats = stats if stats is not None else {}
    stats["regrows"] = 0
    stats["delta_rows"] = delta.n if delta is not None else 0
    if delta is not None:
        det = _ed.current_cop()
        if det is not None:
            det.delta_rows += delta.n
    binder_entry = entry if delta is None else _BinderView(entry, delta)
    bound = Binder(region.cache, scan.table_id, scan.columns, binder_entry).bind_dag(dag)
    # ranges → padded static array; rows outside every range are masked out
    rarr = np.zeros((MAX_RANGES, 2), dtype=np.int64)
    for i, kr in enumerate(ranges):
        rarr[i] = tablecodec.range_to_handles(kr, scan.table_id)
    if has_window:
        _window_pack_guard(bound, entry.n)
        if entry.n > _BLOCK:
            # a partition's rows must share one computation: one program
            # over every block of the region
            return _exec_fused_blocks(region, dag, bound, scan, rarr, dev, warn, stats)
    if _should_fuse_agg(dag, entry):
        return _exec_fused_blocks(region, dag, bound, scan, rarr, dev, warn, stats)
    agg_complete = any(
        ex.tp in (dagpb.AGGREGATION, dagpb.STREAM_AGG) and ex.agg_mode == dagpb.AGG_COMPLETE
        for ex in dag.executors[1:]
    )
    if entry.n > _BLOCK and not agg_complete:
        return _exec_blocks(region, dag, bound, scan, rarr, dev, warn, stats)
    return _exec_single(region, dag, bound, scan, rarr, dev, warn, stats)


def _has_window(dag: dagpb.DAGRequest) -> bool:
    return any(ex.tp == dagpb.WINDOW for ex in dag.executors[1:])


def _window_pack_guard(bound: dagpb.DAGRequest, n: int) -> None:
    """Past 2^20 rows a window sort must pack into one key (the reference's
    gate: its multi-lane chain was pathological at that scale); otherwise
    the task is the host engine's, marked degraded by ``execute_dag``."""
    if n <= (1 << 20):
        return
    n_total = bucket_size(max(n, 1)) if n <= _BLOCK else _n_blocks(n) * _BLOCK
    for ex in bound.executors[1:]:
        if ex.tp == dagpb.WINDOW:
            sb = [tuple(b) if b is not None else None for b in ex.sort_bounds] or None
            if packed_bits(sb, n_total) is None:
                raise UnsupportedForDevice("window sort not packable at this scale")


def _device_inputs(region: RegionView, scan, unit, lo: int, hi: int, n_pad: int, device: torch.device):
    """(handles, column pairs) of rows [lo, hi) on ``device``, padded to
    ``n_pad`` and LRU-cached under ``unit``: "s" for a region held as one
    array, else the block index. Blocks are put on demand, so a LIMIT that
    stops early never uploads the blocks it does not read, and the fused
    and per-block paths share the block entries."""
    entry = region.entry
    cache = region.cache
    lru = _device_lru(cache, device)
    ver = entry.vtag_span(lo, hi)
    base = (region.region_id, scan.table_id)
    hkey = base + (-1, unit, ver, cache.epoch, n_pad)
    hpair = _device_put_col(
        lru, hkey, lambda: (entry.handles[lo:hi], np.ones(hi - lo, bool)), n_pad, device, region.cacheable
    )
    cols_dev = []
    for c in scan.columns:
        if c.is_handle:
            cols_dev.append(hpair)
            continue
        ckey = base + (c.column_id, unit, ver, cache.epoch, n_pad)

        def mk(cid=c.column_id):
            data, valid = entry.cols[cid]
            # narrowing reads the whole region's min/max: every block of a
            # column gets one dtype, so the fused program can concatenate
            return _narrowed(entry, cid, data[lo:hi]), valid[lo:hi]

        cols_dev.append(_device_put_col(lru, ckey, mk, n_pad, device, region.cacheable))
    return hpair[0], tuple(cols_dev)


def _fused_block_inputs(region: RegionView, scan, device: torch.device):
    """(handles per block, per column its pairs per block, live rows per
    block, block count) for the fused multi-block program."""
    bounds = _block_bounds(region.entry.n)
    handles_blocks = []
    cols_blocks: list[list] = [[] for _ in scan.columns]
    for bi, (lo, hi) in enumerate(bounds):
        h, cols_dev = _device_inputs(region, scan, bi, lo, hi, _BLOCK, device)
        handles_blocks.append(h)
        for ci, pair in enumerate(cols_dev):
            cols_blocks[ci].append(pair)
    nvalids = tuple(hi - lo for lo, hi in bounds)
    return tuple(handles_blocks), tuple(tuple(cb) for cb in cols_blocks), nvalids, len(bounds)


def _delta_device_inputs(region: RegionView, scan, device: torch.device):
    """The delta operand on ``device``: its sorted handles (pads hold
    int64-max, so a search into them stays legal), its tombstones and its
    lanes per scan column, all padded to the fixed capacity so every delta
    size runs one program. LRU-cached under the "d" unit and the delta's
    version when the delta covers the region head (``delta.complete``).
    An int64 lane is narrowed to int32 when base and delta together fit, as
    its base blocks are; otherwise it ships int64 and the program widens
    the base lane to match before it concatenates (``dag_kernel``).
    → (handles, column pairs, tombstones)."""
    delta = region.delta
    D = _delta_cap()
    cache = region.cache
    lru = _device_lru(cache, device)
    base = (region.region_id, scan.table_id)
    cacheable = delta.complete

    def key(slot):
        return base + (slot, "d", delta.data_version, cache.epoch, D)

    dh_pair = _device_put_col(
        lru, key(-1), lambda: (delta.handles, np.ones(delta.n, bool)), D, device, cacheable, pad=_I64_MAX
    )
    tomb_pair = _device_put_col(lru, key(-2), lambda: (delta.tomb, np.ones(delta.n, bool)), D, device, cacheable)
    view = _BinderView(region.entry, delta)
    cols_dev = []
    for c in scan.columns:
        if c.is_handle:
            cols_dev.append(dh_pair)
            continue

        def mk(cid=c.column_id):
            data, valid = delta.cols[cid]
            return _narrowed(view, cid, data), valid

        cols_dev.append(_device_put_col(lru, key(c.column_id), mk, D, device, cacheable))
    return dh_pair[0], tuple(cols_dev), tomb_pair[0]


def _delta_args(region: RegionView, scan, device: torch.device, u_lo: int, u_hi: int):
    """The program's trailing delta arguments: the operand and the counts
    ``(mask_n, union_lo, union_hi)`` — every program masks against the
    whole delta and unions only rows [union_lo, union_hi)."""
    dh, dcols, dtomb = _delta_device_inputs(region, scan, device)
    return dh, dcols, dtomb, (region.delta.n, u_lo, u_hi)


def _d2h(t: torch.Tensor) -> np.ndarray:
    """Copy one tensor off the card, counting its bytes on the task's
    ExecDetails (``d2h_bytes``) and in the transfer metric."""
    a = t.cpu().numpy()
    det = _ed.current_cop()
    if det is not None:
        det.d2h_bytes += int(a.nbytes)
    _metrics.DEVICE_TRANSFER.inc(int(a.nbytes), dir="d2h")
    return a


def _to_host(packed):
    """(int buffer, float buffer or None) as numpy arrays."""
    if isinstance(packed, tuple):
        return _d2h(packed[0]), _d2h(packed[1])
    return _d2h(packed), None


def _probe_slice_rows(packed_list: list, kernel):
    """Large rows-kind buffers (capacity = the padded block) are mostly
    empty after selection: read every program's meta row in one copy, then
    slice each buffer to its bucketed live width so only live rows move.
    → (counts, sliced buffers)."""
    tup = isinstance(packed_list[0], tuple)
    ibufs = [p[0] if tup else p for p in packed_list]
    metas = _d2h(torch.stack([b[0, :2] for b in ibufs]))
    sliced = []
    for p, m in zip(packed_list, metas):
        w = min(kernel.out_n, bucket_size(max(2, int(m[0]))))
        sliced.append(tuple(q[:, :w] for q in p) if tup else p[:, :w])
    return [int(m[0]) for m in metas], sliced


def _run_whole(get, run, agg_cap: int, cap_max: int, stats: dict):
    """Run one whole-region program, rerunning it with a 4x larger agg cap
    (at most ``cap_max``, the rows it reads) while its groups overflow.
    → (kernel, int buffer, float buffer)."""
    while True:
        kernel = get(agg_cap)
        packed = run(kernel)
        if kernel.kind == "rows" and kernel.out_n > 65536:
            _, (packed,) = _probe_slice_rows([packed], kernel)
        buf, fbuf = _to_host(packed)
        stats["routes"] = kernel.routes
        if int(buf[0, 1]) > kernel.agg_cap:
            if agg_cap >= cap_max:
                # more groups than rows cannot happen; the row-count cap always fits
                raise RuntimeError("aggregation group overflow beyond row count")
            agg_cap = min(agg_cap * 4, cap_max)
            stats["regrows"] += 1
            continue
        return kernel, buf, fbuf


def _exec_single(region: RegionView, dag, bound, scan, rarr, device: torch.device, warn, stats: dict) -> Chunk:
    """One padded array per column, one program run: a region of at most one
    device block, or a complete-mode aggregation."""
    entry, delta = region.entry, region.delta
    n_pad = bucket_size(max(entry.n, 1))
    dcap = _delta_cap() if delta is not None else 0
    agg_cap = min(_DEFAULT_AGG_CAP, n_pad + dcap) if kernel_needs_agg(bound) else _DEFAULT_AGG_CAP
    fs = _covers_all(rarr, entry, delta)
    stats["path"] = "single"

    def run(kernel):
        handles_dev, cols_dev = _device_inputs(region, scan, "s", 0, entry.n, n_pad, device)
        dargs = () if delta is None else _delta_args(region, scan, device, 0, delta.n)
        return kernel.fn(handles_dev, cols_dev, rarr, entry.n, *dargs)

    kernel, buf, fbuf = _run_whole(
        lambda cap: get_kernel(bound, n_pad, cap, full_scan=fs, delta_cap=dcap), run, agg_cap, n_pad + dcap, stats
    )
    _emit_kernel_warnings(buf, kernel, warn)
    return _chunk_from_bufs(buf, fbuf, int(buf[0, 0]), kernel, dag, region.cache, scan)


def _exec_fused_blocks(region: RegionView, dag, bound, scan, rarr, device: torch.device, warn, stats: dict) -> Chunk:
    """An aggregation-last or window DAG over a region of several blocks:
    one program over every block, one dispatch, no merge of per-block
    partials."""
    entry, delta = region.entry, region.delta
    handles_blocks, cols_blocks, nvalids, nb = _fused_block_inputs(region, scan, device)
    dcap = _delta_cap() if delta is not None else 0
    dargs = () if delta is None else _delta_args(region, scan, device, 0, delta.n)
    n_total = nb * _BLOCK + dcap
    agg_cap = min(_DEFAULT_AGG_CAP, n_total)
    fs = _covers_all(rarr, entry, delta)
    kernel, buf, fbuf = _run_whole(
        lambda cap: get_kernel(bound, _BLOCK, cap, nb=nb, full_scan=fs, delta_cap=dcap),
        lambda kernel: kernel.fn(handles_blocks, cols_blocks, rarr, nvalids, *dargs),
        agg_cap,
        n_total,
        stats,
    )
    stats["path"] = "blockwise dot" if kernel.blockwise else "fused"
    _emit_kernel_warnings(buf, kernel, warn)
    return _chunk_from_bufs(buf, fbuf, int(buf[0, 0]), kernel, dag, region.cache, scan)


def _exec_blocks(region: RegionView, dag, bound, scan, rarr, device: torch.device, warn, stats: dict) -> Chunk:
    """A region of several blocks, one program per block: aggregations and
    TopN run every block and copy the stacked results once; a LIMIT-last DAG
    pages through the blocks. With a delta, every block masks against the
    whole delta and unions the delta rows inside its own handle span."""
    entry, delta = region.entry, region.delta
    bounds = _block_bounds(entry.n)
    limit_last = dag.executors[-1].tp == dagpb.LIMIT
    stats["path"] = "paged limit" if limit_last else "per-block stacked"
    dcap = _delta_cap() if delta is not None else 0
    dcuts = None
    if delta is not None:
        # delta handles are sorted, so block bi unions the contiguous slice
        # [dcuts[bi], dcuts[bi + 1]) (block 0 reaches back to -inf, the last
        # block forward to +inf): block outputs stay in handle order
        starts = np.asarray([entry.handles[lo] for lo, _hi in bounds[1:]], dtype=np.int64)
        dcuts = [0] + [int(c) for c in np.searchsorted(delta.handles, starts)] + [delta.n]
    agg_cap = _DEFAULT_AGG_CAP
    fs = _covers_all(rarr, entry, delta)
    while True:
        kernel = get_kernel(bound, _BLOCK, agg_cap, full_scan=fs, delta_cap=dcap)
        stats["routes"] = kernel.routes

        def run_block(bi: int):
            lo, hi = bounds[bi]
            handles_dev, cols_dev = _device_inputs(region, scan, bi, lo, hi, _BLOCK, device)
            dargs = () if delta is None else _delta_args(region, scan, device, dcuts[bi], dcuts[bi + 1])
            return kernel.fn(handles_dev, cols_dev, rarr, hi - lo, *dargs)

        if limit_last:
            out = _blocks_paged_limit(run_block, len(bounds), kernel, dag, region.cache, scan, warn)
        else:
            out = _blocks_stacked(run_block, len(bounds), kernel, dag, region.cache, scan, warn)
        if out is None:  # agg overflow in some block
            agg_cap = min(agg_cap * 4, _BLOCK + dcap)
            stats["regrows"] += 1
            continue
        return out


def _blocks_stacked(run_block, nb: int, kernel, dag, cache, scan, warn=None):
    """Run every block, stack the results on the device, copy once. Returns
    None on agg-cap overflow (the caller reruns with a larger cap)."""
    packed = [run_block(bi) for bi in range(nb)]
    tup = isinstance(packed[0], tuple)
    chunks = []
    if kernel.kind == "rows" and kernel.out_n > 65536:
        # rows-kind: counts first (one small copy), then live slices only
        counts, gets = _probe_slice_rows(packed, kernel)
        for cnt, got in zip(counts, gets):
            buf, fbuf = _to_host(got)
            _emit_kernel_warnings(buf, kernel, warn)
            chunks.append(_chunk_from_bufs(buf, fbuf, cnt, kernel, dag, cache, scan))
        return _concat_chunks(chunks)
    bi_all = _d2h(torch.stack([p[0] if tup else p for p in packed]))
    bf_all = _d2h(torch.stack([p[1] for p in packed])) if tup else None
    if kernel.kind == "agg" and any(int(b[0, 1]) > kernel.agg_cap for b in bi_all):
        return None
    for b in range(nb):
        buf = bi_all[b]
        fbuf = bf_all[b] if bf_all is not None else None
        _emit_kernel_warnings(buf, kernel, warn)
        chunks.append(_chunk_from_bufs(buf, fbuf, int(buf[0, 0]), kernel, dag, cache, scan))
    return _concat_chunks(chunks)


def _blocks_paged_limit(run_block, nb: int, kernel, dag, cache, scan, warn=None):
    """LIMIT-last: run blocks in windows of 1, 2, 4, then 8, and stop once
    the rows fetched can meet the limit (the coprocessor's paging)."""
    limit = dag.executors[-1].limit
    chunks = []
    got = 0
    window = 1
    bi = 0
    # `not chunks` keeps LIMIT 0 well-formed: one empty block result still
    # carries the output schema
    while bi < nb and (got < limit or not chunks):
        batch = list(range(bi, min(bi + window, nb)))
        packed = [run_block(i) for i in batch]
        if kernel.out_n > 65536:  # LIMIT-last DAGs are rows-kind
            _counts, packed = _probe_slice_rows(packed, kernel)
        for p in packed:
            buf, fbuf = _to_host(p)
            cnt = int(buf[0, 0])
            _emit_kernel_warnings(buf, kernel, warn)
            chunks.append(_chunk_from_bufs(buf, fbuf, cnt, kernel, dag, cache, scan))
            got += cnt
        bi += len(batch)
        window = min(window * 2, 8)
    return _concat_chunks(chunks)


def _concat_chunks(chunks: list[Chunk]) -> Chunk:
    return chunks[0] if len(chunks) == 1 else Chunk.concat(chunks)


def _emit_kernel_warnings(buf, kernel, warn) -> None:
    """Warning counts ride the program's meta row; turn nonzero counts back
    into session warnings, capped like MySQL's max_error_count."""
    if warn is None:
        return
    for code, msg, slot in kernel.warn_specs:
        cnt = int(buf[0, slot]) if slot < buf.shape[1] else 0
        for _ in range(min(cnt, 64)):
            warn("Warning", code, msg)


def _chunk_from_bufs(buf, fbuf, count: int, kernel, dag, cache, scan) -> Chunk:
    """Packed program buffers → Chunk (trim to count, re-attach dictionaries)."""
    outs = []
    for (which, idx), vidx in zip(kernel.lane_loc, kernel.valid_loc):
        data = fbuf[idx] if which == "f" else buf[idx]
        outs.append((data, buf[vidx].astype(bool)))
    # the output schema comes from the *unbound* DAG (string columns keep
    # their dictionaries)
    out_fts = output_ftypes(dag)
    offsets = dag.output_offsets or list(range(len(out_fts)))
    cols = []
    for (data, valid), off in zip(outs, offsets):
        ft = out_fts[off]
        d = np.asarray(data)[:count]
        v = np.asarray(valid)[:count]
        dic = None
        if ft.kind == TypeKind.STRING:
            slot = string_slot_for_output(dag, off)
            dic = cache.dictionary(scan.table_id, slot) if slot is not None else None
            d = d.astype(np.int32)
        elif ft.kind == TypeKind.FLOAT:
            d = d.astype(np.float64)
        else:
            d = d.astype(np.int64)
        cols.append(Column(d, v.astype(bool), ft, dic))
    return Chunk(cols)


def kernel_needs_agg(dag: dagpb.DAGRequest) -> bool:
    return any(ex.tp in (dagpb.AGGREGATION, dagpb.STREAM_AGG) for ex in dag.executors)


def output_ftypes(dag: dagpb.DAGRequest) -> list[FieldType]:
    """Schema of the last executor's output (before output_offsets)."""
    scan = dag.executors[0]
    fts = [c.ftype for c in scan.columns]
    for ex in dag.executors[1:]:
        if ex.tp in (dagpb.AGGREGATION, dagpb.STREAM_AGG):
            out = []
            for a_pb in ex.aggs:
                a = AggDesc.from_pb(a_pb)
                if ex.agg_mode == dagpb.AGG_COMPLETE:
                    out.append(a.ftype)
                    continue
                for pk in a.partial_kinds:
                    if pk == "count":
                        out.append(bigint_type(nullable=False))
                    elif pk == "sum":
                        out.append(AggDesc("sum", a.arg).ftype)
                    elif pk == "sumsq":
                        out.append(double_type())
                    elif pk in ("bit_and", "bit_or", "bit_xor"):
                        out.append(bigint_type(nullable=False))
                    else:
                        out.append(a.arg.ftype if a.arg is not None else bigint_type())
            for g in ex.group_by:
                out.append(expr_from_pb(g).ftype)
            if getattr(ex, "rollup", False):
                out.extend(bigint_type(nullable=False) for _ in ex.group_by)
            fts = out
        elif ex.tp == dagpb.PROJECTION:
            fts = [expr_from_pb(e).ftype for e in ex.exprs]
        elif ex.tp == dagpb.WINDOW:
            fts = fts + [_ft_from_pb(f["ft"]) for f in ex.win_funcs]
    return fts


def string_slot_for_output(dag: dagpb.DAGRequest, offset: int):
    """The storage slot whose dictionary backs output column ``offset``
    (only direct ColumnRef passthroughs keep dictionaries)."""
    scan = dag.executors[0]
    prov: list = list(range(len(scan.columns)))  # output offset → scan offset
    for ex in dag.executors[1:]:
        if ex.tp in (dagpb.AGGREGATION, dagpb.STREAM_AGG):
            out = []
            for a in ex.aggs:
                n_lanes = len(AggDesc.from_pb(a).partial_kinds) if ex.agg_mode != dagpb.AGG_COMPLETE else 1
                arg = a.get("arg")
                src = None
                if a["name"] in ("min", "max", "first_row") and arg is not None and arg.get("tp") == "col":
                    src = prov[arg["idx"]] if arg["idx"] < len(prov) else None
                out.extend([src] * n_lanes)
            for g in ex.group_by:
                out.append(prov[g["idx"]] if g.get("tp") == "col" and g["idx"] < len(prov) else None)
            if getattr(ex, "rollup", False):
                out.extend([None] * len(ex.group_by))  # GROUPING flags: ints
            prov = out
        elif ex.tp == dagpb.PROJECTION:
            prov = [prov[e["idx"]] if e.get("tp") == "col" and e["idx"] < len(prov) else None for e in ex.exprs]
        elif ex.tp == dagpb.WINDOW:
            prov = prov + [None] * len(ex.win_funcs)
    src = prov[offset] if offset < len(prov) else None
    if src is None:
        return None
    return scan.columns[src].column_id
