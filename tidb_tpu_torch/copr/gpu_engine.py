"""GPU coprocessor engine: region columns → device cache → fused program.

Port of the single-block path of tidb_tpu/copr/tpu_engine.py. Per region
task:

1. keep the region's columns resident on the device in an LRU bounded by
   the card's memory (``_DeviceLRU``), keyed by (region, version, epoch),
   with int64 lanes whose values fit int32 stored narrow (``_narrowed``);
2. bind the DAG (string constants → dictionary codes; ``binder.py``);
3. fetch the program for (DAG, padded rows) and run it (``dag_kernel``);
4. trim the packed outputs by the program's reported count and re-attach
   string dictionaries → ``Chunk``.

Overflow protocol: if the program reports more groups than its static cap,
rerun with a 4x larger cap. The engine has no host fallback: a DAG shape
this slice does not port raises ``UnsupportedForDevice``.
"""

from __future__ import annotations

import threading
from collections import OrderedDict

import numpy as np
import torch

from tidb_tpu_torch.copr import dagpb
from tidb_tpu_torch.copr.binder import Binder, UnsupportedForDevice
from tidb_tpu_torch.copr.colcache import DEVICE_BLOCK_ROWS, Region
from tidb_tpu_torch.device import resolve
from tidb_tpu_torch.expression.expr import AggDesc, _ft_from_pb, expr_from_pb
from tidb_tpu_torch.kv import tablecodec
from tidb_tpu_torch.kv.tablecodec import KeyRange
from tidb_tpu_torch.ops.dag_kernel import MAX_RANGES, get_kernel
from tidb_tpu_torch.types import FieldType, TypeKind
from tidb_tpu_torch.types.field_type import bigint_type, double_type
from tidb_tpu_torch.utils.chunk import Chunk, Column, bucket_size

_DEFAULT_AGG_CAP = 4096
_BLOCK = DEVICE_BLOCK_ROWS
# share of the card's memory the column LRU may hold; the rest is the
# programs' working set (one-hot and limb operands, packed outputs)
_HBM_SHARE = 0.5
_HOST_BUDGET = 8 << 30  # device="cpu": the "device" copies are host tensors


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


def _device_put_col(lru: _DeviceLRU, key, make_pair, n_pad: int, device: torch.device):
    """One padded (data, valid) pair on ``device``, LRU-cached under
    ``key``. ``make_pair`` is a thunk: host-side preparation (the int32
    narrowing walks the whole column) runs only on a miss."""
    hit = lru.get(key)
    if hit is not None:
        return hit
    data, valid = make_pair()
    pd = np.zeros(n_pad, dtype=data.dtype)
    pd[: len(data)] = data
    pv = np.zeros(n_pad, dtype=bool)
    pv[: len(valid)] = valid
    out = (torch.from_numpy(pd).to(device), torch.from_numpy(pv).to(device))
    # key layout: (region_id, table_id, slot, unit, version, epoch, n_pad)
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


def _covers_all(rarr: np.ndarray, entry) -> bool:
    """True when the (padded) range set provably covers every region row —
    the program then skips the per-row handle range mask."""
    if entry.n == 0:
        return False
    spans = rarr[rarr[:, 0] < rarr[:, 1]]
    if len(spans) != 1:
        return False
    return int(spans[0, 0]) <= int(entry.handles[0]) and int(entry.handles[-1]) < int(spans[0, 1])


def execute_dag(region: Region, dag: dagpb.DAGRequest, ranges: list[KeyRange], warn=None, device="cuda") -> Chunk:
    """Run one pushed-down DAG over one region on ``device`` → Chunk.

    ``ranges`` are the task's record-key ranges (at most ``MAX_RANGES``);
    ``warn(level, code, msg)`` receives the program's warnings (the builtins
    of this slice raise none). Raises ``UnsupportedForDevice`` for a DAG
    shape this slice does not port.
    """
    dev = resolve(device)
    scan = dag.executors[0]
    if scan.table_id != region.table_id:
        raise ValueError(f"DAG scans table {scan.table_id}, region holds table {region.table_id}")
    if scan.desc:
        raise UnsupportedForDevice("descending scans are host-engine work (not ported)")
    if len(ranges) > MAX_RANGES:
        raise UnsupportedForDevice(f"{len(ranges)} ranges: point-lookup tasks are host-engine work (not ported)")
    if any(ex.tp == dagpb.WINDOW for ex in dag.executors[1:]):
        raise UnsupportedForDevice("window programs are not ported")
    entry = region.entry
    if entry.n > _BLOCK:
        raise UnsupportedForDevice(f"region of {entry.n} rows spans several device blocks (not ported)")
    bound = Binder(region.cache, scan.table_id, scan.columns, entry).bind_dag(dag)
    # ranges → padded static array; rows outside every range are masked out
    rarr = np.zeros((MAX_RANGES, 2), dtype=np.int64)
    for i, kr in enumerate(ranges):
        rarr[i] = tablecodec.range_to_handles(kr, scan.table_id)
    return _exec_single(region, dag, bound, scan, rarr, dev, warn)


def _single_device_inputs(region: Region, scan, n_pad: int, device: torch.device):
    entry = region.entry
    cache = region.cache
    lru = _device_lru(cache, device)
    base = (region.region_id, scan.table_id)
    hkey = base + (-1, "s", entry.data_version, cache.epoch, n_pad)
    handles_pair = _device_put_col(lru, hkey, lambda: (entry.handles, np.ones(entry.n, bool)), n_pad, device)
    cols_dev = []
    for c in scan.columns:
        if c.is_handle:
            cols_dev.append(handles_pair)
            continue
        ckey = base + (c.column_id, "s", entry.data_version, cache.epoch, n_pad)

        def mk(cid=c.column_id):
            data, valid = entry.cols[cid]
            return _narrowed(entry, cid, data), valid

        cols_dev.append(_device_put_col(lru, ckey, mk, n_pad, device))
    return handles_pair[0], tuple(cols_dev)


def _exec_single(region: Region, dag, bound, scan, rarr, device: torch.device, warn=None) -> Chunk:
    """One padded array per column, one program run (a region of at most
    one device block)."""
    entry = region.entry
    n_pad = bucket_size(max(entry.n, 1))
    handles_dev, cols_dev = _single_device_inputs(region, scan, n_pad, device)
    agg_cap = min(_DEFAULT_AGG_CAP, n_pad) if kernel_needs_agg(bound) else _DEFAULT_AGG_CAP
    fs = _covers_all(rarr, entry)
    while True:
        kernel = get_kernel(bound, n_pad, agg_cap, full_scan=fs)
        packed = kernel.fn(handles_dev, cols_dev, rarr, entry.n)
        ibuf, fbuf = packed if isinstance(packed, tuple) else (packed, None)
        if kernel.kind == "rows" and kernel.out_n > 65536:
            # large rows-kind buffers are mostly empty after selection: read
            # the meta row, then move only the bucketed live width
            w = min(kernel.out_n, bucket_size(max(2, int(ibuf[0, 0]))))
            ibuf = ibuf[:, :w]
            fbuf = fbuf[:, :w] if fbuf is not None else None
        buf = ibuf.cpu().numpy()
        fbuf = fbuf.cpu().numpy() if fbuf is not None else None
        count = int(buf[0, 0])
        ngroups = int(buf[0, 1])
        if ngroups > kernel.agg_cap:
            if agg_cap >= n_pad:
                # more groups than rows cannot happen; the n_pad cap always fits
                raise RuntimeError("aggregation group overflow beyond row count")
            agg_cap = min(agg_cap * 4, n_pad)
            continue
        break
    _emit_kernel_warnings(buf, kernel, warn)
    return _chunk_from_bufs(buf, fbuf, count, kernel, dag, region.cache, scan)


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
