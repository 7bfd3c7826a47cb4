"""Carrying a region and a DAG across from the reference's wire forms.

The port's counterpart of loading weights: the caller hands over plain
numpy arrays and lists of bytes (a region's sorted handles, its decoded
columns and its string dictionaries) and the JSON-able dict a DAG
serializes to; nothing here takes a ``tidb_tpu`` object.
"""

from __future__ import annotations

import numpy as np

from tidb_tpu_torch.copr import dagpb
from tidb_tpu_torch.copr.colcache import ColumnCache, RegionColumns
from tidb_tpu_torch.copr.gpu_engine import RegionView


def region_from_arrays(
    handles,
    cols: dict,
    dicts: dict,
    table_id: int,
    region_bounds: tuple[bytes, bytes],
    cache: ColumnCache | None = None,
) -> RegionView:
    """Build one region's host state (``gpu_engine.execute_region`` runs a
    DAG over it).

    handles       : (n,) int64, strictly ascending.
    cols          : {storage slot: (data, valid)}; string slots hold int32
                    codes into ``dicts[slot]``, other slots int64 physical
                    values (scaled decimals, DATE days) or float64.
    dicts         : {string slot: [bytes, ...]} — code i decodes to item i.
    region_bounds : (start_key, end_key) of the region.
    cache         : the store-less ColumnCache shared with the table's other
                    regions (their string codes must agree); a new one when
                    None.
    """
    handles = np.ascontiguousarray(handles, dtype=np.int64)
    n = len(handles)
    if n > 1 and not (np.diff(handles) > 0).all():
        raise ValueError("region handles must be strictly ascending")
    cache = cache if cache is not None else ColumnCache()
    out_cols = {}
    for slot, (data, valid) in cols.items():
        data = np.ascontiguousarray(data)
        valid = np.ascontiguousarray(valid, dtype=bool)
        if data.shape != (n,) or valid.shape != (n,):
            raise ValueError(f"slot {slot}: lanes must have shape ({n},)")
        if data.dtype not in (np.int64, np.int32, np.float64):
            raise ValueError(f"slot {slot}: unsupported dtype {data.dtype}")
        out_cols[int(slot)] = (data, valid)
    for slot, values in dicts.items():
        values = [bytes(v) for v in values]
        dic = cache.dictionary(table_id, int(slot))
        if len(dic) == 0:
            for v in values:
                dic.encode(v)
        elif dic.values_array() != values:
            raise ValueError(f"slot {slot}: dictionary differs from the one the cache holds")
        data, valid = out_cols[int(slot)]
        if data.dtype != np.int32:
            raise ValueError(f"string slot {slot} must hold int32 codes")
        live = data[valid]
        if live.size and (live.min() < 0 or live.max() >= len(values)):
            raise ValueError(f"string slot {slot}: code outside its dictionary")
    entry = RegionColumns(handles, n, out_cols, range_start=region_bounds[0], range_end=region_bounds[1])
    region = RegionView(cache.next_region_id(), table_id, entry, cache)
    cache.add_region(region.region_id, table_id, entry)
    return region


def dag_from_pb(pb: dict) -> dagpb.DAGRequest:
    """The port's DAGRequest for the dict the reference's ``to_pb`` wrote."""
    return dagpb.DAGRequest.from_pb(pb)

