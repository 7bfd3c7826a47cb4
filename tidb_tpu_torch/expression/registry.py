"""Builtin registry (port of tidb_tpu/expression/registry.py).

Implementations receive ``(xp, args, ctx)`` and return ``(data, validity)``
with MySQL NULL semantics (validity None = all valid). They are written with
Python operators only, so one body serves torch tensors on any device and
the numpy object arrays the binder's exact corner evaluation uses; ``xp``
is kept for the reference's call contract and names that backend.

Only the builtins this slice's DAGs use are registered; the binder rejects
any other signature with ``UnsupportedForDevice``.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable

from tidb_tpu_torch.types import FieldType
from tidb_tpu_torch.types.field_type import bool_type, merge_types

GPU_ENGINE = frozenset({"gpu"})


@dataclass
class FuncSpec:
    name: str
    impl: Callable  # (xp, args, ctx) -> (data, validity)
    infer: Callable  # (arg_ftypes) -> FieldType
    engines: frozenset = GPU_ENGINE


REGISTRY: dict[str, FuncSpec] = {}


def register(name: str, infer, engines=GPU_ENGINE):
    def deco(fn):
        REGISTRY[name] = FuncSpec(name, fn, infer, engines)
        return fn

    return deco


def and_valid(xp, *vs):
    """Combine validity masks (None = all valid)."""
    out = None
    for v in vs:
        if v is None:
            continue
        out = v if out is None else (out & v)
    return out


def infer_bool(args) -> FieldType:
    return bool_type()


def infer_merge(args) -> FieldType:
    t = args[0]
    for a in args[1:]:
        t = merge_types(t, a)
    return t
