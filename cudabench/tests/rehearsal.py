"""A run of a cell on the CPU at a small size, for the tests: everything
a chip run does after its look for a card (``harness.run_cell``)."""

from __future__ import annotations

import json
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
ROWS = {"lineitem": 40_000}
SPLIT_KEYS = 8_000  # several regions of lineitem at this size
SEED = 2**31 + 977  # seeds past 32 signed bits are valid input


def bench() -> dict:
    return json.loads((ROOT / "BENCHMARK.json").read_text())


def run(cell: str, trace: bool = False, seconds: float = 1.0, bench_spec: dict | None = None) -> dict:
    from cudabench import harness

    return harness.run_cell(bench_spec or bench(), cell, SEED, seconds, trace, device="cpu", rows=ROWS,
                            split_keys=SPLIT_KEYS, say=lambda *_a: None)
