"""Drive the tidb_tpu_torch port's main path on one CUDA card and check it.

    python3 chip_smoke.py [--seed N]

1. Prints the card (name and power limit as nvidia-smi reports them) and
   builds every hand-written kernel from csrc/, plus K1's stress build (one
   table copy, the fewest blocks: 65,536 rows per block), one nvcc per
   library, all started together. Prints each library's register and
   shared-memory report and the shared-atomic opcodes in its SASS.
2. Holds K1 (the CUDA grouped-sum kernel) bit-exact against its plain
   PyTorch version at its edge shapes and on adversarial lanes: every live
   row in one bucket at ±(2^45 - 1) over 7,999,488 rows, int32 lanes at
   ±(2^31 - 1), constant lanes, lanes sharing one weight tensor, L = 20,
   B = 65 and 512.
3. Generates TPC-H lineitem at scale factor 1 (6,001,215 rows, the
   specification's column domains, from --seed) and runs the eight fixture
   DAGs (COUNT(*), Q6, Q1, the Q10 TopN, the 160-bucket grouped sum, Q18's
   inner GROUP BY l_orderkey, Q15's revenue view and a grouped MIN/MAX/
   BIT_OR/BIT_XOR) through gpu_engine.execute_region in two configurations:
   two regions split at the middle handle, one 4,194,304-row device block
   each, and the whole table as one region of two blocks (the reference
   bench's layout), where each DAG's engine path and aggregation route
   must be the reference's. Every result must equal the port's CPU path
   row for row, the merged partial results of each configuration must
   equal an independent numpy oracle exactly, and the two configurations
   each other. K1's launch count must rise during the band query and not
   during Q1 in the two-region run. Prints each task's warm wall, device
   span, busy time, idle share and concatenation time, each DAG's path,
   route and agg-cap regrows, and the band query's lex-route busy time
   beside its K1-route time.
4. Holds K1 against its plain version on the exact inputs the main path
   gave it and times kernel, plain version and one ``index_add_`` call over
   the same distinct weight and value columns; on Q1's own grouped-sum
   input it times K1 beside the int8 dot route that Q1 takes.
5. Runs the SQL front over the same lineitem: ``tidb_tpu_torch.open``
   with the table bulk-loaded and split at the middle handle into two
   regions, the seven statements of ``SQL_QUERIES`` (the reference bench's
   COUNT(*), Q6, Q1 and Q10, the band query, Q15's revenue view, Q1's
   groups WITH ROLLUP) once cold and ten times warm. Every result must
   equal the numpy oracle's final rows, every cop task must run on the
   ``gpu`` engine with none degraded, and K1 must launch during the band
   query and not during Q1. Prints the load time and the row codec, and
   per statement the cold wall, the warm SQL wall, the summed cop-task
   walls and the SQL-layer tax between them.
6. HTAP, on the same database: about 1,000 lines of the first region
   updated (one price past the int32 envelope, one quantity past 50),
   about 200 of the second deleted and 300 inserted, pending as deltas
   under the compactor's fold threshold. The seven statements run once
   cold and ten times warm with the delta operand and must equal the
   oracle over the written columns, on ``gpu``, none degraded, every task
   folding its region's delta; K1 must launch during band (n = 4,202,496
   per task) and not during Q1, and equal its plain version on the delta
   path's inputs. Prints per statement the warm median beside phase 5's
   and the host engine's median of 3, and the delta operand's bytes and
   upload time; then the compactor folds the deltas and the statements
   equal the oracle again.
7. The device builtins, on the same database with the writes folded in:
   the seven statements of ``BUILTIN_QUERIES`` (Q12's and Q19's lineitem
   predicates, GROUP BY YEAR and YEAR, MONTH, the band query under NOT,
   =, OR and IS NULL, DIV/%/ABS/ROUND/CAST, BIT_COUNT/>>/SQRT/LN) once
   cold and ten times warm; each must equal its numpy oracle on ``gpu``,
   none degraded, with bytes copied off the card, and K1 must launch
   during ``bandf``. Prints per statement its tasks' paths and routes, the
   warm median, the summed and longest cop-task walls and the host
   engine's median of 3. Then every gpu-legal builtin (91), each argument
   signature of ``BUILTIN_CASES``, runs over 4,194,304-row lanes on the
   card against the same body in numpy on the host, printed as one
   ``{"builtins": {...}}`` line (names exact, names within tolerance,
   the worst float distance in ulps).
8. Windows, over the phase-3 columns loaded as ONE region (two blocks:
   the reference bench's layout): the eight ``WINDOW_QUERIES`` (bench.py's
   WINDOWED; RANK/DENSE_RANK/PERCENT_RANK/CUME_DIST; LAG/LEAD/NTILE/
   FIRST_VALUE/LAST_VALUE over 10,000 supplier partitions; a bounded ROWS
   frame; running MIN/MAX; a string order key; a window then TopN; a
   window over a 1.5M-group aggregate at the root), each once cold and
   five times warm, each equal to the port's host engine on the same
   database, on ``gpu``, none degraded, the window inside the task (path
   ``fused``) but for the root one, whose cost-model choice is printed.
   Prints per statement the packed sort key's bits, the warm median, the
   cop-task walls, the host engine's wall and one profiled task's device
   busy time and top ops. Then ``htap_writes`` on this database: WINDOWED
   merges the pending delta first and equals the host engine. Last, the
   ``{"window_costs": ...}`` line: both sides of the root's device/host
   cost model at the root window's input, and the constants they imply.
9. MPP: lineitem's six join and aggregate columns (the phase-3 arrays
   and their part keys), orders (one per order key, o_custkey over the
   two thirds of SF1's 150,000 customers that have orders, o_orderdate
   drawn independently of lineitem's dates), customer (150,000, five
   market segments) and part (200,000, 25 brands, 40 containers), one
   region each, ANALYZEd; the four ``MPP_QUERIES`` (bench.py's Q3, TPC-H
   Q3 with JOIN ... ON, TPC-H Q17, a TopN over lineitem ⋈ orders) at 1
   and 4 virtual shards on the store's card (``parallel.mesh.
   FORCE_DEVICES`` its one handle, on any machine), each once cold and
   five times warm. Each must
   equal the numpy oracle and the port with ``tidb_allow_mpp = 0``, plan
   one ``PhysMPPGather`` with ``MPP_PLANS``' fragments and stages, report
   no retry and no fallback event; K1 must not launch. Prints per
   statement the warm median, the ``tidb_allow_mpp = 0`` wall, the
   gather's wall, per-shard rows and exchanged bytes, ``stage_bytes``
   and one profiled run's device busy time and top ops.
10. The process topology: a store child process (``chip_smoke.py
   --store-child``) owns the card and holds the phase-3 lineitem again as
   two regions and the MPP tables (database ``mpp``, ANALYZEd); a SQL
   layer booted as ``python -m tidb_tpu_torch --store remote`` answers a
   MySQL client, and ``tidb_tpu_torch.open(remote=...)`` in this process
   is a second SQL layer. ``SQL_QUERIES`` and ``MPP_QUERIES``' q3 and q17
   run through both, once cold and five times warm: rows equal to the
   oracle (the wire's as text), ``[gpu]`` readers, one ``PhysMPPGather``
   for q3/q17 with no retry and no fallback, no task degraded, K1 exactly
   2 launches per band statement in the store and none in this process,
   the SQL-layer process holding no CUDA context. Prints per statement
   the warm medians over the wire and in process, the longest cop task
   (or the gather's wall), the wire tax and the tasks' wire time. Then a
   boot check at a small size: ``python -m tidb_tpu_torch --store-server``
   and ``--store remote`` with a status port (CREATE, INSERT, a grouped
   SELECT equal to the embedded port's, ``/status``, rc 0 on SIGTERM).
11. Partitioned tables: the phase-3 lineitem generated from the same seed,
   created ``PARTITION BY RANGE (l_orderkey)`` with four partitions at the
   quartiles of its order keys (about 1.5M rows each) and loaded through
   ``bulk_load``. ``SQL_QUERIES`` run once cold and ten times warm, each
   equal to the oracle with one ``gpu`` task per partition, none
   degraded, K1 launching 4 times per band statement and never during
   Q1; Q6 pruned by its order key plans one task and the band query over
   ``PARTITION (p1, p2)`` two, each equal to the oracle over its rows. K1
   equals its plain version on the band statements' inputs. Prints the
   warm medians beside phase 5's, the task counts and cop-task walls.
12. graftfuzz on the card: ``python -m tidb_tpu_torch.tools.fuzz --seed 42
   --cases 300 --query-pool 6 --device cuda`` (the reference's tier-1
   smoke lane) must come back clean with its device sessions on ``gpu``;
   the reference corpus's five SPECs replay through the port's
   ``run_repro``; under an injected +1 on the gpu engine's first int64
   lane a 4-case campaign finds, shrinks and reproduces the bug.
13. Getting data in and out (``_import_phase``), on ``tidb_tpu_torch.open()``
   with the default region size: 698,000 generated lineitem rows written
   as CSV and loaded with ``LOAD DATA INFILE``, the first 300,000 imported
   with ``IMPORT INTO`` under ``tidb_enable_dist_task = 1`` (three
   subtasks); ``SQL_QUERIES`` over both, cold and five times warm, equal
   to the oracle on ``gpu`` with K1 in band and not in Q1; a 500-row
   append with a new return flag read as the delta operand and a
   200,000-row one that rebuilds the blocks; ``BACKUP`` and ``RESTORE``
   into a second database; a point-in-time restore from the log backup
   after ``htap_writes``; the band statement's plan replayer dump
   explaining the same ``[gpu]`` readers in a fresh handle; the
   hbm-pressure inspection row at the planner's budget and the diag
   bundle. K1 is held against its plain version on the band inputs.
14. The last reference modules. (a) ``python -m tidb_tpu_torch.tools.check
   --json`` (graftcheck over the port, its own empty baseline) exits 0,
   clean. (b) A child (``chip_smoke.py --lockcheck-child``,
   ``TIDB_TPU_LOCKCHECK=1``) installs the port's lock-order detector
   before it imports any other module of the package, checks that the
   port's locks are checked ones, and runs phase 5 again (SF1, two
   regions, the statements cold and five times warm, K1 in band and built
   by nvcc in the child under ``native.cuda._MU``), ``htap_writes`` read
   back, and bench.py's Q3 at 4 virtual shards; a lock-order cycle on any
   thread fails it. Prints the checked locks, the edges recorded, K1's
   launches and the warm medians beside phase 5's (the detector's cost).
   (c) ``python -m tidb_tpu_torch.bench.benchdaily --device cuda`` over
   28 of its 31 lanes, twice, the second run under ``--check`` against
   the first; the three lanes with a 5 % overhead budget
   (``BUDGET_LANES``) are left out: their gates breach on the reference
   itself from run to run, so they run alone beside the smoke. Then
   ``benchdb --device cuda --run BENCHDB_RUN`` must leave 9,000 rows.
15. MPP over every card (``_mpp_devices_phase``; it runs right after
   phase 9, on phase 9's database, which it then closes): the four
   statements with phase 9's checks at width 4 over a mesh of several
   workers, four logical devices on the store's card (four threads,
   four streams, the exchanges carried between them) and, on a machine
   with two cards or more, one shard per card (peer copies). Prints the
   card count and each card's line, peer access between each pair of
   cards, each layout's workers, per statement the cold wall, the warm
   median of five beside phase 9's 4-virtual-shard median, and per
   worker its shards' rows, its stream's event-timed wall, the bytes it
   handed to the other workers in one run, and each card's peak memory.
   K1 must not launch. ``chip_smoke.py --mpp-only`` runs phases 9 and 15
   alone (SF1 generated, no kernel built), then benchdaily's three scaling
   lanes in this process (``_scaling_lanes``): on several cards one shard
   per card up to the card count under the per-chip gate, on one card
   virtual shards under the total gate; it prints each curve and exits
   non-zero if a gate breached.
16. Prints the ``{"kernels": [...]}`` line (``launches``: the SQL path's
   count over its single drive; ``launches_dag_path``,
   ``launches_delta_path``, ``launches_builtins_path``,
   ``launches_mpp_path``, ``launches_mpp_devices_path``,
   ``launches_remote_path``, ``launches_partition_path``,
   ``launches_fuzz_campaign``, ``launches_import_path``,
   ``launches_lockcheck_path``, ``launches_bench_path`` and
   ``launches_probe_path`` the DAG, HTAP, builtins, MPP, multi-worker MPP,
   remote, partition, fuzz, import, lockcheck, bench and probe phases', the
   remote one counted in the store process, the fuzz one in the campaign's,
   the lockcheck one in its child and the bench one in benchdaily's
   processes and benchdb's run), then, last, the ``{"ok": true, "device":
   {...}}`` line.
17. The engine's chip probe and cold builds (``_probe_phase``; it runs
   right after phase 5, on its database, before phase 6 writes to it).
   For COUNT(*), Q6, Q1, Q10 and band one cop task is captured through
   the SQL layer as bench.py's ``chip_time`` does, and
   ``gpu_engine.device_probe_fn`` built over it: the last of 32
   ``run_once`` calls (then one sync) must decode to the task's chunk bit
   for bit, K1 must launch once per ``run_once`` in band and never in the
   others; a descending scan, nine ranges, a window, a LIMIT-last task
   over several blocks and an agg-cap overflow must be refused with
   ValueError. Then each statement with a predicate no row fails (a
   program new to the process) runs under EXPLAIN ANALYZE, which must
   show ``compile:``, its cop tasks charging ``compile_ms`` > 0 and
   ``COP_COMPILE_SECONDS`` growing by the programs built, and again warm,
   charging nothing, with the oracle's rows. Prints per statement the
   amortized ms, the host syncs per ``run_once``, the cold ``compile_ms``
   and, for band, whether K1's build fell inside it.

Any failed check raises, so the script exits non-zero and prints no result
line. It imports torch and the port only.
"""

from __future__ import annotations

import argparse
import datetime as dt
import gc
import json
import os
import re
import shutil
import statistics
import subprocess
import sys
import time
from decimal import Decimal

import numpy as np

HBM_BYTES_PER_S = 3.35e12  # H100 SXM HBM3 (NVIDIA data sheet)
FP32_OPS_PER_S = 67e12  # H100 SXM non-tensor-core peak, the nearest table rate for integer adds
SF1_ROWS = 6_001_215
# K1's stress build: one table copy and the fewest blocks, so a block's
# chunk of up to 65,536 rows lands in one set of 32-bit cells
STRESS_DEFINES = ("K1_REPLICAS=1", "K1_GRID=1")


def _card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def _time_ms(fn, reps: int = 25, warm: int = 3) -> float:
    """Median device time of one call (CUDA events around each call)."""
    import torch

    for _ in range(warm):
        fn()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


# -- K1 ----------------------------------------------------------------------


def _k1_synthetic(n_pad: int, B: int, L: int, seed: int):
    """seg with ~10% dead rows (both seg >= B and seg < 0), L lanes with
    values at ±(2^45 - 1) mixed in, the last lane int32."""
    import torch

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(seed)
    vmax = (1 << 45) - 1
    seg = torch.randint(0, B, (n_pad,), generator=g, device=dev, dtype=torch.int32)
    u = torch.rand(n_pad, generator=g, device=dev)
    seg = torch.where(u < 0.05, B + (seg % 7), seg)
    seg = torch.where((u >= 0.05) & (u < 0.1), -1 - (seg % 7), seg)
    pairs = []
    for k in range(L):
        if k == L - 1:
            v = torch.randint(-(1 << 30), 1 << 30, (n_pad,), generator=g, device=dev, dtype=torch.int32)
        else:
            v = torch.randint(-vmax, vmax + 1, (n_pad,), generator=g, device=dev, dtype=torch.int64)
            r = torch.rand(n_pad, generator=g, device=dev)
            v = torch.where(r < 0.05, vmax, torch.where(r > 0.95, -vmax, v))
        pairs.append((v, torch.rand(n_pad, generator=g, device=dev) < 0.8))
    return seg, pairs


def _k1_adversarial(n_pad: int, B: int, seed: int, hot: bool = False, extra: int = 0):
    """(seg, pairs, bounds): lanes as the engine builds them and at their
    edges. COUNT(*) and occupancy lanes (zeros, bounds (0, 0)); int64 lanes
    at ±(2^45 - 1) with no bounds; int32 lanes at ±(2^31 - 1), with and
    without bounds; a constant lane lo == hi != 0 and the same values with
    no bounds; lanes sharing one weight tensor; ``extra`` more int64 lanes
    with their own weights. ``hot`` puts every live row in bucket B - 1."""
    import torch

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(seed)
    vmax = (1 << 45) - 1
    i32max = (1 << 31) - 1
    seg = torch.full((n_pad,), B - 1, dtype=torch.int32, device=dev) if hot else torch.randint(
        0, B, (n_pad,), generator=g, device=dev, dtype=torch.int32)
    u = torch.rand(n_pad, generator=g, device=dev)
    seg = torch.where(u < 0.05, B + 3, torch.where(u < 0.1, -2, seg))
    mask = torch.rand(n_pad, generator=g, device=dev) < 0.9
    other = torch.rand(n_pad, generator=g, device=dev) < 0.6

    def edge(vm, dtype):
        x = torch.where(torch.rand(n_pad, generator=g, device=dev) < 0.5, vm, -vm)
        return x.to(dtype)

    zero = torch.zeros(n_pad, dtype=torch.int64, device=dev)
    const = torch.full((n_pad,), -7, dtype=torch.int64, device=dev)
    e64, i32 = edge(vmax, torch.int64), edge(i32max, torch.int32)
    lanes = [
        ((zero, mask), (0, 0)),
        ((e64, mask), None),
        ((e64, other), None),
        ((i32, mask), None),
        ((i32, mask), (-i32max, i32max)),
        ((const, other), (-7, -7)),
        ((const, mask), None),
        ((zero, mask), (0, 0)),
    ]
    for _ in range(extra):
        lanes.append(((edge(vmax, torch.int64), torch.rand(n_pad, generator=g, device=dev) < 0.7), None))
    return seg, [p for p, _ in lanes], [b for _, b in lanes]


def _k1_err(seg, pairs, B: int, n_pad: int, bounds=None, fn=None) -> int:
    """Launch K1 (``fn``, a C entry point, or the port's own library) and
    raise unless it equals the plain version bit for bit."""
    import torch

    from tidb_tpu_torch.ops import grouped_sums as gs

    if fn is None:
        c, s = gs.grouped_sums(seg, pairs, B, n_pad, bounds, device=seg.device)
    else:
        c, s = gs.launch(fn, seg, pairs, B, n_pad, bounds)
    pc, ps = gs.grouped_sums_plain(seg, pairs, B, n_pad, bounds)
    torch.cuda.synchronize()
    err = max(int((c - pc).abs().max()), int((s - ps).abs().max()))
    if err != 0:
        raise AssertionError(f"K1 disagrees with its plain version at B={B} n_pad={n_pad} L={len(pairs)}: {err}")
    return err


def _k1_work_ref(seg, pairs, B: int):
    """(bytes, adds) under the reference's contract: seg for every row, each
    lane's weight for every live row and its value for every weighted live
    row, both outputs once; a count and a sum add per lane and weighted row."""
    live = (seg >= 0) & (seg < B)
    nl = int(live.sum())
    nbytes = seg.numel() * 4 + 2 * B * len(pairs) * 8
    adds = 0
    for v, w in pairs:
        nw = int((live & w).sum())
        nbytes += nl + nw * v.element_size()
        adds += 2 * nw
    return nbytes, adds


def _k1_work(seg, pairs, B: int, bounds):
    """(bytes, adds) the bounded call needs: seg for every row; each
    distinct weight column for every live row; each distinct non-constant
    value slot for every weighted live row; both outputs once; one add per
    weighted row of each weight column and of each slot."""
    from tidb_tpu_torch.ops import grouped_sums as gs

    live = (seg >= 0) & (seg < B)
    nl = int(live.sum())
    weights, slots = {}, {}
    for g in gs.plan(pairs, bounds, B):
        for w in g.weights:
            weights[id(w)] = w
        for v, lo, wcol, _p in g.slots:
            slots[(id(v), id(g.weights[wcol]), lo)] = (v, g.weights[wcol])
    nbytes = seg.numel() * 4 + 2 * B * len(pairs) * 8 + nl * len(weights)
    adds = sum(int((live & w).sum()) for w in weights.values())
    for v, w in slots.values():
        nw = int((live & w).sum())
        nbytes += nw * v.element_size()
        adds += nw
    return nbytes, adds


def _bound(nbytes: int, adds: int):
    """(bound_ms, bound_by): the larger of bytes over the memory rate and
    integer adds over the card's non-tensor peak."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = adds / FP32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def _device_ms(fn, match: str = "", reps: int = 20):
    """Mean device time per call of ``fn``'s kernels whose name holds
    ``match`` (all kernels if empty), from torch.profiler; None when the
    profiler records no device time."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    total = sum(
        e.self_device_time_total
        for e in prof.key_averages()
        if getattr(e, "device_type", None) == DeviceType.CUDA and match in e.key
    )
    return total / 1e3 / reps if total > 0 else None


def _host_ms(fn, reps: int = 50) -> float:
    """Host time per call of ``fn`` with its launches queued, not waited
    for: what the wrapper costs the calling thread."""
    import torch

    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    host = (time.perf_counter() - t0) / reps * 1e3
    torch.cuda.synchronize()
    return host


def _k1_library(seg, pairs, B: int, bounds):
    """The library yardstick for the bounded call: one ``index_add_`` into
    B + 1 buckets (dead rows to the extra one) of the same work the kernel
    does, one column per distinct weight tensor and one (weight × value)
    column per distinct non-constant (value, weight) pair. Its operands are
    built here, outside any timing. → (call, (counts, sums) from its
    output)."""
    import torch

    from tidb_tpu_torch.ops import grouped_sums as gs

    cols, index, lanes = [], {}, []

    def column(key, make):
        if key not in index:
            index[key] = len(cols)
            cols.append(make())
        return index[key]

    for (v, w), b in zip(pairs, bounds if bounds is not None else [None] * len(pairs)):
        lo, _hi, constant = gs._lane_bounds(v, b)
        c = column(id(w), lambda: w.to(torch.int64))
        s = None if constant else column((id(v), id(w)), lambda: torch.where(w, v.to(torch.int64), 0))
        lanes.append((c, s, lo))
    seg_c = torch.where((seg >= 0) & (seg < B), seg, B).to(torch.int64)
    src = torch.stack(cols, dim=1)
    out = torch.zeros(B + 1, len(cols), dtype=torch.int64, device=seg.device)

    def call():
        out.zero_()
        out.index_add_(0, seg_c, src)

    def result():
        counts = torch.stack([out[:B, c] for c, _s, _lo in lanes], dim=1)
        sums = torch.stack([out[:B, c] * lo if s is None else out[:B, s] for c, s, lo in lanes], dim=1)
        return counts, sums

    return call, result


def _k1_timings(seg, pairs, B: int, n_pad: int, bounds) -> dict:
    import torch

    from tidb_tpu_torch.ops import grouped_sums as gs

    dev = seg.device
    library, library_result = _k1_library(seg, pairs, B, bounds)
    library()
    lc, ls = library_result()
    pc, ps = gs.grouped_sums_plain(seg, pairs, B, n_pad, bounds)
    if not (torch.equal(lc, pc) and torch.equal(ls, ps)):
        raise AssertionError("index_add_ yardstick disagrees with the plain version")
    call = lambda: gs.grouped_sums(seg, pairs, B, n_pad, bounds, device=dev)  # noqa: E731
    return {
        "ms": _time_ms(call),
        "device_ms": _device_ms(call, "grouped_sums"),
        "host_ms": _host_ms(call),
        "plain_ms": _time_ms(lambda: gs.grouped_sums_plain(seg, pairs, B, n_pad, bounds)),
        "library_ms": _time_ms(library),
        **dict(zip(("bound_ms", "bound_by"), _bound(*_k1_work(seg, pairs, B, bounds)))),
        "ref_contract_bound_ms": _bound(*_k1_work_ref(seg, pairs, B))[0],
    }


def _sass_atomics(lib_path) -> str:
    """The atomic opcodes in a library's SASS with their counts, or why
    there are none to show."""
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    if not os.path.exists(tool):
        return "cuobjdump not found"
    out = subprocess.run([tool, "-sass", str(lib_path)], capture_output=True, text=True, timeout=120)
    if out.returncode != 0:
        return f"cuobjdump failed: {out.stderr.strip()[:200]}"
    ops: dict = {}
    for m in re.finditer(r"\b((?:ATOMS|ATOMG|ATOM|RED|REDG)\.[A-Z0-9_.]+)", out.stdout):
        ops[m.group(1)] = ops.get(m.group(1), 0) + 1
    return ", ".join(f"{k} x{v}" for k, v in sorted(ops.items())) or "no atomics"


# -- TPC-H lineitem at SF1 -----------------------------------------------------

RETURNFLAGS = [b"A", b"N", b"R"]
NEW_RETURNFLAG = b"X"  # a return flag the generated table never holds (code 3)
IMPORT_RETURNFLAGS = RETURNFLAGS + [NEW_RETURNFLAG]
LINESTATUS = [b"F", b"O"]
SHIPMODES = [b"REG AIR", b"AIR", b"RAIL", b"SHIP", b"TRUCK", b"MAIL", b"FOB"]
SHIPINSTRUCTS = [b"DELIVER IN PERSON", b"COLLECT COD", b"NONE", b"TAKE BACK RETURN"]


def _days(d: dt.date) -> int:
    return (d - dt.date(1970, 1, 1)).days


def lineitem_keys(rng, partkey: np.ndarray, n_supp: int):
    """(l_orderkey, l_suppkey, l_linenumber) in TPC-H §4.2.3's domains:
    consecutive orders of 1..7 lines under the spec's sparse order keys
    (the first 8 of every 32), line numbers 1..7 within an order, and each
    line's supplier one of its part's four, (partkey + i * (S/4 + (partkey
    - 1) // S)) mod S + 1 for i in 0..3, with S = ``n_supp`` suppliers."""
    n = len(partkey)
    lines = rng.integers(1, 8, n)  # n orders of at least one line cover n rows
    ends = np.cumsum(lines)
    order = np.searchsorted(ends, np.arange(n), side="right")
    orderkey = (order // 8) * 32 + order % 8 + 1
    linenumber = np.arange(n) - (ends - lines)[order] + 1
    i = rng.integers(0, 4, n)
    suppkey = (partkey + i * (n_supp // 4 + (partkey - 1) // n_supp)) % n_supp + 1
    return orderkey.astype(np.int64), suppkey.astype(np.int64), linenumber.astype(np.int64)


def lineitem_sf1(seed: int, n: int = SF1_ROWS) -> dict:
    """Fourteen lineitem columns in TPC-H §4.2.3's domains: the twelve the
    fixture DAGs read (quantity 1..50; extendedprice = quantity *
    retailprice(partkey) over SF1's 200,000 parts; discount 0.00..0.10;
    tax 0.00..0.08; order date uniform in [1992-01-01, 1998-08-02], ship
    date 1..121 days later, receipt date 1..30 after that; returnflag R/A
    if received by 1995-06-17 else N; linestatus O if shipped after
    1995-06-17 else F; then order key, supplier key (SF1's 10,000
    suppliers) and line number (``lineitem_keys``)), then the commit date
    (order date + 30..90 days) and the receipt date, which Q12's
    predicates read. Each row draws its own order date (the order table
    is not generated). Decimals are scaled integers (DECIMAL(12,2)), dates
    are days since 1970-01-01, strings are codes into the lists above."""
    rng = np.random.default_rng(seed)
    qty = rng.integers(1, 51, n)
    partkey = rng.integers(1, 200_001, n)
    retail = 90_000 + (partkey // 10) % 20_001 + 100 * (partkey % 1000)  # cents
    orderdate = rng.integers(_days(dt.date(1992, 1, 1)), _days(dt.date(1998, 8, 2)) + 1, n)
    ship = orderdate + rng.integers(1, 122, n)
    receipt = ship + rng.integers(1, 31, n)
    current = _days(dt.date(1995, 6, 17))
    rf = np.where(receipt <= current, np.where(rng.random(n) < 0.5, 2, 0), 1).astype(np.int32)
    cols = {
        0: qty.astype(np.int64) * 100,
        1: (qty * retail).astype(np.int64),
        2: rng.integers(0, 11, n).astype(np.int64),
        3: rng.integers(0, 9, n).astype(np.int64),
        4: rf,
        5: (ship > current).astype(np.int32),
        6: ship.astype(np.int64),
        7: rng.integers(0, len(SHIPMODES), n).astype(np.int32),
        8: rng.integers(0, len(SHIPINSTRUCTS), n).astype(np.int32),
    }
    # drawn after the nine columns above, which keep their values
    cols[9], cols[10], cols[11] = lineitem_keys(rng, partkey, 10_000)
    # drawn after the twelve above, which keep their values
    cols[12] = orderdate + rng.integers(30, 91, n)
    cols[13] = receipt.astype(np.int64)
    return cols


def make_regions(cols: dict, table_id: int, parts: int = 2):
    """``parts`` regions split at equal handle counts (handles 1..n), sharing
    one ColumnCache so string codes agree; → [(region, ranges)]. One part
    is the whole table in one region over the full record range."""
    from tidb_tpu_torch.copr.carry import region_from_arrays
    from tidb_tpu_torch.kv import tablecodec

    n = len(cols[0])
    handles = np.arange(1, n + 1, dtype=np.int64)
    cuts = [n * i // parts for i in range(parts + 1)]
    dicts = {4: RETURNFLAGS, 5: LINESTATUS, 7: SHIPMODES, 8: SHIPINSTRUCTS}
    full = tablecodec.record_range(table_id)
    keys = [full.start] + [tablecodec.record_key(table_id, int(handles[c])) for c in cuts[1:-1]] + [full.end]
    out = []
    cache = None
    for lo, hi, start, end in zip(cuts, cuts[1:], keys, keys[1:]):
        sl = {s: (c[lo:hi], np.ones(hi - lo, bool)) for s, c in cols.items()}
        r = region_from_arrays(handles[lo:hi], sl, dicts, table_id, (start, end), cache=cache)
        cache = r.cache
        out.append((r, [tablecodec.KeyRange(start, end)]))
    return out


# -- the SQL front ----------------------------------------------------------------

SQL_SCHEMA = """CREATE TABLE lineitem (
    l_quantity DECIMAL(12,2), l_extendedprice DECIMAL(12,2),
    l_discount DECIMAL(12,2), l_tax DECIMAL(12,2),
    l_returnflag VARCHAR(1), l_linestatus VARCHAR(1), l_shipdate DATE,
    l_shipmode VARCHAR(10), l_shipinstruct VARCHAR(25),
    l_orderkey BIGINT, l_suppkey BIGINT, l_linenumber BIGINT,
    l_commitdate DATE, l_receiptdate DATE)"""

# the reference bench's statements (bench.py: COUNT_STAR, Q6, Q1, Q10), the
# band query the 160-bucket DAG computes, Q15's revenue view, and Q1's
# groups WITH ROLLUP (every grouping set in one pass on the device)
SQL_QUERIES = {
    "count": "SELECT COUNT(*) FROM lineitem",
    "q6": """SELECT SUM(l_extendedprice * l_discount) FROM lineitem
  WHERE l_shipdate >= DATE '1994-01-01' AND l_shipdate < DATE '1995-01-01'
    AND l_discount BETWEEN 0.05 AND 0.07 AND l_quantity < 24""",
    "q1": """SELECT l_returnflag, l_linestatus,
    SUM(l_quantity), SUM(l_extendedprice),
    SUM(l_extendedprice * (1 - l_discount)),
    SUM(l_extendedprice * (1 - l_discount) * (1 + l_tax)),
    AVG(l_quantity), AVG(l_extendedprice), AVG(l_discount), COUNT(*)
  FROM lineitem WHERE l_shipdate <= DATE '1998-09-02'
  GROUP BY l_returnflag, l_linestatus ORDER BY l_returnflag, l_linestatus""",
    "q10": """SELECT l_returnflag, l_extendedprice FROM lineitem
  WHERE l_shipdate >= DATE '1994-01-01'
  ORDER BY l_extendedprice DESC LIMIT 20""",
    "band": """SELECT l_shipmode, l_shipinstruct, l_returnflag, COUNT(*),
    SUM(l_quantity), SUM(l_extendedprice)
  FROM lineitem GROUP BY l_shipmode, l_shipinstruct, l_returnflag""",
    "q15rev": """SELECT l_suppkey, SUM(l_extendedprice * (1 - l_discount)) FROM lineitem
  WHERE l_shipdate >= DATE '1996-01-01' AND l_shipdate < DATE '1996-04-01'
  GROUP BY l_suppkey""",
    "rollup": """SELECT l_returnflag, l_linestatus, COUNT(*), SUM(l_quantity), SUM(l_extendedprice)
  FROM lineitem GROUP BY l_returnflag, l_linestatus WITH ROLLUP""",
}
# statements whose row order the SQL fixes (ORDER BY); the others compare
# as sets of rows
SQL_ORDERED = ("q1", "q10")


def lineitem_sql(db, bulk_load, record_key, cols: dict, parts: int = 2, schema: str = SQL_SCHEMA) -> float:
    """Create the fourteen-column lineitem in ``db`` (a handle opened with no
    automatic region split) from ``schema``, bulk-load the generated ``cols``
    (string codes decoded to their bytes) and split it into ``parts``
    regions at equal handle counts (handles 1..n, ``make_regions``' cuts).
    ``bulk_load`` and ``record_key`` are the handle's own package's. → load
    seconds."""
    db.execute(schema)
    data = [cols[i] for i in range(len(cols))]
    for slot, values in ((4, RETURNFLAGS), (5, LINESTATUS), (7, SHIPMODES), (8, SHIPINSTRUCTS)):
        data[slot] = np.array(values)[cols[slot]]
    t0 = time.perf_counter()
    bulk_load(db, "lineitem", data)
    load_s = time.perf_counter() - t0
    n = len(cols[0])
    table_id = db.catalog.table("test", "lineitem").id
    for i in range(1, parts):
        db.store.split_region(record_key(table_id, n * i // parts + 1))
    return load_s


def sql_oracle(name: str, c: dict) -> list[tuple]:
    """The statement's final rows from the numpy oracle, merged as the SQL
    layer merges the partials: AVG is the sum over the count at the
    argument's scale + 4, rounded half away from zero; Q1 and Q10 in their
    ORDER BY order, the others sorted by ``repr``."""
    want = oracle(name, c)
    if name == "q10":
        return [(f, p) for p, f, _d in want]
    if name == "q1":
        rows = []
        for key in sorted(want):
            sq, sp, sdp, sch, cnt, _sq, _c1, _sp, _c2, sd, _c3 = want[key]
            avg = [_dec((int(x.scaleb(2)) * 10**4 + cnt // 2) // cnt, 6) for x in (sq, sp, sd)]
            rows.append((*key, sq, sp, sdp, sch, *avg, cnt))
        return rows
    if name in ("band", "q15rev", "rollup"):
        return sorted(((*k, *v) for k, v in want.items()), key=repr)
    return [want[()]]


def sql_rows(name: str, rows: list) -> list:
    """A statement's rows in the order ``sql_oracle`` gives them."""
    return list(rows) if name in SQL_ORDERED else sorted(rows, key=repr)


# -- the device builtins: seven statements whose filters, keys and arguments
# need builtins beyond + - * < <= >= (TPC-H Q12's and Q19's lineitem
# predicates, date parts, NOT/=/OR/IS NULL over the band query, DIV, %,
# ABS, ROUND, CAST, BIT_COUNT, >>, SQRT, LN); each must plan [gpu]
BUILTIN_QUERIES = {
    # Q12's lineitem side; its CASE reads l_linestatus and l_returnflag
    # (the orders table, whose priority Q12 counts, is not generated)
    "q12li": """SELECT l_shipmode, SUM(CASE WHEN l_linestatus = 'O' THEN 1 ELSE 0 END),
    SUM(CASE WHEN l_returnflag = 'R' THEN 1 ELSE 0 END), COUNT(*) FROM lineitem
  WHERE l_shipmode IN ('MAIL', 'SHIP') AND l_commitdate < l_receiptdate AND l_shipdate < l_commitdate
    AND l_receiptdate >= DATE '1994-01-01' AND l_receiptdate < DATE '1995-01-01'
  GROUP BY l_shipmode""",
    # Q19's lineitem side: the spec's modes ('AIR REG' is not in the data,
    # whose mode is 'REG AIR'), its instruction and its three quantity ranges
    "q19li": """SELECT SUM(l_extendedprice * (1 - l_discount)) FROM lineitem
  WHERE l_shipmode IN ('AIR', 'AIR REG') AND l_shipinstruct = 'DELIVER IN PERSON'
    AND ((l_quantity >= 1 AND l_quantity <= 11) OR (l_quantity >= 10 AND l_quantity <= 20)
      OR (l_quantity >= 20 AND l_quantity <= 30))""",
    "yearly": """SELECT YEAR(l_shipdate), SUM(l_extendedprice * (1 - l_discount)), COUNT(*) FROM lineitem
  WHERE l_discount <> 0 GROUP BY YEAR(l_shipdate)""",
    "ym": """SELECT YEAR(l_shipdate), MONTH(l_shipdate), COUNT(*), SUM(l_quantity) FROM lineitem
  GROUP BY YEAR(l_shipdate), MONTH(l_shipdate)""",
    # the band query's 160 buckets under a filter: K1's route
    "bandf": """SELECT l_shipmode, l_shipinstruct, l_returnflag, COUNT(*), SUM(l_quantity), SUM(l_extendedprice)
  FROM lineitem WHERE NOT (l_quantity = 25) AND (l_tax > 0.02 OR l_discount IS NULL)
  GROUP BY l_shipmode, l_shipinstruct, l_returnflag""",
    # 100.00, not 100: the reference's DECIMAL * INT rescales the integer to
    # the decimal's scale before its raw product (10^scale too large, on
    # both reference engines); DECIMAL * DECIMAL adds the scales
    "arith": """SELECT l_returnflag, SUM(l_quantity DIV 10), MAX(ABS(l_extendedprice - 50000)),
    SUM(ROUND(l_discount * 100.00)), SUM(CAST(l_tax * 100.00 AS SIGNED)), SUM(l_quantity % 7)
  FROM lineitem GROUP BY l_returnflag""",
    # integer arguments: the reference's double builtins read a DECIMAL
    # argument's scaled integer (SQRT(1.00) is 10 on both its engines)
    "mathbits": """SELECT SUM(BIT_COUNT(l_orderkey)), SUM(l_suppkey >> 3), MAX(SQRT(l_suppkey)), COUNT(*) FROM lineitem
  WHERE LN(l_linenumber) > 1""",
}
FLOAT_REL = 1e-12  # float lanes (SQRT, the math builtins) against numpy


def _year_month(days: np.ndarray):
    m = days.astype("datetime64[D]").astype("datetime64[M]").astype(np.int64)
    return m // 12 + 1970, m % 12 + 1


def builtin_oracle(name: str, c: dict) -> list[tuple]:
    """``BUILTIN_QUERIES[name]``'s final rows from the generated arrays, in
    numpy, sorted by ``repr``."""
    qty, price, disc, tax, rf, ls, ship, mode, instr, okey, skey, line, commit, receipt = (c[i] for i in range(14))
    smode = [x.decode() for x in SHIPMODES]
    if name == "q12li":
        m = np.isin(mode, [SHIPMODES.index(b"MAIL"), SHIPMODES.index(b"SHIP")])
        m &= (commit < receipt) & (ship < commit)
        m &= (receipt >= _days(dt.date(1994, 1, 1))) & (receipt < _days(dt.date(1995, 1, 1)))
        rows = [(smode[k], int((ls[m & (mode == k)] == 1).sum()), int((rf[m & (mode == k)] == 2).sum()),
                 int((m & (mode == k)).sum())) for k in np.unique(mode[m])]
    elif name == "q19li":
        q = qty
        m = (mode == SHIPMODES.index(b"AIR")) & (instr == SHIPINSTRUCTS.index(b"DELIVER IN PERSON"))
        m &= ((q >= 100) & (q <= 1100)) | ((q >= 1000) & (q <= 2000)) | ((q >= 2000) & (q <= 3000))
        rows = [(_dec(int((price[m] * (100 - disc[m])).sum()), 4) if m.any() else None,)]
    elif name == "yearly":
        m = disc != 0
        y, _ = _year_month(ship[m])
        keys, (rev, cnt) = _by_key(y, (price[m] * (100 - disc[m]), np.add), (np.ones_like(y), np.add))
        rows = [(int(k), _dec(int(r), 4), int(n_)) for k, r, n_ in zip(keys, rev, cnt)]
    elif name == "ym":
        y, mo = _year_month(ship)
        keys, (cnt, sq) = _by_key(y * 100 + mo, (np.ones_like(y), np.add), (qty, np.add))
        rows = [(int(k) // 100, int(k) % 100, int(n_), _dec(int(q_), 2)) for k, n_, q_ in zip(keys, cnt, sq)]
    elif name == "bandf":
        m = (qty != 2500) & (tax > 2)
        key = (mode[m].astype(np.int64) * len(SHIPINSTRUCTS) + instr[m]) * len(RETURNFLAGS) + rf[m]
        keys, (cnt, sq, sp) = _by_key(key, (np.ones_like(key), np.add), (qty[m], np.add), (price[m], np.add))
        rows = []
        for b, n_, q_, p_ in zip(keys, cnt, sq, sp):
            mi, rest = divmod(int(b), len(SHIPINSTRUCTS) * len(RETURNFLAGS))
            ii, fi = divmod(rest, len(RETURNFLAGS))
            rows.append((smode[mi], SHIPINSTRUCTS[ii].decode(), RETURNFLAGS[fi].decode(), int(n_),
                         _dec(int(q_), 2), _dec(int(p_), 2)))
    elif name == "arith":
        rows = []
        for fi, f in enumerate(RETURNFLAGS):
            m = rf == fi
            if not m.any():
                continue
            rows.append((
                f.decode(),
                int((qty[m] // 1000).sum()),  # quantities are positive: DIV truncates as floor does
                _dec(int(np.abs(price[m] - 5_000_000).max()), 2),
                _dec(int(disc[m].sum()) * 10_000, 4),  # ROUND of a whole number of hundredths
                int(tax[m].sum()),
                _dec(int(((qty[m] // 100) % 7).sum()) * 100, 2),  # whole quantities
            ))
    elif name == "mathbits":
        m = np.log(line.astype(np.float64)) > 1
        bits = np.unpackbits(okey[m].astype(np.int64).view(np.uint8)).sum()
        rows = [(int(bits), int((skey[m] >> 3).sum()), float(np.sqrt(skey[m].astype(np.float64)).max()), int(m.sum()))]
    else:
        raise KeyError(name)
    return sorted(rows, key=repr)


def rows_match(got: list, want: list, rel: float = FLOAT_REL) -> bool:
    """Row-for-row equality, floats within a relative ``rel``, everything
    else exact."""
    if len(got) != len(want):
        return False
    for g, w in zip(got, want):
        if len(g) != len(w):
            return False
        for a, b in zip(g, w):
            if isinstance(b, float) and isinstance(a, float):
                if not abs(a - b) <= rel * max(abs(a), abs(b)):
                    return False
            elif a != b:
                return False
    return True


# -- every builtin, body by body: generated lanes per argument kind ----------
# (TypeKind name, length, scale, generator(rng, n)); every lane mixes edges
# (zero, sign, extremes, Feb 29, month ends) with draws


def _g_ints(rng, n):
    edge = [0, 1, -1, 2, -2, 7, -7, 10, 63, 64, (1 << 31) - 1, -(1 << 31), 1 << 62, -(1 << 62), (1 << 62) - 1]
    wide = rng.integers(-(1 << 62), 1 << 62, n // 4)
    mid = rng.integers(-(10**9), 10**9, n // 4)
    return np.concatenate([edge, wide, mid, rng.integers(-100, 100, n)])[:n].astype(np.int64)


def _g_small(rng, n):
    return np.concatenate([[0, 1, -1, 59, 60, -59], rng.integers(-70, 70, n)])[:n].astype(np.int64)


def _g_dec(rng, n, digits):
    hi = 10**digits
    edge = [0, 1, -1, hi - 1, -(hi - 1), 50, -50, 149, -149, 150, -150, 5, -5, 10 ** (digits // 2)]
    return np.concatenate([edge, rng.integers(-hi + 1, hi, n // 2), rng.integers(-10_000, 10_000, n)])[:n].astype(np.int64)


def _g_floats(rng, n):
    edge = [0.0, -0.0, 0.5, -0.5, 1.5, -1.5, 2.5, -2.5, 1.0, -1.0, 0.49999999999999994, 1e300, -1e300,
            1e-300, 9.3e18, -9.3e18, 9.2e18, 4.5e15, 0.125, 709.0, 710.0, 3.141592653589793,
            float("nan"), float("inf"), float("-inf")]
    wide = rng.uniform(-10, 10, n // 2) * 10.0 ** rng.integers(-300, 301, n // 2).astype(np.float64)
    return np.concatenate([edge, wide, rng.uniform(-1000, 1000, n)])[:n].astype(np.float64)


def _g_unit(rng, n):
    edge = [0.0, 1.0, -1.0, 1.0000000000000002, -1.0000000000000002, 2.0, -2.0, 0.5]
    return np.concatenate([edge, rng.uniform(-1.2, 1.2, n)])[:n]


def _g_days(rng, n):
    edge = [_days(dt.date(y, m, d)) for y, m, d in (
        (1, 1, 1), (9999, 12, 31), (1970, 1, 1), (1969, 12, 31), (2000, 2, 29), (1900, 2, 28), (1900, 3, 1),
        (2024, 2, 29), (2023, 2, 28), (2024, 1, 31), (2024, 12, 31), (2025, 1, 1), (1600, 2, 29), (4, 2, 29),
        (2021, 1, 3), (2021, 1, 4), (2020, 12, 31), (2008, 12, 29), (2010, 1, 3), (1999, 1, 1),
        (1992, 1, 1), (1998, 12, 31), (1582, 10, 15), (1, 12, 31), (9999, 1, 1), (2027, 1, 1),
    )]
    lo, hi = _days(dt.date(1, 1, 1)), _days(dt.date(9999, 12, 31))
    return np.concatenate([edge, rng.integers(lo, hi + 1, n // 2), rng.integers(8000, 10_957, n)])[:n].astype(np.int64)


def _g_micros(rng, n):
    day_us = 86_400_000_000
    tod = rng.integers(0, day_us, n)
    tod[:6] = [0, day_us - 1, 1, day_us // 2, 0, 999_999]
    return _g_days(rng, n) * day_us + tod


def _g_durations(rng, n):
    cap = 838 * 3_600_000_000 + 59 * 60_000_000 + 59_000_000
    edge = [0, 1, -1, cap, -cap, 3_600_000_000, -3_600_000_000, 86_399_999_999, -1_000_000]
    return np.concatenate([edge, rng.integers(-cap, cap + 1, n)])[:n].astype(np.int64)


def _g_periods(rng, n):
    yymm = rng.integers(0, 100, n // 2) * 100 + rng.integers(1, 13, n // 2)
    yyyymm = rng.integers(1000, 9999, n) * 100 + rng.integers(1, 13, n)
    return np.concatenate([[6901, 7001, 9912, 1, 199801, 200001, 12], yymm, yyyymm])[:n].astype(np.int64)


def _g_daynrs(rng, n):
    return np.concatenate([[0, 366, 719528, 3652424, 3652425, 1, -5], rng.integers(-1000, 3_700_000, n)])[:n].astype(np.int64)


def _g_shifts(rng, n):
    return np.concatenate([[0, 1, 63, 64, 65, -1, 100, 32], rng.integers(-3, 70, n)])[:n].astype(np.int64)


def _g_bools(rng, n):
    return np.concatenate([[0, 1, 2, -1, 0, 1], rng.integers(-1, 3, n)])[:n].astype(np.int64)


def _g_narrow(rng, n):
    # an int32 storage lane (dictionary codes, binder-proven narrow columns)
    return np.concatenate([[0, 1, -1, (1 << 31) - 1, -(1 << 31), 3], rng.integers(-5, 40, n)])[:n].astype(np.int32)


BUILTIN_KINDS = {
    "i": ("INT", 20, 0, _g_ints),
    "s": ("INT", 20, 0, _g_small),
    "b": ("INT", 1, 0, _g_bools),
    "sh": ("INT", 20, 0, _g_shifts),
    "p": ("INT", 20, 0, _g_periods),
    "dn": ("INT", 20, 0, _g_daynrs),
    "m": ("INT", 20, 0, lambda rng, n: rng.integers(0, 16, n).astype(np.int64)),
    "n": ("INT", 11, 0, _g_narrow),
    "d2": ("DECIMAL", 12, 2, lambda rng, n: _g_dec(rng, n, 12)),
    "d6": ("DECIMAL", 20, 6, lambda rng, n: _g_dec(rng, n, 17)),
    "f": ("FLOAT", 0, 0, _g_floats),
    "u": ("FLOAT", 0, 0, _g_unit),
    "dt": ("DATE", 0, 0, _g_days),
    "ts": ("DATETIME", 0, 0, _g_micros),
    "du": ("DURATION", 0, 0, _g_durations),
}


def _c(kind, value):
    """A constant argument (physical units; None for a NULL constant)."""
    return ("c", kind, value)


_NUM2 = [("i", "i"), ("d2", "d6"), ("i", "f"), ("d2", "f"), ("f", "f"), ("i", _c("i", 7)), ("d2", _c("f", 2.5)),
         ("i", _c("i", None))]
_CMP2 = _NUM2 + [("dt", "dt"), ("ts", "ts"), ("d6", _c("d2", 150)), ("f", _c("i", 0)), ("n", _c("i", 3)), ("n", "n"),
                 ("n", "i")]
_DATE1 = [("dt",), ("ts",)]
_FLOAT1 = [("f",), ("i",), ("d2",), ("u",)]
_BITS2 = [("i", "i"), ("i", _c("i", 0xFF)), ("b", "i")]
_SHIFT2 = [("i", "sh"), ("i", _c("sh", 3)), ("i", _c("sh", 64)), ("i", _c("sh", -1))]
_LOGIC2 = [("b", "b"), ("b", _c("b", 0)), ("b", _c("b", 1)), ("b", _c("b", None)), ("f", "b"), ("n", "b")]

# every builtin the reference may run on its device → argument signatures:
# a kind is a column with NULLs, ``_c(kind, value)`` a constant
BUILTIN_CASES = {
    "plus": _NUM2 + [("n", _c("i", 3))], "minus": _NUM2 + [("n", "n")], "mul": _NUM2 + [("n", _c("i", -2))],
    "div": _NUM2 + [("d2", "i"), ("i", _c("i", 0)), ("d6", _c("d2", 0))],
    "intdiv": _NUM2 + [("i", _c("i", 0)), ("f", _c("f", 0.0))],
    "mod": _NUM2 + [("i", _c("i", 0)), ("d6", _c("d2", -300))],
    "unaryminus": [("i",), ("d2",), ("f",)],
    "eq": _CMP2, "ne": _CMP2, "lt": _CMP2, "le": _CMP2, "gt": _CMP2, "ge": _CMP2, "nulleq": _CMP2,
    "and": _LOGIC2, "or": _LOGIC2,
    "xor": [("b", "b"), ("b", _c("b", 1)), ("b", _c("b", None))],
    "not": [("b",), ("f",), ("n",), (_c("b", 0),)],
    "in": [("i", _c("i", 7), _c("i", -1), _c("i", 1 << 62)), ("i", _c("i", 0), _c("i", None)),
           ("d2", _c("d2", 150), _c("d2", -50)), ("dt", _c("dt", 0), _c("dt", 10_957)), ("s", _c("s", 3)),
           ("f", _c("f", 0.5), _c("f", 1e300)), ("n", _c("i", 3), _c("i", 0), _c("i", None))],
    "isnull": [("i",), ("f",), ("n",), (_c("i", None),), (_c("i", 3),)],
    "ifnull": [("i", "i"), ("i", _c("i", -5)), ("f", "f"), ("d2", "d2")],
    "coalesce": [("i", "i", "i"), ("i", _c("i", 9)), ("f", "f"), ("dt", "dt")],
    "if": [("b", "i", "i"), ("b", "n", _c("i", 7)), ("b", "f", "f"), ("b", "i", _c("i", 0)),
           ("b", _c("i", 1), _c("i", 0)), ("f", "d2", "d2")],
    "case_when": [("b", "i", "b", "i", "i"), ("b", "n", "b", _c("i", 5), "n"), ("b", "f", "b", "f"),
                  ("b", _c("i", 1), _c("i", 0)), ("b", "d2", "b", _c("d2", 5), "d2")],
    "abs": [("i",), ("d2",), ("f",)],
    "sign": [("i",), ("d2",), ("f",)],
    "ceil": [("i",), ("d2",), ("d6",), ("f",)],
    "floor": [("i",), ("d2",), ("d6",), ("f",)],
    "round": [("i",), ("d2",), ("d6",), ("f",), ("d6", _c("s", 2)), ("d2", _c("s", 5)), ("i", _c("s", -2)),
              ("f", _c("s", 2)), ("f", _c("s", -1)), ("d2", _c("s", -1))],
    "truncate": [("i", _c("s", 0)), ("i", _c("s", -2)), ("d2", _c("s", 1)), ("d6", _c("s", 0)), ("f", _c("s", 2)),
                 ("f", _c("s", -1)), ("d2", _c("s", -1)), ("d2", _c("s", 4))],
    "greatest": [("i", "i", "i"), ("d2", "d6"), ("i", "f"), ("d2", "f"), ("i", "d2")],
    "least": [("i", "i", "i"), ("d2", "d6"), ("i", "f"), ("d2", "f"), ("i", "d2")],
    "cast_int": [("i",), ("d2",), ("d6",), ("f",)],
    "cast_float": [("i",), ("d2",), ("d6",), ("f",)],
    "cast_decimal": [("i",), ("d2",), ("d6",), ("f",)],
    "year": _DATE1, "month": _DATE1, "quarter": _DATE1, "dayofmonth": _DATE1, "dayofweek": _DATE1,
    "dayofyear": _DATE1, "weekday": _DATE1, "weekofyear": _DATE1, "last_day": _DATE1, "date": _DATE1,
    "to_days": _DATE1, "unix_timestamp": _DATE1,
    "week": _DATE1 + [("dt", _c("m", k)) for k in range(8)] + [("dt", "m"), ("ts", _c("m", 3))],
    "yearweek": _DATE1 + [("dt", _c("m", k)) for k in range(8)],
    "date_add_days": [("dt", "s"), ("ts", "s"), ("dt", _c("i", 31))],
    "date_add_months": [("dt", "s"), ("ts", "s"), ("dt", _c("i", 1)), ("dt", _c("i", -13))],
    "date_add_micros": [("dt", "du"), ("ts", "du"), ("ts", _c("i", 1))],
    "datediff": [("dt", "dt"), ("ts", "dt"), ("dt", _c("dt", 0))],
    "from_days": [("dn",)],
    "from_unixtime": [("s",), ("i",)],
    "hour": [("ts",), ("du",)], "minute": [("ts",), ("du",)], "second": [("ts",), ("du",)],
    "time_to_sec": [("du",)], "sec_to_time": [("s",), ("i",)],
    "maketime": [("s", "s", "s"), ("s", _c("s", 30), _c("s", 0))],
    "addtime": [("ts", "du"), ("dt", "du"), ("du", "du"), ("ts", "ts")],
    "subtime": [("ts", "du"), ("dt", "du"), ("du", "du"), ("ts", "dt")],
    "timediff": [("ts", "ts"), ("du", "du"), ("ts", "du"), ("dt", "ts")],
    "tsdiff_micros": [("ts", "ts"), ("dt", "ts"), ("dt", "dt")],
    "tsdiff_months": [("dt", "dt"), ("ts", "ts"), ("dt", "ts")],
    "period_add": [("p", "s"), ("p", _c("s", 13))],
    "period_diff": [("p", "p"), ("p", _c("p", 199801))],
    "bitand": _BITS2, "bitor": _BITS2, "bitxor": _BITS2,
    "bitneg": [("i",), ("b",)],
    "bit_count": [("i",), ("b",)],
    "shl": _SHIFT2, "shr": _SHIFT2,
    "sqrt": _FLOAT1, "exp": _FLOAT1, "ln": _FLOAT1, "log2": _FLOAT1, "log10": _FLOAT1,
    "sin": _FLOAT1 + [("ts",)], "cos": _FLOAT1 + [("ts",)], "tan": _FLOAT1, "cot": _FLOAT1,
    "asin": _FLOAT1, "acos": _FLOAT1, "atan": _FLOAT1 + [("f", "f"), ("i", "u")],
    "atan2": [("f", "f"), ("i", "i"), ("u", "d2")],
    "pow": [("f", "f"), ("u", "s"), ("s", "s"), ("d2", _c("f", 0.5)), ("i", _c("i", 2))],
    "degrees": _FLOAT1, "radians": _FLOAT1,
}
# cast_decimal's target (precision, scale) is the function's return type
CAST_DEC_TARGETS = [(12, 2), (20, 6), (10, 0)]


def builtin_cases(name: str) -> list:
    """[(argument signature, cast_decimal's target or None)] for ``name``."""
    sigs = BUILTIN_CASES[name]
    if name == "cast_decimal":
        return [(sig, t) for sig in sigs for t in CAST_DEC_TARGETS]
    return [(sig, None) for sig in sigs]


def builtin_lanes(sig, rng, n: int, lane=None) -> list:
    """Per argument: ("col", kind, data, valid) with about 15 % NULLs (the
    first six rows valid), or ("const", kind, value). ``lane(kind, i)``,
    when given, supplies the column of argument ``i`` instead of ``rng``."""
    out = []
    for i, a in enumerate(sig):
        if isinstance(a, tuple):
            out.append(("const", a[1], a[2]))
        elif lane is not None:
            out.append(("col", a, *lane(a, i)))
        else:
            data = np.asarray(BUILTIN_KINDS[a][3](rng, n))
            valid = rng.random(n) > 0.15
            valid[:6] = True
            out.append(("col", a, data, valid))
    return out


def builtin_expr(expr_mod, field_type, type_kind, name: str, lanes, ret=None):
    """``name`` over ``lanes`` as an expression of the package whose
    ``expression.expr``, ``FieldType`` and ``TypeKind`` are given: column
    arguments are ColumnRefs numbered in order."""
    args, ci = [], 0
    for ln in lanes:
        tk, length, scale, _ = BUILTIN_KINDS[ln[1]]
        ft = field_type(getattr(type_kind, tk), length=length, scale=scale, nullable=ln[0] == "col" or ln[2] is None)
        if ln[0] == "col":
            args.append(expr_mod.col(ci, ft))
            ci += 1
        else:
            args.append(expr_mod.Constant(ln[2], ft))
    r = None if ret is None else field_type(type_kind.DECIMAL, length=ret[0], scale=ret[1])
    return expr_mod.func(name, *args, ret=r)


def _decimal_text(cents: int) -> str:
    return f"{cents // 100}.{cents % 100:02d}"


def htap_writes(cols: dict, seed: int, n_update: int = 1000, n_delete: int = 200, n_insert: int = 300,
                table: str = "lineitem", handles=None):
    """Three writes on the loaded lineitem (handles 1..n unless ``handles``
    gives each row's, two regions split at the middle handle) and the
    columns they leave, in numpy. → (updates
    {handle: {slot: new physical value}}, deleted handles, the INSERT
    statement, columns after the three, changed handles in the first
    region, in the second).

    - UPDATE the lines of the first orders, about ``n_update`` of the first
      region (quantity + 1, price + 100.00), one of them to a price of
      25,000,000.00, past the table's maximum and past the int32 envelope
      of the price lane (2,500,000,000 cents), and another to a quantity
      of 75 (the specification's domain ends at 50);
    - DELETE about ``n_delete`` lines of the second region (whole orders);
    - INSERT ``n_insert`` new lines (the next handles: the second region)
      with values from the specification's domains, in new orders past the
      last, with no new dictionary strings.
    """
    n = len(cols[0])
    c = {k: v.copy() for k, v in cols.items()}
    okey = c[9]
    upd = np.flatnonzero(okey <= okey[n_update - 1])
    i_big, i_qty = 0, int(np.flatnonzero(okey > okey[0])[0])  # first lines of the first two orders
    half = n // 2
    gone = (okey >= okey[half + 1000]) & (okey <= okey[half + 1000 + n_delete - 1])
    c[0][upd] += 100
    c[1][upd] += 10_000
    c[1][i_big] = 2_500_000_000
    c[0][i_qty] = 7_500
    h = np.arange(1, n + 1) if handles is None else np.asarray(handles)
    updates = {int(h[i]): {0: int(c[0][i]), 1: int(c[1][i])} for i in upd}
    new = lineitem_sf1(seed + 1, n_insert)
    new[9] = new[9] + (int(okey.max()) // 32 + 1) * 32  # new orders, the keys' sparse pattern kept
    values = []
    for i in range(n_insert):
        values.append(
            f"({_decimal_text(int(new[0][i]))}, {_decimal_text(int(new[1][i]))}, {_decimal_text(int(new[2][i]))}, "
            f"{_decimal_text(int(new[3][i]))}, '{RETURNFLAGS[new[4][i]].decode()}', "
            f"'{LINESTATUS[new[5][i]].decode()}', DATE '{_date(new[6][i]).isoformat()}', "
            f"'{SHIPMODES[new[7][i]].decode()}', '{SHIPINSTRUCTS[new[8][i]].decode()}', "
            f"{new[9][i]}, {new[10][i]}, {new[11][i]}, DATE '{_date(new[12][i]).isoformat()}', "
            f"DATE '{_date(new[13][i]).isoformat()}')"
        )
    insert = f"INSERT INTO {table} VALUES " + ", ".join(values)
    after = {k: np.concatenate([v[~gone], new[k].astype(v.dtype)]) for k, v in c.items()}
    return updates, h[gone], insert, after, len(upd), int(gone.sum()) + n_insert


def commit_rows(db, updates: dict, deletes, table: str = "lineitem") -> None:
    """One transaction on ``table`` through the store's transactional API,
    the commit path SQL DML takes: rewrite the rows of ``updates``
    ({handle: {slot: physical value}}) and delete the rows of ``deletes``.
    (The SQL UPDATE and DELETE executors read the whole table to find their
    rows, which at SF1 dwarfs the reads after them.)"""
    from tidb_tpu_torch.kv.rowcodec import RowSchema, decode_row, encode_row
    from tidb_tpu_torch.kv.tablecodec import record_key

    t = db.catalog.table("test", table)
    schema = RowSchema(t.storage_schema)
    txn = db.store.begin()
    keys = [record_key(t.id, h) for h in updates]
    for key, (h, new), old in zip(keys, updates.items(), txn.batch_get(keys)):
        row = decode_row(schema, old)
        for slot, v in new.items():
            row[slot] = v
        txn.put(key, encode_row(schema, row))
    for h in deletes:
        txn.delete(record_key(t.id, int(h)))
    txn.commit()


# -- the oracle -----------------------------------------------------------------


def _dec(x: int, scale: int) -> Decimal:
    return Decimal(int(x)).scaleb(-scale)


_FOLD = {
    "count": lambda a, b: a + b,
    "sum": lambda a, b: a + b,
    "min": min,
    "max": max,
    "bit_and": lambda a, b: a & b,
    "bit_or": lambda a, b: a | b,
    "bit_xor": lambda a, b: a ^ b,
}


def merge_partials(name: str, per_region: list[list[tuple]], dag):
    """Merge partial results of several regions or blocks the way the root
    executor does: each partial lane folds per group (COUNT/SUM add, MIN/MAX
    keep the extreme, the bit aggregates fold); TopN candidates re-sort and
    cut. → {group key: values}, or the TopN's rows."""
    from tidb_tpu_torch.expression.expr import AggDesc

    if name == "q10":
        # earlier regions hold the lower handles: (-price, region, position)
        # is the host engine's stable order over the whole table
        cand = [(-r[0], ri, i, r) for ri, rows in enumerate(per_region) for i, r in enumerate(rows)]
        return [c[3] for c in sorted(cand, key=lambda c: c[:3])[:20]]
    last = dag.executors[-1]
    n_keys = len(last.group_by)
    ops = [k for a in last.aggs for k in AggDesc.from_pb(a).partial_kinds]
    acc: dict = {}
    for rows in per_region:
        for r in rows:
            key, vals = r[len(r) - n_keys :], r[: len(r) - n_keys]
            cur = acc.setdefault(key, [None] * len(vals))
            for i, (op, v) in enumerate(zip(ops, vals)):
                if v is not None:
                    cur[i] = v if cur[i] is None else _FOLD[op](cur[i], v)
    return {k: tuple(v) for k, v in acc.items()}


def _by_key(key: np.ndarray, *lanes):
    """(distinct keys, per lane and ufunc its reduction over each key's
    rows) in numpy: ``lanes`` are (values, ufunc) pairs."""
    order = np.argsort(key, kind="stable")
    ks = key[order]
    starts = np.flatnonzero(np.r_[True, ks[1:] != ks[:-1]])
    return ks[starts], [uf.reduceat(v[order], starts) for v, uf in lanes]


def _date(days: int) -> dt.date:
    return dt.date(1970, 1, 1) + dt.timedelta(days=int(days))


def returnflags(rf: np.ndarray) -> list:
    """The return-flag dictionary of a column of codes: the generator's
    three, and ``NEW_RETURNFLAG`` (code 3) once an append has brought it."""
    return IMPORT_RETURNFLAGS if len(rf) and int(rf.max()) >= len(RETURNFLAGS) else RETURNFLAGS


def oracle(name: str, c: dict):
    """The query's answer from the generated arrays, in numpy."""
    qty, price, disc, tax, rf, ls, ship, mode, instr, okey, skey, line = (c[i] for i in range(12))
    flags = returnflags(rf)
    if name == "count":
        return {(): (len(qty),)}
    if name == "q6":
        m = (ship >= _days(dt.date(1994, 1, 1))) & (ship < _days(dt.date(1995, 1, 1)))
        m &= (disc >= 5) & (disc <= 7) & (qty < 2400)
        return {(): (_dec(int((price[m] * disc[m]).sum()), 4),)}
    if name == "q1":
        out = {}
        m0 = ship <= _days(dt.date(1998, 9, 2))
        for fi, f in enumerate(flags):
            for si, s in enumerate(LINESTATUS):
                m = m0 & (rf == fi) & (ls == si)
                cnt = int(m.sum())
                if not cnt:
                    continue
                sq, sp, sd = int(qty[m].sum()), int(price[m].sum()), int(disc[m].sum())
                dp = price[m] * (100 - disc[m])
                out[(f.decode(), s.decode())] = (
                    _dec(sq, 2), _dec(sp, 2), _dec(int(dp.sum()), 4), _dec(int((dp * (100 + tax[m])).sum()), 6),
                    cnt, _dec(sq, 2), cnt, _dec(sp, 2), cnt, _dec(sd, 2), cnt,
                )
        return out
    if name == "q10":
        m = ship >= _days(dt.date(1994, 1, 1))
        idx = np.nonzero(m)[0]
        top = idx[np.argsort(-price[idx], kind="stable")[:20]]
        return [(_dec(price[i], 2), flags[rf[i]].decode(), _date(ship[i])) for i in top]
    if name == "band":
        key = (mode.astype(np.int64) * len(SHIPINSTRUCTS) + instr) * len(flags) + rf
        keys, (cnt, sq, sp) = _by_key(key, (np.ones_like(qty), np.add), (qty, np.add), (price, np.add))
        out = {}
        for b, n_, q_, p_ in zip(keys, cnt, sq, sp):
            mi, rest = divmod(int(b), len(SHIPINSTRUCTS) * len(flags))
            ii, fi = divmod(rest, len(flags))
            out[(SHIPMODES[mi].decode(), SHIPINSTRUCTS[ii].decode(), flags[fi].decode())] = (
                int(n_), _dec(q_, 2), _dec(p_, 2),
            )
        return out
    if name == "rollup":
        # the (returnflag, linestatus) groups, one subtotal per returnflag
        # (linestatus rolled up: NULL) and the grand total (both NULL)
        out = {}
        for key, m in [((None, None), np.ones(len(qty), bool))] + [
            ((f.decode(), None), rf == fi) for fi, f in enumerate(flags)
        ] + [
            ((f.decode(), s.decode()), (rf == fi) & (ls == si))
            for fi, f in enumerate(flags) for si, s in enumerate(LINESTATUS)
        ]:
            if m.any():
                out[key] = (int(m.sum()), _dec(int(qty[m].sum()), 2), _dec(int(price[m].sum()), 2))
        return out
    if name == "q18sub":
        keys, (sq,) = _by_key(okey, (qty, np.add))
        return {(int(k),): (_dec(v, 2),) for k, v in zip(keys, sq)}
    if name == "q15rev":
        m = (ship >= _days(dt.date(1996, 1, 1))) & (ship < _days(dt.date(1996, 4, 1)))
        keys, (rev,) = _by_key(skey[m], (price[m] * (100 - disc[m]), np.add))
        return {(int(k),): (_dec(v, 4),) for k, v in zip(keys, rev)}
    if name == "extremes":
        keys, (cnt, lo, hi, bor, bxor) = _by_key(
            skey, (np.ones_like(qty), np.add), (price, np.minimum), (ship, np.maximum),
            (line, np.bitwise_or), (okey, np.bitwise_xor),
        )
        return {
            (int(k),): (int(n_), _dec(p_, 2), _date(d_), int(o_), int(x_))
            for k, n_, p_, d_, o_, x_ in zip(keys, cnt, lo, hi, bor, bxor)
        }
    raise KeyError(name)


# -- main ------------------------------------------------------------------------


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    # the remote phase's store process (chip_smoke.py runs itself as it)
    ap.add_argument("--store-child", action="store_true", help=argparse.SUPPRESS)
    ap.add_argument("--rows", type=int, default=SF1_ROWS, help=argparse.SUPPRESS)
    ap.add_argument("--device", default="cuda", help=argparse.SUPPRESS)
    # phase 14's SQL path under the port's lock-order detector
    ap.add_argument("--lockcheck-child", action="store_true", help=argparse.SUPPRESS)
    # phases 9 and 15 alone (a machine with several cards)
    ap.add_argument("--mpp-only", action="store_true", help=argparse.SUPPRESS)
    args = ap.parse_args()

    import torch

    if args.store_child:
        sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
        return _store_child(args.seed, args.rows, args.device)
    if args.lockcheck_child:
        sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
        return _lockcheck_child(args.seed, args.rows, args.device)

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False — this script needs a CUDA card", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    try:
        import tidb_tpu_torch
        from tidb_tpu_torch.native import cuda as native
    except ImportError as e:
        print(f"chip_smoke: the tidb_tpu_torch package is not beside this script ({e})", file=sys.stderr)
        return 2
    from tidb_tpu_torch.copr import carry, gpu_engine
    from tidb_tpu_torch.ops import dag_kernel
    from tidb_tpu_torch.ops import grouped_sums as gs

    t_start = time.perf_counter()
    card = _card_line()
    kind = torch.cuda.get_device_name(0)
    print(card)  # name, power limit: nvidia-smi's own line
    print(f"torch {torch.__version__} cuda {torch.version.cuda} device {kind} count {torch.cuda.device_count()}")
    if args.mpp_only:
        return _mpp_only(args.seed, gs)
    extra = [("grouped_sums", STRESS_DEFINES)]
    build_s, reports = native.build_all(extra)
    print(f"kernel build: {build_s:.3f} s ({len(reports)} libraries)")
    for name, rep in reports.items():
        for line in rep.splitlines():
            if "registers" in line or "smem" in line or "spill" in line:
                print(f"  {name}: {line.strip()}")
    for name, defines in [("grouped_sums", ())] + extra:
        print(f"  {' '.join((name, *defines))}: SASS atomics: {_sass_atomics(native.library_path(name, defines))}")
    stress = gs.entry(native.load("grouped_sums", STRESS_DEFINES))

    # 2. K1 against its plain version at the edges
    max_err = 0
    for n_pad, B, L in ((1024, 65, 3), (1024, 512, 3), (1 << 22, 65, 3), (1 << 22, 160, 3), (1 << 22, 512, 3), (1 << 22, 160, 20)):
        seg, pairs = _k1_synthetic(n_pad, B, L, args.seed + B + L)
        max_err = max(max_err, _k1_err(seg, pairs, B, n_pad))
        print(f"K1 check n_pad={n_pad} B={B} L={L}: bit-exact")
    # adversarial lanes, through the port's build and the stress build (one
    # table copy, the fewest blocks: up to 65,536 rows in one 32-bit cell)
    for n_pad, B, hot, more in ((7_999_488, 160, True, 0), (7_999_488, 160, False, 0), (131_072, 65, True, 0),
                                (1 << 20, 65, False, 12), (1 << 20, 512, False, 12), (1 << 20, 512, True, 12)):
        seg, pairs, bounds = _k1_adversarial(n_pad, B, args.seed + n_pad + B, hot, more)
        for label, fn in (("port", None), ("stress", stress)):
            max_err = max(max_err, _k1_err(seg, pairs, B, n_pad, bounds, fn))
        print(f"K1 adversarial n_pad={n_pad} B={B} L={len(pairs)} one_bucket={hot}: bit-exact (port and stress builds)")
        del seg, pairs

    # 3. the main path, in two configurations of one SF1 lineitem: two
    # regions of one device block each, and one region of two blocks (the
    # reference bench's layout: one region per chip)
    fixtures = os.path.join(os.path.dirname(os.path.abspath(tidb_tpu_torch.__file__)), "bench", "dags")
    dags = {}
    for name in DAG_NAMES:
        with open(os.path.join(fixtures, f"{name}.json")) as f:
            dags[name] = carry.dag_from_pb(json.load(f))
    table_id = dags["count"].executors[0].table_id
    t0 = time.perf_counter()
    cols = lineitem_sf1(args.seed)
    two = make_regions(cols, table_id)
    one = make_regions(cols, table_id, parts=1)
    print(f"data: {SF1_ROWS} rows generated in {time.perf_counter() - t0:.3f} s; two regions of "
          f"{[r.entry.n for r, _ in two]} rows, one region of {one[0][0].entry.n} rows")

    main_inputs, dot_inputs = [], []
    real_k1, real_dot = dag_kernel.grouped_sums, dag_kernel.grouped_sums_dot

    def recording_k1(seg, pairs, B, n_pad, bounds=None, device="cuda"):
        main_inputs.append((seg, pairs, B, n_pad, bounds))
        return real_k1(seg, pairs, B, n_pad, bounds, device=device)

    def recording_dot(seg, pairs, B, n, bounds=None):
        dot_inputs.append((seg, pairs, B, n, bounds))
        return real_dot(seg, pairs, B, n, bounds)

    dag_kernel.grouped_sums, dag_kernel.grouped_sums_dot = recording_k1, recording_dot
    try:
        gs.LAUNCHES = 0  # the two-region path: counts from 0 just before it
        results2, launches_by_query, info2 = _drive(two, dags, gs)
        main_launches = gs.LAUNCHES  # the kernels line reports this count
    finally:
        dag_kernel.grouped_sums, dag_kernel.grouped_sums_dot = real_k1, real_dot
    print(f"two regions: K1 launches by query: {launches_by_query}")
    if launches_by_query["band"] < 1 or launches_by_query["q1"] != 0:
        raise AssertionError(f"K1 must run for the band query and not for Q1: {launches_by_query}")
    if main_launches < 1:
        raise AssertionError("the main path never launched K1")
    gs.LAUNCHES = 0  # the one-region path: its own counts
    results1, launches1, info1 = _drive(one, dags, gs)
    print(f"one region: K1 launches by query: {launches1} (K1 is not on this path: n = 8,388,608 > 8,000,000 rows)")
    for name in dags:
        for label, info in (("two regions", info2), ("one region", info1)):
            print(f"{name} {label}: path {info[name]['path']}; routes {list(info[name]['routes'])}; "
                  f"agg-cap regrows {info[name]['regrows']}")
        if (info1[name]["path"], info1[name]["routes"]) != ONE_REGION_ROUTES[name]:
            raise AssertionError(f"{name}: one region took {info1[name]}, the reference's routing says "
                                 f"{ONE_REGION_ROUTES[name]}")

    t0 = time.perf_counter()
    merged = {}
    for name, dag in dags.items():
        want = oracle(name, cols)
        for label, regions, results in (("two regions", two, results2[name]), ("one region", one, results1[name])):
            for (r, rg), got in zip(regions, results):
                if not _same_chunk(gpu_engine.execute_region(r, dag, rg, device="cpu"), got):
                    raise AssertionError(f"{name} {label}: card and CPU paths disagree")
            merged[name, label] = merge_partials(name, [c.rows() for c in results], dag)
            if merged[name, label] != want:
                raise AssertionError(f"{name} {label}: merged result disagrees with the numpy oracle")
        if merged[name, "one region"] != merged[name, "two regions"]:
            raise AssertionError(f"{name}: one region, merged, disagrees with two regions")
        print(f"{name}: rows per region {[len(c) for c in results2[name]]} / {[len(c) for c in results1[name]]}; "
              f"equal to the CPU path and the oracle in both configurations, and to each other merged")
    print(f"checks: {time.perf_counter() - t0:.1f} s")

    # warm timings per region task
    busy = {}
    for name, dag in dags.items():
        for label, regions in (("two regions", two), ("one region", one)):
            for ri, (r, rg) in enumerate(regions):
                t = _task_timing(gpu_engine, r, dag, rg)
                busy[name, label, ri] = t["busy"]
                print(f"query {name} {label} region {ri}: wall_ms median {t['wall']:.3f} min {t['wall_min']:.3f}; "
                      f"device_span_ms median {t['span']:.3f}; device_busy_ms {_ms(t['busy'])}; "
                      f"idle_share {t['idle']}; concat_ms {_ms(t['cat'])}"
                      + ("" if t["cat"] is None or not t["busy"] else f" ({t['cat'] / t['busy']:.3f} of busy)"))
                if ri == 0:
                    for k, ms, calls in t["top"]:
                        print(f"    top kernel {ms:.3f} ms x{calls}: {k[:110]}")
    print("band device busy ms: one region (lex route, fused) "
          f"{_ms(busy['band', 'one region', 0])} against two regions (K1 route) "
          f"{_ms(busy['band', 'two regions', 0])} + {_ms(busy['band', 'two regions', 1])}")

    # 4. K1 on the main path's own inputs
    seg, pairs, B, n_pad, bounds = main_inputs[0]
    max_err = max(max_err, _k1_err(seg, pairs, B, n_pad, bounds))
    k1 = _k1_timings(seg, pairs, B, n_pad, bounds)
    print(f"K1 main-path input: n_pad={n_pad} B={B} L={len(pairs)} lanes "
          f"{[str(v.dtype).replace('torch.', '') for v, _ in pairs]} bounds {bounds} "
          f"launches per call {len(gs.plan(pairs, bounds, B))}: {json.dumps(k1)}")
    # K1 on Q1's own grouped-sum input, beside the int8 dot route Q1 takes
    from tidb_tpu_torch.ops.mxu_groupby import grouped_sums_dot

    qseg, qpairs, qB, qn, qbounds = dot_inputs[0]
    max_err = max(max_err, _k1_err(qseg, qpairs, qB, qn, qbounds))
    qc, qs = grouped_sums_dot(qseg, qpairs, qB, qn, qbounds)
    pc, ps = gs.grouped_sums_plain(qseg, qpairs, qB, qn, qbounds)
    if not (torch.equal(qc, pc) and torch.equal(qs, ps)):
        raise AssertionError("the dot route disagrees with K1's plain version on Q1's input")
    k1_call = lambda: gs.grouped_sums(qseg, qpairs, qB, qn, qbounds, device=qseg.device)  # noqa: E731
    dot_call = lambda: grouped_sums_dot(qseg, qpairs, qB, qn, qbounds)  # noqa: E731
    q1 = {
        "k1_ms": _time_ms(k1_call), "k1_device_ms": _device_ms(k1_call, "grouped_sums"),
        "dot_ms": _time_ms(dot_call, reps=10), "dot_device_ms": _device_ms(dot_call, reps=5),
        "bound_ms": _bound(*_k1_work(qseg, qpairs, qB, qbounds))[0],
    }
    print(f"Q1 grouped-sum input: n={qn} B={qB} L={len(qpairs)} bounds {qbounds}: {json.dumps(q1)}")
    print(f"DAG phases: {time.perf_counter() - t_start:.1f} s")

    # 5. the SQL front: the same lineitem through tidb_tpu_torch.open()
    t0 = time.perf_counter()
    gs.LAUNCHES = 0  # the SQL path: counts from 0 just before it
    sql_launches, db, warm = _sql_phase(cols, gs)
    sql_warm = dict(warm)
    print(f"SQL phase: {time.perf_counter() - t0:.1f} s; K1 launches on the SQL path {sql_launches}")

    # 17. the engine's chip probe and cold builds, on phase 5's database before its writes
    t0 = time.perf_counter()
    gs.LAUNCHES = 0  # the probe path: counts from 0 just before it
    _probe_phase(db, cols, gs)
    probe_launches = gs.LAUNCHES
    print(f"phase 17: {time.perf_counter() - t0:.1f} s; K1 launches on the probe path {probe_launches}")

    # 6. HTAP: reads after writes on the same database, the delta pending
    t0 = time.perf_counter()
    delta_launches, err, after = _htap_phase(db, cols, gs, warm, args.seed)
    max_err = max(max_err, err)
    torch.cuda.synchronize()
    print(f"HTAP phase: {time.perf_counter() - t0:.1f} s; K1 launches on the delta path {delta_launches}")

    # 7. the device builtins: the same database, the writes folded in
    t0 = time.perf_counter()
    builtin_launches = _builtins_phase(db, after, gs)
    db.stop_background()
    db = after = warm = None  # the SQL database's columns leave the host and the card
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    print(f"builtins phase: {time.perf_counter() - t0:.1f} s; K1 launches on the builtins path {builtin_launches}")
    print(json.dumps({"builtins": _builtins_check(args.seed)}))

    # 8. windows: one SF1 region, the window program in the task and at the root
    t0 = time.perf_counter()
    costs = _window_phase(cols, args.seed)
    torch.cuda.synchronize()
    print(json.dumps({"window_costs": costs}))
    print(f"window phase: {time.perf_counter() - t0:.1f} s")

    # 9. MPP: the join fragments of Q3, Q17 and a TopN over virtual shards
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    gs.LAUNCHES = 0  # the MPP path: counts from 0 just before it
    mpp_launches, mdb, mtables, mhost, virtual = _mpp_phase(cols, args.seed, gs)
    print(f"MPP phase: {time.perf_counter() - t0:.1f} s; K1 launches on the MPP path {mpp_launches}")

    # 15. MPP over every card: phase 9's database and checks over several
    # workers (run here, while its database is loaded)
    t0 = time.perf_counter()
    gs.LAUNCHES = 0  # the multi-worker MPP path: counts from 0 just before it
    try:
        mpp15_launches = _mpp_devices_phase(mdb, mtables, mhost, virtual, gs)
    finally:
        mdb.stop_background()
    mdb = mtables = mhost = None
    print(f"phase 15: {time.perf_counter() - t0:.1f} s; K1 launches on the multi-worker MPP path {mpp15_launches}")

    # 10. the process topology: a store process owns the card, SQL layers over it
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    remote_launches = _remote_phase(cols, args.seed, gs)
    print(f"remote phase: {time.perf_counter() - t0:.1f} s; K1 launches on the remote path {remote_launches}")
    t0 = time.perf_counter()
    _boot_check()
    print(f"boot check: {time.perf_counter() - t0:.1f} s")

    # 11. partitioned tables: lineitem RANGE-partitioned on l_orderkey, one task per partition
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    gs.LAUNCHES = 0  # the partition path: counts from 0 just before it
    partition_launches, err, k1_partition = _partition_phase(cols, gs, sql_warm)
    max_err = max(max_err, err)
    print(f"partition phase: {time.perf_counter() - t0:.1f} s; K1 launches on the partition path {partition_launches}")

    # 12. graftfuzz on the card: random SQL, the gpu sessions held against the host engine
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    fuzz = _fuzz_phase()
    print(f"fuzz phase: {time.perf_counter() - t0:.1f} s")

    # 13. getting data in and out: LOAD DATA, IMPORT INTO, BACKUP/RESTORE, PITR, replayer, inspection
    gc.collect()
    torch.cuda.empty_cache()
    import_launches, err, k1_import, import_s = _import_phase(args.seed, gs, card=card)
    max_err = max(max_err, err)
    print(f"import phase: {import_s:.1f} s; K1 launches on the import path {import_launches}")

    # 14. the last reference modules: graftcheck, the SQL path under the
    # port's lock-order detector, benchdaily and benchdb
    gc.collect()
    torch.cuda.empty_cache()
    here = os.path.dirname(os.path.abspath(__file__))
    t0 = time.perf_counter()
    gcheck = _graftcheck_run(here)
    print(f"graftcheck: {gcheck['summary']}; {gcheck['rules']} rules in {gcheck['seconds']:.3f} s, "
          f"{gcheck['suppressed']} suppressed, nothing baselined")
    lock = _lockcheck_phase(args.seed, sql_warm)
    bench = _bench_phase(here, gs)
    print(f"phase 14: {time.perf_counter() - t0:.1f} s; K1 launches on the lockcheck path {lock['k1_launches']}, "
          f"on the bench path {bench['k1_launches']} (no lane groups 64 < B <= 512)")
    print(f"total {time.perf_counter() - t_start:.1f} s")

    print(json.dumps({"kernels": [{
        "name": "grouped_sums",
        "route": "cuda",
        "source": "tidb_tpu_torch/csrc/grouped_sums.cu",
        "replaces": "tidb_tpu/ops/pallas_groupby.py:64",
        "launches": sql_launches,
        "launches_dag_path": main_launches,
        "launches_delta_path": delta_launches,
        "launches_builtins_path": builtin_launches,
        "launches_mpp_path": mpp_launches,
        "launches_mpp_devices_path": mpp15_launches,
        "launches_remote_path": remote_launches,
        "launches_partition_path": partition_launches,
        "launches_fuzz_campaign": fuzz["k1_launches"],
        "launches_import_path": import_launches,
        "launches_lockcheck_path": lock["k1_launches"],
        "launches_bench_path": bench["k1_launches"],
        "launches_probe_path": probe_launches,
        "max_abs_err": max_err,
        **k1,
        "partition_input": k1_partition,
        "import_input": k1_import,
    }]}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


DAG_NAMES = ("count", "q6", "q1", "q10", "band", "q18sub", "q15rev", "extremes")
# one SF1 region = two 4,194,304-row blocks: the reference's routing
# (tidb_tpu/copr/tpu_engine.py:502-521, tidb_tpu/ops/dag_kernel.py:522,775)
ONE_REGION_ROUTES = {
    "count": ("fused", ("eqmask",)),
    "q6": ("fused", ("eqmask",)),
    "q1": ("blockwise dot", ("dot",)),
    "q10": ("per-block stacked", ()),
    "band": ("fused", ("lex",)),
    "q18sub": ("fused", ("lex",)),
    "q15rev": ("fused", ("lex",)),
    "extremes": ("fused", ("lex",)),
}


def _sql_phase(cols: dict, gs, reps: int = 10, device: str = "cuda"):
    """The seven statements of ``SQL_QUERIES`` through ``tidb_tpu_torch.open``
    on the card, over ``cols`` split at the middle handle into two regions:
    once cold (the column cache built from MVCC, the columns copied to the
    card), then ``reps`` times warm. Every run must return the oracle's
    rows with every cop task on the ``gpu`` engine and none degraded; K1
    must launch during the band query and not during Q1. Prints the load
    time and row codec, then per statement the cold wall, the warm SQL wall
    (median, min), the summed and longest cop-task walls from ExecDetails
    and the SQL-layer tax (wall minus summed task walls, and wall minus
    the longest task: the tasks run concurrently) and one profiled run's
    device busy time. → (K1 launches over the single (cold) drive of the
    statements, the open database, the warm median per statement)."""
    import tidb_tpu_torch
    from tidb_tpu_torch import native as row_native
    from tidb_tpu_torch.executor.load import bulk_load
    from tidb_tpu_torch.kv.tablecodec import record_key

    db = tidb_tpu_torch.open(region_split_keys=1 << 62, device=device)
    load_s = lineitem_sql(db, bulk_load, record_key, cols, parts=2)
    n_regions = len(db.store.regions())
    codec = "native C++ (g++)" if row_native.lib() is not None else "pure Python (no compiler found)"
    print(f"sql: bulk load {load_s:.3f} s, {len(cols[0])} rows, {n_regions} regions; row codec {codec}")
    s = db.session()
    want = {name: sql_oracle(name, cols) for name in SQL_QUERIES}

    def run(name):
        t0 = time.perf_counter()
        rows = s.query(SQL_QUERIES[name])
        wall = (time.perf_counter() - t0) * 1e3
        summ = s.exec_summary
        if summ is None or summ.engines != {"gpu": n_regions} or summ.degraded:
            raise AssertionError(f"sql {name}: cop tasks {summ and summ.engines}, degraded {summ and summ.degraded}")
        if sql_rows(name, rows) != want[name]:
            raise AssertionError(f"sql {name}: rows disagree with the numpy oracle")
        return wall, summ.procs, summ.device_ms

    cold, by_query, warm = {}, {}, {}
    for name in SQL_QUERIES:
        before = gs.LAUNCHES
        cold[name] = run(name)
        by_query[name] = gs.LAUNCHES - before
    launches = gs.LAUNCHES
    print(f"sql: K1 launches by statement (cold drive): {by_query}")
    if by_query["band"] < 1 or by_query["q1"] != 0:
        raise AssertionError(f"K1 must run for the band query and not for Q1: {by_query}")
    for name in SQL_QUERIES:
        runs = [run(name) for _ in range(reps)]
        warm[name] = statistics.median(w for w, _p, _d in runs)
        walls = [w for w, _p, _d in runs]
        cop_sum = [sum(p) for _w, p, _d in runs]
        cop_max = [max(p) for _w, p, _d in runs]
        tax = [w - c for w, c in zip(walls, cop_sum)]
        tax_crit = [w - c for w, c in zip(walls, cop_max)]
        cw, cp, _cd = cold[name]
        print(f"sql {name}: cold_ms {cw:.3f} (cop tasks {[round(p, 3) for p in cp]}); warm sql_ms median "
              f"{statistics.median(walls):.3f} min {min(walls):.3f}; cop_task_sum_ms median "
              f"{statistics.median(cop_sum):.3f}; cop_task_max_ms median {statistics.median(cop_max):.3f}; "
              f"device_ms median {statistics.median(d for _w, _p, d in runs):.3f}; "
              f"tax_ms median {statistics.median(tax):.3f} (wall minus summed task walls; the tasks run "
              f"concurrently); tax_vs_longest_task_ms median {statistics.median(tax_crit):.3f}; "
              f"{_busy(lambda: run(name), statistics.median(walls))}; rows {len(want[name])}")
    return launches, db, warm


PROBE_QUERIES = ("count", "q6", "q1", "q10", "band")
PROBE_K = 32  # run_once dispatches per timing, then one sync (bench.py's chip_time)
PROBE_LIMIT = "SELECT l_extendedprice, l_shipmode FROM lineitem WHERE l_discount >= 0.01 LIMIT 5"
PROBE_LIMIT_BLOCK = 1 << 20  # the rejection's block size: an SF1 region of two is 3 blocks
# the probe statements with a predicate no lineitem row fails, over a column
# none of them reads: the oracle's rows, a DAG shape new to the process
COLD_QUERIES = {
    "count": "SELECT COUNT(*) FROM lineitem WHERE l_linenumber > 0",
    "q6": SQL_QUERIES["q6"] + " AND l_linenumber > 0",
    "q1": SQL_QUERIES["q1"].replace("GROUP BY", "AND l_linenumber > 0 GROUP BY", 1),
    "q10": SQL_QUERIES["q10"].replace("ORDER BY", "AND l_linenumber > 0 ORDER BY", 1),
    "band": SQL_QUERIES["band"].replace("GROUP BY", "WHERE l_linenumber > 0 GROUP BY", 1),
}


def _capture_task(db, sql: str):
    """Run ``sql`` once through the SQL layer and capture its first
    region's cop task as ``gpu_engine._execute_dag_device`` received it
    (bench.py's ``chip_time``). → ((dag, region, ranges, read_ts), the
    task's chunk, its ``execute_region`` stats)."""
    from tidb_tpu_torch.copr import gpu_engine

    got, stats = [], {}
    real_dev, real_region = gpu_engine._execute_dag_device, gpu_engine.execute_region

    def cap(store, dag, region, ranges, read_ts, warn=None):
        chunk = real_dev(store, dag, region, ranges, read_ts, warn)
        got.append(((dag, region, ranges, read_ts), chunk))
        return chunk

    def with_stats(view, *a, **kw):
        kw["stats"] = stats[view.region_id] = {}
        return real_region(view, *a, **kw)

    gpu_engine._execute_dag_device, gpu_engine.execute_region = cap, with_stats
    try:
        db.session().query(sql)
    finally:
        gpu_engine._execute_dag_device, gpu_engine.execute_region = real_dev, real_region
    args, chunk = min(got, key=lambda t: t[0][1].region_id)
    return args, chunk, stats[args[1].region_id]


def _host_syncs(fn) -> int:
    """The host↔device synchronizations one call of ``fn`` makes, as
    ``torch.cuda.set_sync_debug_mode("warn")`` reports them."""
    import warnings

    import torch

    with warnings.catch_warnings(record=True) as seen:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    return sum("synchroniz" in str(w.message) for w in seen)


def _refused(what: str, fn) -> str:
    try:
        fn()
    except ValueError as e:
        return f"{what}: {e}"
    raise AssertionError(f"probe: {what} was not refused")


def _probe_rejections(db) -> list:
    """The five task shapes the reference's probe refuses, each of which
    must raise ValueError here. → one line per shape."""
    from tidb_tpu_torch.copr import gpu_engine
    from tidb_tpu_torch.ops.dag_kernel import MAX_RANGES

    probe = gpu_engine.device_probe_fn
    (dag, region, ranges, ts), _c, _s = _capture_task(db, SQL_QUERIES["q10"])
    pb = dag.to_pb()
    desc = type(dag).from_pb({**pb, "executors": [{**pb["executors"][0], "desc": True}] + pb["executors"][1:]})
    window = type(dag).from_pb({"output_offsets": [], "executors": pb["executors"][:1] + [{
        "tp": "window", "partition_by": [], "order_by": [],
        "win_funcs": [{"name": "row_number", "args": [], "ft": [8, 20, 0, 1, "binary", 0]}]}]})
    out = [
        _refused("a descending scan", lambda: probe(db.store, desc, region, ranges, ts)),
        _refused(f"{MAX_RANGES + 1} ranges", lambda: probe(db.store, dag, region, list(ranges) * (MAX_RANGES + 1), ts)),
        _refused("a window", lambda: probe(db.store, window, region, ranges, ts)),
    ]
    (ldag, lregion, lranges, lts), _c, _s = _capture_task(db, PROBE_LIMIT)
    block = gpu_engine._BLOCK
    gpu_engine._BLOCK = PROBE_LIMIT_BLOCK
    try:
        out.append(_refused(f"LIMIT-last over {PROBE_LIMIT_BLOCK:,}-row blocks",
                            lambda: probe(db.store, ldag, lregion, lranges, lts)))
    finally:
        gpu_engine._BLOCK = block
    (odag, oregion, oranges, ots), _c, ostats = _capture_task(db, SQL_QUERIES["q15rev"])
    if not ostats["regrows"]:
        raise AssertionError(f"probe: q15rev's task did not overflow the default agg cap: {ostats}")
    out.append(_refused(f"an agg-cap overflow (q15rev; production regrew {ostats['regrows']} times)",
                        lambda: probe(db.store, odag, oregion, oranges, ots)))
    return out


def _probe_phase(db, cols: dict, gs, device: str = "cuda", k: int = PROBE_K) -> None:
    """Phase 17, the engine's chip probe and cold builds, on phase 5's
    database (two regions, before any write).

    Probe: for each of ``PROBE_QUERIES`` one cop task is captured through
    the SQL layer (bench.py's ``chip_time``) and its
    ``gpu_engine.device_probe_fn`` built; the decoded outputs of the last
    of ``k`` ``run_once`` calls (dispatched back to back, then one sync)
    must equal the task's chunk bit for bit, and K1 must launch exactly once
    per ``run_once`` during band and never during the others. Prints per
    statement the engine path, programs per run, the amortized ms and the
    host syncs one ``run_once`` makes. The five refused shapes
    (``_probe_rejections``) must raise ValueError.

    Cold builds: each of ``COLD_QUERIES`` (a DAG shape new to the process)
    runs under EXPLAIN ANALYZE, which must show ``compile:``, with the cop
    tasks' ``compile_ms`` > 0 and ``COP_COMPILE_SECONDS`` grown by the
    programs built (the two concurrent tasks share one program: one
    claimant); then plainly, warm: the oracle's rows, ``compile_ms`` 0 and
    the histogram flat. Prints each cold ``compile_ms`` and, for band,
    whether K1's build and load fell inside it."""
    import torch

    from tidb_tpu_torch.copr import gpu_engine
    from tidb_tpu_torch.native import cuda as native
    from tidb_tpu_torch.ops import dag_kernel
    from tidb_tpu_torch.utils import metrics

    for name in PROBE_QUERIES:
        (dag, region, ranges, ts), chunk, stats = _capture_task(db, SQL_QUERIES[name])
        run_once, sync = gpu_engine.device_probe_fn(db.store, dag, region, ranges, ts)
        sync(run_once())  # warm
        syncs = _host_syncs(run_once) if device != "cpu" else None
        if device != "cpu":
            torch.cuda.synchronize()
        before = gs.LAUNCHES
        t0 = time.perf_counter()
        outs = [run_once() for _ in range(k)]
        sync(outs[-1])
        ms = (time.perf_counter() - t0) * 1e3 / k
        per_run = (gs.LAUNCHES - before) / k
        if not _same_chunk(run_once.chunk(outs[-1]), chunk):
            raise AssertionError(f"probe {name}: the last run_once's outputs disagree with the task's chunk")
        if per_run != (1 if name == "band" else 0):
            raise AssertionError(f"probe {name}: K1 launched {per_run} times per run_once")
        print(f"probe {name}: path {stats['path']}; programs per run_once {len(outs[-1])}; amortized_ms {ms:.4f} "
              f"(K={k}, one sync); host syncs per run_once {'not measured' if syncs is None else syncs}; "
              f"K1 launches per run_once {per_run:g}; equal to the task's chunk ({len(chunk)} rows)")
    for line in _probe_rejections(db):
        print(f"probe refuses {line}")

    s = db.session()
    every_region = {"gpu": len(db.store.regions())}
    for name, sql in COLD_QUERIES.items():
        k1_loaded = ("grouped_sums", ()) in native._LIBS
        built, n0 = len(dag_kernel._COMPILE_CACHE), metrics.COP_COMPILE_SECONDS.count
        t0 = time.perf_counter()
        text = "\n".join(" ".join(str(v) for v in r) for r in s.query("EXPLAIN ANALYZE " + sql))
        wall = (time.perf_counter() - t0) * 1e3
        summ = s.exec_summary
        misses = len(dag_kernel._COMPILE_CACHE) - built
        grew = metrics.COP_COMPILE_SECONDS.count - n0
        if not misses or grew != misses or summ is None or not summ.compile_ms > 0 or "compile:" not in text:
            raise AssertionError(f"cold {name}: {misses} programs built, the histogram grew {grew}, compile_ms "
                                 f"{summ and summ.compile_ms}, EXPLAIN ANALYZE shows compile: {'compile:' in text}")
        cold_ms = summ.compile_ms
        rows = s.query(sql)
        summ = s.exec_summary
        if sql_rows(name, rows) != sql_oracle(name, cols):
            raise AssertionError(f"cold {name}: rows disagree with the numpy oracle")
        if summ.compile_ms != 0 or metrics.COP_COMPILE_SECONDS.count != n0 + grew or summ.engines != every_region:
            raise AssertionError(f"cold {name}: the warm rerun charged compile_ms {summ.compile_ms} on {summ.engines}")
        note = ""
        if name == "band":
            note = ("; K1's build and load: " + ("before this phase (not inside it)" if k1_loaded else
                    "inside it" if ("grouped_sums", ()) in native._LIBS else "not reached"))
        print(f"cold {name}: programs built {misses}; histogram +{grew}; compile_ms {cold_ms:.3f} "
              f"(EXPLAIN ANALYZE wall {wall:.3f} ms); warm rerun compile_ms 0, rows equal to the oracle{note}")


def _htap_phase(db, cols: dict, gs, before: dict, seed: int, reps: int = 10):
    """Reads after writes on the SQL phase's database: ``htap_writes``
    (an UPDATE of about 1,000 lines of the first region with one price past
    the int32 envelope and one quantity past 50, a DELETE of about 200
    lines and an INSERT of 300 of the second), which the default compactor
    leaves pending (under its 2,048-row fold threshold), so every read
    takes the delta operand. Each statement of ``SQL_QUERIES`` runs once
    cold and ``reps`` times warm: its rows must equal the numpy oracle over
    the written columns, every cop task must run on ``gpu`` with none
    degraded and fold its region's whole delta in (ExecDetails
    ``delta_rows``), and K1 must launch during the band query, at n =
    region rows padded + the delta capacity, and not during Q1; K1 is held
    bit-exact against its plain version on the delta path's own input.
    Prints per statement the warm median with the delta pending beside the
    phase-5 warm median (``before``) and the host engine's median of 3
    (what a read after a write cost before the delta operand), the delta
    operand's host-to-card bytes and time, then folds the deltas with the
    compactor and checks the statements again. → (K1 launches over the
    cold drive of the statements, K1's largest error on the delta path's
    input, the columns after the writes)."""
    import dataclasses

    import torch

    from tidb_tpu_torch import config as port_config
    from tidb_tpu_torch.copr import colcache, gpu_engine
    from tidb_tpu_torch.ops import dag_kernel
    from tidb_tpu_torch.utils.chunk import bucket_size

    updates, deletes, insert, after, d1, d2 = htap_writes(cols, seed)
    t0 = time.perf_counter()
    commit_rows(db, updates, ())
    commit_rows(db, {}, deletes)
    db.execute(insert)
    n_regions = len(db.store.regions())
    print(f"htap: 3 writes ({len(updates)} rows updated, {len(deletes)} deleted, {len(after[0]) - len(cols[0]) + len(deletes)} "
          f"inserted) in {time.perf_counter() - t0:.3f} s; changed handles per region {d1}, {d2} "
          f"(cap {port_config.current().device_delta_cap}, fold threshold "
          f"{port_config.current().device_delta_merge_rows}); {len(after[0])} rows after them")
    want = {name: sql_oracle(name, after) for name in SQL_QUERIES}
    s = db.session()

    def run(name, delta_rows, sess=s, engine="gpu"):
        t0 = time.perf_counter()
        rows = sess.query(SQL_QUERIES[name])
        wall = (time.perf_counter() - t0) * 1e3
        summ = sess.exec_summary
        if summ is None or summ.engines != {engine: n_regions} or summ.degraded:
            raise AssertionError(f"htap {name}: cop tasks {summ and summ.engines}, degraded {summ and summ.degraded}")
        if engine == "gpu" and summ.delta_rows != delta_rows:
            raise AssertionError(f"htap {name}: the tasks folded {summ.delta_rows} delta rows, not {delta_rows}")
        if sql_rows(name, rows) != want[name]:
            raise AssertionError(f"htap {name}: rows disagree with the numpy oracle over the written columns")
        return wall, summ

    k1_inputs, tasks = [], []
    real_k1, real_exec = dag_kernel.grouped_sums, gpu_engine.execute_region

    def recording_k1(seg, pairs, B, n_pad, bounds=None, device="cuda"):
        k1_inputs.append((seg, pairs, B, n_pad, bounds))
        return real_k1(seg, pairs, B, n_pad, bounds, device=device)

    def recording_exec(region, dag, ranges, warn=None, device="cuda", stats=None):
        stats = {} if stats is None else stats
        tasks.append((region, dag, stats, ranges))
        return real_exec(region, dag, ranges, warn, device, stats)

    dag_kernel.grouped_sums, gpu_engine.execute_region = recording_k1, recording_exec
    cold, by_query, routes, h2d, task_args = {}, {}, {}, {}, {}
    try:
        gs.LAUNCHES = 0  # the delta path: counts from 0 just before it
        for name in SQL_QUERIES:
            tasks.clear()
            l0, k0 = gs.LAUNCHES, len(k1_inputs)
            cold[name], summ = run(name, d1 + d2)
            by_query[name] = gs.LAUNCHES - l0
            routes[name] = [(st["path"], st["routes"], st["delta_rows"]) for _r, _d, st, _rg in tasks]
            task_args[name] = [(r, d, rg) for r, d, _st, rg in tasks]
            h2d[name] = summ.h2d_bytes
            if name == "band":
                want_n = sorted(bucket_size(r.entry.n) + gpu_engine._delta_cap() for r, _d, _st, _rg in tasks)
                got_n = sorted(inp[3] for inp in k1_inputs[k0:])
                if got_n != want_n:
                    raise AssertionError(f"htap band: K1 ran over n = {got_n}, not the padded region + delta {want_n}")
        launches = gs.LAUNCHES
        # the delta operand of a full-width scan (all fourteen columns), per region
        tasks.clear()
        s.query("SELECT * FROM lineitem WHERE l_quantity < 0")
        operand = [(r, d) for r, d, _st, _rg in tasks]
    finally:
        dag_kernel.grouped_sums, gpu_engine.execute_region = real_k1, real_exec
    print(f"htap: K1 launches by statement (cold drive, delta pending): {by_query}")
    if by_query["band"] < 1 or by_query["q1"] != 0:
        raise AssertionError(f"K1 must run for the band query and not for Q1 on the delta path: {by_query}")
    for name in SQL_QUERIES:
        print(f"htap {name}: tasks (path, routes, delta_rows) {routes[name]}; cold h2d bytes {h2d[name]}")
    err = 0
    for seg, pairs, B, n_pad, bounds in k1_inputs:  # the band query's tasks
        err = max(err, _k1_err(seg, pairs, B, n_pad, bounds))
        print(f"htap: K1 on the delta path's input n_pad={n_pad} B={B} lanes "
              f"{[str(v.dtype).replace('torch.', '') for v, _ in pairs]} bounds {bounds}: bit-exact; "
              f"ms {_time_ms(lambda: gs.grouped_sums(seg, pairs, B, n_pad, bounds, device=seg.device)):.4f}")
    del k1_inputs, seg, pairs
    dev = gpu_engine.store_device(db.store)
    for ri, (region, dag) in enumerate(operand):
        view = dataclasses.replace(region, cacheable=False)
        nbytes = 0
        times = []
        for _ in range(reps):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            dh, dcols, dtomb = gpu_engine._delta_device_inputs(view, dag.executors[0], dev)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
            nbytes = dh.nbytes + dtomb.nbytes + sum(d.nbytes + v.nbytes for d, v in dcols)
        print(f"htap: delta operand region {ri}: {region.delta.n} rows padded to {gpu_engine._delta_cap()}, "
              f"{len(dcols)} column pairs + handles + tombstones, {nbytes} bytes host to card in "
              f"{statistics.median(times):.3f} ms median of {reps} (uncached upload, host clock around it)")

    # each statement's region tasks alone, with the delta and on the base
    # alone (the task phase 5 ran): where the delta fold's time goes
    for name in SQL_QUERIES:
        for region, dag, ranges in task_args[name]:
            t = _task_timing(gpu_engine, region, dag, ranges)
            b = _task_timing(gpu_engine, dataclasses.replace(region, delta=None), dag, ranges)
            print(f"htap {name} task over {region.entry.n} base + {region.delta.n} delta rows: wall_ms median "
                  f"{t['wall']:.3f}, device_busy_ms {_ms(t['busy'])}, idle_share {t['idle']}; the same task on "
                  f"its base alone: wall_ms median {b['wall']:.3f}, device_busy_ms {_ms(b['busy'])}, idle_share "
                  f"{b['idle']}")
            for k, ms, calls in t["top"]:
                print(f"    top kernel {ms:.3f} ms x{calls}: {k[:110]}")

    host = db.session()
    host.execute("SET tidb_isolation_read_engines='host'")
    for name in SQL_QUERIES:
        runs = [run(name, d1 + d2) for _ in range(reps)]
        walls = [w for w, _summ in runs]
        host_ms = statistics.median(run(name, 0, host, "host")[0] for _ in range(3))
        med = statistics.median(walls)
        print(f"htap {name}: cold_ms {cold[name]:.3f}; warm sql_ms with the delta pending median {med:.3f} "
              f"min {min(walls):.3f}; cop_task_sum_ms median {statistics.median(sum(m.procs) for _w, m in runs):.3f}; "
              f"cop_task_max_ms median {statistics.median(max(m.procs) for _w, m in runs):.3f}; warm h2d bytes "
              f"{max(m.h2d_bytes for _w, m in runs)} at most; before the writes "
              f"(phase 5) median {before[name]:.3f}; host engine median of 3 {host_ms:.3f} "
              f"(host/delta {host_ms / med:.2f}x)")

    cache = colcache.cache_for(db.store)
    merged_default = db.run_delta_merge()
    if merged_default != 0 or cache.delta_rows_pending() != d1 + d2:
        raise AssertionError(f"the default compactor folded {merged_default} deltas; it must leave them pending")
    cfg = port_config.current()
    port_config.set_current(dataclasses.replace(cfg, device_delta_merge_rows=1))
    try:
        merged = db.run_delta_merge()
    finally:
        port_config.set_current(cfg)
    if merged != n_regions or cache.delta_rows_pending() != 0:
        raise AssertionError(f"compactor at threshold 1: {merged} folds, {cache.delta_rows_pending()} rows pending")
    after_merge = {name: run(name, 0)[0] for name in SQL_QUERIES}
    print(f"htap: compactor folded {merged} deltas (threshold 1; the default 2,048 folded none); the statements "
          f"equal the oracle on gpu with no delta: first run ms {json.dumps({k: round(v, 3) for k, v in after_merge.items()})}")
    return launches, err, after


BUILTIN_ROWS = 4_194_304  # one device block
# builtins whose integer result converts a double: out of the int64 range
# (and NaN) the host's C cast gives INT64_MIN, the device saturates (and
# maps NaN to 0) as the reference's XLA conversion does
_F2I_NAMES = frozenset({"cast_int", "ceil", "floor", "sign", "intdiv", "cast_decimal"})
_TINY = 2.2250738585072014e-308  # the least normal double


def _builtins_phase(db, cols: dict, gs, reps: int = 10):
    """``BUILTIN_QUERIES`` on the SQL phase's database after the HTAP phase
    (``cols``: the columns the writes left): each once cold and ``reps``
    times warm. Every run must equal ``builtin_oracle`` (integer and
    decimal lanes exact, float lanes within ``FLOAT_REL``), every cop task
    must run on ``gpu`` with none degraded and copy bytes off the card, and
    K1 must launch during ``bandf``. Prints per statement each task's path
    and routes, the cold wall, the warm median, the summed and longest
    cop-task walls, and the host engine's median of 3 on the same data
    (what the parent commit ran these statements on). → K1 launches over
    the cold drive."""
    from tidb_tpu_torch.copr import gpu_engine

    n_regions = len(db.store.regions())
    want = {name: builtin_oracle(name, cols) for name in BUILTIN_QUERIES}
    s = db.session()

    def run(name, sess=s, engine="gpu"):
        t0 = time.perf_counter()
        rows = sorted(sess.query(BUILTIN_QUERIES[name]), key=repr)
        wall = (time.perf_counter() - t0) * 1e3
        summ = sess.exec_summary
        if summ is None or summ.engines != {engine: n_regions} or summ.degraded:
            raise AssertionError(f"builtins {name}: cop tasks {summ and summ.engines}, degraded {summ and summ.degraded}")
        if engine == "gpu" and summ.d2h_bytes <= 0:
            raise AssertionError(f"builtins {name}: the tasks report {summ.d2h_bytes} bytes copied off the card")
        if not rows_match(rows, want[name]):
            raise AssertionError(f"builtins {name}: rows disagree with the numpy oracle: {rows[:3]} against {want[name][:3]}")
        return wall, summ

    tasks = []
    real_exec = gpu_engine.execute_region

    def recording_exec(region, dag, ranges, warn=None, device="cuda", stats=None):
        stats = {} if stats is None else stats
        tasks.append(stats)
        return real_exec(region, dag, ranges, warn, device, stats)

    gpu_engine.execute_region = recording_exec
    cold, by_query, routes = {}, {}, {}
    try:
        gs.LAUNCHES = 0  # the builtins path: counts from 0 just before it
        for name in BUILTIN_QUERIES:
            tasks.clear()
            before = gs.LAUNCHES
            cold[name] = run(name)[0]
            by_query[name] = gs.LAUNCHES - before
            routes[name] = [(st.get("path"), st.get("routes")) for st in tasks]
        launches = gs.LAUNCHES
    finally:
        gpu_engine.execute_region = real_exec
    print(f"builtins: K1 launches by statement (cold drive): {by_query}")
    if by_query["bandf"] < 1:
        raise AssertionError(f"K1 must run for bandf: {by_query}")
    host = db.session()
    host.execute("SET tidb_isolation_read_engines='host'")
    for name in BUILTIN_QUERIES:
        runs = [run(name) for _ in range(reps)]
        walls = [w for w, _m in runs]
        host_ms = statistics.median(run(name, host, "host")[0] for _ in range(3))
        med = statistics.median(walls)
        print(f"builtins {name}: tasks (path, routes) {routes[name]}; cold_ms {cold[name]:.3f}; warm sql_ms median "
              f"{med:.3f} min {min(walls):.3f}; cop_task_sum_ms median "
              f"{statistics.median(sum(m.procs) for _w, m in runs):.3f}; cop_task_max_ms median "
              f"{statistics.median(max(m.procs) for _w, m in runs):.3f}; d2h bytes "
              f"{runs[-1][1].d2h_bytes}; host engine median of 3 {host_ms:.3f} (host/gpu {host_ms / med:.2f}x); "
              f"rows {len(want[name])}")
    return launches


def _builtin_lane_cache(seed: int, n: int, device):
    """(kind, argument index) → (data, valid, data on ``device``, valid on
    ``device``), each drawn once from its own seed."""
    import torch

    cache = {}

    def lane(kind, i):
        key = (kind, i)
        if key not in cache:
            rng = np.random.default_rng([seed, i, list(BUILTIN_KINDS).index(kind)])
            data = np.asarray(BUILTIN_KINDS[kind][3](rng, n))
            valid = rng.random(n) > 0.15
            valid[:6] = True
            cache[key] = (data, valid, torch.from_numpy(data).to(device), torch.from_numpy(valid).to(device))
        return cache[key]

    return lane


def _np_lane(x, n: int, dtype=None):
    import torch

    if isinstance(x, torch.Tensor):
        x = x.cpu().numpy()
    if x is None:
        x = True
    return np.broadcast_to(np.asarray(x, dtype=dtype), (n,))


def _builtins_check(seed: int, n: int = BUILTIN_ROWS, device: str = "cuda") -> dict:
    """Every gpu-legal builtin, each argument signature of
    ``BUILTIN_CASES``, over ``n``-row lanes on the card, held against the
    same body run with numpy on the host: validity and integer, decimal,
    date and boolean lanes exact; float lanes bit-equal or within
    ``FLOAT_REL`` (their worst distance in ulps kept); counted apart: a
    double converted out of the int64 range (``_F2I_NAMES``) and two
    floats both below the least normal double. Raises on any other
    difference. → the ``builtins`` line's object."""
    import torch

    from tidb_tpu_torch.expression import expr as port_expr
    from tidb_tpu_torch.expression.registry import REGISTRY
    from tidb_tpu_torch.types import FieldType, TypeKind

    t0 = time.perf_counter()
    names = sorted(k for k, spec in REGISTRY.items() if "gpu" in spec.engines)
    if sorted(BUILTIN_CASES) != names:
        raise AssertionError(f"the gpu-legal builtins and the cases differ: {sorted(set(names) ^ set(BUILTIN_CASES))}")
    lane = _builtin_lane_cache(seed, n, torch.device(device))
    status, ulps, cases, saturated, subnormal = {}, {}, 0, 0, 0
    i64_min, i64_max = -(1 << 63), (1 << 63) - 1
    for name in names:
        worst, exact = 0.0, True
        for sig, ret in builtin_cases(name):
            lanes = builtin_lanes(sig, None, n, lane=lambda k, i: lane(k, i)[:2])
            e = builtin_expr(port_expr, FieldType, TypeKind, name, lanes, ret)
            host_cols = [lane(a, i)[:2] for i, a in enumerate(sig) if not isinstance(a, tuple)]
            dev_cols = [lane(a, i)[2:] for i, a in enumerate(sig) if not isinstance(a, tuple)]
            hd, hv, _ = port_expr.eval_expr(e, port_expr.EvalBatch(host_cols, [None] * len(host_cols), n), np)
            dd, dv, _ = port_expr.eval_expr(e, port_expr.EvalBatch(dev_cols, [None] * len(dev_cols), n), torch)
            cases += 1
            hv = _np_lane(hv, n, bool)
            if not np.array_equal(_np_lane(dv, n, bool), hv):
                raise AssertionError(f"builtin {name} {sig}: validity differs between the card and numpy")
            hd, dd = _np_lane(hd, n), _np_lane(dd, n)
            if e.ftype.kind == TypeKind.FLOAT:
                hd, dd = hd.astype(np.float64)[hv], dd.astype(np.float64)[hv]
                same = (hd.view(np.int64) == dd.view(np.int64)) | (np.isnan(hd) & np.isnan(dd))
                if not same.all():
                    exact = False
                    a, b = dd[~same], hd[~same]
                    # both below the least normal double: libdevice's exp
                    # flushes to 0 where glibc returns a subnormal, and a
                    # relative tolerance means nothing there
                    tiny = (np.abs(a) < _TINY) & (np.abs(b) < _TINY)
                    subnormal += int(tiny.sum())
                    a, b = a[~tiny], b[~tiny]
                    with np.errstate(all="ignore"):
                        close = np.abs(a - b) <= FLOAT_REL * np.maximum(np.abs(a), np.abs(b))
                    if not close.all():
                        raise AssertionError(f"builtin {name} {sig}: card {a[~close][:4]} against numpy {b[~close][:4]}")
                    if len(a):
                        worst = max(worst, float((np.abs(a - b) / np.spacing(np.abs(b))).max()))
            else:
                hd, dd = hd.astype(np.int64)[hv], dd.astype(np.int64)[hv]
                bad = hd != dd
                if bad.any() and name in _F2I_NAMES and any(
                        not isinstance(a, tuple) and BUILTIN_KINDS[a][0] == "FLOAT" for a in sig):
                    sat = bad & (hd == i64_min) & np.isin(dd, [i64_min, i64_max, 0])
                    saturated += int(sat.sum())
                    bad &= ~sat
                if bad.any():
                    raise AssertionError(f"builtin {name} {sig}: card {dd[bad][:4]} against numpy {hd[bad][:4]}")
        status[name] = "exact" if exact else "within_tolerance"
        if not exact:
            ulps[name] = worst
    return {
        "rows": n, "names": len(names), "cases": cases,
        "exact": sum(v == "exact" for v in status.values()),
        "within_tolerance": sum(v == "within_tolerance" for v in status.values()),
        "worst_float_ulp": max(ulps.values(), default=0.0), "ulp_by_name": ulps,
        "saturated_rows": saturated, "subnormal_rows": subnormal, "seconds": round(time.perf_counter() - t0, 3),
    }


# -- windows: the sorted-batch window program in the region task and at the
# root, over one SF1 region (the reference bench's layout, bench.py:67)

_WIN_SUPP = "PARTITION BY l_suppkey ORDER BY l_orderkey"
WINDOW_QUERIES = {
    # bench.py's WINDOWED, verbatim
    "win": """SELECT l_returnflag, MAX(rn), MAX(cum) FROM (
    SELECT l_returnflag,
           ROW_NUMBER() OVER (PARTITION BY l_returnflag ORDER BY l_extendedprice) AS rn,
           SUM(l_quantity) OVER (PARTITION BY l_returnflag ORDER BY l_extendedprice) AS cum
    FROM lineitem WHERE l_shipdate < DATE '1994-01-01') t
    GROUP BY l_returnflag ORDER BY l_returnflag""",
    # the doubles sum as integers (1e-9 units: exact in any order), and their
    # extremes compare as doubles
    "ranks": """SELECT l_returnflag, l_linestatus, SUM(r), SUM(dr), SUM(CAST(pr * 1000000000 AS SIGNED)),
      SUM(CAST(cd * 1000000000 AS SIGNED)), MAX(pr), MIN(cd) FROM (
    SELECT l_returnflag, l_linestatus,
      RANK() OVER (PARTITION BY l_returnflag, l_linestatus ORDER BY l_quantity DESC) AS r,
      DENSE_RANK() OVER (PARTITION BY l_returnflag, l_linestatus ORDER BY l_quantity DESC) AS dr,
      PERCENT_RANK() OVER (PARTITION BY l_returnflag, l_linestatus ORDER BY l_quantity DESC) AS pr,
      CUME_DIST() OVER (PARTITION BY l_returnflag, l_linestatus ORDER BY l_quantity DESC) AS cd
    FROM lineitem) t GROUP BY l_returnflag, l_linestatus ORDER BY l_returnflag, l_linestatus""",
    "leadlag": """SELECT COUNT(*), SUM(lg), COUNT(lg), SUM(ld), SUM(nt), SUM(fv), SUM(lv) FROM (
    SELECT LAG(l_extendedprice) OVER (PARTITION BY l_suppkey ORDER BY l_shipdate) AS lg,
      LEAD(l_quantity, 2, 0) OVER (PARTITION BY l_suppkey ORDER BY l_shipdate) AS ld,
      NTILE(4) OVER (PARTITION BY l_suppkey ORDER BY l_shipdate) AS nt,
      FIRST_VALUE(l_orderkey) OVER (PARTITION BY l_suppkey ORDER BY l_shipdate) AS fv,
      LAST_VALUE(l_orderkey) OVER (PARTITION BY l_suppkey ORDER BY l_shipdate) AS lv
    FROM lineitem) t""",
    "frames": f"""SELECT SUM(sq), SUM(ap), SUM(cd) FROM (
    SELECT SUM(l_quantity) OVER ({_WIN_SUPP} ROWS BETWEEN 3 PRECEDING AND 1 FOLLOWING) AS sq,
      AVG(l_extendedprice) OVER ({_WIN_SUPP} ROWS BETWEEN 3 PRECEDING AND 1 FOLLOWING) AS ap,
      COUNT(l_discount) OVER ({_WIN_SUPP} ROWS BETWEEN 3 PRECEDING AND 1 FOLLOWING) AS cd
    FROM lineitem) t""",
    "running": f"""SELECT SUM(mn), SUM(mx) FROM (
    SELECT MIN(l_extendedprice) OVER ({_WIN_SUPP}) AS mn, MAX(l_quantity) OVER ({_WIN_SUPP}) AS mx
    FROM lineitem) t""",
    "strord": """SELECT l_returnflag, SUM(r), SUM(dr), COUNT(*) FROM (
    SELECT l_returnflag, RANK() OVER (PARTITION BY l_returnflag ORDER BY l_shipmode) AS r,
      DENSE_RANK() OVER (PARTITION BY l_returnflag ORDER BY l_shipmode) AS dr
    FROM lineitem) t GROUP BY l_returnflag ORDER BY l_returnflag""",
    "wtopn": """SELECT * FROM (
    SELECT l_orderkey, l_linenumber, l_extendedprice,
      ROW_NUMBER() OVER (ORDER BY l_extendedprice DESC) AS rn
    FROM lineitem) t ORDER BY rn LIMIT 10""",
    # a window over an aggregate (1.5M groups): the root's WindowExec
    "rootwin": """SELECT COUNT(*), SUM(r), MAX(r) FROM (
    SELECT RANK() OVER (ORDER BY s DESC) AS r FROM (
      SELECT l_orderkey, SUM(l_quantity) AS s FROM lineitem GROUP BY l_orderkey) t1) t2""",
}
WINDOW_ROOT = "rootwin"

# window_program cases (name, has_arg, arg_is_float, c0, c1, c2_is_float)
# and the argument lane each reads ("i" integer/decimal, "f" double)
WINDOW_SPECS = [
    (("row_number", False, False, 0, 0, False), None),
    (("rank", False, False, 0, 0, False), None),
    (("dense_rank", False, False, 0, 0, False), None),
    (("percent_rank", False, False, 0, 0, False), None),
    (("cume_dist", False, False, 0, 0, False), None),
    (("ntile", False, False, 4, 0, False), None),
    (("ntile", False, False, 7, 0, False), None),
    (("lead", True, False, 2, 0, False), "i"),  # NULL default
    (("lag", True, False, 1, -7, True), "i"),  # constant default
    (("lag", True, True, 3, 2.5, True), "f"),
    (("lead", True, True, 1, 0, False), "f"),
    (("first_value", True, False, 0, 0, False), "i"),
    (("last_value", True, True, 0, 0, False), "f"),
    (("count", False, False, 0, 0, False), None),  # COUNT(*)
    (("count", True, False, 0, 0, False), "i"),
    (("sum", True, False, 0, 0, False), "i"),
    (("sum", True, True, 0, 0, False), "f"),
    (("avg", True, False, 10**4, 0, False), "i"),  # DECIMAL(.., 2) → scale 6
    (("avg", True, True, 0, 0, False), "f"),
    (("min", True, False, 0, 0, False), "i"),
    (("max", True, False, 0, 0, False), "i"),
    (("min", True, True, 0, 0, False), "f"),
    (("max", True, True, 0, 0, False), "f"),
]


def window_batch(sort: str, n: int, seed: int, n_part: int = 1):
    """Seeded window_program inputs: (mask, partition lanes, order lanes,
    order descs, argument lanes by kind, sort bounds). ``sort`` picks the
    sort the bounds lead to: "int32" (a packed key of at most 31 bits),
    "int64" (32..62 bits) or "multilane" (a double order key, no bounds).
    A padded tail and random filtered rows are dead; NULL slots of every
    lane hold garbage values; ~5 % of the keys and ~15 % of the arguments
    are NULL."""
    from tidb_tpu_torch.ops.window_core import widen_bounds

    rng = np.random.default_rng(seed)
    mask = (np.arange(n) < n - n // 8) & (rng.random(n) > 0.1)

    def lane(vals, p_null):
        valid = rng.random(n) > p_null
        garbage = rng.integers(-(1 << 40), 1 << 40, n).astype(vals.dtype)
        return np.where(valid, vals, garbage), valid

    part_dom = 5 if sort != "int64" else 1 << 10
    parts = [lane(rng.integers(0, part_dom, n), 0.05) for _ in range(n_part)]
    if sort == "int32":
        orders, descs = [lane(rng.integers(0, 100, n), 0.05)], [True]
    elif sort == "int64":
        orders = [lane(rng.integers(-(1 << 20), 1 << 20, n), 0.05), lane(rng.integers(0, 6, n), 0.1)]
        descs = [False, True]
    else:
        orders = [lane(rng.integers(0, 9, n), 0.05), lane(np.round(rng.random(n) * 50, 1), 0.05)]
        descs = [False, True]
    args = {"i": lane(rng.integers(-10**6, 10**6, n), 0.15), "f": lane(rng.normal(0, 1e3, n), 0.15)}
    bounds = None
    if sort != "multilane":
        bounds = widen_bounds([(int(d[v].min()), int(d[v].max())) for d, v in parts + orders])
    return mask, parts, orders, descs, args, bounds


def _window_key_bits(bounds, n: int):
    """The packed sort key's bits (live bit included), or None."""
    from tidb_tpu_torch.ops.window_core import packed_bits

    widths = packed_bits(bounds, n)
    return None if widths is None else 1 + sum(max(int(w - 1).bit_length(), 1) for w in widths)


def _window_phase(cols: dict, seed: int, reps: int = 5, device: str = "cuda"):
    """``WINDOW_QUERIES`` through ``tidb_tpu_torch.open`` over ``cols`` as
    ONE region (6,001,215 rows, two blocks: the fused window program runs
    over 8,388,608 rows), each once cold and ``reps`` times warm. Every
    statement must equal the port's host engine on the same database
    (integers and decimals exact, doubles within ``FLOAT_REL``); every cop
    task must run on ``gpu``, none degraded, and each statement but
    ``rootwin`` must carry its window inside its task (path ``fused``);
    ``rootwin``'s window runs on the root, and the phase prints where the
    cost model sent it. Prints per statement the packed key's bits, the
    warm median, the cop-task walls, the host engine's wall and the device
    busy time and top ops of one profiled task. Then commits
    ``htap_writes``: ``win`` must merge the pending delta first and equal
    the host engine. Last, times both sides of the root's cost model at
    ``rootwin``'s input (``_window_costs``). → the cost model's line."""
    import tidb_tpu_torch
    from tidb_tpu_torch.copr import colcache, gpu_engine
    from tidb_tpu_torch.copr.binder import Binder
    from tidb_tpu_torch.executor import executors
    from tidb_tpu_torch.executor.load import bulk_load
    from tidb_tpu_torch.kv.tablecodec import record_key
    from tidb_tpu_torch.ops import window_kernel as wk

    db = tidb_tpu_torch.open(region_split_keys=1 << 62, device=device)
    load_s = lineitem_sql(db, bulk_load, record_key, cols, parts=1)
    if len(db.store.regions()) != 1:
        raise AssertionError(f"window phase: {len(db.store.regions())} regions, not one")
    print(f"window: bulk load {load_s:.3f} s, {len(cols[0])} rows, one region")
    s, host = db.session(), db.session()
    host.execute("SET tidb_isolation_read_engines='host'")
    tasks, roots = [], []
    real_exec, real_try = gpu_engine.execute_region, executors.WindowExec._try_device

    def recording_exec(region, dag, ranges, warn=None, device="cuda", stats=None):
        stats = {} if stats is None else stats
        tasks.append((region, dag, ranges, stats))
        return real_exec(region, dag, ranges, warn, device, stats)

    def recording_try(self, chunk, n):
        out = real_try(self, chunk, n)
        roots.append((self, chunk, n, out is not None))
        return out

    def run(name, sess=s, engine="gpu"):
        del tasks[:], roots[:]
        t0 = time.perf_counter()
        rows = sess.query(WINDOW_QUERIES[name])
        wall = (time.perf_counter() - t0) * 1e3
        summ = sess.exec_summary
        if summ is None or summ.engines != {engine: 1} or summ.degraded:
            raise AssertionError(f"window {name}: cop tasks {summ and summ.engines}, degraded {summ and summ.degraded}")
        if engine == "gpu":
            win_tasks = [t for t in tasks if gpu_engine._has_window(t[1])]
            want_tasks = 0 if name == WINDOW_ROOT else 1
            if len(win_tasks) != want_tasks or any(t[3]["path"] != "fused" for t in win_tasks):
                raise AssertionError(f"window {name}: window tasks {[(t[3].get('path')) for t in win_tasks]}")
        return rows, wall, summ

    gpu_engine.execute_region, executors.WindowExec._try_device = recording_exec, recording_try
    try:
        host_rows = {}
        for name in WINDOW_QUERIES:
            t0 = time.perf_counter()
            host_rows[name] = run(name, host, "host")[0]
            host_ms = (time.perf_counter() - t0) * 1e3
            rows, cold, _summ = run(name)
            if not rows_match(rows, host_rows[name]):
                raise AssertionError(f"window {name}: rows disagree with the host engine: {rows[:3]} against "
                                     f"{host_rows[name][:3]}")
            if name == WINDOW_ROOT:
                (wexec, chunk, n, on_card), = roots
                nf = len(wexec.plan.funcs)
                choice = wk.device_beats_host(n, len(wexec.plan.order_by) + len(wexec.plan.partition_by), nf)
                where = f"root window over {n} rows, cost model picks {'the card' if choice else 'the host'}; " \
                        f"ran on {'the card' if on_card else 'the host'}"
                profiled = lambda: real_try(wexec, chunk, n)  # noqa: E731
                bits = "in the cost line"
            else:
                region, dag, ranges, st = next(t for t in tasks if gpu_engine._has_window(t[1]))
                scan = dag.executors[0]
                bound = Binder(region.cache, scan.table_id, scan.columns, region.entry).bind_dag(dag)
                wex = next(ex for ex in bound.executors if ex.tp == "window")
                n_total = gpu_engine._n_blocks(region.entry.n) * gpu_engine._BLOCK
                bits = _window_key_bits([tuple(b) if b is not None else None for b in wex.sort_bounds], n_total)
                where = f"window in the task, path {st['path']}, routes {list(st.get('routes', ()))}, n {n_total}"
                profiled = lambda: real_exec(region, dag, ranges, device=device)  # noqa: E731
            runs = [run(name) for _ in range(reps)]
            for r in runs:
                if not rows_match(r[0], host_rows[name]):
                    raise AssertionError(f"window {name}: a warm run disagrees with the host engine")
            walls = [w for _r, w, _m in runs]
            med = statistics.median(walls)
            kernels = _profile_device(profiled)
            busy = sum(k[1] for k in kernels) if kernels else None
            print(f"window {name}: {where}; key bits {bits}; cold_ms {cold:.3f}; warm sql_ms median {med:.3f} "
                  f"min {min(walls):.3f}; cop_task_sum_ms median {statistics.median(sum(m.procs) for _r, _w, m in runs):.3f}; "
                  f"cop_task_max_ms median {statistics.median(max(m.procs) for _r, _w, m in runs):.3f}; "
                  f"host engine ms {host_ms:.3f} (host/gpu {host_ms / med:.2f}x); profiled device_busy_ms {_ms(busy)}; "
                  f"rows {len(rows)}")
            for k, ms, calls in kernels[:4]:
                print(f"    top op {ms:.3f} ms x{calls}: {k[:110]}")

        # a window read after writes: the delta folds into the base first
        updates, deletes, insert, after, d1, d2 = htap_writes(cols, seed)
        commit_rows(db, updates, ())
        commit_rows(db, {}, deletes)
        db.execute(insert)
        s.query("SELECT COUNT(*) FROM lineitem")  # builds the delta; it stays pending
        cache = colcache.cache_for(db.store)
        pending = cache.delta_rows_pending()
        if pending <= 0:
            raise AssertionError("window: no delta pending after the writes")
        rows, wall, summ = run("win")
        (_r, _d, _g, st), = [t for t in tasks if gpu_engine._has_window(t[1])]
        if st["delta_rows"] != 0 or summ.delta_rows != 0 or cache.delta_rows_pending() != 0:
            raise AssertionError(f"window after writes: delta rows {st['delta_rows']}, {cache.delta_rows_pending()} pending")
        want = run("win", host, "host")[0]
        if not rows_match(rows, want) or rows == host_rows["win"]:
            raise AssertionError("window after writes: rows disagree with the host engine, or the writes did not show")
        print(f"window win after writes ({pending} changed handles pending): merged first, path {st['path']}, "
              f"{wall:.3f} ms cold; equal to the host engine; {len(after[0])} rows")
        del roots[:]
        s.query(WINDOW_QUERIES[WINDOW_ROOT])  # rootwin's root window and its input, once more
        (wexec, chunk, n, _on_card), = roots
        costs = _window_costs(wexec, chunk, n, device)
    finally:
        gpu_engine.execute_region, executors.WindowExec._try_device = real_exec, real_try
    db.stop_background()
    return costs


def _window_costs(wexec, chunk, n: int, device: str, reps: int = 5) -> dict:
    """Both sides of ``window_kernel.device_beats_host`` at the root
    window's input: the host sweep (WindowExec with no session) and its
    sort; the device path whole (``_try_device``: lanes, upload, program,
    one download) and in parts: the upload of its lanes, the program at
    the padded size and at 1,024 rows, the download. → the constants they
    imply, the measured walls and the model's estimate of each side."""
    import torch

    from tidb_tpu_torch.copr import gpu_engine, host_engine
    from tidb_tpu_torch.executor.executors import WindowExec
    from tidb_tpu_torch.ops import window_kernel as wk

    p = wexec.plan
    nf = len(p.funcs)
    lanes_up = len(p.partition_by) + len(p.order_by)

    class _Given:
        def execute(self):
            return chunk

    def med_ms(fn, k=reps):
        out = []
        for _ in range(k):
            t0 = time.perf_counter()
            fn()
            if device == "cuda":
                torch.cuda.synchronize()
            out.append((time.perf_counter() - t0) * 1e3)
        return statistics.median(out)

    sweep = WindowExec(plan=p, child=_Given(), session=None)
    keys = [[e.to_pb(), False] for e in p.partition_by] + [[e.to_pb(), d] for e, d in p.order_by]
    host_ms = med_ms(sweep.execute, 3)
    sort_ms = med_ms(lambda: host_engine.sort_perm(chunk, keys), 3)
    captured = {}
    real_get = wk.get_window_fn

    def capturing_get(spec, n_pad, bounds=None):
        fn = real_get(spec, n_pad, bounds)

        def wrapped(*args):
            captured.update(spec=spec, n_pad=n_pad, bounds=bounds, fn=fn, args=args)
            return fn(*args)

        return wrapped

    wk.get_window_fn = capturing_get
    try:
        if wexec._try_device(chunk, n) is None:
            raise AssertionError("window costs: the root window did not take the card")
        dev_ms = med_ms(lambda: wexec._try_device(chunk, n))
    finally:
        wk.get_window_fn = real_get
    fn, args, n_pad = captured["fn"], captured["args"], captured["n_pad"]
    part, order, arg, _nv, dev = args
    lanes = [x for pair in part + order + arg for x in pair]
    host_lanes = [x.cpu().numpy() for x in lanes]
    up_bytes = sum(a.nbytes for a in host_lanes)
    up_ms = med_ms(lambda: [torch.from_numpy(a).to(dev) for a in host_lanes])
    prog_ms = med_ms(lambda: fn(*args))
    small = real_get(captured["spec"], 1024, captured["bounds"])
    cut = lambda pairs: tuple((d[:1024], v[:1024]) for d, v in pairs)  # noqa: E731
    small_ms = med_ms(lambda: small(cut(part), cut(order), cut(arg), min(n, 1024), dev))
    flat = fn(*args)
    rows = torch.stack([x.view(torch.int64) if x.is_floating_point() else x.to(torch.int64) for x in flat])[:, :n]
    down_bytes = rows.numel() * 8
    down_ms = med_ms(lambda: gpu_engine._d2h(rows))
    implied = {
        "DEV_FIXED_S": small_ms / 1e3,
        "H2D_NS_PER_BYTE": up_ms * 1e6 / up_bytes,
        "D2H_NS_PER_BYTE": down_ms * 1e6 / down_bytes,
        "DEV_ROW_NS_PER_FUNC": max(prog_ms - small_ms, 0.0) * 1e6 / (n * nf),
        "HOST_ROW_NS_PER_FUNC": max(host_ms - sort_ms, 0.0) * 1e6 / (n * nf),
        "HOST_SORT_ROW_NS": sort_ms * 1e6 / n,
    }
    model_dev = (wk.DEV_FIXED_S + n * (wk.H2D_NS_PER_BYTE * 9 * lanes_up + wk.D2H_NS_PER_BYTE * 16 * nf
                                       + wk.DEV_ROW_NS_PER_FUNC * nf) * 1e-9) * 1e3
    model_host = n * (wk.HOST_ROW_NS_PER_FUNC * nf + wk.HOST_SORT_ROW_NS) * 1e-6
    return {
        "rows": n, "n_pad": n_pad, "key_bits": _window_key_bits(captured["bounds"], n_pad), "funcs": nf, "lanes_up": lanes_up,
        "host_sweep_ms": host_ms, "host_sort_ms": sort_ms, "device_path_ms": dev_ms,
        "upload_ms": up_ms, "upload_bytes": up_bytes, "program_ms": prog_ms, "program_1024_ms": small_ms,
        "download_ms": down_ms, "download_bytes": down_bytes,
        "implied": implied, "model_device_ms": model_dev, "model_host_ms": model_host,
        "device_beats_host": wk.device_beats_host(n, lanes_up, nf),
    }


# -- MPP: the join fragments of TPC-H Q3 and Q17 over virtual shards ---------

SEGMENTS = [b"AUTOMOBILE", b"BUILDING", b"FURNITURE", b"HOUSEHOLD", b"MACHINERY"]
CONTAINERS = [
    f"{size} {kind}".encode()
    for size in ("SM", "LG", "MED", "JUMBO", "WRAP")
    for kind in ("CASE", "BOX", "BAG", "JAR", "PKG", "PACK", "CAN", "DRUM")
]
MPP_SCHEMA = (
    """CREATE TABLE lineitem (l_orderkey BIGINT, l_partkey BIGINT, l_quantity DECIMAL(12,2),
    l_extendedprice DECIMAL(12,2), l_discount DECIMAL(12,2), l_shipdate DATE)""",
    "CREATE TABLE orders (o_orderkey BIGINT PRIMARY KEY, o_custkey BIGINT, o_orderdate DATE, o_shippriority BIGINT)",
    "CREATE TABLE customer (c_custkey BIGINT PRIMARY KEY, c_mktsegment VARCHAR(10))",
    "CREATE TABLE part (p_partkey BIGINT PRIMARY KEY, p_brand VARCHAR(10), p_container VARCHAR(10))",
)
MPP_TABLES = ("lineitem", "orders", "customer", "part")
# bench.py's Q3 (BASELINE config 5, ``q3_join_mpp_ms``) over lineitem and
# orders; TPC-H Q3 with JOIN ... ON from lineitem (the comma form plans a
# cross join in both packages, and a chain from customer keeps the string
# filter between its joins, on the root); TPC-H Q17 (its correlated AVG
# runs as a device stage);
# a TopN over lineitem ⋈ orders whose extra order keys make every tie a
# duplicate row
MPP_QUERIES = {
    "q3": """SELECT o_orderdate, SUM(l_extendedprice) AS rev FROM lineitem, orders
  WHERE l_orderkey = o_orderkey GROUP BY o_orderdate ORDER BY rev DESC, o_orderdate LIMIT 10""",
    "q3full": """SELECT l_orderkey, SUM(l_extendedprice * (1 - l_discount)) AS revenue, o_orderdate, o_shippriority
  FROM lineitem JOIN orders ON l_orderkey = o_orderkey JOIN customer ON o_custkey = c_custkey
  WHERE c_mktsegment = 'BUILDING' AND o_orderdate < DATE '1995-03-15' AND l_shipdate > DATE '1995-03-15'
  GROUP BY l_orderkey, o_orderdate, o_shippriority ORDER BY revenue DESC, o_orderdate LIMIT 10""",
    "q17": """SELECT SUM(l_extendedprice) / 7.0 AS avg_yearly FROM lineitem JOIN part ON p_partkey = l_partkey
  WHERE p_brand = 'Brand#23' AND p_container = 'MED BOX'
    AND l_quantity < (SELECT 0.2 * AVG(l_quantity) FROM lineitem WHERE l_partkey = p_partkey)""",
    "topn": """SELECT l_extendedprice, l_orderkey, l_partkey, o_orderdate FROM lineitem
  JOIN orders ON l_orderkey = o_orderkey ORDER BY l_extendedprice DESC, l_orderkey, l_partkey LIMIT 20""",
}
# (fragments, stages) of each statement's PhysMPPGather, as the reference
# plans them (tests/test_torch_sql_mpp.py holds the port to the reference)
MPP_PLANS = {"q3": (3, 1), "q3full": (4, 1), "q17": (4, 2), "topn": (3, 1)}


def lineitem_partkey(seed: int, n: int = SF1_ROWS) -> np.ndarray:
    """``lineitem_sf1``'s part keys: its second draw, replayed (the columns
    it returns keep their values)."""
    rng = np.random.default_rng(seed)
    rng.integers(1, 51, n)
    return rng.integers(1, 200_001, n)


def mpp_tables(cols: dict, partkey: np.ndarray, seed: int, n_part: int = 200_000, n_cust: int = 150_000) -> dict:
    """{table: column arrays} of the MPP phase, TPC-H §4.2.3's widths:
    lineitem (l_orderkey, l_partkey, l_quantity, l_extendedprice,
    l_discount, l_shipdate) from ``cols`` and ``partkey``; orders, one per
    distinct l_orderkey, o_custkey uniform over the customer keys not
    divisible by 3 (the two thirds of 1..n_cust that have orders),
    o_orderdate uniform in [1992-01-01, 1998-08-02], drawn independently
    of lineitem's dates, o_shippriority 0; customer, c_mktsegment uniform
    over the five segments; part, p_brand 'Brand#MN' (M, N in 1..5) and
    p_container one of the 40. Strings are bytes; decimals scaled
    integers; dates days since 1970-01-01."""
    rng = np.random.default_rng([seed, 3])
    okeys = np.unique(cols[9])
    with_orders = np.arange(1, n_cust + 1)
    with_orders = with_orders[with_orders % 3 != 0]
    lo, hi = _days(dt.date(1992, 1, 1)), _days(dt.date(1998, 8, 2))
    brands = np.array([f"Brand#{m}{k}".encode() for m in range(1, 6) for k in range(1, 6)])
    return {
        "lineitem": [cols[9], partkey.astype(np.int64), cols[0], cols[1], cols[2], cols[6]],
        "orders": [
            okeys,
            with_orders[rng.integers(0, len(with_orders), len(okeys))].astype(np.int64),
            rng.integers(lo, hi + 1, len(okeys)).astype(np.int64),
            np.zeros(len(okeys), np.int64),
        ],
        "customer": [np.arange(1, n_cust + 1, dtype=np.int64), np.array(SEGMENTS)[rng.integers(0, 5, n_cust)]],
        "part": [
            np.arange(1, n_part + 1, dtype=np.int64),
            brands[rng.integers(0, len(brands), n_part)],
            np.array(CONTAINERS)[rng.integers(0, len(CONTAINERS), n_part)],
        ],
    }


def mpp_sql(db, bulk_load, tables: dict, db_name: str = "test"):
    """Create the four tables in database ``db_name`` of ``db`` (a handle
    opened with no automatic region split: one region each), bulk-load
    ``tables`` and ANALYZE them (the exchange choice reads the statistics).
    → (load s, analyze s)."""
    s = db.session()
    s.execute(f"CREATE DATABASE IF NOT EXISTS {db_name}")
    s.execute(f"USE {db_name}")
    for stmt in MPP_SCHEMA:
        s.execute(stmt)
    t0 = time.perf_counter()
    for name in MPP_TABLES:
        bulk_load(db, name, tables[name], db_name=db_name)
    t1 = time.perf_counter()
    for name in MPP_TABLES:
        s.execute(f"ANALYZE TABLE {name}")
    return t1 - t0, time.perf_counter() - t1


def _avg6(s: np.ndarray, n: np.ndarray) -> np.ndarray:
    """AVG of a DECIMAL(12,2) at scale 6 from its scaled sum and count,
    rounded half away from zero (counts > 0)."""
    num = s * 10**4
    return np.sign(num) * ((np.abs(num) + n // 2) // n)


def mpp_oracle(name: str, t: dict) -> list[tuple]:
    """``MPP_QUERIES[name]``'s rows from the generated tables, in numpy:
    every row of the statement without its LIMIT, in its ORDER BY order
    (``mpp_rows_match`` compares a LIMIT's rows against them)."""
    lok, lpk, lq, lp, ld, lship = t["lineitem"]
    ok, ocust, odate, oprio = t["orders"]
    oi = np.searchsorted(ok, lok)  # every line's order (one per distinct key)
    if name == "q3":
        keys, (rev,) = _by_key(odate[oi], (lp, np.add))
        order = np.lexsort((keys, -rev))
        return [(_date(keys[i]), _dec(rev[i], 2)) for i in order]
    if name == "q3full":
        seg = t["customer"][1]
        cutoff = _days(dt.date(1995, 3, 15))
        good = (seg[ocust - 1] == b"BUILDING") & (odate < cutoff)
        m = good[oi] & (lship > cutoff)
        keys, (rev,) = _by_key(lok[m], (lp[m] * (100 - ld[m]), np.add))
        kd = odate[np.searchsorted(ok, keys)]
        order = np.lexsort((kd, -rev))
        return [(int(keys[i]), _dec(rev[i], 4), _date(kd[i]), 0) for i in order]
    if name == "q17":
        _pk, brand, cont = t["part"]
        pkeys, (sq, cnt) = _by_key(lpk, (lq, np.add), (np.ones_like(lq), np.add))
        avg6 = np.zeros(len(brand) + 1, np.int64)
        avg6[pkeys] = _avg6(sq, cnt)
        chosen = (brand == b"Brand#23") & (cont == b"MED BOX")
        m = chosen[lpk - 1] & (lq * 10**5 < 2 * avg6[lpk])
        if not m.any():
            return [(None,)]
        total = int(lp[m].sum())  # at scale 2; over 7.0 at scale 6, half away from zero
        q = (abs(total) * 10**4 + 3) // 7
        return [(_dec(q if total >= 0 else -q, 6),)]
    if name == "topn":
        order = np.lexsort((lpk, lok, -lp))
        return [(_dec(lp[i], 2), int(lok[i]), int(lpk[i]), _date(odate[oi[i]])) for i in order[:100]]
    raise KeyError(name)


def mpp_rows_match(name: str, got: list, want: list, limit: int) -> bool:
    """``got`` is the statement's LIMIT: ``limit`` rows (fewer when ``want``
    has fewer), each a row of ``want``, whose ORDER BY keys equal the
    first ``limit`` of ``want``'s (ties at the cut may pick any of the
    tied rows)."""
    keys = {"q3": lambda r: r[1], "q3full": lambda r: (r[1], r[2]), "topn": lambda r: r[:3], "q17": lambda r: r}[name]
    k = min(limit, len(want))
    return len(got) == k and [keys(r) for r in got] == [keys(r) for r in want[:k]] and set(got) <= set(want)


MPP_LIMITS = {"q3": 10, "q3full": 10, "q17": 1, "topn": 20}


def _mpp_db(cols: dict, seed: int, device: str = "cuda"):
    """The MPP phases' database: ``tidb_tpu_torch.open`` over the tables of
    ``mpp_tables`` (SF1: lineitem 6,001,215 rows, orders ~1.5M, customer
    150,000, part 200,000; one region each, ANALYZEd), and each of
    ``MPP_QUERIES`` once with ``tidb_allow_mpp = 0`` (what the parent ran
    these statements on), which must equal the numpy oracle. → (db,
    tables, {name: (rows, ms)})."""
    import tidb_tpu_torch
    from tidb_tpu_torch.executor.load import bulk_load

    t0 = time.perf_counter()
    tables = mpp_tables(cols, lineitem_partkey(seed, len(cols[0])), seed)
    gen_s = time.perf_counter() - t0
    db = tidb_tpu_torch.open(region_split_keys=1 << 62, device=device)
    load_s, analyze_s = mpp_sql(db, bulk_load, tables)
    sizes = {name: len(tables[name][0]) for name in MPP_TABLES}
    print(f"mpp: tables {sizes} generated in {gen_s:.3f} s; bulk load {load_s:.3f} s; ANALYZE {analyze_s:.3f} s")
    s = db.session()
    s.execute("SET tidb_allow_mpp = 0")
    host = {}
    for name, sql in MPP_QUERIES.items():
        t0 = time.perf_counter()
        rows = s.query(sql)
        host[name] = (rows, (time.perf_counter() - t0) * 1e3)
        if not mpp_rows_match(name, rows, mpp_oracle(name, tables), MPP_LIMITS[name]):
            raise AssertionError(f"mpp {name}: tidb_allow_mpp = 0 disagrees with the oracle: {rows[:3]}")
    return db, tables, host


def _mpp_layout(db, tables: dict, host: dict, label: str, devices, ndev, reps: int = 5,
                profile: bool = True, workers: bool = False) -> dict:
    """``MPP_QUERIES`` on ``db`` over one mesh layout (``parallel.mesh``'s
    ``FORCE_DEVICES = devices``, ``FORCE_NDEV = ndev``), each once cold and
    ``reps`` times warm. Every run must equal the numpy oracle (decimals
    exact) and the ``tidb_allow_mpp = 0`` rows, plan one ``PhysMPPGather``
    with ``MPP_PLANS``' fragments and stages at the layout's width with no
    retry, and emit no MPP fallback event. Prints per statement the plan's
    exchanges, the cold wall, the warm median, the gather's wall, per-shard
    rows and exchanged bytes, ``stage_bytes`` and, with ``profile``, one
    profiled run's device busy time and top ops; with ``workers``, per
    worker its shards' rows and stream wall, the bytes it handed to the
    other workers in one run and each card's peak memory. → {name: warm
    median ms}."""
    import torch

    from tidb_tpu_torch.copr.gpu_engine import store_device
    from tidb_tpu_torch.parallel import mesh
    from tidb_tpu_torch.utils import eventlog

    on_card = store_device(db.store).type == "cuda"
    mesh.FORCE_DEVICES, mesh.FORCE_NDEV = devices, ndev
    med_by = {}
    try:
        m = mesh.make_mesh(devices=mesh.available_devices(db.store.device))
        width = int(m.devices.size)
        cards = sorted({h.device.index for h, _f, _k in m.workers}) if on_card else []
        print(f"mpp layout {label}: {width} shards, workers (device, first shard, shards) "
              f"{[(h.name, f, k) for h, f, k in m.workers]}")
        for name, sql in MPP_QUERIES.items():
            want = mpp_oracle(name, tables)
            host_rows, host_ms = host[name]
            s = db.session()
            plan = "\n".join(r[0] for r in s.query("EXPLAIN " + sql))
            head = next((ln.strip() for ln in plan.splitlines() if "PhysMPPGather" in ln), None)
            if head is None:
                raise AssertionError(f"mpp {name} {label}: no PhysMPPGather:\n{plan}")
            since = time.time()

            def run():
                t = time.perf_counter()
                rows = s.query(sql)
                wall = (time.perf_counter() - t) * 1e3
                det = s.mpp_details[-1] if s.mpp_details else None
                got = None if det is None else (det.n_fragments, det.stages, det.ndev, det.retries)
                if got != (*MPP_PLANS[name], width, 0):
                    raise AssertionError(f"mpp {name} {label}: gather (fragments, stages, ndev, retries) {got}")
                if not mpp_rows_match(name, rows, want, MPP_LIMITS[name]) or rows != host_rows:
                    raise AssertionError(f"mpp {name} {label}: rows disagree with the oracle or the "
                                         f"tidb_allow_mpp = 0 path: {rows[:3]} against {host_rows[:3]}")
                return wall, det

            cold, cold_det = run()
            for c in cards:
                torch.cuda.reset_peak_memory_stats(c)
            runs = [run() for _ in range(reps)]
            walls = [w for w, _d in runs]
            det = runs[-1][1]
            kernels = _profile_device(run) if profile else []
            busy = sum(k[1] for k in kernels) if kernels else None
            events = [ev[3] for ev in eventlog.get().search(since=since, component="mpp")]
            if "host_join_fallback" in events:
                raise AssertionError(f"mpp {name} {label}: the gather fell back to the host join: {events}")
            med = med_by[name] = statistics.median(walls)
            print(f"mpp {name} {label}: {head}; cold_ms {cold:.3f}; warm sql_ms median {med:.3f} "
                  f"min {min(walls):.3f}; gather wall_ms {det.wall_ms:.3f}; tidb_allow_mpp=0 ms {host_ms:.3f} "
                  f"({host_ms / med:.2f}x); shards [id, ms, rows, exchanged bytes] {det.shards}; "
                  f"stage_bytes {det.stage_bytes}; programs built cold {cold_det.compiles} warm {det.compiles}"
                  + (f"; profiled device_busy_ms {_ms(busy)}" if profile else "")
                  + ("" if busy is None else f" (idle share {max(0.0, 1 - busy / med):.3f})") + f"; rows {len(want)}")
            for k, ms, calls in kernels[:4]:
                print(f"    top op {ms:.3f} ms x{calls}: {k[:110]}")
            if workers:
                moved = list(m.moved)
                run()
                sent = [a - b for a, b in zip(m.moved, moved)]
                by_shard = {sh[0]: sh for sh in det.shards}
                per = [{"device": h.name, "shards": k, "rows": sum(by_shard[i][2] for i in range(f, f + k)),
                        "wall_ms": by_shard[f][1], "sent_bytes": sent[w]}
                       for w, (h, f, k) in enumerate(m.workers)]
                peak = {f"cuda:{c}": round(torch.cuda.max_memory_allocated(c) / 2**30, 3) for c in cards}
                print(f"    workers {json.dumps(per)}; peak GiB per card {peak}")
            if on_card:
                torch.cuda.synchronize()
    finally:
        mesh.FORCE_DEVICES = mesh.FORCE_NDEV = None
    return med_by


def _mpp_phase(cols: dict, seed: int, gs, reps: int = 5, device: str = "cuda"):
    """Phase 9: ``MPP_QUERIES`` over ``_mpp_db`` at 1 and 4 virtual shards
    on the store's card (``FORCE_DEVICES`` its one handle, whatever the
    machine holds), ``_mpp_layout``'s checks and prints. K1 must not
    launch. → (K1's launches, the database, the tables, the host rows,
    the 4-shard warm medians)."""
    from tidb_tpu_torch.copr.gpu_engine import store_device
    from tidb_tpu_torch.parallel import mesh

    db, tables, host = _mpp_db(cols, seed, device)
    k1_before = gs.LAUNCHES
    one = [mesh.handle(store_device(db.store))]
    try:
        _mpp_layout(db, tables, host, "ndev 1", one, 1, reps)
        virtual = _mpp_layout(db, tables, host, "ndev 4", one, 4, reps)
    except BaseException:
        db.stop_background()
        raise
    launches = gs.LAUNCHES - k1_before
    if launches:
        raise AssertionError(f"mpp: K1 launched {launches} times on the MPP path")
    return launches, db, tables, host, virtual


def _mpp_only(seed: int, gs) -> int:
    """``chip_smoke.py --mpp-only``: phase 9 and phase 15 alone, over the
    same SF1 tables, then the scaling lanes (what a machine with several
    cards is asked for)."""
    t0 = time.perf_counter()
    cols = lineitem_sf1(seed)
    gs.LAUNCHES = 0
    _launches, db, tables, host, virtual = _mpp_phase(cols, seed, gs)
    print(f"MPP phase: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    try:
        _mpp_devices_phase(db, tables, host, virtual, gs)
    finally:
        db.stop_background()
    print(f"phase 15: {time.perf_counter() - t0:.1f} s")
    breached = _scaling_lanes()
    if breached:
        print(f"mpp-only: phases 9 and 15 passed; the scaling gate breached in {', '.join(breached)}")
        return 1
    print("mpp-only: every check passed")
    return 0


SCALING_LANES = ("scaling_q1_rows_per_s_per_chip", "scaling_q3_rows_per_s_per_chip", "scaling_q17_rows_per_s_per_chip")


def _scaling_lanes(device: str = "cuda") -> list:
    """benchdaily's three scaling lanes in this process on ``device``: with
    several cards one shard per card up to the card count under the
    per-chip gate (rows/s/chip ≥ 0.5 × one card's), with one card virtual
    shards under the total gate. Prints each lane's rows/s and rows/s/chip
    per width and its gate's verdict. → the lanes whose gate breached."""
    from tidb_tpu_torch.bench import benchdaily

    old, benchdaily.DEVICE = benchdaily.DEVICE, device
    breached = []
    try:
        for name in SCALING_LANES:
            t0 = time.perf_counter()
            try:
                verdict = f"gate held, {benchdaily._BENCHES[name]():,.0f} rows/s/chip at the widest"
            except RuntimeError as e:
                verdict = f"gate breached: {e}"
                breached.append(name)
            curve = benchdaily.SCALING_CURVES.get(name.replace("_rows_per_s_per_chip", ""), {})
            per_width = {d: [round(r), round(r / d)] for d, r in curve.get("rows_per_s", {}).items()}
            print(f"scaling {name}: {curve.get('cards')} cards, {curve.get('gate')} gate; rows/s and rows/s/chip "
                  f"by width {json.dumps(per_width)}; {verdict} ({time.perf_counter() - t0:.1f} s)")
    finally:
        benchdaily.DEVICE = old
    return breached


def _mpp_devices_phase(db, tables: dict, host: dict, virtual: dict, gs, reps: int = 5) -> int:
    """Phase 15, MPP over every card: phase 9's statements and checks on
    its database over a mesh of several workers — four logical devices on
    the store's card (four workers with their own streams, the exchanges
    between them carried by the rendezvous) and, with two cards or more,
    one shard per card (peer copies). Prints the card count, peer access
    between each pair of cards, the layouts, per statement the cold wall
    and warm median of ``reps`` beside phase 9's 4-virtual-shard median,
    and per worker its rows, stream wall, bytes handed to the others and
    each card's peak memory. K1 must not launch. → K1's launches."""
    import torch

    from tidb_tpu_torch.copr.gpu_engine import store_device
    from tidb_tpu_torch.parallel import mesh

    dev = store_device(db.store)
    n_cards = torch.cuda.device_count() if dev.type == "cuda" else 0
    print(f"mpp15: {n_cards} cards")
    if n_cards:
        for line in subprocess.run(
            ["nvidia-smi", "--query-gpu=index,name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, check=True, timeout=60,
        ).stdout.strip().splitlines():
            print(f"mpp15: card {line}")
    peers = {f"{i}->{j}": torch.cuda.can_device_access_peer(i, j)
             for i in range(n_cards) for j in range(n_cards) if i != j}
    print(f"mpp15: peer access {peers}")
    layouts = [("4 logical", mesh.logical_devices(dev, 4), None)]
    if n_cards >= 2:
        layouts.append((f"{n_cards} cards", None, None))  # the store's default: one shard per card
    k1_before = gs.LAUNCHES
    for label, devices, ndev in layouts:
        med = _mpp_layout(db, tables, host, label, devices, ndev, reps, profile=False, workers=True)
        print(f"mpp15 {label}: warm medians against phase 9's 4 virtual shards "
              + json.dumps({name: [round(med[name], 3), round(virtual[name], 3), round(med[name] / virtual[name], 3)]
                            for name in med}))
    launches = gs.LAUNCHES - k1_before
    if launches:
        raise AssertionError(f"mpp15: K1 launched {launches} times on the MPP path")
    return launches


# -- the process topology: a store process that owns the card, SQL layers over it

REMOTE_MPP = ("q3", "q17")  # MPP_QUERIES run through the store process


def wire_text(row) -> tuple:
    """A row as the MySQL text protocol carries it: NULL as None, dates in
    ISO form, integers and decimals as their text."""
    return tuple(None if v is None else v.decode() if isinstance(v, bytes) else v.isoformat()
                 if hasattr(v, "isoformat") else str(v) for v in row)


def _store_child(seed: int, n: int, device: str) -> int:
    """The remote phase's store process (``chip_smoke.py --store-child``):
    ``lineitem_sf1(seed, n)`` loaded through ``tidb_tpu_torch.open(device=
    device)`` as the SQL phase loads it (two regions), and the MPP phase's
    four tables in database ``mpp`` (one region each, ANALYZEd), served by
    a ``StoreServer`` that also answers ``smoke_counts`` (K1's launches in
    this process, zeroed on request, and the card's peak memory). Prints
    ``ready port=N ...`` once listening; on SIGTERM prints one JSON line
    (K1 launches, peak memory) and exits 0."""
    import signal
    import threading

    import torch

    import tidb_tpu_torch
    from tidb_tpu_torch.executor.load import bulk_load
    from tidb_tpu_torch.kv.remote import StoreServer
    from tidb_tpu_torch.kv.tablecodec import record_key
    from tidb_tpu_torch.ops import grouped_sums as gs

    stop = threading.Event()
    signal.signal(signal.SIGTERM, lambda *_: stop.set())
    on_card = device != "cpu"

    def peak() -> int:
        return torch.cuda.max_memory_allocated() if on_card and torch.cuda.is_initialized() else 0

    class CountingStoreServer(StoreServer):
        def _dispatch(self, h, blobs):
            if h["cmd"] != "smoke_counts":
                return super()._dispatch(h, blobs)
            out = {"k1": gs.LAUNCHES, "peak_bytes": peak()}
            if h.get("reset"):
                gs.LAUNCHES = 0
            return out, []

    t0 = time.perf_counter()
    cols = lineitem_sf1(seed, n)
    db = tidb_tpu_torch.open(region_split_keys=1 << 62, device=device)
    load_s = lineitem_sql(db, bulk_load, record_key, cols, parts=2)
    tables = mpp_tables(cols, lineitem_partkey(seed, n), seed)
    mpp_load_s, analyze_s = mpp_sql(db, bulk_load, tables, db_name="mpp")
    del cols, tables
    srv = CountingStoreServer(db.store)
    port = srv.start()
    print(f"ready port={port} rows={n} lineitem_load_s={load_s:.3f} mpp_load_s={mpp_load_s:.3f} "
          f"analyze_s={analyze_s:.3f} store_setup_s={time.perf_counter() - t0:.3f}", flush=True)
    stop.wait()
    print(json.dumps({"store": {"k1_launches": gs.LAUNCHES, "peak_bytes": peak()}}), flush=True)
    srv.shutdown()
    db.stop_background()
    return 0


def _store_counts(port: int, reset: bool = False) -> dict:
    """The store child's ``smoke_counts`` over one framed connection."""
    import socket

    from tidb_tpu_torch.kv.remote import _recv_frame, _send_frame

    with socket.create_connection(("127.0.0.1", port), timeout=60) as sock:
        _send_frame(sock, {"cmd": "smoke_counts", "reset": int(reset)})
        h, _blobs = _recv_frame(sock)
    if "err" in h:
        raise AssertionError(f"store child: {h}")
    return h


def _ready(proc, what: str, timeout: float = 900.0) -> dict:
    """The ``ready key=value ...`` line a booted process prints first."""
    import threading

    got = []
    t = threading.Thread(target=lambda: got.append(proc.stdout.readline()), daemon=True)
    t.start()
    t.join(timeout)
    line = got[0] if got else ""
    if not line.startswith("ready"):
        proc.kill()
        raise AssertionError(f"{what} did not report ready (rc {proc.poll()}): {line!r}")
    return {k: (int(v) if v.isdigit() else float(v)) for k, v in (kv.split("=") for kv in line.split()[1:])}


def _sigterm(proc, what: str) -> str:
    """SIGTERM, wait, require rc 0 → what the process printed after."""
    import signal

    proc.send_signal(signal.SIGTERM)
    try:
        out, _ = proc.communicate(timeout=60)
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.communicate()
        raise AssertionError(f"{what} did not exit within 60 s of SIGTERM")
    if proc.returncode != 0:
        raise AssertionError(f"{what} exited {proc.returncode} on SIGTERM")
    return out or ""


def _compute_apps() -> list:
    """[(pid, used memory)] of the processes holding a CUDA context on the
    card, as nvidia-smi lists them."""
    out = subprocess.run(["nvidia-smi", "--query-compute-apps=pid,used_memory", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60).stdout
    return [tuple(x.strip() for x in ln.split(",")) for ln in out.strip().splitlines() if ln.strip()]


def _nvidia_files(pid: int) -> set:
    """The NVIDIA device files process ``pid`` has open (none until it
    first calls into the CUDA driver)."""
    fd_dir = f"/proc/{pid}/fd"
    out = set()
    for fd in os.listdir(fd_dir):
        try:
            target = os.readlink(os.path.join(fd_dir, fd))
        except OSError:
            continue
        if target.startswith("/dev/nvidia"):
            out.add(target)
    return out


def _context_check(sql_pid: int, store_pid: int) -> str:
    """The SQL-layer process never called into the CUDA driver (it has no
    NVIDIA device file open) and the store process holds the card; in
    nvidia-smi's compute-apps list the SQL layer's pid is absent and the
    store's present, or, where nvidia-smi cannot see this sandbox's
    process ids, the list holds exactly two processes: this one and the
    store. → the line that says what was seen."""
    apps = _compute_apps()
    pids = {int(p) for p, _m in apps if p.isdigit()}
    files = {"sql": sorted(_nvidia_files(sql_pid)), "store": sorted(_nvidia_files(store_pid))}
    if files["sql"] or not any(re.fullmatch(r"/dev/nvidia\d+", f) for f in files["store"]):
        raise AssertionError(f"NVIDIA device files open: {files} (the store must hold the card, the SQL layer nothing)")
    if store_pid in pids:
        if sql_pid in pids:
            raise AssertionError(f"nvidia-smi compute apps {apps}: the SQL layer {sql_pid} holds a context")
        how = "the SQL layer's pid absent, the store's present"
    elif len(apps) != 2:
        raise AssertionError(f"nvidia-smi compute apps {apps}: expected this process and the store only")
    else:
        how = "pids not this sandbox's; two contexts: this process and the store"
    return (f"nvidia-smi compute apps {apps} ({how}); device files: SQL layer {sql_pid} {files['sql']}, "
            f"store {store_pid} {files['store']}")


def _remote_phase(cols: dict, seed: int, gs, reps: int = 5, device: str = "cuda") -> int:
    """bench.py's remote topology on the card: a store child process
    (``_store_child``) owns the card and holds SF1 (lineitem as two regions
    and the MPP tables in database ``mpp``); a SQL layer booted as ``python
    -m tidb_tpu_torch --store remote`` answers a MySQL client, and a second
    SQL layer in this process (``tidb_tpu_torch.open(remote=...)``) reports
    cop-task walls, wire time and MPP details. ``SQL_QUERIES`` and the MPP
    phase's ``q3`` and ``q17`` run through both, once cold and ``reps``
    times warm. Every result must equal the numpy oracle (the wire's in
    text), every cop task run on the store's ``gpu`` engine undegraded,
    EXPLAIN show ``[gpu]`` readers and one ``PhysMPPGather`` for q3/q17,
    the gather report no retry and log no fallback, K1 launch exactly 2
    times per band statement in the store and never in this process, and
    the SQL-layer process hold no CUDA context while the store holds one.
    Prints per statement the warm medians over the wire and in process,
    the longest cop task, the wire tax (in-process wall minus the longest
    cop task) and the tasks' wire time. → K1's launches in the store."""
    import statistics as st

    import tidb_tpu_torch
    from tidb_tpu_torch.server import Client
    from tidb_tpu_torch.utils import eventlog

    here = os.path.dirname(os.path.abspath(__file__))
    n = len(cols[0])
    t_phase = time.perf_counter()
    store = subprocess.Popen([sys.executable, os.path.abspath(__file__), "--store-child", "--seed", str(seed),
                              "--rows", str(n), "--device", device],
                             stdout=subprocess.PIPE, text=True, cwd=here)
    sql = None
    db = None
    try:
        info = _ready(store, "the store child")
        port = info["port"]
        print(f"remote: store child pid {store.pid}: {info}")
        dev_flag = [] if device == "cuda" else ["--device", device]
        sql = subprocess.Popen([sys.executable, "-m", "tidb_tpu_torch", "--store", "remote", "--path",
                                f"127.0.0.1:{port}", "--port", "0", "--no-status", *dev_flag],
                               stdout=subprocess.PIPE, text=True, cwd=here)
        wire_port = _ready(sql, "the SQL-layer process", timeout=300)["port"]
        db = tidb_tpu_torch.open(remote=f"127.0.0.1:{port}", device=device)
        for name in MPP_TABLES:  # the persisted statistics, read now (a SQL layer loads them lazily)
            db.stats.load_sync(db.catalog.table("mpp", name).id)
        wire = {"test": Client("127.0.0.1", wire_port), "mpp": Client("127.0.0.1", wire_port, db="mpp")}
        want = {name: sql_oracle(name, cols) for name in SQL_QUERIES}
        mtables = mpp_tables(cols, lineitem_partkey(seed, n), seed)
        want.update({name: mpp_oracle(name, mtables) for name in REMOTE_MPP})
        del mtables
        k1_here = gs.LAUNCHES
        _store_counts(port, reset=True)  # the remote path: the store's count from 0 just before it
        since = time.time()
        launches = {}
        for name in (*SQL_QUERIES, *REMOTE_MPP):
            is_mpp = name in REMOTE_MPP
            text = MPP_QUERIES[name] if is_mpp else SQL_QUERIES[name]
            s = db.session()
            c = wire["mpp" if is_mpp else "test"]
            if is_mpp:
                s.execute("USE mpp")
            plan = "\n".join(r[0] for r in s.query("EXPLAIN " + text))
            for _ in range(40):  # the wire's SQL layer loads the statistics on its first plan, in the background
                wplan = "\n".join(r[0] for r in c.query("EXPLAIN " + text))
                if wplan == plan:
                    break
                time.sleep(0.5)
            if wplan != plan or "[gpu]" not in plan or "[host]" in plan or plan.count("PhysMPPGather") != int(is_mpp):
                raise AssertionError(f"remote {name}: plans over the wire and in process:\n{wplan}\n{plan}")
            before = _store_counts(port)["k1"]

            def run_here():
                t = time.perf_counter()
                rows = s.query(text)
                wall = (time.perf_counter() - t) * 1e3
                if is_mpp:
                    det = s.mpp_details[-1] if s.mpp_details else None
                    got = None if det is None else (det.n_fragments, det.stages, det.ndev, det.retries)
                    if got != (*MPP_PLANS[name], 1, 0):
                        raise AssertionError(f"remote {name}: gather (fragments, stages, ndev, retries) {got}")
                    if not mpp_rows_match(name, rows, want[name], MPP_LIMITS[name]):
                        raise AssertionError(f"remote {name}: rows disagree with the oracle: {rows[:3]}")
                    return wall, rows, (det.wall_ms, None, None)
                summ = s.exec_summary
                if summ is None or summ.engines != {"gpu": 2} or summ.degraded:
                    raise AssertionError(f"remote {name}: cop tasks {summ and summ.engines}, degraded {summ and summ.degraded}")
                if sql_rows(name, rows) != want[name]:
                    raise AssertionError(f"remote {name}: rows disagree with the numpy oracle")
                return wall, rows, (max(summ.procs), summ.wire_ms, summ.device_ms)

            def run_wire(rows_here):
                t = time.perf_counter()
                rows = c.query(text)
                wall = (time.perf_counter() - t) * 1e3
                if sorted(rows, key=repr) != sorted((wire_text(r) for r in rows_here), key=repr):
                    raise AssertionError(f"remote {name}: the wire's rows disagree with the in-process layer's")
                return wall

            cold_here, rows_here, _ = run_here()
            cold_wire = run_wire(rows_here)
            here_runs = [run_here() for _ in range(reps)]
            wire_walls = [run_wire(rows_here) for _ in range(reps)]
            launches[name] = _store_counts(port)["k1"] - before
            runs = 2 * (1 + reps)
            per_band = 0 if device == "cpu" else 2  # the plain version (the CPU's) counts no launch
            if launches[name] != (per_band * runs if name == "band" else 0):
                raise AssertionError(f"remote {name}: K1 launched {launches[name]} times in the store over {runs} "
                                     "statements (2 per band statement, 0 otherwise)")
            walls = [w for w, _r, _t in here_runs]
            longest = [t[0] for _w, _r, t in here_runs]
            tax = [w - t for w, t in zip(walls, longest)]
            extra = "" if is_mpp else (f"; cop tasks' wire_ms median {st.median(t[1] for _w, _r, t in here_runs):.3f}; "
                                       f"device_ms median {st.median(t[2] for _w, _r, t in here_runs):.3f}")
            print(f"remote {name}: cold_ms wire {cold_wire:.3f} in-process {cold_here:.3f}; warm median wire "
                  f"{st.median(wire_walls):.3f} (min {min(wire_walls):.3f}) in-process {st.median(walls):.3f} "
                  f"(min {min(walls):.3f}); {'gather wall_ms' if is_mpp else 'longest cop task ms'} median "
                  f"{st.median(longest):.3f}; wire tax ms median {st.median(tax):.3f}{extra}; "
                  f"K1 launches in the store {launches[name]}; rows {len(rows_here)}")
        events = [ev[3] for ev in eventlog.get().search(since=since, component="mpp")]
        if "host_join_fallback" in events:
            raise AssertionError(f"remote: an MPP gather fell back to the host join: {events}")
        if gs.LAUNCHES != k1_here:
            raise AssertionError(f"remote: K1 launched {gs.LAUNCHES - k1_here} times in this SQL-layer process")
        counts = _store_counts(port)
        if device != "cpu":
            print(f"remote: {_context_check(sql.pid, store.pid)}")
        for c in wire.values():
            c.close()
        _sigterm(sql, "the SQL-layer process")
        sql = None
        tail = [json.loads(ln) for ln in _sigterm(store, "the store child").splitlines() if ln.startswith("{")]
        store = None
        print(f"remote: K1 launches in the store {counts['k1']} ({launches}); store peak memory "
              f"{counts['peak_bytes'] / 2**30:.3f} GiB; at exit {tail}; K1 in this process 0; phase "
              f"{time.perf_counter() - t_phase:.1f} s")
        return counts["k1"]
    finally:
        if db is not None:
            db.stop_background()
        for proc in (sql, store):
            if proc is not None and proc.poll() is None:
                proc.kill()
                proc.wait()


def _boot_check(device: str = "cuda") -> None:
    """``python -m tidb_tpu_torch --store-server`` and ``python -m
    tidb_tpu_torch --store remote`` (with a status port) at a small size:
    CREATE, INSERT, a grouped SELECT over the wire equal to the embedded
    port's answer, ``/status``; SIGTERM gives rc 0 for both."""
    import urllib.request

    import tidb_tpu_torch
    from tidb_tpu_torch.server import Client

    here = os.path.dirname(os.path.abspath(__file__))
    dev_flag = [] if device == "cuda" else ["--device", device]
    stmts = ["CREATE TABLE bootc (a BIGINT PRIMARY KEY, g BIGINT, v DECIMAL(10,2))",
             "INSERT INTO bootc VALUES " + ", ".join(f"({i}, {i % 7}, {i}.{i % 100:02d})" for i in range(1, 2001))]
    query = "SELECT g, COUNT(*), SUM(v) FROM bootc GROUP BY g ORDER BY g"
    store = subprocess.Popen([sys.executable, "-m", "tidb_tpu_torch", "--store-server", "--port", "0", *dev_flag],
                             stdout=subprocess.PIPE, text=True, cwd=here)
    sql = None
    try:
        sport = _ready(store, "the --store-server process", timeout=300)["port"]
        sql = subprocess.Popen([sys.executable, "-m", "tidb_tpu_torch", "--store", "remote", "--path",
                                f"127.0.0.1:{sport}", "--port", "0", "--status-port", "0", *dev_flag],
                               stdout=subprocess.PIPE, text=True, cwd=here)
        ports = _ready(sql, "the SQL-layer process", timeout=300)
        c = Client("127.0.0.1", ports["port"])
        for stmt in stmts:
            c.query(stmt)
        got = c.query(query)
        c.close()
        with urllib.request.urlopen(f"http://127.0.0.1:{ports['status']}/status", timeout=30) as r:
            status = r.read()
        if b"tidb-tpu" not in status:
            raise AssertionError(f"boot: /status answered {status[:200]!r}")
        _sigterm(sql, "the SQL-layer process")
        sql = None
        _sigterm(store, "the --store-server process")
        store = None
    finally:
        for proc in (sql, store):
            if proc is not None and proc.poll() is None:
                proc.kill()
                proc.wait()
    db = tidb_tpu_torch.open(device=device)
    for stmt in stmts:
        db.execute(stmt)
    want = [wire_text(r) for r in db.query(query)]
    db.stop_background()
    if got != want:
        raise AssertionError(f"boot: the grouped SELECT over the wire {got} disagrees with the embedded {want}")
    print(f"boot: --store-server and --store remote answered {len(got)} groups equal to the embedded port; "
          f"/status {status[:80]!r}; both exited 0 on SIGTERM")


PARTITIONS = 4


def partition_bounds(orderkey: np.ndarray, parts: int = PARTITIONS) -> list[int]:
    """RANGE bounds at the quantiles of the generated order keys: partition
    ``i`` holds the keys below bound ``i`` (the last one: MAXVALUE), about
    ``n / parts`` rows each."""
    keys = np.sort(orderkey)
    return [int(keys[len(keys) * i // parts]) for i in range(1, parts)]


def partitioned_schema(bounds: list[int]) -> str:
    """``SQL_SCHEMA`` RANGE-partitioned on ``l_orderkey`` at ``bounds``."""
    defs = [f"PARTITION p{i} VALUES LESS THAN ({b})" for i, b in enumerate(bounds)]
    defs.append(f"PARTITION p{len(bounds)} VALUES LESS THAN MAXVALUE")
    return f"{SQL_SCHEMA}\nPARTITION BY RANGE (l_orderkey) ({', '.join(defs)})"


def partition_statements(bounds: list[int]) -> dict:
    """The statements that name partitions: Q6 pruned to p0 by its order
    key, and the band query over ``PARTITION (p1, p2)``. → {name: (sql,
    oracle statement, the rows' order-key interval, tasks)}."""
    return {
        "q6pruned": (f"{SQL_QUERIES['q6']} AND l_orderkey < {bounds[0]}", "q6", (None, bounds[0]), 1),
        "bandp12": (SQL_QUERIES["band"].replace("FROM lineitem", "FROM lineitem PARTITION (p1, p2)"), "band",
                    (bounds[0], bounds[2]), 2),
    }


def rows_between(cols: dict, lo, hi) -> dict:
    """The lineitem rows whose order key lies in ``[lo, hi)`` (``None``: no
    bound on that side)."""
    keep = np.ones(len(cols[9]), bool)
    if lo is not None:
        keep &= cols[9] >= lo
    if hi is not None:
        keep &= cols[9] < hi
    return cols if keep.all() else {k: v[keep] for k, v in cols.items()}


def _partition_phase(cols: dict, gs, sql_warm: dict, reps: int = 10, device: str = "cuda") -> tuple:
    """TiDB's RANGE partitioning of a fact table on an integer key: ``cols``
    loaded through ``bulk_load`` (which routes each row to its partition's
    physical table) into lineitem ``PARTITION BY RANGE (l_orderkey)``, four
    partitions at the quartiles of the order keys, one cop task each.
    ``SQL_QUERIES`` run once cold and ``reps`` times warm: each equal to the
    numpy oracle with four ``gpu`` tasks and none degraded, K1 launching 4
    times per band statement (one per partition task) and never during Q1.
    Then ``partition_statements``: Q6 pruned to one partition (one task)
    and the band query over two named partitions (two tasks, two K1
    launches), each equal to the oracle over its rows. K1 is held against
    its plain version on the inputs the band statement gave it. Prints the
    load time, and per statement the cold wall, the warm median beside the
    two-region SQL phase's (``sql_warm``), the task count, the summed and
    longest cop-task walls and one profiled run's device busy time (a
    twelfth run). → (K1 launches on the path, K1's largest error on its
    inputs, K1's timings at one partition's input)."""
    import tidb_tpu_torch
    from tidb_tpu_torch.executor.load import bulk_load
    from tidb_tpu_torch.kv.tablecodec import record_key
    from tidb_tpu_torch.ops import dag_kernel

    bounds = partition_bounds(cols[9])
    db = tidb_tpu_torch.open(region_split_keys=1 << 62, device=device)
    load_s = lineitem_sql(db, bulk_load, record_key, cols, parts=1, schema=partitioned_schema(bounds))
    sizes = np.bincount(np.searchsorted(np.array(bounds), cols[9], side="right"), minlength=PARTITIONS)
    print(f"partition: bulk load {load_s:.3f} s, {len(cols[0])} rows into {PARTITIONS} RANGE partitions of "
          f"l_orderkey below {bounds} / MAXVALUE, rows {sizes.tolist()}")
    s = db.session()
    stmts = {name: (sql, name, (None, None), PARTITIONS) for name, sql in SQL_QUERIES.items()}
    stmts.update(partition_statements(bounds))
    want = {name: sql_oracle(oname, rows_between(cols, *iv)) for name, (_sql, oname, iv, _t) in stmts.items()}
    k1_want = {"band": PARTITIONS, "bandp12": 2, "q1": 0, "q6pruned": 0}  # one launch per band task

    def run(name):
        sql, oname, _iv, tasks = stmts[name]
        before = gs.LAUNCHES
        t0 = time.perf_counter()
        rows = s.query(sql)
        wall = (time.perf_counter() - t0) * 1e3
        summ = s.exec_summary
        if summ is None or summ.engines != {"gpu": tasks} or summ.degraded:
            raise AssertionError(f"partition {name}: cop tasks {summ and summ.engines}, degraded "
                                 f"{summ and summ.degraded}, want {{'gpu': {tasks}}}")
        if sql_rows(oname, rows) != want[name]:
            raise AssertionError(f"partition {name}: rows disagree with the numpy oracle")
        if name in k1_want and gs.LAUNCHES - before != k1_want[name]:
            raise AssertionError(f"partition {name}: K1 launched {gs.LAUNCHES - before} times, want {k1_want[name]}")
        return wall, summ.procs

    inputs = []
    real_k1 = dag_kernel.grouped_sums

    def recording_k1(seg, pairs, B, n_pad, bounds=None, device="cuda"):
        inputs.append((seg, pairs, B, n_pad, bounds))
        return real_k1(seg, pairs, B, n_pad, bounds, device=device)

    cold = {}
    dag_kernel.grouped_sums = recording_k1
    try:
        for name in stmts:
            cold[name] = run(name)
    finally:
        dag_kernel.grouped_sums = real_k1
    for name in stmts:
        runs = [run(name) for _ in range(reps)]
        walls = [w for w, _p in runs]
        cop_sum = [sum(p) for _w, p in runs]
        cop_max = [max(p) for _w, p in runs]
        cw, cp = cold[name]
        beside = f" (two-region SQL phase {sql_warm[name]:.3f})" if name in sql_warm else ""
        print(f"partition {name}: tasks {stmts[name][3]}; cold_ms {cw:.3f} (cop tasks {[round(p, 3) for p in cp]}); "
              f"warm sql_ms median {statistics.median(walls):.3f}{beside} min {min(walls):.3f}; "
              f"cop_task_sum_ms median {statistics.median(cop_sum):.3f}; cop_task_max_ms median "
              f"{statistics.median(cop_max):.3f}; {_busy(lambda: run(name), statistics.median(walls))}; "
              f"rows {len(want[name])}")
    launches = gs.LAUNCHES
    err = max(_k1_err(*inp) for inp in inputs)
    seg, pairs, B, n_pad, kb = inputs[0]
    k1 = _k1_timings(seg, pairs, B, n_pad, kb)
    print(f"partition: K1 equal to its plain version on the {len(inputs)} inputs of the cold drive; at p0's "
          f"band input n_pad={n_pad} B={B} L={len(pairs)}: {json.dumps(k1)}")
    db.stop_background()
    return launches, err, k1


FUZZ_SEED = 42
FUZZ_CASES = 300  # the reference's tier-1 smoke lane (tests/test_fuzz_smoke.py)
# the reference's seeded mutation (tests/test_fuzz_harness.py) on the port's
# gpu engine: +1 on the first int64 output lane of every gpu cop task
FUZZ_BUG = """
import numpy as np
from tidb_tpu_torch.copr import gpu_engine

_orig = gpu_engine.execute_dag


def _corrupted(store, dag, region, ranges, read_ts, warn=None):
    ch = _orig(store, dag, region, ranges, read_ts, warn=warn)
    for c in ch.columns:
        if c.data.dtype == np.int64 and len(c.data):
            c.data = c.data + 1
            break
    return ch


gpu_engine.execute_dag = _corrupted
"""


def corpus_specs(root: str) -> dict:
    """The reference's fuzz corpus (``tests/fuzz_corpus/repro_*.py``) read as
    data: each file's top-level assignments run alone, with no builtins
    (the files import the JAX package's runner, so they are not imported).
    → {name: SPEC}."""
    import ast
    import glob

    out = {}
    for path in sorted(glob.glob(os.path.join(root, "tests", "fuzz_corpus", "repro_*.py"))):
        with open(path, encoding="utf-8") as fh:
            tree = ast.parse(fh.read())
        # the module's assignments alone, in order (SPEC may name the
        # constants assigned before it), with no builtins
        names: dict = {"__builtins__": {}}
        exec(compile(ast.Module([n for n in tree.body if isinstance(n, ast.Assign)], []), path, "exec"), names)
        out[os.path.basename(path)[:-3]] = names["SPEC"]
    return out


def _python(body: str, here: str, timeout: float):
    return subprocess.run([sys.executable, "-c", body], capture_output=True, text=True, cwd=here, timeout=timeout)


def _fuzz_phase(device: str = "cuda", cases: int = FUZZ_CASES) -> dict:
    """graftfuzz on the card: ``python -m tidb_tpu_torch.tools.fuzz --seed 42
    --cases N --query-pool 6 --device D --quiet`` as a child process must
    exit 0 with no finding, no harness error and N cases checked, its
    device sessions' cop tasks mostly on ``gpu`` with none degraded and at
    least one MPP gather. Then the reference corpus's SPECs replay through
    the port's ``run_repro`` on ``device``, and under ``FUZZ_BUG`` a
    ``--seed 5 --cases 4`` campaign must exit 1 with a finding shrunk to at
    most 3 columns and 8 rows whose emitted repro fails under the bug and
    passes without it. Prints cases/s, MPP cases and gathers, K1 launches
    and the engine counts. → the campaign's device tally."""
    import tempfile

    from tidb_tpu_torch.tools.fuzz import runner

    here = os.path.dirname(os.path.abspath(__file__))
    cmd = [sys.executable, "-m", "tidb_tpu_torch.tools.fuzz", "--seed", str(FUZZ_SEED), "--cases", str(cases),
           "--query-pool", "6", "--device", device, "--quiet"]
    t0 = time.perf_counter()
    res = subprocess.run(cmd, capture_output=True, text=True, cwd=here, timeout=900)
    wall = time.perf_counter() - t0
    if res.returncode != 0:
        raise AssertionError(f"fuzz: the campaign exited {res.returncode}:\n{res.stdout[-3000:]}\n{res.stderr[-3000:]}")
    doc = json.loads(res.stdout)
    if doc["campaign"] != {"cases": cases, "findings": 0, "harness_errors": 0, "seed": FUZZ_SEED} or doc["findings"]:
        raise AssertionError(f"fuzz: the campaign is not clean: {doc}")
    tally = next(json.loads(ln.split("graftfuzz: device ", 1)[1]) for ln in res.stderr.splitlines()
                 if ln.startswith("graftfuzz: device "))
    engines = tally["engines"]
    if tally["degraded"] or engines.get("gpu", 0) * 2 <= sum(engines.values()) or tally["gathers"] < 1:
        raise AssertionError(f"fuzz: the device sessions did not run on gpu: {tally}")
    print(f"fuzz: seed {FUZZ_SEED}, {cases} cases clean in {tally['elapsed_s']:.3f} s "
          f"({cases / tally['elapsed_s']:.2f} cases/s; child wall {wall:.3f} s); MPP cases {tally['mpp_cases']}, "
          f"gathers {tally['gathers']}; K1 launches {tally['k1_launches']}; device sessions' cop tasks {engines}, "
          f"degraded {tally['degraded']}")

    specs = corpus_specs(here)
    if len(specs) < 5:
        raise AssertionError(f"fuzz: the reference corpus holds {len(specs)} SPECs")
    t0 = time.perf_counter()
    with runner.on_device(device):
        for spec in specs.values():
            runner.run_repro(spec)
    print(f"fuzz: the corpus's {len(specs)} SPECs {sorted(specs)} replay clean in {time.perf_counter() - t0:.3f} s")

    out = tempfile.mkdtemp(prefix="smoke_fuzz_")
    try:
        t0 = time.perf_counter()
        res = _python(FUZZ_BUG + "import sys\nfrom tidb_tpu_torch.tools.fuzz.__main__ import main\n"
                      f"sys.exit(main(['--seed', '5', '--cases', '4', '--query-pool', '6', '--out', {out!r}, "
                      f"'--quiet', '--device', {device!r}]))\n", here, 600)
        if res.returncode != 1:
            raise AssertionError(f"fuzz: the campaign under the injected bug exited {res.returncode}:\n{res.stderr[-3000:]}")
        with open(os.path.join(out, "findings.json"), encoding="utf-8") as fh:
            finding = json.load(fh)["findings"][0]
        if finding["shrunk"]["columns"] > 3 or finding["shrunk"]["rows"] > 8 or finding["repro_verified"] is not True:
            raise AssertionError(f"fuzz: the injected bug's finding {finding}")
        repro = os.path.join(out, finding["repro"])
        with open(repro, encoding="utf-8") as fh:
            if "from tidb_tpu_torch.tools.fuzz.runner import run_repro" not in fh.read():
                raise AssertionError("fuzz: the emitted repro does not replay on the port")
        replay = ("import runpy\nfrom tidb_tpu_torch.tools.fuzz import runner\n"
                  f"with runner.on_device({device!r}):\n    runpy.run_path({repro!r}, run_name='__main__')\n")
        bug = _python(FUZZ_BUG + replay, here, 300)
        if bug.returncode == 0 or "AssertionError" not in bug.stderr:
            raise AssertionError(f"fuzz: the repro must fail under the bug:\n{bug.stderr[-2000:]}")
        ok = _python(replay, here, 300)
        if ok.returncode != 0:
            raise AssertionError(f"fuzz: the repro must pass without the bug:\n{ok.stderr[-2000:]}")
        print(f"fuzz: the injected bug found at seed 5 case {finding['case']} ({finding['oracle']}/{finding['phase']}), "
              f"shrunk to {finding['shrunk']}; its repro fails under the bug and passes without it "
              f"({time.perf_counter() - t0:.3f} s)")
    finally:
        shutil.rmtree(out, ignore_errors=True)
    return tally


# -- getting data in and out: LOAD DATA, IMPORT INTO over disttask, BACKUP /
# RESTORE, PITR, the plan replayer, inspection and the diag bundle -------------

# LOAD DATA's cut of SF1's 6,001,215 rows: the CSV path converts each field
# in Python (33 us a row on the H100's host), and the phase keeps inside
# 150 s. LOAD DATA ingests 200,000-row batches and a region past the
# default 500,000 keys splits at its median as a batch lands, so the table
# ends as regions of 300,000 and 398,000 rows: the 500-row append stays
# under the region size and reaches the delta operand instead of a split.
LOAD_ROWS = 698_000
DIST_ROWS = 300_000  # the dist-task import's cut: three 100,000-row subtasks
SMALL_APPEND, BIG_APPEND = 500, 200_000
APPEND_QUERIES = ("q1", "band", "q6")


def table_queries(table: str) -> dict:
    """``SQL_QUERIES`` over ``table`` (a name or ``db.name``) for lineitem."""
    return {name: re.sub(r"\blineitem\b", table, sql) for name, sql in SQL_QUERIES.items()}


def lineitem_csv(cols: dict, lo: int = 0, hi: int | None = None) -> str:
    """Rows ``lo``..``hi`` of the generated columns as CSV lines in
    ``SQL_SCHEMA``'s column order: decimals as text with two places, dates
    ISO, strings as their text (return-flag code 3 is ``NEW_RETURNFLAG``)."""
    hi = len(cols[0]) if hi is None else hi

    def dec(k):
        x = np.asarray(cols[k][lo:hi], dtype=np.int64)
        return [f"{a}.{b:02d}" for a, b in zip((x // 100).tolist(), (x % 100).tolist())]

    def date(k):
        days, inv = np.unique(np.asarray(cols[k][lo:hi]), return_inverse=True)
        return np.array([_date(d).isoformat() for d in days])[inv].tolist()

    def text(k, values):
        return np.array([v.decode() for v in values])[np.asarray(cols[k][lo:hi])].tolist()

    def num(k):
        return np.asarray(cols[k][lo:hi]).astype(str).tolist()

    fields = [
        dec(0), dec(1), dec(2), dec(3), text(4, IMPORT_RETURNFLAGS), text(5, LINESTATUS), date(6),
        text(7, SHIPMODES), text(8, SHIPINSTRUCTS), num(9), num(10), num(11), date(12), date(13),
    ]
    return "".join(",".join(r) + "\n" for r in zip(*fields))


def append_rows(seed: int, n: int, new_flag_every: int = 0) -> dict:
    """``n`` more lineitem rows from ``seed``; every ``new_flag_every``-th
    row (0: none) carries ``NEW_RETURNFLAG``, a value the table lacks."""
    c = lineitem_sf1(seed, n)
    if new_flag_every:
        c[4] = c[4].copy()
        c[4][::new_flag_every] = len(RETURNFLAGS)
    return c


def concat_rows(cols: dict, more: dict) -> dict:
    return {k: np.concatenate([v, more[k].astype(v.dtype)]) for k, v in cols.items()}


def _import_phase(seed: int, gs, reps: int = 5, device: str = "cuda", n_load: int = LOAD_ROWS,
                  n_dist: int = DIST_ROWS, small: int = SMALL_APPEND, big: int = BIG_APPEND, card: str = "") -> tuple:
    """Getting data in and out of a database on the card, through the entry
    points a user calls, on ``tidb_tpu_torch.open(device=...)`` with the
    default region size:

    1. ``n_load`` generated lineitem rows written as CSV and loaded with
       ``LOAD DATA INFILE`` into ``li_load``; the first ``n_dist`` of them
       imported with ``IMPORT INTO`` under ``tidb_enable_dist_task = 1``
       (100,000-row subtasks) into ``li_dist``.
    2. ``SQL_QUERIES`` over both tables once cold and ``reps`` times warm,
       each equal to the numpy oracle, every cop task on ``gpu``, none
       degraded; K1 launches during band and not during Q1.
    3. ``LOAD DATA`` of ``small`` rows, every third with a return flag the
       table lacks: Q1, band and Q6 equal the oracle over the union, the
       appended rows folded as the delta operand of the touched task; then
       ``big`` rows, past the delta capacity: the blocks are rebuilt (no
       delta) and the three equal the oracle again.
    4. A log backup task started, ``BACKUP DATABASE test`` to a ``file://``
       URL and ``RESTORE DATABASE r``: the seven statements over
       ``r.li_load`` equal those over ``test.li_load`` and the oracle.
    5. ``htap_writes`` on ``li_load`` through transactions, the log
       flushed, the target ts taken, then a write past it flushed too;
       ``restore_point`` to the target ts into database ``p``: the seven
       statements over ``p.li_load`` equal the oracle over the written
       columns (and not the write past the target).
    6. The band statement's plan replayer dump loaded into a fresh handle
       on the same device explains the same ``[gpu]`` readers.
    7. ``information_schema.inspection_result``'s hbm-pressure row reports
       ``gpu_engine.planning_budget(store)`` with resident bytes > 0, and
       ``tools.diag.write_bundle`` writes its seven files.

    Prints the seconds of each step, per statement the warm median and the
    summed and longest cop-task walls on each table. → (K1 launches over
    every statement of the phase, K1's largest error against its plain
    version on the band inputs of step 2, K1's timings at one of them,
    the phase's seconds)."""
    import tempfile

    import tidb_tpu_torch
    from tidb_tpu_torch.copr import gpu_engine
    from tidb_tpu_torch.ops import dag_kernel
    from tidb_tpu_torch.tools import diag, importer, replayer
    from tidb_tpu_torch.tools.pitr import LogBackupTask, restore_point

    print(f"import: card {card}")
    t_phase = time.perf_counter()
    tmp = tempfile.mkdtemp(prefix="smoke_import_")
    tasks, k1_inputs, subtask_s = [], [], []
    real_exec, real_k1 = gpu_engine.execute_region, dag_kernel.grouped_sums
    real_subtask = importer._ImportExec.run_subtask

    def spy(region, dag, ranges, warn=None, device="cuda", stats=None):
        stats = {} if stats is None else stats
        tasks.append(stats)
        return real_exec(region, dag, ranges, warn, device, stats)

    def recording_k1(seg, pairs, B, n_pad, bounds=None, device="cuda"):
        k1_inputs.append((seg, pairs, B, n_pad, bounds))
        return real_k1(seg, pairs, B, n_pad, bounds, device=device)

    def timed_subtask(self, task, subtask, manager):
        t0 = time.perf_counter()
        out = real_subtask(self, task, subtask, manager)
        subtask_s.append(time.perf_counter() - t0)
        return out

    def write(name, text):
        path = os.path.join(tmp, name)
        with open(path, "w") as f:
            f.write(text)
        return path

    gpu_engine.execute_region = spy
    importer._ImportExec.run_subtask = timed_subtask
    try:
        cols = lineitem_sf1(seed, n_load)
        t0 = time.perf_counter()
        text = lineitem_csv(cols)
        load_csv = write("li_load.csv", text)
        cut = 0
        for _ in range(n_dist):
            cut = text.index("\n", cut) + 1
        dist_csv = write("li_dist.csv", text[:cut])
        csv_s = time.perf_counter() - t0
        del text
        db = tidb_tpu_torch.open(device=device)
        s = db.session()
        for table in ("li_load", "li_dist"):
            s.execute(SQL_SCHEMA.replace("lineitem", table, 1))
        # li_load's row handles in load order, as LOAD DATA's batches draw
        # them (contiguous within a batch; a new autoid batch may skip ahead)
        load_id, handles, real_alloc = db.catalog.table("test", "li_load").id, [], db.catalog.alloc_autoid

        def alloc(table_id, n=1):
            base = real_alloc(table_id, n)
            if table_id == load_id:
                handles.append(np.arange(base, base + n, dtype=np.int64))
            return base

        db.catalog.alloc_autoid = alloc
        t0 = time.perf_counter()
        got = s.execute(f"LOAD DATA INFILE '{load_csv}' INTO TABLE li_load FIELDS TERMINATED BY ','").affected
        load_s = time.perf_counter() - t0
        if got != n_load:
            raise AssertionError(f"import: LOAD DATA loaded {got} rows, not {n_load}")
        s.execute("SET tidb_enable_dist_task = 1")
        t0 = time.perf_counter()
        got = s.execute(f"IMPORT INTO li_dist FROM '{dist_csv}'").affected
        dist_s = time.perf_counter() - t0
        done = s.query("SELECT exec_id FROM mysql.tidb_background_subtask WHERE state = 'succeed'")
        if got != n_dist or len(done) != -(-n_dist // importer._SUBTASK_ROWS):
            raise AssertionError(f"import: IMPORT INTO loaded {got} rows in {len(done)} subtasks")
        print(f"import: CSV of {n_load} rows written in {csv_s:.3f} s; LOAD DATA {load_s:.3f} s "
              f"({load_s / n_load * 1e6:.1f} us a row); dist-task IMPORT INTO of {n_dist} rows {dist_s:.3f} s "
              f"({dist_s / n_dist * 1e6:.1f} us a row) in {len(done)} subtasks of "
              f"{[round(x, 3) for x in subtask_s]} s on executors {sorted({e for (e,) in done})}; "
              f"{len(db.store.regions())} regions in the store")

        def run(name, table, want, delta=None):
            """One statement over ``table``: rows equal to ``want``, every task
            on gpu, none degraded; ``delta`` = the rows the tasks must fold
            as their delta operand. → (wall ms, cop-task walls)."""
            tasks.clear()
            t0 = time.perf_counter()
            rows = s.query(table_queries(table)[name])
            wall = (time.perf_counter() - t0) * 1e3
            summ = s.exec_summary
            if summ is None or set(summ.engines) != {"gpu"} or len(tasks) != sum(summ.engines.values()) \
                    or summ.degraded:
                raise AssertionError(f"import {name} on {table}: cop tasks {summ and summ.engines} "
                                     f"({len(tasks)} on the gpu engine), degraded {summ and summ.degraded}")
            if delta is not None and sum(st.get("delta_rows", 0) for st in tasks) != delta:
                raise AssertionError(f"import {name} on {table}: the tasks folded "
                                     f"{[st.get('delta_rows', 0) for st in tasks]} delta rows, not {delta}")
            if sql_rows(name, rows) != want:
                raise AssertionError(f"import {name} on {table}: rows disagree with the numpy oracle")
            return wall, summ.procs, [(st.get("path"), st.get("delta_rows", 0)) for st in tasks]

        def warm(label, table, want, names=tuple(SQL_QUERIES), delta=None):
            for name in names:
                runs = [run(name, table, want[name], delta) for _ in range(reps)]
                walls = [w for w, _p, _t in runs]
                print(f"import {label} {name}: tasks (path, delta_rows) {runs[0][2]}; warm sql_ms median "
                      f"{statistics.median(walls):.3f} min {min(walls):.3f}; cop_task_sum_ms median "
                      f"{statistics.median(sum(p) for _w, p, _t in runs):.3f}; cop_task_max_ms median "
                      f"{statistics.median(max(p) for _w, p, _t in runs):.3f}")

        gs.LAUNCHES = 0  # the import path: counts from 0 just before its first statement
        tables = {"li_load": cols, "li_dist": {k: v[:n_dist] for k, v in cols.items()}}
        for table, c in tables.items():
            want = {name: sql_oracle(name, c) for name in SQL_QUERIES}
            by_query, cold = {}, {}
            for name in SQL_QUERIES:
                before = gs.LAUNCHES
                dag_kernel.grouped_sums = recording_k1 if name == "band" else real_k1
                try:
                    cold[name] = run(name, table, want[name])[0]
                finally:
                    dag_kernel.grouped_sums = real_k1
                by_query[name] = gs.LAUNCHES - before
            print(f"import {table}: cold sql_ms {json.dumps({k: round(v, 3) for k, v in cold.items()})}; "
                  f"K1 launches by statement {by_query}")
            if by_query["band"] < 1 or by_query["q1"] != 0:
                raise AssertionError(f"import {table}: K1 must run for band and not for Q1: {by_query}")
            warm(table, table, want)

        # appends into the table the card already holds
        more = append_rows(seed + 11, small, new_flag_every=3)
        t0 = time.perf_counter()
        got = s.execute(f"LOAD DATA INFILE '{write('small.csv', lineitem_csv(more))}' INTO TABLE li_load "
                        "FIELDS TERMINATED BY ','").affected
        small_s = time.perf_counter() - t0
        cols = concat_rows(cols, more)
        want = {name: sql_oracle(name, cols) for name in APPEND_QUERIES}
        if got != small or not any(k[0] == NEW_RETURNFLAG.decode() for k in want["q1"]):
            raise AssertionError(f"import: the small append loaded {got} rows; Q1 must show the new flag")
        print(f"import: LOAD DATA of {small} rows ({len(more[0][::3])} with return flag "
              f"{NEW_RETURNFLAG.decode()!r}) {small_s:.3f} s; {len(db.store.regions())} regions")
        for name in APPEND_QUERIES:
            print(f"import small append {name}: cold tasks (path, delta_rows) {run(name, 'li_load', want[name], small)[2]}")
        warm("small append", "li_load", want, APPEND_QUERIES, small)
        more = append_rows(seed + 12, big)
        t0 = time.perf_counter()
        got = s.execute(f"LOAD DATA INFILE '{write('big.csv', lineitem_csv(more))}' INTO TABLE li_load "
                        "FIELDS TERMINATED BY ','").affected
        big_s = time.perf_counter() - t0
        cols = concat_rows(cols, more)
        want = {name: sql_oracle(name, cols) for name in SQL_QUERIES}
        print(f"import: LOAD DATA of {big} rows {big_s:.3f} s (past the delta capacity "
              f"{gpu_engine._delta_cap()}); {len(db.store.regions())} regions")
        for name in APPEND_QUERIES:
            print(f"import big append {name}: cold tasks (path, delta_rows) {run(name, 'li_load', want[name], 0)[2]}")
        warm("big append", "li_load", want, APPEND_QUERIES, 0)

        # BACKUP / RESTORE, the log backup task running from before the backup
        log_dir = os.path.join(tmp, "log")
        log_task = LogBackupTask(db, log_dir)
        url = f"file://{tmp}/backup"
        t0 = time.perf_counter()
        backed = s.execute(f"BACKUP DATABASE test TO '{url}'").rows
        backup_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        restored = dict((r[0], r[1]) for r in s.execute(f"RESTORE DATABASE r FROM '{url}'").rows)
        restore_s = time.perf_counter() - t0
        if restored != {"li_load": len(cols[0]), "li_dist": n_dist}:
            raise AssertionError(f"import: RESTORE gave {restored}")
        print(f"import: BACKUP {backed} {backup_s:.3f} s; RESTORE {restored} {restore_s:.3f} s")
        for name in SQL_QUERIES:
            a = run(name, "test.li_load", want[name])
            b = run(name, "r.li_load", want[name])
            print(f"import restore {name}: cold sql_ms test {a[0]:.3f}, r {b[0]:.3f}; tasks {len(a[2])} and {len(b[2])}")
        warm("r", "r.li_load", want)

        # PITR: writes through transactions, the log flushed, a point restore
        db.catalog.alloc_autoid = real_alloc
        handles = np.concatenate(handles)
        if len(handles) != len(cols[0]):
            raise AssertionError(f"import: {len(handles)} handles drawn for {len(cols[0])} rows")
        updates, deletes, insert, after, _d1, _d2 = htap_writes(cols, seed, table="li_load", handles=handles)
        t0 = time.perf_counter()
        commit_rows(db, updates, (), table="li_load")
        commit_rows(db, {}, deletes, table="li_load")
        s.execute(insert)
        dml_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        flushed = log_task.flush()
        flush_s = time.perf_counter() - t0
        target = db.store.current_ts()
        commit_rows(db, {}, handles[1:4], table="li_load")  # past the target: not replayed
        flushed2 = log_task.flush()
        t0 = time.perf_counter()
        pitr = restore_point(db, url, log_dir, target_ts=target, db_name="p")
        pitr_s = time.perf_counter() - t0
        log_task.stop()
        print(f"import: PITR writes ({len(updates)} updated, {len(deletes)} deleted, 300 inserted) {dml_s:.3f} s; "
              f"log flush {flushed} entries {flush_s:.3f} s (then {flushed2} past the target); restore_point "
              f"{pitr_s:.3f} s, {pitr['replayed']} entries replayed over {pitr['tables']}")
        want = {name: sql_oracle(name, after) for name in SQL_QUERIES}
        for name in SQL_QUERIES:
            print(f"import pitr {name}: cold sql_ms {run(name, 'p.li_load', want[name])[0]:.3f}")
        warm("p", "p.li_load", want)
        launches = gs.LAUNCHES  # every statement of the phase has run

        # the plan replayer: the band statement's dump explains the same [gpu] readers
        band = table_queries("li_load")["band"]
        plan_src = [r[0] for r in s.query("EXPLAIN " + band)]
        dump = replayer.dump(s, band, out_dir=tmp)
        db2 = tidb_tpu_torch.open(device=device)
        s2 = db2.session()
        loaded = s2.execute(f"PLAN REPLAYER LOAD '{dump}'").rows[0][0]
        plan_dst = [r[0] for r in s2.query("EXPLAIN " + band)]
        readers = [ln.strip() for ln in plan_dst if "TableReader" in ln]
        if loaded != band or not readers or not all("[gpu]" in ln for ln in readers) or \
                readers != [ln.strip() for ln in plan_src if "TableReader" in ln]:
            raise AssertionError(f"import: the replayed plan {plan_dst} is not the dump's {plan_src}")
        db2.stop_background()
        print(f"import: plan replayer dump {os.path.basename(dump)} loaded; EXPLAIN readers {readers}")

        # inspection: the device cache judged against the planner's budget
        budget = gpu_engine.planning_budget(db.store)
        rows = s.query("SELECT * FROM information_schema.inspection_result WHERE RULE = 'hbm-pressure'")
        seen = [re.match(r"(\d+) bytes resident of (\d+) budget", r[5]) for r in rows]
        if not rows or not all(m and int(m.group(2)) == budget and int(m.group(1)) > 0 for m in seen):
            raise AssertionError(f"import: hbm-pressure rows {rows}, want the budget {budget} and resident bytes")
        files = sorted(os.path.basename(p) for p in diag.write_bundle(db, os.path.join(tmp, "diag")))
        if len(files) != 7:
            raise AssertionError(f"import: the diag bundle wrote {files}")
        print(f"import: inspection hbm-pressure {rows}; diag bundle {files}")
        db.stop_background()
    finally:
        gpu_engine.execute_region = real_exec
        dag_kernel.grouped_sums = real_k1
        importer._ImportExec.run_subtask = real_subtask
        shutil.rmtree(tmp, ignore_errors=True)

    err = max(_k1_err(*inp) for inp in k1_inputs)
    seg, pairs, B, n_pad, kb = k1_inputs[0]
    k1 = _k1_timings(seg, pairs, B, n_pad, kb)
    print(f"import: K1 launches on the import path {launches}; K1 equal to its plain version on the "
          f"{len(k1_inputs)} band inputs of the cold drive; at li_load's first band input n_pad={n_pad} B={B} "
          f"L={len(pairs)}: {json.dumps(k1)}")
    return launches, err, k1, time.perf_counter() - t_phase


def _drive(regions, dags, gs):
    """Every DAG over every region on the card, once. → (Chunks per DAG and
    region, K1 launches per DAG, the engine's stats per DAG of the first
    region)."""
    import torch

    from tidb_tpu_torch.copr import gpu_engine

    results, launches, info = {}, {}, {}
    for name, dag in dags.items():
        before = gs.LAUNCHES
        results[name] = []
        for ri, (r, rg) in enumerate(regions):
            stats = {}
            results[name].append(gpu_engine.execute_region(r, dag, rg, device="cuda", stats=stats))
            if ri == 0:
                info[name] = stats
        torch.cuda.synchronize()
        launches[name] = gs.LAUNCHES - before
    return results, launches, info


# -- the last reference modules on the card: graftcheck, the SQL path under
# the port's lock-order detector, benchdaily and benchdb ---------------------

# benchdaily's lanes with a 5 % overhead budget (instrumented against plain in
# one process): the smoke leaves them out, because their budget gates breach
# on the reference itself run to run (run alone they pass and breach by turns
# on a CPU), so a breach says nothing of the port; they are run alone, one
# process each, beside the smoke and their outcomes recorded
BUDGET_LANES = ("graftcheck_runtime_overhead_ms", "log_overhead_ms", "metering_overhead_ms")
# TiDB's cmd/benchdb job list with 100 random updates in place of 1,000:
# each UPDATE scans the table in Python (~81 ms a statement on an H100
# machine's host), so 1,000 of them held 81 s of the smoke's time limit
BENCHDB_RUN = "create,insert:10000,update-random:100,select:100,query:20,analyze,delete:1000,gc"
# the lockcheck child's MPP statement runs over the first rows of the SQL
# phase's lineitem (ANALYZE of SF1's 6,001,215 rows alone takes ~40 s)
LOCKCHECK_MPP_ROWS = 600_000


def _graftcheck_run(here: str) -> dict:
    """14a: ``python -m tidb_tpu_torch.tools.check --json <tmp>`` in a
    subprocess must exit 0 with ``"ok": true``, no finding and nothing
    baselined. → {seconds, rules, suppressed}."""
    import tempfile

    from tidb_tpu_torch.tools.check import load_rules

    out = os.path.join(tempfile.mkdtemp(prefix="smoke_graftcheck_"), "report.json")
    t0 = time.perf_counter()
    res = subprocess.run([sys.executable, "-m", "tidb_tpu_torch.tools.check", "--json", out],
                         capture_output=True, text=True, cwd=here, timeout=300)
    secs = time.perf_counter() - t0
    if res.returncode != 0:
        raise AssertionError(f"graftcheck: exited {res.returncode}:\n{res.stdout[-3000:]}\n{res.stderr[-2000:]}")
    with open(out, encoding="utf-8") as fh:
        rep = json.load(fh)
    shutil.rmtree(os.path.dirname(out), ignore_errors=True)
    if rep["ok"] is not True or rep["findings"] or rep["baselined"]:
        raise AssertionError(f"graftcheck: the report is not clean: {rep}")
    return {"seconds": secs, "rules": len(load_rules()), "suppressed": rep["suppressed"],
            "summary": res.stdout.strip().splitlines()[-1]}


def _lockcheck_child(seed: int, n: int, device: str, reps: int = 5) -> int:
    """14b's child (``chip_smoke.py --lockcheck-child``): installs
    ``tidb_tpu_torch.utils.lockcheck`` before it imports any other module of
    the package, shows that locks the port creates afterwards are checked
    ones, then on ``open(device=...)``: ``_sql_phase`` over ``n`` rows of
    ``lineitem_sf1(seed)`` in two regions (the statements cold and ``reps``
    times warm, equal to ``sql_oracle``, K1 in band and not in Q1, its
    first-use nvcc build inside this process: the kernels build into a
    fresh directory), ``htap_writes`` committed and the statements read
    again through the delta operand, and bench.py's Q3 at 4 virtual shards
    over the first ``LOCKCHECK_MPP_ROWS`` rows. A ``LockOrderError`` raised
    on any thread fails it. Prints a last line of JSON."""
    os.environ["TIDB_TPU_LOCKCHECK"] = "1"
    from tidb_tpu_torch.utils import lockcheck

    if not lockcheck.install():
        raise AssertionError("lockcheck: install() did not install")
    order_errors = []
    real_init = lockcheck.LockOrderError.__init__

    def recording_init(self, msg, cycle):  # an error swallowed on a worker thread still counts
        order_errors.append(msg)
        real_init(self, msg, cycle)

    lockcheck.LockOrderError.__init__ = recording_init
    import tempfile
    from pathlib import Path

    import torch

    import tidb_tpu_torch
    from tidb_tpu_torch.copr import colcache, gpu_engine
    from tidb_tpu_torch.executor.load import bulk_load
    from tidb_tpu_torch.native import cuda as native
    from tidb_tpu_torch.ops import grouped_sums as gs
    from tidb_tpu_torch.parallel import gather, mesh

    t_start = time.perf_counter()
    for name, lk in (("parallel.gather._MPP_CACHE_MU", gather._MPP_CACHE_MU), ("native.cuda._MU", native._MU)):
        if not isinstance(lk, lockcheck._CheckedLock):
            raise AssertionError(f"lockcheck: {name} is not a checked lock: {lk!r}")
    build_dir = None
    if torch.device(device).type == "cuda":
        # K1's first use compiles it here, under native._MU, from a cop worker
        build_dir = native.BUILD_DIR = Path(tempfile.mkdtemp(prefix="smoke_lockcheck_build_"))
    k1_lib = native.library_path("grouped_sums")
    cols = lineitem_sf1(seed, n)
    gs.LAUNCHES = 0
    _launches, db, warm = _sql_phase(cols, gs, reps=reps, device=device)
    lru = gpu_engine._device_lru(colcache.cache_for(db.store), gpu_engine.store_device(db.store))
    if not isinstance(lru._mu, lockcheck._CheckedLock):
        raise AssertionError(f"lockcheck: the gpu engine's LRU lock is not a checked lock: {lru._mu!r}")
    built = build_dir is not None and k1_lib.exists()
    if build_dir is not None and not built:
        raise AssertionError("lockcheck: K1 was not built inside the child")

    updates, deletes, insert, after, _d1, _d2 = htap_writes(cols, seed)
    commit_rows(db, updates, ())
    commit_rows(db, {}, deletes)
    db.execute(insert)
    s = db.session()
    delta_k1 = {}
    for name, sql in SQL_QUERIES.items():
        before = gs.LAUNCHES
        rows = s.query(sql)
        delta_k1[name] = gs.LAUNCHES - before
        summ = s.exec_summary
        if summ is None or summ.engines != {"gpu": 2} or summ.degraded:
            raise AssertionError(f"lockcheck htap {name}: cop tasks {summ and summ.engines}")
        if sql_rows(name, rows) != sql_oracle(name, after):
            raise AssertionError(f"lockcheck htap {name}: rows disagree with the oracle after the writes")
    if delta_k1["band"] != 2 or delta_k1["q1"] != 0:
        raise AssertionError(f"lockcheck htap: K1 launches by statement {delta_k1}")
    db.stop_background()
    db = None

    m = min(n, LOCKCHECK_MPP_ROWS)
    tables = mpp_tables({k: v[:m] for k, v in cols.items()}, lineitem_partkey(seed, m), seed, n_part=20_000,
                        n_cust=15_000)
    mdb = tidb_tpu_torch.open(region_split_keys=1 << 62, device=device)
    mpp_sql(mdb, bulk_load, tables)
    mesh.FORCE_NDEV = 4
    try:
        ms = mdb.session()
        t0 = time.perf_counter()
        rows = ms.query(MPP_QUERIES["q3"])
        mpp_ms = (time.perf_counter() - t0) * 1e3
        det = ms.mpp_details[-1] if ms.mpp_details else None
        got = None if det is None else (det.n_fragments, det.stages, det.ndev, det.retries)
        if got != (*MPP_PLANS["q3"], 4, 0):
            raise AssertionError(f"lockcheck mpp q3: gather (fragments, stages, ndev, retries) {got}")
        if not mpp_rows_match("q3", rows, mpp_oracle("q3", tables), MPP_LIMITS["q3"]):
            raise AssertionError("lockcheck mpp q3: rows disagree with the oracle")
    finally:
        mesh.FORCE_NDEV = None
    mdb.stop_background()
    if order_errors:
        raise AssertionError(f"lockcheck: {len(order_errors)} lock-order cycle(s): {order_errors[0]}")
    if build_dir is not None:
        shutil.rmtree(build_dir, ignore_errors=True)
    print(json.dumps({"sites": len(lockcheck._sites), "edges": len(lockcheck._edges), "k1_launches": gs.LAUNCHES,
                      "k1_built_here": built, "warm": warm, "htap_k1": delta_k1, "mpp_q3_ms": mpp_ms,
                      "seconds": time.perf_counter() - t_start}))
    return 0


def _lockcheck_phase(seed: int, sql_warm: dict, device: str = "cuda", n: int = SF1_ROWS) -> dict:
    """14b: runs ``_lockcheck_child`` (``chip_smoke.py --lockcheck-child``,
    ``TIDB_TPU_LOCKCHECK=1``) and prints its lines, then the checked locks,
    the edges recorded, K1's launches and the warm medians under the
    detector beside phase 5's (``sql_warm``). → the child's summary."""
    here = os.path.dirname(os.path.abspath(__file__))
    cmd = [sys.executable, os.path.abspath(__file__), "--lockcheck-child", "--seed", str(seed), "--rows", str(n),
           "--device", device]
    t0 = time.perf_counter()
    res = subprocess.run(cmd, capture_output=True, text=True, cwd=here, timeout=900,
                         env=dict(os.environ, TIDB_TPU_LOCKCHECK="1"))
    wall = time.perf_counter() - t0
    if res.returncode != 0:
        raise AssertionError(f"lockcheck: the child exited {res.returncode}:\n{res.stdout[-3000:]}\n{res.stderr[-4000:]}")
    lines = res.stdout.strip().splitlines()
    for ln in lines[:-1]:
        print(f"lockcheck child: {ln}")
    doc = json.loads(lines[-1])
    print(f"lockcheck: child wall {wall:.1f} s (its own {doc['seconds']:.1f} s); checked locks live "
          f"{doc['sites']}, lock-order edges {doc['edges']}, no cycle; K1 launches {doc['k1_launches']} "
          f"(built in the child: {doc['k1_built_here']}; after the writes {doc['htap_k1']}); bench.py's Q3 at 4 "
          f"virtual shards {doc['mpp_q3_ms']:.3f} ms cold")
    for name, ms in doc["warm"].items():
        base = sql_warm.get(name)
        print(f"lockcheck sql {name}: warm median {ms:.3f} ms under the detector, phase 5 {_ms(base)}"
              + ("" if not base else f" ({ms / base:.3f}x)"))
    return doc


def _bench_phase(here: str, gs, device: str = "cuda") -> dict:
    """14c: ``python -m tidb_tpu_torch.bench.benchdaily --device D --out
    <tmp>/daily.json --only <lanes>`` with every registered lane but
    ``BUDGET_LANES`` (28 of 31); every lane must return a number. Then the
    same command with ``--check <tmp>/daily.json``, against itself (the
    run writes ``--out`` before it reads ``--check``), must exit 0 with the
    guard's verdict, every lane returning a number again. The drift of the
    second run against the first (``check_regression`` at the guard's
    tolerance) is printed, not gated: run to run on one host it passes 25 %
    on some lanes (a CPU rehearsal: 6 of 28), so it says nothing of the
    port. Then ``benchdb.main(["--device", D, "--run", BENCHDB_RUN,
    "--json"])`` in this process must leave 9,000 rows in ``bench_db``, its
    aggregation's cop tasks on ``gpu``. Prints every lane's value. →
    {"lanes", "lanes_check": records by lane, "benchdb": its records,
    "k1_launches": K1's launches over the three}."""
    import contextlib
    import io
    import tempfile

    import tidb_tpu_torch
    from tidb_tpu_torch.bench import benchdaily, benchdb

    lanes = [n for n in benchdaily._BENCHES if n not in BUDGET_LANES]
    tmp = tempfile.mkdtemp(prefix="smoke_bench_")
    daily = os.path.join(tmp, "daily.json")
    body = ("import sys\nfrom tidb_tpu_torch.bench import benchdaily\nfrom tidb_tpu_torch.ops import grouped_sums as gs\n"
            "try:\n    benchdaily.main(sys.argv[1:])\nfinally:\n    print(f'k1_launches {gs.LAUNCHES}', file=sys.stderr)\n")
    k1 = 0
    runs, recs = [], []
    try:
        for extra in (["--out", daily], ["--out", daily, "--check", daily]):
            cmd = [sys.executable, "-c", body, "--device", device, *extra, "--only", *lanes]
            t0 = time.perf_counter()
            res = subprocess.run(cmd, capture_output=True, text=True, cwd=here, timeout=900)
            runs.append(time.perf_counter() - t0)
            if res.returncode != 0:
                raise AssertionError(f"benchdaily {' '.join(extra)}: exited {res.returncode}:\n{res.stdout[-3000:]}\n"
                                     f"{res.stderr[-4000:]}")
            k1 += next(int(ln.split()[1]) for ln in res.stderr.splitlines() if ln.startswith("k1_launches "))
            with open(daily, encoding="utf-8") as fh:
                recs.append(json.load(fh))
        if "regression guard: ok" not in res.stdout:
            raise AssertionError(f"benchdaily --check: no guard verdict:\n{res.stdout[-2000:]}")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    first, second = ({r["name"]: r for r in run} for run in recs)
    for run in (first, second):
        if sorted(run) != sorted(lanes) or any(("ms" in r) == ("ops_per_sec" in r) for r in run.values()):
            raise AssertionError(f"benchdaily: not every lane returned one number: {sorted(run)}")
    drift = benchdaily.check_regression(recs[1], recs[0])
    print(f"benchdaily: {len(lanes)} lanes on {device}, twice ({runs[0]:.1f} s, {runs[1]:.1f} s); the second run's "
          f"guard against itself: ok; left out: {', '.join(BUDGET_LANES)}; the second run against the first at the "
          f"guard's tolerance (not gated): {len(drift)} past it{': ' + '; '.join(drift) if drift else ''}")
    for name in lanes:
        a, b = first[name], second[name]
        unit = "ms" if "ms" in a else "ops_per_sec"
        print(f"benchdaily {name}: {a[unit]} / {b[unit]} {unit}")

    opened = []
    real_open = tidb_tpu_torch.open

    def capturing_open(*a, **k):
        opened.append(real_open(*a, **k))
        return opened[-1]

    before = gs.LAUNCHES
    out = io.StringIO()
    tidb_tpu_torch.open = capturing_open
    t0 = time.perf_counter()
    try:
        with contextlib.redirect_stdout(out):
            benchdb.main(["--device", device, "--run", BENCHDB_RUN, "--json"])
    finally:
        tidb_tpu_torch.open = real_open
    secs = time.perf_counter() - t0
    k1 += gs.LAUNCHES - before
    (db,) = opened
    left = db.query("SELECT COUNT(*) FROM bench_db")
    engines = db.session()
    engines.query("SELECT COUNT(*), SUM(v) FROM bench_db")
    on = engines.exec_summary.engines if engines.exec_summary else None
    db.stop_background()
    recs = json.loads(out.getvalue())
    if left != [(9000,)] or [r["job"] for r in recs] != BENCHDB_RUN.split(","):
        raise AssertionError(f"benchdb: {left} rows left, jobs {[r['job'] for r in recs]}")
    if not on or set(on) != {"gpu"}:
        raise AssertionError(f"benchdb: the aggregation's cop tasks ran on {on}")
    print(f"benchdb: {BENCHDB_RUN} on {device} in {secs:.1f} s, {left[0][0]} rows left, cop tasks {on}: {json.dumps(recs)}")
    return {"lanes": first, "lanes_check": second, "benchdb": recs, "k1_launches": k1}


def _same_chunk(a, b) -> bool:
    """Row-for-row equality of two Chunks: equal validity, equal data where
    valid."""
    if len(a) != len(b) or len(a.columns) != len(b.columns):
        return False
    for x, y in zip(a.columns, b.columns):
        if not np.array_equal(x.validity, y.validity):
            return False
        if not np.array_equal(x.data[x.validity], y.data[y.validity]):
            return False
    return True


def _ms(x) -> str:
    return "not measured" if x is None else f"{x:.3f}"


def _task_timing(gpu_engine, region, dag, ranges, reps: int = 10) -> dict:
    """Warm wall (host clock around the call, which ends in the copy of the
    result to the host), device span (CUDA events), device busy time, its
    concatenation kernels and top kernels (torch.profiler), idle share."""
    import torch

    walls, spans = [], []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        t0 = time.perf_counter()
        a.record()
        gpu_engine.execute_region(region, dag, ranges, device="cuda")
        b.record()
        b.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
        spans.append(a.elapsed_time(b))
    kernels = _profile_device(lambda: gpu_engine.execute_region(region, dag, ranges, device="cuda"))
    wall = statistics.median(walls)
    busy = sum(k[1] for k in kernels) if kernels else None
    return {
        "wall": wall,
        "wall_min": min(walls),
        "span": statistics.median(spans),
        "busy": busy,
        "idle": "not measured" if busy is None else f"{max(0.0, 1 - busy / wall):.3f}",
        "cat": sum(k[1] for k in kernels if "CatArray" in k[0]) if kernels else None,
        "top": kernels[:3],
    }


def _busy(fn, wall_ms: float) -> str:
    """One profiled call of ``fn``: the device's busy time (the sum of its
    kernels) and the idle share against ``wall_ms``."""
    kernels = _profile_device(fn)
    busy = sum(k[1] for k in kernels) if kernels else None
    return f"profiled device_busy_ms {_ms(busy)}" + ("" if busy is None else f" (idle share {max(0.0, 1 - busy / wall_ms):.3f})")


def _profile_device(fn):
    """[(kernel, ms, calls)] of one call from torch.profiler, longest first:
    device-side events only (a host op's device total would count its
    kernels twice); [] when the profiler records no device time."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    kernels = [
        (e.key, e.self_device_time_total / 1e3, e.count)
        for e in prof.key_averages()
        if getattr(e, "device_type", None) == DeviceType.CUDA and e.self_device_time_total > 0
    ]
    kernels.sort(key=lambda k: -k[1])
    return kernels


if __name__ == "__main__":
    sys.exit(main())
