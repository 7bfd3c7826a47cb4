"""cudabench: the benchmark of tidb_tpu_torch on NVIDIA H100 cards.

    python3 -m cudabench --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Run from the root of a checkout. The cell is found by name in
``BENCHMARK.json``; its configuration in ``cudabench/configs/<config>.json``
(schema, scale, region split, generator), its traffic in
``cudabench/workloads/<cell>.json`` (templates, the statement list, clients)
and each metric's reader in ``cudabench/metrics/<metric>.py``.

A run generates the tables from ``--seed``, loads them into
``tidb_tpu_torch.open(device="cuda")``, splits each
table into regions of the configuration's ``region_split_keys`` keys (TiKV's
split checker; the port's own split on ingest is off, since its cuts move
with the data), checks each
template's plan, runs every distinct statement of the list twice (the first
builds its programs, the second has to build none), then measures
``--seconds`` of closed-loop traffic: each client is a thread with a session
of its own, sending its next statement when the last returns. After the
window every answer is compared with the numpy reference
(``cudabench/reference/``), and the last line of standard output is the
result. With ``--trace 1`` the window runs under ``torch.profiler`` and the
line carries the cell's per-layer metrics instead of its end-to-end ones.
"""

from __future__ import annotations

import argparse
import gc
import json
import os
import sys
import threading
import time
from pathlib import Path

import numpy as np

PKG = Path(__file__).resolve().parent
# one value for every run: torch's intra-op threads (host-side tensor work
# in the port) and the size the cop worker pool is asked for, so runs on
# one machine load its cores alike
TORCH_THREADS = 4
COP_POOL = 16
NO_SPLIT = 1 << 62
JOIN_GRACE_S = 60.0  # how long past the window's close an answer may come
FORBIDDEN = ("jax", "jaxlib", "flax", "tidb_tpu")


def cache_dirs(root: Path) -> dict:
    """Build and kernel caches at fixed paths inside the checkout (the
    port's own CUDA build directory, ``tidb_tpu_torch/_build``, is too)."""
    base = root / ".cudabench_cache"
    return {"TORCH_EXTENSIONS_DIR": str(base / "torch_extensions"), "TRITON_CACHE_DIR": str(base / "triton")}


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def cell_spec(bench: dict, name: str) -> tuple:
    """(cell entry, configuration, traffic, end-to-end metrics, per-layer
    metrics) of the cell ``name``: the metrics whose ``workloads`` list it,
    or that list none."""
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json (have {sorted(cells)})")
    cell = cells[name]
    config = load_json(PKG / "configs" / f"{cell['config']}.json")
    traffic = load_json(PKG / "workloads" / f"{name}.json")
    if traffic["config"] != cell["config"] or config["name"] != cell["config"]:
        raise ValueError(f"{name}: BENCHMARK.json, the traffic file and the configuration name different configurations")

    def mine(metrics):
        return [m for m in metrics if name in m.get("workloads", [name])]

    return cell, config, traffic, mine(bench["end_to_end"]), mine(bench["per_layer"])


def statements(traffic: dict) -> list:
    """[(template, sql)] of the traffic file's statement list."""
    out = []
    for st in traffic["statements"]:
        tpl = traffic["templates"][st["template"]]
        out.append((st["template"], tpl["sql"].format(**st["params"])))
    return out


def stmt_bytes(config: dict, traffic: dict, rows: dict) -> dict:
    """Statement index -> bytes its template must read: each referenced
    column once, at its narrowest whole-byte width, plus one validity bit
    a row where the column is nullable (not a key)."""
    out = {}
    for i, st in enumerate(traffic["statements"]):
        total = 0.0
        for table, cols in traffic["templates"][st["template"]]["reads"].items():
            spec = {c["name"]: c for c in config["tables"][table]["columns"]}
            for c in cols:
                total += rows[table] * (spec[c]["bytes"] + (0 if spec[c].get("key") else 1 / 8))
        out[i] = total
    return out


def split_handles(spec: dict, cols: dict, split_keys: int) -> list:
    """The handles at which TiKV's split checker would cut a loaded table
    into regions of ``split_keys`` keys: every ``split_keys``-th row handle
    (the integer primary key where the table has one, else the load's
    handles 1..n)."""
    key = next((c["name"] for c in spec["columns"] if c.get("key")), None)
    n = len(next(iter(cols.values())))
    handles = np.sort(cols[key]) if key else np.arange(1, n + 1)
    return [int(handles[i]) for i in range(split_keys, n, split_keys)]


def ddl(table: str, spec: dict) -> str:
    cols = ", ".join(f"{c['name']} {c['type']}" + (" PRIMARY KEY" if c.get("key") else "") for c in spec["columns"])
    return f"CREATE TABLE {table} ({cols})"


class Counters:
    """Programs built so far: cop programs (``COP_COMPILE_SECONDS``' count)
    and MPP program-cache misses."""

    def __init__(self):
        from tidb_tpu_torch.utils import metrics

        self._m = metrics

    def read(self) -> dict:
        return {"cop": self._m.COP_COMPILE_SECONDS.count, "mpp": self._m.MPP_PROGRAM_CACHE.get(result="miss")}

    def since(self, before: dict) -> dict:
        now = self.read()
        return {k: now[k] - before[k] for k in now}


def check_plans(session, traffic: dict, stmts: list) -> None:
    """EXPLAIN of each template (its first statement in the list) has to
    show what the traffic file asks: the engine or the gather that the
    cell exists to measure."""
    want = traffic["explain"]
    seen = set()
    for tpl, sql in stmts:
        if tpl in seen:
            continue
        seen.add(tpl)
        plan = "\n".join(str(r[0]) for r in session.query("EXPLAIN " + sql))
        bad = [w for w in want.get("contains", []) if w not in plan]
        bad += [f"not {w}" for w in want.get("excludes", []) if w in plan]
        bad += [f"{w} x{k}" for w, k in want.get("count", {}).items() if plan.count(w) != k]
        if bad:
            raise RuntimeError(f"plan of {tpl} lacks {bad}:\n{plan}")


def record(session, st, rows) -> None:
    """What the session kept of the statement just run, into ``st``."""
    es = session.exec_summary
    if es is not None and es.num:
        st.cop_tasks = es.num
        st.max_proc_ms = max(es.procs)
    for m in session.mpp_details:
        st.gathers += 1
        st.gather_ms += m.wall_ms
        st.exchange_bytes += sum(int(s[3]) for s in m.shards if len(s) > 3) + sum(int(b) for b in m.stage_bytes)
    st.rows = rows


def client_loop(session, k: int, stmts: list, offset: int, start: threading.Barrier, clock: dict, out: list) -> None:
    """One client: from ``offset`` in the list, each statement sent when
    the last returned, until the window closes."""
    from cudabench.records import Stmt

    i = offset
    start.wait()
    t_end = clock["end"]
    while True:
        t0 = time.perf_counter()
        if t0 >= t_end:
            return
        idx = i % len(stmts)
        tpl, sql = stmts[idx]
        st = Stmt(client=k, index=idx, template=tpl, t0=t0, t1=t0)
        try:
            rows = session.query(sql)
            st.t1 = time.perf_counter()
            record(session, st, rows)
        except Exception as e:  # a statement that fails is counted and reported, the client goes on
            st.t1 = time.perf_counter()
            st.error = f"{type(e).__name__}: {e}"
        out.append(st)
        i += 1


def compare(traffic: dict, tables: dict, stmts: list, answers: dict, numeric: str = "exact") -> dict:
    """{distinct statement index: whether every answer it gave equals the
    reference's}. ``answers`` maps a statement index to the row lists the
    program returned for it."""
    import importlib

    first = {}
    for i, (_tpl, sql) in enumerate(stmts):
        first.setdefault(sql, i)
    ok = {}
    for sql, i in first.items():
        got = [a for j, (_t, s) in enumerate(stmts) if s == sql for a in answers.get(j, [])]
        if not got:
            continue
        tpl = traffic["statements"][i]["template"]
        ref = importlib.import_module(f"cudabench.reference.{tpl}")
        want = ref.rows(tables, traffic["statements"][i]["params"], numeric)
        if ref.LIMIT is not None:
            want = want[: ref.LIMIT]
        ok[i] = all(list(rows) == want for rows in got)
    return ok


def run_cell(bench: dict, name: str, seed: int, seconds: float, trace: bool, device: str = "cuda",
             rows: dict | None = None, split_keys: int | None = None, t_proc: float | None = None,
             say=print) -> dict:
    """One run of the cell; → the result line's object. ``device``,
    ``rows`` and ``split_keys`` are for the CPU tests' rehearsals only: the
    command always measures on the card at the configuration's size."""
    t_proc = time.perf_counter() if t_proc is None else t_proc
    cell, config, traffic, e2e, per_layer = cell_spec(bench, name)
    stmts = statements(traffic)
    import torch

    import tidb_tpu_torch
    from cudabench import data
    from cudabench.records import Run, reader
    from tidb_tpu_torch.copr import client as cop_client
    from tidb_tpu_torch.executor.load import bulk_load
    from tidb_tpu_torch.kv import tablecodec

    torch.set_num_threads(TORCH_THREADS)
    split = split_keys or config["region_split_keys"]
    seed = int(seed) % 2**64

    split_s = {}
    t = time.perf_counter()
    tables = data.generate(config, seed, rows)
    split_s["generate"] = time.perf_counter() - t

    t = time.perf_counter()
    # no split on ingest: it cuts at medians that move with the data, so
    # the seed would change the layout; TiKV's cuts are made below
    db = tidb_tpu_torch.open(region_split_keys=NO_SPLIT, device=device)
    try:
        cop_client.shared_cop_pool(COP_POOL)
        s0 = db.session()
        for tname, spec in config["tables"].items():
            s0.execute(ddl(tname, spec))
            bulk_load(db, tname, [tables[tname][c["name"]] for c in spec["columns"]])
        split_s["load"] = time.perf_counter() - t
        t = time.perf_counter()
        regions = {}
        for tname, spec in config["tables"].items():
            tid = db.catalog.table("test", tname).id
            for h in split_handles(spec, tables[tname], split):
                db.store.split_region(tablecodec.record_key(tid, h))
            regions[tname] = len(db.store.pd.regions_in_ranges([tablecodec.record_range(tid)]))
        split_s["split"] = time.perf_counter() - t
        t = time.perf_counter()
        for tname in config["analyze"]:
            s0.execute(f"ANALYZE TABLE {tname}")
        split_s["analyze"] = time.perf_counter() - t

        t = time.perf_counter()
        check_plans(s0, traffic, stmts)
        counters = Counters()
        answers: dict = {}
        distinct = {}
        for i, (_tpl, sql) in enumerate(stmts):
            distinct.setdefault(sql, i)
        for sql, i in distinct.items():
            answers.setdefault(i, []).append(s0.query(sql))
            before = counters.read()
            answers[i].append(s0.query(sql))
            built = counters.since(before)
            if any(built.values()):
                raise RuntimeError(f"statement {i} built {built} programs on its second run: {sql}")
        split_s["warm"] = time.perf_counter() - t
        n_rows = {tname: len(next(iter(cols.values()))) for tname, cols in tables.items()}
        nbytes = stmt_bytes(config, traffic, n_rows)
        sessions = [db.session() for _ in range(traffic["clients"])]
        gc.collect()
        gc.freeze()  # set-up's objects stay out of the window's collections
        pool_size, _queued = cop_client.cop_pool_stats()
        say(f"cudabench: {name} seed {seed}: regions {regions}; rows {n_rows}; clients {traffic['clients']}; "
            f"distinct statements {len(distinct)} of {len(stmts)}; torch threads {torch.get_num_threads()}; "
            f"cop pool {pool_size} (asked {COP_POOL}); set-up split s "
            + json.dumps({k: round(v, 3) for k, v in split_s.items()}))

        # -- the window ------------------------------------------------------
        spans = prof = None
        if trace:
            from cudabench.trace import Profiler, Spans

            spans = Spans()
            spans.install()
            prof = Profiler(device)
            prof.start()
        out: list = []
        clients = traffic["clients"]
        start = threading.Barrier(clients + 1)
        clock: dict = {}
        threads = [
            threading.Thread(target=client_loop, name=f"cudabench-client-{k}", daemon=True,
                             args=(sessions[k], k, stmts, k * len(stmts) // clients, start, clock, out))
            for k in range(clients)
        ]
        for th in threads:
            th.start()
        before = counters.read()
        clock["start"] = time.perf_counter()
        clock["end"] = clock["start"] + seconds
        setup_s = clock["start"] - t_proc
        start.wait()
        for th in threads:
            th.join(timeout=max(0.0, clock["end"] + JOIN_GRACE_S - time.perf_counter()))
        hung = sum(th.is_alive() for th in threads)
        if device != "cpu":
            torch.cuda.synchronize()
        builds = counters.since(before)
        if prof is not None:
            prof.stop()
            spans.remove()
        peak = torch.cuda.max_memory_allocated() if device != "cpu" else 0
        stmts_run = list(out)
        for st in stmts_run:
            if not st.error:
                answers.setdefault(st.index, []).append(st.rows)
    finally:
        db.stop_background()
    del db, sessions, s0
    gc.unfreeze()
    gc.collect()

    run = Run(setup_s=setup_s, t_start=clock["start"], t_end=clock["end"], stmts=stmts_run, builds=builds,
              stmt_bytes=nbytes, hbm_bytes_per_s=load_json(PKG / "peaks.json")["hbm_bytes_per_s"])
    if prof is not None:
        from cudabench.trace import summarize

        w0 = int(clock["start"] * 1e9) + prof.offset_ns
        w1 = int(clock["end"] * 1e9) + prof.offset_ns
        run.trace = summarize(prof.device_events(), w0, w1, stmts_run, spans, prof.offset_ns)
        if run.trace.busy_s <= 0 and device != "cpu":
            raise RuntimeError("the profiler saw no device operation in the window")

    t = time.perf_counter()
    ok = compare(traffic, tables, stmts, answers)
    ref_s = time.perf_counter() - t
    failed = sum(1 for s in stmts_run if s.error)
    wrong = sum(1 for v in ok.values() if not v)
    metrics = {}
    for m in (per_layer if trace else e2e):
        v = reader(m["name"])(run)
        if v is not None:
            metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}
    checks = {
        "wrong_statements": {"value": wrong, "limit": 0},
        "failed_statements": {"value": failed, "limit": 0},
        "hung_clients": {"value": hung, "limit": 0},
    }
    result = {
        "correct": all(c["value"] <= c["limit"] for c in checks.values()),
        "attempted": len(stmts_run),
        "failed": sum(1 for s in stmts_run if s.error or not ok.get(distinct[stmts[s.index][1]], True)),
        "metrics": metrics,
        "device": {
            "platform": "gpu" if device != "cpu" else "cpu",
            "kind": torch.cuda.get_device_name() if device != "cpu" else "cpu",
            "count": int(cell["chips"]),
            "memory_peak_bytes": int(peak),
        },
    }
    if run.trace is not None:
        result["device"]["busy_s"] = run.trace.busy_s
        result["device"]["window_s"] = run.trace.window_s
        result["breakdown"] = {"device_ops": [[n[:120], v] for n, v in run.trace.device_ops],
                               "idle_gaps": run.trace.idle_gaps}
    result["checks"] = checks
    errors = sorted({s.error for s in stmts_run if s.error})[:3]
    say(f"cudabench: window {seconds} s: {len(run.done())} statements done, {len(stmts_run)} sent, "
        f"builds in window {builds}; reference {ref_s:.3f} s; wrong {[i for i, v in ok.items() if not v]}"
        + (f"; errors {errors}" if errors else ""))
    return result


def forbidden_modules() -> list:
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def main(argv=None) -> int:
    t_proc = time.perf_counter()
    ap = argparse.ArgumentParser(prog="python3 -m cudabench", description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    root = Path.cwd()
    for k, v in cache_dirs(root).items():
        Path(v).mkdir(parents=True, exist_ok=True)
        os.environ[k] = v
    bench = load_json(root / "BENCHMARK.json")
    cell = cell_spec(bench, args.workload)[0]

    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < int(cell["chips"]):
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"cudabench: {args.workload} needs {cell['chips']} CUDA card(s), found {n}", file=sys.stderr)
        return 2
    result = run_cell(bench, args.workload, args.seed, args.seconds, bool(args.trace), "cuda", t_proc=t_proc)
    bad = forbidden_modules()
    if bad:
        print(f"cudabench: the process loaded {bad} (the JAX package or JAX itself)", file=sys.stderr)
        return 3
    for k, c in result["checks"].items():
        print(f"check {k}: {c['value']} (limit {c['limit']})", file=sys.stderr)
    sys.stdout.flush()
    print(json.dumps(result), flush=True)
    return 0
