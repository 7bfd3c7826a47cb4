"""benchdb: workload micro-benchmark CLI (ref: cmd/benchdb/main.go:58 —
the same run-spec grammar: a comma-separated list of jobs, e.g.
``create,insert:10000,update-random:1000,select:100,query:20,gc``).

Usage:
    python -m tidb_tpu_torch.bench.benchdb --run create,insert:10000,select:100
    python -m tidb_tpu_torch.bench.benchdb --device cpu --run create,insert:100

The database opens on ``--device`` (default ``cuda``: with no card the
first device task raises).
"""

from __future__ import annotations

import argparse
import json
import time

TABLE = "bench_db"


def _split(job: str) -> tuple[str, int]:
    name, _, n = job.partition(":")
    return name, int(n) if n else 0


def run_jobs(db, spec: str, blob_size: int = 32) -> list[dict]:
    """Execute the job list; returns per-job timing records."""
    s = db.session()
    out = []
    payload = "x" * blob_size
    n_rows = [0]

    def insert(n):
        batch = 1000
        done = 0
        while done < n:
            m = min(batch, n - done)
            vals = ",".join(
                f"({n_rows[0] + i}, {(n_rows[0] + i) * 3}, '{payload}')" for i in range(m)
            )
            s.execute(f"INSERT INTO {TABLE} VALUES {vals}")
            n_rows[0] += m
            done += m

    def update_random(n):
        import random

        for _ in range(n):
            k = random.randrange(max(n_rows[0], 1))
            s.execute(f"UPDATE {TABLE} SET v = v + 1 WHERE id = {k}")

    def select_point(n):
        for i in range(n):
            s.query(f"SELECT * FROM {TABLE} WHERE id = {i % max(n_rows[0], 1)}")

    def query_agg(n):
        for _ in range(n):
            s.query(f"SELECT COUNT(*), SUM(v) FROM {TABLE}")

    def delete(n):
        s.execute(f"DELETE FROM {TABLE} WHERE id < {n}")

    jobs = {
        "create": lambda n: (
            s.execute(f"DROP TABLE IF EXISTS {TABLE}"),
            s.execute(f"CREATE TABLE {TABLE} (id BIGINT PRIMARY KEY, v BIGINT, pad VARCHAR(255))"),
        ),
        "truncate": lambda n: s.execute(f"TRUNCATE TABLE {TABLE}"),
        "insert": insert,
        "update-random": update_random,
        "select": select_point,
        "query": query_agg,
        "delete": delete,
        "gc": lambda n: db.run_gc(),
        "analyze": lambda n: s.execute(f"ANALYZE TABLE {TABLE}"),
    }
    for job in spec.split(","):
        name, n = _split(job.strip())
        if name not in jobs:
            raise SystemExit(f"unknown job {name!r} (have: {', '.join(jobs)})")
        t0 = time.perf_counter()
        jobs[name](n)
        dt = time.perf_counter() - t0
        rec = {"job": job.strip(), "seconds": round(dt, 4)}
        if n:
            rec["ops_per_sec"] = round(n / dt) if dt > 0 else None
        out.append(rec)
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description="tidb_tpu workload bench (benchdb analog)")
    ap.add_argument("--run", default="create,insert:10000,update-random:1000,select:1000,query:100")
    ap.add_argument("--blob", type=int, default=32, help="pad column size")
    ap.add_argument("--json", action="store_true", help="emit JSON records")
    ap.add_argument("--device", default="cuda", help="the database's device: cuda (default) or cpu")
    args = ap.parse_args(argv)

    import tidb_tpu_torch

    db = tidb_tpu_torch.open(device=args.device)
    recs = run_jobs(db, args.run, args.blob)
    if args.json:
        print(json.dumps(recs))
    else:
        for r in recs:
            ops = f"  {r['ops_per_sec']} ops/s" if r.get("ops_per_sec") else ""
            print(f"{r['job']:<24} {r['seconds']:>9.4f}s{ops}")


if __name__ == "__main__":
    main()
