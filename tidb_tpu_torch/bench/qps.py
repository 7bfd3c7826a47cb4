"""Shared concurrent-QPS harness: N threads × N sessions against one DB.

Used by the headline bench (bench.py qps lanes) and the daily regression
lane (benchdaily qps_point_select) so the barrier/error-propagation
mechanics exist once.
"""

from __future__ import annotations

import threading
import time


def concurrent_qps(db, worker, n_threads: int, iters: int, setup=None) -> float:
    """Each thread gets its own session (optionally warmed by
    ``setup(session, thread_idx)``), all wait on a barrier, then run
    ``worker(session, thread_idx, iteration)`` ``iters`` times. Returns
    operations/second over the synchronized window — the serving-shape
    metric (many connections, shared store + plan state). The first
    worker-thread exception re-raises in the caller."""
    sessions = [db.session() for _ in range(n_threads)]
    if setup is not None:
        for i, s in enumerate(sessions):
            setup(s, i)
    barrier = threading.Barrier(n_threads + 1)
    errors: list = []

    def run(i, s):
        try:
            barrier.wait()
            for k in range(iters):
                worker(s, i, k)
        except Exception as e:  # surface thread failures, don't hang the bench
            errors.append(e)

    threads = [
        threading.Thread(target=run, args=(i, s), daemon=True, name=f"qps-w{i}")
        for i, s in enumerate(sessions)
    ]
    for t in threads:
        t.start()
    barrier.wait()
    t0 = time.perf_counter()
    for t in threads:
        t.join()
    dt = time.perf_counter() - t0
    if errors:
        raise errors[0]
    return (n_threads * iters) / dt if dt > 0 else float("inf")
