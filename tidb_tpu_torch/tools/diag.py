"""One-shot cluster diagnostic bundle (ref: the PingCAP clinic / ``tiup
diag`` idiom): ``python -m tidb_tpu.tools.diag --out DIR`` snapshots every
observability substrate into a directory of JSON files an operator can
attach to an incident — sys reports, metrics history, the structured event
log, inspection results, slow queries, and the effective config.

Determinism contract: for a FIXED process state, two ``write_bundle``
calls produce byte-identical files — every dump sorts its keys, volatile
per-sweep clocks (``ts``/``checked``/``uptime_s``/rates) and the sweep's
own duration histogram are stripped from cached health entries, and the
inspection pass runs with ``echo=False`` so evaluating the rules does not
itself grow the event log between runs. This holds with ``sweep=True``
too: the refresh sweep only moves state the bundle strips.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys

# per-entry wall clocks and instantaneous rates: true of a moment, not of
# the state — stripped so bundle bytes hash stably for a fixed fleet state
_VOLATILE_ENTRY = ("ts", "checked")
_VOLATILE_REPORT = ("uptime_s", "qps", "cop_qps")
# the sweep's own duration histogram: observing the fleet moves it, so a
# bundle that sweeps first would never hash equal to the next one
_VOLATILE_METRICS = ("tidb_tpu_cluster_snapshot_seconds",)


def _strip_health(reports: dict) -> dict:
    out = {}
    for inst, ent in reports.items():
        e = {k: v for k, v in ent.items() if k not in _VOLATILE_ENTRY}
        rep = e.get("report")
        if isinstance(rep, dict):
            rep = {k: v for k, v in rep.items() if k not in _VOLATILE_REPORT}
            mets = rep.get("metrics")
            if isinstance(mets, dict):
                rep["metrics"] = {
                    k: v for k, v in mets.items() if k not in _VOLATILE_METRICS
                }
            e["report"] = rep
        out[inst] = e
    return out


def collect(db, sweep: bool = True) -> dict:
    """→ {filename: JSON-able payload} for one bundle."""
    from tidb_tpu_torch import config as _config
    from tidb_tpu_torch.utils import eventlog as _evlog
    from tidb_tpu_torch.utils.inspection import inspect, rules_catalog
    from tidb_tpu_torch.utils.metricshist import recorder

    if sweep:
        db.health.sweep()
    return {
        "versions.json": {
            "version": "8.0.11-tidb-tpu",
            "git_hash": "tpu-native",
            "python": sys.version.split()[0],
        },
        "config.json": dataclasses.asdict(_config.current()),
        "sys_reports.json": _strip_health(db.health.reports()),
        "metrics_history.json": [
            {"name": n, "labels": lbl, "ts": t, "value": v}
            for n, lbl, t, v in recorder().series()
        ],
        "logs.json": [
            {"ts": ts, "level": _evlog.level_name(lv), "component": comp,
             "event": ev, "fields": fields, "trace_id": tid or ""}
            for ts, lv, comp, ev, fields, tid in _evlog.get().search(limit=None)
        ],
        "inspection.json": {
            "rules": [
                {"name": n, "type": t, "comment": c} for n, t, c in rules_catalog()
            ],
            "results": [
                {"rule": r, "item": i, "status": st, "value": v,
                 "reference": ref, "detail": d}
                for r, i, st, v, ref, d in inspect(db, echo=False)
            ],
        },
        "slow_queries.json": [e.to_pb() for e in db.stmt_summary.slow_queries()],
    }


def write_bundle(db, out_dir: str, sweep: bool = True) -> list:
    """Write the bundle under ``out_dir`` (created if missing) → sorted list
    of the file paths written."""
    os.makedirs(out_dir, exist_ok=True)
    paths = []
    for name, payload in sorted(collect(db, sweep=sweep).items()):
        path = os.path.join(out_dir, name)
        with open(path, "w") as f:
            f.write(json.dumps(payload, sort_keys=True, indent=2, default=str))
            f.write("\n")
        paths.append(path)
    return paths


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m tidb_tpu.tools.diag",
        description="Write a cluster diagnostic bundle.",
    )
    ap.add_argument("--out", required=True, help="bundle output directory")
    ap.add_argument("--config", default=None, help="TOML config file to load first")
    ap.add_argument(
        "--store", action="append", default=[], metavar="HOST:PORT",
        help="wire store server to diagnose (repeat for a sharded fleet); "
        "default: a fresh embedded store",
    )
    args = ap.parse_args(argv)
    from tidb_tpu_torch import config as _config

    if args.config:
        _config.set_current(_config.Config.from_toml(args.config))
    from tidb_tpu_torch.session.session import DB

    if args.store:
        from tidb_tpu_torch.kv.remote import RemoteStore
        from tidb_tpu_torch.kv.sharded import ShardedStore

        remotes = []
        for spec in args.store:
            host, _, port = spec.rpartition(":")
            remotes.append(RemoteStore(host or "127.0.0.1", int(port)))
        db = DB(store=remotes[0] if len(remotes) == 1 else ShardedStore(remotes))
    else:
        db = DB()
    paths = write_bundle(db, args.out)
    for p in paths:
        print(p)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
