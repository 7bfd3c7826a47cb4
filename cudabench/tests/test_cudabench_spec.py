"""BENCHMARK.json, the configuration, traffic and metric files: found by
name, within the benchmark's contract, and a metric added as a file."""

import json
import re
import shutil

import pytest
import rehearsal

from cudabench import harness, qgen, records

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")


def test_benchmark_json_keeps_to_the_contract():
    b = rehearsal.bench()
    assert set(b) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
    assert b["paths"] == ["cudabench"] and len(b["command"]) <= 32
    assert isinstance(b["run_seconds"], int) and 1 <= b["run_seconds"] <= 51
    names = [c["name"] for c in b["configs"]] + [w["name"] for w in b["workloads"]]
    metrics = b["end_to_end"] + b["per_layer"]
    names += [m["name"] for m in metrics]
    assert len(names) == len(set(names)) and all(NAME.match(n) for n in names)
    assert all(UNIT.match(m["unit"]) and m["better"] in ("lower", "higher") for m in metrics)
    e2e = {m["name"]: m for m in b["end_to_end"]}
    assert "setup_s" in e2e and all(0.01 <= m["bound"] <= 0.25 for m in e2e.values())
    assert all(m["source"] in ("host_clock", "device_trace") for m in e2e.values())
    cells = {w["name"] for w in b["workloads"]}
    for m in b["per_layer"]:
        assert m["moves"] in e2e and set(m.get("workloads", cells)) <= cells and "\n" not in m["layer"]
        for w in m.get("workloads", cells):
            assert w in e2e[m["moves"]].get("workloads", cells)
    for c in b["configs"]:
        assert c["file"].startswith("cudabench/") and len(c["reduced"]) <= 16
    assert len(json.dumps(b)) < 64 * 1024


@pytest.mark.parametrize("cell", [w["name"] for w in rehearsal.bench()["workloads"]])
def test_each_cell_is_found_by_name(cell):
    entry, config, traffic, e2e, per_layer = harness.cell_spec(rehearsal.bench(), cell)
    assert config["name"] == entry["config"] == traffic["config"]
    assert {"setup_s"} <= {m["name"] for m in e2e} and len(e2e) >= 2 and per_layer
    for m in e2e + per_layer:
        assert callable(records.reader(m["name"]))
    stmts = harness.statements(traffic)
    assert stmts and all("{" not in sql for _t, sql in stmts)
    for tpl in {t for t, _s in stmts}:
        __import__(f"cudabench.reference.{tpl}")


@pytest.mark.parametrize("cell", [w["name"] for w in rehearsal.bench()["workloads"]])
def test_traffic_files_hold_only_keys_the_harness_reads(cell):
    traffic = harness.cell_spec(rehearsal.bench(), cell)[2]
    assert set(traffic) <= {"config", "clients", "control", "why", "explain", "templates", "draw", "statements"}
    assert isinstance(traffic["clients"], int) and traffic["clients"] >= 1
    assert traffic["control"] in ("float64", "float32")


@pytest.mark.parametrize("cell", [w["name"] for w in rehearsal.bench()["workloads"]])
def test_statement_lists_are_the_qgen_draws_the_files_state(cell):
    traffic = harness.cell_spec(rehearsal.bench(), cell)[2]
    assert traffic["statements"] == qgen.draw(traffic["draw"])


def test_every_metric_file_has_an_entry_and_every_entry_a_file():
    b = rehearsal.bench()
    assert set(records.available()) == {m["name"] for m in b["end_to_end"] + b["per_layer"]}


def test_a_metric_dropped_into_metrics_is_picked_up_with_no_edit(tmp_path, monkeypatch):
    shutil.copytree(records.METRICS_DIR, tmp_path / "metrics")
    (tmp_path / "metrics" / "stmt.count_in_window.py").write_text(
        "def read(run):\n    return float(len(run.done()))\n")
    monkeypatch.setattr(records, "METRICS_DIR", tmp_path / "metrics")
    assert "stmt.count_in_window" in records.available()
    spec = rehearsal.bench()
    spec["per_layer"].append({"name": "stmt.count_in_window", "unit": "stmt", "better": "higher",
                              "source": "host_clock", "layer": "SQL front", "moves": "stmt_per_s",
                              "workloads": ["lineitem.agg"]})
    res = rehearsal.run("lineitem.agg", trace=True, bench_spec=spec)
    assert res["correct"], res["checks"]
    got = res["metrics"]["stmt.count_in_window"]
    assert got["unit"] == "stmt" and got["value"] >= 1
