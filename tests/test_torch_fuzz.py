"""graftfuzz on the port (``tidb_tpu_torch/tools/fuzz/``), held against the
reference's fuzzer and engines, on the CPU.

The generator, oracles, shrinker and harness are copies; ``runner.py`` is
a seam whose device session is ``gpu`` (an unknown engine name plans on
the host, so the reference's ``tpu`` session would hold host against
host), whose DBs open on the device the caller names, and whose mesh
width is the case's own over virtual shards. The tests: both packages
render the same cases; the port's ``gpu`` session answers the seed-42
cases as the reference's ``tpu`` session does; the seed-42 smoke campaign
is clean, deterministic and green through the CLI; the reference's corpus
replays on the port; and an off-by-one injected into the port's
``gpu_engine.execute_dag`` is found, shrunk and reproduced (which a
verbatim copy of ``runner.py`` cannot do: its device session never
reaches the gpu engine).
"""

import json
import os
import subprocess
import sys
import textwrap

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import chip_smoke  # noqa: E402
import tidb_tpu  # noqa: E402, F401  (jax's CPU mesh is configured by conftest before the fuzzer)
from tidb_tpu.tools.fuzz import gen as ref_gen  # noqa: E402
from tidb_tpu.tools.fuzz import runner as ref_runner  # noqa: E402
from tidb_tpu_torch.tools.fuzz import gen, harness, oracles, runner  # noqa: E402

SMOKE_SEED = 42
SMOKE_CASES = 300  # the reference's tier-1 lane, whole: ~20 s on the port's CPU path


def _case_text(spec):
    return (
        [t.create_sql() for t in spec.tables],
        {name: [gen.insert_sql(t, spec.rows.get(t.name, [])) for t in spec.tables if t.name == name] for name in spec.rows},
        [q.sql() for q in spec.queries],
        list(spec.dml),
        (spec.merge, spec.mpp, spec.ndev, spec.tlp_pred, spec.region_split_keys, spec.profile_key),
    )


@pytest.mark.parametrize("seed", [42, 7])
def test_gen_case_renders_the_references_sql(seed):
    for i in range(80):
        ref = ref_gen.gen_case(seed, i, n_queries=2, pool_size=6)
        port = gen.gen_case(seed, i, n_queries=2, pool_size=6)
        assert _case_text(port) == _case_text(ref), i


def _engines(ses, name):
    cs = ses.exec_summary
    return {} if cs is None else {("dev" if e == name else e): n for e, n in cs.engines.items()}


def test_gpu_session_answers_the_seed42_cases_as_the_references_tpu_session():
    """Cases 0-39 of seed 42 (case 39 is an MPP case), cold phase: every
    query's rows from the port's gpu session equal the reference's tpu
    session's under the differential oracle's canonical form, with the
    same cop tasks per engine."""
    ref_pool, port_pool = ref_runner.DBPool(), runner.DBPool()
    mpp_seen = 0
    with runner.on_device("cpu"):
        for i in range(40):
            spec = gen.gen_case(SMOKE_SEED, i, n_queries=2, pool_size=6)
            ref_spec = ref_gen.gen_case(SMOKE_SEED, i, n_queries=2, pool_size=6)
            mpp_seen += spec.mpp
            with ref_runner._delta_config(), ref_runner._forced_ndev(spec.mpp, spec.ndev):
                _db, ref_dev, _h, _w = ref_pool.sessions_for(ref_spec)
                ref_out = [(oracles.run_query(ref_dev, q.sql()), _engines(ref_dev, "tpu")) for q in ref_spec.queries]
            with runner._delta_config(), runner._forced_ndev(spec.mpp, spec.ndev):
                _db, dev, _h, _w = port_pool.sessions_for(spec)
                if not spec.mpp:
                    assert dev.vars["tidb_isolation_read_engines"] == "gpu"
                port_out = [(oracles.run_query(dev, q.sql()), _engines(dev, "gpu")) for q in spec.queries]
            for q, (got, got_eng), (want, want_eng) in zip(spec.queries, port_out, ref_out):
                fold, free = gen.ci_rep_positions(q, spec.tables)
                d = oracles.compare_differential(
                    q.sql(), bool(q.order_by), got, want, "differential", "cold",
                    ci_lax_positions=fold, ci_free_positions=free,
                )
                assert d is None, (i, d and d.detail)
                assert got_eng == want_eng, (i, q.sql())
    assert mpp_seen >= 1 and gen.gen_case(SMOKE_SEED, 39).mpp


def test_smoke_campaign_clean():
    runner.reset_tally()
    with runner.on_device("cpu"):
        res = harness.run_campaign(seed=SMOKE_SEED, cases=SMOKE_CASES, pool_size=6, do_shrink=True)
    assert res.errors == 0, f"harness errors: {res.errors}"
    assert res.findings == [], "divergences found:\n" + res.findings_json()
    assert res.checked == SMOKE_CASES
    tally = runner.TALLY
    assert not tally["degraded"] and tally["engines"]["gpu"] > 10 * tally["engines"].get("host", 0), tally
    assert tally["mpp_cases"] >= 1 and tally["gathers"] >= 1, tally


def test_campaign_deterministic():
    with runner.on_device("cpu"):
        a = harness.run_campaign(seed=7, cases=40, pool_size=6, do_shrink=True)
        b = harness.run_campaign(seed=7, cases=40, pool_size=6, do_shrink=True)
    assert a.findings_json() == b.findings_json()
    assert json.loads(a.findings_json())["campaign"]["cases"] == 40


def _python(body: str, timeout: int = 300):
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    return subprocess.run([sys.executable, "-c", body], capture_output=True, text=True, timeout=timeout, env=env, cwd=REPO)


def test_cli_entry_point():
    out = subprocess.run(
        [sys.executable, "-m", "tidb_tpu_torch.tools.fuzz", "--seed", "7", "--cases", "4", "--query-pool", "6",
         "--quiet", "--device", "cpu"],
        capture_output=True, text=True, timeout=300, cwd=REPO,
    )
    assert out.returncode == 0, out.stderr[-2000:]
    doc = json.loads(out.stdout)
    assert doc["campaign"] == {"cases": 4, "findings": 0, "harness_errors": 0, "seed": 7} and doc["findings"] == []
    line = next(ln for ln in out.stderr.splitlines() if ln.startswith("graftfuzz: device "))
    tally = json.loads(line[len("graftfuzz: device "):])
    assert tally["engines"].get("gpu", 0) > 0 and not tally["degraded"]


def test_cli_defaults_to_the_card():
    """With no ``--device`` the campaign opens its DBs on cuda: here, with
    no card, the device session's first statement raises where the host
    session answers, a divergence, and the CLI exits 1."""
    out = subprocess.run(
        [sys.executable, "-m", "tidb_tpu_torch.tools.fuzz", "--seed", "7", "--cases", "1", "--query-pool", "6", "--quiet"],
        capture_output=True, text=True, timeout=300, cwd=REPO,
    )
    assert out.returncode == 1
    finding = json.loads(out.stdout)["findings"][0]
    assert "device 'cuda' requested" in finding["detail"] and "host=ok" in finding["detail"]


CORPUS = chip_smoke.corpus_specs(REPO)


@pytest.mark.parametrize("name", sorted(CORPUS))
def test_reference_corpus_replays_on_the_port(name):
    with runner.on_device("cpu"):
        runner.run_repro(CORPUS[name])


def test_corpus_tlp_engine_names_the_device_session(monkeypatch):
    """A repro's TLP side ``tpu`` (the reference's name) or ``gpu`` runs in
    the gpu session, ``host`` in the host one."""
    seen = []
    real = runner.run_query

    def spy(ses, sql):
        seen.append(ses.vars["tidb_isolation_read_engines"])
        return real(ses, sql)

    monkeypatch.setattr(runner, "run_query", spy)
    base = dict(CORPUS["repro_s42_c20"])
    assert base["oracle"] == "tlp"
    with runner.on_device("cpu"):
        for side, want in (("tpu", "gpu"), ("gpu", "gpu"), ("host", "host")):
            seen.clear()
            runner.run_repro(dict(base, tlp_engine=side))
            assert set(seen) == {want}, (side, seen)


def test_device_session_reports_gpu_tasks():
    spec = gen.gen_case(SMOKE_SEED, 0, n_queries=2, pool_size=6)
    assert not spec.mpp
    with runner.on_device("cpu"):
        db = runner._build_db(spec)
        dev, host = runner._sessions(db, spec.mpp)
    name = spec.tables[0].name
    dev.query(f"SELECT COUNT(*) FROM {name}")
    assert dev.exec_summary.engines == {"gpu": 1} and not dev.exec_summary.degraded
    host.query(f"SELECT COUNT(*) FROM {name}")
    assert host.exec_summary.engines == {"host": 1}
    assert str(db.store.device) == "cpu"


def test_repro_template_replays_on_the_port():
    assert "from tidb_tpu_torch.tools.fuzz.runner import run_repro\n" in harness._REPRO_TEMPLATE
    assert "from tidb_tpu." not in harness._REPRO_TEMPLATE


def test_injected_parity_bug_found_shrunk_and_reproduced(tmp_path):
    """The reference's seeded mutation (``tests/test_fuzz_harness.py``) on
    the port's gpu engine: +1 on the first int64 lane of every gpu cop
    task. The campaign must find it, shrink it to at most 3 columns and 8
    rows, and emit a repro that fails under the bug and passes without."""
    out_dir = str(tmp_path / "fuzz_out")
    res = _python(
        chip_smoke.FUZZ_BUG
        + textwrap.dedent(
            f"""
            import sys
            from tidb_tpu_torch.tools.fuzz.__main__ import main
            sys.exit(main(["--seed", "5", "--cases", "4", "--query-pool", "6", "--out", {out_dir!r},
                           "--quiet", "--device", "cpu"]))
            """
        )
    )
    assert res.returncode == 1, f"campaign under the injected bug must find it:\n{res.stderr[-2000:]}"
    with open(os.path.join(out_dir, "findings.json"), encoding="utf-8") as f:
        doc = json.load(f)
    assert doc["findings"], "no findings emitted"
    finding = doc["findings"][0]
    assert finding["shrunk"]["columns"] <= 3, finding
    assert finding["shrunk"]["rows"] <= 8, finding
    assert finding["repro_verified"] is True, finding
    repro = os.path.join(out_dir, finding["repro"])
    with open(repro, encoding="utf-8") as f:
        assert "from tidb_tpu_torch.tools.fuzz.runner import run_repro" in f.read()
    replay = textwrap.dedent(
        f"""
        import runpy
        from tidb_tpu_torch.tools.fuzz import runner
        with runner.on_device("cpu"):
            runpy.run_path({repro!r}, run_name="__main__")
        """
    )
    res_bug = _python(chip_smoke.FUZZ_BUG + replay)
    assert res_bug.returncode != 0, "repro must FAIL while the bug is in place"
    assert "AssertionError" in res_bug.stderr
    res_ok = _python(replay)
    assert res_ok.returncode == 0, f"repro must pass on the healthy tree:\n{res_ok.stderr[-2000:]}"
