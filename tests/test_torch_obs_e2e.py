"""The port's observability plane wired into its driver, manager, pool,
controller, store and child side, on the CPU: the counterparts of the
reference's driver-journal, structural and subprocess cases
(tests/test_quality.py, test_obs.py, test_obs_distributed.py), a traced
program-mode run whose journal equals the JAX run's in lockstep, the CLI
with --trace / --journal / `report`, and the plane's import weight in a
child."""
import json
import os
import subprocess
import sys
import textwrap

import pytest

import uptune_tpu.obs as jobs
from uptune_tpu.driver.plugins import SearchHook as JHook
from uptune_tpu.exec import ProgramTuner as JPT
from uptune_tpu.exec import space_io as jio

import uptune_tpu_torch
from uptune_tpu_torch import obs
from uptune_tpu_torch.driver.plugins import SearchHook as THook
from uptune_tpu_torch.exec import ProgramTuner as TPT
from uptune_tpu_torch.exec import space_io as tio
from uptune_tpu_torch.obs import journal, quality, report, sidecar

from test_torch_driver import Replay, _recorder
from test_torch_driver import untraced_planes  # noqa: F401 (autouse)
from test_torch_exec import MIXED_PROG, _write

REPO = os.path.dirname(os.path.dirname(os.path.abspath(
    uptune_tpu_torch.__file__)))
ENV = {"PYTHONPATH": REPO}
QUAD_PROG = textwrap.dedent("""
    import uptune_tpu_torch as ut
    x = ut.tune(50, (0, 100), name="x")
    y = ut.tune(50, (0, 100), name="y")
    ut.feature(x % 7, "bucket")
    ut.interm([float(x), float(y)])
    ut.target(float((x - 37) ** 2 + (y - 11) ** 2), "min")
""")


@pytest.fixture(autouse=True)
def clean():
    obs.reset()
    yield
    journal.stop()
    obs.reset()


def _overlaps(a, b):
    return a["ts"] < b["ts"] + b["dur"] and b["ts"] < a["ts"] + a["dur"]


def test_importing_the_plane_loads_neither_torch_nor_numpy():
    """A tuned program's child imports `obs` (through api/state.py): a
    fresh interpreter that imports the plane, and the child protocol
    module, holds neither torch nor numpy."""
    code = ("import sys, uptune_tpu_torch.obs, uptune_tpu_torch.api.state;"
            "print(sorted(m for m in ('torch', 'numpy', 'jax')"
            " if m in sys.modules))")
    out = subprocess.run([sys.executable, "-c", code], env={
        **os.environ, **ENV}, capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


@pytest.fixture(scope="module")
def driver_journal(tmp_path_factory):
    """One journaled tune of the port's Tuner: rosenbrock-2d, a sync GP
    surrogate, obs and the journal on (the reference's fixture)."""
    from uptune_tpu_torch import Tuner
    from uptune_tpu_torch.workloads import (rosenbrock_objective,
                                            rosenbrock_space)
    p = str(tmp_path_factory.mktemp("journal") / "run.journal.jsonl")
    obs.reset()
    obs.enable()
    mon = obs.start_journal(p, meta={"test": "driver_journal"})
    t = Tuner(rosenbrock_space(2, -2.048, 2.048),
              rosenbrock_objective(2, device="cpu"), seed=0,
              surrogate="gp", device="cpu",
              surrogate_opts=dict(min_points=8, refit_interval=16,
                                  max_points=64, async_refit=False))
    t.run(test_limit=60)
    t.close()
    journal.flush()
    obs.stop_journal(mon)
    out = {"path": p, "online": dict(mon.gauges),
           "alerts": list(mon.alerts),
           "metrics_gauges": obs.metrics_snapshot()["gauges"],
           "events": obs.snapshot()["events"]}
    obs.reset()
    return out


def test_online_gauges_match_offline_replay(driver_journal):
    _, rows = journal.read(driver_journal["path"], strict=True)
    replayed = quality.replay(rows)
    assert replayed.gauges == driver_journal["online"]
    pub = {k: v for k, v in driver_journal["metrics_gauges"].items()
           if k.startswith("search.")}
    assert pub and pub == {k: v for k, v in replayed.gauges.items()
                           if k in pub}


def test_row_schema_and_calibration_join(driver_journal):
    """Step rows with the pull verdicts and, once the GP is fitted, the
    manager's moments (`predict_cands`); snapshot rows from the
    manager's publishes."""
    _, rows = journal.read(driver_journal["path"], strict=True)
    assert {"step", "snapshot"} <= {r["ev"] for r in rows}
    steps = [r for r in rows if r["ev"] == "step"]
    evaluated = [r for r in steps if r.get("qors")]
    assert evaluated and all(("gid0" in r) != ("gids" in r)
                             for r in evaluated)
    joined = [r for r in evaluated if "mus" in r]
    assert joined and all(
        len(r["mus"]) == len(r["sigmas"]) == len(r["qors"])
        and "pred_v" in r for r in joined)
    pulls = [r for r in steps if "batch" in r]
    assert pulls and all(
        r["src"] in ("technique", "surrogate", "injected", "random")
        for r in pulls)
    assert driver_journal["alerts"] == []
    names = {e["name"] for e in driver_journal["events"]}
    assert {"ticket.propose", "ticket.dedup", "ticket.commit",
            "ticket.observe", "ticket.finalize", "surrogate.tick",
            "surrogate.fit", "surrogate.publish"} <= names


def test_report_renders_from_live_journal(driver_journal, tmp_path):
    html = report.render(driver_journal["path"])
    assert "<svg" in html and "Calibration reliability" in html
    assert "## Arm attribution" in report.render(driver_journal["path"],
                                                 fmt="md")
    out = str(tmp_path / "r.html")
    assert report.main([driver_journal["path"], "-o", out]) == 0
    assert os.path.getsize(out) > 1000


def test_refit_spans_overlap_dispatch():
    """A traced async tune shows the overlap the async surrogate plane
    claims: a background surrogate.fit span on the refit worker's lane
    intersecting driver-lane ticket spans."""
    from uptune_tpu_torch import Tuner
    from uptune_tpu_torch.workloads import (rosenbrock_objective,
                                            rosenbrock_space)
    obs.enable()
    objective = rosenbrock_objective(2, device="cpu")
    tuner = Tuner(rosenbrock_space(2, -2.048, 2.048), None, seed=0,
                  device="cpu", surrogate="gp",
                  surrogate_opts={"min_points": 8, "refit_interval": 8,
                                  "max_points": 64, "async_refit": True})
    done = 0
    while done < 48:
        for tr in tuner.ask(min_trials=1):
            tuner.tell(tr, float(objective([tr.config])[0]))
            done += 1
    tuner.close()
    evs = obs.snapshot()["events"]
    fits = [e for e in evs if e["name"] == "surrogate.fit"
            and (e["attrs"] or {}).get("background")]
    assert fits and all(e["track"] != "MainThread" for e in fits)
    driver = [e for e in evs if e["track"] == "MainThread"
              and e["dur"] is not None and e["name"].startswith("ticket.")]
    assert any(_overlaps(f, d) for f in fits for d in driver)


def _program_tuner(d, limit, **kw):
    return TPT([sys.executable, _write(d, QUAD_PROG)], d, parallel=1,
               prefetch=0, test_limit=limit, seed=0, env=ENV,
               runtime_limit=30.0, device="cpu", **kw)


def test_store_hits_bypass_build_lane_and_children_merge(tmp_path):
    """Run 1 fills the store untraced; run 2, traced and journaled,
    serves its replayed prefix from the store (`store` lane) and builds
    the novel configurations on worker-0, whose lane also carries the
    children's own spans from their sidecars; the journal holds the
    store hits and the children's `ut.feature` / `ut.interm` rows."""
    d = str(tmp_path)
    _program_tuner(d, 5).run()
    obs.enable()
    p = str(tmp_path / "j.jsonl")
    journal.start(p)
    pt = _program_tuner(d, 10)
    pt.run()
    journal.stop()
    assert pt.store_hits > 0 and pt.pool.launched > 0
    evs = obs.snapshot()["events"]
    served = {(e["attrs"] or {}).get("gid") for e in evs
              if e["name"] == "store.serve_hit"}
    builds = {(e["attrs"] or {}).get("gid"): e for e in evs
              if e["name"] == "pool.build"}
    assert served and builds and not served & set(builds)
    assert all(e["track"] == "store" for e in evs
               if e["name"] == "store.serve_hit")
    assert len(served) == pt.store_hits and len(builds) == pt.pool.launched
    child = [e for e in evs if e["name"].startswith("child.")]
    assert {e["track"] for e in child} == {"worker-0"}
    assert {"child.run", "child.target", "child.load_proposal",
            "child.feature", "child.interm"} <= {e["name"] for e in child}
    for e in child:
        b = builds[(e["attrs"] or {}).get("gid")]
        assert b["ts"] - 0.1 <= e["ts"] <= b["ts"] + b["dur"] + 0.1
    assert not list((tmp_path / "ut.temp").glob(
        "temp.*/" + sidecar.SIDECAR_FILE))
    counters = obs.metrics_snapshot()["counters"]
    assert counters["pool.sidecar_events"] >= 3
    assert counters["store.hits"] == pt.store_hits
    _, rows = journal.read(p, strict=True)
    kinds = [r["ev"] for r in rows]
    assert kinds.count("store_hit") == pt.store_hits
    assert kinds.count("feature") == kinds.count("interm") \
        == pt.pool.launched
    assert all(r["covars"]["bucket"] == r["covars"]["bucket"] % 7
               for r in rows if r["ev"] == "feature")


def _strip_times(rows):
    """Journal rows without what measures time: the timestamps, the
    ticket's wait and the trials' durations."""
    return [{k: v for k, v in r.items() if k not in ("t", "t_wait", "durs")}
            for r in rows]


def test_traced_program_mode_journal_equals_jax(tmp_path):
    """The program-mode lockstep of tests/test_torch_exec.py (one worker,
    no prefetch, JAX's draws replayed into the port's Tuner), each
    package tracing and journaling itself: the journals' rows are equal,
    timestamps aside, and both traces validate with the children's
    spans on worker-0."""
    limit = 30
    dj, dt = str(tmp_path / "jax"), str(tmp_path / "port")
    kw = dict(parallel=1, prefetch=0, env=ENV, runtime_limit=30.0,
              test_limit=limit, seed=3, store_dir="off")
    pj = JPT([sys.executable, _write(dj, MIXED_PROG)], dj,
             hooks=[_recorder(JHook)(False)], compile_cache_dir="off", **kw)
    pt = TPT([sys.executable, _write(dt, MIXED_PROG)], dt,
             hooks=[_recorder(THook)(True)], device="cpu", **kw)
    pj.analyze()
    pt.analyze()
    jt = pj._make_tuner(jio.space_from_params(pj.params[0]))
    tt = pt._make_tuner(tio.space_from_params(pt.params[0]))
    rep = Replay(jt, tt)
    pj._make_tuner = lambda space: jt
    pt._make_tuner = lambda space: tt
    paths = {}
    try:
        for plane, run, d in ((jobs, pj.run, dj), (obs, pt.run, dt)):
            plane.reset()
            plane.enable()
            paths[d] = os.path.join(d, "run.journal.jsonl")
            mon = plane.start_journal(paths[d])
            run()
            plane.stop_journal(mon)
            plane.validate_trace(plane.chrome_trace())
            lanes = {e["track"] for e in plane.snapshot()["events"]
                     if e["name"].startswith("child.")}
            assert lanes == {"worker-0"}
    finally:
        jobs.journal.stop()
        jobs.reset()
    assert rep.drained()
    _, rows_j = jobs.journal.read(paths[dj], strict=True)
    _, rows_t = journal.read(paths[dt], strict=True)
    steps = [r for r in rows_t if r["ev"] == "step"]
    assert sum(r["evaluated"] for r in steps) == limit
    assert _strip_times(rows_t) == _strip_times(rows_j)


def test_cli_traced_journaled_run_and_report(tmp_path):
    """`ut-torch prog.py --trace --journal` writes a valid trace with its
    metrics timeline and a journal; `ut-torch report` renders it."""
    d = str(tmp_path)
    _write(d, QUAD_PROG)
    env = {**os.environ, **ENV}
    env.pop("UT_TRACE_GUARD", None)
    run = subprocess.run(
        [sys.executable, "-m", "uptune_tpu_torch.cli", "prog.py",
         "--test-limit", "8", "-pf", "2", "--device", "cpu", "--store",
         "off", "--trace", "t.json", "--journal", "j.jsonl",
         "--metrics-interval", "0.2"], cwd=d, env=env, capture_output=True,
        text=True, timeout=300)
    assert run.returncode == 0, run.stdout + run.stderr
    doc = json.load(open(os.path.join(d, "t.json")))
    obs.validate_trace(doc)
    names = {e.get("name") for e in doc["traceEvents"]}
    assert {"pool.build", "ticket.propose", "ticket.commit",
            "child.target"} <= names
    rows = [json.loads(ln) for ln in open(os.path.join(d,
                                                       "t.json.metrics.jsonl"))]
    assert rows and rows[-1]["final"] is True
    _, jrows = journal.read(os.path.join(d, "j.jsonl"), strict=True)
    assert sum(r.get("evaluated", 0) for r in jrows
               if r["ev"] == "step") >= 8
    out = subprocess.run(
        [sys.executable, "-m", "uptune_tpu_torch.cli", "report",
         os.path.join(d, "j.jsonl"), "--format", "md", "-o", "-"],
        env=env, capture_output=True, text=True, timeout=120)
    assert out.returncode == 0 and "## Arm attribution" in out.stdout
