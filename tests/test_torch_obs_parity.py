"""Each module of the port's observability plane against the JAX
package's on the same input: one seeded stream of spans, events,
counters, gauges and histograms (made with numpy from a seed) is fed to
both planes, and what each module makes of it must be equal — the Chrome
trace after export (ids and timestamps aside), the metrics snapshot and
its windows, the Prometheus text, the journal's rows and
`quality.replay` of them, the sidecar round trip, `merge` of the same
shards, `ut report` over one journal (markdown and HTML), the fault
schedules and the telemetry helpers.  Exact equality throughout: the
plane is host Python in both packages."""
import json

import numpy as np
import pytest

import uptune_tpu.obs as jobs
from uptune_tpu.obs import faults as jfaults
from uptune_tpu.obs import merge as jmerge
from uptune_tpu.obs import quality as jquality
from uptune_tpu.obs import report as jreport
from uptune_tpu.obs import ship as jship
from uptune_tpu.obs import sidecar as jsidecar

from uptune_tpu_torch import obs as tobs
from uptune_tpu_torch.obs import faults as tfaults
from uptune_tpu_torch.obs import merge as tmerge
from uptune_tpu_torch.obs import quality as tquality
from uptune_tpu_torch.obs import report as treport
from uptune_tpu_torch.obs import ship as tship
from uptune_tpu_torch.obs import sidecar as tsidecar

SEED = 11
LANES = ("worker-0", "worker-1", "store", None)


@pytest.fixture(autouse=True)
def clean():
    for plane in (jobs, tobs):
        plane.reset()
    yield
    for plane in (jobs, tobs):
        plane.journal.stop()
        plane.reset()


def stream(seed: int = SEED, n: int = 200) -> list:
    """A seeded sequence of (kind, args) plane calls with explicit
    timestamps, so both planes record the same thing."""
    rng = np.random.default_rng(seed)
    ops, t = [], 0.0
    for i in range(n):
        t += float(rng.uniform(0.0, 0.01))
        k = int(rng.integers(0, 6))
        name = ["ticket.propose", "pool.build", "store.serve_hit",
                "surrogate.fit", "ticket.finalize", "child.target"][k]
        lane = LANES[int(rng.integers(0, len(LANES)))]
        attrs = {"gid": i, "arm": ["de", "pso", "ga"][k % 3]}
        if k < 4:
            ops.append(("emit_at", (name, t,
                                    float(rng.uniform(0.0, 0.05)), lane,
                                    attrs)))
        else:
            ops.append(("emit_at", (name, t, None, lane, attrs)))
        ops.append(("count", (f"c.{name}", int(rng.integers(1, 4)))))
        ops.append(("gauge", (f"g.{k}", float(rng.normal()))))
        ops.append(("observe", (f"h.{k % 2}",
                                float(rng.lognormal(0.0, 1.0)))))
    return ops


def feed(plane, ops) -> None:
    plane.enable()
    for kind, args in ops:
        getattr(plane, kind)(*args)


def test_trace_export_equal_ids_and_times_aside():
    ops = stream()
    for plane in (jobs, tobs):
        feed(plane, ops)
    dj, dt = jobs.chrome_trace(), tobs.chrome_trace()
    tobs.validate_trace(dt)

    def shape(doc):
        lane = {(e["pid"], e["tid"]): e["args"]["name"]
                for e in doc["traceEvents"]
                if e["ph"] == "M" and e["name"] == "thread_name"}
        return [(e["ph"], e["name"], lane.get((e["pid"], e["tid"])),
                 e.get("args"), e.get("ts"), e.get("dur"))
                for e in doc["traceEvents"] if e["ph"] != "M"]
    assert shape(dj) == shape(dt) and len(shape(dt)) == 200
    other = lambda d: {k: v for k, v in d["otherData"].items()  # noqa: E731
                       if k not in ("origin_unix", "device_trace")}
    assert other(dj) == other(dt)
    assert jobs.text_summary() == tobs.text_summary()


def test_metrics_windows_and_prometheus_equal():
    ops = stream(SEED + 1)
    half = len(ops) // 2
    rows = {}
    for plane in (jobs, tobs):
        feed(plane, ops[:half])
        r1, cur = plane.window_snapshot(None)
        for kind, args in ops[half:]:
            getattr(plane, kind)(*args)
        r2, _ = plane.window_snapshot(cur)
        rows[plane] = [{k: v for k, v in r.items() if k not in ("t", "dt")}
                       for r in (r1, r2)]
    assert rows[jobs] == rows[tobs]
    assert jobs.metrics_snapshot() == tobs.metrics_snapshot()
    assert jobs.prometheus_text() == tobs.prometheus_text()


def journal_rows(seed: int = SEED, n: int = 120) -> list:
    """Seeded step / snapshot / store_hit rows with the surrogate's
    moments on half of the steps."""
    rng = np.random.default_rng(seed)
    rows, best = [], float("inf")
    for i in range(n):
        q = [round(float(v), 6) for v in rng.normal(5.0 - 0.03 * i, 1.0,
                                                    size=3)]
        nb = [False] * 3
        for j, v in enumerate(q):
            if v < best:
                best, nb[j] = v, True
        row = {"ev": "step", "step": i + 1,
               "arm": ["de", "pso", "ga"][i % 3], "evaluated": 3,
               "withdrawn": False, "new_best": any(nb),
               "best": round(best, 6), "evals": 3 * (i + 1),
               "pruned": 0, "hist_dropped": 0, "t_wait": 0.0,
               "snap_v": i // 10, "lag": 0, "src": "technique",
               "batch": 4, "trials": 3, "filtered": 0, "dup": 1,
               "gid0": 3 * i, "qors": q}
        if any(nb):
            row["nb"] = nb
        if i % 2:
            row["mus"] = [round(v + float(rng.normal(0.0, 0.3)), 6)
                          for v in q]
            row["sigmas"] = [round(float(rng.uniform(0.2, 1.0)), 6)] * 3
            row["pred_v"] = i // 10
        rows.append(row)
        if i % 10 == 9:
            rows.append({"ev": "snapshot", "version": i // 10 + 1,
                         "n_rows": 3 * (i + 1), "bucket": 64})
        if i % 17 == 0:
            rows.append({"ev": "store_hit", "gid": 3 * i, "qor": q[0],
                         "dur": 0.5})
    return rows


def write_journal(plane, path, rows) -> object:
    plane.enable()
    mon = plane.start_journal(path, meta={"seed": SEED})
    for row in rows:
        plane.journal.emit_row(dict(row))
    plane.stop_journal(mon)
    return mon


def test_journal_replay_and_report_equal(tmp_path):
    rows = journal_rows()
    pj, pt = str(tmp_path / "j.jsonl"), str(tmp_path / "t.jsonl")
    mj = write_journal(jobs, pj, rows)
    mt = write_journal(tobs, pt, rows)
    (hj, rj), (ht, rt) = (jobs.journal.read(pj, strict=True),
                          tobs.journal.read(pt, strict=True))
    drop = lambda rs: [{k: v for k, v in r.items() if k != "t"}  # noqa
                       for r in rs]
    assert drop(rj) == drop(rt) == [{**r} for r in rows]
    assert {k: v for k, v in hj.items() if k not in ("origin_unix", "pid")} \
        == {k: v for k, v in ht.items() if k not in ("origin_unix", "pid")}
    assert mj.gauges == mt.gauges and mj.alerts == mt.alerts
    # replay of one journal file through both packages
    qj, qt = jquality.replay(rj), tquality.replay(rj)
    assert qj.gauges == qt.gauges and qj.alerts == qt.alerts
    assert qt.gauges["search.cal_rows"] > 0
    # `ut report` over one journal, both forms
    assert jreport.render(pj, fmt="md") == treport.render(pj, fmt="md")
    assert jreport.render(pj) == treport.render(pj)


def test_sidecar_round_trip_and_merge_equal(tmp_path):
    ops = stream(SEED + 2, 60)
    shards = {}
    for plane, sc in ((jobs, jsidecar), (tobs, tsidecar)):
        feed(plane, ops)
        path = str(tmp_path / f"{plane.__name__}.sidecar.jsonl")
        sc.dump(path)
        shards[plane] = path
    hj, ej = jsidecar.read(shards[jobs])
    ht, et = tsidecar.read(shards[tobs])
    # the dump closes a `child.run` span at the time it is taken
    timed = [e for e in ej + et if e["name"] == "child.run"]
    assert len(timed) == 2
    assert [e for e in ej if e["name"] != "child.run"] == \
        [e for e in et if e["name"] != "child.run"]
    assert hj.keys() == ht.keys()
    # merge: the same sidecar shards and one driver trace through each
    driver = str(tmp_path / "driver.json")
    json.dump(jobs.chrome_trace(extra={"process": "ut-driver"}),
              open(driver, "w"))
    paths = [driver, shards[jobs]]
    mj = jmerge.merge_files(paths, out=str(tmp_path / "mj.json"))
    mt = tmerge.merge_files(paths, out=str(tmp_path / "mt.json"))
    tobs.validate_trace(mt)
    assert mj == mt
    assert tmerge.main(["validate", str(tmp_path / "mj.json")]) == 0


def test_fault_schedules_and_telemetry_helpers_equal():
    spec = "store.record=error@2,pool.reap=delay@1:0.0,wire.read=error%3"
    assert list(jfaults.parse_spec(spec)) == list(tfaults.parse_spec(spec))
    hits = {}
    for fm in (jfaults, tfaults):
        assert fm.maybe_arm_from_env({"UT_FAULTS": spec}) == 3
        raised = []
        for i in range(5):
            for point in ("store.record", "pool.reap", "wire.read"):
                try:
                    fm.fire(point)
                except fm.FaultInjected:
                    raised.append((i, point))
        hits[fm] = (raised, fm.hits(), fm.schedules())
        fm.disarm()
    assert hits[jfaults] == hits[tfaults]
    for tok in (None, "", "off", "none", "0", "host:1"):
        assert jship.disabled_token(tok) == tship.disabled_token(tok)
    src = {"host": "h", "pid": 7, "role": "ut-driver"}
    assert jship.source_label(src) == tship.source_label(src)
