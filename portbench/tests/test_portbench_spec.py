"""BENCHMARK.json against the contract's rules, and the discovery of
every file it names by name."""
import json
import re

import pytest

from portbench import spec

BENCH = spec.load_benchmark()
WIDTH = re.compile(r"(_dim|_rank|_size|hidden|intermediate|latent|state|"
                   r"projection|head|expansion|per_tok)", re.I)


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert 1 <= BENCH["run_seconds"] <= 51
    assert len(json.dumps(BENCH)) <= 64 * 1024
    for p in BENCH["paths"]:
        assert re.fullmatch(r"[A-Za-z0-9_.\-/]{1,200}", p)
        assert not p.endswith("_torch") and not p.startswith("/")
    cmd = BENCH["command"]
    assert 1 <= len(cmd) <= 32
    for word in cmd:
        assert 1 <= len(word) <= 200 and "\n" not in word
        assert not word.startswith("/") and ".." not in word


@pytest.mark.parametrize("group", ["configs", "workloads", "end_to_end",
                                   "per_layer"])
def test_names_and_keys(group):
    keys = {"configs": {"name", "source", "file", "reduced", "why"},
            "workloads": {"name", "config", "traffic", "chips", "why"},
            "end_to_end": {"name", "unit", "better", "bound", "source"},
            "per_layer": {"name", "unit", "better", "source", "layer",
                          "moves"}}[group]
    names = [e["name"] for e in BENCH[group]]
    assert len(names) == len(set(names))
    for e in BENCH[group]:
        assert set(e) - {"workloads"} == keys, e["name"]
        assert spec.NAME.match(e["name"]), e["name"]
        for k in ("why", "layer"):
            if k in e:
                assert 1 <= len(e[k]) <= 200 and "\n" not in e[k]
                assert "\t" not in e[k]
        if group == "configs":
            assert 1 <= len(e["source"]) <= 200
        if "unit" in e:
            assert spec.UNIT.match(e["unit"]) and e["better"] in (
                "lower", "higher")


def test_configs_and_cells():
    cells = BENCH["workloads"]
    used = {c["config"] for c in cells}
    assert used == {c["name"] for c in BENCH["configs"]}
    pairs = [(c["config"], c["traffic"]) for c in cells]
    assert len(pairs) == len(set(pairs))
    assert sum(c["chips"] == 4 for c in cells) <= max(1, len(cells) // 4)
    for c in BENCH["configs"]:
        assert c["file"].startswith(BENCH["paths"][0] + "/")
        assert len(c["reduced"]) <= 16
        for k in c["reduced"]:
            assert spec.NAME.match(k) and not WIDTH.search(k), k
    for c in cells:
        assert c["chips"] in (1, 4) and spec.NAME.match(c["traffic"])
        assert 1 <= len(c["why"]) <= 200


def test_metrics_of_each_cell():
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in BENCH["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    for c in BENCH["workloads"]:
        ends = [m["name"] for m in spec.cell_metrics(BENCH, c["name"],
                                                     False)]
        assert "setup_s" in ends and len(ends) >= 2, c["name"]
        assert spec.cell_metrics(BENCH, c["name"], True), c["name"]
    for m in BENCH["per_layer"]:
        assert m["moves"] in e2e
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        for cell in m["workloads"]:
            reports = [x["name"] for x in spec.cell_metrics(BENCH, cell,
                                                            False)]
            assert m["moves"] in reports, (m["name"], cell)
        assert 1 <= len(m["layer"]) <= 200 and "\n" not in m["layer"]


@pytest.mark.parametrize("cell", [c["name"] for c in BENCH["workloads"]])
def test_discovery_by_name(cell):
    """A cell's configuration, mix, limits and metric readers are files
    found by the names in BENCHMARK.json."""
    c = spec.workload(BENCH, cell)
    cfg = spec.config(BENCH, c["config"])
    mix = spec.traffic(c["traffic"])
    assert cfg["name"] == c["config"]
    assert (spec.HERE / "drivers" / f"{mix['driver']}.py").exists()
    limits = json.loads((spec.HERE / "limits" / f"{cell}.json").read_text())
    assert limits
    for m in spec.cell_metrics(BENCH, cell, True):
        assert callable(spec.metric_reader(m["name"]))


GOOD = {"correct": True, "attempted": 400, "failed": 0,
        "metrics": {"acq_per_s": {"value": 212.4071, "unit": "rows/s"},
                    "setup_s": {"value": 9.3, "unit": "s"}},
        "device": {"platform": "gpu", "kind": "NVIDIA H100 80GB HBM3",
                   "count": 1, "memory_peak_bytes": 51203283968},
        "checks": {"value_gap": {"value": 1e-6, "limit": 1e-4}}}


def test_result_schema():
    assert spec.check_result(GOOD, False) == []
    bad = json.loads(json.dumps(GOOD))
    del bad["failed"]
    bad["metrics"]["bad name"] = {"value": 1.0, "unit": "tokens per s"}
    assert spec.check_result(bad, False)
    traced = json.loads(json.dumps(GOOD))
    assert spec.check_result(traced, True) == ["device lacks busy_s",
                                               "device lacks window_s"]
    traced["device"].update(busy_s=0.5, window_s=10.0)
    traced["breakdown"] = {"device_ops": [["k", 0.1]] * 10,
                           "idle_gaps": [["s > k", 0.2]]}
    assert spec.check_result(traced, True) == []


@pytest.mark.parametrize("name,ok", [("acq_per_s", True), ("a.b-c_9", True),
                                     ("has space", False), ("a,b", False),
                                     ("a/b", False), ("é", False),
                                     ("x" * 65, False)])
def test_name_rule(name, ok):
    assert bool(spec.NAME.match(name)) is ok


@pytest.mark.parametrize("unit,ok", [("tokens/s", True), ("%", True),
                                     ("ops/step", True), ("us", True),
                                     ("µs", False), ("a b", False),
                                     ("x" * 17, False)])
def test_unit_rule(unit, ok):
    assert bool(spec.UNIT.match(unit)) is ok
