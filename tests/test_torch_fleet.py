"""The port's fleet telemetry held to the reference's own contracts, on the
CPU: every test body of tests/test_fleet.py runs here with the reference
module's names (`obs`, `flight`, `ship`, `top`, `hub_mod`,
`TelemetryHub`, `fleet_rollup`, `RequestError`, `WireServer`) and the JAX
package's modules those bodies import pointed at the port's hub,
shipper, flight recorder, top, report and session server (test_torch_
serve's `point_at_port`); the reference's `_EchoServer` is rebuilt on the
port's `WireServer`.

Beside them, the two packages against each other: both hubs fed the same
ship requests answer every op alike, and `top` renders the same text and
the same `--json` frame from the same scrape under either package (a
session server's, a hub's fleet rollup, a device panel, missing
families, a multi-file fleet).
"""
import inspect
import json
import sys
import time
import types

import pytest

import test_fleet as ref_fleet
from uptune_tpu.obs import hub as jhub
from uptune_tpu.obs import top as jtop

from uptune_tpu_torch import obs as tobs
from uptune_tpu_torch.obs import flight as tflight
from uptune_tpu_torch.obs import hub as thub
from uptune_tpu_torch.obs import journal as tjournal
from uptune_tpu_torch.obs import metrics as tmetrics
from uptune_tpu_torch.obs import report as treport
from uptune_tpu_torch.obs import ship as tship
from uptune_tpu_torch.obs import top as ttop
from uptune_tpu_torch.serve import wire as twire

from test_torch_driver import untraced
from test_torch_serve import cases, point_at_port, run_case


class EchoServer(twire.WireServer):
    """The reference's `_EchoServer` (tests/test_fleet.py) on the port's
    wire kernel: its op methods, table and connection hooks as they
    are."""

    WIRE_NAME = ref_fleet._EchoServer.WIRE_NAME
    _op_echo = ref_fleet._EchoServer._op_echo
    _op_boom = ref_fleet._EchoServer._op_boom
    _op_bad = ref_fleet._EchoServer._op_bad
    _OPS = ref_fleet._EchoServer._OPS
    _conn_opened = ref_fleet._EchoServer._conn_opened
    _on_response = ref_fleet._EchoServer._on_response
    _conn_closed = ref_fleet._EchoServer._conn_closed

    def __init__(self):
        twire.WireServer.__init__(self, "127.0.0.1", 0)
        self.reaped = []


@pytest.fixture(scope="module", autouse=True)
def untraced_module():
    with untraced():
        yield


@pytest.fixture
def port_fleet(monkeypatch):
    point_at_port(monkeypatch, [ref_fleet], {
        "obs": tobs, "flight": tflight, "ship": tship, "top": ttop,
        "hub_mod": thub, "TelemetryHub": thub.TelemetryHub,
        "fleet_rollup": thub.fleet_rollup, "_EchoServer": EchoServer})
    for name, mod in (("uptune_tpu.obs.top", ttop),
                      ("uptune_tpu.obs.hub", thub),
                      ("uptune_tpu.obs.flight", tflight),
                      ("uptune_tpu.obs.ship", tship),
                      ("uptune_tpu.obs.metrics", tmetrics),
                      ("uptune_tpu.obs.journal", tjournal),
                      ("uptune_tpu.obs.report", treport)):
        monkeypatch.setitem(sys.modules, name, mod)
    tobs.reset()
    yield
    tship.stop()
    tobs.reset()


FLEET_CLASSES = ("TestWireKernel", "TestShipper", "TestFleetRollup",
                 "TestHubOps", "TestHubConcurrency", "TestFlightRotateDepth",
                 "TestTopFleet", "TestServeHealthLimit",
                 "TestReportMultiSource")
# reference cases with no counterpart here, and why
FLEET_LEFT_OUT = {
    # it runs bench.py --fleet, and bench.py is not ported
    "TestFleetBenchSmoke": "bench.py is the JAX package's",
}
FLEET_CASES = cases(ref_fleet, FLEET_CLASSES)


@pytest.mark.parametrize("cls,name", FLEET_CASES,
                         ids=[f"{c}::{n}" for c, n in FLEET_CASES])
def test_reference_fleet_contract(port_fleet, cls, name, request):
    run_case(getattr(ref_fleet, cls), name, request)


def test_the_cases_cover_every_reference_fleet_test():
    """Every class of tests/test_fleet.py runs here whole, but those
    listed with their reason."""
    classes = {c for c, k in inspect.getmembers(ref_fleet, inspect.isclass)
               if c.startswith("Test") and k.__module__ == "test_fleet"}
    assert classes == set(FLEET_CLASSES) | set(FLEET_LEFT_OUT)


def test_hub_surface_equals_the_reference():
    assert thub.__all__ == jhub.__all__
    assert thub.HEADLINE_RATE_KEYS == jhub.HEADLINE_RATE_KEYS
    assert sorted(thub.TelemetryHub._OPS) == sorted(jhub.TelemetryHub._OPS)
    assert ttop.__all__ == jtop.__all__


# -- the two packages against each other --------------------------------------------
def _ship(role, rows, pid=1, dropped=None):
    req = {"op": "ship", "source": {"host": "hx", "pid": pid, "role": role},
           "rows": rows}
    if dropped is not None:
        req["dropped"] = dropped
    return req


def _window(t, counters, gauges=None, hists=None, deltas=None, final=False):
    row = {"t": t, "dt": 2.0, "counters": counters,
           "deltas": deltas if deltas is not None else dict(counters),
           "gauges": gauges or {}, "hists": hists or {}}
    if final:
        row["final"] = True
    return {"kind": "window", "row": row}


SHIPS = [
    _ship("ut-serve", [_window(10.0, {"serve.asks": 40, "serve.commits": 3},
                               {"serve.sessions.active": 4,
                                "serve.batch_fill": 0.5},
                               {"serve.ask_ms": {"count": 40, "sum": 12.0,
                                                 "window_count": 40,
                                                 "window_sum": 12.0,
                                                 "p50": 0.2, "p95": 0.9}})],
          pid=11),
    _ship("ut-serve", [_window(11.0, {"serve.asks": 100, "serve.commits": 5},
                               {"serve.sessions.active": 6,
                                "serve.batch_fill": 0.75},
                               {"serve.ask_ms": {"count": 100, "sum": 40.0,
                                                 "window_count": 60,
                                                 "window_sum": 28.0,
                                                 "p50": 0.3, "p95": 1.4}})],
          pid=12, dropped=2),
    _ship("ut-driver", [{"kind": "journal", "row": {"ev": "step"}},
                        {"kind": "alert", "row": {"kind": "stall"}},
                        _window(12.0, {"driver.asks": 7}, final=True)],
          pid=13),
    _ship("ut-serve", [{"kind": "health",
                        "row": {"sessions": 3,
                                "by_status": {"failing": 1, "ok": 2}}}],
          pid=11),
]
# reply and timeline fields that read the clock
CLOCK = {"uptime_s", "age_s", "u"}


def _strip(x):
    if isinstance(x, dict):
        return {k: _strip(v) for k, v in x.items() if k not in CLOCK}
    if isinstance(x, list):
        return [_strip(v) for v in x]
    return x


@pytest.mark.parametrize("op", [{"op": "metrics"}, {"op": "sources"},
                                {"op": "health"}, {"op": "health",
                                                   "limit": 2},
                                {"op": "health", "limit": 0},
                                {"op": "ship", "rows": "x",
                                 "source": {"host": "h", "pid": 1,
                                            "role": "r"}},
                                {"op": "hello"}],
                         ids=["metrics", "sources", "health", "health-limit",
                              "health-bad-limit", "ship-bad-rows",
                              "hello-no-source"])
def test_hubs_answer_alike(op, tmp_path):
    """The port's hub and the JAX hub fed the same ship requests: equal
    acks, and equal replies to every read op but for the clock."""
    hubs = (thub.TelemetryHub(port=0, timeline=str(tmp_path / "t.jsonl")),
            jhub.TelemetryHub(port=0, timeline=str(tmp_path / "j.jsonl")))
    try:
        for req in SHIPS:
            acks = [h.handle(json.loads(json.dumps(req))) for h in hubs]
            assert acks[0] == acks[1]
        got, want = (_strip(h.handle(dict(op))) for h in hubs)
        assert got == want
        # the timelines hold the same rows (each stamped with its hub's
        # clock)
        lines = [[_strip(json.loads(x)) for x in open(tmp_path / name)][1:]
                 for name in ("t.jsonl", "j.jsonl")]
        assert lines[0] == lines[1]
    finally:
        for h in hubs:
            h.stop()


@pytest.fixture
def fixed_clock(monkeypatch):
    """Both `top` and both hub modules read one stopped clock (frame
    times, source ages)."""
    clock = types.SimpleNamespace(time=lambda: 1000.0,
                                  strftime=time.strftime,
                                  localtime=time.gmtime, sleep=time.sleep)
    for mod in (ttop, jtop, thub, jhub):
        monkeypatch.setattr(mod, "time", clock)


SCRAPES = {
    "serve": {"ok": True, "sessions": 12, "uptime_s": 33.5, "metrics": {
        "counters": {"serve.asks": 175, "serve.tells": 170,
                     "store.hits": 30, "store.misses": 10,
                     "serve.groups_created": 2, "serve.new_bests": 4},
        "gauges": {"serve.sessions.active": 12, "serve.batch_fill": 0.875,
                   "pool.utilization": 0.66, "pool.busy": 3},
        "hists": {"serve.ask_ms": {"count": 175, "p50": 0.4, "p95": 1.2},
                  "serve.tell_ms": {"count": 170, "p50": 0.1,
                                    "p95": 0.7}}}},
    "device": {"ok": True, "metrics": {
        "counters": {"device.compiles": 4, "device.compile_cache_hits": 3,
                     "device.compile_cache_misses": 1,
                     "device.dispatches": 500},
        "gauges": {"device.programs": 4,
                   "device.achieved_flops_per_s": 2.2e12,
                   "device.achieved_hbm_bytes_per_s": 1.1e12,
                   "device.mxu_util": 0.008, "device.hbm_util": 0.41,
                   "device.arith_intensity": 0.37,
                   "search.best_qor": 1.5, "search.cal_cover95": 0.9},
        "hists": {"device.compile_ms": {"count": 4, "sum": 1234.5}},
        "deltas": {"device.dispatches": 100, "serve.asks": 30}, "dt": 2.0}},
    "empty": {"ok": True, "metrics": {}},
}


@pytest.mark.parametrize("scrape", list(SCRAPES))
def test_top_frames_equal_the_reference(scrape, fixed_clock):
    """One scrape, rendered by either package's `top`: the same text
    (with and without the previous sample, at two widths, with a fleet
    panel) and the same rates."""
    resp = SCRAPES[scrape]
    cur_t, cur_j = ttop.sample_from_scrape(resp), jtop.sample_from_scrape(resp)
    prev = {"counters": {k: v // 2 for k, v in resp.get("metrics", {}).get(
        "counters", {}).items()}}
    prev_t = ttop.Sample(990.0, prev["counters"], {}, {})
    prev_j = jtop.Sample(990.0, prev["counters"], {}, {})
    srcs = [{"source": "hx:1:ut-serve", "age_s": 0.5,
             "rates": {"serve.asks": 12.5}, "stale": False, "dropped": 0,
             "alerts": 1},
            {"source": "hx:2:ut-serve", "age_s": 90.0, "rates": {},
             "stale": True, "final": True}]
    for p_t, p_j in ((None, None), (prev_t, prev_j)):
        assert ttop.rates(p_t, cur_t) == jtop.rates(p_j, cur_j)
        for width in (78, 40):
            assert (ttop.render(p_t, cur_t, "src", width=width)
                    == jtop.render(p_j, cur_j, "src", width=width))
        assert (ttop.render(p_t, cur_t, "src", sources=srcs)
                == jtop.render(p_j, cur_j, "src", sources=srcs))


def _main_out(mod, argv, capsys):
    rc = mod.main(argv)
    return rc, capsys.readouterr().out


@pytest.mark.parametrize("hub_pkg", ["port", "jax"])
@pytest.mark.parametrize("mode", [["--once"], ["--once", "--fleet"],
                                  ["--once", "--json"],
                                  ["--once", "--json", "--fleet"]],
                         ids=["text", "text-fleet", "json", "json-fleet"])
def test_top_addr_frames_equal_the_reference(hub_pkg, mode, fixed_clock,
                                             capsys):
    """`top --addr <hub>` under either package against one hub (the
    port's or the JAX package's) prints the same frame: the fleet
    rollup's text, its `--json` object and the per-source panel."""
    hub = (thub if hub_pkg == "port" else jhub).TelemetryHub(port=0,
                                                             timeline=None)
    hub.start()
    try:
        for req in SHIPS:
            hub.handle(json.loads(json.dumps(req)))
        argv = ["--addr", f"127.0.0.1:{hub.port}"] + mode
        got, want = (_main_out(m, argv, capsys) for m in (ttop, jtop))
    finally:
        hub.stop()
    assert got[0] == want[0] == 0
    assert got[1] == want[1]
    if "--json" in mode:
        frame = json.loads(got[1])
        assert frame["counters"]["serve.asks"] == 140
        assert frame["meta"]["sources"] == 3


@pytest.mark.parametrize("mode", [["--once"], ["--once", "--fleet"],
                                  ["--once", "--json", "--fleet"]],
                         ids=["text", "text-fleet", "json-fleet"])
def test_top_metrics_files_equal_the_reference(mode, fixed_clock, tmp_path,
                                               capsys):
    """`top --metrics` over one file and over a glob of replica files
    (a fleet-rolled frame) prints the same under either package."""
    for name, asks, gauges in (("m.jsonl", 100, {"pool.busy": 2}),
                               ("m.h1.jsonl", 50, {"search.best_qor": 2.5})):
        with open(tmp_path / name, "w") as f:
            for t in (900.0, 901.0):
                f.write(json.dumps({"t": t, "dt": 1.0,
                                    "counters": {"driver.asks": asks},
                                    "deltas": {"driver.asks": asks // 2},
                                    "gauges": gauges, "hists": {}}) + "\n")
    for pattern in ("m.jsonl", "m*.jsonl"):
        argv = ["--metrics", str(tmp_path / pattern)] + mode
        got, want = (_main_out(m, argv, capsys) for m in (ttop, jtop))
        assert got == want and got[0] == 0
