"""The port's device telemetry (`uptune_tpu_torch/obs/device.py`), the
counterpart of tests/test_device.py: the H100 peak table, cost records
in the reference's schema, the `instrument` seam (spans and dispatch
metrics), roofline windows, the torch.profiler capture, and `ut
report`'s device section.  The card's name comes here from a stand-in
for `torch.cuda`; the card itself runs these paths in `chip_smoke.py`'s
obs phase."""
import json
import os
import sys

import pytest
import torch

import test_device as ref_device

from uptune_tpu_torch import obs
from uptune_tpu_torch.obs import device, report, top

H100 = "NVIDIA H100 80GB HBM3"


@pytest.fixture(autouse=True)
def clean():
    obs.reset()
    yield
    obs.device.stop_trace()
    obs.reset()


@pytest.fixture
def ref_on_port(monkeypatch):
    monkeypatch.setattr(ref_device, "obs", obs)
    monkeypatch.setattr(ref_device, "device", device)


@pytest.mark.parametrize("cls,name", [
    ("TestPeakTable", "test_unknown_device_fallback"),
    ("TestHarvest", "test_schema_rejects_malformed"),
    ("TestHarvest", "test_harvest_tolerates_opaque_object"),
])
def test_reference_contract(ref_on_port, cls, name):
    getattr(getattr(ref_device, cls)(), name)()


@pytest.mark.parametrize("name", ["test_panel_renders_values_and_dashes",
                                  "test_json_frame_carries_device_family"])
def test_reference_top_device_panel(monkeypatch, name):
    """TestTopDevicePanel on the port's `top`: its `from uptune_tpu.obs
    import top` resolves to the port's module.  The panel keeps the
    reference's keys (`device.mxu_util`, `device.hbm_util`, ...)."""
    monkeypatch.setitem(sys.modules, "uptune_tpu.obs", obs)
    monkeypatch.setitem(sys.modules, "uptune_tpu.obs.top", top)
    getattr(ref_device.TestTopDevicePanel(), name)()


def test_h100_peaks_by_substring():
    """H100 SXM's data-sheet peaks, matched anywhere in the device name,
    case-insensitive; the TPU entries of the reference are not the
    port's."""
    assert device.resolve_peaks(H100) == (989.4e12, 3.35e12)
    assert device.resolve_peaks("nvidia h100 pcie") == (989.4e12, 3.35e12)
    assert device.resolve_peaks("TPU v4") is None
    u = device.utilization(H100, 98.94e12, 0.335e12)
    assert u["mxu_util"] == pytest.approx(0.1)
    assert u["hbm_util"] == pytest.approx(0.1)
    assert "mxu_util" not in device.utilization(H100)


def test_harvest_takes_the_callers_count():
    rec = device.harvest({"flops": 2e9, "bytes_accessed": 4e9,
                          "peak_memory": {"temp_bytes": 8}})
    device.validate_record(rec)
    assert rec["arith_intensity"] == pytest.approx(0.5)
    assert rec["transcendentals"] is None
    assert rec["peak_memory"]["temp_bytes"] == 8
    assert rec["peak_memory"]["output_bytes"] == 0


def test_instrument_disabled_is_a_call_through():
    f = obs.instrument_device_fn(lambda x: x + 1, "dev.off")
    assert f(1) == 2
    assert device.programs() == {}
    assert obs.metrics_snapshot()["counters"] == {}
    assert obs.snapshot()["events"] == []


def test_instrument_enabled_on_the_cpu():
    """A span and the dispatch metrics a call; nothing compiles, so the
    totals stay 0."""
    obs.enable()
    f = obs.instrument_device_fn(lambda x: x * 2, "dev.cpu", kind="t")
    assert f(torch.ones(3)).sum().item() == 6.0
    f(torch.ones(3))
    rec = device.programs()["dev.cpu"]
    assert rec["dispatches"] == 2
    assert rec["compiles"] == 0 and device.compile_totals() == (0, 0.0)
    m = obs.metrics_snapshot()
    assert m["counters"]["device.dispatches"] == 2
    assert m["hists"]["device.dispatch_ms"]["count"] == 2
    spans = [e for e in obs.snapshot()["events"] if e["name"] == "dev.cpu"]
    assert len(spans) == 2 and spans[0]["attrs"] == {"kind": "t"}


class _Cuda:
    @staticmethod
    def get_device_name(i):
        return H100

    @staticmethod
    def current_device():
        return 0


def test_record_window_against_the_h100_peaks(monkeypatch):
    monkeypatch.setattr(device, "_cuda", lambda: _Cuda)
    assert device.record_window("dev.step", 1e-3) == {}    # disabled
    obs.enable()
    assert device.record_window("dev.step", 1e-3) == {}    # no cost
    device.set_cost("dev.step", {"flops": 98.94e9,
                                 "bytes_accessed": 0.335e9})
    out = device.record_window("dev.step", 1e-3)
    assert out["mxu_util"] == pytest.approx(0.1)
    assert out["hbm_util"] == pytest.approx(0.1)
    g = obs.metrics_snapshot()["gauges"]
    assert g["device.mxu_util.dev.step"] == out["mxu_util"]
    assert g["device.flops.dev.step"] == 98.94e9
    assert device.record_window("dev.step", 1e-3,
                                device_kind="cpu")["achieved_flops_per_s"]


def test_device_span_opens_a_profiler_range():
    """With torch imported, a device_span is also a record_function
    range of the same name in a torch.profiler capture."""
    from torch.profiler import ProfilerActivity, profile
    obs.enable()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with obs.device_span("ticket.propose", arm="de"):
            torch.ones(4).sum()
    assert "ticket.propose" in {e.key for e in prof.key_averages()}
    assert [e["name"] for e in obs.snapshot()["events"]] == [
        "ticket.propose"]


def test_capture_and_export_reference(tmp_path):
    """`start_trace` / `stop_trace` write a Chrome trace of the capture
    under the directory, which the host trace's export references."""
    d = str(tmp_path / "dev")
    obs.enable()
    assert device.start_trace(d) == d
    assert device.start_trace(d) == d          # idempotent while active
    with obs.device_span("engine.run"):
        torch.ones(8).cumsum(0)
    assert device.stop_trace() == d
    assert device.stop_trace() is None
    doc = json.load(open(os.path.join(d, device.TRACE_FILE)))
    assert any(e.get("name") == "engine.run"
               for e in doc["traceEvents"])
    host = obs.chrome_trace()
    obs.validate_trace(host)
    assert host["otherData"]["device_trace"] == d


def test_env_gate(tmp_path, monkeypatch):
    monkeypatch.delenv("UT_DEVICE_TRACE", raising=False)
    assert device.maybe_trace_from_env() is None
    assert device.maybe_trace_from_env({"UT_DEVICE_TRACE": "off"}) is None
    d = str(tmp_path / "env")
    assert device.maybe_trace_from_env({"UT_DEVICE_TRACE": d}) == d
    device.stop_trace()
    assert os.path.exists(os.path.join(d, device.TRACE_FILE))


def test_traced_tuner_reports_no_compiles():
    """The driver's StepStats carry the obs.device compile deltas, which
    stay 0 in the port; its device calls are instrumented programs."""
    from uptune_tpu_torch import Tuner
    from uptune_tpu_torch.workloads import (rosenbrock_objective,
                                            rosenbrock_space)
    obs.enable()
    t = Tuner(rosenbrock_space(2, -2.048, 2.048),
              rosenbrock_objective(2, device="cpu"), seed=0, device="cpu")
    stats = t.step()
    assert stats.n_compiles == 0 and stats.t_compile == 0.0
    progs = device.programs()
    assert any(n.startswith("driver.propose.") for n in progs)
    assert progs["driver.commit"]["dispatches"] == 1
    t.close()


def _metrics_file(tmp_path, gauges, counters):
    p = tmp_path / "m.metrics.jsonl"
    row = {"t": 1.0, "dt": 1.0, "counters": counters,
           "deltas": dict(counters), "gauges": gauges,
           "hists": {"device.compile_ms": {"count": 2, "sum": 321.0}}}
    p.write_text(json.dumps(row) + "\n")
    return str(p)


def _empty_journal(tmp_path):
    jp = tmp_path / "j.jsonl"
    jp.write_text(json.dumps({"v": 1, "origin_unix": 0.0, "meta": {}})
                  + "\n")
    return obs.journal.read(str(jp))


def test_report_section_present_with_device_telemetry(tmp_path):
    """The reference's TestReportDeviceSection case on the port's
    report."""
    met = report.summarize_metrics(_metrics_file(
        tmp_path,
        {"device.flops.engine.run": 1e9, "device.bytes.engine.run": 4e9,
         "device.arith_intensity.engine.run": 0.25,
         "device.compile_ms.engine.run": 321.0,
         "device.achieved_flops_per_s": 5e8, "device.mxu_util": 0.002},
        {"device.compiles": 2, "device.compile_cache_hits": 1,
         "device.compile_cache_misses": 1, "device.dispatches": 10}))
    dev = report.device_summary(met)
    assert dev["programs"]["engine.run"]["flops"] == 1e9
    assert dev["compile"]["compiles"] == 2
    assert dev["roofline"]["mxu_util"] == 0.002
    an = report.analyze(*_empty_journal(tmp_path))
    assert "## Device & compile" in report.render_markdown(an, met)
    assert "Device &amp; compile" in report.render_html(an, met)


def test_report_section_absent_without_device_telemetry(tmp_path):
    met = report.summarize_metrics(_metrics_file(
        tmp_path, {"serve.batch_fill": 1.0}, {"serve.asks": 5}))
    assert report.device_summary(met) is None
    assert report.device_summary(None) is None
    md = report.render_markdown(report.analyze(*_empty_journal(tmp_path)),
                                met)
    assert "Device & compile" not in md
