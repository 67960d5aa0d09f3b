"""The reduction of a device trace (busy time, idle gaps, attribution
to host spans, breakdown), the per-layer readers on a small synthetic
trace, the frozen least times, and the rate and percentile arithmetic."""
import numpy as np
import pytest

from portbench import devtrace, roofline, spec, stats
from portbench.drivers.common import TraceCtx

MS = 1_000_000


def synthetic():
    """Two units of 10 ms: a step span [0, 6) ms launching a scores
    kernel (1 ms) and the merge (0.5 ms), and a top-k span [6, 10) ms
    launching a top-k kernel (2 ms); device idle elsewhere."""
    rows = [("(anonymous namespace)::wq_kernel(float const*)", 1 * MS,
             2 * MS, 1),
            ("void merge_rows_kernel<128>(Rows)", 3 * MS, 3 * MS + MS // 2,
             2),
            ("topk_merge_kernel(float const*)", 7 * MS, 9 * MS, 3)]
    rows += [(n, s + 10 * MS, e + 10 * MS, c + 10) for n, s, e, c in rows]
    launch = {1: MS // 2, 2: 2 * MS, 3: 6 * MS + MS // 2}
    launch.update({c + 10: t + 10 * MS for c, t in launch.items()})
    spans = [devtrace.Span("engine.step", 0, 6 * MS - 1),
             devtrace.Span("engine.propose_topk", 6 * MS, 10 * MS - 1)]
    spans += [devtrace.Span(s.name, s.start + 10 * MS, s.end + 10 * MS)
              for s in list(spans)]
    return devtrace.Ops.of(rows, launch), spans


def test_busy_and_gaps():
    ops = devtrace.Ops.of([("a", 10, 20, 1), ("b", 15, 30, 2),
                           ("c", 50, 60, 3), ("d", 90, 120, 4)])
    assert devtrace.busy_ns(ops, 0, 100) == 20 + 10 + 10
    gs, ge, nxt = devtrace.idle_gaps(ops, 0, 100)
    assert gs.tolist() == [0, 30, 60] and ge.tolist() == [10, 50, 90]
    assert [ops.names[i] for i in nxt] == ["a", "c", "d"]
    assert devtrace.busy_ns(devtrace.Ops([], [], [], [], []), 0, 10) == 0


def test_attribution_and_breakdown():
    ops, spans = synthetic()
    step = devtrace.launched_in(ops, spans, "engine.step")
    assert step.sum() == 4 and ops.seconds(step) == pytest.approx(3e-3)
    top = devtrace.launched_in(ops, spans, "engine.propose_topk")
    assert top.sum() == 2 and ops.seconds(top) == pytest.approx(4e-3)
    b = devtrace.breakdown(ops, spans, 0, 20 * MS)
    assert b["device_ops"][0] == ["topk_merge_kernel", pytest.approx(4e-3)]
    gaps = dict(b["idle_gaps"])
    assert gaps["engine.step > topk_merge_kernel"] == \
        pytest.approx(2 * 3.5e-3)
    assert sum(gaps.values()) == pytest.approx(20e-3 - 7e-3)


def ctx_of(launches, shapes):
    ops, spans = synthetic()
    return TraceCtx(0, 20 * MS, 2, ops, spans, launches, shapes, {})


SHAPES = {"rows": 6040, "cap": 1 << 15, "train_rows": 1024,
          "features": 31, "k": 128}


def test_readers_on_the_synthetic_trace():
    ctx = ctx_of({"acquire_scores": 2, "acquire_topk": 2, "merge_rows": 2},
                 SHAPES)
    c = spec.metric_reader("acquire_scores_roofline")(ctx)
    bound = roofline.acquire_scores_bound(6040, 1024, 31)["bound_s"]
    # C's kernels: the wq kernel only (the merge is not a gp_tile kernel)
    assert c == pytest.approx(100 * 2 * bound / 2e-3)
    d = spec.metric_reader("acquire_topk_roofline")(ctx)
    assert d == pytest.approx(100 * 2 * roofline.acquire_topk_bound(
        6040, 1024, 31, 128)["bound_s"] / 4e-3)
    m = spec.metric_reader("merge_rows_roofline")(ctx)
    assert m == pytest.approx(100 * 2 * roofline.merge_rows_bound(
        1 << 15, 6040)["bound_s"] / 1e-3)
    idle = spec.metric_reader("device.idle_share.acq")(ctx)
    assert idle == pytest.approx(100 * (1 - 7 / 20))
    assert spec.metric_reader("engine.device_ops_per_step")(ctx) == 3


def test_readers_find_nothing():
    empty = TraceCtx()
    for name in ("acquire_scores_roofline", "acquire_topk_roofline",
                 "merge_rows_roofline", "device.idle_share.trials",
                 "engine.device_ops_per_step", "serve.commit_share",
                 "serve.ask_server_p95_ms", "serve.ask_p95_ms",
                 "driver.syncs_per_ticket"):
        assert spec.metric_reader(name)(empty) is None, name
    # no calls counted: no roofline, never a 0
    assert spec.metric_reader("acquire_scores_roofline")(
        ctx_of({}, SHAPES)) is None


def test_serve_and_driver_readers():
    spans = [devtrace.Span("serve.commit", 10, 30),
             devtrace.Span("serve.commit", 90, 130),
             devtrace.Span("serve.propose", 0, 100)]
    ctx = TraceCtx(0, 100, 1, spans=spans,
                   extra={"window": (0, 100), "ask_hist": {"p95": 26.5},
                          "ask_p95_ms": 31.0, "syncs": 30, "tickets": 10})
    assert spec.metric_reader("serve.commit_share")(ctx) == 30.0
    assert spec.metric_reader("serve.ask_server_p95_ms")(ctx) == 26.5
    assert spec.metric_reader("serve.ask_p95_ms")(ctx) == 31.0
    assert spec.metric_reader("driver.syncs_per_ticket")(ctx) == 3.0


@pytest.mark.parametrize("bound,ms", [
    (lambda: roofline.acquire_scores_bound(6040, 1024, 31), 0.0795),
    (lambda: roofline.acquire_topk_bound(6040, 1024, 31, 128), 0.0795),
    (lambda: roofline.merge_rows_bound(1 << 15, 6040), 0.000477)])
def test_least_times_at_the_main_shapes(bound, ms):
    """The counts frozen from chip_smoke.py give its printed bounds."""
    assert bound()["bound_s"] * 1e3 == pytest.approx(ms, rel=2e-3)


def test_rate_and_percentile():
    assert stats.rate(300, 30.0) == 10.0
    v = list(range(1, 101))
    assert stats.percentile(v, 95) == 95
    assert stats.percentile([5.0], 95) == 5.0
    assert stats.percentile([3, 1, 2, 4], 50) == 2
    with pytest.raises(ValueError):
        stats.rate(1, 0)


def test_short_names():
    assert devtrace.short_name(
        "void at::native::vectorized_elementwise_kernel<4, F, A>(int, F)") \
        == "at::native::vectorized_elementwise_kernel"
    assert devtrace.short_name("Memcpy DtoD (Device -> Device)") == \
        "Memcpy DtoD"
    assert np.all(devtrace.Ops.of([("a", 1, 2, 0)]).matching("a"))
