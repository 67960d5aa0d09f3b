"""The `gcc-options-g12.gpsearch` cell at a tiny size on the CPU (the
rehearsal), its control failing a limit, the same run with the timed
path broken underneath (each fault found), and the readers of its two
metrics.

Tiny: the default arms at scale 1 (432 rows a step over the 328 lanes)
into a 512-row history (a step must fit in it) and k 8, windows of a
second; the GP is the configuration's own, 1024 rows over 1027
features, at which the control (the reference in TF32) reads about
2e-4 of the targets' std here, past the cell's limits (a 64-row GP
reads 3e-5)."""
import copy
import json

import pytest
import torch

from portbench import devtrace, spec
from portbench.drivers import gpsearch
from portbench.drivers.common import Run, TraceCtx

BENCH = spec.load_benchmark()
CELL = "gcc-options-g12.gpsearch"
MS = 1_000_000


def tiny(seconds: float = 1.0) -> Run:
    c = spec.workload(BENCH, CELL)
    cfg = copy.deepcopy(spec.config(BENCH, c["config"]))
    cfg["arms"]["scale"] = 1
    cfg["rows_per_step"] = 432
    cfg["history_capacity"] = 512
    mix = copy.deepcopy(spec.traffic(c["traffic"]))
    mix["topk"] = 8
    limits = json.loads((spec.HERE / "limits" / f"{CELL}.json").read_text())
    return Run(c, cfg, mix, 2 ** 33 + 17, seconds, False,
               torch.device("cpu"), lambda: None, limits)


def failed(out) -> list:
    return [c.name for c in out.checks if not c.ok]


def test_rehearsal():
    out = gpsearch.run(tiny())
    assert failed(out) == [], [(c.name, c.value, c.limit)
                               for c in out.checks]
    assert out.attempted > 0 and out.failed == 0
    assert out.rates["acq_per_s"] > 0
    assert out.trace.shapes["features"] == 1027
    assert out.numbers["units_judged"] >= 2


def test_control_fails():
    r = tiny()
    ctl = gpsearch.run(r).control()
    over = [k for k, v in ctl.items()
            if k in r.limits and isinstance(v, (int, float))
            and v > r.limits[k]]
    assert over, ctl


def _state_unchanged(mp):
    from uptune_tpu_torch.engine.fused import FusedEngine
    mp.setattr(FusedEngine, "step",
               lambda self, state, eval_fn=None, exchange=None: state)


def _half_left_out(mp):
    from uptune_tpu_torch.driver.history import History
    insert = History.insert

    def half(self, st, hashes, qor, valid):
        keep = torch.arange(valid.shape[0], device=valid.device) < \
            valid.shape[0] // 2
        return insert(self, st, hashes, qor, valid & keep)
    mp.setattr(History, "insert", half)


def _scores_altered(mp):
    from uptune_tpu_torch.ops import acquire
    f = acquire.acquire_scores
    mp.setattr(acquire, "acquire_scores", lambda *a, **k: f(*a, **k) * 1.01)


def _topk_altered(mp):
    from uptune_tpu_torch.ops import acquire
    f = acquire.acquire_topk

    def altered(*a, **k):
        v, i = f(*a, **k)
        return v * 1.01, i
    mp.setattr(acquire, "acquire_topk", altered)


def _commit_skipped(mp):
    from uptune_tpu_torch.driver.history import History
    mp.setattr(History, "insert", lambda self, st, *a, **k: st)


FAULTS = [_state_unchanged, _half_left_out, _scores_altered, _topk_altered,
          _commit_skipped]


@pytest.mark.parametrize("fault", FAULTS, ids=[f.__name__[1:]
                                               for f in FAULTS])
def test_fault_is_found(fault, monkeypatch):
    fault(monkeypatch)
    out = gpsearch.run(tiny())
    assert failed(out), [(c.name, c.value) for c in out.checks]


# -- the readers of the cell's own metrics ------------------------------------
def test_krows_mma_roofline_reader():
    rd = spec.metric_reader("krows_mma_roofline")
    ops = devtrace.Ops.of([
        ("void krows_mma_kernel<true, true, true>(float const*)", 0,
         MS // 4, 1),
        ("void krows_mma_kernel<true, true, false>(float const*)", MS,
         MS + MS // 4, 2),
        ("void krows_kernel<true, true, true>(float const*)", 2 * MS,
         3 * MS, 3)])
    shapes = {"rows": 6352, "train_rows": 1024, "features": 1027}
    routes = {"acquire_scores": {"cuda_cores": 0, "tensor_cores": 1},
              "acquire_topk": {"cuda_cores": 0, "tensor_cores": 1},
              "gp_mean_var": {"cuda_cores": 1, "tensor_cores": 0}}
    ctx = TraceCtx(0, 4 * MS, 1, ops, [], {}, shapes,
                   {"route_launches": routes})
    bound = 3 * 2 * 6352 * 1024 * 1027 / 495e12
    assert bound == pytest.approx(80.97e-6, rel=1e-3)
    assert rd(ctx) == pytest.approx(100 * 2 * bound / 0.5e-3)
    # a program without the counter, or a window without the kernel
    assert rd(TraceCtx(0, 4 * MS, 1, ops, [], {}, shapes, {})) is None
    assert rd(TraceCtx(extra={"route_launches": routes},
                       shapes=shapes)) is None


def test_acquire_features_ms_reader():
    rd = spec.metric_reader("acquire.features_ms")
    spans = [devtrace.Span("acquire.features", 1 * MS, 3 * MS),
             devtrace.Span("acquire.features", 5 * MS, 6 * MS),
             devtrace.Span("engine.evaluate", 0, 4 * MS),
             devtrace.Span("acquire.features", 9 * MS, 12 * MS)]
    ctx = TraceCtx(0, 10 * MS, 2, extra={"obs_spans": spans})
    assert rd(ctx) == pytest.approx(1.5)    # (2 + 1) ms over 2 units
    assert rd(TraceCtx(0, 10 * MS, 2)) is None
    assert rd(TraceCtx(0, 10 * MS, 2, extra={"obs_spans": spans[2:3]})) \
        is None
