"""The fused engine's phase spans (`engine/fused.py`) and the obs plane's
clock (`obs.to_unix_ns`), on the CPU.

A step is tiled by `engine.propose`, `engine.evaluate`, `engine.dedup`,
`engine.merge` and `engine.observe`, with one `arm.<name>.propose` /
`arm.<name>.observe` an arm inside the propose / observe phase;
`propose_topk` ranks under `engine.topk`.  The spans are host code: they
change no value, and with the plane off they record nothing."""
import time

import pytest
import torch

from uptune_tpu_torch import obs
from uptune_tpu_torch.engine import BatchedEngine, surrogate_eval_fn
from uptune_tpu_torch.flagship import flagship, flagship_surrogate
from uptune_tpu_torch.surrogate import gp

import test_torch_ops  # noqa: F401  (its share of the CPU under xdist)

PHASES = ["engine.propose", "engine.evaluate", "engine.dedup",
          "engine.merge", "engine.observe"]
# the benchmark harness's own spans around a step and a propose_topk
HARNESS = {"engine.step", "engine.propose_topk"}


@pytest.fixture(autouse=True)
def clean():
    obs.reset()
    yield
    obs.reset()


@pytest.fixture(scope="module")
def eng():
    return flagship(1, history_capacity=2048, device="cpu")


@pytest.fixture(scope="module")
def state(eng):
    # a state with history rows, so dedup and merge see members
    st = eng.init(seed=3)
    for _ in range(2):
        st = eng.step(st)
    return st


def traced(fn):
    """`fn()` with the plane on: (its result, the recorded spans)."""
    obs.enable()
    out = fn()
    events = obs.snapshot()["events"]
    obs.reset()
    return out, [e for e in events if e["dur"] is not None]


def assert_same(a, b):
    """Two trees of tensors (states, tuples) equal bitwise."""
    la, lb = leaves(a), leaves(b)
    assert len(la) == len(lb)
    for i, (x, y) in enumerate(zip(la, lb)):
        assert x.dtype == y.dtype and x.shape == y.shape, i
        assert (x.contiguous().numpy().tobytes()
                == y.contiguous().numpy().tobytes()), i


def leaves(tree):
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, (tuple, list)):
        return [x for t in tree for x in leaves(t)]
    return []


def end(e):
    return e["ts"] + e["dur"]


def inside(child, parent):
    return parent["ts"] <= child["ts"] and end(child) <= end(parent)


def test_a_step_records_each_phase_once_in_order(eng, state):
    _, spans = traced(lambda: eng.step(state))
    top = [e for e in spans if e["name"].startswith("engine.")]
    assert [e["name"] for e in top] == PHASES
    for a, b in zip(top, top[1:]):
        assert end(a) <= b["ts"], (a["name"], b["name"])
    assert not {e["name"] for e in spans} & HARNESS


def test_each_arm_has_one_span_in_its_phase(eng, state):
    _, spans = traced(lambda: eng.step(state))
    phase = {e["name"]: e for e in spans if e["name"] in PHASES}
    for half in ("propose", "observe"):
        names = [f"arm.{t.name}.{half}" for t in eng.arms]
        got = [e for e in spans if e["name"].startswith("arm.")
               and e["name"].endswith(f".{half}")]
        assert [e["name"] for e in got] == names
        assert all(inside(e, phase[f"engine.{half}"]) for e in got)
    # the names are the engine's own strings, made once at construction
    arm_names = {s for pair in eng._arm_spans for s in pair}
    for e in spans:
        if e["name"].startswith("arm."):
            assert any(e["name"] is s for s in arm_names)


def test_the_phases_cover_the_step(eng, state):
    eng.step(state)                              # warm
    obs.enable()
    t0 = time.perf_counter()
    eng.step(state)
    wall = time.perf_counter() - t0
    events = obs.snapshot()["events"]
    covered = sum(e["dur"] for e in events if e["name"] in PHASES)
    assert covered >= 0.95 * wall, (covered, wall)


def test_a_step_records_nothing_with_obs_off(eng, state):
    eng.step(state)
    assert obs.snapshot()["events"] == []
    assert obs.snapshot()["dropped"] == {}


def test_a_step_is_bitwise_the_same_with_obs_on(eng, state):
    off = eng.step(state)
    on, spans = traced(lambda: eng.step(state))
    assert spans
    assert_same(off, on)


def test_a_batched_step_is_bitwise_the_same_with_obs_on(eng):
    """vmap runs the spans once a call, over the stacked instances."""
    be = BatchedEngine(eng, 2)
    s0 = be.init(seed=4)
    off = be.run(s0, 1)
    on, spans = traced(lambda: be.run(s0, 1))
    assert_same(off, on)
    assert [e["name"] for e in spans
            if e["name"] in PHASES[2:]] == PHASES[2:]
    assert sum(e["name"] == "engine.propose" for e in spans) == 1


def test_propose_topk_records_propose_then_topk(eng, state):
    x, y, (nc, ncat) = flagship_surrogate(64, seed=1, device="cpu")
    st_gp = gp.fit(x, y, 0.8, 1e-2, n_cont=nc, n_cat=ncat, ls_cat=0.5)
    acq = surrogate_eval_fn(eng.space, st_gp, kind="ei",
                            best_y=float(y.min()), impl="fused",
                            n_cont=nc, n_cat=ncat)
    want = eng.propose_topk(state, acq, 8)
    got, spans = traced(lambda: eng.propose_topk(state, acq, 8))
    top = [e for e in spans if e["name"].startswith("engine.")]
    assert [e["name"] for e in top] == ["engine.propose", "engine.topk"]
    assert end(top[0]) <= top[1]["ts"]
    assert_same(want, got)


def test_to_unix_ns_is_the_time_ns_clock():
    obs.enable()
    with obs.span("clock"):
        time.sleep(0.002)
    now = time.time_ns()
    snap = obs.snapshot()
    e = snap["events"][-1]
    assert abs(obs.to_unix_ns(e["ts"] + e["dur"]) - now) < 1_000_000
    assert snap["origin_unix_ns"] == obs.to_unix_ns(0.0)
    assert abs(snap["origin_unix_ns"] / 1e9 - snap["origin_unix"]) < 1e-6
    assert obs.trace_origin_unix() == snap["origin_unix"]
