"""Each cell's loop at a tiny size on the CPU, with the kernels' plain
versions (the rehearsal); the same runs with the timed path broken
underneath, which the judgement must find (`correct` false); and the
control, the reference in the precision below the configuration's put
in the program's place, which must fail a limit too.

Tiny: the flagship at scale 1 (112 rows a step) into a 256-row history
with a 64-row GP and k 8; 4 served tenants, one a connection, in 2
client processes at 200 asks/s; windows of a second."""
import copy
import json

import pytest
import torch

from portbench import spec
from portbench.drivers import engine, serve, tuner
from portbench.drivers.common import Run

BENCH = spec.load_benchmark()
CPU = torch.device("cpu")


# cells out of BENCHMARK.json until their rates hold a bound (PERF.md,
# Open questions): their configuration, mixes and drivers stay
# rehearsed here
OUT = {c["name"]: c for c in (
    {"name": "rosenbrock-4d.serve1024", "config": "rosenbrock-4d",
     "traffic": "serve1024", "chips": 1},
    {"name": "rosenbrock-4d.tuner", "config": "rosenbrock-4d",
     "traffic": "tuner", "chips": 1})}
BENCH["configs"].append({"name": "rosenbrock-4d",
                         "file": "portbench/configs/rosenbrock-4d.json"})


def entry(cell: str) -> dict:
    return OUT[cell] if cell in OUT else spec.workload(BENCH, cell)


def tiny(cell: str, seconds: float = 1.0) -> Run:
    c = entry(cell)
    cfg = copy.deepcopy(spec.config(BENCH, c["config"]))
    mix = copy.deepcopy(spec.traffic(c["traffic"]))
    if cfg["name"] == "flagship-s64":
        cfg["arms"]["scale"] = 1
        cfg["rows_per_step"] = 112
        cfg["history_capacity"] = 256
        cfg["gp"]["train_rows"] = 64
        if mix.get("topk"):
            mix["topk"] = 8
    else:
        # one tenant a connection, so that each passes several epochs
        cfg["serve"]["tenants"] = 4
        if mix["driver"] == "serve":
            mix.update(client_processes=2, connections=4, asks_per_s=200)
    limits = json.loads((spec.HERE / "limits" / f"{cell}.json").read_text())
    return Run(c, cfg, mix, 2 ** 33 + 17, seconds, False, CPU,
               lambda: None, limits)


DRIVERS = {"engine": engine, "serve": serve, "tuner": tuner}
CELLS = [c["name"] for c in BENCH["workloads"]] + list(OUT)


def run(cell: str, seconds: float = 1.0):
    r = tiny(cell, seconds)
    return DRIVERS[r.mix["driver"]].run(r)


def failed(out) -> list:
    return [c.name for c in out.checks if not c.ok]


@pytest.mark.parametrize("cell", CELLS)
def test_rehearsal(cell):
    out = run(cell)
    assert failed(out) == [], [(c.name, c.value, c.limit)
                               for c in out.checks]
    assert out.attempted > 0 and out.failed == 0
    assert all(v > 0 for v in out.rates.values()), out.rates


@pytest.mark.parametrize("cell", CELLS)
def test_control_fails(cell):
    """The control's numbers, read as the checks read the program's,
    break at least one limit."""
    r = tiny(cell)
    out = DRIVERS[r.mix["driver"]].run(r)
    ctl = out.control()
    over = [k for k, v in ctl.items()
            if k in r.limits and isinstance(v, (int, float))
            and v > r.limits[k]]
    assert over, ctl


# -- faults planted under the timed path ------------------------------------
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


def _objective_altered(mp):
    import uptune_tpu_torch.workloads.synthetic as syn
    f = syn.rosenbrock_device
    mp.setattr(syn, "rosenbrock_device", lambda x: f(x) * 1.001)


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


def _serve_commit_skipped(mp):
    from uptune_tpu_torch.serve.group import SessionGroup
    mp.setattr(SessionGroup, "commit", lambda self, *a, **k: None)


def _serve_half_told(mp):
    from uptune_tpu_torch.serve.session import Session
    f = Session.tell_many
    mp.setattr(Session, "tell_many",
               lambda self, rows, incarn=None: f(self, list(rows)[
                   :max(1, len(rows) // 2)], incarn))


def _serve_best_altered(mp):
    from uptune_tpu_torch.serve.session import Session
    f = Session.best

    def best(self):
        b = f(self)
        if b["qor"] is not None:
            b["qor"] = b["qor"] * (1 + 1e-9)
        return b
    mp.setattr(Session, "best", best)


def _tuner_commit_skipped(mp):
    from uptune_tpu_torch.driver import Tuner
    mp.setattr(Tuner, "_commit", lambda self, *a, **k: None)


def _tuner_half_told(mp):
    from uptune_tpu_torch.driver import Tuner
    f = Tuner.tell
    seen = [0]

    def tell(self, trial, qor, dur=0.0):
        seen[0] += 1
        if seen[0] % 2:
            return f(self, trial, qor, dur)
        self.told += 1          # acknowledged, never applied
        return None
    mp.setattr(Tuner, "tell", tell)


def _tuner_best_altered(mp):
    from uptune_tpu_torch.driver import Tuner
    f = Tuner.result
    mp.setattr(Tuner, "result", lambda self: f(self)._replace(
        best_qor=f(self).best_qor * (1 + 1e-6)))


FAULTS = [
    ("flagship-s64.plain", _state_unchanged),
    ("flagship-s64.plain", _half_left_out),
    ("flagship-s64.plain", _objective_altered),
    ("flagship-s64.gp", _state_unchanged),
    ("flagship-s64.gp", _half_left_out),
    ("flagship-s64.gp", _scores_altered),
    ("flagship-s64.gp", _topk_altered),
    ("rosenbrock-4d.serve1024", _serve_commit_skipped),
    ("rosenbrock-4d.serve1024", _serve_half_told),
    ("rosenbrock-4d.serve1024", _serve_best_altered),
    ("rosenbrock-4d.tuner", _tuner_commit_skipped),
    ("rosenbrock-4d.tuner", _tuner_half_told),
    ("rosenbrock-4d.tuner", _tuner_best_altered),
]


@pytest.mark.parametrize("cell,fault", FAULTS,
                         ids=[f"{c}-{f.__name__[1:]}" for c, f in FAULTS])
def test_fault_is_found(cell, fault, monkeypatch):
    fault(monkeypatch)
    out = run(cell)
    assert failed(out), [(c.name, c.value) for c in out.checks]


@pytest.mark.parametrize("distance,memory,repeats", [
    (10, None, 1), (10_000, None, 1), (10, 512, 1), (383, 512, 1),
    (384, 512, 0), (10_000, 512, 0)])
def test_repeats_within_the_history(distance, memory, repeats):
    """A configuration offered again is a repeat while the tenant's
    dedup still holds it: always with the memo store (memory None), and
    within the history's capacity less a ticket's slack otherwise."""
    from portbench.reference import tenants
    space = [{"name": "x0", "kind": "float", "lo": -3.0, "hi": 3.0}]
    cfgs = [[-3.0 + 6.0 * i / (distance + 1)] for i in range(distance)]
    events = [{"cfgs": [c], "vals": [float(i)], "told": 1, "replied": True}
              for i, c in enumerate(cfgs)]
    events.append({"cfgs": [cfgs[0]], "vals": [0.0], "told": 1,
                   "replied": True})
    rec = {"events": events, "empty_asks": 0, "errors": 0,
           "best": {"qor": 0.0, "tells": distance + 1, "config": None}}
    n = tenants.judge([rec], space, "float64", memory=memory)
    assert n["repeat_offers"] == repeats and n["best_gap"] == 0


def test_a_client_holding_jax_ends_the_serving_run(monkeypatch):
    """A client process that reports JAX or the JAX package among its
    modules after the window ends the serving run with an error, so that
    no result is printed."""
    each = serve.Clients.each

    def planted(self, obj=None, key=""):
        out = each(self, obj, key)
        if key == "stopped":
            out[0]["forbidden"] = ["jax"]
        return out
    monkeypatch.setattr(serve.Clients, "each", planted)
    with pytest.raises(SystemExit, match="jax"):
        run("rosenbrock-4d.serve1024")
