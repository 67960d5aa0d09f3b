"""The driver's companions in both packages: the search hooks
(`driver/plugins.py`), the objectives (`driver/objectives.py`) and the
input managers (`driver/inputs.py`), each case run against the JAX
package and the port (`pkg`); and the port's synthetic host objectives
(`workloads/synthetic.py`) against the JAX package's.

Tolerance of the host objectives: both packages score a float32 batch,
but XLA and PyTorch may sum a row's terms in another order, so the values
are held within HOST_ULPS float32 ulps.
"""
import json
import sys
import types

import numpy as np
import pytest

HOST_ULPS = 4


def _jax_pkg():
    from uptune_tpu.driver import driver, inputs, objectives, plugins
    from uptune_tpu.space import params, spec
    return types.SimpleNamespace(
        name="jax", plugins=plugins, objectives=objectives, inputs=inputs,
        params=params, Space=spec.Space,
        Tuner=lambda *a, **k: driver.Tuner(*a, **k))


def _port_pkg():
    from uptune_tpu_torch.driver import driver, inputs, objectives, plugins
    from uptune_tpu_torch.space import params, spec
    return types.SimpleNamespace(
        name="port", plugins=plugins, objectives=objectives, inputs=inputs,
        params=params, Space=spec.Space,
        Tuner=lambda *a, **k: driver.Tuner(*a, device="cpu", **k))


@pytest.fixture(params=["jax", "port"])
def pkg(request):
    return _jax_pkg() if request.param == "jax" else _port_pkg()


# -- search hooks (tests/test_plugins.py) ----------------------------------------
def _space(pkg):
    P = pkg.params
    return pkg.Space([P.FloatParam("x", -2.0, 2.0),
                      P.FloatParam("y", -2.0, 2.0)])


def _obj(cfgs):
    return [c["x"] ** 2 + c["y"] ** 2 for c in cfgs]


def _recorder(pkg):
    class Recorder(pkg.plugins.SearchHook):
        def __init__(self):
            self.events = []

        def on_start(self, tuner):
            self.events.append(("start",))

        def on_result(self, tuner, trial, qor):
            self.events.append(("result", trial.gid, qor))

        def on_step(self, tuner, stats):
            self.events.append(("step", stats.technique))

        def on_new_best(self, tuner, config, qor):
            self.events.append(("best", qor))

        def on_finish(self, tuner, result):
            self.events.append(("finish", result.evals))
    return Recorder()


def test_hook_lifecycle_and_counts(pkg):
    rec = _recorder(pkg)
    t = pkg.Tuner(_space(pkg), _obj, seed=0, hooks=[rec])
    res = t.run(test_limit=100)
    t.close()
    kinds = [e[0] for e in rec.events]
    assert kinds[0] == "start" and kinds[-1] == "finish"
    assert kinds.count("result") == res.evals
    assert kinds.count("step") == res.steps
    bests = [e[1] for e in rec.events if e[0] == "best"]
    assert bests and bests == sorted(bests, reverse=True)
    assert rec.events[-1] == ("finish", res.evals)


def test_failing_hook_does_not_kill_run(pkg):
    class Bomb(pkg.plugins.SearchHook):
        def on_step(self, tuner, stats):
            raise RuntimeError("boom")

    t = pkg.Tuner(_space(pkg), _obj, seed=0, hooks=[Bomb()])
    res = t.run(test_limit=60)
    t.close()
    assert res.evals >= 60


def test_failure_qor_reported_as_none(pkg):
    rec = _recorder(pkg)
    t = pkg.Tuner(_space(pkg), lambda cfgs: [float("nan")] * len(cfgs),
                  seed=0, hooks=[rec])
    t.step()
    t.close()
    results = [e for e in rec.events if e[0] == "result"]
    assert results and all(e[2] is None for e in results)


def test_log_display(pkg, capsys):
    t = pkg.Tuner(_space(pkg), _obj, seed=0,
                  hooks=[pkg.plugins.LogDisplay(interval=0.0,
                                                out=sys.stdout)])
    t.run(test_limit=80)
    t.close()
    out = capsys.readouterr().out
    assert "NEW BEST" in out and "evals=" in out


def test_file_display(pkg, tmp_path):
    p = tmp_path / "best.log"
    t = pkg.Tuner(_space(pkg), _obj, seed=0,
                  hooks=[pkg.plugins.FileDisplay(str(p))])
    res = t.run(test_limit=80)
    t.close()
    rows = [json.loads(x) for x in p.read_text().splitlines()]
    assert rows and rows[-1]["qor"] == pytest.approx(res.best_qor)
    qs = [r["qor"] for r in rows]
    assert qs == sorted(qs, reverse=True)


# -- objectives (tests/test_objectives_techniques.py) -------------------------------
def test_objective_orders(pkg):
    o = pkg.objectives
    assert o.MinimizeTime()({"time": 1.0}) < o.MinimizeTime()({"time": 2.0})
    assert o.MaximizeAccuracy()({"accuracy": 0.9}) < \
        o.MaximizeAccuracy()({"accuracy": 0.5})
    m = o.MaximizeAccuracyMinimizeSize()
    assert m({"accuracy": 0.9, "size": 5000.0}) < \
        m({"accuracy": 0.8, "size": 1.0})
    assert m({"accuracy": 0.9, "size": 10.0}) < \
        m({"accuracy": 0.9, "size": 20.0})


def test_threshold_partitions(pkg):
    o = pkg.objectives.ThresholdAccuracyMinimizeTime(target=0.95)
    assert o({"accuracy": 0.96, "time": 1e5}) < \
        o({"accuracy": 0.94, "time": 0.001})
    assert o({"accuracy": 0.99, "time": 1.0}) < \
        o({"accuracy": 0.95, "time": 2.0})
    assert o({"accuracy": 0.94, "time": 1.0}) < \
        o({"accuracy": 0.5, "time": 1.0})


def test_objective_nonfinite_is_inf(pkg):
    o = pkg.objectives
    inf = float("inf")
    assert o.MinimizeTime()({"time": float("nan")}) == inf
    m = o.MaximizeAccuracyMinimizeSize()
    assert m({"accuracy": float("nan"), "size": 1.0}) == inf
    assert m({"accuracy": inf, "size": 1.0}) == inf
    t = o.ThresholdAccuracyMinimizeTime(target=0.9)
    assert t({"accuracy": 0.99, "time": float("nan")}) == inf


def test_get_objective_and_missing_metric(pkg):
    o = pkg.objectives
    got = o.get_objective("ThresholdAccuracyMinimizeTime", target=0.9)
    assert isinstance(got, o.ThresholdAccuracyMinimizeTime)
    with pytest.raises(KeyError):
        o.get_objective("Nope")
    with pytest.raises(KeyError, match="accuracy"):
        o.MaximizeAccuracy()({"time": 1.0})


def test_objectives_agree_across_packages():
    """The same metrics scalarize to the same value in both packages."""
    oj, ot = _jax_pkg().objectives, _port_pkg().objectives
    rs = np.random.RandomState(0)
    for name, kw in (("MinimizeTime", {}), ("MaximizeAccuracy", {}),
                     ("MinimizeSize", {}),
                     ("MaximizeAccuracyMinimizeSize", {}),
                     ("ThresholdAccuracyMinimizeTime", {"target": 0.7})):
        fj, ft = oj.get_objective(name, **kw), ot.get_objective(name, **kw)
        for _ in range(50):
            m = {"time": float(rs.rand() * 10), "accuracy": float(rs.rand()),
                 "size": float(rs.randint(0, 10**6))}
            assert fj(m) == ft(m), (name, m)


# -- input managers (tests/test_driver.py) -------------------------------------------
def _int_space(pkg):
    return pkg.Space([pkg.params.IntParam("x", 0, 63)])


def test_fixed_input_manager_single_cached_input(pkg):
    im = pkg.inputs.FixedInputManager(path="/data/train.bin", size=7)
    seen = []

    def obj(cfgs, inputs):
        seen.extend(inputs)
        return [float(c["x"]) for c in cfgs]

    t = pkg.Tuner(_int_space(pkg), obj, seed=0, input_manager=im)
    t.run(test_limit=40)
    t.close()
    assert len(seen) >= 40
    assert all(i is seen[0] for i in seen)
    assert seen[0].path == "/data/train.bin" and seen[0].size == 7


def test_rotating_manager_and_hooks(pkg):
    class Counting(pkg.inputs.RotatingInputManager):
        def __init__(self, inputs):
            super().__init__(inputs)
            self.pre = self.post = 0

        def before_run(self, trial, inp):
            self.pre += 1

        def after_run(self, trial, inp):
            self.post += 1

    In = pkg.inputs.Input
    im = Counting([In("a"), In("b"), In("c")])
    names = []

    def obj(cfgs, inputs):
        names.extend(i.name for i in inputs)
        return [float(c["x"]) for c in cfgs]

    t = pkg.Tuner(_int_space(pkg), obj, seed=1, input_manager=im)
    t.run(test_limit=30)
    t.close()
    assert im.pre == im.post == len(names) >= 30
    assert set(names) == {"a", "b", "c"}
    with pytest.raises(ValueError):
        pkg.inputs.RotatingInputManager([])


def test_without_manager_signature_unchanged(pkg):
    t = pkg.Tuner(_int_space(pkg), lambda cfgs: [float(c["x"])
                                                 for c in cfgs], seed=2)
    res = t.run(test_limit=20)
    t.close()
    assert res.evals >= 20


# -- the synthetic host objectives against the JAX package's ----------------------------
def _configs(rs, n, dims, lo=-3.0, hi=3.0):
    return [{f"x{i}": float(v) for i, v in enumerate(row)}
            for row in rs.uniform(lo, hi, (n, dims))]


@pytest.mark.parametrize("which", ["rosenbrock", "sphere", "beale"])
def test_host_objectives_match_jax(which):
    from uptune_tpu import workloads as wj
    from uptune_tpu_torch import workloads as wt
    rs = np.random.RandomState(3)
    dims = 2 if which == "beale" else 7
    cfgs = _configs(rs, 257, dims)
    if which == "rosenbrock":
        fj = wj.rosenbrock_objective(dims)
        ft = wt.rosenbrock_objective(dims, device="cpu")
    else:
        fj = wj.make_host_objective(getattr(wj, f"{which}_device"), dims)
        ft = wt.make_host_objective(getattr(wt, f"{which}_device"), dims,
                                    device="cpu")
    a, b = np.asarray(fj(cfgs)), ft(cfgs)
    assert a.dtype == b.dtype == np.float32 and a.shape == b.shape == (257,)
    np.testing.assert_array_max_ulp(a, b, maxulp=HOST_ULPS)


def test_tsp_objective_matches_jax():
    from uptune_tpu import workloads as wj
    from uptune_tpu_torch import workloads as wt
    dist = wt.random_tsp_distances(12, seed=4)
    assert np.array_equal(dist, wj.random_tsp_distances(12, seed=4))
    rs = np.random.RandomState(5)
    cfgs = [{"tour": [int(i) for i in rs.permutation(12)]}
            for _ in range(300)]
    a = np.asarray(wj.tsp_objective(dist)(cfgs))
    b = wt.tsp_objective(dist, device="cpu")(cfgs)
    assert a.dtype == b.dtype == np.float32
    np.testing.assert_array_max_ulp(a, b, maxulp=HOST_ULPS)


def test_host_objectives_default_to_the_card():
    """Without `device=` a host objective asks for the card, and a host
    without one raises."""
    import torch
    from uptune_tpu_torch import workloads as wt
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="cuda"):
        wt.rosenbrock_objective(2)
    with pytest.raises(RuntimeError, match="cuda"):
        wt.tsp_objective(np.eye(3))
