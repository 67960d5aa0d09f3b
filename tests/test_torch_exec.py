"""Program mode in the port (uptune_tpu_torch/exec/) against the JAX
package's `exec/`.

The space bridge and the template mode are held equal to the JAX
package's; the port's `ProgramTuner` runs in lockstep with the JAX one
at one worker without prefetch (the only width at which subprocess
completion order is fixed), with JAX's draws replayed into the port's
Tuner as `tests/test_torch_driver.py` does, and must leave the same
archive rows but their `time`, the same best.json and the same tells.
Wider runs are held by their invariants: the budget, no configuration
built twice, rules, constraints and models honoured.
"""
import json
import os
import sys
import textwrap
import time
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import uptune_tpu_torch
from uptune_tpu.api import constraint as JC
from uptune_tpu.api import session as JS
from uptune_tpu.driver.plugins import SearchHook as JHook
from uptune_tpu.exec import ProgramTuner as JPT
from uptune_tpu.exec import space_io as jio
from uptune_tpu.exec import template as jtpl
from uptune_tpu.exec import multistage as jms
from uptune_tpu.exec.pool import WorkerPool as JWorkerPool

import uptune_tpu_torch as ut
from uptune_tpu_torch.api import constraint as TC
from uptune_tpu_torch.api import session as TS
from uptune_tpu_torch.driver.plugins import SearchHook as THook
from uptune_tpu_torch.exec import ProgramTuner as TPT
from uptune_tpu_torch.exec import WorkerPool, call_program
from uptune_tpu_torch.exec import space_io as tio
from uptune_tpu_torch.exec import template as ttpl
from uptune_tpu_torch.exec import multistage as tms
from uptune_tpu_torch.workloads import gcc_like_records

from test_torch_driver import Replay, _recorder, archive_rows
from test_torch_driver import untraced_planes  # noqa: F401 (autouse)
from test_torch_ops import N, assert_bitwise

REPO = os.path.dirname(os.path.dirname(os.path.abspath(
    uptune_tpu_torch.__file__)))
ENV = {"PYTHONPATH": REPO}
CPU = torch.device("cpu")

# the JAX package's test_exec records (every kind the intrusive API
# records) and a few more kinds of the bridge
RECORDS = [
    {"name": "i", "type": "int", "default": 3, "lo": 1, "hi": 9},
    {"name": "f", "type": "float", "default": 0.5, "lo": 0.0, "hi": 2.0},
    {"name": "b", "type": "bool", "default": True},
    {"name": "e", "type": "enum", "default": "-O2",
     "options": ["-O1", "-O2", "-O3"]},
    {"name": "p", "type": "perm", "default": [0, 1, 2], "items": [0, 1, 2]},
    {"name": "p2", "type": "pow2", "default": 8, "lo": 1, "hi": 64},
    {"name": "ba", "type": "bool_array", "default": [0, 1, 0], "n": 3},
]

# a mixed program whose child imports the JAX package (as the unchanged
# samples do); i0 % 5 == 4 fails
MIXED_PROG = textwrap.dedent("""
    import uptune_tpu as ut
    x = [ut.tune(0.0, (-2.0, 2.0), name=f"x{i}") for i in range(3)]
    i0 = ut.tune(3, (0, 9), name="i0")
    e0 = ut.tune("b", ["a", "b", "c"], name="e0")
    b0 = ut.tune(False, name="b0")
    if i0 % 5 == 4:
        raise SystemExit(1)
    q = sum((v - 1.0) ** 2 for v in x) + 0.1 * i0
    q += {"a": 0.0, "b": 0.2, "c": 0.4}[e0] + (0.5 if b0 else 0.0)
    ut.target(q, "min")
""")

QUAD_PROG = textwrap.dedent("""
    import uptune_tpu_torch as ut
    x = ut.tune(50, (0, 100), name="x")
    y = ut.tune(50, (0, 100), name="y")
    ut.target(float((x - 37) ** 2 + (y - 11) ** 2), "min")
""")

MULTI_PROG = textwrap.dedent("""\
    import uptune_tpu as ut
    x = ut.tune(0, (0, 100), name="x")
    y = ut.tune(0, (0, 100), name="y")
    ut.interm([float(x), float(y)])
    ut.target(float((x - 60) ** 2 + (y - 20) ** 2), "min")
""")


@pytest.fixture(autouse=True)
def clean_registry(monkeypatch):
    for v in ("UT_BEFORE_RUN_PROFILE", "UT_TUNE_START", "BEST",
              "UT_WORK_DIR", "UT_MULTI_STAGE_SAMPLE"):
        monkeypatch.delenv(v, raising=False)
    for m in (JC, TC):
        m.REGISTRY.clear()
    for m in (JS, TS):
        m.reset_settings()
    yield
    for m in (JC, TC):
        m.REGISTRY.clear()


def _write(d, body, name="prog.py"):
    os.makedirs(d, exist_ok=True)
    p = os.path.join(d, name)
    with open(p, "w") as f:
        f.write(body)
    return p


def _rows(path):
    return [json.loads(x) for x in open(path)][1:]


# -- the space bridge --------------------------------------------------------
@pytest.mark.parametrize("which", ["exec_records", "gcc_like"])
def test_space_from_params_encodes_and_hashes_alike(which):
    recs = RECORDS if which == "exec_records" else gcc_like_records()
    sj, st = jio.space_from_params(recs), tio.space_from_params(recs)
    assert sj.signature() == st.signature()
    assert jio.default_config(recs) == tio.default_config(recs)
    assert jio.records_from_space(sj) == tio.records_from_space(st)
    # the defaults and 64 configurations drawn by the port
    from uptune_tpu_torch import rng
    cfgs = [tio.default_config(recs)] + st.to_configs(
        st.random(rng.generator(5, CPU), 64))
    cj, ct = sj.from_configs(cfgs), st.from_configs(cfgs, device="cpu")
    assert_bitwise(np.asarray(cj.u), N(ct.u), "u")
    for pj, pt in zip(cj.perms, ct.perms):
        assert_bitwise(np.asarray(pj).astype(np.int64), N(pt), "perm")
    assert_bitwise(np.asarray(sj.hash_batch(cj)).astype(np.int64),
                   N(st.hash_batch(ct)), "hashes")
    assert sj.to_configs(cj) == st.to_configs(ct)
    if which == "gcc_like":
        assert (len(st.specs), st.n_cat, st.cat_max_codes,
                st.n_surrogate_features) == (329, 233, 4, 1028)
    assert sj.search_space_size() == st.search_space_size()


TPL = textwrap.dedent("""\
    import uptune_tpu as ut
    a = 5           # {% a = TuneInt(5, (0, 50)) %}
    opt = '-O1'     # {% opt = TuneEnum('-O1', ['-O1','-O2','-O3'], 'level') %}
    flag = False    # {% flag = TuneBool(False) %}
    r = 0.5         # {% r = TuneFloat(0.5, (0.0, 1.0)) %}
    n = 16          # {% n = TuneLog(16, (1, 1024)) %}
    w = 8           # {% w = TunePow2(8, (2, 64)) %}
    p = [0, 1, 2]   # {% p = TunePermutation([0, 1, 2]) %}
    ut.target(float(a + (10 if opt == '-O1' else 0)), "min")
""")


@pytest.mark.parametrize("cfg", [None, {"a": 7, "level": "-O3",
                                        "flag": True, "p": [2, 0, 1]},
                                 {"a": 9}])
def test_template_extraction_and_rendering_equal(tmp_path, cfg):
    p = _write(str(tmp_path), TPL)
    tj, tt = jtpl.TemplateProgram(p), ttpl.TemplateProgram(p)
    assert tj.records == tt.records and len(tt.records) == 7
    assert tj.defaults() == tt.defaults()
    assert tj.render(cfg) == tt.render(cfg)
    for t, name in ((tj, "j.json"), (tt, "t.json")):
        t.write_params(str(tmp_path / name))
    assert (tmp_path / "j.json").read_bytes() == (
        tmp_path / "t.json").read_bytes()
    plain = _write(str(tmp_path), "print(1)\n", "plain.py")
    assert ttpl.detect_template(plain) is None
    assert jtpl.detect_template(plain) is None


# -- measurement and the pool -------------------------------------------------
def test_timeout_kills_the_process_group(tmp_path):
    """A child that spawns a grandchild and hangs: both are gone when
    call_program returns at its limit."""
    pid_file = tmp_path / "grandchild.pid"
    code = ("import subprocess, sys, time; "
            "p = subprocess.Popen([sys.executable, '-c', "
            "'import time; time.sleep(60)']); "
            f"open({str(pid_file)!r}, 'w').write(str(p.pid)); "
            "time.sleep(60)")
    t0 = time.time()
    res = call_program([sys.executable, "-c", code], limit=1.0)
    assert res["timeout"] and res["returncode"] < 0
    assert time.time() - t0 < 10
    pid = int(pid_file.read_text())
    for _ in range(50):
        try:
            os.kill(pid, 0)
        except ProcessLookupError:
            break
        time.sleep(0.05)
    else:
        pytest.fail(f"grandchild {pid} outlived the kill")


def test_pool_reads_interm_and_covariates_at_reap(tmp_path):
    """A trial's `ut.interm` vector and `ut.feature` covariates, as its
    child wrote them into the sandbox, come back in the result's info;
    a hung trial is killed and its sandbox rebuilt."""
    prog = _write(str(tmp_path), textwrap.dedent("""
        import time
        import uptune_tpu_torch as ut
        x = ut.tune(3, (0, 9), name="x")
        if x == 0:
            time.sleep(60)
        ut.feature(x + 1, "next")
        ut.interm([float(x), 2.0 * x])
        ut.target(float(x), "min")
    """))
    with open(tmp_path / "ut.params.json", "w") as f:
        json.dump([[{"name": "x", "type": "int", "default": 3, "lo": 0,
                     "hi": 9}]], f)
    with WorkerPool([sys.executable, prog], str(tmp_path), 2,
                    runtime_limit=4.0, env=ENV) as pool:
        pool.submit(SimpleNamespace(config={"x": 4}, gid=1))
        pool.submit(SimpleNamespace(config={"x": 0}, gid=2))
        out = {tr.gid: (q, info) for tr, q, _, info in pool.drain()}
        assert pool.replaced == 1 and pool.launched == 2
    q, info = out[1]
    assert q == 4.0 and info["interm"] == [4.0, 8.0]
    assert info["covars"] == {"next": 5}
    q, info = out[2]
    assert q is None and info["timeout"] and "interm" not in info


# -- the controller ------------------------------------------------------------
def test_program_tuner_lockstep_with_jax(tmp_path):
    """One worker, no prefetch: the port's ProgramTuner (the JAX
    package's draws replayed into its Tuner) tells the same trials in
    the same order and leaves the same archive, best.json and result
    as the JAX one, on a program whose child imports the JAX package."""
    limit = 40
    dj, dt = str(tmp_path / "jax"), str(tmp_path / "port")
    rj, rt = _recorder(JHook)(False), _recorder(THook)(True)
    kw = dict(parallel=1, prefetch=0, env=ENV, runtime_limit=30.0,
              test_limit=limit, seed=3, store_dir="off")
    pj = JPT([sys.executable, _write(dj, MIXED_PROG)], dj, hooks=[rj],
             compile_cache_dir="off", **kw)
    pt = TPT([sys.executable, _write(dt, MIXED_PROG)], dt, hooks=[rt],
             device="cpu", **kw)
    pj.analyze()
    pt.analyze()
    assert pj.params == pt.params and pj.default_qor == pt.default_qor
    jt = pj._make_tuner(jio.space_from_params(pj.params[0]))
    tt = pt._make_tuner(tio.space_from_params(pt.params[0]))
    rep = Replay(jt, tt)
    pj._make_tuner = lambda space: jt
    pt._make_tuner = lambda space: tt
    resj, rest = pj.run(), pt.run()
    assert rep.drained()
    assert rj.results == rt.results and len(rt.results) == limit
    assert any(r[3] is None for r in rt.results), "no trial failed"
    assert len({r[1] for r in rt.results}) >= 3
    assert (resj.best_config, resj.best_qor, resj.evals, resj.trace) == (
        rest.best_config, rest.best_qor, rest.evals, rest.trace)
    hj, aj = archive_rows(os.path.join(dj, "ut.archive.jsonl"))
    ht, at = archive_rows(os.path.join(dt, "ut.archive.jsonl"))
    assert hj == ht and aj == at and len(at) == limit
    best = [json.load(open(os.path.join(d, "best.json"))) for d in (dj, dt)]
    assert best[0] == best[1]
    assert best[1] == {"config": rest.best_config, "qor": rest.best_qor}
    assert pj.pool.launched == pt.pool.launched == limit - 1


def test_wide_run_keeps_budget_rules_constraints_models(tmp_path):
    """Four workers with prefetch: the budget holds, no configuration is
    built twice, a rule restricts what is built, a constraint fails
    what it rejects, and a model's proposal is tried (the optimum)."""
    @ut.rule()
    def x_small(cfg):
        return cfg["x"] <= 60

    @ut.constraint()
    def cap(qor, cfg):
        return qor < 3000.0

    @ut.model("oracle")
    def oracle(history, space):
        return {"x": 37, "y": 11}

    d = str(tmp_path)
    limit = 24
    pt = TPT([sys.executable, _write(d, QUAD_PROG)], d, parallel=4,
             env=ENV, runtime_limit=30.0, test_limit=limit, seed=9,
             device="cpu")
    res = pt.run()
    rows = _rows(os.path.join(d, "ut.archive.jsonl"))
    assert len(rows) == res.evals and limit <= res.evals <= limit + 4
    assert pt.pool.launched <= limit + 4
    cfgs = [json.dumps(r["cfg"], sort_keys=True) for r in rows]
    assert len(set(cfgs)) == len(cfgs), "a configuration was built twice"
    built = [r for r in rows if r["tech"] not in ("seed", "oracle")]
    assert built and all(r["cfg"]["x"] <= 60 for r in built)
    assert pt.tuner.filtered_total > 0
    assert any(r["tech"] == "oracle" for r in rows)
    assert res.best_qor == 0.0 and res.best_config == {"x": 37, "y": 11}
    # the constraint: a QoR of 3000 or more is told as a failure
    # (archived as +inf)
    qors = [r["qor"] for r in rows]
    assert all(q < 3000.0 or q == float("inf") for q in qors)
    assert float("inf") in qors
    assert 0.0 < pt.pool.utilization() <= 1.0


def test_decoupled_stages(tmp_path):
    """The decomposed sample: two stages tuned side by side, stage 1
    replaying stage 0's published best."""
    d = str(tmp_path)
    src = os.path.join(REPO, "samples", "decomposed", "decomposed.py")
    prog = _write(d, open(src).read(), "decomposed.py")
    pt = TPT([sys.executable, prog], d, parallel=2, env=ENV,
             runtime_limit=30.0, test_limit=8, seed=13, device="cpu")
    pt.analyze()
    assert tms.select_mode(pt) == "decouple" and len(pt.params) == 2
    res = tms.DecoupledTuner(pt).run()
    assert set(res.best_config) == {"scale", "unroll"}
    assert os.path.isfile(os.path.join(d, "configs", "0-best.json"))
    for s in range(2):
        rows = _rows(os.path.join(d, f"ut.archive_stage{s}.jsonl"))
        assert rows and all("tech" in r for r in rows)
    # the default pipeline's cost is 0.666 + |8 - 96| / 96
    assert res.best_qor < 1.58
    assert json.load(open(os.path.join(d, "best.json")))["config"] == (
        res.best_config)


def test_multistage_pre_post_epochs(tmp_path):
    d = str(tmp_path)
    pt = TPT([sys.executable, _write(d, MULTI_PROG)], d, parallel=2,
             env=ENV, runtime_limit=30.0, test_limit=8, seed=17,
             device="cpu")
    pt.analyze()
    assert tms.select_mode(pt) == "multistage"
    ms = tms.MultiStageTuner(pt, cand_factor=3, retrain_interval=1)
    res = ms.run()
    assert res.evals >= 8
    assert len(ms.surrogate._ys) >= 4
    assert res.best_qor < 60 ** 2 + 20 ** 2


def _settled_polls(monkeypatch):
    """Every poll of either package's WorkerPool waits until none of its
    slots is busy, so the stages of a decoupled run at one worker each
    take turns in a fixed order: a stage-1 trial always replays the
    stage-0 best published just before it, whatever the subprocesses'
    timing."""
    for cls in (JWorkerPool, WorkerPool):
        def poll(self, timeout=0.05, _poll=cls.poll):
            out = []
            while self.busy_count:
                out.extend(_poll(self, 0.1))
            return out
        monkeypatch.setattr(cls, "poll", poll)


def _archives_equal(dj, dt, name):
    hj, aj = archive_rows(os.path.join(dj, name))
    ht, at = archive_rows(os.path.join(dt, name))
    assert hj == ht and aj == at, name
    return at


def _json_files_equal(dj, dt, name):
    pj, pt = os.path.join(dj, name), os.path.join(dt, name)
    assert os.path.isfile(pj) == os.path.isfile(pt), name
    if os.path.isfile(pt):
        assert json.load(open(pj)) == json.load(open(pt)), name


def test_decoupled_lockstep_with_jax(tmp_path, monkeypatch):
    """The decomposed sample's two stages at one worker each, polls
    settled: the port's DecoupledTuner (the JAX package's draws replayed
    into each stage's Tuner) tells the same trials in the same order and
    leaves the same stage archives but for `time`, the same
    configs/<s>-best.json, best.json and merged result as the JAX one."""
    _settled_polls(monkeypatch)
    limit = 8
    dj, dt = str(tmp_path / "jax"), str(tmp_path / "port")
    src = open(os.path.join(REPO, "samples", "decomposed",
                            "decomposed.py")).read()
    rj, rt = _recorder(JHook)(False), _recorder(THook)(True)
    kw = dict(parallel=1, prefetch=0, env=ENV, runtime_limit=30.0,
              test_limit=limit, seed=13, store_dir="off")
    pj = JPT([sys.executable, _write(dj, src, "decomposed.py")], dj,
             hooks=[rj], compile_cache_dir="off", **kw)
    pt = TPT([sys.executable, _write(dt, src, "decomposed.py")], dt,
             hooks=[rt], device="cpu", **kw)
    pj.analyze()
    pt.analyze()
    assert pj.params == pt.params and len(pt.params) == 2
    assert jms.select_mode(pj) == tms.select_mode(pt) == "decouple"
    # each stage's pair of tuners is made when the JAX run makes its
    # tuner (the replay converts the fresh states), from the arguments
    # the port's run must then pass
    stages = []
    jax_tuner, port_tuner = jms.Tuner, tms.Tuner

    def make_jax(space, objective, **k):
        s = len(stages)
        assert k["label"] == f"stage{s}"
        jt = jax_tuner(space, objective, **k)
        tk = dict(k, archive=k["archive"].replace(dj, dt), hooks=pt.hooks,
                  device=pt.device)
        tt = port_tuner(tio.space_from_params(pt.params[s]), objective,
                        **tk)
        stages.append((tt, Replay(jt, tt), tk))
        return jt

    def make_port(space, objective, **k):
        tt, _, tk = stages[int(k["label"][len("stage"):])]
        assert k == tk and objective is None
        assert space.signature() == tt.space.signature()
        return tt
    monkeypatch.setattr(jms, "Tuner", make_jax)
    monkeypatch.setattr(tms, "Tuner", make_port)
    resj = jms.DecoupledTuner(pj).run()
    rest = tms.DecoupledTuner(pt).run()
    assert len(stages) == 2 and all(rep.drained() for _, rep, _ in stages)
    assert rj.results == rt.results
    assert {r[2].keys() == {"scale"} for r in rt.results} == {True, False}
    assert (resj.best_config, resj.best_qor, resj.evals, resj.steps,
            resj.trace) == (rest.best_config, rest.best_qor, rest.evals,
                            rest.steps, rest.trace)
    assert set(rest.best_config) == {"scale", "unroll"}
    for s in range(2):
        assert _archives_equal(dj, dt, f"ut.archive_stage{s}.jsonl")
        _json_files_equal(dj, dt, os.path.join("configs", f"{s}-best.json"))
    assert os.path.isfile(os.path.join(dt, "configs", "0-best.json"))
    _json_files_equal(dj, dt, "best.json")
    assert json.load(open(os.path.join(dt, "best.json"))) == {
        "config": rest.best_config, "qor": rest.best_qor}


def test_multistage_lockstep_with_jax(tmp_path):
    """Pre/post epochs at one post worker (three pre workers, whose
    feature vectors are placed by trial): the port's MultiStageTuner
    (JAX's draws replayed into its Tuner, its own surrogate on the
    port's GP) promotes and tells the same trials in the same order as
    the JAX one, also in the epochs after the feature surrogate is
    fitted, and leaves the same archive, best.json and result."""
    limit = 16
    dj, dt = str(tmp_path / "jax"), str(tmp_path / "port")
    rj, rt = _recorder(JHook)(False), _recorder(THook)(True)
    kw = dict(parallel=1, prefetch=0, env=ENV, runtime_limit=30.0,
              test_limit=limit, seed=17, store_dir="off")
    pj = JPT([sys.executable, _write(dj, MULTI_PROG)], dj, hooks=[rj],
             compile_cache_dir="off", **kw)
    pt = TPT([sys.executable, _write(dt, MULTI_PROG)], dt, hooks=[rt],
             device="cpu", **kw)
    pj.analyze()
    pt.analyze()
    assert pj.params == pt.params and pj.default_qor == pt.default_qor
    assert jms.select_mode(pj) == tms.select_mode(pt) == "multistage"
    jt = pj._make_tuner(jio.space_from_params(pj.params[0]))
    tt = pt._make_tuner(tio.space_from_params(pt.params[0]))
    rep = Replay(jt, tt)
    pj._make_tuner = lambda space: jt
    pt._make_tuner = lambda space: tt
    mj = jms.MultiStageTuner(pj, cand_factor=3, retrain_interval=1)
    mt = tms.MultiStageTuner(pt, cand_factor=3, retrain_interval=1)
    picked = []
    select = mt._select

    def record(trials, feats):
        out = select(trials, feats)
        picked.append(mt.surrogate.fitted)
        return out
    mt._select = record
    resj, rest = mj.run(), mt.run()
    assert rep.drained()
    assert rj.results == rt.results and len(rt.results) >= limit - 1
    # the fitted surrogate chose the survivors of several epochs
    assert picked.count(True) >= 3
    assert mj.surrogate._ys == mt.surrogate._ys
    assert (resj.best_config, resj.best_qor, resj.evals, resj.trace) == (
        rest.best_config, rest.best_qor, rest.evals, rest.trace)
    assert len(_archives_equal(dj, dt, "ut.archive.jsonl")) == rest.evals
    _json_files_equal(dj, dt, "best.json")
    assert json.load(open(os.path.join(dt, "best.json"))) == {
        "config": rest.best_config, "qor": rest.best_qor}


@pytest.mark.parametrize("n", [40, 300])
def test_feature_surrogate_matches_jax(n):
    """`_FeatureSurrogate` on the port's GP scores within the GP's
    tolerance of the JAX package's on the same observations; past
    max_points it subsamples from its own key (shapes only)."""
    r = np.random.RandomState(n)
    xs = r.rand(n, 5).astype(np.float32) * [1, 10, 100, 1, 5]
    ys = (xs[:, 0] * 3 + np.sin(xs[:, 1]) + xs[:, 2] / 50).astype(
        np.float32)
    fj = jms._FeatureSurrogate(seed=3, max_points=256)
    ft = tms._FeatureSurrogate(seed=3, max_points=256, device="cpu")
    for f in (fj, ft):
        for x, y in zip(xs, ys):
            f.observe(x, float(y))
        f.observe(None, 1.0)
        f.observe(xs[0], float("nan"))
        f.refit()
    q = r.rand(64, 5).astype(np.float32) * [1, 10, 100, 1, 5]
    st = ft.scores(q)
    assert st.shape == (64,) and np.isfinite(st).all()
    assert ft._state.x.shape[0] == min(n, 256)
    if n <= 256:
        np.testing.assert_allclose(st, fj.scores(q), rtol=1e-4,
                                   atol=1e-5 * float(ys.std()))
