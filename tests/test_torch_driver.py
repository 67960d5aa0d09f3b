"""Parity of the port's `Tuner` (uptune_tpu_torch/driver/driver.py) with
the JAX package's, plus the port's own driver runs.

Lockstep: both tuners run the same script on one small mixed space (four
floats, an int, a log-int, a bool, an enum and an 8-city tour) under the
default portfolio (AUCBanditMetaTechniqueA) with one numpy objective, so
the reduction order of an objective cannot perturb the trajectory.  The
port's initial technique states are the JAX tuner's
(`convert.from_jax_tstate`), and its draws are JAX's, replayed
(`Replay`): every key JAX splits for an arm pull, a saturation injection
or an observe is recorded as the port's draws for the same call, and a
restart's fresh JAX state is converted.  Over every ticket these are
equal: the arm, the trials' gids and configs, `StepStats` but its
timings, the history state (h0, h1, qor, age and the counters) bitwise
after each ticket; and at the end the archive rows but their `time`, the
trace, the best and every arm's state (the JAX PRNG keys left out).

Both tuners run untraced (`untraced_planes`): a traced JAX `Tuner` counts
its compiles in `StepStats.n_compiles` and the port compiles nothing, so
a test that runs one beside the other turns neither package's `obs`
plane on, whatever an earlier test of the process left on.

The JAX tuner runs its own jitted programs, but for the proposals XLA
would contract into fused multiply-adds (`EAGER`).  Both packages'
archives resume under the other with equal state.
"""
import contextlib
import json
import math
import random
import re
from collections import defaultdict, deque

import jax
import numpy as np
import pytest
import torch

import uptune_tpu.obs as jobs
from uptune_tpu.driver import Tuner as JTuner
from uptune_tpu.driver.plugins import SearchHook as JHook
from uptune_tpu.space import params as JP
from uptune_tpu.space.spec import CandBatch as JCand
from uptune_tpu.space.spec import pad_cands
from uptune_tpu.space.spec import Space as JSpace
from uptune_tpu.techniques import base as jbase
from uptune_tpu.techniques.bandit import RecyclingMeta as JRecycling

import uptune_tpu_torch.obs as tobs
from uptune_tpu_torch import convert
from uptune_tpu_torch.driver import Tuner as TTuner
from uptune_tpu_torch.driver.plugins import SearchHook as THook
from uptune_tpu_torch.space import params as TP
from uptune_tpu_torch.space.spec import CandBatch as TCand
from uptune_tpu_torch.space.spec import Space as TSpace
from uptune_tpu_torch.techniques import base as tbase
from uptune_tpu_torch.techniques.bandit import RecyclingMeta as TRecycling

from test_torch_engine import _np_tree, assert_states_equal
from test_torch_ops import N, assert_bitwise, jcands_to_t
from test_torch_techniques import _mixed_specs, replay_observe, replay_propose

CPU = torch.device("cpu")
CAP = 1024
STEPS = 32
ENUM = {"a": 0.0, "b": 0.2, "c": 0.4}


# -- the obs planes, untraced around a test ----------------------------------------
_JOURNAL_STATE = ("_ENABLED", "_T0", "_PATH", "_F")


@contextlib.contextmanager
def untraced():
    """Both packages' `obs` planes reset for the block: the span flag off
    and the rings and metrics dropped, no journal and no device trace;
    afterwards each plane is as it was (the flag on again if it was, a
    journal left open by an earlier test put back untouched, a device
    trace that was running restarted into its directory)."""
    saved = []
    for plane in (jobs, tobs):
        jrn = tuple(getattr(plane.journal, f) for f in _JOURNAL_STATE)
        trace = dict(plane.device._TRACE)
        buf = list(plane.journal._BUF)
        saved.append((plane, plane.enabled(), jrn, buf, trace))
        if trace["active"]:
            plane.device.stop_trace()
        plane.journal._ENABLED, plane.journal._PATH = False, None
        plane.journal._F = None
        plane.reset()
    try:
        yield
    finally:
        for plane, on, jrn, buf, trace in saved:
            plane.journal.stop()
            plane.device.stop_trace()
            plane.reset()
            if on:
                plane.enable()
            for f, v in zip(_JOURNAL_STATE, jrn):
                setattr(plane.journal, f, v)
            plane.journal._BUF[:] = buf
            plane.device._TRACE.update(dir=trace["dir"])
            if trace["active"]:
                plane.device.start_trace(trace["dir"])


@pytest.fixture(autouse=True)
def untraced_planes():
    """Every test of a file that runs a JAX tuner beside the port's runs
    with both `obs` planes untraced (`untraced`); a case meant to be
    traced turns tracing on itself, on both sides.  The lockstep files
    import this fixture."""
    with untraced():
        yield


def _spaces(specs=_mixed_specs):
    return JSpace(specs(JP)), TSpace(specs(TP))


def objective(cfgs):
    """A numpy objective of a mixed-space config; a config with i0 % 5
    == 4 fails (NaN)."""
    out = []
    for c in cfgs:
        if c["i0"] % 5 == 4:
            out.append(float("nan"))
            continue
        q = sum((c[f"x{i}"] - 1.0) ** 2 for i in range(4))
        q += 0.1 * c["i0"] + 0.01 * math.log2(c["li0"])
        q += (0.5 if c["b0"] else 0.0) + ENUM[c["e0"]]
        q += 0.05 * sum(abs(p - i) for i, p in enumerate(c["tour"]))
        out.append(q)
    return np.asarray(out, np.float64)


def rejects_some(c):
    """A config filter that rejects about one config in seven."""
    return (c["i0"] + int(c["b0"])) % 7 != 3


# -- replayed draws ------------------------------------------------------------
# arms whose propose XLA contracts into fused multiply-adds when jitted
# (DE's a + F (b - c), the normal mutation's u + sigma z): the port has no
# FMA, so the JAX side runs these proposals eagerly, op by op.  Every
# other program is the JAX tuner's own jitted one (NelderMead's centroid
# follows jit's multiply by the reciprocal of S, as the port does).
EAGER = {"DifferentialEvolutionAlt", "NormalGreedyMutation"}


class Replay:
    """Records, as the port's draws, the numbers the JAX tuner `jt` draws,
    and feeds them to the port tuner `tt` in the same order: a FIFO per
    arm for propose and observe draws and restarts' fresh states, and
    one for saturation injections (`Space.random` called by the driver
    itself, outside every technique function).  The port's initial
    states become the JAX tuner's."""

    def __init__(self, jt: JTuner, tt: TTuner):
        self.prop = defaultdict(deque)
        self.obs = defaultdict(deque)
        self.init = defaultdict(deque)
        self.rand = deque()
        self.on = True
        for name, t in jt._member_by_name.items():
            jt._propose_jit[name] = self._propose(jt, t,
                                                  jt._propose_jit[name])
            jt._observe_jit[name] = self._observe(jt, t,
                                                  jt._observe_jit[name])
        make = jt._make_observe
        jt._make_observe = lambda t, donate: self._observe(
            jt, t, make(t, donate))
        sp = jt.space
        random_j = sp.random

        def rand(key, n):
            out = random_j(key, n)
            if self.on:
                self.rand.append(jcands_to_t(out))
            return out
        sp.random = rand
        for name, t in jt._member_by_name.items():
            init_j = t.init_state

            def init(space, key, _init=init_j, _n=name):
                st = self._quiet(_init, space, key)
                self.init[_n].append(convert.from_jax_tstate(_np_tree(st),
                                                             CPU))
                return st
            t.init_state = init
        tt._draw_propose = lambda t, k: self.prop[t.name].popleft()
        tt._draw_observe = lambda t, k: self.obs[t.name].popleft()
        tt._draw_random = lambda n, k: self.rand.popleft()
        for name, t in tt._member_by_name.items():
            t.init_state = (lambda space, draws, _n=name:
                            self.init[_n].popleft())
        for name, st in jt._tstates.items():
            tt._tstates[name] = convert.from_jax_tstate(_np_tree(st), CPU)

    def _quiet(self, fn, *args):
        self.on = False
        try:
            return fn(*args)
        finally:
            self.on = True

    def _propose(self, jt, t, program):
        sp = jt.space

        def eager(st, k, best, hs):
            """The program's steps with the technique run op by op."""
            with jax.disable_jit():
                st2, c = t.propose(sp, st, k, best)
            cp = pad_cands(c, jt._bucket)
            hashes, _, known, src, novel = jt._dedup(hs, cp)
            return st2, cp, hashes, known, src, novel

        fn = eager if t.name in EAGER else program

        def rec(st, k, best, hs):
            self.prop[t.name].append(self._quiet(replay_propose, t, sp, k))
            return self._quiet(fn, st, k, best, hs)
        return rec

    def _observe(self, jt, t, program):
        def rec(st, c, q, best):
            self.obs[t.name].append(self._quiet(replay_observe, t, jt.space,
                                                st))
            return self._quiet(program, st, c, q, best)
        return rec

    def drained(self) -> bool:
        return not (self.rand or any(self.prop.values())
                    or any(self.obs.values()) or any(self.init.values()))


def _hist_np(st, port: bool) -> dict:
    out = {}
    for f in ("h0", "h1", "qor", "age", "n", "step", "dropped"):
        x = getattr(st, f)
        out[f] = np.array(N(x) if port else x).astype(
            np.float32 if f == "qor" else np.int64)
    return out


def _recorder(base):
    class Rec(base):
        """Every trial told and every ticket finalized, with the history
        right after it."""

        def __init__(self, port):
            self.port = port
            self.results, self.steps = [], []

        def on_result(self, tuner, trial, qor):
            self.results.append((trial.gid, trial.ticket.arm_name,
                                 trial.config, qor))

        def on_step(self, tuner, stats):
            self.steps.append((stats._replace(
                t_propose=0.0, t_dedup=0.0, t_eval_wait=0.0, t_refit=0.0,
                t_compile=0.0), _hist_np(tuner.hist_state, self.port)))
    return Rec


def make_pair(tmp_path=None, spaces=None, **kw):
    """(JAX tuner, port tuner, JAX recorder, port recorder, replay) on
    one space (default the mixed one) with the same arguments; a
    `technique` or `surrogate` given as a tuple is the pair (JAX's, the
    port's)."""
    sj, st = spaces or _spaces()
    kj, kt = dict(kw), dict(kw)
    for k in ("technique", "surrogate"):
        if isinstance(kw.get(k), tuple):
            kj[k], kt[k] = kw[k]
    rj, rt = _recorder(JHook)(False), _recorder(THook)(True)
    if tmp_path is not None:
        kj["archive"] = str(tmp_path / "jax.jsonl")
        kt["archive"] = str(tmp_path / "port.jsonl")
    for k in (kj, kt):
        k.setdefault("capacity", CAP)
        k.setdefault("objective", objective)
    jt = JTuner(sj, hooks=[rj], **kj)
    tt = TTuner(st, hooks=[rt], device="cpu", **kt)
    return jt, tt, rj, rt, Replay(jt, tt)


def archive_rows(path):
    lines = [json.loads(x) for x in open(path)]
    return lines[0], [{k: v for k, v in r.items() if k != "time"}
                      for r in lines[1:]]


def assert_tuners_equal(jt, tt, rj, rt, rep, min_tickets=STEPS):
    """Every ticket, the final state and the archives equal."""
    assert rep.drained(), "the port did not take every draw JAX made"
    assert len(rj.steps) == len(rt.steps) >= min_tickets
    assert rj.results == rt.results
    for i, ((sj, hj), (st, ht)) in enumerate(zip(rj.steps, rt.steps)):
        assert sj == st, (i, sj, st)
        for f in hj:
            assert_bitwise(hj[f], ht[f], f"ticket {i} hist.{f}")
    resj, rest = jt.result(), tt.result()
    assert resj.best_config == rest.best_config
    assert (resj.best_qor, resj.evals, resj.steps, resj.trace) == (
        rest.best_qor, rest.evals, rest.steps, rest.trace)
    assert jt.arm_stats == tt.arm_stats
    assert (jt.told, jt.gid, jt.pruned_total, jt.filtered_total) == (
        tt.told, tt.gid, tt.pruned_total, tt.filtered_total)
    assert sorted(jt._tstates) == sorted(tt._tstates)
    for name in jt._tstates:
        assert_states_equal(jt._tstates[name], tt._tstates[name], name)
    for f in ("u", "qor"):
        assert_bitwise(getattr(jt.best, f), N(getattr(tt.best, f)),
                       f"best.{f}")
    if jt.archive_path:
        jt._flush_archive()
        tt._flush_archive()
        hj, aj = archive_rows(jt.archive_path)
        ht, at = archive_rows(tt.archive_path)
        assert hj == ht and aj == at and len(aj) == resj.evals
        # byte for byte but the time field
        lj, lt = ([re.sub(r'"time": [^,]*, ', "", x) for x in open(p)]
                  for p in (jt.archive_path, tt.archive_path))
        assert lj == lt


# -- lockstep cases -------------------------------------------------------------
@pytest.mark.parametrize("sense", ["min", "max"])
def test_step_lockstep(tmp_path, sense):
    """`step()` under the default portfolio with a config filter,
    failures (+inf) and an archive."""
    jt, tt, rj, rt, rep = make_pair(tmp_path, seed=3, sense=sense,
                                    config_filter=rejects_some)
    steps = STEPS if sense == "min" else 12
    for _ in range(steps):
        jt.step()
        tt.step()
    assert jt.filtered_total > 0
    assert any(r[3] is None for r in rt.results), "no failure was told"
    assert len({s.technique for s, _ in rt.steps}) >= 3
    assert_tuners_equal(jt, tt, rj, rt, rep, min_tickets=steps)


def test_lockstep_holds_after_a_traced_reference_test(tmp_path):
    """A reference test that turns the JAX plane on and leaves it on
    (tests/test_serve.py's TestDistributedObs does) does not reach the
    lockstep: traced, the JAX tuner would count its compiles in
    `StepStats.n_compiles`.  Run through `untraced`, the lockstep holds,
    and the plane reads as the earlier test left it."""
    if not jobs.enabled():
        jobs.enable()
    with untraced():
        assert not jobs.enabled() and not tobs.enabled()
        jt, tt, rj, rt, rep = make_pair(tmp_path, seed=3)
        for _ in range(4):
            jt.step()
            tt.step()
        assert_tuners_equal(jt, tt, rj, rt, rep, min_tickets=4)
        assert all(s.n_compiles == 0 for s, _ in rj.steps)
    assert jobs.enabled() and not tobs.enabled()


def _ask_tell_script(tuner):
    """Overlapping asks told in a seeded shuffled order, one ticket fully
    and one partly cancelled; an inject with padding rows; preload and
    preload_rows (exact and re-encoded); then plain steps."""
    a = tuner.ask(min_trials=60)
    b = tuner.ask(min_trials=20)
    trials = a + b
    tickets = list(dict.fromkeys(tr.ticket for tr in trials))
    assert len(tickets) >= 3
    full, part = tickets[0], tickets[1]
    order = list(range(len(trials)))
    random.Random(5).shuffle(order)
    vals = objective([tr.config for tr in trials])
    for i in order:
        tr = trials[i]
        if tr.ticket is full or (tr.ticket is part and tr.slot % 2):
            tuner.cancel(tr)
        else:
            tuner.tell(tr, vals[i])
    seeds = [dict(trials[0].config), dict(trials[3].config),
             dict(trials[5].config, x0=0.25)]
    inj = tuner.inject(seeds)
    for tr, v in zip(inj, objective([tr.config for tr in inj])):
        tuner.tell(tr, v)
    space = tuner.space
    rs = np.random.RandomState(11)
    u = rs.rand(40, space.n_scalar).astype(np.float32)
    perms = [np.stack([rs.permutation(s) for _ in range(40)])
             for s in space.perm_sizes]
    tuner.preload(u[:20], [p[:20] for p in perms],
                  np.linspace(5.0, 9.0, 20), refit=False)
    cfgs = tuner.space.to_configs(
        (JCand if isinstance(tuner, JTuner) else TCand)(
            *((u, tuple(perms)) if isinstance(tuner, JTuner) else
              (torch.from_numpy(u), tuple(torch.from_numpy(p.astype(
                  np.int64)) for p in perms)))))
    rows = [{"cfg": cfgs[i], "qor": 3.0 + 0.1 * i,
             **({"u": u[i].tolist(), "perms": [p[i].tolist() for p in perms]}
                if i % 2 else {})} for i in range(20, 40)]
    tuner.preload_rows(rows)
    for _ in range(12):
        tuner.step()


def test_ask_tell_lockstep(tmp_path):
    jt, tt, rj, rt, rep = make_pair(tmp_path, seed=4)
    _ask_tell_script(jt)
    _ask_tell_script(tt)
    assert_tuners_equal(jt, tt, rj, rt, rep, min_tickets=12)
    assert not tt._pending and not jt._pending


def _tiny_specs(P):
    return [P.IntParam("a", 0, 5), P.IntParam("b", 0, 3)]


def test_saturation_injection_lockstep():
    """A 24-config space: the arms saturate, the driver injects random
    batches, and the run ends when nothing novel is left."""
    def obj(cfgs):
        return np.asarray([(c["a"] - 2) ** 2 + c["b"] for c in cfgs], float)
    jt, tt, rj, rt, rep = make_pair(spaces=_spaces(_tiny_specs),
                                    objective=obj, seed=1)
    rj_res, rt_res = jt.run(test_limit=100), tt.run(test_limit=100)
    assert rt_res.evals == 24 and rt_res.best_qor == 0.0
    assert any(s.technique == "random" for s, _ in rt.steps)
    assert_tuners_equal(jt, tt, rj, rt, rep, min_tickets=20)
    assert rj_res.trace == rt_res.trace


def _recycling(base, meta):
    """The default portfolio's members under RecyclingMeta, window 4."""
    return meta(base.get_root().techniques, name="Recycling4", window=4)


def test_recycling_restart_lockstep():
    """RecyclingMeta with a 4-pull window restarts members mid-run; the
    restarted member's fresh state comes from JAX's, and tickets opened
    before a restart do not observe over it."""
    jt, tt, rj, rt, rep = make_pair(
        seed=6, technique=(_recycling(jbase, JRecycling),
                           _recycling(tbase, TRecycling)))
    for _ in range(24):
        jt.step()
        tt.step()
    assert tt.root.restart_count == jt.root.restart_count > 0
    assert max(tt._tgen.values()) > 0
    assert_tuners_equal(jt, tt, rj, rt, rep, min_tickets=24)


# -- a duck-typed surrogate -------------------------------------------------------
def _stub(cand_cls, to_arr, **opts):
    class Stub:
        """A deterministic surrogate: keeps every other novel row, fits
        after 16 observed rows, and proposes a fixed pool (40 seeded rows,
        a window that moves each pull)."""
        propose_every = 3
        propose_batch_parity = False
        passive = False

        def __init__(self, space):
            rs = np.random.RandomState(2)
            self.u = rs.rand(400, space.n_scalar).astype(np.float32)
            self.perms = [np.stack([rs.permutation(s) for _ in range(400)])
                          for s in space.perm_sizes]
            self.n_obs = 0
            self.pulls = 0
            self.observed = []
            self.refits = 0
            self.arbitration = opts.get("arbitration", "")
            self.auto_passive = opts.get("auto_passive", False)
            self.propose_batch = 12

        @property
        def fitted(self):
            return self.n_obs >= 16

        def keep_mask(self, cands, novel):
            return np.arange(len(novel)) % 2 == 0

        def propose_pool(self, key, best_u, best_perms, best_q):
            s = 13 * self.pulls % 360
            self.pulls += 1
            return cand_cls(to_arr(self.u[s:s + 40]),
                            tuple(to_arr(p[s:s + 40]) for p in self.perms))

        def observe(self, feats, qor):
            self.n_obs += len(qor)
            self.observed.append((np.asarray(feats).copy(),
                                  np.asarray(qor).copy()))

        def maybe_refit(self):
            self.refits += 1
            return False

        def close(self):
            pass
    return Stub


def _stubs(space_j, space_t, **opts):
    import jax.numpy as jnp
    sj = _stub(JCand, lambda a: jnp.asarray(
        a.astype(np.int32) if a.dtype.kind == "i" else a), **opts)(space_j)
    st = _stub(TCand, lambda a: torch.from_numpy(
        a.astype(np.int64) if a.dtype.kind == "i" else a), **opts)(space_t)
    return sj, st


@pytest.mark.parametrize("plane", ["scheduled", "budget_rule"])
def test_stub_surrogate_lockstep(plane):
    """The prune (keep_mask), the scheduled plane (every third
    acquisition once fitted) and, under the run-budget rule (a budget
    below the 8 scalar lanes), the bandit's virtual arm."""
    spaces = _spaces()
    opts = {"auto_passive": True} if plane == "budget_rule" else {}
    sj, st = _stubs(*spaces, **opts)
    jt, tt, rj, rt, rep = make_pair(spaces=spaces, seed=8,
                                    surrogate=(sj, st))
    if plane == "budget_rule":
        with pytest.warns(UserWarning, match="BUDGET-CONSTRAINED"):
            jt.run(test_limit=7)
        with pytest.warns(UserWarning, match="BUDGET-CONSTRAINED"):
            tt.run(test_limit=7)
        assert tt._surr_arm and "surrogate" in tt.root.virtual_arms
        assert st.propose_batch == 8
    for _ in range(16):
        jt.step()
        tt.step()
    techs = [s.technique for s, _ in rt.steps]
    assert "surrogate" in techs and tt.pruned_total > 0
    assert_tuners_equal(jt, tt, rj, rt, rep, min_tickets=16)
    assert len(sj.observed) == len(st.observed) > 0
    for (fj, qj), (ft, qt) in zip(sj.observed, st.observed):
        assert_bitwise(fj, ft, "surrogate features")
        assert_bitwise(qj, qt, "surrogate qor")
    assert sj.refits == st.refits


# -- archives across packages -------------------------------------------------------
def _resumed_state(t, port):
    r = t.result()
    return (r.evals, r.trace, r.best_qor, r.best_config, t.gid,
            _hist_np(t.hist_state, port))


def _assert_resumed_equal(a, b):
    assert a[:5] == b[:5]
    for f in a[5]:
        assert_bitwise(a[5][f], b[5][f], f"resumed hist.{f}")


def test_archives_resume_across_packages(tmp_path):
    """A JAX-written archive resumes under the port and a port-written
    one under JAX, with equal evals, trace, best and history; each
    package resuming its own archive agrees too."""
    jt, tt, _, _, _ = make_pair(tmp_path, seed=2)
    for _ in range(8):
        jt.step()
        tt.step()
    jt.close()
    tt.close()
    sj, st = _spaces()
    for path in (jt.archive_path, tt.archive_path):
        j2 = JTuner(sj, objective, capacity=CAP, archive=path, resume=True)
        t2 = TTuner(st, objective, capacity=CAP, archive=path, resume=True,
                    device="cpu")
        _assert_resumed_equal(_resumed_state(j2, False),
                              _resumed_state(t2, True))
        assert t2.evals == jt.evals
        j2.close()
        t2.close()


# -- the port's own runs (tests/test_driver.py, tests/test_prefetch.py) ----------
def _ros(dims, lo=-3.0, hi=3.0):
    from uptune_tpu_torch.workloads import rosenbrock_space
    return rosenbrock_space(dims, lo, hi)


def _ros_obj(dims):
    from uptune_tpu_torch.workloads import rosenbrock_objective
    return rosenbrock_objective(dims, device="cpu")


def _tuner(space, obj, **kw):
    kw.setdefault("capacity", CAP)
    return TTuner(space, obj, device="cpu", **kw)


def test_rosenbrock_converges():
    t = _tuner(_ros(2), _ros_obj(2), seed=1)
    res = t.run(test_limit=700)
    assert res.best_qor < 1.0, res.best_qor
    assert res.evals >= 700
    assert all(b <= a + 1e-9 for a, b in zip(res.trace, res.trace[1:]))


def test_no_duplicate_evaluations():
    space = TSpace([TP.IntParam("a", 0, 3),
                    TP.EnumParam("e", ("p", "q", "r"))])
    seen = []

    def obj(cfgs):
        seen.extend(tuple(sorted(c.items())) for c in cfgs)
        return [hash(tuple(sorted(c.items()))) % 7 for c in cfgs]

    t = _tuner(space, obj, seed=2, technique="UniformGreedyMutation05")
    t.run(test_limit=60)
    assert len(seen) == len(set(seen)) == 12


def test_dry_arm_backoff():
    """Once an arm's proposals are all duplicates it is skipped for a few
    acquisitions: past saturation a step costs about one propose, not
    one per arm."""
    space = TSpace([TP.IntParam("i", 0, 17)])
    t = _tuner(space, lambda cfgs: [c["i"] for c in cfgs], seed=0)
    calls = defaultdict(int)
    draw = t._draw_propose

    def counted(tech, key):
        calls[tech.name] += 1
        return draw(tech, key)
    t._draw_propose = counted
    t.run(test_limit=100)
    assert t.evals <= 18 and t._arm_dry
    assert sum(calls.values()) <= 2 * t.steps + 2 * len(t.members), (
        dict(calls), t.steps)


def test_every_arm_pulled():
    t = _tuner(_ros(2, -5.0, 5.0), _ros_obj(2), seed=7)
    used = {t.step().technique for _ in range(25)}
    assert len(used) >= 2, used


def test_overlapping_asks_never_duplicate_inflight():
    space = TSpace([TP.IntParam("a", 0, 200), TP.IntParam("b", 0, 200)])
    t = _tuner(space, None, seed=3)
    first = t.ask(min_trials=4)
    second = t.ask(min_trials=4)
    key = lambda c: tuple(sorted(c.items()))  # noqa: E731
    assert not {key(x.config) for x in first} & {key(x.config)
                                                 for x in second}
    for tr in second + first:
        t.tell(tr, float(tr.config["a"]))
    assert t.told == t.evals == len(first) + len(second)
    assert t.inject([first[0].config]) == []


def test_fully_cancelled_ticket_gets_no_observe_and_no_credit():
    t = _tuner(_ros(4), None, seed=9, technique="DifferentialEvolutionAlt")
    for tr in t.ask(min_trials=1):
        t.tell(tr, 100.0 + tr.gid)
    evals0 = t.evals
    spec = t.ask(min_trials=1)
    name = spec[0].ticket.arm.name
    before = t._tstates[name]
    for tr in spec:
        t.cancel(tr)
    assert t._tstates[name] is before and t.evals == evals0
    again = t.inject([spec[0].config])
    assert len(again) == 1, "a cancelled config can be proposed again"
    t.tell(again[0], 5.0)


def test_forwarding_technique_with_two_tickets_in_flight():
    """An arm whose propose returns its state unchanged: two tickets in
    flight share the state tensors, and each observe starts from that
    shared state without writing into it."""
    from uptune_tpu_torch.techniques.base import Technique

    class Forwarding(Technique):
        def natural_batch(self, space):
            return 8

        def init_state(self, space, draws):
            return (torch.zeros((4,)),)

        def draw_propose(self, space, gen):
            return space.random(gen, 8)

        def propose(self, space, state, best, draws):
            return state, draws

        def observe(self, space, state, cands, qor, best, draws=None):
            return (state[0] + 1.0,)

    t = _tuner(_ros(4), None, seed=7, technique=Forwarding("fwd"))
    a = t.ask(min_trials=1)
    b = t.ask(min_trials=1)
    assert a[0].ticket.tstate is b[0].ticket.tstate
    for tr in a + b:
        t.tell(tr, float(tr.gid))
    assert float(t._tstates["fwd"][0][0]) == 1.0
    assert float(a[0].ticket.tstate[0][0]) == 0.0


def test_padding_rows_never_become_trials():
    t = _tuner(_ros(2), None, seed=4)
    trials = t.ask(min_trials=1)
    tk = trials[0].ticket
    assert tk.cands.batch == t._bucket
    for tr in tk.trials:
        assert tk.src[tr.row] == tr.row
    for tr in trials:
        t.tell(tr, float(tr.gid))
    assert int(t.hist_state.n) <= t._bucket


def test_archive_mismatch_rotates(tmp_path):
    import os
    arc = str(tmp_path / "archive.jsonl")
    with _tuner(_ros(2), _ros_obj(2), seed=1, archive=arc) as t:
        t.run(test_limit=60)
    other = TSpace([TP.FloatParam("y", 0.0, 1.0)])
    with pytest.warns(UserWarning, match="different space"):
        t2 = _tuner(other, lambda cfgs: [c["y"] for c in cfgs],
                    archive=arc, resume=True)
    assert t2.evals == 0 and os.path.exists(arc + ".mismatch")
    t2.run(test_limit=20)
    t2.close()
    lines = [json.loads(x) for x in open(arc)]
    assert "space_sig" in lines[0]
    assert all(set(r["cfg"]) == {"y"} for r in lines if "cfg" in r)


def test_archive_refuses_reordered_params(tmp_path):
    arc = str(tmp_path / "archive.jsonl")

    def obj(cfgs):
        return [c["a"] + c["b"] for c in cfgs]
    s1 = TSpace([TP.FloatParam("a", 0.0, 1.0), TP.FloatParam("b", 0.0, 100.0)])
    with _tuner(s1, obj, seed=0, archive=arc) as t:
        t.run(test_limit=40)
    s2 = TSpace([TP.FloatParam("b", 0.0, 100.0), TP.FloatParam("a", 0.0, 1.0)])
    with pytest.warns(UserWarning, match="different space"):
        t2 = _tuner(s2, obj, archive=arc, resume=True)
    assert t2.evals == 0


def test_archive_torn_tail_is_truncated(tmp_path):
    arc = str(tmp_path / "archive.jsonl")
    with _tuner(_ros(2), _ros_obj(2), seed=1, archive=arc) as t:
        t.run(test_limit=60)
    data = open(arc).read()
    with open(arc, "w") as f:
        f.write(data[:-25])  # cut mid-record
    with _tuner(_ros(2), _ros_obj(2), archive=arc, resume=True) as t2:
        assert 0 < t2.evals < 100
        t2.run(test_limit=t2.evals + 40)
    lines = [json.loads(x) for x in open(arc)]
    t3 = _tuner(_ros(2), _ros_obj(2), archive=arc, resume=True)
    assert t3.evals == len([r for r in lines if "cfg" in r])


def test_legacy_credit_signature_still_credits():
    """A meta-technique whose `credit` takes only (name, was_new_best)
    warns once at construction and is credited with two arguments."""
    from uptune_tpu_torch.techniques.bandit import RoundRobinMeta

    class Legacy(RoundRobinMeta):
        def __init__(self, techniques):
            super().__init__(techniques, name="legacy")
            self.events = []

        def credit(self, name, was_new_best):
            self.events.append((name, was_new_best))

    root = Legacy(tbase.get_root().techniques)
    with pytest.warns(FutureWarning, match="legacy"):
        t = _tuner(_ros(2), _ros_obj(2), seed=1, technique=root)
    for _ in range(6):
        t.step()
    assert len(t.root.events) == 6 and t.root.events[0][1] is True


def test_default_device_is_the_card():
    """`Tuner()` without `device=` asks for the card; a host without one
    raises rather than running on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="cuda"):
        TTuner(_ros(2), _ros_obj(2))


def test_string_surrogate_names_the_missing_module():
    """A surrogate given by name builds the port's manager on the tuner's
    device with `surrogate_opts`; an unknown name raises, naming the
    known ones."""
    from uptune_tpu_torch.surrogate.manager import SurrogateManager
    t = _tuner(_ros(2), _ros_obj(2), surrogate="gp",
               surrogate_opts={"min_points": 8})
    assert isinstance(t.surrogate, SurrogateManager)
    assert (t.surrogate.kind, t.surrogate.device, t.surrogate.min_points) \
        == ("gp", CPU, 8)
    with pytest.raises(ValueError, match="known: \\('gp', 'mlp'\\)"):
        _tuner(_ros(2), _ros_obj(2), surrogate="xgb")


def test_flagship_tune_on_cpu(tmp_path):
    """The chip check's tune at a small budget: the default portfolio on
    the flagship's space has a 32-row dedup bucket, one merge a
    committing ticket, no configuration evaluated twice, and
    `flagship_host_objective` agrees with the engines' objective on the
    decoded values."""
    from uptune_tpu_torch.flagship import (flagship_host_objective,
                                           flagship_objective,
                                           flagship_space)
    space = flagship_space()
    arc = str(tmp_path / "flagship.jsonl")
    t = _tuner(space, flagship_host_objective("cpu"), seed=5, archive=arc)
    assert t._bucket == 32
    assert t._nb == {"DifferentialEvolutionAlt": 30,
                     "UniformGreedyMutation": 32,
                     "NormalGreedyMutation": 32, "RandomNelderMead": 17}
    commits = []
    commit = t._commit
    t._commit = lambda *a: (commits.append(1), commit(*a))
    res = t.run(test_limit=300)
    t.close()
    assert len(commits) == res.steps and np.isfinite(res.best_qor)
    rows = archive_rows(arc)[1]
    u = torch.tensor([r["u"] for r in rows], dtype=torch.float32)
    tours = torch.tensor([r["perms"][0] for r in rows])
    packed = TTuner._pack_hashes(N(space.hash_batch(TCand(u, (tours,)))))
    assert len(set(packed.tolist())) == len(rows) == res.evals
    got = flagship_host_objective("cpu")([r["cfg"] for r in rows])
    want = flagship_objective(CPU)(space.decode_scalars(u), (tours,))
    np.testing.assert_allclose(got, N(want), rtol=1e-5)
