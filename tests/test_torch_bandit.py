"""The port's host-side bandit, meta-techniques and technique registry
against the JAX package's.

* The AUC bandit: one 2,000-event credit stream (a virtual arm among
  the members) gives the same `ordered_names()` after every event and
  the same `auc_sum`, `auc_decay` and use counts (Python floats and
  ints, compared exactly); the round-robin order and the recycling
  meta's restarts (`poll_restart`) are the same.
* `generate_bandit_technique(seed)` for seeds 0-19: the same member
  classes, names and hyperparameters.
* The registry: the same 46 names, the same `supports` and
  `natural_batch` of every non-meta technique on three spaces, the same
  experimental flags, and `get_root` resolving as the JAX package's does
  (deep copies, never the registry's own objects).
"""
import numpy as np
import pytest

from uptune_tpu.space import params as JP
from uptune_tpu.space.spec import Space as JSpace
from uptune_tpu.techniques import bandit as jbandit
from uptune_tpu.techniques import banditmutation as jbm
from uptune_tpu.techniques import base as jbase

from uptune_tpu_torch.space import params as TP
from uptune_tpu_torch.space.spec import Space as TSpace
from uptune_tpu_torch.techniques import bandit as tbandit
from uptune_tpu_torch.techniques import banditmutation as tbm
from uptune_tpu_torch.techniques import base as tbase

from test_torch_techniques import _mixed_specs

EVENTS = 2000


def _members(meta):
    return [(type(t).__name__, t.name) for t in meta.techniques]


def _hyper(t):
    """A technique's hyperparameters: its plain attributes."""
    return {k: v for k, v in vars(t).items()
            if isinstance(v, (bool, int, float, str, type(None)))}


# -- the AUC bandit -----------------------------------------------------------
def _credit_stream(seed):
    """(arm index, was_new_best) events, new bests rarer over time."""
    rs = np.random.RandomState(seed)
    arms = rs.randint(0, 5, EVENTS)
    wins = rs.rand(EVENTS) < np.linspace(0.4, 0.05, EVENTS)
    return list(zip(arms.tolist(), wins.tolist()))


@pytest.mark.parametrize("seed", [0, 1])
def test_auc_bandit_credit_stream(seed):
    metas = [m.get_root() for m in (jbase, tbase)]
    for meta in metas:
        meta.register_virtual_arm("surrogate")
    names = [t.name for t in metas[0].techniques] + ["surrogate"]
    assert names[:4] == [t.name for t in metas[1].techniques]
    for i, (arm, win) in enumerate(_credit_stream(seed)):
        orders = [m.ordered_names() for m in metas]
        assert orders[0] == orders[1], i
        for m in metas:
            m.credit(names[arm], win)
    qs = [m.bandit for m in metas]
    for field in ("auc_sum", "auc_decay", "use_counts"):
        a, b = getattr(qs[0], field), getattr(qs[1], field)
        assert a == b, field
        assert all(type(a[k]) is type(b[k]) for k in a), field
    assert list(qs[0].history) == list(qs[1].history)
    assert len(qs[1].history) == qs[1].window
    assert ([t.name for t in metas[0].select_order()]
            == [t.name for t in metas[1].select_order()])


def test_round_robin_and_recycling():
    j = jbase.get_technique("RoundRobinMetaSearchTechnique")
    t = tbase.get_technique("RoundRobinMetaSearchTechnique")
    j, t = jbase.get_root([j.name]), tbase.get_root([t.name])
    for _ in range(9):
        assert ([x.name for x in j.select_order()]
                == [x.name for x in t.select_order()])

    jr = jbase.get_root(["RecyclingMetaTechnique"])
    tr = tbase.get_root(["RecyclingMetaTechnique"])
    names = [x.name for x in jr.techniques]
    rs = np.random.RandomState(3)
    glob = float("inf")
    restarts = []
    for i in range(400):
        arm = names[rs.randint(0, len(names))]
        step = float(rs.rand() * 10.0 + (5.0 if arm == names[2] else 0.0))
        glob = min(glob, step)
        for m in (jr, tr):
            m.credit(arm, step <= glob, step_best=step, global_best=glob)
        got = [m.poll_restart() for m in (jr, tr)]
        assert got[0] == got[1], i
        restarts += got[1]
    assert jr.restart_count == tr.restart_count == len(restarts) > 0


def test_meta_renames_duplicate_members():
    from uptune_tpu.techniques.evolutionary import GreedyMutation as JGM
    from uptune_tpu_torch.techniques.evolutionary import \
        GreedyMutation as TGM
    metas = [b.AUCBanditMeta([g(name="g"), g(name="g"), g(name="g")],
                             name="m")
             for b, g in ((jbandit, JGM), (tbandit, TGM))]
    assert ([x.name for x in metas[0].techniques]
            == [x.name for x in metas[1].techniques] == ["g", "g~", "g~~"])


@pytest.mark.parametrize("seed", range(20))
def test_generate_bandit_technique(seed):
    j, t = jbm.generate_bandit_technique(seed), \
        tbm.generate_bandit_technique(seed)
    assert (j.name, _members(j)) == (t.name, _members(t))
    for a, b in zip(j.techniques, t.techniques):
        assert _hyper(a) == _hyper(b), a.name
    assert j.ordered_names() == t.ordered_names()


# -- the registry -------------------------------------------------------------
def _spaces():
    """(JAX, port) spaces: the mixed space with its 8-city tour,
    rosenbrock-2d, and an 8-city tour alone."""
    def floats(P):
        return [P.FloatParam("x0", -3.0, 3.0), P.FloatParam("x1", -3.0, 3.0)]

    def tour(P):
        return [P.PermParam("tour", tuple(range(8)))]

    return [(JSpace(f(JP)), TSpace(f(TP)))
            for f in (_mixed_specs, floats, tour)]


def _nb(t, space):
    try:
        return t.natural_batch(space)
    except NotImplementedError:
        return "none"


def test_registry_names():
    names = tbase.all_technique_names()
    assert names == jbase.all_technique_names()
    assert len(names) == 46
    for n in names:
        assert tbase.is_experimental(n) == jbase.is_experimental(n), n
    from uptune_tpu_torch.techniques import all_technique_names
    assert all_technique_names() == names
    with pytest.raises(KeyError, match="unknown technique"):
        tbase.get_technique("no-such-arm")


@pytest.mark.parametrize("which", [0, 1, 2])
def test_registry_supports_and_batch(which):
    space_j, space_t = _spaces()[which]
    for n in tbase.all_technique_names():
        jt, tt = jbase.get_technique(n), tbase.get_technique(n)
        assert type(jt).__name__ == type(tt).__name__, n
        if isinstance(jt, jbandit.MetaTechnique):
            assert _members(jt) == _members(tt), n
            continue
        assert jt.supports(space_j) == tt.supports(space_t), n
        assert _nb(jt, space_j) == _nb(tt, space_t), n
        assert _hyper(jt) == _hyper(tt), n


def test_get_root_resolves_as_jax():
    cases = [None, ["PSO_GA_Bandit"], ["ga-OX1", "CMAES"],
             ["MultiTorczon", "pso-CX", "AUCBanditMetaTechniqueC"]]
    cases += [[n] for n in tbase.all_technique_names()]
    for names in cases:
        j, t = jbase.get_root(names), tbase.get_root(names)
        assert (type(j).__name__, j.name) == (type(t).__name__, t.name)
        if isinstance(j, jbandit.MetaTechnique):
            assert _members(j) == _members(t), names
        assert t is not tbase._registry.get(t.name), names
    root = tbase.get_root()
    assert isinstance(root, tbandit.AUCBanditMeta)
    assert root.name == "AUCBanditMetaTechniqueA"
    root.credit(root.techniques[0].name, True)
    assert tbase.get_root().bandit.use_counts[root.techniques[0].name] == 0
