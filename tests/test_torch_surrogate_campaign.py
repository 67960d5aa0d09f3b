"""The calibrated GP surrogate manager in a Tuner campaign over gcc's
328-lane space, small (about 96 told trials, `max_points` 32, seeded):
its decisions against the benchmark's plain float64 reference
(`portbench/reference/manager.py`), its obs spans and counters, and the
campaign bitwise the same with the obs plane on and off.

The QoR of a trial is the benchmark's host surface
(`portbench/reference/surface.py`), a GP's posterior mean over the
archived mmm builds."""
import copy
import json
from pathlib import Path

import numpy as np
import pytest
import torch

from portbench.drivers.common import program_space
from portbench.reference import gp as ref_gp
from portbench.reference import manager as ref_mgr
from portbench.reference.space import RefSpace
from portbench.reference.surface import Surface

from uptune_tpu_torch import obs
from uptune_tpu_torch.driver import Tuner

ROOT = Path(__file__).resolve().parents[1]
CFG = json.loads((ROOT / "portbench/configs/gcc-options-g12-tuner.json")
                 .read_text())
TRIALS, ASK, SEED = 96, 32, 20261019


@pytest.fixture(scope="module")
def world():
    cfg = copy.deepcopy(CFG)
    cfg["surrogate"]["max_points"] = 32
    return (cfg, program_space(cfg["space"]), Surface(cfg),
            RefSpace(cfg["space"], cfg["hash"]["multiplier_seed"]))


class Watched:
    """A campaign whose manager's full fits, prunes and pulls are kept
    (through the manager's `watch`, which only reads)."""

    def __init__(self, cfg, space, surface, seed=SEED):
        self.t = Tuner(space, seed=seed, surrogate="gp",
                       surrogate_opts=dict(cfg["surrogate"]), device="cpu")
        self.t._apply_budget_rule(cfg["tuner"]["budget_rule_test_limit"])
        self.names = [p["name"] for p in cfg["space"]]
        self.surface = surface
        self.cfgs, self.vals = [], []
        self.fits, self.prunes, self.pulls = [], [], []
        self.t.surrogate.watch = self.watch

    def watch(self, what, d):
        if what == "fit":
            self.fits.append((d["snap"], int(d["seed_word"])))
        elif what == "prune":
            elig = d["eligible"]
            self.prunes.append((
                d["snap"], self.fits[-1][1], d["cands"],
                np.ones(len(d["keep"]), bool) if elig is None
                else np.array(elig, bool), d["explore_u"], d["keep"]))
        else:
            self.pulls.append((d["snap"], self.fits[-1][1], d["cands"],
                               float(d["best_y"]), d["idx"]))

    def run(self):
        while self.t.told < TRIALS:
            got = self.t.ask(ASK)
            cfgs = [tuple(tr.config[k] for k in self.names) for tr in got]
            vals = [float(v) for v in self.surface(cfgs)]
            for tr, v in zip(got, vals):
                self.t.tell(tr, v)
            self.cfgs += cfgs
            self.vals += vals
        return self


@pytest.fixture(scope="module")
def campaign(world):
    cfg, space, surface, _ = world
    return Watched(cfg, space, surface).run()


def _training(world, c, snap, seed_word):
    """The reference's view of a snapshot's rows: (x, y) float64."""
    cfg, _, surface, ref = world
    n = int(snap.n_rows)
    rows = (np.arange(n) if snap.exact else ref_mgr.fit_rows(
        np.asarray(c.vals[:n], np.float32), seed_word,
        cfg["surrogate"]["max_points"]))
    vals = surface.values([c.cfgs[i] for i in rows])
    x = ref.features(np.zeros(vals.shape), vals, [])
    return torch.tensor(x), torch.tensor(np.asarray(c.vals)[rows])


def _hp(snap):
    st = snap.state
    return float(st.lengthscale), float(st.noise), float(st.ls_cat)


def _ei(world, c, snap, seed_word, cands, best):
    _, space, _, ref = world
    x, y = _training(world, c, snap, seed_word)
    post = ref_mgr.posterior(x, y, _hp(snap), ref.n_cont, ref.n_cat)
    u = cands.u.numpy()
    vals, bad = ref.resolve(u, space.decode_scalars(cands.u).numpy())
    assert not bad.any()
    mu, sd = ref_gp.moments(post, torch.tensor(ref.features(u, vals, [])))
    return ref_gp.expected_improvement(mu, sd, best).numpy(), \
        float(y.std(correction=0))


def test_refits_take_the_reference_sweep_point(world, campaign):
    cfg, _, _, ref = world
    c = campaign
    assert len(c.fits) >= 3
    grid = cfg["fit_grid"]
    points = {tuple(float(np.float32(v)) for v in (a, b, c))
              for a in grid["ls"] for b in grid["noise"]
              for c in grid["ls_cat"]}
    for snap, word in c.fits:
        x, y = _training(world, c, snap, word)
        best, scores = ref_mgr.sweep(x, y, grid, ref.n_cont, ref.n_cat)
        hp = _hp(snap)
        assert hp in points, hp
        # the point's float64 log evidence is the sweep's best, a row (at
        # 32 rows and the smallest lengthscales every point ties: K is
        # the identity to float64's reach, and float32 takes any)
        mine = ref_mgr.log_evidence(x, y, *hp, ref.n_cont, ref.n_cat)
        assert (scores[best] - mine) / len(y) <= 1e-6, (hp, best)


def test_prunes_keep_the_reference_set(world, campaign):
    cfg, _, _, _ = world
    c = campaign
    s = cfg["surrogate"]
    assert len(c.prunes) >= 2
    for snap, word, cands, elig, explore_u, keep in c.prunes:
        best = float(np.min(c.vals[:int(snap.n_rows)]))
        ei, scale = _ei(world, c, snap, word, cands, best)
        want, explore, k = ref_mgr.keep_set(
            ei, elig, np.asarray(explore_u, np.float64), s["keep_frac"],
            s["explore_frac"])
        assert not (keep & ~elig).any() and not (explore & ~keep).any()
        ranked = keep & ~explore
        assert k - explore.sum() <= ranked.sum() <= k
        dropped = elig & ~keep
        if ranked.any() and dropped.any():
            assert ei[dropped].max() - ei[ranked].min() <= 1e-4 * scale
        # away from near ties the sets are the same
        margin = np.sort(ei[elig])[::-1]
        if len(margin) > k and margin[k - 1] - margin[k] > 1e-4 * scale:
            assert np.array_equal(keep, want)


def test_pulls_return_the_reference_top8(world, campaign):
    c = campaign
    assert len(c.pulls) >= 2
    for snap, word, cands, best_y, idx in c.pulls:
        ei, scale = _ei(world, c, snap, word, cands, best_y)
        want_v, want_i = ref_mgr.pull(ei, 8)
        got = idx.numpy()
        assert len(set(got.tolist())) == 8
        assert ei[got].min() >= want_v[-1] - 1e-4 * scale
        assert (np.diff(ei[got]) <= 1e-4 * scale).all()


def test_spans_and_counters_with_obs_on(world):
    cfg, space, surface, _ = world
    obs.reset()
    obs.enable()
    try:
        w = Watched(cfg, space, surface).run()
        names = {e["name"] for e in obs.snapshot()["events"]}
        pool = obs.counter_value("surrogate.pool_rows")
        prune = obs.counter_value("surrogate.prune_rows")
    finally:
        obs.reset()
    assert {"surrogate.refit", "surrogate.prune",
            "surrogate.pool"} <= names
    m = w.t.surrogate
    assert pool == 512 * len(w.pulls) > 0
    assert prune == sum(int(p[2].batch) for p in w.prunes) > 0
    assert m.rows_scored == pool + prune


def test_rows_scored_counts_with_obs_off(campaign):
    c = campaign
    assert not obs.enabled()
    m = c.t.surrogate
    want = 512 * len(c.pulls) + sum(int(p[2].batch) for p in c.prunes)
    assert m.rows_scored == want > 0
    assert obs.counter_value("surrogate.pool_rows") == 0


def test_campaign_bitwise_with_obs_on_and_off(world, campaign):
    cfg, space, surface, _ = world
    obs.reset()
    obs.enable()
    try:
        on = Watched(cfg, space, surface).run()
    finally:
        obs.reset()
    off = campaign
    assert on.cfgs == off.cfgs and on.vals == off.vals
    assert len(on.fits) == len(off.fits)
    for (a, _), (b, _) in zip(on.fits, off.fits):
        assert torch.equal(a.state.alpha, b.state.alpha)
        assert torch.equal(a.state.chol, b.state.chol)
    for a, b in zip(on.pulls, off.pulls):
        assert torch.equal(a[2].u, b[2].u) and torch.equal(a[4], b[4])
    assert on.t.result().best_qor == off.t.result().best_qor
    assert on.t.surrogate.rows_scored == off.t.surrogate.rows_scored


def test_extensions_keep_their_fits_standardization(world):
    """At the configuration's `max_points` the early snapshots hold rank-1
    extensions: each is the GP on its fit's rows and the rows folded in
    since, at the fit's values and the fit's standardization (not one
    refreshed over every row)."""
    _, space, surface, ref = world
    cfg = copy.deepcopy(CFG)
    c = Watched(cfg, space, surface).run()
    fitted = {id(s): int(s.n_rows) for s, _ in c.fits}
    ext = []
    for snap, *_ in c.prunes + c.pulls:
        if id(snap) not in fitted:
            base = max(n for n in fitted.values() if n < int(snap.n_rows))
            ext.append((snap, base))
    assert ext
    for snap, n_fit in ext:
        n = int(snap.n_rows)
        vals = surface.values(c.cfgs[:n])
        x = torch.tensor(ref.features(np.zeros(vals.shape), vals, []))
        y = torch.tensor(np.asarray(c.vals[:n]))
        post = ref_mgr.posterior(x, y, _hp(snap), ref.n_cont, ref.n_cat,
                                 rows_std=n_fit)
        q = torch.tensor(ref.features(
            np.zeros(vals.shape), surface.values(c.cfgs[n:n + 64]), []))
        mu, sd = ref_gp.moments(post, q)
        from uptune_tpu_torch.surrogate import gp
        names = [p["name"] for p in cfg["space"]]
        cb = space.from_configs([dict(zip(names, v)) for v in
                                 c.cfgs[n:n + 64]], device="cpu")
        m2, s2 = gp.predict(snap.state, space.surrogate_features(cb),
                            space.n_cont_features, space.n_cat)
        scale = float(y[:n_fit].std(correction=0))
        assert float((m2.double() - mu).abs().max()) <= 5e-3 * scale
        assert float((s2.double() - sd).abs().max()) <= 5e-3 * scale
