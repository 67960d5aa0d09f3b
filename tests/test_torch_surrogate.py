"""Parity of the port's surrogate manager (`uptune_tpu_torch/surrogate/
manager.py`) with the JAX package's, on the CPU, for the GP and the MLP
ensemble, on the small mixed space of tests/test_torch_driver.py.

Both managers observe the same seeded host rows.  The JAX manager's draws
are replayed into the port's draw methods (`Replay`): the refit keys (the
subsample's seed word and the MLP's init normals), the keep mask's
explore uniforms and every draw of a pool.  Tolerances:

* training rows, subsample, bucket, threshold and incumbent: bitwise
  (host numpy over equal rows), but for the snapped LOG lanes of the
  surrogate features, which go through each package's log1p / expm1 and
  are held within `LOG_LANE_ATOL` (a few ulps of a unit value);
* the GP state: the GP tolerances of tests/test_torch_gp.py (posterior
  mean rtol 1e-4 / atol 1e-5, sd rtol 1e-3 / atol 1e-5; factor, alpha
  and K^-1 at the mean's, relative to their scale); the MLP's
  predictions within `FIT_TOL_Y_STD` of tests/test_torch_mlp.py;
* a score compared against a cut (the threshold, the k-th score, a
  neighbouring rank) is inside the band when it lies within its row's
  tolerance of it (`score_band`): the tolerances of the moments the
  score is made of, in the GP's standardized units (the mean's plus the
  sd's for EI, plus twice the sd's for LCB), times y_std.  Masks and
  pool picks must agree on every row outside the band; the rows inside
  are counted.

The JAX pool runs eagerly (`eager_pool`): jitted, XLA rewrites the
codec's division by a constant range into a multiply by its reciprocal.
XLA's exp2 (its own exp of x ln 2) differs from torch's in the last
places on about two thirds of inputs, so the pool's rows are compared
twice: with one exp2 for both sides (`shared_exp2`, bitwise), and each
with its own (the dense rows' numeric lanes within `EXP2_ATOL`).
"""
import collections
import contextlib
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from uptune_tpu.ops import acquire as jacq
from uptune_tpu.surrogate import gp as jgp
from uptune_tpu.surrogate import mlp as jmlp
from uptune_tpu.surrogate import screen as jscreen
from uptune_tpu.surrogate.manager import SurrogateManager as JManager

from uptune_tpu_torch import convert
from uptune_tpu_torch.ops import acquire as tacq
from uptune_tpu_torch.surrogate import gp as tgp
from uptune_tpu_torch.surrogate import manager as tman
from uptune_tpu_torch.surrogate import mlp as tmlp
from uptune_tpu_torch.surrogate import screen as tscreen
from uptune_tpu_torch.surrogate.manager import SurrogateManager as TManager

from test_torch_acquire import assert_topk
from test_torch_driver import _spaces
from test_torch_gp import MEAN_TOL, SD_TOL, close
from test_torch_mlp import FIT_TOL_Y_STD, jax_init
from test_torch_ops import N, T, assert_bitwise, jax_perm_rows, jcands_to_t

CPU = torch.device("cpu")
# a snapped LOG lane of the surrogate features (decode through expm1,
# encode through log1p: XLA's and torch's differ in the last place)
LOG_LANE_ATOL = 2.0 ** -22
# a dense row's unit lane through each side's own exp2: a few ulps of
# the radius times a normal
EXP2_ATOL = 2.0 ** -21
# the calibrated options at test size: one 32-row bucket (64 with
# MAX64), a 512-row pool (the gate's 4096 with GATE)
OPTS = dict(min_points=16, refit_interval=16, max_points=32,
            select="topk", keep_frac=0.35, explore_frac=0.1, score="ei",
            propose_batch=8, propose_every=2, pool_mult=64)
GATE = dict(propose_batch=32, pool_mult=128)
# tickets the Tuner lockstep runs (the first fits after one ticket)
LOCKSTEP_TICKETS = 11


@pytest.fixture(scope="module")
def spaces():
    return _spaces()


def rows(space_j, n, seed):
    """(features [n, F], engine QoR [n]) of n random configurations: a
    smooth function of the lanes, one row in ten failed (inf)."""
    cands = space_j.random(jax.random.PRNGKey(seed), n)
    f = np.asarray(space_j.features(cands))
    q = (((f[:, :4] - 0.6) ** 2).sum(1) + 0.3 * f[:, 4] + 0.2 * f[:, 5]
         + 0.5 * (f[:, 6] > 0.5) + 0.4 * (f[:, 7] > 0.6)
         + 0.1 * np.abs(f[:, 8:] - np.linspace(0, 1, 8)).sum(1))
    q[np.arange(n) % 10 == 7] = np.inf
    return f.astype(np.float32), q.astype(np.float32)


class Replay:
    """Records the JAX manager's draws as the port's and feeds them to
    the port manager in the same order: a refit's seed word and MLP init
    normals, a keep mask's explore uniforms, a pool's draws (recorded by
    `pool_draws` from the key JAX's pool was given).  `quiet` wraps the
    recording (the driver lockstep's own Replay must not record the
    pool's `Space.random`)."""

    def __init__(self, jm: JManager, tm: TManager, quiet=None):
        self.refit, self.explore, self.pool = (collections.deque()
                                               for _ in range(3))
        quiet = quiet or (lambda fn, *a: fn(*a))
        args = jm._refit_args

        def refit_args():
            out = args()
            ks, kf = out[2], out[3]
            init = (jax_init(kf, tmlp.layer_sizes(tm._n_features()),
                             tm.n_members) if tm.kind == "mlp" else None)
            self.refit.append(tman.RefitDraws(int(np.asarray(ks)[-1]),
                                              init))
            return out
        jm._refit_args = refit_args
        keep = jm.keep_mask

        def keep_mask(cands, candidate_mask=None):
            key = jm._key
            out = keep(cands, candidate_mask)
            if jm._key is not key:      # it split its key: it drew
                _, ke = jax.random.split(key)
                self.explore.append(T(jax.random.uniform(ke,
                                                         (cands.batch,))))
            return out
        jm.keep_mask = keep_mask
        propose = jm.propose_pool

        def propose_pool(key, *a):
            if jm._snap is not None and jm.propose_batch > 0:
                self.pool.append(quiet(pool_draws, jm, key))
            return quiet(propose, key, *a)
        jm.propose_pool = propose_pool
        tm._draw_refit = lambda ks, kf: self.refit.popleft()
        tm._draw_explore = lambda ke, b: self.explore.popleft()
        tm._draw_pool = lambda key: self.pool.popleft()

    def drained(self) -> bool:
        return not (self.refit or self.explore or self.pool)


def assert_rows(a, b, tm: TManager, what=""):
    """Training rows (model representation) [N, F]: bitwise but the
    snapped LOG lanes, within LOG_LANE_ATOL."""
    from uptune_tpu_torch.space import params as TP
    space = tm.space
    kinds = space.kind_np[space.num_lane_idx]
    log_full = np.nonzero(np.isin(kinds, [TP.LOG_FLOAT, TP.LOG_INT]))[0]
    lanes = (np.arange(space.n_surrogate_features) if tm._screen_idx is None
             else tm._screen_idx)
    is_log = np.isin(lanes, log_full)
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    assert a.shape == b.shape and a.shape[1] == len(lanes), what
    assert_bitwise(a[:, ~is_log], b[:, ~is_log], what)
    np.testing.assert_allclose(a[:, is_log], b[:, is_log], rtol=0,
                               atol=LOG_LANE_ATOL, err_msg=what)


def pair(spaces, kind="gp", **kw):
    """(JAX manager, port manager, replay) with the same options."""
    sj, st = spaces
    opts = dict(OPTS, **kw)
    jm = JManager(sj, kind, **opts)
    tm = TManager(st, kind, device="cpu", **opts)
    return jm, tm, Replay(jm, tm)


def observe_both(jm, tm, f, q):
    jm.observe(f, q)
    tm.observe(f, q)


def queries(jm, tm, n=64):
    """n random configurations in the model's representation (a dead
    one-hot column stays 0, as it does in every real query)."""
    return N(tm._sx(T(rows(jm.space, n, 99)[0])))


def assert_snapshots_match(jm, tm, what=""):
    """Equal snapshot fields; the state within the GP (or MLP)
    tolerances; K^-1 attached exactly when JAX attaches it."""
    sj, st = jm._snap, tm._snap
    assert (st.version, st.n_rows, st.exact, st.in_bucket) == (
        sj.version, sj.n_rows, sj.exact, sj.in_bucket), what
    assert (st.threshold, st.best_y) == (sj.threshold, sj.best_y), what
    if tm.kind == "gp":
        a, b = st.state, sj.state
        assert tuple(a.x.shape) == tuple(b.x.shape), what
        assert_bitwise(b.mask, N(a.mask), what + " mask")
        for f in ("lengthscale", "noise", "ls_cat"):
            assert float(getattr(a, f)) == float(getattr(b, f)), (what, f)
        np.testing.assert_allclose(N(a.y_mean), np.asarray(b.y_mean),
                                   rtol=1e-6, err_msg=what)
        np.testing.assert_allclose(N(a.y_std), np.asarray(b.y_std),
                                   rtol=1e-6, err_msg=what)
        close(N(a.chol), b.chol, MEAN_TOL, what + " chol")
        close(N(a.alpha), b.alpha, MEAN_TOL, what + " alpha")
        assert (a.kinv is None) == (b.kinv is None), what
        if a.kinv is not None:
            close(N(a.kinv), b.kinv, MEAN_TOL, what + " kinv")
        xq = queries(jm, tm)
        mj, sdj = jgp.predict(b, jnp.asarray(xq), jm._n_cont, jm._n_cat)
        mt, sdt = tgp.predict(a, T(xq), tm._n_cont, tm._n_cat)
        close(N(mt), mj, MEAN_TOL, what + " mean")
        close(N(sdt), sdj, SD_TOL, what + " sd")
    else:
        xq = queries(jm, tm)
        pj = np.asarray(jmlp.predict_members(sj.state, jnp.asarray(xq)))
        pt = N(tmlp.predict_members(st.state, T(xq)))
        err = np.abs(pt - pj).max() / float(sj.state.y_std)
        assert err <= FIT_TOL_Y_STD, (what, err)


# -- observe ---------------------------------------------------------------------
def screens(spaces, top=(3, 1)):
    """One FeatureScreen for each package, from the same two sources."""
    sj, st = spaces
    src = []
    for seed in (11, 12):
        f, q = rows(sj, 60, seed)
        src.append((N(st.surrogate_transform(T(f))), q))
    return (jscreen.build_screen(sj, src, *top),
            tscreen.build_screen(st, src, *top))


@pytest.mark.parametrize("screen", ["none", "hard", "soft"])
@pytest.mark.parametrize("kind", ["gp", "mlp"])
def test_observe_rows_bitwise(spaces, kind, screen):
    """The training rows, unscreened and screened hard and soft."""
    sj, st = spaces
    scj = sct = None
    if screen != "none":
        scj, sct = screens(spaces)
    mode = "hard" if screen == "none" else screen
    jm = JManager(sj, kind, screen=scj, screen_mode=mode, **OPTS)
    tm = TManager(st, kind, device="cpu", screen=sct, screen_mode=mode,
                  **OPTS)
    f, q = rows(sj, 40, 0)
    observe_both(jm, tm, f, q)
    assert tm.n_points == jm.n_points == 40
    assert_rows(np.stack(jm._xs), np.stack(tm._xs), tm, "training rows")
    assert tm._ys == jm._ys
    assert (tm._n_cont, tm._n_cat) == (jm._n_cont, jm._n_cat)
    assert tm._n_features() == np.stack(jm._xs).shape[1]


# -- refit, extension ---------------------------------------------------------------
@pytest.mark.parametrize("kind", ["gp", "mlp"])
def test_refits_match(spaces, kind):
    """maybe_refit at the cadence, a subsampled force_refit past
    max_points, and warm_start, with the refit keys replayed."""
    jm, tm, rep = pair(spaces, kind)
    sj = spaces[0]
    f, q = rows(sj, 56, 1)
    observe_both(jm, tm, f[:12], q[:12])
    assert not jm.maybe_refit() and not tm.maybe_refit()
    observe_both(jm, tm, f[12:20], q[12:20])
    assert jm.maybe_refit() and tm.maybe_refit()
    assert tm.fit_bucket() == jm.fit_bucket() == 32
    assert_snapshots_match(jm, tm, "first fit")
    # past max_points: the best half kept, the rest drawn on the host
    observe_both(jm, tm, f[20:], q[20:])
    xs, ys = np.stack(tm._xs), np.asarray(tm._ys, np.float32)
    got = TManager._host_subsample(xs, ys, 12345, 32)
    want = JManager._host_subsample(xs, ys, np.asarray([0, 12345],
                                                       np.uint32), 32)
    for a, b in zip(got, want):
        assert_bitwise(b, a, "host subsample")
    assert jm.force_refit() and tm.force_refit()
    assert not tm._snap.exact
    assert_snapshots_match(jm, tm, "subsampled fit")
    if kind == "gp":
        assert_rows(jm._snap.state.x, N(tm._snap.state.x), tm,
                    "subsampled rows")
    jw, tw, rw = pair(spaces, kind, min_points=8)
    assert jw.warm_start(f[:24], q[:24]) and tw.warm_start(f[:24], q[:24])
    assert_snapshots_match(jw, tw, "warm start")
    assert rep.drained() and rw.drained()


def test_extensions_match(spaces):
    """Rank-1 extensions over several ticks (K^-1 attached for a
    gate-sized pool), then none after a subsampled fit."""
    jm, tm, rep = pair(spaces, "gp", **GATE)
    sj = spaces[0]
    f, q = rows(sj, 60, 2)
    observe_both(jm, tm, f[:16], q[:16])
    jm.maybe_refit()
    tm.maybe_refit()
    assert tm._snap.state.kinv is not None
    at = 16
    # a tick folds at most 8 rows; the third tick's cadence refits
    for step in (3, 12, 1):
        observe_both(jm, tm, f[at:at + step], q[at:at + step])
        at += step
        published = jm.maybe_refit()
        assert tm.maybe_refit() == published
        assert tm.incr_updates == jm.incr_updates
        assert_snapshots_match(jm, tm, f"after {at} rows")
    assert tm.incr_updates > 8
    observe_both(jm, tm, f[at:], q[at:])
    jm.force_refit()
    tm.force_refit()
    assert not tm._snap.exact
    before = tm.incr_updates
    observe_both(jm, tm, f[:4], q[:4])
    jm.maybe_refit()
    tm.maybe_refit()
    assert tm.incr_updates == jm.incr_updates == before
    assert_snapshots_match(jm, tm, "no extension after a subsample")
    assert rep.drained()


# -- keep_mask -----------------------------------------------------------------------
@pytest.fixture(scope="module")
def fitted(spaces):
    """A fitted (JAX, port) manager pair of each kind, 24 rows."""
    out = {}
    for kind in ("gp", "mlp"):
        jm, tm, rep = pair(spaces, kind)
        f, q = rows(spaces[0], 24, 3)
        observe_both(jm, tm, f, q)
        jm.maybe_refit()
        tm.maybe_refit()
        out[kind] = (jm, tm, rep)
    return out


def score_band(jm, feats, lcb: bool) -> np.ndarray:
    """[B] each row's score tolerance in target units: in the GP's
    standardized units the mean's (atol + rtol |mu_n|) plus once (EI) or
    twice (LCB) the sd's (atol + rtol sd_n), times y_std; for the MLP
    FIT_TOL_Y_STD y_std a moment."""
    snap = jm._snap
    ys = float(snap.state.y_std)
    k = 2.0 if lcb else 1.0
    if jm.kind != "gp":
        return np.full(feats.shape[0], (1.0 + k) * FIT_TOL_Y_STD * ys)
    mu, sd = jgp.predict(snap.state, feats, jm._n_cont, jm._n_cat)
    mu_n = (np.asarray(mu, np.float64) - float(snap.state.y_mean)) / ys
    sd_n = np.asarray(sd, np.float64) / ys
    return ys * (MEAN_TOL["atol"] + MEAN_TOL["rtol"] * np.abs(mu_n)
                 + k * (SD_TOL["atol"] + SD_TOL["rtol"] * sd_n))


def jax_scores(jm, cands):
    """The JAX keep mask's scores [B], its members' predictions [E, B]
    (MLP; else None) and each row's band (`score_band`)."""
    snap = jm._snap
    feats = jm._sx(jm.space.features(cands))
    bucket = int(snap.state.x.shape[0]) if jm.kind == "gp" else None
    ei = jm.select == "topk" and jm.score_kind == "ei"
    tol = score_band(jm, feats, lcb=not ei)
    if jm.kind == "gp":
        if ei:
            return -np.asarray(jm._score_ei_jit[bucket](
                snap.state, feats, jnp.float32(snap.best_y))), None, tol
        return (np.asarray(jm._score_jit[bucket](snap.state, feats)), None,
                tol)
    preds = np.asarray(jm._score(snap.state, feats))
    score = preds.mean(axis=0)
    if ei:
        score = -np.asarray(jgp.ei_from_moments(score, preds.std(axis=0),
                                                snap.best_y))
    return score, preds, tol


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("score", ["lcb", "ei"])
@pytest.mark.parametrize("select", ["threshold", "topk"])
@pytest.mark.parametrize("kind", ["gp", "mlp"])
def test_keep_mask_off_the_band(spaces, fitted, kind, select, score,
                                masked):
    """Both managers score against one converted snapshot, the explore
    draw replayed: the masks agree on every row whose score lies outside
    the band around the cut; the rows inside are counted."""
    jm, tm, rep = fitted[kind]
    for m in (jm, tm):
        m.select, m.score_kind = select, score
    tm._snap = convert.from_jax_snapshot(jm._snap, device="cpu")
    cj = spaces[0].random(jax.random.PRNGKey(40 + len(rep.explore)), 96)
    cm = (np.arange(96) % 3 != 0) if masked else None
    kj = jm.keep_mask(cj, cm)
    kt = tm.keep_mask(jcands_to_t(cj), cm)
    assert kt.dtype == bool and kt.shape == kj.shape == (96,)
    s, preds, tol = jax_scores(jm, cj)
    elig = np.ones(96, bool) if cm is None else cm
    if select == "topk":
        k = max(1, int(round(elig.sum() * jm.keep_frac)))
        cut = np.sort(s[elig])[k - 1]
        inside = elig & (np.abs(s - cut) <= 2 * tol)
    elif kind == "gp":
        inside = np.abs(s - jm._snap.threshold) <= tol
    else:
        inside = (np.abs(preds - jm._snap.threshold)
                  <= FIT_TOL_Y_STD * float(jm._snap.state.y_std)).any(axis=0)
    differ = kj != kt
    assert not (differ & ~inside).any(), (np.nonzero(differ & ~inside),
                                          int(inside.sum()))
    assert inside.sum() < 96 // 4, f"{inside.sum()} rows inside the band"
    assert kt.sum() > 0 and not rep.explore


# -- the proposal pool ------------------------------------------------------------------
def pool_draws(jm: JManager, key) -> tman.PoolDraws:
    """The draws of the JAX pool for `key`, as the port's PoolDraws: each
    `jax.random` call of the JAX manager's pool_fn, with its key."""
    space = jm.space
    geo = tman.pool_geometry(space, jm.propose_batch, jm.pool_mult)
    D = space.n_scalar
    lo, hi = tman._sparse_range(max(D, 1))
    kr, kn, ks, kp, km, kv, kw, kf1, kf2, kf3 = jax.random.split(key, 10)
    U = jax.random.uniform
    perms = []
    for i, size in enumerate(space.perm_sizes):
        kp, k1, k2, k3 = jax.random.split(kp, 4)
        perms.append((
            T(jax.vmap(lambda k, s=size: U(k, (s,)))(
                jax.random.split(k1, geo.n_local))),
            jax_perm_rows(jax.random.fold_in(k2, i), geo.n_local, size),
            T(U(k3, (geo.n_local, 1)))))
    return tman.PoolDraws(
        jcands_to_t(space.random(kr, geo.n_rand)),
        T(U(ks, (geo.n_dense, 1), minval=-9.0, maxval=-1.5)),
        T(jax.random.normal(kn, (geo.n_dense, D))),
        T(U(kf1, (geo.n_flip, 1), minval=0.0,
            maxval=float(np.log2(geo.max_flips)))),
        T(U(kf2, (geo.n_flip, D))), T(U(kf3, (geo.n_flip, D))),
        T(U(km, (geo.n_sparse, 1), minval=lo, maxval=hi)),
        T(U(kv, (geo.n_sparse, max(D, 1)))),
        T(U(kw, (geo.n_sparse, max(D, 1)))), tuple(perms))


class _Eager(dict):
    def __init__(self, fn):
        super().__init__()
        self.fn = fn

    def __missing__(self, bucket):
        return self.fn


def eager_pool(jm: JManager) -> None:
    """Run the JAX manager's pool_fn op by op (every bucket)."""
    jm._pool_jit = _Eager(jm._build_pool_fn())


@contextlib.contextmanager
def shared_exp2():
    """jnp.exp2 of a concrete array computed as torch computes it (a
    traced one as XLA does): one exp2 for both packages."""
    orig = jnp.exp2

    def exp2(x):
        if isinstance(x, jax.core.Tracer):
            return orig(x)
        return jnp.asarray(N(torch.exp2(T(x))))
    jnp.exp2 = exp2
    try:
        yield
    finally:
        jnp.exp2 = orig


def jax_pool(jm, key, best, best_y, exp2_shared=True):
    """The JAX pool_fn run eagerly: (its pick, the whole pool)."""
    seen = []
    features = jm.space.features

    def capture(cands):
        seen.append(cands)
        return features(cands)
    jm.space.features = capture
    try:
        with (shared_exp2() if exp2_shared else contextlib.nullcontext()):
            pick = jm.propose_pool(key, best.u[0], tuple(p[0] for p in
                                                        best.perms), best_y)
    finally:
        del jm.space.features
    return pick, seen[0]


def port_pool(tm, rep, best, best_y):
    """The port's pool from the draws the replay recorded from JAX's last
    pool: (the whole pool, its pick by `_rank_pool`, `propose_pool`'s
    output, which takes the draws)."""
    draws = rep.pool[0]
    bt = jcands_to_t(best)
    bu, bp = bt.u[0], tuple(p[0] for p in bt.perms)
    tm._pool_geo = tman.pool_geometry(tm.space, tm.propose_batch,
                                      tm.pool_mult)
    pool = tman.pool_candidates(tm.space, tm._pool_geo, draws, bu, bp,
                                tm._flip_probs())
    idx = tm._rank_pool(tm._snap.state, pool,
                        torch.tensor(best_y, dtype=torch.float32))
    out = tm.propose_pool(None, bu, bp, best_y)
    return pool, idx, out


def assert_cands_rows(cj, ct, what=""):
    assert_bitwise(cj.u, N(ct.u), what + ".u")
    for k, (pj, pt) in enumerate(zip(cj.perms, ct.perms)):
        assert_bitwise(pj, N(pt), f"{what}.perms[{k}]")


def apart(sorted_scores, tol):
    """Ranks whose score stands apart from each neighbour by more than
    the two rows' bands (`tol`, in the same order)."""
    v = np.asarray(sorted_scores, np.float64)
    ok = np.ones(len(v), bool)
    split = np.diff(v) > tol[:-1] + tol[1:]
    ok[1:] &= split
    ok[:-1] &= split
    return ok


@pytest.mark.parametrize("kind", ["gp", "mlp"])
def test_pool_below_the_gate(spaces, fitted, kind):
    """A 512-row pool: the whole pool bitwise (one exp2), the picks equal
    at every rank apart from its neighbours, `propose_pool` the pick;
    with each package's own exp2 only the dense rows' numeric lanes
    move, within EXP2_ATOL."""
    jm, tm, rep = fitted[kind]
    jm.select, jm.score_kind = tm.select, tm.score_kind = "topk", "ei"
    tm._snap = convert.from_jax_snapshot(jm._snap, device="cpu")
    best = spaces[0].random(jax.random.PRNGKey(8), 1)
    best_y = float(jm._snap.best_y)
    key = jax.random.PRNGKey(31)
    eager_pool(jm)
    pick_j, pool_j = jax_pool(jm, key, best, best_y)
    pool_t, idx_t, out_t = port_pool(tm, rep, best, best_y)
    geo = tm._pool_geo
    assert pool_t.batch == geo.pool == 512 and out_t.batch == 8
    assert_cands_rows(pool_j, pool_t, "pool")
    assert_cands_rows(pool_t[idx_t], out_t, "propose_pool")
    # JAX's scores of its pool, in its pick's order
    feats = jm._sx(jm.space.features(pool_j))
    if kind == "gp":
        s = -np.asarray(jgp.expected_improvement(
            jm._snap.state, feats, jnp.float32(best_y), n_cont=jm._n_cont,
            n_cat=jm._n_cat))
    else:
        p = jmlp.predict_members(jm._snap.state, feats)
        s = -np.asarray(jgp.ei_from_moments(p.mean(0), p.std(0),
                                            jnp.float32(best_y)))
    order = np.argsort(s, kind="stable")
    assert_cands_rows(pick_j, jcands_to_t(pool_j[jnp.asarray(order[:8])]),
                      "JAX pick")
    tol = score_band(jm, feats, lcb=False)
    ok = apart(s[order[:9]], tol[order[:9]])[:8]
    np.testing.assert_array_equal(N(idx_t)[ok], order[:8][ok])
    assert ok.sum() >= 4, ok
    # each package's own exp2: the dense rows' numeric lanes alone move
    _, own = jax_pool(jm, key, best, best_y, exp2_shared=False)
    rep.pool.popleft()               # the same draws again: not replayed
    assert rep.drained()
    dense = slice(geo.n_rand, geo.n_rand + geo.n_dense)
    u_j, u_t = np.asarray(own.u), N(pool_t.u)
    np.testing.assert_allclose(u_t[dense], u_j[dense], rtol=0,
                               atol=EXP2_ATOL)
    rest = np.ones(geo.pool, bool)
    rest[dense] = False
    assert_bitwise(u_j[rest], u_t[rest], "pool rows but the dense ones")


def test_pool_at_the_gate_ranks_with_the_fused_topk(spaces, monkeypatch):
    """A 4096-row GP pool: the JAX side pinned to its Pallas kernel (in
    interpret mode), the port through acquire_topk (the plain version of
    launcher D on the CPU): indices equal but where utilities tie within
    the sd tolerance, values within it, the picks equal there."""
    monkeypatch.setenv("UT_PALLAS", "interpret")
    jm, tm, rep = pair(spaces, "gp", **GATE)
    f, q = rows(spaces[0], 24, 3)
    observe_both(jm, tm, f, q)
    jm.maybe_refit()
    tm.maybe_refit()
    tm._snap = convert.from_jax_snapshot(jm._snap, device="cpu")
    assert tm._snap.state.kinv is not None
    best = spaces[0].random(jax.random.PRNGKey(9), 1)
    best_y = float(jm._snap.best_y)
    key = jax.random.PRNGKey(32)
    eager_pool(jm)
    pick_j, pool_j = jax_pool(jm, key, best, best_y)
    pool_t, idx_t, out_t = port_pool(tm, rep, best, best_y)
    assert pool_t.batch == 4096 and out_t.batch == 32
    assert_cands_rows(pool_j, pool_t, "pool")
    st = jm._snap.state
    vj, ij = jacq.acquire_topk(
        st, jm._sx(jm.space.features(pool_j)), 32, kind="ei",
        best_y=jnp.float32(best_y), beta=2.0, n_cont=jm._n_cont,
        n_cat=jm._n_cat, route="interpret")
    vt, it = tacq.acquire_topk(tm._snap.state, tm._sx(
        tm.space.features(pool_t)), 32, kind="ei", best_y=best_y,
        n_cont=tm._n_cont, n_cat=tm._n_cat)
    assert_topk(vj, ij, vt, it, SD_TOL, "at the gate")
    assert torch.equal(it.long(), idx_t)
    assert_cands_rows(pool_j[ij], out_t, "the JAX kernel's picks")
    assert_cands_rows(pick_j, jcands_to_t(pool_j[ij]), "JAX pool_fn")
    assert rep.drained()


@pytest.mark.parametrize("how", ["none", "online", "screen"])
def test_flip_probs_bitwise(spaces, fitted, how):
    jm, tm, _ = fitted["gp"]
    if how == "screen":
        scj, sct = screens(spaces)
        jm = JManager(spaces[0], "gp", screen=scj, **OPTS)
        tm = TManager(spaces[1], "gp", device="cpu", screen=sct, **OPTS)
    elif how == "online":
        for m in (jm, tm):
            m.flip_bias = "online"
        jm.force_refit()
        tm.force_refit()
    try:
        p = N(tm._flip_probs())
        assert_bitwise(np.asarray(jm._flip_probs()), p, how)
        assert abs(p.sum() - 1.0) < 1e-6
        if how != "none":
            assert len(set(p[tm.space.cat_lane_idx].tolist())) > 1
    finally:
        for m in (jm, tm):
            m.flip_bias = "none"


# -- the async plane ------------------------------------------------------------------
def test_async_refit_publishes_the_sync_snapshot(spaces):
    sj, st = spaces
    f, q = rows(sj, 40, 4)
    sync = TManager(st, "gp", device="cpu", **OPTS)
    bg = TManager(st, "gp", device="cpu", async_refit=True, **OPTS)
    for m in (sync, bg):
        m.observe(f[:20], q[:20])
        m.maybe_refit()
    assert bg.drain() and bg.refits == sync.refits == 1
    for a, b in zip(tman._leaves(sync._snap.state),
                    tman._leaves(bg._snap.state)):
        assert torch.equal(a, b)
    assert bg._snap[1:] == sync._snap[1:]
    assert bg.t_refit_bg_total > 0 and bg.t_refit_total == 0
    bg.close()
    assert not [t for t in threading.enumerate()
                if t.name.startswith("ut-surrogate-refit")]


def test_a_failed_background_fit_warns_and_rearms(spaces):
    sj, st = spaces
    f, q = rows(sj, 20, 5)
    msgs = []
    for m in (JManager(sj, "gp", async_refit=True, **OPTS),
              TManager(st, "gp", device="cpu", async_refit=True, **OPTS)):
        def boom(*a, **k):
            raise RuntimeError("boom")
        m._refit_full_body = boom
        m.observe(f, q)
        m.maybe_refit()
        with pytest.warns(RuntimeWarning) as w:
            assert m.drain()
        msgs.append([str(x.message) for x in w])
        assert not m.fitted and m._since_fit >= m.refit_interval
        m.close()
    assert msgs[1] == msgs[0] and "background surrogate refit failed" \
        in msgs[1][0]
    assert not [t for t in threading.enumerate()
                if t.name.startswith("ut-surrogate-refit")]


# -- the Tuner builds the manager -------------------------------------------------------
MANAGER_ATTRS = (
    "kind", "min_points", "refit_interval", "keep_quantile", "majority",
    "explore_frac", "max_points", "n_members", "select", "keep_frac",
    "score_kind", "propose_batch", "propose_every", "pool_mult",
    "min_model_points", "auto_passive", "arbitration",
    "propose_batch_parity", "screen_mode", "flip_bias", "async_refit",
    "incremental", "passive", "_n_cont", "_n_cat", "_use_kinv")


@pytest.mark.parametrize("kind", ["gp", "mlp"])
def test_tuner_builds_the_manager(spaces, kind):
    from uptune_tpu.calibrated import CALIBRATED_OPTS as JOPTS
    from uptune_tpu.driver import Tuner as JTuner

    from uptune_tpu_torch.calibrated import CALIBRATED_OPTS
    from uptune_tpu_torch.driver import Tuner as TTuner
    from test_torch_driver import objective
    assert CALIBRATED_OPTS == JOPTS
    jt = JTuner(spaces[0], objective, surrogate=kind,
                surrogate_opts=CALIBRATED_OPTS, seed=3)
    tt = TTuner(spaces[1], objective, surrogate=kind,
                surrogate_opts=CALIBRATED_OPTS, seed=3, device="cpu")
    assert isinstance(tt.surrogate, TManager)
    assert tt.surrogate.device == CPU
    for a in MANAGER_ATTRS:
        assert getattr(tt.surrogate, a) == getattr(jt.surrogate, a), a
    for n in (0, 16, 100, 300):
        assert tt.surrogate.fit_bucket(n) == jt.surrogate.fit_bucket(n)


# -- the Tuner in lockstep -----------------------------------------------------------------
def may_part(s, t, d, k: int, ordered: bool) -> bool:
    """Can the k smallest of the JAX scores `s` (and, `ordered`, their
    order) differ from those of the port's scores `t` when each row may
    move by up to `d`?  Two rows whose scores tie exactly on both sides
    are ordered by index on both."""
    o = np.argsort(s, kind="stable")
    v, w, e = s[o], t[o], d[o]
    close_pair = (np.abs(v[:, None] - v[None, :]) <= e[:, None] + e[None, :])
    close_pair &= ~((v[:, None] == v[None, :]) & (w[:, None] == w[None, :]))
    top = np.arange(len(v)) < k
    if close_pair[np.ix_(top, ~top)].any():
        return True
    return bool(ordered and np.triu(close_pair[:k, :k], 1).any())


class BandWatch:
    """Flags a ticket in which the two managers' picks may rightly part.
    For each keep mask and pool of the JAX manager the port's scores of
    the same rows come from the port's own model (each fits its own GP
    from its own rows); the ticket is flagged when two rows across the
    keep mask's cut (the k best eligible rows), or among the pool's
    picks (its n_out best, in order), lie closer than the two sides'
    score differences of those rows: there the float error of the two
    fits may swap them.  The largest difference is reported over its
    row's band (`score_band`); the unit tests above hold the fits and
    the scores to the tolerances.  (Flagging every pair within the band
    itself would stop the lockstep at the first fitted ticket: on this
    space the two fits' scores differ by about 1e-4 of the band there.
    Past a subsampled fit at noise 1e-4, K is ill-conditioned and the
    two fits' posteriors can part by more than the band: up to 8x on a
    40-ticket run of this lockstep.)"""

    def __init__(self, jm: JManager, tm: TManager):
        self.hit = False
        self.max_over_band = 0.0
        keep, propose = jm.keep_mask, jm.propose_pool

        def port_scores(cands, best_y):
            st = tm._snap
            return -N(tgp.expected_improvement(
                st.state, tm._sx(tm.space.features(jcands_to_t(cands))),
                best_y, tm._n_cont, tm._n_cat))

        def flag(s, t, tol, k, ordered):
            d = np.abs(s - t)
            self.max_over_band = max(self.max_over_band,
                                     float((d / tol).max()))
            self.hit |= may_part(s, t, d, k, ordered)

        def keep_mask(cands, candidate_mask=None):
            out = keep(cands, candidate_mask)
            if out is not None:
                s, _, tol = jax_scores(jm, cands)
                elig = (np.ones(cands.batch, bool) if candidate_mask is None
                        else np.asarray(candidate_mask))
                t = port_scores(cands, jm._snap.best_y)
                k = max(1, int(round(elig.sum() * jm.keep_frac)))
                flag(s[elig], t[elig], tol[elig], k, ordered=False)
            return out
        jm.keep_mask = keep_mask

        def propose_pool(key, *a):
            seen = []
            features = jm.space.features
            jm.space.features = lambda c: (seen.append(c), features(c))[1]
            try:
                out = propose(key, *a)
            finally:
                del jm.space.features
            if out is not None:
                snap = jm._snap
                feats = jm._sx(features(seen[0]))
                s = -np.asarray(jgp.expected_improvement(
                    snap.state, feats, jnp.float32(a[2]),
                    n_cont=jm._n_cont, n_cat=jm._n_cat))
                flag(s, port_scores(seen[0], a[2]),
                     score_band(jm, feats, lcb=False), out.batch,
                     ordered=True)
            return out
        jm.propose_pool = propose_pool


def test_tuner_lockstep_with_the_gp_manager(spaces, tmp_path):
    """The two Tuners with the GP manager (the calibrated options at test
    size) on the mixed space, every draw replayed: trials, StepStats,
    history and archive rows equal ticket by ticket until the first
    ticket whose keep mask or pool pick falls inside the band, which
    must come after at least 8 tickets with a fitted surrogate."""
    from test_torch_driver import archive_rows, make_pair
    jt, tt, rj, rt, rep = make_pair(tmp_path, spaces=spaces, seed=12,
                                    surrogate="gp",
                                    surrogate_opts=dict(OPTS))
    jm, tm = jt.surrogate, tt.surrogate
    mrep = Replay(jm, tm, quiet=rep._quiet)
    eager_pool(jm)
    watch = BandWatch(jm, tm)
    fitted, first_band = 0, None
    with shared_exp2():
        for ticket in range(LOCKSTEP_TICKETS):
            was_fitted = tm.fitted
            jt.step()
            tt.step()
            if watch.hit:
                first_band = ticket
                break
            assert rj.results == rt.results, ticket
            (sj, hj), (st, ht) = rj.steps[-1], rt.steps[-1]
            assert sj == st, (ticket, sj, st)
            for f in hj:
                assert_bitwise(hj[f], ht[f], f"ticket {ticket} hist.{f}")
            fitted += was_fitted
    print(f"lockstep: {fitted} fitted tickets equal; first ticket inside "
          f"the band: {first_band}; largest score difference over its "
          f"band before it {watch.max_over_band:.3g}")
    assert fitted >= 8, (fitted, first_band)
    assert tm.refits == jm.refits > 0 and tt.pruned_total > 0
    assert "surrogate" in {s.technique for s, _ in rt.steps}
    if first_band is None:
        assert rep.drained() and mrep.drained()
        jt._flush_archive()
        tt._flush_archive()
        assert archive_rows(jt.archive_path) == archive_rows(
            tt.archive_path)
