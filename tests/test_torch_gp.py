"""Parity of the port's GP surrogate (`uptune_tpu_torch/surrogate/gp.py`)
and the flagship's surrogate features with the JAX package, on the CPU.

Both packages get the same seeded numpy inputs.  Tolerances are the
reference's own cross-route ones (tests/test_pallas_score.py): the
posterior mean rtol 1e-4 / atol 1e-5, sd / EI / LCB rtol 1e-3 / atol
1e-5.  The factor, alpha and K^-1 come out of two LAPACK builds fed
kernel matrices that differ in the last bits (different matmul orders),
so they are held at the mean's tolerance relative to their own scale.
Chosen grid points are held exactly, subsample bitwise under replayed
draws.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from uptune_tpu.surrogate import gp as jgp

from uptune_tpu_torch import convert
from uptune_tpu_torch import rng as trng
from uptune_tpu_torch.surrogate import gp as tgp
from uptune_tpu_torch.surrogate import pallas_score as tps

from test_torch_ops import N, T, flagship_spaces

MEAN_TOL = dict(rtol=1e-4, atol=1e-5)
SD_TOL = dict(rtol=1e-3, atol=1e-5)


def onehot(codes, k):
    n, c = codes.shape
    oh = np.zeros((n, c, k), np.float32)
    np.put_along_axis(oh, codes[:, :, None], 1.0, axis=2)
    return (oh.reshape(n, -1) / np.sqrt(2)).astype(np.float32)


def data(kind, n=None):
    """(x, y, n_cont, n_cat) as numpy: the dense and mixed fixtures of
    tests/test_acquire.py and the all-categorical one of
    tests/test_pallas_score.py."""
    if kind == "dense":
        rng = np.random.RandomState(0)
        n = n or 48
        return (rng.rand(n, 6).astype(np.float32),
                rng.randn(n).astype(np.float32), None, 0)
    if kind == "mixed":
        rng = np.random.RandomState(1)
        n = n or 56
        codes = rng.randint(3, size=(n, 4))
        x = np.concatenate([rng.rand(n, 3).astype(np.float32),
                            onehot(codes, 3)], axis=1)
        y = (x[:, 0] + 2.0 * (codes[:, 1] == 0)
             + 0.1 * rng.randn(n)).astype(np.float32)
        return x, y, 3, 4
    rng = np.random.RandomState(4)
    n = n or 64
    codes = rng.randint(3, size=(n, 6))
    y = (3.0 * (codes[:, 0] == 1) - 2.0 * (codes[:, 3] == 2)
         + 0.05 * rng.randn(n)).astype(np.float32)
    return onehot(codes, 3), y, 0, 6


KINDS = ["dense", "mixed", "allcat"]
HYPER = {"dense": (0.3, 1e-3, 1.0), "mixed": (0.4, 1e-2, 0.2),
         "allcat": (0.4, 1e-2, 0.3)}


def close(a, b, tol, what=""):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    scale = max(1.0, float(np.abs(b).max()))
    np.testing.assert_allclose(a, b, rtol=tol["rtol"],
                               atol=tol["atol"] * scale, err_msg=what)


@functools.lru_cache(maxsize=None)
def fit_both(kind, n=None, kinv=True):
    x, y, nc, ncat = data(kind, n)
    ls, nz, lc = HYPER[kind]
    sj = jgp.fit(jnp.asarray(x), jnp.asarray(y), ls, nz, n_cont=nc,
                 n_cat=ncat, ls_cat=lc)
    st = tgp.fit(T(x), T(y), ls, nz, n_cont=nc, n_cat=ncat, ls_cat=lc)
    if kinv:
        sj, st = jgp.precompute_kinv(sj), tgp.precompute_kinv(st)
    return sj, st, x, y, nc, ncat


def queries(f, n=200, seed=2):
    return np.random.RandomState(seed).rand(n, f).astype(np.float32)


def assert_same_posterior(sj, st, nc, ncat):
    """The chosen point can leave K ill-conditioned (noise 1e-4), which
    amplifies last-bit differences in alpha; the posterior it defines is
    what must agree, at the mean's tolerance relative to its scale."""
    xq = queries(sj.x.shape[1])
    mj, sdj = jgp.predict(sj, jnp.asarray(xq), nc, ncat)
    mt, sdt = tgp.predict(st, T(xq), nc, ncat)
    close(N(mt), mj, MEAN_TOL, "mean")
    close(N(sdt), sdj, SD_TOL, "sd")


# -- the surrogate features ------------------------------------------------------
def test_surrogate_transform_matches():
    sj, st = flagship_spaces()
    assert (st.n_cont_features, st.n_cat, st.n_surrogate_features) == (
        sj.n_cont_features, sj.n_cat, sj.n_surrogate_features) == (23, 2, 31)
    cands = sj.random(jax.random.PRNGKey(3), 512)
    fj = np.asarray(sj.surrogate_transform(sj.features(cands)))
    from test_torch_ops import jcands_to_t
    ft = N(st.surrogate_transform(st.features(jcands_to_t(cands))))
    assert ft.shape == fj.shape == (512, 31)
    # the one-hot block and the perm positions are exact; the snapped
    # numeric lanes go through decode/encode transcendentals (a few ulps)
    np.testing.assert_array_equal(ft[:, 23:], fj[:, 23:])
    np.testing.assert_array_equal(ft[:, 11:23], fj[:, 11:23])
    np.testing.assert_allclose(ft[:, :11], fj[:, :11], rtol=0, atol=1e-5)


# -- fit ------------------------------------------------------------------------------
@pytest.mark.parametrize("kind", KINDS)
def test_fit_matches(kind):
    sj, st, *_ = fit_both(kind)
    close(N(st.chol), sj.chol, MEAN_TOL, "chol")
    close(N(st.alpha), sj.alpha, MEAN_TOL, "alpha")
    close(N(st.kinv), sj.kinv, MEAN_TOL, "kinv")
    for f in ("y_mean", "y_std", "lengthscale", "noise", "ls_cat", "mask"):
        np.testing.assert_allclose(N(getattr(st, f)),
                                   np.asarray(getattr(sj, f)), rtol=1e-6,
                                   err_msg=f)


@pytest.mark.parametrize("kind", KINDS)
def test_fit_auto_picks_the_same_grid_point(kind):
    x, y, nc, ncat = data(kind)
    sj = jgp.fit_auto(jnp.asarray(x), jnp.asarray(y), n_cont=nc, n_cat=ncat)
    st = tgp.fit_auto(T(x), T(y), n_cont=nc, n_cat=ncat)
    for f in ("lengthscale", "noise", "ls_cat"):
        assert float(getattr(st, f)) == float(getattr(sj, f)), f
    assert_same_posterior(sj, st, nc, ncat)


def test_fit_auto_bucketed_pads_and_subsamples():
    x, y, nc, ncat = data("mixed", 90)
    key = jax.random.PRNGKey(5)
    sj = jgp.fit_auto_bucketed(jnp.asarray(x), jnp.asarray(y), max_points=64,
                               key=key, n_cont=nc, n_cat=ncat)
    # the port's subsample, fed the draw jax.random.choice made
    pick = T(jax.random.choice(key, 90 - 32, (32,), replace=False))
    st = tgp.fit_auto_bucketed(T(x), T(y), max_points=64, pick=pick,
                               n_cont=nc, n_cat=ncat)
    assert st.x.shape == (64, 15)
    np.testing.assert_array_equal(N(st.x), np.asarray(sj.x))
    for f in ("lengthscale", "noise", "ls_cat"):
        assert float(getattr(st, f)) == float(getattr(sj, f)), f
    assert_same_posterior(sj, st, nc, ncat)
    # 40 rows: padded to the 64-row bucket, mask 40 ones
    sp = tgp.fit_auto_bucketed(T(x[:40]), T(y[:40]), max_points=64,
                               n_cont=nc, n_cat=ncat)
    assert sp.x.shape == (64, 15) and float(sp.mask.sum()) == 40


def test_fit_auto_scores_a_failed_factorization_minus_inf():
    """A grid point whose K + noise I is not positive definite: JAX's
    Cholesky returns NaN there, torch.linalg.cholesky would raise; the
    port uses cholesky_ex, scores the point -inf, and both packages pick
    the other point."""
    x, y, _, _ = data("dense")
    grid = dict(ls_grid=(3.0,), noise_grid=(-0.5, 1e-2))
    assert np.isnan(float(jgp.log_marginal_likelihood(
        jnp.asarray(x), jnp.asarray(y), 3.0, -0.5)))
    assert np.isnan(float(tgp.log_marginal_likelihood(T(x), T(y), 3.0,
                                                      -0.5)))
    sj = jgp.fit_auto(jnp.asarray(x), jnp.asarray(y), **grid)
    st = tgp.fit_auto(T(x), T(y), **grid)
    assert float(sj.noise) == float(st.noise) == np.float32(1e-2)
    assert np.isfinite(N(st.alpha)).all()


# -- extend, subsample ------------------------------------------------------------------
@pytest.mark.parametrize("kind", ["dense", "mixed"])
def test_extend_matches_jax_and_a_full_fit(kind):
    x, y, nc, ncat = data(kind, 30)
    ls, nz, lc = HYPER[kind]
    xj, yj, mj = jgp.pad_train(jnp.asarray(x[:20]), jnp.asarray(y[:20]), 32)
    sj = jgp.precompute_kinv(jgp.fit(xj, yj, ls, nz, mj, n_cont=nc,
                                     n_cat=ncat, ls_cat=lc))
    xt, yt, mt = tgp.pad_train(T(x[:20]), T(y[:20]), 32)
    st = tgp.precompute_kinv(tgp.fit(xt, yt, ls, nz, mt, n_cont=nc,
                                     n_cat=ncat, ls_cat=lc))
    for i in range(20, 22):
        sj = jgp.extend(sj, jnp.asarray(x[i]), jnp.asarray(y[i]),
                        jnp.int32(i), n_cont=nc, n_cat=ncat)
        st = tgp.extend(st, T(x[i]), float(y[i]), i, n_cont=nc, n_cat=ncat)
    for f in ("x", "mask"):
        np.testing.assert_array_equal(N(getattr(st, f)),
                                      np.asarray(getattr(sj, f)))
    close(N(st.chol), sj.chol, MEAN_TOL, "chol vs JAX")
    close(N(st.alpha), sj.alpha, MEAN_TOL, "alpha vs JAX")
    close(N(st.kinv), sj.kinv, MEAN_TOL, "kinv vs JAX")
    # the port's own fit on the 22 rows, with the 20-row standardization
    x1, y1, m1 = tgp.pad_train(T(x[:22]), T(y[:22]), 32)
    full = tgp.precompute_kinv(tgp.fit(x1, y1, ls, nz, m1, n_cont=nc,
                                       n_cat=ncat, ls_cat=lc))
    yn = (y1 - st.y_mean) / st.y_std * m1
    alpha = torch.cholesky_solve(yn[:, None], full.chol)[:, 0]
    close(N(st.chol), N(full.chol), MEAN_TOL, "chol vs fit")
    close(N(st.alpha), N(alpha), MEAN_TOL, "alpha vs fit")
    close(N(st.kinv), N(full.kinv), MEAN_TOL, "kinv vs fit")


def test_subsample_bitwise_under_replayed_draws():
    rng = np.random.RandomState(7)
    x = rng.rand(300, 5).astype(np.float32)
    y = rng.randn(300).astype(np.float32)
    key = jax.random.PRNGKey(11)
    xj, yj = jgp.subsample(key, jnp.asarray(x), jnp.asarray(y), 100)
    pick = T(jax.random.choice(key, 250, (50,), replace=False))
    xt, yt = tgp.subsample(T(x), T(y), 100, pick)
    np.testing.assert_array_equal(N(xt), np.asarray(xj))
    np.testing.assert_array_equal(N(yt), np.asarray(yj))
    # the port's own draw: 50 distinct rows past the best half
    d = tgp.draw_subsample(trng.generator(0, "cpu"), 300, 100)
    assert d.shape == (50,) and len(set(d.tolist())) == 50
    assert int(d.max()) < 250


# -- predict, EI, LCB, thompson, score_flat -------------------------------------------
@pytest.mark.parametrize("kind", KINDS)
def test_predict_and_acquisitions_match(kind):
    sj, st, x, y, nc, ncat = fit_both(kind)
    xq = queries(x.shape[1])
    mj, sdj = jgp.predict(sj, jnp.asarray(xq), nc, ncat)
    mt, sdt = tgp.predict(st, T(xq), nc, ncat)
    np.testing.assert_allclose(N(mt), np.asarray(mj), **MEAN_TOL)
    np.testing.assert_allclose(N(sdt), np.asarray(sdj), **SD_TOL)
    best = float(y.min())
    np.testing.assert_allclose(
        N(tgp.expected_improvement(st, T(xq), best, nc, ncat)),
        np.asarray(jgp.expected_improvement(sj, jnp.asarray(xq), best, nc,
                                            ncat)), **SD_TOL)
    np.testing.assert_allclose(
        N(tgp.lower_confidence_bound(st, T(xq), 2.0, nc, ncat)),
        np.asarray(jgp.lower_confidence_bound(sj, jnp.asarray(xq), 2.0, nc,
                                              ncat)), **SD_TOL)
    key = jax.random.PRNGKey(9)
    z = T(jax.random.normal(key, (200,)))
    np.testing.assert_allclose(
        N(tgp.thompson(st, T(xq), z, nc, ncat)),
        np.asarray(jgp.thompson(sj, jnp.asarray(xq), key, nc, ncat)),
        **SD_TOL)


def test_ei_from_moments_matches():
    rng = np.random.RandomState(3)
    mu = rng.randn(500).astype(np.float32)
    sd = np.abs(rng.randn(500)).astype(np.float32)
    sd[:20] = 0.0                               # the 1e-9 floor
    np.testing.assert_allclose(
        N(tgp.ei_from_moments(T(mu), T(sd), 0.1)),
        np.asarray(jgp.ei_from_moments(jnp.asarray(mu), jnp.asarray(sd),
                                       jnp.float32(0.1))), **SD_TOL)


@pytest.mark.parametrize("score", ["mean", "ei", "lcb"])
@pytest.mark.parametrize("kind", ["dense", "mixed"])
def test_score_flat_matches(kind, score):
    """Below the 4096-row gate both packages score through predict; a
    leading shape [2, 100] flattens and comes back."""
    sj, st, x, y, nc, ncat = fit_both(kind)
    xq = queries(x.shape[1]).reshape(2, 100, -1)
    best = float(y.min()) if score == "ei" else None
    tol = MEAN_TOL if score == "mean" else SD_TOL
    got = tgp.score_flat(st, T(xq), score, best, n_cont=nc, n_cat=ncat)
    ref = jgp.score_flat(sj, jnp.asarray(xq), score, best, n_cont=nc,
                         n_cat=ncat)
    assert got.shape == (2, 100)
    np.testing.assert_allclose(N(got), np.asarray(ref), **tol)


@pytest.mark.parametrize("score", ["mean", "ei"])
def test_score_flat_fused_path_matches_interpret_mode(score):
    """At the 4096-row gate both take the fused tiles: JAX's Pallas
    kernels in interpret mode, the port's plain tiles."""
    sj, st, x, y, nc, ncat = fit_both("mixed")
    xq = queries(x.shape[1], n=tps.PALLAS_MIN_POOL)
    best = float(y.min()) if score == "ei" else None
    tol = MEAN_TOL if score == "mean" else SD_TOL
    got = tgp.score_flat(st, T(xq), score, best, n_cont=nc, n_cat=ncat)
    ref = jgp.score_flat(sj, jnp.asarray(xq), score, best, n_cont=nc,
                         n_cat=ncat, interpret=True)
    np.testing.assert_allclose(N(got), np.asarray(ref), **tol)


def test_from_jax_gp_roundtrip():
    sj, _, x, _, nc, ncat = fit_both("mixed")
    st = convert.from_jax_gp(jax.tree_util.tree_map(np.asarray, sj),
                             device="cpu")
    for f in sj._fields:
        np.testing.assert_array_equal(N(getattr(st, f)),
                                      np.asarray(getattr(sj, f)), f)
    xq = queries(x.shape[1])
    mj, _ = jgp.predict(sj, jnp.asarray(xq), nc, ncat)
    mt, _ = tgp.predict(st, T(xq), nc, ncat)
    np.testing.assert_allclose(N(mt), np.asarray(mj), **MEAN_TOL)


# -- full_f32 across threads ---------------------------------------------------
def test_full_f32_windows_overlap_across_threads():
    """Two threads open and close nested `full_f32` windows in an
    interleaved order under a caller's TF32 setting: inside every window
    the setting is full float32, and the caller's is back at the end
    (the first window to open saved it, the last to close restores
    it)."""
    import threading
    seen = []
    steps = [threading.Event() for _ in range(6)]

    def inside(tag):
        seen.append((tag, torch.get_float32_matmul_precision()))

    def a():                          # opens first, closes in the middle
        with tgp.full_f32():
            inside("a")
            steps[0].set()
            steps[1].wait(10)
            inside("a")
        steps[2].set()

    def b():                          # nested windows, closes last
        steps[0].wait(10)
        with tgp.full_f32():
            inside("b")
            steps[1].set()
            steps[2].wait(10)
            inside("b after a closed")
            with tgp.full_f32():
                inside("b nested")
            inside("b")

    prev = torch.get_float32_matmul_precision()
    torch.set_float32_matmul_precision("high")
    try:
        ts = [threading.Thread(target=f) for f in (a, b)]
        for t in ts:
            t.start()
        for t in ts:
            t.join(30)
        after = torch.get_float32_matmul_precision()
    finally:
        torch.set_float32_matmul_precision(prev)
    assert len(seen) == 6 and all(p == "highest" for _, p in seen), seen
    assert after == "high"
