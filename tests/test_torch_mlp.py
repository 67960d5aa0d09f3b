"""Parity of the port's MLP ensemble (`uptune_tpu_torch/surrogate/mlp.py`)
with the JAX package's, on the CPU.

Both packages fit from the same seeded numpy rows and the same init: the
normals `jax.random` draws inside the JAX `fit` are replayed into the
port's `fit` (its `draw_init` step is left out).  Tolerances:

* the first Adam step (normalisation, per-member losses, gradients and
  the stepped parameters): rtol 1e-5, with an atol of 1e-5 times the
  array's largest magnitude (`step_close`: a gradient entry that is a
  sum cancelling to near zero keeps only the absolute error of its
  terms);
* after the full 300 steps, `predict_members` within `FIT_TOL_Y_STD`
  units of the targets' std (measured on these fixtures: 2.1e-6; XLA
  runs the 300 steps as one compiled scan with its own fusions and
  transcendentals, the port op by op, and the differences compound over
  the steps, so this bound is looser than the first step's);
* one ensemble carried across (`convert.from_jax_mlp`): rtol 1e-5.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from uptune_tpu.surrogate import mlp as jmlp

from uptune_tpu_torch import convert
from uptune_tpu_torch import rng as trng
from uptune_tpu_torch.surrogate import mlp as tmlp

from test_torch_ops import N, T

STEP_RTOL = 1e-5
FIT_TOL_Y_STD = 1e-4
E, F_IN, N_ROWS, BUCKET = 4, 12, 40, 64


def rows(seed=0, n=N_ROWS):
    """Seeded features and targets, two targets failed (NaN)."""
    rs = np.random.RandomState(seed)
    x = rs.rand(n, F_IN).astype(np.float32)
    y = (np.sin(4 * x[:, 0]) + (x[:, 1] - 0.5) ** 2
         + 0.1 * rs.randn(n)).astype(np.float32)
    y[[3, 17]] = np.nan
    return x, y


def jax_init(key, sizes, n_members=E):
    """The normals JAX's `fit` draws for its members' weights, stacked
    as the port's `draw_init` returns them ([E, din, dout] a layer)."""
    layers = [[] for _ in sizes[:-1]]
    for k in jax.random.split(key, n_members):
        for i, (din, dout) in enumerate(zip(sizes[:-1], sizes[1:])):
            k, kw = jax.random.split(k)
            layers[i].append(np.asarray(jax.random.normal(kw, (din, dout))))
    return tuple(T(np.stack(z)) for z in layers)


def fit_both(steps, key=jax.random.PRNGKey(3), mask=None):
    x, y = rows()
    sj = jmlp.fit(key, jnp.asarray(x), jnp.asarray(y), steps=steps,
                  mask=None if mask is None else jnp.asarray(mask))
    st = tmlp.fit(jax_init(key, tmlp.layer_sizes(F_IN)), T(x), T(y),
                  steps=steps, mask=None if mask is None else T(mask))
    return sj, st, x, y


def queries(n=300, seed=5):
    return np.random.RandomState(seed).rand(n, F_IN).astype(np.float32)


def step_close(got, want, what=""):
    want = np.asarray(want, np.float64)
    np.testing.assert_allclose(
        np.asarray(got, np.float64), want, rtol=STEP_RTOL,
        atol=STEP_RTOL * float(np.abs(want).max()), err_msg=what)


def assert_state_close(sj, st):
    for f in ("x_mean", "x_std", "y_mean", "y_std"):
        step_close(N(getattr(st, f)), getattr(sj, f), f)
    for i, ((wj, bj), (wt, bt)) in enumerate(zip(sj.params, st.params)):
        step_close(N(wt), wj, f"w{i}")
        step_close(N(bt), bj, f"b{i}")


def test_init_replays_jax_draws():
    """Zero steps: the He-scaled init is JAX's bitwise."""
    sj, st, _, _ = fit_both(0)
    for (wj, bj), (wt, bt) in zip(sj.params, st.params):
        np.testing.assert_array_equal(N(wt), np.asarray(wj))
        np.testing.assert_array_equal(N(bt), np.asarray(bj))


def test_first_adam_step_matches():
    """Loss, gradients and the stepped parameters of the first step."""
    s0j, s0t, x, y = fit_both(0)
    assert_state_close(s0j, s0t)
    # JAX's loss and gradients per member, at its init
    finite = np.isfinite(y)
    yc = np.where(finite, y, y[finite].max()).astype(np.float32)
    xn = (jnp.asarray(x) - s0j.x_mean) / s0j.x_std
    yn = (jnp.asarray(yc) - s0j.y_mean) / s0j.y_std
    n = jnp.float32(len(y))

    def loss(p):
        return ((jmlp._forward(p, xn) - yn) ** 2).sum() / n
    lj = jax.vmap(loss)(s0j.params)
    gj = jax.vmap(jax.grad(loss))(s0j.params)
    # the port's, at its init
    xt = (T(x) - s0t.x_mean) / s0t.x_std
    yt = (T(yc) - s0t.y_mean) / s0t.y_std
    flat = [t.clone().requires_grad_(True) for pair in s0t.params
            for t in pair]
    lt = tmlp._member_losses(tmlp._pairs(flat), xt, yt,
                             torch.ones(len(y)), torch.tensor(float(len(y))))
    gt = torch.autograd.grad(lt.sum(), flat)
    step_close(N(lt.detach()), lj, "loss")
    for i, (a, b) in enumerate(zip(gt, jax.tree_util.tree_leaves(gj))):
        step_close(N(a), b, f"grad {i}")
    s1j, s1t, _, _ = fit_both(1)
    assert_state_close(s1j, s1t)


def test_full_fit_predictions_match():
    sj, st, _, _ = fit_both(300)
    xq = queries()
    pj = np.asarray(jmlp.predict_members(sj, jnp.asarray(xq)))
    pt = N(tmlp.predict_members(st, T(xq)))
    assert pt.shape == pj.shape == (E, len(xq))
    err = np.abs(pt - pj).max() / float(sj.y_std)
    assert err <= FIT_TOL_Y_STD, err


def test_mask_and_padding_rows_change_nothing():
    """Padded to a 64-row bucket (junk features, NaN targets, mask 0)
    the fit predicts as the 40 real rows do; so does JAX's padded fit."""
    key = jax.random.PRNGKey(3)
    x, y = rows()
    rs = np.random.RandomState(9)
    xp = np.concatenate([x, rs.rand(BUCKET - N_ROWS, F_IN).astype(
        np.float32) * 5.0])
    yp = np.concatenate([y, np.full(BUCKET - N_ROWS, np.nan, np.float32)])
    mp = np.concatenate([np.ones(N_ROWS, np.float32),
                         np.zeros(BUCKET - N_ROWS, np.float32)])
    init = jax_init(key, tmlp.layer_sizes(F_IN))
    st = tmlp.fit(init, T(x), T(y))
    sp = tmlp.fit(init, T(xp), T(yp), mask=T(mp))
    xq = T(queries())
    ys = float(st.y_std)
    pad_err = float((tmlp.predict_members(sp, xq)
                     - tmlp.predict_members(st, xq)).abs().max()) / ys
    assert pad_err <= FIT_TOL_Y_STD, pad_err
    sj = jmlp.fit(key, jnp.asarray(xp), jnp.asarray(yp), mask=jnp.asarray(mp))
    pj = np.asarray(jmlp.predict_members(sj, jnp.asarray(N(xq))))
    err = np.abs(N(tmlp.predict_members(sp, xq)) - pj).max() / ys
    assert err <= FIT_TOL_Y_STD, err


def test_predict_is_the_member_mean_and_std():
    init = tmlp.draw_init(trng.generator(4, "cpu"), tmlp.layer_sizes(F_IN), E)
    x, y = rows()
    st = tmlp.fit(init, T(x), T(y), steps=20)
    xq = T(queries(50))
    preds = N(tmlp.predict_members(st, xq)).astype(np.float64)
    mu, sd = tmlp.predict(st, xq)
    np.testing.assert_allclose(N(mu), preds.mean(0), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(N(sd), preds.std(0), rtol=1e-5, atol=1e-6)


def test_fit_rejects_init_draws_of_other_layers():
    init = tmlp.draw_init(trng.generator(0, "cpu"), tmlp.layer_sizes(5), E)
    x, y = rows()
    with pytest.raises(ValueError, match="do not match the layers"):
        tmlp.fit(init, T(x), T(y), steps=1)


def test_from_jax_mlp_scores_one_ensemble():
    sj = jmlp.fit(jax.random.PRNGKey(7), *(jnp.asarray(a) for a in rows()),
                  steps=30)
    st = convert.from_jax_mlp(sj, device="cpu")
    xq = queries()
    np.testing.assert_allclose(
        N(tmlp.predict_members(st, T(xq))),
        np.asarray(jmlp.predict_members(sj, jnp.asarray(xq))),
        rtol=1e-5, atol=1e-6)
    mj, sdj = jmlp.predict(sj, jnp.asarray(xq))
    mt, sdt = tmlp.predict(st, T(xq))
    np.testing.assert_allclose(N(mt), np.asarray(mj), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(N(sdt), np.asarray(sdj), rtol=1e-5, atol=1e-6)
