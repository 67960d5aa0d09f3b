"""Parity of the port's NOTEARS (`uptune_tpu_torch/plugins/notears.py`)
with the JAX package's, on the CPU, and tests/test_notears.py's bodies
on the port.

Both packages run on the same seeded numpy inputs; `simulate_dag` gets
the numbers `jax.random` drew (`jax_dag_draws`).  What is held:

* `h_func`: within rtol 1e-5 and atol 1e-5 (h is tr(e^{W∘W}) - d, a
  cancellation: float32 leaves it about 1e-6 of absolute error at d 10,
  and `jax.scipy.linalg.expm` (Padé) and `torch.linalg.matrix_exp`
  (Taylor) are different approximations);
* the inner solver's first gradient within rtol 1e-4, atol 1e-5 times
  its largest entry, and a short lockstep (`LOCKSTEP` projected-Adam
  steps) within 1e-5 on the entries whose first gradient stands clear
  of the noise (|g| > `CLEAR` times the largest): an entry at noise
  level moves by about +-lr whichever way its sign falls, so the raw
  iterate is not held there;
* `_break_cycles`, `_ols_refit` and `simulate_dag` (draws replayed):
  bitwise;
* `notears` on test_notears.py's d 6 graph, with and without a
  forbidden mask: the support equal to JAX's, and the refit weights
  bitwise (both refit the same normalised data by numpy on the same
  support);
* the reference's own bodies (TestHFunc, TestBreakCycles, TestRecovery,
  TestCovariateGraph) with their names pointed at the port, on the CPU.
"""
import functools
import importlib
import inspect

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import test_notears as ref
from test_torch_ops import N, T

# the modules (each package's `plugins.notears` attribute is the function)
jnt = importlib.import_module("uptune_tpu.plugins.notears")
tnt = importlib.import_module("uptune_tpu_torch.plugins.notears")

H_TOL = {"rtol": 1e-5, "atol": 1e-5}
GRAD_RTOL = 1e-4
LOCKSTEP = 5
CLEAR = 1e-2
LOCKSTEP_ATOL = 1e-5


def jax_dag_draws(key, d, n_edges, n_samples, w_range=(0.5, 2.0)):
    """The numbers JAX's `simulate_dag` draws, as the port's DagDraws."""
    kw, ks, kz = jax.random.split(key, 3)
    p = d * (d - 1) // 2
    idx = jax.random.choice(kw, p, (min(n_edges, p),), replace=False)
    mag = jax.random.uniform(ks, (p,), minval=w_range[0],
                             maxval=w_range[1])
    sign = jax.random.bernoulli(kz, 0.5, (p,))
    z = jax.random.normal(jax.random.fold_in(kz, 1), (n_samples, d))
    return tnt.DagDraws(*(np.asarray(a) for a in (idx, mag, sign, z)))


def port_simulate_dag(key, d, n_edges, n_samples, w_range=(0.5, 2.0),
                      noise=1.0):
    """The port's simulate_dag fed JAX's draws of `key`."""
    return tnt.dag_from_draws(
        jax_dag_draws(key, d, n_edges, n_samples, w_range), d, noise)


_RUNS = {}


def port_notears(x, **kw):
    """The port's notears on the CPU, each (x, options) solved once in
    the file: the reference's d 6 bodies reuse the parity tests' runs."""
    out = kw.pop("info", None)
    kw = {k: v for k, v in kw.items() if v is not None}
    key = (np.asarray(x, np.float32).tobytes(), repr(sorted(
        (k, np.asarray(v).tobytes() if k == "forbidden" else v)
        for k, v in kw.items())))
    if key not in _RUNS:
        info = {}
        _RUNS[key] = (tnt.notears(x, device="cpu", info=info, **kw), info)
    w, info = _RUNS[key]
    if out is not None:
        out.update(info)
    return w.copy()


def random_w(d, seed, scale=0.4, density=0.5):
    rs = np.random.RandomState(seed)
    w = rs.randn(d, d) * scale * (rs.rand(d, d) < density)
    np.fill_diagonal(w, 0.0)
    return w.astype(np.float32)


def prepared(x, forbidden=None):
    """x and the free mask as `notears` prepares them."""
    x = np.asarray(x, np.float32)
    x = x - x.mean(0)
    x = x / max(float(x.std()), 1e-8)
    d = x.shape[1]
    free = 1.0 - np.eye(d, dtype=np.float32)
    if forbidden is not None:
        free = free * (1.0 - np.asarray(forbidden, np.float32))
    return x, free


@pytest.mark.parametrize("d,seed,scale", [(3, 0, 1.0), (6, 1, 0.4),
                                          (10, 2, 0.3), (10, 3, 0.6),
                                          (32, 4, 0.15)])
def test_h_func(d, seed, scale):
    w = random_w(d, seed, scale)
    np.testing.assert_allclose(float(tnt.h_func(T(w))),
                               float(jnt.h_func(jnp.asarray(w))), **H_TOL)


def test_h_func_zero_on_a_dag():
    w = np.triu(random_w(8, 5, 1.0), 1)
    assert abs(float(tnt.h_func(T(w)))) <= H_TOL["atol"]


@pytest.fixture(scope="module")
def subproblem():
    """test_notears.py's d 6 data, prepared as notears does, and a
    non-zero starting iterate."""
    _, x = port_simulate_dag(jax.random.PRNGKey(0), 6, 6, 800)
    x, free = prepared(x)
    w0 = random_w(6, 7, 0.3) * free
    return x, free, w0, 10.0, 0.5, 0.05, 2e-2


def test_first_gradient(subproblem):
    """One gradient of the smooth objective plus the split's L1 term:
    autograd through matrix_exp against jax.grad through expm."""
    x, free, w0, rho, alpha, lam, _ = subproblem
    ws0 = np.stack([np.maximum(w0, 0), np.maximum(-w0, 0)])

    def jobj(ws):
        w = (ws[0] - ws[1]) * free
        return (jnt._smooth_obj(w, jnp.asarray(x), jnp.float32(rho),
                                jnp.float32(alpha))
                + lam * jnp.sum(ws[0] + ws[1]))
    gj = np.asarray(jax.grad(jobj)(jnp.asarray(ws0)))
    wst = T(ws0).requires_grad_(True)
    w = (wst[0] - wst[1]) * T(free)
    obj = (tnt._smooth_obj(w, T(x), torch.tensor(rho), torch.tensor(alpha))
           + lam * torch.sum(wst[0] + wst[1]))
    gt, = torch.autograd.grad(obj, wst)
    np.testing.assert_allclose(N(gt), gj, rtol=GRAD_RTOL,
                               atol=GRAD_RTOL * float(np.abs(gj).max()))


def test_inner_solver_lockstep(subproblem):
    """LOCKSTEP projected-Adam steps of both solvers from one iterate,
    held on the entries whose first gradient stands clear of the
    noise."""
    x, free, w0, rho, alpha, lam, lr = subproblem
    got = N(tnt._minimize_subproblem(
        T(w0), T(x), torch.tensor(rho), torch.tensor(alpha), lam, T(free),
        LOCKSTEP, lr))
    want = np.asarray(jnt._minimize_subproblem(
        jnp.asarray(w0), jnp.asarray(x), jnp.float32(rho),
        jnp.float32(alpha), lam, jnp.asarray(free), LOCKSTEP, lr))

    def jobj(w):
        return jnt._smooth_obj(w * free, jnp.asarray(x), jnp.float32(rho),
                               jnp.float32(alpha))
    g = np.abs(np.asarray(jax.grad(jobj)(jnp.asarray(w0))))
    clear = (g > CLEAR * g.max()) & (free > 0)
    assert clear.sum() >= 10
    np.testing.assert_allclose(got[clear], want[clear], rtol=0,
                               atol=LOCKSTEP_ATOL)
    assert (got[free == 0] == 0).all()


@pytest.mark.parametrize("seed", range(4))
def test_break_cycles_bitwise(seed):
    rs = np.random.RandomState(seed)
    d = 7
    w = (rs.randn(d, d) * (rs.rand(d, d) < 0.35)).astype(np.float32)
    np.fill_diagonal(w, 0.0)
    np.testing.assert_array_equal(tnt._break_cycles(w),
                                  jnt._break_cycles(w))


@pytest.mark.parametrize("seed", range(3))
def test_ols_refit_bitwise(seed):
    rs = np.random.RandomState(seed)
    x = rs.randn(200, 6).astype(np.float32)
    support = np.triu(rs.rand(6, 6) < 0.5, 1)
    np.testing.assert_array_equal(tnt._ols_refit(x, support),
                                  jnt._ols_refit(x, support))


@pytest.mark.parametrize("seed,d,edges,n", [(0, 6, 6, 800),
                                            (2, 10, 12, 300)])
def test_simulate_dag_with_jax_draws(seed, d, edges, n):
    key = jax.random.PRNGKey(seed)
    wj, xj = jnt.simulate_dag(key, d, edges, n)
    wt, xt = port_simulate_dag(key, d, edges, n)
    np.testing.assert_array_equal(wt, wj)
    np.testing.assert_array_equal(xt, xj)


def test_simulate_dag_own_draws():
    """The port's own draws: a DAG (strictly upper triangular) with the
    asked edge count, magnitudes in w_range, the same on every call."""
    w, x = tnt.simulate_dag(3, 8, 9, 50, device="cpu")
    assert (np.tril(w) == 0).all() and (w != 0).sum() == 9
    assert ((np.abs(w[w != 0]) >= 0.5) & (np.abs(w[w != 0]) < 2.0)).all()
    assert x.shape == (50, 8) and x.dtype == np.float32
    w2, x2 = tnt.simulate_dag(3, 8, 9, 50, device="cpu")
    np.testing.assert_array_equal(x, x2)


@pytest.fixture(scope="module")
def d6():
    """test_notears.py's d 6 graph, JAX's draws."""
    return port_simulate_dag(jax.random.PRNGKey(0), 6, 6, 800)


@pytest.mark.parametrize("forbid_row", [None, 0])
def test_notears_matches_jax(d6, forbid_row):
    w_true, x = d6
    forbid = None
    if forbid_row is not None:
        forbid = np.zeros((6, 6), bool)
        forbid[forbid_row, :] = True
    wj = jnt.notears(x, lambda1=0.05, forbidden=forbid)
    info = {}
    wt = port_notears(x, lambda1=0.05, forbidden=forbid, info=info)
    np.testing.assert_array_equal(wt != 0, wj != 0)
    np.testing.assert_array_equal(wt, wj)
    assert info["subproblems"] >= 1
    assert info["adam_steps"] == 400 * info["subproblems"]
    # the refit ran on the structure, and w_threshold only drops edges
    assert info["support"].shape == (6, 6)
    assert (info["support"] | (wt == 0)).all()
    if forbid is not None:
        assert (wt[forbid_row, :] == 0).all()


def test_default_device_is_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tnt.notears(np.zeros((20, 3), np.float32))


# -- the reference's bodies on the port ---------------------------------------
PORT_NAMES = {
    "h_func": lambda w: tnt.h_func(T(np.asarray(w, np.float32))),
    "_break_cycles": tnt._break_cycles,
    "notears": port_notears,
    "covariate_graph": functools.partial(tnt.covariate_graph, device="cpu"),
    "simulate_dag": port_simulate_dag,
}
REF_CASES = [(c, n) for c in ("TestHFunc", "TestBreakCycles",
                              "TestRecovery", "TestCovariateGraph")
             for n, _ in inspect.getmembers(getattr(ref, c),
                                            inspect.isfunction)
             if n.startswith("test_")]


@pytest.mark.parametrize("cls,name", REF_CASES)
def test_reference_body_on_the_port(cls, name, monkeypatch):
    for attr, value in PORT_NAMES.items():
        monkeypatch.setattr(ref, attr, value)
    getattr(getattr(ref, cls)(), name)()
