"""Launchers A-D's plain versions at the widest space the repo ships:
the gcc-options sample's lanes, 96 continuous + 233 categorical one-hot
over 4 codes (F = 1028), against the JAX package on the CPU.

On the card, krows and A take such a width in chunks of features (one
block held at most 361 / 376 of them); their plain versions, which the
CPU runs, must hold the JAX package's results there as at F = 31: the
XLA route for every kernel family, and one family's Pallas kernel in
interpret mode.  Small B and N; the state is fitted by JAX and carried
over with `convert.from_jax_gp`.  Tolerances as tests/test_torch_acquire.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from uptune_tpu.ops import acquire as jacq
from uptune_tpu.ops import routing
from uptune_tpu.surrogate import gp as jgp

from uptune_tpu_torch import convert, rng
from uptune_tpu_torch.exec.space_io import space_from_params
from uptune_tpu_torch.ops import acquire as tacq
from uptune_tpu_torch.surrogate import pallas_score as tps
from uptune_tpu_torch.workloads import gcc_like_records

from test_torch_acquire import TOL, assert_topk, kw
from test_torch_gp import MEAN_TOL, SD_TOL
from test_torch_ops import N, T

CPU = torch.device("cpu")
N_TRAIN, B = 48, 96


def _gcc_features(n, seed):
    space = space_from_params(gcc_like_records())
    cands = space.random(rng.generator(seed, CPU), n)
    x = N(space.surrogate_transform(space.features(cands)))
    return np.ascontiguousarray(x, np.float32), space


@pytest.fixture(scope="module")
def wide():
    x, space = _gcc_features(N_TRAIN, 1)
    nc, ncat = space.n_cont_features, space.n_cat
    assert x.shape[1] == 96 + 233 * 4 == 1028
    y = (4.0 * x[:, :nc].mean(1) + x[:, nc::4].mean(1)).astype(np.float32)
    sj = jgp.precompute_kinv(jgp.fit(jnp.asarray(x), jnp.asarray(y), 3.0,
                                     1e-2, n_cont=nc, n_cat=ncat,
                                     ls_cat=2.0))
    st = convert.from_jax_gp(jax.tree_util.tree_map(np.asarray, sj),
                             device="cpu")
    xq, _ = _gcc_features(B, 2)
    return sj, st, xq, float(y.min()), nc, ncat


@pytest.mark.parametrize("score", ["mean", "ei", "lcb"])
def test_scores_at_f1028_match_jax_xla_route(wide, score):
    sj, st, xq, best, nc, ncat = wide
    ref = jacq.acquire_scores(sj, jnp.asarray(xq), route=routing.XLA,
                              **kw(score, best, nc, ncat))
    got = tacq.acquire_scores(st, T(xq), **kw(score, best, nc, ncat))
    np.testing.assert_allclose(N(got), np.asarray(ref), **TOL[score])


@pytest.mark.parametrize("score,k", [("ei", 16), ("lcb", 5), ("mean", 32)])
def test_topk_at_f1028_matches_jax_xla_route(wide, score, k):
    sj, st, xq, best, nc, ncat = wide
    vj, ij = jacq.acquire_topk(sj, jnp.asarray(xq), k, route=routing.XLA,
                               **kw(score, best, nc, ncat))
    vt, it = tacq.acquire_topk(st, T(xq), k, **kw(score, best, nc, ncat))
    assert_topk(vj, ij, vt, it, TOL[score], f"{score} k={k}")


def test_moments_at_f1028_match_jax(wide):
    """A's and B's plain versions against the JAX GP's posterior."""
    sj, st, xq, _, nc, ncat = wide
    mj, sdj = jgp.predict(sj, jnp.asarray(xq), nc, ncat)
    np.testing.assert_allclose(N(tps.gp_mean_scores(st, T(xq), nc, ncat)),
                               np.asarray(mj), **MEAN_TOL)
    mt, sdt = tps.gp_mean_var_scores(st, T(xq), nc, ncat)
    np.testing.assert_allclose(N(mt), np.asarray(mj), **MEAN_TOL)
    np.testing.assert_allclose(N(sdt), np.asarray(sdj), **SD_TOL)


def test_scores_at_f1028_match_jax_interpret_kernel(wide):
    """`_scores_kernel` itself, in interpret mode, at F = 1028."""
    sj, st, xq, best, nc, ncat = wide
    ref = jacq.acquire_scores(sj, jnp.asarray(xq), route=routing.INTERPRET,
                              **kw("ei", best, nc, ncat))
    got = tacq.acquire_scores(st, T(xq), **kw("ei", best, nc, ncat))
    np.testing.assert_allclose(N(got), np.asarray(ref), **SD_TOL)


def test_wide_launches_are_not_refused_before_the_device(wide,
                                                         monkeypatch):
    """The wrappers' guard reads the library's limits, which now take any
    width: at F = 1028 a launch gets past `check_train_rows` (on the CPU
    it then stops at the device check, as every launch does here)."""
    from uptune_tpu_torch.surrogate import pallas_score as ps
    _, st, xq, best, nc, ncat = wide
    seen = []

    def query(name, f, var, restype=None):
        seen.append((name, f, var))
        return 2 ** 31 - 1
    monkeypatch.setattr(ps.MEAN_VAR_KERNEL, "query", query)
    ps.check_train_rows(ps.MEAN_VAR_KERNEL, N_TRAIN, 1028, True)
    assert seen == [("ut_acquire_max_train_rows", 1028, 1)]
    blocks = tps.prep_blocks(st, T(xq), nc, ncat)
    with pytest.raises(ValueError, match="needs CUDA tensors"):
        tps.mean_tile_cuda(*blocks)
