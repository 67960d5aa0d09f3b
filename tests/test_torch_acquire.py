"""Parity of the port's fused acquisition (`uptune_tpu_torch/ops/acquire.py`)
and fused scoring (`surrogate/pallas_score.py`) with the JAX package, on
the CPU, where the wrappers take the kernels' plain versions.

Both packages score from one fit: the GP is fitted by JAX and carried to
the port with `convert.from_jax_gp`.  The JAX side runs its per-tile XLA
route (`route="xla"`, bitwise equal to its interpret-mode Pallas kernels
per tests/test_acquire.py), and one case per kernel family runs the
Pallas kernel itself in interpret mode.  Every EI case names its JAX
route, since the reference's two EI routes disagree beyond 1e-5.
Tolerances: mean rtol 1e-4 / atol 1e-5, sd / EI / LCB rtol 1e-3 / atol
1e-5 (tests/test_pallas_score.py).  Top-k: values within those, indices
equal at every rank whose value is apart from its neighbours by more
than the tolerance; exact ties (duplicated rows) go to the lowest index.
"""
import contextlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from uptune_tpu.ops import acquire as jacq
from uptune_tpu.ops import routing
from uptune_tpu.surrogate import gp as jgp
from uptune_tpu.surrogate import pallas_score as jps

from uptune_tpu_torch import convert
from uptune_tpu_torch.ops import acquire as tacq
from uptune_tpu_torch.surrogate import pallas_score as tps

from test_torch_gp import HYPER, MEAN_TOL, SD_TOL, data
from test_torch_ops import N, T

TOL = {"mean": MEAN_TOL, "ei": SD_TOL, "lcb": SD_TOL}


def fitted(kind, n=None):
    x, y, nc, ncat = data(kind, n)
    ls, nz, lc = HYPER[kind]
    sj = jgp.precompute_kinv(jgp.fit(jnp.asarray(x), jnp.asarray(y), ls, nz,
                                     n_cont=nc, n_cat=ncat, ls_cat=lc))
    st = convert.from_jax_gp(jax.tree_util.tree_map(np.asarray, sj),
                             device="cpu")
    xq = np.random.RandomState(2).rand(200, x.shape[1]).astype(np.float32)
    return sj, st, xq, float(y.min()), nc, ncat


@pytest.fixture(scope="module", params=["dense", "mixed", "allcat"])
def state(request):
    return fitted(request.param)


@pytest.fixture(scope="module")
def mixed():
    return fitted("mixed")


def kw(score, best, nc, ncat):
    return dict(kind=score, best_y=best if score == "ei" else None,
                n_cont=nc, n_cat=ncat)


def assert_topk(vj, ij, vt, it, tol, what=""):
    vj, ij = np.asarray(vj, np.float64), np.asarray(ij)
    vt, it = N(vt).astype(np.float64), N(it)
    assert it.dtype == np.int32 and it.shape == ij.shape, what
    np.testing.assert_allclose(vt, vj, err_msg=what, **tol)
    assert (np.diff(vt) <= 0).all(), what
    band = tol["atol"] + tol["rtol"] * np.abs(vj)
    gap = np.full(len(vj), np.inf)
    gap[1:] = np.minimum(gap[1:], vj[:-1] - vj[1:])
    gap[:-1] = np.minimum(gap[:-1], vj[:-1] - vj[1:])
    apart = gap > 2 * band
    np.testing.assert_array_equal(it[apart], ij[apart], err_msg=what)


# -- launcher C: utilities -------------------------------------------------------
@pytest.mark.parametrize("score", ["mean", "ei", "lcb"])
def test_scores_match_jax_xla_route(state, score):
    sj, st, xq, best, nc, ncat = state
    ref = jacq.acquire_scores(sj, jnp.asarray(xq), route=routing.XLA,
                              **kw(score, best, nc, ncat))
    got = tacq.acquire_scores(st, T(xq), **kw(score, best, nc, ncat))
    assert got.shape == (200,) and got.dtype == torch.float32
    np.testing.assert_allclose(N(got), np.asarray(ref), **TOL[score])


def test_scores_match_jax_interpret_kernel(mixed):
    """`_scores_kernel` itself, in interpret mode."""
    sj, st, xq, best, nc, ncat = mixed
    ref = jacq.acquire_scores(sj, jnp.asarray(xq), route=routing.INTERPRET,
                              **kw("ei", best, nc, ncat))
    got = tacq.acquire_scores(st, T(xq), **kw("ei", best, nc, ncat))
    np.testing.assert_allclose(N(got), np.asarray(ref), **SD_TOL)


@pytest.mark.parametrize("score", ["mean", "ei", "lcb"])
def test_unfused_reference_matches(mixed, score):
    sj, st, xq, best, nc, ncat = mixed
    ref = jacq.acquire_scores_ref(sj, jnp.asarray(xq),
                                  **kw(score, best, nc, ncat))
    got = tacq.acquire_scores_ref(st, T(xq), **kw(score, best, nc, ncat))
    np.testing.assert_allclose(N(got), np.asarray(ref), **TOL[score])
    vt, it = tacq.acquire_topk_ref(st, T(xq), 20, **kw(score, best, nc, ncat))
    vf, i_f = tacq.acquire_topk(st, T(xq), 20, **kw(score, best, nc, ncat))
    assert_topk(N(vf), N(i_f), vt, it, TOL[score], "ref vs fused")


# -- launcher D: top-k ---------------------------------------------------------------
@pytest.mark.parametrize("score,k", [("mean", 17), ("ei", 17), ("lcb", 17),
                                     ("ei", 1), ("lcb", 200)])
def test_topk_matches_jax_xla_route(state, score, k):
    sj, st, xq, best, nc, ncat = state
    vj, ij = jacq.acquire_topk(sj, jnp.asarray(xq), k, route=routing.XLA,
                               **kw(score, best, nc, ncat))
    vt, it = tacq.acquire_topk(st, T(xq), k, **kw(score, best, nc, ncat))
    assert_topk(vj, ij, vt, it, TOL[score], f"{score} k={k}")


def test_topk_matches_jax_interpret_kernel(mixed):
    """`_topk_kernel` itself, in interpret mode."""
    sj, st, xq, best, nc, ncat = mixed
    vj, ij = jacq.acquire_topk(sj, jnp.asarray(xq), 33,
                               route=routing.INTERPRET,
                               **kw("lcb", best, nc, ncat))
    vt, it = tacq.acquire_topk(st, T(xq), 33, **kw("lcb", best, nc, ncat))
    assert_topk(vj, ij, vt, it, SD_TOL, "interpret")


@pytest.mark.parametrize("score", ["mean", "ei"])
def test_topk_exact_ties_go_to_the_lowest_index(mixed, score):
    """Duplicated query rows tie exactly: indices equal to JAX's, and the
    lower copy of each pair ranks first."""
    sj, st, xq, best, nc, ncat = mixed
    xq2 = np.concatenate([xq[:100], xq[:100]])
    vj, ij = jacq.acquire_topk(sj, jnp.asarray(xq2), 40, route=routing.XLA,
                               **kw(score, best, nc, ncat))
    vt, it = tacq.acquire_topk(st, T(xq2), 40, **kw(score, best, nc, ncat))
    np.testing.assert_array_equal(N(it), np.asarray(ij))
    it = N(it)
    assert (it[0::2] < 100).all() and (it[1::2] == it[0::2] + 100).all()
    np.testing.assert_array_equal(N(vt)[0::2], N(vt)[1::2])


def test_topk_rejects_k_out_of_range(mixed):
    _, st, xq, best, nc, ncat = mixed
    for k in (0, 201):
        with pytest.raises(ValueError, match="k must be"):
            tacq.acquire_topk(st, T(xq), k, **kw("mean", best, nc, ncat))


# -- launchers A and B: fused scoring ------------------------------------------------
def test_gp_mean_scores_match(state):
    sj, st, xq, _, nc, ncat = state
    ref, _ = jgp.predict(sj, jnp.asarray(xq), nc, ncat)
    got = tps.gp_mean_scores(st, T(xq), nc, ncat)
    np.testing.assert_allclose(N(got), np.asarray(ref), **MEAN_TOL)


def test_gp_mean_var_scores_match(state):
    sj, st, xq, _, nc, ncat = state
    mj, sdj = jgp.predict(sj, jnp.asarray(xq), nc, ncat)
    mt, sdt = tps.gp_mean_var_scores(st, T(xq), nc, ncat)
    np.testing.assert_allclose(N(mt), np.asarray(mj), **MEAN_TOL)
    np.testing.assert_allclose(N(sdt), np.asarray(sdj), **SD_TOL)


def test_pallas_score_kernels_in_interpret_mode(mixed):
    """`_score_kernel_mixed` and `_var_kernel_mixed` themselves."""
    sj, st, xq, _, nc, ncat = mixed
    mj = jps.gp_mean_scores(sj, jnp.asarray(xq), True, nc, ncat)
    np.testing.assert_allclose(N(tps.gp_mean_scores(st, T(xq), nc, ncat)),
                               np.asarray(mj), **MEAN_TOL)
    mj, sdj = jps.gp_mean_var_scores(sj, jnp.asarray(xq), True, nc, ncat)
    mt, sdt = tps.gp_mean_var_scores(st, T(xq), nc, ncat)
    np.testing.assert_allclose(N(mt), np.asarray(mj), **MEAN_TOL)
    np.testing.assert_allclose(N(sdt), np.asarray(sdj), **SD_TOL)


# -- launcher A: where the identity form cancels most, and its sources of error ----
NEAR = 0.01


def near_training(x, nc, seed=5):
    """The training rows, each continuous lane moved by +-NEAR (seeded):
    there |q|^2 + |x|^2 - 2 q.x cancels the most."""
    x = np.asarray(x, np.float32)
    sign = np.random.RandomState(seed).randint(0, 2, (x.shape[0], nc)) * 2 - 1
    near = x.copy()
    near[:, :nc] += (NEAR * sign).astype(np.float32)
    return near


def test_gp_mean_near_training_matches_the_interpret_kernel(mixed):
    """`_score_kernel_mixed` in interpret mode against A's plain version
    on queries a hundredth of a lengthscale from the training rows."""
    sj, st, _, _, nc, ncat = mixed
    near = near_training(sj.x, nc)
    mj = jps.gp_mean_scores(sj, jnp.asarray(near), True, nc, ncat)
    got = tps.gp_mean_scores(st, T(near), nc, ncat)
    np.testing.assert_allclose(N(got), np.asarray(mj), **MEAN_TOL)


@pytest.mark.parametrize("kind", ["dense", "mixed", "allcat"])
def test_gp_mean_ragged_n_matches_the_interpret_kernel(kind):
    """N = 75 training rows (a multiple of neither 8 nor 128) through the
    JAX kernel in interpret mode and A's plain version."""
    sj, st, xq, _, nc, ncat = fitted(kind, 75)
    assert st.x.shape[0] == 75
    mj = jps.gp_mean_scores(sj, jnp.asarray(xq), True, nc, ncat)
    got = tps.gp_mean_scores(st, T(xq), nc, ncat)
    np.testing.assert_allclose(N(got), np.asarray(mj), **MEAN_TOL)


def flagship_state(n, near):
    """A GP over n evaluated flagship configurations (F = 31: 23
    continuous lanes and 8 one-hot, the main path's widths) at the card's
    main hyperparameters, and 200 queries (or the training rows moved by
    +-NEAR)."""
    from uptune_tpu_torch.flagship import flagship_surrogate
    from uptune_tpu_torch.surrogate import gp
    x, y, (nc, ncat) = flagship_surrogate(n, 1, "cpu")
    st = gp.fit(x, y, 0.8, 1e-3, n_cont=nc, n_cat=ncat, ls_cat=2.0)
    xq = (torch.from_numpy(near_training(x, nc)) if near
          else flagship_surrogate(200, 2, "cpu")[0])
    return st, xq, nc, ncat


@pytest.mark.parametrize("case", ["dense", "mixed", "allcat", "mixed_near",
                                  "flagship", "flagship_near"])
def test_kernel_arithmetic_model_meets_the_mean_tolerance(case):
    """chip_smoke's attribution of A's error: the cross term's 3xTF32
    split with centring (all else in float64) stays within the mean
    tolerance of the float64 mean, also where the identity form cancels
    most, at the flagship's 23 + 8 features (packed 24 + 8) as at the
    small fixtures' 6, 3 + 12 and 18; k in f32 summed in float64 does too,
    and every share is finite."""
    import chip_smoke
    if case.startswith("flagship"):
        st, xq, nc, ncat = flagship_state(256, case.endswith("near"))
    else:
        _, st, xq, _, nc, ncat = fitted(case.split("_")[0])
        xq = T(near_training(st.x, nc) if case.endswith("near") else xq)
    blocks = tps.prep_blocks(st, xq, nc, ncat)
    b64 = [None if t is None else t.double() for t in blocks]
    k64 = tps.kernel_tile(*b64[:4])
    mu64 = k64 @ b64[4]
    lim = MEAN_TOL["atol"] + MEAN_TOL["rtol"] * mu64.abs()
    shares = chip_smoke.mean_attribution(blocks, k64, mu64, lim)
    assert all(np.isfinite(v) for v in shares.values()), shares
    assert shares["split_f64_err_over_tol"] <= 1.0, shares
    assert shares["k32_err_over_tol"] <= 1.0, shares


def test_kinv_is_computed_when_not_attached(mixed):
    sj, st, xq, _, nc, ncat = mixed
    bare = st._replace(kinv=None)
    a = tps.gp_mean_var_scores(bare, T(xq), nc, ncat)
    b = tps.gp_mean_var_scores(st, T(xq), nc, ncat)
    np.testing.assert_allclose(N(a[1]), N(b[1]), **SD_TOL)


# -- the wrappers on the CPU -----------------------------------------------------------
def test_cpu_tensors_take_the_plain_version_and_launch_nothing(mixed):
    from uptune_tpu_torch import native
    _, st, xq, best, nc, ncat = mixed
    native.reset_launches()
    tacq.acquire_topk(st, T(xq), 5, **kw("ei", best, nc, ncat))
    tacq.acquire_scores(st, T(xq), **kw("lcb", best, nc, ncat))
    tps.gp_mean_var_scores(st, T(xq), nc, ncat)
    tps.gp_mean_scores(st, T(xq), nc, ncat)
    assert all(k.launches == 0 for k in native.KERNELS)


def test_cuda_wrappers_refuse_cpu_tensors(mixed):
    _, st, xq, best, nc, ncat = mixed
    blocks, kinv, params = tacq.prep(st, T(xq), "ei", best, 2.0, nc, ncat)
    with pytest.raises(ValueError, match="needs CUDA tensors"):
        tacq.scores_cuda(*blocks, kinv, params, "ei")
    with pytest.raises(ValueError, match="needs CUDA tensors"):
        tacq.topk_cuda(*blocks, kinv, params, "ei", 3)
    with pytest.raises(ValueError, match="needs CUDA tensors"):
        tps.mean_tile_cuda(*blocks)
    with pytest.raises(ValueError, match="needs CUDA tensors"):
        tps.mean_var_tile_cuda(*blocks, kinv)


def test_wrappers_refuse_training_rows_over_the_librarys_limit(monkeypatch):
    """The largest N is asked of the library (each launcher's `limit`
    query, by features and kind), and N above it is refused before a
    launch.  The library reports no limit for any launcher now, so the
    mechanism is shown on a stand-in answer; chip_smoke.py checks on the
    card that the real answer at the flagship's 31 features covers the
    manager's 1024-row bucket."""
    from uptune_tpu_torch import native
    asked = []

    def query(symbol, *args):
        asked.append((symbol, args))
        return 1024
    for kern in (native.GP_MEAN, native.GP_MEAN_VAR):
        monkeypatch.setattr(kern, "query", query)
    tps.check_train_rows(native.GP_MEAN_VAR, 1024, 31, True)
    with pytest.raises(ValueError, match=r"N=1025 .*\(at most 1024\)"):
        tps.check_train_rows(native.GP_MEAN_VAR, 1025, 31, True)
    tps.check_train_rows(native.GP_MEAN, 7, 8, False)
    with pytest.raises(ValueError, match=r"gp_mean: N=2000 .*\(at most 1024\)"):
        tps.check_train_rows(native.GP_MEAN, 2000, 8, False)
    assert asked == [("ut_acquire_max_train_rows", (31, 1))] * 2 + [
        ("ut_gp_max_train_rows", (8, 0))] * 2


# -- launcher D's two-level selection, in plain torch ---------------------------------
def sort_pairs(v, i):
    """(value desc, index asc), the order of D's bitonic networks."""
    o = torch.sort(i, stable=True).indices
    v, i = v[o], i[o]
    o = torch.sort(v, descending=True, stable=True).indices
    return v[o], i[o]


def chunked_topk(u, k, chunk, group):
    """What D does on the card, step by step: each `chunk` rows (rows past
    B enter as (-inf, index)) keep their min(k, chunk) best; each `group`
    such lists (slots past their entries filled with (-inf, INT_MAX))
    keep min(k, group k1); the wrapper's stable sort over the lists
    unless there is one list of k, then the clamp of unfilled lanes to
    B - 1.  On the card chunk is 256 and group 8192 // min(k, 256)."""
    b = u.shape[0]
    n1, k1 = -(-b // chunk), min(k, chunk)
    v = torch.full((n1 * chunk,), float("-inf"))
    v[:b] = u
    i = torch.arange(n1 * chunk, dtype=torch.int32)
    lists = [sort_pairs(v[c * chunk:(c + 1) * chunk],
                     i[c * chunk:(c + 1) * chunk]) for c in range(n1)]
    lists = [(lv[:k1], li[:k1]) for lv, li in lists]
    k2 = min(k, group * k1)
    vals, idx = [], []
    for g in range(0, n1, group):
        gv = torch.cat([lv for lv, _ in lists[g:g + group]])
        gi = torch.cat([li for _, li in lists[g:g + group]])
        pad = group * k1 - gv.numel()
        gv = torch.cat([gv, torch.full((pad,), float("-inf"))])
        gi = torch.cat([gi, torch.full((pad,), 2**31 - 1, dtype=torch.int32)])
        gv, gi = sort_pairs(gv, gi)
        vals.append(gv[:k2])
        idx.append(gi[:k2])
    vals, idx = torch.cat(vals), torch.cat(idx)
    if vals.numel() != k:
        vals, pos = tacq.select_topk(vals, k)
        idx = idx[pos.long()]
    return vals, torch.clamp_max(idx, b - 1)


@pytest.mark.parametrize("b,k,chunk,group", [
    (1, 1, 256, 8192), (7, 7, 4, 2), (300, 5, 16, 2), (1000, 128, 256, 8),
    (6040, 128, 256, 64), (6040, 300, 256, 32), (2049, 2049, 256, 32),
    (517, 40, 16, 4), (20000, 1, 256, 8192)])
def test_chunked_selection_matches_select_topk(b, k, chunk, group):
    """D's selection, whatever its chunk and group sizes, gives the
    order of one stable sort: values descending, exact ties to the lowest
    index, with -inf utilities in the tail."""
    rng = np.random.RandomState(b + k + chunk)
    u = np.round(rng.randn(b), 2).astype(np.float32)    # many exact ties
    u[rng.randint(0, b, b // 3)] = u.max()              # ties at the top
    u[rng.rand(b) < 0.1] = -np.inf
    vt, it = chunked_topk(torch.from_numpy(u), k, chunk, group)
    vw, iw = tacq.select_topk(torch.from_numpy(u), k)
    torch.testing.assert_close(vt, vw, rtol=0, atol=0)
    assert torch.equal(it, iw)


# -- the C and D wrappers' checks, on any device ---------------------------------------
def geometry(monkeypatch, words=1000, limit=2**31 - 1):
    """Stand in for the library's queries; returns the list of asks."""
    from uptune_tpu_torch import native
    asked = []
    answers = {"ut_acquire_scratch_words": words,
               "ut_acquire_max_train_rows": limit}

    def query(symbol, *args, **kw):
        asked.append((symbol, args))
        return answers[symbol]
    for kern in (native.ACQ_SCORES, native.ACQ_TOPK, native.GP_MEAN_VAR):
        monkeypatch.setattr(kern, "query", query)
    return asked


def test_acquire_wrappers_refuse_wrong_operand_shapes(mixed):
    """Shapes, dtypes and the scalar pack are checked before the device,
    so a wrong operand is named on the CPU too."""
    _, st, xq, best, nc, ncat = mixed
    blocks, kinv, params = tacq.prep(st, T(xq), "ei", best, 2.0, nc, ncat)
    qc, qk, xc, xk, alpha = blocks
    with pytest.raises(ValueError, match="kinv has shape"):
        tacq.scores_cuda(*blocks, kinv[:-1], params, "ei")
    with pytest.raises(ValueError, match="xk has shape"):
        tacq.topk_cuda(qc, qk, xc, xk[:-1], alpha, kinv, params, "ei", 3)
    with pytest.raises(ValueError, match="qk has shape"):
        tacq.scores_cuda(qc, qk[:-1], xc, xk, alpha, kinv, params, "lcb")
    with pytest.raises(TypeError, match="xc is torch.float64"):
        tacq.topk_cuda(qc, qk, xc.double(), xk, alpha, kinv, params, "ei", 3)
    with pytest.raises(ValueError, match="params must be"):
        tacq.topk_cuda(*blocks, kinv, params[:4], "ei", 3)
    with pytest.raises(ValueError, match="takes kinv None"):
        tacq.scores_cuda(*blocks, kinv, params, "mean")
    with pytest.raises(ValueError, match="k must be"):
        tacq.topk_cuda(*blocks, kinv, params, "ei", 0)


def test_acquire_wrappers_refuse_a_wrong_scratch(mixed, monkeypatch):
    """A given scratch is held to the library's size, dtype, layout and
    device before the launch; a right one passes to the device check."""
    _, st, xq, best, nc, ncat = mixed
    blocks, kinv, params = tacq.prep(st, T(xq), "ei", best, 2.0, nc, ncat)
    asked = geometry(monkeypatch, words=1000)
    bad = [torch.empty(999), torch.empty(1000, dtype=torch.float64),
           torch.empty(10, 100), torch.empty(2000)[::2]]
    for scratch in bad:
        with pytest.raises(ValueError, match="scratch must be"):
            tacq.scores_cuda(*blocks, kinv, params, "ei", scratch=scratch)
        with pytest.raises(ValueError, match="scratch must be"):
            tacq.topk_cuda(*blocks, kinv, params, "ei", 9, scratch=scratch)
    for run in (lambda s: tacq.scores_cuda(*blocks, None, params, "mean",
                                           scratch=s),
                lambda s: tacq.topk_cuda(*blocks, kinv, params, "lcb", 9,
                                         scratch=s)):
        with pytest.raises(ValueError, match="needs CUDA tensors"):
            run(torch.empty(1000))
    b, n = xq.shape[0], kinv.shape[0]
    assert ("ut_acquire_scratch_words", (b, n, 1, 0)) in asked
    assert ("ut_acquire_scratch_words", (b, n, 1, 9)) in asked
    assert ("ut_acquire_scratch_words", (b, n, 0, 0)) in asked


def test_acquire_launchers_take_n_above_the_tile_limit(monkeypatch):
    """B, C and D keep nothing of size N in shared memory: where the
    library reports no limit they take an N that B's former tile (3584 at
    F = 31) did not, and the scratch is sized by the library."""
    from uptune_tpu_torch import native
    asked = geometry(monkeypatch, words=77)
    monkeypatch.setattr(tps, "require_cuda", lambda kernel, dev: None)
    n, b, fc, fk = 3600, 8, 23, 8
    g = np.random.RandomState(0)
    ops = [torch.from_numpy(g.rand(*s).astype(np.float32))
           for s in ((b, fc), (b, fk), (n, fc), (n, fk), (n,))]
    kinv = torch.zeros(n, n)
    params = torch.zeros(5)
    for kern, k in ((native.ACQ_SCORES, None), (native.ACQ_TOPK, 5)):
        dims = tacq._check_launch(kern, "ei", *ops, kinv, params, None, k)
        assert dims[:4] == (b, n, fc, fk) and dims[4].shape == (77,)
    assert ("ut_acquire_max_train_rows", (31, 1)) in asked
    del asked[:]
    scratch = tps.launch_scratch(native.GP_MEAN_VAR, b, n, fc + fk, True, 0,
                                 None, torch.device("cpu"))
    assert scratch.shape == (77,) and scratch.dtype == torch.float32
    assert asked == [("ut_acquire_max_train_rows", (31, 1)),
                     ("ut_acquire_scratch_words", (b, n, 1, 0))]


# -- launcher B's wrapper, on any device -----------------------------------------------
def test_mean_var_wrapper_sizes_and_checks_its_scratch(mixed, monkeypatch):
    """B runs C's passes: its wrapper asks the library for the scratch of
    (B, N, variance, no top-k), refuses a wrong scratch with C's message
    before the device is looked at, and passes a right one on to the
    device check."""
    from uptune_tpu_torch import native
    _, st, xq, best, nc, ncat = mixed
    blocks, kinv, _ = tacq.prep(st, T(xq), "ei", best, 2.0, nc, ncat)
    asked = geometry(monkeypatch, words=1000)
    launches = native.GP_MEAN_VAR.launches
    bad = {"size": torch.empty(999),
           "dtype": torch.empty(1000, dtype=torch.float64),
           "layout": torch.empty(10, 100), "stride": torch.empty(2000)[::2],
           "device": torch.empty(1000, device="meta")}
    for what, scratch in bad.items():
        with pytest.raises(ValueError, match="gp_mean_var: scratch must be a "
                           "contiguous 1-D float32 tensor of at least 1000"):
            tps.mean_var_tile_cuda(*blocks, kinv, scratch=scratch)
    b, n = xq.shape[0], kinv.shape[0]
    assert asked == [("ut_acquire_scratch_words", (b, n, 1, 0))] * len(bad)
    with pytest.raises(ValueError, match="gp_mean_var needs CUDA tensors"):
        tps.mean_var_tile_cuda(*blocks, kinv, scratch=torch.empty(1000))
    with pytest.raises(ValueError, match="kinv has shape"):
        tps.mean_var_tile_cuda(*blocks, kinv[:-1])
    assert native.GP_MEAN_VAR.launches == launches


@pytest.mark.parametrize("n", [3600, 3585])
def test_mean_var_wrapper_takes_n_above_its_former_limit(n, monkeypatch):
    """N = 3600 at F = 31 passes every check of B's wrapper up to the
    launch itself when the library reports no limit (the former tile
    stopped at 3584); a library that reports a limit still refuses."""
    from uptune_tpu_torch import native
    asked = geometry(monkeypatch, words=55)
    monkeypatch.setattr(tps, "require_cuda", lambda kernel, dev: None)
    launched = []

    def function():
        def fn(*args):
            launched.append(args)
            return 0
        return fn
    monkeypatch.setattr(native.GP_MEAN_VAR, "function", function)
    monkeypatch.setattr(tps, "stream_of", lambda dev: 0)
    monkeypatch.setattr(torch.cuda, "device",
                        lambda dev: contextlib.nullcontext())
    b, fc, fk = 8, 23, 8
    g = np.random.RandomState(1)
    ops = [torch.from_numpy(g.rand(*s).astype(np.float32))
           for s in ((b, fc), (b, fk), (n, fc), (n, fk), (n,))]
    before = native.GP_MEAN_VAR.launches
    mu, q = tps.mean_var_tile_cuda(*ops, torch.zeros(n, n))
    assert mu.shape == q.shape == (b,) and mu.dtype == torch.float32
    assert native.GP_MEAN_VAR.launches == before + 1
    native.GP_MEAN_VAR.launches = before
    (args,) = launched
    assert args[-5:-1] == (b, n, fc, fk) and len(args) == 14
    assert ("ut_acquire_scratch_words", (b, n, 1, 0)) in asked
    assert ("ut_acquire_max_train_rows", (31, 1)) in asked
    geometry(monkeypatch, words=55, limit=3584)
    with pytest.raises(ValueError, match=rf"N={n} .*\(at most 3584\)"):
        tps.mean_var_tile_cuda(*ops, torch.zeros(n, n))
