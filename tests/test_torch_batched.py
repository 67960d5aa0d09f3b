"""The port's batched multi-instance engine (`BatchedEngine`,
`exchange_best`, `tune_batch`), its counter-based keys and the GP's
pinned precision, against the port's own sequential runs and against the
JAX package.

Mirrors `tests/test_batched.py` at its sizes: rosenbrock-2d, N <= 4, a
2^9-row history, so that eviction runs within 8 steps.  Every comparison
is bitwise unless a test says otherwise.  The JAX side of the commit
comparison runs under `jax.vmap(..., axis_name=...)`, as
`BatchedEngine._step` vmaps it, fed the same converted state; the port
gets JAX's proposal, raw QoR and NelderMead's restart draws replayed from
the JAX restart keys (the PRNG keys themselves are not compared).
"""
import collections

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from uptune_tpu.engine import BatchedEngine as JBatched
from uptune_tpu.engine import FusedEngine as JEngine
from uptune_tpu.engine.batched import VMAP_AXIS
from uptune_tpu.engine.batched import exchange_best as j_exchange_best
from uptune_tpu.ops import dedup as jdedup
from uptune_tpu.surrogate import gp as jgp
from uptune_tpu.techniques.base import Best as JBest
from uptune_tpu.workloads import rosenbrock_device as j_rosenbrock
from uptune_tpu.workloads import rosenbrock_space as j_rosenbrock_space

import uptune_tpu_torch as ut
from uptune_tpu_torch import convert, rng
from uptune_tpu_torch.engine import BatchedEngine, FusedEngine, exchange_best
from uptune_tpu_torch.ops import dedup
from uptune_tpu_torch.surrogate import gp as tgp
from uptune_tpu_torch.techniques.base import Best
from uptune_tpu_torch.workloads import (random_tsp_distances,
                                        rosenbrock_device, rosenbrock_space,
                                        tsp_device, tsp_space)

from test_torch_engine import assert_states_equal, flat, replay_observe
from test_torch_ops import N, T, assert_bitwise, jcands_to_t

SEED = 7
STEPS = 8
CAP = 1 << 9


def _rb(v, p):
    return rosenbrock_device(v)


def _states_equal(a, b, what=""):
    """Two port states (or trees) equal leaf by leaf, bitwise, keys
    included."""
    fa, fb = flat(a), flat(b)
    assert sorted(fa) == sorted(fb)
    for k in fa:
        assert_bitwise(fa[k], fb[k], f"{what} {k}")
    for ka, kb in zip(_keys(a), _keys(b)):
        assert torch.equal(ka, kb), what


def _keys(st):
    return [st.key] if hasattr(st, "key") else []


def _row(tree, i):
    if isinstance(tree, torch.Tensor):
        return tree[i]
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(_row(x, i) for x in tree))
    if isinstance(tree, tuple):
        return tuple(_row(x, i) for x in tree)
    return tree


def _stack(trees):
    first = trees[0]
    if isinstance(first, torch.Tensor):
        return torch.stack(trees)
    if first is None:
        return None
    if isinstance(first, tuple) and hasattr(first, "_fields"):
        return type(first)(*(_stack(list(x)) for x in zip(*trees)))
    return tuple(_stack(list(x)) for x in zip(*trees))


@pytest.fixture(scope="module")
def rb_eng():
    """One shared 2-d engine: 8 steps x 114 rows overflow the 2^9-row
    history, so the runs evict."""
    return FusedEngine(rosenbrock_space(2, -3.0, 3.0), _rb,
                       history_capacity=CAP, device="cpu")


@pytest.fixture(scope="module")
def batched4(rb_eng):
    be = BatchedEngine(rb_eng, 4)
    return be, be.run(be.init(SEED), STEPS)


# -- matched seeds -------------------------------------------------------------
def test_n1_exact_parity(rb_eng):
    """A 1-instance batched run is the single engine: the whole state,
    history, counters and key included, through the eviction steps."""
    be = BatchedEngine(rb_eng, 1)
    sb = be.run(be.init(SEED), STEPS)
    ss = rb_eng.run(rb_eng.init(be.instance_seeds(SEED)[0]), STEPS)
    assert int(ss.hist.dropped) > 0
    _states_equal(_row(sb, 0), ss, "N=1")


def test_matched_seed_equivalence_n4(batched4, rb_eng):
    """Without exchange, instance i equals the sequential run from
    `instance_seeds(SEED)[i]`: best, history, evals, dropped (the whole
    state)."""
    be, s4 = batched4
    for i, k in enumerate(be.instance_seeds(SEED)):
        si = rb_eng.run(rb_eng.init(k), STEPS)
        assert int(si.hist.dropped) > 0
        _states_equal(_row(s4, i), si, f"instance {i}")


def test_perm_space_batched():
    n = 8
    dist = torch.as_tensor(random_tsp_distances(n, seed=5),
                           dtype=torch.float32)
    eng = FusedEngine(tsp_space(n), lambda v, perms: tsp_device(perms[0],
                                                                dist),
                      history_capacity=1 << 10, device="cpu")
    be = BatchedEngine(eng, 2)
    st = be.run(be.init(0), 6)
    for cfg in be.best_configs(st):
        assert sorted(cfg["tour"]) == list(range(n))
    assert np.isfinite(be.best_qors(st)).all()


def test_run_traced_per_instance_monotone(rb_eng):
    be = BatchedEngine(rb_eng, 2)
    _, traces = be.run_traced(be.init(1), 4)
    tr = N(traces)
    assert tr.shape == (4, 2)
    assert (np.diff(tr, axis=0) <= 0).all()
    _, single = rb_eng.run_traced(rb_eng.init(1), 4)
    assert single.shape == (4,) and (np.diff(N(single)) <= 0).all()


def test_best_reporting(batched4):
    be, st = batched4
    qors = be.best_qors(st)
    cfg, q = be.best(st)
    i = int(np.argmin(qors))
    assert q == qors[i]
    assert cfg == be.best_config(st, i)
    assert len(be.best_configs(st)) == 4


def test_exchange_propagates_best(rb_eng):
    """exchange_every=4: the first three steps are the independent
    instances' own; the fourth commits each instance's batch, then every
    instance's best is the lexicographic (qor, index) minimum of the
    independent instances' bests after that step, bitwise, before the
    arms observe it."""
    ind, ex = BatchedEngine(rb_eng, 4), BatchedEngine(rb_eng, 4,
                                                      exchange_every=4)
    s_ind = ind.run(ind.init(SEED), 3)
    _states_equal(s_ind, ex.run(ex.init(SEED), 3), "before the exchange")
    # a run counts its steps from 0: the exchange is its fourth step's
    s_ind, s_ex = ind.run(s_ind, 1), ex.run(ex.init(SEED), 4)
    q = N(s_ind.best.qor)
    i = int(np.argmin(q))
    assert np.isfinite(q).all()
    assert (N(s_ex.best.qor) == q[i]).all()
    assert (N(s_ex.best.u) == N(s_ind.best.u)[i]).all()
    assert not (N(s_ind.best.qor) == q[i]).all()


# -- tune_batch -----------------------------------------------------------------
def test_tune_batch_and_continue():
    space = rosenbrock_space(2, -3.0, 3.0)
    res = ut.tune_batch(space, _rb, n_instances=2, steps=4, seed=0,
                        history_capacity=1 << 10, device="cpu")
    assert len(res.best_configs) == 2
    assert res.best_qors.shape == (2,)
    assert res.best_qor == res.best_qors.min()
    assert set(res.best_config) == {"x0", "x1"}
    assert (res.acqs > 0).all() and (res.evals > 0).all()
    before = float(res.best_qors.min())
    kept = N(res.state.hist.h0).copy()
    res2 = ut.tune_batch(space, _rb, n_instances=2, steps=4, seed=0,
                         history_capacity=1 << 10, state=res.state,
                         engine=res.engine, device="cpu")
    # the caller's state stays readable and unchanged
    assert float(N(res.state.best.qor).min()) == before
    assert np.array_equal(N(res.state.hist.h0), kept)
    assert float(res2.best_qors.min()) <= before + 1e-6
    assert (res2.acqs == 2 * res.acqs).all()
    with pytest.raises(ValueError):
        ut.tune_batch(space, _rb, n_instances=3, steps=4,
                      engine=res.engine, device="cpu")


def test_tune_batch_max_sense():
    space = rosenbrock_space(2, -3.0, 3.0)
    res = ut.tune_batch(space, lambda v, p: -rosenbrock_device(v),
                        n_instances=2, steps=5, sense="max",
                        history_capacity=1 << 10, device="cpu")
    assert res.best_qor > -0.5


# -- a state is a value; draws do not depend on N --------------------------------
def test_propose_twice_is_bitwise(rb_eng, batched4):
    st = rb_eng.run(rb_eng.init(3), 2)
    a, b = rb_eng.propose(st), rb_eng.propose(st)
    _states_equal(a, b, "single propose")
    be, s4 = batched4
    va = torch.func.vmap(rb_eng.propose)(s4)
    vb = torch.func.vmap(rb_eng.propose)(s4)
    _states_equal(va, vb, "vmapped propose")


def test_draws_do_not_depend_on_n(rb_eng):
    """Instance i's keys and first proposal are the same at N = 1 and
    N = 4, and the same as a single engine's from that key."""
    k1 = BatchedEngine(rb_eng, 1).instance_seeds(SEED)
    k4 = BatchedEngine(rb_eng, 4).instance_seeds(SEED)
    assert torch.equal(k1[0], k4[0])
    assert len({tuple(N(k)) for k in k4}) == 4
    s4 = BatchedEngine(rb_eng, 4).init(SEED)
    _, c4, n4 = torch.func.vmap(rb_eng.propose)(s4)
    for i in range(4):
        _, ci, ni = rb_eng.propose(rb_eng.init(k4[i]))
        assert torch.equal(c4.u[i], ci.u) and torch.equal(n4[i], ni)
    # the draw helpers under vmap over keys equal the helpers per key
    keys = rng.split(rng.key(5, "cpu"), 4)

    def draws(k):
        g = rng.Stream(k, hint=3)
        return (rng.uniform(g, (3, 5)), rng.randint(g, (7,), 2, 9),
                rng.normal(g, (4,)), rng.permutations(g, 2, 6),
                rng.choice_without_replacement(g, 5, 10, 3))
    batched = torch.func.vmap(draws)(keys)
    for i in range(4):
        for got, want in zip(batched, draws(keys[i])):
            assert torch.equal(got[i], want)


def test_counter_draws_are_distributed_as_stated():
    """Uniforms in [0, 1) on multiples of 2^-24, integers in range,
    normals with unit moments, distinct picks; a block size does not
    change what a stream draws."""
    g = rng.generator(11, "cpu")
    u = rng.uniform(g, (200_000,))
    assert float(u.min()) >= 0 and float(u.max()) < 1
    assert torch.equal(u * 2 ** 24, torch.floor(u * 2 ** 24))
    assert abs(float(u.mean()) - 0.5) < 5e-3
    r = rng.randint(g, (100_000,), -3, 4)
    assert int(r.min()) == -3 and int(r.max()) == 3
    assert (torch.bincount(r + 3).double() / 1e5 - 1 / 7).abs().max() < 6e-3
    z = rng.normal(g, (200_000,))
    assert abs(float(z.mean())) < 1e-2 and abs(float(z.std()) - 1) < 1e-2
    c = rng.choice_without_replacement(g, 4000, 12, 3)
    assert int(c.min()) >= 0 and int(c.max()) < 12
    assert bool((c[:, 0] != c[:, 1]).all() & (c[:, 0] != c[:, 2]).all()
                & (c[:, 1] != c[:, 2]).all())
    assert (torch.bincount(c[:, 2], minlength=12).double() / 4000
            - 1 / 12).abs().max() < 0.02
    key = rng.key(12, "cpu")
    one, blocks = rng.Stream(key), rng.Stream(key, hint=1000)
    for shape in ((3,), (40, 2), (1,), (500,)):
        assert torch.equal(rng.uniform(one, shape), rng.uniform(blocks,
                                                                shape))


def test_batched_step_ops_do_not_depend_on_n(rb_eng):
    """The ops a batched step dispatches (vmap's batched kernels, one
    merge op call for all instances) are the same at N = 1 and N = 4:
    no op loops over the instances."""
    class Count(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.ops = collections.Counter()

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            self.ops[str(func)] += 1
            return func(*args, **(kwargs or {}))

    counts = []
    for n in (1, 4):
        be = BatchedEngine(rb_eng, n, exchange_every=1)
        st = be.run(be.init(SEED), 1)
        with Count() as c:
            be.run(st, 1)
        counts.append(c.ops)
    assert counts[0] == counts[1]
    assert counts[0]["uptune_tpu_torch.merge_rows.default"] == 1


# -- against JAX --------------------------------------------------------------------
@pytest.fixture(scope="module")
def jax_batched():
    """A JAX BatchedEngine (rosenbrock-2d, N = 4, the XLA merge) six
    steps in, and its next proposal: the next commit overflows."""
    eng = JEngine(j_rosenbrock_space(2, -3.0, 3.0),
                  lambda v, p: j_rosenbrock(v), history_capacity=CAP,
                  merge_impl="xla")
    be = JBatched(eng, 4)
    st = be.run(be.init(jax.random.PRNGKey(3)), 6)
    tst, cands, keys = jax.vmap(eng.propose)(st)
    raw = jax.vmap(lambda c: eng.objective(
        eng.space.decode_scalars(c.u), c.perms))(cands)
    return eng, st, tst, cands, keys, raw


def _np(x):
    return jax.tree_util.tree_map(np.asarray, x)


@pytest.mark.parametrize("exchange", [False, True])
def test_batched_commit_matches_jax(jax_batched, rb_eng, exchange):
    """One batched commit from a converted stacked JAX state, with JAX's
    proposal and raw QoR, against JAX's `jax.vmap(commit, axis_name=...)`
    (with `exchange_best` over that axis when exchanging), bitwise in
    every leaf; the history overflows and evicts in this commit."""
    eng_j, st_j, tst_j, cands_j, keys_j, raw_j = jax_batched
    assert [t.name for t in eng_j.arms] == [t.name for t in rb_eng.arms]
    ex = ((lambda b: j_exchange_best(b, (VMAP_AXIS,))) if exchange
          else None)
    evict = jnp.any(st_j.hist.n + cands_j.u.shape[1] > CAP)
    # jitted: the commit has no multiply-add that XLA could fuse
    out_j = jax.jit(jax.vmap(lambda s, ts, c, q, k: eng_j.commit(
        s, ts, c, q, k, exchange=ex, evict_pred=evict),
        axis_name=VMAP_AXIS))(st_j, tst_j, cands_j, raw_j, keys_j)

    be = BatchedEngine(rb_eng, 4)
    st_t = convert.from_jax_state(rb_eng.space, _np(st_j), device="cpu")
    tst_t = tuple(convert.from_jax_tstate(_np(ts), torch.device("cpu"))
                  for ts in tst_j)
    draws = _stack([
        tuple(replay_observe(t, eng_j.space,
                             jax.tree_util.tree_map(lambda x: x[i], ts))
              for t, ts in zip(eng_j.arms, tst_j))
        for i in range(4)])
    out_t = be.commit(st_t, tst_t, jcands_to_t(cands_j), T(raw_j),
                      st_t.key, exchange=exchange, draws=draws)
    assert int(out_t.hist.dropped.sum()) > int(st_t.hist.dropped.sum())
    assert_states_equal(out_j, out_t, f"exchange={exchange}")
    if exchange:
        q = N(out_t.best.qor)
        assert (q == q.min()).all()


@pytest.mark.parametrize("case", ["distinct", "ties", "all_inf", "one_inf"])
def test_exchange_best_matches_jax(case):
    """exchange_best on a stacked Best against the JAX function under
    vmap: the lowest instance index wins a tie, and every instance keeps
    its own best while no QoR is finite."""
    r = np.random.RandomState(3)
    n, d, s = 5, 4, 6
    u = r.rand(n, d).astype(np.float32)
    perm = np.stack([r.permutation(s) for _ in range(n)]).astype(np.int32)
    q = {"distinct": [3.0, 1.5, 2.0, 0.5, 4.0],
         "ties": [2.0, 0.25, 3.0, 0.25, 0.25],
         "all_inf": [np.inf] * n,
         "one_inf": [np.inf, np.inf, 7.0, np.inf, np.inf]}[case]
    q = np.asarray(q, np.float32)
    got = exchange_best(Best(T(u), (T(perm, torch.int64),), T(q)))
    want = jax.vmap(lambda b: j_exchange_best(b, (VMAP_AXIS,)),
                    axis_name=VMAP_AXIS)(
        JBest(jnp.asarray(u), (jnp.asarray(perm),), jnp.asarray(q)))
    assert_bitwise(want.u, N(got.u), "u")
    assert_bitwise(want.perms[0], N(got.perms[0]), "perm")
    assert_bitwise(want.qor, N(got.qor), "qor")
    if case == "ties":
        assert (N(got.u) == u[1]).all()
    if case == "all_inf":
        assert (N(got.u) == u).all()


def _merge_case(r, cap, b, n_live):
    h0 = np.sort(r.randint(0, 2 ** 31, n_live).astype(np.uint32))
    h0 = np.concatenate([h0, np.full(cap - n_live, 0xFFFFFFFF, np.uint32)])
    h1 = r.randint(0, 2 ** 32, cap).astype(np.uint32)
    q = r.randn(cap).astype(np.float32)
    q[n_live:] = np.inf
    age = np.concatenate([r.randint(0, 50, n_live),
                          np.full(cap - n_live, -1)]).astype(np.int32)
    nh0 = r.randint(0, 2 ** 31, b).astype(np.uint32)
    nh0[:3] = h0[:3]
    nh0[-4:] = 0xFFFFFFFF
    new = (np.sort(nh0), r.randint(0, 2 ** 32, b).astype(np.uint32),
           r.randn(b).astype(np.float32), np.full(b, 50, np.int32))
    return (h0, h1, q, age), new


def test_merge_instance_axis_matches_jax():
    """The merge's plain version over a leading instance axis, and the
    merge op under `torch.func.vmap` (one call for all instances),
    against JAX's `merge_rows_xla` under `jax.vmap`."""
    r = np.random.RandomState(5)
    cases = [_merge_case(r, 256, 40, n_live) for n_live in (0, 100, 230,
                                                             256)]
    hist = tuple(np.stack([c[0][j] for c in cases]) for j in range(4))
    new = tuple(np.stack([c[1][j] for c in cases]) for j in range(4))
    hj = tuple(jnp.asarray(a) for a in hist)
    nj = tuple(jnp.asarray(a) for a in new)
    pos_j = jax.vmap(lambda h, n: (jnp.arange(n.shape[0], dtype=jnp.int32)
                                   + jnp.searchsorted(h, n, side="right")
                                   .astype(jnp.int32)))(hj[0], nj[0])
    want = jax.vmap(jdedup.merge_rows_xla)(hj, nj, pos_j)
    ht = tuple(T(a) for a in hist)
    nt = tuple(T(a) for a in new)
    pos = T(pos_j)
    for got in (dedup.merge_rows(ht, nt, pos),
                dedup.merge_rows_kernel(ht, nt, pos),
                torch.func.vmap(dedup.merge_history)(ht, nt)):
        for name, w, g in zip(("h0", "h1", "qor", "age"), want, got):
            assert_bitwise(w, N(g), name)
    for i in range(4):     # each instance as a merge of its own
        one = dedup.merge_rows(tuple(c[i] for c in ht),
                               tuple(c[i] for c in nt), pos[i])
        for w, g in zip(want, one):
            assert_bitwise(np.asarray(w)[i], N(g))


# -- the GP pins full float32 ---------------------------------------------------------
def test_gp_ignores_the_callers_tf32_setting(monkeypatch):
    """fit and score_flat with the caller's matmul precision at "high"
    give the same bits as at "highest", run their products at
    "highest", and give the caller's setting back."""
    r = np.random.RandomState(2)
    x = T(r.rand(64, 5).astype(np.float32))
    y = T(r.randn(64).astype(np.float32))
    xq = T(r.rand(40, 5).astype(np.float32))

    def run():
        st = tgp.fit_auto(x, y)
        return st, tgp.score_flat(st, xq, kind="ei", best_y=-1.0)
    st0, s0 = run()
    seen = []
    raw_d2 = tgp._raw_d2

    def spy(a, b):
        seen.append(torch.get_float32_matmul_precision())
        return raw_d2(a, b)
    monkeypatch.setattr(tgp, "_raw_d2", spy)
    prev = torch.get_float32_matmul_precision()
    torch.set_float32_matmul_precision("high")
    try:
        st1, s1 = run()
        assert torch.get_float32_matmul_precision() == "high"
    finally:
        torch.set_float32_matmul_precision(prev)
    assert seen and set(seen) == {"highest"}
    for name in ("alpha", "chol", "lengthscale", "noise"):
        assert_bitwise(N(getattr(st0, name)), N(getattr(st1, name)), name)
    assert_bitwise(N(s0), N(s1), "score_flat")
    # and the reference's fit on the same data, as the GP tests hold it
    want = jgp.fit_auto(jnp.asarray(N(x)), jnp.asarray(N(y)))
    np.testing.assert_allclose(N(st1.lengthscale), np.asarray(
        want.lengthscale), rtol=0)
