"""The port's mesh plane (`uptune_tpu_torch/parallel/`, the mesh route of
`engine/batched.py`) on the CPU, one process over local meshes (a mesh
lists the CPU device once a shard, as it lists ``cuda:0`` on one card):

* TestShardMap — tests/test_batched.py's TestShardMap and its
  `jit_global_topk` case on the port: a `BatchedEngine` over an
  instance mesh equals the unsharded run bitwise (with and without the
  exchange), `global_topk` under the mesh equals the unsharded one
  bitwise, the indivisible case raises, and `tune_batch(mesh=)` runs;
* TestShardedEngine / TestShardedSemanticEquivalence — the bodies of
  tests/test_engine.py's classes on the port, the equivalences bitwise
  (the reference holds them to rtol 1e-5);
* the exchange against the JAX package's `ShardedEngine._exchange` under
  `shard_map` over the 8 virtual CPU devices, fed the same per-replica
  bests: the same broadcast best, bitwise;
* `sharded_gp_score` against the JAX package's for every kind but
  Thompson, within the reference's own tolerances
  (tests/test_surrogate_shard.py: rtol 1e-5, 5e-5 for the mixed
  kernel), and Thompson shards drawing independently.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from uptune_tpu.engine import FusedEngine as JEngine
from uptune_tpu.parallel import make_mesh as j_make_mesh
from uptune_tpu.parallel import sharded_gp_score as j_sharded_gp_score
from uptune_tpu.parallel.sharded import ShardedEngine as JSharded
from uptune_tpu.parallel.sharded import shard_map
from uptune_tpu.space.params import EnumParam as JEnum
from uptune_tpu.space.params import FloatParam as JFloat
from uptune_tpu.space.spec import Space as JSpace
from uptune_tpu.surrogate import gp as jgp
from uptune_tpu.techniques.base import Best as JBest
from uptune_tpu.workloads import rosenbrock_space as j_rosenbrock_space

import uptune_tpu_torch as ut
from uptune_tpu_torch import convert, rng
from uptune_tpu_torch.engine import (BatchedEngine, FusedEngine,
                                     default_arms, make_instance_mesh,
                                     surrogate_eval_fn)
from uptune_tpu_torch.parallel import (ShardedEngine, make_mesh,
                                       sharded_gp_score)
from uptune_tpu_torch.surrogate import gp as tgp
from uptune_tpu_torch.techniques.base import Best
from uptune_tpu_torch.techniques.purerandom import PureRandom
from uptune_tpu_torch.workloads import (random_tsp_distances,
                                        rosenbrock_device, rosenbrock_space,
                                        tsp_device, tsp_space)

from test_torch_ops import N, T, assert_bitwise

CPU = torch.device("cpu")
SEED = 7
STEPS = 8


def _rb(v, p):
    return rosenbrock_device(v)


def _bitwise_states(a, b, what=""):
    for name in ("qor", "u"):
        assert_bitwise(N(getattr(a.best, name)), N(getattr(b.best, name)),
                       f"{what} best.{name}")
    for pa, pb in zip(a.best.perms, b.best.perms):
        assert torch.equal(pa, pb), what
    assert torch.equal(a.evals, b.evals), what
    assert torch.equal(a.hist.h0, b.hist.h0), what
    assert torch.equal(a.key, b.key), what


def _cpu_mesh(n):
    return make_instance_mesh(n, device="cpu")


# -- TestShardMap --------------------------------------------------------------
@pytest.fixture(scope="module")
def rb_eng():
    return FusedEngine(rosenbrock_space(2, -3.0, 3.0), _rb,
                       history_capacity=1 << 9, device="cpu")


class TestShardMap:
    def test_sharded_equals_vmap(self, rb_eng):
        """The instance mesh is semantically invisible: the same
        per-instance results as the unsharded run, bitwise."""
        sv = BatchedEngine(rb_eng, 4).run(BatchedEngine(rb_eng, 4).init(SEED),
                                          STEPS)
        bs = BatchedEngine(rb_eng, 4, mesh=_cpu_mesh(2))
        ss = bs.run(bs.init(SEED), STEPS)
        _bitwise_states(sv, ss, "mesh 2")

    def test_sharded_exchange_equals_vmap_exchange(self, rb_eng):
        """The exchange spans every shard's instances: cooperative
        results match the unsharded portfolio bitwise."""
        be = BatchedEngine(rb_eng, 4, exchange_every=3)
        sv = be.run(be.init(SEED), STEPS)
        bs = BatchedEngine(rb_eng, 4, exchange_every=3, mesh=_cpu_mesh(2))
        ss = bs.run(bs.init(SEED), STEPS)
        _bitwise_states(sv, ss, "mesh 2 exchanging")
        q = N(ss.best.qor)
        np.testing.assert_allclose(q, q.min(), atol=0)

    def test_indivisible_instances_raise(self, rb_eng):
        with pytest.raises(ValueError, match="divisible"):
            BatchedEngine(rb_eng, 3, mesh=_cpu_mesh(2))

    def test_slot_primitives_and_run_traced_are_unsharded_only(self,
                                                               rb_eng):
        bs = BatchedEngine(rb_eng, 4, mesh=_cpu_mesh(2))
        st = bs.init(SEED)
        with pytest.raises(ValueError, match="unsharded"):
            bs.propose_all(st)
        with pytest.raises(ValueError, match="unsharded"):
            bs.init_slot(st, 0, 3)
        with pytest.raises(ValueError, match="unsharded"):
            bs.run_traced(st, 2)

    def test_global_topk_replicated_and_sharded(self):
        """`global_topk` returns every instance the same winners, and
        the mesh route (each shard ranks its instances, the shards'
        lists gathered before the exchange) selects the same candidates
        as the unsharded one, bitwise."""
        space = rosenbrock_space(3, -2.0, 2.0)
        g = np.random.RandomState(0)
        x = T(g.rand(32, space.n_surrogate_features).astype(np.float32))
        y = T(g.randn(32).astype(np.float32))
        st = tgp.fit(x, y, 0.8, 1e-2)
        acq = surrogate_eval_fn(space, st, kind="lcb")
        eng = FusedEngine(space, lambda v, p: torch.zeros(v.shape[0]),
                          history_capacity=1 << 10, device="cpu")
        be = BatchedEngine(eng, 4)
        gv, gown, gidx = be.global_topk(be.init(4), 6, acq)
        assert gv.shape == (4, 6)
        for i in range(1, 4):
            assert torch.equal(gv[0], gv[i]) and torch.equal(gown[0], gown[i])
            assert torch.equal(gidx[0], gidx[i])
        bs = BatchedEngine(eng, 4, mesh=_cpu_mesh(2))
        sv, sown, sidx = bs.global_topk(bs.init(4), 6, acq)
        for a, b, what in ((gv, sv, "vals"), (gown, sown, "owner"),
                           (gidx, sidx, "idx")):
            assert_bitwise(N(a), N(b), what)
        # propose_topk under the mesh stacks the shards' outputs
        _, cands, _, vals, idx = bs.propose_topk(bs.init(4), 6, acq)
        _, cands1, _, vals1, idx1 = be.propose_topk(be.init(4), 6, acq)
        assert torch.equal(cands.u, cands1.u) and torch.equal(idx, idx1)
        assert_bitwise(N(vals), N(vals1), "propose_topk vals")

    def test_tune_batch_takes_a_mesh(self):
        space = rosenbrock_space(2, -3.0, 3.0)
        res = ut.tune_batch(space, _rb, n_instances=4, steps=4, seed=0,
                            history_capacity=1 << 10, device="cpu",
                            mesh=_cpu_mesh(2))
        ref = ut.tune_batch(space, _rb, n_instances=4, steps=4, seed=0,
                            history_capacity=1 << 10, device="cpu")
        assert res.engine.mesh is not None
        np.testing.assert_array_equal(res.best_qors, ref.best_qors)
        assert res.best_configs == ref.best_configs


# -- TestShardedEngine (tests/test_engine.py) ------------------------------------
class TestShardedEngine:
    def test_sharded_run_matches_convergence(self, rb_eng):
        eng = FusedEngine(rosenbrock_space(2, -3.0, 3.0), _rb, device="cpu")
        sh = ShardedEngine(eng, make_mesh(4, 2, device="cpu"))
        state = sh.run(sh.init(0), 60)
        cfg, qor = sh.best(state)
        assert qor < 0.5, qor
        # best exchange: every replica's best equals the global best
        qors = N(state.best.qor)
        assert np.allclose(qors, qors.min(), atol=1e-6)
        assert set(cfg) == {"x0", "x1"}

    def test_search_only_mesh(self):
        eng = FusedEngine(rosenbrock_space(2, -3.0, 3.0), _rb, device="cpu")
        sh = ShardedEngine(eng, make_mesh(8, 1, device="cpu"))
        state = sh.run(sh.init(1), 40)
        _, qor = sh.best(state)
        assert qor < 1.0

    def test_eval_sharding_equivalence(self):
        """Eval-sharded equals unsharded, bitwise (dedup off)."""
        eng = FusedEngine(rosenbrock_space(2, -3.0, 3.0), _rb, dedup=False,
                          device="cpu")
        sh1 = ShardedEngine(eng, make_mesh(1, 1, device="cpu"))
        sh4 = ShardedEngine(eng, make_mesh(1, 4, device="cpu"))
        s1 = sh1.run(sh1.init(7), 25)
        s4 = sh4.run(sh4.init(7), 25)
        assert_bitwise(N(s1.best.qor), N(s4.best.qor), "qor")
        assert_bitwise(N(s1.best.u), N(s4.best.u), "u")

    def test_perm_space_sharded(self):
        n = 8
        dist = T(random_tsp_distances(n, seed=1))
        eng = FusedEngine(tsp_space(n), lambda v, p: tsp_device(p[0], dist),
                          device="cpu")
        sh = ShardedEngine(eng, make_mesh(4, 2, device="cpu"))
        state = sh.run(sh.init(2), 40)
        cfg, qor = sh.best(state)
        assert sorted(cfg["tour"]) == list(range(n))

    def test_engine_and_mesh_must_share_the_device(self, rb_eng):
        mesh = make_mesh(2, 1, devices=[CPU, torch.device("meta")])
        with pytest.raises(ValueError, match="engine's device"):
            ShardedEngine(rb_eng, mesh)
        with pytest.raises(ValueError, match="divisible"):
            ShardedEngine(rb_eng, make_mesh(1, 7, device="cpu"))


def _padded_engine(space, obj, div=8):
    """default arms padded so any eval-axis split divides the batch."""
    arms = default_arms(1)
    pad = (-sum(t.natural_batch(space) for t in arms)) % div
    if pad:
        arms.append(PureRandom(batch=pad))
    return FusedEngine(space, obj, arms=arms, device="cpu")


class TestShardedSemanticEquivalence:
    """With one search replica, eval sharding is invisible: the best
    trajectory of the sharded engine over 60 steps (dedup on) equals the
    single engine's from the replica's key, bitwise."""

    @staticmethod
    def _trajectory(runner, state, chunks=10, chunk=6):
        traj = []
        for _ in range(chunks):
            state = runner(state, chunk)
            traj.append(float(N(state.best.qor).min()))
        return state, traj

    def test_trajectory_equivalence_60_steps(self):
        eng = _padded_engine(rosenbrock_space(3, -3.0, 3.0), _rb)
        sh = ShardedEngine(eng, make_mesh(1, 4, device="cpu"))
        s1, t1 = self._trajectory(eng.run,
                                  eng.init(sh.replica_seeds(11)[0]))
        s4, t4 = self._trajectory(sh.run, sh.init(11))
        assert len(t1) == len(t4) == 10
        assert t1 == t4
        assert_bitwise(N(s1.best.u), N(s4.best.u[0]), "incumbent")
        assert torch.equal(s1.hist.h0, s4.hist.h0[0])

    def test_perm_space_trajectory_equivalence(self):
        n = 8
        dist = T(random_tsp_distances(n, seed=3))
        eng = FusedEngine(tsp_space(n), lambda v, p: tsp_device(p[0], dist),
                          device="cpu")
        sh = ShardedEngine(eng, make_mesh(1, 2, device="cpu"))
        _, t1 = self._trajectory(eng.run, eng.init(sh.replica_seeds(13)[0]),
                                 chunks=8, chunk=8)
        _, t2 = self._trajectory(sh.run, sh.init(13), chunks=8, chunk=8)
        assert t1 == t2

    def test_surrogate_refit_under_mesh_equivalence(self):
        """A GP EI-scored over the whole mesh equals the single-device
        score, and the engine state it ran beside is healthy."""
        space = rosenbrock_space(3, -3.0, 3.0)
        eng = _padded_engine(space, _rb)
        sh = ShardedEngine(eng, make_mesh(1, 4, device="cpu"))
        state = sh.run(sh.init(17), 50)
        g = np.random.RandomState(17)
        feats = T(g.rand(96, space.n_features).astype(np.float32))
        ys = T(g.randn(96).astype(np.float32))
        st = tgp.fit_auto(feats, ys)
        pool = T(g.rand(64, space.n_features).astype(np.float32))
        best_y = float(ys.min())
        got = sharded_gp_score(make_mesh(1, 8, device="cpu"), "eval", st,
                               pool, kind="ei", best_y=best_y)
        want = tgp.expected_improvement(st, pool, best_y)
        np.testing.assert_allclose(N(got), N(want), rtol=1e-4, atol=1e-6)
        assert np.isfinite(N(state.best.qor)).all()


# -- the exchange against the JAX package's ------------------------------------
def _bests(case, d=3, s=5, n=8):
    g = np.random.RandomState(case)
    u = g.rand(n, d).astype(np.float32)
    perms = np.stack([g.permutation(s) for _ in range(n)]).astype(np.int32)
    qor = g.rand(n).astype(np.float32)
    if case == 1:                       # a tie at the minimum
        qor[[2, 5]] = -1.0
    if case == 2:                       # nothing finite yet
        qor[:] = np.inf
    return u, perms, qor


@pytest.mark.parametrize("case", [0, 1, 2])
def test_exchange_equals_shard_map_exchange(case):
    """`ShardedEngine._exchange` fed the same per-replica bests as the
    JAX package's `_exchange` under `shard_map` over 8 CPU devices: the
    same broadcast best (or, with nothing finite, every replica's own),
    bitwise."""
    from jax.sharding import PartitionSpec as P
    u, perms, qor = _bests(case)
    jspace = j_rosenbrock_space(3, -1.0, 1.0)
    jse = JSharded(JEngine(jspace, lambda v, p: jnp.zeros(v.shape[0])),
                   j_make_mesh(n_search=8, n_eval=1))

    def local(b):
        one = jax.tree.map(lambda x: x[0], b)
        return jax.tree.map(lambda x: x[None], jse._exchange(one))

    fn = shard_map(local, mesh=jse.mesh, in_specs=(P("search"),),
                   out_specs=P("search"), check_rep=False)
    want = fn(JBest(jnp.asarray(u), (jnp.asarray(perms),), jnp.asarray(qor)))
    eng = FusedEngine(rosenbrock_space(3, -1.0, 1.0), _rb, device="cpu")
    se = ShardedEngine(eng, make_mesh(8, 1, device="cpu"))
    got = se._exchange(Best(T(u), (torch.from_numpy(perms).long(),), T(qor)))
    assert_bitwise(np.asarray(want.u), N(got.u), "u")
    assert_bitwise(np.asarray(want.qor), N(got.qor), "qor")
    np.testing.assert_array_equal(np.asarray(want.perms[0]),
                                  N(got.perms[0]))


# -- sharded GP scoring against the JAX package's ------------------------------
@pytest.fixture(scope="module")
def gp_env():
    """A dense and a mixed-kernel JAX fit (the reference's fixtures), each
    with the port's copy of the same state."""
    k = jax.random.PRNGKey(0)
    x = jax.random.uniform(k, (96, 6))
    y = ((x - 0.4) ** 2).sum(-1) + 0.1 * jnp.sin(8 * x[:, 0])
    dense = jgp.fit_auto(x, y)
    feats = np.asarray(jax.random.uniform(jax.random.PRNGKey(9), (256, 6)))
    sp = JSpace([JFloat("a", 0, 1), JFloat("b", 0, 1)]
                + [JEnum(f"f{i}", ("x", "y", "z")) for i in range(4)])
    cands = sp.random(jax.random.PRNGKey(3), 96)
    mf = sp.surrogate_transform(sp.features(cands))
    my = mf[:, 0] * 2 + mf[:, 2] - mf[:, 5]
    nc, ncat = sp.n_cont_features, sp.n_cat
    mixed = jgp.fit_auto(mf, my, n_cont=nc, n_cat=ncat)
    q = np.asarray(sp.surrogate_transform(sp.features(
        sp.random(jax.random.PRNGKey(4), 64))))
    conv = lambda s: convert.from_jax_gp(  # noqa: E731
        jax.tree_util.tree_map(np.asarray, s), "cpu")
    return {"dense": (dense, conv(dense), feats, None, 0, float(y.min()),
                      dict(rtol=1e-5, atol=1e-5)),
            "mixed": (mixed, conv(mixed), q, nc, ncat, float(my.min()),
                      dict(rtol=5e-5, atol=1e-6))}


@pytest.mark.parametrize("kind", ["mean", "ei", "lcb"])
@pytest.mark.parametrize("fit", ["dense", "mixed"])
def test_sharded_gp_score_matches_jax(gp_env, fit, kind):
    js, ts, q, nc, ncat, best, tol = gp_env[fit]
    kw = dict(kind=kind, best_y=best if kind == "ei" else None, beta=1.5,
              n_cont=nc, n_cat=ncat)
    want = j_sharded_gp_score(j_make_mesh(n_search=1, n_eval=8), "eval",
                              js, jnp.asarray(q), **kw)
    got = sharded_gp_score(make_mesh(1, 8, device="cpu"), "eval", ts,
                           T(q), **kw)
    np.testing.assert_allclose(N(got), np.asarray(want), **tol)


def test_sharded_gp_score_fused_shards(gp_env, monkeypatch):
    """Shards of PALLAS_MIN_POOL rows or more take the fused mean +
    variance path (`gp_mean_var_scores`, its plain version on the CPU),
    once a shard, and equal the unsharded fused score (`score_flat`
    over all the rows) within the sd's tolerance, the GP tolerance EI
    is held to (tests/test_torch_gp.py SD_TOL)."""
    from uptune_tpu_torch.surrogate import pallas_score as tps
    _, ts, _, nc, ncat, best, _ = gp_env["mixed"]
    q = T(np.random.RandomState(5).rand(2 * 4096, ts.x.shape[1]).astype(
        np.float32))
    calls = []
    fused = tps.gp_mean_var_scores
    monkeypatch.setattr(tps, "gp_mean_var_scores",
                        lambda *a: calls.append(a[1].shape[0]) or fused(*a))
    got = sharded_gp_score(make_mesh(1, 2, device="cpu"), "eval", ts, q,
                           kind="ei", best_y=best, n_cont=nc, n_cat=ncat)
    assert calls == [4096, 4096]
    monkeypatch.setattr(tps, "gp_mean_var_scores", fused)
    want = tgp.score_flat(ts, q, "ei", best, n_cont=nc, n_cat=ncat)
    np.testing.assert_allclose(N(got), N(want), rtol=1e-3, atol=1e-5)
    small = sharded_gp_score(make_mesh(1, 4, device="cpu"), "eval", ts,
                             q[:4096], kind="ei", best_y=best, n_cont=nc,
                             n_cat=ncat)
    assert calls == [4096, 4096]          # 1024-row shards: gp.predict
    np.testing.assert_allclose(N(small), N(want[:4096]), rtol=1e-3,
                               atol=1e-5)


def test_thompson_shards_draw_independently(gp_env):
    _, ts, q, *_ = gp_env["dense"]
    got = N(sharded_gp_score(make_mesh(1, 8, device="cpu"), "eval", ts,
                             T(q), kind="thompson", key=rng.key(3, CPU)))
    assert np.isfinite(got).all()
    s = got.reshape(8, -1)
    for i in range(1, 8):
        assert not np.allclose(s[0], s[i])
    # the same key gives the same draws
    again = N(sharded_gp_score(make_mesh(1, 8, device="cpu"), "eval", ts,
                               T(q), kind="thompson", key=rng.key(3, CPU)))
    np.testing.assert_array_equal(got, again)


def test_sharded_gp_score_validation(gp_env):
    _, ts, q, *_ = gp_env["dense"]
    mesh = make_mesh(1, 8, device="cpu")
    with pytest.raises(ValueError, match="divisible"):
        sharded_gp_score(mesh, "eval", ts, T(q[:100]), kind="mean")
    with pytest.raises(ValueError, match="best_y"):
        sharded_gp_score(mesh, "eval", ts, T(q), kind="ei")
    with pytest.raises(ValueError, match="unknown score"):
        sharded_gp_score(mesh, "eval", ts, T(q), kind="ucb")
    with pytest.raises(ValueError, match="PRNG key"):
        sharded_gp_score(mesh, "eval", ts, T(q), kind="thompson")


def test_on_a_search_eval_mesh(gp_env):
    """Scoring over the eval axis of a 2 x 4 mesh (the engine's mesh
    shape) equals the dense score."""
    _, ts, q, _, _, best, tol = gp_env["dense"]
    got = sharded_gp_score(make_mesh(2, 4, device="cpu"), "eval", ts, T(q),
                           kind="ei", best_y=best)
    want = tgp.expected_improvement(ts, T(q), best)
    np.testing.assert_allclose(N(got), N(want), rtol=1e-5, atol=1e-6)
