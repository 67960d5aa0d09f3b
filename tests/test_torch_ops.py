"""Parity of the port's numeric / permutation / common ops with the JAX
package, bitwise, under replayed draws.

Each port op is a pure function of its draws; the helpers below repeat
the JAX op's own key splits to get the exact numbers `jax.random` drew
and hand them to the port as tensors.  The JAX side runs eagerly (one
XLA program per primitive), so no multiply-add is fused into an FMA and
the float arithmetic is the same on both sides.  The other test_torch_*
files reuse these replay helpers.
"""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from uptune_tpu.ops import numeric as jnum
from uptune_tpu.ops import perm as jperm
from uptune_tpu.space import params as JP
from uptune_tpu.space.spec import CandBatch as JCand
from uptune_tpu.space.spec import Space as JSpace
from uptune_tpu.techniques import common as jcommon

from uptune_tpu_torch.ops import numeric as tnum
from uptune_tpu_torch.ops import perm as tperm
from uptune_tpu_torch.space import params as TP
from uptune_tpu_torch.space.spec import CandBatch as TCand
from uptune_tpu_torch.space.spec import Space as TSpace
from uptune_tpu_torch.techniques import common as tcommon

CPU = torch.device("cpu")


def share_the_cpu():
    """Give each pytest-xdist worker, and the processes it starts, its
    share of the cores.  By default torch's intra-op pool has one OpenMP
    thread a core in every worker: under `-n 6` on eight cores they
    oversubscribe the machine and spin at every small op's barrier while
    the cores run other workers (a 3 s sharded run of
    test_torch_parallel.py took 87 s beside six busy processes, 6 s with
    one thread).  Every worker collects this file, so the setting holds
    for every port test file it runs; a run without xdist keeps torch's
    default."""
    workers = int(os.environ.get("PYTEST_XDIST_WORKER_COUNT", "1"))
    if workers > 1:
        n = max(1, len(os.sched_getaffinity(0)) // workers)
        torch.set_num_threads(n)
        os.environ["OMP_NUM_THREADS"] = str(n)


share_the_cpu()


# -- conversion ----------------------------------------------------------
def T(x, dtype=None):
    """JAX/numpy array -> CPU tensor (u32 held in int64)."""
    a = np.asarray(x)
    if a.dtype == np.uint32:
        a = a.astype(np.int64)
    t = torch.from_numpy(np.array(a))
    return t if dtype is None else t.to(dtype)


def N(t):
    return t.detach().cpu().numpy()


def jcands_to_t(c):
    return TCand(T(c.u, torch.float32),
                 tuple(T(p, torch.int64) for p in c.perms))


def tcands_to_j(c):
    return JCand(jnp.asarray(N(c.u)),
                 tuple(jnp.asarray(N(p).astype(np.int32)) for p in c.perms))


def assert_bitwise(a, b, what=""):
    a, b = np.asarray(a), np.asarray(b)
    if a.dtype == np.uint32:
        a = a.astype(np.int64)
    if b.dtype == np.uint32:
        b = b.astype(np.int64)
    assert a.shape == b.shape, (what, a.shape, b.shape)
    if a.dtype.kind == "f" or b.dtype.kind == "f":
        a32, b32 = a.astype(np.float32), b.astype(np.float32)
        assert np.array_equal(a32.view(np.int32), b32.view(np.int32)), (
            what, np.argwhere(a32.view(np.int32) != b32.view(np.int32))[:5])
    else:
        assert np.array_equal(a.astype(np.int64), b.astype(np.int64)), (
            what, np.argwhere(a.astype(np.int64) != b.astype(np.int64))[:5])


def assert_cands_equal(cj, ct, what=""):
    assert_bitwise(cj.u, N(ct.u), what + ".u")
    for k, (pj, pt) in enumerate(zip(cj.perms, ct.perms)):
        assert_bitwise(pj, N(pt), f"{what}.perms[{k}]")


# -- spaces --------------------------------------------------------------
def _flagship_specs(P):
    return ([P.FloatParam(f"x{i}", -5.0, 5.0) for i in range(8)]
            + [P.IntParam("i0", 0, 64), P.LogIntParam("li0", 1, 4096),
               P.Pow2Param("p0", 1, 256), P.BoolParam("b0"),
               P.EnumParam("e0", ("a", "b", "c", "d")),
               P.PermParam("tour", tuple(range(12)))])


def flagship_spaces():
    """(JAX Space, port Space) of the flagship's mixed space."""
    return JSpace(_flagship_specs(JP)), TSpace(_flagship_specs(TP))


# -- replayed JAX draws --------------------------------------------------
def jax_perm_rows(key, rows, n):
    """The index permutations `_vmap1(shuffle)` applies, row by row."""
    keys = jax.random.split(key, rows)
    return T(jax.vmap(lambda k: jax.random.permutation(k, n))(keys))


def replay_space_random(space_j, key, n):
    """Space.random's draws are its (normalized) output."""
    return jcands_to_t(space_j.random(key, n))


def replay_param_mask(space_j, key, n):
    P = space_j.n_scalar + len(space_j.perm_sizes)
    kf, kc = jax.random.split(key)
    return tcommon.MaskDraws(T(jax.random.uniform(kf, (n, P))),
                             T(jax.random.uniform(kc, (n, P))))


def replay_perm_random_op(key, rows, n):
    ks, kc, kw, ki, kp = jax.random.split(key, 5)

    def swap(k):
        kr, kss = jax.random.split(k)
        return (jax.random.randint(kr, (), 0, n),
                jax.random.randint(kss, (), 0, n))

    r, s = jax.vmap(swap)(jax.random.split(kw, rows))
    d = max(1, min(max(1, n // 4), n))
    inv = jax.vmap(lambda k: jax.random.randint(k, (), 0, n - d + 1))(
        jax.random.split(ki, rows))
    change = jax.vmap(lambda k: jax.random.uniform(k, (n,)))(
        jax.random.split(kc, rows))
    return tcommon.PermOpDraws(
        jax_perm_rows(ks, rows, n), T(change), T(r), T(s), T(inv),
        T(jax.random.randint(kp, (rows,), 0, 4)))


def replay_mutate(space_j, key, n, sigma):
    D = space_j.n_scalar
    kmask, kmut, *kperm = jax.random.split(key, 2 + len(space_j.perm_sizes))
    mask = replay_param_mask(space_j, kmask, n)
    if sigma is None:
        scalar = (T(jax.random.uniform(kmut, (n, D), dtype=jnp.float32)),)
        perms = tuple(jax_perm_rows(kk, n, s)
                      for kk, s in zip(kperm, space_j.perm_sizes))
    else:
        kn, kr = jax.random.split(kmut)
        scalar = (T(jax.random.normal(kn, (n, D), jnp.float32)),
                  T(jax.random.uniform(kr, (n, D), dtype=jnp.float32)))
        perms = tuple(replay_perm_random_op(kk, n, s)
                      for kk, s in zip(kperm, space_j.perm_sizes))
    return tcommon.MutateDraws(mask, scalar, perms)


def replay_linear(space_j, key, n):
    kc, *kperm = jax.random.split(key, 1 + len(space_j.perm_sizes))
    return tcommon.LinearDraws(
        T(jax.random.uniform(kc, (n, space_j.n_scalar), dtype=jnp.float32)),
        tuple(jax_perm_rows(kk, n, s)
              for kk, s in zip(kperm, space_j.perm_sizes)))


# -- fixtures ------------------------------------------------------------
@pytest.fixture(scope="module")
def spaces():
    return flagship_spaces()


def _batch(space_j, seed, n):
    return space_j.random(jax.random.PRNGKey(seed), n)


# -- numeric ---------------------------------------------------------------
class TestNumeric:
    def test_reflect_and_scale(self):
        rng = np.random.RandomState(0)
        v = (rng.randn(512, 9) * 2.0).astype(np.float32)
        assert_bitwise(jnum.reflect_unit(jnp.asarray(v)),
                       N(tnum.reflect_unit(T(v))), "reflect")
        u = rng.rand(64, 9).astype(np.float32)
        assert_bitwise(jnum.scale(jnp.asarray(u), 1.7),
                       N(tnum.scale(T(u), 1.7)), "scale")

    def test_randomize_and_normal_mutation(self, spaces):
        space_j, space_t = spaces
        u = np.asarray(_batch(space_j, 1, 256).u)
        mask = np.random.RandomState(1).rand(*u.shape) < 0.4
        key = jax.random.PRNGKey(11)
        out_j = jnum.randomize(key, jnp.asarray(u), jnp.asarray(mask))
        r = T(jax.random.uniform(key, u.shape, dtype=jnp.float32))
        assert_bitwise(out_j, N(tnum.randomize(T(u), r, T(mask))), "rand")

        cm = np.asarray(space_j.complex_mask)[None, :]
        out_j = jnum.normal_mutation(key, jnp.asarray(u), 0.1,
                                     jnp.asarray(cm), jnp.asarray(mask))
        kn, kr = jax.random.split(key)
        out_t = tnum.normal_mutation(
            T(u), 0.1, T(cm), T(jax.random.normal(kn, u.shape, jnp.float32)),
            T(jax.random.uniform(kr, u.shape, dtype=jnp.float32)), T(mask))
        assert_bitwise(out_j, N(out_t), "normal_mutation")
        assert (N(out_t) >= 0).all() and (N(out_t) <= 1).all()

    def test_set_linear(self, spaces):
        space_j, space_t = spaces
        ua, ub, uc = (np.asarray(_batch(space_j, s, 128).u)
                      for s in (2, 3, 4))
        f = np.random.RandomState(2).rand(128, 1).astype(np.float32)
        cm = np.asarray(space_j.complex_mask)[None, :]
        eq = np.random.RandomState(3).rand(*ua.shape) < 0.5
        mask = np.random.RandomState(4).rand(*ua.shape) < 0.5
        key = jax.random.PRNGKey(5)
        out_j = jnum.set_linear(key, ua, ub, uc, 1.0, f, -f, cm, eq,
                                mask=mask, base=ub)
        red = T(jax.random.uniform(key, ua.shape, dtype=jnp.float32))
        out_t = tnum.set_linear(T(ua), T(ub), T(uc), 1.0, T(f), -T(f),
                                T(cm), T(eq), red, mask=T(mask), base=T(ub))
        assert_bitwise(out_j, N(out_t), "set_linear")

    def test_swarm(self, spaces):
        space_j, _ = spaces
        u, ul, ug = (np.asarray(_batch(space_j, s, 96).u) for s in (6, 7, 8))
        vel = (np.random.RandomState(9).randn(*u.shape) * 0.1).astype(
            np.float32)
        cm = np.asarray(space_j.complex_mask)
        bm = np.asarray(space_j.kind) == JP.BOOL
        key = jax.random.PRNGKey(10)
        nu_j, v_j = jnum.swarm(key, u, ul, ug, vel, cm, bm)
        ks = jax.random.split(key, 4)
        r = [T(jax.random.uniform(k, u.shape, jnp.float32)) for k in ks]
        nu_t, v_t = tnum.swarm(T(u), T(ul), T(ug), T(vel), T(cm), T(bm), *r)
        assert_bitwise(v_j, N(v_t), "velocity")
        assert_bitwise(nu_j, N(nu_t), "position")


# -- permutations --------------------------------------------------------
def _perms(seed, rows, n):
    rng = np.random.RandomState(seed)
    return np.stack([rng.permutation(n) for _ in range(rows)]).astype(
        np.int32)


def _valid(pm, n):
    return all(sorted(row) == list(range(n)) for row in np.asarray(pm))


class TestPerm:
    N = 12

    def test_shuffle(self):
        pm = _perms(0, 200, self.N)
        key = jax.random.PRNGKey(1)
        out_j = jperm.shuffle_batch(key, jnp.asarray(pm))
        out_t = tperm.shuffle_batch(T(pm, torch.int64),
                                    jax_perm_rows(key, 200, self.N))
        assert_bitwise(out_j, N(out_t), "shuffle")
        assert _valid(N(out_t), self.N)

    def test_small_random_change(self):
        pm = _perms(1, 200, self.N)
        key = jax.random.PRNGKey(2)
        out_j = jperm.small_random_change_batch(key, jnp.asarray(pm))
        coins = jax.vmap(lambda k: jax.random.uniform(k, (self.N,)))(
            jax.random.split(key, 200))
        out_t = tperm.small_random_change_batch(T(pm, torch.int64), T(coins))
        assert_bitwise(out_j, N(out_t), "small_random_change")
        assert _valid(N(out_t), self.N)

    def test_random_swap_and_invert(self):
        pm = _perms(2, 200, self.N)
        d = 3
        ops = replay_perm_random_op(jax.random.PRNGKey(3), 200, self.N)
        # the same per-row keys as the JAX ops split off
        key = jax.random.PRNGKey(4)
        out_j = jperm.random_swap_batch(key, jnp.asarray(pm))

        def swap(k):
            kr, ks = jax.random.split(k)
            return (jax.random.randint(kr, (), 0, self.N),
                    jax.random.randint(ks, (), 0, self.N))
        r, s = jax.vmap(swap)(jax.random.split(key, 200))
        out_t = tperm.random_swap_batch(T(pm, torch.int64), T(r), T(s))
        assert_bitwise(out_j, N(out_t), "random_swap")
        assert _valid(N(out_t), self.N)

        out_j = jperm.random_invert_batch(key, jnp.asarray(pm), d)
        rr = jax.vmap(lambda k: jax.random.randint(k, (), 0, self.N - d + 1))(
            jax.random.split(key, 200))
        out_t = tperm.random_invert_batch(T(pm, torch.int64), d, T(rr))
        assert_bitwise(out_j, N(out_t), "random_invert")
        assert _valid(N(out_t), self.N)
        assert ops.pick.min() >= 0 and ops.pick.max() < 4

    def test_toposort(self):
        n = 9
        dep = np.zeros((n, n), bool)
        for i, j in [(1, 0), (3, 1), (4, 2), (8, 7), (5, 3), (6, 5)]:
            dep[i, j] = True   # item i requires item j earlier
        pm = _perms(5, 100, n)
        out_j = jperm.toposort_batch(jnp.asarray(pm), jnp.asarray(dep))
        out_t = tperm.toposort_batch(T(pm, torch.int64), T(dep))
        assert_bitwise(out_j, N(out_t), "toposort")
        assert _valid(N(out_t), n)
        pos = np.argsort(N(out_t), axis=1)
        for i, j in zip(*np.nonzero(dep)):
            assert (pos[:, j] < pos[:, i]).all()


# -- common ----------------------------------------------------------------
class TestCommon:
    def test_param_mutation_mask(self, spaces):
        space_j, space_t = spaces
        key = jax.random.PRNGKey(21)
        for must, rate in ((1, 0.1), (3, 0.3), (0, 0.5)):
            out_j = jcommon.param_mutation_mask(space_j, key, 300, rate, must)
            out_t = tcommon.param_mutation_mask(
                space_t, 300, rate, must, replay_param_mask(space_j, key, 300))
            assert_bitwise(out_j, N(out_t), f"mask must={must}")

    def test_mutate_perm_random_op(self):
        pm = _perms(6, 300, 12)
        mask = np.random.RandomState(6).rand(300) < 0.7
        key = jax.random.PRNGKey(22)
        out_j = jcommon.mutate_perm_random_op(key, jnp.asarray(pm),
                                              jnp.asarray(mask))
        out_t = tcommon.mutate_perm_random_op(
            T(pm, torch.int64), T(mask), replay_perm_random_op(key, 300, 12))
        assert_bitwise(out_j, N(out_t), "perm_random_op")
        assert _valid(N(out_t), 12)

    @pytest.mark.parametrize("sigma,rate", [(None, 0.1), (0.1, 0.3)])
    def test_mutate_batch(self, spaces, sigma, rate):
        space_j, space_t = spaces
        cands_j = _batch(space_j, 23, 256)
        key = jax.random.PRNGKey(24)
        out_j = jcommon.mutate_batch(space_j, key, cands_j, rate, 1, sigma)
        out_t = tcommon.mutate_batch(
            space_t, jcands_to_t(cands_j), rate, 1, sigma,
            replay_mutate(space_j, key, 256, sigma))
        assert_cands_equal(out_j, out_t, "mutate")
        assert _valid(N(out_t.perms[0]), 12)
        assert (N(out_t.u) >= 0).all() and (N(out_t.u) <= 1).all()

    def test_de_linear_batch(self, spaces):
        space_j, space_t = spaces
        base, x1, x2, x3 = (_batch(space_j, s, 160) for s in (30, 31, 32, 33))
        # some parents share their tours, so both permutation branches run
        x3 = JCand(x3.u, (jnp.where(jnp.arange(160)[:, None] % 2 == 0,
                                    x2.perms[0], x3.perms[0]),))
        f = jax.random.uniform(jax.random.PRNGKey(34), (160, 1)) / 2.0 + 0.5
        cross = jcommon.param_mutation_mask(space_j, jax.random.PRNGKey(35),
                                            160, 0.2, 1)
        key = jax.random.PRNGKey(36)
        out_j = jcommon.de_linear_batch(space_j, key, base, x1, x2, x3, f,
                                        cross)
        out_t = tcommon.de_linear_batch(
            space_t, *(jcands_to_t(c) for c in (base, x1, x2, x3)), T(f),
            T(cross), replay_linear(space_j, key, 160))
        assert_cands_equal(out_j, out_t, "de_linear")
        assert _valid(N(out_t.perms[0]), 12)
