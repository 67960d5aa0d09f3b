"""Parity of the port's crossovers and technique arms with the JAX package.

* The five crossovers (PX, PMX, CX, OX1, OX3) on random parent pairs at
  n = 7, 12 and 20, and `crossover_perms` over a space with a block too
  small to cross: bitwise, under the cut points JAX drew, replayed.
* Every arm this slice adds (the GA crossovers, GGA, PSO, pattern search,
  annealing, Torczon, the multi-simplexes, bandit mutation, composable
  DE) on a small mixed space with an 8-city and a 5-item permutation:
  both packages start from one state (`convert.from_jax_tstate`), then
  for a few steps the port's `propose` gets the numbers JAX drew and
  must give JAX's batch and state, and its `observe` gets JAX's batch and
  QoR (some rows failed, +inf) and must give JAX's state.  The PRNG keys
  are left out of the comparison.  The JAX side runs eagerly, so no
  multiply-add is fused into an FMA.
* Annealing's step is exp(-(20 + t/100) / (temp + 1)); XLA's CPU `exp`
  and PyTorch's differ in the last place on some inputs, so the lane
  each row moves is held within 2^-22 (a few ulps of a unit value) and
  everything else bitwise.
* CMA-ES (on a float-only space; it takes no permutations) is held to
  rtol 1e-5 / atol 1e-6: the port sums its products in float64 and its
  eigenvectors may differ from LAPACK's in sign, so the spectrum and
  B diag(lambda) B^T are compared, not B; `propose` given JAX's basis
  holds u within atol 1e-6.
* `BatchedEngine` at N = 2 over every new arm equals two single runs
  from `instance_seeds`, bitwise: every op has a vmap batching rule (the
  engine switches vmap's per-instance fallback off).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from uptune_tpu.ops import perm as jperm
from uptune_tpu.space import params as JP
from uptune_tpu.space.spec import Space as JSpace
from uptune_tpu.techniques import annealing as jann
from uptune_tpu.techniques import banditmutation as jbm
from uptune_tpu.techniques import base as jbase
from uptune_tpu.techniques import cmaes as jcma
from uptune_tpu.techniques import common as jcommon
from uptune_tpu.techniques import evolutionary as jevo
from uptune_tpu.techniques import pattern as jpat
from uptune_tpu.techniques import pso as jpso
from uptune_tpu.techniques import simplex as jsim
from uptune_tpu.techniques.base import Best as JBest

from uptune_tpu_torch import convert
from uptune_tpu_torch.engine import BatchedEngine, FusedEngine
from uptune_tpu_torch.ops import perm as tperm
from uptune_tpu_torch.space import params as TP
from uptune_tpu_torch.space.spec import Space as TSpace
from uptune_tpu_torch.techniques import base as tbase
from uptune_tpu_torch.techniques import common as tcommon
from uptune_tpu_torch.techniques.annealing import SADraws
from uptune_tpu_torch.techniques.banditmutation import (BMDraws,
                                                        ComposableDraws)
from uptune_tpu_torch.techniques.base import Best as TBest
from uptune_tpu_torch.techniques.evolutionary import GreedyDraws
from uptune_tpu_torch.techniques.pattern import MoveDraws
from uptune_tpu_torch.techniques.pso import PSODraws
from uptune_tpu_torch.techniques.simplex import MultiDraws, RestartDraws
from uptune_tpu_torch.workloads import rosenbrock_device, rosenbrock_space

from test_torch_batched import _row, _states_equal
from test_torch_engine import _np_tree, assert_states_equal
from test_torch_engine import replay_propose as replay_propose_slice1
from test_torch_ops import (N, T, _perms, _valid, assert_bitwise,
                            assert_cands_equal, jcands_to_t,
                            replay_mutate, replay_perm_random_op,
                            replay_space_random)

CPU = torch.device("cpu")
CROSS = ("PX", "PMX", "CX", "OX1", "OX3")
# annealing's moved lane: a few ulps of a unit value
EXP_ATOL = 2.0 ** -22
# CMA-ES against JAX
CMA_TOL = {"rtol": 1e-5, "atol": 1e-6}


def _mixed_specs(P, small_block=False):
    """Four floats, an int, a log-int, a bool, an enum and an 8-city
    tour; with `small_block` also a 5-item permutation (below the GA
    crossover's 7)."""
    return ([P.FloatParam(f"x{i}", -5.0, 5.0) for i in range(4)]
            + [P.IntParam("i0", 0, 16), P.LogIntParam("li0", 1, 1024),
               P.BoolParam("b0"), P.EnumParam("e0", ("a", "b", "c")),
               P.PermParam("tour", tuple(range(8)))]
            + ([P.PermParam("order", tuple(range(5)))] if small_block
               else []))


@pytest.fixture(scope="module")
def mixed():
    return JSpace(_mixed_specs(JP)), TSpace(_mixed_specs(TP))


@pytest.fixture(scope="module")
def two_blocks():
    return (JSpace(_mixed_specs(JP, True)),
            TSpace(_mixed_specs(TP, True)))


# -- replayed JAX draws ------------------------------------------------------
def replay_cross_rows(op, keys, n, d):
    """The per-row draws of crossover `op` from JAX's per-row keys."""
    hi = n - max(1, min(int(d), n)) + 1
    if op == "PX":
        def f(k):
            return jax.random.randint(k, (), 2, n + 1)
    elif op == "PMX":
        def f(k):
            return jax.random.randint(k, (), 0, hi)
    elif op == "CX":
        def f(k):
            return jax.random.randint(k, (), 0, n)
    else:
        def f(k):
            k1, k2 = jax.random.split(k)
            r2 = jax.random.randint(k2, (), 0, hi)
            r1 = r2 if op == "OX1" else jax.random.randint(k1, (), 0, hi)
            return jnp.stack([r1, r2])
    return T(jax.vmap(f)(keys), torch.int64)


def replay_crossover_perms(space_j, key, rows, op, strength=1.0 / 3.0,
                           min_size=7):
    keys = jax.random.split(key, len(space_j.perm_sizes))
    out = []
    for kk, size in zip(keys, space_j.perm_sizes):
        if size >= min_size:
            d = max(1, int(round(size * strength)))
            out.append(replay_cross_rows(op, jax.random.split(kk, rows),
                                         size, d))
        else:
            out.append(None)
    return tuple(out)


def replay_moves(space_j, kd, kdir, kperm, n):
    P = space_j.n_scalar + len(space_j.perm_sizes)
    return MoveDraws(
        T(jax.random.randint(kd, (n,), 0, P)),
        T(jax.random.uniform(kdir, (n, 1))),
        tuple(replay_perm_random_op(kk, n, s)
              for kk, s in zip(kperm, space_j.perm_sizes)))


def replay_propose(t, space_j, key):
    """The port's propose draws for JAX arm `t`, from its key."""
    D, nb = space_j.n_scalar, len(space_j.perm_sizes)
    if isinstance(t, jbm.ComposableDE):
        kde, kx = jax.random.split(key)
        return ComposableDraws(
            replay_propose_slice1(t._de, space_j, kde),
            replay_crossover_perms(space_j, kx, t._de.population_size,
                                   t.crossover) if nb else ())
    if isinstance(t, jevo.GreedyMutation):
        krand, kx, kxsel, kmut = jax.random.split(key, 4)
        cross = coin = None
        if t.crossover is not None and nb:
            cross = replay_crossover_perms(space_j, kx, t.batch, t.crossover,
                                           t.crossover_strength)
            coin = T(jax.random.uniform(kxsel, (t.batch, 1)))
        return GreedyDraws(replay_space_random(space_j, krand, t.batch),
                           replay_mutate(space_j, kmut, t.batch, t.sigma),
                           cross, coin)
    if isinstance(t, jpso.PSO):
        ks, _kg, kc1, kc2, *kperm = jax.random.split(key, 4 + nb)
        return PSODraws(
            tuple(T(jax.random.uniform(k, (t.N, D), jnp.float32))
                  for k in jax.random.split(ks, 4)),
            T(jax.random.uniform(kc1, (t.N, 1))),
            T(jax.random.uniform(kc2, (t.N, 1))),
            tuple(replay_cross_rows(t.crossover, jax.random.split(kk, t.N),
                                    size, max(1, int(round(size * 0.3))))
                  for kk, size in zip(kperm, space_j.perm_sizes)))
    if isinstance(t, jpat.PatternSearch):
        kd, kdir, *kperm = jax.random.split(key, 2 + nb)
        return replay_moves(space_j, kd, kdir, kperm, t.batch)
    if isinstance(t, jann.PseudoAnnealingSearch):
        kd, kdir, kstep, *kperm = jax.random.split(key, 3 + nb)
        return SADraws(replay_moves(space_j, kd, kdir, kperm, t.batch),
                       T(jax.random.uniform(kstep, (t.batch, 1))))
    if isinstance(t, jsim.Torczon):
        pad = max(0, t.natural_batch(space_j) - (D + 1))
        return T(jax.random.uniform(key, (pad, D)))
    if isinstance(t, jsim.MultiSimplex):
        nbatch = t.natural_batch(space_j)
        pads = []
        for m in t.members:
            pad = nbatch - m.natural_batch(space_j)
            pads.append(T(jax.random.uniform(jax.random.fold_in(key, 7),
                                             (pad, D))) if pad else None)
        return MultiDraws(tuple(replay_propose(m, space_j, key)
                                for m in t.members), tuple(pads))
    if isinstance(t, jbm.BanditMutation):
        kop, krand, *kmut = jax.random.split(key, 2 + jbm.N_OPS)
        return BMDraws(
            T(jax.random.gumbel(kop, (t.batch, jbm.N_OPS))),
            replay_space_random(space_j, krand, t.batch),
            tuple(replay_mutate(space_j, k, t.batch, sigma)
                  for k, (sigma, _) in zip(kmut, jbm._OPS)))
    if isinstance(t, jcma.CMAES):
        return T(jax.random.normal(key, (t.population_size, D),
                                   jnp.float32))
    return replay_propose_slice1(t, space_j, key)


def replay_observe(t, space_j, tstate_j):
    """The port's observe draws, from the keys JAX's state carries."""
    D = space_j.n_scalar
    if isinstance(t, jsim._SimplexBase):
        k1, k2, _ = jax.random.split(tstate_j.key, 3)
        others = (T(jax.random.uniform(k1, (D, D)))
                  if t.init_style == "random" else None)
        return RestartDraws(T(jax.random.uniform(k2, (D,))), others)
    if isinstance(t, jsim.MultiSimplex):
        return tuple(replay_observe(m, space_j, s)
                     for m, s in zip(t.members, tstate_j[1]))
    if isinstance(t, jann.PseudoAnnealingSearch):
        ukey, _ = jax.random.split(tstate_j.key)
        return T(jax.random.uniform(ukey, ()))
    return None


# -- the crossovers -----------------------------------------------------------
@pytest.mark.parametrize("n", [7, 12, 20])
@pytest.mark.parametrize("op", CROSS)
def test_crossover_bitwise(op, n):
    """Each crossover on 300 random parent pairs (every fifth pair two
    equal parents), per-row cuts replayed from JAX's per-row keys."""
    rows, d = 300, max(1, int(round(n / 3)))
    p1, p2 = _perms(n, rows, n), _perms(n + 100, rows, n)
    p2[::5] = p1[::5]
    key = jax.random.PRNGKey(n)
    batched = getattr(jperm, f"cross_{op.lower()}_batch")
    out_j = batched(key, jnp.asarray(p1), jnp.asarray(p2), d)
    draws = replay_cross_rows(op, jax.random.split(key, rows), n, d)
    out_t = tperm.CROSSOVERS[op].apply(T(p1, torch.int64),
                                       T(p2, torch.int64), d, draws)
    assert_bitwise(out_j, N(out_t), f"{op} n={n}")
    assert _valid(N(out_t), n)
    if op != "OX3":     # OX3's two cuts move a window even between equals
        assert np.array_equal(N(out_t)[::5], p1[::5])


@pytest.mark.parametrize("op", CROSS)
def test_crossover_perms(two_blocks, op):
    """`crossover_perms` crosses the 8-item block and leaves the 5-item
    block (below min_size 7) as parent a's."""
    space_j, space_t = two_blocks
    a, b, child = (space_j.random(jax.random.PRNGKey(s), 64)
                   for s in (1, 2, 3))
    key = jax.random.PRNGKey(4)
    out_j = jcommon.crossover_perms(space_j, key, child, a, b, op)
    draws = replay_crossover_perms(space_j, key, 64, op)
    assert draws[1] is None
    out_t = tcommon.crossover_perms(space_t, jcands_to_t(child),
                                    jcands_to_t(a), jcands_to_t(b), op,
                                    draws)
    assert_cands_equal(out_j, out_t, f"crossover_perms {op}")
    assert_bitwise(a.perms[1], N(out_t.perms[1]), "small block untouched")


# -- every new arm, propose + observe under replayed draws -----------------
ARMS = ([f"ga-{c}" for c in CROSS] + ["GGA"] + [f"pso-{c}" for c in CROSS]
        + ["PatternSearch", "PseudoAnnealingSearch", "RandomTorczon",
           "RightTorczon", "RegularTorczon", "MultiNelderMead",
           "MultiTorczon", "AUCBanditMutationTechnique",
           "ComposableDiffEvolution", "ComposableDiffEvolutionCX"])
# steps run in lockstep (the first member of a multi-simplex reaches its
# LOOP phase in the fourth)
STEPS = {"MultiNelderMead": 4, "MultiTorczon": 4}


def _qor(space_j, cands, step):
    """A deterministic objective of a batch (numpy float32), with every
    seventh row failed (+inf) from the second step on."""
    u = np.asarray(cands.u, np.float64)
    q = ((u - 0.3) ** 2).sum(1)
    for pm in cands.perms:
        pm = np.asarray(pm)
        q = q + 0.05 * np.abs(pm - np.arange(pm.shape[1])).sum(1)
    q = q.astype(np.float32)
    if step:
        q[step % 7::7] = np.inf
    return q


def _assert_propose_equal(name, cj, ct, step):
    what = f"{name} step {step} cands"
    if name != "PseudoAnnealingSearch":
        assert_cands_equal(cj, ct, what)
        return
    for k, (pj, pt) in enumerate(zip(cj.perms, ct.perms)):
        assert_bitwise(pj, N(pt), f"{what}.perms[{k}]")
    np.testing.assert_allclose(N(ct.u), np.asarray(cj.u), rtol=0,
                               atol=EXP_ATOL, err_msg=what)
    # at most the one moved lane of a row may differ
    assert ((N(ct.u) != np.asarray(cj.u)).sum(1) <= 1).all(), what


@pytest.mark.parametrize("name", ARMS)
def test_arm_propose_observe(mixed, name):
    space_j, space_t = mixed
    jt, tt = jbase.get_technique(name), tbase.get_technique(name)
    assert type(jt).__name__ == type(tt).__name__
    assert jt.natural_batch(space_j) == tt.natural_batch(space_t)
    base = jax.random.PRNGKey(17)
    st_j = jt.init_state(space_j, jax.random.fold_in(base, 1000))
    st_t = convert.from_jax_tstate(_np_tree(st_j), CPU)
    assert_states_equal(st_j, st_t, f"{name} init")
    best_j, best_t = JBest.empty(space_j), TBest.empty(space_t, CPU)
    for step in range(STEPS.get(name, 2)):
        key = jax.random.fold_in(base, step)
        st_j, cands_j = jt.propose(space_j, st_j, key, best_j)
        st_t, cands_t = tt.propose(space_t, st_t, best_t,
                                   replay_propose(jt, space_j, key))
        _assert_propose_equal(name, cands_j, cands_t, step)
        assert_states_equal(st_j, st_t, f"{name} step {step} proposed")
        for k, size in enumerate(space_j.perm_sizes):
            assert _valid(N(cands_t.perms[k]), size)

        q = _qor(space_j, cands_j, step)
        best_j = best_j.update(cands_j, jnp.asarray(q))
        best_t = best_t.update(jcands_to_t(cands_j), T(q))
        obs = replay_observe(jt, space_j, st_j)
        st_j = jt.observe(space_j, st_j, cands_j, jnp.asarray(q), best_j)
        st_t = tt.observe(space_t, st_t, jcands_to_t(cands_j), T(q),
                          best_t, obs)
        assert_states_equal(st_j, st_t, f"{name} step {step} observed")


def test_multisimplex_turns(mixed):
    """MultiTorczon advances one member a step, round-robin; the others
    keep their states (the select on `turn`)."""
    from uptune_tpu_torch import rng
    from test_torch_engine import flat
    space_j, space_t = mixed
    t = tbase.get_technique("MultiTorczon")
    gen = rng.generator(3, CPU)
    st = t.init_state(space_t, t.draw_init(space_t, gen))
    best = TBest.empty(space_t, CPU)
    for step in range(4):
        turn = int(st[0])
        assert turn == step % 3
        st2, cands = t.propose(space_t, st, best, t.draw_propose(space_t,
                                                                 gen))
        q = torch.arange(cands.batch, dtype=torch.float32)
        best = best.update(cands, q)
        st = t.observe(space_t, st2, cands, q, best,
                       t.draw_observe(space_t, gen))
        for i in range(3):
            if i == turn:
                assert int(st[1][i].phase) == 1     # LOOP
                continue
            before, after = flat(st2[1][i]), flat(st[1][i])
            for k in before:
                assert_bitwise(before[k], after[k], f"member {i} {k}")


# -- CMA-ES -------------------------------------------------------------------
def _sym(b, sq):
    b, sq = np.asarray(b, np.float64), np.asarray(sq, np.float64)
    return (b * sq ** 2) @ b.T


def test_cmaes_within_tolerance():
    """Four generations on rosenbrock-6d: each step the port starts from
    JAX's state (converted), proposes from JAX's normals and observes
    JAX's batch; mean, paths, covariance, step size, the spectrum and
    B diag(lambda) B^T agree within CMA_TOL."""
    space_j = JSpace([JP.FloatParam(f"x{i}", -3.0, 3.0) for i in range(6)])
    space_t = TSpace([TP.FloatParam(f"x{i}", -3.0, 3.0) for i in range(6)])
    jt, tt = jbase.get_technique("CMAES"), tbase.get_technique("CMAES")
    assert not tt.supports(TSpace(_mixed_specs(TP)))
    st_j = jt.init_state(space_j, jax.random.PRNGKey(0))
    best_j = JBest.empty(space_j)
    best_t = TBest.empty(space_t, CPU)
    for step in range(4):
        st_t = convert.from_jax_tstate(_np_tree(st_j), CPU)
        key = jax.random.PRNGKey(10 + step)
        st_j, cands_j = jt.propose(space_j, st_j, key, best_j)
        _, cands_t = tt.propose(space_t, st_t, best_t,
                                replay_propose(jt, space_j, key))
        np.testing.assert_allclose(N(cands_t.u), np.asarray(cands_j.u),
                                   rtol=0, atol=1e-6)
        vals = space_j.decode_scalars(cands_j.u)
        q = np.array(jax.vmap(lambda v: jnp.sum(
            100.0 * (v[1:] - v[:-1] ** 2) ** 2 + (1 - v[:-1]) ** 2))(vals))
        q[step::9] = np.inf
        best_j = best_j.update(cands_j, jnp.asarray(q))
        best_t = best_t.update(jcands_to_t(cands_j), T(q))
        st_j = jt.observe(space_j, st_j, cands_j, jnp.asarray(q), best_j)
        got = tt.observe(space_t, st_t, jcands_to_t(cands_j), T(q), best_t)
        for f in ("mean", "cov", "sigma", "p_sigma", "p_c", "eig_sq",
                  "eig_isq"):
            np.testing.assert_allclose(
                N(getattr(got, f)), np.asarray(getattr(st_j, f)),
                err_msg=f"step {step} {f}", **CMA_TOL)
        assert int(got.gen) == int(st_j.gen) == step + 1
        np.testing.assert_allclose(_sym(N(got.eig_b), N(got.eig_sq)),
                                   _sym(st_j.eig_b, st_j.eig_sq),
                                   err_msg=f"step {step} B L B^T",
                                   **CMA_TOL)
        b = N(got.eig_b).astype(np.float64)
        np.testing.assert_allclose(b.T @ b, np.eye(6), atol=1e-5)


# -- vmap: BatchedEngine at N = 2 against single runs -------------------------
def _vmap_engines():
    """(engine, steps): every new arm on the mixed space with both
    permutation blocks (smaller populations than the registry's), and
    CMA-ES with PSO on rosenbrock-4d."""
    from uptune_tpu_torch.flagship import resized
    from uptune_tpu_torch.techniques.cmaes import CMAES
    from uptune_tpu_torch.techniques.pso import PSO
    space = TSpace(_mixed_specs(TP, True))

    def objective(vals, perms):
        q = ((vals[:, :4] - 0.5) ** 2).sum(1)
        for pm in perms:
            q = q + 0.05 * (pm - torch.arange(pm.shape[1])).abs().sum(1)
        return q

    sized = ([(f"pso-{c}", 8) for c in CROSS]
             + [(f"ga-{c}", 8) for c in CROSS]
             + [("GGA", 8), ("PatternSearch", 8),
                ("PseudoAnnealingSearch", 8),
                ("AUCBanditMutationTechnique", 12),
                ("ComposableDiffEvolution", 8),
                ("ComposableDiffEvolutionCX", 8)])
    arms = ([resized(tbase.get_technique(n), rows) for n, rows in sized]
            + [tbase.get_technique(n) for n in (
                "RandomTorczon", "RightTorczon", "RegularTorczon",
                "MultiNelderMead", "MultiTorczon")])
    mixed = FusedEngine(space, objective, arms=arms,
                        history_capacity=1 << 10, device="cpu")
    scalar = FusedEngine(rosenbrock_space(4, -3.0, 3.0),
                         lambda v, p: rosenbrock_device(v),
                         arms=[CMAES(population_size=12),
                               PSO(crossover="PX", N=8)],
                         history_capacity=1 << 9, device="cpu")
    return {"mixed": (mixed, 7), "scalar": (scalar, 5)}


@pytest.mark.parametrize("which", ["mixed", "scalar"])
def test_batched_n2_equals_single_runs(which):
    eng, steps = _vmap_engines()[which]
    assert len(eng.arms) == (21 if which == "mixed" else 2)
    be = BatchedEngine(eng, 2)
    sb = be.run(be.init(5), steps)
    for i, k in enumerate(be.instance_seeds(5)):
        si = eng.run(eng.init(k), steps)
        _states_equal(_row(sb, i), si, f"{which} instance {i}")
    assert np.isfinite(be.best_qors(sb)).all()


def test_flagship_portfolio_runs():
    """The flagship under every new arm that supports it (the portfolio
    `chip_smoke.py` drives at scale 11, 6104 rows a step) at scale 1:
    648 rows a step, valid tours in every arm's state, a finite best."""
    from test_torch_engine import flat
    from uptune_tpu_torch.flagship import N_CITIES, flagship_portfolio
    eng = flagship_portfolio(1, history_capacity=1 << 11, device="cpu")
    assert eng.total_batch == 648 and len(eng.arms) == 21
    st = eng.run(eng.init(seed=2), 4)
    for path, leaf in flat(st.tstates).items():
        if "perms" in path:
            assert _valid(leaf.reshape(-1, N_CITIES), N_CITIES), path
    assert _valid(N(st.best.perms[0])[None], N_CITIES)
    assert np.isfinite(eng.best_qor(st)) and int(st.acqs) == 4 * 648
