"""Parity of the port's fused engine with the JAX package on the flagship
at scale 1 (112 rows a step), plus the port's own runs.

(b) holds the full commit state bitwise, with a history small enough to
overflow and evict within the run: both packages start from one state (`convert.from_jax_state`), and for 10 steps the port's `propose`
gets the numbers JAX drew and its `commit` gets JAX's own proposal and
raw QoR (and NelderMead's restart draws, replayed from the JAX restart
key).  The PRNG keys are left out of the comparison: the JAX state's
`key` and `SimplexState.key`, and the port's key.  The JAX side
runs eagerly, so no multiply-add is fused into an FMA.  The hashes of
the compared rows must agree exactly; a LOG_INT value on a .5 rounding
boundary would break that (see test_torch_space.py), and the test
checks it holds for the rows of this run.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from uptune_tpu.engine import FusedEngine as JEngine
from uptune_tpu.engine import default_arms as j_default_arms
from uptune_tpu.space.spec import Space as JSpace
from uptune_tpu.space import params as JP
from uptune_tpu.techniques.de import DifferentialEvolution as JDE
from uptune_tpu.techniques.evolutionary import GreedyMutation as JGM
from uptune_tpu.techniques.purerandom import PureRandom as JPR
from uptune_tpu.techniques.simplex import NelderMead as JNM
from uptune_tpu.workloads import rosenbrock_device as j_rosenbrock
from uptune_tpu.workloads import tsp_device as j_tsp

from uptune_tpu_torch import convert
from uptune_tpu_torch.engine import FusedEngine as TEngine
from uptune_tpu_torch.flagship import flagship, flagship_objective
from uptune_tpu_torch.techniques.de import DEDraws
from uptune_tpu_torch.techniques.evolutionary import GreedyDraws
from uptune_tpu_torch.techniques.simplex import RestartDraws
from uptune_tpu_torch.workloads import rosenbrock_device, rosenbrock_space

from test_torch_ops import (N, T, _flagship_specs, assert_bitwise,
                            assert_cands_equal, jcands_to_t,
                            replay_linear,
                            replay_mutate, replay_param_mask,
                            replay_space_random)

CPU = torch.device("cpu")
CAP = 2048
# the commit test's history: small enough that it overflows within STEPS
# steps, so eviction runs inside a full commit
EVICT_CAP = 512
STEPS = 10


# -- the JAX flagship (as __graft_entry__._flagship, smaller history) ------
def _j_flagship(scale=1, cap=CAP):
    space = JSpace(_flagship_specs(JP))
    rs = np.random.RandomState(7)
    pts = rs.rand(12, 2)
    dist = jnp.asarray(np.sqrt(((pts[:, None, :] - pts[None, :, :]) ** 2)
                               .sum(-1)), jnp.float32)

    def objective(vals, perms):
        return j_rosenbrock(vals[..., :8]) + j_tsp(perms[0], dist)

    arms = j_default_arms(scale)
    pad = (-sum(t.natural_batch(space) for t in arms)) % 8
    if pad:
        arms.append(JPR(batch=pad))
    return JEngine(space, objective, arms=arms, history_capacity=cap,
                   merge_impl="xla")


# -- replayed technique draws ----------------------------------------------
def replay_propose(t, space_j, key):
    """The port's draws for one arm's propose, from the JAX arm's key."""
    if isinstance(t, JPR):
        return replay_space_random(space_j, key, t.batch)
    if isinstance(t, JGM):
        krand, _kx, _kxsel, kmut = jax.random.split(key, 4)
        return GreedyDraws(replay_space_random(space_j, krand, t.batch),
                           replay_mutate(space_j, kmut, t.batch, t.sigma))
    if isinstance(t, JDE):
        P = t.population_size
        kpar, kf, kmask, klin = jax.random.split(key, 4)
        n_pool = P - 1 + t.information_sharing
        picks = jax.vmap(lambda k: jax.random.choice(
            k, n_pool, (3,), replace=False))(jax.random.split(kpar, P))
        return DEDraws(T(picks), T(jax.random.uniform(kf, (P, 1))),
                       replay_param_mask(space_j, kmask, P),
                       replay_linear(space_j, klin, P))
    if isinstance(t, JNM):
        return T(jax.random.uniform(key, (3, space_j.n_scalar)))
    raise TypeError(t)


def replay_observe(t, space_j, tstate_j):
    """NelderMead's restart draws, from the JAX simplex state's key."""
    if not isinstance(t, JNM):
        return None
    k1, k2, _ = jax.random.split(tstate_j.key, 3)
    D = space_j.n_scalar
    others = (T(jax.random.uniform(k1, (D, D)))
              if t.init_style == "random" else None)
    return RestartDraws(T(jax.random.uniform(k2, (D,))), others)


def engine_propose_draws(eng_j, st_j):
    _, *karms = jax.random.split(st_j.key, len(eng_j.arms) + 1)
    return tuple(replay_propose(t, eng_j.space, k)
                 for t, k in zip(eng_j.arms, karms))


# -- state comparison --------------------------------------------------------
def flat(x, prefix="state"):
    """{path: numpy array} over NamedTuples/tuples, leaving out the PRNG
    keys (the `key` fields of both packages)."""
    out = {}
    if isinstance(x, tuple) and hasattr(x, "_fields"):
        for name, v in zip(x._fields, x):
            if name == "key":
                continue
            out.update(flat(v, f"{prefix}.{name}"))
    elif isinstance(x, tuple):
        for i, v in enumerate(x):
            out.update(flat(v, f"{prefix}[{i}]"))
    elif isinstance(x, torch.Tensor):
        out[prefix] = N(x)
    else:
        out[prefix] = np.asarray(x)
    return out


def assert_states_equal(st_j, st_t, when=""):
    fj, ft = flat(st_j), flat(st_t)
    assert sorted(fj) == sorted(ft), (sorted(set(fj) ^ set(ft)))
    for k in fj:
        assert_bitwise(fj[k], ft[k], f"{when} {k}")


def _np_tree(x):
    return jax.tree_util.tree_map(np.asarray, x)


@pytest.fixture(scope="module")
def engines():
    return _j_flagship(), flagship(1, history_capacity=CAP, device="cpu")


# -- (a) the objective ---------------------------------------------------------
def test_objective_matches(engines):
    eng_j, eng_t = engines
    cands = eng_j.space.random(jax.random.PRNGKey(1), 2048)
    vals = eng_j.space.decode_scalars(cands.u)
    ref = np.asarray(eng_j.objective(vals, cands.perms))
    got = N(flagship_objective(CPU)(T(vals), (T(cands.perms[0],
                                                torch.int64),)))
    np.testing.assert_allclose(got, ref, rtol=1e-6)


def test_flagship_shapes(engines):
    eng_j, eng_t = engines
    assert eng_t.total_batch == eng_j.total_batch == 112
    assert [t.name for t in eng_t.arms] == [t.name for t in eng_j.arms]
    assert eng_t.batches == eng_j.batches


# -- (b) the commit state, step by step ---------------------------------------
def test_commit_state_bitwise_10_steps():
    eng_j = _j_flagship(cap=EVICT_CAP)
    eng_t = flagship(1, history_capacity=EVICT_CAP, device="cpu")
    st_j = eng_j.init(jax.random.PRNGKey(0))
    st_t = convert.from_jax_state(eng_t.space, _np_tree(st_j), seed=0,
                                  device="cpu")
    assert_states_equal(st_j, st_t, "init")
    for step in range(STEPS):
        tst_j, cands_j, key_j = eng_j.propose(st_j)
        # the port's propose, fed the numbers JAX drew
        tst_t, cands_t, key_t = eng_t.propose(
            st_t, draws=engine_propose_draws(eng_j, st_j))
        assert_cands_equal(cands_j, cands_t, f"step {step} cands")
        assert_states_equal(tst_j, tst_t, f"step {step} proposed tstates")
        # precondition of a bitwise history: no row on a .5 boundary
        assert_bitwise(eng_j.space.hash_batch(cands_j),
                       N(eng_t.space.hash_batch(cands_t)),
                       f"step {step} hashes")

        raw_j = eng_j.objective(eng_j.space.decode_scalars(cands_j.u),
                                cands_j.perms)
        obs = tuple(replay_observe(t, eng_j.space, ts)
                    for t, ts in zip(eng_j.arms, tst_j))
        st_t = eng_t.commit(
            st_t, tuple(convert.from_jax_tstate(_np_tree(ts), CPU)
                        for ts in tst_j),
            jcands_to_t(cands_j), T(raw_j), key_t, draws=obs)
        st_j = eng_j.commit(st_j, tst_j, cands_j, raw_j, key_j)
        assert_states_equal(st_j, st_t, f"step {step}")
    assert int(st_t.evals) > EVICT_CAP
    assert int(st_t.hist.dropped) > 0        # eviction ran, held to JAX
    assert int(st_t.tstates[3].phase) == 1   # NelderMead reached LOOP


# -- (c) the port's own run keeps its invariants ------------------------------
def test_port_run_invariants(engines):
    _, eng_t = engines
    st = eng_t.init(seed=3)
    for _ in range(15):
        tst, cands, key = eng_t.propose(st)
        u = N(cands.u)
        assert u.shape == (112, eng_t.space.n_scalar)
        assert (u >= 0).all() and (u <= 1).all()
        assert all(sorted(r) == list(range(12)) for r in N(cands.perms[0]))
        st = eng_t.commit(st, tst, cands, eng_t.evaluate(cands), key)
    de, nm = st.tstates[0], st.tstates[3]
    for pm in (N(de.pop.perms[0]), N(st.best.perms[0])[None],
               N(nm.perms[0])[None]):
        assert all(sorted(r) == list(range(12)) for r in pm)
    assert np.isfinite(eng_t.best_qor(st))
    assert int(st.acqs) == 15 * 112
    h0 = N(st.hist.h0)
    assert (np.diff(h0) >= 0).all() and int(st.hist.n) == int(st.evals)
    cfg = eng_t.best_config(st)
    assert sorted(cfg["tour"]) == list(range(12))


# -- (d) convergence on rosenbrock-2d -----------------------------------------
def test_rosenbrock_converges():
    """best < 1e-2 on rosenbrock-2d within a few hundred evals.  A small
    portfolio (NelderMead + a 4-row normal greedy mutation) keeps the
    evals per step low; the default portfolio spends ~100 a step."""
    from uptune_tpu_torch.techniques.evolutionary import GreedyMutation
    from uptune_tpu_torch.techniques.simplex import NelderMead
    space = rosenbrock_space(2, -3.0, 3.0)
    evals = []
    for seed in range(5):
        arms = [GreedyMutation(batch=4, sigma=0.05, mutation_rate=0.3,
                               name="NormalGreedyMutation"),
                NelderMead(init_style="random", name="RandomNelderMead")]
        eng = TEngine(space, lambda v, p: rosenbrock_device(v), arms=arms,
                      device="cpu")
        st = eng.init(seed=seed)
        for _ in range(150):
            st = eng.step(st)
            if eng.best_qor(st) < 1e-2:
                break
        assert eng.best_qor(st) < 1e-2, seed
        evals.append(int(st.evals))
    assert np.median(evals) <= 600, evals


def test_from_jax_state_roundtrip(engines):
    eng_j, eng_t = engines
    st_j = eng_j.run(eng_j.init(jax.random.PRNGKey(4)), 2)
    st_t = convert.from_jax_state(eng_t.space, _np_tree(st_j), device="cpu")
    assert_states_equal(st_j, st_t, "converted")
    assert st_t.hist.h0.dtype == torch.int64


def test_engine_refuses_cuda_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("this host has a card")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        flagship(1)


# -- (e) the surrogate-guided step ---------------------------------------------
def _j_surrogate(eng_j, n=64):
    """A GP fitted by JAX on n evaluated flagship configurations."""
    from uptune_tpu.surrogate import gp as jgp
    space = eng_j.space
    cands = space.random(jax.random.PRNGKey(6), n)
    feats = space.surrogate_transform(space.features(cands))
    y = eng_j.objective(space.decode_scalars(cands.u), cands.perms)
    nc, ncat = space.n_cont_features, space.n_cat
    st = jgp.precompute_kinv(jgp.fit(feats, y, 0.8, 1e-2, n_cont=nc,
                                     n_cat=ncat, ls_cat=0.5))
    return st, float(y.min()), nc, ncat


@pytest.mark.parametrize("impl", ["fused", "score_flat"])
def test_surrogate_eval_and_propose_topk_match(engines, impl):
    """`surrogate_eval_fn(...)(cands)` on one proposal epoch, and
    `propose_topk`'s ranking of it under replayed draws, against JAX (EI,
    JAX's per-tile XLA route on the CPU; 112 rows, so score_flat takes
    predict in both packages)."""
    from uptune_tpu.engine import surrogate_eval_fn as j_eval_fn
    from uptune_tpu_torch.engine import surrogate_eval_fn as t_eval_fn
    from test_torch_acquire import assert_topk
    from test_torch_gp import SD_TOL
    eng_j, eng_t = engines
    gp_j, best, nc, ncat = _j_surrogate(eng_j)
    gp_t = convert.from_jax_gp(_np_tree(gp_j), device="cpu")
    opts = dict(kind="ei", best_y=best, n_cont=nc, n_cat=ncat, impl=impl)
    ev_j = j_eval_fn(eng_j.space, gp_j, **opts)
    ev_t = t_eval_fn(eng_t.space, gp_t, **opts)
    st_j = eng_j.init(jax.random.PRNGKey(2))
    st_t = convert.from_jax_state(eng_t.space, _np_tree(st_j), device="cpu")
    tst_j, cands_j, _ = eng_j.propose(st_j)
    np.testing.assert_allclose(N(ev_t(jcands_to_t(cands_j))),
                               np.asarray(ev_j(cands_j)), **SD_TOL)
    if impl != "fused":
        return
    # JAX's propose_topk is this propose followed by this ranking
    vj, ij = ev_j.topk(cands_j, ev_j.aux, 16)
    tst_t, cands_t, _, vt, it = eng_t.propose_topk(
        st_t, ev_t, 16, draws=engine_propose_draws(eng_j, st_j))
    assert_cands_equal(cands_j, cands_t, "propose_topk cands")
    assert_topk(vj, ij, vt, it, SD_TOL, "propose_topk")


def test_port_surrogate_steps_run(engines):
    """The port's own surrogate-guided steps: `step(eval_fn=...)` commits
    the negated EI as QoR; a refit publishes without rebuilding."""
    from uptune_tpu_torch.engine import surrogate_aux, surrogate_eval_fn
    from uptune_tpu_torch.flagship import flagship_surrogate
    from uptune_tpu_torch.surrogate import gp
    _, eng_t = engines
    x, y, (nc, ncat) = flagship_surrogate(64, seed=1, device="cpu")
    st_gp = gp.fit(x, y, 0.8, 1e-2, n_cont=nc, n_cat=ncat, ls_cat=0.5)
    ev = surrogate_eval_fn(eng_t.space, st_gp, kind="ei",
                           best_y=float(y.min()), n_cont=nc, n_cat=ncat)
    assert ev.aux[0].kinv is not None
    st = eng_t.init(seed=5)
    for i in range(4):
        st = eng_t.step(st, eval_fn=ev)
        if i == 1:
            x2, y2, _ = flagship_surrogate(64, seed=2, device="cpu")
            ev.publish(surrogate_aux(gp.fit(x2, y2, 0.8, 1e-2, n_cont=nc,
                                            n_cat=ncat, ls_cat=0.5),
                                     float(y2.min()), "ei"))
    assert int(st.acqs) == 4 * 112
    assert np.isfinite(eng_t.best_qor(st)) and eng_t.best_qor(st) <= 0
    _, cands, _, vals, idx = eng_t.propose_topk(st, ev, 8)
    assert (N(idx) < cands.batch).all() and (np.diff(N(vals)) <= 0).all()
