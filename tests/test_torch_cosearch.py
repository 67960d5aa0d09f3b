"""Cooperating g++ flag searches (the benchmark's `gcc-options-g12-pf4`
deployment) through the port's `BatchedEngine` on the CPU: four
instances of the mined g++ 12.2 space, each with its own arms and
history, every step scored by one GP's EI and the best exchanged after
every step, then `global_topk` over the four instances' proposals.

A batched commit with the exchange is held bitwise against the JAX
package's `BatchedEngine` commit (`jax.vmap(commit, axis_name=...)` with
its `exchange_best`) from the same state, proposal and QoR, in a step
that evicts; `global_topk` against the benchmark's float64 reference
(`portbench/reference/instances.py` and `gp.py`); and the obs plane's
`engine.exchange` span and its two counters.

Small: the default arms at scale 1 (432 rows an instance a step), 512-row
histories (the third step evicts), a 64-row GP and k 8."""
import copy
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from uptune_tpu.engine import BatchedEngine as JBatched
from uptune_tpu.engine import FusedEngine as JEngine
from uptune_tpu.engine.batched import VMAP_AXIS
from uptune_tpu.engine.batched import exchange_best as j_exchange_best
from uptune_tpu.engine.fused import default_arms as j_default_arms
from uptune_tpu.space import params as JP
from uptune_tpu.space.spec import Space as JSpace
from uptune_tpu.techniques.purerandom import PureRandom as JPureRandom

from portbench.drivers.common import program_space
from portbench.reference import gcc, instances
from portbench.reference import gp as ref_gp
from portbench.reference.space import RefSpace
from uptune_tpu_torch import convert, obs
from uptune_tpu_torch.engine import (BatchedEngine, FusedEngine,
                                     surrogate_eval_fn)
from uptune_tpu_torch.engine.fused import default_arms
from uptune_tpu_torch.space.spec import CandBatch
from uptune_tpu_torch.surrogate import gp
from uptune_tpu_torch.techniques.purerandom import PureRandom

from test_torch_batched import _np, _stack
from test_torch_engine import assert_states_equal, replay_observe
from test_torch_ops import N, T, jcands_to_t

CONFIG = gcc.ROOT / "portbench" / "configs" / "gcc-options-g12-pf4.json"
LIMITS = gcc.ROOT / "portbench" / "limits" / \
    "gcc-options-g12-pf4.cosearch.json"
CPU = torch.device("cpu")
N_INST, ROWS, CAP, TRAIN, K = 4, 432, 512, 64, 8


@pytest.fixture(scope="module")
def cfg():
    return json.loads(CONFIG.read_text())


def pad(arms, space):
    return -sum(t.natural_batch(space) for t in arms) % 8


@pytest.fixture(scope="module")
def model(cfg):
    """The engine without a device objective, its EI over a GP fitted on
    the first 64 archived builds, and the float64 reference's
    posterior."""
    space = program_space(cfg["space"])
    ref = RefSpace(cfg["space"], cfg["hash"]["multiplier_seed"])
    small = copy.deepcopy(cfg)
    small["gp"]["train_rows"] = TRAIN
    g = small["gp"]
    u, y = gcc.training_set(small, 7)
    ut = torch.from_numpy(u)
    x = space.surrogate_features(CandBatch(ut, ()))
    st = gp.fit(x, torch.from_numpy(y), g["lengthscale"], g["noise"],
                n_cont=space.n_cont_features, n_cat=space.n_cat,
                ls_cat=g["ls_cat"])
    best = float(y.min())
    ev = surrogate_eval_fn(space, st, kind="ei", best_y=best, impl="fused",
                           n_cont=space.n_cont_features, n_cat=space.n_cat)
    vals, bad = ref.resolve(u, space.decode_scalars(ut).numpy())
    assert bad.sum() == 0
    post = ref_gp.fit(torch.from_numpy(ref.features(u, vals, [])),
                      torch.from_numpy(y.astype(np.float64)),
                      g["lengthscale"], g["noise"], g["ls_cat"], ref.n_cont,
                      ref.n_cat)
    arms = default_arms(1)
    arms.append(PureRandom(batch=pad(arms, space)))
    eng = FusedEngine(space, None, arms=arms, history_capacity=CAP,
                      device=CPU)
    assert eng.total_batch == ROWS
    return eng, ev, ref, post, best


def jax_space(cfg) -> JSpace:
    return JSpace([JP.EnumParam(p["name"], options=tuple(p["options"]))
                   if p["kind"] == "enum" else
                   JP.IntParam(p["name"], lo=p["lo"], hi=p["hi"])
                   for p in cfg["space"]])


@pytest.fixture(scope="module")
def jax_pf4(cfg, model):
    """The JAX package's engine over the same space and arms, four
    instances two exchanging commits in (each instance's history full),
    and its next proposal with the port's EI of it as the raw QoR."""
    eng, ev = model[:2]
    space_j = jax_space(cfg)
    arms = j_default_arms(1)
    arms.append(JPureRandom(batch=pad(arms, space_j)))
    eng_j = JEngine(space_j, lambda v, p: jnp.zeros(v.shape[0]), arms=arms,
                    history_capacity=CAP, merge_impl="xla")
    assert [t.name for t in eng_j.arms] == [t.name for t in eng.arms]
    ex = lambda b: j_exchange_best(b, (VMAP_AXIS,))  # noqa: E731
    propose = jax.jit(jax.vmap(eng_j.propose))
    commit = jax.jit(lambda s, ts, c, q, k, evict: jax.vmap(
        lambda s, ts, c, q, k: eng_j.commit(s, ts, c, q, k, exchange=ex,
                                            evict_pred=evict),
        axis_name=VMAP_AXIS)(s, ts, c, q, k))

    def scored(cands):
        c = jcands_to_t(cands)
        flat = CandBatch(c.u.reshape(N_INST * ROWS, -1), ())
        return jnp.asarray(N(ev(flat)).reshape(N_INST, ROWS))

    def evict(st, cands):
        return jnp.any(st.hist.n + cands.u.shape[1] > CAP)
    st = JBatched(eng_j, N_INST).init(jax.random.PRNGKey(5))
    for _ in range(2):
        tst, cands, keys = propose(st)
        st = commit(st, tst, cands, scored(cands), keys, evict(st, cands))
    tst, cands, keys = propose(st)
    return eng_j, st, tst, cands, keys, scored(cands), commit, \
        evict(st, cands)


def test_exchanging_commit_matches_jax(jax_pf4, model):
    """One batched commit with the exchange from a converted stacked JAX
    state, with JAX's proposal and the same QoR, against JAX's vmapped
    commit and `exchange_best`, bitwise in every leaf; every instance's
    history overflows and evicts in it, and every instance ends with one
    best."""
    eng = model[0]
    eng_j, st_j, tst_j, cands_j, keys_j, raw_j, commit, evict = jax_pf4
    assert bool(evict)
    out_j = commit(st_j, tst_j, cands_j, raw_j, keys_j, evict)
    st_t = convert.from_jax_state(eng.space, _np(st_j), device="cpu")
    tst_t = tuple(convert.from_jax_tstate(_np(ts), CPU) for ts in tst_j)
    draws = _stack([
        tuple(replay_observe(t, eng_j.space,
                             jax.tree_util.tree_map(lambda x: x[i], ts))
              for t, ts in zip(eng_j.arms, tst_j))
        for i in range(N_INST)])
    be = BatchedEngine(eng, N_INST, exchange_every=1)
    out_t = be.commit(st_t, tst_t, jcands_to_t(cands_j), T(raw_j),
                      st_t.key, exchange=True, draws=draws)
    assert (N(out_t.hist.dropped) > N(st_t.hist.dropped)).all()
    assert_states_equal(out_j, out_t, "exchanging commit")
    q = N(out_t.best.qor)
    assert (q == q.min()).all()
    assert (N(out_t.best.u) == N(out_t.best.u)[0]).all()


def test_global_topk_matches_the_reference(model):
    """`global_topk` over the four instances' proposals (D once over four
    segments, then `exchange_topk`) against the float64 EI of every row
    of the pool and the reference's pooled rule, within the cell's
    limits; every instance reads the same list."""
    eng, ev, ref, post, best = model
    limits = json.loads(LIMITS.read_text())
    be = BatchedEngine(eng, N_INST, exchange_every=1)
    st = be.run(be.init(11), 3, ev)
    assert (N(st.hist.dropped) > 0).all()
    vals, owner, idx = be.global_topk(st, K, ev)
    assert vals.shape == owner.shape == idx.shape == (N_INST, K)
    for t in (vals, owner, idx):
        assert (t == t[0]).all()
    _, pool, _ = be.propose_all(st)
    u = pool.u.reshape(N_INST * ROWS, -1)
    dv, bad = ref.resolve(u.numpy(), eng.space.decode_scalars(u).numpy())
    assert bad.sum() == 0
    x = torch.from_numpy(ref.features(u.numpy(), dv, []))
    ei = ref_gp.ei(post, x, best).numpy().reshape(N_INST, ROWS)
    v, o, r = N(vals[0]).astype(np.float64), N(owner[0]), N(idx[0])
    assert instances.order_faults(v, o, r) == 0
    assert len(set(zip(o.tolist(), r.tolist()))) == K
    scale = float(post.std)
    assert np.abs(v - ei[o, r]).max() / scale <= limits["topk_value_gap"]
    kth = instances.pooled_topk(ei, K)[0][-1]
    assert max(0.0, kth - ei[o, r].min()) / scale <= \
        limits["topk_select_gap"]
    # the pool's winners by the reference are the program's
    _, o_ref, r_ref = instances.pooled_topk(ei, K)
    assert set(zip(o_ref.tolist(), r_ref.tolist())) == \
        set(zip(o.tolist(), r.tolist()))


@pytest.mark.parametrize("every", [1, 0])
def test_exchange_span_and_counters(model, every):
    """`engine.exchange` once an exchanging step (never without the
    exchange), `engine.exchanges` one and `engine.instance_commits` N a
    step."""
    eng, ev = model[:2]
    be = BatchedEngine(eng, N_INST, exchange_every=every)
    st = be.init(3)
    obs.enable()
    try:
        be.run(st, 3, ev)
        spans = [e["name"] for e in obs.snapshot()["events"]
                 if e.get("dur") is not None]
        exchanges = obs.counter_value("engine.exchanges")
        commits = obs.counter_value("engine.instance_commits")
    finally:
        obs.reset()
    assert spans.count("engine.exchange") == 3 * every
    assert spans.count("engine.batched_run") == 1
    assert exchanges == 3 * every
    assert commits == 3 * N_INST
