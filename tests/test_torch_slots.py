"""The batched engine's slot primitives (`BatchedEngine.propose_all`,
`init_slot`, `commit_slot`, `propose_topk`, `global_topk`,
`exchange_topk`) and launcher D over an instance axis (the custom op
`uptune_tpu_torch::acquire_topk` and its vmap rule), on the CPU.

Against the JAX package, at its test sizes (rosenbrock-2d, N = 4, a
2^9-row history): one `commit_slot` and one `init_slot` from a converted
stacked JAX state, bitwise against `jit_commit_slot` / `jit_init_slot`
with JAX's proposal, observe and init draws replayed (the PRNG keys left
out of the comparison), and every other slot's row unchanged bitwise;
`exchange_topk` bitwise against JAX's under `jax.vmap` with exact ties.
The port's own: `propose_topk` is `propose_all` followed by each slot's
`acquire_topk`, bitwise (the reference's
`test_jit_propose_topk_matches_full_scores`), and `global_topk` the
exchange of those tops on every row.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from uptune_tpu.engine import BatchedEngine as JBatched
from uptune_tpu.engine import FusedEngine as JEngine
from uptune_tpu.engine.batched import VMAP_AXIS
from uptune_tpu.engine.batched import exchange_topk as j_exchange_topk
from uptune_tpu.techniques.de import DifferentialEvolution as JDE
from uptune_tpu.techniques.simplex import NelderMead as JNM
from uptune_tpu.workloads import rosenbrock_device as j_rosenbrock
from uptune_tpu.workloads import rosenbrock_space as j_rosenbrock_space

from uptune_tpu_torch import convert
from uptune_tpu_torch.engine import (BatchedEngine, FusedEngine,
                                     exchange_topk, surrogate_eval_fn)
from uptune_tpu_torch.ops import acquire as tacq
from uptune_tpu_torch.space.spec import CandBatch
from uptune_tpu_torch.surrogate import gp as tgp
from uptune_tpu_torch.techniques.simplex import SimplexInitDraws
from uptune_tpu_torch.workloads import rosenbrock_device, rosenbrock_space

from test_torch_acquire import geometry
from test_torch_batched import _np, _row, _states_equal
from test_torch_engine import assert_states_equal, replay_observe
from test_torch_lint import plan  # noqa: F401 (gp_plan.h built by g++)
from test_torch_ops import N, T, assert_bitwise, jcands_to_t
from test_torch_ops import replay_space_random

CAP = 1 << 9
SLOT = 2


@pytest.fixture(scope="module")
def engines():
    """The JAX batched engine six steps in (its next commit overflows
    the history and evicts) and the port's engine on the same space."""
    eng_j = JEngine(j_rosenbrock_space(2, -3.0, 3.0),
                    lambda v, p: j_rosenbrock(v), history_capacity=CAP,
                    merge_impl="xla")
    be_j = JBatched(eng_j, 4)
    st_j = be_j.run(be_j.init(jax.random.PRNGKey(3)), 6)
    eng_t = FusedEngine(rosenbrock_space(2, -3.0, 3.0),
                        lambda v, p: rosenbrock_device(v),
                        history_capacity=CAP, device="cpu")
    assert [t.name for t in eng_j.arms] == [t.name for t in eng_t.arms]
    return eng_j, be_j, st_j, eng_t


def _clone(tree):
    from uptune_tpu_torch.engine.batched import _map
    return _map(torch.clone, tree)


def _port_state(eng_t, st_j):
    return convert.from_jax_state(eng_t.space, _np(st_j), device="cpu")


def _other_rows_unchanged(before, after, slot, n):
    for i in range(n):
        if i != slot:
            _states_equal(_row(before, i), _row(after, i), f"slot {i}")


def test_commit_slot_matches_jax(engines):
    """`commit_slot` of slot 2 against `jit_commit_slot`: row 2 bitwise
    but the keys (the history evicts in this commit), every other row as
    it was, and one merge a commit."""
    eng_j, be_j, st_j, eng_t = engines
    t_j, c_j, k_j = be_j.jit_propose_all()(st_j)
    raw_j = eng_j.objective(eng_j.space.decode_scalars(c_j.u[SLOT]),
                            tuple(p[SLOT] for p in c_j.perms))
    be_t = BatchedEngine(eng_t, 4)
    st_t = _port_state(eng_t, st_j)
    before = _clone(st_t)
    tst_t = tuple(convert.from_jax_tstate(_np(ts), torch.device("cpu"))
                  for ts in t_j)
    draws = tuple(replay_observe(t, eng_j.space,
                                 jax.tree_util.tree_map(lambda x: x[SLOT],
                                                        ts))
                  for t, ts in zip(eng_j.arms, t_j))
    # the JAX program donates its input: it gets a copy
    out_j = be_j.jit_commit_slot()(jax.tree_util.tree_map(jnp.copy, st_j),
                                   t_j, c_j, k_j, raw_j, jnp.int32(SLOT))
    out_t = be_t.commit_slot(st_t, tst_t, jcands_to_t(c_j), st_t.key,
                             T(raw_j), SLOT, draws=draws)
    assert out_t is st_t                # written in place
    row_j = jax.tree_util.tree_map(lambda x: x[SLOT], out_j)
    assert int(row_j.hist.dropped) > 0
    assert_states_equal(row_j, _row(out_t, SLOT), "slot 2")
    _other_rows_unchanged(before, out_t, SLOT, 4)
    for i in range(4):
        if i != SLOT:
            assert_states_equal(
                jax.tree_util.tree_map(lambda x: x[i], out_j),
                _row(out_t, i), f"slot {i}")


def replay_init(eng_j, key):
    """The port's init draws of every arm, from the JAX init's key
    (`FusedEngine.init` splits one key an arm)."""
    keys = jax.random.split(key, len(eng_j.arms) + 1)
    out = []
    for t, k in zip(eng_j.arms, keys[:-1]):
        if isinstance(t, JDE):
            out.append(replay_space_random(eng_j.space, k,
                                           t.population_size))
        elif isinstance(t, JNM):
            k0, k1, _, _ = jax.random.split(k, 4)
            seed = replay_space_random(eng_j.space, k0, 1)
            d = eng_j.space.n_scalar
            s = seed.u.shape[1] + 1 if t.init_style == "random" else None
            others = (T(jax.random.uniform(k1, (s - 1, d)))
                      if s is not None else None)
            out.append(SimplexInitDraws(seed, others))
        else:
            out.append(None)
    return tuple(out)


def test_init_slot_matches_jax(engines):
    """`init_slot` of slot 2 against `jit_init_slot` with JAX's init
    draws replayed: row 2 is the fresh state bitwise (keys left out),
    every other row as it was, and the row depends on the seed alone."""
    eng_j, be_j, st_j, eng_t = engines
    be_t = BatchedEngine(eng_t, 4)
    st_t = _port_state(eng_t, st_j)
    before = _clone(st_t)
    key = jax.random.PRNGKey(17)
    draws = replay_init(eng_j, key)
    st_j2 = jax.tree_util.tree_map(jnp.copy, st_j)
    out_j = be_j.jit_init_slot()(st_j2, jnp.int32(SLOT), key)
    out_t = be_t.init_slot(st_t, SLOT, 17, draws=draws)
    assert_states_equal(jax.tree_util.tree_map(lambda x: x[SLOT], out_j),
                        _row(out_t, SLOT), "init slot 2")
    _other_rows_unchanged(before, out_t, SLOT, 4)
    # the same seed at another slot, or alone, gives the same row
    alone = eng_t.init(17)
    again = be_t.init_slot(be_t.init(0), 0, 17)
    _states_equal(_row(again, 0), alone, "slot 0")
    st_a = be_t.init_slot(be_t.init(0), 3, 17)
    _states_equal(_row(st_a, 3), alone, "slot 3")


@pytest.mark.parametrize("case", ["distinct", "ties", "all_tied"])
def test_exchange_topk_matches_jax(case):
    """The portfolio-wide top k of the instances' own lists against
    JAX's `exchange_topk` under `jax.vmap`: values, owners and local
    indices bitwise, ties to the lowest flat (instance, rank) index."""
    r = np.random.RandomState(9)
    n, k = 4, 5
    vals = -np.sort(-r.rand(n, k).astype(np.float32), axis=1)
    if case == "ties":
        vals[1] = vals[0]
        vals[3, :2] = vals[0, 0]
    if case == "all_tied":
        vals[:] = 0.5
    idx = np.stack([r.permutation(50)[:k] for _ in range(n)]).astype(
        np.int32)
    want = jax.vmap(lambda v, i: j_exchange_topk(v, i, (VMAP_AXIS,), k),
                    axis_name=VMAP_AXIS)(jnp.asarray(vals), jnp.asarray(idx))
    got = exchange_topk(T(vals), T(idx), k)
    for w, g, name in zip(want, got, ("vals", "owner", "idx")):
        assert_bitwise(np.asarray(w)[0], N(g), name)
        assert (np.asarray(w) == np.asarray(w)[0]).all()


@pytest.fixture(scope="module")
def acq_engine():
    """A port GP on rosenbrock-3d's features and a 4-slot engine."""
    space = rosenbrock_space(3, -2.0, 2.0)
    g = np.random.RandomState(0)
    x = T(g.rand(32, space.n_surrogate_features).astype(np.float32))
    y = T(g.randn(32).astype(np.float32))
    st = tgp.fit(x, y, 0.8, 1e-2)
    eng = FusedEngine(space, lambda v, p: torch.zeros(v.shape[0]),
                      history_capacity=1 << 10, device="cpu")
    return space, st, float(y.min()), BatchedEngine(eng, 4)


@pytest.mark.parametrize("kind", ["lcb", "ei"])
def test_propose_topk_is_propose_all_then_each_slots_topk(acq_engine,
                                                          kind):
    """One epoch ranked under vmap (D's custom op: the slots' lists as
    segments of one call) equals `propose_all` followed by each slot's
    own `acquire_topk`, bitwise; and each slot's top k is the stable
    top k of its full utility vector."""
    space, st, best, be = acq_engine
    acq = surrogate_eval_fn(space, st, kind=kind, best_y=best)
    s0 = be.init(2)
    ts, cands, keys, vals, idx = be.propose_topk(s0, 5, acq)
    ts2, cands2, keys2 = be.propose_all(s0)
    assert torch.equal(cands.u, cands2.u) and torch.equal(keys, keys2)
    assert vals.shape == idx.shape == (4, 5) and idx.dtype == torch.int32
    for i in range(4):
        ci = CandBatch(cands.u[i], tuple(p[i] for p in cands.perms))
        v1, i1 = acq.topk(ci, acq.aux, 5)
        assert_bitwise(N(v1), N(vals[i]), f"slot {i} vals")
        assert_bitwise(N(i1), N(idx[i]), f"slot {i} idx")
        u = -acq(ci)       # the eval orientation is the negated utility
        rv, ri = tacq.select_topk(u, 5)
        assert torch.equal(ri, idx[i])
        torch.testing.assert_close(rv, vals[i], rtol=1e-5, atol=2e-6)
    gv, gown, gidx = be.global_topk(s0, 5, acq)
    assert gv.shape == (4, 5)
    ev, eo, ei = exchange_topk(vals, idx, 5)
    for i in range(4):
        assert torch.equal(gv[i], ev) and torch.equal(gown[i], eo)
        assert torch.equal(gidx[i], ei)


def test_acquire_topk_vmap_rule_takes_the_instance_axis_on_queries(
        acq_engine):
    """Under `torch.func.vmap` the query rows carry the instances; a
    batched GP operand is not a path of the engine and raises, with no
    per-instance loop."""
    space, st, best, _ = acq_engine
    g = np.random.RandomState(3)
    xq = T(g.rand(3, 40, space.n_surrogate_features).astype(np.float32))
    vals, idx = torch.func.vmap(
        lambda q: tacq.acquire_topk(st, q, 6, kind="lcb"))(xq)
    for i in range(3):
        v1, i1 = tacq.acquire_topk(st, xq[i], 6, kind="lcb")
        assert torch.equal(vals[i], v1) and torch.equal(idx[i], i1)
    blocks, kinv, params = tacq.prep(st, xq[0], "lcb", None, 2.0, None, 0)
    qc, qk, xc, xk, alpha = blocks
    with pytest.raises(ValueError, match="shared by every instance"):
        torch.func.vmap(lambda a: tacq.topk_tile(
            qc, qk, xc, xk, a, kinv, params, "lcb", 6))(
            alpha.expand(2, -1).contiguous())


def test_segmented_d_checks_its_segments_before_the_device(acq_engine,
                                                            monkeypatch):
    """D over segments asks the library for a segmented scratch, and
    refuses rows that do not split into the segments, before the device
    is looked at."""
    space, st, best, _ = acq_engine
    g = np.random.RandomState(4)
    xq = T(g.rand(60, space.n_surrogate_features).astype(np.float32))
    blocks, kinv, params = tacq.prep(st, xq, "lcb", None, 2.0, None, 0)
    asked = geometry(monkeypatch, words=1000)
    from uptune_tpu_torch import native
    query = native.ACQ_TOPK.query
    monkeypatch.setattr(native.ACQ_TOPK, "query", lambda sym, *a, **kw: (
        asked.append((sym, a)) or 1000 if sym == "ut_acquire_scratch_words"
        else query(sym, *a, **kw)))
    with pytest.raises(ValueError, match="do not split into 7 segments"):
        tacq.topk_segments_cuda(*blocks, kinv, params, "lcb", 3, 7)
    with pytest.raises(ValueError, match="k must be"):
        tacq.topk_segments_cuda(*blocks, kinv, params, "lcb", 16, 4)
    with pytest.raises(ValueError, match="needs CUDA tensors"):
        tacq.topk_segments_cuda(*blocks, kinv, params, "lcb", 3, 4)
    asked.clear()
    with pytest.raises(ValueError, match="scratch must be"):
        tacq.topk_segments_cuda(*blocks, kinv, params, "lcb", 3, 4,
                                scratch=torch.empty(10))
    assert asked == [("ut_acquire_scratch_words", (15, 32, 1, 3, 4))]


@pytest.mark.parametrize("b,n,var,k,segs", [(6040, 1024, 1, 128, 4),
                                            (4096, 1024, 1, 32, 64),
                                            (40, 32, 0, 6, 3),
                                            (6040, 1024, 1, 128, 1)])
def test_segments_scratch_words(plan, b, n, var, k, segs):
    """D over S segments of B rows plans its passes over the S x B rows
    as one batch and keeps each segment's candidates: the words of one
    launch over S x B rows but S times a segment's candidate lists; one
    segment is the single-list plan."""
    f = plan.ut_acquire_scratch_words
    tile = 128
    np_, bp = -(-n // tile) * tile, -(-(b * segs) // tile) * tile
    words = (np_ // tile) * bp * (2 if var else 1)
    if var:
        words += bp * np_ + 2 * np_ * np_
    words += 2 * segs * -(-b // 256) * min(k, 256)
    assert f(b, n, var, k, segs) == words
    assert f(b, n, var, b + 1, segs) == -1
    assert f(b, n, var, k, 0) == -1
    assert plan.ut_acquire_topk_slots(b, k) >= k
