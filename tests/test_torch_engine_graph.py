"""The fused engine's CUDA graphs (`engine/graphs.py`, `FusedEngine.step`
and `propose_topk` on the card).

On the CPU the engine never captures: every call runs the eager code and
counts as `eager` in `graph_counts`, and the tree and buffer helpers the
graphs use are checked there.  The cases marked `card` need an NVIDIA
card (they skip without one): graphed steps equal eager `propose` +
`commit` steps bitwise, in every state leaf, at the flagship-s64 shapes
and on a small space, for the objective and for the fused EI eval_fn; a
kept state stays a value; the merge's launch counter counts replays; a
new state structure captures again; `exchange=` and an objective that
reads the host run eagerly.  Run them on a card with

    python -m pytest tests/test_torch_engine_graph.py --noconftest -q
"""
import pytest
import torch

from uptune_tpu_torch import native, obs, rng
from uptune_tpu_torch.engine import FusedEngine, surrogate_eval_fn
from uptune_tpu_torch.engine import graphs
from uptune_tpu_torch.engine.fused import GRAPHS, MAX_CAPTURES
from uptune_tpu_torch.flagship import flagship
from uptune_tpu_torch.surrogate import gp
from uptune_tpu_torch.workloads import rosenbrock_device, rosenbrock_space


# -- helpers -----------------------------------------------------------------
def leaves(tree):
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, (tuple, list)):
        return [x for t in tree for x in leaves(t)]
    return []


def assert_same(a, b):
    """Two trees of tensors equal bitwise, leaf by leaf."""
    la, lb = leaves(a), leaves(b)
    assert len(la) == len(lb)
    for i, (x, y) in enumerate(zip(la, lb)):
        assert x.dtype == y.dtype and x.shape == y.shape, i
        assert (x.detach().cpu().contiguous().numpy().tobytes()
                == y.detach().cpu().contiguous().numpy().tobytes()), i


def eager_step(eng, st, eval_fn=None):
    """A step from the eager functions alone."""
    ts, cands, key = eng.propose(st)
    raw = eng.evaluate(cands) if eval_fn is None else eval_fn(cands)
    return eng.commit(st, ts, cands, raw, key)


def ei_fn(eng, n):
    """The fused EI eval_fn of a GP fitted on n random rows of the
    engine's space."""
    space = eng.space
    cands = space.random(rng.generator(11, eng.device), n)
    x = space.surrogate_transform(space.features(cands))
    y = eng.evaluate(cands)
    nc, ncat = space.n_cont_features, space.n_cat
    st = gp.fit(x, y, 0.8, 1e-2, n_cont=nc, n_cat=ncat, ls_cat=2.0)
    return surrogate_eval_fn(space, st, kind="ei", best_y=float(y.min()),
                             impl="fused", n_cont=nc, n_cat=ncat)


def small(device):
    return FusedEngine(rosenbrock_space(3), lambda v, p: rosenbrock_device(v),
                       history_capacity=1 << 10, device=device)


def counts(eng, **want):
    """graph_counts with every count not named in `want` zero."""
    got = {g: dict(c) for g, c in eng.graph_counts.items()}
    full = {g: {"captures": 0, "replays": 0, "eager": 0} for g in GRAPHS}
    for name, n in want.items():
        g, what = name.split("_")
        full[g][what] = n
    assert got == full


# -- on the CPU ----------------------------------------------------------------
@pytest.fixture(scope="module")
def cpu_eng():
    return flagship(1, history_capacity=2048, device="cpu")


def test_the_cpu_never_captures_and_steps_as_before():
    eng = flagship(1, history_capacity=2048, device="cpu")
    st = want = eng.init(seed=5)
    for _ in range(3):
        st = eng.step(st)
        want = eager_step(eng, want)
        assert_same(st, want)
    counts(eng, step_eager=3)
    assert not eng._captures


def test_the_cpu_scored_step_and_topk_are_eager():
    eng = flagship(1, history_capacity=2048, device="cpu")
    ev = ei_fn(eng, 64)
    st = eng.step(eng.init(seed=6), eval_fn=ev)
    assert_same(st, eager_step(eng, eng.init(seed=6), ev))
    got = eng.propose_topk(st, ev, 8)
    ts, cands, key = eng.propose(st)
    assert_same(got, (ts, cands, key, *ev.topk(cands, ev.aux, 8)))
    counts(eng, propose_eager=2, commit_eager=1)
    assert not eng._captures


def test_exchange_counts_as_eager():
    eng = flagship(1, history_capacity=2048, device="cpu")
    st = eng.init(seed=7)
    assert_same(eng.step(st, exchange=lambda b: b), eager_step(eng, st))
    counts(eng, step_eager=1)


@pytest.mark.parametrize("steps", [0, 1, 3])
def test_a_state_keeps_its_structure_across_steps(cpu_eng, steps):
    """The graphs are keyed by the state's structure, so a closed loop
    captures once only if a step returns a state of its input's."""
    dev = torch.device("cpu")
    st = cpu_eng.init(seed=8)
    for _ in range(steps):
        st = cpu_eng.step(st)
    first = graphs.flatten(st, dev)[1]
    after = graphs.flatten(cpu_eng.step(st), dev)[1]
    assert first == after and hash(first) == hash(after)
    ts, cands, key = cpu_eng.propose(st)
    assert graphs.flatten((ts, cands, key), dev) is not None


def test_flatten_round_trips_a_state(cpu_eng):
    dev = torch.device("cpu")
    st = cpu_eng.step(cpu_eng.init(seed=9))
    got, spec = graphs.flatten(st, dev)
    assert all(isinstance(t, torch.Tensor) for t in got)
    back = graphs.unflatten(spec, got)
    assert type(back) is type(st)
    assert type(back.best) is type(st.best)
    assert type(back.tstates) is tuple
    assert all(a is b for a, b in zip(leaves(back), leaves(st)))


@pytest.mark.parametrize("tree", [
    (torch.zeros(2), 3),
    (torch.zeros(2), [torch.zeros(1)]),
    (torch.zeros(2), torch.zeros(1, device="meta")),
], ids=["number", "list", "other-device"])
def test_flatten_refuses_what_a_graph_cannot_hold(tree):
    assert graphs.flatten(tree, torch.device("cpu")) is None


def test_flatten_keys_shapes_and_dtypes():
    dev = torch.device("cpu")
    a = graphs.flatten((torch.zeros(3), None), dev)[1]
    assert a == graphs.flatten((torch.ones(3), None), dev)[1]
    assert a != graphs.flatten((torch.zeros(4), None), dev)[1]
    assert a != graphs.flatten((torch.zeros(3, dtype=torch.int32), None),
                               dev)[1]
    assert a != graphs.flatten((torch.zeros(3),), dev)[1]


def test_a_layout_aligns_and_separates_its_tensors(cpu_eng):
    dev = torch.device("cpu")
    st = cpu_eng.step(cpu_eng.init(seed=10))
    got, spec = graphs.flatten(st, dev)
    lay = graphs.Layout([(t.shape, t.dtype) for t in got], dev)
    buf = lay.alloc()
    views = lay.views(buf)
    base = buf.data_ptr()
    spans = []
    for v, t in zip(views, got):
        assert v.shape == t.shape and v.dtype == t.dtype
        assert v.is_contiguous()
        off = v.data_ptr() - base
        assert off % graphs.ALIGN == 0
        spans.append((off, off + v.numel() * v.element_size()))
    spans.sort()
    assert all(a[1] <= b[0] for a, b in zip(spans, spans[1:]))
    assert spans[-1][1] <= lay.nbytes
    assert len(lay.groups) == len({t.dtype for t in got})
    assert sorted(i for g in lay.groups for i in g) == list(range(len(got)))
    lay.copy(views, got)
    assert_same(graphs.unflatten(spec, views), st)
    # a clone of the buffer is a tree of its own
    fresh = graphs.unflatten(spec, lay.views(buf.clone()))
    assert_same(fresh, st)
    lay.copy(views, [torch.zeros_like(t) for t in got])
    assert_same(fresh, st)


def test_a_layout_of_nothing_and_of_empty_tensors():
    dev = torch.device("cpu")
    empty = graphs.Layout([], dev)
    assert empty.nbytes == graphs.ALIGN and empty.views(empty.alloc()) == []
    lay = graphs.Layout([(torch.Size([0, 3]), torch.float32),
                         (torch.Size([]), torch.bool)], dev)
    v = lay.views(lay.alloc())
    assert v[0].shape == (0, 3) and v[1].shape == ()
    lay.copy(v, [torch.zeros(0, 3), torch.ones((), dtype=torch.bool)])
    assert bool(v[1])


# -- on the card ---------------------------------------------------------------
@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: CUDA graphs run only there")
    native.reset_launches()
    obs.reset()
    yield torch.device("cuda")
    obs.reset()


ENGINES = {"flagship-s64": lambda d: flagship(64, device=d),
           "small": small}


def graph_storages(eng):
    """The storages of every static buffer of the engine's graphs."""
    out = set()
    for g in eng._captures.values():
        out.add(g.views[0].untyped_storage().data_ptr())
        out.update(t.untyped_storage().data_ptr() for t in g.inputs.values())
        out.update(ph.buf.untyped_storage().data_ptr()
                   for ph in g.phases.values() if ph is not None)
    return out


def assert_own_storage(eng, tree):
    static = graph_storages(eng)
    assert static
    for t in leaves(tree):
        assert t.untyped_storage().data_ptr() not in static


@pytest.mark.card
@pytest.mark.parametrize("name", sorted(ENGINES))
def test_graphed_steps_equal_eager_steps(card, name):
    eng = ENGINES[name](card)
    st = want = eng.init(seed=21)
    for _ in range(20):
        st = eng.step(st)
        want = eager_step(eng, want)
        assert_same(st, want)
    counts(eng, step_captures=1, step_replays=20)
    assert_own_storage(eng, st)


@pytest.mark.card
@pytest.mark.parametrize("name", sorted(ENGINES))
def test_graphed_scored_steps_and_topk_equal_eager(card, name):
    eng = ENGINES[name](card)
    ev = ei_fn(eng, 1024 if name == "flagship-s64" else 64)
    k = 128 if name == "flagship-s64" else 16
    st = want = eng.init(seed=22)
    for _ in range(20):
        st = eng.step(st, eval_fn=ev)
        want = eager_step(eng, want, ev)
        assert_same(st, want)
        got = eng.propose_topk(st, ev, k)
        ts, cands, key = eng.propose(st)
        assert_same(got, (ts, cands, key, *ev.topk(cands, ev.aux, k)))
        assert_own_storage(eng, (st, got))
    counts(eng, propose_captures=1, propose_replays=40,
           commit_captures=1, commit_replays=20)


@pytest.mark.card
def test_a_kept_state_and_batch_stay_values(card):
    eng = flagship(64, device=card)
    ev = ei_fn(eng, 1024)
    st = eng.init(seed=23)
    kept = None
    for i in range(20):
        st = eng.step(st, eval_fn=ev)
        top = eng.propose_topk(st, ev, 128)
        if i == 2:
            kept, kept_top = st, top
            proposed = eng.propose(kept)
            copies = [t.clone() for t in leaves((kept, kept_top))]
    assert_same(eng.propose(kept), proposed)
    assert_same(leaves((kept, kept_top)), copies)
    assert_own_storage(eng, (kept, kept_top))


@pytest.mark.card
def test_the_merge_counter_counts_replays(card):
    eng = flagship(64, device=card)
    ev = ei_fn(eng, 1024)
    st = eng.init(seed=24)
    st = eng.step(st)
    # the warm-up pass ran the merge once, the capture ran nothing, the
    # replay once
    assert native.MERGE.launches == 2
    for i in range(5):
        st = eng.step(st)
        assert native.MERGE.launches == 3 + i
    native.reset_launches()
    st = eng.step(st, eval_fn=ev)               # captures propose, commit
    assert native.MERGE.launches == 2
    assert native.ACQ_SCORES.launches == 1      # launcher C stays eager
    for i in range(5):
        st = eng.step(st, eval_fn=ev)
        eng.propose_topk(st, ev, 128)
        assert native.MERGE.launches == 3 + i
        assert native.ACQ_SCORES.launches == 2 + i
        assert native.ACQ_TOPK.launches == 1 + i


@pytest.mark.card
def test_a_new_structure_captures_again(card):
    eng = small(card)
    st = eng.init(seed=25)
    st = eng.step(eng.step(st))
    counts(eng, step_captures=1, step_replays=2)
    # five structures: int32 or int64 counters
    variants = [st]
    for field in ("evals", "acqs", "arm_pulls", "arm_hits"):
        variants.append(variants[-1]._replace(
            **{field: getattr(st, field).to(torch.int64)}))
    for i, v in enumerate(variants[1:]):
        assert_same(eng.step(v), eager_step(eng, v))
        assert eng.graph_counts["step"]["captures"] == 2 + i
    assert len(eng._captures) == MAX_CAPTURES
    # the first structure was the oldest and is captured once more
    eng.step(st)
    assert eng.graph_counts["step"]["captures"] == len(variants) + 1


@pytest.mark.card
def test_exchange_and_draws_run_eagerly_on_the_card(card):
    eng = small(card)
    ev = ei_fn(eng, 64)
    st = eng.init(seed=26)
    got = eng.step(st, exchange=lambda b: b)
    assert_same(got, eager_step(eng, st))
    draws = eng.draw_propose(rng.split(st.key, 2)[1])
    got = eng.propose_topk(st, ev, 16, draws=draws)
    ts, cands, key = eng.propose(st)
    assert_same(got, (ts, cands, key, *ev.topk(cands, ev.aux, 16)))
    counts(eng, step_eager=1, propose_eager=1)
    assert not eng._captures


@pytest.mark.card
def test_an_objective_that_reads_the_host_runs_eagerly(card):
    def host_read(vals, perms):
        scale = float(vals.abs().max())          # a host read
        return rosenbrock_device(vals) + 0.0 * scale

    eng = FusedEngine(rosenbrock_space(3), host_read,
                      history_capacity=1 << 10, device=card)
    obs.enable()
    st = want = eng.init(seed=27)
    for _ in range(3):
        st = eng.step(st)
        want = eager_step(eng, want)
        assert_same(st, want)
    refused = [e for e in obs.snapshot()["events"]
               if e["name"] == "engine.graph.refused"]
    assert len(refused) == 1
    counts(eng, step_eager=3)
    # the card is usable after the refused capture
    assert float(torch.ones(4, device=card).sum()) == 4.0


@pytest.mark.card
def test_replays_record_one_span_each_and_no_phase_spans(card):
    eng = small(card)
    ev = ei_fn(eng, 64)
    st = eng.step(eng.init(seed=28), eval_fn=ev)     # captures
    eng.propose_topk(st, ev, 16)
    obs.enable()
    st = eng.step(st, eval_fn=ev)
    eng.propose_topk(st, ev, 16)
    names = [e["name"] for e in obs.snapshot()["events"]]
    # C and D stay eager, each with the span of its feature transform
    assert names == ["engine.graph.propose", "engine.evaluate",
                     "acquire.features", "engine.graph.commit",
                     "engine.graph.propose", "engine.topk",
                     "acquire.features"]
