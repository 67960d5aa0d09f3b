"""NelderMead's proposal in one kernel (`csrc/simplex.cu`,
`native.SIMPLEX`) and the entry that routes to it,
`ops/simplex.py::simplex_propose`.

On the CPU: `NelderMead.propose` and the entry are the torch chain
(`propose_chain`) bitwise and launch nothing, for the random, right and
regular simplexes in INIT and in LOOP, over values with ties, +inf, NaN,
and both signs of zero and of NaN; a numpy model of the kernel's algorithm (the rank over
sort keys, the centroid's sum in order, the float32 1 / S, the unfused
arithmetic, the clamp) rebuilds the chain's outputs bitwise on the same
states; the custom op's vmap rule stacks the instances into one call;
the wrapper refuses a CPU state; the kernel's INIT
is the technique's and its name keeps clear of the rooflines' patterns.
The cases marked `card` hold the kernel bitwise against the chain at D
13, 328 and 2048, count one launch a proposal and one a vmapped
proposal, and hold the fused and batched engines' proposals bitwise
against the chain's, eagerly and replayed from a captured graph; they
skip without an NVIDIA card.  Run them on a card with

    python -m pytest tests/test_torch_simplex_kernel.py --noconftest -q
"""
import json
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from portbench.drivers.common import program_space
from uptune_tpu_torch import native, rng
from uptune_tpu_torch.engine import BatchedEngine, FusedEngine, graphs
from uptune_tpu_torch.engine.fused import default_arms
from uptune_tpu_torch.flagship import flagship
from uptune_tpu_torch.ops import simplex as simplex_ops
from uptune_tpu_torch.techniques.simplex import (INIT, LOOP, NelderMead,
                                                 SimplexState)
from uptune_tpu_torch.workloads import rosenbrock_space

REPO = Path(__file__).resolve().parents[1]
CPU = torch.device("cpu")
GCC_CONFIG = REPO / "portbench" / "configs" / "gcc-options-g12.json"
ROOFLINE = REPO / "portbench" / "metrics" / "acquire_scores_roofline.py"
COEFFS = (2.0, 2.0, 0.5, 0.5)      # NelderMead's alpha, gamma, beta, sigma
STYLES = ("random", "right", "regular")
# the values of a LOOP state: distinct, tied, with +inf, with NaN, with
# both signs of zero and of NaN; INIT's are all +inf
VALUES = ("distinct", "ties", "inf", "nan", "signs")


def bits(t: torch.Tensor) -> np.ndarray:
    """A tensor's bits: float32 as int32, anything else as bytes."""
    t = t.detach().cpu().contiguous().reshape(-1)
    return t.view(torch.int32 if t.dtype == torch.float32
                  else torch.uint8).numpy()


def leaves(tree):
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, (tuple, list)):
        return [x for t in tree for x in leaves(t)]
    return []


def assert_bitwise(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.shape == w.shape and g.dtype == w.dtype
        np.testing.assert_array_equal(bits(g), bits(w))


def values(kind: str, s: int, seed: int) -> np.ndarray:
    r = np.random.RandomState(seed)
    v = r.standard_normal(s).astype(np.float32)
    if kind == "ties":
        v = r.randint(0, 4, s).astype(np.float32)
    elif kind == "inf":
        v[r.rand(s) < 0.3] = np.inf
        v[0] = np.inf
    elif kind == "nan":
        v[r.rand(s) < 0.3] = np.nan
        v[1] = np.inf
    elif kind == "signs":
        v = r.choice(np.float32([0.0, -0.0, 1.0, -1.0, np.inf, np.nan,
                                 -np.float32(np.nan)]), s)
    return v


def state(style: str, d: int, phase: int, kind: str, seed: int,
          device=CPU):
    """A NelderMead state of `style` over d unit lanes (its own initial
    simplex, moved a little in LOOP so that no two rows are alike) and
    its propose draws."""
    nm = NelderMead(style, f"{style.title()}NelderMead")
    space = rosenbrock_space(d)
    st = nm.init_state(space, nm.draw_init(space, rng.generator(seed, CPU)))
    draws = nm.draw_propose(space, rng.generator(seed + 1, CPU))
    if phase == LOOP:
        r = np.random.RandomState(seed)
        jitter = r.uniform(-0.05, 0.05, tuple(st.pts_u.shape))
        pts = np.clip(st.pts_u.numpy() + jitter, 0.0, 1.0).astype(np.float32)
        st = st._replace(
            pts_u=torch.from_numpy(pts),
            vals=torch.from_numpy(values(kind, d + 1, seed)),
            phase=torch.tensor(LOOP, dtype=torch.int32))
    to = {k: v.to(device) if isinstance(v, torch.Tensor) else v
          for k, v in st._asdict().items()}
    return nm, SimplexState(**to), draws.to(device)


def chain(st: SimplexState, draws: torch.Tensor):
    return simplex_ops.propose_chain(st.pts_u, st.vals, draws, st.phase,
                                     *COEFFS)


# -- the kernel's algorithm in numpy ------------------------------------------
def sort_keys(v: np.ndarray) -> np.ndarray:
    """The kernel's `sort_key`: -0 as +0, every NaN above +inf."""
    v = np.where(v == 0, np.float32(0.0), v).astype(np.float32)
    b = v.view(np.uint32)
    k = np.where(b & np.uint32(0x80000000), ~b, b | np.uint32(0x80000000))
    return np.where(np.isnan(v), np.uint32(0xFFFFFFFF), k).astype(np.uint32)


def model(pts, vals, draws, phase, alpha, gamma, beta, sigma):
    """simplex.cu's algorithm over float32 numpy arrays: each value's
    rank (the values before it in the stable order), the sorted rows
    summed one at a time, the float32 1 / S, unfused float32 ops in the
    chain's order, a clamp that passes NaN."""
    f32 = np.float32
    if phase == INIT:
        return np.concatenate([pts, draws]), pts, vals
    s = len(vals)
    keys = sort_keys(vals)
    order = np.empty(s, np.int64)
    for i in range(s):
        rank = (keys[:i] <= keys[i]).sum() + (keys[i + 1:] < keys[i]).sum()
        order[rank] = i
    p = pts[order]
    acc = p[0].copy()
    for r in range(1, s):
        acc = acc + p[r]
    c = acc * f32(1.0 / s)
    w = p[-1]

    def clamp(x):
        return np.where(np.isnan(x), x, np.minimum(np.maximum(x, f32(0)),
                                                   f32(1)))
    refl = clamp(c + (c - w) * f32(alpha))
    expa = clamp(c + (refl - c) * f32(gamma))
    c_out = clamp(c + (refl - c) * f32(beta))
    c_in = clamp(c + (w - c) * f32(beta))
    shrink = p[0] + (p[1:] - p[0]) * f32(sigma)
    return (np.concatenate([refl[None], expa[None], c_out[None], c_in[None],
                            shrink]), p, vals[order])


# -- on the CPU ---------------------------------------------------------------
@pytest.mark.parametrize("style", STYLES)
@pytest.mark.parametrize("kind", ("init",) + VALUES)
def test_the_cpu_proposal_is_the_chain(style, kind):
    """`NelderMead.propose` and the entry give the chain's batch and
    state bitwise on the CPU, and launch nothing."""
    phase = INIT if kind == "init" else LOOP
    nm, st, draws = state(style, 6, phase, kind, seed=len(kind))
    want = chain(st, draws)
    before = native.counts()
    st2, cands = nm.propose(rosenbrock_space(6), st, None, draws)
    entry = simplex_ops.simplex_propose(st.pts_u, st.vals, draws, st.phase,
                                        *COEFFS)
    assert native.counts() == before
    assert_bitwise((cands.u, st2.pts_u, st2.vals), want)
    assert_bitwise(entry, want)
    assert int(st2.phase) == phase and cands.perms == ()


@pytest.mark.parametrize("style", STYLES)
@pytest.mark.parametrize("kind", ("init",) + VALUES)
@pytest.mark.parametrize("d", (1, 13, 40))
def test_the_kernels_algorithm_rebuilds_the_chain(style, kind, d):
    """The numpy model of simplex.cu equals the chain bitwise: the
    stable order (ties by index, +inf in order, every NaN last, -0 as
    +0), the centroid, the trial and shrink points, the sorted state."""
    phase = INIT if kind == "init" else LOOP
    _, st, draws = state(style, d, phase, kind, seed=d + len(kind))
    want = chain(st, draws)
    got = model(st.pts_u.numpy(), st.vals.numpy(), draws.numpy(), phase,
                *COEFFS)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(
            np.asarray(g, np.float32).reshape(-1).view(np.int32), bits(w))


def test_the_sort_keys_order_as_the_chain_sorts():
    """Sorting by the keys, then the index, is torch.argsort(stable=True)
    on the CPU (and jnp.argsort) over every special value at once."""
    v = np.float32([3.0, -0.0, np.nan, 0.0, -np.inf, np.inf, -np.float32(
        np.nan), 1e-45, -1e-45, 3.0, 0.0, np.inf, -2.5, np.nan])
    by_keys = np.lexsort((np.arange(len(v)), sort_keys(v)))
    want = torch.argsort(torch.from_numpy(v), stable=True).numpy()
    np.testing.assert_array_equal(by_keys, want)


def test_the_kernels_init_is_the_techniques():
    src = native.SIMPLEX.source.read_text()
    (init,) = re.findall(r"constexpr int kInit = (\d+);", src)
    assert int(init) == INIT == simplex_ops.INIT and LOOP != INIT


def four_states(d: int = 7):
    """Four states of one space: three in LOOP (distinct, tied, NaN
    values) and one in INIT, stacked, with their draws."""
    parts = [state(style, d, phase, kind, seed=10 + i)
             for i, (style, phase, kind) in enumerate((
                 ("random", LOOP, "distinct"), ("right", LOOP, "ties"),
                 ("regular", INIT, "init"), ("random", LOOP, "nan")))]
    sts = [p[1] for p in parts]
    return (torch.stack([s.pts_u for s in sts]),
            torch.stack([s.vals for s in sts]),
            torch.stack([p[2] for p in parts]),
            torch.stack([s.phase for s in sts]), parts)


def test_vmap_stacks_the_instances_into_one_call(monkeypatch):
    """Under vmap the op's rule calls the kernel's wrapper once on all
    instances (a stand-in here: the chain, instance by instance), each
    instance getting its own outputs; an operand without the instance
    axis is shared."""
    pts, vals, draws, phase, parts = four_states()
    calls = []

    def stand_in(p, v, dr, ph, *coeffs):
        calls.append(p.shape[0])
        outs = [simplex_ops.propose_chain(*x, *coeffs)
                for x in zip(p, v, dr, ph)]
        return tuple(torch.stack(o) for o in zip(*outs))
    monkeypatch.setattr(simplex_ops, "simplex_cuda", stand_in)
    op = torch.ops.uptune_tpu_torch.simplex_propose

    def one(p, v, dr, ph):
        u, q, w = op(p[None], v[None], dr[None], ph.reshape(1), *COEFFS)
        return u[0], q[0], w[0]
    prev = torch._C._functorch._is_vmap_fallback_enabled()
    torch._C._functorch._set_vmap_fallback_enabled(False)
    try:
        got = torch.func.vmap(one)(pts, vals, draws, phase)
        shared = torch.func.vmap(one, in_dims=(0, 0, None, 0))(
            pts, vals, draws[1], phase)
    finally:
        torch._C._functorch._set_vmap_fallback_enabled(prev)
    assert calls == [4, 4]
    for i, (_, st, dr) in enumerate(parts):
        assert_bitwise([o[i] for o in got], chain(st, dr))
        assert_bitwise([o[i] for o in shared], chain(st, draws[1]))


def test_the_wrapper_refuses_a_cpu_state():
    pts, vals, draws, phase, _ = four_states()
    with pytest.raises(ValueError, match="needs a CUDA state"):
        simplex_ops.simplex_cuda(pts, vals, draws, phase, *COEFFS)


def gp_tile_pattern() -> str:
    """The pattern by which the benchmark picks C's and D's kernels."""
    found = re.search(r"GP_TILE = \((.*?)\)\n", ROOFLINE.read_text(), re.S)
    return "".join(re.findall(r'r?"([^"]*)"', found.group(1)))


def test_the_kernels_name_keeps_clear_of_the_rooflines():
    """No kernel of simplex.cu matches the pattern that selects C's and
    D's kernels, nor the merge's or the features' names."""
    src = native.SIMPLEX.source.read_text()
    kernels = re.findall(r"__global__ void (?:__launch_bounds__\(\w+\) )?"
                         r"(\w+)\(", src)
    assert kernels == ["simplex_propose_kernel"]
    pattern = gp_tile_pattern()
    assert "krows_mma_kernel" in pattern
    for name in kernels:
        assert not re.search(pattern, name)
        assert "merge_rows_kernel" not in name
        assert "surrogate_feats_kernel" not in name


# -- on the card --------------------------------------------------------------
@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the simplex kernel runs only "
                    "there")
    native.reset_launches()
    return torch.device("cuda")


def on_card_chain(monkeypatch):
    """Make `simplex_propose` run the torch chain on the card too."""
    monkeypatch.setattr(simplex_ops, "simplex_propose",
                        simplex_ops.propose_chain)


@pytest.mark.card
@pytest.mark.parametrize("d", (13, 328, 2048))
@pytest.mark.parametrize("kind", ("init",) + VALUES)
def test_the_kernel_equals_the_chain_on_the_card(card, d, kind):
    """Bitwise against the CPU's chain, and against the card's chain
    where no value is a signed zero or NaN (the card's argsort may order
    -0 before +0, or a negative NaN apart from the others, where JAX and
    the CPU hold each pair equal); one launch."""
    phase = INIT if kind == "init" else LOOP
    style = STYLES[(d + len(kind)) % 3]
    _, st, draws = state(style, d, phase, kind, seed=d * 7 + len(kind))
    want = chain(st, draws)
    gst = SimplexState(*(t.to(card) if isinstance(t, torch.Tensor) else t
                         for t in st))
    gdraws = draws.to(card)
    native.reset_launches()
    got = simplex_ops.simplex_propose(gst.pts_u, gst.vals, gdraws,
                                      gst.phase, *COEFFS)
    torch.cuda.synchronize()
    assert native.SIMPLEX.launches == 1
    assert_bitwise(got, want)
    if kind != "signs":
        assert_bitwise(got, chain(gst, gdraws))


@pytest.mark.card
def test_one_launch_for_a_vmapped_proposal(card):
    """N 4 at D 328 under vmap: one launch, each instance its own
    single call's outputs bitwise."""
    pts, vals, draws, phase, parts = four_states(328)
    args = [t.to(card) for t in (pts, vals, draws, phase)]
    native.reset_launches()
    prev = torch._C._functorch._is_vmap_fallback_enabled()
    torch._C._functorch._set_vmap_fallback_enabled(False)
    try:
        got = torch.func.vmap(lambda *a: simplex_ops.simplex_propose(
            *a, *COEFFS))(*args)
    finally:
        torch._C._functorch._set_vmap_fallback_enabled(prev)
    torch.cuda.synchronize()
    assert native.SIMPLEX.launches == 1
    for i, (_, st, dr) in enumerate(parts):
        assert_bitwise([o[i] for o in got], chain(st, dr))


def gcc_engine(device) -> FusedEngine:
    space = program_space(json.loads(GCC_CONFIG.read_text())["space"])
    return FusedEngine(space, None, arms=default_arms(1),
                       history_capacity=1 << 12, device=device)


def row_sum(cands):
    return cands.u.sum(-1)


ENGINES = {"flagship-s64": lambda d: flagship(64, device=d),
           "gcc-options-g12": gcc_engine}


@pytest.mark.card
@pytest.mark.parametrize("name", sorted(ENGINES))
def test_fused_proposals_equal_the_chain_eager_and_replayed(
        card, name, monkeypatch):
    """The fused engine's proposal in LOOP: the eager one and graph
    "propose"'s replay equal each other and the proposal with the chain
    in place of the kernel, bitwise; one launch each."""
    eng = ENGINES[name](card)
    ev = None if name == "flagship-s64" else row_sum
    st = eng.init(seed=31)
    for _ in range(4):
        st = eng.step(st, eval_fn=ev)
    nm = next(i for i, t in enumerate(eng.arms) if isinstance(t, NelderMead))
    assert int(st.tstates[nm].phase) == LOOP
    assert eng._graph_propose(st) is not None      # captured, if not yet
    native.reset_launches()
    eager = eng.propose(st)
    assert native.SIMPLEX.launches == 1
    replayed = eng._graph_propose(st)
    torch.cuda.synchronize()
    assert native.SIMPLEX.launches == 2
    on_card_chain(monkeypatch)
    plain = eng.propose(st)
    assert native.SIMPLEX.launches == 2
    assert_bitwise(leaves(eager), leaves(plain))
    assert_bitwise(leaves(replayed), leaves(plain))


@pytest.mark.card
def test_batched_proposals_equal_the_chain_eager_and_replayed(
        card, monkeypatch):
    """`BatchedEngine.propose_all` over 4 gcc-options instances: one
    launch for all of them, eager and from a captured graph, bitwise the
    proposal with the chain in place of the kernel."""
    be = BatchedEngine(gcc_engine(card), 4)
    st = be.run(be.init(seed=32), 3, eval_fn=row_sum)
    native.reset_launches()
    eager = be.propose_all(st)
    torch.cuda.synchronize()
    assert native.SIMPLEX.launches == 1
    # the phase's eager warm-up counts one launch, its capture none
    ph = graphs.Phase(be._propose_all, (st,),
                      torch.device("cuda", torch.cuda.current_device()))
    assert ph.counts[native.SIMPLEX, "launches", None] == 1
    assert native.SIMPLEX.launches == 2
    ph.replay()
    torch.cuda.synchronize()
    assert native.SIMPLEX.launches == 3
    on_card_chain(monkeypatch)
    plain = be.propose_all(st)
    assert native.SIMPLEX.launches == 3
    assert_bitwise(leaves(eager), leaves(plain))
    assert_bitwise(leaves(ph.static), leaves(plain))
