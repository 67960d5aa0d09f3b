"""The GP's query features in one kernel (`csrc/features.cu`,
`native.FEATURES`) and the entry that routes to it,
`Space.surrogate_features` (`ops/features.py`).

On the CPU: the entry is `surrogate_transform(features(cands))` bitwise
and launches nothing; a numpy model of the kernel's slots and column
table (`Space.feature_tables`) rebuilds the chain's features bitwise, so
the tables place every column, perm position and one-hot code where the
chain does; the kernel's constants are spec.py's as float32; the custom
op's vmap rule stacks the instances into one call; the wrapper refuses a
CPU batch; the kernel's name keeps clear of the patterns that select C's
and D's kernels for their rooflines.  The cases marked `card` hold the
kernel bitwise against the chain on the card, count its launches and
rows, and read its name from the profiler; they skip without an NVIDIA
card.  Run them on a card with

    python -m pytest tests/test_torch_surrogate_features.py --noconftest -q
"""
import json
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from portbench.drivers.common import program_space
from uptune_tpu_torch import native, rng
from uptune_tpu_torch.flagship import flagship_space
from uptune_tpu_torch.ops import features as feature_ops
from uptune_tpu_torch.space import params as P
from uptune_tpu_torch.space import spec
from uptune_tpu_torch.space.spec import CandBatch, Space

REPO = Path(__file__).resolve().parents[1]
CPU = torch.device("cpu")
GCC_CONFIG = REPO / "portbench" / "configs" / "gcc-options-g12.json"
ROOFLINE = REPO / "portbench" / "metrics" / "acquire_scores_roofline.py"
CARD_BATCHES = (1, 7, 6040, 6352, 24_160)
CPU_BATCHES = (1, 7, 300)


def mixed_space() -> Space:
    """Every scalar kind (a selector too) and two perm blocks, one a
    schedule with dependencies."""
    return Space([
        P.FloatParam("f", -5.0, 5.0), P.IntParam("i", -3, 40),
        P.LogFloatParam("lf", 0.5, 300.0), P.LogIntParam("li", 1, 4096),
        P.Pow2Param("p2", 1, 1024), P.BoolParam("b"),
        P.SwitchParam("sw", 5), P.EnumParam("e", ("a", "b", "c")),
        P.SelectorParam("sel", ("x", "y", "z"), 10),
        P.PermParam("tour", tuple(range(7))),
        P.ScheduleParam("sched", ("a", "b", "c", "d", "e"),
                        deps=(("b", ("a",)), ("d", ("b", "c"))))])


def many_perms_space() -> Space:
    """Nine perm blocks, of 2 to 10 items, side by side in the kernel's
    one perm tensor."""
    return Space([P.IntParam("i", 0, 9), P.EnumParam("e", ("a", "b"))]
                 + [P.PermParam(f"p{k}", tuple(range(k + 2)))
                    for k in range(9)])


def gcc_space() -> Space:
    return program_space(json.loads(GCC_CONFIG.read_text())["space"])


SPACES = {"gcc-options-g12": gcc_space, "flagship-s64": flagship_space,
          "mixed": mixed_space, "many_perms": many_perms_space}


def edge_units(space: Space) -> list:
    """Per lane, unit values at its edges: 0, 1, -0.0, and on and one
    float32 step either side of the .5 rounding boundaries of an int,
    log-int, pow2 or code lane (a few of them for a wide lane)."""
    out = []
    for lane in range(space.n_scalar):
        kind = int(space.kind_np[lane])
        slo, shi = float(space.slo_np[lane]), float(space.shi_np[lane])
        vlo, vhi = float(space.vlo_np[lane]), float(space.vhi_np[lane])
        vals = [0.0, 1.0, -0.0, 0.5]
        if kind != P.FLOAT and kind != P.LOG_FLOAT:
            ks = sorted({vlo, vlo + 1, (vlo + vhi) // 2, vhi - 1, vhi})
            for k in ks:
                v = k + 0.5
                s = np.log2(v - vlo + 1.0) if kind == P.LOG_INT else v
                u = np.float32((s - slo) / (shi - slo))
                vals += [float(u), float(np.nextafter(u, np.float32(2))),
                         float(np.nextafter(u, np.float32(-1)))]
        out.append([v for v in vals if -0.0 <= v <= 1.0])
    return out


def batch(space: Space, b: int, seed: int, device=CPU) -> CandBatch:
    """b rows: uniform lanes, the first rows on each lane's edge values
    in turn; perms from the space's own draws (valid, normalized)."""
    r = np.random.RandomState(seed)
    u = r.uniform(size=(b, space.n_scalar)).astype(np.float32)
    for lane, vals in enumerate(edge_units(space)):
        rows = np.arange(min(b, 3 * len(vals)))
        u[rows, lane] = np.asarray(vals, np.float32)[
            (rows + lane) % len(vals)]
    perms = space.random(rng.generator(seed, device), b).perms
    return CandBatch(torch.from_numpy(u).to(device), perms)


def bits(t: torch.Tensor) -> np.ndarray:
    return t.detach().cpu().contiguous().view(torch.int32).numpy()


def chain(space: Space, cands: CandBatch) -> torch.Tensor:
    return space.surrogate_transform(space.features(cands))


def model(space: Space, cands: CandBatch) -> np.ndarray:
    """The kernel's algorithm in numpy over the Space's tables: a row's
    slots are its lanes (the chain's code for a categorical lane, its
    snapped unit value otherwise), then each perm item's position, put at
    its rank within its block (`items_of`); each output column copies a
    slot or compares it with its code (`cols`).  The positions divide as
    the CPU's torch ops do (the card multiplies by the reciprocal, as
    PyTorch's CUDA division by a host scalar does)."""
    ft = space.feature_tables(CPU)
    vals = space.decode_scalars(cands.u)
    cat = torch.as_tensor(space.kind_np >= P.BOOL)
    lanes = torch.where(cat, vals, space.encode_scalars(vals)).numpy()
    b = cands.batch
    perm = np.concatenate([p.numpy() for p in cands.perms]
                          or [np.zeros((b, 0), np.int64)], axis=1)
    items_of = ft.items_of.numpy()
    pos = np.zeros((b, len(items_of)), np.float32)
    for q, (start, size) in enumerate(items_of):
        block = perm[:, start:start + size]
        j = q - start
        x = block[:, j:j + 1]
        rank = ((block < x) | ((block == x) & (np.arange(size) < j))).sum(1)
        pos[np.arange(b), start + rank] = np.float32(j) / np.float32(
            max(1, size - 1))
    slots = np.concatenate([lanes, pos], axis=1)
    slot, code = ft.cols.numpy().T
    out = slots[:, slot]
    hot = code >= 0
    out[:, hot] = np.where(out[:, hot] == code[hot].astype(np.float32),
                           np.float32(spec._ONE_HOT), np.float32(0.0))
    return out


# -- on the CPU ---------------------------------------------------------------
@pytest.mark.parametrize("name", SPACES)
@pytest.mark.parametrize("b", CPU_BATCHES)
def test_the_entry_on_the_cpu_is_the_chain(name, b):
    space = SPACES[name]()
    cands = batch(space, b, seed=b)
    before = native.counts()
    got = space.surrogate_features(cands)
    assert got.shape == (b, space.n_surrogate_features)
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(bits(got), bits(chain(space, cands)))
    assert native.counts() == before


@pytest.mark.parametrize("name", SPACES)
def test_the_kernels_tables_rebuild_the_chain(name):
    """The model over the tables equals the chain bitwise, edge rows
    included; the tables' shapes are the space's widths."""
    space = SPACES[name]()
    ft = space.feature_tables(CPU)
    p = sum(space.perm_sizes)
    assert ft.cols.shape == (space.n_surrogate_features, 2)
    assert ft.items_of.shape == (p, 2)
    assert ft.lanes.shape == (space.n_scalar, 4)
    assert ft.kind.dtype == ft.cols.dtype == ft.items_of.dtype == torch.int32
    assert space.feature_tables(CPU) is ft
    cands = batch(space, 300, seed=11)
    np.testing.assert_array_equal(model(space, cands).view(np.int32),
                                  bits(chain(space, cands)))


def test_the_constants_are_the_chains_as_float32():
    """features.cu's float constants, each a hex literal beside the
    spec.py name it rounds, are those values as float32."""
    src = native.FEATURES.source.read_text()
    found = re.findall(r"constexpr float k\w+ = (-?0x[0-9a-f.p+-]+)f;"
                       r"\s*// (_[A-Z0-9_]+)", src)
    assert [name for _, name in found] == [
        "_LN2", "_INV_LN2", "_LOG_FLOOR", "_MIN_RANGE", "_ONE_HOT"]
    for lit, name in found:
        want = np.float32(getattr(spec, name))
        assert float.fromhex(lit) == float(want), (name, lit, want)


def test_vmap_stacks_the_instances_into_one_call(monkeypatch):
    """Under vmap the op's rule calls the kernel's wrapper once on every
    instance's rows (a stand-in here: the chain), and each instance gets
    its own rows' features; a perm block without the instance axis is
    shared."""
    space = mixed_space()
    parts = [batch(space, 9, seed=s) for s in range(4)]
    u = torch.stack([c.u for c in parts])
    perms = [torch.stack(ps) for ps in zip(*[c.perms for c in parts])]
    calls = []

    def stand_in(u, perm, *tables):
        calls.append(u.shape[0])
        return chain(space, CandBatch(u, torch.split(perm, space.perm_sizes,
                                                     dim=-1)))
    monkeypatch.setattr(feature_ops, "features_cuda", stand_in)
    tables = space.feature_tables(CPU)
    prev = torch._C._functorch._is_vmap_fallback_enabled()
    torch._C._functorch._set_vmap_fallback_enabled(False)
    try:
        got = torch.func.vmap(lambda a, b, c: feature_ops.surrogate_features(
            a, [b, c], tables))(u, *perms)
        shared = torch.func.vmap(lambda a, b: feature_ops.surrogate_features(
            a, [b, perms[1][0]], tables), in_dims=(1, 0))(
                u.transpose(0, 1), perms[0])
    finally:
        torch._C._functorch._set_vmap_fallback_enabled(prev)
    assert calls == [36, 36]
    want = torch.stack([chain(space, c) for c in parts])
    np.testing.assert_array_equal(bits(got), bits(want))
    want = torch.stack([chain(space, CandBatch(
        c.u, (c.perms[0], parts[0].perms[1]))) for c in parts])
    np.testing.assert_array_equal(bits(shared), bits(want))


def test_the_wrapper_refuses_a_cpu_batch():
    space = flagship_space()
    cands = batch(space, 4, seed=0)
    with pytest.raises(ValueError, match="needs a CUDA batch"):
        feature_ops.features_cuda(cands.u, cands.perms[0],
                                  *space.feature_tables(CPU))


def gp_tile_pattern() -> str:
    """The pattern by which the benchmark picks C's and D's kernels."""
    found = re.search(r"GP_TILE = \((.*?)\)\n", ROOFLINE.read_text(), re.S)
    return "".join(re.findall(r'r?"([^"]*)"', found.group(1)))


def roofline_matches(names) -> list:
    pattern = gp_tile_pattern()
    return [n for n in names
            if re.search(pattern, n) or "merge_rows_kernel" in n]


def test_the_kernels_name_keeps_clear_of_c_and_ds_rooflines():
    """No kernel of features.cu matches the pattern that selects C's and
    D's kernels, nor the merge's name, so their rooflines stay theirs."""
    pattern = gp_tile_pattern()
    assert "krows_mma_kernel" in pattern and "kinv_prep_kernel" in pattern
    src = native.FEATURES.source.read_text()
    kernels = re.findall(r"__global__ void (?:__launch_bounds__\(\w+\) )?"
                         r"(\w+)\(", src)
    assert kernels == ["surrogate_feats_kernel"]
    assert not roofline_matches(kernels)
    assert roofline_matches(["krows_mma_kernel",
                                         "merge_rows_kernel<128>"])


# -- on the card --------------------------------------------------------------
@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the features kernel runs only "
                    "there")
    native.reset_launches()
    return torch.device("cuda")


@pytest.mark.card
@pytest.mark.parametrize("name", SPACES)
@pytest.mark.parametrize("b", CARD_BATCHES)
def test_the_kernel_equals_the_chain_on_the_card(card, name, b):
    """Bitwise, edge rows included; one launch, counting its rows."""
    space = SPACES[name]()
    cands = batch(space, b, seed=b + 1, device=card)
    want = chain(space, cands)
    native.reset_launches()
    got = space.surrogate_features(cands)
    torch.cuda.synchronize()
    assert (native.FEATURES.launches, native.FEATURES.elements) == (1, b)
    np.testing.assert_array_equal(bits(got), bits(want))


@pytest.mark.card
def test_the_kernel_under_vmap_is_one_launch(card):
    space = flagship_space()
    parts = [batch(space, 6040, seed=s, device=card) for s in range(4)]
    u = torch.stack([c.u for c in parts])
    perms = torch.stack([c.perms[0] for c in parts])
    native.reset_launches()
    got = torch.func.vmap(lambda a, p: space.surrogate_features(
        CandBatch(a, (p,))))(u, perms)
    torch.cuda.synchronize()
    assert (native.FEATURES.launches, native.FEATURES.elements) == (
        1, 4 * 6040)
    want = torch.stack([chain(space, c) for c in parts])
    np.testing.assert_array_equal(bits(got), bits(want))


@pytest.mark.card
def test_the_profiler_names_the_kernel_clear_of_the_rooflines(card):
    space = gcc_space()
    cands = batch(space, 64, seed=3, device=card)
    space.surrogate_features(cands)
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        space.surrogate_features(cands)
        torch.cuda.synchronize()
    names = {e.name for e in prof.events()
             if "surrogate_feats_kernel" in e.name}
    assert names
    assert not roofline_matches(names)
