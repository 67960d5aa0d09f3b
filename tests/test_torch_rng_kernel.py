"""The draws' counter hash as one kernel (`csrc/rng.cu`, `native.RNG`)
and the custom ops that route to it (`rng.py`).

On the CPU: a numpy model of the kernel's arithmetic (wrapping uint32)
equals `rng._hash` at the edges of its inputs; the custom ops on CPU
keys equal the torch ops for one key and a stack of keys, in both modes
(a split's whole words, a stream's block); vmap over stacked keys calls
the op once and equals the per-key calls; a stream's draws do not
depend on its block size.  The cases marked `card` hold the kernel
bitwise against the torch ops and count its launches across graph
replays; they skip without an NVIDIA card.  Run them on a card with

    python -m pytest tests/test_torch_rng_kernel.py --noconftest -q
"""
import numpy as np
import pytest
import torch

from uptune_tpu_torch import native, rng

CPU = torch.device("cpu")
MODES = ("split", "draw")
EDGE_WORDS = (0, 1, 0x7FFFFFFF, 0x80000000, 0xFFFFFFFF)


def model_hash(k0: int, k1: int, domain: int, start: int,
               count: int) -> np.ndarray:
    """The kernel's arithmetic in numpy: uint32 words, wrapping sums and
    products, the counter cut to its low 32 bits."""
    with np.errstate(over="ignore"):
        j = (np.arange(count, dtype=np.uint64) + np.uint64(start)).astype(
            np.uint32)
        x = j * np.uint32(rng._STEP) + np.uint32(k0) + np.uint32(domain)
        x = mix(x) ^ np.uint32(k1)
        return mix(x)


def mix(x: np.ndarray) -> np.ndarray:
    x = x ^ (x >> np.uint32(16))
    x = x * np.uint32(rng._M1)
    x = x ^ (x >> np.uint32(15))
    x = x * np.uint32(rng._M2)
    return x ^ (x >> np.uint32(16))


def the_key(k0: int, k1: int, device=CPU) -> torch.Tensor:
    return torch.tensor([k0, k1], dtype=torch.int64, device=device)


def stacked_keys(n: int, device=CPU) -> torch.Tensor:
    return rng.split(rng.key(2026, device), n)


def through_op(key: torch.Tensor, mode: str, start: int, count: int):
    """The custom op of `mode` on `key`: (words,) or (words, uniforms)."""
    if mode == "split":
        return (torch.ops.uptune_tpu_torch.rng_hash(key, rng._SPLIT, start,
                                                    count),)
    return tuple(torch.ops.uptune_tpu_torch.rng_block(key, start, count))


def through_torch(key: torch.Tensor, mode: str, start: int, count: int):
    """The torch ops of `mode` (the plain version), on the key's device."""
    if mode == "split":
        return (rng._hash_torch(key, rng._SPLIT, start, count),)
    return rng._block_torch(key, start, count)


def assert_bitwise(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape
        assert g.device == w.device
        assert torch.equal(g.cpu().view(torch.int32 if g.dtype ==
                                        torch.float32 else g.dtype),
                           w.cpu().view(torch.int32 if w.dtype ==
                                        torch.float32 else w.dtype))


# -- the kernel's arithmetic ---------------------------------------------------
@pytest.mark.parametrize("k0", EDGE_WORDS)
@pytest.mark.parametrize("k1", (0, 0x9E3779B9, 0xFFFFFFFF))
@pytest.mark.parametrize("domain", (rng._DRAW, rng._SPLIT))
@pytest.mark.parametrize("start,count", [
    (0, 40), (3, 17), (2**31 - 20, 40), (2**32 - 20, 40),
    (2**32 + 5, 9), (3 * 2**32 - 1, 3)])
def test_the_uint32_model_equals_the_int64_hash(k0, k1, domain, start,
                                                 count):
    """Across 2^31 and 2^32 in the counter, at key words 0 and 2^32 - 1,
    in both domains: wrapping uint32 arithmetic gives rng's words."""
    got = rng._hash_torch(the_key(k0, k1), domain, start, count)
    want = model_hash(k0, k1, domain, start, count)
    assert got.dtype == torch.int64
    assert bool((got >= 0).all()) and bool((got < 2**32).all())
    np.testing.assert_array_equal(got.numpy(), want.astype(np.int64))


def test_the_model_equals_a_stream_and_a_split():
    """The 24-bit words and uniforms of a stream, and a split's keys, are
    the model's words cut and scaled."""
    k0, k1 = (int(w) for w in rng.key(7, CPU))
    g = rng.Stream(the_key(k0, k1), hint=64)
    words = model_hash(k0, k1, rng._DRAW, 0, 100).astype(np.int64) >> 8
    np.testing.assert_array_equal(
        rng.randint(g, (60,), 0, 1 << 24).numpy(), words[:60])
    np.testing.assert_array_equal(
        rng.uniform(g, (40,)).numpy(),
        words[60:].astype(np.float32) * np.float32(2.0 ** -24))
    np.testing.assert_array_equal(
        rng.split(the_key(k0, k1), 3).reshape(-1).numpy(),
        model_hash(k0, k1, rng._SPLIT, 0, 6).astype(np.int64))


# -- the custom ops on the CPU -------------------------------------------------
@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("lead", [(), (4,)])
@pytest.mark.parametrize("count", [1, 4, 182, 100_003])
def test_the_op_on_cpu_keys_is_the_torch_path(mode, lead, count):
    key = stacked_keys(4)[0] if lead == () else stacked_keys(4)
    native.reset_launches()
    for start in (0, 13):
        got = through_op(key, mode, start, count)
        assert_bitwise(got, through_torch(key, mode, start, count))
        assert got[0].shape == lead + (count,)
    assert native.RNG.launches == 0 and native.RNG.elements == 0


@pytest.mark.parametrize("mode", MODES)
def test_vmap_over_stacked_keys_equals_per_key_calls(mode):
    """Under torch.func.vmap (its per-instance fallback off, as the
    batched engine runs it) a stacked key goes through the op once."""
    keys = stacked_keys(5)

    def one(k):
        return through_op(k, mode, 7, 182)
    prev = torch._C._functorch._is_vmap_fallback_enabled()
    torch._C._functorch._set_vmap_fallback_enabled(False)
    try:
        got = torch.func.vmap(one)(keys)
        moved = torch.func.vmap(one, in_dims=1)(keys.T.contiguous())
    finally:
        torch._C._functorch._set_vmap_fallback_enabled(prev)
    want = [torch.stack(w) for w in zip(*(one(k) for k in keys))]
    assert_bitwise(got, want)
    assert_bitwise(moved, want)


def test_vmap_over_a_stream_equals_per_key_streams():
    keys = stacked_keys(3)

    def draws(k):
        g = rng.Stream(k, hint=50)
        return (rng.uniform(g, (3, 5)), rng.randint(g, (7,), 2, 9),
                rng.normal(g, (4,)), rng.split(k, 2))
    got = torch.func.vmap(draws)(keys)
    want = [torch.stack(w) for w in zip(*(draws(k) for k in keys))]
    assert_bitwise(got, want)


@pytest.mark.parametrize("hint", [0, 1, 7, 64, 1000])
def test_a_streams_draws_do_not_depend_on_its_block_size(hint):
    key = rng.key(31, CPU)

    def draws(g):
        return (rng.uniform(g, (3, 5)), rng.randint(g, (70,), -4, 9),
                rng.normal(g, (4,)), rng.permutations(g, 2, 6),
                rng.choice_without_replacement(g, 5, 10, 3),
                rng.uniform(g, (0,)), rng.uniform(g, (129,)))
    assert_bitwise(draws(rng.Stream(key, hint)), draws(rng.Stream(key)))


def test_the_kernel_wrapper_refuses_what_it_cannot_take():
    with pytest.raises(ValueError, match="needs a CUDA key"):
        rng._block_cuda(rng.key(1, CPU), rng._DRAW, 0, 4, True)
    with pytest.raises(ValueError, match="needs a CUDA key"):
        rng._block_cuda(rng.key(1, CPU), rng._SPLIT, 0, 4, False)


# -- on the card -----------------------------------------------------------------
@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the rng kernel runs only there")
    native.reset_launches()
    return torch.device("cuda")


@pytest.mark.card
@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("rows", [None, 1, 4, 3])
@pytest.mark.parametrize("count", [1, 3, 4, 5, 182, 100_003])
def test_the_kernel_equals_the_torch_path(card, mode, rows, count):
    """Bitwise, for one key and stacks of keys (a vector running on into
    the next key row where count is not a multiple of 4), from counters
    near 2^32."""
    key = (stacked_keys(4, card)[0] if rows is None
           else stacked_keys(rows, card))
    native.reset_launches()
    for start in (0, 5, 2**32 - 2):
        got = through_op(key, mode, start, count)
        torch.cuda.synchronize()
        assert_bitwise(got, through_torch(key, mode, start, count))
    n = 1 if rows is None else rows
    assert native.RNG.launches == 3
    assert native.RNG.elements == 3 * n * count


@pytest.mark.card
def test_the_kernel_under_vmap_is_one_launch(card):
    keys = stacked_keys(6, card)
    native.reset_launches()
    got = torch.func.vmap(lambda k: through_op(k, "draw", 0, 999))(keys)
    assert native.RNG.launches == 1
    assert_bitwise(got, through_torch(keys, "draw", 0, 999))


@pytest.mark.card
def test_a_card_stream_equals_a_cpu_stream(card):
    def draws(g):
        return (rng.uniform(g, (3, 5)), rng.randint(g, (70,), -4, 9),
                rng.permutations(g, 2, 6),
                rng.choice_without_replacement(g, 5, 10, 3))
    on_card = draws(rng.Stream(rng.key(5, card), 40))
    assert_bitwise([t.cpu() for t in on_card],
                   draws(rng.Stream(rng.key(5, CPU), 40)))
    assert native.RNG.launches >= 1


@pytest.mark.card
def test_graph_replays_count_the_kernels_launches_and_elements(card):
    from uptune_tpu_torch.engine import graphs
    key = rng.key(3, card)
    native.reset_launches()

    def fn(k):
        g = rng.Stream(k)
        return rng.uniform(g, (1000,)), rng.split(k, 2)
    phase = graphs.Phase(fn, (key,), key.device)      # cuda:0
    assert (native.RNG.launches, native.RNG.elements) == (2, 1004)
    phase.replay()
    phase.replay()
    torch.cuda.synchronize()
    assert (native.RNG.launches, native.RNG.elements) == (6, 3012)
    assert_bitwise(phase.fresh(), [t for t in fn(key)])
