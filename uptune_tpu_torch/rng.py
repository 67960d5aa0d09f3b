"""Draw helpers: every random number the port uses comes from here.

The JAX package threads `jax.random` keys; so does the port, with its own
counter-based generator (a hash of a counter).  A key is a [2]
int64 tensor holding two 32-bit words.  Element j of the stream of a key
is a hash of (key, j), so a draw is a function of the key alone: the
state that carries a key is a value (drawing twice from one state gives
the same numbers), and under `torch.func.vmap` a stacked [N, 2] key
draws for all N instances in the same launches as one key does.

* `key(seed)` makes a key from an integer; `split(key, n)` derives n
  independent keys ([n, 2]) in one hash pass.
* `Stream(key)` hands out consecutive elements of the key's stream
  (`hinted` makes one sized by what a draw phase took last time); the
  draw helpers below (`uniform`, `normal`, `randint`, `permutations`,
  `choice_without_replacement`) take a stream and consume from it in
  call order.  A stream hashes a block of elements at a time (`hint`
  elements, or as many as a request needs); what it draws does not
  depend on the block size.

The hash mixes 32-bit words held in int64 with multipliers below 2^31,
so no product overflows.  On the CPU it runs as those torch ops
(`_hash_torch`); on the card a block of it is one launch of the
hand-written kernel `csrc/rng.cu` (`native.RNG`), which does the same
arithmetic in wrapping uint32 and gives the same words bit for bit.  The
custom ops `uptune_tpu_torch::rng_hash` (whole words: `_hash`, so
`split`) and `uptune_tpu_torch::rng_block` (a stream's block of 24-bit
words and their uniforms) route by the key's device, with no mode knob:
CPU keys take the torch ops, CUDA keys launch the kernel or raise.  Their
vmap rules put a stacked key's instance axis in front and call the op
once, so a batched engine draws for all its instances in one launch.

A uniform is the top 24 bits of a word times 2^-24 (exact in float32),
an integer in [lo, hi) is lo + (those 24 bits times (hi - lo)) >> 24, a
normal comes from two uniforms by Box-Muller.  Uniforms and integers
are the same on the CPU and on the card; a normal goes through log and
cos and may differ in the last place.

Each stochastic op of the port is split into a draw step built from these
helpers and a pure function of the draws; the parity tests feed the pure
part the numbers `jax.random` drew, which this generator does not
reproduce.
"""
from __future__ import annotations

import math
from typing import Optional, Sequence

import torch

from . import native

_MASK = 0xFFFFFFFF
# odd multipliers below 2^31: a 32-bit word times one fits in int64
_M1, _M2 = 0x7FEB352D, 0x5BD1E995
_STEP = 0x61C88647                  # 2^32 / golden ratio, rounded, odd
# the two uses of a key's hash: its stream of draws, and the keys split
# off it
_DRAW, _SPLIT = 0x2545F491, 0x3C6EF372


def _mix(x):
    """A bijection of 32-bit words (ints or int64 tensors in [0, 2^32))."""
    x = x ^ (x >> 16)
    x = (x * _M1) & _MASK
    x = x ^ (x >> 15)
    x = (x * _M2) & _MASK
    return x ^ (x >> 16)


def _hash_torch(key: torch.Tensor, domain: int, start: int,
                count: int) -> torch.Tensor:
    """`_hash` as torch ops: the plain version of the kernel, which the
    CPU runs."""
    j = torch.arange(start, start + count, dtype=torch.int64,
                     device=key.device)
    x = _mix((j * _STEP + key[..., :1] + domain) & _MASK)
    return _mix(x ^ key[..., 1:])


def _block_torch(key: torch.Tensor, start: int, count: int):
    """`Stream`'s block as torch ops: (24-bit words, uniforms)."""
    words = _hash_torch(key, _DRAW, start, count) >> 8
    return words, words.to(torch.float32) * 2.0 ** -24


def _block_cuda(key: torch.Tensor, domain: int, start: int, count: int,
                draw: bool):
    """Launch the kernel (`csrc/rng.cu`) on a CUDA key [..., 2], on the
    current stream: one launch for every key row (none for an empty
    block), counted once, with its elements.  Returns (the [..., count]
    int64 words, the uniforms or None): with `draw`, the 24-bit words of
    the `_DRAW` sequence and their uniforms; otherwise the whole words of
    the `domain` sequence.  Checks the key and raises if the launch
    fails."""
    dev = key.device
    if dev.type != "cuda":
        raise ValueError(f"rng's kernel needs a CUDA key, got {dev}")
    if key.dtype != torch.int64 or key.dim() == 0 or key.shape[-1] != 2:
        raise ValueError(f"a key is [..., 2] int64, got {key.dtype} "
                         f"{tuple(key.shape)}")
    if count < 0 or start < 0:
        raise ValueError(f"elements {start} + {count} of a stream")
    lead = tuple(key.shape[:-1])
    rows = math.prod(lead)
    keys = key.contiguous()
    words = torch.empty(lead + (count,), dtype=torch.int64, device=dev)
    floats = (torch.empty(lead + (count,), dtype=torch.float32, device=dev)
              if draw else None)
    if rows * count:
        native.RNG.launch(dev, keys, words, floats, rows, count, start & _MASK,
                          domain, elements=rows * count)
    return words, floats


def _hash_impl(key, domain, start, count):
    if key.device.type == "cpu":
        return _hash_torch(key, domain, start, count)
    return _block_cuda(key, domain, start, count, False)[0]


def _block_impl(key, start, count):
    if key.device.type == "cpu":
        return _block_torch(key, start, count)
    return _block_cuda(key, _DRAW, start, count, True)


_hash_op = torch.library.custom_op(
    "uptune_tpu_torch::rng_hash", _hash_impl, mutates_args=(),
    schema="(Tensor key, int domain, int start, int count) -> Tensor")
_block_op = torch.library.custom_op(
    "uptune_tpu_torch::rng_block", _block_impl, mutates_args=(),
    schema="(Tensor key, int start, int count) -> (Tensor, Tensor)")


def _hash_vmap(info, in_dims, key, domain, start, count):
    """vmap over `_hash`: the stacked key's instance axis goes in front
    and the op runs once."""
    return _hash_op(key.movedim(in_dims[0], 0), domain, start, count), 0


def _block_vmap(info, in_dims, key, start, count):
    return _block_op(key.movedim(in_dims[0], 0), start, count), (0, 0)


_hash_op.register_vmap(_hash_vmap)
_block_op.register_vmap(_block_vmap)


def _hash(key: torch.Tensor, domain: int, start: int,
          count: int) -> torch.Tensor:
    """[..., count] int64 words: elements start .. start + count - 1 of
    the key's `domain` sequence.  Distinct elements of one sequence give
    distinct words.  Torch ops for a CPU key, one kernel launch for a
    CUDA key (the module's docstring)."""
    return _hash_op(key, domain, start, count)


def key(seed: int, device) -> torch.Tensor:
    """The [2] int64 key of an integer seed (any size; the low 64 bits
    count)."""
    s = int(seed) & ((1 << 64) - 1)
    k0 = _mix(_mix(s & _MASK) ^ 0x6A09E667)
    k1 = _mix(_mix((s >> 32) ^ k0) ^ 0x3C6EF372)
    return torch.tensor([k0, k1], dtype=torch.int64, device=device)


def split(key: torch.Tensor, n: int) -> torch.Tensor:
    """[..., n, 2]: n keys derived from `key`, independent of each other,
    of the key's own stream and of every key split off them."""
    words = _hash(key, _SPLIT, 0, 2 * n)
    return words.reshape(words.shape[:-1] + (n, 2))


class Stream:
    """Consecutive elements of one key's stream.  A plain Python object
    made afresh for each draw step (never stored in a state): the key is
    the state, the stream only counts what the step has used."""

    def __init__(self, key: torch.Tensor, hint: int = 0):
        self.key = key
        self.device = key.device
        self.used = 0               # elements handed out so far
        self._hint = int(hint)
        self._start = 0             # the block's first element
        self._words: Optional[torch.Tensor] = None   # [..., len] 24 bits
        self._floats: Optional[torch.Tensor] = None  # the same, as U[0, 1)

    def _take(self, n: int):
        """(24-bit words, uniforms) [..., n] for the next n elements."""
        end = self._start + (0 if self._words is None
                             else self._words.shape[-1])
        if self._words is None or self.used + n > end:
            size = max(n, self._hint - self.used)
            self._words, self._floats = _block_op(self.key, self.used, size)
            self._start = self.used
        a = self.used - self._start
        self.used += n
        return self._words[..., a:a + n], self._floats[..., a:a + n]


def hinted(key: torch.Tensor, hints: dict, phase, draw):
    """draw(stream) on a stream of `key` that hashes at once as many
    elements as `phase` took last time (`hints`, updated here); what it
    draws does not depend on that."""
    gen = Stream(key, hints.get(phase, 0))
    out = draw(gen)
    hints[phase] = gen.used
    return out


def generator(seed: int, device) -> Stream:
    """A stream of the key of an integer seed (for one-off draws outside
    an engine state)."""
    return Stream(key(seed, device))


def _shaped(x: torch.Tensor, shape: Sequence[int]) -> torch.Tensor:
    return x.reshape(x.shape[:-1] + tuple(shape))


def uniform(gen: Stream, shape: Sequence[int]) -> torch.Tensor:
    """U[0, 1) float32, multiples of 2^-24."""
    return _shaped(gen._take(math.prod(shape))[1], shape)


def normal(gen: Stream, shape: Sequence[int]) -> torch.Tensor:
    """Standard normal float32 (Box-Muller on two uniforms each)."""
    n = math.prod(shape)
    u = gen._take(2 * n)[1]
    r = torch.sqrt(-2.0 * torch.log1p(-u[..., :n]))
    return _shaped(r * torch.cos((2.0 * math.pi) * u[..., n:]), shape)


def randint(gen: Stream, shape: Sequence[int], lo: int,
            hi: int) -> torch.Tensor:
    """Integers in [lo, hi), int64."""
    w = gen._take(math.prod(shape))[0]
    return _shaped(((w * (int(hi) - int(lo))) >> 24) + int(lo), shape)


def permutations(gen: Stream, rows: int, n: int) -> torch.Tensor:
    """[rows, n] int64: an independent uniform permutation of range(n)
    per row (stable argsort of i.i.d. uniform keys, so equal keys keep
    index order and the result is the same on every device)."""
    return torch.argsort(uniform(gen, (rows, n)), dim=-1, stable=True)


def choice_without_replacement(gen: Stream, rows: int, n_pool: int,
                               k: int) -> torch.Tensor:
    """[rows, k] int64: k distinct picks from range(n_pool) per row, in
    draw order.  Pick j is uniform over the n_pool - j values not yet
    picked: an integer below n_pool - j, moved past each earlier pick it
    reaches (in ascending order)."""
    picks = []
    for j in range(k):
        r = randint(gen, (rows,), 0, n_pool - j)
        if picks:
            prev = torch.sort(torch.stack(picks, dim=-1), dim=-1).values
            for c in range(j):
                r = r + (r >= prev[..., c]).to(torch.int64)
        picks.append(r)
    return torch.stack(picks, dim=-1)
