"""Draw helpers: every random number the port uses comes from here.

The JAX package threads `jax.random` keys; the port threads one
`torch.Generator` (seeded from an integer) and draws on the generator's
device.  Each stochastic op of the port is split into a draw step built
from these helpers and a pure function of the draws; the parity tests
feed the pure part the numbers `jax.random` drew, which a
`torch.Generator` cannot reproduce.
"""
from __future__ import annotations

from typing import Sequence

import torch


def generator(seed: int, device: torch.device) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(int(seed))


def uniform(gen: torch.Generator, shape: Sequence[int]) -> torch.Tensor:
    """U[0, 1) float32."""
    return torch.rand(tuple(shape), generator=gen, device=gen.device,
                      dtype=torch.float32)


def normal(gen: torch.Generator, shape: Sequence[int]) -> torch.Tensor:
    return torch.randn(tuple(shape), generator=gen, device=gen.device,
                       dtype=torch.float32)


def randint(gen: torch.Generator, shape: Sequence[int], lo: int,
            hi: int) -> torch.Tensor:
    """Integers in [lo, hi), int64."""
    return torch.randint(int(lo), int(hi), tuple(shape), generator=gen,
                         device=gen.device, dtype=torch.int64)


def permutations(gen: torch.Generator, rows: int, n: int) -> torch.Tensor:
    """[rows, n] int64: an independent uniform permutation of range(n)
    per row (argsort of i.i.d. uniform keys)."""
    return torch.argsort(uniform(gen, (rows, n)), dim=1)


def choice_without_replacement(gen: torch.Generator, rows: int,
                               n_pool: int, k: int) -> torch.Tensor:
    """[rows, k] int64: k distinct picks from range(n_pool) per row."""
    return permutations(gen, rows, n_pool)[:, :k]
