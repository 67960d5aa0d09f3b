"""Synthetic benchmark objectives (rosenbrock, tsp) in batched form.

Counterpart of `uptune_tpu/workloads/synthetic.py`, limited to what the
fused engine's flagship uses: the spaces, the random TSP instance, and
the device objectives over decoded values / permutation blocks.
"""
from __future__ import annotations

import numpy as np
import torch

from ..space.params import FloatParam, IntParam, PermParam
from ..space.spec import Space


def rosenbrock_space(dims: int = 2, lo: float = -30.0, hi: float = 30.0,
                     as_int: bool = False) -> Space:
    mk = IntParam if as_int else FloatParam
    return Space([mk(f"x{i}", lo, hi) for i in range(dims)])


def rosenbrock_device(x: torch.Tensor) -> torch.Tensor:
    """[..., D] -> [...] classic Rosenbrock value."""
    a, b = x[..., :-1], x[..., 1:]
    return (100.0 * (b - a * a) ** 2 + (1.0 - a) ** 2).sum(dim=-1)


def tsp_space(n_cities: int) -> Space:
    return Space([PermParam("tour", list(range(n_cities)))])


def random_tsp_distances(n_cities: int, seed: int = 0) -> np.ndarray:
    """[n, n] float64 Euclidean distances between uniform random cities."""
    rs = np.random.RandomState(seed)
    pts = rs.rand(n_cities, 2)
    return np.sqrt(((pts[:, None, :] - pts[None, :, :]) ** 2).sum(-1))


def tsp_device(perm: torch.Tensor, dist: torch.Tensor) -> torch.Tensor:
    """perm [..., N] city order -> [...] closed-tour length."""
    nxt = torch.roll(perm, -1, dims=-1)
    return dist[perm, nxt].sum(dim=-1)
