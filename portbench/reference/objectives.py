"""The objectives of the configurations, in float64 (and, for the
control, in a lower precision): OpenTuner's examples/rosenbrock and
examples/tsp."""
from __future__ import annotations

from typing import Sequence

import numpy as np


def rosenbrock(x: np.ndarray) -> np.ndarray:
    """[..., D] -> [...]: sum of 100 (x[i+1] - x[i]^2)^2 + (1 - x[i])^2."""
    a, b = x[..., :-1], x[..., 1:]
    return (100.0 * (b - a * a) ** 2 + (1.0 - a) ** 2).sum(-1)


def rosenbrock_py(x: Sequence[float]) -> float:
    """The same sum over a list of floats, in plain Python (a client
    process evaluates it without NumPy)."""
    return sum(100.0 * (x[i + 1] - x[i] ** 2) ** 2 + (1.0 - x[i]) ** 2
               for i in range(len(x) - 1))


def distances(cities: Sequence[Sequence[float]]) -> np.ndarray:
    """[n, n] Euclidean distances between the cities' points."""
    p = np.asarray(cities, np.float64)
    return np.sqrt(((p[:, None, :] - p[None, :, :]) ** 2).sum(-1))


def tour_length(perm: np.ndarray, dist: np.ndarray) -> np.ndarray:
    """[..., n] city order -> [...] closed-tour length."""
    perm = np.asarray(perm, np.int64)
    return dist[perm, np.roll(perm, -1, axis=-1)].sum(-1)


def flagship(vals: np.ndarray, tour: np.ndarray, dist: np.ndarray,
             n_float: int) -> np.ndarray:
    """rosenbrock over the first `n_float` lanes plus the tour length."""
    return rosenbrock(np.asarray(vals, np.float64)[:, :n_float]) + \
        tour_length(tour, dist)


def flagship_lowp(vals: np.ndarray, tour: np.ndarray, dist: np.ndarray,
                  n_float: int, dtype: str = "bfloat16") -> np.ndarray:
    """The same objective computed in `dtype` (torch, on the CPU): the
    control of a float32 configuration."""
    import torch
    dt = getattr(torch, dtype)
    x = torch.as_tensor(np.asarray(vals)[:, :n_float]).to(dt)
    a, b = x[:, :-1], x[:, 1:]
    r = (100.0 * (b - a * a) ** 2 + (1.0 - a) ** 2).sum(-1)
    d = torch.as_tensor(dist).to(dt)
    p = torch.as_tensor(np.asarray(tour, np.int64))
    t = d[p, torch.roll(p, -1, dims=-1)].sum(-1)
    return (r + t).to(torch.float64).numpy()


def lower(x: float, dtype: str) -> float:
    """x rounded to `dtype` (float32 or bfloat16) and back."""
    if dtype == "float32":
        return float(np.float32(x))
    import torch
    return float(torch.tensor(x, dtype=torch.float64).to(
        getattr(torch, dtype)).to(torch.float64))
