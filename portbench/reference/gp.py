"""The GP posterior and expected improvement, from the configuration's
stated model: a product kernel, Matern-5/2 over the continuous block
(one lengthscale) times exp(-(differing categorical lanes / n_cat) /
ls_cat); targets standardized over the training rows (population std);
K + noise I; the predictive variance of a noisy observation, 1 + noise -
k K^-1 k, floored at 1e-9; EI for minimization, sd floored at 1e-9.

`precision="float64"` is the reference.  `precision="tf32"` is the
control of a float32 configuration: the same algebra in float32 with the
operands of every matrix product rounded to TF32 (10 mantissa bits),
which is what a float32 product with TF32 on computes."""
from __future__ import annotations

import math
from typing import NamedTuple

import torch


def tf32(t: torch.Tensor) -> torch.Tensor:
    """float32 rounded to the nearest TF32 value (ties away from 0)."""
    bits = t.contiguous().view(torch.int32)
    bits = (bits + 0x1000) & ~0x1FFF
    return bits.view(torch.float32)


class Posterior(NamedTuple):
    x: torch.Tensor
    chol: torch.Tensor
    alpha: torch.Tensor
    mean: torch.Tensor
    std: torch.Tensor
    ls: float
    noise: float
    ls_cat: float
    n_cont: int
    n_cat: int
    precision: str


def _mm(a: torch.Tensor, b: torch.Tensor, precision: str) -> torch.Tensor:
    if precision == "tf32":
        return tf32(a) @ tf32(b)
    return a @ b


def _d2(a: torch.Tensor, b: torch.Tensor, precision: str) -> torch.Tensor:
    return torch.clamp_min((a * a).sum(-1)[:, None] + (b * b).sum(-1)[None]
                           - 2.0 * _mm(a, b.T, precision), 0.0)


def kernel(p: Posterior, q: torch.Tensor) -> torch.Tensor:
    """[B, F] queries -> [B, N] k(q, x)."""
    nc = p.n_cont
    d2 = _d2(q[:, :nc], p.x[:, :nc], p.precision) / (p.ls * p.ls)
    d = torch.sqrt(d2 + 1e-12)
    k = (1.0 + math.sqrt(5.0) * d + (5.0 / 3.0) * d2) * torch.exp(
        -math.sqrt(5.0) * d)
    if p.n_cat:
        ham = _d2(q[:, nc:], p.x[:, nc:], p.precision)
        k = k * torch.exp(-(ham / p.n_cat) / p.ls_cat)
    return k


def fit(x: torch.Tensor, y: torch.Tensor, ls: float, noise: float,
        ls_cat: float, n_cont: int, n_cat: int,
        precision: str = "float64") -> Posterior:
    dt = torch.float64 if precision == "float64" else torch.float32
    x, y = x.to(dt), y.to(dt)
    mean = y.mean()
    std = torch.clamp_min(y.std(correction=0), 1e-8)
    yn = (y - mean) / std
    p = Posterior(x, None, None, mean, std, ls, noise, ls_cat, n_cont,
                  n_cat, precision)
    k = kernel(p, x) + noise * torch.eye(x.shape[0], dtype=dt,
                                         device=x.device)
    chol = torch.linalg.cholesky(k)
    alpha = torch.cholesky_solve(yn[:, None], chol)[:, 0]
    return p._replace(chol=chol, alpha=alpha)


def moments(p: Posterior, q: torch.Tensor, block: int = 2048):
    """[B, F] -> (mean [B], sd [B]) in target units, in blocks of rows."""
    mus, sds = [], []
    q = q.to(p.x.dtype)
    for i in range(0, q.shape[0], block):
        kq = kernel(p, q[i:i + block])
        mu = _mm(kq, p.alpha[:, None], p.precision)[:, 0]
        v = torch.linalg.solve_triangular(p.chol, kq.T, upper=False)
        var = torch.clamp_min(1.0 + p.noise - (v * v).sum(0), 1e-9)
        mus.append(mu * p.std + p.mean)
        sds.append(torch.sqrt(var) * p.std)
    return torch.cat(mus), torch.cat(sds)


def expected_improvement(mu: torch.Tensor, sd: torch.Tensor,
                         best: float) -> torch.Tensor:
    sd = torch.clamp_min(sd, 1e-9)
    z = (best - mu) / sd
    pdf = torch.exp(-0.5 * z * z) / math.sqrt(2 * math.pi)
    cdf = 0.5 * (1.0 + torch.erf(z / math.sqrt(2.0)))
    return (best - mu) * cdf + sd * pdf


def ei(p: Posterior, q: torch.Tensor, best: float) -> torch.Tensor:
    return expected_improvement(*moments(p, q), best)



def topk(u, k: int):
    """The k largest of the utilities `u` (NumPy), descending, ties to
    the lowest index: (values, indices)."""
    import numpy as np
    order = np.argsort(-np.asarray(u), kind="stable")[:k]
    return np.asarray(u)[order], order
