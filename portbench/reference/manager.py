"""What the calibrated GP surrogate manager decides, in plain PyTorch in
float64 (TF32 off), from the configuration's stated semantics
(`surrogate` and `guarantees` of gcc-options-g12-tuner.json):

- the rows a full fit uses: all of the campaign's told rows while they
  number `max_points` or fewer, else a best-biased subsample (the best
  half by QoR, in NumPy's `argsort` order of the float32 values, then
  `max_points - max_points // 2` of the rest drawn by
  `numpy.random.RandomState(seed_word & 0x7fffffff).choice` without
  replacement);
- the fit's hyperparameters: the sweep's point of largest log marginal
  likelihood on those rows, (lengthscale, noise) over their grids at the
  middle `ls_cat`, then `ls_cat` over its grid at that winner, the first
  maximum taken; a point whose factorization fails scores -inf;
- posterior moments and expected improvement at those values
  (`reference/gp.py`); a snapshot that holds rank-1 extensions is the
  GP on the last full fit's rows and the rows folded in since, at that
  fit's values and with its standardization;
- a prune's keep set: the `k = max(1, round(n * keep_frac))` rows of
  largest EI among the `n` eligible rows, ties to the lowest index, and
  every eligible row whose explore draw is below `explore_frac`;
- a pull: the `n_out` rows of largest EI of its pool, descending, ties to
  the lowest index.

`precision="float32"` computes the same in plain float32: float32's
own reach on that posterior, the yardstick the program's gaps are read
against.  `precision="tf32"` computes it in float32 with every matrix
product's operands rounded to TF32: the control."""
from __future__ import annotations

import contextlib
import math
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from . import gp as ref_gp


@contextlib.contextmanager
def no_tf32():
    """float32 products in full float32 inside (the reference's float64
    products never use TF32; the control rounds its operands itself)."""
    cuda, cudnn = torch.backends.cuda.matmul, torch.backends.cudnn
    saved = cuda.allow_tf32, cudnn.allow_tf32
    cuda.allow_tf32 = cudnn.allow_tf32 = False
    try:
        yield
    finally:
        cuda.allow_tf32, cudnn.allow_tf32 = saved


def fit_rows(ys32: np.ndarray, seed_word: int, max_points: int) -> np.ndarray:
    """Indices of the told rows a full fit uses (`ys32`: every told row's
    QoR in float32, in told order)."""
    n = len(ys32)
    if n <= max_points:
        return np.arange(n)
    n_best = max_points // 2
    order = np.argsort(ys32)
    rest = order[n_best:]
    rs = np.random.RandomState(int(seed_word) & 0x7fffffff)
    pick = rs.choice(len(rest), max_points - n_best, replace=False)
    return np.concatenate([order[:n_best], rest[pick]])


def log_evidence(x: torch.Tensor, y: torch.Tensor, ls: float, noise: float,
                 ls_cat: float, n_cont: int, n_cat: int,
                 precision: str = "float64") -> float:
    """The GP's log marginal likelihood of the standardized targets:
    -1/2 yn' K^-1 yn - 1/2 log|K| - n/2 log 2 pi, K = k(x, x) + noise I;
    -inf where K does not factor."""
    dt = torch.float64 if precision == "float64" else torch.float32
    x, y = x.to(dt), y.to(dt)
    std = torch.clamp_min(y.std(correction=0), 1e-8)
    yn = (y - y.mean()) / std
    p = ref_gp.Posterior(x, None, None, None, None, ls, noise, ls_cat,
                         n_cont, n_cat, precision)
    k = ref_gp.kernel(p, x) + noise * torch.eye(x.shape[0], dtype=dt,
                                                device=x.device)
    chol, info = torch.linalg.cholesky_ex(k)
    if int(info) != 0:
        return -math.inf
    alpha = torch.cholesky_solve(yn[:, None], chol)[:, 0]
    v = float(-0.5 * (yn * alpha).sum()
              - torch.log(torch.diagonal(chol)).sum()
              - 0.5 * x.shape[0] * math.log(2 * math.pi))
    return v if math.isfinite(v) else -math.inf


def sweep(x: torch.Tensor, y: torch.Tensor, grid: Dict[str, Sequence[float]],
          n_cont: int, n_cat: int, precision: str = "float64"
          ) -> Tuple[Tuple[float, float, float], Dict[tuple, float]]:
    """The sweep's choice -> ((ls, noise, ls_cat), every point's log
    evidence)."""
    cats = list(grid["ls_cat"])
    mid = cats[len(cats) // 2]
    seen: Dict[tuple, float] = {}

    def best_of(points):
        best, score = None, -math.inf
        for pt in points:
            if pt not in seen:
                seen[pt] = log_evidence(x, y, *pt, n_cont, n_cat, precision)
            if best is None or seen[pt] > score:
                best, score = pt, seen[pt]
        return best
    ls, nz, _ = best_of([(a, b, mid) for a in grid["ls"]
                         for b in grid["noise"]])
    return best_of([(ls, nz, c) for c in cats]), seen


def posterior(x: torch.Tensor, y: torch.Tensor, hp: Tuple[float, float, float],
              n_cont: int, n_cat: int, precision: str = "float64",
              rows_std: Optional[int] = None) -> ref_gp.Posterior:
    """The GP on (x, y) at `hp`, its targets standardized by the mean and
    population std of the first `rows_std` rows (all by default): a
    snapshot extended past its last full fit keeps that fit's
    standardization, and its rows are the fit's rows, then the rows
    folded in since."""
    ls, noise, ls_cat = hp
    if rows_std is None or rows_std >= len(y):
        return ref_gp.fit(x, y, ls, noise, ls_cat, n_cont, n_cat, precision)
    dt = torch.float64 if precision == "float64" else torch.float32
    x, y = x.to(dt), y.to(dt)
    mean = y[:rows_std].mean()
    std = torch.clamp_min(y[:rows_std].std(correction=0), 1e-8)
    p = ref_gp.Posterior(x, None, None, mean, std, ls, noise, ls_cat,
                         n_cont, n_cat, precision)
    k = ref_gp.kernel(p, x) + noise * torch.eye(x.shape[0], dtype=dt,
                                                device=x.device)
    chol = torch.linalg.cholesky(k)
    alpha = torch.cholesky_solve(((y - mean) / std)[:, None], chol)[:, 0]
    return p._replace(chol=chol, alpha=alpha)


def keep_set(ei: np.ndarray, eligible: np.ndarray, explore_u: np.ndarray,
             keep_frac: float, explore_frac: float
             ) -> Tuple[np.ndarray, np.ndarray, int]:
    """-> (the keep mask, the explore mask, k)."""
    ei = np.asarray(ei, np.float64)
    eligible = np.asarray(eligible, bool)
    n = int(eligible.sum())
    k = max(1, int(round(n * keep_frac)))
    keep = np.zeros(len(ei), bool)
    if n:
        order = np.argsort(np.where(eligible, -ei, np.inf), kind="stable")
        keep[order[:min(k, n)]] = True
    explore = (np.asarray(explore_u) < explore_frac) & eligible
    return keep | explore, explore, k


def pull(ei: np.ndarray, n_out: int) -> Tuple[np.ndarray, np.ndarray]:
    """The pool's top `n_out` by EI: (values, indices)."""
    return ref_gp.topk(ei, n_out)
