"""Exact Gaussian-process surrogate (Matérn-5/2 × exp-Hamming), in torch.

Counterpart of `uptune_tpu/surrogate/gp.py`: the fit is one Cholesky
factorization, prediction two matrix products over the whole query
batch, and both carry the predictive variance that EI and LCB need.
Cholesky, `cho_solve` and `solve_triangular` are plain `torch.linalg`
calls, as the JAX package leaves them to XLA.  Matrix products run in
full float32 whatever the caller has set: every entry point runs under
`full_f32` (the JAX package's `precision="highest"`, load-bearing there:
in TF32 the difference of squares in the distances collapses the kernel
diagonal), which restores the caller's setting on the way out.

Randomness: `subsample` and `thompson` are pure functions of their
draws; `draw_subsample` / `draw_thompson` make the draws from a
`torch.Generator`, so tests can feed the numbers `jax.random` drew.

History larger than `max_points` is subsampled (the best half by QoR
plus a random draw of the rest) so the O(N^3) fit stays bounded.
"""
from __future__ import annotations

import contextlib
import math
import threading
from typing import NamedTuple, Optional, Sequence, Tuple, Union

import torch

from .. import rng

Scalar = Union[float, torch.Tensor]


class GPState(NamedTuple):
    x: torch.Tensor          # [N, F] training features (maybe padded rows)
    alpha: torch.Tensor      # [N] K^-1 (y - mean) / std
    chol: torch.Tensor       # [N, N] lower Cholesky of K + noise I
    y_mean: torch.Tensor     # scalar
    y_std: torch.Tensor      # scalar
    lengthscale: torch.Tensor
    noise: torch.Tensor
    mask: torch.Tensor       # [N] 1.0 = real training row, 0.0 = padding
    ls_cat: Scalar = 1.0     # categorical-block lengthscale
    # optional premasked K^-1 for the fused variance path
    # (`precompute_kinv`); attached once per (re)fit
    kinv: Optional[torch.Tensor] = None


# `full_f32` windows open in the process, and the caller's setting saved
# by the first to open (restored by the last to close): the setting is
# process-global, and the async refit worker and the driver thread may
# be inside windows at once
_F32_LOCK = threading.Lock()
_F32_DEPTH = 0
_F32_SAVED: Optional[tuple] = None


def _backends() -> tuple:
    return (torch.backends.cuda.matmul, torch.backends.mkldnn.matmul)


def _f32_enter() -> None:
    """Open a window: the first one saves the caller's setting (through
    the API that set it) and switches TF32 off."""
    global _F32_DEPTH, _F32_SAVED
    with _F32_LOCK:
        if _F32_DEPTH == 0:
            try:
                _F32_SAVED = ("legacy", torch.get_float32_matmul_precision())
            except RuntimeError:        # set through fp32_precision
                _F32_SAVED = ("backends",
                              [b.fp32_precision for b in _backends()])
            if _F32_SAVED[0] == "legacy":
                torch.set_float32_matmul_precision("highest")
            else:
                for b in _backends():
                    b.fp32_precision = "ieee"
        _F32_DEPTH += 1


def _f32_exit() -> None:
    """Close a window: the last one restores the saved setting."""
    global _F32_DEPTH, _F32_SAVED
    with _F32_LOCK:
        _F32_DEPTH -= 1
        if _F32_DEPTH == 0:
            how, prev = _F32_SAVED
            if how == "legacy":
                torch.set_float32_matmul_precision(prev)
            else:
                for b, v in zip(_backends(), prev):
                    b.fp32_precision = v
            _F32_SAVED = None


@contextlib.contextmanager
def full_f32():
    """Run float32 matrix products in full float32 (no TF32, on any
    backend) inside, and restore the caller's setting after.  Either API
    may have set it: the legacy one (`allow_tf32`,
    `set_float32_matmul_precision`), which then reads back, or the
    per-backend `fp32_precision` one, after which the legacy getter
    raises; each is restored through the API that set it.  Windows may
    nest and overlap across threads: the setting is saved when the first
    opens and restored when the last closes."""
    _f32_enter()
    try:
        yield
    finally:
        _f32_exit()


def _f32(v, device) -> torch.Tensor:
    """`v` as float32 on `device`; a host value goes to the card through
    pinned memory, without a synchronisation."""
    if isinstance(v, torch.Tensor) or torch.device(device).type != "cuda":
        return torch.as_tensor(v, dtype=torch.float32, device=device)
    return torch.tensor(v, dtype=torch.float32).pin_memory().to(
        device, non_blocking=True)


def _raw_d2(x1: torch.Tensor, x2: torch.Tensor) -> torch.Tensor:
    """[N, F] x [M, F] -> [N, M] squared euclidean distances through the
    |a|^2 + |b|^2 - 2ab^T identity, clamped at 0 (full f32 matmul)."""
    return torch.clamp_min(
        (x1 * x1).sum(-1)[:, None] + (x2 * x2).sum(-1)[None, :]
        - 2.0 * (x1 @ x2.T), 0.0)


def _matern52_from_d2(d2: torch.Tensor) -> torch.Tensor:
    """Matérn-5/2 from lengthscale-scaled squared distances."""
    d = torch.sqrt(d2 + 1e-12)
    s5d = math.sqrt(5.0) * d
    return (1.0 + s5d + (5.0 / 3.0) * d2) * torch.exp(-s5d)


def _kernel_from_d2(d2c: torch.Tensor, ham: Optional[torch.Tensor], ls,
                    ls_cat, n_cat: int) -> torch.Tensor:
    """k = Matérn52(d2c / ls^2) * exp(-(ham / n_cat) / ls_cat), from the
    raw continuous distances and the Hamming counts (or None)."""
    k = _matern52_from_d2(d2c / (ls * ls))
    if ham is not None and n_cat:
        k = k * torch.exp(-(ham / float(n_cat)) / ls_cat)
    return k


def _d2_blocks(x1: torch.Tensor, x2: torch.Tensor, n_cont: Optional[int]):
    """Split features at column `n_cont`: (continuous d2, Hamming d2)."""
    if n_cont is None or n_cont >= x1.shape[-1]:
        return _raw_d2(x1, x2), None
    return (_raw_d2(x1[:, :n_cont], x2[:, :n_cont]),
            _raw_d2(x1[:, n_cont:], x2[:, n_cont:]))


def _standardize(y: torch.Tensor, mask: Optional[torch.Tensor]
                 ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Clamp non-finite targets to the worst finite value, then
    standardize over the real (masked-in) rows."""
    finite = torch.isfinite(y)
    if mask is not None:
        finite = finite & (mask > 0)
    worst = torch.max(torch.where(finite, y, -math.inf))
    y = torch.where(finite, y, worst)
    if mask is None:
        mean = y.mean()
        std = torch.clamp_min(y.std(correction=0), 1e-8)
    else:
        n = torch.clamp_min(mask.sum(), 1.0)
        mean = (y * mask).sum() / n
        std = torch.clamp_min(
            torch.sqrt((mask * (y - mean) ** 2).sum() / n), 1e-8)
    yn = (y - mean) / std
    if mask is not None:
        yn = yn * mask
    return yn, mean, std


def _mask_adjust(k: torch.Tensor, noise, mask: Optional[torch.Tensor]
                 ) -> torch.Tensor:
    """K + noise I, with padded rows made independent unit-variance
    points (zero coupling, 1 on the diagonal)."""
    n = k.shape[0]
    if mask is not None:
        k = mask[:, None] * mask[None, :] * k + torch.diag(1.0 - mask)
    return k + noise * torch.eye(n, dtype=k.dtype, device=k.device)


def _cho_solve(chol: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Solve (L L^T) x = b for a vector or a matrix b."""
    if b.dim() == 1:
        return torch.cholesky_solve(b[:, None], chol)[:, 0]
    return torch.cholesky_solve(b, chol)


@full_f32()
def fit(x: torch.Tensor, y: torch.Tensor, lengthscale: Scalar = 0.3,
        noise: Scalar = 1e-3, mask: Optional[torch.Tensor] = None,
        n_cont: Optional[int] = None, n_cat: int = 0,
        ls_cat: Scalar = 1.0) -> GPState:
    """Exact GP fit at fixed hyperparameters; `mask` ([N] 1.0 real, 0.0
    padding) pads the training set to a bucket without changing the
    result; `n_cont`/`n_cat` select the mixed kernel."""
    dev = x.device
    yn, mean, std = _standardize(y, mask)
    ls, nz, lc = _f32(lengthscale, dev), _f32(noise, dev), _f32(ls_cat, dev)
    d2c, ham = _d2_blocks(x, x, n_cont)
    k = _mask_adjust(_kernel_from_d2(d2c, ham, ls, lc, n_cat), nz, mask)
    chol = torch.linalg.cholesky(k)
    alpha = _cho_solve(chol, yn)
    m = torch.ones(x.shape[0], device=dev) if mask is None else mask
    return GPState(x, alpha, chol, mean, std, ls, nz, m, lc)


DEFAULT_LS_GRID = (0.05, 0.1, 0.2, 0.3, 0.5, 0.8, 1.3, 2.0, 3.0)
DEFAULT_NOISE_GRID = (1e-4, 1e-3, 1e-2, 1e-1)
DEFAULT_LS_CAT_GRID = (0.02, 0.05, 0.1, 0.2, 0.5, 1.0, 2.0)


def _mll_from_k(k: torch.Tensor, yn: torch.Tensor,
                mask: Optional[torch.Tensor], n_rows: int) -> torch.Tensor:
    """Log evidence from the adjusted K.  A failed factorization (K not
    positive definite in f32) scores NaN, as JAX's Cholesky returns NaN
    where `torch.linalg.cholesky` would raise."""
    chol, info = torch.linalg.cholesky_ex(k)
    alpha = _cho_solve(chol, yn)
    logdiag = torch.log(torch.diagonal(chol))
    if mask is not None:
        logdiag = logdiag * mask
        n = mask.sum()
    else:
        n = float(n_rows)
    mll = (-0.5 * (yn * alpha).sum() - logdiag.sum()
           - 0.5 * n * math.log(2 * math.pi))
    return torch.where(info == 0, mll, math.nan)


@full_f32()
def log_marginal_likelihood(x: torch.Tensor, y: torch.Tensor, lengthscale,
                            noise, mask: Optional[torch.Tensor] = None,
                            n_cont: Optional[int] = None, n_cat: int = 0,
                            ls_cat=1.0) -> torch.Tensor:
    """Exact GP log evidence on standardized targets; padded rows
    contribute exactly zero."""
    dev = x.device
    yn, _, _ = _standardize(y, mask)
    d2c, ham = _d2_blocks(x, x, n_cont)
    k = _mask_adjust(_kernel_from_d2(d2c, ham, _f32(lengthscale, dev),
                                     _f32(ls_cat, dev), n_cat),
                     _f32(noise, dev), mask)
    return _mll_from_k(k, yn, mask, x.shape[0])


@full_f32()
def fit_auto(x: torch.Tensor, y: torch.Tensor,
             mask: Optional[torch.Tensor] = None,
             ls_grid: Sequence[float] = DEFAULT_LS_GRID,
             noise_grid: Sequence[float] = DEFAULT_NOISE_GRID,
             n_cont: Optional[int] = None, n_cat: int = 0,
             ls_cat_grid: Sequence[float] = DEFAULT_LS_CAT_GRID
             ) -> GPState:
    """Fit with (lengthscale, noise[, ls_cat]) chosen by marginal
    likelihood: sweep (ls, noise) at the middle ls_cat, then ls_cat at
    that winner (9 x 4 + 7 = 43 factorizations with categoricals), and
    refit the winner.  The raw distance blocks are computed once.  A
    point whose factorization fails (or gives NaN) scores -inf."""
    dev = x.device
    has_cat = n_cat > 0 and n_cont is not None and n_cont < x.shape[-1]
    yn, _, _ = _standardize(y, mask)
    d2c, ham = _d2_blocks(x, x, n_cont)

    def sweep(grid: torch.Tensor) -> torch.Tensor:
        scores = torch.stack([
            _mll_from_k(_mask_adjust(
                _kernel_from_d2(d2c, ham, hp[0], hp[2], n_cat), hp[1], mask),
                yn, mask, x.shape[0])
            for hp in grid])
        scores = torch.where(torch.isnan(scores), -math.inf, scores)
        # argmax takes the first maximum, as jnp.argmax does
        return grid[torch.argmax(scores)]

    cat_grid = tuple(ls_cat_grid)
    mid = cat_grid[len(cat_grid) // 2] if has_cat else 1.0
    best = sweep(_f32([(ls, nz, mid) for ls in ls_grid
                       for nz in noise_grid], dev))
    if has_cat:
        g2 = torch.stack([
            best[0].expand(len(cat_grid)), best[1].expand(len(cat_grid)),
            _f32(cat_grid, dev)], dim=1)
        best = sweep(g2)
    return fit(x, y, best[0], best[1], mask, n_cont=n_cont, n_cat=n_cat,
               ls_cat=best[2])


def bucket_of(n: int, max_points: int) -> int:
    """Training-shape bucket for `n` rows: the next power of two, capped
    at `max_points`."""
    b = 1
    while b < n:
        b *= 2
    return min(b, max(max_points, n))


def pad_train(x: torch.Tensor, y: torch.Tensor, bucket: int
              ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Zero-pad a training set to `bucket` rows -> (x, y, mask)."""
    n = x.shape[0]
    mask = torch.cat([torch.ones(n, device=x.device),
                      torch.zeros(bucket - n, device=x.device)]).to(x.dtype)
    x = torch.cat([x, torch.zeros((bucket - n, x.shape[1]), dtype=x.dtype,
                                  device=x.device)])
    y = torch.cat([y, torch.zeros(bucket - n, dtype=y.dtype,
                                  device=y.device)])
    return x, y, mask


def draw_subsample(gen: rng.Stream, n: int, max_points: int
                   ) -> torch.Tensor:
    """The draw of `subsample`: max_points - max_points // 2 distinct
    positions in the n - max_points // 2 rows past the best half."""
    n_best = max_points // 2
    return rng.choice_without_replacement(
        gen, 1, n - n_best, max_points - n_best)[0]


def subsample(x: torch.Tensor, y: torch.Tensor, max_points: int,
              pick: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Best-biased subsample: the best half by y (stable order), then the
    rows at positions `pick` (from `draw_subsample`) of the rest."""
    n = x.shape[0]
    if n <= max_points:
        return x, y
    n_best = max_points // 2
    order = torch.argsort(y, stable=True)
    idx = torch.cat([order[:n_best], order[n_best:][pick.to(x.device)]])
    return x[idx], y[idx]


@full_f32()
def fit_auto_bucketed(x: torch.Tensor, y: torch.Tensor, *,
                      max_points: int = 1024,
                      pick: Optional[torch.Tensor] = None,
                      n_cont: Optional[int] = None, n_cat: int = 0,
                      ls_grid: Sequence[float] = DEFAULT_LS_GRID,
                      noise_grid: Sequence[float] = DEFAULT_NOISE_GRID,
                      ls_cat_grid: Sequence[float] = DEFAULT_LS_CAT_GRID
                      ) -> GPState:
    """`fit_auto` over a padded power-of-two bucket: subsample past
    `max_points` (the draw `pick` from `draw_subsample`, by default one
    from seed 0, as the JAX package defaults to PRNGKey(0)), pad, sweep.
    PyTorch runs eagerly, so no per-bucket program cache is needed."""
    if x.shape[0] > max_points:
        if pick is None:
            pick = draw_subsample(rng.generator(0, x.device), x.shape[0],
                                  max_points)
        x, y = subsample(x, y, max_points, pick)
    bucket = bucket_of(x.shape[0], max_points)
    x, y, mask = pad_train(x.to(torch.float32), y.to(torch.float32), bucket)
    return fit_auto(x, y, mask, ls_grid=ls_grid, noise_grid=noise_grid,
                    n_cont=n_cont, n_cat=n_cat, ls_cat_grid=ls_cat_grid)


@full_f32()
def extend(state: GPState, x_row: torch.Tensor, y_raw, slot: int,
           n_cont: Optional[int] = None, n_cat: int = 0) -> GPState:
    """O(N^2) rank-1 extension of a padded GPState: condition on one new
    observation in padding row `slot` (the first padded row), keeping
    the hyperparameters and standardization of the last full fit.  The
    result equals `fit` on the extended set at those values; a premasked
    K^-1 is extended by the bordered-inverse identity.  `y_raw` must be
    finite."""
    xb, chol, mask = state.x, state.chol, state.mask
    d2c, ham = _d2_blocks(x_row[None, :], xb, n_cont)
    kvec = _kernel_from_d2(d2c, ham, state.lengthscale, state.ls_cat,
                           n_cat)[0] * mask
    w = torch.linalg.solve_triangular(chol, kvec[:, None], upper=False)[:, 0]
    lnn = torch.sqrt(torch.clamp_min(1.0 + state.noise - (w * w).sum(),
                                     1e-12))
    chol_new = chol.clone()
    row = w.clone()
    row[slot] = lnn
    chol_new[slot, :] = row
    # the standardized targets, recovered from the old factor (K alpha =
    # yn), with the new row spliced in
    yn = chol @ (chol.T @ state.alpha)
    yn[slot] = (_f32(y_raw, xb.device) - state.y_mean) / state.y_std
    alpha_new = _cho_solve(chol_new, yn)
    kinv_new = state.kinv
    if kinv_new is not None:
        r = kinv_new @ kvec
        r[slot] -= 1.0
        kinv_new = kinv_new + torch.outer(r, r) / (lnn * lnn)
    x_new = xb.clone()
    x_new[slot] = x_row
    mask_new = mask.clone()
    mask_new[slot] = 1.0
    return state._replace(x=x_new, alpha=alpha_new, chol=chol_new,
                          mask=mask_new, kinv=kinv_new)


@full_f32()
def precompute_kinv(state: GPState) -> GPState:
    """Attach the premasked K^-1 (padded rows and columns zeroed) that
    the fused variance path reads."""
    n = state.x.shape[0]
    eye = torch.eye(n, dtype=torch.float32, device=state.x.device)
    kinv = _cho_solve(state.chol.to(torch.float32), eye)
    kinv = kinv * state.mask[:, None] * state.mask[None, :]
    return state._replace(kinv=kinv)


@full_f32()
def predict(state: GPState, xq: torch.Tensor,
            n_cont: Optional[int] = None, n_cat: int = 0
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """[B, F] -> (mean [B], std [B]) in target units, through the
    materialized [B, N] cross-kernel and a triangular solve."""
    d2c, ham = _d2_blocks(xq, state.x, n_cont)
    kq = _kernel_from_d2(d2c, ham, state.lengthscale, state.ls_cat, n_cat)
    kq = kq * state.mask[None, :]
    mu = kq @ state.alpha
    v = torch.linalg.solve_triangular(state.chol, kq.T, upper=False)
    var = torch.clamp_min(1.0 + state.noise - (v ** 2).sum(0), 1e-9)
    return mu * state.y_std + state.y_mean, torch.sqrt(var) * state.y_std


def ei_from_moments(mu: torch.Tensor, sd: torch.Tensor, best
                    ) -> torch.Tensor:
    """EI for minimization from predictive moments, sd floored at 1e-9."""
    sd = torch.clamp_min(sd, 1e-9)
    z = (best - mu) / sd
    pdf = torch.exp(-0.5 * z * z) / math.sqrt(2 * math.pi)
    cdf = 0.5 * (1.0 + torch.erf(z / math.sqrt(2.0)))
    return (best - mu) * cdf + sd * pdf


def expected_improvement(state: GPState, xq: torch.Tensor, best,
                         n_cont: Optional[int] = None, n_cat: int = 0
                         ) -> torch.Tensor:
    mu, sd = predict(state, xq, n_cont, n_cat)
    return ei_from_moments(mu, sd, best)


def lower_confidence_bound(state: GPState, xq: torch.Tensor,
                           beta: float = 2.0, n_cont: Optional[int] = None,
                           n_cat: int = 0) -> torch.Tensor:
    mu, sd = predict(state, xq, n_cont, n_cat)
    return mu - beta * sd


def draw_thompson(gen: rng.Stream, b: int) -> torch.Tensor:
    """The draw of `thompson`: one standard normal per query row."""
    return rng.normal(gen, (b,))


def thompson(state: GPState, xq: torch.Tensor, z: torch.Tensor,
             n_cont: Optional[int] = None, n_cat: int = 0) -> torch.Tensor:
    """One posterior sample per query row (diagonal approximation), from
    the standard normals `z` (`draw_thompson`)."""
    mu, sd = predict(state, xq, n_cont, n_cat)
    return mu + sd * z


@full_f32()
def score_flat(state: GPState, xq: torch.Tensor, kind: str = "mean",
               best_y=None, beta: float = 2.0,
               n_cont: Optional[int] = None, n_cat: int = 0) -> torch.Tensor:
    """Score a query batch of any leading shape [..., F] as one flat
    pass: 'mean', 'ei' (needs `best_y`) or 'lcb' (mu - beta*sd).  From
    PALLAS_MIN_POOL = 4096 flat rows on, the fused tile functions of
    `pallas_score` score it (the CUDA kernels on the card); below it
    `predict` does, as in the JAX package."""
    from . import pallas_score
    lead = xq.shape[:-1]
    flat = xq.reshape(-1, xq.shape[-1])
    fused = flat.shape[0] >= pallas_score.PALLAS_MIN_POOL
    if kind == "mean":
        out = (pallas_score.gp_mean_scores(state, flat, n_cont, n_cat)
               if fused else predict(state, flat, n_cont, n_cat)[0])
    elif kind in ("ei", "lcb"):
        mu, sd = (pallas_score.gp_mean_var_scores(state, flat, n_cont, n_cat)
                  if fused else predict(state, flat, n_cont, n_cat))
        if kind == "ei":
            if best_y is None:
                raise ValueError("kind='ei' needs best_y")
            out = ei_from_moments(mu, sd, _f32(best_y, flat.device))
        else:
            out = mu - beta * sd
    else:
        raise ValueError(f"unknown kind {kind!r}")
    return out.reshape(lead)
