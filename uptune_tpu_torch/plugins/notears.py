"""NOTEARS causal structure discovery, in torch.

Counterpart of `uptune_tpu/plugins/notears.py`.  The augmented-Lagrangian
subproblem is solved by projected Adam on the (w+, w-) split, as the JAX
package does, but as an eager loop of `inner_steps` steps where the JAX
package runs one jitted `lax.scan`: each step is one `torch.autograd.grad`
of the smooth objective through `torch.linalg.matrix_exp` (the
counterpart of `jax.scipy.linalg.expm`), whose trace carries its exact
gradient (`_TraceExp`).  The products run in full
float32 (`gp.full_f32`) whatever the caller has set, and Adam's bias
correction 1 - beta^t is the float32 power the MLP ensemble uses.

The outer loop (dual ascent on alpha, rho escalated while h fails to
fall 4x, capped at `rho_max`), the support threshold, cycle breaking and
the OLS refit are the JAX package's.  The loop reads h back to the host
once a subproblem, in float32 as the reference computes it.  h is a
cancellation (tr e^{W∘W} minus d) with about 1e-6 of absolute error at
d = 10, so two runs that differ in the last bits of the iterate may take
different rho branches; the result the tests hold is the contract: the
support after `support_threshold`, cycle breaking and the refit weights.

`simulate_dag` is a draw step (`draw_dag`, on the port's counter-based
generator) and a pure function of the draws (`dag_from_draws`), so the
tests can feed it the numbers `jax.random` drew.

Entry points take `device=` and default to the card (`"cuda"`); the CPU
is asked for explicitly.
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Sequence

import numpy as np
import torch

from .. import rng
from ..device import DeviceLike, resolve_device
from ..surrogate.gp import full_f32
from ..surrogate.mlp import _bias_correction


class _TraceExp(torch.autograd.Function):
    """tr(e^A) by `torch.linalg.matrix_exp`, with its exact gradient
    (e^A)^T (the derivative of tr(e^A) along H is tr(e^A H)): one matrix
    exponential a step, where autograd through matrix_exp would compute
    a second one, of twice the size, for the full Fréchet derivative."""

    @staticmethod
    def forward(ctx, a):
        e = torch.linalg.matrix_exp(a)
        ctx.save_for_backward(e)
        return torch.diagonal(e).sum()

    @staticmethod
    def backward(ctx, g):
        e, = ctx.saved_tensors
        return g * e.T


def h_func(w: torch.Tensor) -> torch.Tensor:
    """Acyclicity measure: tr(e^{W∘W}) - d; zero iff W is a DAG."""
    d = w.shape[0]
    return _TraceExp.apply(w * w) - d


def _smooth_obj(w, x, rho, alpha):
    """Least-squares loss + augmented-Lagrangian acyclicity terms (the
    smooth part of the subproblem; L1 is handled by the split)."""
    n = x.shape[0]
    r = x - x @ w
    loss = 0.5 / n * torch.sum(r * r)
    h = h_func(w)
    return loss + 0.5 * rho * h * h + alpha * h


@full_f32()
def _minimize_subproblem(w0: torch.Tensor, x: torch.Tensor,
                         rho: torch.Tensor, alpha: torch.Tensor,
                         lambda1: float, free: torch.Tensor, steps: int,
                         lr: float) -> torch.Tensor:
    """min_W smooth(W) + lambda1*||W||_1 via the (w+, w-) >= 0 split,
    solved with `steps` projected-Adam steps; `free` masks entries
    pinned to zero (diagonal, forbidden edges).  `rho` and `alpha` are
    float32 scalars on the iterate's device."""
    ws = torch.stack([torch.clamp_min(w0, 0.0), torch.clamp_min(-w0, 0.0)])
    m = torch.zeros_like(ws)
    v = torch.zeros_like(ws)
    for i in range(steps):
        wsg = ws.requires_grad_(True)
        w = (wsg[0] - wsg[1]) * free
        g, = torch.autograd.grad(_smooth_obj(w, x, rho, alpha), wsg)
        with torch.no_grad():
            # the L1 term lambda1 * sum(w+ + w-) adds lambda1 to every
            # entry's gradient: the same float sum autograd would form,
            # without its launches
            g = g + lambda1
            m = 0.9 * m + 0.1 * g
            v = 0.999 * v + 0.001 * g * g
            mh = m / _bias_correction(0.9, i + 1)
            vh = v / _bias_correction(0.999, i + 1)
            ws = ws.detach() - lr * mh / (torch.sqrt(vh) + 1e-8)
            ws = torch.clamp_min(ws, 0.0) * free[None]   # project
    return ((ws[0] - ws[1]) * free).detach()


def _ols_refit(x: np.ndarray, support: np.ndarray) -> np.ndarray:
    """Exact least-squares weights on a fixed DAG support: each column
    regressed on its support parents.  Undoes the L1 + penalty shrinkage
    of the augmented-Lagrangian iterate (whose job was structure, not
    magnitude)."""
    d = x.shape[1]
    w = np.zeros((d, d), np.float32)
    for j in range(d):
        parents = np.nonzero(support[:, j])[0]
        if len(parents) == 0:
            continue
        coef, *_ = np.linalg.lstsq(x[:, parents], x[:, j], rcond=None)
        w[parents, j] = coef
    return w


def _break_cycles(w: np.ndarray) -> np.ndarray:
    """Drop the smallest-|w| edge ON A CYCLE until the support is acyclic
    (the near-DAG iterate can carry tiny cycle-closing entries).
    Edges between topologically-sortable nodes are never touched — only
    the subgraph Kahn's algorithm cannot sort is cyclic."""
    w = w.copy()
    d = w.shape[0]
    while True:
        # Kahn's algorithm on the support; unsorted nodes form the
        # cycle-involved subgraph
        adj = w != 0
        indeg = adj.sum(0).copy()
        sorted_mask = np.zeros(d, bool)
        queue = [j for j in range(d) if indeg[j] == 0]
        while queue:
            u = queue.pop()
            sorted_mask[u] = True
            for v in np.nonzero(adj[u])[0]:
                indeg[v] -= 1
                if indeg[v] == 0:
                    queue.append(int(v))
        if sorted_mask.all():
            return w
        cyc = ~sorted_mask
        in_cycle_sub = adj & cyc[:, None] & cyc[None, :]
        nz = np.abs(np.where(in_cycle_sub, w, np.inf))
        i, j = np.unravel_index(np.argmin(nz), w.shape)
        w[i, j] = 0.0


def notears(x: np.ndarray, lambda1: float = 0.1, max_iter: int = 100,
            h_tol: float = 1e-5, w_threshold: float = 0.3,
            inner_steps: int = 400, lr: float = 2e-2,
            support_threshold: float = 0.1, rho_max: float = 1e8,
            forbidden: Optional[np.ndarray] = None,
            device: DeviceLike = "cuda",
            info: Optional[dict] = None) -> np.ndarray:
    """Learn a weighted DAG adjacency matrix from samples.

    Dual ascent on alpha with rho escalation while h fails to decrease
    4x, stop at h <= h_tol, threshold small weights.

    Parameters
    ----------
    x : [n, d] sample matrix (columns = variables).
    lambda1 : L1 edge sparsity weight.
    forbidden : optional [d, d] bool mask of edges forced to zero; the
        diagonal is always forced.
    device : where the subproblems run (default the card).
    info : if given, receives ``subproblems`` (solves run),
        ``adam_steps`` (their steps in all) and ``support`` (the [d, d]
        bool structure the refit ran on: the iterate past
        `support_threshold`, cycles broken).
    """
    dev = resolve_device(device)
    x = np.asarray(x, np.float32)
    n, d = x.shape
    x = x - x.mean(0)                       # NOTEARS assumes centered data
    # one global scale, so the fixed-step inner solver sees O(1)
    # magnitudes without losing the relative variances that identify
    # edge directions
    x = x / max(float(x.std()), 1e-8)
    free = 1.0 - np.eye(d, dtype=np.float32)
    if forbidden is not None:
        free = free * (1.0 - np.asarray(forbidden, np.float32))
    free_t = torch.from_numpy(free).to(dev)
    xt = torch.from_numpy(x).to(dev)

    def solve(w, rho, alpha):
        return _minimize_subproblem(
            w, xt, torch.tensor(rho, dtype=torch.float32, device=dev),
            torch.tensor(alpha, dtype=torch.float32, device=dev),
            lambda1, free_t, inner_steps, lr)

    # dual ascent with a rho cap: past ~1e8 the penalty dwarfs the data
    # term and the iterate collapses toward W=0; magnitudes come from the
    # OLS refit below, so h_tol only needs to certify the structure
    w_est = torch.zeros((d, d), device=dev)
    rho, alpha, h = 1.0, 0.0, np.inf
    solves = 0
    for _ in range(max_iter):
        if rho >= rho_max:
            break   # penalty saturated; accept the current iterate
        while rho < rho_max:
            w_new = solve(w_est, rho, alpha)
            solves += 1
            with full_f32():
                h_new = float(h_func(w_new))
            if h_new > 0.25 * h:
                rho *= 10
            else:
                break
        w_est, h = w_new, h_new
        alpha += rho * h
        if h <= h_tol:
            break
    # the iterate gives STRUCTURE only: support at a loose threshold,
    # break residual near-DAG cycles, refit magnitudes by OLS on the
    # support, then apply the final w_threshold
    w_sup = w_est.cpu().numpy().copy()
    w_sup[np.abs(w_sup) < support_threshold] = 0.0
    w_sup = _break_cycles(w_sup)
    if info is not None:
        info.update(subproblems=solves, adam_steps=solves * inner_steps,
                    support=w_sup != 0)
    w = _ols_refit(x, w_sup != 0)   # W is global-scale invariant
    w[np.abs(w) < w_threshold] = 0.0
    return w


# ----------------------------------------------------------------------
# integration with the tuning archive
def covariate_graph(covars: Sequence[dict], qor: Sequence[float],
                    lambda1: float = 0.1, w_threshold: float = 0.3,
                    device: DeviceLike = "cuda") -> dict:
    """Learn a DAG over per-trial covariates (`ut.feature` records) plus
    the QoR column; returns {'names': [...], 'w': [d, d] list,
    'drivers': [names with a direct edge into qor]}."""
    names = sorted({k for c in covars for k in c})
    rows = []
    for c, q in zip(covars, qor):
        if not all(k in c for k in names):
            continue
        if not np.isfinite(q):
            continue
        rows.append([float(c[k]) for k in names] + [float(q)])
    if len(rows) < 10:
        raise ValueError(
            f"need >= 10 complete covariate rows, have {len(rows)}")
    x = np.asarray(rows, np.float32)
    # standardized, so lambda1 is scale-free across covariate units; the
    # QoR is a sink (nothing is caused by the objective value): its
    # outgoing edges are forbidden
    x = (x - x.mean(0)) / np.maximum(x.std(0), 1e-8)
    qcol = len(names)
    forbid = np.zeros((qcol + 1, qcol + 1), bool)
    forbid[qcol, :] = True
    w = notears(x, lambda1=lambda1, w_threshold=w_threshold,
                forbidden=forbid, device=device)
    drivers = [names[i] for i in range(len(names)) if w[i, qcol] != 0.0]
    return {"names": names + ["qor"], "w": w.tolist(),
            "drivers": drivers}


class DagDraws(NamedTuple):
    edges: np.ndarray   # [k] distinct indices into the (i < j) pairs
    mag: np.ndarray     # [P] float32 edge magnitudes in w_range
    sign: np.ndarray    # [P] bool, True = positive
    z: np.ndarray       # [n_samples, d] float32 standard normals


def _pairs(d: int):
    return [(i, j) for j in range(d) for i in range(j)]


def draw_dag(gen: rng.Stream, d: int, n_edges: int, n_samples: int,
             w_range=(0.5, 2.0)) -> DagDraws:
    """The draws of a random linear-Gaussian SEM."""
    p = len(_pairs(d))
    edges = rng.choice_without_replacement(gen, 1, p, min(n_edges, p))[0]
    lo, hi = w_range
    mag = rng.uniform(gen, (p,)) * (hi - lo) + lo
    sign = rng.uniform(gen, (p,)) < 0.5
    z = rng.normal(gen, (n_samples, d))
    return DagDraws(*(t.cpu().numpy() for t in (edges, mag, sign, z)))


def dag_from_draws(draws: DagDraws, d: int, noise: float = 1.0):
    """(w [d, d], x [n, d]) of a SEM: lower-triangular W guarantees
    acyclicity; X solves x = W^T x + z."""
    pairs = _pairs(d)
    w = np.zeros((d, d), np.float32)
    mag = np.asarray(draws.mag, np.float32)
    sign = np.where(np.asarray(draws.sign), 1.0, -1.0)
    for k in np.asarray(draws.edges):
        i, j = pairs[int(k)]
        w[i, j] = mag[int(k)] * sign[int(k)]
    z = np.asarray(draws.z, np.float32) * noise
    # x (I - W) = z  =>  x = z (I - W)^{-1}
    x = z @ np.linalg.inv(np.eye(d, dtype=np.float32) - w)
    return w, x.astype(np.float32)


def simulate_dag(seed, d: int, n_edges: int, n_samples: int,
                 w_range=(0.5, 2.0), noise: float = 1.0,
                 device: DeviceLike = "cuda"):
    """Random linear-Gaussian SEM for tests: (w, x).  `seed` is an int
    or a `rng.Stream`; an int draws on `device`."""
    gen = (seed if isinstance(seed, rng.Stream)
           else rng.generator(seed, resolve_device(device)))
    return dag_from_draws(draw_dag(gen, d, n_edges, n_samples, w_range),
                          d, noise)
