"""Batched CMA-ES: covariance-matrix-adaptation evolution strategy.

Counterpart of `uptune_tpu/techniques/cmaes.py`: standard (mu/mu_w,
lambda) CMA-ES with rank-1 and rank-mu covariance updates and cumulative
step-size adaptation, in the unit cube of the scalar lanes; no
permutation blocks (the arm does not support spaces that have them).
Each generation ends with one symmetric eigendecomposition of the
covariance, cached in the state for the next propose.

Three choices keep a generation reproducible across devices and under
`torch.func.vmap`:

* the matrix and vector products accumulate in float64 and round once
  to float32, so their results do not depend on how a BLAS library
  orders its sums (a single or a batched product, on the CPU or the
  card);
* `torch.linalg.eigh` solves the covariance as a batch of two copies:
  on CUDA, PyTorch sends a batch of small matrices to one cuSOLVER
  routine and a single matrix to another, so the batch of two keeps a
  single engine on the batched engine's routine.  On CUDA `eigh` also
  reads its error flags on the host: one synchronisation a generation;
* no tensor is divided by a Python float (see `observe`).

Eigenvectors are defined up to sign, so the port's basis may differ from
the JAX package's column by column; B diag(lambda) B^T and the spectrum
agree.
"""
from __future__ import annotations

import math
from typing import NamedTuple, Tuple

import numpy as np
import torch

from .. import rng
from ..space.spec import CandBatch, Space
from .base import Best, Technique, register


class CMAState(NamedTuple):
    mean: torch.Tensor      # [D]
    cov: torch.Tensor       # [D, D]
    sigma: torch.Tensor     # scalar step size
    p_sigma: torch.Tensor   # [D] step-size evolution path
    p_c: torch.Tensor       # [D] covariance evolution path
    gen: torch.Tensor       # scalar i32 generation counter
    # the eigendecomposition of `cov`, refreshed whenever cov changes
    eig_b: torch.Tensor     # [D, D] eigenvector basis
    eig_sq: torch.Tensor    # [D] sqrt(eigenvalues)
    eig_isq: torch.Tensor   # [D] 1/sqrt(eigenvalues)


def _mm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b summed in float64, rounded once to float32."""
    return torch.matmul(a.to(torch.float64),
                        b.to(torch.float64)).to(torch.float32)


class CMAES(Technique):
    def __init__(self, population_size: int = 32, sigma0: float = 0.3,
                 name: str = "CMAES"):
        super().__init__(name)
        self.population_size = int(population_size)
        self.sigma0 = float(sigma0)
        self._w = {}    # (D, device) -> the recombination weights [mu]

    def natural_batch(self, space: Space) -> int:
        return self.population_size

    def supports(self, space: Space) -> bool:
        return space.n_scalar >= 2 and not space.perm_sizes

    def _consts(self, d: int):
        """The strategy constants (they depend on D and lambda only)."""
        lam = self.population_size
        mu = lam // 2
        w_np = np.log(mu + 0.5) - np.log(np.arange(1, mu + 1))
        w_np = w_np / w_np.sum()                      # [mu], sums to 1
        mu_eff = 1.0 / float((w_np ** 2).sum())
        c_sigma = (mu_eff + 2.0) / (d + mu_eff + 5.0)
        d_sigma = (1.0 + 2.0 * max(0.0, math.sqrt((mu_eff - 1.0)
                                                  / (d + 1.0)) - 1.0)
                   + c_sigma)
        c_c = (4.0 + mu_eff / d) / (d + 4.0 + 2.0 * mu_eff / d)
        c_1 = 2.0 / ((d + 1.3) ** 2 + mu_eff)
        c_mu = min(1.0 - c_1,
                   2.0 * (mu_eff - 2.0 + 1.0 / mu_eff)
                   / ((d + 2.0) ** 2 + mu_eff))
        # E||N(0, I_d)||
        chi_d = math.sqrt(d) * (1.0 - 1.0 / (4.0 * d)
                                + 1.0 / (21.0 * d * d))
        return mu, w_np.astype(np.float32), mu_eff, c_sigma, d_sigma, \
            c_c, c_1, c_mu, chi_d

    @staticmethod
    def _eig(cov: torch.Tensor):
        """Symmetric eigendecomposition with a clamped spectrum:
        (B, sqrt(lambda), 1/sqrt(lambda)); see the module docstring for
        the batch of two."""
        cov = 0.5 * (cov + cov.mT)
        lam, b = torch.linalg.eigh(torch.stack((cov, cov)))
        lam = torch.clamp(lam[0], 1e-10, 1e6)
        return b[0], torch.sqrt(lam), 1.0 / torch.sqrt(lam)

    def draw_init(self, space: Space, gen: rng.Stream) -> torch.device:
        """No numbers (the initial state is fixed): the device the state
        lives on."""
        return gen.device

    def init_state(self, space: Space, draws: torch.device) -> CMAState:
        d = space.n_scalar
        dev = draws
        f32 = dict(dtype=torch.float32, device=dev)
        return CMAState(
            torch.full((d,), 0.5, **f32), torch.eye(d, **f32),
            torch.tensor(self.sigma0, **f32), torch.zeros((d,), **f32),
            torch.zeros((d,), **f32),
            torch.zeros((), dtype=torch.int32, device=dev),
            torch.eye(d, **f32), torch.ones((d,), **f32),
            torch.ones((d,), **f32))

    def draw_propose(self, space: Space, gen: rng.Stream) -> torch.Tensor:
        """[lambda, D] standard normals."""
        return rng.normal(gen, (self.population_size, space.n_scalar))

    def propose(self, space: Space, state: CMAState, best: Best,
                draws: torch.Tensor) -> Tuple[CMAState, CandBatch]:
        y = _mm(draws * state.eig_sq[None, :], state.eig_b.mT)  # ~ N(0, C)
        u = torch.clamp(state.mean[None, :] + state.sigma * y, 0.0, 1.0)
        return state, space.normalize(CandBatch(u, ()))

    def observe(self, space: Space, state: CMAState, cands: CandBatch,
                qor: torch.Tensor, best: Best, draws=None) -> CMAState:
        d = space.n_scalar
        (mu, w_np, mu_eff, c_sigma, d_sigma, c_c, c_1, c_mu,
         chi_d) = self._consts(d)
        w = self._w.get((d, qor.device))
        if w is None:    # one host-to-device copy per device, not a step
            w = self._w[(d, qor.device)] = torch.as_tensor(
                w_np, device=qor.device)

        # selection: the mu best of the generation (failures rank last)
        q = torch.where(torch.isfinite(qor), qor, 1e30)
        order = torch.argsort(q, stable=True)[:mu]
        # y recovered from the evaluated candidates (after the boundary
        # clip: the repair-and-update treatment)
        y_sel = (cands.u[order] - state.mean[None, :]) / state.sigma
        y_w = _mm(w, y_sel)                                     # [D]

        mean = state.mean + state.sigma * y_w
        b, isq = state.eig_b, state.eig_isq
        inv_sqrt_y = _mm(_mm(y_w, b) * isq, b.mT)               # C^-1/2 y_w
        p_sigma = ((1.0 - c_sigma) * state.p_sigma
                   + math.sqrt(c_sigma * (2.0 - c_sigma) * mu_eff)
                   * inv_sqrt_y)
        gen = state.gen + 1
        ps_norm = torch.sqrt(_mm(p_sigma, p_sigma))
        # stalled-path indicator (Hansen's h_sigma)
        denom = torch.sqrt(1.0 - (1.0 - c_sigma) ** (2.0 * gen))
        h_sigma = (ps_norm / denom
                   < (1.4 + 2.0 / (d + 1.0)) * chi_d).to(torch.float32)
        p_c = ((1.0 - c_c) * state.p_c
               + h_sigma * math.sqrt(c_c * (2.0 - c_c) * mu_eff) * y_w)

        rank1 = (p_c[:, None] * p_c[None, :]
                 + (1.0 - h_sigma) * c_c * (2.0 - c_c) * state.cov)
        rank_mu = _mm((y_sel * w[:, None]).mT, y_sel)           # sum w y y^T
        cov = ((1.0 - c_1 - c_mu) * state.cov
               + c_1 * rank1 + c_mu * rank_mu)
        # times the reciprocal, not `/ chi_d`: on CUDA PyTorch divides by
        # a Python float through a reciprocal that it rounds one way
        # outside torch.func.vmap and another way inside it
        sigma = state.sigma * torch.exp(
            (c_sigma / d_sigma) * (ps_norm * (1.0 / chi_d) - 1.0))
        sigma = torch.clamp(sigma, 1e-8, 1.0)
        nb, nsq, nisq = self._eig(cov)   # the generation's one eigh
        return CMAState(mean, cov, sigma, p_sigma, p_c, gen, nb, nsq, nisq)


register(CMAES())
