"""Batched differential evolution.

Counterpart of `uptune_tpu/techniques/de.py`: synchronous DE — every
member proposes its replacement each step, with the global best appended
to the parent pool (information sharing), per-param crossover coin < cr
with n_cross forced, cfg = x1 + F*(x2 - x3), F ~ U(0.5, 1).  The first
propose emits the random initial population itself; observe() keeps a
candidate where it beats its member.
"""
from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

from .. import rng
from ..space.spec import CandBatch, Space
from .base import Best, Technique, register
from .common import (LinearDraws, MaskDraws, de_linear_batch,
                     draw_de_linear_batch, draw_param_mutation_mask,
                     param_mutation_mask)


class DEState(NamedTuple):
    pop: CandBatch              # [P, ...] member configurations
    qor: torch.Tensor           # [P] member QoR (+inf = not yet measured)
    bootstrapped: torch.Tensor  # scalar bool: initial population submitted?


class DEDraws(NamedTuple):
    picks: torch.Tensor    # [P, 3] distinct parent-pool indices per member
    f: torch.Tensor        # [P, 1] U[0,1)
    cross: MaskDraws
    linear: LinearDraws


class DifferentialEvolution(Technique):
    def __init__(self, population_size: int = 30, cr: float = 0.9,
                 n_cross: int = 1, information_sharing: int = 1,
                 name: str = "DifferentialEvolution"):
        super().__init__(name)
        self.population_size = population_size
        self.cr = cr
        self.n_cross = n_cross
        self.information_sharing = information_sharing

    def natural_batch(self, space: Space) -> int:
        return self.population_size

    def draw_init(self, space: Space, gen: rng.Stream) -> CandBatch:
        return space.random(gen, self.population_size)

    def init_state(self, space: Space, draws: CandBatch) -> DEState:
        P = self.population_size
        dev = draws.u.device
        return DEState(draws,
                       torch.full((P,), float("inf"), dtype=torch.float32,
                                  device=dev),
                       torch.zeros((), dtype=torch.bool, device=dev))

    def draw_propose(self, space: Space, gen: rng.Stream) -> DEDraws:
        P = self.population_size
        n_pool = P - 1 + self.information_sharing
        return DEDraws(
            rng.choice_without_replacement(gen, P, n_pool, 3),
            rng.uniform(gen, (P, 1)),
            draw_param_mutation_mask(space, gen, P),
            draw_de_linear_batch(space, gen, P))

    def propose(self, space: Space, state: DEState, best: Best,
                draws: DEDraws) -> Tuple[DEState, CandBatch]:
        P = self.population_size
        dev = state.qor.device
        picks = draws.picks.to(torch.int64)
        # pool index -> population index (skip self); >= P-1 means "best"
        member = torch.arange(P, device=dev)[:, None]
        pop_idx = torch.where(picks >= member, picks + 1, picks)
        is_best = picks >= (P - 1)
        have_best = torch.isfinite(best.qor)
        use_best = is_best & have_best                   # [P, 3]

        def gather(x_pop, x_best):
            rows = x_pop[torch.clamp(pop_idx, 0, P - 1)]   # [P, 3, ...]
            ub = use_best.reshape(use_best.shape + (1,) * (rows.dim() - 2))
            return torch.where(ub, x_best.expand_as(rows), rows)

        xs_u = gather(state.pop.u, best.u)
        xs_perms = tuple(gather(pp, bp)
                         for pp, bp in zip(state.pop.perms, best.perms))

        def parent(j: int) -> CandBatch:
            return CandBatch(xs_u[:, j], tuple(p[:, j] for p in xs_perms))

        f = draws.f / 2.0 + 0.5                           # U(0.5, 1)
        cross = param_mutation_mask(space, P, self.cr, self.n_cross,
                                    draws.cross)
        cands = de_linear_batch(space, state.pop, parent(0), parent(1),
                                parent(2), f, cross, draws.linear)
        cands = space.normalize(cands)

        # bootstrap: emit the unsubmitted initial population instead
        boot = state.bootstrapped
        out = CandBatch(
            torch.where(boot, cands.u, state.pop.u),
            tuple(torch.where(boot, c, p)
                  for c, p in zip(cands.perms, state.pop.perms)))
        return state._replace(bootstrapped=torch.ones_like(boot)), out

    def observe(self, space: Space, state: DEState, cands: CandBatch,
                qor: torch.Tensor, best: Best, draws=None) -> DEState:
        # candidate i replaces member i if strictly better (also covers the
        # bootstrap generation, member qor = +inf)
        better = qor < state.qor
        pop = CandBatch(
            torch.where(better[:, None], cands.u, state.pop.u),
            tuple(torch.where(better[:, None], c, p)
                  for c, p in zip(cands.perms, state.pop.perms)))
        return DEState(pop, torch.minimum(state.qor, qor),
                       state.bootstrapped)


register(DifferentialEvolution())
register(DifferentialEvolution(cr=0.2, name="DifferentialEvolutionAlt"))
register(DifferentialEvolution(population_size=100, cr=0.2,
                               name="DifferentialEvolution_20_100"))
