"""Greedy evolutionary techniques, batched.

Counterpart of `uptune_tpu/techniques/evolutionary.py`.  Greedy selection
always picks the incumbent global best, so one step emits N independent
mutations of the best configuration (uniform redraw, or sigma-scaled
Gaussian noise with a random manipulator on complex parameters).  Before
any result exists every row falls back to an independent random config.

The GA variants (`crossover=`) first cross the permutation blocks of two
selected parents with a named crossover (PX/PMX/CX/OX1/OX3) at
d = size * crossover_strength on blocks of 7 or more items, on the rows
whose coin falls below `crossover_rate`.  With greedy selection both
parents are the incumbent, as in the JAX package, which keeps the call
for parity.
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

from .. import rng
from ..space.spec import CandBatch, Space
from .base import Best, Technique, register
from .common import (MutateDraws, crossover_perms, draw_crossover_perms,
                     draw_mutate_batch, mutate_batch)


class GreedyDraws(NamedTuple):
    fallback: CandBatch     # random rows used while no best exists
    mutate: MutateDraws
    # the GA crossover (None without one, or on a space without perms):
    # per perm block the crossover's draws, and [B, 1] U[0,1) coins
    cross: Optional[tuple] = None
    cross_coin: Optional[torch.Tensor] = None


class GreedyMutation(Technique):
    """UniformGreedyMutation / NormalGreedyMutation / GA / GGA family."""

    def __init__(self, batch: int = 32, mutation_rate: float = 0.1,
                 crossover_rate: float = 0.0, must_mutate_count: int = 1,
                 sigma: Optional[float] = None,
                 crossover: Optional[str] = None,
                 crossover_strength: float = 1.0 / 3.0,
                 name: str = "GreedyMutation"):
        super().__init__(name)
        self.batch = batch
        self.mutation_rate = mutation_rate
        self.crossover_rate = crossover_rate
        self.must_mutate_count = must_mutate_count
        self.sigma = sigma
        self.crossover = crossover
        self.crossover_strength = crossover_strength

    def natural_batch(self, space: Space) -> int:
        return self.batch

    def init_state(self, space: Space, draws=None):
        return ()

    def _crosses(self, space: Space) -> bool:
        return self.crossover is not None and bool(space.perm_sizes)

    def draw_propose(self, space: Space, gen: rng.Stream) -> GreedyDraws:
        n = self.batch
        fallback = space.random(gen, n)
        cross = coin = None
        if self._crosses(space):
            cross = draw_crossover_perms(space, gen, n, self.crossover,
                                         self.crossover_strength)
            coin = rng.uniform(gen, (n, 1))
        return GreedyDraws(fallback,
                           draw_mutate_batch(space, gen, n, self.sigma),
                           cross, coin)

    def propose(self, space: Space, state, best: Best,
                draws: GreedyDraws) -> Tuple[tuple, CandBatch]:
        n = self.batch
        fb = draws.fallback
        have = torch.isfinite(best.qor)
        parent = CandBatch(
            torch.where(have, best.u[None, :].expand(n, -1), fb.u),
            tuple(torch.where(have, p[None, :].expand(n, -1), f)
                  for p, f in zip(best.perms, fb.perms)))
        cands = parent
        if self._crosses(space):
            crossed = crossover_perms(space, parent, parent, parent,
                                      self.crossover, draws.cross,
                                      self.crossover_strength)
            do = draws.cross_coin < self.crossover_rate
            cands = CandBatch(cands.u, tuple(
                torch.where(do, c, p)
                for c, p in zip(crossed.perms, cands.perms)))
        cands = mutate_batch(space, cands, self.mutation_rate,
                             self.must_mutate_count, self.sigma,
                             draws.mutate)
        return state, space.normalize(cands)

    def observe(self, space, state, cands, qor, best, draws=None):
        return state


class GlobalGA(GreedyMutation):
    """globalGA: a crossover that copies `crossover_strength * n_params`
    values from parent 2 into parent 1 before mutation.  With greedy
    selection both parents are the incumbent, so the copy is an identity,
    as in the JAX package."""


def _register_all():
    for cx in ("OX3", "OX1", "PX", "CX", "PMX"):
        register(GreedyMutation(mutation_rate=0.10, crossover_rate=0.8,
                                crossover=cx, name=f"ga-{cx}"))
    register(GreedyMutation(mutation_rate=0.10, name="ga-base"))
    for rate in (0.05, 0.10, 0.20):
        register(GreedyMutation(
            mutation_rate=rate,
            name=f"UniformGreedyMutation{int(rate*100):02d}"))
        register(GreedyMutation(
            mutation_rate=rate, sigma=0.1,
            name=f"NormalGreedyMutation{int(rate*100):02d}"))
    register(GlobalGA(mutation_rate=0.1, sigma=0.1, crossover_rate=0.5,
                      crossover_strength=0.2, name="GGA"))


_register_all()
