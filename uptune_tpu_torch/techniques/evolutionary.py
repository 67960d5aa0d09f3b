"""Greedy evolutionary techniques, batched.

Counterpart of `uptune_tpu/techniques/evolutionary.py`.  Greedy selection
always picks the incumbent global best, so one step emits N independent
mutations of the best configuration (uniform redraw, or sigma-scaled
Gaussian noise with a random manipulator on complex parameters).  Before
any result exists every row falls back to an independent random config.

The GA crossover variants (`crossover=`) are not ported yet: their
permutation crossovers come with a later slice of the port.
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

from .. import rng
from ..space.spec import CandBatch, Space
from .base import Best, Technique, register
from .common import MutateDraws, draw_mutate_batch, mutate_batch


class GreedyDraws(NamedTuple):
    fallback: CandBatch     # random rows used while no best exists
    mutate: MutateDraws


class GreedyMutation(Technique):
    """UniformGreedyMutation / NormalGreedyMutation."""

    def __init__(self, batch: int = 32, mutation_rate: float = 0.1,
                 must_mutate_count: int = 1, sigma: Optional[float] = None,
                 crossover: Optional[str] = None,
                 name: str = "GreedyMutation"):
        super().__init__(name)
        if crossover is not None:
            raise NotImplementedError(
                f"GreedyMutation(crossover={crossover!r}): the permutation "
                f"crossovers come with a later slice of the port")
        self.batch = batch
        self.mutation_rate = mutation_rate
        self.must_mutate_count = must_mutate_count
        self.sigma = sigma

    def natural_batch(self, space: Space) -> int:
        return self.batch

    def init_state(self, space: Space, draws=None):
        return ()

    def draw_propose(self, space: Space, gen: rng.Stream) -> GreedyDraws:
        return GreedyDraws(space.random(gen, self.batch),
                           draw_mutate_batch(space, gen, self.batch,
                                             self.sigma))

    def propose(self, space: Space, state, best: Best,
                draws: GreedyDraws) -> Tuple[tuple, CandBatch]:
        n = self.batch
        fb = draws.fallback
        have = torch.isfinite(best.qor)
        parent = CandBatch(
            torch.where(have, best.u[None, :].expand(n, -1), fb.u),
            tuple(torch.where(have, p[None, :].expand(n, -1), f)
                  for p, f in zip(best.perms, fb.perms)))
        cands = mutate_batch(space, parent, self.mutation_rate,
                             self.must_mutate_count, self.sigma,
                             draws.mutate)
        return state, space.normalize(cands)

    def observe(self, space, state, cands, qor, best, draws=None):
        return state


def _register_all():
    register(GreedyMutation(mutation_rate=0.10, name="ga-base"))
    for rate in (0.05, 0.10, 0.20):
        register(GreedyMutation(
            mutation_rate=rate,
            name=f"UniformGreedyMutation{int(rate*100):02d}"))
        register(GreedyMutation(
            mutation_rate=rate, sigma=0.1,
            name=f"NormalGreedyMutation{int(rate*100):02d}"))


_register_all()
