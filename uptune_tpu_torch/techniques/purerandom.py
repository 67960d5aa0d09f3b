"""Uniform random search (`PureRandom`).  Stateless: every step emits a
fresh uniform batch — the draws are the proposal."""
from __future__ import annotations

from .. import rng
from ..space.spec import CandBatch, Space
from .base import Best, Technique, register


class PureRandom(Technique):
    def __init__(self, batch: int = 64, name: str = "PureRandom"):
        super().__init__(name)
        self.batch = batch

    def natural_batch(self, space: Space) -> int:
        return self.batch

    def init_state(self, space: Space, draws=None):
        return ()

    def draw_propose(self, space: Space, gen: rng.Stream) -> CandBatch:
        return space.random(gen, self.batch)

    def propose(self, space: Space, state, best: Best, draws: CandBatch):
        return state, draws

    def observe(self, space, state, cands, qor, best, draws=None):
        return state


register(PureRandom())
