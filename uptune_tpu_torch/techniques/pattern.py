"""Batched pattern (compass) search.

Counterpart of `uptune_tpu/techniques/pattern.py`: a center
configuration and a step size; one step samples `batch` random
(parameter, direction) moves at the current step size (a random
manipulator on a chosen permutation block), and observe() moves the
center to the global best found elsewhere, else to the best improving
point, else halves the step.
"""
from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

from .. import rng
from ..space.spec import CandBatch, Space
from .base import Best, Technique, register, take_row
from .common import (PermOpDraws, draw_perm_random_op, mutate_perm_random_op,
                     n_params)


class PatternState(NamedTuple):
    center: CandBatch           # [1, ...]
    center_qor: torch.Tensor    # scalar
    step: torch.Tensor          # scalar f32


class MoveDraws(NamedTuple):
    """One random (parameter, direction) move per row."""
    which: torch.Tensor                 # [B] int64 parameter index
    direction: torch.Tensor             # [B, 1] U[0,1): < 0.5 is down
    perms: Tuple[PermOpDraws, ...]      # per perm block


def draw_moves(space: Space, gen: rng.Stream, n: int) -> MoveDraws:
    return MoveDraws(
        rng.randint(gen, (n,), 0, n_params(space)),
        rng.uniform(gen, (n, 1)),
        tuple(draw_perm_random_op(gen, n, s) for s in space.perm_sizes))


def apply_moves(space: Space, center: CandBatch, mag: torch.Tensor,
                draws: MoveDraws) -> CandBatch:
    """Each row moves one parameter of the [1, ...] `center`: a scalar
    lane up or down by `mag` (clipped to [0, 1]), or a permutation block
    by a random manipulator."""
    n = draws.which.shape[0]
    which = draws.which.to(torch.int64)
    direction = torch.where(draws.direction < 0.5, -1.0, 1.0)
    lanes = torch.arange(space.n_scalar, device=which.device)
    lane_sel = which[:, None] == lanes[None, :]
    u = torch.clamp(center.u.expand(n, -1) + lane_sel * direction * mag,
                    0.0, 1.0)
    perms = []
    for k, d in enumerate(draws.perms):
        pm = center.perms[k].expand(n, -1)
        perms.append(mutate_perm_random_op(pm, which == space.n_scalar + k,
                                           d))
    return CandBatch(u, tuple(perms))


class PatternSearch(Technique):
    def __init__(self, batch: int = 32, initial_step: float = 0.1,
                 name: str = "PatternSearch"):
        super().__init__(name)
        self.batch = batch
        self.initial_step = initial_step

    def natural_batch(self, space: Space) -> int:
        return self.batch

    def draw_init(self, space: Space, gen: rng.Stream) -> CandBatch:
        return space.random(gen, 1)

    def init_state(self, space: Space, draws: CandBatch) -> PatternState:
        dev = draws.u.device
        return PatternState(
            draws, torch.tensor(float("inf"), device=dev),
            torch.tensor(self.initial_step, dtype=torch.float32,
                         device=dev))

    def draw_propose(self, space: Space, gen: rng.Stream) -> MoveDraws:
        return draw_moves(space, gen, self.batch)

    def propose(self, space: Space, state: PatternState, best: Best,
                draws: MoveDraws) -> Tuple[PatternState, CandBatch]:
        cands = apply_moves(space, state.center, state.step, draws)
        return state, space.normalize(cands)

    def observe(self, space: Space, state: PatternState, cands: CandBatch,
                qor: torch.Tensor, best: Best,
                draws=None) -> PatternState:
        i = torch.argmin(qor).reshape(1)
        best_pt_qor = take_row(qor, i)
        improved = best_pt_qor < state.center_qor
        # priority: a global best found elsewhere > an improving point >
        # shrink
        adopt_global = ((best.qor < state.center_qor)
                        & (best.qor < best_pt_qor))
        new_u = torch.where(adopt_global, best.u,
                            torch.where(improved, take_row(cands.u, i),
                                        state.center.u[0]))
        new_perms = tuple(
            torch.where(adopt_global, b,
                        torch.where(improved, take_row(c, i), p[0]))
            for b, c, p in zip(best.perms, cands.perms, state.center.perms))
        new_qor = torch.where(adopt_global, best.qor,
                              torch.minimum(state.center_qor, best_pt_qor))
        shrink = (~improved) & (~adopt_global)
        new_step = torch.where(shrink, state.step * 0.5, state.step)
        return PatternState(
            CandBatch(new_u[None, :], tuple(p[None, :] for p in new_perms)),
            new_qor, new_step)


register(PatternSearch())
