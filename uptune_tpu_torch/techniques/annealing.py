"""Batched pseudo simulated annealing.

Counterpart of `uptune_tpu/techniques/annealing.py`: one annealing chain
over a linear cooling schedule (temperature 30 -> 0 over 100 steps,
looped).  Each step samples `batch` random (parameter, direction) moves
of the current state, scaled by exp(-(20 + t/100) / (temp + 1)) times a
uniform; observe() sorts the batch with the current state (a stable
argsort) and accepts the sel-th best, sel geometric with success
probability exp(-1/temp), or the global best once the chain is frozen.

The JAX state carries its own key for the acceptance draw, which
observe() splits; here that uniform is an observe draw (`draw_observe`),
so the state holds tensors only.
"""
from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

from .. import rng
from ..space.spec import CandBatch, Space
from .base import Best, Technique, register
from .pattern import MoveDraws, apply_moves, draw_moves


class SAState(NamedTuple):
    cur: CandBatch              # [1, ...] current chain state
    cur_qor: torch.Tensor       # scalar
    counter: torch.Tensor       # scalar i32: cooling-schedule position


class SADraws(NamedTuple):
    moves: MoveDraws
    mag: torch.Tensor           # [B, 1] U[0,1): the step's share


class PseudoAnnealingSearch(Technique):
    def __init__(self, batch: int = 32, t_hi: float = 30.0,
                 t_lo: float = 0.0, interval: int = 100,
                 scaling: float = 50.0,
                 name: str = "PseudoAnnealingSearch"):
        super().__init__(name)
        self.batch = batch
        self.t_hi = t_hi
        self.t_lo = t_lo
        self.interval = interval
        self.scaling = scaling

    def natural_batch(self, space: Space) -> int:
        return self.batch

    def _temp(self, counter: torch.Tensor) -> torch.Tensor:
        """Linear t_hi -> t_lo over `interval` steps, looping."""
        c = torch.remainder(counter, self.interval).to(torch.float32)
        return self.t_hi + (self.t_lo - self.t_hi) * c / self.interval

    def draw_init(self, space: Space, gen: rng.Stream) -> CandBatch:
        return space.random(gen, 1)

    def init_state(self, space: Space, draws: CandBatch) -> SAState:
        dev = draws.u.device
        return SAState(draws, torch.tensor(float("inf"), device=dev),
                       torch.zeros((), dtype=torch.int32, device=dev))

    def draw_propose(self, space: Space, gen: rng.Stream) -> SADraws:
        return SADraws(draw_moves(space, gen, self.batch),
                       rng.uniform(gen, (self.batch, 1)))

    def propose(self, space: Space, state: SAState, best: Best,
                draws: SADraws) -> Tuple[SAState, CandBatch]:
        temp = self._temp(state.counter)
        step = torch.exp(-(20.0 + state.counter.to(torch.float32) / 100.0)
                         / (temp + 1.0))
        cands = apply_moves(space, state.cur, step * draws.mag, draws.moves)
        return state, space.normalize(cands)

    def draw_observe(self, space: Space, gen: rng.Stream) -> torch.Tensor:
        """The scalar U[0,1) of the acceptance rule."""
        return rng.uniform(gen, ())

    def observe(self, space: Space, state: SAState, cands: CandBatch,
                qor: torch.Tensor, best: Best,
                draws: torch.Tensor) -> SAState:
        temp = self._temp(state.counter)
        # the current state joins the sorted pool (stable, as jnp.argsort)
        all_qor = torch.cat([qor, state.cur_qor[None]])
        order = torch.argsort(all_qor, stable=True)
        # sel ~ geometric(p), p = exp(-1/temp), in closed form
        p = torch.exp(-1.0 / torch.clamp_min(temp, 1e-6))
        sel = torch.where(
            p > 1e-9,
            torch.floor(torch.log(torch.clamp_min(draws, 1e-30))
                        / torch.log(torch.clamp_min(p, 1e-30))
                        ).to(torch.int32),
            0)
        sel = torch.remainder(sel, all_qor.shape[0]).to(torch.int64)
        pick = order.index_select(0, sel.reshape(1))

        def row(x_cands, x_cur):
            return torch.cat([x_cands, x_cur], dim=0).index_select(
                0, pick)[0]

        new_u = row(cands.u, state.cur.u)
        new_perms = tuple(row(c, p_) for c, p_ in zip(cands.perms,
                                                      state.cur.perms))
        new_qor = all_qor.index_select(0, pick)[0]
        # switch to the global best when frozen
        frozen = (p < 1e-4) & (best.qor < new_qor)
        new_u = torch.where(frozen, best.u, new_u)
        new_perms = tuple(torch.where(frozen, b, p_)
                          for b, p_ in zip(best.perms, new_perms))
        new_qor = torch.where(frozen, best.qor, new_qor)
        return SAState(
            CandBatch(new_u[None, :], tuple(p_[None, :] for p_ in new_perms)),
            new_qor, state.counter + 1)


register(PseudoAnnealingSearch())
