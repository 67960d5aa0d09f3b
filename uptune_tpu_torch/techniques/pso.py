"""Batched particle swarm optimization.

Counterpart of `uptune_tpu/techniques/pso.py`: N particles, each with a
position, per-lane velocity and local best, all moved by one propose()
(op3_swarm with c = omega, c1 = phi_l, c2 = phi_g).  Scalar lanes follow
the velocity form, BOOL lanes the sigmoid coin, other complex lanes the
stochastic (current / local / global) mix (`ops/numeric.swarm`).  A
permutation block is crossed, with probability 1 - omega, with the
global best (probability phi_g) or the local best, by the technique's
crossover at strength 0.3; both crosses take the same per-row draws, as
the JAX package's share their per-row keys.  The first propose() emits
the initial random positions.
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

from .. import rng
from ..ops import numeric as nops
from ..ops import perm as pops
from ..space import params as P
from ..space.spec import CandBatch, Space
from .base import Best, Technique, register


class PSOState(NamedTuple):
    pos: CandBatch              # [N, ...] particle positions
    vel: torch.Tensor           # [N, D] scalar-lane velocities
    lbest: CandBatch            # [N, ...] per-particle best position
    lbest_qor: torch.Tensor     # [N]
    bootstrapped: torch.Tensor  # scalar bool


class PSODraws(NamedTuple):
    swarm: Tuple[torch.Tensor, ...]   # (r1, r2, coin, pick), each [N, D]
    move: torch.Tensor                # [N, 1] U[0,1): > omega moves perms
    partner: torch.Tensor             # [N, 1] U[0,1): < phi_g crosses g
    cross: Tuple[Optional[torch.Tensor], ...]   # per perm block


def _cross_d(size: int) -> int:
    return max(1, int(round(size * 0.3)))


class PSO(Technique):
    def __init__(self, crossover: str = "OX1", N: int = 30,
                 omega: float = 0.5, phi_l: float = 0.5, phi_g: float = 0.5,
                 name: Optional[str] = None):
        super().__init__(name or f"pso-{crossover}")
        self.crossover = crossover
        self.N = N
        self.omega = omega
        self.phi_l = phi_l
        self.phi_g = phi_g

    def natural_batch(self, space: Space) -> int:
        return self.N

    def draw_init(self, space: Space, gen: rng.Stream) -> CandBatch:
        return space.random(gen, self.N)

    def init_state(self, space: Space, draws: CandBatch) -> PSOState:
        dev = draws.u.device
        return PSOState(
            draws, torch.zeros((self.N, space.n_scalar), device=dev),
            draws, torch.full((self.N,), float("inf"), device=dev),
            torch.zeros((), dtype=torch.bool, device=dev))

    def draw_propose(self, space: Space, gen: rng.Stream) -> PSODraws:
        N, D = self.N, space.n_scalar
        cx = pops.CROSSOVERS[self.crossover]
        return PSODraws(
            tuple(rng.uniform(gen, (N, D)) for _ in range(4)),
            rng.uniform(gen, (N, 1)), rng.uniform(gen, (N, 1)),
            tuple(cx.draw(gen, N, size, _cross_d(size))
                  for size in space.perm_sizes))

    def propose(self, space: Space, state: PSOState, best: Best,
                draws: PSODraws) -> Tuple[PSOState, CandBatch]:
        N = self.N
        t = space.tables(state.vel.device)
        have = torch.isfinite(best.qor)
        gbest_u = torch.where(have, best.u, state.pos.u[0])
        new_u, new_vel = nops.swarm(
            state.pos.u, state.lbest.u, gbest_u[None, :], state.vel,
            t.complex_mask[None, :], (t.kind == P.BOOL)[None, :],
            *draws.swarm, c=self.omega, c1=self.phi_l, c2=self.phi_g)

        # permutation blocks: a crossover with the local or global best
        coin_move = draws.move > self.omega
        coin_partner = draws.partner < self.phi_g
        cx = pops.CROSSOVERS[self.crossover]
        perms = []
        for d, pm, lb, gb, size in zip(draws.cross, state.pos.perms,
                                       state.lbest.perms, best.perms,
                                       space.perm_sizes):
            k = _cross_d(size)
            gb_rows = torch.where(have, gb[None, :].expand(N, -1), pm)
            with_g = cx.apply(pm, gb_rows, k, d)
            with_l = cx.apply(pm, lb, k, d)
            crossed = torch.where(coin_partner, with_g, with_l)
            perms.append(torch.where(coin_move, crossed, pm))

        moved = space.normalize(CandBatch(new_u, tuple(perms)))
        boot = state.bootstrapped
        out = CandBatch(
            torch.where(boot, moved.u, state.pos.u),
            tuple(torch.where(boot, m, p)
                  for m, p in zip(moved.perms, state.pos.perms)))
        vel = torch.where(boot, new_vel, state.vel)
        return PSOState(out, vel, state.lbest, state.lbest_qor,
                        torch.ones_like(boot)), out

    def observe(self, space: Space, state: PSOState, cands: CandBatch,
                qor: torch.Tensor, best: Best, draws=None) -> PSOState:
        better = qor < state.lbest_qor
        lbest = CandBatch(
            torch.where(better[:, None], cands.u, state.lbest.u),
            tuple(torch.where(better[:, None], c, p)
                  for c, p in zip(cands.perms, state.lbest.perms)))
        return state._replace(lbest=lbest,
                              lbest_qor=torch.minimum(state.lbest_qor, qor))


for _cx in ("OX3", "OX1", "PMX", "PX", "CX"):
    register(PSO(crossover=_cx))
