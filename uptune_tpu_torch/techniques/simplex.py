"""Batched Nelder-Mead.

Counterpart of `uptune_tpu/techniques/simplex.py` (`NelderMead`; Torczon
and the multi-simplex meta-technique come with a later slice).  One round
proposes the whole decision tree at once — reflection, expansion, outside
and inside contraction, and the S-1 shrink points — and observe() applies
the decision rules branchlessly.  Simplex geometry lives on the scalar
unit lanes; permutation blocks ride along from the seed point.  On
convergence the simplex restarts around the global best.

The JAX state carries its own restart key (`SimplexState.key`); here the
restart draws come from the engine's key through `draw_observe`,
so the state holds tensors only.
"""
from __future__ import annotations

import math
from typing import NamedTuple, Optional, Tuple

import torch

from .. import rng
from ..space.spec import CandBatch, Space
from .base import Best, Technique, register

INIT, LOOP = 0, 1


class SimplexState(NamedTuple):
    pts_u: torch.Tensor               # [S, D] simplex point unit values
    vals: torch.Tensor                # [S] measured QoR (+inf before INIT)
    perms: Tuple[torch.Tensor, ...]   # each [s_k]: shared seed ordering
    phase: torch.Tensor               # scalar i32: INIT or LOOP
    stale: torch.Tensor               # scalar i32: rounds without improvement


class SimplexInitDraws(NamedTuple):
    seed: CandBatch                   # one random config
    others: Optional[torch.Tensor]    # [S-1, D] U[0,1) ("random" style)


class RestartDraws(NamedTuple):
    seed_u: torch.Tensor              # [D] U[0,1): seed while no best exists
    others: Optional[torch.Tensor]    # [S-1, D] U[0,1) ("random" style)


def _simplex_size(space: Space) -> int:
    return space.n_scalar + 1


def _centroid(pts: torch.Tensor) -> torch.Tensor:
    """The mean of the S simplex points as XLA computes `jnp.mean(pts, 0)`:
    the rows summed in order, then times the f32 reciprocal of S.
    `torch.mean` (and `torch.cumsum`, which accumulates f32 in f64 on the
    CPU) round differently, and the reflection amplifies the ulp."""
    acc = pts[0]
    for row in pts[1:]:
        acc = acc + row
    return acc * (1.0 / pts.shape[0])


class NelderMead(Technique):
    def __init__(self, init_style: str, name: str, alpha: float = 2.0,
                 gamma: float = 2.0, beta: float = 0.5, sigma: float = 0.5,
                 edge: float = 0.1):
        super().__init__(name)
        if init_style not in ("random", "right", "regular"):
            raise ValueError(init_style)
        self.init_style = init_style
        self.edge = edge
        self.alpha = alpha
        self.gamma = gamma
        self.beta = beta
        self.sigma = sigma

    def supports(self, space: Space) -> bool:
        return space.n_scalar >= 1

    def natural_batch(self, space: Space) -> int:
        return _simplex_size(space) + 3

    # ---- initial simplex (Random/Right/Regular mixins) ---------------------
    def _draw_others(self, space: Space,
                     gen: rng.Stream) -> Optional[torch.Tensor]:
        if self.init_style != "random":
            return None
        return rng.uniform(gen, (_simplex_size(space) - 1, space.n_scalar))

    def _initial_simplex(self, space: Space, seed_u: torch.Tensor,
                         others: Optional[torch.Tensor]) -> torch.Tensor:
        D = space.n_scalar
        if self.init_style == "random":
            return torch.cat([seed_u[None, :], others], dim=0)
        eye = torch.eye(D, dtype=torch.float32, device=seed_u.device)
        if self.init_style == "right":
            shift = torch.where(seed_u <= 0.5, self.edge, -self.edge)
            others = seed_u[None, :] + eye * shift[None, :]
            return torch.cat([seed_u[None, :], others], dim=0)
        # regular
        q = ((math.sqrt(D + 1.0) - 1.0) / (D * math.sqrt(2.0))) * self.edge
        p = q + self.edge / math.sqrt(2.0)
        base = torch.where(max(p, q) + seed_u > 1.0, -seed_u, seed_u)
        others = torch.abs(base[None, :] + q + eye * (p - q))
        return torch.cat([seed_u[None, :], others], dim=0)

    def draw_init(self, space: Space,
                  gen: rng.Stream) -> SimplexInitDraws:
        return SimplexInitDraws(space.random(gen, 1),
                                self._draw_others(space, gen))

    def init_state(self, space: Space,
                   draws: SimplexInitDraws) -> SimplexState:
        S = _simplex_size(space)
        seed = draws.seed
        dev = seed.u.device
        pts = self._initial_simplex(space, seed.u[0], draws.others)
        return SimplexState(
            pts, torch.full((S,), float("inf"), device=dev),
            tuple(p[0] for p in seed.perms),
            torch.tensor(INIT, dtype=torch.int32, device=dev),
            torch.tensor(0, dtype=torch.int32, device=dev))

    def _restart(self, space: Space, state: SimplexState, best: Best,
                 converged: torch.Tensor,
                 draws: RestartDraws) -> SimplexState:
        """Re-seed the simplex around the global best (and adopt its
        permutation blocks) where `converged`."""
        have_best = torch.isfinite(best.qor)
        seed_u = torch.where(have_best, best.u, draws.seed_u)
        new_pts = self._initial_simplex(space, seed_u, draws.others)
        perms = tuple(torch.where(converged & have_best, bp, sp)
                      for sp, bp in zip(state.perms, best.perms))
        return SimplexState(
            torch.where(converged, new_pts, state.pts_u),
            torch.where(converged, torch.full_like(state.vals, float("inf")),
                        state.vals),
            perms,
            torch.where(converged, INIT, LOOP).to(torch.int32),
            torch.where(converged, 0, state.stale).to(torch.int32))

    def _attach_perms(self, state: SimplexState,
                      u: torch.Tensor) -> CandBatch:
        n = u.shape[0]
        return CandBatch(u, tuple(p[None, :].repeat(n, 1)
                                  for p in state.perms))

    # ---- propose / observe ---------------------------------------------------
    def draw_propose(self, space: Space, gen: rng.Stream) -> torch.Tensor:
        """[3, D] U[0,1): the INIT phase's padding rows."""
        return rng.uniform(gen, (3, space.n_scalar))

    def propose(self, space: Space, state: SimplexState, best: Best,
                draws: torch.Tensor) -> Tuple[SimplexState, CandBatch]:
        # stable: jnp.argsort is, and at INIT every value is +inf
        order = torch.argsort(state.vals, stable=True)
        pts = state.pts_u[order]
        vals = state.vals[order]
        centroid = _centroid(pts)   # calculate_centroid: all points
        worst = pts[-1]
        refl = torch.clamp(centroid + self.alpha * (centroid - worst), 0, 1)
        expa = torch.clamp(centroid + self.gamma * (refl - centroid), 0, 1)
        c_out = torch.clamp(centroid + self.beta * (refl - centroid), 0, 1)
        c_in = torch.clamp(centroid + self.beta * (worst - centroid), 0, 1)
        shrink = pts[0][None, :] + self.sigma * (pts[1:] - pts[0][None, :])
        loop_batch = torch.cat(
            [refl[None], expa[None], c_out[None], c_in[None], shrink], dim=0)
        init_batch = torch.cat([state.pts_u, draws], dim=0)
        is_init = state.phase == INIT
        u = torch.where(is_init, init_batch, loop_batch)
        # sorted order must persist into observe: store the sorted simplex
        new_state = state._replace(
            pts_u=torch.where(is_init, state.pts_u, pts),
            vals=torch.where(is_init, state.vals, vals))
        return new_state, self._attach_perms(state, u)

    def draw_observe(self, space: Space,
                     gen: rng.Stream) -> RestartDraws:
        return RestartDraws(rng.uniform(gen, (space.n_scalar,)),
                            self._draw_others(space, gen))

    def observe(self, space: Space, state: SimplexState, cands: CandBatch,
                qor: torch.Tensor, best: Best,
                draws: RestartDraws) -> SimplexState:
        S = _simplex_size(space)
        init_vals = qor[:S]
        pts, vals = state.pts_u, state.vals          # sorted by propose
        qr, qe, qoc, qic = qor[0], qor[1], qor[2], qor[3]
        q_shrink = qor[4:4 + S - 1]
        refl, expa, c_out, c_in = (cands.u[0], cands.u[1],
                                   cands.u[2], cands.u[3])
        shrink_pts = cands.u[4:4 + S - 1]

        case_expand = (qr < vals[0]) & (qe < qr)
        case_reflect = (qr < vals[1]) & ~case_expand
        out_base = qr <= vals[-1]
        q_cont = torch.where(out_base, qoc, qic)
        cont_pt = torch.where(out_base, c_out, c_in)
        q_base = torch.where(out_base, qr, vals[-1])
        case_contract = (~case_expand) & (~case_reflect) & (q_cont <= q_base)
        case_shrink = (~case_expand) & (~case_reflect) & (~case_contract)

        repl_pt = torch.where(case_expand, expa,
                              torch.where(case_reflect, refl, cont_pt))
        repl_q = torch.where(case_expand, qe,
                             torch.where(case_reflect, qr, q_cont))
        # replace the worst (last of the sorted simplex)
        loop_pts = torch.cat(
            [pts[:-1], torch.where(case_shrink, pts[-1], repl_pt)[None]])
        loop_vals = torch.cat(
            [vals[:-1], torch.where(case_shrink, vals[-1], repl_q)[None]])
        # shrink: all but the best replaced by the measured shrink points
        loop_pts = torch.where(case_shrink,
                               torch.cat([pts[:1], shrink_pts], dim=0),
                               loop_pts)
        loop_vals = torch.where(case_shrink,
                                torch.cat([vals[:1], q_shrink]), loop_vals)

        is_init = state.phase == INIT
        new_pts = torch.where(is_init, pts, loop_pts)
        new_vals = torch.where(is_init, init_vals, loop_vals)
        improved = torch.min(new_vals) < torch.min(vals)
        stale = torch.where(is_init | improved, 0,
                            state.stale + 1).to(torch.int32)
        out = SimplexState(new_pts, new_vals, state.perms,
                           torch.full_like(state.phase, LOOP), stale)
        # convergence: no improvement for ~3 rounds, or a collapsed simplex
        spread = torch.amax(new_pts, dim=0) - torch.amin(new_pts, dim=0)
        converged = (~is_init) & (
            (out.stale > 3 * S + 1) | (torch.max(spread) < 1e-6))
        return self._restart(space, out, best, converged, draws)


def _mk(style, name, **kw):
    return NelderMead(init_style=style, name=name, **kw)


register(_mk("random", "RandomNelderMead"))
register(_mk("right", "RightNelderMead"))
register(_mk("regular", "RegularNelderMead"))
