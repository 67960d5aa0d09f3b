"""Batched simplex techniques: Nelder-Mead, Torczon and the multi-simplex.

Counterpart of `uptune_tpu/techniques/simplex.py`.  One Nelder-Mead
round proposes the whole decision tree at once — reflection, expansion,
outside and inside contraction, and the S-1 shrink points — and
observe() applies the decision rules branchlessly; one Torczon round
proposes the reflected, expanded and contracted simplexes (3(S-1)
points) and observe() keeps the winner.  Simplex geometry lives on the
scalar unit lanes; permutation blocks ride along from the seed point.
On convergence the simplex restarts around the global best.

`MultiSimplex` (MultiNelderMead / MultiTorczon) interleaves three
members round-robin, one a step.  The JAX package picks the member with
`lax.switch(turn, ...)`; here every member proposes and observes each
step and `torch.where` on `turn` keeps the one whose turn it is (the
select JAX makes of a switch under vmap), so `turn` is never read on the
host.

The JAX state carries its own restart key (`SimplexState.key`); here the
restart draws come from the engine's key through `draw_observe`,
so the state holds tensors only.
"""
from __future__ import annotations

import math
from typing import NamedTuple, Optional, Tuple

import torch

from .. import rng
from ..ops import simplex as simplex_ops
from ..ops.simplex import INIT, LOOP
from ..space.spec import CandBatch, Space
from .base import Best, Technique, register


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


class _SimplexBase(Technique):
    def __init__(self, init_style: str, name: str, edge: float = 0.1):
        super().__init__(name)
        if init_style not in ("random", "right", "regular"):
            raise ValueError(init_style)
        self.init_style = init_style
        self.edge = edge

    def supports(self, space: Space) -> bool:
        return space.n_scalar >= 1

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

    def draw_observe(self, space: Space,
                     gen: rng.Stream) -> RestartDraws:
        return RestartDraws(rng.uniform(gen, (space.n_scalar,)),
                            self._draw_others(space, gen))

    def _finish(self, space: Space, state: SimplexState, pts: torch.Tensor,
                vals: torch.Tensor, loop_pts: torch.Tensor,
                loop_vals: torch.Tensor, init_vals: torch.Tensor,
                best: Best, draws: RestartDraws) -> SimplexState:
        """The end of an observe: adopt the INIT values or the round's
        simplex, count rounds without improvement, restart on
        convergence."""
        S = _simplex_size(space)
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


class NelderMead(_SimplexBase):
    def __init__(self, init_style: str, name: str, alpha: float = 2.0,
                 gamma: float = 2.0, beta: float = 0.5, sigma: float = 0.5,
                 edge: float = 0.1):
        super().__init__(init_style, name, edge)
        self.alpha = alpha
        self.gamma = gamma
        self.beta = beta
        self.sigma = sigma

    def natural_batch(self, space: Space) -> int:
        return _simplex_size(space) + 3

    # ---- propose / observe ---------------------------------------------------
    def draw_propose(self, space: Space, gen: rng.Stream) -> torch.Tensor:
        """[3, D] U[0,1): the INIT phase's padding rows."""
        return rng.uniform(gen, (3, space.n_scalar))

    def propose(self, space: Space, state: SimplexState, best: Best,
                draws: torch.Tensor) -> Tuple[SimplexState, CandBatch]:
        """The round's batch, and the state with the simplex sorted (the
        order persists into observe): the torch chain on the CPU, one
        kernel launch on the card (`ops/simplex.py`)."""
        u, pts, vals = simplex_ops.simplex_propose(
            state.pts_u, state.vals, draws, state.phase, self.alpha,
            self.gamma, self.beta, self.sigma)
        return (state._replace(pts_u=pts, vals=vals),
                self._attach_perms(state, u))

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

        return self._finish(space, state, pts, vals, loop_pts, loop_vals,
                            init_vals, best, draws)


class Torczon(_SimplexBase):
    def __init__(self, init_style: str, name: str, alpha: float = 1.0,
                 gamma: float = 2.0, beta: float = 0.5, edge: float = 0.1):
        super().__init__(init_style, name, edge)
        self.alpha = alpha
        self.gamma = gamma
        self.beta = beta

    def natural_batch(self, space: Space) -> int:
        S = _simplex_size(space)
        return max(S, 3 * (S - 1))

    def draw_propose(self, space: Space, gen: rng.Stream) -> torch.Tensor:
        """[nb - S, D] U[0,1): the INIT phase's padding rows."""
        pad = max(0, self.natural_batch(space) - _simplex_size(space))
        return rng.uniform(gen, (pad, space.n_scalar))

    def propose(self, space: Space, state: SimplexState, best: Best,
                draws: torch.Tensor) -> Tuple[SimplexState, CandBatch]:
        nb = self.natural_batch(space)
        order = torch.argsort(state.vals, stable=True)
        pts = state.pts_u[order]
        vals = state.vals[order]
        b = pts[0][None, :]
        rest = pts[1:]

        def scaled(scale):
            return torch.clamp(b + scale * (b - rest), 0.0, 1.0)

        loop_batch = torch.cat([scaled(self.alpha), scaled(self.gamma),
                                scaled(-self.beta)], dim=0)
        if loop_batch.shape[0] < nb:
            loop_batch = torch.cat([loop_batch, loop_batch.new_zeros(
                (nb - loop_batch.shape[0], space.n_scalar))], dim=0)
        init_batch = torch.cat([state.pts_u, draws], dim=0)[:nb]
        is_init = state.phase == INIT
        u = torch.where(is_init, init_batch, loop_batch)
        new_state = state._replace(
            pts_u=torch.where(is_init, state.pts_u, pts),
            vals=torch.where(is_init, state.vals, vals))
        return new_state, self._attach_perms(state, u)

    def observe(self, space: Space, state: SimplexState, cands: CandBatch,
                qor: torch.Tensor, best: Best,
                draws: RestartDraws) -> SimplexState:
        S = _simplex_size(space)
        init_vals = qor[:S]
        pts, vals = state.pts_u, state.vals          # sorted by propose
        m = S - 1
        qr, qe, qc = qor[:m], qor[m:2 * m], qor[2 * m:3 * m]
        refl, expa, cont = (cands.u[:m], cands.u[m:2 * m],
                            cands.u[2 * m:3 * m])
        min_r = torch.min(qr)
        use_exp = (min_r < vals[0]) & (torch.min(qe) < min_r)
        use_ref = (min_r < vals[0]) & ~use_exp
        chosen = torch.where(use_exp, expa, torch.where(use_ref, refl, cont))
        chosen_q = torch.where(use_exp, qe, torch.where(use_ref, qr, qc))
        loop_pts = torch.cat([pts[:1], chosen], dim=0)
        loop_vals = torch.cat([vals[:1], chosen_q])
        return self._finish(space, state, pts, vals, loop_pts, loop_vals,
                            init_vals, best, draws)


def _select(cond: torch.Tensor, a, b):
    """`a` where cond, else `b`, over two trees of one structure."""
    if isinstance(a, torch.Tensor):
        return torch.where(cond, a, b)
    if isinstance(a, tuple) and hasattr(a, "_fields"):
        return type(a)(*(_select(cond, x, y) for x, y in zip(a, b)))
    return tuple(_select(cond, x, y) for x, y in zip(a, b))


class MultiDraws(NamedTuple):
    members: tuple                        # each member's propose draws
    pads: Tuple[Optional[torch.Tensor], ...]  # [pad, D] U[0,1) or None


class MultiSimplex(Technique):
    """MultiNelderMead / MultiTorczon: the three init styles round-robin,
    one member a step (each member restarts from the global best on
    convergence by itself).  The state is (turn, member states)."""

    def __init__(self, members, name):
        super().__init__(name)
        self.members = members

    def supports(self, space: Space) -> bool:
        return all(m.supports(space) for m in self.members)

    def natural_batch(self, space: Space) -> int:
        return max(m.natural_batch(space) for m in self.members)

    def draw_init(self, space: Space, gen: rng.Stream) -> tuple:
        return tuple(m.draw_init(space, gen) for m in self.members)

    def init_state(self, space: Space, draws: tuple):
        dev = draws[0].seed.u.device
        return (torch.zeros((), dtype=torch.int32, device=dev),
                tuple(m.init_state(space, d)
                      for m, d in zip(self.members, draws)))

    def draw_propose(self, space: Space, gen: rng.Stream) -> MultiDraws:
        nb = self.natural_batch(space)
        members = tuple(m.draw_propose(space, gen) for m in self.members)
        pads = []
        for m in self.members:
            pad = nb - m.natural_batch(space)
            pads.append(rng.uniform(gen, (pad, space.n_scalar))
                        if pad else None)
        return MultiDraws(members, tuple(pads))

    def propose(self, space: Space, state, best: Best, draws: MultiDraws):
        """Every member proposes; the one whose turn it is advances and
        emits its batch (padded to the widest member's: uniform rows, the
        perms of its first row)."""
        turn, sub = state
        new_sub, cands = [], None
        for i, (m, st, d, pad) in enumerate(zip(self.members, sub,
                                                draws.members, draws.pads)):
            s2, c = m.propose(space, st, best, d)
            if pad is not None:
                c = CandBatch(
                    torch.cat([c.u, pad], dim=0),
                    tuple(torch.cat([p, p[:1].expand(pad.shape[0], -1)],
                                    dim=0) for p in c.perms))
            mine = turn == i
            new_sub.append(_select(mine, s2, st))
            cands = c if cands is None else _select(mine, c, cands)
        return (turn, tuple(new_sub)), cands

    def draw_observe(self, space: Space, gen: rng.Stream) -> tuple:
        return tuple(m.draw_observe(space, gen) for m in self.members)

    def observe(self, space: Space, state, cands: CandBatch,
                qor: torch.Tensor, best: Best, draws: tuple):
        turn, sub = state
        new_sub = []
        for i, (m, st, d) in enumerate(zip(self.members, sub, draws)):
            n = m.natural_batch(space)
            s2 = m.observe(space, st, cands[:n], qor[:n], best, d)
            new_sub.append(_select(turn == i, s2, st))
        nxt = torch.remainder(turn + 1, len(self.members)).to(torch.int32)
        return (nxt, tuple(new_sub))


def _mk(cls, style, name, **kw):
    return cls(init_style=style, name=name, **kw)


register(_mk(NelderMead, "random", "RandomNelderMead"))
register(_mk(NelderMead, "right", "RightNelderMead"))
register(_mk(NelderMead, "regular", "RegularNelderMead"))
register(MultiSimplex([_mk(NelderMead, "right", "RightNelderMead_"),
                       _mk(NelderMead, "random", "RandomNelderMead_"),
                       _mk(NelderMead, "regular", "RegularNelderMead_")],
                      name="MultiNelderMead"))
register(_mk(Torczon, "random", "RandomTorczon"))
register(_mk(Torczon, "right", "RightTorczon"))
register(_mk(Torczon, "regular", "RegularTorczon"))
register(MultiSimplex([_mk(Torczon, "right", "RightTorczon_"),
                       _mk(Torczon, "random", "RandomTorczon_"),
                       _mk(Torczon, "regular", "RegularTorczon_")],
                      name="MultiTorczon"))
