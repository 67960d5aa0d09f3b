"""Shared batched building blocks used by several techniques.

Counterpart of `uptune_tpu/techniques/common.py`.  A "parameter" is one
scalar lane or one permutation block; a mutation pass picks, per row, one
forced parameter plus a Bernoulli subset of the rest.  Each block comes
as a draw step (`draw_*`, consumes a stream) and a pure function of the
draws; the draws' NamedTuples mirror the JAX package's key splits one to
one, so a test can fill them with the numbers JAX drew.
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Tuple, Union

import torch

from .. import rng
from ..ops import numeric as nops
from ..ops import perm as pops
from ..space.spec import CandBatch, Space


# -- parameter mutation mask -------------------------------------------------
class MaskDraws(NamedTuple):
    scores: torch.Tensor   # [n, P] U[0,1): the forced params are its top-k
    coins: torch.Tensor    # [n, P] U[0,1): coin < rate mutates


def n_params(space: Space) -> int:
    return space.n_scalar + len(space.perm_sizes)


def draw_param_mutation_mask(space: Space, gen: rng.Stream,
                             n: int) -> MaskDraws:
    P = n_params(space)
    return MaskDraws(rng.uniform(gen, (n, P)), rng.uniform(gen, (n, P)))


def param_mutation_mask(space: Space, n: int, rate: float, must: int,
                        draws: MaskDraws) -> torch.Tensor:
    """[n, n_params] bool: per row, `must` forced distinct params (the
    smallest scores; a stable argsort, as jnp.argsort is) plus
    coin < rate on the others.  Param order: scalar lanes, perm blocks."""
    mutate = draws.coins < rate
    if must > 0:
        idx = torch.argsort(draws.scores, dim=1, stable=True)[:, :must]
        mutate = mutate.scatter(1, idx, True)
    return mutate


# -- one random permutation manipulator per row -------------------------------
class PermOpDraws(NamedTuple):
    shuffle: torch.Tensor    # [B, n] index permutations
    change: torch.Tensor     # [B, n] U[0,1) bubble coins
    swap_r: torch.Tensor     # [B] positions
    swap_s: torch.Tensor     # [B]
    invert_r: torch.Tensor   # [B] window starts
    pick: torch.Tensor       # [B] in [0, 4): which manipulator


def _invert_d(n: int) -> int:
    return max(1, n // 4)


def draw_perm_random_op(gen: rng.Stream, rows: int,
                        n: int) -> PermOpDraws:
    r, s = pops.draw_random_swap(gen, rows, n)
    return PermOpDraws(
        pops.draw_shuffle(gen, rows, n),
        pops.draw_small_random_change(gen, rows, n), r, s,
        pops.draw_random_invert(gen, rows, n, _invert_d(n)),
        rng.randint(gen, (rows,), 0, 4))


def mutate_perm_random_op(pm: torch.Tensor, mask: torch.Tensor,
                          draws: PermOpDraws) -> torch.Tensor:
    """One random permutation manipulator per masked row: shuffle, small
    random change, random swap or invert (d = n//4, at least 1)."""
    n = pm.shape[1]
    variants = torch.stack([
        pops.shuffle_batch(pm, draws.shuffle),
        pops.small_random_change_batch(pm, draws.change),
        pops.random_swap_batch(pm, draws.swap_r, draws.swap_s),
        pops.random_invert_batch(pm, _invert_d(n), draws.invert_r),
    ])                                                # [4, B, n]
    rows = torch.arange(pm.shape[0], device=pm.device)
    chosen = variants[draws.pick.to(torch.int64), rows]
    return torch.where(mask[:, None], chosen, pm)


# -- one evolutionary mutation pass ------------------------------------------
class MutateDraws(NamedTuple):
    mask: MaskDraws
    # uniform variant: (r,) redraws; normal variant: (noise, redraw)
    scalar: Tuple[torch.Tensor, ...]
    # per perm block: [B, s_k] shuffles (uniform) or PermOpDraws (normal)
    perms: Tuple[Union[torch.Tensor, PermOpDraws], ...]


def draw_mutate_batch(space: Space, gen: rng.Stream, n: int,
                      sigma: Optional[float]) -> MutateDraws:
    D = space.n_scalar
    mask = draw_param_mutation_mask(space, gen, n)
    if sigma is None:
        scalar = (rng.uniform(gen, (n, D)),)
        perms = tuple(pops.draw_shuffle(gen, n, s) for s in space.perm_sizes)
    else:
        scalar = (rng.normal(gen, (n, D)), rng.uniform(gen, (n, D)))
        perms = tuple(draw_perm_random_op(gen, n, s)
                      for s in space.perm_sizes)
    return MutateDraws(mask, scalar, perms)


def mutate_batch(space: Space, cands: CandBatch, rate: float, must: int,
                 sigma: Optional[float], draws: MutateDraws) -> CandBatch:
    """sigma=None  -> uniform mutation (op1_randomize per selected param)
    sigma=float -> normal mutation on primitive lanes, a random
                   manipulator on complex lanes and permutation blocks"""
    n = cands.batch
    mask = param_mutation_mask(space, n, rate, must, draws.mask)
    scal_mask = mask[:, :space.n_scalar]
    if sigma is None:
        u = nops.randomize(cands.u, draws.scalar[0], scal_mask)
    else:
        cm = space.tables(cands.u.device).complex_mask[None, :]
        u = nops.normal_mutation(cands.u, sigma, cm, draws.scalar[0],
                                 draws.scalar[1], scal_mask)
    perms = []
    for k, (d, pm) in enumerate(zip(draws.perms, cands.perms)):
        pmask = mask[:, space.n_scalar + k]
        if sigma is None:
            perms.append(torch.where(pmask[:, None],
                                     pops.shuffle_batch(pm, d), pm))
        else:
            perms.append(mutate_perm_random_op(pm, pmask, d))
    return CandBatch(u, tuple(perms))


def perm_codes_equal(p1: torch.Tensor, p2: torch.Tensor) -> torch.Tensor:
    """[B] bool: rows equal."""
    return torch.all(p1 == p2, dim=-1)


# -- the DE candidate construction ---------------------------------------------
class LinearDraws(NamedTuple):
    redraw: torch.Tensor                 # [B, D] U[0,1) complex-lane redraws
    shuffles: Tuple[torch.Tensor, ...]   # per perm block [B, s_k]


def draw_de_linear_batch(space: Space, gen: rng.Stream,
                         n: int) -> LinearDraws:
    return LinearDraws(
        rng.uniform(gen, (n, space.n_scalar)),
        tuple(pops.draw_shuffle(gen, n, s) for s in space.perm_sizes))


def de_linear_batch(space: Space, base: CandBatch, x1: CandBatch,
                    x2: CandBatch, x3: CandBatch, f: torch.Tensor,
                    cross_mask: torch.Tensor,
                    draws: LinearDraws) -> CandBatch:
    """Per selected param, cfg = x1 + f*(x2 - x3): scalar lanes by
    op4_set_linear with randomize-if-differ on complex lanes; permutation
    blocks copy x1 and reshuffle iff x2 != x3.  Unselected params keep
    `base`.  f: [B, 1]; cross_mask: [B, n_params] bool."""
    D = space.n_scalar
    codes2 = space.decode_scalars(x2.u)
    codes3 = space.decode_scalars(x3.u)
    cm = space.tables(x1.u.device).complex_mask[None, :]
    u = nops.set_linear(x1.u, x2.u, x3.u, 1.0, f, -f, cm, codes2 == codes3,
                        draws.redraw, mask=cross_mask[:, :D], base=base.u)
    perms = []
    for k, sh in enumerate(draws.shuffles):
        pmask = cross_mask[:, D + k]
        differ = ~perm_codes_equal(x2.perms[k], x3.perms[k])
        shuffled = pops.shuffle_batch(x1.perms[k], sh)
        new = torch.where(differ[:, None], shuffled, x1.perms[k])
        perms.append(torch.where(pmask[:, None], new, base.perms[k]))
    return CandBatch(u, tuple(perms))


# -- permutation crossover between two parents --------------------------------
def _cross_d(size: int, strength: float) -> int:
    return max(1, int(round(size * strength)))


def draw_crossover_perms(space: Space, gen: rng.Stream, rows: int, op: str,
                         strength: float = 1.0 / 3.0,
                         min_size: int = 7) -> Tuple[Optional[torch.Tensor],
                                                     ...]:
    """Per perm block, the crossover's per-row draws (None for a block
    below `min_size`, which the crossover leaves alone)."""
    cx = pops.CROSSOVERS[op]
    return tuple(cx.draw(gen, rows, size, _cross_d(size, strength))
                 if size >= min_size else None
                 for size in space.perm_sizes)


def crossover_perms(space: Space, child: CandBatch, a: CandBatch,
                    b: CandBatch, op: str,
                    draws: Tuple[Optional[torch.Tensor], ...],
                    strength: float = 1.0 / 3.0,
                    min_size: int = 7) -> CandBatch:
    """Crossover `op` (PX/PMX/CX/OX1/OX3) between parents a and b on every
    perm block of size >= min_size, at d = round(size * strength) (at
    least 1), written into `child`'s perm slots; a smaller block takes
    a's.  `draws` from `draw_crossover_perms`."""
    if not space.perm_sizes:
        return child
    cx = pops.CROSSOVERS[op]
    perms = []
    for d, pa, pb, size in zip(draws, a.perms, b.perms, space.perm_sizes):
        if size >= min_size:
            perms.append(cx.apply(pa, pb, _cross_d(size, strength), d))
        else:
            perms.append(pa)
    return CandBatch(child.u, tuple(perms))
