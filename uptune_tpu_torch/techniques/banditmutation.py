"""Operator-level bandit mutation, composable DE, random portfolios.

Counterpart of `uptune_tpu/techniques/banditmutation.py`:

* `BanditMutation` (`AUCBanditMutationTechnique`): a bandit over six
  mutation operators of the global best, with its credit on the device:
  the state carries an EMA improvement score per operator, propose()
  draws one operator per row from an epsilon-softmax over the credits,
  applies every operator to the whole batch and keeps each row's own.
  The JAX package draws the operator with `jax.random.categorical`, the
  Gumbel-max trick argmax(log p + g); here g = -log(-log(u)) is a
  propose draw, so the tests can replay JAX's Gumbel noise.
* `ComposableDE` (`ComposableDiffEvolution` / `...CX`): DE whose
  permutation blocks are crossed (PX/PMX/CX/OX1/OX3) between the
  proposal and the current population instead of reshuffled.
* `generate_bandit_technique(seed)`: a seeded random AUC-bandit
  portfolio over randomly-hyperparameterized arms (host only).
"""
from __future__ import annotations

import random as _pyrandom
from typing import NamedTuple, Optional, Tuple

import torch

from .. import rng
from ..space.spec import CandBatch, Space
from .bandit import AUCBanditMeta
from .base import Best, Technique, register
from .common import (MutateDraws, crossover_perms, draw_crossover_perms,
                     draw_mutate_batch, mutate_batch)
from .de import DEDraws, DifferentialEvolution

# operator menu: (sigma, rate) mutation variants; sigma None = uniform
# resample, else normal mutation
_OPS = (
    (None, 0.0),      # uniform-resample one param
    (0.01, 0.0),      # fine normal, one param
    (0.05, 0.0),
    (0.15, 0.0),
    (0.30, 0.0),      # coarse normal, one param
    (0.05, 0.25),     # normal over ~quarter of the params
)
N_OPS = len(_OPS)


class BMState(NamedTuple):
    credit: torch.Tensor    # [N_OPS] f32 EMA of per-op improvement rate
    counts: torch.Tensor    # [N_OPS] i32 pulls (for reporting)
    last_ops: torch.Tensor  # [B] i32 op drawn for each row of the last batch


class BMDraws(NamedTuple):
    gumbel: torch.Tensor                 # [B, N_OPS] Gumbel noise
    fallback: CandBatch                  # random rows while no best exists
    mutate: Tuple[MutateDraws, ...]      # per operator


class BanditMutation(Technique):
    """Bandit-credited mutations of the global best configuration."""

    def __init__(self, batch: int = 48, epsilon: float = 0.15,
                 temperature: float = 0.1, decay: float = 0.05,
                 name: str = "AUCBanditMutationTechnique"):
        super().__init__(name)
        self.batch = batch
        self.epsilon = epsilon
        self.temperature = temperature
        self.decay = decay

    def natural_batch(self, space: Space) -> int:
        return self.batch

    def draw_init(self, space: Space, gen: rng.Stream) -> torch.device:
        """No numbers (the initial state is fixed): the device the state
        lives on."""
        return gen.device

    def init_state(self, space: Space, draws: torch.device) -> BMState:
        i32 = dict(dtype=torch.int32, device=draws)
        return BMState(torch.zeros((N_OPS,), device=draws),
                       torch.zeros((N_OPS,), **i32),
                       torch.zeros((self.batch,), **i32))

    def draw_propose(self, space: Space, gen: rng.Stream) -> BMDraws:
        B = self.batch
        u = rng.uniform(gen, (B, N_OPS))
        return BMDraws(
            -torch.log(-torch.log(u)), space.random(gen, B),
            tuple(draw_mutate_batch(space, gen, B, sigma)
                  for sigma, _ in _OPS))

    def propose(self, space: Space, state: BMState, best: Best,
                draws: BMDraws) -> Tuple[BMState, CandBatch]:
        B = self.batch
        # seed from the global best; random rows until one exists
        have_best = torch.isfinite(best.qor)
        seed = best.as_batch(B)
        rand = draws.fallback
        base = CandBatch(
            torch.where(have_best, seed.u, rand.u),
            tuple(torch.where(have_best, s, r)
                  for s, r in zip(seed.perms, rand.perms)))

        # epsilon-softmax over the credits, one operator per row
        logits = state.credit / self.temperature
        e = torch.exp(logits - torch.max(logits))
        probs = ((1.0 - self.epsilon) * (e / torch.sum(e))
                 + self.epsilon / N_OPS)
        ops = torch.argmax(draws.gumbel + torch.log(probs)[None, :], dim=1)

        variants = [mutate_batch(space, base, rate, 1, sigma, d)
                    for (sigma, rate), d in zip(_OPS, draws.mutate)]
        rows = torch.arange(B, device=ops.device)
        u = torch.stack([v.u for v in variants])[ops, rows]
        perms = tuple(torch.stack([v.perms[k] for v in variants])[ops, rows]
                      for k in range(len(space.perm_sizes)))
        hits = (ops[:, None] == torch.arange(N_OPS, device=ops.device))
        counts = state.counts + hits.sum(0).to(torch.int32)
        return (BMState(state.credit, counts, ops.to(torch.int32)),
                space.normalize(CandBatch(u, perms)))

    def observe(self, space: Space, state: BMState, cands: CandBatch,
                qor: torch.Tensor, best: Best, draws=None) -> BMState:
        # `best` already holds this batch, so a row that set the new best
        # has qor <= best.qor
        improved = (qor <= best.qor) & torch.isfinite(qor)
        onehot = (state.last_ops.to(torch.int64)[:, None]
                  == torch.arange(N_OPS, device=qor.device)
                  ).to(torch.float32)                         # [B, O]
        pulls = onehot.sum(0)
        wins = (onehot * improved[:, None]).sum(0)
        rate = torch.where(pulls > 0, wins / torch.clamp_min(pulls, 1.0),
                           0.0)
        credit = torch.where(
            pulls > 0,
            (1.0 - self.decay) * state.credit + self.decay * rate,
            state.credit)
        return BMState(credit, state.counts, state.last_ops)


# ----------------------------------------------------------------------
class ComposableDraws(NamedTuple):
    de: DEDraws
    cross: Tuple[Optional[torch.Tensor], ...]   # per perm block


class ComposableDE(Technique):
    """DE with a composable permutation crossover: scalar lanes follow
    x1 + F(x2 - x3) through the wrapped DE; permutation blocks of the
    proposal are crossed with the current population's."""

    def __init__(self, crossover: str = "OX1", population_size: int = 30,
                 cr: float = 0.9, name: Optional[str] = None):
        super().__init__(name or f"ComposableDE-{crossover}")
        self._de = DifferentialEvolution(
            population_size=population_size, cr=cr, name=self.name + "~de")
        self.crossover = crossover

    def natural_batch(self, space: Space) -> int:
        return self._de.natural_batch(space)

    def draw_init(self, space: Space, gen: rng.Stream) -> CandBatch:
        return self._de.draw_init(space, gen)

    def init_state(self, space: Space, draws: CandBatch):
        return self._de.init_state(space, draws)

    def draw_propose(self, space: Space,
                     gen: rng.Stream) -> ComposableDraws:
        return ComposableDraws(
            self._de.draw_propose(space, gen),
            draw_crossover_perms(space, gen, self._de.population_size,
                                 self.crossover))

    def propose(self, space: Space, state, best: Best,
                draws: ComposableDraws):
        state, cands = self._de.propose(space, state, best, draws.de)
        if space.perm_sizes:
            # the child x parent crossover, the composable operator slot
            cands = crossover_perms(space, cands, cands, state.pop,
                                    self.crossover, draws.cross)
            cands = space.normalize(cands)
        return state, cands

    def observe(self, space: Space, state, cands: CandBatch,
                qor: torch.Tensor, best: Best, draws=None):
        return self._de.observe(space, state, cands, qor, best)


# ----------------------------------------------------------------------
def generate_bandit_technique(seed: int = 0,
                              n_arms: int = None) -> AUCBanditMeta:
    """Seeded random AUC-bandit portfolio (`--generate-bandit-technique`:
    a random sub-technique count and random hyperparameters)."""
    from .annealing import PseudoAnnealingSearch
    from .evolutionary import GreedyMutation
    from .pattern import PatternSearch
    from .pso import PSO
    from .simplex import NelderMead, Torczon

    rng = _pyrandom.Random(seed)
    n = n_arms or rng.randint(2, 5)
    makers = [
        lambda i: DifferentialEvolution(
            population_size=rng.choice([15, 30, 50, 100]),
            cr=rng.choice([0.2, 0.5, 0.9]), name=f"rand-de-{i}"),
        lambda i: GreedyMutation(
            mutation_rate=rng.choice([0.01, 0.1, 0.3]),
            sigma=rng.choice([None, 0.05, 0.1, 0.3]),
            crossover=rng.choice([None, "OX1", "PMX", "CX"]),
            crossover_rate=rng.choice([0.0, 0.5, 0.8]),
            name=f"rand-gm-{i}"),
        lambda i: PSO(crossover=rng.choice(["OX1", "OX3", "PMX", "CX",
                                            "PX"]),
                      omega=rng.uniform(0.3, 0.8), name=f"rand-pso-{i}"),
        lambda i: NelderMead(init_style=rng.choice(["random", "right"]),
                             name=f"rand-nm-{i}"),
        lambda i: Torczon(init_style=rng.choice(["random", "right"]),
                          name=f"rand-tz-{i}"),
        lambda i: PseudoAnnealingSearch(name=f"rand-sa-{i}"),
        lambda i: PatternSearch(name=f"rand-ps-{i}"),
        lambda i: BanditMutation(name=f"rand-bm-{i}"),
    ]
    members = [rng.choice(makers)(i) for i in range(n)]
    return AUCBanditMeta(members, name=f"RandomBandit-{seed}",
                         seed=seed)


register(BanditMutation())
register(ComposableDE("OX1", name="ComposableDiffEvolution"))
register(ComposableDE("CX", name="ComposableDiffEvolutionCX"))
