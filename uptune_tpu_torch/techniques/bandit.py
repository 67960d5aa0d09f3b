"""Meta-techniques: the AUC multi-armed bandit and round-robin portfolios.

Counterpart of `uptune_tpu/techniques/bandit.py`, carried over as it is:
the bandit's decision (which technique proposes next) is host control
flow, and its state is a window of at most 500 events, so it lives on
the host with `random.Random(seed)` for its tie-breaks.

* exploitation = sliding-window AUC credit of was-new-best events
  (O(1) incremental update with auc_sum / auc_decay);
* exploration = sqrt(2 * log2(|history|) / use_count);
* score = exploit + C * explore, C = 0.05, window = 500.

A batched step pushes one event per pull: "this pull produced a new
global best".  In the fused engine (`engine/fused.py`) every arm
proposes each step and the bandit is not consulted; the program-mode
driver orders its pulls with `select_order()` and feeds `credit()`.
"""
from __future__ import annotations

import math
import random as _pyrandom
from collections import deque
from typing import Dict, List, Optional, Sequence

from .base import Technique, register


class AUCBanditQueue:
    """Host-side exact port of the reference's AUC bandit credit queue."""

    def __init__(self, keys: Sequence[str], C: float = 0.05,
                 window: int = 500, seed: int = 0):
        self.C = C
        self.window = window
        self.keys = list(keys)
        self.history: deque = deque()
        self.use_counts: Dict[str, int] = {k: 0 for k in keys}
        self.auc_sum: Dict[str, float] = {k: 0.0 for k in keys}
        self.auc_decay: Dict[str, float] = {k: 0.0 for k in keys}
        self.rng = _pyrandom.Random(seed)

    def add_key(self, key: str) -> None:
        """Register a new arm mid-flight (used for virtual arms like the
        surrogate proposal plane).  Starts with zero pulls, so the
        exploration term is +inf and the bandit tries it promptly."""
        if key in self.use_counts:
            return
        self.keys.append(key)
        self.use_counts[key] = 0
        self.auc_sum[key] = 0.0
        self.auc_decay[key] = 0.0

    def exploitation_term(self, key: str) -> float:
        pos = self.use_counts[key]
        if not pos:
            return 0.0
        return self.auc_sum[key] * 2.0 / (pos * (pos + 1.0))

    def exploration_term(self, key: str) -> float:
        if self.use_counts[key] > 0 and len(self.history) > 1:
            return math.sqrt(2.0 * math.log2(len(self.history))
                             / self.use_counts[key])
        return float("inf")

    def bandit_score(self, key: str) -> float:
        return self.exploitation_term(key) + self.C * self.exploration_term(key)

    def ordered_keys(self) -> List[str]:
        """Best-scoring first; ties broken randomly (reference shuffles then
        stable-sorts ascending and iterates reversed)."""
        keys = list(self.keys)
        self.rng.shuffle(keys)
        keys.sort(key=self.bandit_score, reverse=True)
        return keys

    def on_result(self, key: str, value: bool) -> None:
        self.history.append((key, value))
        self.use_counts[key] += 1
        if value:
            self.auc_sum[key] += self.use_counts[key]
            self.auc_decay[key] += 1
        if len(self.history) > self.window:
            k, v = self.history.popleft()
            self.use_counts[k] -= 1
            self.auc_sum[k] -= self.auc_decay[k]
            if v:
                self.auc_decay[k] -= 1


class MetaTechnique(Technique):
    """A technique made of sub-techniques; the driver unrolls it (jitting
    each member) and calls select_order()/credit() host-side per step
    (metatechniques.py:14-76)."""

    def __init__(self, techniques: Sequence[Technique],
                 name: Optional[str] = None):
        super().__init__(name)
        seen = set()
        uniq = []
        for t in techniques:
            nm = t.name
            while nm in seen:
                nm += "~"
            if nm != t.name:
                import copy
                t = copy.copy(t)
                t.name = nm
            seen.add(nm)
            uniq.append(t)
        self.techniques: List[Technique] = uniq

    def select_order(self) -> List[Technique]:
        raise NotImplementedError

    def credit(self, name: str, was_new_best: bool,
               step_best: Optional[float] = None,
               global_best: Optional[float] = None) -> None:
        """Feedback after a pull resolves.  `step_best` is the pull's own
        best QoR (engine orientation), `global_best` the run's best —
        the extra channels exist for quality-aware metas (recycling)."""
        pass

    def poll_restart(self) -> List[str]:
        """Names of members whose device state the driver should
        re-initialize (fresh init_state) before the next acquisition.
        Drained on read; empty for metas that never restart members."""
        return []


class AUCBanditMeta(MetaTechnique):
    def __init__(self, techniques: Sequence[Technique],
                 name: Optional[str] = None, C: float = 0.05,
                 window: int = 500, seed: int = 0):
        super().__init__(techniques, name)
        self.bandit = AUCBanditQueue([t.name for t in self.techniques],
                                     C=C, window=window, seed=seed)
        self._by_name = {t.name: t for t in self.techniques}
        # virtual arms compete in the AUC queue but have no Technique:
        # the driver interprets them itself (e.g. 'surrogate' pulls the
        # EI proposal pool).  select_order() filters them out so callers
        # that only understand Techniques keep working.
        self.virtual_arms: set = set()

    def register_virtual_arm(self, name: str) -> None:
        if name in self._by_name:
            raise ValueError(f"arm name {name!r} already taken by a "
                             f"member technique")
        self.virtual_arms.add(name)
        self.bandit.add_key(name)

    def ordered_names(self) -> List[str]:
        """Full credit-ordered arm-name list, virtual arms included."""
        return self.bandit.ordered_keys()

    def select_order(self) -> List[Technique]:
        return [self._by_name[k] for k in self.bandit.ordered_keys()
                if k in self._by_name]

    def credit(self, name: str, was_new_best: bool,
               step_best: Optional[float] = None,
               global_best: Optional[float] = None) -> None:
        self.bandit.on_result(name, was_new_best)


class RoundRobinMeta(MetaTechnique):
    """metatechniques.py:78-87."""

    def __init__(self, techniques: Sequence[Technique],
                 name: Optional[str] = None):
        super().__init__(techniques, name)
        self._i = 0

    def select_order(self) -> List[Technique]:
        order = self.techniques[self._i:] + self.techniques[:self._i]
        self._i = (self._i + 1) % len(self.techniques)
        return order


class RecyclingMeta(RoundRobinMeta):
    """Restart-underperformers meta (metatechniques.py:89-180),
    re-designed for batched pulls.

    Round-robin between members; every `window` resolved pulls the member
    with the WORST window-best QoR is marked for restart when (a) it also
    completed the previous window (the reference's `old_best_results[w]
    is not None` guard — fresh members get a full window before judgment)
    and (b) the global best strictly beats its window best (reference:
    `objective.lt(driver.best_result, best_results[worst])`).  A restart
    here re-initializes the member's DEVICE state via poll_restart() —
    populations/simplices re-seed while jitted programs stay cached —
    instead of constructing a renamed `.R%d` instance (the reference's
    generators rebuild Python objects; our techniques are stateless
    hyperparameter holders, so identity and archive attribution are
    stable across restarts).  The reference seeds replacements with the
    global best config; here every propose() already receives `best`, so
    the restarted member re-anchors the same way.
    """

    def __init__(self, techniques: Sequence[Technique],
                 name: Optional[str] = None, window: int = 20):
        super().__init__(techniques, name)
        self.window = int(window)
        self._pulls = 0
        inf = float("inf")
        self._win_best: Dict[str, float] = {
            t.name: inf for t in self.techniques}
        self._win_pulls: Dict[str, int] = {
            t.name: 0 for t in self.techniques}
        self._prev_pulls: Dict[str, int] = {}
        self._queued: List[str] = []
        self.restart_count = 0
        self._global = inf

    def credit(self, name: str, was_new_best: bool,
               step_best: Optional[float] = None,
               global_best: Optional[float] = None) -> None:
        self._pulls += 1
        if name in self._win_best:
            self._win_pulls[name] += 1
            if step_best is not None:
                self._win_best[name] = min(self._win_best[name],
                                           float(step_best))
        if global_best is not None:
            self._global = min(self._global, float(global_best))
        if self._pulls % self.window == 0:
            self._recycle()

    def _recycle(self) -> None:
        # judge only members actually PULLED this window: an un-scheduled
        # member keeps its state (the reference judges on window results;
        # restarting healthy members for not being scheduled would
        # discard good populations whenever window < len(techniques)).
        # A pulled member whose window best is +inf (it produced only
        # duplicates / failures) is legitimately worst — that is the
        # stagnated case the restart-meta exists for.
        pulled = [k for k, p in self._win_pulls.items() if p > 0]
        restarted = None
        if pulled:
            worst = max(pulled, key=lambda k: self._win_best[k])
            if (self._prev_pulls.get(worst, 0) > 0
                    and self._global < self._win_best[worst]):
                self._queued.append(worst)
                self.restart_count += 1
                restarted = worst
        self._prev_pulls = dict(self._win_pulls)
        if restarted is not None:
            # the re-seeded member gets one full window of grace before
            # it can be judged again (the reference's replacement starts
            # with old_best_results=None); without this a lagging member
            # would churn through a restart every single window
            self._prev_pulls[restarted] = 0
        self._win_best = {k: float("inf") for k in self._win_best}
        self._win_pulls = {k: 0 for k in self._win_pulls}

    def poll_restart(self) -> List[str]:
        out, self._queued = self._queued, []
        return out


def _portfolio(name: str, members) -> AUCBanditMeta:
    return AUCBanditMeta(members, name=name)


def _register_portfolios():
    from .annealing import PseudoAnnealingSearch
    from .de import DifferentialEvolution
    from .evolutionary import GreedyMutation, GlobalGA
    from .pattern import PatternSearch
    from .pso import PSO
    from .simplex import NelderMead

    def de_alt():
        return DifferentialEvolution(cr=0.2, name="DifferentialEvolutionAlt")

    def ugm(**kw):
        return GreedyMutation(**kw)

    def rnm(name="RandomNelderMead"):
        return NelderMead(init_style="random", name=name)

    # bandittechniques.py:273-320
    register(_portfolio("AUCBanditMetaTechniqueA", [
        de_alt(), ugm(name="UniformGreedyMutation"),
        ugm(sigma=0.1, mutation_rate=0.3, name="NormalGreedyMutation"),
        rnm()]))
    register(_portfolio("AUCBanditMetaTechniqueB", [
        de_alt(), ugm(name="UniformGreedyMutation")]))
    register(_portfolio("AUCBanditMetaTechniqueC", [
        de_alt(), PatternSearch()]))
    register(_portfolio("PSO_GA_Bandit",
        [PSO(crossover=cx) for cx in ("OX3", "OX1", "CX", "PMX", "PX")] +
        [ugm(mutation_rate=0.01, crossover_rate=0.8, crossover=cx,
             name=f"ga-{cx}") for cx in ("OX3", "OX1", "CX", "PX", "PMX")] +
        [ugm(mutation_rate=0.01, name="ga-base")]))
    # portfolio A with the UniformGreedyMutation arm swapped for CMA-ES
    # under the same AUC bandit, opt-in via --technique: the JAX
    # package's matched A/B (AB_PORTFOLIO.md) has it behind portfolio A,
    # which stays the default, so it is registered as experimental.
    from .cmaes import CMAES
    register(_portfolio("AUCBanditMetaTechniqueTPU", [
        de_alt(), ugm(sigma=0.1, mutation_rate=0.3,
                      name="NormalGreedyMutation"),
        CMAES(), rnm()]), experimental=True)

    # the generic restart-meta + plain round-robin, registered so
    # --technique can name them (metatechniques.py:78-180) — both over
    # the default portfolio's members
    register(RecyclingMeta([
        de_alt(), ugm(name="UniformGreedyMutation"),
        ugm(sigma=0.1, mutation_rate=0.3, name="NormalGreedyMutation"),
        rnm()], name="RecyclingMetaTechnique"))
    register(RoundRobinMeta([
        de_alt(), ugm(name="UniformGreedyMutation"),
        ugm(sigma=0.1, mutation_rate=0.3, name="NormalGreedyMutation"),
        rnm()], name="RoundRobinMetaSearchTechnique"))
    register(_portfolio("test", [de_alt(), PseudoAnnealingSearch()]))
    register(_portfolio("test2", [
        de_alt(), ugm(name="UniformGreedyMutation"),
        ugm(sigma=0.1, mutation_rate=0.3, name="NormalGreedyMutation"),
        rnm(), PseudoAnnealingSearch()]))
    register(_portfolio("PSO_GA_DE",
        [PSO(crossover=cx) for cx in ("OX1", "PMX", "PX")] +
        [ugm(crossover_rate=0.5, crossover=cx, name=f"ga-{cx}")
         for cx in ("OX1", "PMX", "PX")] +
        [de_alt(),
         GlobalGA(mutation_rate=0.1, sigma=0.1, crossover_rate=0.5,
                  crossover_strength=0.2, name="GGA")]))


_register_portfolios()
