"""The flagship workload: a mixed space and a rosenbrock + tsp objective.

The port's counterpart of `__graft_entry__._flagship`: 8 floats, an int,
a log-int, a pow2, a bool, an enum and a 12-city permutation (every codec
kind), scored by rosenbrock on the floats plus the closed-tour length of
the permutation over a fixed random TSP instance (`flagship_objective`
over decoded values for the engines, `flagship_host_objective` over
config dicts for the `Tuner`).  The default arms are scaled by `scale`,
and a PureRandom arm pads the step to a multiple of 8 rows: 111 + 1 rows
at scale 1, 6033 + 7 = 6040 rows at scale 64.

`flagship_portfolio` runs the same space and objective under every other
non-meta arm that supports it (`portfolio_arms`): 546 rows a scale plus
95 rows of simplexes, padded to 6104 rows at scale 11.
"""
from __future__ import annotations

import copy
from typing import Tuple

import torch

from . import rng

from .device import DeviceLike, resolve_device
from .engine.fused import FusedEngine, default_arms
from .space.params import (BoolParam, EnumParam, FloatParam, IntParam,
                           LogIntParam, PermParam, Pow2Param)
from .space.spec import Space
from .techniques.base import Technique
from .techniques.purerandom import PureRandom
from .workloads.synthetic import (_configs_to_x, random_tsp_distances,
                                  rosenbrock_device, tsp_device)

N_CITIES = 12
TSP_SEED = 7


def flagship_space() -> Space:
    return Space(
        [FloatParam(f"x{i}", -5.0, 5.0) for i in range(8)]
        + [IntParam("i0", 0, 64), LogIntParam("li0", 1, 4096),
           Pow2Param("p0", 1, 256), BoolParam("b0"),
           EnumParam("e0", ("a", "b", "c", "d")),
           PermParam("tour", tuple(range(N_CITIES)))])


def flagship_objective(device: torch.device):
    """(vals, perms) -> rosenbrock(vals[..., :8]) + tour length."""
    dist = torch.as_tensor(random_tsp_distances(N_CITIES, TSP_SEED),
                           dtype=torch.float32).to(device)

    def objective(vals, perms):
        return rosenbrock_device(vals[..., :8]) + tsp_device(perms[0], dist)
    return objective


def flagship_host_objective(device: DeviceLike = "cuda"):
    """The flagship's objective for the `Tuner`: config dicts -> numpy
    values, in the manner of `workloads.make_host_objective`: the float
    lanes x0..x7 (float32) and the tours (int64) go to `device` as one
    batch (on the card through pinned memory, without a synchronisation),
    are scored there in one call, and the values come back."""
    dev = resolve_device(device)
    score = flagship_objective(dev)

    def put(t):
        return (t.pin_memory().to(dev, non_blocking=True)
                if dev.type == "cuda" else t)

    def objective(cfgs):
        x = torch.as_tensor(_configs_to_x(cfgs, 8), dtype=torch.float32)
        tours = torch.as_tensor([c["tour"] for c in cfgs], dtype=torch.int64)
        return score(put(x), (put(tours),)).cpu().numpy()
    return objective


def flagship(scale: int = 1, history_capacity: int = 1 << 15,
             device: DeviceLike = "cuda") -> FusedEngine:
    """The flagship FusedEngine on `device`."""
    device = resolve_device(device)
    space = flagship_space()
    return FusedEngine(space, flagship_objective(device),
                       arms=_padded(default_arms(scale), space),
                       history_capacity=history_capacity, device=device)


def resized(t: Technique, rows: int) -> Technique:
    """A deep copy of `t` proposing `rows` rows a step: its population or
    batch is set to `rows` (a composable DE's is its wrapped DE's)."""
    t = copy.deepcopy(t)
    inner = getattr(t, "_de", t)
    for field in ("N", "batch", "population_size"):
        if hasattr(inner, field):
            setattr(inner, field, rows)
            return t
    raise TypeError(f"{t.name} has no population or batch to resize")


def portfolio_arms(scale: int = 1) -> list:
    """Every non-meta arm of the registry that supports the flagship's
    space and is not a default arm, taken from the registry with their
    populations scaled by `scale`: the PSO_GA_Bandit members (PSO and the
    GA under each crossover, and ga-base), GGA, composable DE (OX1, CX),
    bandit mutation, pattern search and annealing; then RegularTorczon,
    MultiTorczon and MultiNelderMead (the simplexes' sizes follow the
    space)."""
    from .techniques.base import get_root
    space = flagship_space()
    members = list(get_root(["PSO_GA_Bandit"]).techniques) + [
        get_root([n]) for n in (
            "GGA", "ComposableDiffEvolution", "ComposableDiffEvolutionCX",
            "AUCBanditMutationTechnique", "PatternSearch",
            "PseudoAnnealingSearch")]
    arms = [resized(t, scale * t.natural_batch(space)) for t in members]
    return arms + [get_root([n]) for n in (
        "RegularTorczon", "MultiTorczon", "MultiNelderMead")]


def _padded(arms: list, space: Space) -> list:
    """`arms` and a PureRandom arm padding the step to a multiple of 8
    rows."""
    pad = (-sum(t.natural_batch(space) for t in arms)) % 8
    return arms + [PureRandom(batch=pad)] if pad else arms


def flagship_portfolio(scale: int = 1, history_capacity: int = 1 << 15,
                       device: DeviceLike = "cuda") -> FusedEngine:
    """The flagship's space and objective under `portfolio_arms(scale)`,
    on `device`."""
    device = resolve_device(device)
    space = flagship_space()
    return FusedEngine(space, flagship_objective(device),
                       arms=_padded(portfolio_arms(scale), space),
                       history_capacity=history_capacity, device=device)


def flagship_surrogate(n_train: int, seed: int = 0,
                       device: DeviceLike = "cuda"
                       ) -> Tuple[torch.Tensor, torch.Tensor,
                                  Tuple[int, int]]:
    """`n_train` uniform flagship configurations, drawn from `seed`, and
    their objective: -> (GP features [n_train, 31], targets [n_train],
    (n_cont, n_cat)) for `gp.fit*`.  The features are 23 continuous lanes
    (11 numeric, 12 tour positions) and the two categorical lanes one-hot
    over 4 codes."""
    device = resolve_device(device)
    space = flagship_space()
    cands = space.random(rng.generator(seed, device), n_train)
    feats = space.surrogate_transform(space.features(cands))
    y = flagship_objective(device)(space.decode_scalars(cands.u),
                                   cands.perms)
    return feats, y, (space.n_cont_features, space.n_cat)
