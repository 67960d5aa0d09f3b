"""Multi-shard GP acquisition scoring: candidates sharded over a mesh
axis, the fitted GPState replicated.

Counterpart of `uptune_tpu/parallel/surrogate_shard.py`.  At 10^5-10^6
pool candidates an acquisition's [B, N] cross-kernel dominates, and it
is embarrassingly parallel over B: each shard scores its slice of the
batch against the full (replicated) training set, and the scores are
gathered back.  The regime is chosen PER SHARD, as in the JAX package:
once a shard's slice reaches `PALLAS_MIN_POOL` candidates, mean / ei /
lcb go through the fused mean + variance path
(`pallas_score.gp_mean_var_scores`: launcher B on the card, its plain
version on the CPU — the tensors' device picks, there is no mode knob),
and smaller slices through `gp.predict`; `use_pallas=` overrides the
choice, as the reference's argument does.  Thompson samples always use
`gp.predict`, and each shard draws its own normals from its own key
(`rng.split(key, n)[i]`), so shards never repeat each other's draws.

Shards of a local axis run one after another in this process and their
scores are stacked on the axis's first device; an axis that spans
processes scores this process's positions and gathers the rest through
the process group (`parallel/mesh.py`).
"""
from __future__ import annotations

from typing import Optional

import torch

from .. import rng
from ..surrogate import gp as gp_mod
from ..surrogate import pallas_score
from ..surrogate.gp import GPState
from .mesh import Mesh, all_gather, gather_local

SCORES = ("mean", "ei", "lcb", "thompson")


def sharded_gp_score(mesh: Mesh, axis: str, state: GPState,
                     feats: torch.Tensor, kind: str = "ei",
                     best_y: Optional[float] = None,
                     key: Optional[torch.Tensor] = None,
                     beta: float = 2.0,
                     n_cont: Optional[int] = None,
                     n_cat: int = 0,
                     use_pallas: Optional[bool] = None) -> torch.Tensor:
    """[B, F] candidate features -> [B] acquisition scores, with B
    sharded over `mesh.shape[axis]` shards and the GPState replicated.

    kind='mean' returns the predictive mean, 'ei' expected improvement
    over `best_y` (higher = better), 'lcb' the lower confidence bound
    (lower = better), 'thompson' one posterior sample per point (needs
    `key`, an `rng.key`; each shard draws from its own key split off it).

    `n_cont`/`n_cat` are the mixed-kernel split (Space.n_cont_features /
    Space.n_cat) and MUST match what the state was fitted with."""
    if kind not in SCORES:
        raise ValueError(f"unknown score {kind!r}; known: {SCORES}")
    if kind == "ei" and best_y is None:
        raise ValueError("kind='ei' needs best_y (incumbent QoR)")
    if kind == "thompson" and key is None:
        raise ValueError("kind='thompson' needs a PRNG key")
    n = mesh.shape[axis]
    b = feats.shape[0]
    if b % n:
        raise ValueError(f"batch {b} not divisible by mesh axis "
                         f"{axis!r} of size {n}")
    shard = b // n
    if use_pallas is None:
        use_pallas = shard >= pallas_score.PALLAS_MIN_POOL
    if use_pallas and state.kinv is None and kind != "thompson":
        # attach the premasked K^-1 ONCE here, not once a shard
        state = gp_mod.precompute_kinv(state)
    best = torch.as_tensor(0.0 if best_y is None else best_y,
                           dtype=torch.float32, device=feats.device)
    keys = rng.split(key, n) if kind == "thompson" else None

    def local(i: int) -> torch.Tensor:
        x = feats[i * shard:(i + 1) * shard].to(mesh.device_of(axis, i))
        if kind == "thompson":
            z = gp_mod.draw_thompson(rng.Stream(keys[i]), shard)
            return gp_mod.thompson(state, x, z, n_cont, n_cat)
        if use_pallas:
            mu, sd = pallas_score.gp_mean_var_scores(state, x, n_cont,
                                                     n_cat)
        else:
            mu, sd = gp_mod.predict(state, x, n_cont, n_cat)
        if kind == "mean":
            return mu
        if kind == "ei":
            return gp_mod.ei_from_moments(mu, sd, best.to(mu.device))
        return mu - beta * sd

    out = gather_local([local(i) for i in mesh.owned(axis)])
    return all_gather(mesh, out) if mesh.spans_processes(axis) else out
