"""The surrogate evaluator of the batched engine.

Counterpart of the part of `uptune_tpu/engine/batched.py` that the single
engine uses: `StatefulEval`, `surrogate_aux` and `surrogate_eval_fn`.
`BatchedEngine`, `exchange_best` and `exchange_topk` are not ported yet.

A surrogate eval_fn scores a flat candidate batch against a fitted GP so
that the engine prefers low posterior mean ('mean'), high expected
improvement ('ei') or low mu - beta*sd ('lcb').  With impl='fused' the
score is the fused acquisition pass (`ops/acquire.py`, launcher C on the
card); impl='score_flat' keeps the staging through `gp.score_flat`
(launchers A and B past 4096 rows).
"""
from __future__ import annotations

from typing import Callable, Optional

import torch

from ..ops import acquire
from ..space.spec import CandBatch
from ..surrogate import gp


class StatefulEval:
    """An eval_fn whose learned state is an argument: `fn(cands, aux)` is
    built once, and the GP snapshot lives in `.aux`, so a refit is one
    `publish`.  `topk(cands, aux, k) -> (vals [k], idx [k])` is the fused
    score + acquisition + top-k companion; calling the object scores a
    batch against the current aux."""
    __slots__ = ("fn", "topk", "aux")

    def __init__(self, fn: Callable, aux, topk: Optional[Callable] = None):
        self.fn, self.aux, self.topk = fn, aux, topk

    def __call__(self, cands: CandBatch) -> torch.Tensor:
        return self.fn(cands, self.aux)

    def publish(self, aux) -> None:
        """Swap in a new snapshot (same kind and training bucket)."""
        self.aux = aux


def surrogate_aux(gp_state: gp.GPState, best_y=None, kind: str = "ei"):
    """(GPState with the premasked K^-1 attached for the variance kinds,
    best-so-far as an f32 scalar on the state's device)."""
    if kind != "mean" and gp_state.kinv is None:
        gp_state = gp.precompute_kinv(gp_state)
    return (gp_state, torch.as_tensor(0.0 if best_y is None else best_y,
                                      dtype=torch.float32,
                                      device=gp_state.x.device))


def surrogate_eval_fn(space, gp_state: gp.GPState, kind: str = "ei",
                      best_y=None, beta: float = 2.0,
                      n_cont: Optional[int] = None, n_cat: int = 0,
                      sense: str = "min", impl: str = "fused"
                      ) -> StatefulEval:
    """A flat-batch eval_fn over a fitted GPState (see the module
    docstring).  `sense` must match the engine's: the engine re-orients
    what an eval_fn returns (`qor = sign * raw`), so this pre-applies the
    inverse; the GP is assumed fitted on minimized QoR."""
    if sense not in ("min", "max"):
        raise ValueError(f"sense must be 'min' or 'max', got {sense!r}")
    if impl not in ("fused", "score_flat"):
        raise ValueError(f"unknown impl {impl!r}")
    if kind == "ei" and best_y is None:
        raise ValueError("kind='ei' needs best_y")
    sgn = 1.0 if sense == "min" else -1.0

    def feats(cands: CandBatch) -> torch.Tensor:
        return space.surrogate_transform(space.features(cands))

    def fn(cands: CandBatch, aux) -> torch.Tensor:
        st, by = aux
        if impl == "fused":
            u = acquire.acquire_scores(
                st, feats(cands), kind=kind,
                best_y=by if kind == "ei" else None,
                beta=beta, n_cont=n_cont, n_cat=n_cat)
            # utilities are higher-is-better; negation is exact
            return sgn * (-u)
        s = gp.score_flat(st, feats(cands), kind=kind,
                          best_y=by if kind == "ei" else None,
                          beta=beta, n_cont=n_cont, n_cat=n_cat)
        return sgn * (-s if kind == "ei" else s)

    def topk(cands: CandBatch, aux, k: int):
        st, by = aux
        return acquire.acquire_topk(
            st, feats(cands), k, kind=kind,
            best_y=by if kind == "ei" else None,
            beta=beta, n_cont=n_cont, n_cat=n_cat)

    return StatefulEval(fn, surrogate_aux(gp_state, best_y, kind), topk=topk)
