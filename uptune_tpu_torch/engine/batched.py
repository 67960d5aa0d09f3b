"""The batched multi-instance engine and the surrogate evaluator.

Counterpart of `uptune_tpu/engine/batched.py`.  `BatchedEngine` runs N
independent tunes of one space as one program: the `EngineState`s are
stacked along a leading instance axis, and a step is

* `propose` under `torch.func.vmap` over the instances;
* ONE evaluation of the flattened [N*B] batch (the objective, or an
  eval_fn such as launcher C's fused acquisition, sees every instance's
  rows in one launch);
* `commit_head` under vmap, then (every `exchange_every` steps)
  `exchange_best` across the stacked best, then `commit_tail` under vmap.

Every op under vmap has a batching rule, so a step makes the same
launches at any N (vmap's per-instance fallback is switched off inside
the step, so an op without a rule raises instead of looping), and the
history merge is one launch of the merge kernel over all instances
(`ops/dedup.py`).  Each instance draws from its own key
(`instance_seeds`), so instance i of a batched run equals
`FusedEngine.init(instance_seeds(seed)[i])` run alone, bitwise, unless
an exchange couples them.

The JAX package gates eviction at the batch level (`evict_pred`, one
unbatched predicate, so that the evict branch of its `lax.cond` does not
run for every instance).  The port's history evicts on every insert,
which is the identity at zero overflow (`History._evict`), so there is
nothing to gate.  The mesh route (`mesh=`, `make_instance_mesh`) and the
top-k exchange (`exchange_topk`, `jit_global_topk`, `jit_propose_topk`)
and the serving plane's slot primitives are not ported yet.

A surrogate eval_fn scores a flat candidate batch against a fitted GP so
that the engine prefers low posterior mean ('mean'), high expected
improvement ('ei') or low mu - beta*sd ('lcb').  With impl='fused' the
score is the fused acquisition pass (`ops/acquire.py`, launcher C on the
card); impl='score_flat' keeps the staging through `gp.score_flat`
(launchers A and B past 4096 rows).
"""
from __future__ import annotations

import contextlib
from typing import Callable, List, Optional, Tuple

import numpy as np
import torch

from .. import rng
from ..ops import acquire
from ..space.spec import CandBatch
from ..surrogate import gp
from ..techniques.base import Best
from .fused import EngineState, FusedEngine


def exchange_best(best: Best, dim: int = 0) -> Best:
    """The global best, copied to every instance of a `Best` stacked
    along `dim`: the lexicographic (qor, instance index) minimum, picked
    as the JAX package's one-hot psum does (the sum over instances of
    the winner's row and zeros).  Every instance keeps its own
    configuration while no QoR is finite."""
    qor = best.qor.movedim(dim, 0)
    n = qor.shape[0]
    qmin = torch.min(qor)
    rank = torch.arange(n, device=qor.device)
    winner = torch.min(torch.where(qor == qmin, rank, 1 << 30))
    have = torch.isfinite(qmin)
    i_am = (rank == winner) & have

    def pick(x):
        x = x.movedim(dim, 0)
        one = i_am.reshape((n,) + (1,) * (x.dim() - 1))
        won = torch.where(one, x, torch.zeros_like(x)).sum(0)
        return torch.where(have, won.expand_as(x), x).movedim(0, dim)

    return Best(pick(best.u), tuple(pick(p) for p in best.perms),
                qmin.expand_as(best.qor))


@contextlib.contextmanager
def _no_vmap_fallback():
    """Inside: an op without a vmap batching rule raises instead of
    running once per instance."""
    was = torch._C._functorch._is_vmap_fallback_enabled()
    torch._C._functorch._set_vmap_fallback_enabled(False)
    try:
        yield
    finally:
        torch._C._functorch._set_vmap_fallback_enabled(was)


class BatchedEngine:
    """A `FusedEngine` over a leading instance axis: `n_instances`
    independent searches of one space in one program (see the module
    docstring); `exchange_every=k` copies the global best to every
    instance after every k-th step of a run, which turns multi-start
    into a cooperative portfolio."""

    def __init__(self, engine: FusedEngine, n_instances: int,
                 exchange_every: int = 0):
        if n_instances < 1:
            raise ValueError(f"n_instances must be >= 1: {n_instances}")
        self.engine = engine
        self.n_instances = int(n_instances)
        self.exchange_every = int(exchange_every)

    # -- state management ---------------------------------------------------
    def instance_seeds(self, seed: int) -> torch.Tensor:
        """[n_instances, 2]: the per-instance keys `init` derives from
        `seed`, so that a sequential run can start `FusedEngine.init`
        from instance i's (the counterpart of `instance_keys`)."""
        return rng.split(rng.key(seed, self.engine.device),
                         self.n_instances)

    def init(self, seed: int = 0) -> EngineState:
        """The stacked per-instance states ([n_instances] leading axis)."""
        with _no_vmap_fallback():
            state = torch.func.vmap(self.engine.init)(
                self.instance_seeds(seed))
        # vmap returns what init makes without a draw broadcast over the
        # instances; give every leaf its own storage
        return _map(torch.Tensor.contiguous, state)

    # -- the batched step ---------------------------------------------------
    def commit(self, state: EngineState, tstates, cands: CandBatch,
               raw: torch.Tensor, keys: torch.Tensor,
               exchange: bool = False,
               draws: Optional[tuple] = None) -> EngineState:
        """One commit of every instance: `commit_head` under vmap, then
        `exchange_best` across the stacked best if `exchange`, then
        `commit_tail` under vmap.  `raw` is [n, B]; `draws` (stacked per
        arm, as `draw_observe` makes them for one instance) default to
        those of each instance's key."""
        eng = self.engine
        with _no_vmap_fallback():
            head = torch.func.vmap(eng.commit_head)(state, tstates, cands,
                                                    raw)
            if exchange:
                head = head._replace(best=exchange_best(head.best))
            # None (no draws, or an arm's without observe draws) is
            # passed as it is
            return torch.func.vmap(eng.commit_tail, in_dims=(
                0, 0, 0, 0, 0, _map(lambda t: 0, draws)))(
                state, tstates, cands, head, keys, draws)

    def _step(self, state: EngineState, t: int,
              eval_fn: Optional[Callable] = None) -> EngineState:
        """propose (vmapped) -> score (ONE flat call) -> commit (vmapped,
        exchanging after every exchange_every-th step)."""
        with _no_vmap_fallback():
            tstates, cands, keys = torch.func.vmap(self.engine.propose)(
                state)
        n, b = cands.u.shape[0], cands.u.shape[1]
        flat = CandBatch(cands.u.reshape(n * b, -1),
                         tuple(p.reshape(n * b, p.shape[-1])
                               for p in cands.perms))
        raw = (eval_fn or self.engine.evaluate)(flat).reshape(n, b)
        k = self.exchange_every
        return self.commit(state, tstates, cands, raw, keys,
                           exchange=k > 0 and (t + 1) % k == 0)

    def run(self, state: EngineState, n_steps: int,
            eval_fn: Optional[Callable] = None) -> EngineState:
        """n_steps batched steps; the exchange counts steps from 0 in
        each call, as the JAX package's scan does."""
        for t in range(n_steps):
            state = self._step(state, t, eval_fn)
        return state

    def run_traced(self, state: EngineState, n_steps: int
                   ) -> Tuple[EngineState, torch.Tensor]:
        """Like run() but also returns the per-instance best-so-far trace
        [n_steps, n_instances] in the user's orientation."""
        sign = self.engine.sign
        trace = []
        for t in range(n_steps):
            state = self._step(state, t)
            trace.append(sign * state.best.qor)
        return state, torch.stack(trace)

    # -- host-side results --------------------------------------------------
    def best_qors(self, state: EngineState) -> np.ndarray:
        """[n_instances] per-instance best QoR in the user's orientation
        (a host read: the reporting boundary)."""
        return self.engine.sign * state.best.qor.cpu().numpy()

    def best_config(self, state: EngineState, i: int) -> dict:
        """Instance i's incumbent configuration."""
        return self.engine.space.to_configs(
            _map(lambda t: t[i], state.best).as_batch(1))[0]

    def best_configs(self, state: EngineState) -> List[dict]:
        return self.engine.space.to_configs(
            CandBatch(state.best.u, state.best.perms))

    def best(self, state: EngineState) -> Tuple[dict, float]:
        """(config, qor) of the globally best instance."""
        qors = self.best_qors(state)
        i = int(np.argmin(self.engine.sign * qors))
        return self.best_config(state, i), float(qors[i])


def _map(fn, tree):
    """fn over every tensor of a tree of NamedTuples and tuples."""
    if isinstance(tree, torch.Tensor):
        return fn(tree)
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(_map(fn, x) for x in tree))
    if isinstance(tree, tuple):
        return tuple(_map(fn, x) for x in tree)
    return tree


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
