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

While the obs plane records, a step counts its instances' commits
(`engine.instance_commits`, N a step) and an exchanging step records the
span `engine.exchange` around `exchange_best` and counts one
`engine.exchanges`.

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
nothing to gate.

The mesh route (`mesh=`, a one-axis ('idev',) mesh from
`make_instance_mesh`) splits the instance axis into one contiguous
block of instances a shard.  A step runs every shard's vmapped propose,
ONE evaluation of the shard's flat batch (launcher C once a shard when
the eval_fn is the fused acquisition) and its vmapped `commit_head`
(the merge once a shard), then the exchange over every instance of
every shard (the shards' bests stacked on the first shard's device,
`parallel/mesh.py`'s collective over a local axis), then every shard's
`commit_tail`.  The shards run one after another on the engine's
device; on one card the mesh lists ``cuda:0`` once a shard.  A sharded
run equals the unsharded run of the same seed bitwise wherever the
evaluation of a row does not depend on the rows evaluated beside it.

The slot primitives are the serving plane's seam (`serve/group.py`): a
session server multiplexes ask/tell tenants onto ONE stacked state, one
slot each.  `propose_all` proposes for every slot in one vmapped call,
`init_slot` (join, and slot reuse after a leave) and `commit_slot` (a
tenant's measured epoch) touch one slot's row, and `propose_topk` /
`global_topk` rank every slot's proposal with launcher D over the
instance axis (one launch), the second merging the per-slot tops into
one portfolio-wide top k (`exchange_topk`).  They are eager methods, the
counterparts of the JAX package's `jit_*` slot programs: there is no
program to compile or memoize.

A surrogate eval_fn scores a flat candidate batch against a fitted GP so
that the engine prefers low posterior mean ('mean'), high expected
improvement ('ei') or low mu - beta*sd ('lcb').  With impl='fused' the
score is the fused acquisition pass (`ops/acquire.py`, launcher C on the
card); impl='score_flat' keeps the staging through `gp.score_flat`
(launchers A and B past 4096 rows).
"""
from __future__ import annotations

import contextlib
from typing import Callable, List, Optional, Tuple, Union

import numpy as np
import torch

from .. import obs, rng
from ..device import DeviceLike, resolve_device
from ..ops import acquire
from ..parallel.mesh import (Mesh, canonical, gather_local, stack_trees,
                             unstack_tree)
from ..space.spec import CandBatch
from ..surrogate import gp
from ..techniques.base import Best
from .fused import EngineState, FusedEngine

# the instance mesh's one axis (the JAX package's shard_map axis name)
MESH_AXIS = "idev"


def make_instance_mesh(n_devices: Optional[int] = None, devices=None,
                       device: DeviceLike = "cuda"):
    """1-D ('idev',) mesh of one process: `devices`, or `device` listed
    `n_devices` times (default once) — on one card every shard is
    ``cuda:0``."""
    if devices is None:
        devices = [resolve_device(device)] * (n_devices or 1)
    devices = list(devices)
    if n_devices is not None:
        devices = devices[:n_devices]
    return Mesh(np.array(devices, dtype=object), (MESH_AXIS,))


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
    into a cooperative portfolio; `mesh` (a ('idev',) mesh from
    `make_instance_mesh`) splits the instances into one block a shard
    (see the module docstring)."""

    def __init__(self, engine: FusedEngine, n_instances: int,
                 exchange_every: int = 0, mesh=None):
        if n_instances < 1:
            raise ValueError(f"n_instances must be >= 1: {n_instances}")
        self.engine = engine
        self.n_instances = int(n_instances)
        self.exchange_every = int(exchange_every)
        self.mesh = mesh
        self.n_shards = 1
        if mesh is not None:
            self.n_shards = n_dev = mesh.shape[MESH_AXIS]
            if self.n_instances % n_dev:
                raise ValueError(
                    f"n_instances {n_instances} not divisible by "
                    f"mesh axis size {n_dev}")
            if mesh.group is not None:
                raise ValueError("an instance mesh is one process's "
                                 "(make_instance_mesh)")
            on = {canonical(d) for d in mesh.devices.flat}
            if on != {canonical(engine.device)}:
                raise ValueError(
                    f"the instance mesh's shards run on the engine's "
                    f"device {engine.device}, not on "
                    f"{sorted(str(d) for d in on)}")
        self.n_local = self.n_instances // self.n_shards

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
        head = self._head(state, tstates, cands, raw)
        if exchange:
            head = head._replace(best=exchange_best(head.best))
        return self._tail(state, tstates, cands, head, keys, draws)

    def _head(self, state, tstates, cands, raw):
        with _no_vmap_fallback():
            return torch.func.vmap(self.engine.commit_head)(
                state, tstates, cands, raw)

    def _tail(self, state, tstates, cands, head, keys, draws=None):
        # None (no draws, or an arm's without observe draws) is passed
        # as it is
        with _no_vmap_fallback():
            return torch.func.vmap(self.engine.commit_tail, in_dims=(
                0, 0, 0, 0, 0, _map(lambda t: 0, draws)))(
                state, tstates, cands, head, keys, draws)

    def _split(self, tree) -> list:
        """The mesh's shards of a stacked tree: one block of n_local
        instances a shard (the whole tree unsharded)."""
        if self.mesh is None:
            return [tree]
        return unstack_tree(tree, self.n_shards, self.n_local)

    def _join(self, shards: list):
        """The shards' trees stacked on the first shard's device (the
        collective over the instance mesh's local axis)."""
        if len(shards) == 1:
            return shards[0]
        return stack_trees(shards, cat=True)

    def _step(self, shards: list, t: int,
              eval_fn: Optional[Callable] = None) -> list:
        """Every shard's propose (vmapped) -> score (ONE flat call a
        shard) -> commit_head (vmapped), the exchange across every
        instance after every exchange_every-th step, then every shard's
        commit_tail (vmapped)."""
        props, heads = [], []
        for s in shards:
            with _no_vmap_fallback():
                tstates, cands, keys = torch.func.vmap(self.engine.propose)(
                    s)
            n, b = cands.u.shape[0], cands.u.shape[1]
            flat = CandBatch(cands.u.reshape(n * b, -1),
                             tuple(p.reshape(n * b, p.shape[-1])
                                   for p in cands.perms))
            raw = (eval_fn or self.engine.evaluate)(flat).reshape(n, b)
            props.append((tstates, cands, keys))
            heads.append(self._head(s, tstates, cands, raw))
        obs.count("engine.instance_commits", self.n_instances)
        k = self.exchange_every
        if k > 0 and (t + 1) % k == 0:
            with obs.span("engine.exchange"):
                best = exchange_best(self._join([h.best for h in heads]))
                heads = [h._replace(best=bs)
                         for h, bs in zip(heads, self._split(best))]
            obs.count("engine.exchanges")
        return [self._tail(s, ts, c, h, kk)
                for s, (ts, c, kk), h in zip(shards, props, heads)]

    def run(self, state: EngineState, n_steps: int,
            eval_fn: Optional[Callable] = None) -> EngineState:
        """n_steps batched steps; the exchange counts steps from 0 in
        each call, as the JAX package's scan does.  Each call is one
        `engine.batched_run` dispatch window of the obs plane."""
        return _run_obs(self, state, n_steps, eval_fn)

    def _run_steps(self, state: EngineState, n_steps: int,
                   eval_fn: Optional[Callable]) -> EngineState:
        shards = self._split(state)
        for t in range(n_steps):
            shards = self._step(shards, t, eval_fn)
        return self._join(shards)

    def run_traced(self, state: EngineState, n_steps: int
                   ) -> Tuple[EngineState, torch.Tensor]:
        """Like run() but also returns the per-instance best-so-far trace
        [n_steps, n_instances] in the user's orientation.  Unsharded
        only, as in the JAX package."""
        if self.mesh is not None:
            raise ValueError("run_traced is unsharded-only")
        sign = self.engine.sign
        trace = []
        for t in range(n_steps):
            state, = self._step([state], t)
            trace.append(sign * state.best.qor)
        return state, torch.stack(trace)

    # -- slot primitives (the serving plane's join/ask/tell seam) ------------
    # The JAX programs donate the stacked state (`donate_argnums=(0,)`):
    # no caller reads a state again once it has passed it to init_slot or
    # commit_slot.  So the port writes slot i's row in place, outside
    # vmap, and returns the same state; a `ProposalEpoch` (serve/group.py)
    # holds `propose_all`'s outputs, never the state.  Those outputs may
    # share storage with the state where an arm's propose hands a state
    # leaf back unchanged; a later in-place write to slot j's row then
    # shows in the epoch's row j only, which is stale for slot j from
    # that write on (its generation moved), and no other row moves.

    def propose_all(self, state: EngineState
                    ) -> Tuple[tuple, CandBatch, torch.Tensor]:
        """vmap(propose) over the stacked state -> (stacked new tstates,
        stacked CandBatch [n, B, ...], stacked keys).  A pure read of the
        state: one epoch can be re-derived, identically, for any slot
        that has not moved since."""
        self._unsharded()
        return _propose_all_obs(self, state)

    def _propose_all(self, state):
        with _no_vmap_fallback():
            return torch.func.vmap(self.engine.propose)(state)

    def init_slot(self, state: EngineState, i: int,
                  seed: Union[int, torch.Tensor],
                  draws: Optional[tuple] = None) -> EngineState:
        """Slot i re-initialised from `seed` (an integer seed or an
        `rng.key`), written in place: session join, and slot reuse after
        a leave (the departed tenant's rows are overwritten).  The row is
        `FusedEngine.init(seed)`, so it depends on the seed alone, never
        on the slot's position; `draws` (per arm) as for `init`."""
        self._unsharded()
        return _init_slot_obs(self, state, i, seed, draws)

    def _init_slot(self, state, i, seed, draws):
        _write_row(state, int(i), self.engine.init(seed, draws))
        return state

    def commit_slot(self, state: EngineState, tstates, cands: CandBatch,
                    keys: torch.Tensor, raw: torch.Tensor, i: int,
                    draws: Optional[tuple] = None) -> EngineState:
        """Slot i's proposal epoch committed, written in place: `tstates`
        / `cands` / `keys` are `propose_all` outputs (stacked), `raw` the
        [B] un-oriented measured QoR of slot i's rows.  One
        `FusedEngine.commit` on slot i's row (one merge launch); only row
        i changes.  No exchange: server sessions are independent tenants,
        coupled only through the shared results store.  `draws` (per arm,
        for observe) default to those of slot i's key."""
        self._unsharded()
        return _commit_slot_obs(self, state, tstates, cands, keys, raw, i,
                                draws)

    def _commit_slot(self, state, tstates, cands, keys, raw, i, draws):
        i = int(i)
        at = lambda t: _map(lambda x: x[i], t)  # noqa: E731
        new_i = self.engine.commit(at(state), at(tstates), at(cands), raw,
                                   keys[i], draws=draws)
        _write_row(state, i, new_i)
        return state

    def _unsharded(self) -> None:
        if self.mesh is not None:
            # a sharded group would put every tenant's ask on every
            # shard; the serving plane scales by more groups instead
            raise ValueError("slot primitives are unsharded-only")

    def propose_topk(self, state: EngineState, k: int, acq, aux=None):
        """One proposal epoch and each slot's fused top k by acquisition
        -> (tstates, cands, keys, vals [n, k], idx [n, k]).  `acq` is a
        `StatefulEval` with a `.topk` (`surrogate_eval_fn(...,
        impl="fused")`); `aux` defaults to its published snapshot.  On
        the card the instances rank in one launch of D (one a shard
        under a mesh, the shards' outputs stacked after)."""
        if acq.topk is None:
            raise ValueError("acq has no topk (need impl='fused')")
        return self._join(_propose_topk_obs(
            self, state, k, acq, acq.aux if aux is None else aux))

    def _propose_topk(self, state, k, acq, aux) -> list:
        out = []
        for s in self._split(state):
            with _no_vmap_fallback():
                tstates, cands, keys = torch.func.vmap(
                    self.engine.propose)(s)
                vals, idx = torch.func.vmap(
                    lambda c: acq.topk(c, aux, k))(cands)
            out.append((tstates, cands, keys, vals, idx))
        return out

    def global_topk(self, state: EngineState, k: int, acq, aux=None):
        """One proposal epoch, each instance's fused top k, then the
        portfolio-wide top k of the [n * B] pool (`exchange_topk`) ->
        (vals, owner, idx), each [n, k] with identical rows: `owner` is
        the instance that proposed each winner, `idx` its row there.
        Under a mesh each shard ranks its instances (D once a shard) and
        the collective stacks the shards' top-k lists on the first
        shard's device before the exchange."""
        if acq.topk is None:
            raise ValueError("acq has no topk (need impl='fused')")
        shards = _propose_topk_obs(self, state, k, acq,
                                   acq.aux if aux is None else aux)
        vals = gather_local([sh[3] for sh in shards])
        idx = gather_local([sh[4] for sh in shards])
        n = self.n_instances
        return tuple(x.expand(n, k)
                     for x in _global_topk_obs(vals, idx, k))

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


def exchange_topk(vals: torch.Tensor, idx: torch.Tensor, k: int
                  ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The portfolio-wide top k of the instances' own top-k lists: `vals`
    / `idx` [n, k] (each row descending, `idx` a row's place in its
    instance's batch), pooled in (instance, local rank) order, the k
    largest kept, ties to the lowest flat index (the JAX package's
    `lax.top_k` over the flattened pool) -> (vals [k], owner [k] int32,
    idx [k] int32).  `vals` / `idx` hold every instance's list: under an
    instance mesh `BatchedEngine.global_topk` gathers the shards' lists
    first, and every instance reads the same winners."""
    v, pos = acquire.select_topk(vals.reshape(-1), k)
    pos = pos.long()
    return (v, torch.div(pos, k, rounding_mode="floor").to(torch.int32),
            idx.to(torch.int32).reshape(-1)[pos])


def _write_row(state, i: int, row) -> None:
    """Every leaf of `row` into row i of the stacked `state`'s leaf, in
    place (the slot primitives' donated write)."""
    leaves_s, leaves_r = [], []
    _map(leaves_s.append, state)
    _map(leaves_r.append, row)
    if len(leaves_s) != len(leaves_r):
        raise ValueError("the slot's row does not match the stacked state")
    for a, b in zip(leaves_s, leaves_r):
        a[i].copy_(b)


def _map(fn, tree):
    """fn over every tensor of a tree of NamedTuples and tuples."""
    if isinstance(tree, torch.Tensor):
        return fn(tree)
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(_map(fn, x) for x in tree))
    if isinstance(tree, tuple):
        return tuple(_map(fn, x) for x in tree)
    return tree


# the batched engine's observability seam (one wrapper for every
# engine; the obs registry keys programs by name)
_run_obs = obs.instrument_device_fn(
    lambda eng, *args: eng._run_steps(*args), "engine.batched_run")
_propose_all_obs = obs.instrument_device_fn(
    lambda eng, *args: eng._propose_all(*args), "engine.propose_all")
_propose_topk_obs = obs.instrument_device_fn(
    lambda eng, *args: eng._propose_topk(*args), "engine.propose_topk")
_global_topk_obs = obs.instrument_device_fn(exchange_topk,
                                            "engine.global_topk")
_init_slot_obs = obs.instrument_device_fn(
    lambda eng, *args: eng._init_slot(*args), "engine.init_slot")
_commit_slot_obs = obs.instrument_device_fn(
    lambda eng, *args: eng._commit_slot(*args), "engine.commit_slot")


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
        # the features apart from the launch that scores them
        with obs.span("acquire.features"):
            return space.surrogate_features(cands)

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
