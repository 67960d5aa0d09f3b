"""Multi-replica scale-out of the fused engine over a ('search', 'eval')
mesh.

Counterpart of `uptune_tpu/parallel/sharded.py`.  The reference scales
search by running one OpenTuner instance per parallel slot and
synchronising their results epoch-wise through a global SQLite table,
and evaluation by Ray actors.  The mesh maps both axes:

* **`search` axis** — independent search replicas (own technique states,
  own key streams, own dedup history), exchanging the global best every
  step: the lexicographic (qor, replica) argmin, broadcast as a one-hot
  sum (`engine.batched.exchange_best`), the local best kept while
  nothing is finite;
* **`eval` axis** — each replica's candidate batch is split into
  `n_eval` slices, each evaluated on its own, and the QoR is gathered
  back so that `observe` sees the whole population.  Proposal
  generation is the replica's own (one propose a replica a step).

The JAX package runs the whole multi-replica run as one `shard_map`-ped
scan.  Here a step runs every replica this process holds in turn
(`propose`, the sharded evaluation, `commit_head`), then the exchange,
then every replica's `commit_tail`; the exchange gathers the bests of
the replicas other processes hold through the process group
(`parallel/mesh.py`).  Each replica's commit launches the merge kernel
once on the card.  With one search replica the eval sharding is
invisible: the run equals `FusedEngine.run` from the replica's key.

A `ShardedEngine` runs on its engine's device: every mesh position this
process holds must be that device (several cards are several processes,
`make_multihost_mesh`).
"""
from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from .. import rng
from ..device import resolve_device
from ..engine import batched
from ..engine.fused import EngineState, FusedEngine
from ..techniques.base import Best
from .mesh import Mesh, all_gather, canonical, stack_trees, unstack_tree


def make_mesh(n_search: Optional[int] = None, n_eval: int = 1,
              devices: Optional[Sequence] = None, device="cuda") -> Mesh:
    """A one-process ('search', 'eval') mesh: `devices` (default
    `device` listed n_search * n_eval times; on one card every shard is
    ``cuda:0``).  `n_search` defaults to len(devices) // n_eval."""
    if devices is None:
        dev = resolve_device(device)
        devices = [dev] * ((n_search or 1) * n_eval)
    devices = list(devices)
    if n_search is None:
        n_search = len(devices) // n_eval
    n = n_search * n_eval
    if n > len(devices) or n < 1:
        raise ValueError(f"a {n_search} x {n_eval} mesh needs {n} devices, "
                         f"got {len(devices)}")
    return Mesh(np.array(devices[:n], dtype=object).reshape(n_search,
                                                            n_eval),
                ("search", "eval"))


class ShardedEngine:
    """A FusedEngine replicated over mesh['search'] with eval sharding
    over mesh['eval']."""

    def __init__(self, engine: FusedEngine, mesh: Mesh):
        self.engine = engine
        self.mesh = mesh
        self.n_search = mesh.shape["search"]
        self.n_eval = mesh.shape["eval"]
        if engine.total_batch % self.n_eval:
            raise ValueError(
                f"total batch {engine.total_batch} not divisible by "
                f"eval-axis size {self.n_eval}")
        if mesh.spans_processes("eval"):
            raise ValueError("the eval axis must stay inside one process")
        # the search replicas this process holds (its rows of the grid)
        self.replicas = mesh.owned("search")
        mine = {canonical(mesh.devices[i, j]) for i in self.replicas
                for j in range(self.n_eval)}
        if mine != {canonical(engine.device)}:
            raise ValueError(
                f"a ShardedEngine runs on its engine's device "
                f"{engine.device}; this process's mesh positions are on "
                f"{sorted(str(d) for d in mine)}")

    # -- state management ---------------------------------------------------
    def replica_seeds(self, seed: int) -> torch.Tensor:
        """[n_search, 2]: every replica's key, derived from `seed` as
        `init` derives them (so that a FusedEngine run can start from
        replica i's)."""
        return rng.split(rng.key(seed, self.engine.device), self.n_search)

    def init(self, seed: int = 0) -> EngineState:
        """The states of the replicas this process holds, stacked on a
        leading axis (all n_search of them in one process)."""
        keys = self.replica_seeds(seed)
        return stack_trees([self.engine.init(keys[i])
                            for i in self.replicas])

    # -- collectives --------------------------------------------------------
    def _exchange(self, best: Best) -> Best:
        """Global-best broadcast across the search axis: `best` stacks
        this process's replicas' bests; every replica's is gathered,
        exchanged, and this process keeps its rows."""
        if self.n_search == 1:
            return best
        g = Best(all_gather(self.mesh, best.u),
                 tuple(all_gather(self.mesh, p) for p in best.perms),
                 all_gather(self.mesh, best.qor))
        ex = batched.exchange_best(g)
        if self.mesh.group is None:
            return ex
        rows = torch.as_tensor(self.replicas, device=best.qor.device)
        return Best(ex.u[rows], tuple(p[rows] for p in ex.perms),
                    ex.qor[rows])

    def _sharded_eval(self, cands) -> torch.Tensor:
        """Each eval shard evaluates its slice of the batch; the QoR is
        gathered back to the full batch (the eval axis is one
        process's)."""
        eng = self.engine
        if self.n_eval == 1:
            return eng.evaluate(cands)
        shard = eng.total_batch // self.n_eval
        return torch.cat([eng.evaluate(cands[j * shard:(j + 1) * shard])
                          for j in range(self.n_eval)])

    # -- the run ------------------------------------------------------------
    def _steps(self, states: List[EngineState], n_steps: int
               ) -> List[EngineState]:
        eng = self.engine
        for _ in range(n_steps):
            props = [eng.propose(s) for s in states]
            heads = [eng.commit_head(s, ts, c, self._sharded_eval(c))
                     for s, (ts, c, _) in zip(states, props)]
            best = self._exchange(stack_trees([h.best for h in heads]))
            heads = [h._replace(best=b) for h, b in
                     zip(heads, unstack_tree(best, len(heads)))]
            states = [eng.commit_tail(s, ts, c, h, k)
                      for s, (ts, c, k), h in zip(states, props, heads)]
        return states

    def run(self, state: EngineState, n_steps: int) -> EngineState:
        """n_steps sharded steps of every replica this process holds."""
        n = len(self.replicas)
        return stack_trees(self._steps(unstack_tree(state, n), n_steps))

    # -- host-side results --------------------------------------------------
    def best(self, state: EngineState) -> Tuple[dict, float]:
        """(config, qor) of the best replica this process holds (every
        replica holds the global best after an exchanging step)."""
        qors = state.best.qor.cpu().numpy()
        i = int(np.argmin(qors))
        b = unstack_tree(state.best, len(qors))[i]
        cfg = self.engine.space.to_configs(b.as_batch(1))[0]
        return cfg, float(self.engine.sign * qors[i])
