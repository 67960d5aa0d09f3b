"""Engine groups: many tenants, one batched state.

Counterpart of `uptune_tpu/serve/group.py`.  A ``SessionGroup`` owns one
``BatchedEngine`` whose instance axis is a pool of *slots*.  Each tenant
session occupies one slot; everything a session does maps onto three
slot primitives of the engine (engine/batched.py):

* join / slot reuse -> ``init_slot``    (slot i's row, in place)
* need proposals    -> ``propose_all``  (ONE vmapped propose for every
  slot — the cross-tenant batching this plane exists for)
* batch measured    -> ``commit_slot``  (slot i's row, in place: one
  launch of the merge kernel on the card)

Proposal epochs exploit that ``propose`` is pure in the state: an
epoch taken now is valid for every slot that has not committed since,
so one propose refreshes every needy tenant (``pending_for``
coalesces), and a mid-flight tenant keeps its older epoch — the stacked
tensors it will commit against stay alive by reference.

All group state is guarded by one reentrant lock per group.  The
propose runs under that lock; on the card its kernels are queued on the
stream, and the blocking device->host read happens later, in
``ProposalEpoch.host_rows``, outside the lock.  commit_slot and
init_slot write the stacked state in place under the same lock, so a
propose never reads a half-written state, and the stream orders a
queued propose's reads before a later commit's writes.  A commit
landing after the propose only makes the published epoch stale for
THAT slot — its generation moved — which triggers the next refresh.

The JAX package traces and compiles its three slot programs at group
construction (one throwaway propose / commit / init round, the
``serve.warm_compile`` span).  The port compiles nothing, and that
round leaves no observable trace in the group (slot 0 is re-seeded by
its first join and its generation is 0 either way), so the port's
groups skip it.
"""
from __future__ import annotations

import threading
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from .. import obs
from ..device import DeviceLike, resolve_device, to_host
from ..engine import BatchedEngine, FusedEngine
from ..space.spec import CandBatch, Space


def group_key(space: Space, arms: Optional[Sequence[str]],
              sense: str, history_capacity: int) -> Tuple:
    """Tenant-grouping identity: sessions are multiplexed onto one
    batched state only when EVERYTHING that shapes its tensors and
    semantics matches — structural space signature, arm portfolio,
    orientation, and dedup-history capacity."""
    return (tuple(space.signature()),
            tuple(arms) if arms else "default",
            sense, int(history_capacity))


class ProposalEpoch:
    """One propose_all output: stacked technique states, stacked
    candidates, stacked keys, plus the per-slot state generation at
    take time (validity check) and a lazily materialized host copy of
    the candidate rows (ONE device->host transfer per epoch; per-slot
    reads are numpy views)."""

    __slots__ = ("tstates", "cands", "keys", "slot_gens", "_host")

    def __init__(self, tstates, cands: CandBatch, keys,
                 slot_gens: Tuple[int, ...]):
        self.tstates = tstates
        self.cands = cands
        self.keys = keys
        self.slot_gens = slot_gens
        self._host = None

    def host_rows(self, slot: int) -> CandBatch:
        """Slot `slot`'s candidate batch on the host (CPU tensors over
        numpy, for config decode); the stacked pull happens once per
        epoch, in one transfer.  Called WITHOUT the group lock (session
        decode runs unlocked), so the lazy materialization is one
        atomic tuple rebind — a racing duplicate pull is benign
        (identical values, last ref wins)."""
        h = self._host
        if h is None:
            u, *perms = (torch.from_numpy(a) for a in
                         to_host(self.cands.u, *self.cands.perms))
            h = (u, tuple(perms))
            self._host = h
        u, perms = h
        return CandBatch(u[slot], tuple(p[slot] for p in perms))


class SessionGroup:
    """One space signature's slice of the serving plane: a slot pool
    over a BatchedEngine plus the shared proposal-epoch cache, on one
    device (default the card)."""

    def __init__(self, space: Space, slots: int, *,
                 arms: Optional[Sequence[str]] = None,
                 sense: str = "min", history_capacity: int = 1 << 10,
                 device: DeviceLike = "cuda"):
        self.space = space
        self.sense = sense
        self.device = resolve_device(device)
        self.key = group_key(space, arms, sense, history_capacity)
        # objective=None: evaluation is the TENANT's side of the
        # protocol — only the propose/commit halves ever run here, and
        # commit takes the measured raw batch directly
        self.engine = FusedEngine(space, None, arms=list(arms) if arms
                                  else None, sense=sense,
                                  history_capacity=history_capacity,
                                  device=self.device)
        self.batched = BatchedEngine(self.engine, slots)
        self.n_slots = int(slots)
        self.batch = self.engine.total_batch   # rows per epoch
        self.lock = threading.RLock()
        # slot 0..n-1 placeholder streams; every join re-seeds its slot
        # from the tenant's own seed, so this seed is inert — and a
        # constant one keeps group construction deterministic
        self.state = self.batched.init(0)
        self.slot_gen = [0] * self.n_slots
        self.free: List[int] = list(range(self.n_slots - 1, -1, -1))
        self.active: Dict[int, Any] = {}   # slot -> Session
        self.epoch: Optional[ProposalEpoch] = None

    # -- membership ----------------------------------------------------
    @property
    def n_active(self) -> int:
        return len(self.active)

    @property
    def n_free(self) -> int:
        return len(self.free)

    def join(self, seed: int, store=None, session_id: Optional[str] = None):
        """Allocate a slot and seed it from the tenant's own seed
        (slot-position independent: the same seed produces the same
        session in ANY group — the matched-seed parity contract with
        LocalSession).  Raises IndexError when full."""
        from .session import Session
        with self.lock:
            slot = self.free.pop()
            self.state = self.batched.init_slot(self.state, slot,
                                                int(seed))
            self.slot_gen[slot] += 1
            sess = Session(self, slot, int(seed), store=store,
                           session_id=session_id)
            self.active[slot] = sess
            obs.count("serve.joins")
            return sess

    def leave(self, sess) -> None:
        """Free the slot.  The departed tenant's state rows stay in the
        stacked tensors until a future join overwrites them (init_slot);
        proposals for free slots are dead rows nobody reads."""
        with self.lock:
            if self.active.get(sess.slot) is sess:
                del self.active[sess.slot]
                self.free.append(sess.slot)
                obs.count("serve.leaves")

    # -- the three device paths ----------------------------------------
    def pending_for(self, sess) -> ProposalEpoch:
        """An epoch valid for `sess`'s slot.  When the cached epoch
        predates the slot's last commit, ONE vmapped propose refreshes
        it — and with it every other needy tenant (coalescing: the
        batch-fill gauge records how many sessions each propose
        actually served).  The whole check-refresh-publish is one lock
        hold; the first caller after a commit proposes, everyone else
        reads the published epoch."""
        with self.lock:
            ep = self.epoch
            if ep is not None and \
                    ep.slot_gens[sess.slot] == self.slot_gen[sess.slot]:
                return ep
            needy = sum(1 for s in self.active.values()
                        if s.pending is None)
            with obs.span("serve.propose", slots=self.n_slots):
                t, c, k = self.batched.propose_all(self.state)
            ep = ProposalEpoch(t, c, k, tuple(self.slot_gen))
            self.epoch = ep
            obs.count("serve.proposes")
            obs.gauge("serve.batch_fill",
                      needy / max(1, self.n_slots))
            return ep

    def commit(self, sess, epoch: ProposalEpoch,
               raw: np.ndarray) -> None:
        """Publish `sess`'s measured epoch: one commit updating only its
        slot's row of the stacked state."""
        with obs.span("serve.commit", slot=sess.slot):
            raw_t = torch.as_tensor(np.asarray(raw, np.float32),
                                    device=self.device)
            self.state = self.batched.commit_slot(
                self.state, epoch.tstates, epoch.cands, epoch.keys,
                raw_t, sess.slot)
        self.slot_gen[sess.slot] += 1
        obs.count("serve.commits")
