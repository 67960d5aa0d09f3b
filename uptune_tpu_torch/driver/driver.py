"""The tuning driver: the ask/tell loop over the technique arms.

Counterpart of `uptune_tpu/driver/driver.py`.  Each acquisition the
meta-technique (the AUC bandit by default) orders its arms on the host,
the first arm whose batch holds a hash-novel row proposes a whole batch,
the batch is hashed and deduplicated against the device history and
within itself, and only the novel rows go out for evaluation as trials.
When every trial of a ticket is told (or cancelled) the ticket commits:
the novel rows merge into the history (on the card through the merge
kernel, `ops/dedup.py`, `csrc/merge.cu`), the best folds in, the rows are
appended to the jsonl archive, and the arm observes its batch and earns
its bandit credit.

How the port differs from the JAX driver:

* It runs eagerly.  There is no jit, no buffer donation and no weak type,
  so `_leaf_keys`, `_strong`, `_arm_forwards` and the non-donating
  observe have no counterpart.  The invariant that replaces them: no
  technique's `propose` or `observe` writes into a tensor it was given,
  so two tickets of one arm may share state tensors while in flight.
* The bucket padding stays: every arm's batch is padded to the largest
  natural batch, and `inject` and `_ingest_batch` pad to multiples of it.
  The padding rows are in-batch duplicates of row 0, and they decide the
  dedup sources, the trials' order and the archive rows as in the JAX
  driver.
* Randomness comes from the tuner's counter-based key (`rng`), split
  where the JAX driver splits its PRNG key: once per member init, per arm
  pull, per saturation injection, per surrogate pull and per restart.
  The draws go through one method per phase (`_draw_init`,
  `_draw_propose`, `_draw_observe`, `_draw_random`), so a test can feed
  the numbers JAX drew.  The JAX NelderMead, annealing and simplex
  restarts read keys held in their states; the port's read observe
  draws, so `_finalize` splits the key once more for each observe.
* Host reads are the JAX driver's, at the same points, and where the JAX
  driver reads several arrays at one point one transfer carries them
  (`_to_host`): an arm pull's hashes, novelty, known QoR and dedup
  sources; an opened ticket's batch; after a commit the drop count and
  the best QoR, which the tuner keeps on the host (`_best_q`) for the
  next ticket's `prev` and for `result()`.  Host values go to the card
  through pinned memory without a synchronisation (`_to_device`).

A surrogate given by name (``surrogate="gp"`` or ``"mlp"``) builds the
port's `SurrogateManager` (`surrogate/manager.py`) on the tuner's device
with `surrogate_opts`; a surrogate object is driven through the same
calls.  Left out, with the work that brings it back: the `obs` spans,
counters and tuning journal (`StepStats.n_compiles` / `t_compile` stay
0, as in an untraced JAX run).
"""
from __future__ import annotations

import copy
import inspect
import json
import logging
import math
import os
import time
import warnings
from typing import Any, Callable, Dict, List, NamedTuple, Optional, Sequence

import numpy as np
import torch

from .. import rng
from ..device import DeviceLike, resolve_device
from ..device import to_device as _to_device
from ..device import to_host as _to_host
from ..space.spec import CandBatch, Space, pad_cands
from ..techniques import base as tbase
from ..techniques.bandit import MetaTechnique
from ..techniques.base import Best, Technique
from .history import History, dup_source
from .plugins import fire as _fire

Objective = Callable[[List[Dict[str, Any]]], Sequence[float]]

log = logging.getLogger("uptune_tpu_torch")


class StepStats(NamedTuple):
    step: int
    technique: str
    batch: int
    evaluated: int
    best_qor: float
    was_new_best: bool
    pruned: int = 0
    # cumulative live history rows evicted past capacity (oldest-first):
    # nonzero means dedup no longer sees the oldest part of the run
    hist_dropped: int = 0
    # driver timing for this ticket (seconds): propose + dedup dispatch,
    # host-side pending mask / config materialization, and wall-clock
    # from ticket open to finalize
    t_propose: float = 0.0
    t_dedup: float = 0.0
    t_eval_wait: float = 0.0
    # surrogate observability: seconds the tell path blocked on
    # surrogate learning, the snapshot version scoring reads, and its
    # staleness in training rows
    t_refit: float = 0.0
    snapshot_version: int = 0
    refit_lag_rows: int = 0
    # compile activity in the ticket's window: the port compiles nothing
    # at run time (its kernels build once, before the first launch), so
    # both stay 0, as in an untraced run of the JAX driver
    n_compiles: int = 0
    t_compile: float = 0.0


class Trial:
    """One proposed configuration awaiting an external result (the
    ask/tell unit)."""

    __slots__ = ("gid", "config", "ticket", "slot", "row", "qor", "dur",
                 "cancelled")

    def __init__(self, gid: int, config: Dict[str, Any], ticket: "_Ticket",
                 slot: int, row: int):
        self.gid = gid
        self.config = config
        self.ticket = ticket
        self.slot = slot          # index within the ticket's trial list
        self.row = row            # row within the proposed device batch
        self.qor: Optional[float] = None   # ENGINE orientation once told
        self.dur = 0.0
        self.cancelled = False

    def __repr__(self):
        return (f"Trial(gid={self.gid}, tech={self.ticket.arm_name!r}, "
                f"qor={self.qor})")


class _Ticket:
    """One arm's proposed batch plus its dedup verdicts (host copies);
    completes when every novel trial has been told or cancelled."""

    __slots__ = ("arm", "arm_name", "tstate", "cands", "hashes", "known",
                 "src", "novel_np", "injected", "pruned", "trials",
                 "remaining", "u_np", "perms_np", "gen", "credit_virtual",
                 "packed", "t_propose", "t_dedup", "t_open")

    def __init__(self, arm, arm_name, tstate, cands, hashes, known, src,
                 novel_np, injected, pruned, gen=0, credit_virtual=False):
        self.arm = arm
        self.arm_name = arm_name
        self.tstate = tstate
        self.cands = cands
        self.hashes = hashes
        self.known = known
        self.src = src
        self.novel_np = novel_np
        self.injected = injected
        self.pruned = pruned
        # injected ticket that still earns bandit credit: the surrogate
        # virtual arm (arbitration='bandit')
        self.credit_virtual = credit_virtual
        self.trials: List[Trial] = []
        self.remaining = 0
        self.u_np = None
        self.perms_np = None
        self.packed = None        # [B] uint64 packed hashes (host)
        self.t_propose = 0.0      # s in the propose + dedup dispatch
        self.t_dedup = 0.0        # s in host-side mask + materialization
        self.t_open = 0.0         # perf_counter() when the ticket opened
        # member-state generation at open time: a restart bumps it, and a
        # ticket opened before the restart must not observe over the
        # re-initialized state
        self.gen = gen


class TuneResult(NamedTuple):
    best_config: Dict[str, Any]
    best_qor: float          # in USER orientation (negated back for 'max')
    evals: int
    steps: int
    trace: List[float]       # best-so-far (user orientation) after each eval
    t_propose: float = 0.0
    t_dedup: float = 0.0
    t_eval_wait: float = 0.0
    t_refit: float = 0.0
    t_compile: float = 0.0


class Tuner:
    """Single-instance batched tuner over an in-process objective.

    Parameters
    ----------
    space : Space
    objective : callable(list[config dict]) -> sequence of float
        QoR per config; non-finite values count as failures (+inf).
    technique : str | list[str] | Technique | None
        As the --technique flag; default is the AUCBanditMetaTechniqueA
        portfolio.
    sense : 'min' | 'max'
        User objective orientation; the engine always minimizes.
    archive : optional path of the jsonl trial archive (resume source),
        in the JAX driver's format: either package resumes the other's.
    device : where the history, the best and the arms' states live
        (default ``"cuda"``; raises without a card unless ``"cpu"``).
    """

    def __init__(self, space: Space, objective: Optional[Objective] = None,
                 *, technique=None, seed: int = 0, sense: str = "min",
                 capacity: int = 1 << 16,
                 archive: Optional[str] = None,
                 resume: bool = False,
                 surrogate=None, surrogate_opts: Optional[dict] = None,
                 config_filter: Optional[
                     Callable[[Dict[str, Any]], bool]] = None,
                 hooks: Optional[Sequence] = None,
                 label: str = "",
                 input_manager=None,
                 device: DeviceLike = "cuda"):
        assert sense in ("min", "max"), sense
        self.device = resolve_device(device)
        # identifies this tuner in shared-hook output
        self.label = label
        self.space = space
        self.objective = objective
        # input-selection policy (driver/inputs.py): when set, step()
        # calls the objective as objective(cfgs, inputs)
        self.input_manager = input_manager
        # search-space restriction predicate (ut.rule); rejected configs
        # are never evaluated/archived and serve +inf to their technique
        self.config_filter = config_filter
        self.filtered_total = 0
        self.sense = sense
        self.sign = 1.0 if sense == "min" else -1.0
        self.key = rng.key(seed, self.device)
        # elements each draw phase took last time (a stream's block size)
        self._hints: Dict[tuple, int] = {}
        self.history = History(capacity, device=self.device)
        self.hist_state = self.history.init()
        self.best = Best.empty(space, self.device)
        # the best's QoR on the host, read after every commit
        self._best_q = float("inf")
        self.archive_path = archive
        self.evals = 0
        # trials individually resolved via tell(); never lags like
        # `evals`, which advances when a whole ticket finalizes
        self.told = 0
        self.steps = 0
        self.gid = 0
        self.trace: List[float] = []
        self._zero_novel_streak = 0
        self._cap_warned = False
        self._last_dropped = 0
        self.pruned_total = 0
        self._surr_tick = 0   # acquisition counter for propose_every
        # arms whose last proposal was entirely duplicates, keyed by the
        # acquisition counter: skipped for a few acquisitions
        self._arm_dry: Dict[str, int] = {}
        self._dry_backoff = 5
        self._acq_count = 0
        # hashes proposed but not yet resolved: asked trials must not be
        # re-proposed
        self._pending: set = set()
        # per-technique attribution counters (pulls, evals, new-bests)
        self.arm_stats: Dict[str, List[int]] = {}
        self.hooks = list(hooks or [])

        # surrogate pruning and the proposal plane: a name builds the
        # manager on the tuner's device
        if isinstance(surrogate, str):
            from ..surrogate.manager import SurrogateManager
            surrogate = SurrogateManager(
                space, surrogate, seed=seed, device=self.device,
                **(surrogate_opts or {}))
        self.surrogate = surrogate

        root = technique
        if root is None or isinstance(root, str) or (
                isinstance(root, (list, tuple))):
            names = ([root] if isinstance(root, str) else root)
            root = tbase.get_root(names)  # returns a private copy
        else:
            # a directly-passed Technique may be shared by the caller;
            # meta-techniques carry mutable host-side credit state
            root = copy.deepcopy(root)
        self.root: Technique = root
        # a MetaTechnique.credit written against the old 2-arg signature
        # keeps working; detected once by inspection
        self._credit_kw = True
        if isinstance(root, MetaTechnique):
            try:
                ps = inspect.signature(root.credit).parameters.values()
            except (TypeError, ValueError):  # builtins/C: assume modern
                ps = ()
            if ps and not any(
                    p.name == "step_best"
                    or p.kind == inspect.Parameter.VAR_KEYWORD
                    for p in ps):
                self._credit_kw = False
                warnings.warn(
                    f"{type(root).__name__}.credit uses the legacy "
                    "(name, was_new_best) signature; add step_best= "
                    "and global_best= keywords — quality-aware metas "
                    "(RecyclingMeta) need them. Falling back to the "
                    "2-arg call.", FutureWarning)
        members = (root.techniques if isinstance(root, MetaTechnique)
                   else [root])
        self.members: List[Technique] = [
            t for t in members if t.supports(space)]
        if not self.members:
            raise ValueError(
                f"no technique in {root.name!r} supports this space")
        self._tstates: Dict[str, Any] = {}
        self._member_by_name: Dict[str, Technique] = {
            t.name: t for t in self.members}
        # rows of each arm's own proposal within its padded ticket batch
        self._nb: Dict[str, int] = {
            t.name: t.natural_batch(space) for t in self.members}
        # bumped on each RecyclingMeta restart; see _Ticket.gen
        self._tgen: Dict[str, int] = {t.name: 0 for t in self.members}
        # every arm's proposal is padded to this bucket, and inject() and
        # _ingest_batch pad to multiples of it
        self._bucket = max(self._nb.values())
        for t in self.members:
            self._tstates[t.name] = t.init_state(
                space, self._draw_init(t, self._next_key()))

        # surrogate arbitration='bandit': the proposal plane becomes a
        # credit-earning virtual arm of the AUC bandit
        self._surr_arm = False
        sm = self.surrogate
        if sm is not None and getattr(sm, "arbitration", "") == "bandit":
            if not self._wire_surrogate_arm():
                warnings.warn(
                    "surrogate arbitration='bandit' needs an AUC-bandit "
                    "root technique and propose_batch > 0; falling back "
                    "to the scheduled proposal plane", UserWarning)

        self.t_propose_total = 0.0
        self.t_dedup_total = 0.0
        self.t_eval_wait_total = 0.0
        self.t_refit_total = 0.0
        self.t_compile_total = 0.0

        if resume and archive and os.path.exists(archive):
            self._resume(archive)
        elif archive and os.path.exists(archive) and os.path.getsize(archive):
            # not resuming, but never append to a different space's file
            self._check_archive_header(archive)
        _fire(self.hooks, "on_start", self)
        self._archive_f = open(archive, "a") if archive else None
        if self._archive_f is not None and self._archive_f.tell() == 0:
            # header: full space signature, checked on every reopen
            self._archive_f.write(
                json.dumps({"space_sig": self._space_sig()}) + "\n")
            self._archive_f.flush()

    # ------------------------------------------------------------------
    # randomness: the tuner's key, split where the JAX driver splits its
    # own, and one draw method per phase
    def _next_key(self) -> torch.Tensor:
        """Split the tuner's key: keep one half, return the other."""
        self.key, k = rng.split(self.key, 2).unbind(0)
        return k

    def _draw_init(self, t: Technique, key: torch.Tensor):
        return rng.hinted(key, self._hints, ("init", t.name),
                          lambda g: t.draw_init(self.space, g))

    def _draw_propose(self, t: Technique, key: torch.Tensor):
        return rng.hinted(key, self._hints, ("propose", t.name),
                          lambda g: t.draw_propose(self.space, g))

    def _draw_observe(self, t: Technique, key: torch.Tensor):
        return rng.hinted(key, self._hints, ("observe", t.name),
                          lambda g: t.draw_observe(self.space, g))

    def _draw_random(self, n: int, key: torch.Tensor) -> CandBatch:
        """The saturation injection's uniform random batch."""
        return rng.hinted(key, self._hints, ("random", n),
                          lambda g: self.space.random(g, n))

    # ------------------------------------------------------------------
    def _space_sig(self) -> List[str]:
        """Ordered structural signature of the space (Space.signature):
        any change invalidates position-indexed unit-vector replay."""
        return self.space.signature()

    def _rotate_mismatch(self, path: str) -> None:
        bak = path + ".mismatch"
        os.replace(path, bak)
        warnings.warn(
            f"archive {path} was recorded for a different space; "
            f"moved aside to {bak}")

    def _check_archive_header(self, path: str) -> None:
        """Rotate the archive aside unless its signature (or, for legacy
        headerless files, its first row's param-name set) matches."""
        try:
            with open(path) as f:
                first = json.loads(f.readline())
        except (json.JSONDecodeError, OSError):
            return
        if "space_sig" in first:
            if first["space_sig"] != self._space_sig():
                self._rotate_mismatch(path)
        elif "cfg" in first and set(first["cfg"]) != {
                s.name for s in self.space.specs}:
            self._rotate_mismatch(path)

    def _resume(self, path: str) -> None:
        """Replay the jsonl archive: exact unit vectors -> history + best
        (replayed as technique 'seed', without touching technique
        states)."""
        rows = []
        sig = None
        compacted = 0
        good_end = 0
        size = os.path.getsize(path)
        with open(path, "rb") as f:
            for line in f:
                text = line.strip()
                if not text:
                    good_end = f.tell()
                    continue
                try:
                    rec = json.loads(text)
                except json.JSONDecodeError:
                    break  # torn tail write; ignore the rest
                if not line.endswith(b"\n") and f.tell() == size:
                    break  # complete JSON but unterminated final line
                if "space_sig" in rec:
                    sig = rec["space_sig"]
                    # rows a compaction dropped still count as evals
                    compacted = int(rec.get("compacted_rows", 0))
                else:
                    rows.append(rec)
                good_end = f.tell()
        if good_end < size:
            # drop the torn fragment so the next append starts clean
            with open(path, "r+b") as f:
                f.truncate(good_end)
        # the archive must match the current space structurally (raw unit
        # vectors are position-indexed); a mismatch is rotated aside
        mismatch = (sig is not None and sig != self._space_sig()) or (
            sig is None and rows
            and set(rows[0]["cfg"]) != {s.name for s in self.space.specs})
        if mismatch:
            self._rotate_mismatch(path)
            return
        if not rows:
            return
        u = np.asarray([r["u"] for r in rows], np.float32)
        perms = [
            np.asarray([r["perms"][k] for r in rows], np.int32)
            for k in range(len(self.space.perm_sizes))]
        # archive rows are user-oriented; engine-internal = sign * user
        qor = self.sign * np.asarray([r["qor"] for r in rows], np.float32)
        self._ingest_batch(u, perms, qor)
        if self.surrogate is not None:
            # replayed trials are training data too
            r0 = time.perf_counter()
            fitted = self.surrogate.maybe_refit()
            dt = time.perf_counter() - r0
            if getattr(self.surrogate, "_refit_future", None) \
                    is not None:
                log.info("[ut] resume: surrogate refit over %d replayed "
                         "rows scheduled on the background worker "
                         "(t_refit=%.3fs on the startup path)",
                         len(rows), dt)
            elif dt > 0.1 or fitted:
                log.info("[ut] resume: surrogate refit over %d replayed "
                         "rows took t_refit=%.3fs (enable the async "
                         "surrogate plane to move this off the startup "
                         "path)", len(rows), dt)
        self.gid = max(int(r["gid"]) for r in rows) + 1
        self.evals = len(rows) + compacted
        self.told = len(rows) + compacted
        running = float("inf")
        for q in qor:
            running = min(running, float(q))
            self.trace.append(self.sign * running)

    def _ingest_batch(self, u_np: np.ndarray, perms_np: List[np.ndarray],
                      qor_np: np.ndarray) -> None:
        """Commit externally-measured rows (exact unit vectors,
        ENGINE-oriented QoR) into history + best (+ surrogate training
        set) in bucket-sized chunks padded by repeating row 0, as the
        live tune's tickets are.  Counters/trace/archive are untouched —
        callers own those."""
        total = len(qor_np)
        bucket = self._bucket
        dev = self.device
        for s in range(0, total, bucket):
            n = min(bucket, total - s)
            cu = u_np[s:s + n]
            cp = [p[s:s + n] for p in perms_np]
            cq = qor_np[s:s + n]
            if n < bucket:
                pad = bucket - n
                cu = np.concatenate([cu, np.repeat(cu[:1], pad, axis=0)])
                cp = [np.concatenate([p, np.repeat(p[:1], pad, axis=0)])
                      for p in cp]
                cq = np.concatenate([cq, np.repeat(cq[:1], pad)])
            cands = CandBatch(_to_device(cu, torch.float32, dev),
                              tuple(_to_device(p, torch.int64, dev)
                                    for p in cp))
            hashes, found, _, _, novel = self._dedup(cands)
            self._commit(hashes, cands,
                         _to_device(cq, torch.float32, dev), novel)
            if self.surrogate is not None:
                # padding rows duplicate row 0 (sliced off via [:n]), and
                # rows already in the history trained when they entered
                # it: only history-novel rows train
                fresh = ~_to_host(found)[0][:n]
                if fresh.any():
                    feats = self._features(cu[:n], [p[:n] for p in cp])
                    self.surrogate.observe(feats[fresh], cq[:n][fresh])
        self._read_commit()

    def preload(self, u, perms, qor, refit: bool = True) -> int:
        """Warm-start ingestion of externally-recorded trials: rows enter
        the dedup history — never re-proposed, and dup-served their
        recorded QoR if a technique finds them again — fold into the
        best-so-far, and train the surrogate.  They touch NO run
        counters (evals/told/steps), archive rows, or trace entries.

        `u` is [B, n_scalar] unit vectors, `perms` a list of [B, size]
        index arrays (one per perm spec), `qor` USER-oriented values;
        non-finite rows are dropped.  Returns the rows ingested."""
        u = np.atleast_2d(np.asarray(u, np.float32))
        qor_e = self.sign * np.asarray(qor, np.float32).reshape(-1)
        perms_np = [np.asarray(p, np.int32) for p in (perms or [])]
        if len(perms_np) != len(self.space.perm_sizes):
            raise ValueError(
                f"preload needs {len(self.space.perm_sizes)} perm "
                f"arrays, got {len(perms_np)}")
        keep = np.isfinite(qor_e)
        if not keep.all():
            u = u[keep]
            perms_np = [p[keep] for p in perms_np]
            qor_e = qor_e[keep]
        if not len(qor_e):
            return 0
        self._ingest_batch(u, perms_np, qor_e)
        sm = self.surrogate
        if refit and sm is not None:
            if hasattr(sm, "force_refit"):
                sm.force_refit()   # warm guidance live from trial 1
            else:
                sm.maybe_refit()
        return int(len(qor_e))

    def preload_rows(self, rows, refit: bool = True) -> int:
        """`preload` over result-store row dicts (``cfg``/``qor`` plus
        optional exact ``u``/``perms``).  Rows carrying exact unit
        vectors matching this space replay bit-exactly; the rest are
        re-encoded from their configs."""
        rows = [r for r in rows if isinstance(r, dict) and "cfg" in r]
        if not rows:
            return 0
        space = self.space
        sizes = space.perm_sizes

        def exact(r):
            u, pp = r.get("u"), r.get("perms")
            return (u is not None and len(u) == space.n_scalar
                    and len(pp or []) == len(sizes)
                    and all(len(p) == s for p, s in zip(pp or [], sizes)))

        ex = [r for r in rows if exact(r)]
        ap = [r for r in rows if not exact(r)]
        n = 0
        if ex:
            u = np.asarray([r["u"] for r in ex], np.float32)
            perms = [np.asarray([r["perms"][k] for r in ex], np.int32)
                     for k in range(len(sizes))]
            # defer any refit to the LAST preload call of this batch
            n += self.preload(u, perms, [r["qor"] for r in ex],
                              refit=refit and not ap)
        if ap:
            cb = space.from_configs([r["cfg"] for r in ap], device="cpu")
            n += self.preload(cb.u.numpy(), [p.numpy() for p in cb.perms],
                              [r["qor"] for r in ap], refit=refit)
        return n

    def _log_trial(self, gid, tech, cfg, u_row, perm_rows, qor, is_best,
                   dur) -> None:
        """Append one archive row; `tech` records the proposing
        technique."""
        if self._archive_f is None:
            return
        rec = {"gid": gid, "tech": tech, "time": round(dur, 6), "cfg": cfg,
               "u": [float(x) for x in u_row],
               "perms": [[int(i) for i in p] for p in perm_rows],
               "qor": float(qor), "best": bool(is_best)}
        self._archive_f.write(json.dumps(rec) + "\n")

    def _flush_archive(self):
        if self._archive_f is not None:
            self._archive_f.flush()

    # ------------------------------------------------------------------
    def _features(self, u_np: np.ndarray,
                  perms_np: List[np.ndarray]) -> np.ndarray:
        """Surrogate features of host rows, computed on the host."""
        cb = CandBatch(torch.from_numpy(np.asarray(u_np, np.float32)),
                       tuple(torch.from_numpy(np.asarray(p, np.int64))
                             for p in perms_np))
        return self.space.features(cb).numpy()

    def _dedup(self, cands: CandBatch):
        """(hashes, found, known, src, novel) on the device: hash, look
        up in the history, find in-batch duplicates."""
        hashes = self.space.hash_batch(cands)
        found, known = self.history.contains(self.hist_state, hashes)
        src = dup_source(hashes)
        novel = (src == torch.arange(hashes.shape[0],
                                     device=hashes.device)) & ~found
        return hashes, found, known, src, novel

    def _propose_dedup(self, t: Technique, st, draws):
        """One arm pull: propose the arm's natural batch, pad to the
        bucket, hash + dedup vs history + in-batch."""
        st2, c = t.propose(self.space, st, self.best, draws)
        cp = pad_cands(c, self._bucket)
        hashes, _, known, src, novel = self._dedup(cp)
        return st2, cp, hashes, known, src, novel

    def _commit(self, hashes, cands: CandBatch, qor, newly) -> None:
        """Merge the novel rows into the history and fold the batch into
        the best (device work only; `_read_commit` reads the result)."""
        self.hist_state = self.history.insert(self.hist_state, hashes, qor,
                                              newly)
        self.best = self.best.update(cands, qor)

    def _read_commit(self) -> None:
        """The history's drop count and the best QoR, to the host in one
        transfer."""
        dropped, q = _to_host(self.hist_state.dropped, self.best.qor)
        self._last_dropped = int(dropped)
        self._best_q = float(q)

    @staticmethod
    def _pack_hashes(hashes_np: np.ndarray) -> np.ndarray:
        """[B, 2] u32 hash pairs (held in int64) -> [B] uint64
        (h0 << 32) | h1, the JAX driver's packing."""
        hs = np.asarray(hashes_np).astype(np.uint64)
        return (hs[:, 0] << np.uint64(32)) | hs[:, 1]

    def _mask_pending(self, hashes_np, novel_np):
        """Drop candidates whose hash is already out for evaluation.
        Returns (novel mask, novel count, packed hashes)."""
        packed = self._pack_hashes(hashes_np)
        if self._pending:
            pend = np.fromiter(self._pending, np.uint64,
                               len(self._pending))
            novel_np = novel_np & ~np.isin(packed, pend)
        return novel_np, int(novel_np.sum()), packed

    def _verdicts(self, hashes, known, src, novel):
        """The dedup verdicts on the host, in one transfer: (known, src,
        novel mask after the pending mask, novel count, packed)."""
        h, k, s, nv = _to_host(hashes, known, src, novel)
        novel_np, n_novel, packed = self._mask_pending(h, nv)
        return k, s, novel_np, n_novel, packed

    def _surrogate_ticket(self, credit: bool) -> Optional[_Ticket]:
        """Try to pull the surrogate proposal plane once: a batch from
        the manager's pool (`propose_pool`), deduped and opened as an
        injected ticket attributed 'surrogate'.  A saturated pool, or one
        whose every novel row the config filter rejects, opens no ticket
        and marks the arm dry."""
        sm = self.surrogate
        if not self._surrogate_ready():
            return None
        cands = sm.propose_pool(self._next_key(), self.best.u,
                                self.best.perms, self._best_q)
        if cands is None:
            return None
        pre = self._dedup_masked(cands)
        if not pre[3].any():
            self._arm_dry["surrogate"] = self._acq_count
            return None
        self._arm_dry.pop("surrogate", None)
        tk = self._open_injected_ticket(cands, "surrogate", _pre=pre,
                                        credit_virtual=credit)
        if not tk.trials:
            self._arm_dry["surrogate"] = self._acq_count
            return None
        return tk

    def _surrogate_ready(self) -> bool:
        """Can the proposal plane emit a pool right now? (enabled,
        fitted, and there is a finite incumbent to perturb around)"""
        sm = self.surrogate
        return (sm is not None and bool(getattr(sm, "propose_batch", 0))
                and sm.fitted
                and math.isfinite(self._best_q))

    def _acquire_surrogate(self) -> Optional[_Ticket]:
        """Scheduled surrogate proposal plane: every `propose_every`-th
        acquisition (once fitted) the manager emits its own batch.  Under
        arbitration='bandit' this path is off — the AUC bandit pulls the
        plane as a virtual arm in _acquire instead."""
        if not self._surrogate_ready():
            return None
        self._surr_tick += 1
        if self._surr_tick % max(1, self.surrogate.propose_every):
            return None
        return self._surrogate_ticket(credit=False)

    def _dedup_masked(self, cands: CandBatch):
        """(hashes, known, src, novel_np, packed): dedup vs history +
        in-batch, then mask hashes already out for evaluation."""
        hashes, _, known, src, novel = self._dedup(cands)
        k, s, novel_np, _, packed = self._verdicts(hashes, known, src, novel)
        return hashes, k, s, novel_np, packed

    def _open_injected_ticket(self, cands: CandBatch, source: str,
                              _pre=None, credit_virtual=False) -> _Ticket:
        """Dedup -> pending-mask -> injected ticket -> open: the shared
        plumbing behind inject() and the surrogate proposal plane."""
        hashes, known, src, novel_np, packed = (
            _pre if _pre is not None else self._dedup_masked(cands))
        tk = _Ticket(None, source, None, cands, hashes, known, src,
                     novel_np, injected=True, pruned=0,
                     credit_virtual=credit_virtual)
        tk.packed = packed
        self._open_ticket(tk)
        return tk

    def _acquire(self) -> _Ticket:
        """Choose arm -> propose batch -> dedup (history + in-batch +
        pending) -> surrogate prune; returns the open ticket."""
        self._acq_count += 1
        if not self._surr_arm:
            tk = self._acquire_surrogate()
            if tk is not None:
                return tk
            order = (self.root.select_order()
                     if isinstance(self.root, MetaTechnique)
                     else [self.root])
            order = [t for t in order if t.name in self._tstates]
        else:
            # bandit arbitration: the AUC queue orders techniques AND
            # the 'surrogate' virtual arm together
            order = []
            for n in self.root.ordered_names():
                if n in self.root.virtual_arms:
                    order.append(n)
                elif n in self._tstates:
                    order.append(self._member_by_name[n])
        if self._arm_dry:
            dry = {n for n, s in self._arm_dry.items()
                   if self._acq_count - s < self._dry_backoff}
            if dry:
                # arms inside the backoff window are skipped; when every
                # arm is dry, one proposes
                active = [t for t in order
                          if (t if isinstance(t, str) else t.name)
                          not in dry]
                order = active if active else order[:1]
        if all(isinstance(t, str) for t in order):
            # a failed virtual pull must leave a technique to fall back on
            order.append(self.members[0])

        chosen = None
        t_prop = 0.0
        t_host0 = time.perf_counter()
        for t in order:
            if isinstance(t, str):  # virtual arm: the surrogate plane
                stk = self._surrogate_ticket(credit=True)
                if stk is not None:
                    return stk
                continue
            draws = self._draw_propose(t, self._next_key())
            p0 = time.perf_counter()
            tstate, cands, hashes, known, src, novel = self._propose_dedup(
                t, self._tstates[t.name], draws)
            t_prop += time.perf_counter() - p0
            known_np, src_np, novel_np, n_novel, packed = self._verdicts(
                hashes, known, src, novel)
            if n_novel > 0:
                self._arm_dry.pop(t.name, None)
            else:
                self._arm_dry[t.name] = self._acq_count
            if n_novel > 0 or chosen is None:
                chosen = (t, tstate, cands, hashes, known_np, src_np,
                          novel_np, n_novel, packed)
            if n_novel > 0:
                break
        (t, tstate, cands, hashes, known_np, src_np, novel_np, n_novel,
         packed) = chosen

        injected = False
        if n_novel == 0:
            self._zero_novel_streak += 1
            if self._zero_novel_streak >= 3:
                # saturation fallback: random injection.  The injected
                # batch is NOT the arm's proposal: it flows into no
                # observe() and no bandit credit
                injected = True
                k = self._next_key()
                p0 = time.perf_counter()
                cands = self._draw_random(cands.batch, k)
                hashes, _, known, src, novel = self._dedup(cands)
                t_prop += time.perf_counter() - p0
                known_np, src_np, novel_np, n_novel, packed = \
                    self._verdicts(hashes, known, src, novel)
        else:
            self._zero_novel_streak = 0

        pruned = 0
        if n_novel and self.surrogate is not None and not injected:
            keep = self.surrogate.keep_mask(cands, novel_np)
            if keep is not None:
                pruned = int((novel_np & ~keep).sum())
                if pruned:
                    # rejected without evaluation: NOT archived, NOT
                    # inserted into history (may be re-proposed later)
                    novel_np = novel_np & np.asarray(keep)
                    n_novel = int(novel_np.sum())
                    self.pruned_total += pruned

        name = "random" if injected else t.name
        tk = _Ticket(t, name, tstate, cands, hashes, known_np, src_np,
                     novel_np, injected, pruned,
                     gen=self._tgen.get(t.name, 0))
        tk.packed = packed
        tk.t_propose = t_prop
        self._open_ticket(tk)
        tk.t_dedup = time.perf_counter() - t_host0 - t_prop
        return tk

    def _open_ticket(self, tk: _Ticket) -> None:
        """Materialize trials for a ticket's novel rows (after the
        optional config filter) and register them pending."""
        tk.t_open = time.perf_counter()
        if tk.novel_np.any():
            idx = np.nonzero(tk.novel_np)[0]
            # one device->host transfer of the whole batch, then plain
            # numpy row selection
            u_all, *perms_all = _to_host(tk.cands.u, *tk.cands.perms)
            cfgs = self.space.to_configs(CandBatch(
                torch.from_numpy(u_all[idx]),
                tuple(torch.from_numpy(p[idx]) for p in perms_all)))
            if self.config_filter is not None:
                keep = np.asarray([bool(self.config_filter(c))
                                   for c in cfgs])
                if not keep.all():
                    self.filtered_total += int((~keep).sum())
                    tk.novel_np[idx[~keep]] = False
                    idx = idx[keep]
                    cfgs = [c for c, k in zip(cfgs, keep) if k]
            if len(idx):
                tk.u_np = u_all[idx]
                tk.perms_np = [p[idx] for p in perms_all]
                for j, (row, cfg) in enumerate(zip(idx, cfgs)):
                    tk.trials.append(Trial(self.gid, cfg, tk, j, int(row)))
                    self.gid += 1
                    self._pending.add(int(tk.packed[row]))
        tk.remaining = len(tk.trials)
        st = self.arm_stats.setdefault(tk.arm_name, [0, 0, 0])
        st[0] += 1
        st[1] += len(tk.trials)

    def inject(self, cfgs: Sequence[Dict[str, Any]],
               source: str = "seed") -> List[Trial]:
        """Open a ticket for externally-proposed configs (user models,
        seed/default configs).  Injected tickets never touch technique
        states or bandit credit; resolve the returned trials via
        tell()."""
        cfgs = list(cfgs)
        # pad to a multiple of the dedup bucket by repeating the first
        # config: padding rows are exact in-batch duplicates (never
        # novel, never trials)
        n = len(cfgs)
        target = -(-n // self._bucket) * self._bucket
        if n and n < target:
            cfgs = cfgs + [cfgs[0]] * (target - n)
        cb = self.space.from_configs(cfgs, device="cpu")
        cands = CandBatch(
            _to_device(cb.u.numpy(), torch.float32, self.device),
            tuple(_to_device(p.numpy(), torch.int64, self.device)
                  for p in cb.perms))
        tk = self._open_injected_ticket(cands, source)
        if not tk.trials:
            self._finalize(tk)  # all dups: serve + commit immediately
            return []
        return tk.trials

    # ------------------------------------------------------------------
    # ask/tell: the externally-paced surface, batched
    def ask(self, min_trials: int = 1, max_attempts: int = 8) -> List[Trial]:
        """Propose >= min_trials hash-novel trials for external
        evaluation (fewer only if the space saturates)."""
        trials: List[Trial] = []
        for _ in range(max_attempts):
            tk = self._acquire()
            if tk.trials:
                trials.extend(tk.trials)
            else:
                self._finalize(tk)  # serve dups / credit immediately
            if len(trials) >= min_trials:
                break
        return trials

    def tell(self, trial: Trial, qor: Optional[float],
             dur: float = 0.0) -> Optional[StepStats]:
        """Report a trial's USER-oriented QoR (None/NaN/inf = failure).
        Returns StepStats when the trial's whole ticket resolves."""
        if trial.qor is not None or trial.cancelled:
            raise ValueError(f"trial gid={trial.gid} already resolved")
        v = float("nan") if qor is None else float(qor)
        # engine minimizes; failures are +inf in ENGINE orientation
        trial.qor = self.sign * v if math.isfinite(v) else float("inf")
        trial.dur = dur
        self.told += 1
        if self.hooks:
            _fire(self.hooks, "on_result", self, trial,
                  float(qor) if math.isfinite(v) else None)
        tk = trial.ticket
        tk.remaining -= 1
        if tk.remaining == 0:
            return self._finalize(tk)
        return None

    def cancel(self, trial: Trial) -> Optional[StepStats]:
        """Withdraw an un-told trial: no archive row, no history insert,
        no eval count — the config may be re-proposed later."""
        if trial.qor is not None or trial.cancelled:
            raise ValueError(f"trial gid={trial.gid} already resolved")
        trial.cancelled = True
        tk = trial.ticket
        tk.remaining -= 1
        if tk.remaining == 0:
            return self._finalize(tk)
        return None

    def _credit(self, name: str, was_new_best: bool, live, global_best:
                float) -> None:
        """One AUC credit event for a resolved pull.  step_best comes
        from the ticket's LIVE trials only."""
        step_best = min((tr.qor for tr in live), default=float("inf"))
        if self._credit_kw:
            self.root.credit(name, was_new_best, step_best=step_best,
                             global_best=global_best)
        else:
            self.root.credit(name, was_new_best)

    def _finalize(self, tk: _Ticket) -> StepStats:
        """Commit a completed ticket: history insert, best update,
        archive rows, technique observe + bandit credit."""
        dev = self.device
        qor_np = tk.known  # history dups served their recorded result
        packed = tk.packed
        live = [tr for tr in tk.trials if not tr.cancelled]
        for tr in tk.trials:
            self._pending.discard(int(packed[tr.row]))
            if tr.cancelled:
                tk.novel_np[tr.row] = False  # never entered history
            else:
                qor_np[tr.row] = tr.qor
        evaluated = len(live)
        # a ticket whose trials were ALL withdrawn was never evaluated:
        # no observe, no bandit credit.  A ZERO-trial ticket (every row
        # a served duplicate) still credits: the negative feedback that
        # lets the bandit starve a saturated arm
        withdrawn = bool(tk.trials) and not live

        prev = self._best_q
        qor = None
        if evaluated or tk.novel_np.any():
            # in-batch duplicates copy their source row's result
            qor = _to_device(qor_np[tk.src], torch.float32, dev)
            self._commit(tk.hashes, tk.cands, qor,
                         _to_device(tk.novel_np, torch.bool, dev))
            self._read_commit()
            new = self._best_q
        else:
            # nothing evaluated and nothing novel: skip the commit
            new = prev
        was_new_best = new < prev

        running = prev
        for tr in live:
            is_best = tr.qor < running
            running = min(running, tr.qor)
            self._log_trial(tr.gid, tk.arm_name, tr.config,
                            tk.u_np[tr.slot],
                            [p[tr.slot] for p in tk.perms_np],
                            self.sign * tr.qor, is_best, tr.dur)
            self.trace.append(self.sign * running)
        self.evals += evaluated

        if not tk.injected and not withdrawn:
            nm = tk.arm.name
            if tk.gen == self._tgen.get(nm, 0):
                if qor is None:
                    qor = _to_device(qor_np[tk.src], torch.float32, dev)
                nb = self._nb[nm]
                draws = self._draw_observe(tk.arm, self._next_key())
                self._tstates[nm] = tk.arm.observe(
                    self.space, tk.tstate, tk.cands[:nb], qor[:nb],
                    self.best, draws)
            # else: the member was restarted while this ticket was in
            # flight — observing would undo the restart
            if isinstance(self.root, MetaTechnique):
                self._credit(nm, was_new_best, live, new)
                # quality-aware metas (RecyclingMeta) may ask for member
                # restarts: re-initialize the member's state
                for rn in self.root.poll_restart():
                    t = self._member_by_name.get(rn)
                    if t is not None:
                        self._tstates[rn] = t.init_state(
                            self.space, self._draw_init(t, self._next_key()))
                        self._tgen[rn] = self._tgen.get(rn, 0) + 1
        elif tk.credit_virtual and isinstance(self.root, MetaTechnique) \
                and not withdrawn:
            # bandit-arbitrated surrogate pull: the outcome is the
            # virtual arm's AUC event
            self._credit(tk.arm_name, was_new_best, live, new)
        if was_new_best:
            self.arm_stats.setdefault(tk.arm_name, [0, 0, 0])[2] += 1
        t_refit = 0.0
        if evaluated and self.surrogate is not None:
            # surrogate learning is the LAST act of the ticket, after
            # every device dispatch of the driver
            slots = [tr.slot for tr in live]
            self.surrogate.observe(
                self._features(tk.u_np[slots],
                               [p[slots] for p in tk.perms_np]),
                qor_np[np.asarray([tr.row for tr in live])])
            r0 = time.perf_counter()
            self.surrogate.maybe_refit()
            t_refit = time.perf_counter() - r0
        dropped = self._last_dropped
        if dropped and not self._cap_warned:
            self._cap_warned = True
            warnings.warn(
                f"history capacity ({self.history.capacity}) exceeded; "
                f"oldest entries are being evicted (dedup no longer sees "
                f"the start of the run) — raise Tuner(capacity=...); "
                f"running drop count is in StepStats.hist_dropped")
        self.steps += 1
        self._flush_archive()
        t_wait = time.perf_counter() - tk.t_open if tk.t_open else 0.0
        self.t_propose_total += tk.t_propose
        self.t_dedup_total += tk.t_dedup
        self.t_eval_wait_total += t_wait
        self.t_refit_total += t_refit
        sm = self.surrogate
        snap_v = int(getattr(sm, "snapshot_version", 0) or 0)
        lag = int(getattr(sm, "refit_lag_rows", 0) or 0)
        stats = StepStats(self.steps, tk.arm_name, tk.cands.batch,
                          evaluated, self.sign * new, was_new_best,
                          tk.pruned, dropped, tk.t_propose, tk.t_dedup,
                          t_wait, t_refit, snap_v, lag, 0, 0.0)
        if self.hooks:
            if was_new_best:
                res = self.result()
                _fire(self.hooks, "on_new_best", self,
                      res.best_config, res.best_qor)
            _fire(self.hooks, "on_step", self, stats)
        return stats

    def step(self) -> StepStats:
        """One synchronous acquisition step: acquire -> evaluate novel
        via the in-process objective -> finalize."""
        if self.objective is None:
            raise RuntimeError(
                "Tuner has no in-process objective: drive it externally "
                "via ask()/tell() instead of step()/run()")
        tk = self._acquire()
        if not tk.trials:
            return self._finalize(tk)
        cfgs = [tr.config for tr in tk.trials]
        t0 = time.time()
        im = self.input_manager
        if im is not None:
            inps = [im.select_input(tr) for tr in tk.trials]
            for tr, i in zip(tk.trials, inps):
                im.before_run(tr, i)
            vals = np.asarray(self.objective(cfgs, inps),
                              np.float64).reshape(-1)
            for tr, i in zip(tk.trials, inps):
                im.after_run(tr, i)
        else:
            vals = np.asarray(self.objective(cfgs),
                              np.float64).reshape(-1)
        dur = (time.time() - t0) / max(1, len(cfgs))
        stats = None
        for tr, v in zip(tk.trials, vals):
            stats = self.tell(tr, float(v), dur)
        return stats

    # ------------------------------------------------------------------
    def run(self, test_limit: int = 5000,
            time_limit: Optional[float] = None,
            target: Optional[float] = None) -> TuneResult:
        """Run until `test_limit` evaluations (default 5000), a
        wall-clock limit, or a target QoR is reached."""
        self._apply_budget_rule(test_limit)
        t0 = time.time()
        no_eval_streak = 0
        while self.evals < test_limit:
            stats = self.step()
            no_eval_streak = 0 if stats.evaluated else no_eval_streak + 1
            if no_eval_streak >= 25:
                # search space exhausted: even random injection finds
                # nothing hash-novel any more
                break
            if time_limit is not None and time.time() - t0 > time_limit:
                break
            if target is not None and self._target_met(target):
                break
        return self.result()

    def _wire_surrogate_arm(self) -> bool:
        """Register the surrogate proposal plane as a credit-earning
        virtual arm of the AUC bandit (arbitration='bandit').  Returns
        False when the root is not an AUC bandit or the plane is
        disabled."""
        sm = self.surrogate
        from ..techniques.bandit import AUCBanditMeta
        if not (isinstance(self.root, AUCBanditMeta)
                and getattr(sm, "propose_batch", 0)):
            return False
        if "surrogate" not in self.root.virtual_arms:
            self.root.register_virtual_arm("surrogate")
        self._surr_arm = True
        if getattr(sm, "propose_batch_parity", False):
            # pull-size parity: raise the pool batch to the median
            # technique-arm batch
            bs = sorted(t.natural_batch(self.space)
                        for t in self.members)
            med = int(bs[len(bs) // 2])
            if med > sm.propose_batch:
                sm.propose_batch = med
        return True

    def _apply_budget_rule(self, test_limit: int) -> None:
        """Run-budget surrogate rule: with fewer evals than scalar
        parameters the plane becomes an AUC-credit virtual arm with the
        calibrated pull size (BUDGET_CONSTRAINED_OPTS), or passive when
        the root cannot arbitrate; a later large-budget run reverts what
        the rule changed.  Users opt out via auto_passive=False."""
        sm = self.surrogate
        if sm is None or not getattr(sm, "auto_passive", False):
            return
        if test_limit < self.space.n_scalar:
            if getattr(sm, "passive", False):
                return      # already passive (this rule or the user)
            if self._surr_arm or getattr(sm, "_auto_budget", False):
                return      # user chose arbitration, or already applied
            prev = (sm.arbitration, sm.propose_batch_parity,
                    sm.propose_batch)
            from ..calibrated import BUDGET_CONSTRAINED_OPTS
            sm.arbitration = "bandit"
            sm.propose_batch_parity = False
            # propose_batch == 0 means the plane is disabled: leave it so
            # _wire_surrogate_arm declines
            if sm.propose_batch:
                sm.propose_batch = \
                    BUDGET_CONSTRAINED_OPTS["propose_batch"]
            if self._wire_surrogate_arm():
                sm._auto_budget = prev
                warnings.warn(
                    f"surrogate switched to BUDGET-CONSTRAINED bandit "
                    f"arbitration for this run: budget {test_limit} "
                    f"evals < {self.space.n_scalar} scalar parameters — "
                    f"the regime where AUC-arbitrated "
                    f"{sm.propose_batch}-eval pool pulls "
                    f"are the best measured configuration (0.88x "
                    f"baseline median, BENCHREPORT.md); pass "
                    f"surrogate_opts={{'auto_passive': False}} to "
                    f"override", UserWarning)
                return
            # can't arbitrate: fall back to passivation
            (sm.arbitration, sm.propose_batch_parity,
             sm.propose_batch) = prev
            sm.passive = True
            sm._auto_passivated = True
            warnings.warn(
                f"surrogate set PASSIVE for this run: budget "
                f"{test_limit} evals < {self.space.n_scalar} scalar "
                f"parameters, a regime where scheduled in-loop guidance "
                f"is measured neutral-to-harmful (BENCHREPORT.md) and "
                f"the root technique cannot bandit-arbitrate the plane; "
                f"pass surrogate_opts={{'auto_passive': False}} to "
                f"override", UserWarning)
        else:
            if getattr(sm, "_auto_passivated", False):
                sm.passive = False
                sm._auto_passivated = False
            prev = getattr(sm, "_auto_budget", None)
            if prev:
                (sm.arbitration, sm.propose_batch_parity,
                 sm.propose_batch) = prev
                sm._auto_budget = None
                if sm.arbitration != "bandit":
                    self._surr_arm = False

    def _target_met(self, target: float) -> bool:
        q = self._best_q
        if not math.isfinite(q):
            return False
        user = self.sign * q
        return user <= target if self.sense == "min" else user >= target

    def result(self) -> TuneResult:
        q = self._best_q
        cfg = {}
        if math.isfinite(q):
            cfg = self.space.to_configs(self.best.as_batch(1))[0]
        return TuneResult(cfg, self.sign * q, self.evals, self.steps,
                          list(self.trace), self.t_propose_total,
                          self.t_dedup_total, self.t_eval_wait_total,
                          self.t_refit_total, self.t_compile_total)

    def best_config(self) -> Dict[str, Any]:
        return self.result().best_config

    def close(self):
        if self.hooks:
            _fire(self.hooks, "on_finish", self, self.result())
            self.hooks = []
        sm = self.surrogate
        if sm is not None:
            # let an in-flight background refit publish and shut the
            # worker down
            if hasattr(sm, "close"):
                sm.close()
            elif hasattr(sm, "drain"):
                sm.drain()
        if self._archive_f is not None:
            self._archive_f.close()
            self._archive_f = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
