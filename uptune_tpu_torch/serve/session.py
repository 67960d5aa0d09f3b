"""One tenant's session: tickets over versioned snapshots.

Counterpart of `uptune_tpu/serve/session.py`.

A session is a state machine over its group slot:

    version v ──ask──> pending epoch (B candidate rows, decoded once)
        │                 │ tickets: one per UNIQUE config (in-epoch
        │                 │ duplicate rows share a ticket and a value)
        │                 │ store memo: rows another tenant already
        │                 │ measured are auto-filled — no ticket at all
        │<───commit────── │ every row filled -> publish version v+1

``ask`` returns tickets against the CURRENT version; ``tell`` fills
rows; the tell that completes the batch commits (one donated dispatch)
and publishes the next version.  A ticket from a published-over epoch
is stale and rejected (StaleTicketError) — the versioned-snapshot
contract of the surrogate plane, applied to tenants.

``LocalSession`` is the same machinery on a private single-slot group:
the *offline tuner* of the serving plane.  The parity tests (and the
serving measurements' sequential baseline) hold the multiplexed server to bitwise
per-session equality with it at matched seeds.
"""
from __future__ import annotations

import threading
import uuid
from typing import Any, Dict, List, NamedTuple, Optional, Sequence

import numpy as np

from .. import obs
from ..obs.quality import SessionQuality
from ..store.keys import canon_config
from .durable import encode_raw


class StaleTicketError(KeyError):
    """tell() against a ticket that is unknown, already told, or from
    an epoch that has been published over."""


class SessionRestoredError(StaleTicketError):
    """tell() against a ticket from an in-flight epoch that a server
    crash destroyed: the session was restored from its checkpoint
    (durable.py) and the epoch's ticket assignment cannot be trusted
    across the restart — the client must re-ask (reissue) and retry
    with the fresh tickets (docs/SERVING.md "Durability & failover")."""


class TrialOffer(NamedTuple):
    """One ask() result row: measure `config` and tell `ticket` its
    QoR.  (`cached` offers carry a store-served QoR and need no tell —
    the serving counters report them; ask() returns only live
    tickets.)  `epoch` is the session version the ticket was issued
    against — carried back by resuming clients so a duplicate tell
    replay is detected server-side.  `canon` is the
    config's canonical JSON text, computed once per epoch for the
    dedup scan and reused by the server's preserialized ask reply
    — None for offers minted off paths that never
    canonicalized (LocalSession callers ignore it)."""
    ticket: int
    config: Dict[str, Any]
    epoch: int = 0
    canon: Optional[str] = None


class _Pending(object):
    """One epoch's host-side bookkeeping.  All accounting is LAZY:
    rows are scanned, canon-deduped and memo-checked only as ask()
    hands tickets out, so every request costs O(rows touched this
    call), never O(B) — the serving plane's tail-latency contract
    (an eager per-epoch pass put milliseconds of sha1/decode work
    under the group lock on EVERY epoch-boundary ask, which is
    exactly what the serving plane's ask p95 would have caught).

    In-epoch dedup: rows with one canonical config share one ticket
    and one measured value (the engine's own dedup would classify
    them as duplicates anyway; a tenant should never be asked to
    build the same config twice in one batch)."""

    __slots__ = ("epoch", "version", "configs", "raw", "filled",
                 "next_row", "by_canon", "group_canon", "group_rows",
                 "group_value", "tickets", "told")

    def __init__(self, epoch, version: int, configs: List[dict]):
        self.epoch = epoch
        self.version = version
        self.configs = configs
        b = len(configs)
        self.raw = np.full((b,), np.nan, np.float32)
        self.filled = np.zeros((b,), bool)
        self.next_row = 0                       # lazy scan cursor
        self.by_canon: Dict[str, int] = {}      # canon -> dup-group
        self.group_canon: List[str] = []        # dup-group -> canon
        self.group_rows: List[List[int]] = []
        self.group_value: List[Optional[float]] = []
        self.tickets: Dict[int, int] = {}       # ticket id -> dup-group
        self.told: set = set()     # consumed tickets (duplicate squash)

    def fill(self, g: int, value: float) -> None:
        rows = self.group_rows[g]
        self.raw[rows] = value
        self.filled[rows] = True

    @property
    def unfilled(self) -> int:
        return int((~self.filled).sum())

    def settled(self) -> bool:
        """Every row scanned, no ticket outstanding, every row filled
        -> ready to commit."""
        return (self.next_row >= len(self.configs)
                and not self.tickets and self.unfilled == 0)


class Session:
    """One tenant bound to one group slot.  All methods take the
    group's lock; everything host-visible (incumbent, counters) lives
    here so `best` never touches the device."""

    def __init__(self, group, slot: int, seed: int, *,
                 store=None, session_id: Optional[str] = None):
        self.group = group
        self.slot = slot
        self.seed = seed
        self.id = session_id or uuid.uuid4().hex[:16]
        self.store = store
        self.version = 0            # published snapshots (commits)
        self.pending: Optional[_Pending] = None
        self.best_config: Optional[dict] = None
        self.best_qor: Optional[float] = None
        self.asks = 0
        self.tells = 0
        self.store_served = 0       # rows auto-filled from the memo
        self.closed = False
        self._ticket_seq = 0
        # durable checkpoint plane: the durable server sets
        # `durable` to its CheckpointLog; _commit then buffers one
        # record per published version, drained OUTSIDE the group lock
        # but BEFORE the op's reply (ack-after-durable).  `incarn` is
        # the restart-incarnation token: bumped by crash recovery so a
        # pre-crash ticket can never be misapplied to a post-restore
        # epoch that happens to reuse its (version, ticket id) pair
        self.durable = None
        self._ckpt_buf: List[Dict[str, Any]] = []
        # serializes this session's checkpoint appends across handler
        # threads, and carries the flushed-version watermark they
        # synchronize on (see _drain_ckpt)
        self._ckpt_lock = threading.Lock()
        self._ckpt_flushed = 0
        self.incarn = "0"
        # per-tenant search-quality accumulator: a few ints
        # + one bounded ring, updated at tell time under the group
        # lock, read by the server's {"op": "health"} op — always on
        self.quality = SessionQuality()

    # -- internals -----------------------------------------------------
    def _offer_best(self, cfg: dict, qor: float) -> bool:
        sign = self.group.engine.sign
        if self.best_qor is None or sign * qor < sign * self.best_qor:
            self.best_config, self.best_qor = cfg, float(qor)
            obs.count("serve.new_bests")
            return True
        return False

    def _new_pending(self) -> Optional[_Pending]:
        """Build this session's pending epoch.  The group lock is NOT
        held across the expensive host side — epoch materialization
        (one stacked device->host pull) and config decode — so other
        tenants' asks and tells proceed under it.  Returns None when
        the epoch went stale between taking it and locking back in
        (this session committed concurrently — only possible with
        multiple clients driving one session); the ask loop then
        retries."""
        ep = self.group.pending_for(self)
        configs = self.group.space.to_configs(ep.host_rows(self.slot))
        with self.group.lock:
            if ep.slot_gens[self.slot] != self.group.slot_gen[self.slot] \
                    or self.pending is not None:
                return self.pending
            return self._adopt(ep, configs)

    def _adopt(self, ep, configs: List[dict]) -> _Pending:
        # memo/dedup accounting is deferred to ask()'s lazy row scan
        p = _Pending(ep, self.version, configs)
        self.pending = p
        return p

    def _scan_row(self, p: _Pending) -> Optional[TrialOffer]:
        """Advance the lazy cursor one row: attach duplicates to their
        group, auto-fill rows the cross-tenant memo already knows (any
        config ANY tenant of this scope measured is served without a
        build — and without a ticket), or mint a ticket.  Returns the
        offer for live rows, None otherwise."""
        r = p.next_row
        p.next_row += 1
        cfg = p.configs[r]
        c = canon_config(cfg)
        g = p.by_canon.get(c)
        if g is not None:                   # in-epoch duplicate
            p.group_rows[g].append(r)
            v = p.group_value[g]
            if v is not None:               # group already resolved
                p.raw[r] = v
                p.filled[r] = True
            return None                     # else: fills at its tell
        g = len(p.group_rows)
        p.by_canon[c] = g
        p.group_canon.append(c)
        p.group_rows.append([r])
        row = self.store.lookup(cfg) if self.store is not None else None
        if row is not None:
            q = float(row["qor"])
            p.group_value.append(q)
            p.raw[r] = q
            p.filled[r] = True
            self.store_served += 1
            obs.count("serve.store_served")
            self._offer_best(cfg, q)
            return None
        p.group_value.append(None)
        t = self._ticket_seq
        self._ticket_seq += 1
        p.tickets[t] = g
        return TrialOffer(t, cfg, p.version, c)

    def _commit(self) -> None:
        p = self.pending
        self.group.commit(self, p.epoch, p.raw)
        self.version += 1
        self.pending = None
        if self.durable is not None:
            # the v -> v+1 delta, buffered under the group lock (host
            # dict + one B-float list) and appended to disk by
            # _drain_ckpt outside it.  Incumbent/counters/quality are
            # checkpointed verbatim: replay preserves values but not
            # tell ORDER, and order is what breaks qor ties
            self._ckpt_buf.append({
                "ev": "commit", "v": self.version,
                "raw": encode_raw(p.raw),
                "best_cfg": self.best_config,
                "best_qor": self.best_qor,
                "asks": self.asks, "tells": self.tells,
                "served": self.store_served,
                "tseq": self._ticket_seq,
                "q": self.quality.state()})

    def _drain_ckpt(self) -> None:
        """Flush buffered commit records to the checkpoint segment —
        called outside the group lock (disk stays off the serving
        path) but before the op's reply is written, so a committed:
        true a client observed is always durable (the bounded-loss
        contract the failover measurement prices).

        Two clients may drive one session from two handler threads,
        so the drain is serialized per session (_ckpt_lock) and the
        buffer swap happens INSIDE that lock: an op may only skip the
        drain when the flushed watermark already covers every version
        it could have published — never because a peer swapped the
        buffer but has not finished appending (acking v+1 while v sat
        un-appended in a stalled peer would leave a version gap scan()
        rightly refuses to replay past)."""
        if self.durable is None:
            return
        # racy fast path, safe by monotonicity: _ckpt_flushed only
        # grows (under _ckpt_lock), and self.version was published
        # before this op's commit record entered the buffer — a stale
        # read can only send us through the lock unnecessarily
        if self._ckpt_flushed >= self.version:
            return
        with self._ckpt_lock:
            with self.group.lock:
                recs, self._ckpt_buf = self._ckpt_buf, []
            for i, r in enumerate(recs):
                if not self.durable.append(self.id, r):
                    # disk refused (ENOSPC/EIO — counted by the log):
                    # requeue THIS record and the rest at the buffer
                    # FRONT, order preserved, so a later drain retries
                    # once the disk recovers.  The watermark must not
                    # advance past a hole — recovery truncates at the
                    # first version gap, so a skipped record would
                    # silently void every later acked commit
                    with self.group.lock:
                        self._ckpt_buf[:0] = recs[i:]
                    return
                self._ckpt_flushed = max(self._ckpt_flushed,
                                         int(r.get("v", 0)))

    # -- the ask/tell surface ------------------------------------------
    def ask(self, n: int = 1, max_auto: int = 4) -> List[TrialOffer]:
        """Up to `n` trial offers from the current epoch.  Epochs fully
        served by the store memo are committed and skipped (bounded by
        `max_auto` per call); fewer than `n` offers — possibly none —
        come back when the epoch's remaining rows are already ticketed
        out (tell those first).  An epoch refresh only ENQUEUES device
        work under the group lock (group.pending_for); the blocking
        host pull + config decode run unlocked (_new_pending).

        The fast path — k tickets off an already-materialized epoch —
        is ONE group-lock hold: open-check, row scan and
        ticket mint happen in the same acquisition, so a k-wide ask
        costs one lock round instead of k."""
        out: List[TrialOffer] = []
        autos = 0
        while not out:
            need_epoch = False
            with self.group.lock:
                self._check_open()
                p = self.pending
                if p is None:
                    need_epoch = True
                else:
                    while p.next_row < len(p.configs) and len(out) < n:
                        offer = self._scan_row(p)
                        if offer is not None:
                            out.append(offer)
                    if out:
                        self.asks += len(out)
                        break
                    if p.settled():
                        # every row memo-served: publish and move on
                        self._commit()
                        autos += 1
                        if autos >= max_auto:
                            break
                        continue
                    break   # rows already ticketed out: tell first
            if need_epoch:
                # the expensive host side (device pull + config
                # decode) runs UNLOCKED; the next loop pass re-reads
                # self.pending under the lock, so a concurrent commit
                # between here and there is simply retried
                self._new_pending()
        obs.count("serve.asks", len(out))
        # memo auto-commits above published versions: durable-ack them
        # before this ask's reply, same rule as the tell path
        self._drain_ckpt()
        return out

    def outstanding(self) -> List[TrialOffer]:
        """The current epoch's live (unanswered) tickets, re-offered
        in issue order — the reconnect path: an ask whose reply was
        lost already ticketed rows out, and re-asking must surface
        THOSE tickets or the epoch can never settle (the client
        resume protocol, docs/SERVING.md)."""
        with self.group.lock:
            p = self.pending
            if p is None:
                return []
            return [TrialOffer(t, p.configs[p.group_rows[g][0]],
                               p.version, p.group_canon[g])
                    for t, g in sorted(p.tickets.items())]

    def _squash_duplicate(self, p: Optional[_Pending], ticket: int,
                          epoch, incarn) -> Optional[Dict[str, Any]]:
        """Duplicate-replay detection (called under the group lock
        when `ticket` is not live).  A resuming client retries a tell
        whose reply it never observed; the ticket's epoch id tells
        the two cases apart: already-committed epoch -> squash as a
        durable duplicate; already-told but uncommitted -> squash
        without commit.  A ticket carrying a STALE incarnation token
        from before a crash-restore is only squashable when its epoch
        committed durably — otherwise it belongs to the lost
        in-flight epoch and the client must re-ask."""
        if epoch is None:
            return None
        try:
            epoch = int(epoch)
        except (TypeError, ValueError):
            return None
        if epoch < self.version:
            # the ticket's epoch published durably (commit records are
            # acked-before-reply): whatever incarnation issued it, its
            # tell is inside that commit — a pure duplicate
            return {"new_best": False, "committed": True,
                    "version": self.version, "duplicate": True}
        if incarn is not None and str(incarn) != self.incarn:
            raise SessionRestoredError(
                f"session {self.id} was restored after a crash; "
                f"ticket {ticket} belongs to a lost in-flight epoch "
                f"— re-ask (reissue) and retry")
        if p is not None and epoch == p.version and ticket in p.told:
            return {"new_best": False, "committed": False,
                    "version": self.version, "duplicate": True}
        return None

    def _tell_locked(self, ticket: int, qor, epoch, incarn):
        """Apply ONE tell under the group lock (caller holds it).
        Returns ``(result, fx)`` where ``fx`` is None for a squashed
        duplicate, else the ``(cfg, value, finite, new_best,
        committed)`` tuple the caller's unlocked side effects (journal
        row, store memo write) need.  Raises StaleTicketError /
        conversion errors exactly like the historical tell body —
        batch callers turn those into per-element error entries."""
        self._check_open()
        p = self.pending
        # a ticket carrying a stale incarnation token must NEVER
        # apply, even if its id coincides with a live ticket (the
        # restored id space is offset — _mark_restored — so this
        # is a belt, not the wall)
        stale_inc = (incarn is not None
                     and str(incarn) != self.incarn)
        if p is None or ticket not in p.tickets or stale_inc:
            dup = self._squash_duplicate(p, ticket, epoch, incarn)
            if dup is not None:
                obs.count("serve.dup_tells")
                return dup, None
            raise StaleTicketError(
                f"ticket {ticket} is unknown, already told, or "
                f"from a published-over epoch (session "
                f"{self.id}, version {self.version})")
        # convert BEFORE popping: a malformed qor (string, list)
        # must leave the ticket live for a retry, not consume it
        # and strand the epoch one row short of settled forever
        v = float("nan") if qor is None else float(qor)
        g = p.tickets.pop(ticket)
        p.told.add(ticket)
        finite = v == v and abs(v) != float("inf")
        p.group_value[g] = v if finite else float("nan")
        p.fill(g, p.group_value[g])
        cfg = p.configs[p.group_rows[g][0]]
        new_best = False
        if finite:
            new_best = self._offer_best(cfg, v)
        self.tells += 1
        self.quality.on_tell(finite, new_best)
        committed = False
        if p.settled():
            self._commit()
            committed = True
        return ({"new_best": new_best, "committed": committed,
                 "version": self.version},
                (cfg, v, finite, new_best, committed, self.version))

    def _tell_fx(self, fx, dur: float) -> None:
        """One applied tell's unlocked side effects: the journal row
        and the cross-tenant memo write — disk stays off the group's
        serving path."""
        cfg, v, finite, new_best, committed, version = fx
        if obs.journal.enabled():
            # the server-side tuning journal (per-tenant stream): one
            # row per committed tell, so `ut report` over a server's
            # journal shows each session's progress and the health op's
            # verdicts are reconstructible offline
            obs.journal.emit(
                "serve_tell", session=self.id, ok=finite,
                qor=round(v, 6) if finite else None,
                new_best=new_best, committed=committed,
                version=version)
        # the memo write happens OUTSIDE the group lock (the store has
        # its own lock; a racing reader either hits or re-measures —
        # never a correctness matter).  Best-effort to the end: the
        # tell is already applied, so a failed append (disk full,
        # store closed by a racing stop) must not fail the response —
        # that would report ok=False for an epoch that really
        # committed
        if self.store is not None:
            try:
                self.store.record(cfg, v if finite else None, dur,
                                  source=f"serve:{self.id}")
            except OSError:
                obs.count("serve.store_write_errors")
        obs.count("serve.tells")

    def tell(self, ticket: int, qor: Optional[float],
             dur: float = 0.0, epoch=None, incarn=None
             ) -> Dict[str, Any]:
        """Report a ticket's USER-oriented QoR (None/NaN/inf = build
        failure).  The tell completing the epoch publishes the next
        snapshot version.  `epoch`/`incarn` are the resume protocol's
        idempotence tags (the ticket's TrialOffer.epoch and the ask
        reply's incarnation token): a duplicate replay after an
        acked-but-unobserved reply is detected and squashed instead
        of raising or double-applying."""
        with self.group.lock:
            out, fx = self._tell_locked(ticket, qor, epoch, incarn)
        # durable-before-ack: the commit record (if this tell
        # published) hits disk before this method returns a
        # committed=true the client could act on
        self._drain_ckpt()
        if fx is not None:
            self._tell_fx(fx, dur)
        return out

    def tell_many(self, rows: Sequence[Any], incarn=None
                  ) -> Dict[str, Any]:
        """Apply a batch of tells in ONE group-lock hold and ack them
        all behind ONE checkpoint drain — the vectorized
        server op.  Each row is a ``{"ticket", "qor"[, "dur",
        "epoch"]}`` object carrying its own epoch tag; `incarn` covers
        the batch (one client, one incarnation).  Element-wise error
        walls: a stale/malformed row becomes an ``errors`` entry and
        the rest still apply — exactly the durable duplicate-squash
        matrix, row by row.  Ack-after-durable holds batch-wide: the
        single ``_drain_ckpt`` below flushes EVERY version this batch
        published before the one reply that acks it."""
        out: Dict[str, Any] = {"told": 0, "new_best": False,
                               "committed": False, "duplicates": 0,
                               "version": self.version}
        errors: List[Dict[str, Any]] = []
        fxs: List[Any] = []
        with self.group.lock:
            for r in rows:
                try:
                    # convert dur (and ticket) BEFORE applying, so a
                    # malformed row leaves its ticket live for retry
                    dur = float(r.get("dur") or 0.0)
                    one, fx = self._tell_locked(
                        int(r["ticket"]), r.get("qor"),
                        r.get("epoch"), incarn)
                except StaleTicketError as e:
                    errors.append({"ticket": r.get("ticket"),
                                   "error": str(e)})
                    continue
                except (KeyError, TypeError, ValueError,
                        AttributeError) as e:
                    errors.append({"ticket": (r.get("ticket")
                                              if isinstance(r, dict)
                                              else None),
                                   "error": f"bad tell payload: {e}"})
                    continue
                if one.get("duplicate"):
                    out["duplicates"] += 1
                else:
                    out["told"] += 1
                    out["new_best"] = (out["new_best"]
                                       or one["new_best"])
                    fxs.append((fx, dur))
                out["committed"] = out["committed"] or one["committed"]
                out["version"] = one["version"]
        if errors:
            out["errors"] = errors
        # ONE durable drain acks the whole batch (every commit this
        # batch buffered is on disk before the reply), then the
        # unlocked per-tell side effects in application order
        self._drain_ckpt()
        for fx, dur in fxs:
            self._tell_fx(fx, dur)
        return out

    def best(self) -> Dict[str, Any]:
        """Host-side incumbent (never a device sync)."""
        with self.group.lock:
            return {"config": self.best_config, "qor": self.best_qor,
                    "version": self.version, "asks": self.asks,
                    "tells": self.tells,
                    "store_served": self.store_served}

    def health(self, *, stall_tells: int = 64,
               fail_rate_hi: float = 0.5) -> Dict[str, Any]:
        """Per-session quality verdict (never a device sync): the
        SessionQuality status plus the counters a poller needs to act
        on it — the serve `{"op": "health"}` payload."""
        with self.group.lock:
            out = {"session": self.id, "version": self.version,
                   "asks": self.asks, "store_served": self.store_served,
                   "best_qor": self.best_qor}
            out.update(self.quality.health(stall_tells=stall_tells,
                                           fail_rate_hi=fail_rate_hi))
            return out

    # -- crash recovery (serve/durable.py) -----------------------------
    def _replay_commit(self, raw: Sequence[float]) -> None:
        """Re-publish one committed epoch through the SAME
        propose/commit programs — no tickets, no config decode: the
        stream of raw batches alone determines the device state, and
        `propose` is pure in the state, so the replayed session is
        bitwise identical to one that never died."""
        with self.group.lock:
            ep = self.group.pending_for(self)
            self.group.commit(self, ep, np.asarray(raw, np.float32))
            self.version += 1
            self.pending = None

    def _mark_restored(self, incarn: str) -> None:
        """Stamp a crash-restored session: a fresh incarnation token
        (pre-crash tickets are detected, squashed or rejected — never
        misapplied) and a ticket-id space offset past anything the
        lost incarnation could have minted (ids are wire handles, not
        device state, so the offset never touches parity)."""
        with self.group.lock:
            self.incarn = str(incarn)
            self._ticket_seq += 1 << 20
            # every replayed version came FROM the segment: durable
            self._ckpt_flushed = self.version

    def _restore_host(self, rec: Dict[str, Any], incarn: str) -> None:
        """Host-side accounting from the last commit record —
        checkpointed verbatim because replay preserves values but not
        tell order, and order is what breaks qor ties."""
        with self.group.lock:
            self.best_config = rec.get("best_cfg")
            bq = rec.get("best_qor")
            self.best_qor = None if bq is None else float(bq)
            self.asks = int(rec.get("asks", 0))
            self.tells = int(rec.get("tells", 0))
            self.store_served = int(rec.get("served", 0))
            self._ticket_seq = int(rec.get("tseq", 0))
            q = rec.get("q")
            if q is not None:
                self.quality.restore(q)
        self._mark_restored(incarn)

    def close(self) -> None:
        with self.group.lock:
            if self.closed:
                return
            self.closed = True
            self.pending = None
            self.group.leave(self)
        # any not-yet-drained commit must land before the close mark,
        # then the segment is reaped (a recovering server also reaps
        # segments whose stream ends in a close record)
        self._drain_ckpt()
        if self.durable is not None:
            self.durable.append(self.id, {"ev": "close"})
            self.durable.reap(self.id)

    def _check_open(self) -> None:
        if self.closed:
            raise StaleTicketError(f"session {self.id} is closed")

    def __enter__(self) -> "Session":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


class LocalSession:
    """The offline sibling: identical session mechanics on a private
    single-slot group, no server, no sockets.

        with LocalSession(space, seed=3) as s:
            while budget:
                for t in s.ask(8):
                    s.tell(t.ticket, measure(t.config))
        s.best()

    Matched seeds make this bitwise equal to a server session — the
    parity bar tests/test_serve.py holds the multiplexed plane to.
    `device` (default the card) is where its one-slot group lives."""

    def __init__(self, space, seed: int = 0, *,
                 arms: Optional[Sequence[str]] = None,
                 sense: str = "min", history_capacity: int = 1 << 10,
                 store=None, device="cuda"):
        from .group import SessionGroup
        self._group = SessionGroup(space, 1, arms=arms, sense=sense,
                                   history_capacity=history_capacity,
                                   device=device)
        self._session = self._group.join(seed, store=store)

    def ask(self, n: int = 1, **kw) -> List[TrialOffer]:
        return self._session.ask(n, **kw)

    def tell(self, ticket: int, qor: Optional[float],
             dur: float = 0.0) -> Dict[str, Any]:
        return self._session.tell(ticket, qor, dur)

    def tell_many(self, rows: Sequence[Any]) -> Dict[str, Any]:
        return self._session.tell_many(rows)

    def best(self) -> Dict[str, Any]:
        return self._session.best()

    def health(self, **kw) -> Dict[str, Any]:
        return self._session.health(**kw)

    @property
    def version(self) -> int:
        return self._session.version

    def close(self) -> None:
        self._session.close()

    def __enter__(self) -> "LocalSession":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
