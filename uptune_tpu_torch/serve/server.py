"""The session server: newline-delimited JSON over TCP, thread per
connection, every request one JSON object with an ``op`` field.

    {"op": "open", "space": [...param records...], "seed": 3,
     "program": "my-flow"}            -> {"ok": true, "session": "..."}
    {"op": "ask", "session": s, "n": 4}
    {"op": "tell", "session": s, "ticket": 0, "qor": 1.25}
    {"op": "best", "session": s}
    {"op": "close", "session": s}
    {"op": "metrics"}                 -> the obs metrics scrape
    {"op": "health", "session": s}    -> per-session search quality
    {"op": "stats"} / {"op": "ping"}

``SessionServer.handle(request) -> response`` is the transport-free
dispatch (tests and the in-process bench drive it directly); the TCP
layer is one reader/writer loop around it.  An optional ``id`` field
is echoed verbatim so clients may pipeline.  The
generic half — dispatch table, per-op error walls, the accept /
reader loops, connection reaping — lives in ``serve.wire.WireServer``
(in the JAX package shared with the fleet-telemetry hub); this module owns
only the session-plane ops and registries.

The port's server runs its groups on one device, the card unless the
caller asks for the CPU (``device="cpu"``, the CLI's ``--device cpu``),
as every entry point of the port does; on the card each tenant commit
launches the merge kernel.

Tenant grouping happens at ``open``: the request's space records are
rebuilt into a Space, and sessions whose ``group_key`` matches share
one BatchedEngine instance axis (new groups are allocated when
existing ones fill).  Scoped result stores — the cross-tenant memo —
are shared per (space signature, program token) under one store
directory, so one tenant's recorded build serves another's ask.

There is no authentication or tenant quota beyond the session cap:
this is an in-cluster serving plane, not an internet-facing one
(docs/SERVING.md).
"""
from __future__ import annotations

import logging
import os
import re
import threading
import time
import uuid
from typing import Any, Dict, List, Optional, Tuple

from .. import obs
from ..api.session import settings
from ..device import DeviceLike, resolve_device
from ..exec.space_io import space_from_params
from ..store import is_remote_addr, open_store
from ..store.store import ResultStore
from .durable import CheckpointLog, decode_raw, default_checkpoint_dir
from .group import SessionGroup, group_key
from .session import Session, StaleTicketError
from .wire import (RequestError, WireReply,  # noqa: F401  (re-export)
                   WireServer)
from .wire import _ENC as _enc

log = logging.getLogger("uptune_tpu_torch")

# a client-proposed durable session id becomes a checkpoint FILENAME:
# constrain it to the uuid-hex shape the server mints itself
_SID_OK = re.compile(r"^[A-Za-z0-9_-]{1,64}$")


def _resolve(value, key):
    """The documented precedence: explicit argument (CLI flag layer) >
    ut.config session settings > DEFAULTS."""
    return settings[key] if value is None else value


class SessionServer(WireServer):
    """One serving process.  Construct, ``start()``, ``connect()``
    clients against ``.port``, ``stop()``.  All constructor parameters
    but `device` default through the ``serve-*`` ut.config keys;
    `device` (default the card) is where every group's stacked state
    lives."""

    WIRE_NAME = "ut-serve"

    # grace a disconnected durable tenant gets before its slot is
    # swept (seconds): a resuming client re-attaches well inside it,
    # a truly dead one stops leaking its slot + admission unit —
    # lazily enforced on open/attach/stats (no reaper thread)
    ORPHAN_TTL = 900.0

    def __init__(self, host: Optional[str] = None,
                 port: Optional[int] = None,
                 slots: Optional[int] = None,
                 max_sessions: Optional[int] = None,
                 store_dir: Optional[str] = None,
                 work_dir: Optional[str] = None,
                 durable: Optional[str] = None,
                 durable_fsync: Optional[bool] = None,
                 orphan_ttl: Optional[float] = None,
                 device: Optional[DeviceLike] = None):
        # before anything binds or scans: no card and no device="cpu"
        # is a refusal, never a quiet run on the CPU
        self.device = resolve_device("cuda" if device is None else device)
        super().__init__(str(_resolve(host, "serve-host")),
                         int(_resolve(port, "serve-port")))
        self.slots = int(_resolve(slots, "serve-slots"))
        self.max_sessions = int(_resolve(max_sessions,
                                         "serve-max-sessions"))
        if self.slots < 1:
            raise ValueError(f"serve-slots must be >= 1: {self.slots}")
        sd = _resolve(store_dir, "serve-store-dir")
        self.work_dir = os.path.abspath(work_dir or os.getcwd())
        if sd is None:
            sd = os.path.join(self.work_dir, "ut.serve", "store")
        # a tcp:// base joins a cooperative store server
        # (`ut-torch store`) — an address, not a path
        self.store_dir = (None if str(sd).lower() in ("off", "none")
                          else str(sd) if is_remote_addr(sd)
                          else os.path.abspath(str(sd)))
        # self._lock (WireServer) guards the registries below too
        self._groups: Dict[Tuple, List[SessionGroup]] = {}
        self._glocks: Dict[Tuple, threading.Lock] = {}
        self._admitted = 0      # admission reservations (<= max)
        self._sessions: Dict[str, Session] = {}
        self._stores: Dict[Tuple, ResultStore] = {}
        # the metrics registry only records while the obs plane is
        # enabled; a serving process keeps it on so the scrape op (and
        # the serving plane's measurements) always has data.  Span rings are
        # bounded per thread, so long-lived servers don't grow
        if not obs.enabled():
            obs.enable()
        # -- durable sessions (docs/SERVING.md) --------------
        dv = _resolve(durable, "serve-durable")
        if dv is not None and str(dv).lower() in ("off", "none", "0",
                                                  "false"):
            dv = None
        self.ckpt: Optional[CheckpointLog] = None
        self.orphan_ttl = float(orphan_ttl if orphan_ttl is not None
                                else self.ORPHAN_TTL)
        self._orphans: Dict[str, float] = {}   # sid -> disconnect time
        # sid -> owning-connection token (id of its owned-set): a DEAD
        # connection may only orphan-stamp sessions it still owns, so
        # a lingering old connection's demise cannot re-orphan a
        # session its client already re-attached elsewhere
        self._owners: Dict[str, int] = {}
        self.recovered = 0
        self.recovery_s = 0.0
        if dv is not None:
            # a remote store base is no place for checkpoint files —
            # 'on' falls back to the work-dir default then
            local_sd = (None if is_remote_addr(self.store_dir)
                        else self.store_dir)
            cdir = (default_checkpoint_dir(local_sd, self.work_dir)
                    if str(dv).lower() in ("on", "true", "1")
                    else os.path.abspath(str(dv)))
            self.ckpt = CheckpointLog(
                cdir, fsync=bool(_resolve(durable_fsync,
                                          "serve-durable-fsync")))
            self._recover()

    # -- registry ------------------------------------------------------
    def _store_for(self, space, program: str) -> Optional[ResultStore]:
        if self.store_dir is None:
            return None
        sig = space.signature()
        key = (tuple(sig), str(program))
        with self._lock:
            st = self._stores.get(key)
        if st is not None:
            return st
        # construct OUTSIDE the registry lock (the initial base/seg
        # disk scan can be large — the _join_group rule: a new
        # tenant's construction wall must not stall every other op),
        # double-checked insert under it.  The eval signature is the
        # tenant-declared program token: tenants naming the same
        # program (and space) share rows; different tokens never
        # collide.  A losing racer's instance never touched disk
        # (the segment opens lazily on first append) — just close it.
        new = open_store(self.store_dir, sig,
                         ["ut-serve", str(program)])
        with self._lock:
            st = self._stores.get(key)
            if st is None:
                self._stores[key] = st = new
        if st is not new:
            new.close()
        return st

    def _join_group(self, space, arms, sense: str,
                    history_capacity: int, seed: int, store,
                    session_id: Optional[str] = None) -> Session:
        """Join a free slot in an existing group for this key, or
        construct a new group and join it.  Group construction
        allocates and seeds the stacked state — it runs under a PER-KEY
        construction lock, never the registry lock, so a new tenant's
        construction wall stalls only same-key joiners, not the rest of
        the serving plane."""
        key = group_key(space, arms, sense, history_capacity)
        with self._lock:
            klock = self._glocks.setdefault(key, threading.Lock())
        while True:
            with self._lock:
                frees = [g for g in self._groups.setdefault(key, [])
                         if g.n_free]
            for g in frees:
                try:
                    return g.join(seed, store=store,
                                  session_id=session_id)
                except IndexError:
                    continue    # lost the last slot to a racing join
            with klock:
                with self._lock:
                    if any(g.n_free for g in self._groups[key]):
                        continue    # a slot freed while we waited
                g = SessionGroup(space, self.slots, arms=arms,
                                 sense=sense,
                                 history_capacity=history_capacity,
                                 device=self.device)
                with self._lock:
                    self._groups[key].append(g)
                obs.count("serve.groups_created")

    # -- crash recovery (serve/durable.py) -------------------
    def _recover(self) -> None:
        """Restore every live checkpointed session (reaping closed
        ones) before the listener binds: a resuming client's attach
        can never observe a half-recovered registry.  Each restore
        replays the commit stream through the group's propose/commit
        slot primitives — signatures with more survivors than
        one group's slots simply allocate further groups, exactly as
        live opens do."""
        t0 = time.perf_counter()
        for sid, bundle in self.ckpt.scan():
            if bundle["closed"] or bundle["open"] is None:
                self.ckpt.reap(sid)
                continue
            try:
                self._restore_session(sid, bundle)
                self.recovered += 1
            except Exception:
                # one corrupt/unplaceable segment must not take down
                # every other tenant's recovery; the segment is kept
                # on disk for post-mortem
                log.exception("[%s] failed to restore session %s",
                              self.WIRE_NAME, sid)
                obs.count("serve.recover_errors")
        self.recovery_s = round(time.perf_counter() - t0, 3)
        if self.recovered:
            log.info("[%s] recovered %d session(s) in %.2fs from %s",
                     self.WIRE_NAME, self.recovered, self.recovery_s,
                     self.ckpt.root)
        obs.gauge("serve.recovered", self.recovered)

    def _restore_session(self, sid: str, bundle: dict) -> None:
        o = bundle["open"]
        space = space_from_params(o["space"])
        store = (self._store_for(space, str(o.get("program", "")))
                 if o.get("store") else None)
        with self._lock:
            if self._admitted >= self.max_sessions:
                raise RequestError(
                    f"server full ({self.max_sessions} sessions)")
            self._admitted += 1
        try:
            sess = self._join_group(
                space, o.get("arms"), str(o.get("sense", "min")),
                int(o.get("hist", 1 << 10)), int(o.get("seed", 0)),
                store, session_id=sid)
            for rec in bundle["commits"]:
                sess._replay_commit(decode_raw(rec["raw"]))
            if bundle["commits"]:
                sess._restore_host(bundle["commits"][-1],
                                   uuid.uuid4().hex[:8])
            else:
                sess._mark_restored(uuid.uuid4().hex[:8])
            sess.durable = self.ckpt
            with self._lock:
                self._sessions[sess.id] = sess
                # restored tenants start disconnected: the orphan
                # clock runs until their client re-attaches
                self._orphans[sess.id] = time.time()
                obs.gauge("serve.sessions.active", self.n_sessions)
        except BaseException:
            with self._lock:
                self._admitted -= 1
            raise

    def _sweep_orphans(self) -> None:
        """Close durable sessions whose client disconnected more than
        orphan_ttl ago (lazily, from the open/attach/stats paths):
        resume stays lossless inside the grace window, and a dead
        tenant stops pinning its slot + admission unit forever."""
        if self.ckpt is None or not self._orphans:
            return
        now = time.time()
        with self._lock:
            expired = [sid for sid, t in self._orphans.items()
                       if now - t > self.orphan_ttl]
            for sid in expired:
                self._orphans.pop(sid, None)
        for sid in expired:
            self.handle({"op": "close", "session": sid})
            obs.count("serve.orphans_reaped")

    def _session(self, req: dict) -> Session:
        sid = req.get("session")
        sess = self._sessions.get(sid)
        if sess is None:
            raise RequestError(f"unknown session {sid!r}")
        # activity cancels orphanhood: a recovered session driven
        # without an explicit attach (in-process callers, a client
        # whose attach was lost) must not be swept mid-drive.  One
        # truthy check on the hot path; the lock only when a clock is
        # actually running
        if self._orphans and self.ckpt is not None:
            with self._lock:
                self._orphans.pop(sess.id, None)
        return sess

    @property
    def n_sessions(self) -> int:
        return len(self._sessions)

    # -- ops -----------------------------------------------------------
    def _op_ping(self, req: dict) -> dict:
        return {"t": time.time(), "sessions": self.n_sessions}

    def _op_open(self, req: dict) -> dict:
        records = req.get("space")
        if not isinstance(records, list) or not records:
            raise RequestError("open needs 'space': a non-empty list "
                               "of param records")
        try:
            space = space_from_params(records)
        except (KeyError, TypeError, ValueError) as e:
            raise RequestError(f"bad space records: {e}")
        sense = req.get("sense", "min")
        if sense not in ("min", "max"):
            raise RequestError(f"sense must be min|max: {sense!r}")
        arms = req.get("arms")
        if arms is not None and not (
                isinstance(arms, list)
                and all(isinstance(a, str) for a in arms)):
            raise RequestError("arms must be a list of technique names")
        try:
            hist = int(req.get("history_capacity", 1 << 10))
            seed = int(req.get("seed", 0))
        except (TypeError, ValueError) as e:
            raise RequestError(
                f"history_capacity/seed must be integers: {e}")
        program = str(req.get("program", ""))
        use_store = str(req.get("store", "on")).lower() not in (
            "off", "false", "0")
        # a resuming client may propose its own durable session id so
        # a retried open (reply lost mid-exchange) re-attaches instead
        # of leaking a second session.  The id becomes a checkpoint
        # filename: constrain its shape
        sid = req.get("session")
        if sid is not None:
            if not isinstance(sid, str) or not _SID_OK.match(sid):
                raise RequestError(
                    "session id must match [A-Za-z0-9_-]{1,64}")
            with self._lock:
                existing = self._sessions.get(sid)
                if existing is not None:
                    # idempotent re-open = an attach: the resuming
                    # client is live again, so its orphan clock (a
                    # lost-reply disconnect may have started it) stops
                    self._orphans.pop(sid, None)
            if existing is not None:
                return self._attach_payload(existing)
        self._sweep_orphans()
        # admission is a reserve-then-join two-step so the (possibly
        # compiling) join runs outside the registry lock without
        # letting racing opens overshoot max_sessions
        with self._lock:
            if self._admitted >= self.max_sessions:
                raise RequestError(
                    f"server full ({self.max_sessions} sessions)")
            self._admitted += 1
        try:
            store = (self._store_for(space, program) if use_store
                     else None)
            try:
                sess = self._join_group(space, arms, sense, hist,
                                        seed, store, session_id=sid)
            except ValueError as e:     # e.g. no arm supports space
                raise RequestError(str(e))
            if self.ckpt is not None:
                # the open record is durable BEFORE the reply: a
                # session a client ever heard about is recoverable
                self.ckpt.append(sess.id, {
                    "ev": "open", "t": round(time.time(), 3),
                    "space": records, "seed": seed,
                    "program": program, "sense": sense, "arms": arms,
                    "hist": hist, "store": store is not None})
                sess.durable = self.ckpt
            with self._lock:
                cur = self._sessions.get(sess.id)
                if cur is None:
                    self._sessions[sess.id] = sess
                obs.gauge("serve.sessions.active", self.n_sessions)
            if cur is not None:
                # lost an id race with a concurrent open/attach: fold
                # into the winner (the loser's durable mark is cleared
                # first so closing it cannot reap the winner's segment)
                sess.durable = None
                sess.close()
                with self._lock:
                    self._admitted -= 1
                    self._orphans.pop(cur.id, None)
                return self._attach_payload(cur)
        except BaseException:
            with self._lock:
                self._admitted -= 1
            raise
        return self._attach_payload(sess)

    def _attach_payload(self, sess: Session) -> dict:
        grp = sess.group
        return {"session": sess.id, "slots": grp.n_slots,
                "batch": grp.batch, "store": sess.store is not None,
                "version": sess.version, "incarn": sess.incarn,
                "durable": self.ckpt is not None}

    def _op_attach(self, req: dict) -> dict:
        """Re-attach a resuming client to its durable session id
        (after a reconnect or a server restart): clears the orphan
        clock, transfers connection ownership (via _on_response), and
        returns the open-shaped payload including the session's
        current version and incarnation token."""
        self._sweep_orphans()
        sess = self._session(req)
        with self._lock:
            self._orphans.pop(sess.id, None)
        obs.count("serve.attaches")
        return self._attach_payload(sess)

    def _op_ask(self, req: dict) -> dict:
        sess = self._session(req)
        try:
            n = int(req.get("n", 1))
        except (TypeError, ValueError) as e:
            raise RequestError(f"n must be an integer: {e}")
        t0 = time.perf_counter()
        reissued = False
        try:
            if req.get("reissue"):
                # the resume path: an ask whose reply was lost already
                # ticketed rows out — re-offer the outstanding tickets
                # first so the epoch can settle (new rows only once
                # nothing is outstanding)
                offers = sess.outstanding()
                reissued = bool(offers)
                if not offers:
                    offers = sess.ask(n)
            else:
                offers = sess.ask(n)
        except StaleTicketError as e:
            # a concurrent close between the registry fetch and the
            # ask is a routine client-side race, not a server fault
            raise RequestError(str(e))
        obs.observe("serve.ask_ms", (time.perf_counter() - t0) * 1e3)
        if reissued:
            obs.count("serve.reissues")
        version, served = sess.version, sess.store_served
        incarn = sess.incarn
        out = WireReply(
            ok=True,
            trials=[{"ticket": o.ticket, "config": o.config,
                     "epoch": o.epoch} for o in offers],
            version=version, store_served=served,
            incarn=incarn, reissued=reissued)
        if all(o.canon is not None for o in offers):
            # preserialized reply: each offer's canonical
            # config JSON was computed once, at the epoch's dedup
            # scan — a k-wide ask splices k cached fragments instead
            # of re-encoding k config dicts, and a batch frame
            # splices this whole text in turn.  canon_config is
            # value-identical to the raw dict for wire-decoded
            # configs (sorted keys only), so text == dict holds.
            rows = ",".join(
                '{"ticket":%d,"config":%s,"epoch":%d}'
                % (o.ticket, o.canon, o.epoch) for o in offers)
            out.wire_text = (
                '{"ok":true,"trials":[%s],"version":%d,'
                '"store_served":%d,"incarn":%s,"reissued":%s}'
                % (rows, version, served, _enc(incarn),
                   "true" if reissued else "false"))
        return out

    def _op_tell(self, req: dict) -> dict:
        """Single tell (`ticket` + `qor`) or a batch in one round trip
        (`results`: list of {ticket, qor[, dur]} objects) — a tenant
        measuring trials in parallel reports them all at once.  The
        `results` form is the legacy spelling of `tell_many` and
        routes through the same vectorized one-lock-hold path."""
        if "results" in req:
            return self._op_tell_many(req)
        if "ticket" not in req:
            raise RequestError("tell needs 'ticket' or 'results'")
        sess = self._session(req)
        t0 = time.perf_counter()
        # a SINGLE tell keeps the hard ok=False contract: a stale or
        # malformed tell is the whole op's error
        try:
            one = sess.tell(int(req["ticket"]), req.get("qor"),
                            float(req.get("dur", 0.0)),
                            epoch=req.get("epoch"),
                            incarn=req.get("incarn"))
        except StaleTicketError as e:
            raise RequestError(str(e))
        except (KeyError, TypeError, ValueError, AttributeError) as e:
            raise RequestError(f"bad tell payload: {e}")
        dup = bool(one.get("duplicate"))
        out = {"told": 0 if dup else 1,
               "new_best": False if dup else one["new_best"],
               "committed": one["committed"],
               "duplicates": 1 if dup else 0,
               "version": one["version"]}
        obs.observe("serve.tell_ms", (time.perf_counter() - t0) * 1e3)
        return out

    def _op_tell_many(self, req: dict) -> dict:
        """The vectorized batch tell: every row applies in
        ONE group-lock hold and the whole batch is acked behind ONE
        checkpoint drain.  Element-wise error walls — one bad/stale
        ticket must not discard the progress of the others (they are
        already told server-side; reporting ok=False would strand the
        epoch): per-row failures come back in `errors`."""
        sess = self._session(req)
        batch = req.get("results")
        if not isinstance(batch, list):
            raise RequestError("'results' must be a list")
        t0 = time.perf_counter()
        out = sess.tell_many(batch, incarn=req.get("incarn"))
        obs.observe("serve.tell_ms", (time.perf_counter() - t0) * 1e3)
        return out

    def _op_best(self, req: dict) -> dict:
        return self._session(req).best()

    def _op_close(self, req: dict) -> dict:
        sess = self._session(req)
        sess.close()
        with self._lock:
            if self._sessions.pop(sess.id, None) is not None:
                self._admitted -= 1
            self._orphans.pop(sess.id, None)
            self._owners.pop(sess.id, None)
            obs.gauge("serve.sessions.active", self.n_sessions)
        return {"closed": sess.id}

    def _op_metrics(self, req: dict) -> dict:
        """The obs-plane scrape (metrics
        snapshot() was written as the future session-server payload).
        ``"format": "prometheus"`` returns the text exposition instead
        (docs/SERVING.md), so a textfile collector / sidecar exporter
        can relay the registry without learning the JSON schema."""
        fmt = str(req.get("format", "json")).lower()
        out: Dict[str, Any] = {
            "sessions": self.n_sessions,
            "uptime_s": round(time.time() - self.started_unix, 3)}
        if fmt == "prometheus":
            out["metrics_text"] = obs.prometheus_text()
        elif fmt == "json":
            out["metrics"] = obs.metrics_snapshot()
        else:
            raise RequestError(
                f"metrics format must be json|prometheus: {fmt!r}")
        return out

    # health-op defaults: a serve tenant's epochs are narrow (batch
    # rows, not driver tickets), so the stall bar sits far below the
    # driver-side QualityConfig default; request fields override
    HEALTH_STALL_TELLS = 64
    HEALTH_FAIL_RATE_HI = 0.5
    HEALTH_MAX_SESSIONS = 64
    HEALTH_LIMIT_CAP = 1024

    def _op_health(self, req: dict) -> dict:
        """Per-session search-quality verdicts: with a
        ``session`` field, that tenant's health; without, a bounded
        roll-up over every live session — what a sharded front tier
        (ROADMAP item 1) polls to decide placement/eviction.  Optional
        ``stall_tells`` / ``fail_rate_hi`` override the thresholds for
        this request only; ``limit`` bounds the roll-up payload
        (default 64, capped at ``HEALTH_LIMIT_CAP`` so one request
        can never serialize an unbounded session table —
        docs/SERVING.md)."""
        try:
            stall = int(req.get("stall_tells", self.HEALTH_STALL_TELLS))
            frh = float(req.get("fail_rate_hi",
                                self.HEALTH_FAIL_RATE_HI))
            limit = int(req.get("limit", self.HEALTH_MAX_SESSIONS))
        except (TypeError, ValueError) as e:
            raise RequestError(
                f"stall_tells/fail_rate_hi/limit must be numbers: {e}")
        if not 1 <= limit <= self.HEALTH_LIMIT_CAP:
            raise RequestError(
                f"limit must be in [1, {self.HEALTH_LIMIT_CAP}]: "
                f"{limit}")
        if req.get("session") is not None:
            return {"health": self._session(req).health(
                stall_tells=stall, fail_rate_hi=frh)}
        with self._lock:
            sessions = list(self._sessions.values())
        rows = [s.health(stall_tells=stall, fail_rate_hi=frh)
                for s in sessions]
        by_status: Dict[str, int] = {}
        for r in rows:
            by_status[r["status"]] = by_status.get(r["status"], 0) + 1
        # bounded payload: worst-first (failing, stalled, cold, ok) so
        # a truncated roll-up still surfaces every unhealthy tenant
        # ahead of the healthy tail
        rank = {"failing": 0, "stalled": 1, "cold": 2, "ok": 3}
        rows.sort(key=lambda r: (rank.get(r["status"], 4),
                                 r["session"]))
        return {"sessions": len(rows), "by_status": by_status,
                "truncated": len(rows) > limit,
                "health": rows[:limit]}

    def _op_stats(self, req: dict) -> dict:
        with self._lock:
            groups = [{"space": g.key[0][0][:60] if g.key[0] else "",
                       "slots": g.n_slots, "active": g.n_active,
                       "batch": g.batch}
                      for gs in self._groups.values() for g in gs]
            # keyed program@scope-prefix: two stores sharing a program
            # token over DIFFERENT spaces must not overwrite each
            # other in the payload (scope hashes space sig + program)
            stores = {f"{k[1] or '<anon>'}@{s.scope[:10]}": s.stats()
                      for k, s in self._stores.items()}
        out = {"sessions": self.n_sessions, "groups": groups,
               "stores": stores, "store_dir": self.store_dir}
        if req.get("sessions"):
            # the front-tier router's attach probe (serve/router.py):
            # an id the router no longer remembers is located by
            # asking each shard which durable sessions it owns
            with self._lock:
                out["session_ids"] = sorted(self._sessions)
        if self.ckpt is not None:
            self._sweep_orphans()
            with self._lock:
                orphans = len(self._orphans)
            out["durable"] = {**self.ckpt.stats(),
                              "recovered": self.recovered,
                              "recovery_s": self.recovery_s,
                              "orphans": orphans,
                              "orphan_ttl": self.orphan_ttl}
        return out

    _OPS = {"ping": _op_ping, "open": _op_open, "attach": _op_attach,
            "ask": _op_ask, "tell": _op_tell,
            "tell_many": _op_tell_many, "best": _op_best,
            "close": _op_close, "metrics": _op_metrics,
            "stats": _op_stats, "health": _op_health}

    # -- wire hooks (serve/wire.py owns dispatch + the TCP loops) ------
    def _listen_banner(self) -> str:
        return (f" (slots={self.slots}, max-sessions="
                f"{self.max_sessions}, store={self.store_dir or 'off'})")

    def _conn_opened(self, conn, addr) -> set:
        # session lifetime is CONNECTION-scoped: ids opened here are
        # reaped when the connection dies, so a crashed tenant cannot
        # hold its group slot and admission unit forever (a long-lived
        # server would otherwise leak to "server full" under client
        # churn).  Tracked at the transport layer — handle() stays
        # transport-free and in-process sessions are unaffected.
        return set()

    def _on_response(self, owned: set, req: dict, resp: dict) -> None:
        if resp.get("ok") and isinstance(req, dict):
            if req.get("op") in ("open", "attach"):
                sid = resp["session"]
                owned.add(sid)
                with self._lock:
                    # ownership MOVES to this connection, and a live
                    # owner means no orphan clock is running
                    self._owners[sid] = id(owned)
                    self._orphans.pop(sid, None)
            elif req.get("op") == "close":
                owned.discard(resp.get("closed"))

    def _conn_closed(self, owned: set) -> None:
        for sid in owned:   # best-effort: never raises
            if self.ckpt is not None:
                # durable sessions get an orphan grace window instead
                # of the instant reap: a resuming client re-attaches
                # (clearing the clock); a dead one is swept lazily
                # after orphan_ttl.  Only the CURRENT owner may start
                # the clock — a lingering old connection dying after
                # its client re-attached elsewhere owns nothing here
                with self._lock:
                    if (sid in self._sessions
                            and self._owners.get(sid) == id(owned)):
                        self._orphans[sid] = time.time()
                        self._owners.pop(sid, None)
            else:
                self.handle({"op": "close", "session": sid})

    def stop(self) -> None:
        super().stop()      # listener + live connections
        # snapshot under _lock: handler threads may still be mutating
        # the registry (an open inside _store_for) while shutdown
        # walks it
        with self._lock:
            stores = list(self._stores.values())
        for st in stores:
            st.close()
