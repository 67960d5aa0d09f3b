"""RemoteStore: the networked client half of the cooperative search
fabric — drop-in for `ResultStore` wherever one plugs in today,
speaking the store/server.py wire ops over one TCP connection.

Counterpart of `uptune_tpu/store/remote.py`: the same rows, keys and
wire frames, so a port client and a JAX-package client share one
server (either package's) and read each other's rows.  Host Python
only: the client imports neither torch nor numpy.

Design rule: the tuning loop must NEVER block on the network.  A
`record()` is a local-table insert plus a bounded enqueue; one daemon
flusher thread owns the socket and ships queued rows batch-wise,
ack-gated, with reconnect backoff — the TelemetryShipper discipline
(obs/ship.py) applied to result rows:

* bounded queue sheds the OLDEST rows with explicit ``dropped``
  accounting (newest rows carry the most evidence),
* in-flight rows stay owned by the flusher until the server acks them,
  so a connection death mid-batch replays them after reconnect — the
  server's content-key dedup makes that replay idempotent,
* a dead server degrades the store to local-only (lookups/exchange
  serve the local table; queued rows wait) instead of stalling tells,
  and a recovered server drains the backlog transparently.

Reads are local-first: `lookup()` consults the in-memory table (rows
pulled from the server plus everything recorded locally) and only pays
one wire round-trip on a miss while connected.  `refresh()` is the
``delta`` op — the `pop_fresh_rows` fresh-foreign contract holds
exactly: rows pulled during the INITIAL open sync are a previous run's
results (warm start's job), only rows arriving after open feed the
exchange plane.
"""
from __future__ import annotations

import json
import logging
import os
import socket
import threading
import time
from typing import Any, Dict, List, Optional, Sequence, Tuple

from .. import obs
from ..obs.ship import backoff_jitter
from ..utils.net import reject_self_connect
from .keys import eval_signature, scope_id, trial_key
from .store import _finite

log = logging.getLogger("uptune_tpu_torch")

__all__ = ["RemoteStore", "parse_addr", "QUEUE_MAX", "BATCH_MAX"]

QUEUE_MAX = 1024                # bounded write-behind (rows)
BATCH_MAX = 64                  # rows shipped per flush pass
BACKOFF_BASE = 0.25
BACKOFF_MAX = 5.0
CONNECT_TIMEOUT = 3.0
OP_TIMEOUT = 10.0


def parse_addr(addr: str) -> Tuple[str, int]:
    """``tcp://HOST:PORT`` (or bare ``HOST:PORT``) -> (host, port)."""
    a = str(addr).strip()
    if a.startswith("tcp://"):
        a = a[len("tcp://"):]
    host, sep, ptxt = a.rpartition(":")
    if not sep or not host or "/" in host:
        raise ValueError(
            f"store address must be tcp://HOST:PORT: {addr!r}")
    try:
        port = int(ptxt)
    except ValueError:
        raise ValueError(
            f"store address port is not a number: {addr!r}")
    if not 1 <= port <= 65535:
        raise ValueError(f"store address port out of range: {addr!r}")
    return host, port


class RemoteStore:
    """One process's handle on a shared `StoreServer` — the
    `ResultStore` public surface (lookup/record/refresh/scope_rows/
    best_row/pop_fresh_rows/stats/close) over TCP with local
    write-behind.

    Lock order: ``_lock`` (table + counters) -> ``_qlock`` (queue
    leaf); ``_wire_lock`` serializes socket use and is NEVER held
    while ``_lock`` is wanted (wire I/O happens with the table lock
    released, so a slow server cannot stall a lookup)."""

    def __init__(self, addr: str, space_sig: Sequence[str], command,
                 *, stage: int = 0,
                 extra_files: Optional[Sequence[str]] = None,
                 env: Optional[Dict[str, str]] = None,
                 refresh_interval: float = 2.0,
                 fsync: Optional[bool] = None,
                 queue_max: int = QUEUE_MAX,
                 batch_max: int = BATCH_MAX,
                 connect_timeout: float = CONNECT_TIMEOUT,
                 op_timeout: float = OP_TIMEOUT,
                 backoff_base: float = BACKOFF_BASE,
                 backoff_max: float = BACKOFF_MAX):
        del fsync   # durability is the SERVER's contract (--fsync there)
        self.addr = str(addr)
        self.host, self.port = parse_addr(addr)
        self.eval_sig = eval_signature(command, stage,
                                       extra_files=extra_files, env=env)
        self.scope = scope_id(list(space_sig), self.eval_sig)
        self.refresh_interval = float(refresh_interval)
        self.instance = f"{os.getpid():d}-{os.urandom(4).hex()}"
        self.queue_max = int(queue_max)
        self.batch_max = int(batch_max)
        self.connect_timeout = float(connect_timeout)
        self.op_timeout = float(op_timeout)
        self.backoff_base = float(backoff_base)
        self.backoff_max = float(backoff_max)
        self._lock = threading.RLock()
        self._qlock = threading.Lock()
        self._wire_lock = threading.Lock()
        self._sock: Optional[socket.socket] = None
        self._file = None
        self._rid = 0
        self._rows: Dict[str, Dict[str, Any]] = {}
        self._fresh_foreign: set = set()
        self._queue: List[Dict[str, Any]] = []
        self._pending: List[Dict[str, Any]] = []   # flusher-owned batch
        self._wake = threading.Event()
        self._stop = threading.Event()
        self._cursor = 0
        self._incarn: Optional[str] = None
        self._last_refresh = 0.0
        self._closed = False
        self.hits = 0
        self.misses = 0
        self.recorded = 0
        self.foreign_rows = 0
        self.dropped = 0            # write-behind rows shed (bounded queue)
        self.acked = 0              # rows the server durably acked
        self.connects = 0
        self.failures = 0
        # open: one dial attempt; a dead server at open is LOUD (the
        # user asked for a shared store and is getting local-only) but
        # never fatal — the flusher keeps retrying in the background
        try:
            with self._wire_lock:
                self._connect()
            self._initial_sync()
        except (OSError, ValueError) as e:
            log.warning(
                "[ut] remote store %s unreachable at open (%s): "
                "degrading to local-only; queued rows will ship if the "
                "server comes back", self.addr, e)
        self._flusher = threading.Thread(
            target=self._loop, name="ut-rstore-flush", daemon=True)
        self._flusher.start()

    # -- wire ----------------------------------------------------------
    @property
    def connected(self) -> bool:
        return self._sock is not None

    def _connect(self) -> None:
        """Dial + hello (caller holds ``_wire_lock`` or is __init__
        before the flusher starts)."""
        sock = socket.create_connection(
            (self.host, self.port), timeout=self.connect_timeout)
        try:
            # the localhost-ephemeral-port self-connect hazard the
            # serve client and shipper already guard against
            reject_self_connect(sock, f"store {self.addr}")
            sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            sock.settimeout(self.op_timeout)
            f = sock.makefile("rwb")
            self._sock, self._file = sock, f
            resp = self._request({"op": "hello",
                                  "client": self.instance,
                                  "scope": self.scope})
            incarn = resp.get("incarn")
            with self._lock:
                if incarn != self._incarn:
                    # new server incarnation: our delta cursor indexes
                    # a dead append order — restart it (the local
                    # table dedups the re-pull)
                    self._cursor = 0
                    self._incarn = incarn
                self.connects += 1
        except BaseException:
            self._sock = self._file = None
            try:
                sock.close()
            except OSError:
                pass
            raise
        obs.count("rstore.connects")

    def _drop_conn(self) -> None:
        sock, self._sock, self._file = self._sock, None, None
        if sock is not None:
            try:
                sock.close()
            except OSError:
                pass

    def _request(self, payload: Dict[str, Any]) -> Dict[str, Any]:
        """One request/response on the live connection (caller holds
        ``_wire_lock`` or is __init__).  Raises OSError on any
        transport or protocol failure so every caller's degrade path
        is uniform."""
        if self._file is None:
            raise OSError("remote store not connected")
        self._rid += 1
        payload = dict(payload, id=self._rid)
        try:
            self._file.write(json.dumps(
                payload, separators=(",", ":")).encode() + b"\n")
            self._file.flush()
            line = self._file.readline()
        except (OSError, ValueError) as e:
            raise OSError(f"remote store I/O failed: {e}")
        if not line:
            raise OSError("remote store closed the connection")
        try:
            resp = json.loads(line)
        except json.JSONDecodeError as e:
            raise OSError(f"remote store sent a malformed reply: {e}")
        if not isinstance(resp, dict) or not resp.get("ok"):
            err = resp.get("error") if isinstance(resp, dict) else line
            raise OSError(f"remote store refused "
                          f"{payload.get('op')}: {err}")
        return resp

    def _initial_sync(self) -> None:
        """Pull the scope's existing rows at open.  These are a
        previous run's results: merged as NON-fresh so warm start sees
        them via `scope_rows()` but the exchange plane does not re-pull
        history as migration (the ResultStore ``_loading`` rule)."""
        n = self._pull_delta(fresh=False)
        if n:
            log.info("[ut] remote store %s: synced %d existing row(s)",
                     self.addr, n)

    def _pull_delta(self, fresh: bool) -> int:
        """Loop the ``delta`` op until drained (caller must NOT hold
        ``_lock``; takes ``_wire_lock``)."""
        total = 0
        with self._wire_lock:
            if self._sock is None:
                return 0
            more = True
            while more:
                with self._lock:
                    cur, inc = self._cursor, self._incarn
                resp = self._request({"op": "delta", "scope": self.scope,
                                      "cursor": cur, "incarn": inc,
                                      "src": self.instance})
                rows = resp.get("rows") or []
                with self._lock:
                    self._cursor = int(resp.get("cursor", cur))
                    self._incarn = resp.get("incarn", inc)
                    for row in rows:
                        if self._merge_foreign(row, fresh):
                            total += 1
                more = bool(resp.get("more")) and bool(rows)
        return total

    def _merge_foreign(self, row: Any, fresh: bool) -> bool:
        """First-finite-wins merge of a server row (caller holds
        ``_lock``)."""
        if not isinstance(row, dict):
            return False
        k = row.get("k")
        if not isinstance(k, str):
            return False
        cur = self._rows.get(k)
        if cur is not None and (_finite(cur.get("qor"))
                                or not _finite(row.get("qor"))):
            return False
        self._rows[k] = row
        self.foreign_rows += 1
        if fresh:
            self._fresh_foreign.add(k)
        return True

    # -- ResultStore surface: reads ------------------------------------
    def __len__(self) -> int:
        with self._lock:
            return len(self._rows)

    def __bool__(self) -> bool:
        # An open-but-empty store must stay truthy: ``if store:`` call
        # sites would otherwise never record the first row.
        return True

    def lookup(self, cfg: Dict[str, Any]) -> Optional[Dict[str, Any]]:
        """Local table first; one wire lookup on a local miss while
        connected (a foreign sibling may have measured this config
        since the last delta pull)."""
        k = trial_key(self.scope, cfg)
        with self._lock:
            row = self._rows.get(k)
            if row is not None and _finite(row.get("qor")):
                self.hits += 1
                obs.count("store.hits")
                return row
        if self._sock is not None:
            try:
                with self._wire_lock:
                    if self._sock is not None:
                        resp = self._request({"op": "lookup", "k": k})
                        row = resp.get("row")
                    else:
                        row = None
            except OSError:
                with self._wire_lock:
                    self._drop_conn()
                row = None
            if isinstance(row, dict) and _finite(row.get("qor")):
                with self._lock:
                    # remote hit: cache it, NOT fresh (a served memo
                    # is not an elite-migration event)
                    self._merge_foreign(row, fresh=False)
                    self.hits += 1
                    obs.count("store.hits")
                return row
        with self._lock:
            self.misses += 1
            obs.count("store.misses")
            return None

    def scope_rows(self) -> List[Dict[str, Any]]:
        with self._lock:
            return [r for r in self._rows.values()
                    if r.get("scope") == self.scope
                    and _finite(r.get("qor"))]

    def best_row(self, sense: str = "min") -> Optional[Dict[str, Any]]:
        rows = self.scope_rows()
        if not rows:
            return None
        pick = min if sense == "min" else max
        return pick(rows, key=lambda r: float(r["qor"]))

    def pop_fresh_rows(self) -> List[Dict[str, Any]]:
        """Finite in-scope rows pulled from the server since open (the
        elite-migration feed); consuming clears the set."""
        with self._lock:
            if not self._fresh_foreign:
                return []
            keys, self._fresh_foreign = self._fresh_foreign, set()
            out = []
            for k in keys:
                r = self._rows.get(k)
                if r is not None and r.get("scope") == self.scope \
                        and _finite(r.get("qor")):
                    out.append(r)
            return out

    def refresh(self) -> int:
        """Pull the server's delta feed (reconnect handled by the
        flusher, not here — refresh on a dead connection is a cheap
        no-op, never a dial)."""
        self._last_refresh = time.monotonic()
        try:
            with obs.span("store.refresh") as sp:
                n = self._pull_delta(fresh=True)
                sp.set(rows=n)
            return n
        except OSError as e:
            with self._wire_lock:
                self._drop_conn()
            log.debug("[ut] remote store %s refresh failed: %s",
                      self.addr, e)
            return 0

    def maybe_refresh(self) -> int:
        if time.monotonic() - self._last_refresh < self.refresh_interval:
            return 0
        return self.refresh()

    # -- ResultStore surface: writes -----------------------------------
    def record(self, cfg: Dict[str, Any], qor: Optional[float],
               dur: float = 0.0, *, u: Optional[Sequence[float]] = None,
               perms: Optional[Sequence[Sequence[int]]] = None,
               source: str = "") -> Optional[Dict[str, Any]]:
        """Local-table insert + bounded enqueue; NEVER dials or blocks
        on the wire (the tell path's latency contract).  Returns the
        row, or None on idempotent re-records — the ResultStore
        contract exactly."""
        with self._lock:
            k = trial_key(self.scope, cfg)
            cur = self._rows.get(k)
            if cur is not None and (_finite(cur.get("qor"))
                                    or not _finite(qor)):
                return None
            row: Dict[str, Any] = {
                "k": k, "scope": self.scope, "cfg": cfg,
                "qor": (float(qor) if _finite(qor) else None),
                "dur": round(float(dur), 6), "t": round(time.time(), 3),
                "src": source or self.instance,
            }
            if u is not None:
                row["u"] = [float(x) for x in u]
            if perms is not None:
                row["perms"] = [[int(i) for i in p] for p in perms]
            self._rows[k] = row
            self.recorded += 1
            obs.count("store.recorded")
        self._offer(row)
        return row

    def _offer(self, row: Dict[str, Any]) -> None:
        """Bounded enqueue under the queue leaf lock, shedding the
        OLDEST row when full (the shipper's drop rule: newest evidence
        wins) with explicit accounting."""
        with self._qlock:
            self._queue.append(row)
            while len(self._queue) > self.queue_max:
                self._queue.pop(0)
                self.dropped += 1
                obs.count("rstore.client_dropped")
        self._wake.set()

    def ingest_archive(self, path: str) -> int:
        """Replay a driver jsonl trial archive through record() (rows
        ship to the server like any other)."""
        n = 0
        try:
            with open(path, "rb") as f:
                for line in f:
                    if not line.endswith(b"\n"):
                        break   # torn tail
                    try:
                        rec = json.loads(line)
                    except json.JSONDecodeError:
                        break
                    if "cfg" not in rec:
                        continue   # space_sig header row
                    if self.record(rec["cfg"], rec.get("qor"),
                                   rec.get("time", 0.0),
                                   u=rec.get("u"), perms=rec.get("perms"),
                                   source="archive") is not None:
                        n += 1
        except OSError:
            return n
        return n

    # -- flusher -------------------------------------------------------
    def _loop(self) -> None:
        """The write-behind daemon (obs/ship.py discipline): wait for
        work or the poll tick, reconnect with jittered exponential
        backoff, ship ``_pending`` (retried-before-new, ack-gated)."""
        backoff = self.backoff_base
        while True:
            # event-driven with a 0.2s poll floor: a record() wakes the
            # flusher immediately, so sibling processes see new rows at
            # wire latency, not at the poll tick (what makes a tight
            # elite-migration cadence real instead of aspirational)
            self._wake.wait(0.2)
            stopping = self._stop.is_set()
            self._wake.clear()
            with self._qlock:
                have = bool(self._queue) or bool(self._pending)
            if have:
                with self._wire_lock:
                    dead = self._sock is None
                if dead:
                    try:
                        with self._wire_lock:
                            if self._sock is None:
                                self._connect()
                        backoff = self.backoff_base
                        log.info("[ut] remote store %s reconnected",
                                 self.addr)
                    except (OSError, ValueError):
                        with self._lock:
                            self.failures += 1
                        if stopping:
                            break   # terminal: server still dead
                        self._stop.wait(backoff_jitter(backoff))
                        backoff = min(backoff * 2, self.backoff_max)
                        continue
                try:
                    self._flush()
                    backoff = self.backoff_base
                except OSError as e:
                    with self._wire_lock:
                        self._drop_conn()
                    with self._lock:
                        self.failures += 1
                    log.debug("[ut] remote store %s flush failed: %s",
                              self.addr, e)
                    if not stopping:
                        self._stop.wait(backoff_jitter(backoff))
                        backoff = min(backoff * 2, self.backoff_max)
            if stopping:
                # final cut AFTER a flush attempt: rows queued before
                # close() had their chance to ship
                break

    def _flush(self) -> None:
        """Ship up to batch_max rows, ack-gated.  ``_pending`` is
        flusher-owned: rows move queue -> pending under ``_qlock``,
        leave pending only on server ack, and survive a connection
        death for replay after reconnect (the server's content-key
        dedup absorbs re-sends)."""
        while True:
            with self._qlock:
                take = self.batch_max - len(self._pending)
                if take > 0 and self._queue:
                    self._pending.extend(self._queue[:take])
                    del self._queue[:take]
                batch = list(self._pending)
            if not batch:
                return
            with self._wire_lock:
                if self._sock is None:
                    raise OSError("remote store not connected")
                for row in batch:
                    resp = self._request({"op": "record", "row": row})
                    if not resp.get("acked"):
                        raise OSError(
                            f"remote store did not ack row {row['k']}")
                    with self._qlock:
                        # ack-gated removal: identity, not equality —
                        # the queue may hold a same-key retry row
                        self._pending = [r for r in self._pending
                                         if r is not row]
                    with self._lock:
                        self.acked += 1
                    obs.count("rstore.client_acked")

    # -- lifecycle -----------------------------------------------------
    def flush_wait(self, timeout: float = 5.0) -> bool:
        """Best-effort wait until the write-behind queue drains (tests
        and orderly shutdowns; the tuning loop never calls this)."""
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            with self._qlock:
                if not self._queue and not self._pending:
                    return True
            self._wake.set()
            time.sleep(0.02)
        return False

    def compact(self) -> int:
        """Server-side storage is one log; nothing to compact from the
        client.  Returns the local row count for parity."""
        return len(self)

    def close(self) -> None:
        if self._closed:
            return
        self._closed = True
        self._stop.set()
        self._wake.set()
        self._flusher.join(timeout=self.op_timeout)
        with self._wire_lock:
            self._drop_conn()
        with self._qlock:
            left = len(self._queue) + len(self._pending)
        if left:
            log.warning("[ut] remote store %s closed with %d unshipped "
                        "row(s) (server unreachable)", self.addr, left)

    def __enter__(self) -> "RemoteStore":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    def stats(self) -> Dict[str, Any]:
        addr, scope = self.addr, self.scope   # immutable after __init__
        connected = self.connected
        with self._qlock:
            queued = len(self._queue) + len(self._pending)
        with self._lock:
            return {"rows": len(self._rows), "hits": self.hits,
                    "misses": self.misses, "recorded": self.recorded,
                    "foreign_rows": self.foreign_rows,
                    "scope": scope,
                    "remote": {"addr": addr,
                               "connected": connected,
                               "queued": queued,
                               "dropped": self.dropped,
                               "acked": self.acked,
                               "connects": self.connects,
                               "failures": self.failures}}
