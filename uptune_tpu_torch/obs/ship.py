"""Fleet-telemetry shipper: push this process's telemetry streams to
a networked hub (obs/hub.py) over the serve plane's newline-JSON/TCP
wire.

The distributed-obs layer watches one process end to
end but only meets its peers post-mortem — `ut-trace` merges, `.hN`
flight-recorder files, journal files copied by hand.  The reference
shipped the live half as ZMQ/S3 result transport into one global
database every search instance reported into (PAPER.md L1/L4); a
`TelemetryShipper` is this package's equivalent: any process started
with ``--telemetry HOST:PORT`` / ``UT_TELEMETRY`` /
``ut.config({'telemetry': ...})`` pushes, once per interval,

* one **window snapshot** row (`obs.metrics.window_snapshot` — the
  same shape as a flight-recorder row, cut on the shipper's own
  cursor so a local recorder and the hub never fight over windows),
* the **journal rows** emitted since the last window (a
  `journal.add_sink` subscriber),
* every **obs.alert** the quality monitor fired
  (`quality.add_alert_sink`), and
* an optional **health rollup** from a caller-provided callable (the
  serve CLI wires the server's ``{"op": "health"}`` rollup here).

Hot-path contract (the >= 0.95x bar):
``offer()`` is a bounded append under a leaf lock — it NEVER blocks,
never touches a socket, and when the hub is slow or gone the queue
drops its OLDEST rows with explicit accounting (``dropped`` is
carried in every ship request, counted hub-side per source, and
published locally as the ``ship.dropped`` counter).  All socket work
happens on one background daemon thread with
reconnect-plus-exponential-backoff; a dead hub costs the process
nothing but the dropped telemetry.

Durability contract (the fleet kill test): a batch is removed
from the shipper only after the hub ACKS it — and the hub acks only
after appending to its durable fleet timeline — so a SIGKILLed
source loses at most the one in-flight (un-acked) window.
"""
from __future__ import annotations

import json
import os
import random
import socket
import threading
import time
from typing import Any, Callable, Dict, List, Optional

from ..utils.net import reject_self_connect
from . import core, journal, metrics, quality

__all__ = ["TelemetryShipper", "start", "stop", "active",
           "maybe_ship_from_env", "source_label", "backoff_jitter",
           "DEFAULT_INTERVAL", "DEFAULT_QUEUE_MAX",
           "DEFAULT_BATCH_MAX"]

DEFAULT_INTERVAL = 1.0
DEFAULT_QUEUE_MAX = 4096        # queued rows (each ~hundreds of bytes)
DEFAULT_BATCH_MAX = 512         # rows per ship request (ack unit)
BACKOFF_BASE = 0.25
BACKOFF_MAX = 5.0

# reconnect jitter: after a hub restart a whole
# fleet would reconnect in LOCKSTEP on the same 0.25s..5s schedule —
# a thundering herd on the hub accept loop every backoff tick.  Each
# process waits a uniformly drawn fraction [1/2, 1] of its current
# backoff instead; the exponential GROWTH stays deterministic, only
# the wait is spread.  Per-process RNG: the herd decorrelates even
# when every process starts from the same fork image
_JITTER_RNG = random.Random(os.urandom(8))


def backoff_jitter(backoff: float) -> float:
    """The jittered wait for one reconnect backoff step."""
    return float(backoff) * (0.5 + 0.5 * _JITTER_RNG.random())


def source_label(src: Dict[str, Any]) -> str:
    """The hub's source key, rendered: ``host:pid:role``."""
    return f"{src.get('host')}:{src.get('pid')}:{src.get('role')}"


class TelemetryShipper:
    """One process's telemetry push loop.  Construct + ``start()``,
    or use the module-level ``start(addr, role=...)`` registry."""

    def __init__(self, addr: str, role: str = "ut",
                 interval: float = DEFAULT_INTERVAL,
                 queue_max: int = DEFAULT_QUEUE_MAX,
                 batch_max: int = DEFAULT_BATCH_MAX,
                 backoff_base: float = BACKOFF_BASE,
                 backoff_max: float = BACKOFF_MAX,
                 health_provider: Optional[Callable[[], dict]] = None,
                 connect_timeout: float = 5.0):
        host, _, port = str(addr).rpartition(":")
        if not host:
            raise ValueError(
                f"telemetry address must be 'host:port', got {addr!r}")
        self.addr = (host, int(port))
        self.source = {"host": socket.gethostname(),
                       "pid": os.getpid(), "role": str(role)}
        self.interval = max(0.02, float(interval))
        self.queue_max = int(queue_max)
        self.batch_max = max(1, int(batch_max))
        self.backoff_base = float(backoff_base)
        self.backoff_max = float(backoff_max)
        self.health_provider = health_provider
        self.connect_timeout = float(connect_timeout)
        # accounting (read by stats()/tests/bench; ints are GIL-atomic
        # enough for telemetry, exact counts are updated under _qlock)
        self.dropped = 0        # rows shed by the bounded queue
        self.acked = 0          # rows the hub confirmed durable
        self.shipped_batches = 0
        self.connects = 0       # successful connections
        self.failures = 0       # connect/send failures
        self.windows = 0
        self._q: List[Dict[str, Any]] = []
        self._qlock = threading.Lock()      # leaf lock: offer() only
        self._pending: Optional[List[Dict[str, Any]]] = None
        self._cursor: Optional[Dict[str, Any]] = None
        self._last_window_t = time.time()
        self._sock: Optional[socket.socket] = None
        self._file = None
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    # -- hot path ------------------------------------------------------
    def offer(self, kind: str, row: Dict[str, Any]) -> bool:
        """Queue one telemetry row; never blocks, never raises.  At
        capacity the OLDEST queued row is shed (live telemetry favors
        recency) and counted.  Refused after stop() — except from the
        shipper's own final-window cut, which rides `_offer`."""
        if self._stop.is_set():
            return False
        self._offer(kind, row)
        return True

    def _offer(self, kind: str, row: Dict[str, Any]) -> None:
        item = {"kind": kind, "row": row}
        with self._qlock:
            if len(self._q) >= self.queue_max:
                self._q.pop(0)
                self.dropped += 1
                metrics.count("ship.dropped")
            self._q.append(item)

    # journal rows arrive under journal._LOCK — offer's leaf lock keeps
    # the sink O(append); the row is shallow-copied because the shipper
    # serializes it later, on its own thread
    def _journal_sink(self, row: Dict[str, Any]) -> None:
        self.offer("journal", dict(row))

    def _alert_sink(self, rec: Dict[str, Any]) -> None:
        self.offer("alert", dict(rec))

    # -- lifecycle -----------------------------------------------------
    def start(self) -> "TelemetryShipper":
        # shipping implies a live metrics registry (same rule as the
        # serving process: obs stays enabled so windows have content)
        if not core.enabled():
            core.enable()
        journal.add_sink(self._journal_sink)
        quality.add_alert_sink(self._alert_sink)
        self._thread = threading.Thread(
            target=self._loop, name="ut-telemetry-shipper", daemon=True)
        self._thread.start()
        return self

    def stop(self, timeout: float = 5.0) -> None:
        """Final window + best-effort drain, then close.  Idempotent."""
        if self._stop.is_set():
            return
        journal.remove_sink(self._journal_sink)
        quality.remove_alert_sink(self._alert_sink)
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout)
        self._close()

    def stats(self) -> Dict[str, Any]:
        with self._qlock:
            queued = len(self._q)
        return {"source": dict(self.source), "queued": queued,
                "dropped": self.dropped, "acked": self.acked,
                "batches": self.shipped_batches,
                "connects": self.connects, "failures": self.failures,
                "windows": self.windows}

    # -- shipping loop -------------------------------------------------
    def _loop(self) -> None:
        backoff = self.backoff_base
        while True:
            stopping = self._stop.wait(self.interval)
            if not stopping:
                self._cut_window()
            try:
                self._flush()
                backoff = self.backoff_base     # a full flush resets it
            except (OSError, ValueError):
                self.failures += 1
                self._close()
                if not stopping:
                    # reconnect-with-backoff: sleep here (not the hub's
                    # problem), capped, reset on the next success —
                    # jittered so a restarted hub's whole fleet does
                    # not reconnect in lockstep (backoff_jitter)
                    if self._stop.wait(backoff_jitter(backoff)):
                        stopping = True
                    backoff = min(self.backoff_max, backoff * 2)
            if stopping:
                # the terminal cut happens HERE — strictly after
                # stop() is observed, including when it landed during
                # the backoff wait above — so the last window always
                # carries final=true and the terminal counters (the
                # exactness contract's clean-shutdown half)
                self._cut_window(final=True)
                try:
                    self._flush()
                except (OSError, ValueError):
                    self.failures += 1
                self._close()
                return

    def _cut_window(self, final: bool = False) -> None:
        now = time.time()
        row, self._cursor = metrics.window_snapshot(self._cursor)
        row = {"t": round(now, 3),
               "dt": round(now - self._last_window_t, 3), **row}
        self._last_window_t = now
        if final:
            row["final"] = True
        self.windows += 1
        self._offer("window", row)
        if self.health_provider is not None:
            try:
                h = self.health_provider()
            except Exception:   # health is best-effort telemetry
                h = None
            if h:
                self._offer("health", {"t": round(now, 3), **h})

    def _flush(self) -> None:
        """Ship everything queued, one acked batch at a time.  The
        in-flight batch (`_pending`) survives a failed send and is
        retried before new rows — acked-exactly-once from the queue's
        point of view (the hub may see a batch twice only when the ACK
        itself was lost; rows are telemetry windows, so a re-append is
        visible in the timeline, never double-counted in the rollup
        which keys on absolute counters)."""
        while True:
            if self._pending is None:
                with self._qlock:
                    if not self._q:
                        return
                    batch = self._q[:self.batch_max]
                    del self._q[:self.batch_max]
                # assigned OUTSIDE _qlock: _pending is single-owner
                # (only this shipper thread ever touches it), and
                # never writing it under the lock keeps that ownership
                # checkable (R103) instead of looking shared
                self._pending = batch
            self._send_batch(self._pending)
            self.acked += len(self._pending)
            self.shipped_batches += 1
            self._pending = None

    def _send_batch(self, rows: List[Dict[str, Any]]) -> None:
        f = self._ensure_conn()
        with self._qlock:
            # producer threads bump `dropped` under _qlock in _offer;
            # an unlocked read here could tear against that increment
            dropped = self.dropped
        req = {"op": "ship", "source": self.source, "rows": rows,
               "dropped": dropped}
        f.write(json.dumps(req, separators=(",", ":")).encode() + b"\n")
        f.flush()
        line = f.readline()
        if not line:
            raise OSError("hub closed the connection")
        resp = json.loads(line)
        if not resp.get("ok"):
            raise ValueError(
                f"hub rejected batch: {resp.get('error')}")

    def _ensure_conn(self):
        if self._file is not None:
            return self._file
        s = socket.create_connection(self.addr,
                                     timeout=self.connect_timeout)
        reject_self_connect(s, f"{self.addr[0]}:{self.addr[1]}")
        s.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        f = s.makefile("rwb")
        # hello announces the source (and survives hub restarts: every
        # ship request re-carries the source, hello is a courtesy that
        # registers idle processes in `sources` before data flows)
        hello = {"op": "hello", "source": self.source,
                 "start_unix": round(time.time(), 3)}
        f.write(json.dumps(hello, separators=(",", ":")).encode()
                + b"\n")
        f.flush()
        line = f.readline()
        if not line or not json.loads(line).get("ok"):
            try:
                f.close()
                s.close()
            except OSError:
                pass
            raise OSError("hub refused hello")
        self._sock, self._file = s, f
        self.connects += 1
        return f

    def _close(self) -> None:
        if self._file is not None:
            try:
                self._file.close()
                self._sock.close()
            except OSError:
                pass
        self._file = None
        self._sock = None


# -- module registry (the CLI / env seam) ------------------------------
_ACTIVE: Optional[TelemetryShipper] = None
_REG_LOCK = threading.Lock()

DISABLED_TOKENS = ("0", "off", "false", "none")


def disabled_token(val) -> bool:
    return val is None or str(val).strip().lower() in DISABLED_TOKENS


def start(addr: str, role: str = "ut",
          **kw: Any) -> TelemetryShipper:
    """Start (or return the already-running) shipper for this
    process.  A second start with a different address replaces the
    first (stopping it cleanly)."""
    global _ACTIVE
    with _REG_LOCK:
        cur = _ACTIVE
    if cur is not None and not cur._stop.is_set():
        if f"{cur.addr[0]}:{cur.addr[1]}" == str(addr) \
                and cur.source["role"] == str(role):
            return cur
        cur.stop()
    shipper = TelemetryShipper(addr, role=role, **kw)
    with _REG_LOCK:
        _ACTIVE = shipper
    shipper.start()
    return shipper


def active() -> Optional[TelemetryShipper]:
    with _REG_LOCK:
        return _ACTIVE


def stop() -> None:
    with _REG_LOCK:
        shipper = _ACTIVE
    if shipper is not None:
        shipper.stop()


def maybe_ship_from_env(role: str = "ut",
                        env: Optional[dict] = None
                        ) -> Optional[TelemetryShipper]:
    """``UT_TELEMETRY=host:port`` starts the shipper for this process
    (the CLIs' ``--telemetry`` flag and ``ut.config('telemetry')``
    layer above it, same precedence as trace/journal).  ``--num-hosts``
    replicas inherit the env, so every replica ships automatically
    with its UT_PROCESS_ID folded into the role."""
    e = os.environ if env is None else env
    val = e.get("UT_TELEMETRY", "").strip()
    if not val or disabled_token(val):
        return None
    pid_env = e.get("UT_PROCESS_ID")
    if pid_env and pid_env != "0":
        role = f"{role}.h{pid_env}"
    return start(val, role=role)
