"""The networked ResultStore server (`ut-torch store`): one crash-safe
process holding the shared results table for a cooperating fleet.

Counterpart of `uptune_tpu/store/server.py`, op for op, row for row and
log line for log line: a JAX-package `RemoteStore` and the port's both
record into it and read each other's rows, and either package's server
replays the other's `rows.jsonl`.

`ResultStore` already exchanges rows between instances — but only
through a shared filesystem (each instance re-scans the directory's
segments).  The reference synchronized its fleet through one global
SQLite database every `MpiController` worker published into; this
module is the equivalent over the port's own seams: a `StoreServer` on
the serve/wire.py kernel speaking

* ``hello``  — client announces itself (+ optional scope): returns the
  server incarnation token and the scope's row count,
* ``lookup`` — one content key -> its finite row (the memo read),
* ``record`` — one row in, durably appended, THEN acked.  Duplicate
  keys are acked as ``dup`` without an append — the content-key dedup
  that makes a reconnecting client's write-behind replay idempotent,
* ``delta``  — the `pop_fresh_rows` feed generalized over the wire:
  rows appended after a client-held cursor, filtered to the requested
  scope and excluding the requester's own rows,
* ``best`` / ``stats`` / ``metrics`` / ``health`` — incumbent query,
  accounting, the `ut-torch top --addr` scrape, and the hub's
  worst-first fold entry (``by_status``, the hub's rollup shape).

Durability is the CheckpointLog write discipline (serve/durable.py):
one complete JSON line per accepted row via a single ``O_APPEND``
write — the ack is sent only after the append returns, so a SIGKILL
can never lose an acked row (page-cache durable; ``--fsync`` extends
that to power loss).  Restart replays the log torn-tail-tolerantly: a
partial tail line (the append the crash interrupted) ends the usable
prefix.  ``faults.fire("rstore.append")`` sits inside the append so
`chip_smoke.py`'s store phase can kill the server at a deterministic
append and prove the contract.

The server is host Python and holds no tensors: `ut-torch store` needs
no card (as `ut-torch hub` needs none), so no device check refuses it
and it imports neither torch nor numpy.
"""
from __future__ import annotations

import argparse
import json
import logging
import os
import sys
import threading
import time
from typing import Any, Dict, List, Optional

from .. import obs
from ..obs import faults
from ..serve.wire import RequestError, WireServer
from .store import _finite

log = logging.getLogger("uptune_tpu_torch")

__all__ = ["StoreServer", "main", "LOG_FILE", "DELTA_MAX"]

LOG_FILE = "rows.jsonl"         # the server's single durable log
DELTA_MAX = 512                 # rows per delta reply (clients loop)

# the row fields a record op may carry — anything else is dropped so
# one client cannot bloat every sibling's delta feed with junk
_ROW_FIELDS = ("k", "scope", "cfg", "qor", "dur", "t", "src", "u",
               "perms")


class StoreServer(WireServer):
    """One shared results table behind a TCP port.

    The table is rebuilt from the durable log on construction
    (torn-tail-tolerant, exactly the segment-load rule ResultStore
    applies to its shards), so a SIGKILLed server restarted on the
    same directory serves every row it ever acked.  ``incarn`` is a
    fresh token per construction: delta cursors are positions in THIS
    incarnation's append order, and a client presenting a stale
    incarnation is restarted from 0 (its local table dedups the
    re-read)."""

    WIRE_NAME = "ut-store"

    def __init__(self, host: str = "127.0.0.1", port: int = 0,
                 root: Optional[str] = None, *, fsync: bool = False):
        super().__init__(host, port)
        self.root = os.path.abspath(root or os.path.join(
            os.getcwd(), "ut.store"))
        os.makedirs(self.root, exist_ok=True)
        self.fsync = bool(fsync)
        self.log_path = os.path.join(self.root, LOG_FILE)
        self.incarn = f"{os.getpid():d}-{os.urandom(4).hex()}"
        # _lock (WireServer's RLock) guards the table + counters;
        # _io_lock is the fd-lifecycle leaf lock (the ResultStore
        # discipline: acquire order _lock -> _io_lock, never reverse)
        self._io_lock = threading.Lock()
        self._fd: Optional[int] = None
        self._rows: Dict[str, Dict[str, Any]] = {}
        self._seq: List[str] = []      # keys in durable append order
        self.hits = 0
        self.misses = 0
        self.recorded = 0              # rows accepted this incarnation
        self.dups = 0                  # idempotent re-records acked
        self.appends = 0               # durable appends this incarnation
        self.append_errors = 0
        self.replayed = 0              # rows recovered from the log
        self.torn_tail = False
        self._clients = 0
        # a store server is a serving process: the scrape op (and the
        # hub's fold) always has data
        if not obs.enabled():
            obs.enable()
        self._replay()

    # -- durability ----------------------------------------------------
    def _replay(self) -> None:
        """Rebuild table + append order from the durable log.  The
        CheckpointLog load rule: only COMPLETE lines count, and a bad
        line mid-file ends the usable prefix (bytes after a torn
        append are one interrupted write's debris, not data)."""
        try:
            with open(self.log_path, "rb") as f:
                buf = f.read()
        except OSError:
            return
        for line in buf.split(b"\n"):
            if not line.strip():
                continue
            try:
                row = json.loads(line)
            except json.JSONDecodeError:
                self.torn_tail = True
                break
            if isinstance(row, dict) and isinstance(row.get("k"), str):
                self._merge(row)
                self.replayed += 1
        if self.replayed or self.torn_tail:
            log.info("[%s] replayed %d row(s) from %s%s",
                     self.WIRE_NAME, self.replayed, self.log_path,
                     " (torn tail dropped)" if self.torn_tail else "")

    def _merge(self, row: Dict[str, Any]) -> bool:
        """First-finite-wins merge (caller holds ``_lock`` or is the
        single-threaded replay).  Returns True when the row changed
        the table."""
        k = row["k"]
        cur = self._rows.get(k)
        if cur is not None and (_finite(cur.get("qor"))
                                or not _finite(row.get("qor"))):
            return False
        self._rows[k] = row
        if cur is None:
            self._seq.append(k)
        return True

    def _append_durable(self, row: Dict[str, Any]) -> None:
        """One row -> one complete O_APPEND line, flushed before the
        caller acks (serve/durable.py's ack-after-durable discipline).
        The fault point fires INSIDE the append window so an armed
        crash lands exactly where the loss bound is contested."""
        data = (json.dumps(row, separators=(",", ":"),
                           allow_nan=False) + "\n").encode()
        with self._io_lock:
            faults.fire("rstore.append")
            if self._fd is None:
                self._fd = os.open(
                    self.log_path,
                    os.O_WRONLY | os.O_CREAT | os.O_APPEND, 0o644)
            os.write(self._fd, data)   # one write = one atomic line
            fd = os.dup(self._fd) if self.fsync else None
        if fd is not None:
            # the power-loss barrier runs outside the lock on a dup'd
            # fd (the ResultStore R102 rule): the row is on disk when
            # the ack goes out either way
            try:
                os.fsync(fd)
            finally:
                os.close(fd)

    # -- ops -----------------------------------------------------------
    def _op_hello(self, req: dict) -> dict:
        scope = req.get("scope")
        with self._lock:
            rows = (sum(1 for r in self._rows.values()
                        if r.get("scope") == scope)
                    if isinstance(scope, str) else len(self._rows))
        return {"role": "ut-store", "incarn": self.incarn,
                "rows": rows, "started_unix": self.started_unix}

    def _op_lookup(self, req: dict) -> dict:
        k = req.get("k")
        if not isinstance(k, str):
            raise RequestError("lookup needs a string 'k'")
        with self._lock:
            row = self._rows.get(k)
            if row is not None and _finite(row.get("qor")):
                self.hits += 1
                obs.count("store.hits")
                return {"row": row}
            self.misses += 1
            obs.count("store.misses")
            return {"row": None}

    def _op_record(self, req: dict) -> dict:
        raw = req.get("row")
        if not isinstance(raw, dict) or not isinstance(raw.get("k"),
                                                       str) \
                or not isinstance(raw.get("scope"), str) \
                or not isinstance(raw.get("cfg"), dict):
            raise RequestError(
                "record needs a row object with k/scope/cfg")
        qor = raw.get("qor")
        if qor is not None:
            try:
                qor = float(qor)
            except (TypeError, ValueError):
                raise RequestError(f"row qor must be a number or "
                                   f"null: {qor!r}")
            if not _finite(qor):
                qor = None
        row = {f: raw[f] for f in _ROW_FIELDS if f in raw}
        row["qor"] = qor
        with self._lock:
            cur = self._rows.get(row["k"])
            if cur is not None and (_finite(cur.get("qor"))
                                    or not _finite(qor)):
                # content-key dedup: a write-behind replay after
                # reconnect re-sends its in-flight rows — ack, never
                # re-append (idempotency is the client's durability)
                self.dups += 1
                return {"acked": True, "dup": True}
        # the durable append runs OUTSIDE _lock (lookups must not
        # queue behind disk); ack-after-durable means the table insert
        # and the ack both happen only after the append returned.  Two
        # racers on one fresh key may both append — duplicate log
        # lines merge away on replay, exactly like duplicate segment
        # rows in ResultStore
        try:
            self._append_durable(row)
        except OSError:
            with self._lock:
                self.append_errors += 1
            raise
        with self._lock:
            self.appends += 1
            obs.count("rstore.appends")
            if self._merge(row):
                self.recorded += 1
                obs.count("store.recorded")
                return {"acked": True, "dup": False}
            self.dups += 1
            return {"acked": True, "dup": True}

    def _op_delta(self, req: dict) -> dict:
        scope = req.get("scope")
        if not isinstance(scope, str):
            raise RequestError("delta needs a string 'scope'")
        src = req.get("src")
        try:
            cursor = int(req.get("cursor", 0))
        except (TypeError, ValueError):
            raise RequestError(
                f"cursor must be an integer: {req.get('cursor')!r}")
        if req.get("incarn") not in (None, self.incarn):
            # the client's cursor indexes a DEAD incarnation's append
            # order: restart it (its local table dedups the re-read)
            cursor = 0
        cursor = max(0, cursor)
        out: List[Dict[str, Any]] = []
        with self._lock:
            total = len(self._seq)
            while cursor < total and len(out) < DELTA_MAX:
                r = self._rows.get(self._seq[cursor])
                cursor += 1
                if r is not None and r.get("scope") == scope \
                        and r.get("src") != src \
                        and _finite(r.get("qor")):
                    out.append(r)
            more = cursor < total
        return {"rows": out, "cursor": cursor, "more": more,
                "incarn": self.incarn}

    def _op_best(self, req: dict) -> dict:
        scope = req.get("scope")
        if not isinstance(scope, str):
            raise RequestError("best needs a string 'scope'")
        sense = str(req.get("sense", "min"))
        pick = min if sense != "max" else max
        with self._lock:
            rows = [r for r in self._rows.values()
                    if r.get("scope") == scope
                    and _finite(r.get("qor"))]
        if not rows:
            return {"row": None}
        return {"row": pick(rows, key=lambda r: float(r["qor"]))}

    def _op_stats(self, req: dict) -> dict:
        with self._lock:
            scopes = len({r.get("scope") for r in self._rows.values()})
            return {"rows": len(self._rows), "scopes": scopes,
                    "hits": self.hits, "misses": self.misses,
                    "recorded": self.recorded, "dups": self.dups,
                    "appends": self.appends,
                    "append_errors": self.append_errors,
                    "replayed": self.replayed,
                    "torn_tail": self.torn_tail,
                    "clients": self._clients, "incarn": self.incarn,
                    "root": self.root, "fsync": self.fsync}

    def _op_metrics(self, req: dict) -> dict:
        """The `ut-torch top --addr` scrape — the session server's payload
        shape (top.sample_from_scrape), carrying the store.* counters
        plus rstore.appends for the acked-append gauge."""
        fmt = str(req.get("format", "json")).lower()
        with self._lock:
            clients = self._clients
        out: Dict[str, Any] = {
            "sessions": clients,
            "uptime_s": round(time.time() - self.started_unix, 3)}
        if fmt == "prometheus":
            out["metrics_text"] = obs.prometheus_text()
        elif fmt == "json":
            out["metrics"] = obs.metrics_snapshot()
        else:
            raise RequestError(
                f"metrics format must be json|prometheus: {fmt!r}")
        return out

    def _op_health(self, req: dict) -> dict:
        """The hub's fold entry (obs/hub.py adopts the worst
        ``by_status`` verdict of a shipped health rollup): ``failing``
        when durable appends error, ``cold`` while the table is empty,
        ``ok`` otherwise."""
        with self._lock:
            if self.append_errors:
                status = "failing"
            elif not self._rows:
                status = "cold"
            else:
                status = "ok"
            return {"role": "ut-store", "status": status,
                    "by_status": {status: max(1, self._clients)},
                    "rows": len(self._rows),
                    "clients": self._clients,
                    "appends": self.appends,
                    "append_errors": self.append_errors}

    def _op_ping(self, req: dict) -> dict:
        return {"role": "ut-store", "t": time.time()}

    _OPS = {"hello": _op_hello, "lookup": _op_lookup,
            "record": _op_record, "delta": _op_delta,
            "best": _op_best, "stats": _op_stats,
            "metrics": _op_metrics, "health": _op_health,
            "ping": _op_ping}

    # -- connection accounting (the WireServer reaping seam) -----------
    def _conn_opened(self, conn, addr) -> Any:
        with self._lock:
            self._clients += 1
        return True

    def _conn_closed(self, state: Any) -> None:
        if state:
            with self._lock:
                self._clients -= 1

    def _listen_banner(self) -> str:
        return (f" (store root {self.root}, {len(self._rows)} row(s)"
                f"{', fsync' if self.fsync else ''})")

    def stop(self) -> None:
        super().stop()
        with self._io_lock:
            if self._fd is not None:
                os.close(self._fd)
                self._fd = None


def main(argv: Optional[List[str]] = None) -> int:
    """``ut-torch store`` — run a store server."""
    p = argparse.ArgumentParser(
        prog="ut-torch store",
        description="networked results-store server: tuning processes "
                    "started with --store tcp://HOST:PORT share one "
                    "results table, exchange new-bests, and pool "
                    "surrogate evidence through it")
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--port", type=int, default=8791,
                   help="TCP port (0 = ephemeral, printed once bound)")
    p.add_argument("--dir", default=None, metavar="DIR",
                   help="durable log directory (default ut.store under "
                        "the cwd); restart on the same directory "
                        "replays every acked row")
    p.add_argument("--fsync", action="store_true",
                   help="fsync each append (power-loss durability; "
                        "SIGKILL durability needs no fsync)")
    p.add_argument("--telemetry", default=None, metavar="HOST:PORT",
                   help="ship metrics/health to a `ut-torch hub` collector "
                        "under the ut-store role")
    p.add_argument("-v", "--verbose", action="store_true")
    args = p.parse_args(argv)
    logging.basicConfig(
        level=logging.DEBUG if args.verbose else logging.INFO,
        format="%(asctime)s %(levelname)s %(message)s")
    # the deterministic-crash seam (same as `ut-torch serve`)
    faults.maybe_arm_from_env()
    srv = StoreServer(args.host, args.port, args.dir,
                      fsync=args.fsync)
    shipper = None
    if args.telemetry:
        shipper = obs.ship.start(
            args.telemetry, role="ut-store",
            health_provider=lambda: srv._op_health({}))
    srv.start()
    print(f"PORT {srv.port}", flush=True)
    try:
        while True:
            time.sleep(3600)
    except KeyboardInterrupt:
        log.info("[%s] shutting down", srv.WIRE_NAME)
    finally:
        if shipper is not None:
            shipper.stop()
        srv.stop()
    return 0


if __name__ == "__main__":
    sys.exit(main())
