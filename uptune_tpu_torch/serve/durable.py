"""Durable session checkpoints: the serving plane's write-ahead log.

Counterpart of `uptune_tpu/serve/durable.py`; a segment is byte for byte
the JAX package's, so either package's server recovers the other's.

The store memoizes *builds*, but a session's committed state — its
published versions, incumbent, counters — lived only in RAM: one
``kill -9`` of the serving process vaporized every tenant.  This
module journals each session's **committed state transitions** as one
append-only, torn-tail-tolerant JSONL segment per session id:

``sess-<id>.jsonl`` under the checkpoint dir (by default
``<store-dir>/checkpoints`` — the store's directory-scan ignores
subdirectories, so the two planes share one tree)::

    {"ev": "open",   ... space records, seed, program, sense, ...}
    {"ev": "commit", "v": 1, "raw": [...], "best_cfg": ..., ...}
    {"ev": "commit", "v": 2, ...}
    {"ev": "close"}

Why this is *small*: sessions are already versioned snapshots
(serve/session.py), so a checkpoint is just the v -> v+1 delta on the
commit path — the measured raw batch (``None`` encodes NaN: JSON has
no NaN and a failure row must replay as one) plus the host-side
accounting (incumbent, counters, ticket cursor, quality state) that
replay cannot cheaply reconstruct in tell order.  Device state is
never serialized at all: ``propose`` is pure in the state, so
recovery replays the commit stream through the SAME
``propose_all``/``commit_slot`` primitives and lands on a state
**bitwise identical** to one that never died.

Write discipline is the store's segment rule: one complete JSON line
per record via a single ``O_APPEND`` write (readers can only ever see
an incomplete *tail* line, which `load` leaves unconsumed), with an
optional fsync knob for power-loss durability — plain ``os.write``
already survives process SIGKILL via the page cache, which is the
failure mode the JAX package's ``bench.py --failover`` prices.

Ordering contract (the zero-committed-tell-loss bound): the serving
op that *publishes* a version appends its commit record **before its
reply is written** (Session._drain_ckpt), so any ``committed: true``
a client ever observed is durable.  A crash between the in-RAM
commit and the append loses only an ack the client never received —
the client retries, recovery restores v, and the store memo (whose
``record`` also precedes the reply) re-fills the replayed epoch with
identical values.
"""
from __future__ import annotations

import json
import os
import threading
from typing import Any, Dict, Iterator, List, Optional, Tuple

from .. import obs
from ..obs import faults

__all__ = ["CheckpointLog", "default_checkpoint_dir", "decode_raw",
           "encode_raw", "CKPT_PREFIX", "CKPT_SUFFIX"]

CKPT_PREFIX = "sess-"
CKPT_SUFFIX = ".jsonl"


def default_checkpoint_dir(store_dir: Optional[str],
                           work_dir: str) -> str:
    """``--durable`` without a path: checkpoints live under the store
    directory (the content-addressed tree is already the serving
    plane's durable home); with the store off, under the work dir's
    ut.serve tree."""
    if store_dir:
        return os.path.join(store_dir, "checkpoints")
    return os.path.join(work_dir, "ut.serve", "checkpoints")


def encode_raw(raw) -> List[Optional[float]]:
    """A measured epoch batch as JSON: None encodes NaN (failure
    rows) — allow_nan JSON is not JSON, and a replayed failure must
    stay a failure."""
    out: List[Optional[float]] = []
    for v in raw:
        f = float(v)
        out.append(f if f == f and abs(f) != float("inf") else None)
    return out


def decode_raw(enc: List[Optional[float]]) -> List[float]:
    return [float("nan") if v is None else float(v) for v in enc]


class CheckpointLog:
    """One serving process's checkpoint plane: per-session append-only
    segments under one directory.  Appends open/write/close the file
    per record — commit records are per *epoch* (a whole batch of
    tells), so the syscall cost is amortized far off the ask/tell hot
    path, and no fd table grows with the session count."""

    def __init__(self, root: str, *, fsync: bool = False):
        self.root = os.path.abspath(root)
        os.makedirs(self.root, exist_ok=True)
        self.fsync = bool(fsync)
        # serializes same-session appends from concurrent handler
        # threads (two clients may drive one session); cross-session
        # appends never share a file, so one lock is contention-free
        # at the per-epoch append rate
        self._lock = threading.Lock()
        self.appends = 0
        self.errors = 0
        self.reaped = 0

    def path_for(self, sid: str) -> str:
        return os.path.join(self.root,
                            f"{CKPT_PREFIX}{sid}{CKPT_SUFFIX}")

    # -- writes --------------------------------------------------------
    def append(self, sid: str, record: Dict[str, Any]) -> bool:
        """Append one record as one complete line via a single
        O_APPEND write.  Returns False on OSError (counted, never
        raised: the tell is already applied in RAM — failing the
        reply for a disk hiccup would report ok=False for an epoch
        that really committed, the store-append rule)."""
        faults.fire("ckpt.append")
        data = (json.dumps(record, separators=(",", ":"),
                           allow_nan=False) + "\n").encode()
        fd = -1
        try:
            # open+write under the lock (same-session append order);
            # fsync OUTSIDE it — fsync flushes the whole inode, so by
            # the time THIS append's fsync returns, this record and
            # every earlier one are durable, and the caller's reply
            # still strictly follows its own record's durability.
            # Holding a lock across fsync serializes every concurrent
            # session behind one disk flush (R102).
            with self._lock:
                fd = os.open(self.path_for(sid),
                             os.O_WRONLY | os.O_CREAT | os.O_APPEND,
                             0o644)
                os.write(fd, data)       # one write = one atomic line
            if self.fsync:
                os.fsync(fd)
        except OSError:
            self.errors += 1
            obs.count("serve.ckpt_errors")
            return False
        finally:
            if fd >= 0:
                os.close(fd)
        self.appends += 1
        obs.count("serve.ckpt_appends")
        return True

    def reap(self, sid: str) -> None:
        """Drop a closed session's segment (recovery also reaps any
        segment whose record stream ends in a close)."""
        try:
            os.unlink(self.path_for(sid))
            self.reaped += 1
        except OSError:
            pass

    # -- reads (recovery) ----------------------------------------------
    def load(self, sid: str) -> List[Dict[str, Any]]:
        """One session's surviving records, torn-tail tolerant: an
        incomplete or unparseable final line (the crash tail) is
        dropped; a bad line mid-file ends the usable prefix — records
        after it cannot be trusted to be contiguous."""
        out: List[Dict[str, Any]] = []
        try:
            with open(self.path_for(sid), "rb") as f:
                buf = f.read()
        except OSError:
            return out
        for line in buf.split(b"\n"):
            if not line.strip():
                continue
            try:
                rec = json.loads(line)
            except json.JSONDecodeError:
                break
            if isinstance(rec, dict):
                out.append(rec)
        return out

    def session_ids(self) -> List[str]:
        try:
            names = sorted(os.listdir(self.root))
        except OSError:
            return []
        return [n[len(CKPT_PREFIX):-len(CKPT_SUFFIX)] for n in names
                if n.startswith(CKPT_PREFIX)
                and n.endswith(CKPT_SUFFIX)]

    def scan(self) -> Iterator[Tuple[str, Dict[str, Any]]]:
        """Yield ``(sid, bundle)`` per surviving segment, where bundle
        is ``{"open": rec | None, "commits": [recs sorted by v],
        "closed": bool}``.  Commit records are sorted and deduped by
        version (same-session drains from two handler threads may
        append out of order; versions are authoritative) and truncated
        at the first gap — replay must be contiguous from v=1."""
        for sid in self.session_ids():
            recs = self.load(sid)
            open_rec: Optional[Dict[str, Any]] = None
            closed = False
            by_v: Dict[int, Dict[str, Any]] = {}
            for r in recs:
                ev = r.get("ev")
                if ev == "open" and open_rec is None:
                    open_rec = r
                elif ev == "commit":
                    try:
                        v = int(r["v"])
                    except (KeyError, TypeError, ValueError):
                        continue
                    by_v.setdefault(v, r)
                elif ev == "close":
                    closed = True
            commits: List[Dict[str, Any]] = []
            for v in range(1, len(by_v) + len(recs) + 1):
                r = by_v.get(v)
                if r is None:
                    break
                commits.append(r)
            yield sid, {"open": open_rec, "commits": commits,
                        "closed": closed}

    def stats(self) -> Dict[str, Any]:
        return {"dir": self.root, "fsync": self.fsync,
                "appends": self.appends, "errors": self.errors,
                "reaped": self.reaped}
