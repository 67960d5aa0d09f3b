"""Content-addressed trial results store: the port's answer to the
reference's SQLite results database (`python/uptune/
api.py` SQLAlchemy sync + CSV archives).

An in-memory table (key -> row) fronts an append-only on-disk shard
layout inside one store directory:

* ``seg-<instance>.jsonl`` — per-instance append-only segment.  Each
  process appends ONLY to its own segment (unique token), one complete
  JSON line per row via a single ``O_APPEND`` write, so N concurrent
  instances never interleave bytes and readers never see a torn row in
  the middle of a file — at worst an incomplete tail line, which is
  simply not parsed until its newline arrives.
* ``base.jsonl`` — optional compacted snapshot.  ``compact()`` merges
  everything visible into a new base (atomic tmp+rename) and truncates
  only the caller's OWN segment; other instances' live segments are
  never touched, and duplicate keys across base/segments are harmless
  (first finite row wins on load).

Multi-instance exchange is just this layout plus ``refresh()``: each
instance periodically re-scans the directory, reads the newly appended
complete lines of every other segment from its remembered offset, and
merges the rows — any instance's measured config becomes a cache hit
for all of them.

Rows are scoped by ``keys.scope_id`` (space signature + eval
signature), so one directory safely holds many programs' results;
lookups can only ever hit rows recorded for the same space, the same
program content, and the same stage.  Failure rows (``qor: null``) are
recorded for bookkeeping but never served: a build that failed once may
have failed transiently, and re-measuring a failure is the safe side of
that bet.
"""
from __future__ import annotations

import json
import os
import threading
import time
from typing import Any, Dict, List, Optional, Sequence

from .. import obs
from ..obs import faults
from .keys import eval_signature, scope_id, trial_key


def _finite(q) -> bool:
    return q is not None and q == q and abs(q) != float("inf")


def _resolve_fsync(explicit) -> bool:
    """The store's durability knob (docs/STORE.md "Durability"):
    explicit argument > UT_STORE_FSYNC env > ut.config('store-fsync')
    > off.  The O_APPEND protocol already survives process SIGKILL
    through the page cache; fsync additionally survives power loss at
    the cost of one disk barrier per recorded build."""
    if explicit is not None:
        return bool(explicit)
    env = os.environ.get("UT_STORE_FSYNC", "").strip().lower()
    if env:
        return env in ("1", "true", "yes", "on")
    from ..api.session import settings
    return bool(settings.get("store-fsync"))


class ResultStore:
    """One instance's handle on a shared store directory.

    Parameters
    ----------
    root : str
        Store directory (created if missing); shareable between
        concurrent processes.
    space_sig : sequence of str
        Structural space signature (``Tuner._space_sig()`` form).
    command : str | list
        The evaluation command (content-addressed via keys.py).
    stage : int
        Pipeline stage index the results belong to.
    extra_files : optional paths whose CONTENT shapes the measurement
        (template sources); hashed into the eval signature.
    refresh_interval : float
        Minimum seconds between directory re-scans in
        ``maybe_refresh()``.
    """

    def __init__(self, root: str, space_sig: Sequence[str], command,
                 *, stage: int = 0,
                 extra_files: Optional[Sequence[str]] = None,
                 env: Optional[Dict[str, str]] = None,
                 refresh_interval: float = 2.0,
                 fsync: Optional[bool] = None):
        self.root = os.path.abspath(root)
        os.makedirs(self.root, exist_ok=True)
        self.fsync = _resolve_fsync(fsync)
        # the session server shares ONE store handle between its
        # per-connection threads (the cross-tenant memo), so the
        # table/offset/segment mutations take a reentrant lock; the
        # single-threaded driver path pays one uncontended acquire per
        # lookup/record.  CROSS-PROCESS safety was never the lock's
        # job — that is the O_APPEND segment protocol.  Disk appends
        # take _io_lock INSTEAD so a lookup (held under a tenant
        # group's lock in the serving plane) never waits on another
        # tenant's os.write; acquire order is _lock -> _io_lock,
        # never the reverse
        self._lock = threading.RLock()
        self._io_lock = threading.Lock()
        self._closed = False
        self.eval_sig = eval_signature(command, stage,
                                       extra_files=extra_files, env=env)
        self.scope = scope_id(list(space_sig), self.eval_sig)
        self.refresh_interval = float(refresh_interval)
        # unique per-instance segment token: pid + entropy (two stores
        # opened by one process must not share a segment either)
        self.instance = f"{os.getpid():d}-{os.urandom(4).hex()}"
        self._seg_path = os.path.join(self.root,
                                      f"seg-{self.instance}.jsonl")
        self._seg_fd: Optional[int] = None
        self._rows: Dict[str, Dict[str, Any]] = {}
        # path -> (inode, byte offset past the last complete line)
        self._offsets: Dict[str, tuple] = {}
        self._last_refresh = 0.0
        self.hits = 0
        self.misses = 0
        self.recorded = 0
        self.foreign_rows = 0   # rows merged from other instances
        # keys merged from siblings AFTER the initial open: the
        # exchange plane acts on these deltas only (rows already
        # present at open are a previous run's results — cross-RUN
        # propagation is warm start's job, not exchange's)
        self._fresh_foreign: set = set()
        self._loading = True
        self._load_all()
        self._loading = False

    # -- loading -------------------------------------------------------
    def _shard_files(self) -> List[str]:
        try:
            names = sorted(os.listdir(self.root))
        except OSError:
            return []
        out = []
        for n in names:
            if n == "base.jsonl" or (n.startswith("seg-")
                                     and n.endswith(".jsonl")):
                out.append(os.path.join(self.root, n))
        return out

    def _merge(self, row: Dict[str, Any], foreign: bool) -> None:
        k = row.get("k")
        if not isinstance(k, str):
            return
        cur = self._rows.get(k)
        # first finite measurement wins; a finite row may replace a
        # recorded failure (another instance's retry succeeded)
        if cur is None or (not _finite(cur.get("qor"))
                           and _finite(row.get("qor"))):
            self._rows[k] = row
            if foreign:
                self.foreign_rows += 1
                if not self._loading:
                    self._fresh_foreign.add(k)

    def _read_new_lines(self, path: str) -> int:
        """Parse newly appended COMPLETE lines of one shard file from
        the remembered offset; a torn tail (no newline yet) stays
        unconsumed until a later pass.  Offsets are bound to the file's
        IDENTITY (inode): a sibling's compact() replaces base.jsonl by
        rename and may recreate its own segment from empty — a stale
        byte offset into the new file would silently skip rows, so an
        inode change or a shrink resets the offset to 0 (re-reads merge
        away as duplicates)."""
        ino, off = self._offsets.get(path, (None, 0))
        try:
            with open(path, "rb") as f:
                st = os.fstat(f.fileno())
                if st.st_ino != ino or st.st_size < off:
                    off = 0   # replaced or truncated: start over
                ino = st.st_ino
                f.seek(off)
                buf = f.read()
        except OSError:
            return 0
        if not buf:
            self._offsets[path] = (ino, off)
            return 0
        end = buf.rfind(b"\n")
        if end < 0:
            self._offsets[path] = (ino, off)
            return 0
        self._offsets[path] = (ino, off + end + 1)
        n = 0
        for line in buf[: end + 1].splitlines():
            if not line.strip():
                continue
            try:
                row = json.loads(line)
            except json.JSONDecodeError:
                continue   # defensive: one bad row never poisons a shard
            self._merge(row, foreign=path != self._seg_path)
            n += 1
        return n

    def _load_all(self) -> int:
        n = 0
        for path in self._shard_files():
            if path == self._seg_path:
                continue   # own appends are already in memory
            n += self._read_new_lines(path)
        return n

    def refresh(self) -> int:
        """Re-scan the directory for other instances' appends; returns
        the number of FOREIGN rows read (this instance's own segment is
        never re-read — its rows entered memory at record() time), so a
        truthy refresh really means siblings produced something."""
        with self._lock:
            self._last_refresh = time.monotonic()
            with obs.span("store.refresh") as sp:
                n = self._load_all()
                sp.set(rows=n)
            return n

    def maybe_refresh(self) -> int:
        """Time-gated refresh() for call sites inside hot loops."""
        if time.monotonic() - self._last_refresh < self.refresh_interval:
            return 0
        return self.refresh()

    # -- queries -------------------------------------------------------
    def __len__(self) -> int:
        with self._lock:
            return len(self._rows)

    def __bool__(self) -> bool:
        # An open-but-empty store must stay truthy: ``if store:`` call
        # sites would otherwise never record the first row.
        return True

    def lookup(self, cfg: Dict[str, Any]) -> Optional[Dict[str, Any]]:
        """The recorded row for this config under THIS scope, or None.
        Only successful (finite-QoR) rows are served; failure rows are
        re-measured (see module docstring)."""
        with self._lock:
            row = self._rows.get(trial_key(self.scope, cfg))
            if row is not None and _finite(row.get("qor")):
                self.hits += 1
                obs.count("store.hits")
                return row
            self.misses += 1
            obs.count("store.misses")
            return None

    def scope_rows(self) -> List[Dict[str, Any]]:
        """All finite rows recorded for this (space, eval) scope — the
        warm-start training/replay set."""
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
        """Finite in-scope rows merged from SIBLING instances since the
        last call (rows present at open never appear): the exchange
        plane's delta feed.  Consuming clears the set."""
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

    # -- writes --------------------------------------------------------
    def _append(self, row: Dict[str, Any]) -> Optional[int]:
        """Write one row to the segment (caller holds ``_io_lock``).
        With fsync on, returns a dup'd fd for the caller to flush
        OUTSIDE the lock — fsync is inode-wide, so the dup covers this
        append even if the original fd is closed meanwhile; holding
        ``_io_lock`` across the barrier would queue every concurrent
        append behind one disk flush (R102).  Returns None otherwise."""
        if self._closed:
            # a record() racing close() (server stop vs an in-flight
            # tell) must not resurrect the segment: reopening here
            # would leak the fd and leave a stray seg file behind
            return None
        if self._seg_fd is None:
            self._seg_fd = os.open(
                self._seg_path,
                os.O_WRONLY | os.O_CREAT | os.O_APPEND, 0o644)
        data = (json.dumps(row, separators=(",", ":"),
                           allow_nan=False) + "\n").encode()
        os.write(self._seg_fd, data)   # one write = one atomic line
        if self.fsync:
            # UT_STORE_FSYNC / ut.config('store-fsync'): recorded
            # builds survive power loss, one barrier per append
            return os.dup(self._seg_fd)
        return None

    def record(self, cfg: Dict[str, Any], qor: Optional[float],
               dur: float = 0.0, *, u: Optional[Sequence[float]] = None,
               perms: Optional[Sequence[Sequence[int]]] = None,
               source: str = "") -> Optional[Dict[str, Any]]:
        """Record one measured trial (USER-oriented QoR; None = build
        failure).  Returns the stored row, or None when an equal-or-
        better row for the key already exists (idempotent re-records,
        e.g. archive ingestion over a live store, append nothing)."""
        faults.fire("store.record")
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
        # the disk append runs outside _lock (lookups on the serving
        # path must not queue behind it); _io_lock serializes fd use.
        # Same-key dedup already resolved above, and segment line
        # ORDER across threads is irrelevant — rows are keyed and
        # duplicate keys merge away on load
        with self._io_lock:
            fd = self._append(row)
        if fd is not None:
            # the durability barrier runs outside BOTH locks on the
            # dup'd fd; the row is on disk when record() returns, the
            # memo-before-reply contract, without serializing other
            # threads' appends behind the flush
            try:
                os.fsync(fd)
            finally:
                os.close(fd)
        return row

    def ingest_archive(self, path: str) -> int:
        """Replay a driver jsonl trial archive into the store (exact
        unit vectors preserved), so resume and pre-store runs share the
        cache path.  Rows already present are skipped."""
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

    # -- maintenance ---------------------------------------------------
    def compact(self) -> int:
        """Merge every visible row into a fresh ``base.jsonl`` (atomic
        rename) and retire this instance's own segment.  Other
        instances' segments are left alone — their rows are now ALSO in
        the base, and duplicate keys merge away on load.

        The whole-store write + fsync runs OUTSIDE the locks (a
        shared-handle tenant's lookup/record must not queue behind a
        full disk flush — R102); correctness comes from rotating the
        segment first: under ``_lock``+``_io_lock`` the own segment is
        closed and renamed to a ``seg-*-old.jsonl`` name that still
        matches the sibling scan pattern, so (a) any record() landing
        mid-compact reopens a FRESH segment and its row survives the
        retirement, and (b) a crash before the base rename loses
        nothing — the rotated segment is still scanned on next load."""
        with self._lock:
            self.refresh()
            old: Optional[str] = os.path.join(
                self.root, f"seg-{self.instance}-old.jsonl")
            with self._io_lock:
                if self._seg_fd is not None:
                    os.close(self._seg_fd)
                    self._seg_fd = None
                try:
                    os.rename(self._seg_path, old)
                except OSError:
                    old = None          # no segment yet
            self._offsets.pop(self._seg_path, None)
            snapshot = list(self._rows.values())
            # per-instance tmp name: two siblings compacting
            # concurrently must not truncate each other's in-flight
            # snapshot (each publishes a FULL merged view, so
            # last-rename-wins is safe)
            tmp = os.path.join(self.root,
                               f"base.jsonl.{self.instance}.tmp")
        with open(tmp, "w") as f:
            for row in snapshot:
                f.write(json.dumps(row, separators=(",", ":")) + "\n")
            f.flush()
            os.fsync(f.fileno())
        with self._lock:
            base = os.path.join(self.root, "base.jsonl")
            os.replace(tmp, base)
            # base content changed identity: re-read from 0 next
            # refresh
            self._offsets.pop(base, None)
            self._read_new_lines(base)
            if old is not None:
                # every rotated row is now in the base (the snapshot
                # was taken after the rotation): safe to drop
                try:
                    os.unlink(old)
                except OSError:
                    pass
                self._offsets.pop(old, None)
            return len(self._rows)

    def close(self) -> None:
        # the serving plane shares one handle across tenant threads,
        # so a close must not race a record()'s in-flight os.write —
        # _io_lock is the fd-lifecycle lock
        with self._io_lock:
            self._closed = True
            if self._seg_fd is not None:
                os.close(self._seg_fd)
                self._seg_fd = None

    def __enter__(self) -> "ResultStore":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    def stats(self) -> Dict[str, Any]:
        return {"rows": len(self._rows), "hits": self.hits,
                "misses": self.misses, "recorded": self.recorded,
                "foreign_rows": self.foreign_rows,
                "scope": self.scope}
