"""Metrics flight recorder: the one-shot scrape, turned into a
timeline.

A metrics registry read exactly once — at `obs.finish()` — would
leave a crashed run, an interrupted run, or a week-long `ut serve`
process no usable metrics history at all.  A ``FlightRecorder`` is a
background daemon thread that appends one `metrics.window_snapshot`
row to a JSONL file every `interval` seconds: absolute counters PLUS
per-window counter deltas and histogram-window percentiles, so rates
("asks/s over the last second") read straight off consecutive rows
without diffing absolute scrapes.  `ut top --metrics <file>` tails
exactly this stream.

Bounded by construction: at `max_rows` the file rotates — the current
generation moves to ``<path>.1`` (older generations shift to ``.2`` …
``.N`` up to the configured `rotate` depth; default 1, the historical
behavior) — so leaving the recorder on forever costs a fixed disk
budget.  `chain(path)` lists the surviving generations oldest-first
and `read_chain(path)` replays their rows in write order: `ut top`'s
tail and the fleet hub's timeline replay both read through rotation
boundaries instead of forgetting everything at each cap.  `stop()`
writes one final row (marked ``"final": true``) and is idempotent —
it is called from the normal `obs.finish()` path, the SIGINT/atexit
flush (`obs.install_exit_flush`), or both.
"""
from __future__ import annotations

import json
import os
import threading
import time
from typing import Any, Dict, List, Optional

from . import metrics

__all__ = ["FlightRecorder", "start", "stop", "active_for",
           "rotate_files", "chain", "read_chain",
           "DEFAULT_INTERVAL", "DEFAULT_MAX_ROWS", "DEFAULT_ROTATE"]

DEFAULT_INTERVAL = 1.0
DEFAULT_MAX_ROWS = 20000
DEFAULT_ROTATE = 1


def rotate_files(path: str, depth: int) -> None:
    """Shift the rotation chain one generation: ``.N-1`` -> ``.N`` …
    ``<path>`` -> ``.1`` (the oldest generation past `depth` is
    dropped).  Best-effort per link — a vanished generation never
    breaks the shift.  Shared by the flight recorder and the fleet
    hub's timeline (obs/hub.py), so every rotation-capped JSONL in
    the obs plane ages the same way."""
    depth = max(1, int(depth))
    for i in range(depth, 1, -1):
        try:
            os.replace(f"{path}.{i - 1}", f"{path}.{i}")
        except OSError:
            pass
    try:
        os.replace(path, path + ".1")
    except OSError:
        pass


def chain(path: str) -> List[str]:
    """Existing generations of a rotation-capped JSONL, OLDEST first
    (``.N`` … ``.1``, then the live file)."""
    out: List[str] = []
    n = 1
    while os.path.exists(f"{path}.{n}"):
        n += 1
    for i in range(n - 1, 0, -1):
        out.append(f"{path}.{i}")
    if os.path.exists(path):
        out.append(path)
    return out


def read_chain(path: str) -> List[Dict[str, Any]]:
    """Every parseable JSON row across the rotation chain, in write
    order (torn lines skipped — same tolerance as every obs JSONL)."""
    rows: List[Dict[str, Any]] = []
    for p in chain(path):
        try:
            with open(p) as f:
                for line in f:
                    line = line.strip()
                    if not line:
                        continue
                    try:
                        row = json.loads(line)
                    except json.JSONDecodeError:
                        continue
                    if isinstance(row, dict):
                        rows.append(row)
        except OSError:
            continue
    return rows

# path -> running recorder; obs.finish() consults this so a run with a
# recorder gets its final row + close instead of a second (schema-
# mismatched) one-shot append
_ACTIVE: Dict[str, "FlightRecorder"] = {}
# every path that EVER had a recorder this process: a later finish()
# (e.g. the clean exit after a signal flush already stopped it) must
# not append a schema-mismatched legacy one-shot row after "final"
_EVER: set = set()
_REG_LOCK = threading.Lock()


class FlightRecorder:
    """One background metrics-snapshot writer.  Construct + `start()`,
    or use the module-level `start(path, ...)` registry helpers."""

    def __init__(self, path: str, interval: float = DEFAULT_INTERVAL,
                 max_rows: int = DEFAULT_MAX_ROWS,
                 extra: Optional[Dict[str, Any]] = None,
                 rotate: int = DEFAULT_ROTATE):
        self.path = path
        self.interval = max(0.01, float(interval))
        self.max_rows = int(max_rows)
        self.rotate = max(1, int(rotate))
        self.extra = dict(extra or {})
        self.rows_written = 0
        self.rotations = 0
        self._cursor: Optional[Dict[str, Any]] = None
        self._last_t = time.time()
        self._f = None
        self._stop = threading.Event()
        self._wlock = threading.Lock()   # row writes: thread vs stop()
        self._thread: Optional[threading.Thread] = None

    # -- lifecycle -----------------------------------------------------
    def start(self) -> "FlightRecorder":
        self._f = open(self.path, "a")
        self._last_t = time.time()
        self._thread = threading.Thread(
            target=self._loop, name="ut-flight-recorder", daemon=True)
        self._thread.start()
        return self

    def _loop(self) -> None:
        while not self._stop.wait(self.interval):
            try:
                self._write_row()
            except OSError:
                return      # disk gone: recording is best-effort

    def stop(self, timeout: float = 5.0) -> None:
        """Final row + close.  Idempotent and safe from signal
        handlers (the writer thread is joined with a bound)."""
        if self._stop.is_set():
            return
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout)
        try:
            self._write_row(final=True)
        except OSError:
            pass
        with self._wlock:
            if self._f is not None:
                self._f.close()
                self._f = None
        with _REG_LOCK:
            if _ACTIVE.get(self.path) is self:
                del _ACTIVE[self.path]

    # -- rows ----------------------------------------------------------
    def _write_row(self, final: bool = False) -> None:
        with self._wlock:
            if self._f is None:
                return
            now = time.time()
            row, self._cursor = metrics.window_snapshot(self._cursor)
            row = {"t": round(now, 3),
                   "dt": round(now - self._last_t, 3),
                   "pid": os.getpid(), **row}
            self._last_t = now
            if final:
                row["final"] = True
            if self.extra:
                row.update(self.extra)
            self._f.write(json.dumps(row) + "\n")
            self._f.flush()
            self.rows_written += 1
            if self.rows_written % max(1, self.max_rows) == 0 \
                    and not final:
                self._rotate()

    def _rotate(self) -> None:
        """Cap the file: the generation chain shifts one step (the
        oldest past `rotate` is dropped), appends continue fresh."""
        self._f.close()
        rotate_files(self.path, self.rotate)
        self._f = open(self.path, "a")
        self.rotations += 1


# -- module registry (the obs.finish / exit-flush seam) ----------------
def start(path: str, interval: float = DEFAULT_INTERVAL,
          max_rows: int = DEFAULT_MAX_ROWS,
          extra: Optional[Dict[str, Any]] = None,
          rotate: int = DEFAULT_ROTATE) -> FlightRecorder:
    """Start (or return the already-running) recorder for `path`."""
    with _REG_LOCK:
        rec = _ACTIVE.get(path)
        if rec is not None:
            return rec
        rec = FlightRecorder(path, interval=interval, max_rows=max_rows,
                             extra=extra, rotate=rotate)
        _ACTIVE[path] = rec
        _EVER.add(path)
    rec.start()
    return rec


def active_for(path: str) -> Optional[FlightRecorder]:
    with _REG_LOCK:
        return _ACTIVE.get(path)


def had_recorder(path: str) -> bool:
    with _REG_LOCK:
        return path in _EVER


def stop(path: Optional[str] = None) -> None:
    """Stop the recorder for `path` (or every active one)."""
    with _REG_LOCK:
        recs = ([_ACTIVE[path]] if path is not None and path in _ACTIVE
                else list(_ACTIVE.values()) if path is None else [])
    for rec in recs:
        rec.stop()
