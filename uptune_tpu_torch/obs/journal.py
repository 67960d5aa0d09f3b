"""Tuning journal: an append-only JSONL stream of search *decisions*.

Where the span rings (`obs.core`) answer "what ran when" and the
metrics registry answers "how much, in aggregate", the journal answers
the search-quality questions neither can: which arm proposed each
config, what the surrogate *believed* about it at propose time, what
the build actually measured, which rows the dedup/prune/screen layers
dropped, when the store served a build for free — the reference
framework's CSV archive + SQLite result sync, re-shaped as one typed
event stream.

Same contract as the rest of the obs plane:

* **Disabled is free.**  `_ENABLED` is a module-level bool checked
  FIRST in every `emit`; the disabled path allocates nothing.  The
  instrumented call sites (driver ticket lifecycle, store serve path,
  serve-session commits, surrogate publishes) stay in the hot paths
  permanently; the enabled path is held to >= 0.95x of the disabled
  driver's throughput with the journal active (`chip_smoke.py`'s obs
  phase prints the ratio on the card).
* **Off the device hot path.**  `emit` serializes one small dict to a
  string and appends it to an in-memory buffer under a short lock; the
  file write happens every `_FLUSH_EVERY` rows (and at `stop()`), in
  whichever *host* thread crossed the threshold — never inside a
  device dispatch.  A journal row is ~hundreds of bytes at per-ticket
  / per-tell frequency (hundreds/s), not per-candidate.
* **Torn-tail tolerant.**  `read()` skips unparseable trailing lines,
  so a journal from a crashed run replays up to its last complete row
  (the same rule as the trial archive and the flight recorder).

File format: one header line
``{"journal": 1, "origin_unix": ..., "pid": ..., "meta": {...}}``
then one JSON object per event: ``{"ev": <kind>, "t": <seconds since
start>, ...}``.  The event taxonomy lives in docs/OBSERVABILITY.md
("Search-quality telemetry").

Sinks: `add_sink(fn)` registers a callable receiving every emitted row
dict *before* serialization — how `obs.quality.QualityMonitor` derives
live convergence/calibration gauges from the same rows the file gets,
which is what makes its online values exactly reproducible offline
(`quality.replay` feeds the file's rows through the same code).
"""
from __future__ import annotations

import json
import os
import threading
import time
from typing import Any, Callable, Dict, List, Optional, Tuple

__all__ = ["enabled", "start", "stop", "emit", "emit_row", "flush",
           "path", "add_sink", "remove_sink", "read", "step_tells",
           "disabled_token", "SCHEMA_VERSION", "EVENT_KINDS",
           "DISABLED_TOKENS"]

SCHEMA_VERSION = 1

# the ONE disable vocabulary for journal paths — shared by the `ut`
# and `ut serve` --journal flags, UT_JOURNAL, and ut.config('journal')
# so the surfaces can never diverge on what "off" spells
DISABLED_TOKENS = ("0", "off", "false", "none")


def disabled_token(val) -> bool:
    """True when `val` spells "no journal" (None counts)."""
    return val is None or str(val).strip().lower() in DISABLED_TOKENS

# the closed event vocabulary; `read(strict=True)` (and the committed
# example's tier-1 test) reject rows outside it so the offline tools
# and the online monitor can never silently disagree about the stream.
# Per-TRIAL outcomes ride the `step` row as parallel arrays (qors,
# plus mus / sigmas when the surrogate was fitted at propose time):
# one JSON row per *ticket* keeps emission ~2 us/trial on the driver
# hot path where one row per trial measured ~15 us — the difference
# between holding and losing the >= 0.95x bar on a 1-core
# box.  Arrays at their default are OMITTED (compact encoding):
# absent `ok` = all true, absent `nb` = all false, absent `durs` =
# all zero, and contiguous gids collapse to `gid0` (else `gids`);
# `qors` is always present and defines the trial count
EVENT_KINDS = (
    "step",         # one ticket finalized: the arm pull's dedup /
                    # prune / filter verdicts (src, batch, trials,
                    # dup, filtered — captured at propose time),
                    # per-trial outcome arrays, credit, incumbent
    "store_hit",    # a build served from the result store
    "exchange",     # a sibling instance's best injected
    "federate",     # sibling (config, qor) rows fed to the surrogate
    "snapshot",     # surrogate snapshot published
    "feature",      # ut.feature covariates observed by a trial
    "interm",       # ut.interm intermediate feature vector
    "serve_tell",   # one serve-session tell (per-tenant stream)
)

_FLUSH_EVERY = 128

# one reusable encoder: ~25% cheaper per row than json.dumps (which
# re-resolves options per call) on the per-ticket emit path
_ENC = json.JSONEncoder(separators=(",", ":"),
                        check_circular=False).encode

_ENABLED = False
_T0 = 0.0
_PATH: Optional[str] = None
_F = None
_BUF: List[str] = []
_LOCK = threading.Lock()
_SINKS: List[Callable[[Dict[str, Any]], None]] = []


def enabled() -> bool:
    return _ENABLED


def path() -> Optional[str]:
    return _PATH


def start(out_path: str,
          meta: Optional[Dict[str, Any]] = None) -> str:
    """Open the journal at `out_path` (truncating — one file is one
    run) and write the header line.  Idempotent per path: starting the
    already-active path returns it unchanged; starting a different
    path stops the previous journal first."""
    global _ENABLED, _T0, _PATH, _F
    with _LOCK:
        if _ENABLED and _PATH == out_path:
            return out_path
    if _ENABLED:
        stop()
    f = open(out_path, "w")
    hdr = {"journal": SCHEMA_VERSION, "origin_unix": time.time(),
           "pid": os.getpid(), "meta": dict(meta or {})}
    f.write(json.dumps(hdr) + "\n")
    f.flush()
    with _LOCK:
        _F = f
        _PATH = out_path
        _BUF.clear()
        _T0 = time.perf_counter()
        _ENABLED = True
    return out_path


def stop() -> Optional[str]:
    """Flush and close; returns the path that was active.  Sinks stay
    registered — they belong to the caller, not the file."""
    global _ENABLED, _PATH, _F
    with _LOCK:
        _ENABLED = False
        f, p = _F, _PATH
        buf = _BUF[:]
        _BUF.clear()
        _F = None
        _PATH = None
        if f is not None:
            try:
                if buf:
                    f.write("".join(buf))
                f.close()
            except OSError:
                pass    # disk gone: journaling is best-effort
    return p


def add_sink(fn: Callable[[Dict[str, Any]], None]) -> None:
    with _LOCK:
        if fn not in _SINKS:
            _SINKS.append(fn)


def remove_sink(fn: Callable[[Dict[str, Any]], None]) -> None:
    with _LOCK:
        try:
            _SINKS.remove(fn)
        except ValueError:
            pass


def emit(ev: str, **fields: Any) -> None:
    """Record one event.  Every value must already be JSON-safe (the
    instrumented call sites cast device scalars to python floats
    and ints — the journal never touches a device buffer)."""
    if not _ENABLED:
        return
    # the kwargs dict IS the row (emit owns it): no second dict merge
    # on the hot path
    fields["ev"] = ev
    emit_row(fields)


def emit_row(row: Dict[str, Any]) -> None:
    """`emit` for callers that already hold the row dict (must carry
    "ev"; ownership transfers to the journal).  The driver's step
    emission uses this: re-packing ~20 fields through kwargs was
    measurable against the hot-path budget."""
    if not _ENABLED:
        return
    row["t"] = round(time.perf_counter() - _T0, 6)
    line = _ENC(row) + "\n"
    with _LOCK:
        if not _ENABLED:        # stop() raced us: drop, don't crash
            return
        _BUF.append(line)
        # sinks run UNDER the lock, so the online monitor folds rows
        # in exactly the order the file records them — concurrent
        # emitters (serve tenant threads, the async refit worker's
        # snapshot rows vs driver steps) must not be able to reorder
        # the monitor against the file, or the bit-exact
        # online == replay contract (obs/quality.py) breaks.  The
        # driver emit path is single-threaded, so this serializes
        # nothing there; no sink acquires this lock re-entrantly
        # (metrics/ring locks are leaf locks).
        for fn in _SINKS:
            fn(row)
        if len(_BUF) >= _FLUSH_EVERY:
            _write_locked()


def flush() -> None:
    with _LOCK:
        _write_locked()


def _write_locked() -> None:
    """Drain the buffer to disk.  Caller holds _LOCK — one lock keeps
    the buffer, the file handle, and stop() coherent (the registry-
    lock pattern of obs.metrics); the write itself is one buffered
    "".join at per-128-rows frequency, microseconds next to the
    per-ticket cadence feeding it."""
    if _F is None or not _BUF:
        return
    try:
        _F.write("".join(_BUF))
        _F.flush()
    except OSError:
        pass            # disk gone: best-effort
    _BUF.clear()


def step_tells(row: Dict[str, Any]):
    """Decode one step row's compact per-trial arrays into
    ``(gid, ok, qor, nb, dur, mu, sigma)`` tuples — THE reference
    decoder for the compact encoding documented on EVENT_KINDS
    (absent ``ok`` = all true, ``nb`` = all false, ``durs`` = all
    zero, contiguous ids as ``gid0``).  Offline consumers
    (`obs.report`) route through here; `QualityMonitor._on_step`
    keeps a fused inline copy of the SAME semantics for the hot path
    — an encoding change must update both or the report's tell table
    silently disagrees with the replayed gauges beside it."""
    qors = row.get("qors") or ()
    gids = row.get("gids")
    gid0 = row.get("gid0", 0)
    oks = row.get("ok")
    nbs = row.get("nb")
    durs = row.get("durs")
    mus = row.get("mus")
    sigmas = row.get("sigmas")
    for i in range(len(qors)):
        yield (gids[i] if gids is not None else gid0 + i,
               True if oks is None else oks[i],
               qors[i],
               False if nbs is None else nbs[i],
               0.0 if durs is None else durs[i],
               None if mus is None else mus[i],
               None if sigmas is None else sigmas[i])


def read(journal_path: str, strict: bool = False
         ) -> Tuple[Dict[str, Any], List[Dict[str, Any]]]:
    """(header, rows) from a journal file.  Unparseable trailing lines
    (a torn tail from a crashed writer) are dropped; `strict=True`
    raises ValueError on a bad header, an unknown event kind, or a
    torn row that is NOT the final line — the schema validation the
    committed example artifact is held to."""
    header: Dict[str, Any] = {}
    rows: List[Dict[str, Any]] = []
    bad_at: Optional[int] = None
    with open(journal_path) as f:
        for i, line in enumerate(f):
            line = line.strip()
            if not line:
                continue
            try:
                rec = json.loads(line)
            except json.JSONDecodeError:
                bad_at = i
                continue
            if bad_at is not None and strict:
                raise ValueError(
                    f"{journal_path}:{bad_at + 1}: torn row in the "
                    f"middle of the stream")
            if i == 0 and "journal" in rec:
                header = rec
                continue
            if not isinstance(rec, dict) or "ev" not in rec:
                if strict:
                    raise ValueError(
                        f"{journal_path}:{i + 1}: not an event row: "
                        f"{line[:80]}")
                continue
            if strict and rec["ev"] not in EVENT_KINDS:
                raise ValueError(
                    f"{journal_path}:{i + 1}: unknown event kind "
                    f"{rec['ev']!r}; known: {EVENT_KINDS}")
            rows.append(rec)
    if strict:
        if header.get("journal") != SCHEMA_VERSION:
            raise ValueError(
                f"{journal_path}: missing/unsupported journal header "
                f"(want version {SCHEMA_VERSION}, got "
                f"{header.get('journal')!r})")
    return header, rows
