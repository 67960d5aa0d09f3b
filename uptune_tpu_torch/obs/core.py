"""Span/event recording core: per-thread lock-free ring buffers.

The unified observability plane's hot half.  Every instrumented plane
(driver ticket lifecycle, WorkerPool slots, the background refit
thread, the store, the engine step loop) calls the tiny module-level
API here; `uptune_tpu_torch.obs.export` turns the recorded rings into a
Perfetto-viewable Chrome trace, a metrics JSONL, and a text summary.
The port's copy of `uptune_tpu/obs/core.py`; only `device_span` differs.

Design constraints:

* **Disabled is free.**  `_ENABLED` is a module-level bool checked
  FIRST in every entry point; the disabled path allocates nothing —
  `span()` returns one shared no-op singleton, `event()`/`count()`
  return immediately.  The driver plane runs thousands of asks a
  second and instrumentation that is off must not tax it.
* **Enabled is lock-free on the record path.**  Each thread owns its
  own `_Ring` (created once under `_REG_LOCK`, then written without
  any lock): one writer per buffer by construction, so concurrent
  driver + refit-thread + pool bookkeeping never contend or interleave.
  Readers (the exporter) snapshot `buf[:]` + `idx` — under the GIL the
  slot write at `buf[i % cap]` happens-before the `idx` bump, so a
  snapshot never observes a torn record, at worst it misses the very
  newest one.
* **Bounded.**  Rings are fixed-capacity (default 2^16 records); past
  capacity the oldest records are overwritten and `dropped` counts
  them, so a week-long serve process can leave tracing on without
  growing without bound.

Records are plain tuples ``(name, ts, dur, track, attrs)``:

* ``ts``     — seconds since `enable()` (perf_counter timebase;
  `to_unix_ns` maps it to `time.time_ns()`'s clock, the one
  ``torch.profiler`` stamps a device trace in);
* ``dur``    — span length in seconds, or None for an instant event;
* ``track``  — explicit lane name (worker slots, synthetic lanes), or
  None for "the thread that recorded it";
* ``attrs``  — small JSON-safe dict or None.
"""
from __future__ import annotations

import itertools
import os
import sys
import threading
import time
from typing import Any, Dict, List, Optional

__all__ = [
    "enabled", "enable", "disable", "reset", "span", "device_span",
    "event", "complete_span", "emit_at", "new_span_id", "snapshot",
    "trace_origin_unix", "to_unix_ns", "DEFAULT_CAPACITY",
]

DEFAULT_CAPACITY = 1 << 16

_ENABLED = False
_T0 = 0.0            # perf_counter at enable(): the trace origin
_T0_UNIX = 0.0       # wall-clock at enable() (for artifact metadata)
_T0_UNIX_NS = 0      # time_ns() read with _T0 (`to_unix_ns`)
_CAPACITY = DEFAULT_CAPACITY

_REG_LOCK = threading.Lock()
_RINGS: List["_Ring"] = []
_TLS = threading.local()
# bumped on every enable()/reset(): a thread whose cached ring carries
# an older epoch re-registers on its next record, so threads that
# outlive an enable cycle (the refit worker) can't write into a ring
# the exporter no longer sees
_EPOCH = 0


class _Ring:
    """One thread's record buffer.  Single writer (the owning thread);
    `snapshot()` may run from any thread."""

    __slots__ = ("buf", "idx", "cap", "track", "epoch")

    def __init__(self, cap: int, track: str, epoch: int):
        self.buf: List[Optional[tuple]] = [None] * cap
        self.idx = 0
        self.cap = cap
        self.track = track
        self.epoch = epoch

    def append(self, rec: tuple) -> None:
        i = self.idx
        self.buf[i % self.cap] = rec
        self.idx = i + 1   # publish AFTER the slot write (GIL ordering)

    @property
    def dropped(self) -> int:
        return max(0, self.idx - self.cap)

    def snapshot(self) -> List[tuple]:
        """Recorded tuples, oldest first (complete records only)."""
        i, cap = self.idx, self.cap
        buf = self.buf[:]
        if i <= cap:
            return [r for r in buf[:i] if r is not None]
        head = i % cap
        out = buf[head:] + buf[:head]
        return [r for r in out if r is not None]


def _ring() -> _Ring:
    r = getattr(_TLS, "ring", None)
    if r is None or r.epoch != _EPOCH:
        t = threading.current_thread()
        r = _Ring(_CAPACITY, t.name, _EPOCH)
        _TLS.ring = r
        with _REG_LOCK:
            _RINGS.append(r)
    return r


# ---------------------------------------------------------------- flag
def enabled() -> bool:
    return _ENABLED


def enable(capacity: int = DEFAULT_CAPACITY) -> None:
    """Start recording.  Existing rings are cleared so a fresh enable
    always exports one coherent run."""
    global _ENABLED, _T0, _T0_UNIX, _T0_UNIX_NS, _CAPACITY, _EPOCH
    with _REG_LOCK:
        _RINGS.clear()
        _EPOCH += 1
    # other threads' cached rings cannot be cleared from here; the
    # epoch bump makes them re-register on their next record instead
    _CAPACITY = int(capacity)
    t0_ns, _T0_UNIX_NS = _origin_pair()
    _T0 = t0_ns / 1e9
    _T0_UNIX = _T0_UNIX_NS / 1e9
    _ENABLED = True
    from . import device as _d
    from . import metrics as _m
    _m.reset()
    _d.reset_registry()


def _origin_pair():
    """(perf_counter_ns, time_ns) read back to back: of five tries, the
    pair whose two perf_counter reads around time_ns() lie closest, with
    time_ns() set against their midpoint."""
    best = None
    for _ in range(5):
        a = time.perf_counter_ns()
        u = time.time_ns()
        b = time.perf_counter_ns()
        if best is None or b - a < best[0]:
            best = (b - a, (a + b) // 2, u)
    return best[1], best[2]


def disable() -> None:
    global _ENABLED
    _ENABLED = False


def reset() -> None:
    """Disable AND drop every recorded ring/metric (test isolation)."""
    global _ENABLED, _EPOCH
    _ENABLED = False
    with _REG_LOCK:
        _RINGS.clear()
        _EPOCH += 1
    from . import device as _d
    from . import metrics as _m
    _m.reset()
    _d.reset_registry()


def now() -> float:
    """Seconds since the trace origin (0.0 when disabled)."""
    return time.perf_counter() - _T0 if _ENABLED else 0.0


def trace_origin_unix() -> float:
    return _T0_UNIX


def to_unix_ns(ts: float) -> int:
    """A record's ``ts`` (seconds since the trace origin) on
    `time.time_ns()`'s clock, the clock ``torch.profiler`` stamps its
    device events in: host spans laid over a device trace."""
    return _T0_UNIX_NS + round(ts * 1e9)


def _record(rec: tuple) -> None:
    _ring().append(rec)


# ---------------------------------------------------------------- spans
class _Noop:
    """Shared do-nothing span: the disabled fast path allocates
    nothing — every disabled `span()` call returns this singleton."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def set(self, **attrs):
        return self


NOOP = _Noop()


class _Span:
    __slots__ = ("name", "t0", "attrs", "_annot")

    def __init__(self, name: str, attrs: Optional[Dict[str, Any]],
                 annot=None):
        self.name = name
        self.attrs = attrs
        self._annot = annot
        self.t0 = time.perf_counter()

    def set(self, **attrs) -> "_Span":
        """Attach/overwrite attributes after entry (e.g. a row count
        known only at exit)."""
        if self.attrs is None:
            self.attrs = attrs
        else:
            self.attrs.update(attrs)
        return self

    def __enter__(self) -> "_Span":
        if self._annot is not None:
            self._annot.__enter__()
        return self

    def __exit__(self, *exc) -> bool:
        t1 = time.perf_counter()
        if self._annot is not None:
            self._annot.__exit__(*exc)
        _record((self.name, self.t0 - _T0, t1 - self.t0, None,
                 self.attrs))
        return False


def span(name: str, **attrs):
    """``with obs.span("propose", arm=name):`` — one timed span on the
    calling thread's lane.  Returns the shared no-op when disabled."""
    if not _ENABLED:
        return NOOP
    return _Span(name, attrs or None)


def device_span(name: str, **attrs):
    """A span that ALSO opens a `torch.profiler.record_function` range,
    so when a torch.profiler capture runs alongside (`obs.device.
    start_trace`), host spans line up with the CUDA kernels they
    launched.  The range is opened only when torch is already imported
    (`sys.modules`): the plane never imports it, so a tuned program's
    child process stays free of it.  No-op when disabled; a plain span
    without torch."""
    if not _ENABLED:
        return NOOP
    annot = None
    torch = sys.modules.get("torch")
    if torch is not None:
        try:
            annot = torch.profiler.record_function(name)
        except Exception:
            pass
    return _Span(name, attrs or None, annot)


def event(name: str, **attrs) -> None:
    """Instant event on the calling thread's lane."""
    if not _ENABLED:
        return
    _record((name, time.perf_counter() - _T0, None, None, attrs or None))


def complete_span(name: str, t0: float, dur: float,
                  track: Optional[str] = None, **attrs) -> None:
    """Record an already-measured span, optionally on an explicit lane
    (`track`) — how WorkerPool build windows land on per-slot lanes:
    the driver thread emits them at reap time with the slot's own
    launch timestamp.  `t0` is a raw perf_counter() value."""
    if not _ENABLED:
        return
    _record((name, t0 - _T0, max(0.0, dur), track, attrs or None))


def emit_at(name: str, ts: float, dur: Optional[float] = None,
            track: Optional[str] = None,
            attrs: Optional[Dict[str, Any]] = None) -> None:
    """Record an event/span at an EXPLICIT trace-relative timestamp
    (seconds since this process's trace origin) — the foreign-clock
    entry point: a subprocess sidecar's events are re-emitted here
    after their unix-clock offset against our origin is applied
    (`obs.sidecar.merge_into`).  `dur=None` records an instant."""
    if not _ENABLED:
        return
    _record((name, float(ts),
             None if dur is None else max(0.0, float(dur)),
             track, attrs or None))


# span/trace ids for cross-process context propagation: unique within
# a process by the counter, across processes by the pid prefix (good
# enough to join one client's request span to one server handler span
# in a merged trace — not a cryptographic trace id)
_SPAN_SEQ = itertools.count(1)


def new_span_id() -> str:
    return f"{os.getpid():x}-{next(_SPAN_SEQ):x}"


# ------------------------------------------------------------- reading
def snapshot() -> Dict[str, Any]:
    """All recorded events plus ring bookkeeping.

    Returns ``{"events": [...], "dropped": {track: n}, "origin_unix",
    "origin_unix_ns"}`` where each event is
    ``{"name", "ts", "dur"|None, "track", "attrs"|None}`` and ``ts`` /
    ``dur`` are seconds since the trace origin (`to_unix_ns` maps a
    ``ts`` to nanoseconds on `time.time_ns()`'s clock).  Events are
    sorted by timestamp across tracks."""
    with _REG_LOCK:
        rings = list(_RINGS)
    events = []
    dropped: Dict[str, int] = {}
    for r in rings:
        if r.dropped:
            dropped[r.track] = dropped.get(r.track, 0) + r.dropped
        for name, ts, dur, track, attrs in r.snapshot():
            events.append({"name": name, "ts": ts, "dur": dur,
                           "track": track or r.track, "attrs": attrs})
    events.sort(key=lambda e: e["ts"])
    return {"events": events, "dropped": dropped,
            "origin_unix": _T0_UNIX, "origin_unix_ns": _T0_UNIX_NS}
