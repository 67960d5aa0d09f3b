"""Unified observability plane: cross-plane span tracing + metrics.

The port's counterpart of `uptune_tpu/obs/`, with the same public
names.  Every asynchronous plane (the driver's prefetch, the store, the
background refit, the worker pool, the engines) is instrumented through
this package's tiny module-level API:

    from uptune_tpu_torch import obs

    with obs.span("ticket.propose", arm=name):   # timed span
        ...
    obs.event("ticket.open", gid=gid)            # instant event
    obs.count("store.hit")                       # counter
    obs.gauge("prefetch.depth", len(queue))      # gauge
    obs.observe("store.serve_ms", dt * 1e3)      # histogram

Everything is a no-op until `obs.enable()` (or a `--trace` / `UT_TRACE`
run): the disabled path is one module-flag check and allocates nothing,
so instrumentation stays in the hot paths permanently (`chip_smoke.py`'s
obs phase prints the enabled path's cost on the card).  When enabled,
each thread
records into its own lock-free ring buffer; exporters turn the rings
into a Perfetto-viewable Chrome trace (one lane per thread / worker
slot), a metrics JSONL, and a text summary.  See docs/OBSERVABILITY.md
for the span taxonomy and metric names (the same here).

The plane imports neither torch nor numpy at module level: a tuned
program's child process imports it (through `api/state.py`) and must
stay light.  `hub` (the fleet collector, `ut-torch hub`) and `top` (the
dashboard, `ut-torch top`) are modules of the package, not names of
this surface, as in the JAX package: they ride the serving plane's wire.
"""
from __future__ import annotations

import os
from typing import Any, Dict, Optional

from . import device, faults, flight, journal, quality, ship
from .core import (DEFAULT_CAPACITY, complete_span, device_span,
                   disable, emit_at, enable, enabled, event,
                   new_span_id, now, reset, snapshot, span,
                   trace_origin_unix)
# the port's own: a record's ts on the device trace's clock (not in
# `__all__`, which is the reference's)
from .core import to_unix_ns  # noqa: F401
from .export import (chrome_trace, prometheus_text, text_summary,
                     validate_trace, write_metrics_jsonl, write_trace)
from .metrics import count, counter_value, gauge, observe
from .metrics import snapshot as metrics_snapshot
from .metrics import window_snapshot

__all__ = [
    "enabled", "enable", "disable", "reset", "span", "device_span",
    "event", "complete_span", "emit_at", "new_span_id", "count",
    "gauge", "observe", "snapshot", "metrics_snapshot",
    "window_snapshot", "chrome_trace", "write_trace",
    "write_metrics_jsonl", "prometheus_text", "text_summary",
    "validate_trace", "now", "trace_origin_unix",
    "maybe_enable_from_env", "finish", "start_flight_recorder",
    "install_exit_flush", "instrument_device_fn", "DEFAULT_CAPACITY",
    "journal", "quality", "start_journal", "stop_journal",
    "maybe_journal_from_env", "device", "faults", "flight", "ship",
]


def start_journal(path: str, meta: Optional[Dict[str, Any]] = None,
                  monitor: bool = True):
    """Start the tuning journal (obs.journal) and, by default, attach
    a publishing `QualityMonitor` so convergence/calibration gauges
    ride the metrics registry, the flight recorder, and `ut top`'s
    search panel for free (docs/OBSERVABILITY.md "Search-quality
    telemetry").  Returns the monitor (or None)."""
    journal.start(path, meta=meta)
    return quality.attach() if monitor else None


def stop_journal(mon=None) -> Optional[str]:
    """Flush + close the journal; detaches `mon` when given."""
    if mon is not None:
        quality.detach(mon)
    return journal.stop()


def maybe_journal_from_env(env: Optional[dict] = None):
    """`UT_JOURNAL=<path>` starts the tuning journal for this process
    (the CLI's `--journal` flag layers above it).  Returns the
    attached QualityMonitor, or None when unset/disabled."""
    e = os.environ if env is None else env
    val = e.get("UT_JOURNAL", "").strip()
    if not val or journal.disabled_token(val):
        return None
    return start_journal(val)


def instrument_device_fn(fn, name: str, **attrs):
    """Wrap a device-dispatching callable so every invocation records a
    `device_span` (host span + torch.profiler range) — the engine
    plane's seam: a step, an arm's proposal, a dedup or a commit is the
    observability unit.  The wrapper is also the device-telemetry point
    (`obs.device`): while tracing is on each call's window on the current
    CUDA stream is timed with events and the per-program registry and
    `device.*` metrics are kept; when tracing is disabled the wrapper
    costs one flag check."""
    return device.instrument(fn, name, **attrs)


def maybe_enable_from_env(env: Optional[dict] = None) -> Optional[str]:
    """`UT_TRACE=<path>` turns tracing on for this process (the
    `ut-torch` CLI hook; the CLI's `--trace` flag and `ut.config('trace')`
    layer above it).  Returns the trace output path when enabled,
    None otherwise.  `UT_TRACE=1` enables recording without a
    default output path (callers export explicitly)."""
    e = os.environ if env is None else env
    val = e.get("UT_TRACE", "").strip()
    if not val or val.lower() in ("0", "off", "false", "none"):
        return None
    enable()
    return None if val.lower() in ("1", "true", "yes", "on") else val


def finish(path: Optional[str],
           extra: Optional[Dict[str, Any]] = None,
           metrics_path: Optional[str] = None) -> Optional[dict]:
    """End-of-run export: write the Chrome trace to `path` and settle
    the metrics sidecar next to it (`<path>.metrics.jsonl` unless
    `metrics_path` overrides) — when a flight recorder is running on
    that sidecar it is stopped (writing its final timeline row);
    otherwise one legacy metrics-snapshot line is appended.  Returns
    the trace document.  A None path skips the files (summary-only
    callers).  Recording stays enabled — callers own
    disable()/reset()."""
    if not enabled():
        return None
    doc = None
    if path:
        doc = write_trace(path, extra=extra)
        mpath = metrics_path or path + ".metrics.jsonl"
        rec = flight.active_for(mpath)
        if rec is not None:
            rec.stop()
        elif not flight.had_recorder(mpath):
            write_metrics_jsonl(mpath,
                                extra={"trace": os.path.basename(path)})
        # this path is settled: the exit-flush hook must not overwrite
        # the document (it would drop caller extras like the
        # trace-guard report written on the clean path)
        _FLUSH_REGISTRY.pop(path, None)
    return doc


def start_flight_recorder(trace_path: str,
                          interval: float = flight.DEFAULT_INTERVAL,
                          metrics_path: Optional[str] = None,
                          max_rows: int = flight.DEFAULT_MAX_ROWS,
                          rotate: int = flight.DEFAULT_ROTATE
                          ) -> "flight.FlightRecorder":
    """Start the periodic metrics timeline for a traced run, on the
    same `<trace>.metrics.jsonl` sidecar `finish()` settles (so the
    one-shot scrape becomes a timeline, not a second file).  `ut top
    --metrics <sidecar>` tails it live; `interval <= 0` is rejected by
    the caller layer ('off').  `rotate` is the generation-chain depth
    kept past the row cap (`--metrics-rotate`; default 1, the
    historical single-`.1` behavior)."""
    return flight.start(metrics_path or trace_path + ".metrics.jsonl",
                        interval=interval, max_rows=max_rows,
                        extra={"trace": os.path.basename(trace_path)},
                        rotate=rotate)


# ------------------------------------------------------- exit flushing
# a run interrupted by ^C (or a supervisor's SIGTERM) must still leave
# a valid — merely truncated — trace and a metrics tail on disk.  The
# registry maps trace path -> extra dict; one set of hooks flushes all.
_FLUSH_REGISTRY: Dict[str, Dict[str, Any]] = {}
_FLUSH_STATE: Dict[str, Any] = {"hooked": False, "flushing": False,
                                "reason": None}


def _flush_all(reason: str) -> None:
    if _FLUSH_STATE["flushing"]:
        return              # re-entrant call during a flush
    _FLUSH_STATE["flushing"] = True
    try:
        for path, extra in list(_FLUSH_REGISTRY.items()):
            try:
                finish(path, extra={**extra, "flushed_on": reason})
            except OSError:
                pass        # output dir vanished: nothing to save to
        # the tuning journal's buffered tail rides the same graceful
        # flush: an interrupted run keeps its search telemetry too
        journal.flush()
        # and the fleet shipper's final window: a SIGTERM'd process
        # ships its terminal counters before the interpreter dies, so
        # the hub's exactness contract (fleet counters == the sum of
        # per-source finals) holds through graceful shutdowns
        ship.stop()
        # an active torch.profiler capture must also settle, or the
        # device trace is lost on exactly the failed/^C runs one most
        # wants to profile (stop_trace is idempotent-safe when no
        # capture is active)
        try:
            device.stop_trace()
        except Exception:
            pass
    finally:
        _FLUSH_STATE["flushing"] = False


def _flush_atexit() -> None:
    _flush_all(_FLUSH_STATE["reason"] or "atexit")


def install_exit_flush(path: Optional[str],
                       extra: Optional[Dict[str, Any]] = None) -> None:
    """Register `path` for graceful telemetry flushing: the trace (and
    the flight recorder's final row) is written at interpreter exit,
    not only on the clean end-of-run `finish()` path — including exits
    forced by SIGINT/SIGTERM.  `path=None` installs the hooks without
    registering a trace — the journal-without-trace shape: a SIGTERM'd
    `ut serve --journal` must still flush its buffered journal tail
    (and unwind through the server's own finally), even though there
    is no trace document to write.  The signal handlers themselves do NO
    I/O and take NO locks: a Python signal handler runs on the main
    thread between bytecodes, possibly inside a frame that already
    holds the (non-reentrant) metrics/ring locks the flush needs, so
    flushing inline could deadlock the very ^C it serves.  Instead the
    handler records the reason and unwinds (KeyboardInterrupt /
    SystemExit), and the atexit hook — running after the stack, and
    therefore every lock, is released — performs the actual flush,
    tagged with the recorded signal.  Handlers chain to whatever was
    installed before (default SIGINT behavior is preserved);
    installation is skipped silently off the main thread, where Python
    forbids signal handlers.  Idempotent per path."""
    import atexit
    import signal
    import sys

    if path is not None:
        _FLUSH_REGISTRY[path] = dict(extra or {})
    if _FLUSH_STATE["hooked"]:
        return
    _FLUSH_STATE["hooked"] = True
    atexit.register(_flush_atexit)

    def _chain(sig, prev):
        def handler(signum, frame):
            _FLUSH_STATE["reason"] = f"signal:{signum}"
            if callable(prev):
                prev(signum, frame)
            elif signum == signal.SIGINT:
                raise KeyboardInterrupt
            else:
                sys.exit(128 + signum)
        return handler

    for sig in (signal.SIGINT, signal.SIGTERM):
        try:
            signal.signal(sig, _chain(sig, signal.getsignal(sig)))
        except (ValueError, OSError):
            pass            # non-main thread / unsupported platform
