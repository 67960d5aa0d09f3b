"""Metrics registry: counters, gauges, histograms.

The scrape-able half of the observability plane: where spans answer
"what happened when", metrics answer "how much, in aggregate" — store
hit rates, worker utilization, prefetch queue depth, snapshot
version/refit lag, dedup collisions, engine acquisition rates.  The
session server (the serving plane) serves `snapshot()`
as its ``{"op": "metrics"}`` scrape payload — the seam this module
was written for; `uptune_tpu_torch.obs.export` also writes it as one JSONL
line per run and folds it into the text summary.

Same contract as the span core: every update checks the core's
module-level enabled flag first and returns immediately when tracing
is off, so instrumented hot paths cost one predicate when disabled.
Updates take one small module lock — metric updates are per-ticket /
per-build frequency (hundreds/s), not per-candidate, so contention is
irrelevant next to correctness, and a lock keeps read-modify-write
counters exact under the driver + refit + pool threads.

Histograms keep exact count/sum/min/max forever and the FIRST
`_HIST_CAP` raw samples for percentile estimation; a summary never
lies about totals, only its percentiles degrade to "of the first N"
on very long runs.
"""
from __future__ import annotations

import threading
from typing import Any, Dict, List, Optional

from . import core

__all__ = ["count", "gauge", "observe", "snapshot", "window_snapshot",
           "reset", "counter_value"]

_LOCK = threading.Lock()
_COUNTERS: Dict[str, float] = {}
_GAUGES: Dict[str, float] = {}
_HISTS: Dict[str, "_Hist"] = {}
_HIST_CAP = 8192


class _Hist:
    __slots__ = ("n", "total", "vmin", "vmax", "samples")

    def __init__(self):
        self.n = 0
        self.total = 0.0
        self.vmin = float("inf")
        self.vmax = float("-inf")
        self.samples: List[float] = []

    def add(self, v: float) -> None:
        self.n += 1
        self.total += v
        if v < self.vmin:
            self.vmin = v
        if v > self.vmax:
            self.vmax = v
        if len(self.samples) < _HIST_CAP:
            self.samples.append(v)

    def summary(self) -> Dict[str, Any]:
        out = {"count": self.n, "sum": round(self.total, 6),
               "min": round(self.vmin, 6), "max": round(self.vmax, 6),
               "mean": round(self.total / self.n, 6) if self.n else None}
        if self.samples:
            s = sorted(self.samples)
            for p in (50, 95, 99):
                out[f"p{p}"] = round(s[min(len(s) - 1,
                                           (len(s) * p) // 100)], 6)
            if self.n > len(self.samples):
                out["sampled"] = len(self.samples)
        return out


def count(name: str, n: float = 1) -> None:
    """Increment a monotonic counter."""
    if not core._ENABLED:
        return
    with _LOCK:
        _COUNTERS[name] = _COUNTERS.get(name, 0) + n


def gauge(name: str, value: float) -> None:
    """Set a last-value-wins gauge."""
    if not core._ENABLED:
        return
    with _LOCK:
        _GAUGES[name] = value


def observe(name: str, value: float) -> None:
    """Add one observation to a histogram."""
    if not core._ENABLED:
        return
    with _LOCK:
        h = _HISTS.get(name)
        if h is None:
            h = _HISTS[name] = _Hist()
        h.add(value)


def counter_value(name: str) -> float:
    with _LOCK:
        return _COUNTERS.get(name, 0)


def snapshot() -> Dict[str, Any]:
    """One self-contained metrics snapshot (the JSONL row / scrape
    payload): ``{"counters": {...}, "gauges": {...},
    "hists": {name: summary}}``."""
    with _LOCK:
        return {
            "counters": dict(_COUNTERS),
            "gauges": dict(_GAUGES),
            "hists": {k: h.summary() for k, h in _HISTS.items()},
        }


def window_snapshot(cursor: Optional[Dict[str, Any]] = None):
    """One flight-recorder row: the absolute scrape PLUS what changed
    since `cursor` (the previous call's second return value).

    Returns ``(row, new_cursor)`` where ``row`` is
    ``{"counters": abs, "deltas": {name: since-cursor}, "gauges": abs,
    "hists": {name: window summary}}``.  A histogram's window summary
    reports ``count``/``sum`` for the whole run and
    ``window_count``/``window_sum``/``p50``/``p95`` over ONLY the
    samples recorded since the cursor — so a long-lived server's
    timeline shows each interval's latency distribution, not an
    ever-flattening lifetime percentile.  (Past `_HIST_CAP` retained
    samples the window percentiles go None while the window counts
    stay exact — same honesty rule as `_Hist.summary`.)

    Everything is read under the one metrics lock, so a row is a
    consistent cut: the writer thread and a concurrent scrape can
    never disagree about which update landed in which window."""
    prev_c = (cursor or {}).get("counters", {})
    prev_h = (cursor or {}).get("hists", {})
    with _LOCK:
        counters = dict(_COUNTERS)
        gauges = dict(_GAUGES)
        hists: Dict[str, Any] = {}
        hcur: Dict[str, Any] = {}
        for k, h in _HISTS.items():
            pn, psum, plen = prev_h.get(k, (0, 0.0, 0))
            win = h.samples[plen:]
            summ: Dict[str, Any] = {
                "count": h.n, "sum": round(h.total, 6),
                "window_count": h.n - pn,
                "window_sum": round(h.total - psum, 6),
            }
            if win:
                s = sorted(win)
                for p in (50, 95):
                    summ[f"p{p}"] = round(
                        s[min(len(s) - 1, (len(s) * p) // 100)], 6)
            hists[k] = summ
            hcur[k] = (h.n, h.total, len(h.samples))
    deltas = {k: round(v - prev_c.get(k, 0), 6)
              for k, v in counters.items()}
    row = {"counters": counters, "deltas": deltas, "gauges": gauges,
           "hists": hists}
    return row, {"counters": counters, "hists": hcur}


def reset() -> None:
    with _LOCK:
        _COUNTERS.clear()
        _GAUGES.clear()
        _HISTS.clear()
