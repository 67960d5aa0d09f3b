"""Exporters: Chrome trace-event JSON (Perfetto), metrics JSONL, text
summary.

The trace JSON follows the Chrome trace-event format's flavor that
Perfetto ingests directly (https://ui.perfetto.dev -> open file):

* one ``pid`` (the tuning process), one ``tid`` per LANE — a lane is
  either a real thread (driver MainThread, the ``ut-surrogate-refit``
  worker) or a synthetic track (``worker-N`` build slots, emitted by
  the driver thread at reap time with the slot's own timestamps) — so
  the background refit and every WorkerPool slot render as horizontal
  lanes against the driver's ticket spans;
* complete spans are ``"ph": "X"`` events with microsecond ``ts`` /
  ``dur``; instants are ``"ph": "i"`` scope-thread events; lane names
  arrive as ``"ph": "M"`` thread_name metadata records.

`validate_trace` is the schema contract: the round-trip test and the
committed example artifact are both held to it.
"""
from __future__ import annotations

import json
import time
from typing import Any, Dict, List, Optional

from . import core, metrics

__all__ = ["chrome_trace", "write_trace", "write_metrics_jsonl",
           "text_summary", "validate_trace", "prometheus_text"]

PID = 1


def _lane_order(track: str) -> tuple:
    """Sort key: driver thread first, worker slots next (numeric), then
    auxiliary threads (refit worker, ...)."""
    if track == "MainThread":
        return (0, 0, track)
    if track.startswith("worker-"):
        try:
            return (1, int(track.split("-", 1)[1]), track)
        except ValueError:
            return (1, 1 << 30, track)
    return (2, 0, track)


def chrome_trace(snap: Optional[Dict[str, Any]] = None,
                 extra: Optional[Dict[str, Any]] = None
                 ) -> Dict[str, Any]:
    """Build the Chrome trace-event document from a core snapshot
    (default: the live rings) plus the metrics snapshot."""
    if snap is None:
        snap = core.snapshot()
    tracks: List[str] = []
    for e in snap["events"]:
        if e["track"] not in tracks:
            tracks.append(e["track"])
    tracks.sort(key=_lane_order)
    tid_of = {t: i + 1 for i, t in enumerate(tracks)}
    events: List[Dict[str, Any]] = []
    for t, tid in tid_of.items():
        events.append({"ph": "M", "pid": PID, "tid": tid,
                       "name": "thread_name", "args": {"name": t}})
        events.append({"ph": "M", "pid": PID, "tid": tid,
                       "name": "thread_sort_index",
                       "args": {"sort_index": _lane_order(t)[0] * 1000
                                + _lane_order(t)[1]}})
    for e in snap["events"]:
        rec: Dict[str, Any] = {
            "name": e["name"],
            "cat": e["name"].split(".", 1)[0],
            "pid": PID,
            "tid": tid_of[e["track"]],
            "ts": round(e["ts"] * 1e6, 3),
        }
        if e["dur"] is None:
            rec["ph"] = "i"
            rec["s"] = "t"
        else:
            rec["ph"] = "X"
            rec["dur"] = round(e["dur"] * 1e6, 3)
        if e["attrs"]:
            rec["args"] = e["attrs"]
        events.append(rec)
    other: Dict[str, Any] = {
        "origin_unix": snap.get("origin_unix", 0.0),
        "dropped": snap.get("dropped", {}),
        "metrics": metrics.snapshot(),
    }
    # combined-profile reference: when a programmatic torch.profiler
    # capture ran (`--device-trace` / UT_DEVICE_TRACE), point at its
    # directory so the host trace and the CUDA kernel trace open side
    # by side (obs/device.py)
    from . import device as _device
    if _device.trace_dir():
        other["device_trace"] = _device.trace_dir()
    if extra:
        other.update(extra)
    return {"traceEvents": events, "displayTimeUnit": "ms",
            "otherData": other}


def write_trace(path: str, extra: Optional[Dict[str, Any]] = None
                ) -> Dict[str, Any]:
    """Write the Perfetto-viewable trace JSON; returns the document."""
    doc = chrome_trace(extra=extra)
    with open(path, "w") as f:
        json.dump(doc, f)
    return doc


def write_metrics_jsonl(path: str,
                        extra: Optional[Dict[str, Any]] = None) -> None:
    """Append ONE metrics-snapshot line (a scrape row): counters,
    gauges, histogram summaries, wall-clock timestamp."""
    row = {"t": round(time.time(), 3), **metrics.snapshot()}
    if extra:
        row.update(extra)
    with open(path, "a") as f:
        f.write(json.dumps(row) + "\n")


def validate_trace(doc: Any) -> None:
    """Schema contract for the exported trace (raises ValueError):
    every event has ph/pid/tid/name; X events carry numeric ts and
    dur >= 0; instants carry ts; every (pid, tid) used by a timed
    event has a thread_name metadata record.  Lanes are keyed by the
    (pid, tid) PAIR — tids are per-process in the Chrome format, so a
    merged multi-process document (`ut-trace merge`) legitimately
    reuses tid 1 under every pid."""
    def fail(msg):
        raise ValueError(f"trace schema: {msg}")

    if not isinstance(doc, dict) or "traceEvents" not in doc:
        fail("document must be a dict with a 'traceEvents' list")
    evs = doc["traceEvents"]
    if not isinstance(evs, list):
        fail("'traceEvents' must be a list")
    named_lanes = set()
    used_lanes = set()
    for i, e in enumerate(evs):
        if not isinstance(e, dict):
            fail(f"event {i} is not an object")
        for k in ("ph", "pid", "tid", "name"):
            if k not in e:
                fail(f"event {i} missing {k!r}")
        if e["ph"] == "M":
            if e["name"] == "thread_name":
                if not e.get("args", {}).get("name"):
                    fail(f"event {i}: thread_name without args.name")
                named_lanes.add((e["pid"], e["tid"]))
            continue
        if e["ph"] not in ("X", "i", "C"):
            fail(f"event {i}: unknown phase {e['ph']!r}")
        if not isinstance(e.get("ts"), (int, float)):
            fail(f"event {i}: non-numeric ts")
        used_lanes.add((e["pid"], e["tid"]))
        if e["ph"] == "X":
            d = e.get("dur")
            if not isinstance(d, (int, float)) or d < 0:
                fail(f"event {i}: X event needs dur >= 0")
        if "args" in e:
            try:
                json.dumps(e["args"])
            except (TypeError, ValueError):
                fail(f"event {i}: args not JSON-serializable")
    missing = used_lanes - named_lanes
    if missing:
        fail(f"lanes {sorted(missing)} have events but no thread_name "
             f"metadata (they would be anonymous in Perfetto)")


def _prom_name(name: str) -> str:
    """Metric-registry name -> Prometheus metric name: dots and every
    other illegal character become underscores, one `ut_` namespace
    prefix."""
    out = []
    for ch in name:
        out.append(ch if (ch.isascii() and (ch.isalnum() or ch == "_"))
                   else "_")
    s = "".join(out)
    if s and s[0].isdigit():
        s = "_" + s
    return "ut_" + s


def prometheus_text(snap: Optional[Dict[str, Any]] = None) -> str:
    """Prometheus text exposition (version 0.0.4) of a metrics
    snapshot: counters as `counter`, gauges as `gauge`, histogram
    summaries as `summary` (quantile series + `_sum`/`_count`).  The
    serve `{"op": "metrics", "format": "prometheus"}` scrape returns
    this string so a textfile-collector / sidecar exporter can relay
    the registry without learning the JSON schema."""
    if snap is None:
        snap = metrics.snapshot()
    lines: List[str] = []
    for k in sorted(snap.get("counters", {})):
        n = _prom_name(k)
        lines.append(f"# TYPE {n} counter")
        lines.append(f"{n} {snap['counters'][k]:g}")
    for k in sorted(snap.get("gauges", {})):
        n = _prom_name(k)
        lines.append(f"# TYPE {n} gauge")
        lines.append(f"{n} {snap['gauges'][k]:g}")
    for k in sorted(snap.get("hists", {})):
        h = snap["hists"][k]
        n = _prom_name(k)
        lines.append(f"# TYPE {n} summary")
        for q, key in ((0.5, "p50"), (0.95, "p95"), (0.99, "p99")):
            if h.get(key) is not None:
                lines.append(f'{n}{{quantile="{q}"}} {h[key]:g}')
        lines.append(f"{n}_sum {h.get('sum', 0):g}")
        lines.append(f"{n}_count {h.get('count', 0):g}")
    return "\n".join(lines) + ("\n" if lines else "")


def text_summary(snap: Optional[Dict[str, Any]] = None) -> str:
    """End-of-run human summary: per-span-name count/total/mean, the
    counters and gauges, histogram percentiles, and drop warnings."""
    if snap is None:
        snap = core.snapshot()
    per: Dict[str, List[float]] = {}
    insts: Dict[str, int] = {}
    for e in snap["events"]:
        if e["dur"] is None:
            insts[e["name"]] = insts.get(e["name"], 0) + 1
        else:
            per.setdefault(e["name"], []).append(e["dur"])
    lines = ["== obs summary =="]
    if per:
        lines.append("spans (count / total s / mean ms):")
        for name in sorted(per):
            ds = per[name]
            lines.append(f"  {name:<28} {len(ds):>6}  "
                         f"{sum(ds):>9.3f}  "
                         f"{1e3 * sum(ds) / len(ds):>9.3f}")
    if insts:
        lines.append("events:")
        for name in sorted(insts):
            lines.append(f"  {name:<28} {insts[name]:>6}")
    m = metrics.snapshot()
    if m["counters"]:
        lines.append("counters:")
        for k in sorted(m["counters"]):
            lines.append(f"  {k:<28} {m['counters'][k]:>10g}")
    if m["gauges"]:
        lines.append("gauges:")
        for k in sorted(m["gauges"]):
            lines.append(f"  {k:<28} {m['gauges'][k]:>10g}")
    if m["hists"]:
        lines.append("histograms:")
        for k in sorted(m["hists"]):
            h = m["hists"][k]
            lines.append(
                f"  {k:<28} n={h['count']} mean={h['mean']} "
                f"p50={h.get('p50')} p95={h.get('p95')} "
                f"max={h['max']}")
    if snap.get("dropped"):
        lines.append(f"DROPPED events (ring capacity exceeded): "
                     f"{snap['dropped']}")
    return "\n".join(lines)
