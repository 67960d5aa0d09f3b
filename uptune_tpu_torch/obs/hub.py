"""Fleet-telemetry hub: one collector every process reports into
(`ut-torch hub`).

Counterpart of `uptune_tpu/obs/hub.py`, op for op and rule for rule.
The hub is a `WireServer` (serve/wire.py) whose clients are
`TelemetryShipper`s (obs/ship.py): `ut-torch` driver replicas,
`ut-torch serve` processes and benchmark clients push window snapshots,
journal rows, alerts and health rollups; operators and the sharded
front tier (serve/router.py, which embeds one) pull the fleet view back
out over the very same wire:

* ``{"op": "metrics"}`` — the FLEET rollup in the session server's
  scrape shape, so ``ut-torch top --addr <hub>`` works unchanged:
  counters are exact sums of each live source's latest absolute
  counters, gauges are last-write-wins across sources, histogram
  windows sum their exact counts/sums with count-weighted
  (approximate, and so labeled) fleet percentiles.
* ``{"op": "sources"}`` — one row per (host, pid, role): liveness,
  window/journal/alert/drop accounting, per-source headline rates.
* ``{"op": "health", "limit": N}`` — worst-first health across
  sources (stale sources float to the top with status ``stale``),
  the placement/eviction feed for a front tier.
* ``{"op": "ship"}`` / ``{"op": "hello"}`` — the shipper's push ops.

Durability: every acked row is appended (and flushed) to the fleet
timeline JSONL BEFORE the ok reply — a SIGKILLed source loses at
most its one un-acked in-flight batch.  The timeline is torn-tail
tolerant and rotation-capped exactly like the flight recorder
(`flight.rotate_files`, ``--timeline-rotate`` generations), and a
restarting hub REPLAYS the surviving chain so the fleet view picks up
where the dead hub left off.  Host Python only: the hub imports
neither torch nor numpy.
"""
from __future__ import annotations

import argparse
import json
import logging
import os
import sys
import time
from collections import deque
from typing import Any, Dict, List, Optional, Tuple

from ..serve.wire import RequestError, WireServer
from . import flight

log = logging.getLogger("uptune_tpu_torch")

__all__ = ["TelemetryHub", "fleet_rollup", "main",
           "DEFAULT_TIMELINE", "DEFAULT_TIMELINE_ROWS"]

DEFAULT_TIMELINE = "ut.fleet.jsonl"
DEFAULT_TIMELINE_ROWS = 50000
DEFAULT_WINDOW_RING = 64
DEFAULT_STALE_S = 15.0
HEALTH_MAX_SOURCES = 64         # default health-op payload bound
HEALTH_LIMIT_CAP = 1024         # request `limit` ceiling (serve rule)

_STATUS_RANK = {"failing": 0, "stale": 1, "stalled": 2, "cold": 3,
                "ok": 4}

# the per-source panel's headline counters, shared by the hub's
# `sources` op and `ut-torch top`'s file-mode panel so the two views can
# never drift on what a source's "rate" means
HEADLINE_RATE_KEYS = ("driver.asks", "serve.asks", "serve.tells",
                      "store.recorded")   # the ut-store role's rate


def window_rates(row: Dict[str, Any]) -> Dict[str, float]:
    """Headline per-second rates off one window row's own deltas."""
    dt = float(row.get("dt") or 0.0)
    d = row.get("deltas") or {}
    out: Dict[str, float] = {}
    if dt > 0:
        for k in HEADLINE_RATE_KEYS:
            if d.get(k):
                out[k] = round(d[k] / dt, 1)
    return out


def fleet_rollup(rows: List[Tuple[str, Dict[str, Any]]]
                 ) -> Dict[str, Any]:
    """Aggregate one window row per source into the fleet view.

    `rows` is ``[(source_label, window_row), ...]`` where each row is
    a flight-recorder/shipper window snapshot (absolute ``counters``,
    per-window ``deltas``, ``gauges``, windowed ``hists``, sender
    ``t``/``dt``).  Semantics (the JAX package's, rule for rule):

    * **counters** — exact sums of per-source absolutes (the
      exactness contract: the sum of the sources' own final
      flight-recorder rows);
    * **deltas** — sums of the rows' own window deltas (each window
      is exact per source; the fleet window is their union);
    * **gauges** — last-write-wins by sender timestamp (same rule as
      the registry itself, across processes);
    * **hists** — ``count``/``sum``/``window_count``/``window_sum``
      are exact sums; ``p50``/``p95`` are count-WEIGHTED averages of
      the per-source window percentiles — approximate by nature (the
      raw samples never leave their process) and labeled
      ``"approx": true`` so no reader mistakes them for a true fleet
      distribution.

    Also returns ``dt`` (the widest source window, for display
    rates) and ``per_source`` label list.
    """
    counters: Dict[str, float] = {}
    deltas: Dict[str, float] = {}
    gauges: Dict[str, float] = {}
    gauge_t: Dict[str, float] = {}
    hists: Dict[str, Dict[str, Any]] = {}
    hist_w: Dict[str, List[Tuple[float, Optional[float],
                                 Optional[float]]]] = {}
    dt = 0.0
    for label, row in rows:
        if not isinstance(row, dict):
            continue
        t = float(row.get("t") or 0.0)
        dt = max(dt, float(row.get("dt") or 0.0))
        for k, v in (row.get("counters") or {}).items():
            counters[k] = counters.get(k, 0) + v
        for k, v in (row.get("deltas") or {}).items():
            deltas[k] = deltas.get(k, 0) + v
        for k, v in (row.get("gauges") or {}).items():
            if t >= gauge_t.get(k, -1.0):
                gauges[k] = v
                gauge_t[k] = t
        for k, h in (row.get("hists") or {}).items():
            if not isinstance(h, dict):
                continue
            agg = hists.setdefault(
                k, {"count": 0, "sum": 0.0, "window_count": 0,
                    "window_sum": 0.0})
            agg["count"] += h.get("count", 0) or 0
            agg["sum"] += h.get("sum", 0.0) or 0.0
            agg["window_count"] += h.get("window_count", 0) or 0
            agg["window_sum"] += h.get("window_sum", 0.0) or 0.0
            wc = h.get("window_count", 0) or 0
            if wc:
                hist_w.setdefault(k, []).append(
                    (wc, h.get("p50"), h.get("p95")))
    for k, parts in hist_w.items():
        # count-weighted average of per-source window percentiles
        for idx, p in ((1, "p50"), (2, "p95")):
            num = den = 0.0
            for part in parts:
                v = part[idx]
                if v is not None:
                    num += part[0] * v
                    den += part[0]
            if den:
                hists[k][p] = round(num / den, 6)
                hists[k]["approx"] = True
    return {"counters": counters, "deltas": deltas, "gauges": gauges,
            "hists": hists, "dt": round(dt, 3),
            "per_source": [label for label, _ in rows]}


class _Source:
    """Per-(host, pid, role) state: the window ring + accounting."""

    __slots__ = ("key", "label", "meta", "first_unix", "last_unix",
                 "windows", "last_window", "journal_rows", "alerts",
                 "health", "health_unix", "dropped", "acked",
                 "final_seen")

    def __init__(self, key: Tuple[str, str, str], meta: Dict[str, Any],
                 ring: int):
        self.key = key
        self.label = f"{key[0]}:{key[1]}:{key[2]}"
        self.meta = dict(meta)
        self.first_unix = time.time()
        self.last_unix = self.first_unix
        self.windows: deque = deque(maxlen=ring)
        self.last_window: Optional[Dict[str, Any]] = None
        self.journal_rows = 0
        self.alerts: deque = deque(maxlen=32)
        self.health: Optional[Dict[str, Any]] = None
        self.health_unix = 0.0
        self.dropped = 0
        self.acked = 0
        self.final_seen = False


class TelemetryHub(WireServer):
    """The fleet collector.  Construct, ``start()``, point shippers
    and ``ut-torch top --addr`` at ``.port``, ``stop()``."""

    WIRE_NAME = "ut-hub"

    def __init__(self, host: str = "127.0.0.1", port: int = 0,
                 timeline: Optional[str] = DEFAULT_TIMELINE,
                 timeline_rows: int = DEFAULT_TIMELINE_ROWS,
                 timeline_rotate: int = flight.DEFAULT_ROTATE,
                 window_ring: int = DEFAULT_WINDOW_RING,
                 stale_s: float = DEFAULT_STALE_S):
        super().__init__(host, port)
        self.timeline_path = (None if timeline in (None, "", "off")
                              else str(timeline))
        self.timeline_rows = int(timeline_rows)
        self.timeline_rotate = max(1, int(timeline_rotate))
        self.window_ring = int(window_ring)
        self.stale_s = float(stale_s)
        self._sources: Dict[Tuple[str, str, str], _Source] = {}
        self._tl_f = None
        self._tl_rows = 0
        self.timeline_rotations = 0
        self.rows_received = 0
        if self.timeline_path:
            self._replay_timeline()
            self._tl_f = self._open_timeline()

    def _open_timeline(self):
        """Append-open a timeline generation; a FRESH file gets the
        self-describing header line (`ut report` keys fleet-timeline
        detection on it; replay skips it as a non-source line).  An
        EXISTING file (hub restart) resumes its row count, so the
        rotation cap bounds the generation on disk — not merely this
        process's appends."""
        f = open(self.timeline_path, "a")
        if f.tell() == 0:
            f.write(json.dumps({"fleet": 1,
                                "origin_unix": round(time.time(), 3),
                                "pid": os.getpid()}) + "\n")
            f.flush()
            self._tl_rows = 0
        else:
            try:
                with open(self.timeline_path) as rf:
                    self._tl_rows = sum(1 for line in rf
                                        if '"src"' in line)
            except OSError:
                self._tl_rows = 0
        return f

    # -- timeline ------------------------------------------------------
    def _replay_timeline(self) -> None:
        """Restore per-source state from a previous hub's surviving
        rotation chain (oldest generation first), so a restarted hub
        serves the fleet view it had before dying.  Sources restored
        this way show their recorded last-seen age — they go `stale`
        naturally unless their shipper reconnects and resumes."""
        n = 0
        for row in flight.read_chain(self.timeline_path):
            src = row.get("src")
            kind = row.get("kind")
            if not (isinstance(src, str) and isinstance(kind, str)):
                continue    # header / foreign line
            parts = src.split(":")
            if len(parts) != 3:
                continue
            key = (parts[0], parts[1], parts[2])
            s = self._sources.get(key)
            if s is None:
                s = self._sources[key] = _Source(
                    key, {"replayed": True}, self.window_ring)
                s.first_unix = float(row.get("u") or s.first_unix)
            self._fold(s, kind, row.get("row"),
                       at=float(row.get("u") or 0.0) or None)
            n += 1
        if n:
            log.info("[ut-hub] replayed %d timeline rows -> %d "
                     "sources", n, len(self._sources))

    def _append_timeline(self, lines: List[str]) -> None:
        """Durable half of the ack: rows hit the timeline (flushed)
        before the shipper hears ok.  Caller holds `_lock`."""
        if self._tl_f is None or not lines:
            return
        self._tl_f.write("".join(lines))
        self._tl_f.flush()
        self._tl_rows += len(lines)
        if self._tl_rows >= self.timeline_rows:
            self._tl_f.close()
            flight.rotate_files(self.timeline_path,
                                self.timeline_rotate)
            self._tl_f = self._open_timeline()
            self._tl_rows = 0
            self.timeline_rotations += 1

    # -- source folding ------------------------------------------------
    def _fold(self, s: _Source, kind: str, row: Any,
              at: Optional[float] = None) -> None:
        s.last_unix = at if at is not None else time.time()
        if not isinstance(row, dict):
            return
        if kind == "window":
            s.windows.append(row)
            s.last_window = row
            if row.get("final"):
                s.final_seen = True
        elif kind == "journal":
            s.journal_rows += 1
        elif kind == "alert":
            s.alerts.append(row)
        elif kind == "health":
            s.health = row
            s.health_unix = s.last_unix

    def _source_for(self, req: dict) -> _Source:
        meta = req.get("source")
        if not isinstance(meta, dict):
            raise RequestError("missing 'source' object "
                               "({host, pid, role})")
        key = (str(meta.get("host")), str(meta.get("pid")),
               str(meta.get("role")))
        s = self._sources.get(key)
        if s is None:
            s = self._sources[key] = _Source(key, meta,
                                             self.window_ring)
            log.info("[ut-hub] new source %s", s.label)
        return s

    # -- ops -----------------------------------------------------------
    def _op_ping(self, req: dict) -> dict:
        with self._lock:
            return {"t": time.time(), "sources": len(self._sources)}

    def _op_hello(self, req: dict) -> dict:
        with self._lock:
            s = self._source_for(req)
            s.last_unix = time.time()
            return {"source": s.label}

    def _op_ship(self, req: dict) -> dict:
        rows = req.get("rows")
        if not isinstance(rows, list):
            raise RequestError("ship needs 'rows': a list")
        now = time.time()
        with self._lock:
            s = self._source_for(req)
            try:
                s.dropped = int(req.get("dropped", s.dropped))
            except (TypeError, ValueError):
                pass
            lines = []
            for item in rows:
                if not isinstance(item, dict):
                    continue
                kind = str(item.get("kind", "?"))
                row = item.get("row")
                self._fold(s, kind, row, at=now)
                lines.append(json.dumps(
                    {"u": round(now, 3), "src": s.label, "kind": kind,
                     "row": row}, separators=(",", ":")) + "\n")
            # durability before the ack: everything the shipper will
            # consider delivered is already flushed to the timeline
            self._append_timeline(lines)
            s.acked += len(lines)
            self.rows_received += len(lines)
        return {"acked": len(lines)}

    def _op_metrics(self, req: dict) -> dict:
        """The fleet rollup in the session server's scrape shape
        (``ut-torch top --addr <hub>`` renders it unchanged)."""
        with self._lock:
            rows = [(s.label, s.last_window)
                    for s in self._sources.values()
                    if s.last_window is not None]
            n = len(self._sources)
        roll = fleet_rollup(rows)
        return {"sources": n,
                "uptime_s": round(time.time() - self.started_unix, 3),
                "metrics": {"counters": roll["counters"],
                            "gauges": roll["gauges"],
                            "hists": roll["hists"],
                            "deltas": roll["deltas"],
                            "dt": roll["dt"]}}

    def _source_row(self, s: _Source, now: float) -> Dict[str, Any]:
        age = now - s.last_unix
        rates = window_rates(s.last_window or {})
        return {"host": s.key[0], "pid": s.key[1], "role": s.key[2],
                "source": s.label, "age_s": round(age, 3),
                "stale": age > self.stale_s and not s.final_seen,
                "final": s.final_seen,
                "windows": len(s.windows), "journal_rows": s.journal_rows,
                "alerts": len(s.alerts), "dropped": s.dropped,
                "acked": s.acked, "rates": rates}

    def _op_sources(self, req: dict) -> dict:
        now = time.time()
        with self._lock:
            rows = [self._source_row(s, now)
                    for s in self._sources.values()]
        rows.sort(key=lambda r: r["source"])
        return {"sources": len(rows), "rows": rows}

    def _op_health(self, req: dict) -> dict:
        """Worst-first health across sources.  A source that shipped
        a serve-health rollup contributes its own worst verdict; a
        source past the staleness bar reports ``stale``; everything
        else is ``ok``.  `limit` bounds the payload (the serve health
        op's rule)."""
        try:
            limit = int(req.get("limit", HEALTH_MAX_SOURCES))
        except (TypeError, ValueError) as e:
            raise RequestError(f"limit must be an integer: {e}")
        if not 1 <= limit <= HEALTH_LIMIT_CAP:
            raise RequestError(
                f"limit must be in [1, {HEALTH_LIMIT_CAP}]: {limit}")
        now = time.time()
        rows = []
        by_status: Dict[str, int] = {}
        # rows are built entirely under the lock (the _op_sources
        # rule): s.alerts is a deque a concurrent ship batch appends
        # to — iterating it unlocked raises "deque mutated during
        # iteration" under a health poll racing active shippers
        with self._lock:
            for s in self._sources.values():
                row = self._source_row(s, now)
                status = "ok"
                if row["stale"]:
                    status = "stale"
                h = s.health
                if isinstance(h, dict):
                    # a shipped serve rollup: adopt its worst verdict
                    bys = h.get("by_status")
                    if isinstance(bys, dict) and bys:
                        worst = min(bys, key=lambda k:
                                    _STATUS_RANK.get(k, 9))
                        if _STATUS_RANK.get(worst, 9) < \
                                _STATUS_RANK.get(status, 9):
                            status = worst
                        row["sessions_by_status"] = bys
                if s.alerts and status == "ok":
                    status = "stalled" if any(
                        a.get("kind") == "stall" for a in s.alerts) \
                        else status
                row["status"] = status
                by_status[status] = by_status.get(status, 0) + 1
                rows.append(row)
        rows.sort(key=lambda r: (_STATUS_RANK.get(r["status"], 9),
                                 r["source"]))
        return {"sources": len(rows), "by_status": by_status,
                "truncated": len(rows) > limit,
                "health": rows[:limit]}

    def gauge_values(self, key: str) -> List[float]:
        """One value per LIVE (non-final) source's latest window for
        gauge `key` — the additive-rollup seam: fleet_rollup's gauges
        are last-write-wins (correct for a fleet-wide setting like a
        snapshot version), but a per-process population gauge like
        ``serve.sessions.active`` only means something fleet-wide as a
        SUM, so the front-tier router re-aggregates those few keys
        from the per-source values (serve/router.py metrics op)."""
        out: List[float] = []
        with self._lock:
            for s in self._sources.values():
                if s.final_seen or not isinstance(s.last_window, dict):
                    continue
                v = (s.last_window.get("gauges") or {}).get(key)
                if isinstance(v, (int, float)):
                    out.append(float(v))
        return out

    def _op_stats(self, req: dict) -> dict:
        with self._lock:
            return {"sources": len(self._sources),
                    "rows_received": self.rows_received,
                    "timeline": self.timeline_path,
                    "timeline_rows": self._tl_rows,
                    "timeline_rotations": self.timeline_rotations}

    _OPS = {"ping": _op_ping, "hello": _op_hello, "ship": _op_ship,
            "metrics": _op_metrics, "sources": _op_sources,
            "health": _op_health, "stats": _op_stats}

    def _listen_banner(self) -> str:
        return (f" (timeline={self.timeline_path or 'off'}, "
                f"rotate={self.timeline_rotate})")

    def stop(self) -> None:
        super().stop()
        with self._lock:
            if self._tl_f is not None:
                try:
                    self._tl_f.close()
                except OSError:
                    pass
                self._tl_f = None


# ------------------------------------------------------------------ CLI
def main(argv: Optional[List[str]] = None) -> int:
    p = argparse.ArgumentParser(
        prog="ut-torch hub",
        description="fleet-telemetry hub: aggregate every process's "
                    "metrics/journal/health streams live")
    p.add_argument("--host", default="127.0.0.1",
                   help="bind address (default 127.0.0.1)")
    p.add_argument("--port", type=int, default=8790,
                   help="TCP port; 0 picks an ephemeral port "
                        "(default 8790)")
    p.add_argument("--timeline", default=DEFAULT_TIMELINE,
                   metavar="JSONL",
                   help="durable fleet timeline (every acked row; "
                        "'off' disables; default ut.fleet.jsonl).  An "
                        "existing chain is REPLAYED at startup")
    p.add_argument("--timeline-rows", type=int,
                   default=DEFAULT_TIMELINE_ROWS,
                   help="rows per timeline generation before rotation "
                        f"(default {DEFAULT_TIMELINE_ROWS})")
    p.add_argument("--timeline-rotate", type=int,
                   default=flight.DEFAULT_ROTATE, metavar="N",
                   help="rotation generations kept (.1 … .N; "
                        "default 1)")
    p.add_argument("--stale", type=float, default=DEFAULT_STALE_S,
                   help="seconds of silence before a source reports "
                        f"stale (default {DEFAULT_STALE_S})")
    p.add_argument("-v", "--verbose", action="store_true")
    args = p.parse_args(argv)
    logging.basicConfig(
        level=logging.DEBUG if args.verbose else logging.INFO,
        format="[%(relativeCreated)7.0fms] %(levelname)s %(message)s")
    hub = TelemetryHub(host=args.host, port=args.port,
                       timeline=args.timeline,
                       timeline_rows=args.timeline_rows,
                       timeline_rotate=args.timeline_rotate,
                       stale_s=args.stale)
    try:
        hub.serve_forever()
    finally:
        log.info("[ut-hub] %d rows from %d sources%s",
                 hub.rows_received, len(hub._sources),
                 f"; timeline at {hub.timeline_path}"
                 if hub.timeline_path else "")
    return 0


if __name__ == "__main__":
    sys.exit(main())
