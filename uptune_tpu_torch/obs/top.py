"""`ut-torch top` — live terminal dashboard for a running tuning process.

Counterpart of `uptune_tpu/obs/top.py`: the same modes, and frame for
frame the same text and ``--json`` objects from the same scrape.  Two
data sources, one view:

* ``ut-torch top --addr host:port`` polls a running `ut-torch serve`
  process's ``{"op": "metrics"}`` scrape over the wire (rates are
  computed from counter deltas between successive polls);
* ``ut-torch top --metrics out.json.metrics.jsonl`` tails a
  flight-recorder timeline on disk (any traced run: `ut-torch serve`,
  `ut-torch prog.py --trace`) — rows already carry per-window deltas,
  so rates read straight off the newest row.  Works on a LIVE file and
  post-mortem on a crashed run's tail alike.  ``--metrics`` repeats
  and accepts globs (``'out.json.metrics.jsonl*'`` picks up ``.hN``
  replica files): several files render as ONE fleet-rolled frame
  (obs.hub.fleet_rollup — counters summed, gauges last-write,
  labeled-approximate percentiles) with each row labeled per source.

``--addr`` may also point at a fleet-telemetry hub (`ut-torch hub`) or
a sharded front-tier router (`ut-torch route`): their metrics ops serve
the fleet rollup in the same scrape shape, so the frame just works;
``--fleet`` adds a per-source panel (one line per shipping process:
age, rates, drops, alerts) fed by the ``sources`` op — or derived per
file in multi ``--metrics`` mode.  The tail reader follows the flight
recorder's rotation chain (``<file>.N`` … ``<file>.1``), so a freshly
rotated timeline still yields a full frame.

The frame shows the serving plane's vitals: active sessions, epoch
batch fill, ask/tell rates and latency percentiles, worker-pool
utilization, store hit rate, surrogate refit lag, and the device
panel.  The device panel keeps the JAX package's keys
(``device.mxu_util``, ``device.hbm_util``, ...), which the port's
obs/device.py fills with the card's tensor-core and HBM shares.  Every
field is pulled defensively: a metrics stream missing a family (a
driver run has no `serve.*`) renders "—", never a crash.

``--once`` prints a single frame and exits (scripts, tests); with
``--json`` that frame is one JSON object (counters/gauges/hists/rates)
so CI asserts on fields instead of scraping text.  The refresh loop
redraws with ANSI cursor-home + clear and exits cleanly on ^C / a
vanished server.  Host Python only: neither torch nor numpy.
"""
from __future__ import annotations

import argparse
import glob as _glob
import json
import os
import sys
import time
from typing import Any, Dict, List, Optional, Tuple

__all__ = ["Sample", "rates", "render", "fleet_lines", "main"]

CLEAR = "\x1b[H\x1b[2J"


class Sample:
    """One metrics observation: absolute counters/gauges/hists at time
    `t`, plus (for flight-recorder rows) the row's own window deltas."""

    def __init__(self, t: float, counters: Dict[str, float],
                 gauges: Dict[str, float], hists: Dict[str, Any],
                 deltas: Optional[Dict[str, float]] = None,
                 dt: Optional[float] = None,
                 meta: Optional[Dict[str, Any]] = None):
        self.t = t
        self.counters = counters
        self.gauges = gauges
        self.hists = hists
        self.deltas = deltas
        self.dt = dt
        self.meta = dict(meta or {})


def sample_from_scrape(resp: Dict[str, Any]) -> Sample:
    """A serve (or hub — same shape, plus fleet window deltas and a
    source count) `{"op": "metrics"}` response -> Sample."""
    m = resp.get("metrics", {}) or {}
    return Sample(time.time(), m.get("counters", {}) or {},
                  m.get("gauges", {}) or {}, m.get("hists", {}) or {},
                  deltas=m.get("deltas"), dt=m.get("dt") or None,
                  meta={"sessions": resp.get("sessions"),
                        "uptime_s": resp.get("uptime_s"),
                        "sources": resp.get("sources")})


def sample_from_row(row: Dict[str, Any]) -> Sample:
    """A flight-recorder JSONL row -> Sample."""
    return Sample(float(row.get("t", 0.0)),
                  row.get("counters", {}) or {},
                  row.get("gauges", {}) or {},
                  row.get("hists", {}) or {},
                  deltas=row.get("deltas"), dt=row.get("dt"),
                  meta={"final": row.get("final", False),
                        "trace": row.get("trace")})


TAIL_BYTES = 256 * 1024


def _tail_rows(path: str, n: int) -> List[Dict[str, Any]]:
    """Newest-first parseable rows from ONE file's tail."""
    try:
        with open(path, "rb") as f:
            f.seek(0, 2)
            size = f.tell()
            f.seek(max(0, size - TAIL_BYTES))
            lines = f.read().decode("utf-8", "replace").splitlines()
    except OSError:
        return []
    out: List[Dict[str, Any]] = []
    for line in reversed(lines):
        if len(out) >= n:
            break
        try:
            row = json.loads(line)
        except json.JSONDecodeError:
            continue
        if isinstance(row, dict) and "counters" in row:
            out.append(row)
    return out


def last_rows(path: str, n: int = 2) -> List[Dict[str, Any]]:
    """The last `n` parseable rows of a metrics JSONL (tail-tolerant:
    a row being appended right now is skipped).  Reads only the final
    `TAIL_BYTES` of each file — a rotation-capped timeline near 20k
    rows is megabytes, and the refresh loop calls this every couple
    of seconds; the first (possibly truncated) line of a mid-file
    seek fails to parse and is skipped like any torn row.  When the
    live file holds fewer than `n` rows (it just rotated), older
    rotation generations (``<path>.1`` … ``<path>.N``) fill in, so a
    freshly capped timeline still renders a full frame."""
    out = _tail_rows(path, n)
    gen = 1
    while len(out) < n:
        older = _tail_rows(f"{path}.{gen}", n - len(out))
        if not older:
            break
        out.extend(older)
        gen += 1
    return list(reversed(out))


def rates(prev: Optional[Sample], cur: Sample) -> Dict[str, float]:
    """Per-second counter rates for the displayed window.  Prefers the
    row's own deltas (flight-recorder source, exact window); falls
    back to diffing successive polls (scrape source)."""
    if cur.deltas is not None and cur.dt:
        return {k: v / cur.dt for k, v in cur.deltas.items()}
    if prev is None or cur.t <= prev.t:
        return {}
    dt = cur.t - prev.t
    return {k: (v - prev.counters.get(k, 0)) / dt
            for k, v in cur.counters.items()}


def _fmt(v: Any, unit: str = "", nd: int = 1) -> str:
    if v is None:
        return "—"
    if isinstance(v, float):
        return f"{v:,.{nd}f}{unit}"
    return f"{v}{unit}"


def _hist_p(hists: Dict[str, Any], name: str, p: str) -> Optional[float]:
    h = hists.get(name)
    return h.get(p) if isinstance(h, dict) else None


def _source_row(label: str, row: Dict[str, Any]) -> Dict[str, Any]:
    """Normalize one flight-recorder/window row into the per-source
    panel shape (the hub's `sources` op emits the same keys, through
    the same shared rate helper)."""
    from .hub import window_rates
    rates_ = window_rates(row)
    t = float(row.get("t") or 0.0)
    return {"source": label,
            "age_s": round(max(0.0, time.time() - t), 1) if t else None,
            "rates": rates_, "final": bool(row.get("final")),
            "stale": False, "dropped": None, "alerts": None,
            "journal_rows": None}


def fleet_lines(sources: List[Dict[str, Any]],
                width: int = 78) -> List[str]:
    """The per-source panel (`--fleet`): one labeled line per shipping
    process / metrics file, worst (stale) first."""
    out = [f"sources   ({len(sources)})"]
    rows = sorted(sources, key=lambda r: (not r.get("stale"),
                                          str(r.get("source"))))
    for r in rows:
        rate = r.get("rates") or {}
        main_rate = (rate.get("serve.asks") or rate.get("driver.asks")
                     or rate.get("serve.tells")
                     or rate.get("store.recorded"))
        flags = []
        if r.get("stale"):
            flags.append("STALE")
        if r.get("final"):
            flags.append("final")
        out.append(
            ("  {:<30}{:>7}s {:>9}/s  drop{:>4}  alrt{:>3} {}")
            .format(
                str(r.get("source"))[:30],
                _fmt(r.get("age_s")),
                _fmt(main_rate),
                _fmt(r.get("dropped"), nd=0),
                _fmt(r.get("alerts"), nd=0),
                " ".join(flags))[:width].rstrip())
    return out


def render(prev: Optional[Sample], cur: Sample, source: str,
           width: int = 78,
           sources: Optional[List[Dict[str, Any]]] = None) -> str:
    """One dashboard frame as text (pure: testable without a tty)."""
    r = rates(prev, cur)
    c, g, h = cur.counters, cur.gauges, cur.hists
    hits = c.get("store.hits", 0)
    misses = c.get("store.misses", 0)
    hit_rate = (hits / (hits + misses) if hits + misses else None)
    up = cur.meta.get("uptime_s")
    lines = [
        # the JAX package's frame text, title included: a frame of the
        # same scrape is the same text under either package
        f"ut top — {source}"[:width],
        time.strftime("%Y-%m-%d %H:%M:%S", time.localtime(cur.t))
        + (f"   up {up:,.0f}s" if up is not None else "")
        + (f"   window {cur.dt:.2f}s" if cur.dt else "")
        + (f"   sources {cur.meta['sources']}"
           if cur.meta.get("sources") is not None else "")
        + ("   [FINAL]" if cur.meta.get("final") else ""),
        "-" * min(width, 60),
        "serve     sessions {}   batch fill {}   groups+ {}".format(
            _fmt(g.get("serve.sessions.active"), nd=0),
            _fmt(g.get("serve.batch_fill"), nd=2),
            _fmt(c.get("serve.groups_created"), nd=0)),
        "rates     asks/s {}   tells/s {}   proposes/s {}   "
        "store-served/s {}".format(
            _fmt(r.get("serve.asks", r.get("driver.asks"))),
            _fmt(r.get("serve.tells", r.get("driver.told"))),
            _fmt(r.get("serve.proposes")),
            _fmt(r.get("serve.store_served"))),
        "latency   ask p50/p95 {}/{} ms   tell p50/p95 {}/{} ms".format(
            _fmt(_hist_p(h, "serve.ask_ms", "p50"), nd=2),
            _fmt(_hist_p(h, "serve.ask_ms", "p95"), nd=2),
            _fmt(_hist_p(h, "serve.tell_ms", "p50"), nd=2),
            _fmt(_hist_p(h, "serve.tell_ms", "p95"), nd=2)),
        "workers   busy {}   utilization {}   builds/s {}   "
        "build p95 {} s".format(
            _fmt(g.get("pool.busy"), nd=0),
            _fmt(g.get("pool.utilization"), nd=2),
            _fmt(r.get("pool.launched")),
            _fmt(_hist_p(h, "pool.build_s", "p95"), nd=2)),
        # recorded/acked-appends light up against a store-server
        # scrape (`ut-torch top --addr` on a `ut-torch store` process)
        "store     hits {}   misses {}   hit-rate {}   recorded {}   "
        "acked-appends {}   serve p95 {} ms".format(
            _fmt(hits, nd=0), _fmt(misses, nd=0),
            _fmt(None if hit_rate is None else 100 * hit_rate, "%"),
            _fmt(c.get("store.recorded"), nd=0),
            _fmt(c.get("rstore.appends"), nd=0),
            _fmt(_hist_p(h, "store.serve_ms", "p95"), nd=2)),
        "learn     snapshot v{}   refit lag {} rows   "
        "new bests {}".format(
            _fmt(g.get("surrogate.snapshot_version"), nd=0),
            _fmt(g.get("surrogate.refit_lag_rows"), nd=0),
            _fmt(c.get("serve.new_bests", c.get("driver.new_bests")),
                 nd=0)),
        # device panel: compile count/time + persistent-cache outcome
        # from the obs.device counters (the port compiles nothing, so
        # its own streams show 0 or "—"), achieved rates and util
        # fractions from the last measured window's aggregate gauges —
        # all "—" for an untraced stream
        "device    programs {}   compiles {} ({} ms)   "
        "cache hit/miss {}/{}   dispatches/s {}".format(
            _fmt(g.get("device.programs"), nd=0),
            _fmt(c.get("device.compiles"), nd=0),
            _fmt(_hist_p(h, "device.compile_ms", "sum"), nd=0),
            _fmt(c.get("device.compile_cache_hits"), nd=0),
            _fmt(c.get("device.compile_cache_misses"), nd=0),
            _fmt(r.get("device.dispatches"))),
        "roofline  flops/s {}   HBM B/s {}   MXU {}   HBM {}   "
        "AI {}".format(
            _fmt(g.get("device.achieved_flops_per_s"), nd=0),
            _fmt(g.get("device.achieved_hbm_bytes_per_s"), nd=0),
            _fmt(g.get("device.mxu_util"), nd=6),
            _fmt(g.get("device.hbm_util"), nd=4),
            _fmt(g.get("device.arith_intensity"), nd=3)),
    ]
    # search-quality panel: the journal-derived gauges a
    # QualityMonitor publishes; a run without a journal renders "—"
    if any(k.startswith("search.") for k in g):
        lines += [
            "search    best {}   tells {}   since-best {}   "
            "regret {}".format(
                _fmt(g.get("search.best_qor"), nd=4),
                _fmt(g.get("search.tells"), nd=0),
                _fmt(g.get("search.tells_since_best"), nd=0),
                _fmt(g.get("search.regret_proxy"), nd=4)),
            "quality   cal MAE {}   rank-corr {}   cover95 {}   "
            "dup {}   alerts {}".format(
                _fmt(g.get("search.cal_mae"), nd=4),
                _fmt(g.get("search.cal_rank_corr"), nd=2),
                _fmt(g.get("search.cal_cover95"), nd=2),
                _fmt(g.get("search.dup_rate"), nd=2),
                _fmt(c.get("search.alerts", 0), nd=0)),
        ]
    # anything moving that the fixed panel doesn't show (top deltas)
    shown = {"serve.asks", "serve.tells", "serve.proposes",
             "serve.store_served", "driver.asks", "driver.told",
             "pool.launched"}
    extras = sorted(((v, k) for k, v in r.items()
                     if v > 0 and k not in shown), reverse=True)[:4]
    if extras:
        lines.append("also      " + "   ".join(
            f"{k} {_fmt(v)}/s" for v, k in extras)[:width - 10])
    if sources is not None:
        lines += fleet_lines(sources, width)
    return "\n".join(lines)


# ------------------------------------------------------------------ CLI
def main(argv: Optional[List[str]] = None) -> int:
    p = argparse.ArgumentParser(
        prog="ut-torch top",
        description="live dashboard over a running uptune-tpu (PyTorch "
                    "port) server, hub or router, or a flight-recorder "
                    "metrics timeline")
    src = p.add_mutually_exclusive_group()
    src.add_argument("--addr", default=None, metavar="HOST:PORT",
                     help="poll a running `ut-torch serve` process's "
                          "metrics op — or a fleet-telemetry hub "
                          "(`ut-torch hub`) or router (`ut-torch "
                          "route`), whose scrape is the live fleet "
                          "rollup (default: the configured "
                          "serve-host:serve-port)")
    src.add_argument("--metrics", default=None, metavar="JSONL",
                     action="append",
                     help="tail flight-recorder metrics timeline(s) "
                          "instead of polling a server.  Repeatable "
                          "and glob-expanded ('out.json.metrics"
                          ".jsonl*' includes .hN replica files); "
                          "several files render one fleet-rolled "
                          "frame with per-source labels")
    p.add_argument("--fleet", action="store_true",
                   help="add the per-source panel: one labeled line "
                        "per shipping process (hub `sources` op) or "
                        "per metrics file")
    p.add_argument("--interval", type=float, default=2.0,
                   help="refresh cadence in seconds (default 2)")
    p.add_argument("--once", action="store_true",
                   help="print one frame and exit (scripts/tests)")
    p.add_argument("--json", action="store_true",
                   help="with --once: print the frame as one JSON "
                        "object (counters, gauges, hists, computed "
                        "rates, meta) instead of the rendered text, "
                        "so scripts/CI assert on fields rather than "
                        "scraping the dashboard")
    args = p.parse_args(argv)
    if args.json and not args.once:
        p.error("--json requires --once (one machine-readable frame)")

    client = None
    prev: Optional[Sample] = None
    # glob-expanded, order-stable, deduped metrics path set (an
    # unmatched pattern stays literal: the file may appear later)
    mpaths: List[str] = []
    for pat in (args.metrics or []):
        hits = sorted(_glob.glob(pat)) or [pat]
        for h in hits:
            if h not in mpaths:
                mpaths.append(h)

    def poll() -> Tuple[Optional[Sample], str,
                        Optional[List[Dict[str, Any]]]]:
        nonlocal client
        if mpaths:
            if len(mpaths) == 1:
                # single file: the historical exact-window frame (one
                # tail read per tick)
                rows = last_rows(mpaths[0], 2)
                if not rows:
                    return None, mpaths[0], None
                srcs = ([_source_row(os.path.basename(mpaths[0]),
                                     rows[-1])]
                        if args.fleet else None)
                return sample_from_row(rows[-1]), mpaths[0], srcs
            per: List[Tuple[str, Dict[str, Any]]] = []
            for path in mpaths:
                rows = last_rows(path, 1)
                if rows:
                    per.append((os.path.basename(path), rows[-1]))
            label = f"{len(mpaths)} metrics files"
            if not per:
                return None, label, None
            from .hub import fleet_rollup
            roll = fleet_rollup(per)
            cur = Sample(
                max(float(r.get("t") or 0.0) for _, r in per),
                roll["counters"], roll["gauges"], roll["hists"],
                deltas=roll["deltas"], dt=roll["dt"] or None,
                meta={"sources": len(per)})
            srcs = ([_source_row(lbl, row) for lbl, row in per]
                    if args.fleet else None)
            return cur, label, srcs
        from ..serve.client import ServeError, connect
        if client is None:
            client = connect(args.addr)
        resp = client.metrics()
        srcs = None
        if args.fleet:
            try:
                srcs = client.request("sources").get("rows")
            except ServeError:
                srcs = None     # a session server: no sources op
        return (sample_from_scrape(resp),
                f"{client.host}:{client.port}", srcs)

    try:
        while True:
            try:
                cur, source, srcs = poll()
            except (OSError, ValueError, RuntimeError) as e:
                print(f"ut-torch top: {e}", file=sys.stderr)
                return 1
            if cur is None:
                print(f"ut-torch top: no metrics rows yet in {source}",
                      file=sys.stderr)
                if args.once:
                    return 1
            else:
                if args.once and args.json:
                    frame_obj = {"t": cur.t, "source": source,
                                 "counters": cur.counters,
                                 "gauges": cur.gauges,
                                 "hists": cur.hists,
                                 "rates": rates(prev, cur),
                                 "window_s": cur.dt, "meta": cur.meta}
                    if srcs is not None:
                        frame_obj["sources"] = srcs
                    print(json.dumps(frame_obj, sort_keys=True))
                    return 0
                frame = render(prev, cur, source, sources=srcs)
                if args.once:
                    print(frame)
                    return 0
                sys.stdout.write(CLEAR + frame + "\n")
                sys.stdout.flush()
                prev = cur
            time.sleep(max(0.1, args.interval))
    except KeyboardInterrupt:
        return 0
    finally:
        if client is not None:
            client.close()


if __name__ == "__main__":
    sys.exit(main())
