"""`ut report` — render a tuning journal into a post-run quality
report.

The successor of the reference framework's CSV-archive +
`report.py` surface: where `ut-trace` shows *where the time went*,
this shows *whether the search was any good* — convergence curve,
per-arm attribution, surrogate-calibration reliability, store
efficacy, and the alerts the online detector would have raised — all
recomputed EXACTLY from the journal through `obs.quality.replay`
(the same code path the live gauges run), so the report can never
disagree with what `ut top` showed during the run.

    ut report out.journal.jsonl                    # -> .report.html
    ut report out.journal.jsonl --format md -o -   # markdown to stdout
    ut report j.jsonl --metrics trace.json.metrics.jsonl
    ut report 'out.journal.h*.jsonl'               # multi-replica
    ut report ut.fleet.jsonl                       # hub fleet timeline

Multi-source journals: several journal files (repeatable
positionals, glob-expanded — e.g. the ``.hN`` files every
``--num-hosts`` replica writes) or ONE hub fleet timeline
(``ut hub --timeline``, detected by its header; each source's shipped
journal rows are split back out) render a single document with a
fleet summary table and per-source attribution sections, each
replayed through the same exact `quality.replay` path.

The HTML is fully self-contained (inline SVG + CSS, no scripts, no
network), so it can be committed next to a bench artifact or attached
to a ticket; the markdown form carries the same numbers for terminals
and code review.  Charts use the repo's validated default palette
(light + dark via prefers-color-scheme); every chart is paired with
the table carrying the same data.
"""
from __future__ import annotations

import argparse
import glob as _glob
import html as _html
import json
import os
import sys
from typing import Any, Dict, List, Optional, Tuple

from . import journal as journal_mod
from . import quality as quality_mod

__all__ = ["analyze", "render", "render_html", "render_markdown",
           "render_multi", "read_sources", "summarize_metrics",
           "device_summary", "main"]

# nominal two-sided central-interval levels for the reliability table
# (z quantiles of the standard normal)
RELIABILITY_LEVELS = ((50, 0.6745), (80, 1.2816), (90, 1.6449),
                      (95, 1.9600), (99, 2.5758))

# categorical slots (validated default palette, references order —
# fixed assignment by first appearance, never cycled; arms past the
# 8th fold to the neutral "other" ink)
_SERIES_LIGHT = ("#2a78d6", "#eb6834", "#1baf7a", "#eda100",
                 "#e87ba4", "#008300", "#4a3aa7", "#e34948")
_SERIES_DARK = ("#3987e5", "#d95926", "#199e70", "#c98500",
                "#d55181", "#008300", "#9085e9", "#e66767")
_OTHER = "#8a8985"


def analyze(header: Dict[str, Any], rows: List[Dict[str, Any]],
            config: Optional[quality_mod.QualityConfig] = None
            ) -> Dict[str, Any]:
    """Everything the renderers need, computed once: the exact quality
    replay plus the row-level sequences the charts draw."""
    mon = quality_mod.replay(rows, config)
    tells: List[Dict[str, Any]] = []
    cal: List[Tuple[float, float, float]] = []   # (mu, sigma, qor)
    store_hits = 0
    store_saved_s = 0.0
    exchanges = 0
    snapshots = 0
    features = 0
    interms = 0
    sessions: Dict[str, Dict[str, Any]] = {}
    sense = "min"
    best: Optional[float] = None
    for row in rows:
        ev = row.get("ev")
        if ev == "step":
            # flatten the per-trial outcome arrays into tell records
            # via the reference compact-encoding decoder (the journal
            # packs one row per ticket — obs/journal.py EVENT_KINDS)
            if row.get("sense") == "max":
                sense = "max"
            for gid, ok, qor, nb, dur, mu, sigma in \
                    journal_mod.step_tells(row):
                if nb and qor is not None:
                    best = float(qor)
                tell = {"t": row.get("t"), "gid": gid,
                        "arm": row.get("arm"), "ok": ok, "qor": qor,
                        "new_best": nb, "best": best, "dur": dur}
                if mu is not None:
                    tell["mu"], tell["sigma"] = mu, sigma
                    if ok and qor is not None:
                        cal.append((float(mu), float(sigma),
                                    float(qor)))
                tells.append(tell)
            if row.get("best") is not None:
                best = float(row["best"])   # authoritative incumbent
        elif ev == "store_hit":
            store_hits += 1
            store_saved_s += float(row.get("dur") or 0.0)
        elif ev == "exchange":
            exchanges += 1
        elif ev == "snapshot":
            snapshots += 1
        elif ev == "feature":
            features += 1
        elif ev == "interm":
            interms += 1
        elif ev == "serve_tell":
            s = sessions.setdefault(str(row.get("session")),
                                    {"tells": 0, "new_bests": 0,
                                     "fails": 0})
            s["tells"] += 1
            s["new_bests"] += int(bool(row.get("new_best")))
            s["fails"] += int(not row.get("ok"))
    reliability = []
    if cal:
        zs = [(q - m) / max(s, 1e-12) for m, s, q in cal]
        for level, zq in RELIABILITY_LEVELS:
            emp = sum(1 for z in zs if abs(z) <= zq) / len(zs)
            reliability.append({"nominal": level,
                                "empirical": round(emp, 4)})
    return {"header": header, "mon": mon, "tells": tells,
            "sense": sense, "cal_rows": len(cal),
            "reliability": reliability, "store_hits": store_hits,
            "store_saved_s": round(store_saved_s, 3),
            "exchanges": exchanges, "snapshots": snapshots,
            "features": features, "interms": interms,
            "sessions": sessions}


def summarize_metrics(metrics_path: str) -> Optional[Dict[str, Any]]:
    """Optional flight-recorder sidecar summary: wall span, row count,
    and the peak per-window rate of the headline counters — the system
    plane's one-paragraph contribution to a search-quality report."""
    rows = []
    try:
        with open(metrics_path) as f:
            for line in f:
                line = line.strip()
                if not line:
                    continue
                try:
                    row = json.loads(line)
                except json.JSONDecodeError:
                    continue        # torn tail
                if isinstance(row, dict) and "counters" in row:
                    rows.append(row)
    except OSError:
        return None
    if not rows:
        return None
    peaks: Dict[str, float] = {}
    for row in rows:
        dt = row.get("dt") or 0
        if not dt:
            continue
        for k, v in (row.get("deltas") or {}).items():
            rate = v / dt
            if rate > peaks.get(k, 0.0):
                peaks[k] = rate
    top = sorted(peaks.items(), key=lambda kv: -kv[1])[:6]
    return {"rows": len(rows),
            "span_s": round(rows[-1].get("t", 0) - rows[0].get("t", 0),
                            3),
            "final_counters": rows[-1].get("counters", {}),
            "final_gauges": rows[-1].get("gauges", {}),
            "final_hists": rows[-1].get("hists", {}),
            "peak_rates": {k: round(v, 2) for k, v in top}}


# device-telemetry extraction: the same replay path as the
# rest of the report — the flight recorder's FINAL row carries the
# run's terminal device.* gauges/counters, exactly what `ut top`
# showed live, so the report can never disagree with the dashboard
_DEV_PROGRAM_FAMILIES = ("flops", "bytes", "compile_ms",
                         "arith_intensity")
_DEV_ROOFLINE_KEYS = ("achieved_flops_per_s",
                      "achieved_hbm_bytes_per_s", "peak_flops_per_s",
                      "peak_hbm_bytes_per_s", "mxu_util", "hbm_util",
                      "arith_intensity")


def device_summary(met: Optional[Dict[str, Any]]
                   ) -> Optional[Dict[str, Any]]:
    """Per-program flops/bytes, the compile breakdown and the roofline
    aggregates from a metrics timeline's final row; None when the run
    carried no device telemetry (the section is simply absent)."""
    if not met:
        return None
    g = met.get("final_gauges") or {}
    c = met.get("final_counters") or {}
    if not any(k.startswith("device.") for k in list(g) + list(c)):
        return None
    progs: Dict[str, Dict[str, Any]] = {}
    for fam in _DEV_PROGRAM_FAMILIES:
        prefix = f"device.{fam}."
        for k, v in g.items():
            if k.startswith(prefix):
                progs.setdefault(k[len(prefix):], {})[fam] = v
    h = (met.get("final_hists") or {}).get("device.compile_ms") or {}
    return {
        "programs": progs,
        "compile": {
            "compiles": c.get("device.compiles"),
            "compile_ms_total": h.get("sum"),
            "cache_hits": c.get("device.compile_cache_hits"),
            "cache_misses": c.get("device.compile_cache_misses"),
            "dispatches": c.get("device.dispatches"),
        },
        "roofline": {k: g.get(f"device.{k}")
                     for k in _DEV_ROOFLINE_KEYS
                     if g.get(f"device.{k}") is not None},
    }


# --------------------------------------------------------------- SVG
def _fmt(v: Any, nd: int = 4) -> str:
    if v is None:
        return "—"
    if isinstance(v, float):
        return f"{v:.{nd}g}"
    return str(v)


def _scale(lo: float, hi: float, a: float, b: float):
    span = (hi - lo) or 1.0
    return lambda v: a + (v - lo) / span * (b - a)


def _ticks(lo: float, hi: float, n: int = 4) -> List[float]:
    span = (hi - lo) or 1.0
    return [lo + span * i / n for i in range(n + 1)]


def _svg_convergence(an: Dict[str, Any], width: int = 640,
                     height: int = 240) -> str:
    """Best-so-far step line over per-tell QoR dots (one series + its
    context marks; y = user-oriented QoR, x = tell index)."""
    tells = [r for r in an["tells"] if r.get("ok")
             and r.get("qor") is not None]
    if len(tells) < 2:
        return ""
    qs = [float(r["qor"]) for r in tells]
    bests = [float(r["best"]) for r in tells if r.get("best") is not None]
    lo = min(qs + bests)
    hi = max(qs + bests)
    ml, mr, mt, mb = 58, 14, 10, 26
    sx = _scale(0, len(tells) - 1, ml, width - mr)
    sy = _scale(lo, hi, height - mb, mt)
    grid, labels = [], []
    for tv in _ticks(lo, hi):
        y = sy(tv)
        grid.append(f'<line x1="{ml}" y1="{y:.1f}" x2="{width - mr}" '
                    f'y2="{y:.1f}" class="grid"/>')
        labels.append(f'<text x="{ml - 6}" y="{y + 3.5:.1f}" '
                      f'class="tick" text-anchor="end">'
                      f'{_fmt(tv, 3)}</text>')
    for tv in _ticks(0, len(tells) - 1):
        x = sx(tv)
        labels.append(f'<text x="{x:.1f}" y="{height - mb + 16}" '
                      f'class="tick" text-anchor="middle">'
                      f'{int(tv)}</text>')
    dots = []
    for i, r in enumerate(tells):
        dots.append(
            f'<circle cx="{sx(i):.1f}" cy="{sy(float(r["qor"])):.1f}" '
            f'r="2" class="dot"><title>tell {i} gid={r.get("gid")} '
            f'arm={_html.escape(str(r.get("arm")))} '
            f'qor={_fmt(float(r["qor"]))}</title></circle>')
    pts, prev_best = [], None
    for i, r in enumerate(tells):
        b = r.get("best")
        if b is None:
            continue
        b = float(b)
        if prev_best is not None:
            pts.append(f"{sx(i):.1f},{sy(prev_best):.1f}")  # step
        pts.append(f"{sx(i):.1f},{sy(b):.1f}")
        prev_best = b
    line = (f'<polyline points="{" ".join(pts)}" class="best"/>'
            if pts else "")
    return (
        f'<svg viewBox="0 0 {width} {height}" role="img" '
        f'aria-label="convergence curve">'
        f'{"".join(grid)}'
        f'<line x1="{ml}" y1="{height - mb}" x2="{width - mr}" '
        f'y2="{height - mb}" class="axis"/>'
        f'{"".join(dots)}{line}{"".join(labels)}'
        f'<text x="{ml}" y="{height - 4}" class="tick">tell index'
        f'</text></svg>'
        f'<div class="legend"><span><i class="sw best-sw"></i>'
        f'best so far</span><span><i class="sw dot-sw"></i>'
        f'per-tell QoR</span></div>')


def _arm_slots(an: Dict[str, Any]) -> Dict[str, int]:
    """Fixed categorical slot per arm, by first appearance in the tell
    stream (never re-assigned, never cycled); -1 = folded to Other."""
    slots: Dict[str, int] = {}
    for r in an["tells"]:
        arm = str(r.get("arm"))
        if arm not in slots:
            slots[arm] = len(slots) if len(slots) < 8 else -1
    return slots


def _svg_arm_timeline(an: Dict[str, Any], width: int = 640,
                      height: int = 64) -> str:
    """Attribution strip: one thin mark per tell, colored by arm;
    new-best tells get a full-height mark."""
    tells = an["tells"]
    if not tells:
        return ""
    slots = _arm_slots(an)
    ml, mr = 58, 14
    sx = _scale(0, max(1, len(tells) - 1), ml, width - mr)
    marks = []
    for i, r in enumerate(tells):
        arm = str(r.get("arm"))
        cls = f"s{slots[arm]}" if slots[arm] >= 0 else "sx"
        h = height - 24 if r.get("new_best") else (height - 24) // 2
        y = height - 18 - h
        marks.append(
            f'<rect x="{sx(i) - 1:.1f}" y="{y}" width="2" '
            f'height="{h}" class="{cls}"><title>tell {i} '
            f'arm={_html.escape(arm)}'
            f'{" NEW BEST" if r.get("new_best") else ""}</title>'
            f'</rect>')
    legend = "".join(
        f'<span><i class="sw {"s%d" % s if s >= 0 else "sx"}-sw"></i>'
        f'{_html.escape(a)}</span>'
        for a, s in slots.items())
    return (
        f'<svg viewBox="0 0 {width} {height}" role="img" '
        f'aria-label="arm attribution timeline">'
        f'<line x1="{ml}" y1="{height - 18}" x2="{width - mr}" '
        f'y2="{height - 18}" class="axis"/>{"".join(marks)}'
        f'<text x="{ml}" y="{height - 4}" class="tick">tell index '
        f'(tall = new best)</text></svg>'
        f'<div class="legend">{legend}</div>')


# ----------------------------------------------------------- renders
def _arm_table(an: Dict[str, Any]) -> List[List[Any]]:
    mon = an["mon"]
    out = []
    for arm, (pulls, evals, bests) in sorted(mon.arm_stats.items()):
        out.append([arm, pulls, evals, bests,
                    _fmt(mon.gauges.get(f"search.arm_evals_share.{arm}"),
                         3),
                    _fmt(mon.gauges.get(f"search.arm_best_share.{arm}"),
                         3)])
    return out


def _summary_pairs(an: Dict[str, Any],
                   met: Optional[Dict[str, Any]]) -> List[Tuple[str, Any]]:
    mon = an["mon"]
    g = mon.gauges
    pairs = [
        ("best QoR", _fmt(mon.best, 6)),
        ("sense", an["sense"]),
        ("tells", mon.tells),
        ("new bests", mon.new_bests),
        ("tells since best", mon.tells_since_best),
        ("regret proxy", _fmt(g.get("search.regret_proxy"))),
        ("pulls", mon.pulls),
        ("dup rate", _fmt(g.get("search.dup_rate"), 3)),
        ("prune rate", _fmt(g.get("search.prune_rate"), 3)),
        ("fail rate", _fmt(g.get("search.fail_rate"), 3)),
        ("store hits", an["store_hits"]),
        ("build time served from store",
         f"{an['store_saved_s']:.1f} s"),
        ("exchange injections", an["exchanges"]),
        ("surrogate snapshots", an["snapshots"]),
        ("calibration rows", an["cal_rows"]),
        ("calibration MAE (window)",
         _fmt(g.get("search.cal_mae"))),
        ("rank corr (window)", _fmt(g.get("search.cal_rank_corr"), 3)),
        ("covariate rows", an["features"]),
        ("interm rows", an["interms"]),
        ("alerts", len(mon.alerts)),
    ]
    if an["sessions"]:
        pairs.append(("serve sessions", len(an["sessions"])))
    if met:
        pairs.append(("flight-recorder rows",
                      f"{met['rows']} over {met['span_s']} s"))
    return pairs


def render_markdown(an: Dict[str, Any],
                    met: Optional[Dict[str, Any]] = None) -> str:
    mon = an["mon"]
    meta = an["header"].get("meta") or {}
    lines = ["# ut report", ""]
    if meta:
        lines += ["run: `" + json.dumps(meta, sort_keys=True) + "`", ""]
    lines += ["## Summary", "", "| metric | value |", "|---|---|"]
    lines += [f"| {k} | {v} |" for k, v in _summary_pairs(an, met)]
    lines += ["", "## Arm attribution", "",
              "| arm | pulls | evals | new bests | evals share | "
              "best share |", "|---|---|---|---|---|---|"]
    for row in _arm_table(an):
        lines.append("| " + " | ".join(str(c) for c in row) + " |")
    if an["reliability"]:
        lines += ["", "## Calibration reliability "
                      f"({an['cal_rows']} joined rows)", "",
                  "| nominal interval | empirical coverage |",
                  "|---|---|"]
        for r in an["reliability"]:
            lines.append(f"| {r['nominal']}% | "
                         f"{100 * r['empirical']:.1f}% |")
    if mon.alerts:
        lines += ["", "## Alerts", "", "| t (s) | kind | detail |",
                  "|---|---|---|"]
        for a in mon.alerts:
            detail = {k: v for k, v in a.items()
                      if k not in ("kind", "t")}
            lines.append(f"| {a['t']:.1f} | {a['kind']} | "
                         f"`{json.dumps(detail, sort_keys=True)}` |")
    else:
        lines += ["", "No alerts fired."]
    if an["sessions"]:
        lines += ["", "## Serve sessions", "",
                  "| session | tells | new bests | fails |",
                  "|---|---|---|---|"]
        for sid in sorted(an["sessions"]):
            s = an["sessions"][sid]
            lines.append(f"| {sid} | {s['tells']} | {s['new_bests']} "
                         f"| {s['fails']} |")
    if met:
        lines += ["", "## System timeline (flight recorder)", "",
                  "| counter | peak rate /s |", "|---|---|"]
        for k, v in met["peak_rates"].items():
            lines.append(f"| {k} | {v} |")
    dev = device_summary(met)
    if dev:
        lines += ["", "## Device & compile", ""]
        comp = dev["compile"]
        lines += ["| metric | value |", "|---|---|"]
        for label, key in (("compiles", "compiles"),
                           ("compile time (ms)", "compile_ms_total"),
                           ("compile-cache hits", "cache_hits"),
                           ("compile-cache misses", "cache_misses"),
                           ("device dispatches", "dispatches")):
            lines.append(f"| {label} | {_fmt(comp.get(key))} |")
        if dev["programs"]:
            lines += ["", "| program | flops | bytes | AI | "
                          "compile ms |", "|---|---|---|---|---|"]
            for name in sorted(dev["programs"]):
                p = dev["programs"][name]
                lines.append(
                    f"| {name} | {_fmt(p.get('flops'))} | "
                    f"{_fmt(p.get('bytes'))} | "
                    f"{_fmt(p.get('arith_intensity'), 3)} | "
                    f"{_fmt(p.get('compile_ms'), 3)} |")
        if dev["roofline"]:
            lines += ["", "| roofline (last measured window) | value |",
                      "|---|---|"]
            for k in sorted(dev["roofline"]):
                lines.append(f"| {k} | {_fmt(dev['roofline'][k])} |")
    return "\n".join(lines) + "\n"


_CSS = """
.viz-root {{
  color-scheme: light;
  --surface-1: #fcfcfb; --text-primary: #0b0b0b;
  --text-secondary: #52514e; --grid: #e7e6e2; --axis: #b5b4af;
  {light}
  --other: #8a8985;
  font: 14px/1.5 system-ui, sans-serif;
  color: var(--text-primary); background: var(--surface-1);
  max-width: 720px; margin: 0 auto; padding: 24px;
}}
@media (prefers-color-scheme: dark) {{
  :root:where(:not([data-theme="light"])) .viz-root {{
    color-scheme: dark;
    --surface-1: #1a1a19; --text-primary: #ffffff;
    --text-secondary: #c3c2b7; --grid: #31302e; --axis: #55544f;
    {dark}
  }}
}}
.viz-root h1 {{ font-size: 20px; }}
.viz-root h2 {{ font-size: 16px; margin-top: 28px; }}
.viz-root table {{ border-collapse: collapse; margin: 8px 0; }}
.viz-root td, .viz-root th {{
  padding: 3px 10px; border-bottom: 1px solid var(--grid);
  text-align: left; font-variant-numeric: tabular-nums; }}
.viz-root th {{ color: var(--text-secondary); font-weight: 600; }}
.viz-root .meta {{ color: var(--text-secondary); }}
.viz-root svg {{ width: 100%; height: auto; display: block; }}
.viz-root .grid {{ stroke: var(--grid); stroke-width: 1; }}
.viz-root .axis {{ stroke: var(--axis); stroke-width: 1; }}
.viz-root .tick {{ fill: var(--text-secondary); font-size: 10px; }}
.viz-root .best {{ fill: none; stroke: var(--s0); stroke-width: 2;
  stroke-linejoin: round; }}
.viz-root .dot {{ fill: var(--axis); }}
.viz-root .legend {{ color: var(--text-secondary); font-size: 12px;
  display: flex; gap: 16px; margin: 4px 0 0 58px; }}
.viz-root .legend .sw {{ display: inline-block; width: 10px;
  height: 10px; border-radius: 2px; margin-right: 5px; }}
.viz-root .best-sw {{ background: var(--s0); }}
.viz-root .dot-sw {{ background: var(--axis); border-radius: 50%; }}
.viz-root .sx {{ fill: var(--other); }}
.viz-root .sx-sw {{ background: var(--other); }}
{series_css}
.viz-root .alert td:nth-child(2) {{ font-weight: 600; }}
"""


def _report_css() -> str:
    """The one CSS block both HTML renderers (single-source and
    fleet) embed — styling fixes land once."""
    series_css = "\n".join(
        f".viz-root .s{i} {{ fill: var(--s{i}); }}\n"
        f".viz-root .s{i}-sw {{ background: var(--s{i}); }}"
        for i in range(8))
    return _CSS.format(
        light="\n  ".join(f"--s{i}: {c};"
                          for i, c in enumerate(_SERIES_LIGHT)),
        dark="\n    ".join(f"--s{i}: {c};"
                           for i, c in enumerate(_SERIES_DARK)),
        series_css=series_css)


def _table_html(headers, rows_) -> str:
    """Escaped HTML table — the shared cell-escaping path of both
    renderers."""
    h = "".join(f"<th>{_html.escape(str(c))}</th>" for c in headers)
    b = "".join(
        "<tr>" + "".join(f"<td>{_html.escape(str(c))}</td>"
                         for c in row) + "</tr>"
        for row in rows_)
    return f"<table><tr>{h}</tr>{b}</table>"


def render_html(an: Dict[str, Any],
                met: Optional[Dict[str, Any]] = None) -> str:
    import time as _time
    meta = an["header"].get("meta") or {}
    origin = an["header"].get("origin_unix")
    when = (_time.strftime("%Y-%m-%d %H:%M:%S",
                           _time.gmtime(origin)) + " UTC"
            if origin else "—")
    css = _report_css()
    table = _table_html

    parts = [
        "<!doctype html><html><head><meta charset='utf-8'>",
        "<title>ut report</title>",
        f"<style>{css}</style></head><body class='viz-root'>",
        "<h1>ut report — search quality</h1>",
        f"<p class='meta'>journal recorded {when}"
        + (f" · {_html.escape(json.dumps(meta, sort_keys=True))}"
           if meta else "") + "</p>",
        "<h2>Summary</h2>",
        table(("metric", "value"), _summary_pairs(an, met)),
    ]
    conv = _svg_convergence(an)
    if conv:
        parts += ["<h2>Convergence</h2>", conv]
    strip = _svg_arm_timeline(an)
    if strip:
        parts += ["<h2>Arm attribution</h2>", strip]
    parts.append(table(("arm", "pulls", "evals", "new bests",
                        "evals share", "best share"), _arm_table(an)))
    if an["reliability"]:
        parts += [f"<h2>Calibration reliability "
                  f"({an['cal_rows']} joined rows)</h2>",
                  table(("nominal interval", "empirical coverage"),
                        [(f"{r['nominal']}%",
                          f"{100 * r['empirical']:.1f}%")
                         for r in an["reliability"]])]
    mon = an["mon"]
    parts.append("<h2>Alerts</h2>")
    if mon.alerts:
        parts.append(table(
            ("t (s)", "kind", "detail"),
            [(f"{a['t']:.1f}", a["kind"],
              json.dumps({k: v for k, v in a.items()
                          if k not in ("kind", "t")}, sort_keys=True))
             for a in mon.alerts]))
    else:
        parts.append("<p class='meta'>No alerts fired.</p>")
    if an["sessions"]:
        parts += ["<h2>Serve sessions</h2>",
                  table(("session", "tells", "new bests", "fails"),
                        [(sid, s["tells"], s["new_bests"], s["fails"])
                         for sid, s in sorted(an["sessions"].items())])]
    if met:
        parts += ["<h2>System timeline (flight recorder)</h2>",
                  table(("counter", "peak rate /s"),
                        sorted(met["peak_rates"].items())),
                  f"<p class='meta'>{met['rows']} rows over "
                  f"{met['span_s']} s</p>"]
    dev = device_summary(met)
    if dev:
        comp = dev["compile"]
        parts += ["<h2>Device &amp; compile</h2>",
                  table(("metric", "value"),
                        [("compiles", _fmt(comp.get("compiles"))),
                         ("compile time (ms)",
                          _fmt(comp.get("compile_ms_total"))),
                         ("compile-cache hits",
                          _fmt(comp.get("cache_hits"))),
                         ("compile-cache misses",
                          _fmt(comp.get("cache_misses"))),
                         ("device dispatches",
                          _fmt(comp.get("dispatches")))])]
        if dev["programs"]:
            parts.append(table(
                ("program", "flops", "bytes", "AI", "compile ms"),
                [(name, _fmt(p.get("flops")), _fmt(p.get("bytes")),
                  _fmt(p.get("arith_intensity"), 3),
                  _fmt(p.get("compile_ms"), 3))
                 for name, p in sorted(dev["programs"].items())]))
        if dev["roofline"]:
            parts.append(table(
                ("roofline (last measured window)", "value"),
                [(k, _fmt(dev["roofline"][k]))
                 for k in sorted(dev["roofline"])]))
    parts.append("</body></html>")
    return "".join(parts)


def render(journal_path: str, metrics_path: Optional[str] = None,
           fmt: str = "html",
           config: Optional[quality_mod.QualityConfig] = None) -> str:
    header, rows = journal_mod.read(journal_path)
    an = analyze(header, rows, config)
    met = summarize_metrics(metrics_path) if metrics_path else None
    if fmt == "md":
        return render_markdown(an, met)
    return render_html(an, met)


# ----------------------------------------------------------- multi-source
def _is_fleet_timeline(path: str) -> bool:
    """A hub fleet timeline announces itself with a ``{"fleet": 1}``
    header line (obs/hub.py); a plain journal starts with
    ``{"journal": 1}``."""
    try:
        with open(path) as f:
            for line in f:
                line = line.strip()
                if not line:
                    continue
                try:
                    rec = json.loads(line)
                except json.JSONDecodeError:
                    return False
                return isinstance(rec, dict) and "fleet" in rec
    except OSError:
        pass
    return False


def read_fleet(path: str) -> List[Tuple[str, Dict[str, Any],
                                        List[Dict[str, Any]]]]:
    """Split a hub fleet timeline (including its rotation chain) back
    into per-source journal streams: ``[(source_label, header, rows),
    ...]``.  Only ``kind == "journal"`` rows participate — window
    snapshots and health rollups are system-plane telemetry the
    quality replay has no use for."""
    from . import flight
    origin = None
    per: Dict[str, List[Dict[str, Any]]] = {}
    for rec in flight.read_chain(path):
        if "fleet" in rec:
            origin = origin or rec.get("origin_unix")
            continue
        if rec.get("kind") != "journal":
            continue
        row = rec.get("row")
        if isinstance(row, dict) and "ev" in row:
            per.setdefault(str(rec.get("src")), []).append(row)
    return [(src,
             {"journal": journal_mod.SCHEMA_VERSION,
              "origin_unix": origin,
              "meta": {"source": src,
                       "fleet": os.path.basename(path)}},
             rows)
            for src, rows in sorted(per.items())]


def read_sources(paths: List[str]
                 ) -> List[Tuple[str, Dict[str, Any],
                                 List[Dict[str, Any]]]]:
    """Normalize the CLI's positional(s) into per-source journal
    streams.  One fleet timeline expands into its shipped sources;
    journal files contribute one source each, labeled by basename."""
    if len(paths) == 1 and _is_fleet_timeline(paths[0]):
        return read_fleet(paths[0])
    out = []
    for p in paths:
        header, rows = journal_mod.read(p)
        out.append((os.path.basename(p), header, rows))
    return out


def _source_summary_row(label: str, an: Dict[str, Any]) -> List[Any]:
    mon = an["mon"]
    tells = [r for r in an["tells"] if r.get("ok")]
    best = next((r["best"] for r in reversed(an["tells"])
                 if r.get("best") is not None), None)
    return [label, len(tells),
            _fmt(best) if best is not None else "—",
            sum(1 for r in an["tells"] if r.get("new_best")),
            len(mon.alerts), an["store_hits"]]


_FLEET_HEADERS = ("source", "tells", "best", "new bests", "alerts",
                  "store hits")


def render_multi(sources: List[Tuple[str, Dict[str, Any],
                                     List[Dict[str, Any]]]],
                 fmt: str = "html",
                 config: Optional[quality_mod.QualityConfig] = None
                 ) -> str:
    """One document over several sources: a fleet summary table, then
    per-source attribution (summary, arm table, convergence chart in
    HTML, alerts) — every source replayed through the same
    `quality.replay` path as the single-source report."""
    ans = [(label, analyze(header, rows, config))
           for label, header, rows in sources]
    if fmt == "md":
        lines = ["# ut report — fleet", "",
                 f"{len(ans)} sources", "", "## Sources", "",
                 "| " + " | ".join(_FLEET_HEADERS) + " |",
                 "|" + "---|" * len(_FLEET_HEADERS)]
        for label, an in ans:
            lines.append("| " + " | ".join(
                str(c) for c in _source_summary_row(label, an)) + " |")
        for label, an in ans:
            lines += ["", f"## Source: {label}", "",
                      "| metric | value |", "|---|---|"]
            lines += [f"| {k} | {v} |"
                      for k, v in _summary_pairs(an, None)]
            lines += ["", "| arm | pulls | evals | new bests | "
                          "evals share | best share |",
                      "|---|---|---|---|---|---|"]
            for row in _arm_table(an):
                lines.append("| " + " | ".join(str(c) for c in row)
                             + " |")
            mon = an["mon"]
            if mon.alerts:
                lines += ["", "| t (s) | kind |", "|---|---|"]
                lines += [f"| {a['t']:.1f} | {a['kind']} |"
                          for a in mon.alerts]
        return "\n".join(lines) + "\n"

    # html: the single-source document's shared CSS + table helpers
    css = _report_css()
    table = _table_html
    parts = [
        "<!doctype html><html><head><meta charset='utf-8'>",
        "<title>ut report — fleet</title>",
        f"<style>{css}</style></head><body class='viz-root'>",
        "<h1>ut report — fleet</h1>",
        f"<p class='meta'>{len(ans)} sources</p>",
        "<h2>Sources</h2>",
        table(_FLEET_HEADERS,
              [_source_summary_row(label, an) for label, an in ans]),
    ]
    for label, an in ans:
        parts += [f"<h2>Source: {_html.escape(label)}</h2>",
                  table(("metric", "value"), _summary_pairs(an, None))]
        conv = _svg_convergence(an)
        if conv:
            parts.append(conv)
        parts.append(table(("arm", "pulls", "evals", "new bests",
                            "evals share", "best share"),
                           _arm_table(an)))
        mon = an["mon"]
        if mon.alerts:
            parts.append(table(
                ("t (s)", "kind", "detail"),
                [(f"{a['t']:.1f}", a["kind"],
                  json.dumps({k: v for k, v in a.items()
                              if k not in ("kind", "t")},
                             sort_keys=True))
                 for a in mon.alerts]))
    parts.append("</body></html>")
    return "".join(parts)


# ------------------------------------------------------------------ CLI
def main(argv: Optional[List[str]] = None) -> int:
    p = argparse.ArgumentParser(
        prog="ut report",
        description="render a tuning journal into a self-contained "
                    "search-quality report (docs/OBSERVABILITY.md "
                    "'Search-quality telemetry')")
    p.add_argument("journal", nargs="+",
                   help="tuning journal JSONL(s) (ut --journal / "
                        "ut serve --journal; repeatable and "
                        "glob-expanded, e.g. 'out.jsonl.h*') — or ONE "
                        "hub fleet timeline (ut hub --timeline), "
                        "split back into its shipped per-source "
                        "journal streams")
    p.add_argument("--metrics", default=None, metavar="JSONL",
                   help="optional flight-recorder metrics timeline to "
                        "fold in (system-plane peak rates; "
                        "single-source reports only)")
    p.add_argument("--format", choices=("html", "md"), default="html")
    p.add_argument("-o", "--out", default=None,
                   help="output path ('-' = stdout; default "
                        "<journal>.report.<fmt>)")
    args = p.parse_args(argv)
    paths: List[str] = []
    for pat in args.journal:
        hits = sorted(_glob.glob(pat)) or [pat]
        for h in hits:
            if h not in paths:
                paths.append(h)
    try:
        if len(paths) == 1 and not _is_fleet_timeline(paths[0]):
            text = render(paths[0], args.metrics, args.format)
        else:
            sources = read_sources(paths)
            if not sources:
                print(f"ut report: no journal rows in {paths}",
                      file=sys.stderr)
                return 1
            text = render_multi(sources, args.format)
    except (OSError, ValueError) as e:
        print(f"ut report: {e}", file=sys.stderr)
        return 1
    out = args.out or f"{paths[0]}.report.{args.format}"
    if out == "-":
        sys.stdout.write(text)
    else:
        with open(out, "w") as f:
            f.write(text)
        print(f"ut report: wrote {out}", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
