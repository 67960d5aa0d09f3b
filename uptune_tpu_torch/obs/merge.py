"""`ut-trace`: join multi-process trace shards into one document.

The distributed runs this repo now produces leave their telemetry in
per-process shards — a driver's ``--trace`` export, each ``--num-hosts``
replica's ``.hN`` file, a `ut serve` server's shutdown export, a traced
client's own trace, and WorkerPool sandbox sidecar JSONL from children
no reap collected.  Perfetto can open only one file;
``ut-trace merge`` aligns the shards' clocks and emits one
`validate_trace`-clean Chrome document:

* each shard becomes its own **pid** with a ``process_name`` metadata
  record (its declared role — ``otherData.process`` / sidecar header
  ``process`` — or the file's basename), keeping every shard's lanes
  intact under it;
* timestamps are shifted by each shard's unix-clock offset against the
  earliest shard's origin (``otherData.origin_unix``).  On one machine
  that is one clock and the alignment is exact; across hosts it is as
  good as NTP — expect ~ms skew, not ordering guarantees for sub-ms
  spans (docs/OBSERVABILITY.md caveats);
* client/server span JOINS are annotated: a ``client.request`` span
  whose ``ctx`` id matches a ``serve.handle`` span's ``parent`` gains
  ``server_ms`` and ``wire_ms`` args — client-observed latency,
  decomposed into server time and everything else (wire + queueing).

CLI::

    ut-trace merge -o merged.json driver.json serve.json client.json \
        ut.temp/temp.0/ut.trace.jsonl
    ut-trace validate merged.json

(``python -m uptune_tpu_torch.obs.merge``).
"""
from __future__ import annotations

import argparse
import json
import os
import sys
from typing import Any, Dict, List, Optional

from . import sidecar
from .export import validate_trace

__all__ = ["load_shard", "merge_shards", "merge_files", "main"]


class ShardError(ValueError):
    """A file that is neither a Chrome-trace document nor a sidecar."""


def _norm_chrome(doc: Dict[str, Any], path: str) -> Dict[str, Any]:
    """Chrome-trace document -> normalized shard: events in SECONDS
    relative to the shard's own origin, lanes resolved to names."""
    evs = doc.get("traceEvents")
    if not isinstance(evs, list):
        raise ShardError(f"{path}: no traceEvents list")
    other = doc.get("otherData", {}) or {}
    lane_of: Dict[Any, str] = {}
    for e in evs:
        if isinstance(e, dict) and e.get("ph") == "M" \
                and e.get("name") == "thread_name":
            lane_of[e.get("tid")] = e.get("args", {}).get(
                "name", f"tid-{e.get('tid')}")
    events = []
    for e in evs:
        if not isinstance(e, dict) or e.get("ph") not in ("X", "i", "C"):
            continue
        events.append({
            "name": e.get("name", "?"),
            "ts": float(e.get("ts", 0.0)) / 1e6,
            "dur": (float(e["dur"]) / 1e6
                    if isinstance(e.get("dur"), (int, float)) else None),
            "track": lane_of.get(e.get("tid"), f"tid-{e.get('tid')}"),
            "attrs": e.get("args"),
            "ph": e["ph"],
        })
    return {
        "path": path,
        "process": other.get("process") or os.path.basename(path),
        "origin_unix": float(other.get("origin_unix", 0.0) or 0.0),
        "events": events,
        "other": other,
    }


def _norm_sidecar(header: Dict[str, Any], events: List[Dict[str, Any]],
                  path: str) -> Dict[str, Any]:
    out = []
    for e in events:
        out.append({"name": e.get("name", "?"),
                    "ts": float(e.get("ts", 0.0)),
                    "dur": e.get("dur"),
                    "track": e.get("track") or "child",
                    "attrs": e.get("attrs"),
                    "ph": "i" if e.get("dur") is None else "X"})
    proc = header.get("process") or "worker-child"
    if header.get("gid") is not None:
        proc = f"{proc} gid={header['gid']}"
    return {"path": path, "process": proc,
            "origin_unix": float(header.get("origin_unix", 0.0) or 0.0),
            "events": out, "other": dict(header)}


def load_shard(path: str) -> Dict[str, Any]:
    """Load one shard file: a Chrome trace-event JSON document (the
    ``--trace`` exports) or a sandbox sidecar JSONL."""
    parsed = sidecar.read(path)
    if parsed is not None:
        return _norm_sidecar(parsed[0], parsed[1], path)
    try:
        with open(path) as f:
            doc = json.load(f)
    except (OSError, json.JSONDecodeError) as e:
        raise ShardError(f"{path}: unreadable ({e})")
    if not isinstance(doc, dict):
        raise ShardError(f"{path}: not a trace document")
    return _norm_chrome(doc, path)


def _annotate_joins(shards: List[Dict[str, Any]]) -> int:
    """Cross-shard client/server span join: `client.request` spans
    (args.ctx) matched to `serve.handle` spans (args.parent) gain
    server_ms + wire_ms.  Works within one shard too (an in-process
    client).  Returns the number of joins made."""
    handlers: Dict[str, Dict[str, Any]] = {}
    for sh in shards:
        for e in sh["events"]:
            if e["name"] == "serve.handle" and e["dur"] is not None:
                parent = (e.get("attrs") or {}).get("parent")
                if parent:
                    handlers[str(parent)] = e
    joins = 0
    for sh in shards:
        for e in sh["events"]:
            if e["name"] != "client.request" or e["dur"] is None:
                continue
            ctx = (e.get("attrs") or {}).get("ctx")
            h = handlers.get(str(ctx)) if ctx else None
            if h is None:
                continue
            server_ms = h["dur"] * 1e3
            attrs = dict(e.get("attrs") or {})
            attrs["server_ms"] = round(server_ms, 3)
            attrs["wire_ms"] = round(
                max(0.0, e["dur"] * 1e3 - server_ms), 3)
            e["attrs"] = attrs
            joins += 1
    return joins


def merge_shards(shards: List[Dict[str, Any]]) -> Dict[str, Any]:
    """Normalized shards -> one Chrome document: pid per shard,
    process/thread metadata, clock-offset-aligned timestamps."""
    if not shards:
        raise ShardError("nothing to merge")
    joins = _annotate_joins(shards)
    origins = [s["origin_unix"] for s in shards if s["origin_unix"] > 0]
    base = min(origins) if origins else 0.0
    events: List[Dict[str, Any]] = []
    manifest = []
    for pid0, sh in enumerate(shards):
        pid = pid0 + 1
        offset = (sh["origin_unix"] - base
                  if sh["origin_unix"] > 0 else 0.0)
        events.append({"ph": "M", "pid": pid, "tid": 0,
                       "name": "process_name",
                       "args": {"name": sh["process"]}})
        events.append({"ph": "M", "pid": pid, "tid": 0,
                       "name": "process_sort_index",
                       "args": {"sort_index": pid}})
        tracks: List[str] = []
        for e in sh["events"]:
            if e["track"] not in tracks:
                tracks.append(e["track"])
        tid_of = {t: i + 1 for i, t in enumerate(tracks)}
        for t, tid in tid_of.items():
            events.append({"ph": "M", "pid": pid, "tid": tid,
                           "name": "thread_name", "args": {"name": t}})
        for e in sh["events"]:
            rec: Dict[str, Any] = {
                "name": e["name"],
                "cat": e["name"].split(".", 1)[0],
                "pid": pid,
                "tid": tid_of[e["track"]],
                "ts": round((e["ts"] + offset) * 1e6, 3),
            }
            if e["dur"] is None:
                rec["ph"] = "i"
                rec["s"] = "t"
            else:
                rec["ph"] = "X"
                rec["dur"] = round(max(0.0, e["dur"]) * 1e6, 3)
            if e["attrs"]:
                rec["args"] = e["attrs"]
            events.append(rec)
        manifest.append({"path": sh["path"], "pid": pid,
                         "process": sh["process"],
                         "origin_unix": sh["origin_unix"],
                         "offset_s": round(offset, 6),
                         "events": len(sh["events"])})
    return {"traceEvents": events, "displayTimeUnit": "ms",
            "otherData": {"origin_unix": base, "merged": manifest,
                          "joins": joins,
                          "merged_by": "ut-trace merge"}}


def merge_files(paths: List[str],
                out: Optional[str] = None) -> Dict[str, Any]:
    """Load + merge + (optionally) write; always validates."""
    doc = merge_shards([load_shard(p) for p in paths])
    validate_trace(doc)
    if out:
        with open(out, "w") as f:
            json.dump(doc, f)
    return doc


# ------------------------------------------------------------------ CLI
def main(argv: Optional[List[str]] = None) -> int:
    p = argparse.ArgumentParser(
        prog="ut-trace",
        description="merge / validate uptune-tpu observability traces "
                    "(docs/OBSERVABILITY.md)")
    sub = p.add_subparsers(dest="cmd", required=True)
    pm = sub.add_parser(
        "merge", help="join trace shards (Chrome-trace JSON exports "
                      "and/or sandbox sidecar JSONL) into one "
                      "Perfetto-viewable document")
    pm.add_argument("shards", nargs="+", metavar="SHARD")
    pm.add_argument("-o", "--out", required=True, metavar="OUT.json")
    pv = sub.add_parser("validate",
                        help="check a trace document against the "
                             "schema contract")
    pv.add_argument("doc", metavar="TRACE.json")
    args = p.parse_args(argv)

    if args.cmd == "merge":
        try:
            doc = merge_files(args.shards, out=args.out)
        except (ShardError, ValueError, OSError) as e:
            print(f"ut-trace: {e}", file=sys.stderr)
            return 1
        m = doc["otherData"]["merged"]
        print(f"ut-trace: merged {len(m)} shard(s), "
              f"{sum(s['events'] for s in m)} event(s), "
              f"{doc['otherData']['joins']} client/server join(s) "
              f"-> {args.out}")
        return 0
    try:
        with open(args.doc) as f:
            validate_trace(json.load(f))
    except (OSError, ValueError) as e:
        print(f"ut-trace: INVALID: {e}", file=sys.stderr)
        return 1
    print(f"ut-trace: {args.doc} is schema-clean")
    return 0


if __name__ == "__main__":
    sys.exit(main())
