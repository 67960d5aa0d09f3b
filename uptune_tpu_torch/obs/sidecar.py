"""Subprocess trace sidecars: child-side span recording for WorkerPool
evaluations, merged into the driver's timeline at reap.

A sandboxed trial subprocess cannot write into the driver's rings, so
each build would render as ONE opaque ``pool.build`` span.  This
module decomposes it: when the driver traces, ``WorkerPool.submit``
exports ``UT_TRACE_SIDECAR=<sandbox>/ut.trace.jsonl`` into the trial's
environment; the child (the user program importing ``uptune_tpu_torch``
or ``uptune_tpu``: the sidecar format is the same)
sees the variable during protocol-state init, turns its own obs plane
on, and at interpreter exit dumps everything it recorded to the
sidecar file — one JSON header line (clock origin, pid, gid) plus one
line per event.  At reap the driver reads the file back, aligns the
child's clock against its own trace origin (both sides record their
``time.time()`` origin; on one machine that is one clock, across hosts
it is NTP-accurate — docs/OBSERVABILITY.md caveats), and re-emits the
events under the slot's ``worker-N`` lane, where they nest inside the
``pool.build`` window.

The same file format doubles as a merge shard: ``ut-trace merge``
accepts sidecar JSONL next to full Chrome-trace documents, giving a
still-running (or crashed) child's partial telemetry a seat in the
merged document even when no reap ever collected it.
"""
from __future__ import annotations

import atexit
import json
import os
from typing import Any, Dict, List, Optional, Tuple

from . import core

__all__ = ["SIDECAR_ENV", "SIDECAR_FILE", "maybe_init_child", "dump",
           "read", "merge_into"]

SIDECAR_ENV = "UT_TRACE_SIDECAR"
SIDECAR_FILE = "ut.trace.jsonl"

# the path this process registered an atexit dump for (guards against
# double registration when protocol state is re-initialized in-process)
_REGISTERED: Optional[str] = None


def maybe_init_child(env: Optional[dict] = None) -> Optional[str]:
    """Child-side hook: when ``UT_TRACE_SIDECAR`` names a path, enable
    recording in THIS process and register an atexit dump to it.
    Returns the path when armed, None otherwise.  Idempotent — the
    protocol state may be re-initialized without stacking dumps."""
    global _REGISTERED
    path = (os.environ if env is None else env).get(SIDECAR_ENV,
                                                    "").strip()
    if not path or path.lower() in ("0", "off", "false", "none"):
        return None
    if _REGISTERED == path:
        return path
    if not core.enabled():
        core.enable()
    if _REGISTERED is None:
        atexit.register(_dump_registered)
    _REGISTERED = path
    return path


def _dump_registered() -> None:
    if _REGISTERED is not None:
        try:
            dump(_REGISTERED)
        except OSError:
            pass    # sandbox deleted under us (timeout kill): nothing
            # to report to — the driver already reaped the slot


def dump(path: str, process: str = "worker-child") -> None:
    """Write everything recorded so far to the sidecar file (atomic
    tmp+rename: the driver may poll mid-write).  Also stamps a
    ``child.run`` span covering the whole recorded window, so the
    worker lane shows the subprocess's full extent even when the user
    program recorded nothing else."""
    core.emit_at("child.run", 0.0, core.now(),
                 attrs={"pid": os.getpid()})
    snap = core.snapshot()
    header = {
        "sidecar": 1,
        "origin_unix": snap.get("origin_unix", 0.0),
        "pid": os.getpid(),
        "process": process,
        "gid": os.environ.get("UT_GLOBAL_ID"),
        "slot": os.environ.get("UT_CURR_INDEX"),
        "stage": os.environ.get("UT_CURR_STAGE"),
    }
    tmp = f"{path}.tmp{os.getpid()}"
    with open(tmp, "w") as f:
        f.write(json.dumps(header) + "\n")
        for e in snap["events"]:
            f.write(json.dumps({"name": e["name"], "ts": e["ts"],
                                "dur": e["dur"], "track": e["track"],
                                "attrs": e["attrs"]}) + "\n")
    os.replace(tmp, path)


def read(path: str) -> Optional[Tuple[Dict[str, Any],
                                      List[Dict[str, Any]]]]:
    """Parse a sidecar file -> (header, events), or None when the file
    is missing, empty, or not a sidecar (torn tails are tolerated the
    same way the store tolerates them: complete leading lines win)."""
    try:
        with open(path) as f:
            lines = f.read().splitlines()
    except OSError:
        return None
    if not lines:
        return None
    try:
        header = json.loads(lines[0])
    except json.JSONDecodeError:
        return None
    if not isinstance(header, dict) or "sidecar" not in header:
        return None
    events = []
    for line in lines[1:]:
        try:
            e = json.loads(line)
        except json.JSONDecodeError:
            break           # torn tail: keep what is complete
        if isinstance(e, dict) and "name" in e and "ts" in e:
            events.append(e)
    return header, events


def merge_into(path: str, track: str) -> int:
    """Driver-side reap hook: align a child sidecar's clock against
    this process's trace origin and re-emit its events onto `track`
    (the slot's worker lane).  Returns the number of events merged;
    0 when tracing is off or the sidecar is absent/unreadable.  The
    consumed file is removed so a slot reused without a fresh sidecar
    can never replay a previous trial's events."""
    if not core.enabled():
        return 0
    parsed = read(path)
    if parsed is None:
        return 0
    header, events = parsed
    offset = (float(header.get("origin_unix", 0.0) or 0.0)
              - core.trace_origin_unix())
    gid = header.get("gid")
    try:
        gid = int(gid)      # env-protocol strings -> the driver's ints
    except (TypeError, ValueError):
        pass
    n = 0
    for e in events:
        attrs = dict(e.get("attrs") or {})
        attrs.setdefault("child_pid", header.get("pid"))
        if gid is not None:
            attrs.setdefault("gid", gid)
        core.emit_at(e["name"], float(e["ts"]) + offset, e.get("dur"),
                     track, attrs)
        n += 1
    try:
        os.unlink(path)
    except OSError:
        pass
    return n
