"""`ut-torch serve` — run the session server from the command line.

    ut-torch serve                          # serve-host:serve-port defaults
    ut-torch serve --port 0                 # ephemeral port (printed)
    ut-torch serve --slots 256 --store-dir /shared/ut-store
    ut-torch serve --trace serve_trace.json # obs plane export on shutdown
    ut-torch serve --device cpu             # groups on the CPU

(`python -m uptune_tpu_torch.cli serve ...`.)  Counterpart of
`uptune_tpu/serve/cli.py`, with its flags.  Flag precedence is the
repo-wide contract: CLI flags > ut.config (`serve-*` keys) > DEFAULTS
(api/session.py).  The JAX package serves on the host CPU; the port
serves on the card and takes ``--device cpu`` as the tuning CLI does:
without a card and without it, the command exits 1 before it binds a
socket.  SIGTERM shuts the server down as SIGINT does, with exit code 0.
"""
from __future__ import annotations

import argparse
import json
import logging
import os
import signal
from typing import List, Optional

log = logging.getLogger("uptune_tpu_torch")


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="ut-torch serve",
        description="uptune-tpu (PyTorch port) multi-tenant tuning session "
                    "server "
                    "(docs/SERVING.md)")
    p.add_argument("--host", default=None,
                   help="bind address (default: ut.config serve-host)")
    p.add_argument("--port", type=int, default=None,
                   help="TCP port; 0 picks an ephemeral port "
                        "(default: ut.config serve-port)")
    p.add_argument("--slots", type=int, default=None,
                   help="instance-slot capacity per engine group: "
                        "sessions sharing a space signature batch "
                        "their proposal generation across one "
                        "BatchedEngine instance axis of this width "
                        "(default: ut.config serve-slots)")
    p.add_argument("--max-sessions", type=int, default=None,
                   help="admission limit across all groups "
                        "(default: ut.config serve-max-sessions)")
    p.add_argument("--store-dir", default=None, metavar="DIR",
                   help="shared cross-tenant result memo directory; "
                        "'off' disables (default: ut.config "
                        "serve-store-dir, else ut.serve/store under "
                        "the cwd)")
    p.add_argument("--work-dir", default=None,
                   help="base dir for the default store location")
    p.add_argument("--durable", nargs="?", const="on", default=None,
                   metavar="DIR",
                   help="crash-safe serving (docs/SERVING.md "
                        "'Durability & failover'): journal every "
                        "committed session transition to per-session "
                        "checkpoint segments (DIR, or "
                        "<store-dir>/checkpoints when omitted) and "
                        "recover all live sessions on startup — "
                        "SIGKILL loses zero committed tells.  'off' "
                        "disables (default: ut.config serve-durable)")
    p.add_argument("--durable-fsync", action="store_true",
                   default=None,
                   help="fsync each checkpoint append: committed "
                        "tells additionally survive power loss "
                        "(SIGKILL durability needs no fsync; default: "
                        "ut.config serve-durable-fsync)")
    p.add_argument("--workers", type=int, default=None, metavar="N",
                   help="wire-kernel worker-pool width: how many "
                        "requests may execute concurrently across "
                        "ALL connections (default 8).  The asyncio "
                        "connection loop itself is single-threaded; "
                        "workers are where commits and checkpoint "
                        "appends run")
    p.add_argument("--orphan-ttl", type=float, default=None,
                   metavar="SECONDS",
                   help="grace a disconnected durable tenant gets "
                        "before its slot is swept (default 900); "
                        "resuming clients re-attach inside it")
    p.add_argument("--trace", default=None, metavar="OUT.json",
                   help="observability export written at shutdown "
                        "(docs/OBSERVABILITY.md); 'off' disables. "
                        "Flushed on SIGINT/SIGTERM too, and the "
                        "metrics sidecar is a flight-recorder "
                        "timeline while the server runs")
    p.add_argument("--metrics-interval", type=float, default=None,
                   metavar="SECONDS",
                   help="flight-recorder cadence for the traced "
                        "server's metrics timeline (default 1.0; 0 "
                        "disables).  `ut top --metrics "
                        "OUT.json.metrics.jsonl` tails it live")
    p.add_argument("--metrics-rotate", type=int, default=None,
                   metavar="N",
                   help="flight-recorder rotation depth: generations "
                        "kept past the row cap (default 1)")
    p.add_argument("--telemetry", default=None, metavar="HOST:PORT",
                   help="ship this server's metrics windows, journal "
                        "rows, alerts AND its `{\"op\": \"health\"}` "
                        "session rollup to a running `ut hub` "
                        "collector (docs/OBSERVABILITY.md 'Fleet "
                        "telemetry').  Also reachable via "
                        "UT_TELEMETRY or ut.config({'telemetry': "
                        "...}); 'off' disables")
    p.add_argument("--journal", default=None, metavar="OUT.jsonl",
                   help="tuning journal (docs/OBSERVABILITY.md "
                        "'Search-quality telemetry'): one JSONL row "
                        "per session tell, plus the live "
                        "convergence/calibration gauges derived from "
                        "them; render post-hoc with `ut-torch report`.  "
                        "Also reachable via UT_JOURNAL; 'off' "
                        "disables")
    p.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                   help="where the groups' stacked engine states live "
                        "(default: the card; on a host without one, "
                        "pass cpu)")
    p.add_argument("-v", "--verbose", action="store_true")
    return p


def resolve_config(args: argparse.Namespace) -> dict:
    """Flags > ut.config serve-* keys > DEFAULTS, resolved into the
    SessionServer constructor kwargs (None = let the constructor read
    the settings layer; the indirection exists so the precedence is
    testable without binding a socket)."""
    from ..api.session import settings
    out = {}
    for flag, key in (("host", "serve-host"), ("port", "serve-port"),
                      ("slots", "serve-slots"),
                      ("max_sessions", "serve-max-sessions"),
                      ("store_dir", "serve-store-dir"),
                      ("durable", "serve-durable"),
                      ("durable_fsync", "serve-durable-fsync")):
        v = getattr(args, flag)
        out[flag] = settings[key] if v is None else v
    out["work_dir"] = args.work_dir
    out["orphan_ttl"] = args.orphan_ttl
    out["device"] = args.device
    return out


def main(argv: Optional[List[str]] = None) -> int:
    args = build_parser().parse_args(argv)
    logging.basicConfig(
        level=logging.DEBUG if args.verbose else logging.INFO,
        format="[%(relativeCreated)7.0fms] %(levelname)s %(message)s")

    # the groups live on the card unless --device cpu: fail before
    # anything binds a socket, as the tuning CLI fails before its run
    from ..device import resolve_device
    try:
        resolve_device(args.device)
    except RuntimeError as e:
        log.error("[ut-serve] %s (pass --device cpu)", e)
        return 1

    # SIGTERM stops the server as ^C does: serve_forever unwinds
    # through its finally (telemetry settled below) and the command
    # exits 0; obs.install_exit_flush chains to this handler
    def _terminate(signum, frame):
        raise KeyboardInterrupt
    signal.signal(signal.SIGTERM, _terminate)

    from .. import obs
    trace_path = args.trace
    if trace_path is None:
        trace_path = obs.maybe_enable_from_env()
        if trace_path is None and not obs.enabled():
            from ..api.session import settings
            cfg_trace = settings["trace"]
            if cfg_trace and str(cfg_trace).lower() not in ("off",
                                                            "none"):
                trace_path = str(cfg_trace)
    elif trace_path.lower() in ("off", "none"):
        trace_path = None
    if trace_path and not obs.enabled():
        obs.enable()
    # UT_DEVICE_TRACE=<dir>: a torch.profiler capture of the serving
    # process — stopped in the shutdown finally so a SIGINT'd server
    # still writes its device trace
    dtrace = obs.device.maybe_trace_from_env()
    if trace_path:
        # a serving process is exactly the shape the flight recorder
        # exists for: long-lived, scraped rarely, killed by signal —
        # without the timeline + exit flush it leaves no telemetry
        obs.install_exit_flush(trace_path,
                               extra={"process": "ut-serve"})
        mi = (args.metrics_interval if args.metrics_interval is not None
              else 1.0)
        if mi > 0:
            obs.start_flight_recorder(
                trace_path, interval=mi,
                rotate=(args.metrics_rotate
                        if args.metrics_rotate is not None
                        else obs.flight.DEFAULT_ROTATE))

    # tuning journal: per-tenant serve_tell rows + the
    # derived search-quality gauges (which the metrics op and `ut top`
    # then expose).  Flag > UT_JOURNAL env; 'off' disables
    journal_path = args.journal
    if journal_path is None:
        mon = obs.maybe_journal_from_env()
        journal_path = obs.journal.path() if mon is not None else None
    elif obs.journal.disabled_token(journal_path):
        # same disable vocabulary as the tuning CLI / UT_JOURNAL
        journal_path = None
        mon = None
    else:
        mon = obs.start_journal(journal_path,
                                meta={"process": "ut-serve"})
    if journal_path and not trace_path:
        # journal without trace: SIGINT/SIGTERM must still flush the
        # buffered journal tail (and unwind into the finally below)
        obs.install_exit_flush(None)

    # UT_FAULTS (obs/faults.py): deterministic crash/delay/error
    # schedules for failover tests — a
    # production server never sets this; log loudly when armed
    n_faults = obs.faults.maybe_arm_from_env()
    if n_faults:
        log.warning("[ut-serve] %d fault-injection rule(s) ARMED via "
                    "UT_FAULTS: %s", n_faults, obs.faults.schedules())

    from .server import SessionServer
    srv = SessionServer(**resolve_config(args))
    if args.workers is not None and args.workers > 0:
        srv.max_workers = int(args.workers)

    # fleet telemetry (docs/OBSERVABILITY.md "Fleet telemetry"): flag
    # > UT_TELEMETRY env > ut.config('telemetry').  The serving
    # process additionally ships its session-health rollup, so the
    # hub's `health` op sees per-tenant verdicts fleet-wide
    shipper = None
    telemetry = args.telemetry
    if telemetry is None:
        telemetry = os.environ.get("UT_TELEMETRY", "").strip() or None
        if telemetry is None:
            from ..api.session import settings
            cfg_t = settings["telemetry"]
            if not obs.ship.disabled_token(cfg_t):
                telemetry = str(cfg_t)
    if obs.ship.disabled_token(telemetry):
        telemetry = None
    if telemetry:
        shipper = obs.ship.start(
            telemetry, role="ut-serve",
            health_provider=lambda: srv._op_health({}))
        # telemetry-only servers (no --trace/--journal) still need
        # the SIGINT/SIGTERM hooks: the exit flush's ship.stop()
        # ships the final window, and the chained handler unwinds
        # serve_forever into the finally below (idempotent)
        obs.install_exit_flush(None)

    try:
        srv.serve_forever()
    finally:
        if shipper is not None:
            shipper.stop()
            st = shipper.stats()
            log.info("[ut-serve] telemetry shipped to %s:%s (%d rows "
                     "acked, %d dropped)", shipper.addr[0],
                     shipper.addr[1], st["acked"], st["dropped"])
        if dtrace:
            obs.device.stop_trace()
            log.info("[ut-serve] device profile captured under %s",
                     dtrace)
        if journal_path:
            obs.stop_journal(mon)
            log.info("[ut-serve] journal written to %s (render with "
                     "`ut-torch report %s`)", journal_path, journal_path)
        if trace_path:
            obs.finish(trace_path, extra={"process": "ut-serve"})
            log.info("[ut-serve] trace written to %s", trace_path)
        elif obs.enabled():
            snap = obs.metrics_snapshot()
            log.info("[ut-serve] final metrics: %s",
                     json.dumps(snap.get("counters", {})))
    return 0


if __name__ == "__main__":
    import sys
    sys.exit(main())
