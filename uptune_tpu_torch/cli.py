"""`ut-torch` — the port's command-line entry point.

    python -m uptune_tpu_torch.cli prog.py -pf 4 --test-limit 200
    ut-torch prog.py --technique de --technique pso
    ut-torch --list-techniques
    ut-torch prog.py --apply-best          # re-run with the best config

The JAX package's `ut` (`uptune_tpu/cli.py`), with the same parser and
the same flag precedence (flags > ut.config(...) > defaults), apart
from these:

* ``--device`` takes ``cuda`` (the default) or ``cpu``: the Tuner's
  proposal side runs on the card, and a host without one must ask for
  the CPU (the JAX package defaults to its CPU platform instead); there
  is no fallback;
* the observability flags (--trace, --journal, --metrics-interval,
  --metrics-rotate, --telemetry, --device-trace) and their UT_TRACE /
  UT_JOURNAL / UT_TELEMETRY / UT_DEVICE_TRACE variables drive the port's
  `obs` plane as the JAX package's drive its own; ``--device-trace`` /
  UT_DEVICE_TRACE capture a torch.profiler Chrome trace
  (DIR/device_trace.json) instead of an XPlane dump; ``ut-torch report``
  renders a journal (`obs/report.py`);
* the subcommands ``serve``, ``route``, ``top``, ``hub``, ``report``
  and ``store`` are the port's (``serve`` and ``route`` take
  ``--device`` too; ``store`` is host Python and needs no card);
  ``--store tcp://HOST:PORT`` joins a ``ut-torch store`` (or a JAX
  package ``ut store``) server;
* UT_TRACE_GUARD set to anything but off exits with code 2, naming the
  reason;
* ``--compile-cache-dir`` is accepted and has no effect.

Mode selection is automatic (async_task_scheduler.py:465-474): template
annotations in the script select template mode; >1 stage in
ut.params.json selects multi-stage.
"""
from __future__ import annotations

import argparse
import json
import logging
import os
import sys
from typing import Dict, List, Optional

def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="ut-torch",
        description="uptune-tpu's PyTorch/CUDA port: program autotuner")
    p.add_argument("script", nargs="?", help="program to tune")
    p.add_argument("script_args", nargs="*",
                   help="arguments passed through to the program")
    p.add_argument("-pf", "--parallel-factor", type=int, default=None,
                   help="parallel evaluation width")
    p.add_argument("--test-limit", type=int, default=None,
                   help="number of trials")
    p.add_argument("--timeout", type=float, default=None,
                   help="total tuning wall-clock limit (s)")
    p.add_argument("--runtime-limit", type=float, default=None,
                   help="per-trial wall-clock limit (s)")
    p.add_argument("-t", "--technique", action="append", default=None,
                   help="search technique (repeatable); default: AUC "
                        "bandit portfolio")
    p.add_argument("--generate-bandit-technique", type=int, default=None,
                   metavar="SEED",
                   help="use a seeded random AUC-bandit portfolio "
                        "instead of --technique")
    p.add_argument("--learning-models", action="append", default=None,
                   choices=("gp", "mlp"),
                   help="enable the surrogate plane (EI top-k pruning "
                        "+ pool proposals, calibrated defaults); the "
                        "reference's --learning-models flag")
    p.add_argument("--surrogate-arbitration", default=None,
                   choices=("schedule", "bandit", "bandit-small-budget"),
                   help="how the surrogate proposal plane gets "
                        "acquisitions: 'schedule' fires every Nth "
                        "acquisition (with the run-budget passivation "
                        "rule); 'bandit' registers it as a "
                        "credit-earning arm of the AUC bandit, which "
                        "starves it per-run when its pulls stop "
                        "producing new bests; 'bandit-small-budget' is "
                        "the measured recipe for eval budgets at or "
                        "below the parameter count (bandit arbitration "
                        "+ affordable 8-eval pulls, no passivation — "
                        "0.88x baseline on gcc-real at 30 seeds, "
                        "BENCHREPORT.md)")
    p.add_argument("--surrogate-async", choices=("on", "off"),
                   default=None,
                   help="async surrogate plane (default on): 'on' runs "
                        "the O(N^3) GP refit + hyperparameter sweep on "
                        "a background worker publishing versioned "
                        "snapshots — ask/tell never blocks on learning "
                        "and new observations fold into the model via "
                        "O(N^2) incremental Cholesky updates; 'off' "
                        "restores the synchronous inline refit")
    p.add_argument("--surrogate-screen", action="append", default=None,
                   metavar="ARCHIVE",
                   help="cross-payload transfer: driver jsonl trial "
                        "archive(s) from OTHER workloads over the SAME "
                        "space (repeatable).  The surrogate restricts "
                        "its model to the feature lanes that measurably "
                        "moved QoR there and biases its pool mutations "
                        "toward them (surrogate/screen.py) — the "
                        "measured fix for budget<params runs where an "
                        "unscreened GP stays prior-dominated")
    p.add_argument("--surrogate-screen-top", default="16,24",
                   metavar="CONT,CAT",
                   help="screen sizes: continuous lanes, categorical "
                        "groups kept (default 16,24; hard mode only)")
    p.add_argument("--surrogate-screen-mode", default="hard",
                   choices=("hard", "soft"),
                   help="'hard' restricts the model to the top-k lanes; "
                        "'soft' keeps full width and scales each lane "
                        "by its transferred sensitivity (per-lane ARD)")
    p.add_argument("--surrogate-flip-bias", default=None,
                   choices=("none", "online"),
                   help="'online' re-ranks categorical params by "
                        "|corr| with QoR over THIS run's observations "
                        "at each refit and biases the proposal plane's "
                        "flip moves toward them (75%% sensitivity / "
                        "25%% uniform) — guides the bold moves without "
                        "narrowing the model")
    p.add_argument("--seed-configuration", action="append", default=None,
                   metavar="JSON",
                   help="JSON file with a known-good configuration (or "
                        "a list of them) injected as 'seed' trials at "
                        "startup, evaluated before any technique batch "
                        "— warm-starts expensive runs from prior bests "
                        "(repeatable; partial configs are merged over "
                        "the declared defaults).  The reference's "
                        "--seed-configuration flag")
    p.add_argument("--seed", type=int, default=None, help="RNG seed")
    p.add_argument("--prefetch", type=int, default=None, metavar="N",
                   help="async ticket prefetch depth: keep N trials "
                        "proposed ahead of free worker slots so device "
                        "propose+dedup hides behind build wall-clock "
                        "(default: the parallel factor; 0 = lockstep "
                        "propose-only-when-a-slot-is-free)")
    p.add_argument("--compile-cache-dir", default=None, metavar="DIR",
                   help="accepted for the JAX package's command lines "
                        "and has no effect: the port compiles nothing "
                        "at tune time")
    p.add_argument("--store-dir", default=None, metavar="DIR",
                   help="content-addressed trial results store "
                        "(docs/STORE.md): consulted before every build "
                        "— a previously measured config is served its "
                        "recorded QoR without launching the program, "
                        "and N concurrent ut processes sharing one "
                        "store directory exchange results and "
                        "new-bests (default: ut.temp/store under the "
                        "work dir; pass 'off' to disable)")
    p.add_argument("--store", default=None, metavar="MODE|ADDR",
                   help="'on'/'off' forces the results store regardless "
                        "of --store-dir ('off' wins over any "
                        "directory); tcp://HOST:PORT joins a `ut-torch "
                        "store` cooperative store server instead of a "
                        "directory (shared results table, new-best "
                        "exchange and federated surrogate rows across "
                        "processes)")
    p.add_argument("--federate", choices=("on", "off"), default=None,
                   help="feed sibling instances' (config, qor) rows "
                        "into the local surrogate at exchange time "
                        "(default on; elite migration runs either way)")
    p.add_argument("--exchange-interval", type=float, default=None,
                   metavar="SECONDS",
                   help="migration cadence: minimum seconds between "
                        "store refreshes gating elite migration and "
                        "the federated surrogate feed (default 2)")
    p.add_argument("--warm-start", action="store_true", default=None,
                   help="preload this (space, program)'s stored trials "
                        "before the first acquisition: best-so-far, "
                        "dedup history (recorded configs are never "
                        "re-proposed) and the surrogate training set "
                        "all start warm — spend the whole budget on "
                        "NEW configs instead of replaying a cached "
                        "stream")
    p.add_argument("--params", default=None,
                   help="reuse an existing ut.params.json")
    p.add_argument("--resume", action="store_true",
                   help="resume from the trial archive")
    p.add_argument("--work-dir", default=None,
                   help="work directory (default: cwd)")
    p.add_argument("--no-sandbox", action="store_true",
                   help="run trials directly in the work dir")
    p.add_argument("--apply-best", action="store_true",
                   help="run the program once with the best config")
    p.add_argument("--list-techniques", action="store_true",
                   help="list registered search techniques and exit")
    p.add_argument("--print-search-space-size", action="store_true",
                   help="analyze, print log10(space size) and exit")
    p.add_argument("--print-params", action="store_true",
                   help="analyze, print the param records and exit")
    p.add_argument("--cfg", action="store_true",
                   help="print the resolved configuration")
    p.add_argument("--num-hosts", type=int, default=None,
                   help="run the same command in N local processes (the "
                        "analogue of the reference's Ray cluster "
                        "provisioning, cluster/config.yaml). In program "
                        "mode each process is an INDEPENDENT search "
                        "replica (multi-start: seeds diverge, replica "
                        "i>0 writes ut.archive.hi.jsonl / best.hi.json; "
                        "the launcher promotes the best replica to "
                        "best.json at the end). The UT_COORDINATOR / "
                        "UT_NUM_PROCESSES / UT_PROCESS_ID env is also "
                        "wired, so library-mode programs can call "
                        "uptune_tpu_torch.parallel.initialize() for the "
                        "torch.distributed sharded-engine plane")
    p.add_argument("--trace", default=None, metavar="OUT.json",
                   help="observability plane (docs/OBSERVABILITY.md): "
                        "record cross-plane spans (ticket lifecycle, "
                        "worker-slot build lanes and their subprocess "
                        "sidecar spans, background refit, store hits) "
                        "and write a Perfetto-viewable Chrome trace "
                        "JSON here, plus OUT.json.metrics.jsonl with "
                        "the flight recorder's periodic metrics "
                        "timeline; also flushed on SIGINT/SIGTERM.  "
                        "Also reachable via UT_TRACE=<path> or "
                        "ut.config({'trace': ...}); 'off' disables")
    p.add_argument("--journal", default=None, metavar="OUT.jsonl",
                   help="tuning journal: an append-only JSONL stream of "
                        "search decisions (arm pulls with dedup/prune "
                        "verdicts, every tell joined with the "
                        "surrogate's mu/sigma, store hits, snapshot "
                        "publishes) plus live convergence/calibration "
                        "gauges and alerts.  Render with `ut-torch "
                        "report OUT.jsonl`.  Also reachable via "
                        "UT_JOURNAL or ut.config({'journal': ...}); "
                        "'off' disables")
    p.add_argument("--metrics-interval", type=float, default=None,
                   metavar="SECONDS",
                   help="flight-recorder cadence for the traced run's "
                        "metrics timeline (default 1.0; 0 disables the "
                        "background thread and restores the single "
                        "end-of-run metrics snapshot).  Only "
                        "meaningful with --trace/UT_TRACE")
    p.add_argument("--metrics-rotate", type=int, default=None,
                   metavar="N",
                   help="flight-recorder rotation depth: generations "
                        "kept past the row cap (<file>.1 ... <file>.N; "
                        "default 1)")
    p.add_argument("--telemetry", default=None, metavar="HOST:PORT",
                   help="fleet telemetry: ship this process's metrics "
                        "window snapshots, journal rows and alerts to a "
                        "running telemetry hub (the JAX package's `ut "
                        "hub`: the wire is the same) over a bounded "
                        "never-blocking queue.  Also reachable via "
                        "UT_TELEMETRY or ut.config({'telemetry': "
                        "...}); 'off' disables")
    p.add_argument("--device-trace", default=None, metavar="DIR",
                   help="torch.profiler capture of the whole run: "
                        "DIR/device_trace.json (CUDA kernels and the "
                        "host's record_function ranges, named as the "
                        "--trace spans), referenced from the --trace "
                        "export (otherData.device_trace).  Also "
                        "reachable via UT_DEVICE_TRACE=<dir>; 'off' "
                        "disables")
    p.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                   help="where the Tuner's proposal side runs (default "
                        "cuda: the card, and a host without one exits "
                        "non-zero unless given 'cpu'; no fallback)")
    p.add_argument("-v", "--verbose", action="store_true")
    return p


# The JAX package's `ut <name>` subcommands: the port's (module, entry)
# for each, at the same relative module path.  REFUSED_SUBCOMMANDS names
# any not ported yet with the ROADMAP item (Queue 1) that brings it:
# none is left.
SUBCOMMANDS = {
    "serve": ("uptune_tpu_torch.serve.cli", "main"),
    "route": ("uptune_tpu_torch.serve.router", "main"),
    "top": ("uptune_tpu_torch.obs.top", "main"),
    "report": ("uptune_tpu_torch.obs.report", "main"),
    "hub": ("uptune_tpu_torch.obs.hub", "main"),
    "store": ("uptune_tpu_torch.store.server", "main"),
}
REFUSED_SUBCOMMANDS: Dict[str, str] = {}
# observability variables the port refuses when set to anything but off,
# with the reason
OBS_ENV = ("UT_TRACE_GUARD",)
OBS_REFUSED = {
    "UT_TRACE_GUARD": "the trace guard counts jit retraces, and the port "
                      "traces nothing (it runs eagerly)",
}
_OFF = ("", "off", "none", "0", "false")


def refused(args: argparse.Namespace) -> Optional[str]:
    """The observability variable this run sets and the port refuses
    (`OBS_ENV`, set to anything but off), or None."""
    for var in OBS_ENV:
        if os.environ.get(var, "").strip().lower() not in _OFF:
            return var
    return None


def _configure_logging(verbose: bool) -> None:
    logging.basicConfig(
        level=logging.DEBUG if verbose else logging.INFO,
        format="[%(relativeCreated)7.0fms] %(levelname)s %(message)s")


def _launch_hosts(n: int, argv: Optional[List[str]],
                  work_dir: Optional[str] = None) -> int:
    """`ut-torch --num-hosts N ...`: run the SAME command in N local
    processes.  Program mode is multi-start: each replica tunes
    independently with a diverged seed and its own archive/best files
    (ProgramTuner.host_tag), and the launcher promotes the best replica's
    result to best.json afterwards.  Children inherit everything else
    from the parent command line; their output is line-prefixed with
    [hN].  Exit code is the first nonzero child code."""
    import socket
    import subprocess
    import threading

    s = socket.socket()
    s.bind(("localhost", 0))
    port = s.getsockname()[1]
    s.close()

    base = [a for a in (argv if argv is not None else sys.argv[1:])]
    # strip the flag (both --num-hosts N and --num-hosts=N spellings)
    cleaned, skip = [], False
    for a in base:
        if skip:
            skip = False
            continue
        if a == "--num-hosts":
            skip = True
            continue
        if a.startswith("--num-hosts="):
            continue
        cleaned.append(a)

    # children must import the package regardless of their cwd (checkout
    # use without pip install -e — same seam as ProgramTuner.env_extra)
    from .utils.pypath import child_pythonpath
    pp = child_pythonpath()
    procs = []
    for pid in range(n):
        env = dict(os.environ,
                   PYTHONPATH=pp,
                   UT_COORDINATOR=f"localhost:{port}",
                   UT_NUM_PROCESSES=str(n),
                   UT_PROCESS_ID=str(pid))
        procs.append(subprocess.Popen(
            [sys.executable, "-m", "uptune_tpu_torch.cli", *cleaned],
            env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True))

    def _pump(i, p):
        for line in p.stdout:
            sys.stdout.write(f"[h{i}] {line}")
            sys.stdout.flush()

    threads = [threading.Thread(target=_pump, args=(i, p), daemon=True)
               for i, p in enumerate(procs)]
    for t in threads:
        t.start()
    rc = 0
    for p in procs:
        code = p.wait()
        rc = rc or code
    for t in threads:
        t.join(timeout=5)
    _merge_replica_bests(cleaned, n, work_dir)
    return rc


def _merge_replica_bests(cleaned: List[str], n: int,
                         work_dir: Optional[str] = None) -> None:
    """Promote the best replica's result to best.json (best-effort: the
    work dir is the launcher's --work-dir when given, else derived from
    the script positional — matching main()'s own resolution; silently
    skipped for non-tuning invocations like --list-techniques)."""
    import json as _json

    script = next((a for a in cleaned
                   if not a.startswith("-") and os.path.isfile(a)
                   and a.endswith((".py", ".tpl"))), None)
    if script is None:
        return
    if work_dir:
        work_dir = os.path.abspath(work_dir)
    else:
        work_dir = os.path.dirname(os.path.abspath(script)) or os.getcwd()
    # orientation comes from the program's declared trend (ut.target)
    sense = "min"
    try:
        with open(os.path.join(work_dir, "ut.default_qor.json")) as f:
            sense = _json.load(f).get("trend", "min")
    except (OSError, ValueError):
        pass
    sign = 1.0 if sense == "min" else -1.0
    cands = []
    for pid in range(n):
        tag = f".h{pid}" if pid else ""
        path = os.path.join(work_dir, f"best{tag}.json")
        if not os.path.isfile(path):
            continue
        try:
            with open(path) as f:
                rec = _json.load(f)
            cands.append((sign * float(rec["qor"]), pid, rec))
        except (ValueError, KeyError, OSError):
            continue
    if not cands:
        return
    skey, pid, rec = min(cands)
    qor = sign * skey
    dst = os.path.join(work_dir, "best.json")
    if pid != 0:
        with open(dst, "w") as f:
            _json.dump(rec, f, indent=1)
    print(f"[ut] best across {len(cands)} replicas: qor={qor:.6g} "
          f"(replica h{pid}) -> {dst}")


class _ObsSession:
    """The observability switches of one tune, resolved as the JAX CLI
    resolves them (flag > UT_* variable > ut.config > default, the .hN
    suffix for --num-hosts replicas), and their end-of-run settling."""

    def __init__(self, log):
        self.log = log
        self.trace_path = None
        self.journal_path = None
        self.jmon = None
        self.dtrace = None
        self.shipper = None

    def stop_device_trace(self) -> None:
        """Settle the profiler capture before the trace export, so the
        referenced device trace is complete (also on a raising run)."""
        from . import obs
        if self.dtrace:
            obs.device.stop_trace()
            self.log.info("[ut] device trace written to %s",
                          os.path.join(self.dtrace,
                                       obs.device.TRACE_FILE))

    def finish(self) -> None:
        """Settle the journal, then the trace (the journal's final
        quality gauges land in the flight recorder's last row), then the
        telemetry shipper's final window."""
        from . import obs
        log = self.log
        if self.journal_path:
            for alert in (self.jmon.alerts if self.jmon is not None
                          else []):
                log.warning("[ut] search alert: %s", json.dumps(alert))
            obs.stop_journal(self.jmon)
            log.info("[ut] journal written to %s (render with `ut-torch "
                     "report %s`)", self.journal_path, self.journal_path)
        if obs.enabled():
            if self.trace_path:
                obs.finish(self.trace_path, extra={"process": "ut-driver"})
                log.info("[ut] trace written to %s (open in "
                         "https://ui.perfetto.dev; metrics in %s)",
                         self.trace_path,
                         self.trace_path + ".metrics.jsonl")
            for line in obs.text_summary().splitlines():
                log.info("[ut] %s", line)
        if self.shipper is not None:
            self.shipper.stop()
            st = self.shipper.stats()
            log.info("[ut] telemetry shipped to %s:%s (%d rows acked, "
                     "%d dropped)", self.shipper.addr[0],
                     self.shipper.addr[1], st["acked"], st["dropped"])


def _start_obs(args, settings, script: str, log) -> _ObsSession:
    """Turn on what the run asks for before the tune: tracing with its
    exit flush and flight recorder, the telemetry shipper, the profiler
    capture, the tuning journal."""
    from . import obs
    ses = _ObsSession(log)
    trace_path = args.trace
    if trace_path is None:
        trace_path = obs.maybe_enable_from_env()
        if trace_path is None and not obs.enabled():
            cfg_trace = settings["trace"]
            if cfg_trace and str(cfg_trace).lower() not in ("off", "none"):
                trace_path = str(cfg_trace)
    elif trace_path.lower() in ("off", "none"):
        trace_path = None
    pid_env = os.environ.get("UT_PROCESS_ID")
    if trace_path and pid_env and pid_env != "0":
        # --num-hosts replicas each trace their own file
        root, ext = os.path.splitext(trace_path)
        trace_path = f"{root}.h{pid_env}{ext}"
    if trace_path and not obs.enabled():
        obs.enable()
    if trace_path:
        # an interrupted run still flushes a valid truncated trace and
        # the metrics timeline's tail
        obs.install_exit_flush(trace_path, extra={"process": "ut-driver"})
        mi = (args.metrics_interval if args.metrics_interval is not None
              else 1.0)
        if mi > 0:
            obs.start_flight_recorder(
                trace_path, interval=mi,
                rotate=(args.metrics_rotate
                        if args.metrics_rotate is not None
                        else obs.flight.DEFAULT_ROTATE))
    ses.trace_path = trace_path

    telemetry = args.telemetry
    if telemetry is None:
        # an env value, 'off' included, wins over ut.config
        telemetry = os.environ.get("UT_TELEMETRY", "").strip() or None
        if telemetry is None:
            cfg_t = settings["telemetry"]
            if not obs.ship.disabled_token(cfg_t):
                telemetry = str(cfg_t)
    if obs.ship.disabled_token(telemetry):
        telemetry = None
    if telemetry:
        role = ("ut-driver" if not pid_env or pid_env == "0"
                else f"ut-driver.h{pid_env}")
        ses.shipper = obs.ship.start(telemetry, role=role)
        # the exit flush's ship.stop() ships the final window when a
        # supervisor kills the run
        obs.install_exit_flush(None)

    dtrace = args.device_trace
    if dtrace is None:
        dtrace = obs.device.maybe_trace_from_env()
    elif dtrace.lower() in ("off", "none"):
        dtrace = None
    else:
        dtrace = obs.device.start_trace(dtrace)
    ses.dtrace = dtrace

    journal_path = args.journal
    if journal_path is None:
        journal_path = os.environ.get("UT_JOURNAL", "").strip() or None
        if journal_path is None:
            cfg_j = settings["journal"]
            if cfg_j:
                journal_path = str(cfg_j)
    if journal_path and obs.journal.disabled_token(journal_path):
        journal_path = None
    if journal_path and pid_env and pid_env != "0":
        root, ext = os.path.splitext(journal_path)
        journal_path = f"{root}.h{pid_env}{ext}"
    if journal_path:
        ses.jmon = obs.start_journal(
            journal_path, meta={"process": "ut-driver",
                                "script": os.path.basename(script)})
        if not trace_path:
            # the graceful flush must still cover the journal's tail
            obs.install_exit_flush(None)
    ses.journal_path = journal_path
    return ses


def main(argv: Optional[List[str]] = None) -> int:
    raw = list(argv if argv is not None else sys.argv[1:])
    if raw and raw[0] in SUBCOMMANDS:
        import importlib
        mod_name, attr = SUBCOMMANDS[raw[0]]
        return getattr(importlib.import_module(mod_name), attr)(raw[1:])
    if raw and raw[0] in REFUSED_SUBCOMMANDS:  # none left (see above)
        print(f"ut-torch: the {raw[0]!r} subcommand is not ported yet "
              f"(ROADMAP Queue 1 {REFUSED_SUBCOMMANDS[raw[0]]})",
              file=sys.stderr)
        return 2
    args = build_parser().parse_args(argv)
    what = refused(args)
    if what is not None:
        print(f"ut-torch: {what} is refused: {OBS_REFUSED[what]}; unset "
              f"it or set it to off", file=sys.stderr)
        return 2
    _configure_logging(args.verbose)
    log = logging.getLogger("uptune_tpu_torch")
    if args.num_hosts is not None and args.num_hosts > 1 \
            and "UT_PROCESS_ID" not in os.environ:
        return _launch_hosts(args.num_hosts, argv, args.work_dir)

    if args.list_techniques:
        from .techniques.base import all_technique_names, is_experimental
        for name in all_technique_names():
            # [experimental] = measured BEHIND the default portfolio on
            # the reference fixtures (AB_PORTFOLIO.md) — selectable,
            # not recommended
            print(f"{name}  [experimental]" if is_experimental(name)
                  else name)
        return 0
    if not args.script:
        print("ut-torch: a script to tune is required", file=sys.stderr)
        return 2

    script = os.path.abspath(args.script)
    if not os.path.isfile(script):
        print(f"ut-torch: no such file {script}", file=sys.stderr)
        return 2
    work_dir = os.path.abspath(args.work_dir or os.path.dirname(script)
                               or os.getcwd())

    if args.apply_best:
        from .exec.measure import call_program
        env = dict(os.environ)
        env.update({"BEST": "True", "UPTUNE": "True",
                    "UT_WORK_DIR": work_dir})
        res = call_program([sys.executable, script] + args.script_args,
                           env=env, cwd=work_dir, capture=False)
        return res["returncode"]

    if args.store is not None and args.store not in ("on", "off"):
        if not args.store.startswith("tcp://"):
            print(f"ut-torch: --store must be on, off or tcp://HOST:PORT, "
                  f"got {args.store!r}", file=sys.stderr)
            return 2
        from .store.remote import parse_addr
        try:
            parse_addr(args.store)
        except ValueError as e:
            print(f"ut-torch: --store: {e}", file=sys.stderr)
            return 2
    if not (args.print_params or args.print_search_space_size):
        # the tune runs on the card unless --device cpu: fail before the
        # analysis run on a host without one
        from .device import resolve_device
        try:
            resolve_device(args.device)
        except RuntimeError as e:
            print(f"ut-torch: {e} (pass --device cpu)", file=sys.stderr)
            return 1

    from .api.session import settings
    from .exec.controller import ProgramTuner
    from .exec.template import detect_template

    template = None
    if script.endswith((".py", ".tpl")):
        try:
            template = detect_template(script)
        except ValueError as e:
            print(f"ut-torch: {e}", file=sys.stderr)
            return 2

    technique = args.technique
    if technique is not None and len(technique) == 1:
        technique = technique[0]
    if args.generate_bandit_technique is not None:
        if technique is not None:
            print("ut-torch: --generate-bandit-technique conflicts with "
                  "--technique; pass one or the other", file=sys.stderr)
            return 2
        from .techniques.banditmutation import generate_bandit_technique
        technique = generate_bandit_technique(
            args.generate_bandit_technique)

    # the flag is this layer's override; when absent, ProgramTuner
    # itself falls back to the ut.config 'learning-model' setting (the
    # same flags > settings > defaults layering as its sibling params)
    models = args.learning_models
    surrogate = models[0] if models else None
    if models and len(models) > 1:
        log.warning("[ut] only one surrogate runs per tuner; using "
                    "%r and ignoring %r (the mlp kind is itself an "
                    "ensemble)", surrogate, models[1:])

    if args.surrogate_arbitration == "bandit-small-budget":
        from .calibrated import BUDGET_CONSTRAINED_OPTS
        sopts = dict(BUDGET_CONSTRAINED_OPTS)
    elif args.surrogate_arbitration:
        sopts = {"arbitration": args.surrogate_arbitration}
    else:
        sopts = None
    if args.surrogate_screen:
        try:
            c, k = (int(x) for x in args.surrogate_screen_top.split(","))
        except ValueError:
            print("ut-torch: --surrogate-screen-top must be 'CONT,CAT' "
                  "integers", file=sys.stderr)
            return 2
        sopts = dict(sopts or {})
        sopts["screen"] = {"archives": list(args.surrogate_screen),
                           "top_cont": c, "top_cat": k}
        sopts["screen_mode"] = args.surrogate_screen_mode
    if args.surrogate_flip_bias:
        sopts = dict(sopts or {})
        sopts["flip_bias"] = args.surrogate_flip_bias
    seed_cfgs = []
    for path in (args.seed_configuration or []):
        try:
            with open(path) as f:
                loaded = json.load(f)
        except (OSError, json.JSONDecodeError) as e:
            print(f"ut-torch: --seed-configuration {path}: {e}",
                  file=sys.stderr)
            return 2
        if isinstance(loaded, dict):
            loaded = [loaded]
        if not (isinstance(loaded, list)
                and all(isinstance(c, dict) for c in loaded)):
            print(f"ut-torch: --seed-configuration {path}: expected a "
                  f"JSON object or list of objects", file=sys.stderr)
            return 2
        seed_cfgs.extend(loaded)

    store_dir = args.store_dir
    if args.store == "off":
        store_dir = "off"
    elif args.store == "on" and store_dir is None:
        # force-enable ONLY overrides a disabled config: a store-dir
        # configured via ut.config keeps winning (--store on means
        # "make sure it runs", not "ignore where it runs)"
        cfg_dir = settings["store-dir"]
        if cfg_dir is None or (isinstance(cfg_dir, str)
                               and cfg_dir.lower() in ("off", "none")):
            store_dir = "default"   # ut.temp/store under the work dir
    elif args.store is not None and args.store != "on":
        # tcp://HOST:PORT (checked above) joins a cooperative store
        # server; the addr IS the store base (wins over any directory —
        # a process cannot be in two stores)
        store_dir = args.store
    pt = ProgramTuner(
        [sys.executable, script] + args.script_args, work_dir,
        parallel=args.parallel_factor, test_limit=args.test_limit,
        runtime_limit=args.runtime_limit, timeout=args.timeout,
        technique=technique, seed=args.seed, params_file=args.params,
        resume=args.resume, sandbox=not args.no_sandbox,
        surrogate=surrogate, surrogate_opts=sopts,
        surrogate_async=args.surrogate_async, template=template,
        seed_configs=seed_cfgs, prefetch=args.prefetch,
        compile_cache_dir=args.compile_cache_dir,
        store_dir=store_dir, warm_start=args.warm_start,
        federate=(None if args.federate is None
                  else args.federate == "on"),
        exchange_interval=args.exchange_interval, device=args.device)

    if args.cfg:
        for k in sorted(settings):
            print(f"  {k} = {settings[k]}")

    params = pt.analyze()
    if args.print_params:
        print(json.dumps(params, indent=1))
        return 0
    if args.print_search_space_size:
        import math
        from .exec.space_io import stage_spaces
        for s, space in enumerate(stage_spaces(params)):
            size = space.search_space_size()
            print(f"stage {s}: log10(size) = "
                  f"{math.log10(size) if size else 0:.2f}")
        return 0

    from .exec.multistage import run_auto
    session = _start_obs(args, settings, script, log)
    try:
        res = run_auto(pt)   # single / multi-stage / decouple
    finally:
        session.stop_device_trace()
    session.finish()
    log.info("[ut] done: best qor=%.6g evals=%d", res.best_qor, res.evals)
    print(json.dumps({"best_config": res.best_config,
                      "best_qor": res.best_qor, "evals": res.evals}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
