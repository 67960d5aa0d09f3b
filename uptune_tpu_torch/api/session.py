"""Session settings + best-config persistence: `ut.config`, `ut.init`,
`ut.get_best`.

Mirrors the reference's validated settings dict
(`python/uptune/__init__.py:45-55,79-83`) and best-config
round trip (`api.py:52-65,146-149`): the controller writes ``best.json``
on every improvement; ``get_best()`` reads it back; ``init(apply_best=
True)`` switches the process into BEST mode so subsequent ``ut.tune()``
calls serve the best config.

Precedence contract (tests/python/test_async_execute.py:5-14 in the
reference): CLI flags > ``ut.config(...)`` > these defaults.  The CLI
layer (`uptune_tpu_torch.cli`) reads this dict for any flag the user did not
pass explicitly.
"""
from __future__ import annotations

import json
import os
from typing import Any, Dict, Optional, Tuple

from .state import BEST_FILE, STATE

# The JAX package's keys, so that a program's ut.config(...) written for
# it runs unchanged; the port's program mode reads the controller's keys
# (budget, parallelism, store, surrogate, prefetch), and the compilation
# cache, observability, Pallas routing and serving keys are accepted and
# have no effect until their planes are ported (ROADMAP Queue 1).
DEFAULTS: Dict[str, Any] = {
    "test-limit": 10,
    "runtime-limit": 7200,
    "timeout": 72000,
    "parallel-factor": 2,
    "async-interval": 0.05,
    "gpu-num": 0,
    "cpu-num": 1,
    "learning-model": [],
    "training-data": None,
    "online-training": False,
    "technique": None,
    "seed": 0,
    # async ticket prefetch depth for the program-mode controller
    # (None = one pool width of lookahead; 0 = lockstep propose-on-free)
    "prefetch-depth": None,
    # persistent XLA compilation cache base dir for driver programs
    # (None = default resolution: UT_COMPILE_CACHE_DIR, else .xla_cache
    # at the repo root / ~/.cache/uptune_tpu/xla; 'off' disables).  The
    # controller appends a per-space-signature subdir, so repeated tunes
    # of the same program skip first-step compiles
    "compile-cache-dir": None,
    # content-addressed trial results store (docs/STORE.md): directory
    # of append-only result shards consulted before every build — a hit
    # serves the recorded QoR without launching the program, and N
    # concurrent instances sharing one directory exchange results.
    # None = <work_dir>/ut.temp/store; the literal 'off' disables
    "store-dir": None,
    # fsync every store segment append (docs/STORE.md "Durability"):
    # the O_APPEND protocol already survives process SIGKILL via the
    # page cache; this knob additionally survives power loss / kernel
    # panic at the cost of one fsync per recorded build.  Layered
    # under the UT_STORE_FSYNC env var; off by default — a recorded
    # build is re-measurable, so most deployments prefer the append
    # to stay off the critical path
    "store-fsync": False,
    # warm-start a fresh tune from the store's recorded rows for the
    # same (space, program): preload best-so-far + dedup history +
    # surrogate training set before the first acquisition
    "warm-start": False,
    # cooperative search (docs/STORE.md "Remote store"):
    # when the store brings in sibling rows at exchange time, also
    # feed the non-elite (config, qor) rows into the local surrogate's
    # training set — K cooperating instances train on one pooled
    # evidence set.  Off disables the federated feed (elite migration
    # alone still runs)
    "federate": True,
    # migration cadence in seconds: minimum interval between store
    # refreshes (directory re-scan or remote delta pull), which gates
    # both elite migration and the federated feed
    "exchange-interval": 2.0,
    # observability plane (docs/OBSERVABILITY.md): a path turns on
    # cross-plane span tracing for the run and writes a
    # Perfetto-viewable Chrome trace there (+ a metrics-snapshot JSONL
    # next to it); None/'off' leaves tracing disabled (the
    # instrumented hot paths cost one flag check).  Layered under the
    # `ut --trace` flag and the UT_TRACE env var
    "trace": None,
    # tuning journal (docs/OBSERVABILITY.md "Search-quality
    # telemetry"): a path streams structured search events (arm pulls,
    # dedup/prune verdicts, tells joined with the surrogate's
    # propose-time mu/sigma, store hits) to an append-only JSONL and
    # derives live convergence/calibration gauges + stall alerts from
    # them; render post-hoc with `ut report`.  Layered under the
    # `ut --journal` flag and the UT_JOURNAL env var; None/'off'
    # leaves it disabled (one flag check per call site)
    "journal": None,
    # fleet telemetry (docs/OBSERVABILITY.md "Fleet telemetry"):
    # 'host:port' of a running `ut hub` collector — the process ships
    # metrics window snapshots, journal rows, alerts and health
    # rollups there over a bounded never-blocking queue.  Layered
    # under the `--telemetry` flags and the UT_TELEMETRY env var
    # (which --num-hosts replicas inherit); None/'off' disables
    "telemetry": None,
    # async surrogate plane (docs/PERF.md): 'on' (None = default) moves
    # the O(N^3) GP refit + fit_auto hyperparameter sweep onto a
    # background worker publishing versioned snapshots, so the driver
    # tell path never blocks on learning; 'off' runs the full refit
    # synchronously inline again (note: O(N^2) incremental extension
    # between refits stays on in both modes — disable it via
    # surrogate_opts={'incremental': False})
    "surrogate-async": None,
    # Pallas kernel routing (ops/routing.py): 'auto' (None = default)
    # routes each kernel site by backend + shape qualification — the
    # compiled TPU kernel, the interpret-mode kernel on CPU where the
    # site opts in, the XLA fallback otherwise; 'interpret' forces the
    # kernel route in interpret mode wherever shapes are supported
    # (debugging/CI: kernel math everywhere, any host); 'off' forces
    # the XLA fallback everywhere (bisection).  Layered UNDER the
    # UT_PALLAS env var (env wins — the knob must be forceable on a
    # subprocess without touching its code)
    "pallas": None,
    # tuning-as-a-service session server (`ut serve`, docs/SERVING.md).
    # Same precedence contract as every other key: CLI flags >
    # ut.config(...) > these defaults.
    # bind address / TCP port (0 = pick an ephemeral port and print it)
    "serve-host": "127.0.0.1",
    "serve-port": 8765,
    # instance-slot capacity of each engine group: sessions sharing one
    # space signature are packed onto one BatchedEngine instance axis
    # (proposals batch ACROSS tenants); when a group fills, another
    # group of the same signature is allocated
    "serve-slots": 64,
    # admission limit across all groups ('server full' above it)
    "serve-max-sessions": 4096,
    # shared cross-tenant results memo: one content-addressed store
    # directory mounted under every session's scope — a config one
    # tenant measured is served to any other tenant's ask without a
    # build.  None = ut.serve/store under the server's cwd; 'off'
    # disables the memo
    "serve-store-dir": None,
    # crash-safe serving (docs/SERVING.md "Durability & failover"):
    # a directory (or 'on' for <store-dir>/checkpoints) turns on the
    # write-ahead session checkpoint plane — every committed session
    # transition is journaled before its reply, `ut serve --durable`
    # recovers all live sessions on restart, and resuming clients
    # re-attach losslessly.  None/'off' disables
    "serve-durable": None,
    # fsync each checkpoint append (power-loss durability; SIGKILL
    # durability needs no fsync — same tradeoff as store-fsync)
    "serve-durable-fsync": False,
}

settings: Dict[str, Any] = dict(DEFAULTS)


def config(user: Dict[str, Any]) -> Dict[str, Any]:
    """Override session settings; unknown keys are rejected."""
    if not isinstance(user, dict):
        raise TypeError(f"config expects a dict, got {type(user).__name__}")
    unknown = sorted(set(user) - set(DEFAULTS))
    if unknown:
        raise KeyError(
            f"unknown setting(s) {unknown}; valid: {sorted(DEFAULTS)}")
    settings.update(user)
    return settings


def reset_settings() -> None:
    """Restore defaults (used by tests and between CLI runs)."""
    settings.clear()
    settings.update(DEFAULTS)


def init(apply_best: bool = False) -> None:
    """Mark the process as running under uptune; optionally apply the
    best known config to subsequent ut.tune() calls."""
    if os.environ.get("EZTUNING"):
        return
    os.environ["UPTUNE"] = "True"
    if apply_best:
        os.environ["BEST"] = "True"
        STATE.reset()


def best_path(work_dir: Optional[str] = None) -> str:
    return os.path.join(work_dir or STATE.work_dir, BEST_FILE)


def get_best(work_dir: Optional[str] = None) -> Tuple[Dict[str, Any], Any]:
    """-> (best config dict, its QoR)."""
    path = best_path(work_dir)
    if not os.path.isfile(path):
        raise FileNotFoundError(
            f"no best config at {path}: run a tuning session first")
    with open(path) as f:
        best = json.load(f)
    if isinstance(best, dict) and "config" in best:
        return best["config"], best.get("qor")
    if isinstance(best, (list, tuple)) and len(best) == 2:
        return dict(best[0]), best[1]
    raise ValueError(f"unrecognized best.json payload at {path}")


def write_best(cfg: Dict[str, Any], qor: Any,
               work_dir: Optional[str] = None,
               filename: Optional[str] = None) -> None:
    """Controller-side write of best.json (api.py:146-149).  `filename`
    overrides BEST_FILE (multi-host replicas write best.h{N}.json so N
    processes never race on one file)."""
    path = (os.path.join(work_dir or STATE.work_dir, filename)
            if filename else best_path(work_dir))
    with open(path, "w") as f:
        json.dump({"config": cfg, "qor": qor}, f, indent=1)
