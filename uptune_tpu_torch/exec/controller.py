"""ProgramTuner: end-to-end black-box tuning of an external program.

The JAX package's `exec/controller.py` on the port's Tuner: the
re-design of the reference's controller stack
(`python/uptune/api.py:399-594` async_execute +
`src/async_task_scheduler.py:20-52` analysis +
`src/single_stage.py:13-82` single-stage run builder):

1. ANALYSIS: run the program once with UT_BEFORE_RUN_PROFILE=On; it
   records its search space (`ut.params.json`) and default QoR.
2. Build the device Space and a Tuner whose proposal side (techniques,
   bandit, dedup, surrogate prune) runs on `device` (the card by
   default), committing through the merge kernel.
3. Async evaluation: keep a WorkerPool of subprocess slots busy from the
   Tuner's ask() queue; tell() results back as they arrive (the free-list
   semantics of api.py:458-554) with timeout kill + dead-worker
   replacement; honor @ut.rule config filters, @ut.constraint QoR
   checks, and @ut.model host proposal sources.
4. Persist best.json on every improvement (api.py:146-149) and the jsonl
   trial archive for resume.
5. Content-addressed results store (`store/`, docs/STORE.md):
   every trial is looked up before launch — a hit serves the recorded
   QoR without a build — every measured result is recorded back, and
   concurrent instances sharing one store directory exchange results
   (the reference's SQLite result-database sync, api.py SQLAlchemy).

The JAX package's controller also keeps a persistent XLA compilation
cache; the port compiles nothing at tune time, so `compile_cache_dir` is
accepted and has no effect.  Its spans, counters and journal rows are
the JAX controller's: the analyze and warm-start spans, the store-hit
bypass lane, the exchange and federate rows.
"""
from __future__ import annotations

import collections
import json
import logging
import os
import time
from typing import Any, Dict, List, Optional, Tuple


from .. import obs
from ..api.constraint import REGISTRY
from ..api.session import settings, write_best
from ..api.state import DEFAULT_QOR_FILE, PARAMS_FILE
from ..api.tuner import registered_models
from ..device import DeviceLike
from ..driver.driver import Trial, Tuner, TuneResult
from .measure import call_program
from .pool import WorkerPool
from .space_io import default_config, space_from_params

log = logging.getLogger("uptune_tpu_torch")


class AnalysisError(RuntimeError):
    pass


class ProgramTuner:
    """Tune an external program invocation over its declared space.

    Parameters mirror the reference's CLI/settings layer (api.py:24-48);
    any left as None falls back to ut.config() session settings.
    """

    def __init__(self, command, work_dir: Optional[str] = None, *,
                 parallel: Optional[int] = None,
                 test_limit: Optional[int] = None,
                 runtime_limit: Optional[float] = None,
                 timeout: Optional[float] = None,
                 technique=None, seed: Optional[int] = None,
                 params_file: Optional[str] = None,
                 archive: Optional[str] = None, resume: bool = False,
                 surrogate=None, surrogate_opts: Optional[dict] = None,
                 surrogate_async: Optional[str] = None,
                 env: Optional[Dict[str, str]] = None,
                 sandbox: bool = True,
                 status_interval: Optional[int] = None,
                 template=None, hooks=None,
                 seed_configs: Optional[List[Dict]] = None,
                 prefetch: Optional[int] = None,
                 compile_cache_dir: Optional[str] = None,
                 store_dir: Optional[str] = None,
                 warm_start: Optional[bool] = None,
                 federate: Optional[bool] = None,
                 exchange_interval: Optional[float] = None,
                 device: DeviceLike = "cuda"):
        # seed_configs: known-good configurations injected as 'seed'
        # trials at startup (the reference's --seed-configuration file
        # loading, opentuner/search/driver.py:37-42) — warm-starts
        # expensive runs from prior bests.  Unlike the declared-defaults
        # seed their QoR is unknown, so they are EVALUATED first.
        # template: a TemplateProgram (non-intrusive mode) — the space
        # comes from its annotations and each trial renders its own copy
        # of the source into the sandbox before launch
        self.template = template
        self.hooks = hooks
        # where the Tuner's proposal side runs (the card unless the
        # caller asks for the CPU; no fallback)
        self.device = device
        if template is not None and isinstance(command, (list, tuple)):
            # trials must execute the per-sandbox RENDERED copy, so any
            # absolute reference to the annotated source becomes relative
            # to the trial's cwd (its sandbox)
            tpath = os.path.abspath(template.path)
            command = [os.path.basename(c)
                       if isinstance(c, str) and os.path.abspath(c) == tpath
                       else c for c in command]
        self.command = command
        self.work_dir = os.path.abspath(work_dir or os.getcwd())
        os.makedirs(self.work_dir, exist_ok=True)
        self.parallel = int(parallel if parallel is not None
                            else settings["parallel-factor"])
        self.test_limit = int(test_limit if test_limit is not None
                              else settings["test-limit"])
        self.runtime_limit = (runtime_limit if runtime_limit is not None
                              else settings["runtime-limit"])
        self.timeout = (timeout if timeout is not None
                        else settings["timeout"])
        self.interval = float(settings["async-interval"])
        self.technique = (technique if technique is not None
                          else settings["technique"])
        self.seed = int(seed if seed is not None else settings["seed"])
        # `ut --num-hosts N` (or a real pod launch) makes each process
        # an INDEPENDENT search replica over the same program
        # (multi-start): program-mode tuning has no cross-process
        # exchange.  Diverge the replica seeds, and give
        # non-coordinator replicas their own archive/best files so N
        # appenders never interleave one jsonl.
        pid = int(os.environ.get("UT_PROCESS_ID", "0") or 0)
        nproc = int(os.environ.get("UT_NUM_PROCESSES", "1") or 1)
        self.host_tag = f".h{pid}" if (nproc > 1 and pid > 0) else ""
        if nproc > 1:
            self.seed += pid
        self.params_file = params_file
        self.archive = archive if archive is not None else os.path.join(
            self.work_dir, f"ut.archive{self.host_tag}.jsonl")
        self.resume = resume
        self.seed_configs = list(seed_configs or [])
        if surrogate is None:
            # same flags > ut.config() > defaults layering as the
            # sibling parameters above; the settings key holds a kind
            # list (the reference's learning-model list, __init__.py:53)
            m = settings["learning-model"]
            models = [m] if isinstance(m, str) else list(m or [])
            surrogate = models[0] if models else None
            if len(models) > 1:
                log.warning(
                    "[ut] only one surrogate runs per tuner; using %r "
                    "and ignoring %r (the mlp kind is itself an "
                    "ensemble)", surrogate, models[1:])
        self.surrogate = surrogate
        # by-name surrogates get the calibrated defaults (BENCHREPORT
        # settings) unless the caller overrides
        if isinstance(surrogate, str):
            from ..calibrated import CALIBRATED_OPTS
            self.surrogate_opts = {**CALIBRATED_OPTS,
                                   **(surrogate_opts or {})}
            # async surrogate plane (docs/PERF.md): flag > ut.config >
            # default ON for program mode — builds give the background
            # refit wall-clock to hide behind, exactly like prefetch.
            # An explicit surrogate_opts['async_refit'] (library use)
            # wins over the settings default; the explicit
            # --surrogate-async flag wins over everything
            sa = (surrogate_async if surrogate_async is not None
                  else settings["surrogate-async"])
            on = str(sa).lower() not in ("off", "false", "0") \
                if sa is not None else True
            if surrogate_async is not None:
                self.surrogate_opts["async_refit"] = on
            else:
                self.surrogate_opts.setdefault("async_refit", on)
        else:
            self.surrogate_opts = surrogate_opts
            if surrogate is None and surrogate_opts:
                log.warning(
                    "[ut] surrogate options %s have no effect: no "
                    "learning model is enabled (pass --learning-models "
                    "/ ut.config learning-model)",
                    sorted(surrogate_opts))
        self.env_extra = dict(env or {})
        # children (analysis run + sandboxed eval workers) must be able
        # to `import uptune_tpu_torch` even from a plain checkout with no
        # `pip install -e .` (utils/pypath.py)
        from ..utils.pypath import child_pythonpath
        self.env_extra["PYTHONPATH"] = child_pythonpath(
            self.env_extra.get("PYTHONPATH"))
        self.use_sandbox = sandbox
        self.status_interval = (status_interval if status_interval
                                is not None else max(1, self.parallel))
        # async ticket prefetch: keep `prefetch` trials proposed AHEAD
        # of free worker slots, so the device propose+dedup+config
        # materialization runs while every slot is still busy building
        # and a freed slot is refilled instantly (0 = the old lockstep
        # behavior: propose only when a slot is already free).  Default
        # is the pool width — one build wave of lookahead.
        pf = (prefetch if prefetch is not None
              else settings["prefetch-depth"])
        self.prefetch = int(pf if pf is not None else self.parallel)
        # accepted for the JAX package's callers; the port has no
        # compilation cache (module docstring)
        self.compile_cache_dir = compile_cache_dir
        # content-addressed results store (uptune_tpu/store/,
        # docs/STORE.md): consulted before every build — a hit serves
        # the recorded QoR through tell() without launching anything;
        # results land back in it as they are measured, and concurrent
        # instances sharing one directory — or one tcp:// store server
        # (`ut-torch store`, or the JAX package's `ut store`) — exchange
        # them.
        # None resolves to <work_dir>/ut.temp/store; the literal 'off'
        # disables.
        self.store_dir = (store_dir if store_dir is not None
                          else settings["store-dir"])
        self.warm_start = bool(warm_start if warm_start is not None
                               else settings["warm-start"])
        # cooperative-search knobs: `federate` feeds sibling
        # (config, qor) rows into the local surrogate's training set at
        # exchange time (K hosts train one surrogate's worth of
        # evidence); `exchange_interval` is the migration cadence —
        # it becomes the store's refresh_interval, the single gate both
        # the elite-migration and federated-rows flows tick on
        self.federate = bool(federate if federate is not None
                             else settings["federate"])
        self.exchange_interval = float(
            exchange_interval if exchange_interval is not None
            else settings["exchange-interval"])
        self.store = None
        self.store_hits = 0        # builds eliminated by cache hits
        self.exchange_injected = 0  # sibling-instance bests ingested
        self.federated_rows = 0    # sibling rows fed to the surrogate
        # observability: speculative trials withdrawn after a tell()
        # landed a new best (their tickets were proposed around the
        # stale incumbent)
        self.spec_cancelled = 0

        self.params: Optional[List[List[Dict[str, Any]]]] = None
        self.default_qor: Optional[float] = None
        self.sense = "min"
        self.tuner: Optional[Tuner] = None
        self.pool: Optional[WorkerPool] = None
        self.stage = 0
        self._results_seen = 0
        self._host_history: List[Tuple[Dict[str, Any], float]] = []

    # ------------------------------------------------------------------
    def analyze(self, force: bool = False) -> List[List[Dict[str, Any]]]:
        """Space discovery: reuse an existing ut.params.json (the
        reference's --params short-circuit, async_task_scheduler.py:21-32)
        or run the profiling subprocess."""
        if self.template is not None:
            # template mode: the space comes from the annotations; run the
            # default-rendered program once for the default QoR + sense
            self.params = [self.template.records]
            self.template.write_params(
                os.path.join(self.work_dir, PARAMS_FILE))
            name = os.path.basename(self.template.path)
            dflt = os.path.join(self.work_dir, name)
            if os.path.abspath(dflt) != os.path.abspath(
                    self.template.path):
                self.template.render_to(dflt)
            env = dict(os.environ)
            env.update(self.env_extra)
            env.pop("UT_TUNE_START", None)
            env.update({"UT_BEFORE_RUN_PROFILE": "On",
                        "UT_WORK_DIR": self.work_dir})
            call_program(self.command, limit=self.runtime_limit, env=env,
                         cwd=self.work_dir)
            self._read_default_qor()
            return self.params

        path = self.params_file or os.path.join(self.work_dir, PARAMS_FILE)
        if not force and os.path.isfile(path):
            with open(path) as f:
                self.params = json.load(f)
        else:
            env = dict(os.environ)
            env.update(self.env_extra)
            env.pop("UT_TUNE_START", None)
            env.update({"UT_BEFORE_RUN_PROFILE": "On",
                        "UT_WORK_DIR": self.work_dir})
            res = call_program(self.command, limit=self.runtime_limit,
                               env=env, cwd=self.work_dir)
            ppath = os.path.join(self.work_dir, PARAMS_FILE)
            if res["returncode"] != 0 or not os.path.isfile(ppath):
                raise AnalysisError(
                    f"analysis run failed (rc={res['returncode']}, "
                    f"timeout={res['timeout']}): "
                    f"{res['stderr'].strip()[-500:]}")
            with open(ppath) as f:
                self.params = json.load(f)
        if not self.params or not any(self.params):
            raise AnalysisError("analysis recorded no tunable parameters")
        self._read_default_qor()
        return self.params

    def _read_default_qor(self) -> None:
        dq_path = os.path.join(self.work_dir, DEFAULT_QOR_FILE)
        if os.path.isfile(dq_path):
            try:
                with open(dq_path) as f:
                    dq = json.load(f)
                self.default_qor = float(dq["qor"])
                self.sense = dq.get("trend", "min")
            except (json.JSONDecodeError, KeyError, TypeError, ValueError):
                pass

    # ------------------------------------------------------------------
    def _make_tuner(self, space) -> Tuner:
        filt = (REGISTRY.check_config if REGISTRY.rules else None)
        return Tuner(space, None, technique=self.technique,
                     seed=self.seed, sense=self.sense,
                     archive=self.archive, resume=self.resume,
                     surrogate=self.surrogate,
                     surrogate_opts=self.surrogate_opts,
                     config_filter=filt,
                     hooks=self.hooks, device=self.device)

    def _maybe_new_best(self, stats) -> None:
        if stats is not None and stats.was_new_best:
            res = self.tuner.result()
            write_best(res.best_config, res.best_qor,
                       work_dir=self.work_dir,
                       filename=(f"best{self.host_tag}.json"
                                 if self.host_tag else None))
            log.info("[ut] new best qor=%.6g after %d evals",
                     res.best_qor, res.evals)

    def _status(self, last_qor: Optional[float]) -> None:
        self._results_seen += 1
        if self._results_seen % self.status_interval:
            return
        res = self.tuner.result()
        lw = "fail" if last_qor is None else f"{last_qor:.6g}"
        log.info("[ut] evals=%d best(GB)=%.6g last(LW)=%s pending=%d "
                 "replaced=%d", res.evals, res.best_qor, lw,
                 self.pool.busy_count, self.pool.replaced)

    @staticmethod
    def _cancel_speculative(queue, tuner: Tuner) -> int:
        """Withdraw queued-but-unlaunched trials whose ticket came from
        a technique arm (or the bandit-arbitrated surrogate plane):
        they were proposed around the now-stale incumbent.  cancel()
        guarantees no archive row, no history insert, and — when a
        ticket loses ALL its trials — no observe() and no bandit credit
        (driver._finalize `withdrawn`), so a cancelled pull is an
        unknown outcome, not a penalty.  Externally-provided trials
        (seed configs, @ut.model proposals, random saturation top-ups)
        are kept: their value does not depend on the incumbent."""
        kept, n = [], 0
        while queue:
            tr = queue.popleft()
            tk = tr.ticket
            # injected covers seed/model AND the random saturation
            # top-up (arm set, injected=True) — all incumbent-agnostic;
            # the bandit-arbitrated surrogate pull (credit_virtual) is
            # injected too but IS proposed around the incumbent
            if (not tk.injected) or tk.credit_virtual:
                tuner.cancel(tr)
                n += 1
            else:
                kept.append(tr)
        queue.extend(kept)
        if n:
            # trials actually withdrawn, not new-best sweeps
            obs.count("driver.spec_invalidations", n)
        return n

    # ------------------------------------------------------------------
    def _open_store(self, space):
        """Open the results store for this (space, command, stage)
        scope, or return None when disabled ('off').  A ``tcp://``
        base names a cooperative store server
        (`ut-torch store`, a `RemoteStore`); anything
        else a filesystem `ResultStore`."""
        base = self.store_dir
        if isinstance(base, str) and base.lower() in ("off", "none"):
            return None
        if base is None or (isinstance(base, str)
                            and base.lower() in ("on", "default")):
            base = os.path.join(self.work_dir, "ut.temp", "store")
        from ..store import open_store
        extra = ([self.template.path] if self.template is not None
                 else None)
        return open_store(base, [repr(s) for s in space.specs],
                          self.command, stage=self.stage,
                          extra_files=extra, env=self.env_extra,
                          refresh_interval=self.exchange_interval)

    @staticmethod
    def _verdict(qor: Optional[float],
                 config: Dict[str, Any]) -> Optional[float]:
        """USER-oriented QoR -> the tell() verdict: an @ut.constraint
        violation becomes a failure (None).  The ONE rule shared by
        the poll loop, the wall-limit drain, store-hit serving, and
        the profiled seed default."""
        if qor is not None and REGISTRY.constraints and \
                not REGISTRY.check_qor(qor, config):
            return None
        return qor

    def _record_result(self, trial: Trial, qor: Optional[float],
                       dur: float, info: Dict[str, Any]) -> None:
        """Measured trial -> store row.  The RAW QoR is recorded (the
        @ut.constraint verdict is session policy, re-applied at serve
        time); timeouts are not recorded at all — they depend on this
        run's --runtime-limit and another instance with a wider limit
        may succeed."""
        if self.store is None or info.get("timeout"):
            return
        tk = trial.ticket
        self.store.record(
            trial.config, qor, dur, u=tk.u_np[trial.slot],
            perms=[p[trial.slot] for p in tk.perms_np])

    def _serve_hit(self, trial: Trial, row: Dict[str, Any],
                   queue) -> None:
        """A store hit: synthesize the trial result and tell() it
        immediately — no build, but FULL accounting (told/evals budget,
        archive row, surrogate observation, bandit credit) and the same
        new-best speculative invalidation a pool result triggers."""
        t0 = time.perf_counter()
        qor = self._verdict(row.get("qor"), trial.config)
        stats = self.tuner.tell(trial, qor, float(row.get("dur", 0.0)))
        if obs.journal.enabled():
            # store-hit attribution for the search-quality stream: the
            # tell row records the outcome, this one that it cost no
            # build
            obs.journal.emit(
                "store_hit", gid=trial.gid,
                qor=None if qor is None else round(float(qor), 6),
                dur=round(float(row.get("dur", 0.0)), 6))
        if obs.enabled():
            # the bypass lane: a served ticket's gid shows up here and
            # never on a worker-N build lane
            obs.complete_span("store.serve_hit", t0=t0,
                              dur=time.perf_counter() - t0,
                              track="store", gid=trial.gid)
            obs.observe("store.serve_ms",
                        (time.perf_counter() - t0) * 1e3)
        if qor is not None:
            self._host_history.append((trial.config, qor))
        if stats is not None and stats.was_new_best and self.prefetch:
            self.spec_cancelled += self._cancel_speculative(
                queue, self.tuner)
        self._maybe_new_best(stats)
        self._status(qor)

    def _warm_start_from_store(self) -> int:
        """Preload the store's recorded rows for this scope into the
        tuner: best-so-far + dedup history + surrogate training set,
        with no budget/archive impact (Tuner.preload).  Rows carrying
        exact unit vectors replay bit-exactly; legacy rows without them
        are re-encoded from their configs (close enough for warm-start
        dedup — a boundary float that re-encodes differently just gets
        re-measured once)."""
        store, tuner = self.store, self.tuner
        rows = store.scope_rows()
        if REGISTRY.constraints:
            # stored rows carry the RAW QoR; @ut.constraint is session
            # policy and must gate here exactly as it gates serve-time
            # hits — otherwise a violating row becomes an unbeatable
            # preloaded best and the tune reports a forbidden config
            rows = [r for r in rows
                    if REGISTRY.check_qor(r["qor"], r["cfg"])]
        if not rows:
            return 0
        n = tuner.preload_rows(rows)
        res = tuner.result()
        log.info("[ut] warm start: %d stored trials preloaded "
                 "(best=%.6g)", n, res.best_qor)
        return n

    def _maybe_exchange_best(self, queue) -> None:
        """Multi-instance exchange: when refresh() brings in sibling
        rows, inject the incoming best as an 'exchange' trial if it
        beats our incumbent.  It will be a store hit at launch time —
        entering this instance's history/best/archive with full
        accounting and zero build cost (the reference's SQLite-sync
        new-best propagation, api.py SQLAlchemy plane).

        Acts ONLY on the store's fresh-foreign delta feed
        (`pop_fresh_rows`): rows already present at store open are a
        previous run's results — importing those up front would steer
        the techniques around them and break the exact cache replay of
        a repeated tune (the BENCH_CACHE protocol).  Cross-RUN
        propagation is `--warm-start`'s job.  A sibling's raw best may
        also violate THIS session's @ut.constraint — such rows are
        dropped, never injected (serving one would just burn a budget
        trial as a failure)."""
        rows = self.store.pop_fresh_rows()
        if REGISTRY.constraints:
            rows = [r for r in rows
                    if REGISTRY.check_qor(r["qor"], r["cfg"])]
        if not rows:
            return
        tuner = self.tuner
        pick = min if self.sense == "min" else max
        row = pick(rows, key=lambda r: float(r["qor"]))
        injected = []
        if tuner.sign * float(row["qor"]) < float(tuner.best.qor):
            injected = tuner.inject([row["cfg"]], source="exchange")
        if injected:
            self.exchange_injected += len(injected)
            obs.event("store.exchange", qor=float(row["qor"]))
            obs.count("store.exchange_injected", len(injected))
            if obs.journal.enabled():
                obs.journal.emit("exchange",
                                 qor=round(float(row["qor"]), 6))
            # serve ahead of speculative technique work
            queue.extendleft(reversed(injected))
        if self.federate:
            # federated surrogate rows: the injected elite
            # re-enters through its store-hit tell with full
            # accounting, so feed the REST of the delta to the
            # surrogate/dedup planes only — K cooperating hosts train
            # on one pooled evidence set without burning budget trials
            self._federate_rows([r for r in rows
                                 if not (injected and r is row)])

    def _federate_rows(self, rows) -> None:
        """Sibling (config, qor) rows -> the tuner's dedup history +
        surrogate training set (Tuner.preload_rows): no budget, no
        archive rows, no bandit credit — foreign evidence, not this
        run's work.  Refit stays at the surrogate's own versioned-
        snapshot watermark (maybe_refit): migration cadence must not
        force a refit storm on K hosts at once."""
        if not rows:
            return
        n = self.tuner.preload_rows(rows, refit=False)
        if not n:
            return
        self.federated_rows += n
        obs.count("store.federated_rows", n)
        sm = self.tuner.surrogate
        if sm is not None:
            sm.maybe_refit()
        if obs.journal.enabled():
            obs.journal.emit("federate", rows=n)

    def _host_proposals(self, space) -> List[Trial]:
        """Ask @ut.model proposal sources for one config each."""
        trials: List[Trial] = []
        for fn in registered_models():
            try:
                cfg = fn(list(self._host_history), space)
            except Exception as e:  # user code: isolate failures
                log.warning("[ut] custom model %s failed: %s",
                            getattr(fn, "_ut_model_name", fn), e)
                continue
            if isinstance(cfg, dict):
                trials.extend(self.tuner.inject(
                    [cfg], source=getattr(fn, "_ut_model_name", "model")))
        return trials

    # ------------------------------------------------------------------
    def run(self, test_limit: Optional[int] = None,
            time_limit: Optional[float] = None) -> TuneResult:
        """Tune end-to-end; returns the Tuner's TuneResult."""
        if self.params is None:
            with obs.span("controller.analyze"):
                self.analyze()
        limit = int(test_limit if test_limit is not None
                    else self.test_limit)
        wall_limit = (time_limit if time_limit is not None
                      else self.timeout)
        records = self.params[self.stage]
        space = space_from_params(records)
        store = self.store = self._open_store(space)
        self.tuner = tuner = self._make_tuner(space)
        # the CLI drives ask/tell (not Tuner.run), so the run-budget
        # surrogate rule is applied here where the limit is known
        tuner._apply_budget_rule(limit)
        if store is not None:
            if self.resume and os.path.exists(self.archive):
                # the replayed archive doubles as store rows, so runs
                # recorded before the store existed (or whose store dir
                # was lost) still never re-execute an archived config
                store.ingest_archive(self.archive)
            if self.warm_start:
                with obs.span("controller.warm_start") as sp:
                    sp.set(rows=self._warm_start_from_store())

        queue: collections.deque = collections.deque()
        # seed trial: the program's declared defaults; its QoR was already
        # measured by the profiling run, so tell() it without a subprocess
        seed_trials = tuner.inject([default_config(records)], "seed")
        # the default itself may violate a QoR constraint
        dq = self._verdict(self.default_qor, default_config(records))
        if seed_trials and dq is not None:
            for tr in seed_trials:
                # the profiling run measured the defaults: that is a
                # real result, record it for sibling/future tunes
                self._record_result(tr, dq, 0.0, {})
                self._maybe_new_best(tuner.tell(tr, dq))
        else:
            queue.extend(seed_trials)
        # user-provided seed configurations (--seed-configuration):
        # merged over the declared defaults (a partial file is valid,
        # like the reference's manipulator load), injected as 'seed'
        # trials and evaluated ahead of any technique batch
        if self.seed_configs:
            defaults = default_config(records)
            merged = []
            for cfg in self.seed_configs:
                unknown = sorted(set(cfg) - set(defaults))
                if unknown:
                    log.warning("[ut] seed configuration: ignoring "
                                "unknown parameter(s) %s", unknown)
                merged.append({**defaults,
                               **{k: v for k, v in cfg.items()
                                  if k in defaults}})
            queue.extend(tuner.inject(merged, "seed"))
        queue.extend(self._host_proposals(space))
        pre_launch = None
        if self.template is not None:
            name = os.path.basename(self.template.path)
            tpl = self.template

            def pre_launch(sb, index, trial):
                tpl.render_to(os.path.join(sb, name), trial.config)

        t0 = time.time()
        dry_asks = 0
        # gid of a queue head already looked up and missed while every
        # slot was busy: don't re-hash it each poll iteration (reset
        # when a refresh merges new rows — the answer may have changed)
        miss_gid = -1
        with WorkerPool(self.command, self.work_dir, self.parallel,
                        runtime_limit=self.runtime_limit,
                        env=self.env_extra,
                        sandbox=self.use_sandbox,
                        pre_launch=pre_launch,
                        # multi-host replicas share work_dir: namespace
                        # the sandbox slots (and thereby the per-slot
                        # config hand-off files) per replica, or two
                        # replicas' workers read each other's configs
                        slot_prefix=(f"{self.host_tag[1:]}."
                                     if self.host_tag else "")) as pool:
            self.pool = pool
            while True:
                # 1. refill freed slots INSTANTLY from the prefetched
                # queue — no device work on this path.  Gate on told
                # (per-trial), not evals (per-ticket): a wide in-flight
                # ticket must still count against the budget, or a
                # --test-limit 25 run launches 50+ trials.  A trial
                # whose config the store already holds is served INLINE
                # (no slot, no build): the recorded QoR flows through
                # tell() with full accounting, and the loop keeps
                # draining — store hits don't wait for free slots
                while queue and tuner.told + pool.busy_count < limit:
                    head = queue[0]
                    hit = (store.lookup(head.config)
                           if store is not None and head.gid != miss_gid
                           else None)
                    if hit is not None:
                        self.store_hits += 1
                        self._serve_hit(queue.popleft(), hit, queue)
                        continue
                    if not pool.n_free:
                        miss_gid = head.gid
                        break
                    pool.submit(queue.popleft(), stage=self.stage)
                # 2. speculative prefetch: top the queue back up to
                # `prefetch` trials while every slot is busy building,
                # so the propose+dedup device programs and config
                # materialization hide entirely behind build wall-clock
                outstanding = pool.busy_count + len(queue)
                depth = max(self.prefetch, pool.n_free)
                if (tuner.told + outstanding < limit
                        and len(queue) < depth
                        and dry_asks < 8):
                    want = min(depth - len(queue),
                               limit - tuner.told - outstanding)
                    asked = tuner.ask(min_trials=want)
                    queue.extend(asked)
                    obs.gauge("prefetch.depth", len(queue))
                    dry_asks = 0 if asked else dry_asks + 1
                    if asked and pool.n_free:
                        continue  # launch the fresh trials before polling
                # multi-instance exchange: pick up sibling instances'
                # freshly appended rows (time-gated re-scan) and pull
                # in their best when it beats ours
                if store is not None and store.maybe_refresh():
                    miss_gid = -1   # new rows: head may hit now
                    self._maybe_exchange_best(queue)
                if pool.busy_count == 0:
                    if tuner.told >= limit:
                        break
                    if not queue and dry_asks >= 8:
                        break  # space saturated: nothing left to propose
                for trial, qor, dur, info in pool.poll(self.interval):
                    self._record_result(trial, qor, dur, info)
                    qor = self._verdict(qor, trial.config)
                    stats = tuner.tell(trial, qor, dur)
                    if qor is not None:
                        self._host_history.append((trial.config, qor))
                    if stats is not None and stats.was_new_best \
                            and self.prefetch:
                        # a new best invalidates speculative technique
                        # tickets proposed around the stale incumbent:
                        # withdraw the un-launched ones so the refill
                        # proposes against the new best instead
                        # (prefetch=0 keeps the legacy fire-everything
                        # behavior)
                        self.spec_cancelled += self._cancel_speculative(
                            queue, tuner)
                    self._maybe_new_best(stats)
                    self._status(qor)
                if wall_limit and time.time() - t0 > wall_limit:
                    for trial, qor, dur, info in pool.drain(
                            timeout=self.runtime_limit):
                        self._record_result(trial, qor, dur, info)
                        tuner.tell(trial, self._verdict(
                            qor, trial.config), dur)
                    break
            # withdraw trials still queued (never launched): no archive
            # rows, no failure penalty — the limit simply arrived first
            while queue:
                tuner.cancel(queue.popleft())
            # the async-pipeline scoreboard (docs/PERF.md): slot-seconds
            # spent building vs driver overhead the prefetch failed to
            # hide behind them
            log.info(
                "[ut] pool utilization=%.2f (driver t_propose=%.2fs "
                "t_dedup=%.2fs behind t_eval_wait=%.1fs; speculative "
                "cancels=%d)", pool.utilization(),
                tuner.t_propose_total, tuner.t_dedup_total,
                tuner.t_eval_wait_total, self.spec_cancelled)
            if store is not None:
                log.info(
                    "[ut] store: %d build(s) eliminated by cache hits, "
                    "%d launched, %d exchange trial(s) ingested, %d "
                    "row(s) federated (%s)",
                    self.store_hits, pool.launched,
                    self.exchange_injected, self.federated_rows,
                    store.stats())
        res = tuner.result()
        if res.best_config:
            write_best(res.best_config, res.best_qor,
                       work_dir=self.work_dir)
        tuner.close()
        if store is not None:
            store.close()
        return res
