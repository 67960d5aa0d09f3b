"""Sandboxed subprocess worker pool for black-box program evaluation.

Replaces the reference's Ray actor pool (`python/uptune/
api.py:813-910` RunProgram + the free-list dispatch `api.py:458-554` and
dead-actor replacement `api.py:668-679`) with plain POSIX process
supervision:

* each worker slot owns a sandbox dir (`ut.temp/temp.{i}`) populated
  with symlinks to the work dir's files (api.py:104-125 prepare_workdir),
  so concurrent trials never collide on build artifacts;
* a trial is submitted by publishing its config JSON into the sandbox
  (`configs/ut.dr_stage{S}_index{I}.json`, the publish side of
  async_task_scheduler.py:315-338) and launching the user command with
  the UT_* env protocol;
* poll() sweeps slots: completed runs have their QoR file parsed (and
  the `ut.feature` covariates and `ut.interm` vector the child wrote
  read into the result's info), timed-out runs are process-group-killed
  and their sandbox rebuilt (the dead-worker replacement semantics).

With tracing on, each build is a `pool.build` span on its slot's lane
(`worker-<prefix><i>`), the child's own spans come back through a
per-sandbox trace sidecar merged onto that lane at reap
(`obs.sidecar`), and with the journal on the child's covariates and
feature vector become `feature` / `interm` rows, as in the JAX pool.
"""
from __future__ import annotations

import json
import os
import shutil
import subprocess
import time
from typing import Any, Dict, List, Optional, Tuple

from .. import obs
from ..api.report import COVARS_FILE, FEATURES_FILE
from ..obs import faults, sidecar
from .measure import kill_process_group, popen_kw

PROTOCOL_FILES = ("ut.params.json",)   # copied (not symlinked) per sandbox


class _Slot:
    __slots__ = ("index", "sandbox", "proc", "trial", "t0", "t0p",
                 "deadline", "stage", "log_f", "err_f")

    def __init__(self, index: int, sandbox: str):
        self.index = index
        self.sandbox = sandbox
        self.proc: Optional[subprocess.Popen] = None
        self.trial = None
        self.t0 = 0.0
        self.t0p = 0.0       # perf_counter at launch (the build span)
        self.deadline = float("inf")
        self.stage = 0
        self.log_f = None
        self.err_f = None

    @property
    def busy(self) -> bool:
        return self.proc is not None


class WorkerPool:
    """N sandboxed subprocess evaluation slots.

    Parameters
    ----------
    command : str | list
        The user program invocation (run with cwd = the slot sandbox).
    work_dir : str
        Directory holding the user program + protocol files.
    n_workers : int
        Parallel evaluation width (the reference's --parallel-factor).
    runtime_limit : float | None
        Per-trial wall-clock limit in seconds (api.py:25-28 default 7200).
    env : dict | None
        Extra environment for every trial (merged over os.environ).
    memory_limit : int | None
        Per-trial address-space cap in bytes (setrlimit).
    sandbox : bool
        If False, all slots share work_dir directly (only safe for
        parallel=1 or read-only programs).
    """

    def __init__(self, command, work_dir: str, n_workers: int = 2, *,
                 runtime_limit: Optional[float] = 7200.0,
                 env: Optional[Dict[str, str]] = None,
                 memory_limit: Optional[int] = None,
                 sandbox: bool = True,
                 pre_launch=None,
                 result_parser=None,
                 slot_prefix: str = ""):
        # pre_launch(sandbox_dir, slot_index, trial) runs after the config
        # publish and before the subprocess starts — template mode renders
        # the per-trial source file here (src/single_stage.py:26-27)
        self.pre_launch = pre_launch
        # result_parser(sandbox_dir, stage) -> value|None overrides the
        # default QoR-file parse (multi-stage 'pre' phases read feature
        # vectors instead, src/multi_stage.py:88-102)
        self.result_parser = result_parser
        # slot_prefix namespaces sandbox dirs so several pools (one per
        # pipeline stage in decouple mode) share one work dir
        self.slot_prefix = slot_prefix
        self.command = command
        self.work_dir = os.path.abspath(work_dir)
        self.n_workers = int(n_workers)
        self.runtime_limit = runtime_limit
        self.env_extra = dict(env or {})
        self.memory_limit = memory_limit
        self.use_sandbox = sandbox
        self.temp_root = os.path.join(self.work_dir, "ut.temp")
        self.replaced = 0          # dead-worker replacements performed
        self.launched = 0
        self.busy_s = 0.0          # summed per-trial wall time (reaped)
        self._t_started = time.time()
        self._slots: List[_Slot] = []

    # ------------------------------------------------------------------
    def start(self) -> "WorkerPool":
        os.makedirs(self.temp_root, exist_ok=True)
        self._slots = [
            _Slot(i, self._build_sandbox(i)) for i in range(self.n_workers)]
        self._t_started = time.time()
        return self

    def _build_sandbox(self, index: int) -> str:
        if not self.use_sandbox:
            os.makedirs(os.path.join(self.work_dir, "configs"),
                        exist_ok=True)
            return self.work_dir
        path = os.path.join(self.temp_root,
                            f"temp.{self.slot_prefix}{index}")
        if os.path.isdir(path):
            shutil.rmtree(path)
        os.makedirs(os.path.join(path, "configs"))
        for name in os.listdir(self.work_dir):
            # protocol outputs (ut.*) stay per-sandbox; everything else is
            # shared read-only via symlink (api.py:113-123)
            if name.startswith("ut.") or name == "configs":
                continue
            os.symlink(os.path.join(self.work_dir, name),
                       os.path.join(path, name))
        for name in PROTOCOL_FILES:
            src = os.path.join(self.work_dir, name)
            if os.path.isfile(src):
                shutil.copy(src, os.path.join(path, name))
        return path

    def _replace_sandbox(self, slot: _Slot) -> None:
        """Rebuild a slot after a kill — the dead-worker replacement
        (api.py:668-679: delete the actor, create a fresh one)."""
        self.replaced += 1
        slot.sandbox = self._build_sandbox(slot.index)

    # ------------------------------------------------------------------
    def free_slots(self) -> List[int]:
        return [s.index for s in self._slots if not s.busy]

    @property
    def busy_count(self) -> int:
        return sum(1 for s in self._slots if s.busy)

    @property
    def n_free(self) -> int:
        return sum(1 for s in self._slots if not s.busy)

    def stats(self) -> Dict[str, Any]:
        """Pool-side scoreboard (logs + bench artifacts): launches =
        real builds started (the store's cache hits never reach here),
        dead-worker replacements, slot-seconds spent building, and
        utilization."""
        return {"launched": self.launched, "replaced": self.replaced,
                "busy_s": round(self.busy_s, 4),
                "utilization": round(self.utilization(), 4)}

    def utilization(self) -> float:
        """Fraction of slot-seconds spent running trials since start()
        (reaped trials only).  1.0 = every slot always building; the gap
        to 1.0 is dispatch overhead the driver failed to hide — the
        number async prefetch exists to push up."""
        wall = max(time.time() - self._t_started, 1e-9)
        return min(1.0, self.busy_s / (wall * max(1, self.n_workers)))

    def submit(self, trial, stage: int = 0,
               extra_env: Optional[Dict[str, str]] = None) -> int:
        """Publish the trial's config and launch it on a free slot;
        returns the slot index."""
        free = [s for s in self._slots if not s.busy]
        if not free:
            raise RuntimeError("no free worker slot")
        slot = free[0]
        sb = slot.sandbox
        # clear stale protocol outputs (a previous trial's trace sidecar
        # too: a reused slot must never replay old child spans)
        for name in os.listdir(sb):
            if name.startswith("ut.qor_stage") or name in (
                    FEATURES_FILE, sidecar.SIDECAR_FILE):
                os.unlink(os.path.join(sb, name))
        cfg_path = os.path.join(
            sb, "configs", f"ut.dr_stage{stage}_index{slot.index}.json")
        with open(cfg_path, "w") as f:
            json.dump(trial.config, f)

        env = dict(os.environ)
        env.update(self.env_extra)
        env.update(extra_env or {})
        env.update({
            "UT_TUNE_START": "True",
            "UT_CURR_INDEX": str(slot.index),
            "UT_CURR_STAGE": str(stage),
            "UT_GLOBAL_ID": str(trial.gid),
            "UT_WORK_DIR": sb,
        })
        env.pop("UT_BEFORE_RUN_PROFILE", None)
        # trace-context propagation: when the driver traces, the child
        # records its own spans and dumps them to a per-sandbox sidecar
        # merged back at reap.  Popped first, so a stale path from an
        # enclosing traced run never leaks into an untraced child
        env.pop(sidecar.SIDECAR_ENV, None)
        if obs.enabled():
            env[sidecar.SIDECAR_ENV] = os.path.join(
                sb, sidecar.SIDECAR_FILE)
        if self.pre_launch is not None:
            self.pre_launch(sb, slot.index, trial)
        slot.log_f = open(os.path.join(sb, "ut.run.log"), "w")
        slot.err_f = open(os.path.join(sb, "ut.run.err"), "w")
        slot.proc = subprocess.Popen(
            self.command, shell=isinstance(self.command, str), cwd=sb,
            env=env, stdout=slot.log_f, stderr=slot.err_f,
            **popen_kw(self.memory_limit))
        slot.trial = trial
        slot.t0 = time.time()
        slot.t0p = time.perf_counter()
        slot.deadline = (slot.t0 + self.runtime_limit
                         if self.runtime_limit else float("inf"))
        slot.stage = stage
        self.launched += 1
        obs.count("pool.launched")
        obs.gauge("pool.busy", self.busy_count)
        return slot.index

    # ------------------------------------------------------------------
    def _parse_qor(self, slot: _Slot) -> Optional[float]:
        """Last [index, val, trend] row of the stage QoR file, or None."""
        path = os.path.join(slot.sandbox,
                            f"ut.qor_stage{slot.stage}.json")
        try:
            with open(path) as f:
                rows = json.load(f)
            return float(rows[-1][1])
        except (OSError, json.JSONDecodeError, IndexError, TypeError,
                ValueError):
            return None

    def _reap(self, slot: _Slot, *, killed: bool) -> Tuple[Any, Optional[
            float], float, Dict[str, Any]]:
        faults.fire("pool.reap")
        dur = time.time() - slot.t0
        self.busy_s += dur
        rc = slot.proc.returncode
        for f in (slot.log_f, slot.err_f):
            if f is not None:
                f.close()
        qor = None
        if not killed and rc == 0:
            qor = (self.result_parser(slot.sandbox, slot.stage)
                   if self.result_parser is not None
                   else self._parse_qor(slot))
        info = {"returncode": rc, "timeout": killed, "slot": slot.index,
                "sandbox": slot.sandbox, **self._child_rows(slot)}
        trial = slot.trial
        # the build window on this slot's lane, emitted at reap with the
        # slot's own launch time on the perf_counter timebase: store-hit
        # trials never reach a slot, so their absence from the worker
        # lanes is the bypass made visible
        pdur = time.perf_counter() - slot.t0p
        lane = f"worker-{self.slot_prefix}{slot.index}"
        obs.complete_span(
            "pool.build", t0=slot.t0p, dur=pdur, track=lane,
            gid=getattr(trial, "gid", None), rc=rc, timeout=killed)
        # the child's sidecar spans nest inside the build window on the
        # same lane (clock-offset aligned; a killed child usually left
        # none)
        n_child = sidecar.merge_into(
            os.path.join(slot.sandbox, sidecar.SIDECAR_FILE), lane)
        if n_child:
            obs.count("pool.sidecar_events", n_child)
        obs.observe("pool.build_s", pdur)
        obs.gauge("pool.utilization", self.utilization())
        if obs.journal.enabled():
            gid = getattr(trial, "gid", None)
            if "covars" in info:
                obs.journal.emit("feature", gid=gid, covars=info["covars"])
            if "interm" in info:
                obs.journal.emit("interm", gid=gid, feats=info["interm"])
        if killed:
            obs.count("pool.timeouts")
        slot.proc = slot.trial = slot.log_f = slot.err_f = None
        slot.deadline = float("inf")
        if killed:
            self._replace_sandbox(slot)
        return trial, qor, dur, info

    @staticmethod
    def _child_rows(slot: _Slot) -> Dict[str, Any]:
        """The trial's `ut.feature` covariates (``covars``) and its
        `ut.interm` feature vector (``interm``), as the child persisted
        them to its sandbox (api/report.py); the reference fed exactly
        these rows to its QoR estimator.  `ut.features.json` is cleared
        at submit, so whatever is there came from THIS trial;
        covars.json accumulates per sandbox by design — the current dict
        is the trial's observed state.  Unreadable or absent files are
        routine (most programs call neither API) and leave the key out."""
        out: Dict[str, Any] = {}
        try:
            with open(os.path.join(slot.sandbox, COVARS_FILE)) as f:
                covars = json.load(f)
            if isinstance(covars, dict) and covars:
                out["covars"] = covars
        except (OSError, json.JSONDecodeError):
            pass
        try:
            with open(os.path.join(slot.sandbox, FEATURES_FILE)) as f:
                rows = json.load(f)
            # [[index, feats]] (api/report.py interm): the vector of the
            # last (only) row
            if rows and isinstance(rows[-1], list) and len(rows[-1]) == 2:
                out["interm"] = list(rows[-1][1])
        except (OSError, json.JSONDecodeError):
            pass
        return out

    def poll(self, timeout: float = 0.05
             ) -> List[Tuple[Any, Optional[float], float, Dict[str, Any]]]:
        """Collect finished/timed-out trials, waiting up to `timeout`
        seconds for at least one if any slot is busy.  Each result is
        (trial, qor | None, wall_time, info)."""
        results = []
        deadline = time.time() + timeout
        while True:
            now = time.time()
            for slot in self._slots:
                if not slot.busy:
                    continue
                if slot.proc.poll() is not None:
                    results.append(self._reap(slot, killed=False))
                elif now > slot.deadline:
                    kill_process_group(slot.proc)
                    results.append(self._reap(slot, killed=True))
            if results or now >= deadline or self.busy_count == 0:
                return results
            time.sleep(min(0.01, max(0.0, deadline - time.time())))

    def drain(self, timeout: Optional[float] = None) -> List[Tuple[
            Any, Optional[float], float, Dict[str, Any]]]:
        """Wait for every busy slot to resolve (bounded by per-trial
        deadlines, plus `timeout` overall if given)."""
        out = []
        t_end = time.time() + timeout if timeout else None
        while self.busy_count:
            out.extend(self.poll(0.1))
            if t_end and time.time() > t_end:
                break
        return out

    def shutdown(self) -> None:
        for slot in self._slots:
            if slot.busy:
                kill_process_group(slot.proc)
                self._reap(slot, killed=True)

    def __enter__(self):
        return self.start()

    def __exit__(self, *exc):
        self.shutdown()
