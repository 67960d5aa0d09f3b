"""QoR reporting + metadata API: `ut.target`, `ut.interm`, `ut.feature`,
`ut.save`, `ut.get_global_id`, `ut.get_local_id`, `ut.get_meta_data`.

Behavioral spec from the reference (`python/uptune/
report.py:45-201`), re-built on the explicit per-process protocol state in
`uptune_tpu_torch.api.state` instead of class-attribute globals:

* ``target(val, 'min'|'max')`` —
  ANALYSIS: flush the recorded search space to ``ut.params.json``, record
  the default QoR, and advance the stage counter (each `target` call marks
  a stage boundary, so multi-stage spaces are discovered in one profiling
  run).
  TUNE, single-stage: append ``[index, val, trend]`` to
  ``ut.qor_stage0.json`` and keep running.
  TUNE, multi-stage: acts as a breakpoint (report.py:69-79) — when the
  program reaches the stage being tuned (``UT_CURR_STAGE``) it writes the
  stage QoR and exits 0; earlier breakpoints just advance the stage
  counter (resetting the positional counter for the next stage's
  ``ut.tune`` calls).

* ``interm(features)`` — intermediate feature vector for the multi-stage
  surrogate filter; under ``UT_MULTI_STAGE_SAMPLE`` the call is the 'pre'
  phase breakpoint (report.py:85-103).

* ``feature(val, name)`` — covariate registration (report.py:187-201),
  persisted to ``covars.json`` in the work dir.

* ``save(objective)`` — decorator reporting a function's return value as
  the target QoR (report.py:35-43).
"""
from __future__ import annotations

import functools
import json
import os
import sys
from typing import Any, Callable, Optional, Sequence

from .state import ANALYSIS, BEST, STATE, TUNE

INTERIM_FILE = "ut.interim_features.json"
FEATURES_FILE = "ut.features.json"
COVARS_FILE = "covars.json"


def _check_qor(val: Any, objective: str) -> float:
    if isinstance(val, bool) or not isinstance(val, (int, float)):
        raise TypeError(f"QoR must be a real number, got {val!r}")
    if objective not in ("min", "max"):
        raise ValueError(f"objective must be 'min' or 'max', "
                         f"got {objective!r}")
    return float(val)


def target(val: Any, objective: str = "min") -> Any:
    """Register the target QoR of this run; returns `val` unchanged."""
    qor = _check_qor(val, objective)
    mode = STATE.mode
    if mode == ANALYSIS:
        # each target() call closes one stage of the space discovery
        STATE.flush_params()
        STATE.write_default_qor(qor, objective)
        STATE.cur_stage += 1
        STATE.count = 0
    elif mode == TUNE:
        # lands in the trial's trace sidecar (when the driver traces):
        # the moment the user program produced its QoR, visible inside
        # the slot's build window after the reap-time merge
        from .. import obs
        obs.event("child.target", qor=qor, stage=STATE.cur_stage)
        n_stages = (len(STATE.params_meta) if STATE.params_meta
                    else max(1, len(STATE.recorded)))
        if n_stages <= 1:
            STATE.write_qor_row(STATE.index, qor, objective)
        else:
            # multi-stage breakpoint semantics
            if STATE.cur_stage == STATE.stage:
                STATE.write_qor_row(STATE.index, qor, objective)
                sys.exit(0)
            if STATE.cur_stage > STATE.stage:
                raise RuntimeError(
                    f"breakpoint past the tuned stage: at stage "
                    f"{STATE.cur_stage}, tuning stage {STATE.stage}")
            STATE.cur_stage += 1
            STATE.count = 0
    elif mode == BEST:
        # no QoR write, but stage/counter bookkeeping must still advance
        # so unnamed params in stages >= 1 bind positionally
        STATE.cur_stage += 1
        STATE.count = 0
    return val


def save(objective: str = "min") -> Callable:
    """Decorator: report the wrapped function's return value via target."""
    def decorator(fn: Callable) -> Callable:
        @functools.wraps(fn)
        def run(*args, **kwargs):
            return target(fn(*args, **kwargs), objective)
        return run
    return decorator


def interm(features: Sequence[Any], shape: Optional[int] = None):
    """Report an intermediate feature vector (multi-stage 'pre' phase)."""
    feats = list(features)
    if shape is not None and len(feats) != shape:
        raise ValueError(f"feature shape mismatch: {len(feats)} != {shape}")
    mode = STATE.mode
    path = os.path.join(STATE.work_dir, FEATURES_FILE)
    if mode == ANALYSIS:
        # marker file whose presence selects multi-stage mode
        # (async_task_scheduler.py:465-474)
        with open(os.path.join(STATE.work_dir, INTERIM_FILE), "w") as f:
            json.dump({"shape": len(feats)}, f)
        with open(path, "w") as f:
            json.dump([[-1, feats]], f)
    elif mode == TUNE:
        with open(path, "w") as f:
            json.dump([[STATE.index, feats]], f)
        # rides the trial's trace sidecar when the driver traces (like
        # child.target); the persisted file above is what the reap path
        # reads into the tuning journal (exec/pool.py)
        from .. import obs
        obs.event("child.interm", n=len(feats), stage=STATE.cur_stage)
        if os.environ.get("UT_MULTI_STAGE_SAMPLE"):
            sys.exit(0)  # 'pre'-phase breakpoint
    return features


def feature(val: Any, name: str) -> Any:
    """Register a named covariate observed by this run."""
    from . import constraint as _c
    path = os.path.join(STATE.work_dir, COVARS_FILE)
    data = {}
    if os.path.exists(path):
        try:
            with open(path) as f:
                data = json.load(f)
        except json.JSONDecodeError:
            data = {}
    # register in every mode: ut.vars.<name> bounds must resolve during
    # TUNE/BEST trials too, not only in the analysis run
    _c.register(name, val)
    data[name] = val
    with open(path, "w") as f:
        json.dump(data, f)
    if STATE.mode == TUNE:
        # sidecar visibility for traced runs; the journal row itself is
        # emitted by the driver at reap from the file just written
        from .. import obs
        obs.event("child.feature", covar=str(name))
    return val


def get_global_id():
    """Global trial id under tuning; 'base' outside a tuning run."""
    if os.environ.get("UT_TUNE_START"):
        return STATE.global_id
    return "base"


def get_local_id() -> Optional[int]:
    """Worker-slot index under tuning; None outside a tuning run."""
    if os.environ.get("UT_TUNE_START"):
        return STATE.index
    return None


def get_meta_data(key: str) -> Optional[str]:
    """Read a protocol env var; UT_WORK_DIR falls back to cwd."""
    val = os.environ.get(key)
    if val is not None:
        return val
    if key == "UT_WORK_DIR":
        return os.getcwd()
    raise RuntimeError(f"no metadata {key!r}: program not under tuning")
