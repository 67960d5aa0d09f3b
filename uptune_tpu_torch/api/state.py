"""Process-side protocol state for user programs under tuning.

A user program importing `uptune_tpu_torch as ut` (or the JAX package:
the protocol is the same, byte for byte) runs in one of four modes,
selected by environment variables — the same env protocol as the reference
(`python/uptune/template/types.py:57-138`, `api.py:861-868`,
`src/uptune.h:21-26`):

==================  =======================================================
(none)              DEFAULT: `ut.tune()` returns its default value
UT_BEFORE_RUN_PROFILE  ANALYSIS: record the search space; `ut.target()`
                    flushes it to ut.params.json + ut.default_qor.json
UT_TUNE_START       TUNE: `ut.tune()` serves values from the proposal JSON
                    published by the controller for (stage, index)
BEST                BEST: serve values from best.json (apply_best)
==================  =======================================================

Proposal lookup is by the reference's order-dependent positional counter
(`types.py:132-134`): the k-th `ut.tune()` call binds to the k-th recorded
parameter.  The controller additionally publishes a name-keyed map, and we
look up by *name first*, falling back to position — robust when names are
given, compatible when not.

Deliberate divergences from the reference protocol (the controller in
`uptune_tpu_torch.exec` is written against THIS contract):
  * work dir env var is ``UT_WORK_DIR`` (reference: ``UT_TEMP_DIR``,
    api.py:94) — one variable for both roles.
  * proposal files are ``configs/ut.dr_stage{S}_index{I}.json``
    (reference: ``configs/{stage}-{index}.json``) — self-describing names.
"""
from __future__ import annotations

import json
import os
import sys
from typing import Any, Dict, List, Optional

DEFAULT, ANALYSIS, TUNE, BEST = "default", "analysis", "tune", "best"

PARAMS_FILE = "ut.params.json"
DEFAULT_QOR_FILE = "ut.default_qor.json"
BEST_FILE = "best.json"


def _truthy(v: Optional[str]) -> bool:
    return bool(v) and v.lower() not in ("0", "false", "off", "")


class _ProtocolState:
    """Singleton holding the per-process run state."""

    def __init__(self):
        self.reset()

    def reset(self):
        self.mode = self._detect_mode()
        if self.mode == TUNE:
            # trace-context propagation (docs/OBSERVABILITY.md): a
            # traced driver exports UT_TRACE_SIDECAR into the sandbox
            # env; this child then records its own spans and dumps
            # them at exit for the reap-time merge.  Inert (one env
            # check) for untraced runs.
            from ..obs import sidecar
            sidecar.maybe_init_child()
        self.work_dir = os.environ.get("UT_WORK_DIR", os.getcwd())
        self.index = int(os.environ.get("UT_CURR_INDEX", "0"))
        self.stage = int(os.environ.get("UT_CURR_STAGE", "0"))
        self.global_id = int(os.environ.get("UT_GLOBAL_ID", "0"))
        # ANALYSIS: recorded per-stage param specs
        self.recorded: List[List[Dict[str, Any]]] = [[]]
        # TUNE/BEST: per-stage counters + loaded proposal
        self.count = 0
        self.cur_stage = 0          # which ut.target breakpoint we're in
        self.proposal: Optional[Dict[str, Any]] = None
        self.params_meta: Optional[List[List[Dict[str, Any]]]] = None
        self.qor_records: List[Any] = []
        self.features: List[Any] = []
        self.interm_feats: List[Any] = []

    @staticmethod
    def _detect_mode() -> str:
        env = os.environ
        if _truthy(env.get("UT_BEFORE_RUN_PROFILE")):
            return ANALYSIS
        if _truthy(env.get("UT_TUNE_START")):
            return TUNE
        if _truthy(env.get("BEST")):
            return BEST
        return DEFAULT

    # ------------------------------------------------------------------
    # ANALYSIS side
    def record_param(self, rec: Dict[str, Any]) -> None:
        while len(self.recorded) <= self.cur_stage:
            self.recorded.append([])
        stage = self.recorded[self.cur_stage]
        rec = dict(rec)
        if not rec.get("name"):
            rec["name"] = f"v{self.cur_stage}_{len(stage)}"
        names = {r["name"] for st in self.recorded for r in st}
        if rec["name"] in names:
            raise ValueError(
                f"duplicate tunable parameter name {rec['name']!r}")
        stage.append(rec)

    def flush_params(self) -> None:
        # atomic (tmp + rename): multi-host replicas may run their
        # analysis passes concurrently in one work_dir; a torn
        # ut.params.json read by the sibling would crash its space build
        path = os.path.join(self.work_dir, PARAMS_FILE)
        tmp = path + f".tmp{os.getpid()}"
        with open(tmp, "w") as f:
            json.dump(self.recorded, f, indent=1)
        os.replace(tmp, path)

    # ------------------------------------------------------------------
    # TUNE side
    def _load_params_meta(self) -> None:
        """Load ut.params.json (if present) for positional binding."""
        ppath = os.path.join(self.work_dir, PARAMS_FILE)
        if os.path.exists(ppath):
            with open(ppath) as f:
                self.params_meta = json.load(f)

    def _load_proposal(self) -> None:
        from .. import obs
        cfg_dir = os.path.join(self.work_dir, "configs")
        path = os.path.join(
            cfg_dir, f"ut.dr_stage{self.stage}_index{self.index}.json")
        with obs.span("child.load_proposal", stage=self.stage):
            with open(path) as f:
                self.proposal = json.load(f)
            self._load_params_meta()
        # merge best configs of earlier stages (template/access.py:19-25,
        # types.py:124-129): stage s trials replay stages < s from their
        # published best
        for s in range(self.stage):
            bpath = os.path.join(cfg_dir, f"{s}-best.json")
            if os.path.exists(bpath):
                with open(bpath) as f:
                    prev = json.load(f)
                for k, v in prev.items():
                    self.proposal.setdefault(k, v)

    def _load_best(self) -> None:
        path = os.path.join(self.work_dir, BEST_FILE)
        with open(path) as f:
            best = json.load(f)
        # controller writes {"config": {...}, "qor": q}; also accept a
        # bare config dict or the reference's [config, qor] list shape
        if isinstance(best, dict):
            self.proposal = best.get("config", best)
        elif (isinstance(best, list) and len(best) == 2
              and isinstance(best[0], dict)):
            self.proposal = best[0]
        else:
            raise ValueError(f"unrecognized best.json payload: {best!r}")
        # params metadata enables the positional-counter fallback for
        # unnamed ut.tune() calls (the reference's common style,
        # types.py:132-134) in BEST mode too
        self._load_params_meta()

    def next_value(self, name: Optional[str], default: Any) -> Any:
        """Serve the value for the next ut.tune() call."""
        if self.proposal is None:
            try:
                (self._load_best if self.mode == BEST
                 else self._load_proposal)()
            except (OSError, json.JSONDecodeError, ValueError):
                return default  # no/bad published config: run as default
        key = None
        if name and name in self.proposal:
            key = name
        elif self.params_meta is not None:
            # positional counter within the current stage (types.py:132-134)
            stage_params = (self.params_meta[self.cur_stage]
                            if self.cur_stage < len(self.params_meta) else [])
            if self.count < len(stage_params):
                key = stage_params[self.count]["name"]
        self.count += 1
        if key is None or key not in self.proposal:
            return default
        return self.proposal[key]

    # ------------------------------------------------------------------
    # QoR side
    def write_qor_row(self, index: int, value: Any, trend: str) -> None:
        """Append an [index, val, trend] row to the current stage's QoR
        file (the reference's row shape, report.py:62-79); multi-stage
        breakpoint control flow lives in report.target."""
        path = os.path.join(self.work_dir,
                            f"ut.qor_stage{self.cur_stage}.json")
        rows = []
        if os.path.exists(path):
            try:
                with open(path) as f:
                    rows = json.load(f)
            except json.JSONDecodeError:
                rows = []
        rows.append([index, value, trend])
        with open(path, "w") as f:
            json.dump(rows, f)

    def write_default_qor(self, value: Any, trend: str) -> None:
        path = os.path.join(self.work_dir, DEFAULT_QOR_FILE)
        tmp = path + f".tmp{os.getpid()}"
        with open(tmp, "w") as f:
            json.dump({"qor": value, "trend": trend,
                       "stage": self.cur_stage}, f)
        os.replace(tmp, path)


STATE = _ProtocolState()
