"""Multi-stage tuning modes.

Two distinct modes, auto-selected like the reference
(`python/uptune/src/async_task_scheduler.py:465-474`), ported from the
JAX package's `exec/multistage.py`:

* **DecoupledTuner** — the program declares >1 `ut.target` breakpoint
  (>1 stage in ut.params.json).  Each pipeline stage gets its own Tuner +
  WorkerPool and all stages tune concurrently; a stage-s trial replays
  stages < s from their current best configs (the best-config stack,
  async_task_scheduler.py:106-145 + 117-126), published as
  `configs/{s}-best.json`.

* **MultiStageTuner** — the program declares an `ut.interm(features)`
  checkpoint (marker file ut.interim_features.json).  Tuning runs in
  surrogate-filtered epochs (src/multi_stage.py:50-165): a candidate pool
  of cand_factor x parallel proposals runs the cheap 'pre' phase to the
  interm breakpoint, a feature-space surrogate scores the emitted
  vectors, only `parallel` survivors run the full 'post' phase, and the
  surrogate retrains online on (features, QoR) pairs.
"""
from __future__ import annotations

import json
import logging
import os
import shutil
import time
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from .. import rng
from ..api.session import write_best
from ..device import DeviceLike, resolve_device
from ..driver.driver import TuneResult, Tuner
from .controller import ProgramTuner
from .pool import WorkerPool
from .space_io import default_config, space_from_params

log = logging.getLogger("uptune_tpu_torch")

INTERIM_FILE = "ut.interim_features.json"
FEATURES_FILE = "ut.features.json"


def select_mode(pt: ProgramTuner) -> str:
    """'decouple' | 'multistage' | 'single' (a_t_s.py:465-474)."""
    if pt.params is not None and len(pt.params) > 1:
        return "decouple"
    if os.path.isfile(os.path.join(pt.work_dir, INTERIM_FILE)):
        return "multistage"
    return "single"


def run_auto(pt: ProgramTuner) -> TuneResult:
    """Analyze (if needed) and dispatch to the right mode."""
    if pt.params is None:
        pt.analyze()
    mode = select_mode(pt)
    if mode == "decouple":
        return DecoupledTuner(pt).run()
    if mode == "multistage":
        return MultiStageTuner(pt).run()
    return pt.run()


# ---------------------------------------------------------------------
class _Stage:
    def __init__(self, index: int, records, tuner: Tuner,
                 pool: WorkerPool):
        self.index = index
        self.records = records
        self.tuner = tuner
        self.pool = pool
        self.queue: List = []
        self.dry_asks = 0
        self.best_published: Optional[float] = None


class DecoupledTuner:
    """Stage-parallel pipeline tuning over one ProgramTuner's program."""

    def __init__(self, pt: ProgramTuner):
        if pt.params is None:
            pt.analyze()
        if len(pt.params) < 2:
            raise ValueError("decouple mode needs >= 2 stages")
        self.pt = pt
        self.work_dir = pt.work_dir
        os.makedirs(os.path.join(self.work_dir, "configs"), exist_ok=True)

    def _publish_stage_best(self, stage: _Stage) -> None:
        """Push a stage's best config onto the best-config stack
        (a_t_s.py:117-126) for downstream stages to replay."""
        res = stage.tuner.result()
        if not res.best_config:
            return
        if stage.best_published is not None and \
                res.best_qor >= stage.best_published:
            return
        stage.best_published = res.best_qor
        path = os.path.join(self.work_dir, "configs",
                            f"{stage.index}-best.json")
        with open(path, "w") as f:
            json.dump(res.best_config, f)

    def _pre_launch(self, stage_idx: int):
        """Sandboxes need the upstream best-config stack + any template
        render."""
        tpl = self.pt.template
        tpl_name = (os.path.basename(tpl.path) if tpl else None)

        def hook(sb, index, trial):
            for t in range(stage_idx):
                src = os.path.join(self.work_dir, "configs",
                                   f"{t}-best.json")
                if os.path.isfile(src):
                    shutil.copy(src, os.path.join(sb, "configs",
                                                  f"{t}-best.json"))
            if tpl is not None:
                tpl.render_to(os.path.join(sb, tpl_name), trial.config)
        return hook

    def run(self, test_limit: Optional[int] = None,
            time_limit: Optional[float] = None) -> TuneResult:
        pt = self.pt
        limit = int(test_limit if test_limit is not None
                    else pt.test_limit)
        wall = time_limit if time_limit is not None else pt.timeout
        stages: List[_Stage] = []
        try:
            for s, records in enumerate(pt.params):
                tuner = Tuner(
                    space_from_params(records), None,
                    technique=pt.technique, seed=pt.seed + s,
                    sense=pt.sense,
                    archive=os.path.join(self.work_dir,
                                         f"ut.archive_stage{s}.jsonl"),
                    resume=pt.resume, hooks=pt.hooks,
                    label=f"stage{s}", device=pt.device)
                pool = WorkerPool(
                    pt.command, self.work_dir, pt.parallel,
                    runtime_limit=pt.runtime_limit, env=pt.env_extra,
                    sandbox=pt.use_sandbox, slot_prefix=f"s{s}.",
                    pre_launch=self._pre_launch(s)).start()
                st = _Stage(s, records, tuner, pool)
                st.queue.extend(tuner.inject([default_config(records)],
                                             "seed"))
                stages.append(st)

            t0 = time.time()
            while True:
                progress = False
                for st in stages:
                    tuner, pool = st.tuner, st.pool
                    if (tuner.told + pool.busy_count + len(st.queue)
                            < limit and
                            len(st.queue) < len(pool.free_slots())
                            and st.dry_asks < 8):
                        asked = tuner.ask(
                            min_trials=len(pool.free_slots()))
                        st.queue.extend(asked)
                        st.dry_asks = 0 if asked else st.dry_asks + 1
                    while st.queue and pool.free_slots() and \
                            tuner.told + pool.busy_count < limit:
                        pool.submit(st.queue.pop(0), stage=st.index)
                        progress = True
                    for trial, qor, dur, info in pool.poll(pt.interval):
                        stats = tuner.tell(trial, qor, dur)
                        progress = True
                        if stats is not None and stats.was_new_best:
                            self._publish_stage_best(st)
                done = all(
                    st.tuner.told >= limit or (
                        st.pool.busy_count == 0 and not st.queue
                        and st.dry_asks >= 8)
                    for st in stages) and all(
                    st.pool.busy_count == 0 for st in stages)
                if done or (wall and time.time() - t0 > wall):
                    break
                if not progress:
                    time.sleep(pt.interval)
            for st in stages:
                for trial, qor, dur, info in st.pool.drain(
                        timeout=pt.runtime_limit):
                    st.tuner.tell(trial, qor, dur)
                while st.queue:
                    st.tuner.cancel(st.queue.pop(0))
        finally:
            for st in stages:
                st.pool.shutdown()
                st.tuner.close()

        # merged result: every stage's best params; QoR = final stage's
        merged: Dict[str, Any] = {}
        for st in stages:
            merged.update(st.tuner.result().best_config)
        last = stages[-1].tuner.result()
        res = TuneResult(merged, last.best_qor,
                         sum(st.tuner.evals for st in stages),
                         sum(st.tuner.steps for st in stages),
                         last.trace)
        if merged:
            write_best(merged, res.best_qor, work_dir=self.work_dir)
        return res


# ---------------------------------------------------------------------
class _FeatureSurrogate:
    """GP over program-emitted feature vectors (the reference's XGBoost
    ensemble role, src/multi_stage.py:8-22 score + xgbregressor.py), on
    the port's `surrogate/gp.py` on `device`; the subsample's draws come
    from a key of `rng.py`."""

    def __init__(self, seed: int = 0, max_points: int = 1024,
                 device: DeviceLike = "cuda"):
        from ..surrogate import gp as gp_mod
        self._gp = gp_mod
        self.device = resolve_device(device)
        self._key = rng.key(seed, self.device)
        self.max_points = max_points
        self._xs: List[np.ndarray] = []
        self._ys: List[float] = []
        self._state = None
        self._mu = self._sd = None   # feature z-score stats

    @property
    def fitted(self) -> bool:
        return self._state is not None

    def observe(self, feats, qor: float) -> None:
        if feats is None or not np.isfinite(qor):
            return
        self._xs.append(np.asarray(feats, np.float32))
        self._ys.append(float(qor))

    def refit(self) -> None:
        if len(self._ys) < 8:
            return
        xs = np.stack(self._xs)
        # program features are raw-scale; z-score them so the GP's unit
        # lengthscale prior is meaningful
        self._mu = xs.mean(axis=0)
        self._sd = xs.std(axis=0) + 1e-8
        x = torch.from_numpy(np.ascontiguousarray(
            (xs - self._mu) / self._sd, np.float32)).to(self.device)
        y = torch.from_numpy(np.asarray(self._ys, np.float32)).to(
            self.device)
        self._key, ks = rng.split(self._key, 2)
        n = x.shape[0]
        if n > self.max_points:
            pick = self._gp.draw_subsample(rng.Stream(ks), n,
                                           self.max_points)
            x, y = self._gp.subsample(x, y, self.max_points, pick)
        self._state = self._gp.fit(x, y)

    def scores(self, feats: np.ndarray) -> np.ndarray:
        x = (np.asarray(feats, np.float32) - self._mu) / self._sd
        mean, _ = self._gp.predict(self._state, torch.from_numpy(
            np.ascontiguousarray(x, np.float32)).to(self.device))
        return mean.cpu().numpy()


class MultiStageTuner:
    """Surrogate-filtered pre/post epoch tuning (multirun)."""

    def __init__(self, pt: ProgramTuner, *, cand_factor: int = 6,
                 keep_split: float = 0.5, retrain_interval: int = 2):
        if pt.params is None:
            pt.analyze()
        self.pt = pt
        self.cand_factor = cand_factor       # pool = factor x parallel
        self.keep_split = keep_split         # sample within best split
        self.retrain_interval = retrain_interval
        self.surrogate = _FeatureSurrogate(seed=pt.seed, device=pt.device)
        self._rng = np.random.RandomState(pt.seed)

    @staticmethod
    def _parse_features(sandbox: str, stage: int):
        path = os.path.join(sandbox, FEATURES_FILE)
        try:
            with open(path) as f:
                rows = json.load(f)
            return list(map(float, rows[-1][1]))
        except (OSError, json.JSONDecodeError, IndexError, TypeError,
                ValueError):
            return None

    def _select(self, trials, feats) -> List[int]:
        """Indices of trials promoted to the 'post' phase."""
        k = min(self.pt.parallel, len(trials))
        valid = [i for i, f in enumerate(feats) if f is not None]
        if not valid:
            return []
        if not self.surrogate.fitted:
            return list(self._rng.choice(valid, size=min(k, len(valid)),
                                         replace=False))
        fmat = np.stack([feats[i] for i in valid])
        scores = self.surrogate.scores(fmat)
        order = np.argsort(scores)           # engine orientation: low=good
        split = max(k, int(np.ceil(len(order) * self.keep_split)))
        top = [valid[i] for i in order[:split]]
        picked = self._rng.choice(len(top), size=min(k, len(top)),
                                 replace=False)
        return [top[i] for i in picked]

    def run(self, test_limit: Optional[int] = None,
            time_limit: Optional[float] = None) -> TuneResult:
        pt = self.pt
        limit = int(test_limit if test_limit is not None
                    else pt.test_limit)
        wall = time_limit if time_limit is not None else pt.timeout
        records = pt.params[0]
        space = space_from_params(records)
        tuner = pt._make_tuner(space)
        pt.tuner = tuner

        tpl = pt.template
        tpl_name = os.path.basename(tpl.path) if tpl else None

        def pre_launch(sb, index, trial):
            fpath = os.path.join(sb, FEATURES_FILE)
            if os.path.isfile(fpath):
                os.unlink(fpath)
            if tpl is not None:
                tpl.render_to(os.path.join(sb, tpl_name), trial.config)

        n_pre = pt.parallel * self.cand_factor
        pre_pool = WorkerPool(
            pt.command, pt.work_dir, n_pre,
            runtime_limit=pt.runtime_limit, env=pt.env_extra,
            sandbox=pt.use_sandbox, slot_prefix="pre.",
            pre_launch=pre_launch,
            result_parser=self._parse_features).start()
        post_pool = WorkerPool(
            pt.command, pt.work_dir, pt.parallel,
            runtime_limit=pt.runtime_limit, env=pt.env_extra,
            sandbox=pt.use_sandbox, slot_prefix="post.",
            pre_launch=pre_launch).start()

        # seed: defaults' QoR is known from the profiling run
        seed_trials = tuner.inject([default_config(records)], "seed")
        if seed_trials and pt.default_qor is not None:
            for tr in seed_trials:
                tuner.tell(tr, pt.default_qor)

        t0 = time.time()
        epoch = 0
        feat_of: Dict[int, Any] = {}         # gid -> feature vector
        try:
            while tuner.told < limit:
                epoch += 1
                asked = tuner.ask(min_trials=n_pre)
                # cancel the tail of the last ticket instead of slicing
                # it off: an orphaned (never told/cancelled) trial keeps
                # its whole ticket open forever — evals stalls and its
                # pending hashes are never released
                trials = asked[:n_pre]
                for tr in asked[n_pre:]:
                    tuner.cancel(tr)
                if not trials:
                    break
                # ---- 'pre' phase: run to the interm breakpoint
                for tr in trials:
                    pre_pool.submit(
                        tr, stage=0,
                        extra_env={"UT_MULTI_STAGE_SAMPLE": "1"})
                feats: List[Any] = [None] * len(trials)
                pos = {tr.gid: i for i, tr in enumerate(trials)}
                for trial, fv, dur, info in pre_pool.drain(
                        timeout=pt.runtime_limit):
                    feats[pos[trial.gid]] = fv
                # ---- select survivors, cancel the rest
                chosen = set(self._select(trials, feats))
                post = []
                for i, tr in enumerate(trials):
                    if i in chosen:
                        feat_of[tr.gid] = feats[i]
                        post.append(tr)
                    else:
                        tuner.cancel(tr)
                # ---- 'post' phase: full runs
                for tr in post:
                    post_pool.submit(tr, stage=0)
                for trial, qor, dur, info in post_pool.drain(
                        timeout=pt.runtime_limit):
                    stats = tuner.tell(trial, qor, dur)
                    if qor is not None:
                        self.surrogate.observe(
                            feat_of.pop(trial.gid, None),
                            tuner.sign * qor)
                    pt._maybe_new_best(stats)
                if epoch % self.retrain_interval == 0:
                    self.surrogate.refit()
                if wall and time.time() - t0 > wall:
                    break
        finally:
            pre_pool.shutdown()
            post_pool.shutdown()
            tuner.close()
        res = tuner.result()
        if res.best_config:
            write_best(res.best_config, res.best_qor, work_dir=pt.work_dir)
        return res


ProgramTuner.run_auto = run_auto
