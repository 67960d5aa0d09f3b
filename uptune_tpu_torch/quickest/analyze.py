"""QuickEst analysis stage (the port's copy of
`uptune_tpu/quickest/analyze.py`): learning curves, model scores, feature
importance — the research loop that answers "how much data does the
estimator need and which features matter".

Reference: `python/uptune/quickest/analyze.py` —
`analyze_learning_curve` (:417-495, per-target train/test RRSE as the
training-set prefix grows), `analyze_scores` (:242-291, per-model
RAE/R2/RRSE tables written as CSVs), `analyze_feature_importance`
(:149-198, per-target lasso |coef| / tree split-weight tables),
`analyze_scores_hls` (:293-333, the no-model baseline scoring each early
HLS feature directly against its matching target), dispatched by the
`analyze()` CLI switch (:498).  The reference re-fits sklearn
Lasso/XGBoost per curve point; here each point re-fits the torch
lasso->MLP->stack target model of `pipeline._TargetModel` with the same
hyperparameters, so the curve reflects the estimator actually shipped.

All outputs are plain dicts plus optional CSV files (no pandas/pickle);
plotting is delegated to the caller or `save_plots` (matplotlib gated).
"""
from __future__ import annotations

import csv
import os
from typing import TYPE_CHECKING, Dict, List, Optional, Sequence

import numpy as np

from .pipeline import (QuickEst, _TargetModel, apply_preprocess,
                       preprocess, r2_score, rae)

if TYPE_CHECKING:
    from ..device import DeviceLike


def rrse(y: np.ndarray, pred: np.ndarray) -> float:
    """Root relative squared error (analyze.py:219-228), the
    reference's learning-curve metric."""
    num = float(((y - pred) ** 2).sum())
    den = float(((y - y.mean()) ** 2).sum())
    return float(np.sqrt(num / max(den, 1e-12)))


def scores(est: QuickEst, x: np.ndarray, y: np.ndarray,
           target_names: Sequence[str],
           save_dir: Optional[str] = None
           ) -> Dict[str, Dict[str, float]]:
    """Per-target RAE/R2/RRSE of a fitted estimator on held-out data
    (analyze_scores, analyze.py:242-291)."""
    y = np.asarray(y, np.float32)
    if y.ndim == 1:
        y = y[:, None]
    out: Dict[str, Dict[str, float]] = {}
    for j, name in enumerate(target_names):
        pred = est.predict(x, name)
        out[name] = {"RAE": rae(y[:, j], pred),
                     "R2": r2_score(y[:, j], pred),
                     "RRSE": rrse(y[:, j], pred)}
    if save_dir:
        _write_table(os.path.join(save_dir, "scores.csv"),
                     ["target", "RAE", "R2", "RRSE"],
                     [[n, m["RAE"], m["R2"], m["RRSE"]]
                      for n, m in out.items()])
    return out


def hls_scores(x: np.ndarray, y: np.ndarray,
               pairs: Sequence[tuple],
               feature_names: Sequence[str],
               target_names: Sequence[str],
               save_dir: Optional[str] = None
               ) -> Dict[str, Dict[str, float]]:
    """The no-model baseline (analyze_scores_hls, analyze.py:293-333):
    score an early HLS feature DIRECTLY as the prediction of its
    post-implementation counterpart — the floor any learned estimator
    must beat.  `pairs` maps (feature_name, target_name); the result is
    keyed by (feature, target) so two early features scored against the
    same target both survive (the reference emits one row per pair)."""
    x = np.atleast_2d(np.asarray(x, np.float32))
    y = np.atleast_2d(np.asarray(y, np.float32))
    out: Dict[tuple, Dict[str, float]] = {}
    for feat, tgt in pairs:
        fi = list(feature_names).index(feat)
        ti = list(target_names).index(tgt)
        fx, ty = x[:, fi], y[:, ti]
        out[(feat, tgt)] = {"feature": feat, "target": tgt,
                            "RAE": rae(ty, fx),
                            "R2": r2_score(ty, fx), "RRSE": rrse(ty, fx)}
    if save_dir:
        _write_table(os.path.join(save_dir, "scores_hls.csv"),
                     ["target", "feature", "RAE", "R2", "RRSE"],
                     [[m["target"], m["feature"], m["RAE"], m["R2"],
                       m["RRSE"]] for m in out.values()])
    return out


def learning_curve(x_train: np.ndarray, y_train: np.ndarray,
                   x_test: np.ndarray, y_test: np.ndarray,
                   target_names: Sequence[str],
                   points: int = 8,
                   save_dir: Optional[str] = None,
                   device: "DeviceLike" = "cuda",
                   **model_opts) -> Dict[str, Dict[str, list]]:
    """Train/test RRSE per target as the training prefix grows
    (analyze_learning_curve, analyze.py:417-495: prefixes from ~15% of
    the data up to all of it).  Answers the QuickEst research question:
    how many implementation runs must be collected before the estimator
    is trustworthy?"""
    y_train = np.asarray(y_train, np.float32)
    y_test = np.asarray(y_test, np.float32)
    if y_train.ndim == 1:
        y_train = y_train[:, None]
    if y_test.ndim == 1:
        y_test = y_test[:, None]
    n = x_train.shape[0]
    lo = max(16, int(round(n * 0.15)))   # _TargetModel floor is 16 rows
    if lo >= n:
        raise ValueError(f"need > {lo} training rows for a curve, got {n}")
    nums = sorted({int(v) for v in np.linspace(lo, n, points)})
    xt_clean, meta = preprocess(x_train)
    xe_clean = apply_preprocess(x_test, meta)
    base_seed = model_opts.pop("seed", 0)

    out: Dict[str, Dict[str, list]] = {}
    for j, name in enumerate(target_names):
        tr_scores, te_scores = [], []
        for num in nums:
            m = _TargetModel(seed=base_seed + j, device=device,
                             **model_opts).fit(
                xt_clean[:num], y_train[:num, j])
            tr_scores.append(rrse(y_train[:num, j],
                                  m.predict(xt_clean[:num])))
            te_scores.append(rrse(y_test[:, j], m.predict(xe_clean)))
        out[name] = {"nums": nums, "train": tr_scores, "test": te_scores}
    if save_dir:
        rows = [[name, num, tr, te]
                for name, d in out.items()
                for num, tr, te in zip(d["nums"], d["train"], d["test"])]
        _write_table(os.path.join(save_dir, "learning_curve.csv"),
                     ["target", "train_rows", "rrse_train", "rrse_test"],
                     rows)
    return out


def feature_importance(est: QuickEst,
                       save_dir: Optional[str] = None
                       ) -> Dict[str, Dict[str, float]]:
    """Per-target normalized |lasso coefficient| over the preprocessed
    feature set, plus which features the MLP stage actually consumes
    (analyze_feature_importance, analyze.py:149-198 — lasso weights and
    tree split-weights; our second stage's 'importance' is membership in
    the lasso-selected set)."""
    out: Dict[str, Dict[str, float]] = {}
    kept = est.pre_meta["kept"] if est.pre_meta else None
    for name, m in est.models.items():
        w = np.abs(np.asarray(m.w, np.float64))
        total = w.sum() or 1.0
        fn = _kept_names(est.feature_names, kept, len(w))
        imp = {fn[i]: float(w[i] / total) for i in range(len(w))}
        out[name] = dict(sorted(imp.items(), key=lambda kv: -kv[1]))
        out[name]["__selected__"] = [fn[i] for i in m.sel]  # type: ignore
    if save_dir:
        feats = sorted({f for d in out.values()
                        for f in d if f != "__selected__"})
        rows = [[f] + [out[t].get(f, 0.0) for t in est.models]
                for f in feats]
        _write_table(os.path.join(save_dir, "feature_importance.csv"),
                     ["feature"] + list(est.models), rows)
    return out


def analyze(func: str = "scores", **kwargs):
    """Dispatch façade mirroring the reference CLI's -f switch
    (analyze.py:498 + the abbreviation table at :49-60)."""
    table = {
        "sc": scores, "scores": scores, "score": scores,
        "schls": hls_scores, "score_hls": hls_scores, "hls": hls_scores,
        "lc": learning_curve, "learning_curve": learning_curve,
        "fi": feature_importance, "feature_importance": feature_importance,
    }
    if func not in table:
        raise ValueError(
            f"unknown analysis {func!r}; known: {sorted(table)}")
    return table[func](**kwargs)


def _kept_names(feature_names: Optional[Sequence[str]],
                kept: Optional[Sequence[int]], n: int) -> List[str]:
    if feature_names is None:
        return [f"f{i}" for i in range(n)]
    if kept is None:
        return list(feature_names)[:n]
    return [feature_names[i] for i in kept]


def _write_table(path: str, header: Sequence[str], rows) -> None:
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(header)
        for r in rows:
            w.writerow(r)
