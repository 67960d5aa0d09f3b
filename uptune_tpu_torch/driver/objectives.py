"""Search objectives: map multi-metric results to the engine's scalar
minimization key.

Counterpart of `uptune_tpu/driver/objectives.py`, carried over as it is.

The reference compares Result ORM rows through objective strategy
classes (`/root/reference/python/uptune/opentuner/search/objective.py`:
`MinimizeTime:161`, `MaximizeAccuracy:186`,
`MaximizeAccuracyMinimizeSize:218`, `ThresholdAccuracyMinimizeTime:246`)
with pairwise compare/relative methods.  The batched engine ranks
candidates by one scalar on device, so each objective here is a
*scalarization* `scalarize(metrics) -> float` whose total order matches
the reference's pairwise comparisons:

* lexicographic composites use a documented `scale` separating the
  primary and secondary keys;
* threshold composites place every below-threshold result after every
  above-threshold one, ordered by how far below they are.

Use with the ask/tell driver::

    tuner = Tuner(space, sense="min")
    obj = ThresholdAccuracyMinimizeTime(target=0.95)
    ...
    tuner.tell(trial, obj.scalarize({"time": 3.2, "accuracy": 0.97}))
"""
from __future__ import annotations

import math
from typing import Any, Dict, Optional

Metrics = Dict[str, float]

#: ordering gap between the primary and secondary lexicographic keys;
#: secondary values are clipped into (-SCALE/2, SCALE/2)
SCALE = 1e7


class _NonFinite(Exception):
    """Raised internally when a required metric is nan/inf; __call__
    converts it to the +inf failure rank."""


def _get(metrics: Metrics, key: str) -> float:
    try:
        v = float(metrics[key])
    except KeyError:
        raise KeyError(
            f"objective needs metric {key!r}; got {sorted(metrics)}"
        ) from None
    if not math.isfinite(v):
        raise _NonFinite(key)
    return v


def _clip_secondary(v: float) -> float:
    lim = SCALE / 2.0 - 1.0
    return max(-lim, min(lim, v))


class SearchObjective:
    """Base: scalarize() must be monotone in the objective's preference
    order (smaller = better, the engine's normal form)."""

    #: metric keys this objective reads
    keys = ("time",)

    def scalarize(self, metrics: Metrics) -> float:
        raise NotImplementedError

    def __call__(self, metrics: Metrics) -> float:
        try:
            v = self.scalarize(metrics)
        except _NonFinite:
            return float("inf")   # failed measurement: worst rank
        return v if math.isfinite(v) else float("inf")


class MinimizeTime(SearchObjective):
    """objective.py:161 — the default."""
    keys = ("time",)

    def scalarize(self, metrics: Metrics) -> float:
        return _get(metrics, "time")


class MaximizeAccuracy(SearchObjective):
    """objective.py:186."""
    keys = ("accuracy",)

    def scalarize(self, metrics: Metrics) -> float:
        return -_get(metrics, "accuracy")


class MinimizeSize(SearchObjective):
    keys = ("size",)

    def scalarize(self, metrics: Metrics) -> float:
        return _get(metrics, "size")


class MaximizeAccuracyMinimizeSize(SearchObjective):
    """objective.py:218 — accuracy dominates; size breaks ties (the
    reference compares accuracy first, then size).  Accuracy is
    quantized to `accuracy_resolution` so near-equal accuracies compete
    on size, matching the reference's float-compare tolerance in spirit."""
    keys = ("accuracy", "size")

    def __init__(self, accuracy_resolution: float = 1e-3):
        self.resolution = accuracy_resolution

    def scalarize(self, metrics: Metrics) -> float:
        acc = _get(metrics, "accuracy")
        size = _get(metrics, "size")
        acc_q = round(acc / self.resolution)
        return -acc_q * SCALE + _clip_secondary(size)


class ThresholdAccuracyMinimizeTime(SearchObjective):
    """objective.py:246 — minimize time subject to accuracy >= target;
    any result below the target ranks after every result above it,
    ordered by accuracy shortfall."""
    keys = ("accuracy", "time")

    def __init__(self, target: float):
        self.target = float(target)

    def scalarize(self, metrics: Metrics) -> float:
        acc = _get(metrics, "accuracy")
        t = _get(metrics, "time")
        if acc >= self.target:
            return _clip_secondary(t)
        return SCALE * (1.0 + (self.target - acc))


_BY_NAME = {
    "MinimizeTime": MinimizeTime,
    "MaximizeAccuracy": MaximizeAccuracy,
    "MinimizeSize": MinimizeSize,
    "MaximizeAccuracyMinimizeSize": MaximizeAccuracyMinimizeSize,
    "ThresholdAccuracyMinimizeTime": ThresholdAccuracyMinimizeTime,
}


def get_objective(name: str, **kwargs: Any) -> SearchObjective:
    """Resolve an objective by its reference class name."""
    try:
        return _BY_NAME[name](**kwargs)
    except KeyError:
        raise KeyError(f"unknown objective {name!r}; "
                       f"known: {sorted(_BY_NAME)}") from None
