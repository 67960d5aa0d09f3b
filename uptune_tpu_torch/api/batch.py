"""Library surface for the batched multi-instance engine:
`uptune_tpu_torch.tune_batch(...)`, N tunes of one space as one program
(`engine/batched.py`), returning per-instance results.

Counterpart of `uptune_tpu/api/batch.py`.  The reference's analogue is
launching N OpenTuner processes and joining their archives; here every
instance proposes under one `torch.func.vmap`, all N batches are scored
in one call, and every history merges in one kernel launch.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, List, NamedTuple, Optional, Sequence

import numpy as np

from ..device import DeviceLike


class BatchTuneResult(NamedTuple):
    """Per-instance outcomes of one batched run (user orientation)."""
    best_config: Dict[str, Any]         # globally best instance's config
    best_qor: float                     # its QoR
    best_configs: List[Dict[str, Any]]  # per-instance incumbents
    best_qors: np.ndarray               # [n_instances]
    evals: np.ndarray                   # [n_instances] novel evaluations
    acqs: np.ndarray                    # [n_instances] candidates processed
    state: Any                          # final stacked EngineState
    engine: Any                         # the BatchedEngine (for resuming)


def tune_batch(space, objective, n_instances: int, steps: int,
               seed: int = 0, arms: Optional[Sequence] = None,
               sense: str = "min", exchange_every: int = 0,
               history_capacity: int = 1 << 13,
               eval_fn: Optional[Callable] = None, state=None,
               engine=None, device: DeviceLike = "cuda"
               ) -> BatchTuneResult:
    """Run `n_instances` tunes of `space` for `steps` batched steps each.

    `objective(vals [B, D], perms) -> [B]` is a device objective over the
    FLATTENED candidate batch (all instances score in one call);
    `eval_fn(cands) -> [B]` replaces it with a CandBatch-level evaluator
    (for example `engine.surrogate_eval_fn`'s fused GP scoring).
    `exchange_every=k` copies the global best to every instance after
    every k-th step.  Pass `state=prev.state, engine=prev.engine` to
    continue a previous run; `prev.state` stays as it was, since no
    state is ever updated in place."""
    from ..engine import BatchedEngine, FusedEngine

    be = engine
    if be is None:
        eng = FusedEngine(space, objective, arms=arms,
                          history_capacity=history_capacity, sense=sense,
                          device=device)
        be = BatchedEngine(eng, n_instances, exchange_every=exchange_every)
    elif be.n_instances != n_instances:
        raise ValueError(
            f"engine has {be.n_instances} instances, got "
            f"n_instances={n_instances}")
    if state is None:
        state = be.init(seed)
    state = be.run(state, steps, eval_fn)
    cfg, qor = be.best(state)
    return BatchTuneResult(
        cfg, qor, be.best_configs(state), be.best_qors(state),
        state.evals.cpu().numpy(), state.acqs.cpu().numpy(), state, be)
