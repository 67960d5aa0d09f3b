"""Custom-tuner decorator: `@ut.model(name, weight)`.

The reference declares this hook as a stub (`python/
uptune/tuners/tuner.py:7-14`) — the decorated function was stored and
never called.  Here a registered model is a real proposal source: the
controller asks it for configs at startup
(`uptune_tpu_torch.exec.controller.ProgramTuner._host_proposals`) and injects
them as attributed trials via `Tuner.inject` — evaluated ahead of any
technique batch, archived under the model's name, but outside the AUC
bandit's credit loop (injected tickets never touch technique state).

A model is a callable ``(history, space) -> config_dict`` where history
is a list of ``(config_dict, qor)`` pairs seen so far.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional, Tuple

from .constraint import REGISTRY


def model(name: Optional[str] = None, weight: float = 1.0) -> Callable:
    """Decorator registering a user-defined proposal model."""
    def decorator(fn: Callable) -> Callable:
        fn._ut_model_name = name or fn.__name__
        fn._ut_model_weight = float(weight)
        REGISTRY.custom_models.append(fn)
        return fn
    return decorator


def registered_models() -> List[Callable]:
    return list(REGISTRY.custom_models)
