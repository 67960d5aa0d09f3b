from .fused import DeviceObjective, EngineState, FusedEngine, default_arms  # noqa: F401
from .batched import StatefulEval, surrogate_aux, surrogate_eval_fn  # noqa: F401
