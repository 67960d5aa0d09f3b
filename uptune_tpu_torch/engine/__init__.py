from .fused import DeviceObjective, EngineState, FusedEngine, default_arms  # noqa: F401
from .batched import (BatchedEngine, StatefulEval, exchange_best,  # noqa: F401
                      surrogate_aux, surrogate_eval_fn)
