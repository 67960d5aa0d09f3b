from .fused import DeviceObjective, EngineState, FusedEngine, default_arms  # noqa: F401
