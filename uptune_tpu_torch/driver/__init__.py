from .driver import StepStats, TuneResult, Tuner  # noqa: F401
from .history import History, HistState, dup_source, unique_mask  # noqa: F401
