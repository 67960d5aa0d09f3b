"""The device-resident dedup history (the program-mode driver comes with a
later slice of the port)."""
from .history import History, HistState, dup_source, unique_mask  # noqa: F401
