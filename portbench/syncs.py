"""Host-device synchronisations, counted by torch's sync debug mode.

Frozen from `chip_smoke.py::sync_count`: the mode warns once for each
synchronising call, and the warnings are counted between `start()` and
`stop()`."""
from __future__ import annotations

import warnings


class Counter:
    def __init__(self):
        self.n = 0
        self.on = False
        self._prev = None
        self._catch = None

    def _hook(self, message, category, filename, lineno, file=None,
              line=None):
        # not the mode's own notice that it is a prototype
        if "called a synchronizing" in str(message):
            self.n += 1

    def start(self) -> None:
        import torch
        self._catch = warnings.catch_warnings()
        self._catch.__enter__()
        warnings.simplefilter("always")
        warnings.showwarning = self._hook
        self._prev = torch.cuda.get_sync_debug_mode()
        torch.cuda.set_sync_debug_mode("warn")
        self.on = True

    def stop(self) -> None:
        if not self.on:
            return
        import torch
        torch.cuda.set_sync_debug_mode(self._prev)
        self._catch.__exit__(None, None, None)
        self.on = False
