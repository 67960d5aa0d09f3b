"""Search hooks: observer callbacks over the tuning loop.

Counterpart of `uptune_tpu/driver/plugins.py`, carried over as it is
but for its logger, which is the port's.

The reference's SearchPlugin interface + periodic display plugins
(`/root/reference/python/uptune/opentuner/search/plugin.py:26-103`:
before/after main, on_result, on_new_best_result; LogDisplayPlugin
prints best/elapsed every ~5s of result waits, FileDisplayPlugin tees
to a file).  Here hooks attach to the batched Tuner: per-trial
on_result, per-ticket on_step, on_new_best, plus start/finish.
"""
from __future__ import annotations

import json
import logging
import time
from typing import Any, Dict, Optional

log = logging.getLogger("uptune_tpu_torch")


class SearchHook:
    """Base observer; override any subset (plugin.py:26-62)."""

    def on_start(self, tuner) -> None:
        pass

    def on_result(self, tuner, trial, qor: Optional[float]) -> None:
        """Called for every individually-told trial (user orientation)."""

    def on_step(self, tuner, stats) -> None:
        """Called when a ticket finalizes (one StepStats)."""

    def on_new_best(self, tuner, config: Dict[str, Any],
                    qor: float) -> None:
        pass

    def on_finish(self, tuner, result) -> None:
        pass


class LogDisplay(SearchHook):
    """Periodic status line (LogDisplayPlugin, plugin.py:86-101):
    elapsed, evals, best-so-far — at most once per `interval` seconds."""

    def __init__(self, interval: float = 5.0, out=None):
        self.interval = interval
        self.out = out
        self._t0 = time.time()
        self._last = 0.0

    def _emit(self, text: str) -> None:
        if self.out is not None:
            print(text, file=self.out)
        else:
            log.info(text)

    def on_start(self, tuner) -> None:
        self._t0 = time.time()

    @staticmethod
    def _tag(tuner) -> str:
        lbl = getattr(tuner, "label", "")
        return f"[{lbl}] " if lbl else ""

    def on_step(self, tuner, stats) -> None:
        now = time.time()
        if now - self._last < self.interval:
            return
        self._last = now
        self._emit(f"[{now - self._t0:7.1f}s] {self._tag(tuner)}"
                   f"evals={tuner.evals} best={stats.best_qor:.6g} "
                   f"arm={stats.technique} pruned={tuner.pruned_total}")

    def on_new_best(self, tuner, config, qor) -> None:
        self._emit(f"[{time.time() - self._t0:7.1f}s] {self._tag(tuner)}"
                   f"NEW BEST qor={qor:.6g} after {tuner.evals} evals")


class FileDisplay(SearchHook):
    """Append one JSON line per new best to a file
    (FileDisplayPlugin, plugin.py:103-153)."""

    def __init__(self, path: str):
        self.path = path
        self._t0 = time.time()

    def on_start(self, tuner) -> None:
        self._t0 = time.time()

    def on_new_best(self, tuner, config, qor) -> None:
        rec = {"elapsed": round(time.time() - self._t0, 3),
               "evals": tuner.evals, "qor": qor, "config": config}
        # disambiguate interleaved events when several tuners (one per
        # pipeline stage) share this hook instance
        if getattr(tuner, "label", ""):
            rec["tuner"] = tuner.label
        with open(self.path, "a") as f:
            f.write(json.dumps(rec) + "\n")


def fire(hooks, method: str, *args) -> None:
    """Dispatch to every hook, isolating observer failures from the
    tuning loop (an exception in a display must not kill the run)."""
    for h in hooks or ():
        try:
            getattr(h, method)(*args)
        except Exception:  # noqa: BLE001 — observers are best-effort
            log.warning("search hook %s.%s failed", type(h).__name__,
                        method, exc_info=True)
