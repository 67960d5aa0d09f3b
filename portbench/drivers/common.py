"""What every driver shares: derived seeds, the clock of set-up, the
record of a window, and the sample of units to judge."""
from __future__ import annotations

import hashlib
import random
import time
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Tuple

from .. import devtrace


def sub_seed(seed: int, what: str, bits: int = 31) -> int:
    """A seed for one use (`what`) derived from the run's seed: the same
    run seed gives the same inputs, two uses get unrelated streams."""
    h = hashlib.sha256(f"{int(seed)}:{what}".encode()).digest()
    return int.from_bytes(h[:8], "little") % ((1 << bits) - 1)


@dataclass
class Run:
    """What a driver gets: the cell, its configuration and mix, the run's
    seed and window, the device, and whether the window is traced."""
    cell: Dict[str, Any]
    config: Dict[str, Any]
    mix: Dict[str, Any]
    seed: int
    seconds: float
    trace: bool
    device: Any
    setup_done: Any = None          # callable: the first timed unit starts
    limits: Dict[str, float] = field(default_factory=dict)
    t_start: float = 0.0            # the process's start, time.time()

    def note(self, what: str) -> None:
        """A step of set-up, with the seconds since the process
        started, on standard error."""
        import sys
        print(f"portbench: {what} at {time.time() - self.t_start:.3f} s",
              file=sys.stderr, flush=True)


@dataclass
class Check:
    name: str
    value: float
    limit: float

    @property
    def ok(self) -> bool:
        return self.value == self.value and self.value <= self.limit


@dataclass
class Outcome:
    """What a driver returns.  `rates` are the end-to-end metrics it
    measured (by name); `checks` decide `correct`; `trace` holds what
    the per-layer readers read."""
    rates: Dict[str, float]
    attempted: int
    failed: int
    checks: List[Check]
    memory_peak_bytes: int
    trace: "TraceCtx"
    numbers: Dict[str, Any] = field(default_factory=dict)
    # the control's numbers: the reference in a lower precision put in
    # the program's place, read as the checks read the program's
    control: Any = None


@dataclass
class TraceCtx:
    """The traced window as the per-layer readers see it."""
    t0: int = 0                     # ns, time.time_ns()'s clock
    t1: int = 0
    units: int = 0
    ops: devtrace.Ops = field(
        default_factory=lambda: devtrace.Ops([], [], [], [], []))
    spans: List[devtrace.Span] = field(default_factory=list)
    launches: Dict[str, int] = field(default_factory=dict)
    shapes: Dict[str, Any] = field(default_factory=dict)
    extra: Dict[str, Any] = field(default_factory=dict)

    @property
    def window_s(self) -> float:
        return (self.t1 - self.t0) / 1e9


class Spans:
    """Host spans in time.time_ns()'s clock, from perf_counter_ns reads
    (one offset taken when the recorder starts)."""

    def __init__(self, on: bool):
        self.on = on
        self.rows: List[Tuple[str, int, int]] = []
        self.offset = time.time_ns() - time.perf_counter_ns()

    def add(self, name: str, a: int, b: int) -> None:
        if self.on:
            self.rows.append((name, a, b))

    def spans(self) -> List[devtrace.Span]:
        o = self.offset
        return [devtrace.Span(n, a + o, b + o) for n, a, b in self.rows]


class Sample:
    """The units of a window to judge: the first, the last and `k` more
    drawn uniformly from the rest (a reservoir, seeded)."""

    def __init__(self, k: int, seed: int):
        self.k = k
        self.rng = random.Random(seed)
        self.first: Optional[Any] = None
        self.last: Optional[Any] = None
        self.rest: List[Any] = []
        self.seen = 0

    def offer(self, i: int) -> bool:
        """Whether unit i goes into the reservoir (decided before it
        runs, so that its inputs are kept only when needed)."""
        if i == 0:
            return False
        self.seen += 1
        if len(self.rest) < self.k:
            self._slot = len(self.rest)
            self.rest.append(None)
            return True
        j = self.rng.randrange(self.seen)
        if j < self.k:
            self._slot = j
            return True
        return False

    def put(self, i: int, item: Any, kept: bool) -> None:
        if i == 0:
            self.first = item
        elif kept:
            self.rest[self._slot] = item
        self.last = item

    def items(self) -> List[Any]:
        out = [self.first] + [x for x in self.rest if x is not None]
        if self.last is not None and all(self.last is not x for x in out):
            out.append(self.last)
        return [x for x in out if x is not None]


def chunk_rates(marks: List[float], t0: float, per_unit: float,
                width: float = 1.0) -> List[float]:
    """Units a second in each `width`-second slice of the window, from
    the end time of every unit: a diagnostic of drift, printed and never
    a metric."""
    if not marks:
        return []
    n = int((marks[-1] - t0) / width) + 1
    counts = [0] * n
    for m in marks:
        counts[min(n - 1, int((m - t0) / width))] += 1
    return [round(c * per_unit / width, 1) for c in counts]


def program_space(params: List[dict]):
    """The program's Space for a configuration's `space` list."""
    from uptune_tpu_torch.space import params as P
    from uptune_tpu_torch.space.spec import Space
    out = []
    for p in params:
        k, n = p["kind"], p["name"]
        if k == "float":
            out.append(P.FloatParam(n, float(p["lo"]), float(p["hi"])))
        elif k == "int":
            out.append(P.IntParam(n, int(p["lo"]), int(p["hi"])))
        elif k == "log_int":
            out.append(P.LogIntParam(n, int(p["lo"]), int(p["hi"])))
        elif k == "pow2":
            out.append(P.Pow2Param(n, int(p["lo"]), int(p["hi"])))
        elif k == "bool":
            out.append(P.BoolParam(n))
        elif k == "enum":
            out.append(P.EnumParam(n, tuple(p["options"])))
        elif k == "perm":
            out.append(P.PermParam(n, tuple(range(int(p["items"])))))
        else:
            raise ValueError(f"unknown kind {k!r}")
    return Space(out)


def reference_space(cfg: Dict[str, Any]):
    from ..reference.space import RefSpace
    return RefSpace(cfg["space"], int(cfg["hash"]["multiplier_seed"]))


def launches() -> Dict[str, int]:
    """The program's launch counter of each hand-written kernel."""
    from uptune_tpu_torch import native
    return {k.name: k.launches for k in native.KERNELS}


def synchronize(device) -> None:
    import torch
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def memory_peak(device) -> int:
    import torch
    return int(torch.cuda.max_memory_allocated(device)) \
        if device.type == "cuda" else 0
