"""The device trace of a run's window, and its reduction.

`Window` holds `torch.profiler` (CUDA activity: the device's kernels,
copies and sets, and the host's launch calls, each pair joined by a
correlation id) open across the measured window.  The profiler stamps
its events in `time.time_ns()`'s clock, and the harness's host spans
are taken in the same clock.  The functions below reduce the events to
what the per-layer metrics read: the device ops inside the window, the
union of their intervals (busy time), the idle gaps, the host span open
at each op's launch, and the breakdown.  A window holds millions of ops,
so they are NumPy arrays (`Ops`)."""
from __future__ import annotations

import re
import time
from typing import Dict, Iterable, List, NamedTuple, Optional, Tuple

import numpy as np

LAUNCH_CALL = re.compile(r"^cu(da)?(LaunchKernel|Memcpy|Memset|Launch)")


class Span(NamedTuple):
    name: str
    start: int      # ns, time.time_ns()'s clock
    end: int


class Ops:
    """Device ops in order of start: each one's name (an index into
    `names`), start and end (ns) and the correlation id of its launch,
    and the host time of each launch (`launch`, aligned with the ops;
    -1 where the trace holds no launch call for it)."""

    def __init__(self, names: List[str], name_id, start, end, corr,
                 launch=None):
        order = np.argsort(np.asarray(start, np.int64), kind="stable")
        self.names = list(names)
        self.name_id = np.asarray(name_id, np.int64)[order]
        self.start = np.asarray(start, np.int64)[order]
        self.end = np.asarray(end, np.int64)[order]
        self.corr = np.asarray(corr, np.int64)[order]
        self.launch = (np.full(len(order), -1, np.int64) if launch is None
                       else np.asarray(launch, np.int64)[order])

    @classmethod
    def of(cls, rows: Iterable[Tuple[str, int, int, int]],
           launch: Optional[Dict[int, int]] = None) -> "Ops":
        """From (name, start, end, corr) rows and {corr: launch time}."""
        rows = list(rows)
        names, ids, index = [], [], {}
        for r in rows:
            if r[0] not in index:
                index[r[0]] = len(names)
                names.append(r[0])
            ids.append(index[r[0]])
        corr = [r[3] for r in rows]
        la = [(launch or {}).get(c, -1) for c in corr]
        return cls(names, ids, [r[1] for r in rows], [r[2] for r in rows],
                   corr, la)

    def __len__(self) -> int:
        return len(self.start)

    def matching(self, pattern: str) -> np.ndarray:
        """[n] bool: ops whose name matches the regular expression."""
        rx = re.compile(pattern)
        hit = np.array([bool(rx.search(n)) for n in self.names], bool)
        return hit[self.name_id] if len(self.names) else np.zeros(0, bool)

    def seconds(self, mask: Optional[np.ndarray] = None) -> float:
        d = self.end - self.start
        return float((d if mask is None else d[mask]).sum()) / 1e9


class Window:
    """The traced part of a measured window: the last `TRACED` seconds
    of it (all of it when shorter), so that reading the trace, millions
    of events, stays short.  `open(seconds)` as the window opens, `poll`
    between units of work (it starts the profiler when the traced part
    begins), `close(units)` once the device is synchronised at the
    window's end; `t0`, `t1` and `units` are then the traced part's.
    With `on` false nothing is traced and `ops` stays empty."""

    TRACED = 10.0
    SENTINELS = 8

    def __init__(self, on: bool):
        self.on = on
        self.t0 = self.t1 = 0
        self.units = 0
        self.ops = Ops([], [], [], [], [])
        self._prof = None
        self._start_at = None
        self._units0 = 0

    def open(self, seconds: float) -> bool:
        self._start_at = time.perf_counter() + max(0.0, seconds
                                                   - self.TRACED)
        return self.poll(0)

    def poll(self, units: int) -> bool:
        """Whether the traced part began just now."""
        if not self.on or self._prof is not None or self.t0 or \
                time.perf_counter() < self._start_at:
            return False
        import torch
        from torch.profiler import ProfilerActivity, profile
        self._prof = profile(activities=[ProfilerActivity.CUDA])
        self._prof.__enter__()
        # the profiler may lose the device records of its first few
        # kernels: these small ones, before the traced part opens, take
        # the loss
        x = torch.zeros(1, device="cuda")
        for _ in range(self.SENTINELS):
            x.add_(1.0)
        torch.cuda.synchronize()
        self._units0 = units
        self.t0 = time.time_ns()
        return True

    def close(self, units: int) -> None:
        """The window's end: the caller has synchronised the device."""
        if self._prof is None:
            return
        self.t1 = time.time_ns()
        self.units = units - self._units0
        self._prof.__exit__(None, None, None)
        self.ops = read_events(self._prof.profiler.kineto_results.events(),
                               self.t0, self.t1)
        self._prof = None


def read_events(events, t0: int, t1: int) -> Ops:
    """Kineto events -> the device ops overlapping [t0, t1], with the
    host time of each one's launch call."""
    from torch.autograd import DeviceType
    cuda = DeviceType.CUDA
    rows, launch = [], {}
    for e in events:
        if e.device_type() == cuda:
            s = e.start_ns()
            t = s + e.duration_ns()
            if t > t0 and s < t1:
                rows.append((e.name(), s, t, e.correlation_id()))
        elif LAUNCH_CALL.match(e.name()):
            launch[e.correlation_id()] = e.start_ns()
    return Ops.of(rows, launch)


def _merged(ops: Ops, t0: int, t1: int) -> Tuple[np.ndarray, np.ndarray]:
    """The union of the ops' intervals clipped to [t0, t1], as disjoint
    intervals in order: (starts, ends)."""
    s = np.clip(ops.start, t0, t1)
    e = np.clip(ops.end, t0, t1)
    keep = e > s
    s, e = s[keep], e[keep]
    if not len(s):
        return s, e
    order = np.argsort(s, kind="stable")
    s, e = s[order], e[order]
    reach = np.maximum.accumulate(e)
    new = np.ones(len(s), bool)
    new[1:] = s[1:] > reach[:-1]
    idx = np.nonzero(new)[0]
    ends = np.append(reach[idx[1:] - 1], reach[-1])
    return s[idx], ends


def busy_ns(ops: Ops, t0: int, t1: int) -> int:
    """The length of the union of the ops' intervals inside [t0, t1]."""
    s, e = _merged(ops, t0, t1)
    return int((e - s).sum())


def idle_gaps(ops: Ops, t0: int, t1: int
              ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """The intervals of [t0, t1] in which no op runs: (starts, ends, the
    name id of the op that ends each gap, -1 for the window's end)."""
    s, e = _merged(ops, t0, t1)
    gs = np.concatenate([[t0], e])
    ge = np.concatenate([s, [t1]])
    # the op that starts each busy stretch ends the gap before it
    first = np.searchsorted(ops.start, s, side="left")
    nxt = np.concatenate([ops.name_id[np.minimum(first, len(ops) - 1)]
                          if len(ops) else np.zeros(0, np.int64), [-1]])
    keep = ge > gs
    return gs[keep], ge[keep], nxt[keep]


def span_index(spans: List[Span], t: np.ndarray) -> np.ndarray:
    """For each time, the index (into `spans` sorted by start) of the
    innermost span open at it among the 8 that started last before it,
    or -1."""
    if not spans or not len(t):
        return np.full(len(t), -1, np.int64)
    st = np.array([s.start for s in spans], np.int64)
    en = np.array([s.end for s in spans], np.int64)
    i = np.searchsorted(st, t, side="right") - 1
    best = np.full(len(t), -1, np.int64)
    width = np.full(len(t), np.iinfo(np.int64).max)
    for back in range(8):
        j = i - back
        ok = j >= 0
        jj = np.where(ok, j, 0)
        inside = ok & (en[jj] >= t) & (st[jj] <= t)
        w = en[jj] - st[jj]
        take = inside & (w < width)
        best = np.where(take, jj, best)
        width = np.where(take, w, width)
    return best


def launched_in(ops: Ops, spans: List[Span], name: str) -> np.ndarray:
    """[n] bool: ops whose host launch call lies inside a span called
    `name`."""
    sel = sorted((s for s in spans if s.name == name),
                 key=lambda s: s.start)
    if not sel or not len(ops):
        return np.zeros(len(ops), bool)
    return (span_index(sel, ops.launch) >= 0) & (ops.launch >= 0)


def short_name(name: str, width: int = 60) -> str:
    """A kernel's name without its return type, template arguments and
    parameters."""
    if name.startswith(("Memcpy", "Memset")):
        return " ".join(name.split(" ")[:2])[:width]
    base = re.sub(r"\(.*", "", name.replace("(anonymous namespace)::", ""))
    depth, out = 0, []
    for ch in base:
        if ch == "<":
            depth += 1
        elif ch == ">":
            depth -= 1
        elif depth == 0:
            out.append(ch)
    base = "".join(out).strip().split(" ")[-1]
    return (base or name)[:width]


def breakdown(ops: Ops, spans: List[Span], t0: int, t1: int
              ) -> Dict[str, list]:
    """The ten device ops that took most time, and the idle time by what
    the host was doing (the innermost host span at each gap's middle, and
    the op that ended the gap), in seconds."""
    by_op: Dict[str, float] = {}
    dur = np.clip(ops.end, t0, t1) - np.clip(ops.start, t0, t1)
    sums = np.bincount(ops.name_id, weights=dur,
                       minlength=len(ops.names)) if len(ops) else []
    for i, v in enumerate(sums):
        k = short_name(ops.names[i])
        by_op[k] = by_op.get(k, 0.0) + float(v)
    ordered = sorted(spans, key=lambda s: s.start)
    gs, ge, nxt = idle_gaps(ops, t0, t1)
    where = span_index(ordered, (gs + ge) // 2)
    by_gap: Dict[str, float] = {}
    n_names = len(ops.names) + 1
    key = (where + 1) * n_names + (nxt + 1)
    uniq, inv = np.unique(key, return_inverse=True)
    tot = np.bincount(inv, weights=(ge - gs).astype(np.float64))
    for k, v in zip(uniq.tolist(), tot.tolist()):
        w, n = divmod(k, n_names)
        host = ordered[w - 1].name if w else "outside spans"
        op = short_name(ops.names[n - 1], 40) if n else "window end"
        label = f"{host} > {op}"
        by_gap[label] = by_gap.get(label, 0.0) + v

    def top(d):
        return [[k, v / 1e9] for k, v in sorted(d.items(),
                                                key=lambda kv: -kv[1])[:10]]
    return {"device_ops": top(by_op), "idle_gaps": top(by_gap)}
