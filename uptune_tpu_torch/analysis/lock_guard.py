"""Runtime lock sanitizer: the dynamic half of the concurrency pass.

The static rules (R101–R106) see one module at a time and syntactic
lock identity; LockGuard watches the *process*: with
``UT_LOCK_GUARD=1|strict`` it wraps ``threading.Lock``/``RLock`` via a
plain module-attribute patch (no sitecustomize) so every lock created
afterwards records into one acquisition-order graph keyed by
allocation site.  It detects

* **cycles** — site A acquired while holding B somewhere, and B while
  holding A somewhere else: the dynamic would-deadlock signal R101
  approximates statically;
* **held-too-long** — a lock held past ``UT_LOCK_GUARD_MS``
  milliseconds (0 = threshold off, the default: the serving plane
  deliberately holds its per-key lock across a whole commit, so a
  fixed default would cry wolf; ``held_max_ms`` is always reported).

The TraceGuard pattern throughout: ``lock_guard_from_env()`` returns
an inert guard when the env var is unset (zero overhead, no patching),
detections are *recorded* at acquire/release and only raised from
``check()`` on clean exit (never mid-critical-section), strict mode
raises ``LockOrderError``, warn mode emits a RuntimeWarning, and every
detection lands in the obs metrics/event families
(``lockguard.cycles`` / ``lockguard.held_too_long``).

Scope and honesty notes: only locks created AFTER ``install()``
through the ``threading`` module attributes are wrapped (``from
threading import Lock`` binds the raw factory at import time; the repo
always spells ``threading.Lock()``).  Bookkeeping is guarded by a raw
``_thread.allocate_lock`` plus a thread-local re-entrancy flag so the
guard's own obs calls cannot recurse into it.  Per-acquire overhead is
a thread-local append and a monotonic read.
"""
from __future__ import annotations

import _thread
import os
import sys
import threading
import time
import warnings
from typing import Any, Dict, List, Optional, Set, Tuple

from .. import obs

__all__ = ["LockGuard", "LockOrderError", "lock_guard_from_env"]

_PATCH_LOCK = _thread.allocate_lock()   # serializes install/uninstall
_mono = time.monotonic                  # hot-path alias


class LockOrderError(RuntimeError):
    """Strict-mode verdict: the process built a cyclic lock-order
    graph (would deadlock under the right interleave) or held a lock
    past the configured threshold."""


def _caller_site() -> str:
    """Allocation site of a Lock()/RLock() call, as `dir/file.py:NN`,
    skipping frames inside threading.py itself (Condition() allocates
    its RLock from there — the user call site is what identifies the
    lock)."""
    tfile = getattr(threading, "__file__", "")
    f = sys._getframe(2)
    while f is not None and f.f_code.co_filename == tfile:
        f = f.f_back
    if f is None:
        return "<unknown>:0"
    fn = f.f_code.co_filename
    parts = fn.replace("\\", "/").rsplit("/", 2)
    short = "/".join(parts[-2:]) if len(parts) > 1 else fn
    return f"{short}:{f.f_lineno}"


class _LockProxy:
    """Wraps a raw lock; reports acquire/release to the guard.

    The guard bookkeeping is INLINED here rather than delegated to
    LockGuard methods: plain-Lock acquire/release is the sanitizer's
    hot path (every `with self._lock:` in the serving/store planes),
    and on the bench box each avoided Python call is a measurable
    slice of the >= 0.95x overhead budget."""

    __slots__ = ("_g", "_lk", "_site", "_acq", "_rel")

    def __init__(self, guard: "LockGuard", raw, site: str):
        self._g = guard
        self._lk = raw
        self._site = site
        self._acq = raw.acquire     # bound-method cache: one fewer
        self._rel = raw.release     # attribute hop per hot-path call

    def acquire(self, blocking: bool = True, timeout: float = -1):
        ok = self._acq(blocking, timeout)
        if ok:
            g = self._g
            if g._active:
                tls = g._tls
                try:
                    stack = tls.stack
                except AttributeError:
                    stack = tls.stack = []
                    tls.busy = False
                if not tls.busy:
                    g.acquires += 1     # telemetry; races lose counts
                    if stack:
                        site = self._site
                        edges = g._edges
                        for hp, _t0 in stack:
                            h = hp._site
                            # lock-free probe: edges are only added,
                            # so a hit is definitive; first-seen pairs
                            # go through the locked slow path
                            if (h != site
                                    and site not in edges.get(h, ())):
                                g._add_edges(tls, stack, site)
                                break
                    stack.append((self, _mono()))
        return ok

    __enter__ = acquire

    def release(self) -> None:
        g = self._g
        tls = g._tls
        stack = getattr(tls, "stack", None)
        if stack and not tls.busy:
            if stack[-1][0] is self:        # LIFO: the common case
                t0 = stack.pop()[1]
            else:
                t0 = None
                for i in range(len(stack) - 2, -1, -1):
                    if stack[i][0] is self:
                        t0 = stack.pop(i)[1]
                        break
            if t0 is not None and g._active:
                ms = (_mono() - t0) * 1e3
                site = self._site
                if ms > g._held_max.get(site, 0.0):
                    g._held_max[site] = ms  # racy max: telemetry
                if 0.0 < g.held_ms < ms:
                    g._note_held(tls, site, ms)
        self._rel()

    def locked(self) -> bool:
        return self._lk.locked()

    def __exit__(self, *exc) -> None:
        self.release()

    def _at_fork_reinit(self) -> None:
        self._lk._at_fork_reinit()

    def __repr__(self) -> str:
        return f"<guarded {self._lk!r} @ {self._site}>"


class _RLockProxy:
    """Reentrant variant: only the outermost acquire/release touch the
    guard, and the `_release_save`/`_acquire_restore`/`_is_owned`
    protocol is forwarded so Condition(RLock()) keeps working.
    Bookkeeping inlined for the same hot-path reason as _LockProxy
    (the session server's per-key lock is an RLock)."""

    __slots__ = ("_g", "_lk", "_site", "_count", "_acq", "_rel")

    def __init__(self, guard: "LockGuard", raw, site: str):
        self._g = guard
        self._lk = raw
        self._site = site
        self._count = 0
        self._acq = raw.acquire
        self._rel = raw.release

    def acquire(self, blocking: bool = True, timeout: float = -1):
        ok = self._acq(blocking, timeout)
        if ok:
            self._count += 1            # owner-only mutation: safe
            if self._count == 1:
                g = self._g
                if g._active:
                    tls = g._tls
                    try:
                        stack = tls.stack
                    except AttributeError:
                        stack = tls.stack = []
                        tls.busy = False
                    if not tls.busy:
                        g.acquires += 1
                        if stack:
                            site = self._site
                            edges = g._edges
                            for hp, _t0 in stack:
                                h = hp._site
                                if (h != site and site
                                        not in edges.get(h, ())):
                                    g._add_edges(tls, stack, site)
                                    break
                        stack.append((self, _mono()))
        return ok

    __enter__ = acquire

    def release(self) -> None:
        if self._count == 1:
            self._g._on_release(self)
        self._count -= 1
        self._rel()

    def __exit__(self, *exc) -> None:
        self.release()

    # Condition support ------------------------------------------------
    def _release_save(self):
        self._g._on_release(self)
        n, self._count = self._count, 0
        return (n, self._lk._release_save())

    def _acquire_restore(self, state) -> None:
        n, inner = state
        self._lk._acquire_restore(inner)
        self._count = n
        self._g._on_acquire(self)

    def _is_owned(self) -> bool:
        return self._lk._is_owned()

    def _at_fork_reinit(self) -> None:
        self._lk._at_fork_reinit()
        self._count = 0

    def __repr__(self) -> str:
        return f"<guarded {self._lk!r} @ {self._site}>"


class LockGuard:
    def __init__(self, *, strict: bool = False, held_ms: float = 0.0,
                 enabled: bool = True, name: str = "lock-guard"):
        self.strict = bool(strict)
        self.held_ms = float(held_ms)
        self.enabled = bool(enabled)
        self.name = name
        self.locks = 0           # proxies created
        self.acquires = 0        # approximate (unlocked counter)
        self._raw = _thread.allocate_lock()     # guards the edge graph
        self._tls = threading.local()
        # site -> set of sites acquired while it was held
        self._edges: Dict[str, Set[str]] = {}
        self._cycles: List[Tuple[str, ...]] = []
        self._held_long: List[Tuple[str, float]] = []
        self._held_max: Dict[str, float] = {}
        self._orig: Optional[tuple] = None
        self._active = False

    # -- bookkeeping ---------------------------------------------------
    # the acquire/release fast paths are deliberately lock-free: the
    # held stack is thread-local, `_edges` membership probes are plain
    # GIL-atomic dict reads (edges are only ever added), and the graph
    # lock + re-entrancy flag are taken only for FIRST-SEEN edges and
    # detections — steady state pays a tls read, a counter, a list
    # append and a monotonic stamp (priced by the bench's >= 0.95x gate)
    def _on_acquire(self, proxy) -> None:
        if not self._active:
            return
        tls = self._tls
        try:
            stack = tls.stack
        except AttributeError:
            stack = tls.stack = []
            tls.busy = False
        if tls.busy:
            return
        self.acquires += 1          # telemetry; races lose counts
        if stack:
            site = proxy._site
            novel = False
            for held_proxy, _t0 in stack:
                h = held_proxy._site
                if h != site and site not in self._edges.get(h, ()):
                    novel = True
                    break
            if novel:
                self._add_edges(tls, stack, site)
        stack.append((proxy, time.monotonic()))

    def _on_release(self, proxy) -> None:
        tls = self._tls
        stack = getattr(tls, "stack", None)
        if not stack or tls.busy:
            return
        if stack[-1][0] is proxy:           # LIFO: the common case
            t0 = stack.pop()[1]
        else:
            t0 = None
            for i in range(len(stack) - 2, -1, -1):
                if stack[i][0] is proxy:
                    t0 = stack.pop(i)[1]
                    break
            if t0 is None:
                return
        if self._active:
            ms = (time.monotonic() - t0) * 1e3
            site = proxy._site
            if ms > self._held_max.get(site, 0.0):
                self._held_max[site] = ms   # racy max: telemetry
            if 0.0 < self.held_ms < ms:
                self._note_held(tls, site, ms)

    def _note_held(self, tls, site: str, ms: float) -> None:
        tls.busy = True         # obs may touch proxied locks
        try:
            with self._raw:
                self._held_long.append((site, round(ms, 3)))
            obs.count("lockguard.held_too_long")
            obs.event("lockguard.held", site=site, ms=round(ms, 3),
                      limit_ms=self.held_ms)
        finally:
            tls.busy = False

    def _add_edges(self, tls, stack, site: str) -> None:
        """Slow path: at least one (held -> site) pair is new.  Edge
        insertion + cycle search under the graph lock; obs emission
        after it (obs may itself acquire proxied locks — busy makes
        that re-entrancy a no-op, and emitting outside `_raw` keeps
        the graph lock leaf-level)."""
        tls.busy = True
        try:
            cycles = []
            with self._raw:
                for held_proxy, _t0 in stack:
                    h = held_proxy._site
                    if h == site:
                        continue
                    dests = self._edges.setdefault(h, set())
                    if site not in dests:
                        dests.add(site)
                        c = self._find_cycle(h, site)
                        if c:
                            self._cycles.append(c)
                            cycles.append(c)
            for c in cycles:
                obs.count("lockguard.cycles")
                obs.event("lockguard.cycle", path=list(c))
        finally:
            tls.busy = False

    def _find_cycle(self, a: str,
                    b: str) -> Optional[Tuple[str, ...]]:
        """Called under self._raw right after adding edge a->b: if a is
        reachable from b, the graph just closed a cycle."""
        seen = {b}
        todo = [b]
        parent: Dict[str, str] = {}
        found = False
        while todo and not found:
            x = todo.pop()
            for y in self._edges.get(x, ()):
                if y == a:
                    parent[y] = x
                    found = True
                    break
                if y not in seen:
                    seen.add(y)
                    parent[y] = x
                    todo.append(y)
        if not found:
            return None
        path = [a]
        cur: Optional[str] = a
        # walk parents back from a to b, then close with a->b
        while cur != b:
            cur = parent.get(cur)
            if cur is None:
                break
            path.append(cur)
        path.reverse()          # b ... a
        return tuple([a] + path)

    # -- install/uninstall --------------------------------------------
    def install(self) -> "LockGuard":
        if not self.enabled or self._active:
            return self
        with _PATCH_LOCK:
            self._orig = (threading.Lock, threading.RLock)
            guard = self
            orig_rlock = self._orig[1]

            def Lock():
                guard.locks += 1
                return _LockProxy(guard, _thread.allocate_lock(),
                                  _caller_site())

            def RLock():
                guard.locks += 1
                return _RLockProxy(guard, orig_rlock(), _caller_site())

            threading.Lock = Lock
            threading.RLock = RLock
            self._active = True
        return self

    def uninstall(self) -> None:
        if not self._active:
            return
        with _PATCH_LOCK:
            self._active = False
            if self._orig is not None:
                # tolerate a nested guard having re-patched after us:
                # only restore what is still ours to restore
                threading.Lock, threading.RLock = self._orig
                self._orig = None

    # -- verdicts ------------------------------------------------------
    def report(self) -> Dict[str, Any]:
        with self._raw:
            cycles = [list(c) for c in self._cycles]
            held_long = list(self._held_long)
            n_edges = sum(len(v) for v in self._edges.values())
        held_max = max(self._held_max.values(), default=0.0)
        return {"name": self.name, "strict": self.strict,
                "held_ms_limit": self.held_ms, "locks": self.locks,
                "acquires": self.acquires, "edges": n_edges,
                "cycles": cycles, "held_too_long": held_long,
                "held_max_ms": round(held_max, 3)}

    def ok(self) -> bool:
        return not self._cycles and not self._held_long

    def check(self) -> None:
        """Raise (strict) or warn on recorded problems — called on
        clean exit only, never mid-critical-section."""
        if not self.enabled or self.ok():
            return
        rep = self.report()
        parts = []
        if rep["cycles"]:
            parts.append(f"{len(rep['cycles'])} lock-order cycle(s): "
                         + "; ".join(" -> ".join(c)
                                     for c in rep["cycles"][:3]))
        if rep["held_too_long"]:
            worst = max(rep["held_too_long"], key=lambda s: s[1])
            parts.append(f"{len(rep['held_too_long'])} held-too-long "
                         f"event(s), worst {worst[0]} at {worst[1]}ms "
                         f"(limit {self.held_ms}ms)")
        msg = f"[{self.name}] " + "; ".join(parts)
        if self.strict:
            raise LockOrderError(msg)
        warnings.warn(msg, RuntimeWarning, stacklevel=2)

    def __enter__(self) -> "LockGuard":
        return self.install()

    def __exit__(self, exc_type, exc, tb) -> None:
        self.uninstall()
        if exc_type is None:
            self.check()


def lock_guard_from_env(name: str = "lock-guard") -> LockGuard:
    """UT_LOCK_GUARD=1|true|yes|warn -> warn mode; =strict -> raise;
    unset -> inert guard (no patching, no overhead).
    UT_LOCK_GUARD_MS sets the held-too-long threshold in milliseconds
    (default 0 = off: held_max_ms is still reported)."""
    v = os.environ.get("UT_LOCK_GUARD", "").strip().lower()
    enabled = v in ("1", "true", "yes", "warn", "strict")
    strict = v == "strict" or os.environ.get(
        "UT_LOCK_GUARD_STRICT", "").strip().lower() in ("1", "true",
                                                        "yes")
    try:
        held_ms = float(os.environ.get("UT_LOCK_GUARD_MS", "0") or 0)
    except ValueError:
        held_ms = 0.0
    return LockGuard(strict=strict and enabled, held_ms=held_ms,
                     enabled=enabled, name=name)
