"""Deterministic fault injection for the crash-safety planes.

The failover story — durable session checkpoints, lossless restart,
client auto-resume — is only as trustworthy as the crashes it was
tested against, and wall-clock SIGKILLs land wherever the scheduler
happens to be.  This registry gives tests and the failover benchmarks
*schedule-driven* faults instead: a named point in the code calls
``faults.fire("ckpt.append")`` and an armed schedule decides, purely
by hit count, whether that exact call crashes the process, sleeps, or
raises — the same run replays the same fault on every box.

Contract (the obs one-flag-check no-op pattern, same as `obs.span` /
`journal.emit`): ``fire`` checks one module-level bool FIRST and
returns immediately when nothing is armed — the call sites live in
the wire loops, the checkpoint appender, the store recorder and the
pool reaper permanently, at the cost of one flag check.  Arming is
test/bench-only, never a production mode.

Points (the seams future shard-failover work reuses):

* ``wire.accept``  — a connection was accepted (serve/wire.py)
* ``wire.read``    — a request line was read, before dispatch
* ``wire.reply``   — a response is about to be written
* ``ckpt.append``  — a session checkpoint record is about to be
  appended (serve/durable.py) — crashing HERE is the
  commit-vs-checkpoint window the bounded-loss contract is about
* ``store.record`` — a trial row is about to be recorded
* ``rstore.append`` — the networked store server (store/server.py)
  is about to durably append an accepted row — crashing HERE is the
  ack-after-durable window the zero-acked-loss contract is about
  (the remote-store benchmark's deterministic kill)
* ``pool.reap``    — a worker-pool build is about to be reaped
* ``route.spawn``  — the front-tier router is about to spawn (or
  respawn) a shard process (serve/router.py)
* ``route.kill``   — fired once per router supervisor tick; arming it
  with ``error`` makes the supervisor SIGKILL its lowest-index live
  shard on that exact tick — the deterministic shard-death injection
  the sharded-serving benchmark replays on every box

Actions: ``crash`` (``os._exit`` — no atexit, no flush: the closest
in-process stand-in for SIGKILL), ``delay`` (sleep `param` seconds),
``error`` (raise ``FaultInjected``, an OSError the defensive walls
treat like any I/O failure).  A rule fires on exact hit number
(``at=N``, 1-based) or every N-th hit (``every=N``).

Env seam: ``UT_FAULTS="ckpt.append=crash@12,wire.read=delay@3:0.05"``
arms a child process at import-arming call sites (`ut serve` reads it
at startup) — how a failover benchmark crashes a real serving
process at a deterministic checkpoint append.
"""
from __future__ import annotations

import os
import threading
import time
from typing import Any, Dict, Iterator, List, Optional, Tuple

__all__ = ["FaultInjected", "POINTS", "ACTIONS", "armed", "arm",
           "disarm", "fire", "hits", "schedules", "parse_spec",
           "maybe_arm_from_env", "ENV_VAR"]

ENV_VAR = "UT_FAULTS"

POINTS = ("wire.accept", "wire.read", "wire.reply", "ckpt.append",
          "store.record", "rstore.append", "pool.reap", "route.spawn",
          "route.kill")

ACTIONS = ("crash", "delay", "error")

CRASH_EXIT_CODE = 137           # what a SIGKILLed child's 128+9 reads as


class FaultInjected(OSError):
    """An armed `error` schedule fired at a fault point."""


class _Rule:
    """One armed schedule entry: action + when it fires."""

    __slots__ = ("action", "at", "every", "param", "fired")

    def __init__(self, action: str, at: Optional[int],
                 every: Optional[int], param: Optional[float]):
        if action not in ACTIONS:
            raise ValueError(
                f"unknown fault action {action!r}; valid: {ACTIONS}")
        if (at is None) == (every is None):
            raise ValueError("exactly one of at=/every= must be given")
        if at is not None and at < 1:
            raise ValueError(f"at= is a 1-based hit number: {at}")
        if every is not None and every < 1:
            raise ValueError(f"every= must be >= 1: {every}")
        self.action = action
        self.at = at
        self.every = every
        self.param = param
        self.fired = 0

    def matches(self, n: int) -> bool:
        if self.at is not None:
            return n == self.at
        return n % self.every == 0

    def describe(self) -> Dict[str, Any]:
        out: Dict[str, Any] = {"action": self.action,
                               "fired": self.fired}
        if self.at is not None:
            out["at"] = self.at
        if self.every is not None:
            out["every"] = self.every
        if self.param is not None:
            out["param"] = self.param
        return out


_ARMED = False                  # the ONE flag fire() checks first
_LOCK = threading.Lock()
_RULES: Dict[str, List[_Rule]] = {}
_HITS: Dict[str, int] = {}


def armed() -> bool:
    return _ARMED


def hits(point: Optional[str] = None):
    """Hit counters (all points, or one) — counted only while armed."""
    with _LOCK:
        if point is not None:
            return _HITS.get(point, 0)
        return dict(_HITS)


def schedules() -> Dict[str, List[Dict[str, Any]]]:
    with _LOCK:
        return {p: [r.describe() for r in rs]
                for p, rs in _RULES.items()}


def arm(point: str, action: str, *, at: Optional[int] = None,
        every: Optional[int] = None,
        param: Optional[float] = None) -> None:
    """Arm one schedule rule at a named point.  Unknown points are
    rejected eagerly — a typo must fail the test arming it, not
    silently never fire."""
    global _ARMED
    if point not in POINTS:
        raise ValueError(
            f"unknown fault point {point!r}; valid: {POINTS}")
    rule = _Rule(action, at, every, param)
    with _LOCK:
        _RULES.setdefault(point, []).append(rule)
        _ARMED = True


def disarm(point: Optional[str] = None) -> None:
    """Drop one point's schedules (or everything), resetting hit
    counters; the flag drops with the last schedule so disarmed cost
    returns to one flag check."""
    global _ARMED
    with _LOCK:
        if point is None:
            _RULES.clear()
            _HITS.clear()
        else:
            _RULES.pop(point, None)
            _HITS.pop(point, None)
        _ARMED = bool(_RULES)


def fire(point: str) -> None:
    """The call-site seam.  Disarmed: one module-flag check, nothing
    allocated, nothing locked (no **kwargs either — an empty kwargs
    dict per call would tax the disarmed wire/store hot paths).
    Armed: count the hit and apply any matching rule — crash exits
    the process immediately (no atexit, no buffered flush: the
    SIGKILL stand-in), delay sleeps, error raises FaultInjected for
    the caller's normal error walls."""
    if not _ARMED:
        return
    _fire(point)


def _fire(point: str) -> None:
    with _LOCK:
        n = _HITS.get(point, 0) + 1
        _HITS[point] = n
        todo = [r for r in _RULES.get(point, ()) if r.matches(n)]
        for r in todo:
            r.fired += 1
    for r in todo:
        if r.action == "crash":
            # os._exit, not sys.exit: no exception unwind, no atexit,
            # no flush — committed state must already be durable
            os._exit(int(r.param) if r.param is not None
                     else CRASH_EXIT_CODE)
        elif r.action == "delay":
            time.sleep(float(r.param) if r.param is not None else 0.05)
        else:
            raise FaultInjected(
                f"injected fault at {point} (hit {n})")


def parse_spec(spec: str) -> Iterator[Tuple[str, str, int, int,
                                            Optional[float]]]:
    """Parse the UT_FAULTS grammar into arm() argument tuples:
    ``point=action@N[:param]`` (exact hit) or
    ``point=action%N[:param]`` (every N-th), comma-separated.
    Yields (point, action, at, every, param) with exactly one of
    at/every non-zero."""
    for entry in str(spec).split(","):
        entry = entry.strip()
        if not entry:
            continue
        point, sep, rest = entry.partition("=")
        if not sep:
            raise ValueError(f"bad fault spec {entry!r}: no '='")
        param: Optional[float] = None
        if ":" in rest:
            rest, _, ptxt = rest.partition(":")
            param = float(ptxt)
        at = every = 0
        if "@" in rest:
            action, _, ntxt = rest.partition("@")
            at = int(ntxt)
        elif "%" in rest:
            action, _, ntxt = rest.partition("%")
            every = int(ntxt)
        else:
            action, at = rest, 1
        yield point.strip(), action.strip(), at, every, param


def maybe_arm_from_env(env: Optional[dict] = None) -> int:
    """``UT_FAULTS=<spec>`` arms this process's fault schedules (the
    seam a failover benchmark uses to crash a child `ut serve` at a
    deterministic fault-point hit).  Returns the number of rules
    armed; unset/empty arms nothing."""
    e = os.environ if env is None else env
    spec = e.get(ENV_VAR, "").strip()
    if not spec:
        return 0
    n = 0
    for point, action, at, every, param in parse_spec(spec):
        arm(point, action, at=at or None, every=every or None,
            param=param)
        n += 1
    return n
