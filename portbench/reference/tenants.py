"""The judgement of served or library tenants, in plain Python: what
each offered and told, against the configuration's guarantees.

A tenant's record holds its events (each ask's configurations, the
values told for them, whether the tell was answered and the count it
acknowledged), and what the
program reported last (`best`: the configuration, the QoR and the count
of tells applied).  The reference's best is the least value the tenant
told, or one the memo served it (then its configuration's value, which
the reference recomputes, is the best's).  `lower` rounds the
reference's best to a lower precision: the control."""
from __future__ import annotations

import math
from typing import Dict, List, Optional

from .objectives import lower as to_lower
from .objectives import rosenbrock_py


# rows of one ticket that eviction may drop before an older row of the
# same age (ties at the threshold age go in hash order)
TICKET_SLACK = 128


def judge(tenants: List[dict], space: List[dict], best_dtype: str,
          lower: Optional[str] = None,
          memory: Optional[int] = None) -> Dict[str, float]:
    """-> {invalid_trials, repeat_offers, tells_lost, empty_asks,
    errors, best_gap}.  `best_dtype` is the precision the program keeps
    a tenant's best in ("float64" as told, or "float32").  `memory` is
    the history's capacity where it bounds what the tenant's dedup sees
    (oldest rows evicted first): a configuration told more than that
    many distinct configurations ago may be offered again.  None: no
    repeat ever (the served memo store remembers every tell)."""
    names = [p["name"] for p in space]
    # the program keeps a float lane's bounds and values in float32: a
    # value is a member when it lies within the bounds as float32 holds
    # them (2.048 is 2.0480000972747803 there)
    lo = [to_lower(p["lo"], "float32") for p in space]
    hi = [to_lower(p["hi"], "float32") for p in space]
    n = {"invalid_trials": 0, "repeat_offers": 0, "tells_lost": 0,
         "empty_asks": 0, "errors": 0, "best_gap": 0.0, "tenants": 0,
         "trials": 0}
    reach = math.inf if memory is None else memory - TICKET_SLACK
    for t in tenants:
        told: Dict[tuple, float] = {}
        first: Dict[tuple, int] = {}    # index among distinct tells
        acked = 0
        for ev in t["events"]:
            cfgs, vals, n_told = ev["cfgs"], ev["vals"], ev["told"]
            for x in cfgs:
                if len(x) != len(names) or not all(
                        isinstance(v, float) and math.isfinite(v)
                        and a <= v <= b for v, a, b in zip(x, lo, hi)):
                    n["invalid_trials"] += 1
                if tuple(x) in told and len(first) - first[tuple(x)] < reach:
                    n["repeat_offers"] += 1
            if ev["replied"]:
                for x, v in zip(cfgs, vals):
                    told[tuple(x)] = v
                    first.setdefault(tuple(x), len(first))
                n["tells_lost"] += len(cfgs) - n_told
            acked += n_told
            n["trials"] += len(cfgs)
        best = t["best"]
        n["tells_lost"] += abs(int(best.get("tells", 0)) - acked)
        n["empty_asks"] += t["empty_asks"]
        n["errors"] += t["errors"]
        n["tenants"] += 1
        if not told:
            continue
        want = min(told.values())
        if lower:
            got = to_lower(want, lower)
        else:
            got = best.get("qor")
        n["best_gap"] = max(n["best_gap"], _gap(got, want, best, names,
                                                best_dtype))
    return n


def _gap(got, want: float, best: dict, names, best_dtype: str) -> float:
    """How far the program's best lies from the reference's: 0 when it
    is the reference's least told value kept in `best_dtype`, or a
    better value whose configuration evaluates to it."""
    if got is None or not math.isfinite(got):
        return math.inf
    if best_dtype != "float64":
        want = to_lower(want, best_dtype)
    if got < want and best.get("config") and best.get("store_served"):
        cfg = best["config"]
        x = [cfg[k] for k in names]
        v = rosenbrock_py(x)
        if best_dtype != "float64":
            v = to_lower(v, best_dtype)
        if math.isclose(v, got, rel_tol=1e-12, abs_tol=0.0):
            return 0.0
    return abs(got - want) / max(abs(want), 1e-300)
