"""A load-generating client process of the serving cells.

    python3 portbench/drivers/serve_client.py   (its job on stdin)

It reads one JSON job line on stdin (the server's port, the space's
records, the tenants of each of its connections, the ask size, the
offered rate), opens one connection a thread and the connection's
tenants on it, drives each connection's first tenant through the
warm-up epochs, and prints `{"ready": ...}`.  On `{"t0", "t1"}`
(time.monotonic()'s clock, shared by the processes of the host) every
connection runs its turns: they arrive as a Poisson process at its share
of the offered rate, drawn from its seed; at each it asks for its
current tenant, evaluates the objective here and tells the whole ask
back with `tell_many`, and moves to its next tenant once that tenant's
epoch commits.  A turn that arrives while the connection is busy starts
when the connection is free, so at a rate above the server's capacity
each connection runs its turns back to back.  An ask's latency runs from
its request's send to its reply; how late each turn started is kept
apart.  No turn starts at or after t1.  It then prints
`{"stopped": ...}`, with any module of JAX or the JAX package that this
process holds, and on `{"judge": path}` reads every tenant's `best`,
writes what it offered, told and read to `path`, closes its connections
and prints `{"done": true}`.  It imports neither torch nor NumPy.  What
set-up made is frozen out of the cyclic collector's walks before the
window, and what a turn records is tuples of floats, which it stops
tracking."""
from __future__ import annotations

import gc
import json
import random
import sys
import threading
import time


def rosenbrock(x):
    return sum(100.0 * (x[i + 1] - x[i] ** 2) ** 2 + (1.0 - x[i]) ** 2
               for i in range(len(x) - 1))


class Connection:
    def __init__(self, job, seeds):
        from uptune_tpu_torch.serve.client import connect
        self.job = job
        self.names = [r["name"] for r in job["records"]]
        self.client = connect(("127.0.0.1", job["port"]))
        self.handles = [self.client.open_session(
            job["records"], seed=s, program=job["program"],
            history_capacity=job["history"], store=job["store"])
            for s in seeds]
        self.tenants = [{"seed": s, "session": h.id, "events": [],
                         "commits": 0, "empty_asks": 0, "errors": 0}
                        for s, h in zip(seeds, self.handles)]
        self.lat = []                 # (send, seconds) of each ask
        self.late = []                # seconds each turn started late
        self.told = 0                 # trials told in the window
        self.requests = 0
        self.failed = 0
        self.t_last = 0.0

    def epoch_part(self, i: int, timed: bool, due: float = 0.0) -> bool:
        """One ask and its tell for tenant i, its turn due at `due`:
        whether its epoch committed (or it had nothing to offer)."""
        h, rec = self.handles[i], self.tenants[i]
        a = time.monotonic()
        if timed:
            self.late.append(a - due)
        try:
            trials = h.ask(self.job["ask"])
        except Exception as exc:      # noqa: BLE001  (counted, judged)
            rec["errors"] += 1
            self.failed += timed
            print(f"serve client: ask: {exc!r}", file=sys.stderr)
            return True
        b = time.monotonic()
        if timed:
            self.lat.append((a, b - a))
            self.requests += 1
        if not trials:
            rec["empty_asks"] += 1
            return True
        # tuples of floats, which the cyclic collector stops tracking
        cfgs = tuple(tuple(t.config[n] for n in self.names) for t in trials)
        vals = tuple(rosenbrock(x) for x in cfgs)
        try:
            r = h.tell_many(list(zip((t.ticket for t in trials), vals)))
        except Exception as exc:      # noqa: BLE001
            rec["errors"] += 1
            self.failed += timed
            rec["events"].append({"cfgs": cfgs, "vals": vals, "told": 0,
                                  "replied": False})
            print(f"serve client: tell: {exc!r}", file=sys.stderr)
            return True
        self.t_last = time.monotonic()
        n_err = len(r.get("errors") or ())
        rec["errors"] += n_err
        rec["events"].append({"cfgs": cfgs, "vals": vals,
                              "told": int(r.get("told", 0)),
                              "replied": True})
        if timed:
            self.requests += 1
            self.told += int(r.get("told", 0))
            self.failed += bool(n_err)
        if r.get("committed"):
            rec["commits"] += 1
            return True
        return False

    def warm(self, epochs: int) -> None:
        for _ in range(epochs):
            while not self.epoch_part(0, False):
                pass

    def drive(self, t0: float, t1: float, rate: float, seed: int) -> None:
        rng = random.Random(seed)
        i = 1 % len(self.handles)
        due = t0 + rng.expovariate(rate)
        while due < t1:
            wait = due - time.monotonic()
            if wait > 0:
                time.sleep(wait)
            elif time.monotonic() >= t1:
                break
            if self.epoch_part(i, True, due):
                i = (i + 1) % len(self.handles)
            due += rng.expovariate(rate)


FORBIDDEN = ("jax", "jaxlib", "flax", "uptune_tpu")


def forbidden_modules() -> list:
    """Top-level names in sys.modules that are JAX or the JAX package,
    compared whole (`uptune_tpu_torch` is not `uptune_tpu`)."""
    return sorted({n.split(".", 1)[0] for n in list(sys.modules)}
                  & set(FORBIDDEN))


def main() -> int:
    job = json.loads(sys.stdin.readline())
    sys.path.insert(0, job["root"])
    t_start = time.monotonic()
    conns = [None] * len(job["connections"])

    def open_one(j):
        conns[j] = Connection(job, job["connections"][j])
        t = time.monotonic()
        conns[j].warm(job["warm_epochs"])
        print(f"serve client: connection {j} opened in "
              f"{t - t_start:.3f} s, warm in {time.monotonic() - t:.3f} s",
              file=sys.stderr, flush=True)
    ts = [threading.Thread(target=open_one, args=(j,))
          for j in range(len(conns))]
    for t in ts:
        t.start()
    for t in ts:
        t.join()
    if any(c is None for c in conns):
        return 1
    print(f"serve client: {sum(len(c.handles) for c in conns)} tenants "
          f"open and warm in {time.monotonic() - t_start:.3f} s",
          file=sys.stderr, flush=True)
    print(json.dumps({"ready": True}), flush=True)
    go = json.loads(sys.stdin.readline())
    rate = job["asks_per_s"] / job["connections_total"]
    ts = [threading.Thread(target=c.drive, args=(go["t0"], go["t1"], rate,
                                                 seed))
          for c, seed in zip(conns, job["arrival_seeds"])]
    gc.collect()
    gc.freeze()                     # set-up's objects, out of its walks
    for t in ts:
        t.start()
    for t in ts:
        t.join()
    lat = [x for c in conns for x in c.lat if go["t0"] <= x[0] < go["t1"]]
    print(json.dumps({"stopped": True,
                      "t_last": max(c.t_last for c in conns),
                      "told": sum(c.told for c in conns),
                      "requests": sum(c.requests for c in conns),
                      "failed": sum(c.failed for c in conns),
                      "ask_s": [s for _, s in lat],
                      "late_s": [x for c in conns for x in c.late],
                      "forbidden": forbidden_modules()}),
          flush=True)
    cmd = json.loads(sys.stdin.readline())
    tenants = []
    for c in conns:
        for h, rec in zip(c.handles, c.tenants):
            rec["best"] = h.best()
            tenants.append(rec)
        c.client.close()
    with open(cmd["judge"], "w") as f:
        json.dump(tenants, f)
    print(json.dumps({"done": True}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
