"""The library Tuner's window: one `Tuner` in this process, closed loop:
`ask(n)` (the driver's bucket), evaluate every trial on the host, `tell`
each; a unit of work is one ask and its tells.

The configuration's `tuner` block gives the ask size and the history's
capacity.  `trials_per_s` is every trial told in the window over the
window.  After it, the trials asked and told are judged by the reference
(`reference/tenants.py`) as one tenant whose best the Tuner keeps in
float32."""
from __future__ import annotations

import time

from .. import devtrace, stats, syncs
from ..reference import tenants as ref_tenants
from ..reference.objectives import rosenbrock_py
from .common import (Check, Outcome, Run, Spans, TraceCtx, chunk_rates,
                     launches,
                     memory_peak, program_space, sub_seed, synchronize)

# units before the window: the first loads the kernels, the second runs
# them warm
WARM_UNITS = 2


def run(r: Run) -> Outcome:
    from uptune_tpu_torch.driver import Tuner
    from uptune_tpu_torch.driver.plugins import SearchHook
    tc = r.config["tuner"]
    names = [p["name"] for p in r.config["space"]]

    class Tickets(SearchHook):
        n = 0

        def on_step(self, tuner, stats):
            Tickets.n += 1
    t = Tuner(program_space(r.config["space"]),
              seed=sub_seed(r.seed, "tuner"), capacity=int(tc["capacity"]),
              hooks=[Tickets()], device=r.device)
    r.note("tuner built")
    record = {"seed": r.seed, "events": [], "empty_asks": 0, "errors": 0}
    n_ask = int(tc["ask"])

    def unit(spans: Spans) -> int:
        a = time.perf_counter_ns()
        trials = t.ask(n_ask)
        b = time.perf_counter_ns()
        if not trials:
            record["empty_asks"] += 1
            return 0
        # tuples of floats, which the cyclic collector stops tracking,
        # so that the growing record adds nothing to its traversals
        cfgs = tuple(tuple(tr.config[k] for k in names) for tr in trials)
        vals = tuple(rosenbrock_py(x) for x in cfgs)
        c = time.perf_counter_ns()
        for tr, v in zip(trials, vals):
            t.tell(tr, v)
        d = time.perf_counter_ns()
        spans.add("tuner.ask", a, b)
        spans.add("tuner.evaluate", b, c)
        spans.add("tuner.tell", c, d)
        record["events"].append({"cfgs": cfgs, "vals": vals,
                                 "told": len(trials), "replied": True})
        return len(trials)

    spans = Spans(r.trace)
    for _ in range(WARM_UNITS):
        unit(Spans(False))
    synchronize(r.device)
    r.note("warm units done")
    told = units = 0
    marks = []
    w = devtrace.Window(r.trace)
    sc = syncs.Counter()

    def traced_part():
        """The traced part begins: its counters start from here."""
        sc.start()
        return launches(), Tickets.n
    r.setup_done()
    t0 = time.perf_counter()
    l0, k0 = launches(), Tickets.n
    if w.open(r.seconds):
        l0, k0 = traced_part()
    end = t0 + r.seconds
    while time.perf_counter() < end:
        told += unit(spans)
        units += 1
        marks.append(time.perf_counter())
        if w.poll(units):
            l0, k0 = traced_part()
    synchronize(r.device)
    t1 = time.perf_counter()
    l1, k1 = launches(), Tickets.n
    sc.stop()
    w.close(units)
    peak = memory_peak(r.device)
    r.note(f"units a second by second {chunk_rates(marks, t0, 1)}")
    res = t.result()
    record["best"] = {"config": res.best_config or None,
                      "qor": float(res.best_qor), "tells": t.told,
                      "store_served": 0}
    t.close()
    ctx = TraceCtx(w.t0, w.t1, w.units, w.ops, spans.spans(),
                   {n: l1[n] - l0[n] for n in l1}, {},
                   {"syncs": sc.n if r.trace else None,
                    "tickets": k1 - k0})
    memory = int(tc["capacity"])
    n = ref_tenants.judge([record], r.config["space"], "float32",
                          memory=memory)
    checks = [Check(k, n[k], r.limits[k])
              for k in ("invalid_trials", "repeat_offers", "tells_lost",
                        "empty_asks", "best_gap")]
    return Outcome({"trials_per_s": stats.rate(told, t1 - t0)}, told, 0,
                   checks, peak, ctx, dict(n, units=units),
                   lambda: dict(ref_tenants.judge(
                       [record], r.config["space"], "float32",
                       lower="bfloat16", memory=memory),
                       precision="bfloat16"))

