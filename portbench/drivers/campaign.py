"""g++ flag campaigns through the library Tuner with the calibrated GP
surrogate, back to back on one card: each campaign is a fresh
`Tuner(space, seed=..., surrogate="gp", surrogate_opts=...)` with the
configuration's `surrogate` options and the run-budget rule applied as
program mode applies it; it asks `ask` trials at a time, takes each
trial's QoR from the host's surface (`reference/surface.py`, standing in
for a build) and tells each one, and ends at the first ask at or past
`campaign_trials` told trials.  A unit of work is one ask and its tells.

The campaigns run in `tuner.processes` tuning processes on the host, in
turns and one at a time, as successive `ut` campaigns each run in a
process of their own: a process's host speed is its own for its life
(on the H100's host one process runs every campaign up to a quarter
slower than the next), so a window over several processes reads their
mean.  Each process runs torch on `host_threads` CPU threads.  A traced
run keeps its campaigns in the run's own process, where the profiler
sees the device's work.

Each process runs one whole campaign, drawn from the run's seed, before
the window, untimed, so that every training bucket's path is warm.  The
window runs the traffic's suite of campaigns (seeded from `suite_seed`,
the same in every run) back to back, campaign i in process i mod
`processes`; `acq_per_s` is the rows the surrogate scored in the
campaigns that end inside the window (each pull's pool and each prune's
batch, the managers' `rows_scored`) over those campaigns' seconds, so a
run's rate is of whole campaigns and not of where the window cuts one.
Where none ends by the window's close, the window runs on to the end of
its first.

The judgement: the trials every campaign offered and told, by the tenant
rules of `reference/tenants.py` (one tenant a campaign; a configuration
read as one float a parameter, an enum's option as its code), and the
manager's decisions, seen through its `watch`, against
`reference/manager.py` in float64 at the recorded points, in each
process: its warm campaign's last full fit and every full fit, prune and
pull of its share of `SAMPLED` asks of that campaign drawn from the
seed, its window's last full fit and those of its share of `SAMPLED`
window asks drawn from the seed.  At a full fit, the sweep's choice
(`fit_mll_gap`: the reference's best log evidence less that of the
program's point, a row) and the posterior at the chosen values on 64
told rows the fit left out; at a prune, the posterior on its eligible
rows and its keep set; at a pull, on its pool's rows that are no
training row, and its 8 rows.  A snapshot that holds rank-1 extensions
is held to the GP on its fit's rows and the rows folded in since, at
the fit's values and standardization.  Gaps are over the std the
snapshot standardizes its targets by, and read against float32's own
reach there: a plain float32 fit's widest gap from float64 on the same
rows and queries (at least 1e-5).  `value_gap`: the mean's and sd's
widest gap from the float64 reference, over that reach;
`topk_value_gap`: that of the EI of a pull's 8 rows, over float32's EI
reach; `prune_select_gap`: the best dropped eligible row's reference
EI less the worst kept non-explore row's, and `topk_select_gap`: the
reference's 8th best EI less the worst returned, or the returned
list's widest rise, each less twice float32's EI reach (a choice made
on float32 scores can pass over a row that much better).
`prune_malformed`: kept rows that were not eligible, explore rows
dropped, more than k or fewer than k less the explore rows kept by
rank; `topk_malformed`: not 8 distinct rows of the pool, or, ranking a
pool of one row repeated, any list but its first 8 indices;
`unjudged`: the kinds of decision (fit, prune, pull) of which none was
judged.  The processes' numbers are summed, or their widest taken.

With `--trace 1` the program's obs plane records in the traced part:
its spans go into `TraceCtx.extra["obs_spans"]`, its counters of the
rows the surrogate scored into `extra["obs_counters"]` and the records
its rings dropped into `extra["obs_dropped"]`."""
from __future__ import annotations

import dataclasses
import math
import sys
import time
import traceback
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional

import numpy as np

from .. import devtrace
from ..reference import gp as ref_gp
from ..reference import manager as ref_mgr
from ..reference import tenants as ref_tenants
from ..reference.surface import Surface
from .common import (Check, Outcome, Run, Sample, Spans, TraceCtx,
                     chunk_rates, launches, memory_peak, program_space,
                     reference_space, sub_seed, synchronize)

# the asks of the warm campaigns, and of the window, whose decisions are
# judged (shared out among the tuning processes)
SAMPLED = 5
PROBE_ROWS = 64
# the obs rings' records a thread in the traced part (far above what 10 s
# of campaigns record)
OBS_CAPACITY = 1 << 18
LIMITS = ("fit_mll_gap", "value_gap", "prune_select_gap", "topk_value_gap",
          "topk_select_gap")
# the least float32 reach a gap is read against, in the targets' std
FLOOR = 1e-5
# the seconds the run waits on a tuning process's answer before it gives
# the process up (a warm campaign with its process's start-up is the
# longest)
WAIT = 900.0


@dataclass
class Fit:
    snap: Any
    seed_word: int               # seeds the fit's host subsample
    campaign: "Campaign"


@dataclass
class Prune:
    snap: Any
    base: Fit                    # the last full fit: the snapshot, or the
                                 # one it extends
    campaign: "Campaign"
    cands: Any
    eligible: np.ndarray
    explore_u: np.ndarray
    keep: np.ndarray


@dataclass
class Pull:
    snap: Any
    base: Fit
    campaign: "Campaign"
    cands: Any
    best_y: Any
    idx: Any
    rank: Any                    # the manager's ranking of a batch at this
                                 # snapshot, for the tie probe


def base_of(it) -> Fit:
    return it if isinstance(it, Fit) else it.base


@dataclass
class Campaign:
    """One Tuner's campaign: what it offered and told, and the manager's
    decisions recorded while `on`."""
    tuner: Any
    told: int = 0
    seconds: float = 0.0         # its start, then its length
    rows: int = 0                # rows its surrogate scored
    cfgs: List[tuple] = field(default_factory=list)   # told, in order
    vals: List[float] = field(default_factory=list)
    us: List[np.ndarray] = field(default_factory=list)  # their unit rows,
                                                        # an ask a block
    record: Dict[str, Any] = field(default_factory=dict)
    on: bool = False
    last_fit: Optional[Fit] = None
    items: List[Any] = field(default_factory=list)

    def watch(self, what: str, d: Dict[str, Any]) -> None:
        """The manager's observer (`SurrogateManager.watch`): keeps
        references to what the judge reads.  Every full fit is kept as
        the campaign's last; prunes and pulls only while `on`."""
        if what == "fit":
            self.last_fit = Fit(d["snap"], d["seed_word"], self)
            if self.on:
                self.items.append(self.last_fit)
            return
        if not self.on:
            return
        snap = d["snap"]
        if what == "prune":
            keep = np.asarray(d["keep"], bool)
            elig = (np.ones(len(keep), bool) if d["eligible"] is None
                    else np.asarray(d["eligible"], bool))
            self.items.append(Prune(
                snap, self.last_fit, self, d["cands"], elig,
                np.asarray(d["explore_u"], np.float64), keep))
        elif what == "pull":
            self.items.append(Pull(snap, self.last_fit, self, d["cands"],
                                   d["best_y"], d["idx"], d["rank"]))


@dataclass
class Done:
    """A window campaign as its tuning process reports it: whether it
    ended (or was cut at the window's close), its seconds, the rows its
    surrogate scored, its told trials and its units."""
    index: int
    ended: bool
    seconds: float
    rows: int
    told: int
    units: int
    process: int


class Tuning:
    """One tuning process's campaigns: its warm campaign, the suite
    campaigns it is handed, each a fresh Tuner, and the judgement of
    what it recorded.  `k` numbers the process among the run's `of`."""

    def __init__(self, r: Run, k: int = 0, of: int = 1):
        cfg, tc = r.config, r.config["tuner"]
        if tc["technique"] != "default" or tc["surrogate"] != "gp":
            raise ValueError("the campaign runs the default root technique "
                             "with the GP surrogate")
        self.r, self.k, self.cfg, self.tc = r, k, cfg, tc
        self.surface = Surface(cfg)
        self.space = program_space(cfg["space"])
        self.names = [p["name"] for p in cfg["space"]]
        self.n_ask, self.trials = int(tc["ask"]), int(tc["campaign_trials"])
        self.suite = int(r.mix["suite_seed"])
        tag = "" if k == 0 else f".{k}"
        share = -(-SAMPLED // of)
        self.warm_sample = Sample(share, sub_seed(r.seed, "sample.warm" + tag))
        self.sample = Sample(share, sub_seed(r.seed, "sample" + tag))
        self.warm_seed = sub_seed(r.seed, "campaign.warm" + tag)
        self.campaigns: List[Campaign] = []
        self.warm_c: Optional[Campaign] = None
        self.cut: Optional[Campaign] = None     # the campaign the window cut
        self.units = 0                          # window units run here
        self.j: Optional[Judge] = None
        self.items: List[Any] = []     # the judged decisions
        self.note("surface and space built")

    def note(self, what: str) -> None:
        self.r.note(what if self.k == 0 else f"process {self.k}: {what}")

    def new_campaign(self, seed: int) -> Campaign:
        from uptune_tpu_torch.driver import Tuner
        tc = self.tc
        t = Tuner(self.space, seed=seed,
                  capacity=int(tc["history_capacity"]), surrogate="gp",
                  surrogate_opts=dict(self.cfg["surrogate"]),
                  device=self.r.device)
        m = t.surrogate
        if not (hasattr(m, "rows_scored") and hasattr(m, "watch")):
            raise RuntimeError("the program's surrogate manager counts no "
                               "rows_scored or has no watch: it cannot run "
                               "this cell")
        t._apply_budget_rule(int(tc["budget_rule_test_limit"]))
        c = Campaign(t, record={"seed": len(self.campaigns), "events": [],
                                "empty_asks": 0, "errors": 0},
                     seconds=time.perf_counter())
        m.watch = c.watch
        self.campaigns.append(c)
        return c

    def close(self, c: Campaign) -> None:
        """End a campaign: its length, its best and its count of
        committed tells for the judge, the rows its surrogate scored."""
        c.seconds = time.perf_counter() - c.seconds
        t = c.tuner
        res = t.result()
        c.record["best"] = {"config": res.best_config or None,
                            "qor": float(res.best_qor), "tells": t.evals,
                            "store_served": 0}
        c.told, c.rows = t.told, t.surrogate.rows_scored
        t.close()
        c.tuner = None

    def unit(self, c: Campaign, spans: Spans) -> int:
        t = c.tuner
        a = time.perf_counter_ns()
        try:
            got = t.ask(self.n_ask)
            b = time.perf_counter_ns()
            if not got:
                c.record["empty_asks"] += 1
                return 0
            cfgs = [tuple(tr.config[k] for k in self.names) for tr in got]
            us = np.stack([tr.ticket.u_np[tr.slot] for tr in got])
            vals = [float(v) for v in self.surface(cfgs)]
            d = time.perf_counter_ns()
            for tr, v in zip(got, vals):
                t.tell(tr, v)
        except Exception:                         # noqa: BLE001
            traceback.print_exc(file=sys.stderr)
            c.record["errors"] += 1
            return -1
        e = time.perf_counter_ns()
        spans.add("tuner.ask", a, b)
        spans.add("tuner.evaluate", b, d)
        spans.add("tuner.tell", d, e)
        c.cfgs.extend(cfgs)
        c.vals.extend(vals)
        c.us.append(us)
        c.record["events"].append({"cfgs": cfgs, "vals": vals,
                                   "told": len(cfgs), "replied": True})
        return len(cfgs)

    def done(self, c: Campaign, told: int) -> bool:
        return told < 0 or c.tuner.told >= self.trials

    def judged(self, sample: Sample, c: Campaign, k: int,
               spans: Spans) -> int:
        """One unit, its decisions kept when the sample takes it."""
        keep = sample.offer(k)
        c.on = keep
        n0 = len(c.items)
        told = self.unit(c, spans)
        c.on = False
        if keep:
            sample.put(k, c.items[n0:], True)
        return told

    def warm(self) -> Campaign:
        """The warm campaign, drawn from the run's seed: every bucket's
        path, untimed, and judged at its share of asks drawn from the
        seed."""
        c = self.new_campaign(self.warm_seed)
        self.note("tuner built")
        k = 0
        while True:
            k += 1
            if self.done(c, self.judged(self.warm_sample, c, k,
                                        Spans(False))):
                break
        self.close(c)
        self.warm_c = c
        synchronize(self.r.device)
        self.note(f"warm campaign done: {c.told} trials in "
                  f"{len(c.record['events'])} asks")
        return c

    def campaign(self, index: int, end: float, to_end: bool,
                 spans: Spans, after: Optional[Callable] = None) -> Done:
        """The suite's campaign `index`, a fresh Tuner, to its end; cut at
        the first ask that ends at or past `end` (time.time()) unless
        `to_end`.  `after(c)` follows every unit."""
        a = time.perf_counter_ns()
        c = self.new_campaign(sub_seed(self.suite, f"campaign.{index}"))
        spans.add("tuner.build", a, time.perf_counter_ns())
        n0 = self.units
        while True:
            told = self.judged(self.sample, c, self.units + 1, spans)
            self.units += 1
            if after is not None:
                after(c)
            if self.done(c, told):
                self.close(c)
                return Done(index, True, c.seconds, c.rows, c.told,
                            self.units - n0, self.k)
            if not to_end and time.time() >= end:
                self.cut = c
                return Done(index, False,
                            time.perf_counter() - c.seconds,
                            c.tuner.surrogate.rows_scored, c.tuner.told,
                            self.units - n0, self.k)

    def finish(self) -> int:
        """Close the campaign the window cut; the device memory's peak."""
        if self.cut is not None:
            self.close(self.cut)
            self.cut = None
        return memory_peak(self.r.device)

    def judge(self) -> Dict[str, Any]:
        """The numbers of this process's judgement (`verdict` reads
        them)."""
        warm = self.warm_c
        items = [warm.last_fit] + [x for s in (self.warm_sample, self.sample)
                                   for got in s.rest if got for x in got]
        last = next((x.last_fit for x in reversed(self.campaigns[1:])
                     if x.last_fit is not None), None)
        if last is not None and all(last is not x for x in items):
            items.append(last)
        self.items = [x for x in items if x is not None]
        self.j = Judge(self.r, self.cfg, self.space, self.surface)
        return self.j.judge(self.campaigns, self.items)

    def control(self) -> Dict[str, Any]:
        return self.j.control(self.items, "tf32")


def run(r: Run) -> Outcome:
    """The cell's run, with torch's CPU threads set to the configuration's
    `host_threads` and put back after."""
    import torch
    was = torch.get_num_threads()
    torch.set_num_threads(int(r.config["tuner"]["host_threads"]))
    try:
        n = int(r.config["tuner"]["processes"])
        return in_one(r) if r.trace or n == 1 else in_many(r, n)
    finally:
        torch.set_num_threads(was)


def window(seconds: float, one: Callable[[int, float, bool], Done]
           ) -> List[Done]:
    """The suite's campaigns back to back (`one(index, end, to_end)`)
    until the first that ends at or past the window's close, or is cut
    there: every campaign run, in order."""
    end = time.time() + seconds
    runs: List[Done] = []
    while True:
        d = one(len(runs), end, not any(x.ended for x in runs))
        runs.append(d)
        if not d.ended or time.time() >= end:
            return runs


def rate(runs: List[Done], trials: int) -> tuple:
    """(rows a second, the campaigns it is over): those that ended in
    the window whole (all that ended, where an error ended every one)."""
    ended = [x for x in runs if x.ended]
    whole = [x for x in ended if x.told >= trials] or ended
    return (sum(x.rows for x in whole)
            / sum(x.seconds for x in whole)), whole


def in_one(r: Run) -> Outcome:
    """Every campaign in this process (the traced run's way)."""
    from uptune_tpu_torch import obs
    p = Tuning(r)
    p.warm()
    spans = Spans(r.trace)
    marks, so_far = [], []
    rows_ended = 0
    w = devtrace.Window(r.trace)
    r.setup_done()
    cpu0 = time.process_time()
    t0 = time.perf_counter()
    w.open(r.seconds)
    l0 = launches()

    def after(c: Campaign) -> None:
        nonlocal l0, rows_ended
        marks.append(time.perf_counter())
        so_far.append(rows_ended + c.tuner.surrogate.rows_scored)
        if c.tuner.told >= p.trials:
            rows_ended = so_far[-1]
        if w.poll(p.units):
            l0 = launches()
            obs.enable(OBS_CAPACITY)
    try:
        runs = window(r.seconds, lambda i, end, to_end: p.campaign(
            i, end, to_end, spans, after))
        synchronize(r.device)
        t1 = time.perf_counter()
        cpu = time.process_time() - cpu0
        l1 = launches()
        w.close(p.units)
        found, dropped, counted = [], 0, {}
        if obs.enabled():
            snap = obs.snapshot()
            found = [devtrace.Span(e["name"], obs.to_unix_ns(e["ts"]),
                                   obs.to_unix_ns(e["ts"] + e["dur"]))
                     for e in snap["events"] if e.get("dur") is not None]
            dropped = sum(snap["dropped"].values())
            counted = {k: obs.counter_value(k) for k in (
                "surrogate.pool_rows", "surrogate.prune_rows")}
    finally:
        obs.reset()
    peak = p.finish()
    r.note(f"units a second by second {chunk_rates(marks, t0, 1)}")
    r.note(f"rows a second in the window's first and last fifth "
           f"{fifths(marks, so_far, t0, t1)}; the process's CPU seconds "
           f"over the window's {cpu / (t1 - t0):.3f}")
    if r.trace:
        r.note(f"obs counters over {w.units} traced units: {counted}; "
               f"records dropped {dropped}")
    ctx = TraceCtx(w.t0, w.t1, w.units, w.ops, spans.spans(),
                   {n: l1[n] - l0[n] for n in l1},
                   {"ask": p.n_ask, "campaign_trials": p.trials,
                    "features": p.space.n_surrogate_features},
                   {"obs_spans": found, "obs_counters": counted,
                    "obs_dropped": dropped})
    n = p.judge()
    return outcome(r, runs, n, peak, ctx, p.control)


def in_many(r: Run, k: int) -> Outcome:
    """The campaigns in `k` tuning processes, in turns."""
    if r.device.type == "cuda":
        from uptune_tpu_torch import native
        native.build()          # once, before the processes load it
    pool = Pool(r, k)
    try:
        pool.answers()          # every process warm
        r.setup_done()
        runs = window(r.seconds, lambda i, end, to_end: pool.call(
            i % k, "campaign", i, end, to_end))
        got = pool.ask_all("judge")
    except BaseException:
        pool.close()
        raise
    n = merge([x[0] for x in got])
    peak = max(x[1] for x in got)

    def control() -> Dict[str, Any]:
        return merge(pool.ask_all("control"))
    return outcome(r, runs, n, peak, TraceCtx(), control)


def outcome(r: Run, runs: List[Done], n: Dict[str, Any], peak: int,
            ctx: TraceCtx, control: Callable[[], Dict]) -> Outcome:
    trials = int(r.config["tuner"]["campaign_trials"])
    per_s, whole = rate(runs, trials)
    seconds = sum(x.seconds for x in whole)
    scored = sum(x.rows for x in whole)
    told = sum(x.told for x in runs)
    r.note(f"{len(whole)} whole campaigns in the window, "
           f"{sum(x.told for x in whole)} trials told, {scored} rows "
           f"scored in {seconds:.3f} s")
    r.note("campaigns of the window (process, seconds, rows scored, rows "
           "a second): " + ", ".join(
               f"({x.process}, {x.seconds:.3f}, {x.rows}, "
               f"{x.rows / x.seconds:.0f})" for x in runs))
    numbers = dict(n, units=sum(x.units for x in runs),
                   campaigns=len(whole), trials=told, rows_scored=scored,
                   campaign_seconds=seconds)
    return Outcome({"acq_per_s": per_s}, told, 0, verdict(n, r.limits),
                   peak, ctx, numbers,
                   lambda: dict(control(), precision="tf32"))


# -- the tuning processes ----------------------------------------------------
class Pool:
    """The run's tuning processes, started together (spawned: each opens
    the card itself), each warming its `Tuning` at once and then serving
    the run's requests (`serve`).  Closed when dropped."""

    def __init__(self, r: Run, k: int):
        import multiprocessing as mp
        ctx = mp.get_context("spawn")
        child = dataclasses.replace(r, setup_done=None)
        self.conns, self.procs = [], []
        for i in range(k):
            a, b = ctx.Pipe()
            p = ctx.Process(target=serve, args=(b, child, i, k),
                            name=f"tuning-{i}", daemon=True)
            p.start()
            b.close()
            self.conns.append(a)
            self.procs.append(p)

    def answer(self, i: int) -> Any:
        c = self.conns[i]
        try:
            if not c.poll(WAIT):
                raise RuntimeError(f"tuning process {i} gave no answer in "
                                   f"{WAIT:.0f} s")
            kind, what = c.recv()
        except (EOFError, OSError) as exc:
            raise RuntimeError(f"tuning process {i} ended: {exc!r}") from exc
        if kind == "error":
            raise RuntimeError(f"tuning process {i} failed:\n{what}")
        return what

    def answers(self) -> List[Any]:
        return [self.answer(i) for i in range(len(self.conns))]

    def call(self, i: int, *msg) -> Any:
        self.conns[i].send(msg)
        return self.answer(i)

    def ask_all(self, *msg) -> List[Any]:
        for c in self.conns:
            c.send(msg)
        return self.answers()

    def close(self) -> None:
        for c in self.conns:
            try:
                c.send(("stop",))
            except (OSError, ValueError):
                pass
        for p in self.procs:
            p.join(30)
            if p.is_alive():
                p.terminate()
                p.join(10)
        self.conns, self.procs = [], []

    def __del__(self):
        try:
            self.close()
        except Exception:                         # noqa: BLE001
            pass


def serve(conn, r: Run, k: int, of: int) -> None:
    """A tuning process: warm its campaign, then run what the run asks
    (a suite campaign, the judgement, the control) until told to stop."""
    import torch
    try:
        torch.set_num_threads(int(r.config["tuner"]["host_threads"]))
        if r.device.type == "cuda":
            torch.cuda.set_device(r.device)
        p = Tuning(r, k, of)
        p.warm()
        conn.send(("ok", None))
        while True:
            msg = conn.recv()
            if msg[0] == "stop":
                return
            if msg[0] == "campaign":
                out = p.campaign(*msg[1:], Spans(False))
            elif msg[0] == "judge":
                peak = p.finish()
                out = (p.judge(), peak)
            elif msg[0] == "control":
                out = p.control()
            else:
                raise ValueError(f"unknown request {msg[0]!r}")
            conn.send(("ok", out))
    except BaseException:                         # noqa: BLE001
        try:
            conn.send(("error", traceback.format_exc()))
        except (OSError, ValueError):
            pass


# the processes' numbers that add up; every other is the widest
SUMMED = ("invalid_trials", "repeat_offers", "tells_lost", "empty_asks",
          "errors", "tenants", "trials", "decode_mismatch", "prune_malformed",
          "topk_malformed", "fits_judged", "prunes_judged", "pulls_judged")


def merge(ns: List[Dict[str, Any]]) -> Dict[str, Any]:
    """The tuning processes' numbers as one: counts summed, readings the
    widest, each with where it was read."""
    out: Dict[str, Any] = {}
    for n in ns:
        for key, v in n.items():
            if key.endswith("_at") or not isinstance(v, (int, float)):
                continue
            if key in SUMMED:
                out[key] = out.get(key, 0) + v
            elif key not in out or v > out[key]:
                out[key] = v
                if key + "_at" in n:
                    out[key + "_at"] = n[key + "_at"]
    return out


def verdict(n: Dict[str, Any], limits: Dict[str, float]) -> List[Check]:
    """The checks of `correct` from the judgement's numbers: `unjudged`
    counts the kinds of decision none of which was judged."""
    n["unjudged"] = sum(n[k] == 0 for k in (
        "fits_judged", "prunes_judged", "pulls_judged"))
    names = ("invalid_trials", "repeat_offers", "tells_lost", "empty_asks",
             "errors", "best_gap", "decode_mismatch", "prune_malformed",
             "topk_malformed", "unjudged") + LIMITS
    return [Check(k, n[k], limits.get(k, 0)) for k in names]


# -- the judgement ----------------------------------------------------------
class Judge:
    """The manager's decisions at the recorded items against the float64
    reference, for the program or, as the control, for the reference in a
    lower precision put in its place (`Subject`)."""

    def __init__(self, r: Run, cfg: Dict[str, Any], space, surface):
        self.r, self.cfg = r, cfg
        self.space, self.surface = space, surface
        self.ref = reference_space(cfg)
        self.s = cfg["surrogate"]
        self.grid = cfg["fit_grid"]
        self.dev = r.device
        self._post: Dict[tuple, Any] = {}
        self._rows: Dict[int, tuple] = {}

    # what the tenants offered and told
    def tenants(self, campaigns: List[Campaign]) -> Dict:
        space, codes = [], []
        for p in self.cfg["space"]:
            if p["kind"] == "enum":
                space.append({"name": p["name"], "lo": 0.0,
                              "hi": float(len(p["options"]) - 1)})
                codes.append({o: float(i) for i, o in
                              enumerate(p["options"])})
            else:
                space.append({"name": p["name"], "lo": float(p["lo"]),
                              "hi": float(p["hi"])})
                codes.append(None)

        def read(x):
            return tuple(
                (m.get(v, math.nan) if m is not None else
                 float(v) if isinstance(v, int) and not isinstance(v, bool)
                 else math.nan) for v, m in zip(x, codes))
        recs = []
        for c in campaigns:
            rec = dict(c.record)
            rec["events"] = [dict(ev, cfgs=[read(x) for x in ev["cfgs"]])
                             for ev in rec["events"]]
            recs.append(rec)
        return ref_tenants.judge(recs, space, "float32",
                                 memory=int(self.cfg["tuner"][
                                     "history_capacity"]))

    # the rows a snapshot is fitted on, as the reference reads them
    def rows(self, c: Campaign, snap, base: Fit) -> np.ndarray:
        n = int(snap.n_rows)
        if snap.exact:
            return np.arange(n)
        ys32 = np.asarray(c.vals[:n], np.float32)
        return ref_mgr.fit_rows(ys32, int(base.seed_word),
                                int(self.s["max_points"]))

    def told_features(self, c: Campaign, idx: np.ndarray) -> tuple:
        """(the reference's features of told rows, their lanes the
        program decoded otherwise than the reference allows).  A row is
        read from its trial's unit vector, with the program's rounding
        taken on a lane where float32 and float64 may round either way
        (`RefSpace.resolve`): the manager learns a trial from the
        float32 decode of its unit vector, while the trial's
        configuration is the float64 decode."""
        import torch
        u = np.concatenate(c.us)[idx]
        pv = self.space.decode_scalars(torch.from_numpy(u)).numpy()
        vals, bad = self.ref.resolve(u, pv)
        return self.ref.features(u, vals, []), int(bad.sum())

    def training(self, it) -> tuple:
        """(x, y, rows, the rows of the targets' standardization: the last
        full fit's, the lanes decoded otherwise than allowed) of the
        item's snapshot."""
        import torch
        if id(it) not in self._rows:
            c, base = it.campaign, base_of(it)
            rows = self.rows(c, it.snap, base)
            feats, bad = self.told_features(c, rows)
            x = torch.tensor(feats, device=self.dev)
            y = torch.tensor(np.asarray(c.vals, np.float64)[rows],
                             device=self.dev)
            # an extension's rows follow its fit's (an exact snapshot's
            # rows are the told ones, in order)
            self._rows[id(it)] = (x, y, rows, int(base.snap.n_rows), bad)
        return self._rows[id(it)]

    @staticmethod
    def program_hp(snap) -> tuple:
        st = snap.state
        return (float(st.lengthscale), float(st.noise), float(st.ls_cat))

    def posterior(self, it, hp, precision: str):
        """The reference's posterior of the item's snapshot at `hp`, or
        None where its factorization fails."""
        key = (id(it.snap), hp, precision)
        if key not in self._post:
            x, y, _, n_std, _ = self.training(it)
            try:
                self._post[key] = ref_mgr.posterior(
                    x, y, hp, self.ref.n_cont, self.ref.n_cat, precision,
                    rows_std=n_std)
            except RuntimeError:
                self._post[key] = None
        return self._post[key]

    def moments(self, post, xq: np.ndarray):
        import torch
        mu, sd = ref_gp.moments(post, torch.as_tensor(xq, device=self.dev))
        return mu.double().cpu().numpy(), sd.double().cpu().numpy()

    def queries(self, it) -> tuple:
        """(the program's candidate batch, the reference's features of it,
        lanes decoded otherwise than the reference allows): a full fit's
        64 told rows it left out, drawn from the seed, as their trials'
        unit vectors; a prune's or a pull's batch."""
        from uptune_tpu_torch.space.spec import CandBatch
        if isinstance(it, Fit):
            c = it.campaign
            rng = np.random.default_rng(sub_seed(
                self.r.seed, f"probe.{it.snap.version}"))
            left = np.setdiff1d(np.arange(len(c.cfgs)),
                                self.training(it)[2])
            if not len(left):
                return None, np.zeros((0, 0)), 0
            idx = np.sort(rng.choice(left, min(PROBE_ROWS, len(left)),
                                     replace=False))
            import torch
            u = torch.from_numpy(np.concatenate(c.us)[idx])
            cands = CandBatch(u.to(self.dev), ())
        else:
            cands = it.cands
        u = cands.u.cpu().numpy()
        pv = self.space.decode_scalars(cands.u).cpu().numpy()
        vals, bad = self.ref.resolve(u, pv)
        return cands, self.ref.features(u, vals, []), int(bad.sum())

    @staticmethod
    def fresh(it, xq: np.ndarray, x) -> np.ndarray:
        """The rows whose values are read: a prune's eligible rows; every
        other batch's rows that are no training row (a pool's copies of
        the incumbent, which dedup drops before any build, and where
        float32's distances cancel to their rounding)."""
        if isinstance(it, Prune):
            return it.eligible
        seen = {r.tobytes() for r in x.double().cpu().numpy()}
        return np.array([r.tobytes() not in seen
                         for r in np.asarray(xq, np.float64)], bool)

    def best(self, it) -> float:
        """The incumbent the item's EI is read against."""
        if isinstance(it, Pull):
            return float(it.best_y)
        return float(np.min(it.campaign.vals[:int(it.snap.n_rows)]))

    def judge(self, campaigns: List[Campaign], items: List[Any]) -> Dict:
        """The numbers of the tenant rules and of the decisions at the
        items (`verdict` makes the checks of them)."""
        n = self.tenants(campaigns)
        n.update(self.numbers(items, Program(self)))
        return n

    def control(self, items: List[Any], precision: str) -> Dict:
        n = self.numbers(items, Lower(self, precision))
        return {k: n[k] for k in LIMITS}

    def numbers(self, items: List[Any], who: "Subject") -> Dict:
        n = {k: 0.0 for k in LIMITS}
        n.update(prune_malformed=0, topk_malformed=0, decode_mismatch=0,
                 fits_judged=0, prunes_judged=0, pulls_judged=0)
        with ref_mgr.no_tf32():
            for it in items:
                self.item(it, who, n)
        return n

    def item(self, it, who: "Subject", n: Dict) -> None:
        x, y, rows, n_std, bad_rows = self.training(it)
        # the std the snapshot's targets are standardized by
        scale = float(y[:n_std].std(correction=0))
        hp = who.hp(it)
        if isinstance(it, Fit):
            n["fits_judged"] += 1
            best, scores = ref_mgr.sweep(x, y, self.grid, self.ref.n_cont,
                                         self.ref.n_cat)
            got = scores.get(hp)
            if got is None:
                got = ref_mgr.log_evidence(x, y, *hp, self.ref.n_cont,
                                           self.ref.n_cat)
            self.widest(n, it, "fit_mll_gap",
                        (scores[best] - got) / len(rows))
            hp = self.program_hp(it.snap)
        post = self.posterior(it, hp, "float64")
        post32 = self.posterior(it, hp, "float32")
        cands, xq, bad = self.queries(it)
        n["decode_mismatch"] += bad + bad_rows
        if not len(xq):
            return
        got = who.moments(it, cands, xq, hp)
        if post is None or got is None:
            n["value_gap"] = math.inf
            return
        mu, sd = self.moments(post, xq)
        new = self.fresh(it, xq, x)
        # float32's own reach on this posterior: a plain float32 fit's
        # widest gap from float64 on the same rows and queries (a
        # posterior float32 cannot factor is not read)
        m32, s32 = self.moments(post32, xq) if post32 else (mu, sd)
        reach = (max(gap_of(m32[new], mu[new], scale),
                     gap_of(s32[new], sd[new], scale), FLOOR)
                 if post32 else math.inf)
        gap = max(gap_of(got[0][new], mu[new], scale),
                  gap_of(got[1][new], sd[new], scale))
        self.widest(n, it, "value_gap", gap / reach, gap, reach)
        if isinstance(it, Fit):
            return
        best = self.best(it)
        ei = ei_of(mu, sd, best)
        mine = ei_of(*got, best)
        e32 = ei_of(m32, s32, best)
        ereach = (max(gap_of(e32[new], ei[new], scale), FLOOR)
                  if post32 else math.inf)
        # a choice made on float32 scores can pass over a row up to
        # twice float32's own error on them better
        slack = 2.0 * ereach
        if isinstance(it, Prune):
            n["prunes_judged"] += 1
            self.prune(it, who.keep(it, mine), ei, scale, slack, n)
            return
        n["pulls_judged"] += 1
        k = int(self.s["propose_batch"])
        idx = who.top(it, mine, k)
        if (idx.shape != (k,) or len(set(idx.tolist())) != k
                or idx.min() < 0 or idx.max() >= len(ei)):
            n["topk_malformed"] += 1
            return
        gap = gap_of(mine[idx], ei[idx], scale)
        self.widest(n, it, "topk_value_gap", gap / ereach, gap, ereach)
        want, _ = ref_mgr.pull(ei, k)
        got_ei = ei[idx]
        miss = max(float(want[-1] - got_ei.min()),
                   float(np.max(got_ei[1:] - got_ei[:-1], initial=0.0)))
        self.widest(n, it, "topk_select_gap",
                    max(0.0, miss / scale - slack), miss / scale, slack)
        n["topk_malformed"] += who.ties(it, k)

    def prune(self, it: Prune, keep: np.ndarray, ei: np.ndarray,
              scale: float, slack: float, n: Dict) -> None:
        elig = it.eligible
        _, explore, k = ref_mgr.keep_set(ei, elig, it.explore_u,
                                         float(self.s["keep_frac"]),
                                         float(self.s["explore_frac"]))
        ranked = keep & ~explore
        bad = int((keep & ~elig).sum()) + int((explore & ~keep).sum())
        bad += int(ranked.sum() > k) + int(ranked.sum() < k - explore.sum())
        n["prune_malformed"] += bad
        dropped = elig & ~keep
        if ranked.any() and dropped.any():
            miss = (float(ei[dropped].max()) - float(ei[ranked].min())) \
                / scale
            self.widest(n, it, "prune_select_gap", max(0.0, miss - slack),
                        miss, slack)

    def widest(self, n: Dict, it, name: str, reading: float,
               gap: float = 0.0, reach: float = 0.0) -> None:
        """Fold one item's reading in, with where the widest was read:
        (what, rows, rows of its last full fit, lengthscale, the gap and
        what it is read against)."""
        if reading > n[name]:
            n[name] = reading
            n[name + "_at"] = [type(it).__name__, int(it.snap.n_rows),
                               int(base_of(it).snap.n_rows),
                               self.program_hp(it.snap)[0], gap, reach]


class Subject:
    """Whose decisions are judged: the program's, or the control's."""

    def __init__(self, j: Judge):
        self.j = j


class Program(Subject):
    def hp(self, it) -> tuple:
        return self.j.program_hp(it.snap)

    def moments(self, it, cands, xq, hp):
        from uptune_tpu_torch.surrogate import gp
        space = self.j.space
        mu, sd = gp.predict(it.snap.state, space.surrogate_features(cands),
                            space.n_cont_features, space.n_cat)
        return mu.double().cpu().numpy(), sd.double().cpu().numpy()

    def keep(self, it: Prune, ei) -> np.ndarray:
        return it.keep

    def top(self, it: Pull, ei, k: int) -> np.ndarray:
        return it.idx.cpu().numpy().astype(np.int64)

    def ties(self, it: Pull, k: int) -> int:
        return tie_probe(it, k)


class Lower(Subject):
    """The reference in a lower precision in the program's place: its
    own sweep at a full fit, its posterior at the program's values
    elsewhere, and the decisions its EI makes."""

    def __init__(self, j: Judge, precision: str):
        super().__init__(j)
        self.precision = precision

    def hp(self, it) -> tuple:
        if not isinstance(it, Fit):
            return self.j.program_hp(it.snap)
        x, y, _, _, _ = self.j.training(it)
        best, _ = ref_mgr.sweep(x, y, self.j.grid, self.j.ref.n_cont,
                                self.j.ref.n_cat, self.precision)
        return best

    def moments(self, it, cands, xq, hp):
        post = self.j.posterior(it, hp, self.precision)
        return None if post is None else self.j.moments(post, xq)

    def keep(self, it: Prune, ei) -> np.ndarray:
        keep, _, _ = ref_mgr.keep_set(
            ei, it.eligible, it.explore_u,
            float(self.j.s["keep_frac"]), float(self.j.s["explore_frac"]))
        return keep

    def top(self, it: Pull, ei, k: int) -> np.ndarray:
        return ref_mgr.pull(ei, k)[1].astype(np.int64)

    def ties(self, it: Pull, k: int) -> int:
        return 0


def fifths(marks: List[float], scored: List[int], t0: float, t1: float
           ) -> List[float]:
    """Rows scored a second in the window's first and last fifth, from
    the running count at each unit's end: a diagnostic of drift."""
    m, n = np.asarray(marks), np.asarray(scored, np.float64)
    fifth = (t1 - t0) / 5

    def at(t):
        i = np.searchsorted(m, t, side="right")
        return n[i - 1] if i else 0.0
    return [round(float(at(t0 + fifth)) / fifth, 1),
            round(float(n[-1] - at(t1 - fifth)) / fifth, 1)] if len(m) else []


def span_ms(ctx, name: str) -> Optional[float]:
    """The time of the program's `name` spans inside the traced window,
    over its units, in ms; None where the program has no such span (the
    readers of the `surrogate.*_ms` metrics)."""
    spans = [s for s in ctx.extra.get("obs_spans") or ()
             if s.name == name and s.start >= ctx.t0 and s.end <= ctx.t1]
    if not spans or not ctx.units:
        return None
    return sum(s.end - s.start for s in spans) / 1e6 / ctx.units


def gap_of(got, want, scale: float) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    if not len(want):
        return 0.0
    return float(np.max(np.abs(got - want))) / scale


def ei_of(mu, sd, best: float) -> np.ndarray:
    import torch
    return ref_gp.expected_improvement(
        torch.as_tensor(mu, dtype=torch.float64),
        torch.as_tensor(sd, dtype=torch.float64), best).numpy()


def tie_probe(it: Pull, k: int) -> int:
    """The manager's ranking of a pool of its first row repeated: 1 when
    the list is not the pool's first k indices (ties to the lowest),
    else 0."""
    from uptune_tpu_torch.space.spec import CandBatch
    c = it.cands
    rep = CandBatch(c.u[:1].expand_as(c.u).contiguous(),
                    tuple(p[:1].expand_as(p).contiguous() for p in c.perms))
    idx = it.rank(rep).cpu().numpy()
    return int(not np.array_equal(idx, np.arange(k)))

