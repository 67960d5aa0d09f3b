"""The acquisition search of a deployment whose objective is a build:
`FusedEngine` with no device objective, each step scored by the GP's
expected improvement (launcher C), then one `propose_topk` (launcher D)
that picks the next batch of builds.

Mix parameters as `engine`'s: `eval` ("ei" only) and `topk` (k).  The
GP is fitted from the configuration's archived trials and rows drawn
from the seed (`reference/gcc.py`); the reference's GP is fitted on the
same rows, each decoded as a judged row is (the program's rounding
taken on a lane float32 may round either way, any other difference a
`decode_mismatch`).  A unit of work is one step and its `propose_topk`;
`acq_per_s` counts the 2 x rows they score.  The units judged and the
judgement are `engine`'s.

With `--trace 1` the program's obs plane records while the window is
traced: its spans (`acquire.features` among them), on the profiler's
clock, go into `TraceCtx.extra["obs_spans"]`, and the launches of B, C
and D in the traced part by their kernel-rows route into
`extra["route_launches"]`.  A program without either leaves them
empty."""
from __future__ import annotations

import time
from typing import Dict

import numpy as np

from .. import devtrace
from ..reference import gcc
from ..reference import gp as ref_gp
from . import engine
from .common import (Outcome, Run, Sample, Spans, TraceCtx, chunk_rates,
                     launches, memory_peak, program_space, reference_space,
                     sub_seed, synchronize)


class Search(engine.Flagship):
    """The engine over the configuration's space, without a device
    objective, and the GP that scores its steps."""

    def __init__(self, run: Run):
        from uptune_tpu_torch.engine.fused import FusedEngine, default_arms
        from uptune_tpu_torch.techniques.purerandom import PureRandom
        cfg = run.config
        if run.mix["eval"] != "ei":
            raise ValueError("a build is not run on the card: the gpsearch "
                             "mix scores every step by the GP's EI")
        self.run, self.dev = run, run.device
        self.ref = reference_space(cfg)
        space = program_space(cfg["space"])
        arms = cfg["arms"]
        if arms["set"] != "default":
            raise ValueError(f"unknown arm set {arms['set']!r}")
        arms_list = default_arms(int(arms["scale"]))
        pad = -sum(t.natural_batch(space) for t in arms_list) % int(
            arms["pad_to"])
        if pad:
            arms_list.append(PureRandom(batch=pad))
        self.eng = FusedEngine(space, None, arms=arms_list,
                               history_capacity=int(cfg["history_capacity"]),
                               device=self.dev)
        if self.eng.total_batch != int(cfg["rows_per_step"]):
            raise ValueError(f"{self.eng.total_batch} rows a step, not "
                             f"{cfg['rows_per_step']}")
        self.rows = self.eng.total_batch
        self.k = int(run.mix.get("topk") or 0)
        self._surrogate()

    def _surrogate(self):
        """The GP of the configuration's training set (`gcc.training_set`)
        with the stated hyperparameters; the program fits its state."""
        import torch
        from uptune_tpu_torch.engine import surrogate_eval_fn
        from uptune_tpu_torch.space.spec import CandBatch
        from uptune_tpu_torch.surrogate import gp
        g, dev, space = self.run.config["gp"], self.dev, self.eng.space
        u, y32 = gcc.training_set(self.run.config,
                                  sub_seed(self.run.seed, "gp.train"))
        self.best_y = float(y32.min())
        ut = torch.tensor(u, device=dev)
        x = space.surrogate_transform(space.features(CandBatch(ut, ())))
        st = gp.fit(x, torch.tensor(y32, device=dev), g["lengthscale"],
                    g["noise"], n_cont=space.n_cont_features,
                    n_cat=space.n_cat, ls_cat=g["ls_cat"])
        self.ev = surrogate_eval_fn(space, st, kind="ei", best_y=self.best_y,
                                    impl="fused",
                                    n_cont=space.n_cont_features,
                                    n_cat=space.n_cat)
        self.train = (u, [], y32)
        self.features = x.shape[1]
        # the training rows' values as the program decoded them where
        # float32 may round either way (an enum lane a few 1e-7 from a
        # code's edge flips a one-hot): the reference's GP is fitted on
        # the same configurations, each lane checked as a judged row's
        pv = space.decode_scalars(ut).cpu().numpy()
        self.train_vals, bad = self.ref.resolve(u, pv)
        self.train_mismatch = int(bad.sum())

    def reference_posterior(self, precision: str = "float64"):
        """The reference's own GP on the training rows' values."""
        import torch
        g = self.run.config["gp"]
        u, _, y32 = self.train
        x = self.ref.features(u, self.train_vals, [])
        return ref_gp.fit(torch.tensor(x, device=self.dev),
                          torch.tensor(y32.astype(np.float64),
                                       device=self.dev),
                          g["lengthscale"], g["noise"], g["ls_cat"],
                          self.ref.n_cont, self.ref.n_cat, precision)


def route_launches() -> Dict[str, Dict[str, int]]:
    """The program's launches of B, C and D by krows route ({} from a
    program that does not count them)."""
    from uptune_tpu_torch import native
    out = {}
    for k in native.KERNELS:
        read = getattr(k, "route_launches", None)
        routes = read() if callable(read) else None
        if routes is not None:
            out[k.name] = routes
    return out


def moved(a: Dict[str, Dict[str, int]], b: Dict[str, Dict[str, int]]):
    """b - a, by name and by key."""
    return {n: {r: b[n][r] - a.get(n, {}).get(r, 0) for r in b[n]}
            for n in b}


def program_spans(obs) -> list:
    """The obs plane's spans on time.time_ns()'s clock."""
    return [devtrace.Span(e["name"], obs.to_unix_ns(e["ts"]),
                          obs.to_unix_ns(e["ts"] + e["dur"]))
            for e in obs.snapshot()["events"] if e.get("dur") is not None]


def run(r: Run) -> Outcome:
    from uptune_tpu_torch import obs
    f = Search(r)
    r.note("engine built")
    k = f.k
    st0 = f.eng.init(seed=sub_seed(r.seed, "engine.init"))
    warm = f.unit(st0, Spans(False))         # every shape the window uses
    synchronize(r.device)
    r.note("warm unit done")
    sample = Sample(engine.SAMPLED, sub_seed(r.seed, "sample"))
    sample.put(0, (st0, *warm), False)
    st = warm[0]
    spans = Spans(r.trace)
    units = 0
    marks = []
    w = devtrace.Window(r.trace)
    g0 = {g: dict(c) for g, c in f.eng.graph_counts.items()}
    r.setup_done()
    t0 = time.perf_counter()
    w.open(r.seconds)
    l0, q0 = launches(), route_launches()
    end = t0 + r.seconds
    try:
        while time.perf_counter() < end:
            keep = sample.offer(units + 1)
            st2, top = f.unit(st, spans)
            sample.put(units + 1, (st, st2, top), keep)
            st = st2
            units += 1
            marks.append(time.perf_counter())
            if w.poll(units):
                l0, q0 = launches(), route_launches()
                obs.enable()
        synchronize(r.device)
        t1 = time.perf_counter()
        l1, q1 = launches(), route_launches()
        w.close(units)
        found = program_spans(obs) if obs.enabled() else []
    finally:
        obs.reset()
    peak = memory_peak(r.device)
    r.note(f"units a second by second {chunk_rates(marks, t0, 1)}")
    r.note(f"graph_counts moved in the window by "
           f"{moved(g0, f.eng.graph_counts)}")
    r.note(f"launches by krows route since the traced part began "
           f"(the whole window untraced): "
           f"{moved(q0, q1)}")
    ctx = TraceCtx(w.t0, w.t1, w.units, w.ops, spans.spans(),
                   {n: l1[n] - l0[n] for n in l1},
                   {"rows": f.rows, "cap": int(r.config["history_capacity"]),
                    "train_rows": int(r.config["gp"]["train_rows"]),
                    "features": f.features, "k": k},
                   {"obs_spans": found, "route_launches": moved(q0, q1)})
    del st
    items = sample.items()
    checks, numbers = engine.judge(f, items, k)
    # a training row decoded otherwise than the reference allows
    numbers["decode_mismatch"] += f.train_mismatch
    for c in checks:
        if c.name == "decode_mismatch":
            c.value += f.train_mismatch
    per_unit = f.rows * (2 if k else 1)
    return Outcome({"acq_per_s": units * per_unit / (t1 - t0)}, units, 0,
                   checks, peak, ctx, numbers,
                   lambda: dict(engine.control(f, items, k, "tf32"),
                                precision="tf32"))
