"""The fused engine's window: `FusedEngine.step` over and over, and with
`topk` in the mix one `propose_topk` after each step.

Mix parameters: `eval` ("objective": the step evaluates the
configuration's objective on the device; "ei": the step scores its rows
by the GP's expected improvement, launcher C), and `topk` (k of the
`propose_topk` that follows each step, launcher D; 0 for none).  A unit
of work is one step (and its `propose_topk`); `acq_per_s` counts every
row a unit scores.

The judgement follows the program step by step from its own state: for
each sampled unit the reference replays the commit from the state
before it (decode, membership, hash, dedup, eviction, merge, the best's
fold) with its own float64 objective or posterior, and compares the
state after it.  The first unit judged is the warm-up step from the
fresh state."""
from __future__ import annotations

import time
from typing import Any, Dict, List

import numpy as np

from ..reference import gp as ref_gp
from ..reference import history as ref_hist
from ..reference import objectives
from .common import (Check, Outcome, Run, Sample, Spans, TraceCtx,
                     chunk_rates, launches, memory_peak, program_space,
                     reference_space, sub_seed, synchronize)
from .. import devtrace

SAMPLED = 5


class Flagship:
    """The system under test and the reference's view of its inputs."""

    def __init__(self, run: Run):
        import torch
        from uptune_tpu_torch.engine.fused import FusedEngine, default_arms
        from uptune_tpu_torch.techniques.purerandom import PureRandom
        from uptune_tpu_torch.workloads.synthetic import (rosenbrock_device,
                                                          tsp_device)
        cfg, dev = run.config, run.device
        self.run, self.dev = run, dev
        self.ref = reference_space(cfg)
        obj = cfg["objective"]
        self.nf = int(obj["rosenbrock_lanes"])
        self.dist = objectives.distances(obj["cities"])
        dist32 = torch.tensor(self.dist, dtype=torch.float32, device=dev)
        nf = self.nf

        def objective(vals, perms):
            return rosenbrock_device(vals[..., :nf]) + tsp_device(perms[0],
                                                                  dist32)
        space = program_space(cfg["space"])
        arms = cfg["arms"]
        if arms["set"] != "default":
            raise ValueError(f"unknown arm set {arms['set']!r}")
        arms_list = default_arms(int(arms["scale"]))
        pad = -sum(t.natural_batch(space) for t in arms_list) % int(
            arms["pad_to"])
        if pad:
            arms_list.append(PureRandom(batch=pad))
        self.eng = FusedEngine(space, objective, arms=arms_list,
                               history_capacity=int(cfg["history_capacity"]),
                               device=dev)
        if self.eng.total_batch != int(cfg["rows_per_step"]):
            raise ValueError(f"{self.eng.total_batch} rows a step, not "
                             f"{cfg['rows_per_step']}")
        self.rows = self.eng.total_batch
        self.k = int(run.mix.get("topk") or 0)
        self.ev = None
        self.features = 0
        if run.mix["eval"] == "ei":
            self._surrogate()

    def _surrogate(self):
        """The GP of the configuration: training rows drawn on the device
        from the seed, their objective by the reference, the stated
        hyperparameters; the program fits its state from them."""
        import torch
        from uptune_tpu_torch.engine import surrogate_eval_fn
        from uptune_tpu_torch.space.spec import CandBatch
        from uptune_tpu_torch.surrogate import gp
        g, dev, space = self.run.config["gp"], self.dev, self.eng.space
        n = int(g["train_rows"])
        gen = torch.Generator(device=dev)
        gen.manual_seed(sub_seed(self.run.seed, "gp.train"))
        u = torch.rand((n, space.n_scalar), generator=gen, device=dev)
        perms = tuple(torch.argsort(torch.rand((n, s), generator=gen,
                                               device=dev), dim=1)
                      for s in space.perm_sizes)
        un, pn = u.cpu().numpy(), [p.cpu().numpy() for p in perms]
        vals, _ = self.ref.decode(un)
        y = objectives.flagship(vals, pn[0], self.dist, self.nf)
        y32 = y.astype(np.float32)
        self.best_y = float(y32.min())
        x = space.surrogate_transform(space.features(CandBatch(u, perms)))
        st = gp.fit(x, torch.tensor(y32, device=dev), g["lengthscale"],
                    g["noise"], n_cont=space.n_cont_features,
                    n_cat=space.n_cat, ls_cat=g["ls_cat"])
        self.ev = surrogate_eval_fn(space, st, kind="ei", best_y=self.best_y,
                                    impl="fused",
                                    n_cont=space.n_cont_features,
                                    n_cat=space.n_cat)
        self.train = (un, pn, y32)
        self.features = x.shape[1]

    def reference_posterior(self, precision: str = "float64"):
        """The reference's own GP from the same inputs (on the device)."""
        import torch
        g = self.run.config["gp"]
        un, pn, y32 = self.train
        vals, _ = self.ref.decode(un)
        x = self.ref.features(un, vals, pn)
        return ref_gp.fit(torch.tensor(x, device=self.dev),
                          torch.tensor(y32.astype(np.float64),
                                       device=self.dev),
                          g["lengthscale"], g["noise"], g["ls_cat"],
                          self.ref.n_cont, self.ref.n_cat, precision)

    # -- the window ----------------------------------------------------------
    def unit(self, st, spans: Spans):
        """One unit of work: a step (scored by the GP's EI on the gp
        mix), then with `topk` one propose_topk from the new state."""
        a = time.perf_counter_ns()
        st2 = self.eng.step(st, eval_fn=self.ev)
        b = time.perf_counter_ns()
        spans.add("engine.step", a, b)
        top = None
        if self.k:
            _, cands, _, vals, idx = self.eng.propose_topk(st2, self.ev,
                                                           self.k)
            top = (cands, vals, idx)
            spans.add("engine.propose_topk", b, time.perf_counter_ns())
        return st2, top


def run(r: Run) -> Outcome:
    f = Flagship(r)
    r.note("engine built")
    k = f.k
    st0 = f.eng.init(seed=sub_seed(r.seed, "engine.init"))
    warm = f.unit(st0, Spans(False))         # every shape the window uses
    synchronize(r.device)
    r.note("warm unit done")
    sample = Sample(SAMPLED, sub_seed(r.seed, "sample"))
    sample.put(0, (st0, *warm), False)
    st = warm[0]
    spans = Spans(r.trace)
    units = 0
    marks = []
    w = devtrace.Window(r.trace)
    r.setup_done()
    t0 = time.perf_counter()
    w.open(r.seconds)
    l0 = launches()                # from the traced part's start, if traced
    end = t0 + r.seconds
    while time.perf_counter() < end:
        keep = sample.offer(units + 1)
        st2, top = f.unit(st, spans)
        sample.put(units + 1, (st, st2, top), keep)
        st = st2
        units += 1
        marks.append(time.perf_counter())
        if w.poll(units):
            l0 = launches()
    synchronize(r.device)
    t1 = time.perf_counter()
    l1 = launches()
    w.close(units)
    peak = memory_peak(r.device)
    r.note(f"units a second by second {chunk_rates(marks, t0, 1)}")
    ctx = TraceCtx(w.t0, w.t1, w.units, w.ops, spans.spans(),
                   {n: l1[n] - l0[n] for n in l1},
                   {"rows": f.rows, "cap": int(r.config["history_capacity"]),
                    "train_rows": int(r.config.get("gp", {}).get(
                        "train_rows", 0)),
                    "features": f.features, "k": k})
    del st
    items = sample.items()
    checks, numbers = judge(f, items, k)
    lower = "tf32" if f.ev is not None else "bfloat16"
    per_unit = f.rows * (2 if k else 1)
    return Outcome({"acq_per_s": units * per_unit / (t1 - t0)}, units, 0,
                   checks, peak, ctx, numbers,
                   lambda: dict(control(f, items, k, lower), precision=lower))


# -- the judgement ----------------------------------------------------------
def table(h) -> ref_hist.Table:
    return ref_hist.Table(h.h0.cpu().numpy(), h.h1.cpu().numpy(),
                          h.qor.cpu().double().numpy(),
                          h.age.cpu().numpy().astype(np.int64), int(h.n),
                          int(h.step), int(h.dropped))


def decoded(f: Flagship, cands):
    """The reference's reading of a candidate batch: (u, perms, values,
    rows that are no members, lanes decoded otherwise than it does)."""
    u = cands.u.cpu().numpy()
    perms = [p.cpu().numpy() for p in cands.perms]
    pv = f.eng.space.decode_scalars(cands.u).cpu().numpy()
    vals, bad = f.ref.resolve(u, pv)
    return u, perms, vals, int((~f.ref.members(u, perms)).sum()), \
        int(bad.sum())


class Values:
    """The reference's value of candidate rows (the objective, or minus
    the GP's EI), and the scale its gaps are read in."""

    def __init__(self, f: Flagship, precision: str = "float64"):
        self.f = f
        self.precision = precision
        if f.ev is not None:
            self.post = f.reference_posterior(precision)
            # gaps are read in the float64 posterior's target std
            self.scale = float(self.post.std if precision == "float64"
                               else f.reference_posterior().std)

    def ei(self, u, vals, perms):
        import torch
        x = torch.tensor(self.f.ref.features(u, vals, perms),
                         device=self.f.dev)
        return ref_gp.ei(self.post, x, self.f.best_y).double().cpu().numpy()

    def __call__(self, u, vals, perms) -> np.ndarray:
        if self.f.ev is not None:
            return -self.ei(u, vals, perms)
        if self.precision == "float64":
            return objectives.flagship(vals, perms[0], self.f.dist, self.f.nf)
        return objectives.flagship_lowp(vals, perms[0], self.f.dist,
                                        self.f.nf, self.precision)

    def gap(self, got, want) -> float:
        """The widest gap, relative to the values (the objective) or to
        the targets' std (EI)."""
        got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
        if not len(want):
            return 0.0
        scale = self.scale if self.f.ev is not None else np.maximum(
            np.abs(want), 1e-30)
        return float(np.max(np.abs(got - want) / scale))


def judge(f: Flagship, items: List[Any], k: int):
    """Each sampled unit against the reference: (checks, numbers)."""
    val = Values(f)
    n = {"invalid_rows": 0, "decode_mismatch": 0, "history_mismatch": 0,
         "value_gap": 0.0, "topk_malformed": 0, "topk_value_gap": 0.0,
         "topk_select_gap": 0.0, "units_judged": len(items)}
    for pre, post, top in items:
        _, cands, _ = f.eng.propose(pre)
        u, perms, vals, invalid, mism = decoded(f, cands)
        n["invalid_rows"] += invalid
        n["decode_mismatch"] += mism
        want_q = val(u, vals, perms)
        hashes = f.ref.hash(f.ref.lanes(u, vals, perms))
        t_pre, t_post = table(pre.hist), table(post.hist)
        nov = ref_hist.novel(t_pre, hashes)
        want = ref_hist.commit(t_pre, hashes, want_q, nov)
        n["history_mismatch"] += sum(ref_hist.mismatches(want, t_post)
                                     .values())
        n["history_mismatch"] += int(int(post.evals) - int(pre.evals)
                                     != int(nov.sum()))
        new = (want.age == t_pre.step) & (t_post.age == want.age) & \
            (t_post.h0 == want.h0) & (t_post.h1 == want.h1)
        gaps = [val.gap(t_post.qor[new], want.qor[new])]
        # the best's fold, and the best's own value
        best_want = min(float(pre.best.qor), float(want_q.min()))
        gaps.append(val.gap([float(post.best.qor)], [best_want]))
        bu = post.best.u[None].cpu().numpy()
        bp = [p[None].cpu().numpy() for p in post.best.perms]
        bpv = f.eng.space.decode_scalars(post.best.u[None]).cpu().numpy()
        bvals, bbad = f.ref.resolve(bu, bpv)
        n["decode_mismatch"] += int(bbad.sum())
        gaps.append(val.gap([float(post.best.qor)], val(bu, bvals, bp)))
        n["value_gap"] = max(n["value_gap"], *gaps)
        if top is not None:
            judge_topk(f, val, top, k, n)
    checks = [Check("invalid_rows", n["invalid_rows"], 0),
              Check("decode_mismatch", n["decode_mismatch"], 0),
              Check("history_mismatch", n["history_mismatch"], 0),
              Check("value_gap", n["value_gap"],
                    f.run.limits["value_gap"])]
    if k:
        checks += [Check("topk_malformed", n["topk_malformed"], 0),
                   Check("topk_value_gap", n["topk_value_gap"],
                         f.run.limits["topk_value_gap"]),
                   Check("topk_select_gap", n["topk_select_gap"],
                         f.run.limits["topk_select_gap"])]
    return checks, n


def judge_topk(f: Flagship, val: Values, top, k: int, n: Dict) -> None:
    cands, vals, idx = top
    u, perms, dv, invalid, mism = decoded(f, cands)
    n["invalid_rows"] += invalid
    n["decode_mismatch"] += mism
    ei = val.ei(u, dv, perms)
    v = vals.double().cpu().numpy()
    i = idx.cpu().numpy().astype(np.int64)
    ok = (len(i) == k and len(set(i.tolist())) == k and i.min() >= 0
          and i.max() < len(ei) and np.isfinite(v).all()
          and (np.diff(v) <= 0).all())
    if not ok:
        n["topk_malformed"] += 1
        return
    n["topk_value_gap"] = max(n["topk_value_gap"], val.gap(v, ei[i]))
    kth = ref_gp.topk(ei, k)[0][-1]
    n["topk_select_gap"] = max(n["topk_select_gap"],
                               max(0.0, float(kth - ei[i].min())) / val.scale)


def control(f: Flagship, items: List[Any], k: int, precision: str) -> Dict:
    """The control's numbers: the reference computed in `precision` put
    in the program's place, its values (on the rows the commit takes as
    novel) and its top k read against the float64 reference."""
    val, low = Values(f), Values(f, precision)
    n = {"value_gap": 0.0, "topk_value_gap": 0.0, "topk_select_gap": 0.0}
    for pre, post, top in items:
        _, cands, _ = f.eng.propose(pre)
        u, perms, vals, _, _ = decoded(f, cands)
        hashes = f.ref.hash(f.ref.lanes(u, vals, perms))
        nov = ref_hist.novel(table(pre.hist), hashes)
        n["value_gap"] = max(n["value_gap"], val.gap(
            low(u, vals, perms)[nov], val(u, vals, perms)[nov]))
        if top is not None:
            u, perms, vals, _, _ = decoded(f, top[0])
            ei, ei_c = val.ei(u, vals, perms), low.ei(u, vals, perms)
            v, i = ref_gp.topk(ei_c, k)
            n["topk_value_gap"] = max(n["topk_value_gap"], val.gap(v, ei[i]))
            kth = ref_gp.topk(ei, k)[0][-1]
            n["topk_select_gap"] = max(
                n["topk_select_gap"],
                max(0.0, float(kth - ei[i].min())) / val.scale)
    return n
