"""Cooperating acquisition searches of one deployment on one card:
`BatchedEngine` over the configuration's `instances` copies of the
`gpsearch` engine, each with its own arms and history, every step's
rows of all instances scored in one call by the shared GP's EI
(launcher C over the flat batch), the best exchanged every
`exchange_every` steps, then one `global_topk` (launcher D over one
segment an instance, then the pooled top k) that picks the next builds
from all instances at once.

Mix parameters as `gpsearch`'s: `eval` ("ei" only) and `topk` (k).  A
unit of work is one batched step and its `global_topk`; `acq_per_s`
counts the 2 x instances x rows an instance that they score.  The
host spans are named as the single engine's (`engine.step`,
`engine.propose_topk`), so that the readers of C, D, the kernel rows,
the merge, the ops and the idle share read the cell as they read
`gpsearch`; the merge writes every instance's history in one launch, so
`shapes["cap"]` is the rows of all of them.

The judgement takes `engine`'s sampled units and re-derives each one's
proposal with `propose_all` from the state before it.  Each instance's
commit is judged as `engine` judges a single engine's (decode,
membership, hash, dedup, eviction, the merge, the committed values);
the instances' shared rules by `reference/instances.py`: every
instance's best after the step is the exchanged best (by configuration
and value; where one configuration holds the least value, also by the
unit vector of the lowest instance that holds it), and the pooled top
k against the float64 EI of every row of the pool.  Different
configurations hardly ever tie on a QoR in the GP's scores, so a run
seldom shows where a tie goes; the judgement also hands the step's
exchange function (`exchange_best`) one row of each instance under one
QoR, where the rule takes instance 0's (`exchange_mismatch` counts the
instances that break either), and runs `global_topk` from the judged
state with its instance 0 in every instance, where every row of the
pool ties across the instances and the list must keep the pooled order
(`topk_malformed`)."""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Dict, List

import numpy as np

from .. import devtrace
from ..reference import history as ref_hist
from ..reference import instances
from . import engine, gpsearch
from .common import (Check, Outcome, Run, Sample, Spans, TraceCtx,
                     chunk_rates, launches, memory_peak, sub_seed,
                     synchronize)


class CoSearch(gpsearch.Search):
    """The batched engine over the configuration's instances, and the
    GP that scores their steps."""

    def __init__(self, run: Run):
        from uptune_tpu_torch.engine.batched import BatchedEngine
        cfg = run.config
        n = int(cfg["instances"])
        if int(cfg["rows_per_step"]) % n:
            raise ValueError(f"{cfg['rows_per_step']} rows a step do not "
                             f"split into {n} instances")
        # the single engine is one instance: its rows are a step's share
        super().__init__(dataclasses.replace(run, config=dict(
            cfg, rows_per_step=int(cfg["rows_per_step"]) // n)))
        self.run = run
        self.n = n
        self.b = self.eng.total_batch
        self.rows = n * self.b
        self.be = BatchedEngine(self.eng, n,
                                exchange_every=int(cfg["exchange_every"]))

    def unit(self, st, spans: Spans):
        """One batched step scored by the GP's EI, then one global_topk
        from the new state: (state, (vals, owner, idx), each [n, k])."""
        a = time.perf_counter_ns()
        st2 = self.be.run(st, 1, self.ev)
        b = time.perf_counter_ns()
        spans.add("engine.step", a, b)
        top = self.be.global_topk(st2, self.k, self.ev)
        spans.add("engine.propose_topk", b, time.perf_counter_ns())
        return st2, top


def _map(fn, tree):
    """fn over every tensor of a tree of tensors, NamedTuples and
    tuples."""
    import torch
    if isinstance(tree, torch.Tensor):
        return fn(tree)
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(_map(fn, x) for x in tree))
    if isinstance(tree, tuple):
        return tuple(_map(fn, x) for x in tree)
    return tree


def row(tree, i: int):
    """Instance i of a stacked tree."""
    return _map(lambda t: t[i], tree)


def flat(cands):
    """A stacked [n, B] candidate batch as one [n * B] batch."""
    from uptune_tpu_torch.space.spec import CandBatch
    n, b = cands.u.shape[:2]
    return CandBatch(cands.u.reshape(n * b, -1),
                     tuple(p.reshape(n * b, p.shape[-1])
                           for p in cands.perms))


def run(r: Run) -> Outcome:
    from uptune_tpu_torch import obs
    f = CoSearch(r)
    r.note("engine built")
    k = f.k
    st0 = f.be.init(seed=sub_seed(r.seed, "engine.init"))
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
    r.setup_done()
    t0 = time.perf_counter()
    w.open(r.seconds)
    l0, q0 = launches(), gpsearch.route_launches()
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
                l0, q0 = launches(), gpsearch.route_launches()
                obs.enable()
        synchronize(r.device)
        t1 = time.perf_counter()
        l1, q1 = launches(), gpsearch.route_launches()
        w.close(units)
        found = gpsearch.program_spans(obs) if obs.enabled() else []
        counted = {c: obs.counter_value(c) for c in (
            "engine.exchanges", "engine.instance_commits")}
    finally:
        obs.reset()
    peak = memory_peak(r.device)
    r.note(f"units a second by second {chunk_rates(marks, t0, 1)}")
    r.note(f"launches by krows route since the traced part began "
           f"(the whole window untraced): "
           f"{gpsearch.moved(q0, q1)}")
    if r.trace:
        r.note(f"obs counters over {w.units} traced units: {counted}")
    ctx = TraceCtx(w.t0, w.t1, w.units, w.ops, spans.spans(),
                   {n: l1[n] - l0[n] for n in l1},
                   {"rows": f.rows, "instances": f.n,
                    "cap": f.n * int(r.config["history_capacity"]),
                    "train_rows": int(r.config["gp"]["train_rows"]),
                    "features": f.features, "k": k},
                   {"obs_spans": found,
                    "route_launches": gpsearch.moved(q0, q1)})
    del st
    items = sample.items()
    checks, numbers = judge(f, items, k)
    numbers["decode_mismatch"] += f.train_mismatch
    for c in checks:
        if c.name == "decode_mismatch":
            c.value += f.train_mismatch
    return Outcome({"acq_per_s": units * 2 * f.rows / (t1 - t0)}, units, 0,
                   checks, peak, ctx, numbers,
                   lambda: dict(control(f, items, k, "tf32"),
                                precision="tf32"))


# -- the judgement ----------------------------------------------------------
def best_of(f: CoSearch, best, n: Dict):
    """A stacked best as the reference reads it: (hash of each
    instance's configuration, u [n, D] float32, qor [n], the reference's
    values of the configurations)."""
    from uptune_tpu_torch.space.spec import CandBatch
    _, _, vals, _, mism = engine.decoded(f, CandBatch(best.u, best.perms))
    n["decode_mismatch"] += mism
    u = best.u.cpu().numpy()
    perms = [p.cpu().numpy() for p in best.perms]
    hashes = f.ref.hash(f.ref.lanes(u, vals, perms))
    return [tuple(h) for h in hashes.tolist()], u, \
        best.qor.cpu().double().numpy(), (u, vals, perms)


def judge(f: CoSearch, items: List[Any], k: int):
    """Each sampled unit against the reference: (checks, numbers)."""
    val = engine.Values(f)
    n = {"invalid_rows": 0, "decode_mismatch": 0, "history_mismatch": 0,
         "value_gap": 0.0, "exchange_mismatch": 0, "topk_malformed": 0,
         "topk_value_gap": 0.0, "topk_select_gap": 0.0,
         "units_judged": len(items)}
    for pre, post, top in items:
        _, cands, _ = f.be.propose_all(pre)
        rows = [judge_commit(f, val, row(pre, i), row(post, i),
                             row(cands, i), n) for i in range(f.n)]
        judge_exchange(f, val, pre, post, rows, n)
        n["exchange_mismatch"] += tie_probe(f, cands)
        judge_pool(f, val, post, top, k, n)
        n["topk_malformed"] += pool_probe(f, post, k)
    checks = [Check("invalid_rows", n["invalid_rows"], 0),
              Check("decode_mismatch", n["decode_mismatch"], 0),
              Check("history_mismatch", n["history_mismatch"], 0),
              Check("value_gap", n["value_gap"], f.run.limits["value_gap"]),
              Check("exchange_mismatch", n["exchange_mismatch"], 0),
              Check("topk_malformed", n["topk_malformed"], 0),
              Check("topk_value_gap", n["topk_value_gap"],
                    f.run.limits["topk_value_gap"]),
              Check("topk_select_gap", n["topk_select_gap"],
                    f.run.limits["topk_select_gap"])]
    return checks, n


def judge_commit(f: CoSearch, val, pre, post, cands, n: Dict):
    """One instance's commit as `engine.judge` judges a single engine's
    (the best apart) -> (its rows' QoR by the reference, their hashes,
    their u)."""
    u, perms, vals, invalid, mism = engine.decoded(f, cands)
    n["invalid_rows"] += invalid
    n["decode_mismatch"] += mism
    want_q = val(u, vals, perms)
    hashes = f.ref.hash(f.ref.lanes(u, vals, perms))
    t_pre, t_post = engine.table(pre.hist), engine.table(post.hist)
    nov = ref_hist.novel(t_pre, hashes)
    want = ref_hist.commit(t_pre, hashes, want_q, nov)
    n["history_mismatch"] += sum(ref_hist.mismatches(want, t_post).values())
    n["history_mismatch"] += int(int(post.evals) - int(pre.evals)
                                 != int(nov.sum()))
    new = (want.age == t_pre.step) & (t_post.age == want.age) & \
        (t_post.h0 == want.h0) & (t_post.h1 == want.h1)
    n["value_gap"] = max(n["value_gap"],
                         val.gap(t_post.qor[new], want.qor[new]))
    return want_q, [tuple(h) for h in hashes.tolist()], u


def judge_exchange(f: CoSearch, val, pre, post, rows, n: Dict) -> None:
    """Every instance's best after the step against the exchanged best
    of the folded ones (`instances.fold`, `instances.exchange`): the
    configurations within the value_gap limit of the least value are the
    ones the program's float32 may take."""
    limit = f.run.limits["value_gap"]
    tol = limit * val.scale
    ph, pu, pq, _ = best_of(f, pre.best, n)
    folded = [instances.fold(pq[i], q)[0] for i, (q, _, _) in
              enumerate(rows)]
    w = instances.exchange(folded)
    gh, gu, gq, (bu, bvals, bp) = best_of(f, post.best, n)
    if w is None:
        # no finite QoR: each instance keeps its own (an infinite one)
        n["exchange_mismatch"] += int(np.isfinite(gq).sum())
        return
    m = folded[w]
    near = []          # (instance, hash, u, a previous best) near m
    for i, (q, hs, u) in enumerate(rows):
        if pq[i] <= m + tol:
            near.append((i, ph[i], pu[i], True))
        for r in np.nonzero(q <= m + tol)[0]:
            near.append((i, hs[r], u[r], False))
    hashes = {h for _, h, _, _ in near}
    keep = None
    if len(hashes) == 1:
        # one configuration holds the least value: the lowest instance
        # that holds it gives its unit vector, its previous best's (kept
        # on a tie) or its first such row's
        first = min(i for i, _, _, _ in near)
        held = [(x.tobytes(), prev) for i, _, x, prev in near
                if i == first]
        keep = [x for x, prev in held if prev] + \
            [x for x, prev in held if not prev][:1]
    mine = val(bu, bvals, bp)
    for j in range(f.n):
        gap = max(val.gap([gq[j]], [m]), val.gap([gq[j]], [mine[j]]))
        n["value_gap"] = max(n["value_gap"], gap)
        bad = (gh[j] not in hashes or gap > limit
               or gq[j] != gq[0] or gu[j].tobytes() != gu[0].tobytes()
               or (keep is not None and gu[j].tobytes() not in keep))
        n["exchange_mismatch"] += int(bad)


def tie_probe(f: CoSearch, cands) -> int:
    """The step's exchange function on the first row of each instance's
    proposal, all under one QoR: instances whose best is not instance
    0's row (the rule's lowest index)."""
    import torch
    from uptune_tpu_torch.engine import batched
    from uptune_tpu_torch.techniques.base import Best
    u = cands.u[:, 0]
    q = torch.zeros(u.shape[0], dtype=torch.float32, device=u.device)
    got = batched.exchange_best(Best(u, tuple(p[:, 0] for p in cands.perms),
                                     q))
    want = instances.exchange(q.cpu().numpy())
    return int((got.u != u[want]).any(-1).sum())


def pool_probe(f: CoSearch, state, k: int) -> int:
    """`global_topk` from the state with its instance 0 in every
    instance, so that each row of the pool is proposed by every
    instance under one utility: 1 when the list breaks the pooled order
    (ties to the lowest instance), else 0."""
    rep = _map(lambda t: t[:1].expand_as(t).contiguous(), state)
    vals, owner, idx = (t[0].cpu().numpy()
                        for t in f.be.global_topk(rep, k, f.ev))
    return int(instances.order_faults(vals, owner, idx) > 0)


def judge_pool(f: CoSearch, val, post, top, k: int, n: Dict) -> None:
    """The pooled top k of `global_topk` against the float64 EI of every
    row of the pool (`propose_all` from the state it ranked)."""
    vals, owner, idx = (t.cpu().numpy() for t in top)
    _, pool, _ = f.be.propose_all(post)
    u, perms, dv, invalid, mism = engine.decoded(f, flat(pool))
    n["invalid_rows"] += invalid
    n["decode_mismatch"] += mism
    ei = val.ei(u, dv, perms).reshape(f.n, f.b)
    v, o, r = vals[0].astype(np.float64), owner[0].astype(np.int64), \
        idx[0].astype(np.int64)
    ok = (vals.shape == owner.shape == idx.shape == (f.n, k)
          and (vals == vals[0]).all() and (owner == owner[0]).all()
          and (idx == idx[0]).all() and o.min() >= 0 and o.max() < f.n
          and r.min() >= 0 and r.max() < f.b and np.isfinite(v).all()
          and len(set(zip(o.tolist(), r.tolist()))) == k
          and instances.order_faults(v, o, r) == 0)
    if not ok:
        n["topk_malformed"] += 1
        return
    n["topk_value_gap"] = max(n["topk_value_gap"], val.gap(v, ei[o, r]))
    kth = instances.pooled_topk(ei, k)[0][-1]
    n["topk_select_gap"] = max(n["topk_select_gap"],
                               max(0.0, float(kth - ei[o, r].min()))
                               / val.scale)


def control(f: CoSearch, items: List[Any], k: int, precision: str) -> Dict:
    """The control's numbers: the reference computed in `precision` put
    in the program's place, its values (on each instance's rows that the
    commit takes as novel) and its pooled top k read against the float64
    reference."""
    val, low = engine.Values(f), engine.Values(f, precision)
    n = {"value_gap": 0.0, "topk_value_gap": 0.0, "topk_select_gap": 0.0}
    for pre, post, _ in items:
        _, cands, _ = f.be.propose_all(pre)
        for i in range(f.n):
            u, perms, vals, _, _ = engine.decoded(f, row(cands, i))
            hashes = f.ref.hash(f.ref.lanes(u, vals, perms))
            nov = ref_hist.novel(engine.table(row(pre, i).hist), hashes)
            n["value_gap"] = max(n["value_gap"], val.gap(
                low(u, vals, perms)[nov], val(u, vals, perms)[nov]))
        _, pool, _ = f.be.propose_all(post)
        u, perms, vals, _, _ = engine.decoded(f, flat(pool))
        ei = val.ei(u, vals, perms).reshape(f.n, f.b)
        ei_c = low.ei(u, vals, perms).reshape(f.n, f.b)
        v, o, r = instances.pooled_topk(ei_c, k)
        n["topk_value_gap"] = max(n["topk_value_gap"], val.gap(v, ei[o, r]))
        kth = instances.pooled_topk(ei, k)[0][-1]
        n["topk_select_gap"] = max(
            n["topk_select_gap"],
            max(0.0, float(kth - ei[o, r].min())) / val.scale)
    return n
