"""The `gcc-options-g12-pf4.cosearch` cell at a tiny size on the CPU (the
rehearsal), its control failing a limit, the same run with the
instances' shared rules broken underneath (each fault found), the
reader of its own metric, and on the card launcher D over the cell's
four segments at F 1027 against its plain version.

Tiny: four instances of the default arms at scale 1 (432 rows an
instance a step over the 328 lanes) into 512-row histories and k 8,
windows of a second; the GP is the configuration's own, 1024 rows over
1027 features, at which the control (the reference in TF32) reads past
the cell's limits."""
import copy
import json

import pytest
import torch

from portbench import devtrace, spec
from portbench.drivers import cosearch
from portbench.drivers.common import Run, TraceCtx, program_space, sub_seed
from portbench.reference import gcc, instances

BENCH = spec.load_benchmark()
CELL = "gcc-options-g12-pf4.cosearch"
MS = 1_000_000


def tiny(seconds: float = 1.0) -> Run:
    c = spec.workload(BENCH, CELL)
    cfg = copy.deepcopy(spec.config(BENCH, c["config"]))
    cfg["arms"]["scale"] = 1
    cfg["rows_per_step"] = cfg["instances"] * 432
    cfg["history_capacity"] = 512
    mix = copy.deepcopy(spec.traffic(c["traffic"]))
    mix["topk"] = 8
    limits = json.loads((spec.HERE / "limits" / f"{CELL}.json").read_text())
    return Run(c, cfg, mix, 2 ** 33 + 17, seconds, False,
               torch.device("cpu"), lambda: None, limits)


def failed(out) -> list:
    return [c.name for c in out.checks if not c.ok]


def test_rehearsal():
    out = cosearch.run(tiny())
    assert failed(out) == [], [(c.name, c.value, c.limit)
                               for c in out.checks]
    assert out.attempted > 0 and out.failed == 0
    assert out.rates["acq_per_s"] > 0
    assert out.trace.shapes["rows"] == 4 * 432
    assert out.trace.shapes["cap"] == 4 * 512
    assert out.numbers["units_judged"] >= 2


def test_control_fails():
    r = tiny()
    ctl = cosearch.run(r).control()
    over = [k for k, v in ctl.items()
            if k in r.limits and isinstance(v, (int, float))
            and v > r.limits[k]]
    assert over, ctl


# -- faults planted under the timed path ------------------------------------
def _flipped(best, dim):
    from uptune_tpu_torch.techniques.base import Best
    return Best(best.u.flip(dim), tuple(p.flip(dim) for p in best.perms),
                best.qor.flip(dim))


def _exchange_to_highest_on_ties(mp):
    from uptune_tpu_torch.engine import batched
    f = batched.exchange_best
    mp.setattr(batched, "exchange_best",
               lambda best, dim=0: _flipped(f(_flipped(best, dim), dim),
                                            dim))


def _exchange_skipped(mp):
    from uptune_tpu_torch.engine.batched import BatchedEngine
    init = BatchedEngine.__init__

    def never(self, engine, n_instances, exchange_every=0, mesh=None):
        init(self, engine, n_instances, 0, mesh)
    mp.setattr(BatchedEngine, "__init__", never)


def _segment_dropped(mp):
    from uptune_tpu_torch.engine.batched import BatchedEngine
    f = BatchedEngine._propose_topk

    def dropped(self, state, k, acq, aux):
        out = []
        for ts, c, keys, v, i in f(self, state, k, acq, aux):
            v = v.clone()
            v[-1] = float("-inf")           # the last instance's list
            out.append((ts, c, keys, v, i))
        return out
    mp.setattr(BatchedEngine, "_propose_topk", dropped)


def _pool_ties_to_highest(mp):
    from uptune_tpu_torch.engine import batched
    f = batched.exchange_topk

    def reversed_pool(vals, idx, k):
        v, owner, i = f(vals.flip(0), idx.flip(0), k)
        return v, (vals.shape[0] - 1 - owner).to(owner.dtype), i
    mp.setattr(batched, "_global_topk_obs", reversed_pool)


def _committed_into_another(mp):
    from uptune_tpu_torch.engine.batched import BatchedEngine
    f = BatchedEngine._head

    def crossed(self, state, tstates, cands, raw):
        def one_for_zero(t):
            t = t.clone()
            t[0] = t[1]
            return t
        cands = type(cands)(one_for_zero(cands.u),
                            tuple(one_for_zero(p) for p in cands.perms))
        return f(self, state, tstates, cands, one_for_zero(raw))
    mp.setattr(BatchedEngine, "_head", crossed)


FAULTS = [_exchange_to_highest_on_ties, _exchange_skipped, _segment_dropped,
          _pool_ties_to_highest, _committed_into_another]
FOUND_BY = {"_exchange_to_highest_on_ties": "exchange_mismatch",
            "_exchange_skipped": "exchange_mismatch",
            "_segment_dropped": "topk_select_gap",
            "_pool_ties_to_highest": "topk_malformed",
            "_committed_into_another": "history_mismatch"}


@pytest.mark.parametrize("fault", FAULTS, ids=[f.__name__[1:]
                                               for f in FAULTS])
def test_fault_is_found(fault, monkeypatch):
    fault(monkeypatch)
    out = cosearch.run(tiny())
    assert FOUND_BY[fault.__name__] in failed(out), \
        [(c.name, c.value) for c in out.checks]


# -- the reference's rules ----------------------------------------------------
def test_reference_rules():
    assert instances.fold(2.0, [3.0, 1.0, 1.0]) == (1.0, 1)
    assert instances.fold(1.0, [3.0, 1.0]) == (1.0, -1)
    assert instances.exchange([2.0, 0.5, 3.0, 0.5]) == 1
    assert instances.exchange([float("inf")] * 3) is None
    u = [[0.5, 0.9, 0.9], [0.9, 0.1, 0.5]]
    v, o, r = instances.pooled_topk(u, 4)
    assert v.tolist() == [0.9, 0.9, 0.9, 0.5]
    assert o.tolist() == [0, 0, 1, 0] and r.tolist() == [1, 2, 0, 0]
    assert instances.order_faults(v, o, r) == 0
    assert instances.order_faults(v, [1, 0, 0, 0], [0, 1, 2, 0]) == 1
    assert instances.order_faults([0.5, 0.9], [0, 0], [0, 1]) == 1


# -- the reader of the cell's own metric --------------------------------------
def test_exchange_ms_reader():
    rd = spec.metric_reader("engine.exchange_ms")
    spans = [devtrace.Span("engine.exchange", 1 * MS, 2 * MS),
             devtrace.Span("engine.global_topk", 3 * MS, 6 * MS),
             devtrace.Span("engine.batched_run", 0, 4 * MS),
             devtrace.Span("engine.exchange", 9 * MS, 12 * MS)]
    ctx = TraceCtx(0, 10 * MS, 2, extra={"obs_spans": spans})
    assert rd(ctx) == pytest.approx(2.0)    # (1 + 3) ms over 2 units
    # a program without the exchange's span, or a window without spans
    assert rd(TraceCtx(0, 10 * MS, 2, extra={"obs_spans": spans[1:3]})) \
        is None
    assert rd(TraceCtx(0, 10 * MS, 2)) is None


# -- on the card --------------------------------------------------------------
@pytest.mark.card
def test_d_over_four_segments_at_f1027(card):
    """Launcher D over the cell's 4 x 6352 rows at F 1027 and k 128 (the
    tensor-core kernel rows): each segment's list bitwise against a
    single launch on its rows, and within the cell's limits (in the
    targets' std) against `topk_plain` on them."""
    from uptune_tpu_torch.ops import acquire as acq
    from uptune_tpu_torch.space.spec import CandBatch
    from uptune_tpu_torch.surrogate import gp
    from uptune_tpu_torch.surrogate.pallas_score import krows_route
    cfg = spec.config(BENCH, spec.workload(BENCH, CELL)["config"])
    limits = json.loads((spec.HERE / "limits" / f"{CELL}.json").read_text())
    space = program_space(cfg["space"])
    g, segs, rows, k = cfg["gp"], cfg["instances"], 6352, 128
    u, y = gcc.training_set(cfg, sub_seed(7, "gp.train"))
    x = space.surrogate_features(CandBatch(torch.tensor(u, device=card),
                                           ()))
    st = gp.fit(x, torch.tensor(y, device=card), g["lengthscale"],
                g["noise"], n_cont=space.n_cont_features, n_cat=space.n_cat,
                ls_cat=g["ls_cat"])
    assert x.shape[1] == 1027 and krows_route(x.shape[1]) == "tensor_cores"
    gen = torch.Generator(device=card)
    gen.manual_seed(11)
    xq = space.surrogate_features(CandBatch(
        torch.rand((segs * rows, space.n_scalar), generator=gen,
                   device=card), ()))
    blocks, kinv, params = acq.prep(st, xq, "ei", float(y.min()), 2.0,
                                    space.n_cont_features, space.n_cat)
    vals, idx = acq.topk_segments_cuda(*blocks, kinv, params, "ei", k, segs)
    ys = float(st.y_std)
    for s in range(segs):
        sb = type(blocks)(*(None if t is None else
                            t[s * rows:(s + 1) * rows].contiguous()
                            for t in blocks[:2]), *blocks[2:])
        v1, i1 = acq.topk_cuda(*sb, kinv, params, "ei", k)
        assert torch.equal(vals[s], v1) and torch.equal(idx[s], i1)
        u_all = acq.utilities_plain(*sb, kinv, params, "ei")
        vp, _ = acq.select_topk(u_all, k)
        gap = float((vals[s] - vp).abs().max()) / ys
        select = max(0.0, float(vp[-1] - u_all[idx[s].long()].min())) / ys
        assert gap <= limits["topk_value_gap"], gap
        assert select <= limits["topk_select_gap"], select
