"""The `gcc-options-g12-tuner.gpcampaign` cell at a tiny size on the CPU
(the rehearsal), its control failing a limit, the same run with the
manager's decisions or the Tuner broken underneath (each fault found),
and the readers of its own metrics.

Tiny: campaigns of 96 trials with the manager's `max_points` at 32, so
that its refits subsample, windows of 5 seconds; the space, the surface
and every other option are the configuration's."""
import copy
import json

import numpy as np
import pytest
import torch

from portbench import devtrace, spec
from portbench.drivers import campaign
from portbench.drivers.common import Run, TraceCtx

BENCH = spec.load_benchmark()
CELL = "gcc-options-g12-tuner.gpcampaign"
MS = 1_000_000


def tiny(seconds: float = 5.0, processes: int = 1) -> Run:
    c = spec.workload(BENCH, CELL)
    cfg = copy.deepcopy(spec.config(BENCH, c["config"]))
    cfg["tuner"]["campaign_trials"] = 96
    cfg["tuner"]["processes"] = processes
    cfg["surrogate"]["max_points"] = 32
    mix = copy.deepcopy(spec.traffic(c["traffic"]))
    limits = json.loads((spec.HERE / "limits" / f"{CELL}.json").read_text())
    return Run(c, cfg, mix, 2 ** 33 + 29, seconds, False,
               torch.device("cpu"), lambda: None, limits)


def failed(out) -> list:
    return [c.name for c in out.checks if not c.ok]


def test_rehearsal():
    out = campaign.run(tiny())
    assert failed(out) == [], [(c.name, c.value, c.limit)
                               for c in out.checks]
    assert out.attempted > 0 and out.failed == 0
    assert out.rates["acq_per_s"] > 0
    n = out.numbers
    assert n["campaigns"] >= 1 and n["rows_scored"] > 0
    assert n["fits_judged"] >= 2 and n["prunes_judged"] >= 1 \
        and n["pulls_judged"] >= 1


def test_rehearsal_in_tuning_processes():
    """The campaigns in two tuning processes in turns: each warms its
    own, the window's alternate between them, and their judgements and
    controls come back as one."""
    r = tiny(processes=2)
    out = campaign.run(r)
    assert failed(out) == [], [(c.name, c.value, c.limit)
                               for c in out.checks]
    n = out.numbers
    assert n["campaigns"] >= 1 and n["rows_scored"] > 0
    assert n["tenants"] >= 3      # two warm campaigns and the window's
    assert n["fits_judged"] >= 4 and n["prunes_judged"] >= 1 \
        and n["pulls_judged"] >= 1
    ctl = out.control()
    assert set(campaign.LIMITS) <= set(ctl)
    assert [k for k in campaign.LIMITS if ctl[k] > r.limits[k]], ctl
    del out


def test_a_failing_tuning_process_fails_the_run():
    """A process that cannot run the cell (here: a technique the cell
    does not run; a program without `rows_scored` fails the same way)
    ends the run with its error, and no process is left behind."""
    r = tiny(processes=2)
    r.config["tuner"]["technique"] = "PSO"
    with pytest.raises(RuntimeError, match="tuning process 0 failed"):
        campaign.run(r)


def test_merge_sums_counts_and_keeps_the_widest():
    a = {"tells_lost": 1, "fits_judged": 2, "value_gap": 3.0,
         "value_gap_at": ["Fit", 1], "best_gap": 0.0}
    b = {"tells_lost": 2, "fits_judged": 0, "value_gap": 5.0,
         "value_gap_at": ["Pull", 2], "best_gap": 0.5}
    m = campaign.merge([a, b])
    assert m == {"tells_lost": 3, "fits_judged": 2, "value_gap": 5.0,
                 "value_gap_at": ["Pull", 2], "best_gap": 0.5}


def test_control_fails():
    r = tiny()
    ctl = campaign.run(r).control()
    over = [k for k, v in ctl.items()
            if k in r.limits and isinstance(v, (int, float))
            and v > r.limits[k]]
    assert over, ctl


# -- faults planted under the timed path ------------------------------------
def _ei(m, snap, cands, best):
    from uptune_tpu_torch.surrogate import gp
    return gp.expected_improvement(
        snap.state, m.space.surrogate_features(cands), best,
        m.space.n_cont_features, m.space.n_cat)


def _prune_keeps_its_worst_row(mp):
    from uptune_tpu_torch.surrogate.manager import SurrogateManager
    f = SurrogateManager._keep_mask

    def worst_kept(self, snap, cands, candidate_mask):
        keep, explore_u = f(self, snap, cands, candidate_mask)
        keep = keep.copy()
        elig = np.asarray(candidate_mask, bool)
        ei = _ei(self, snap, cands, snap.best_y).numpy()
        out = elig & ~keep
        if out.any() and (keep & elig).any():
            kept = np.nonzero(keep & elig)[0]
            keep[kept[np.argmax(ei[kept])]] = False
            keep[np.nonzero(out)[0][np.argmin(ei[out])]] = True
        return keep, explore_u
    mp.setattr(SurrogateManager, "_keep_mask", worst_kept)


def _pull_returns_a_low_row(mp):
    from uptune_tpu_torch.surrogate.manager import SurrogateManager
    f = SurrogateManager._rank_pool

    def low(self, state, cands, best_y):
        idx = f(self, state, cands, best_y).clone()
        ei = _ei(self, self._snap, cands, best_y)
        idx[-1] = int(torch.argmin(ei))
        return idx
    mp.setattr(SurrogateManager, "_rank_pool", low)


def _tell_lost(mp):
    from uptune_tpu_torch.driver import Tuner
    f = Tuner.tell
    calls = [0]

    def lossy(self, trial, qor, dur=0.0):
        calls[0] += 1
        if calls[0] % 97 == 0:
            return None
        return f(self, trial, qor, dur)
    mp.setattr(Tuner, "tell", lossy)


def _refit_at_another_lengthscale(mp):
    from uptune_tpu_torch.surrogate import gp
    f = gp.fit_auto

    def other(x, y, mask=None, **kw):
        st = f(x, y, mask, **kw)
        return gp.fit(x, y, st.lengthscale * 4.0, st.noise, mask,
                      n_cont=kw.get("n_cont"), n_cat=kw.get("n_cat", 0),
                      ls_cat=st.ls_cat)
    mp.setattr(gp, "fit_auto", other)


def _decisions_unseen(mp):
    """The manager's decisions no longer reach the judge (its observer
    renamed or dropped): nothing is compared, and the cell says so."""
    mp.setattr(campaign.Campaign, "watch", lambda self, what, d: None)


FAULTS = [_prune_keeps_its_worst_row, _pull_returns_a_low_row, _tell_lost,
          _refit_at_another_lengthscale, _decisions_unseen]
FOUND_BY = {"_prune_keeps_its_worst_row": "prune_select_gap",
            "_pull_returns_a_low_row": "topk_select_gap",
            "_tell_lost": "tells_lost",
            "_refit_at_another_lengthscale": "fit_mll_gap",
            "_decisions_unseen": "unjudged"}


@pytest.mark.parametrize("fault", FAULTS, ids=[f.__name__[1:]
                                               for f in FAULTS])
def test_fault_is_found(fault, monkeypatch):
    fault(monkeypatch)
    out = campaign.run(tiny())
    assert FOUND_BY[fault.__name__] in failed(out), \
        [(c.name, c.value) for c in out.checks]


# -- the readers of the cell's own metrics ------------------------------------
@pytest.mark.parametrize("name", ["refit", "pool", "prune"])
def test_span_readers(name):
    rd = spec.metric_reader(f"surrogate.{name}_ms")
    mine = f"surrogate.{name}"
    spans = [devtrace.Span(mine, 1 * MS, 2 * MS),
             devtrace.Span(mine, 3 * MS, 6 * MS),
             devtrace.Span("surrogate.tick", 0, 7 * MS),
             devtrace.Span(mine, 9 * MS, 12 * MS)]     # past the window
    ctx = TraceCtx(0, 10 * MS, 2, extra={"obs_spans": spans})
    assert rd(ctx) == pytest.approx(2.0)    # (1 + 3) ms over 2 units
    # a program without the span, or a window without spans
    assert rd(TraceCtx(0, 10 * MS, 2, extra={"obs_spans": spans[2:3]})) \
        is None
    assert rd(TraceCtx(0, 10 * MS, 2)) is None
