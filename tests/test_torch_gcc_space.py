"""The mined g++ 12.2 flag space (the benchmark's `gcc-options-g12`
configuration) through the port on the CPU, at its full 328 lanes (233
enums, 95 ints up to 1,048,574 wide) and the GP's 1027 features, held
against the benchmark's plain float64 reference
(`portbench/reference/`): decode and membership, the hash, the GP's
features, a scored step's commit and `propose_topk`; the archived
trials the GP trains on; the launch counter by krows route; the
`acquire.features` span; an engine without a device objective.

Small scale: the default arms at scale 1 (432 rows a step), a 512-row
history (a step must fit in it), a 64-row GP and k 8."""
import copy
import ctypes
import json
import shutil
import subprocess

import numpy as np
import pytest
import torch

from portbench.drivers.common import program_space
from portbench.reference import gcc
from portbench.reference import gp as ref_gp
from portbench.reference import history as ref_hist
from portbench.reference.space import RefSpace
from uptune_tpu_torch import native, obs
from uptune_tpu_torch.engine import FusedEngine, surrogate_eval_fn
from uptune_tpu_torch.engine.fused import default_arms
from uptune_tpu_torch.ops import acquire
from uptune_tpu_torch.space.spec import CandBatch
from uptune_tpu_torch.surrogate import gp
from uptune_tpu_torch.surrogate import pallas_score as ps
from uptune_tpu_torch.techniques.purerandom import PureRandom

CONFIG = gcc.ROOT / "portbench" / "configs" / "gcc-options-g12.json"
CPU = torch.device("cpu")
ROWS, CAP, TRAIN, K = 432, 512, 64, 8
# a float32 GP against the float64 reference, both from the same float32
# training rows, at the configuration's hyperparameters (K's condition
# number is a few hundred): float32's rounding through the Cholesky and
# the EI leaves gaps of about 1e-7 of the targets' std (at most 1.1e-7
# in these steps); the reference in TF32, the precision below, reads
# about 3e-5 in them
EI_TOL = 5e-6
# the GP's features of an int lane are (v - lo) / (hi - lo) on the
# search scale: float32's rounding of the bounds and of the division
# gives a few ulps of 1
FEATURE_TOL = 1e-6


@pytest.fixture(scope="module")
def cfg():
    return json.loads(CONFIG.read_text())


@pytest.fixture(scope="module")
def spaces(cfg):
    return (program_space(cfg["space"]),
            RefSpace(cfg["space"], cfg["hash"]["multiplier_seed"]))


def arms(space, scale=1):
    out = default_arms(scale)
    pad = -sum(t.natural_batch(space) for t in out) % 8
    return out + [PureRandom(batch=pad)] if pad else out


@pytest.fixture(scope="module")
def model(cfg, spaces):
    """The engine without a device objective, and its EI over a GP
    fitted on the first 64 archived builds."""
    space, ref = spaces
    small = copy.deepcopy(cfg)
    small["gp"]["train_rows"] = TRAIN
    g = small["gp"]
    u, y = gcc.training_set(small, 7)
    x = space.surrogate_transform(space.features(CandBatch(
        torch.from_numpy(u), ())))
    st = gp.fit(x, torch.from_numpy(y), g["lengthscale"], g["noise"],
                n_cont=space.n_cont_features, n_cat=space.n_cat,
                ls_cat=g["ls_cat"])
    best = float(y.min())
    ev = surrogate_eval_fn(space, st, kind="ei", best_y=best, impl="fused",
                           n_cont=space.n_cont_features, n_cat=space.n_cat)
    vals, _ = resolved(space, ref, torch.from_numpy(u))
    post = ref_gp.fit(torch.from_numpy(ref.features(u, vals, [])),
                      torch.from_numpy(y.astype(np.float64)), g["lengthscale"],
                      g["noise"], g["ls_cat"], ref.n_cont, ref.n_cat)
    eng = FusedEngine(space, None, arms=arms(space), history_capacity=CAP,
                      device=CPU)
    return eng, ev, post, best


def seeded_u(space, seed=3, n=2048):
    """Uniform rows, then every lane at 0, at 1 and at 0.5."""
    g = torch.Generator().manual_seed(seed)
    u = torch.rand((n, space.n_scalar), generator=g)
    ends = torch.tensor([[0.0], [1.0], [0.5]]).expand(3, space.n_scalar)
    return torch.cat([u, ends])


def resolved(space, ref, u):
    """The reference's values of unit rows, the program's rounding taken
    where float32 may round either way; and the lanes where the
    program's value is no member or differs."""
    pv = space.decode_scalars(u).numpy()
    return ref.resolve(u.numpy(), pv)


# -- the space ------------------------------------------------------------------
def test_the_space_is_the_archived_signature(cfg, spaces):
    space, _ = spaces
    for rel in cfg["trials"]["archives"]:
        with open(gcc.ROOT / rel) as fh:
            sig = json.loads(fh.readline())["space_sig"]
        assert gcc.parse_signature(sig) == cfg["space"]
    kinds = [p["kind"] for p in cfg["space"]]
    assert kinds == ["enum"] * 233 + ["int"] * 95
    widths = [p["hi"] - p["lo"] for p in cfg["space"] if p["kind"] == "int"]
    assert (min(widths), max(widths)) == (1, 1048574)
    assert (space.n_scalar, space.n_cat, space.cat_max_codes) == (328, 233, 4)
    assert space.n_surrogate_features == cfg["gp"]["features"] == 1027
    assert sum(t.natural_batch(space) for t in arms(space, 64)) == \
        cfg["rows_per_step"] == 6352
    assert sum(t.natural_batch(space) for t in arms(space)) == ROWS


def test_decode_and_membership_match_the_reference(spaces, model):
    space, ref = spaces
    eng = model[0]
    _, cands, _ = eng.propose(eng.init(seed=5))
    for u in (seeded_u(space), cands.u):
        vals, bad = resolved(space, ref, u)
        assert bad.sum() == 0
        assert ref.members(u.numpy(), []).all()
    # float32's ulp at a million is 1/16: the widest lanes' rounding is
    # the program's choice only within that reach of a .5 boundary
    _, amb = ref.decode(seeded_u(space).numpy())
    assert amb[:, :233].mean() < 1e-3


def test_hash_matches_the_reference(spaces):
    space, ref = spaces
    u = seeded_u(space, seed=4)
    vals, _ = resolved(space, ref, u)
    want = ref.hash(ref.lanes(u.numpy(), vals, []))
    got = space.hash_batch(CandBatch(u, ())).numpy()
    np.testing.assert_array_equal(got, want)
    assert len({tuple(h) for h in got.tolist()}) == len(got)


def test_features_match_the_reference(spaces):
    space, ref = spaces
    u = seeded_u(space, seed=5)
    vals, _ = resolved(space, ref, u)
    got = space.surrogate_transform(space.features(CandBatch(u, ())))
    want = ref.features(u.numpy(), vals, [])
    assert got.shape == want.shape == (u.shape[0], 1027)
    np.testing.assert_allclose(got.double().numpy(), want, rtol=0,
                               atol=FEATURE_TOL)
    # one code of each enum lane, over 4 columns scaled by 1/sqrt(2)
    oh = got[:, 95:].reshape(-1, 233, 4)
    assert torch.allclose(oh.sum(-1), torch.full((1,), 2 ** -0.5))


# -- the archived trials ----------------------------------------------------------
def test_the_training_set_starts_with_the_archived_builds(cfg):
    u, q = gcc.archived(cfg)
    assert u.shape == (276, 328) and u.dtype == np.float32
    assert np.isfinite(q).all() and len({r.tobytes() for r in u}) == 276
    assert 0.019 < q.min() < q.max() < 1.27
    x1, y1 = gcc.training_set(cfg, 11)
    x2, y2 = gcc.training_set(cfg, 11)
    x3, y3 = gcc.training_set(cfg, 12)
    assert x1.shape == (1024, 328) and y1.dtype == np.float32
    np.testing.assert_array_equal(x1, x2)
    np.testing.assert_array_equal(y1, y2)
    np.testing.assert_array_equal(x1[:276], u)
    np.testing.assert_array_equal(y1[:276], q.astype(np.float32))
    assert not np.array_equal(x1[276:], x3[276:])
    assert set(y1[276:].tolist()) <= set(q.astype(np.float32).tolist())
    assert ((x1 >= 0) & (x1 < 1)).all()


def test_an_archive_of_another_space_is_refused(cfg):
    other = copy.deepcopy(cfg)
    other["space"][-1]["hi"] += 1
    with pytest.raises(ValueError, match="its space is not"):
        gcc.archived(other)


# -- a scored step and propose_topk --------------------------------------------------
def table(h) -> ref_hist.Table:
    return ref_hist.Table(h.h0.numpy(), h.h1.numpy(), h.qor.double().numpy(),
                          h.age.numpy().astype(np.int64), int(h.n),
                          int(h.step), int(h.dropped))


def ei_ref(spaces, post, best, u):
    """The reference's values of unit rows and their EI (float64)."""
    space, ref = spaces
    vals, _ = resolved(space, ref, u)
    return vals, ref_gp.ei(post, torch.from_numpy(ref.features(
        u.numpy(), vals, [])), best).numpy()


@pytest.fixture(scope="module")
def steps(model):
    """Three scored steps from a fresh state (past the first, each
    evicts: two steps' rows overfill the history)."""
    eng, ev = model[:2]
    sts = [eng.init(seed=9)]
    for _ in range(3):
        sts.append(eng.step(sts[-1], eval_fn=ev))
    return sts


@pytest.mark.parametrize("i", [0, 1, 2])
def test_a_scored_step_commits_as_the_reference(spaces, model, steps, i):
    _, ref = spaces
    eng, _, post, best = model
    pre, post_st = steps[i], steps[i + 1]
    _, cands, _ = eng.propose(pre)
    vals, want_ei = ei_ref(spaces, post, best, cands.u)
    hashes = ref.hash(ref.lanes(cands.u.numpy(), vals, []))
    t_pre, t_post = table(pre.hist), table(post_st.hist)
    nov = ref_hist.novel(t_pre, hashes)
    want = ref_hist.commit(t_pre, hashes, -want_ei, nov)
    assert ref_hist.mismatches(want, t_post) == {"rows": 0, "n": 0,
                                                 "step": 0, "dropped": 0}
    assert int(post_st.evals) - int(pre.evals) == int(nov.sum())
    live = t_post.age == t_pre.step
    gap = np.abs(t_post.qor[live] - want.qor[live]).max() / float(post.std)
    assert live.sum() > 0 and gap < EI_TOL
    best_want = min(float(pre.best.qor), float((-want_ei).min()))
    assert abs(float(post_st.best.qor) - best_want) / float(post.std) < EI_TOL
    assert (t_post.dropped > t_pre.dropped) == (i > 0)


def test_propose_topk_ranks_as_the_reference(spaces, model, steps):
    eng, ev, post, best = model
    _, cands, _, v, idx = eng.propose_topk(steps[-1], ev, K)
    _, want = ei_ref(spaces, post, best, cands.u)
    i = idx.numpy().astype(np.int64)
    assert len(set(i.tolist())) == K and (np.diff(v.numpy()) <= 0).all()
    np.testing.assert_allclose(v.double().numpy(), want[i], rtol=0,
                               atol=EI_TOL * float(post.std))
    kth = ref_gp.topk(want, K)[0][-1]
    assert max(0.0, kth - want[i].min()) / float(post.std) < EI_TOL


def test_an_engine_without_objective_needs_an_eval_fn(model):
    eng = model[0]
    st = eng.init(seed=1)
    with pytest.raises(ValueError, match="no device objective"):
        eng.step(st)
    _, cands, _ = eng.propose(st)
    with pytest.raises(ValueError, match="no device objective"):
        eng.evaluate(cands)
    assert eng.graph_counts["step"]["eager"] == 0


# -- the acquire.features span ---------------------------------------------------------
@pytest.mark.parametrize("on", [True, False])
def test_acquire_features_is_one_span_a_call(model, on):
    eng, ev = model[:2]
    _, cands, _ = eng.propose(eng.init(seed=2))
    obs.reset()
    try:
        obs.enable()
        if not on:
            obs.disable()       # the rings stay, and stay empty
        ev(cands)
        ev.topk(cands, ev.aux, K)
        names = [e["name"] for e in obs.snapshot()["events"]]
        assert names.count("acquire.features") == (2 if on else 0)
    finally:
        obs.reset()


# -- the launch counter by krows route -------------------------------------------------
@pytest.fixture(scope="module")
def plan(tmp_path_factory):
    """gp_plan.h built by the host compiler: the library's own answers
    to the launchers' queries, the route among them."""
    cxx = shutil.which("g++") or shutil.which("c++")
    assert cxx, "no host C++ compiler"
    d = tmp_path_factory.mktemp("plan")
    (d / "plan.cpp").write_text('#include "gp_plan.h"\n')
    out = subprocess.run(
        [cxx, "-std=c++17", "-O2", "-shared", "-fPIC", "-I",
         str(native.CSRC), "-o", str(d / "gp_plan.so"), str(d / "plan.cpp")],
        capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    return ctypes.CDLL(str(d / "gp_plan.so"))


def launch_on_the_plan(monkeypatch, plan):
    """B, C and D launch nothing (the launch seam, `Kernel.call`, returns
    success) and are counted from zero, and ask the host-built plan what
    the CUDA library would answer."""
    monkeypatch.setattr(native.Kernel, "call", lambda self, dev, *args: 0)
    for kern in (native.GP_MEAN_VAR, native.ACQ_SCORES, native.ACQ_TOPK):
        monkeypatch.setattr(kern, "library", lambda: plan)
    monkeypatch.setattr(ps, "require_cuda", lambda kernel, dev: None)
    native.reset_launches()


def operands(f, fc, b=16, n=8):
    g = torch.Generator().manual_seed(f)
    r = [torch.rand(s, generator=g) for s in
         ((b, fc), (b, f - fc), (n, fc), (n, f - fc), (n,), (n, n))]
    params = torch.tensor([1e-4, 0.0, 1.0, 0.5, 2.0])
    return r, params


@pytest.mark.parametrize("f,fc,route", [(1027, 95, "tensor_cores"),
                                        (31, 23, "cuda_cores"),
                                        (361, 95, "cuda_cores"),
                                        (362, 95, "tensor_cores")])
def test_launches_count_by_krows_route(monkeypatch, plan, f, fc, route):
    launch_on_the_plan(monkeypatch, plan)
    (qc, qk, xc, xk, alpha, kinv), params = operands(f, fc)
    acquire.scores_cuda(qc, qk, xc, xk, alpha, kinv, params, "ei")
    acquire.topk_cuda(qc, qk, xc, xk, alpha, kinv, params, "ei", 4)
    acquire.scores_cuda(qc, qk, xc, xk, alpha, kinv, params, "lcb")
    ps.mean_var_tile_cuda(qc, qk, xc, xk, alpha, kinv)
    other = "cuda_cores" if route == "tensor_cores" else "tensor_cores"
    assert native.ACQ_SCORES.route_launches() == {route: 2, other: 0}
    assert native.ACQ_TOPK.route_launches() == {route: 1, other: 0}
    assert native.GP_MEAN_VAR.route_launches() == {route: 1, other: 0}
    assert native.ACQ_SCORES.width_launches == {f: 2}
    assert native.MERGE.route_launches() is None
    native.reset_launches()
    assert native.ACQ_SCORES.route_launches() == {route: 0, other: 0}
    assert not native.ACQ_TOPK.width_launches
