"""Parity of the port's QuickEst (`uptune_tpu_torch/quickest/`) with the
JAX package's, on the CPU, and tests/test_quickest.py's bodies on the
port.

Both packages fit the same seeded numpy rows.  What is held:

* `_lasso_fit`: the ISTA coefficients within rtol 1e-5 and an atol of
  1e-6 times the largest (`LASSO_TOL`), and the selected features
  (`sel`, argsort of -|w| with the 1e-6 floor) equal;
* `_TargetModel` with the MLP's init normals `jax.random` drew replayed
  into the port's fit (`test_torch_mlp.jax_init`): `sel` equal, and the
  predictions within test_torch_mlp's `FIT_TOL_Y_STD` of the targets'
  std;
* a model directory saved by either package loads in the other: the
  same quickest.json, the same npz keys and shapes, and predictions
  within `CROSS_TOL_Y_STD` of the targets' std (one set of weights, two
  forward passes);
* `hlsreport.extract`'s CSV, and the `feature_importance` and
  `hls_scores` tables, byte for byte (host code on the same model); the
  `scores` table, whose predictions come from two forward passes,
  within `CROSS_TOL_Y_STD`;
* the reference's own bodies with their names pointed at the port, on
  the CPU, but the two it marks slow.
"""
import csv
import functools
import importlib
import inspect
import os
import sys
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import test_quickest as ref
import uptune_tpu
from test_torch_mlp import FIT_TOL_Y_STD, jax_init
from test_torch_ops import T

from uptune_tpu.quickest import hlsreport as jhls
from uptune_tpu.quickest import pipeline as jp
from uptune_tpu_torch.quickest import hlsreport as thls
from uptune_tpu_torch.quickest import pipeline as tp
from uptune_tpu_torch.surrogate import mlp as tmlp

# the modules (each package's `quickest.analyze` attribute is the function)
janalyze = importlib.import_module("uptune_tpu.quickest.analyze")
tanalyze = importlib.import_module("uptune_tpu_torch.quickest.analyze")
tq = importlib.import_module("uptune_tpu_torch.quickest")

LASSO_TOL = {"rtol": 1e-5, "atol_of_max": 1e-6}
CROSS_TOL_Y_STD = 1e-5
STEPS = 60           # MLP steps of the parity fits (the reference: 400)


def lasso_close(got, want):
    np.testing.assert_allclose(
        got, want, rtol=LASSO_TOL["rtol"],
        atol=LASSO_TOL["atol_of_max"] * float(np.abs(want).max()))


def selected(w, top_k=32):
    """`_TargetModel.fit`'s feature selection."""
    order = np.argsort(-np.abs(w))
    sel = order[:min(top_k, len(w))]
    sel = sel[np.abs(w[sel]) > 1e-6]
    return np.sort(sel if len(sel) else order[:1])


def standardized(x, y):
    return ((x - x.mean(0)) / np.maximum(x.std(0), 1e-8),
            (y - y.mean()) / max(float(y.std()), 1e-8))


def lasso_data():
    """TestLasso's rows, and _dataset's LUT target standardized."""
    rs = np.random.RandomState(0)
    x = rs.randn(300, 20).astype(np.float32)
    y = (2.0 * x[:, 3] - 1.0 * x[:, 7] + 0.02 * rs.randn(300)).astype(
        np.float32)
    x2, y2 = ref._dataset()
    return [(x, y, 0.05), (*standardized(x2, y2[:, 0]), 0.02)]


@pytest.mark.parametrize("case", [0, 1])
def test_lasso_matches_jax(case):
    x, y, lam = lasso_data()[case]
    wj, bj = jp._lasso_fit(jnp.asarray(x), jnp.asarray(y), lam)
    wt, bt = tp._lasso_fit(T(x), T(y), lam)
    lasso_close(wt.numpy(), np.asarray(wj))
    np.testing.assert_allclose(float(bt), float(bj), rtol=1e-5, atol=1e-6)
    np.testing.assert_array_equal(selected(wt.numpy()),
                                  selected(np.asarray(wj)))


@pytest.fixture(scope="module")
def saved(tmp_path_factory):
    """The same data fitted and saved by each package."""
    x, y = ref._dataset(n=160)
    names = [f"feat{i}" for i in range(x.shape[1])]
    targets = ["LUT_impl", "FF_impl"]
    d = tmp_path_factory.mktemp("quickest")
    ej = jp.QuickEst(mlp_steps=STEPS, n_members=2).fit(
        x, y, targets, feature_names=names)
    et = tp.QuickEst(device="cpu", mlp_steps=STEPS, n_members=2).fit(
        x, y, targets, feature_names=names)
    ej.save(str(d / "jax"))
    et.save(str(d / "port"))
    return d, ej, et, targets, ref._dataset(seed=1, n=50)


@pytest.mark.parametrize("j", [0, 1])
def test_target_model_with_jax_draws(saved, j):
    """Each target of the JAX fit in `saved` (seed j, two members)
    against the port's fit of the same rows from JAX's init draws."""
    d, ej, _, targets, (xq, yq) = saved
    x, y = ref._dataset(n=160)
    x, _ = jp.preprocess(x)
    mj = ej.models[targets[j]]
    init = jax_init(jax.random.PRNGKey(j), tmlp.layer_sizes(len(mj.sel)),
                    n_members=2)
    mt = tp._TargetModel(mlp_steps=STEPS, n_members=2, seed=j,
                         device="cpu").fit(x, y[:, j], init=init)
    np.testing.assert_array_equal(mt.sel, mj.sel)
    lasso_close(mt.w, mj.w)
    xp = jp.apply_preprocess(xq, ej.pre_meta)
    np.testing.assert_allclose(
        mt.predict(xp), mj.predict(xp), rtol=0,
        atol=FIT_TOL_Y_STD * float(y[:, j].std()))


def test_target_model_own_draws_are_a_function_of_the_seed():
    x, y = ref._dataset(seed=4, n=100)
    a = tp._TargetModel(mlp_steps=10, seed=2, device="cpu").fit(x, y[:, 0])
    b = tp._TargetModel(mlp_steps=10, seed=2, device="cpu").fit(x, y[:, 0])
    c = tp._TargetModel(mlp_steps=10, seed=3, device="cpu").fit(x, y[:, 0])
    np.testing.assert_array_equal(a.predict(x), b.predict(x))
    assert not np.array_equal(a.predict(x), c.predict(x))


def test_saved_directories_have_one_layout(saved):
    d, *_ = saved
    assert sorted(os.listdir(d / "jax")) == sorted(os.listdir(d / "port"))
    assert ((d / "jax" / "quickest.json").read_bytes()
            == (d / "port" / "quickest.json").read_bytes())
    for name in os.listdir(d / "jax"):
        if name.endswith(".npz"):
            a, b = np.load(d / "jax" / name), np.load(d / "port" / name)
            assert sorted(a.files) == sorted(b.files)
            for k in a.files:
                assert a[k].shape == b[k].shape and a[k].dtype == b[k].dtype


@pytest.mark.parametrize("saved_by", ["jax", "port"])
def test_model_directory_loads_in_the_other_package(saved, saved_by):
    d, ej, et, targets, (xq, yq) = saved
    mine = ej if saved_by == "jax" else et
    other = (tp.QuickEst.load(str(d / saved_by), device="cpu")
             if saved_by == "jax" else jp.QuickEst.load(str(d / saved_by)))
    for j, t in enumerate(targets):
        np.testing.assert_allclose(
            other.predict(xq, t), mine.predict(xq, t), rtol=0,
            atol=CROSS_TOL_Y_STD * float(yq[:, j].std()))
        np.testing.assert_array_equal(other.models[t].sel,
                                      mine.models[t].sel)


def read(path):
    return open(path, "rb").read()


def test_analyze_tables(saved, tmp_path):
    d, _, _, targets, (xq, yq) = saved
    ej = jp.QuickEst.load(str(d / "jax"))
    et = tp.QuickEst.load(str(d / "jax"), device="cpu")
    for pkg, est, mod in (("jax", ej, janalyze), ("port", et, tanalyze)):
        out = tmp_path / pkg
        mod.feature_importance(est, save_dir=str(out))
        mod.hls_scores(xq, yq, [("feat0", "LUT_impl"), ("feat5", "FF_impl")],
                       [f"feat{i}" for i in range(xq.shape[1])], targets,
                       save_dir=str(out))
        mod.scores(est, xq, yq, targets, save_dir=str(out))
    for name in ("feature_importance.csv", "scores_hls.csv"):
        assert read(tmp_path / "jax" / name) == read(tmp_path / "port" / name)
    rows = [list(csv.reader(open(tmp_path / p / "scores.csv")))
            for p in ("jax", "port")]
    assert [r[0] for r in rows[0]] == [r[0] for r in rows[1]]
    np.testing.assert_allclose(
        np.asarray([r[1:] for r in rows[1][1:]], float),
        np.asarray([r[1:] for r in rows[0][1:]], float), rtol=0,
        atol=CROSS_TOL_Y_STD)


def test_extract_csv_byte_equal(tmp_path):
    for design, cp, fit in (("fir", 10, True), ("matmul", 20, True),
                            ("gemm", 5, False)):
        ref.TestExtract._make_tree(tmp_path, design, cp, with_fit=fit)
    dirs = [str(tmp_path / n) for n in ("fir", "matmul", "gemm")]
    for req in (True, False):
        nj = jhls.extract(dirs, str(tmp_path / "j.csv"),
                          require_targets=req)
        nt = thls.extract(dirs, str(tmp_path / "t.csv"),
                          require_targets=req)
        assert nj == nt
        assert read(tmp_path / "j.csv") == read(tmp_path / "t.csv")
    assert (thls.discover_operations(dirs)
            == jhls.discover_operations(dirs))


def test_default_device_is_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    x, y = ref._dataset(n=40)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tp.QuickEst().fit(x, y[:, 0], ["LUT_impl"])


# -- the reference's bodies on the port ---------------------------------------
class CpuQuickEst(tp.QuickEst):
    """The port's QuickEst on the CPU unless told otherwise."""

    def __init__(self, device="cpu", **model_opts):
        super().__init__(device=device, **model_opts)

    @classmethod
    def load(cls, path, device="cpu"):
        return tp.QuickEst.load.__func__(cls, path, device)


def port_lasso(x, y, lam, steps=500):
    return tp._lasso_fit(T(np.asarray(x)), T(np.asarray(y)), lam, steps)


# the package the bodies import inside (`from uptune_tpu.quickest import
# scores`, ...): the port's, its entry points on the CPU
CPU_QUICKEST = types.ModuleType("uptune_tpu.quickest")
CPU_QUICKEST.__dict__.update({n: getattr(tq, n) for n in tq.__all__})
CPU_QUICKEST.__dict__.update(
    QuickEst=CpuQuickEst,
    train=functools.partial(tq.train, device="cpu"),
    test=functools.partial(tq.test, device="cpu"),
    predict=functools.partial(tq.predict, device="cpu"),
    learning_curve=functools.partial(tq.learning_curve, device="cpu"),
    hlsreport=thls)
PORT_NAMES = {
    "QuickEst": CpuQuickEst, "load_csv": tp.load_csv,
    "preprocess": tp.preprocess, "apply_preprocess": tp.apply_preprocess,
    "q_train": CPU_QUICKEST.train, "q_test": CPU_QUICKEST.test,
    "q_predict": CPU_QUICKEST.predict, "_lasso_fit": port_lasso,
    "r2_score": tp.r2_score, "rae": tp.rae,
}
# the bodies the reference marks slow stay out, as in its own tier-1 run
SLOW = {"test_seed_option_accepted", "test_learning_curve_improves_with_data"}
REF_CASES = [(c, n) for c in ("TestPreprocess", "TestLasso", "TestQuickEst",
                              "TestModuleFacade", "TestRegressions",
                              "TestAnalyze", "TestExtract", "TestCSV")
             for n, _ in inspect.getmembers(getattr(ref, c),
                                            inspect.isfunction)
             if n.startswith("test_") and n not in SLOW]
_FITTED = {}


@pytest.mark.parametrize("cls,name", REF_CASES)
def test_reference_body_on_the_port(cls, name, monkeypatch, request):
    for attr, value in PORT_NAMES.items():
        monkeypatch.setattr(ref, attr, value)
    monkeypatch.setattr(uptune_tpu, "analyze", tq.analyze)
    monkeypatch.setitem(sys.modules, "uptune_tpu.quickest", CPU_QUICKEST)
    monkeypatch.setitem(sys.modules, "uptune_tpu.quickest.hlsreport", thls)
    klass = getattr(ref, cls)
    obj = klass()
    case = getattr(obj, name)
    kwargs = {}
    for p in inspect.signature(case).parameters:
        if p == "fitted":
            if cls not in _FITTED:
                _FITTED[cls] = klass.fitted.__wrapped__(obj)
            kwargs[p] = _FITTED[cls]
        else:
            kwargs[p] = request.getfixturevalue(p)
    case(**kwargs)
