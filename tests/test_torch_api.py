"""The child side of program mode in the port (uptune_tpu_torch/api/):
the `UT_*` protocol against the JAX package's.

A tuned program imports either package; the controller of either must
serve it.  So one fixture program, run under each package in the
analysis, TUNE and BEST modes, must leave byte-identical protocol files,
the registry and settings must agree, and importing the port in a child
must not pull in torch (a trial would pay for it) or JAX.
"""
import json
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import pytest

from uptune_tpu.api import constraint as JC
from uptune_tpu.api import session as JS
from uptune_tpu.api import state as JState

from uptune_tpu_torch.api import constraint as TC
from uptune_tpu_torch.api import session as TS
from uptune_tpu_torch.api import state as TState

REPO = Path(__file__).resolve().parent.parent
PKGS = ("uptune_tpu", "uptune_tpu_torch")

# every tune() kind, a named and an unnamed call, a covariate, an
# intermediate feature vector and the target
PROG = textwrap.dedent("""
    import {pkg} as ut
    x = ut.tune(3, (1, 9), name="x")
    r = ut.tune(0.5, (0.0, 2.0))
    f = ut.tune(True, name="flag")
    o = ut.tune("-O2", ["-O1", "-O2", "-O3"], name="olevel")
    p = ut.tune([0, 1, 2, 3], [0, 1, 2, 3], name="order")
    ut.feature(x * 2, "twice")
    ut.interm([float(x), r, float(len(p))])
    q = (x - 4) ** 2 + r + (0.5 if f else 0.0) + {{"-O1": 1, "-O2": 2,
        "-O3": 3}}[o] + sum(abs(a - i) for i, a in enumerate(p))
    ut.target(float(q), "min")
    print(ut.get_global_id(), ut.get_local_id())
""")

CONFIG = {"x": 7, "v0_1": 1.25, "flag": False, "olevel": "-O3",
          "order": [3, 1, 0, 2]}


def _run(pkg: str, work: Path, env: dict) -> subprocess.CompletedProcess:
    prog = work / "prog.py"
    prog.write_text(PROG.format(pkg=pkg))
    full = {k: v for k, v in os.environ.items()
            if k not in ("UT_BEFORE_RUN_PROFILE", "UT_TUNE_START", "BEST",
                         "UT_WORK_DIR")}
    full.update(PYTHONPATH=str(REPO), UT_WORK_DIR=str(work), **env)
    return subprocess.run([sys.executable, str(prog)], cwd=work, env=full,
                          capture_output=True, text=True, timeout=120)


def _files(work: Path) -> dict:
    return {str(p.relative_to(work)): p.read_bytes()
            for p in sorted(work.rglob("*"))
            if p.is_file() and p.name != "prog.py"
            and "__pycache__" not in p.parts}


def _stage(work: Path, mode: str, params: bytes) -> dict:
    """The files the controller leaves before a trial of `mode`, and the
    mode's variables."""
    work.mkdir(parents=True, exist_ok=True)
    (work / "ut.params.json").write_bytes(params)
    if mode == "tune":
        (work / "configs").mkdir(exist_ok=True)
        (work / "configs" / "ut.dr_stage0_index2.json").write_text(
            json.dumps(CONFIG))
        return {"UT_TUNE_START": "True", "UT_CURR_INDEX": "2",
                "UT_CURR_STAGE": "0", "UT_GLOBAL_ID": "17"}
    (work / "best.json").write_text(json.dumps(
        {"config": CONFIG, "qor": 1.5}, indent=1))
    return {"BEST": "True"}


@pytest.fixture(scope="module")
def analysis(tmp_path_factory):
    """The analysis run of the fixture under each package."""
    out = {}
    for pkg in PKGS:
        work = tmp_path_factory.mktemp(f"analysis_{pkg}")
        res = _run(pkg, work, {"UT_BEFORE_RUN_PROFILE": "On"})
        assert res.returncode == 0, res.stderr
        out[pkg] = (_files(work), res.stdout)
    return out


def test_analysis_files_are_byte_identical(analysis):
    (fj, oj), (ft, ot) = analysis["uptune_tpu"], analysis["uptune_tpu_torch"]
    assert set(fj) == {"ut.params.json", "ut.default_qor.json",
                       "ut.interim_features.json", "ut.features.json",
                       "covars.json"}
    assert fj == ft and oj == ot
    recs = json.loads(fj["ut.params.json"])
    assert [r["name"] for r in recs[0]] == ["x", "v0_1", "flag", "olevel",
                                            "order"]


@pytest.mark.parametrize("mode", ["tune", "best"])
def test_trial_files_are_byte_identical(analysis, tmp_path, mode):
    """A TUNE trial (the controller's published config, slot 2, gid 17)
    and a BEST run leave the same files and print the same ids under
    either package; the served values are the config's."""
    params = analysis["uptune_tpu"][0]["ut.params.json"]
    files, outs = {}, {}
    for pkg in PKGS:
        work = tmp_path / pkg
        res = _run(pkg, work, _stage(work, mode, params))
        assert res.returncode == 0, res.stderr
        files[pkg], outs[pkg] = _files(work), res.stdout
    assert files["uptune_tpu"] == files["uptune_tpu_torch"]
    assert outs["uptune_tpu"] == outs["uptune_tpu_torch"]
    f = files["uptune_tpu_torch"]
    if mode == "tune":
        assert outs["uptune_tpu_torch"].split() == ["17", "2"]
        rows = json.loads(f["ut.qor_stage0.json"])
        # (7 - 4)^2 + 1.25 + 0 + 3 + |3| + |0| + |2| + |1|
        assert rows == [[2, 9 + 1.25 + 3 + 6, "min"]]
        assert json.loads(f["ut.features.json"]) == [[2, [7.0, 1.25, 4.0]]]
    else:
        assert "ut.qor_stage0.json" not in f
        assert outs["uptune_tpu_torch"].split() == ["base", "None"]
    assert json.loads(f["covars.json"]) == {"twice": 14}


def test_protocol_constants_equal():
    for name in ("PARAMS_FILE", "DEFAULT_QOR_FILE", "BEST_FILE", "DEFAULT",
                 "ANALYSIS", "TUNE", "BEST"):
        assert getattr(JState, name) == getattr(TState, name), name


def test_settings_and_config_agree():
    assert JS.DEFAULTS == TS.DEFAULTS
    try:
        user = {"test-limit": 77, "parallel-factor": 3, "seed": 5}
        assert JS.config(dict(user)) == TS.config(dict(user))
        for mod in (JS, TS):
            with pytest.raises(KeyError):
                mod.config({"no-such-setting": 1})
            with pytest.raises(TypeError):
                mod.config([("seed", 1)])
    finally:
        JS.reset_settings()
        TS.reset_settings()


@pytest.mark.parametrize("cfg", [
    {"a": True, "b": True, "x": 3}, {"a": True, "b": False, "x": 3},
    {"a": False, "b": True, "x": 30}, {"a": False, "b": False, "x": 9}])
def test_rules_and_constraints_agree(cfg):
    """`@ut.rule` and `@ut.constraint` registered alike in each package
    give the same verdicts, one- and two-argument constraints alike."""
    verdicts = []
    for mod in (JC, TC):
        mod.REGISTRY.clear()
        try:
            @mod.rule()
            def not_both(c):
                return not (c["a"] and c["b"])

            @mod.rule("small")
            def small(c):
                return c["x"] < 20

            @mod.constraint()
            def cap(qor, c):
                return qor < 10 * c["x"]

            @mod.constraint()
            def positive(qor):
                return qor > 0

            node = mod.register("v1", 8)
            verdicts.append((
                mod.REGISTRY.check_config(cfg),
                [mod.REGISTRY.check_qor(q, cfg) for q in (-1.0, 5.0, 95.0)],
                small._ut_rule_name, cap._ut_constraint_name,
                int(mod.vars.v1), node <= 8, node == 8))
        finally:
            mod.REGISTRY.clear()
    assert verdicts[0] == verdicts[1]


def test_best_round_trip_across_packages(tmp_path):
    """best.json written by either package's controller side reads back
    under the other's `get_best`."""
    for w, r in ((JS, TS), (TS, JS)):
        w.write_best({"x": 3, "e": "-O2"}, 1.5, work_dir=str(tmp_path))
        assert r.get_best(str(tmp_path)) == ({"x": 3, "e": "-O2"}, 1.5)


@pytest.mark.parametrize("use", ["tune", "target", "config", "rule"])
def test_child_import_pulls_in_neither_torch_nor_jax(use):
    """`import uptune_tpu_torch as ut` and a protocol name, in a fresh
    interpreter, import neither torch nor JAX: a tuned program pays only
    for the protocol modules on every trial."""
    code = ("import sys, uptune_tpu_torch as ut; "
            f"ut.{use}; "
            "print(sorted(m for m in ('torch', 'jax', 'numpy') "
            "if m in sys.modules))")
    env = dict(os.environ, PYTHONPATH=str(REPO))
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=60)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


def test_names_not_ported_yet_name_their_item():
    """No name is left to port: every public name of the JAX package's
    lazy surface resolves in the port, from the port's counterpart of
    the JAX package's module."""
    import uptune_tpu
    import uptune_tpu_torch as ut
    from uptune_tpu_torch import quickest
    from uptune_tpu_torch.serve import client, session
    assert ut.connect is client.connect
    assert ut.LocalSession is session.LocalSession
    for name, (mod, attr) in uptune_tpu._LAZY.items():
        assert ut._LAZY[name] == (mod.replace("uptune_tpu.",
                                              "uptune_tpu_torch.", 1), attr)
        assert getattr(ut, name) is not None
    assert ut.preprocess is quickest.preprocess
    with pytest.raises(AttributeError, match="has no attribute"):
        ut.no_such_name
    assert {"tune", "target", "Tuner", "tune_batch"} <= set(dir(ut))
