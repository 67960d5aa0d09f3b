"""The C++ header client (`cpp/include`) tuned by the port's
`ProgramTuner` on the CPU: the demo of tests/test_cpp.py, built with g++
as that file builds it, speaks the same `UT_*` protocol to either
package.  The analysis run discovers its four parameters and its default
cost, a 12-trial tune finds a configuration, and best.json applies back
through the client's BEST mode."""
import os
import shutil
import subprocess

import pytest

from test_cpp import CPP, _compile

from uptune_tpu_torch.api import constraint as C
from uptune_tpu_torch.api import session
from uptune_tpu_torch.exec import ProgramTuner

import test_torch_ops  # noqa: F401  (each worker's share of the cores)

pytestmark = pytest.mark.skipif(shutil.which("g++") is None,
                                reason="no g++ in environment")


@pytest.fixture(autouse=True)
def clean_registry(monkeypatch):
    for v in ("UT_BEFORE_RUN_PROFILE", "UT_TUNE_START", "BEST",
              "UT_WORK_DIR"):
        monkeypatch.delenv(v, raising=False)
    C.REGISTRY.clear()
    session.reset_settings()
    yield


def test_demo_tuned_by_the_port(tmp_path):
    demo = _compile(os.path.join(CPP, "demo", "demo_tune.cc"),
                    str(tmp_path / "demo_tune"))
    work = tmp_path / "w"
    work.mkdir()
    pt = ProgramTuner([demo], str(work), parallel=2, test_limit=12,
                      runtime_limit=30.0, seed=3, device="cpu")
    params = pt.analyze()
    assert [r["name"] for r in params[0]] == [
        "block", "alpha", "unroll", "opt"]
    assert pt.default_qor == pytest.approx(7.4)
    res = pt.run()
    assert res.evals >= 12
    assert res.best_qor <= 7.4
    assert set(res.best_config) == {"block", "alpha", "unroll", "opt"}
    env = dict(os.environ, BEST="True", UT_WORK_DIR=str(work))
    out = subprocess.run([demo], capture_output=True, text=True, env=env,
                         cwd=str(work), timeout=60)
    assert out.returncode == 0
    blk = int(out.stdout.split("block=")[1].split()[0])
    assert blk == res.best_config["block"]
