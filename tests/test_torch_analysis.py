"""`ut-torch-lint` (`uptune_tpu_torch/analysis/`) against the JAX
package's `ut-lint`, on the CPU, and tests/test_lint.py's and
tests/test_conc_lint.py's bodies on the port.

* Both analyzers over `uptune_tpu/` and `uptune_tpu_torch/` print the
  same JSON (every rule, suppressed findings shown), and over a file of
  hazards the same text, JSON and SARIF.
* The reference's bodies run with their names (`lint_source`, the
  reporters, `LockGuard`, ...) pointed at the port's, their
  `python -m uptune_tpu.analysis` subprocesses running the port's
  analyzer, and the JAX package's serve and store modules they import
  (TestLockGuardStrictSmoke) the port's.  Left out: TestTraceGuard (the
  port traces nothing: its TraceGuard raises, held below) and the two
  repo gates that run the JAX package's own lint script over its tree
  (`test_repo_clean`, TestRepoConcurrencyClean; the JSON comparison
  over both trees holds the analyzers alike there).
* The port's fast-path packages are finding- and suppression-free under
  its own analyzer, as test_lint.py holds the JAX package's.
"""
import inspect
import json
import os
import subprocess
import sys
import textwrap
import types

import pytest

import test_conc_lint as ref_conc
import test_lint as ref_lint
from uptune_tpu_torch import analysis as tanalysis
from uptune_tpu_torch.analysis import __main__ as tmain
from uptune_tpu_torch.analysis import lock_guard as tlock_guard
from uptune_tpu_torch.analysis import reporters as treporters
from uptune_tpu_torch.serve import durable as tdurable
from uptune_tpu_torch.serve import wire as twire
from uptune_tpu_torch.store import store as tstore

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ENV = dict(os.environ, PYTHONPATH=REPO)

HAZARDS = textwrap.dedent('''
    import threading

    import jax
    import jax.numpy as jnp


    @jax.jit
    def f(x):
        print("tracing")
        if x > 0:
            return float(x)
        return x


    def g(key):
        a = jax.random.uniform(key)
        b = jax.random.uniform(key)
        for _ in range(3):
            h = jax.jit(lambda v: v * 2)
        return a + b + h(1.0)


    class Box:
        def __init__(self):
            self._lock = threading.Lock()
            self.items = []

        def put(self, v):
            with self._lock:
                self.items.append(v)

        def peek(self):
            return self.items[-1]

        def slow(self, sock):
            with self._lock:
                sock.recv(10)


    def kick(fn):
        threading.Thread(target=fn).start()
''')


def lint_cli(pkg, args):
    return subprocess.Popen([sys.executable, "-m", f"{pkg}.analysis", *args],
                            cwd=REPO, env=ENV, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True)


def both(args):
    """(returncode, stdout) of each package's analyzer on `args`, run
    side by side."""
    procs = [lint_cli(pkg, args) for pkg in ("uptune_tpu",
                                             "uptune_tpu_torch")]
    outs = []
    for p in procs:
        out, _ = p.communicate(timeout=300)
        outs.append((p.returncode, out))
    return outs


def test_both_trees_same_json():
    j, t = both(["uptune_tpu", "uptune_tpu_torch", "--format", "json",
                 "--show-suppressed"])
    assert j == t
    doc = json.loads(t[1])
    assert doc["tool"] == "ut-lint" and t[0] == 0


@pytest.mark.parametrize("fmt", ["text", "json", "sarif"])
def test_hazards_same_findings(tmp_path, fmt):
    (tmp_path / "hazards.py").write_text(HAZARDS)
    j, t = both([str(tmp_path / "hazards.py"), "--format", fmt])
    assert j == t
    assert t[0] == 1
    if fmt == "json":
        rules = {f["rule"] for f in json.loads(t[1])["findings"]}
        assert {"R001", "R002", "R003", "R004", "R005"} <= rules
        assert {"R102", "R105"} <= rules


def test_list_rules_and_default_path(monkeypatch, capsys):
    j, t = both(["--list-rules"])
    assert j == t
    linted = []
    monkeypatch.setattr(tmain, "lint_paths",
                        lambda paths, select: linted.append(paths) or [])
    monkeypatch.chdir(REPO)
    assert tmain.main([]) == 0
    assert linted == [["uptune_tpu_torch"]]
    assert "0 finding(s)" in capsys.readouterr().out


def test_trace_guard_has_no_counterpart():
    with pytest.raises(NotImplementedError, match="traces nothing"):
        tanalysis.TraceGuard(limit=2)
    assert tanalysis.guard_from_env({}) is None
    assert tanalysis.guard_from_env({"UT_TRACE_GUARD": "off"}) is None
    with pytest.raises(NotImplementedError):
        tanalysis.guard_from_env({"UT_TRACE_GUARD": "strict"})


@pytest.mark.parametrize("package", ["store", "surrogate", "engine", "ops",
                                     "obs", "serve", "parallel",
                                     "analysis"])
def test_port_package_suppression_free(package):
    out = tanalysis.lint_paths(
        [os.path.join(REPO, "uptune_tpu_torch", package)])
    assert out == [], [f.to_dict() for f in out]


# -- the reference's bodies on the port ---------------------------------------
def port_subprocess():
    """`subprocess` for the bodies: `-m uptune_tpu.analysis` runs the
    port's analyzer."""
    def run(args, *a, **kw):
        args = ["uptune_tpu_torch.analysis" if v == "uptune_tpu.analysis"
                else v for v in args]
        return subprocess.run(args, *a, **kw)
    return types.SimpleNamespace(run=run, PIPE=subprocess.PIPE)


PORT_NAMES = {
    "lint_source": tanalysis.lint_source,
    "format_json": treporters.format_json,
    "format_sarif": treporters.format_sarif,
    "format_text": treporters.format_text,
    "LockGuard": tlock_guard.LockGuard,
    "LockOrderError": tlock_guard.LockOrderError,
    "lock_guard_from_env": tlock_guard.lock_guard_from_env,
    "subprocess": port_subprocess(),
}
# the JAX package's modules the bodies import inside, as the port's
PORT_MODULES = {"uptune_tpu.serve.durable": tdurable,
                "uptune_tpu.serve.wire": twire,
                "uptune_tpu.store.store": tstore}
LEFT_OUT = {"TestTraceGuard", "TestRepoConcurrencyClean"}


def ref_cases(mod):
    return [(mod.__name__, c, n)
            for c, k in inspect.getmembers(mod, inspect.isclass)
            if c.startswith("Test") and c not in LEFT_OUT
            for n, _ in inspect.getmembers(k, inspect.isfunction)
            if n.startswith("test_")]


REF_CASES = ref_cases(ref_lint) + ref_cases(ref_conc)


@pytest.mark.parametrize("mod,cls,name", REF_CASES)
def test_reference_body_on_the_port(mod, cls, name, monkeypatch, request):
    ref = sys.modules[mod]
    for attr, value in PORT_NAMES.items():
        if hasattr(ref, attr):
            monkeypatch.setattr(ref, attr, value)
    for modname, value in PORT_MODULES.items():
        monkeypatch.setitem(sys.modules, modname, value)
    case = getattr(getattr(ref, cls)(), name)
    case(**{p: request.getfixturevalue(p)
            for p in inspect.signature(case).parameters})
