"""The port's crash-safe serving and batched wire kernel held to the
reference's own contracts, on the CPU: the test bodies of
tests/test_durable.py and tests/test_wire_batch.py run on the port's
modules through test_torch_serve's `point_at_port` (their WireServer
subclasses rebuilt on the port's `WireServer`).  The recovery lifecycle
(`TestRecoveryLifecycle`, slow-marked in the reference for JAX's
compiles) runs here in full: a checkpoint the port's server writes is
recovered by a fresh port server with no committed tell lost, and the
recovered stream continues bitwise as a never-killed `LocalSession`.

Beside them, the checkpoint segment byte for byte: the same records
appended by either package's `CheckpointLog` give the same file, and a
segment the JAX package wrote loads in the port's.
"""
import inspect
import json

import numpy as np
import pytest

import test_durable as ref_durable
import test_wire_batch as ref_wire
from uptune_tpu.serve import durable as jdurable

from uptune_tpu_torch.serve import durable as tdurable
from uptune_tpu_torch.serve import wire as twire

from test_torch_driver import untraced
from test_torch_serve import CpuGroup, cases, point_at_port, run_case


def _rebase(cls, base):
    """A reference WireServer subclass with the port's base (its
    methods and op table as they are)."""
    ns = {k: v for k, v in vars(cls).items()
          if k not in ("__dict__", "__weakref__")}
    return type(cls.__name__, (base,), ns)


PingServer = _rebase(ref_durable._PingServer, twire.WireServer)
EchoServer = _rebase(ref_wire._EchoServer, twire.WireServer)


class HookServer(EchoServer):
    """The reference's `_HookServer` on the port: records every (op, ok)
    pair `_on_response` observes."""

    def __init__(self, *a, **kw):
        super().__init__(*a, **kw)
        self.seen = []

    def _on_response(self, state, req, resp):
        self.seen.append((req.get("op"), bool(resp.get("ok"))))


@pytest.fixture(scope="module", autouse=True)
def untraced_module():
    with untraced():
        yield


@pytest.fixture
def port_serve(monkeypatch):
    point_at_port(monkeypatch, [ref_durable, ref_wire],
                  {"_PingServer": PingServer, "_EchoServer": EchoServer,
                   "_HookServer": HookServer})


@pytest.fixture
def srv():
    return EchoServer("127.0.0.1", 0)


@pytest.fixture(scope="module")
def group():
    """TestDuplicateTellIdempotence's class fixture, on the port."""
    return CpuGroup(_space(), 1)


def _space():
    from uptune_tpu_torch.workloads import rosenbrock_space
    return rosenbrock_space(2, -3.0, 3.0)


DURABLE_CLASSES = ("TestFaults", "TestCheckpointLog", "TestStoreFsyncKnob",
                   "TestDurableConfigKeys", "TestShipperJitter",
                   "TestWireHardening", "TestDuplicateTellIdempotence",
                   "TestRecoveryLifecycle")
DURABLE_LEFT_OUT = {
    # drives bench.py --failover, which is the JAX package's
    "TestFailoverBenchSmoke": "bench.py is the JAX package's",
}
WIRE_CLASSES = ("TestBatchDispatch", "TestEncodeFastPath", "TestHookFanOut",
                "TestBatchTCP")
CASES = ([("durable", c, n) for c, n in cases(ref_durable, DURABLE_CLASSES)]
         + [("wire", c, n) for c, n in cases(ref_wire, WIRE_CLASSES)])
MODULES = {"durable": ref_durable, "wire": ref_wire}


@pytest.mark.parametrize("module,cls,name", CASES,
                         ids=[f"{m}::{c}::{n}" for m, c, n in CASES])
def test_reference_contract(port_serve, module, cls, name, request):
    run_case(getattr(MODULES[module], cls), name, request)


def test_the_cases_cover_every_reference_test():
    """Every class of the two reference files runs here whole, but the
    one listed with its reason."""
    for mod, classes, left in ((ref_durable, DURABLE_CLASSES,
                                DURABLE_LEFT_OUT),
                               (ref_wire, WIRE_CLASSES, {})):
        found = {c for c, k in inspect.getmembers(mod, inspect.isclass)
                 if c.startswith("Test") and k.__module__ == mod.__name__}
        assert found == set(classes) | set(left), mod.__name__


def test_the_cases_run_on_the_port(port_serve):
    """What the reference bodies reach is the port's."""
    import sys
    import uptune_tpu
    assert ref_durable.CheckpointLog is tdurable.CheckpointLog
    assert ref_wire.WireServer is twire.WireServer
    assert issubclass(ref_wire._HookServer, twire.WireServer)
    assert sys.modules["uptune_tpu.serve.durable"] is tdurable
    assert uptune_tpu.obs.__name__ == "uptune_tpu_torch.obs"


def _records():
    raw = np.array([1.5, np.nan, -2.25, np.inf, 0.1], np.float32)
    return [
        {"ev": "open", "space": [{"name": "x0", "type": "float",
                                  "low": -3.0, "high": 3.0}],
         "seed": 3, "program": "p", "sense": "min", "arms": None,
         "hist": 1024, "store": False},
        {"ev": "commit", "v": 1, "raw": None, "best_cfg": {"x0": 0.5},
         "best_qor": 0.25, "asks": 7, "tells": 7, "served": 0, "tseq": 7,
         "q": {"n": 7}},
        {"ev": "close"},
    ], raw


def test_checkpoint_segments_are_the_reference_byte_for_byte(tmp_path):
    """The same records appended by the port's and the JAX package's
    `CheckpointLog` make the same bytes (NaN and inf rows included: a
    failure, encoded as null), and
    each package loads the other's segment to the same bundle."""
    recs, raw = _records()
    for pkg, mod in (("jax", jdurable), ("port", tdurable)):
        assert mod.encode_raw(raw) == jdurable.encode_raw(raw)
        log = mod.CheckpointLog(str(tmp_path / pkg))
        for r in recs:
            r = dict(r, raw=mod.encode_raw(raw)) if r["ev"] == "commit" \
                else r
            assert log.append("abc", r)
    pj, pt = (tmp_path / "jax" / "sess-abc.jsonl",
              tmp_path / "port" / "sess-abc.jsonl")
    assert pj.read_bytes() == pt.read_bytes()
    bundles = {}
    for pkg, mod, root in (("port", tdurable, "jax"),
                           ("jax", jdurable, "port")):
        bundles[pkg] = dict(mod.CheckpointLog(str(tmp_path / root)).scan())
    assert json.dumps(bundles["port"], sort_keys=True, default=str) == \
        json.dumps(bundles["jax"], sort_keys=True, default=str)
    # a non-finite row is a failure: it replays as NaN in both packages
    got = tdurable.decode_raw(tdurable.encode_raw(raw))
    want = jdurable.decode_raw(jdurable.encode_raw(raw))
    np.testing.assert_array_equal(np.asarray(got, np.float32),
                                  np.asarray(want, np.float32))
    assert np.isnan(np.asarray(got, np.float32)[[1, 3]]).all()
