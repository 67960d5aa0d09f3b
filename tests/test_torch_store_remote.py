"""The port's cooperative store plane (`uptune_tpu_torch/store/server.py`
and `remote.py`) held to the reference's own contracts, on the CPU:
every test body of the classes of tests/test_store_remote.py listed in
STORE_CLASSES runs here with the reference module's names pointed at the
port's (test_torch_serve's `point_at_port`), a parametrized body once a
parameter.  `TestStoreRemoteBenchSmoke` has no counterpart: it runs the
JAX package's `bench.py --store-remote --quick`, and the port's bench of
that protocol is `chip_smoke.py`'s store phase.

Beside them, the two packages against each other: a JAX `RemoteStore`
against the port's `StoreServer` and a port `RemoteStore` against the
JAX server (each records, each reads the other's rows), the servers'
`rows.jsonl` byte for byte equal for the same records, `parse_addr`'s
errors equal, and a `ProgramTuner` of each package exchanging a sibling's
best through its package's server with the same `store_hits`,
`exchange_injected` and `federated_rows`.
"""
import inspect
import json
import os
import socket
import sys
import time

import pytest

import test_store_remote as ref_store
import uptune_tpu
from uptune_tpu.exec.controller import ProgramTuner as JProgramTuner
from uptune_tpu.store import remote as jremote
from uptune_tpu.store import server as jserver

from uptune_tpu_torch import obs as tobs
from uptune_tpu_torch import store as tstore
from uptune_tpu_torch.exec.controller import ProgramTuner as TProgramTuner
from uptune_tpu_torch.store import remote as tremote
from uptune_tpu_torch.store import server as tserver

from test_torch_driver import untraced
from test_torch_serve import point_at_port, run_case

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SIG = ["spec-a", "spec-b"]


@pytest.fixture(scope="module", autouse=True)
def untraced_module():
    """The store server turns its package's obs plane on (a serving
    process does); none of it reaches the next file."""
    with untraced():
        yield


@pytest.fixture
def port_store(monkeypatch):
    point_at_port(monkeypatch, [ref_store], {
        "is_remote_addr": tstore.is_remote_addr,
        "open_store": tstore.open_store,
        "RemoteStore": tremote.RemoteStore, "parse_addr": tremote.parse_addr,
        "StoreServer": tserver.StoreServer, "ResultStore": tstore.ResultStore})
    for name, mod in (("uptune_tpu.store", tstore),
                      ("uptune_tpu.store.remote", tremote),
                      ("uptune_tpu.store.server", tserver)):
        monkeypatch.setitem(sys.modules, name, mod)
    tobs.reset()
    yield
    tobs.reset()


STORE_CLASSES = ("TestParseAddr", "TestOpenStoreFactory",
                 "TestStoreServerOps", "TestRemoteStoreFailureModes")
# reference classes with no counterpart here, and why
STORE_LEFT_OUT = {
    "TestStoreRemoteBenchSmoke": "bench.py is the JAX package's; "
                                 "chip_smoke.py's store phase runs the "
                                 "protocol on the port",
}


def _param_cases():
    """(class, test, parameters) of every reference test of
    STORE_CLASSES, a parametrized one once a parameter set."""
    out = []
    for cname in STORE_CLASSES:
        klass = getattr(ref_store, cname)
        for name, fn in inspect.getmembers(klass, inspect.isfunction):
            if not name.startswith("test_"):
                continue
            marks = [m for m in getattr(fn, "pytestmark", ())
                     if m.name == "parametrize"]
            if not marks:
                out.append((cname, name, {}))
                continue
            (argname, values), = [m.args for m in marks]
            for v in values:
                out.append((cname, name, {argname: v}))
    return out


CASES = _param_cases()


@pytest.mark.parametrize(
    "cls,name,params", CASES,
    ids=[f"{c}::{n}" + (f"[{list(p.values())[0]}]" if p else "")
         for c, n, p in CASES])
def test_reference_store_remote_contract(port_store, cls, name, params,
                                         request):
    if not params:
        run_case(getattr(ref_store, cls), name, request)
        return
    obj = getattr(ref_store, cls)()
    getattr(obj, name)(**params)


def test_the_cases_cover_every_reference_store_remote_test():
    """Every class of tests/test_store_remote.py runs here whole, but
    those listed with their reason."""
    classes = {c for c, k in inspect.getmembers(ref_store, inspect.isclass)
               if c.startswith("Test") and k.__module__ == "test_store_remote"}
    assert classes == set(STORE_CLASSES) | set(STORE_LEFT_OUT)


# -- the two packages against each other --------------------------------------------
@pytest.mark.parametrize("server_pkg,writer_pkg", [
    (tserver, jremote), (jserver, tremote)])
def test_clients_of_either_package_share_a_server(tmp_path, server_pkg,
                                                  writer_pkg):
    """One package's server, a client of each package: rows recorded by
    either are acked, reach the other as fresh foreign rows, and are
    served by key to both."""
    srv = server_pkg.StoreServer("127.0.0.1", 0, str(tmp_path)).start()
    addr = f"tcp://127.0.0.1:{srv.port}"
    reader_pkg = jremote if writer_pkg is tremote else tremote
    a = writer_pkg.RemoteStore(addr, SIG, "cmd", refresh_interval=0.0)
    b = reader_pkg.RemoteStore(addr, SIG, "cmd", refresh_interval=0.0)
    try:
        assert a.scope == b.scope and a.connected and b.connected
        for i in range(5):
            a.record({"i": i}, float(10 - i), 0.5, u=[0.1 * i, 0.5])
        assert a.flush_wait(10.0)
        assert b.refresh() == 5
        fresh = sorted(r["cfg"]["i"] for r in b.pop_fresh_rows())
        assert fresh == list(range(5))
        assert b.lookup({"i": 3})["qor"] == 7.0
        assert b.best_row()["cfg"] == {"i": 4}
        b.record({"j": 1}, 0.25)
        assert b.flush_wait(10.0)
        assert a.refresh() == 1
        assert a.lookup({"j": 1})["qor"] == 0.25
        assert a.lookup({"i": 0})["u"] == [0.0, 0.5]
        with srv._lock:
            assert srv.recorded == 6 and srv.dups == 0
    finally:
        a.close()
        b.close()
        srv.stop()


def test_rows_log_byte_equal(tmp_path):
    """The same record ops (a failure, a dup, an upgrade, another
    scope) leave both servers' rows.jsonl byte for byte equal, and each
    package's server replays the other's log."""
    rows = [{"k": f"k{i}", "scope": "sc", "cfg": {"i": i, "f": 0.1 * i},
             "qor": 1.0 + i, "dur": 0.5, "t": 1700000000.123,
             "src": "w0", "u": [0.25, 0.5], "perms": [[1, 0]],
             "junk": "dropped"} for i in range(4)]
    rows.append(dict(rows[0], k="kf", qor=None))
    rows.append(dict(rows[1]))                          # a dup
    rows.append(dict(rows[0], k="kf", qor=2.5))         # upgrades kf
    rows.append(dict(rows[2], k="ko", scope="other"))
    logs = {}
    for name, pkg in (("jax", jserver), ("port", tserver)):
        root = tmp_path / name
        srv = pkg.StoreServer("127.0.0.1", 0, str(root))
        replies = [srv.handle({"op": "record", "row": r}) for r in rows]
        srv.stop()
        logs[name] = ((root / "rows.jsonl").read_bytes(), replies)
    assert logs["jax"] == logs["port"]
    for name, pkg in (("jax", tserver), ("port", jserver)):
        srv = pkg.StoreServer("127.0.0.1", 0, str(tmp_path / name))
        assert srv.replayed == 7 and not srv.torn_tail
        assert srv.handle({"op": "lookup", "k": "kf"})["row"]["qor"] == 2.5
        srv.stop()


@pytest.mark.parametrize("addr", [
    "tcp://", "tcp://host", "host", "tcp://host:nan", "tcp://host:0",
    "tcp://:123", "http://h:1", "tcp://a/b:1", "tcp://h:70000"])
def test_parse_addr_errors_equal(addr):
    errs = []
    for pkg in (jremote, tremote):
        with pytest.raises(ValueError) as e:
            pkg.parse_addr(addr)
        errs.append(str(e.value))
    assert errs[0] == errs[1]


QUAD = """
import uptune_tpu as ut
x = ut.tune(50, (0, 100), name="x")
y = ut.tune(50, (0, 100), name="y")
ut.target(float((x - 37) ** 2 + (y - 11) ** 2), "min")
"""


def _exchange_run(tmp_path, server_mod, remote_mod, tuner_cls, **kw):
    """A ProgramTuner over a tcp:// store: after its first result a
    sibling (another RemoteStore of the same package) records the
    optimum, which the next refresh injects as an exchange trial served
    from the store."""
    from uptune_tpu.driver.plugins import SearchHook as JHook
    from uptune_tpu_torch.driver.plugins import SearchHook as THook
    srv = server_mod.StoreServer("127.0.0.1", 0,
                                 str(tmp_path / "srv")).start()
    addr = f"tcp://127.0.0.1:{srv.port}"
    state = {"pt": None, "planted": False}
    base = THook if tuner_cls is TProgramTuner else JHook

    class Sibling(base):
        def on_start(self, tuner):
            state["pt"].store.refresh_interval = 0.0

        def on_result(self, tuner, trial, qor):
            if state["planted"]:
                return
            state["planted"] = True
            pt = state["pt"]
            sib = remote_mod.RemoteStore(
                addr, [repr(s) for s in pt.tuner.space.specs], pt.command)
            sib.record({"x": 37, "y": 11}, 0.0, 0.5)
            assert sib.flush_wait(10.0)
            sib.close()

    prog = tmp_path / "prog.py"
    prog.write_text(QUAD)
    pt = tuner_cls([sys.executable, str(prog)], str(tmp_path), parallel=2,
                   env={"PYTHONPATH": REPO}, runtime_limit=30.0,
                   test_limit=8, seed=3, store_dir=addr, hooks=[Sibling()],
                   **kw)
    state["pt"] = pt
    try:
        res = pt.run()
        # the controller closed its client: every row it recorded is
        # on the server
        with srv._lock:
            recorded = srv.recorded
    finally:
        srv.stop()
    return pt, res, recorded


def test_controller_exchange_over_a_store_server(tmp_path):
    """Exchange and federation run over a RemoteStore unchanged: the
    port's ProgramTuner against the port's server and the JAX
    package's against its own, the same scenario, the same counters."""
    out = {}
    for name, srv, rem, cls, kw in (
            ("jax", jserver, jremote, JProgramTuner, {}),
            ("port", tserver, tremote, TProgramTuner, {"device": "cpu"})):
        d = tmp_path / name
        d.mkdir()
        pt, res, recorded = _exchange_run(d, srv, rem, cls, **kw)
        rows = [json.loads(x) for x in open(d / "ut.archive.jsonl")][1:]
        ex = [r for r in rows if r["tech"] == "exchange"]
        assert res.best_qor == 0.0 and res.best_config == {"x": 37, "y": 11}
        assert len(ex) == 1 and ex[0]["qor"] == 0.0
        # the tune's own measured rows plus the sibling's optimum
        assert recorded == pt.pool.launched + 1 + 1   # + the seed trial
        out[name] = (pt.store_hits, pt.exchange_injected, pt.federated_rows)
    assert out["port"] == out["jax"]
    assert out["port"][1] == 1 and out["port"][0] >= 1
