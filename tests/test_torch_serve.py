"""The port's serving plane (`uptune_tpu_torch/serve/`) held to the
reference's own contracts, on the CPU: every test body of the classes of
tests/test_serve.py listed in CASES runs here with the reference
module's names, and the JAX package's modules those bodies import
(`uptune_tpu.serve.*`, `uptune_tpu.obs`, `uptune_tpu.exec.space_io`,
...), pointed at the port's (`port_serve`).  Groups, servers and
`LocalSession`s take ``device="cpu"`` (the port's entry points default
to the card).  Both packages' `obs` planes are untraced around the file
(`untraced` of test_torch_driver): the server turns the port's plane on,
as a serving process does, and TestDistributedObs turns it on too, and
neither reaches the next file.

Beside them, the two packages against each other: a JAX client against
the port's server and a port client against the JAX server (open / ask
/ tell / close; replies, versions and stale-ticket errors alike),
`encode_reply` byte for byte, and the lazy client's import weight.
"""
import importlib
import inspect
import os
import subprocess
import sys
import signal
import time

import pytest

import test_serve as ref_serve
import uptune_tpu
import uptune_tpu.serve.wire as jwire
from uptune_tpu.serve import SessionServer as JServer
from uptune_tpu.serve import connect as jconnect
from uptune_tpu.workloads import rosenbrock_space as j_rosenbrock_space

import uptune_tpu_torch
from uptune_tpu_torch import cli as tcli
from uptune_tpu_torch import obs as tobs
from uptune_tpu_torch import serve as tserve
from uptune_tpu_torch.api import session as tapi_session
from uptune_tpu_torch.exec import space_io as tio
from uptune_tpu_torch.serve import cli as tserve_cli
from uptune_tpu_torch.serve import client as tclient
from uptune_tpu_torch.serve import durable as tdurable
from uptune_tpu_torch.serve import group as tgroup
from uptune_tpu_torch.serve import server as tserver
from uptune_tpu_torch.serve import session as tsession
from uptune_tpu_torch.serve import wire as twire
from uptune_tpu_torch.workloads import rosenbrock_space

from test_torch_driver import untraced

REPO = os.path.dirname(os.path.dirname(os.path.abspath(
    uptune_tpu_torch.__file__)))


# -- the port on the CPU, under the reference's names ------------------------------
class CpuServer(tserver.SessionServer):
    def __init__(self, *args, **kw):
        kw.setdefault("device", "cpu")
        super().__init__(*args, **kw)


class CpuGroup(tgroup.SessionGroup):
    def __init__(self, *args, **kw):
        kw.setdefault("device", "cpu")
        super().__init__(*args, **kw)


class CpuLocalSession(tsession.LocalSession):
    def __init__(self, *args, **kw):
        kw.setdefault("device", "cpu")
        super().__init__(*args, **kw)


# the JAX package's modules the reference bodies import, and the port's
PORT_MODULES = {
    "uptune_tpu.serve": tserve, "uptune_tpu.serve.client": tclient,
    "uptune_tpu.serve.durable": tdurable, "uptune_tpu.serve.group": tgroup,
    "uptune_tpu.serve.server": tserver, "uptune_tpu.serve.session": tsession,
    "uptune_tpu.serve.wire": twire, "uptune_tpu.serve.cli": tserve_cli,
    "uptune_tpu.exec.space_io": tio, "uptune_tpu.obs": tobs,
    "uptune_tpu.obs.faults": tobs.faults, "uptune_tpu.obs.ship": tobs.ship,
    "uptune_tpu.api.session": tapi_session, "uptune_tpu.cli": tcli,
    "uptune_tpu.store.store": importlib.import_module(
        "uptune_tpu_torch.store.store"),
    "uptune_tpu.space": importlib.import_module("uptune_tpu_torch.space"),
    "uptune_tpu.space.spec": importlib.import_module(
        "uptune_tpu_torch.space.spec"),
    "uptune_tpu.space.params": importlib.import_module(
        "uptune_tpu_torch.space.params"),
    "uptune_tpu.workloads": importlib.import_module(
        "uptune_tpu_torch.workloads"),
}
# names on the port's modules that the reference bodies reach, as the
# CPU variants
CPU_NAMES = {
    tserve: {"SessionServer": CpuServer, "SessionGroup": CpuGroup,
             "LocalSession": CpuLocalSession},
    tserver: {"SessionServer": CpuServer},
    tgroup: {"SessionGroup": CpuGroup},
    tsession: {"LocalSession": CpuLocalSession},
}
# the reference test modules' own names, and the port's
PORT_NAMES = {
    "api_session": tapi_session, "records_from_space": tio.records_from_space,
    "space_from_params": tio.space_from_params,
    "LocalSession": CpuLocalSession, "ServeError": tclient.ServeError,
    "SessionServer": CpuServer, "connect": tclient.connect,
    "build_parser": tserve_cli.build_parser,
    "resolve_config": tserve_cli.resolve_config, "SessionGroup": CpuGroup,
    "group_key": tgroup.group_key,
    "StaleTicketError": tsession.StaleTicketError,
    "rosenbrock_space": rosenbrock_space, "faults": tobs.faults,
    "backoff_jitter": tobs.ship.backoff_jitter,
    "CheckpointLog": tdurable.CheckpointLog,
    "decode_raw": tdurable.decode_raw, "encode_raw": tdurable.encode_raw,
    "WireServer": twire.WireServer, "RequestError": twire.RequestError,
    "WireReply": twire.WireReply, "encode_reply": twire.encode_reply,
    "_set_id": twire._set_id,
}


def point_at_port(monkeypatch, modules, extra=None):
    """For one case: the reference modules' names, the JAX package's
    modules in `sys.modules` and its package attributes the bodies read
    (`from uptune_tpu import obs`, `ut.config`, `uptune_tpu.serve`) all
    the port's, the servers, groups and local sessions on the CPU."""
    # the package attributes first: monkeypatch reads the old value, and
    # the JAX package resolves (and caches) a lazy name from sys.modules
    for attr, value in (("obs", tobs), ("cli", tcli), ("serve", tserve),
                        ("config", tapi_session.config),
                        ("connect", tclient.connect),
                        ("LocalSession", CpuLocalSession)):
        monkeypatch.setattr(uptune_tpu, attr, value, raising=False)
    for name, mod in PORT_MODULES.items():
        monkeypatch.setitem(sys.modules, name, mod)
    for mod, names in CPU_NAMES.items():
        for name, value in names.items():
            monkeypatch.setattr(mod, name, value, raising=False)
    names = dict(PORT_NAMES, **(extra or {}))
    for mod in modules:
        for name, value in names.items():
            if hasattr(mod, name):
                monkeypatch.setattr(mod, name, value)


def run_case(klass, name, request):
    """One reference test method, its fixtures resolved here (a class's
    own setup/teardown_method around it)."""
    obj = klass()
    case = getattr(obj, name)
    kwargs = {p: request.getfixturevalue(p)
              for p in inspect.signature(case).parameters}
    def hook(name):
        fn = getattr(obj, name, None)
        if fn is not None:
            fn(*([case] if inspect.signature(fn).parameters else []))
    hook("setup_method")
    try:
        case(**kwargs)
    finally:
        hook("teardown_method")


def cases(module, classes, left_out=()):
    """(class name, test name) of every test of `classes`, but the
    methods in `left_out`."""
    out = []
    for cname in classes:
        klass = getattr(module, cname)
        for n, _ in inspect.getmembers(klass, inspect.isfunction):
            if n.startswith("test_") and n not in left_out:
                out.append((cname, n))
    return out


@pytest.fixture(scope="module", autouse=True)
def untraced_module():
    """Both obs planes reset for the file and restored after it: the
    port's server keeps its plane on while the file runs (a serving
    process does), and none of it reaches the next file."""
    with untraced():
        yield


# -- fixtures of the reference bodies, on the port ----------------------------------
@pytest.fixture(scope="module")
def server(tmp_path_factory):
    """One shared server: 8-slot groups, memo store on (the reference's
    module fixture, on the port)."""
    store = str(tmp_path_factory.mktemp("serve_store"))
    srv = CpuServer(host="127.0.0.1", port=0, slots=8, max_sessions=64,
                    store_dir=store).start()
    yield srv
    srv.stop()


@pytest.fixture(scope="module")
def offline():
    """One shared single-slot group, reused across seeds via join/leave."""
    return CpuGroup(rosenbrock_space(2, -3.0, 3.0), 1)


@pytest.fixture
def port_serve(monkeypatch):
    point_at_port(monkeypatch, [ref_serve])


SERVE_CLASSES = ("TestWireBridge", "TestConfigKeys", "TestSessionMechanics",
                 "TestServerProtocol", "TestDistributedObs",
                 "TestIsolationParity", "TestCrossTenantMemo",
                 "TestBatchedWirePlane")
# reference cases with no counterpart here, and why
SERVE_LEFT_OUT = {
    # the port compiles nothing, so there is no retrace to count (the
    # port refuses UT_TRACE_GUARD for the same reason)
    "TestNoRetrace": "no compiled programs",
    # bench.py is not ported
    "TestBenchSmoke": "bench.py is the JAX package's",
}
# slow-marked reference cases (not run by the tier-1 selection there)
SERVE_SLOW = {"test_soak_parity_with_churn_and_memo"}
SERVE_CASES = cases(ref_serve, SERVE_CLASSES, SERVE_SLOW)


@pytest.mark.parametrize("cls,name", SERVE_CASES,
                         ids=[f"{c}::{n}" for c, n in SERVE_CASES])
def test_reference_serve_contract(port_serve, cls, name, request):
    run_case(getattr(ref_serve, cls), name, request)


def test_the_cases_cover_every_reference_serve_test():
    """Every class of tests/test_serve.py runs here whole, but those
    listed with their reason (and the slow soak); a new reference case
    shows up as a missing one."""
    classes = {c for c, k in inspect.getmembers(ref_serve, inspect.isclass)
               if c.startswith("Test") and k.__module__ == "test_serve"}
    assert classes == set(SERVE_CLASSES) | set(SERVE_LEFT_OUT)
    slow = {n for c in SERVE_CLASSES
            for n, f in inspect.getmembers(getattr(ref_serve, c),
                                           inspect.isfunction)
            if any(m.name == "slow" for m in getattr(f, "pytestmark", []))}
    assert slow == SERVE_SLOW


# -- the two packages on one wire ---------------------------------------------------
def _measure(cfg):
    return ref_serve._measure(cfg)


def _drive(h, stale_error):
    """open / ask / tell (a whole epoch, so the version moves) / a stale
    ticket / best; -> what a client saw, for comparison."""
    seen = {"asks": [], "versions": []}
    first = None
    while h.version < 1:
        trials = h.ask(7)
        first = first if first is not None else trials[0].ticket
        seen["asks"].append([(t.ticket, t.config, t.epoch) for t in trials])
        r = h.tell_many([(t.ticket, _measure(t.config)) for t in trials])
        seen["versions"].append((r["told"], r["committed"], r["version"]))
    with pytest.raises(stale_error) as e:
        h.tell(first, 1.0)
    seen["stale"] = str(e.value).split("(session")[0]
    b = h.best()
    seen["best"] = (b["config"], b["qor"], b["version"], b["tells"])
    return seen


@pytest.fixture(scope="module")
def jax_server():
    srv = JServer(host="127.0.0.1", port=0, slots=2, max_sessions=8,
                  store_dir="off").start()
    yield srv
    srv.stop()


@pytest.fixture(scope="module")
def port_server():
    srv = CpuServer(host="127.0.0.1", port=0, slots=2, max_sessions=8,
                    store_dir="off").start()
    yield srv
    srv.stop()


def test_clients_and_servers_of_both_packages_interoperate(jax_server,
                                                           port_server):
    """A JAX client against the port's server and a port client against
    the JAX server open, ask, tell a whole epoch, hit a stale ticket,
    read the best and close: the replies parse the same way, the
    version advances at the same tell, and the stale ticket gets the
    same error.  (The two engines propose different rows, so a pairing
    compares the same client against both servers.)"""
    runs = {}
    for cname, conn, err, space in (
            ("jax", jconnect, jwire.RequestError, j_rosenbrock_space),
            ("port", tclient.connect, twire.RequestError,
             rosenbrock_space)):
        for sname, srv in (("jax", jax_server), ("port", port_server)):
            client_error = (importlib.import_module(
                "uptune_tpu.serve.client").ServeError if cname == "jax"
                else tclient.ServeError)
            with conn(("127.0.0.1", srv.port)) as c:
                with c.open_session(space(2, -3.0, 3.0), seed=5,
                                    store=False) as h:
                    runs[cname, sname] = _drive(h, client_error)
                    assert c._batch_ok is not False
            assert srv.n_sessions == 0
    # the same server answers either client alike, bitwise
    for sname in ("jax", "port"):
        assert runs["jax", sname] == runs["port", sname], sname
    # either server runs the protocol alike: the epoch settles at the
    # batch's size, the stale ticket is refused with one message
    for key in ("versions", "stale"):
        assert runs["jax", "jax"][key] == runs["jax", "port"][key], key
    assert [len(a) for a in runs["jax", "jax"]["asks"]] == [
        len(a) for a in runs["jax", "port"]["asks"]]


@pytest.mark.parametrize("payload", [
    {"ok": True, "v": 1.5, "trials": [{"ticket": 0, "config": {"x": 1}}]},
    {"ok": False, "error": "unknown op 'zap'", "id": 7},
    {"ok": True, "nan": float("nan"), "inf": float("inf"), "none": None},
])
def test_encode_reply_is_the_reference_byte_for_byte(payload):
    """A reply's wire text, a preserialized `WireReply`'s, and both after
    an `id` echo are the JAX package's, byte for byte."""
    assert twire.encode_reply(payload) == jwire.encode_reply(payload)
    r_t, r_j = twire.WireReply(**payload), jwire.WireReply(**payload)
    r_t.wire_text = r_j.wire_text = jwire.encode_reply(payload)
    for rid in (9, "abc"):
        twire._set_id(r_t, rid)
        jwire._set_id(r_j, rid)
        assert twire.encode_reply(r_t) == jwire.encode_reply(r_j)
        assert dict(r_t) == dict(r_j)


def test_the_client_imports_neither_torch_nor_numpy():
    """A tenant process imports the client alone: in a fresh interpreter
    `uptune_tpu_torch.serve.client` (and `uptune_tpu_torch.connect`)
    pulls in neither torch nor numpy."""
    code = ("import sys, uptune_tpu_torch as ut, uptune_tpu_torch.serve.client;"
            "ut.connect;"
            "print(sorted(m for m in ('torch', 'numpy', 'jax')"
            " if m in sys.modules))")
    out = subprocess.run([sys.executable, "-c", code],
                         env={**os.environ, "PYTHONPATH": REPO},
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


def test_ut_torch_serve_subprocess_round_trip(tmp_path):
    """`python -m uptune_tpu_torch.cli serve --port 0 --device cpu`
    prints its port, serves one ask / tell round over TCP, and exits 0
    on SIGTERM."""
    env = {**os.environ, "PYTHONPATH": REPO}
    for v in ("UT_TRACE", "UT_JOURNAL", "UT_TELEMETRY", "UT_FAULTS",
              "UT_DEVICE_TRACE"):
        env.pop(v, None)
    proc = subprocess.Popen(
        [sys.executable, "-m", "uptune_tpu_torch.cli", "serve", "--port",
         "0", "--device", "cpu", "--store-dir", "off"],
        cwd=str(tmp_path), env=env, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True)
    try:
        port = None
        lines = []
        deadline = time.time() + 120
        while port is None and time.time() < deadline:
            line = proc.stdout.readline()
            if not line:
                break
            lines.append(line)
            if "listening on" in line:
                port = int(line.rsplit(":", 1)[1].split()[0])
        assert port, "".join(lines)
        with tclient.connect(("127.0.0.1", port)) as c:
            with c.open_session(rosenbrock_space(2, -3.0, 3.0), seed=1,
                                store=False) as h:
                trials = h.ask(4)
                r = h.tell_many([(t.ticket, _measure(t.config))
                                 for t in trials])
                assert r["told"] == 4
                assert h.best()["qor"] == min(_measure(t.config)
                                              for t in trials)
        proc.send_signal(signal.SIGTERM)
        assert proc.wait(timeout=60) == 0
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()


def test_serve_without_a_card_exits_before_binding(monkeypatch):
    """Without `--device cpu` on a host without a card the subcommand
    exits 1 before a server exists (nothing binds)."""
    import torch
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    built = []
    monkeypatch.setattr(tserver.SessionServer, "__init__",
                        lambda self, *a, **k: built.append(1))
    assert tcli.main(["serve", "--port", "0"]) == 1
    assert not built
