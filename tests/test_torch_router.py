"""The port's sharded front tier (`uptune_tpu_torch/serve/router.py`) held
to the reference's own contracts, on the CPU: every test body of the
classes of tests/test_router.py listed in ROUTER_CLASSES runs here with
the reference module's names, and the JAX package's modules those bodies
import, pointed at the port's (test_torch_serve's `point_at_port`).
Routers take ``device="cpu"`` (the port's entry points default to the
card); the reference's `FakeShard` is rebuilt on the port's `WireServer`.

Beside them, the two packages against each other: routing keys and
ring placements equal through the same add / remove sequence, the
router's replies (the redirect frames among them) byte for byte, and a
client of either package routed through the other package's router to
a shard of that package.  Then one sharded smoke with real processes:
a port `Router` over `ut-torch serve --device cpu --durable` shards, K
walked 1 -> 2, one deterministic `route.kill`, and every session's
final state equal to a matched-seed CPU `LocalSession` with no acked
committed version lost.
"""
import json
import os
import sys
import threading
import time

import numpy as np
import pytest

import test_router as ref_router
from uptune_tpu.serve import SessionServer as JServer
from uptune_tpu.serve import connect as jconnect
from uptune_tpu.serve import router as jrouter
from uptune_tpu.serve import wire as jwire
from uptune_tpu.workloads import rosenbrock_space as j_rosenbrock_space

from uptune_tpu_torch import obs as tobs
from uptune_tpu_torch.exec.space_io import records_from_space
from uptune_tpu_torch.obs import hub as thub
from uptune_tpu_torch.obs import top as ttop
from uptune_tpu_torch.serve import client as tclient
from uptune_tpu_torch.serve import router as trouter
from uptune_tpu_torch.serve import wire as twire
from uptune_tpu_torch.serve.session import LocalSession
from uptune_tpu_torch.workloads import rosenbrock_space

from test_torch_driver import untraced
from test_torch_serve import (REPO, CpuServer, cases, point_at_port,
                              run_case)


class CpuRouter(trouter.Router):
    """The port's router with its shards on the CPU."""

    def __init__(self, *args, **kw):
        kw.setdefault("device", "cpu")
        super().__init__(*args, **kw)


class FakeShard(twire.WireServer):
    """The reference's `FakeShard` (tests/test_router.py) on the port's
    wire kernel: its op methods and table as they are."""

    WIRE_NAME = ref_router.FakeShard.WIRE_NAME
    _op_ping = ref_router.FakeShard._op_ping
    _op_open = ref_router.FakeShard._op_open
    _op_attach = ref_router.FakeShard._op_attach
    _op_stats = ref_router.FakeShard._op_stats
    _OPS = ref_router.FakeShard._OPS

    def __init__(self):
        twire.WireServer.__init__(self, "127.0.0.1", 0)
        self.sessions = {}
        self.opens = 0


@pytest.fixture(scope="module", autouse=True)
def untraced_module():
    with untraced():
        yield


@pytest.fixture
def port_router(monkeypatch):
    point_at_port(monkeypatch, [ref_router], {
        "obs": tobs, "router_mod": trouter, "HashRing": trouter.HashRing,
        "Router": CpuRouter, "routing_key": trouter.routing_key,
        "SessionClient": tclient.SessionClient, "FakeShard": FakeShard})
    for name, mod in (("uptune_tpu.serve.router", trouter),
                      ("uptune_tpu.obs.top", ttop),
                      ("uptune_tpu.obs.hub", thub)):
        monkeypatch.setitem(sys.modules, name, mod)
    tobs.reset()
    yield
    tobs.reset()


@pytest.fixture
def router(tmp_path):
    """TestRouterOps's class fixture, on the port: three registered
    externals on dead ports."""
    r = CpuRouter(shards=0, work_dir=str(tmp_path))
    for i in range(3):
        r.register("127.0.0.1", 1, name=f"s{i}")
    return r


ROUTER_CLASSES = ("TestHashRing", "TestRoutingKey", "TestRouterOps",
                  "TestRedirectTCP")
# reference cases with no counterpart here, and why
ROUTER_LEFT_OUT = {
    # it runs bench.py --serve-sharded, and bench.py is not ported; the
    # sharded smoke below drives the same protocol on the port
    "TestShardedBenchSmoke": "bench.py is the JAX package's",
}
ROUTER_CASES = cases(ref_router, ROUTER_CLASSES)


@pytest.mark.parametrize("cls,name", ROUTER_CASES,
                         ids=[f"{c}::{n}" for c, n in ROUTER_CASES])
def test_reference_router_contract(port_router, cls, name, request):
    run_case(getattr(ref_router, cls), name, request)


def test_the_cases_cover_every_reference_router_test():
    """Every class of tests/test_router.py runs here whole, but those
    listed with their reason; a new reference class shows up as a
    missing one."""
    import inspect
    classes = {c for c, k in inspect.getmembers(ref_router, inspect.isclass)
               if c.startswith("Test") and k.__module__ == "test_router"}
    assert classes == set(ROUTER_CLASSES) | set(ROUTER_LEFT_OUT)


# -- the two packages against each other --------------------------------------------
def _records(i, o=0.0):
    return records_from_space(rosenbrock_space(2, -3.0 - i - o, 3.0 + i + o))


MIXED = [{"name": "x0", "type": "float", "lo": -1.0, "hi": 1.0},
         {"name": "n", "type": "int", "lo": 0, "hi": 9},
         {"name": "c", "type": "enum", "options": ["a", "b", "c"]}]


@pytest.mark.parametrize("records", [_records(0), _records(3, 0.125),
                                     MIXED, MIXED[::-1]],
                         ids=["rosenbrock", "rosenbrock-offset", "mixed",
                              "mixed-reordered"])
def test_routing_key_equals_the_reference(records):
    assert trouter.routing_key(records) == jrouter.routing_key(records)


@pytest.mark.parametrize("replicas", [1, 16, 64])
def test_ring_placements_equal_the_reference(replicas):
    """The same adds and removes give both rings the same owner for every
    key, after each change."""
    keys = [f"key-{i}" for i in range(1500)] + [
        trouter.routing_key(_records(i, 0.125 * o))
        for i in range(6) for o in range(16)]
    mine, ref = trouter.HashRing(replicas), jrouter.HashRing(replicas)
    steps = [("add", "s0"), ("add", "s1"), ("add", "s2"), ("add", "s3"),
             ("remove", "s1"), ("add", "s4"), ("remove", "s0"),
             ("add", "s1"), ("remove", "nope")]
    assert [mine.lookup(k) for k in keys[:3]] == [None] * 3
    for op, name in steps:
        getattr(mine, op)(name)
        getattr(ref, op)(name)
        assert mine.nodes == ref.nodes and len(mine) == len(ref)
        assert [mine.lookup(k) for k in keys] == [ref.lookup(k) for k in keys]


@pytest.fixture
def router_pair(tmp_path):
    """A JAX router and a port router over the same three registered
    shard addresses (dead ports: no request reaches them)."""
    pair = (CpuRouter(shards=0, work_dir=str(tmp_path / "port")),
            jrouter.Router(shards=0, work_dir=str(tmp_path / "jax")))
    for r in pair:
        for i in range(3):
            r.register("127.0.0.1", 9 + i, name=f"s{i}")
    return pair


FRAMES = {
    "open": {"op": "open", "space": _records(1)},
    "open-durable-id": {"op": "open", "space": _records(2),
                        "session": "sid-1", "id": 7},
    "attach-known": {"op": "attach", "session": "sid-1"},
    "attach-unknown": {"op": "attach", "session": "nope"},
    "route-by-space": {"op": "route", "space": MIXED},
    "route-by-key": {"op": "route", "key": "abc"},
    "resolve": {"op": "resolve", "spaces": [_records(i) for i in range(5)]
                + ["bad", []]},
    "resolve-keys": {"op": "resolve", "keys": ["a", "b", ""]},
    "open-no-space": {"op": "open", "space": []},
    "scale-bad": {"op": "scale", "shards": 100},
    "batch": {"op": "batch", "ops": [{"op": "route", "space": _records(4)},
                                     {"op": "open", "space": MIXED}]},
}


@pytest.mark.parametrize("frame", list(FRAMES))
def test_router_replies_equal_the_reference_byte_for_byte(router_pair,
                                                          frame):
    """Each router answers the same requests (after the same earlier
    ones) with the same wire text: the redirect frames, route and
    resolve rows, and the error replies."""
    mine, ref = router_pair
    for name in list(FRAMES)[:list(FRAMES).index(frame) + 1]:
        got = twire.encode_reply(mine.handle(dict(FRAMES[name])))
        want = jwire.encode_reply(ref.handle(dict(FRAMES[name])))
    assert got == want


def _measure(cfg):
    x = np.array([cfg["x0"], cfg["x1"]])
    return float(100.0 * (x[1] - x[0] ** 2) ** 2 + (1 - x[0]) ** 2)


@pytest.mark.parametrize("client,router", [("jax", "port"), ("port", "jax"),
                                           ("port", "port"), ("jax", "jax")])
def test_clients_follow_either_packages_router(client, router, tmp_path):
    """A client of either package opens through a router of either
    package: one redirect to the shard (a session server of the router's
    package), then ask / tell a whole epoch and read the best there."""
    if router == "port":
        shard = CpuServer(host="127.0.0.1", port=0, slots=2, max_sessions=8,
                          store_dir="off").start()
        r = CpuRouter(shards=0, work_dir=str(tmp_path),
                      supervise_interval=30.0).start()
    else:
        shard = JServer(host="127.0.0.1", port=0, slots=2, max_sessions=8,
                        store_dir="off").start()
        r = jrouter.Router(shards=0, work_dir=str(tmp_path),
                           supervise_interval=30.0).start()
    conn = jconnect if client == "jax" else tclient.connect
    space = (j_rosenbrock_space if client == "jax" else rosenbrock_space)(
        2, -3.0, 3.0)
    try:
        r.register("127.0.0.1", shard.port)
        with conn(("127.0.0.1", r.port)) as c:
            with c.open_session(space, seed=3, store=False) as h:
                assert c.redirects == 1 and c.port == shard.port
                told = 0
                while h.version < 1:
                    trials = h.ask(8)
                    rep = h.tell_many([(t.ticket, _measure(t.config))
                                       for t in trials])
                    told += rep["told"]
                best = h.best()
                assert best["version"] == 1 and best["tells"] == told
                assert best["qor"] == _measure(best["config"])
        assert shard.n_sessions == 0
    finally:
        r.stop()
        shard.stop()


# -- one sharded smoke with real shard processes ------------------------------------
SMOKE_LIMIT_S = 360.0       # the whole smoke, boots and drives included
SMOKE_SPACES, SMOKE_EPOCHS, SMOKE_CHUNK = 3, 2, 8


def _placement(k_max):
    """Space bounds walked (the reference's idiom) until s0 owns some but
    not all sessions and every shard owns one."""
    ring = jrouter.HashRing()
    for i in range(k_max):
        ring.add(f"s{i}")
    for o in range(64):
        recs = [_records(i, o * 0.125) for i in range(SMOKE_SPACES)]
        owners = [ring.lookup(jrouter.routing_key(r)) for r in recs]
        if (len(set(owners)) == k_max
                and 1 <= owners.count("s0") < SMOKE_SPACES):
            return o, recs, owners
    raise AssertionError("no placement found")


def test_sharded_smoke_kill_and_parity(tmp_path, monkeypatch):
    """A port Router over real `ut-torch serve --device cpu --durable`
    shards: K walked 1 -> 2 by the scale op (a round of sessions at
    each), then a round during which `route.kill` SIGKILLs s0 once on a
    supervisor tick, after the sessions it owns committed an epoch.  The
    supervisor respawns it on its port with its checkpoints; the
    auto-resume clients finish, no acked committed version goes back,
    and every final state equals a matched-seed CPU LocalSession's."""
    deadline = time.time() + SMOKE_LIMIT_S
    o, recs, owners = _placement(2)
    for v in ("UT_TRACE", "UT_JOURNAL", "UT_TELEMETRY", "UT_FAULTS",
              "UT_DEVICE_TRACE"):
        monkeypatch.delenv(v, raising=False)
    r = CpuRouter(port=0, shards=0, slots=4, max_sessions=16,
                  store_dir=str(tmp_path / "store"), work_dir=str(tmp_path),
                  supervise_interval=0.5)
    r.start()
    per, errors = {}, []

    def drive(idx, seed, tag, n_epochs, hold=None):
        try:
            c = tclient.connect(("127.0.0.1", r.port), timeout=120,
                                auto_resume=True, max_retries=80,
                                backoff_base=0.25, backoff_max=2.0)
            h = c.open_session(recs[idx], seed=seed, program=f"smoke-{idx}")
            acked, monotone = 0, True
            while h.version < n_epochs:
                assert time.time() < deadline, f"{tag}/{idx} at v{h.version}"
                if hold is not None and owners[idx] == "s0" and h.version:
                    hold.wait(timeout=120)
                trials = h.ask(SMOKE_CHUNK)
                rep = h.tell_many([(t.ticket, _measure(t.config))
                                   for t in trials])
                v = rep.get("version")
                if v is not None:
                    monotone &= int(v) >= acked
                    if rep.get("committed"):
                        acked = max(acked, int(v))
            per[tag, idx] = {"best": h.best(), "acked": acked,
                             "monotone": monotone,
                             "reconnects": c.reconnects}
            h.close()
            c.close()
        except Exception as e:
            errors.append((tag, idx, repr(e)))

    def run_round(tag, seed_base, n_epochs, mid=None, hold=None):
        ts = [threading.Thread(target=drive,
                               args=(i, seed_base + i, tag, n_epochs, hold))
              for i in range(SMOKE_SPACES)]
        for t in ts:
            t.start()
        if mid is not None:
            mid()
        for t in ts:
            t.join(max(1.0, deadline - time.time()))
        assert not any(t.is_alive() for t in ts), f"round {tag} past limit"
        assert not errors, errors

    try:
        for k in (1, 2):
            rep = r.handle({"op": "scale", "shards": k})
            assert rep["ok"] and rep["live"] == k, rep
            run_round(f"k{k}", 500 + 100 * k, SMOKE_EPOCHS)
        killed = threading.Event()
        mapped = r.handle({"op": "ping"})["sessions"]

        def mid():
            while (r.handle({"op": "ping"})["sessions"] < mapped + SMOKE_SPACES
                   and time.time() < deadline):
                time.sleep(0.05)
            tobs.faults.arm("route.kill", "error",
                            at=tobs.faults.hits("route.kill") + 1)
            while r.kills < 1 and time.time() < deadline:
                time.sleep(0.05)
            killed.set()

        run_round("kill", 900, SMOKE_EPOCHS + 1, mid=mid, hold=killed)
        tobs.faults.disarm()
        stats = r.handle({"op": "stats"})
        # the respawned s0 reports to the hub as a third source once its
        # shipper has said hello (it connects in the background)
        fleet = r.handle({"op": "metrics"})
        while fleet["sources"] < 3 and time.time() < deadline:
            time.sleep(0.1)
            fleet = r.handle({"op": "metrics"})
    finally:
        tobs.faults.disarm()
        r.stop()
    assert stats["kills"] == 1
    restarts = {row["name"]: row["restarts"] for row in stats["shards"]}
    assert restarts == {"s0": 1, "s1": 0}, restarts
    assert fleet["shards"] == 2 and fleet["sources"] >= 3
    for i in range(SMOKE_SPACES):
        got = per["kill", i]
        assert got["monotone"] and got["best"]["version"] >= got["acked"]
        if owners[i] == "s0":
            assert got["reconnects"] > 0
        ls = LocalSession(rosenbrock_space(2, -3.0 - i - o * 0.125,
                                           3.0 + i + o * 0.125),
                          seed=900 + i, device="cpu")
        while ls.version < SMOKE_EPOCHS + 1:
            for t in ls.ask(SMOKE_CHUNK):
                ls.tell(t.ticket, _measure(t.config))
        want = ls.best()
        ls.close()
        assert (got["best"]["config"], got["best"]["qor"],
                got["best"]["version"]) == (want["config"], want["qor"],
                                            want["version"]), i
    assert time.time() < deadline


def test_router_without_a_card_exits_before_spawning(monkeypatch, tmp_path):
    """Without `--device cpu` on a host without a card, `ut-torch route`
    exits 1 before a router exists, and a Router asked for the card
    raises in start() before its hub, listener or any shard."""
    import torch
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    spawned = []
    monkeypatch.setattr(trouter.Router, "_spawn_proc",
                        lambda self, shard: spawned.append(shard))
    from uptune_tpu_torch import cli
    assert cli.main(["route", "--port", "0", "--work-dir",
                     str(tmp_path)]) == 1
    r = trouter.Router(port=0, shards=2, work_dir=str(tmp_path))
    assert r.device == "cuda"
    with pytest.raises(RuntimeError, match="is_available"):
        r.start()
    assert not spawned and r.hub.port == 0 and r.port == 0


def test_shards_are_port_serve_processes_on_the_routers_device(tmp_path,
                                                               monkeypatch):
    """A shard is `python -m uptune_tpu_torch.cli serve --device <the
    router's>`, without the router's fault schedule, with the package's
    parent on its PYTHONPATH and its own device-trace directory."""
    seen = {}

    class Proc:
        pid = 4242

        def poll(self):
            return None

    def popen(cmd, cwd, env, stdout, stderr):
        seen.update(cmd=cmd, env=env)
        return Proc()

    monkeypatch.setattr(trouter.subprocess, "Popen", popen)
    monkeypatch.setenv("UT_FAULTS", "route.kill=error@1")
    monkeypatch.setenv("UT_DEVICE_TRACE", "dt")
    for device in ("cuda", "cpu"):
        r = trouter.Router(shards=0, work_dir=str(tmp_path), device=device)
        shard = r._new_shard()
        r._spawn_proc(shard)
        cmd, env = seen["cmd"], seen["env"]
        assert cmd[1:5] == ["-m", "uptune_tpu_torch.cli", "serve",
                            "--device"] and cmd[5] == device
        assert cmd[cmd.index("--durable") + 1] == shard.ckpt_dir
        assert cmd[cmd.index("--telemetry") + 1].endswith(f":{r.hub.port}")
        assert "UT_FAULTS" not in env
        assert env["UT_DEVICE_TRACE"] == os.path.join(os.path.abspath("dt"),
                                                      shard.name)
        root = os.path.dirname(os.path.dirname(os.path.abspath(
            trouter.__file__)))
        assert os.path.dirname(root) in env["PYTHONPATH"].split(os.pathsep)


def test_a_dead_shard_is_respawned_on_its_port_each_tick(tmp_path,
                                                        monkeypatch):
    """The reference's supervision: a managed shard found dead is
    respawned on every tick, on the same port, without leaving the ring
    and without the converge step adding a shard beside it; once a
    respawn stays up, the respawns stop."""
    spawns = []

    class Proc:
        pid = 1

        def __init__(self, rc):
            self.returncode = rc

        def poll(self):
            return self.returncode

    outcomes = [1, 1, 1, None]          # three deaths, then it stays up

    def spawn(self, shard):
        spawns.append((shard.name, shard.port))
        shard.proc = Proc(outcomes[min(len(spawns), len(outcomes)) - 1])
        shard.ready = False

    monkeypatch.setattr(trouter.Router, "_spawn_proc", spawn)
    r = CpuRouter(shards=0, work_dir=str(tmp_path))
    sh = r._new_shard()
    sh.proc, sh.ready = Proc(1), True
    r._shards[sh.name] = sh
    r._ring.add(sh.name)
    r._target = 1
    for _ in range(10):
        r._tick()
    assert spawns == [(sh.name, sh.port)] * 4
    assert sh.restarts == 4 and sh.alive
    assert list(r._shards) == [sh.name]
    assert r._ring.lookup("any-key") == sh.name


# -- the route phase's readers (chip_smoke.py), on the CPU ------------------------
def test_chip_smoke_counts_the_merge_in_a_device_trace(tmp_path):
    """`chip_smoke.trace_kernels` counts a torch.profiler Chrome trace's
    CUDA kernel events, and the port's kernel functions among them by
    name (template arguments and parameter lists as CUPTI prints them);
    host events and copies are not kernels; a missing trace is None."""
    import chip_smoke
    events = ([{"ph": "X", "cat": "kernel",
                "name": "void merge_rows_kernel<128>(long const*, long)"}] * 3
              + [{"ph": "X", "cat": "kernel",
                  "name": "void at::native::elementwise_kernel<128, 4>()"}]
              + [{"ph": "X", "cat": "kernel",
                  "name": "void krows_mma_kernel<true, false, true>(int)"}]
              + [{"ph": "X", "cat": "cpu_op", "name": "merge_rows_kernel"},
                 {"ph": "X", "cat": "gpu_memcpy", "name": "Memcpy HtoD"}])
    path = tmp_path / "device_trace.json"
    path.write_text(json.dumps({"traceEvents": events}))
    assert chip_smoke.trace_kernels(path) == {
        "all": 5, "merge_rows_kernel": 3, "krows_mma_kernel": 1}
    assert chip_smoke.trace_kernels(tmp_path / "missing.json") is None


def test_chip_smoke_reads_a_router_fleet_timeline(tmp_path):
    """`chip_smoke.fleet_timeline` reads a hub's timeline back: each
    source's last window by pid (its final flag with it), and the fleet
    counters a hub replaying the timeline serves, the exact sum of the
    sources' latest counters."""
    import chip_smoke
    path = tmp_path / "fleet.jsonl"
    hub = thub.TelemetryHub(port=0, timeline=str(path))
    try:
        for pid, commits in (("101", (3, 7)), ("202", (5, 9))):
            src = {"host": "h", "pid": pid, "role": "serve"}
            for i, c in enumerate(commits):
                row = {"counters": {"serve.commits": c}, "dt": 1.0,
                       "final": i == len(commits) - 1 and pid == "101"}
                assert hub.handle({"op": "ship", "source": src,
                                   "rows": [{"kind": "window",
                                             "row": row}]})["ok"]
        want = hub.handle({"op": "metrics"})["metrics"]["counters"]
    finally:
        hub.stop()
    last, fleet = chip_smoke.fleet_timeline(path)
    assert {p: w["counters"]["serve.commits"] for p, w in last.items()} == {
        "101": 7, "202": 9}
    assert last["101"]["final"] and not last["202"]["final"]
    assert fleet == want and fleet["serve.commits"] == 16


def test_chip_smoke_cold_starts_from_the_shards_op():
    """`chip_smoke.cold_starts` turns the router's `shards` rows, read at
    once after `Router.start()` booted them one after another, into each
    shard's seconds from its spawn to the next one's (the last one's to
    start()'s return)."""
    import chip_smoke
    now = time.time()
    rows = [{"name": "s1", "uptime_s": 5.0}, {"name": "s0", "uptime_s": 12.0},
            {"name": "s2", "uptime_s": 2.5}]
    got = chip_smoke.cold_starts(rows, now - 0.5)
    assert got == pytest.approx([7.0, 2.5, 2.0], abs=0.05)


@pytest.mark.parametrize("n,dims,k,partial", [(6, 2, 3, True),
                                              (16, 4, 3, False)])
def test_chip_smoke_placement_walks_the_bounds(n, dims, k, partial):
    """`chip_smoke.route_placement` walks the reference's bounds until
    every shard owns a signature (and s0 some but not all), and its
    owners are the JAX package's ring's."""
    import chip_smoke
    place = chip_smoke.route_placement(n, dims, k, partial)
    ring = jrouter.HashRing()
    for i in range(k):
        ring.add(f"s{i}")
    assert place["owners"] == [ring.lookup(jrouter.routing_key(r))
                               for r in place["records"]]
    assert set(place["owners"]) == {f"s{i}" for i in range(k)}
    if partial:
        assert 1 <= place["owners"].count("s0") < n
    o = place["offset_steps"]
    assert place["bounds"][1] == (-4.0 - o * 0.125, 4.0 + o * 0.125)


def test_ut_torch_route_subprocess_round_trip(tmp_path):
    """`python -m uptune_tpu_torch.cli route --device cpu` spawns its
    shard, routes an open there, and on SIGTERM stops the shard and
    exits 0 (no shard outlives its router)."""
    import signal
    import subprocess
    env = {**os.environ, "PYTHONPATH": REPO}
    for v in ("UT_TRACE", "UT_JOURNAL", "UT_TELEMETRY", "UT_FAULTS",
              "UT_DEVICE_TRACE"):
        env.pop(v, None)
    proc = subprocess.Popen(
        [sys.executable, "-m", "uptune_tpu_torch.cli", "route", "--port",
         "0", "--shards", "1", "--device", "cpu", "--work-dir",
         str(tmp_path)], cwd=str(tmp_path), env=env,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    try:
        port, shard_pid, lines = None, None, []
        deadline = time.time() + 120
        while shard_pid is None and time.time() < deadline:
            line = proc.stdout.readline()
            if not line:
                break
            lines.append(line)
            if "[ut-route] listening on" in line:
                port = int(line.split("listening on ")[1].split()[0]
                           .rsplit(":", 1)[1])
            if "[ut-route] shard s0 -> pid" in line:
                shard_pid = int(line.split("-> pid ")[1].split()[0])
        assert port and shard_pid, "".join(lines)
        with tclient.connect(("127.0.0.1", port)) as c:
            # the shard joins the ring once it answers a ping
            while c.ping()["shards"] < 1:
                assert time.time() < deadline, "".join(lines)
                time.sleep(0.1)
            with c.open_session(rosenbrock_space(2, -3.0, 3.0), seed=1,
                                store=False) as h:
                assert c.redirects == 1 and c.port != port
                trials = h.ask(4)
                assert h.tell_many([(t.ticket, _measure(t.config))
                                    for t in trials])["told"] == 4
        proc.send_signal(signal.SIGTERM)
        assert proc.wait(timeout=60) == 0
        with pytest.raises(ProcessLookupError):
            os.kill(shard_pid, 0)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
