"""The port's multi-process plane (`uptune_tpu_torch/parallel/multihost.py`,
`ShardedEngine` over a process group, the cooperative store between
processes, `ut-torch --num-hosts`) on the CPU, with gloo ranks.

* TestConfig / TestLauncher — the bodies of tests/test_multihost.py's
  classes with its names pointed at the port's (the launcher's children
  are `python -m uptune_tpu_torch.cli`);
* TestMesh — its layout contract on the port: the eval axis never
  crosses a process, indivisible widths raise, rank 0 coordinates;
* TestTwoProcess — two gloo processes started with the launcher's
  UT_COORDINATOR / UT_NUM_PROCESSES / UT_PROCESS_ID environment call
  `initialize()`, build the hybrid mesh, run sharded engine steps with
  the cross-process best exchange, and print the same global best, equal
  bitwise to a one-process local mesh of the same shape and seed;
* TestFourProcessElastic — four processes, a checkpointed best, one
  SIGKILLed mid-run, and a resumed job that never regresses;
* TestTwoProcessCooperativeStore — two worker processes, each with a
  port `RemoteStore`, cooperating through one port `StoreServer`;
* TestLauncherTune — `ut-torch --num-hosts 2 prog.py --device cpu`.

Every subprocess wait has its own timeout, and each rank's
`init_process_group` one of UT_DIST_TIMEOUT seconds, so a hung rank
fails its test in seconds.  The workers are this file run as a script
(`python tests/test_torch_multihost.py mh|store ...`), importing
neither jax nor the JAX package.
"""
import json
import os
import socket
import subprocess
import sys
import time

import pytest

HERE = os.path.abspath(__file__)
REPO = os.path.dirname(os.path.dirname(HERE))
WAIT_S = 120                    # every communicate / wait of a worker
DIST_TIMEOUT_S = 30             # each rank's init_process_group


def _free_port() -> int:
    s = socket.socket()
    s.bind(("localhost", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _env(**extra):
    env = {k: v for k, v in os.environ.items()
           if k not in ("UT_PROCESS_ID", "UT_NUM_PROCESSES",
                        "UT_COORDINATOR")}
    pp = env.get("PYTHONPATH", "")
    env["PYTHONPATH"] = REPO + (os.pathsep + pp if pp else "")
    env.update({k: str(v) for k, v in extra.items()})
    return env


def _spawn_workers(n, port, extra_env):
    """n ranks with the environment `ut-torch --num-hosts n` gives its
    children (`cli._launch_hosts`)."""
    procs = []
    for pid in range(n):
        env = _env(UT_COORDINATOR=f"localhost:{port}",
                   UT_NUM_PROCESSES=n, UT_PROCESS_ID=pid,
                   UT_DIST_TIMEOUT=DIST_TIMEOUT_S,
                   **{k: v.format(pid=pid) for k, v in extra_env.items()})
        procs.append(subprocess.Popen(
            [sys.executable, HERE, "mh"], env=env, stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, text=True))
    return procs


def _communicate_all(procs, timeout=WAIT_S):
    outs = []
    try:
        for p in procs:
            out, err = p.communicate(timeout=timeout)
            assert p.returncode == 0, f"worker failed:\n{out}\n{err}"
            outs.append(out)
    except subprocess.TimeoutExpired:
        pytest.fail("multihost worker hung")
    finally:
        for q in procs:
            if q.poll() is None:
                q.kill()
                q.wait(timeout=30)
    return outs


def _mh_line(out):
    return next(ln for ln in out.splitlines() if ln.startswith("UT_MH "))


def _field(line, name):
    return line.split(f"{name}=")[1].split()[0]


# -- the reference bodies on the port ------------------------------------------
@pytest.fixture
def ref_mh(monkeypatch):
    """tests/test_multihost.py with its parallel names and the CLI module
    its launcher bodies import pointed at the port's."""
    import test_multihost as ref
    from uptune_tpu_torch import cli as tcli
    from uptune_tpu_torch import parallel as tpar
    for name in ("distributed_config", "is_coordinator",
                 "make_multihost_mesh"):
        monkeypatch.setattr(ref, name, getattr(tpar, name))
    monkeypatch.setitem(sys.modules, "uptune_tpu.cli", tcli)
    monkeypatch.delenv("UT_PROCESS_ID", raising=False)
    return ref


@pytest.mark.parametrize("name", ["test_single_process_defaults",
                                  "test_env_layer", "test_args_beat_env",
                                  "test_validation"])
def test_config_reference_bodies(ref_mh, monkeypatch, name):
    getattr(ref_mh.TestConfig(), name)(monkeypatch)


def test_config_equals_the_reference(monkeypatch):
    """The same resolution and the same error texts as the JAX
    package's `distributed_config`."""
    from uptune_tpu.parallel import distributed_config as jcfg
    from uptune_tpu_torch.parallel import distributed_config as tcfg
    for v in ("UT_COORDINATOR", "UT_NUM_PROCESSES", "UT_PROCESS_ID"):
        monkeypatch.delenv(v, raising=False)
    for args in ((None, None, None), ("h:1", 3, 2), (None, 1, 0)):
        assert jcfg(*args) == tcfg(*args)
    for args in ((None, 2, None), ("h:1", 2, 5), (None, 0, None),
                 ("h:1", 2, -1)):
        errs = []
        for fn in (jcfg, tcfg):
            with pytest.raises(ValueError) as e:
                fn(*args)
            errs.append(str(e.value))
        assert errs[0] == errs[1]


@pytest.mark.parametrize("name", ["test_num_hosts_spawns_prefixed_children",
                                  "test_child_does_not_relaunch"])
def test_launcher_reference_bodies(ref_mh, monkeypatch, capsys, name):
    case = getattr(ref_mh.TestLauncher(), name)
    if name == "test_child_does_not_relaunch":
        case(monkeypatch, capsys)
    else:
        case(capsys)


class TestMesh:
    def test_layout(self):
        """Four processes' worth of devices (a CPU device listed twice a
        process, as the reference's virtual devices), eval width 2: each
        eval row on one process, a process's rows contiguous."""
        import torch
        from uptune_tpu_torch.parallel import make_multihost_mesh
        cpu = torch.device("cpu")
        mesh = make_multihost_mesh(n_eval_per_host=2, devices=[cpu] * 8)
        assert mesh.shape == {"search": 4, "eval": 2}
        assert mesh.world == 1 and mesh.group is None
        assert mesh.owned("search") == [0, 1, 2, 3]
        assert not mesh.spans_processes("eval")

    def test_indivisible(self):
        from uptune_tpu_torch.parallel import make_multihost_mesh
        with pytest.raises(ValueError, match="divid"):
            make_multihost_mesh(n_eval_per_host=3, device="cpu")

    def test_eval_wider_than_host_rejected(self):
        import torch
        from uptune_tpu_torch.parallel import make_multihost_mesh
        with pytest.raises(ValueError, match="divid"):
            make_multihost_mesh(n_eval_per_host=2, device="cpu")
        with pytest.raises(ValueError, match="divisible"):
            make_multihost_mesh(n_eval_per_host=3,
                                devices=[torch.device("cpu")] * 8)

    def test_coordinator_predicate(self):
        from uptune_tpu_torch.parallel import initialize, is_coordinator
        assert is_coordinator() is True     # single-process run
        assert initialize(None, 1, 0)["backend"] is None


class TestTwoProcess:
    def test_distributed_best_exchange(self, tmp_path):
        """2 gloo processes x 2 eval shards: `initialize()` from the
        launcher's environment, the hybrid mesh, 25 sharded steps, the
        same global best on both ranks, equal bitwise to one process
        over a local 2 x 2 mesh of the same seed."""
        import torch
        from uptune_tpu_torch.parallel import ShardedEngine, make_mesh
        outs = _communicate_all(_spawn_workers(2, _free_port(), {}))
        lines = [_mh_line(o) for o in outs]
        bests = {_field(ln, "global_best_hex") for ln in lines}
        assert len(bests) == 1, lines
        assert sorted("coord=True" in ln for ln in lines) == [False, True]
        assert {_field(ln, "backend") for ln in lines} == {"gloo"}
        se = ShardedEngine(_worker_engine(), make_mesh(2, 2, device="cpu"))
        st = se.run(se.init(1000), 25)
        assert float(torch.min(st.best.qor)).hex() == bests.pop()


class TestFourProcessElastic:
    """4 gloo processes with a checkpointed best, a SIGKILLed worker
    mid-run (job-level preemption: the job dies as a unit), and a
    resumed 4-process job that restores the checkpoint and never
    regresses past it."""

    def test_kill_and_resume(self, tmp_path):
        ckpt = str(tmp_path / "best.json")
        outs = _communicate_all(_spawn_workers(4, _free_port(),
                                               {"UT_MH_CKPT": ckpt}))
        lines = [_mh_line(o) for o in outs]
        assert len({_field(ln, "global_best") for ln in lines}) == 1
        assert sum("coord=True" in ln for ln in lines) == 1
        with open(ckpt) as f:
            saved = json.load(f)
        assert saved["qor"] < 1.0

        beacon = str(tmp_path / "started_{pid}.txt")
        procs = _spawn_workers(4, _free_port(), {
            "UT_MH_STEPS": "4000", "UT_MH_START_FILE": beacon})
        try:
            deadline = time.time() + WAIT_S
            while time.time() < deadline and not all(
                    os.path.exists(beacon.format(pid=p)) for p in range(4)):
                time.sleep(0.2)
            assert all(os.path.exists(beacon.format(pid=p))
                       for p in range(4)), "phase B never got under way"
            procs[2].kill()                   # the preempted host
            assert procs[2].wait(timeout=WAIT_S) != 0
        finally:
            for p in procs:                   # job-level teardown
                p.kill()
                p.wait(timeout=WAIT_S)

        outs = _communicate_all(_spawn_workers(4, _free_port(), {
            "UT_MH_CKPT": ckpt, "UT_MH_RESUME": "1"}))
        finals = set()
        for out in outs:
            line = _mh_line(out)
            assert f"restored={saved['qor']:.9f}" in line, line
            finals.add(float(_field(line, "global_best")))
        assert len(finals) == 1
        assert finals.pop() <= saved["qor"] + 1e-9


class TestTwoProcessCooperativeStore:
    """Two worker processes, each holding a port RemoteStore, cooperate
    through one port StoreServer over localhost TCP: record/ack,
    cross-worker delta feeds and the shared-memo lookup (the body of
    the reference's class, the workers on the port)."""

    @staticmethod
    def _req(port, payload):
        with socket.create_connection(("127.0.0.1", port),
                                      timeout=10) as s:
            f = s.makefile("rwb")
            f.write((json.dumps(payload) + "\n").encode())
            f.flush()
            resp = json.loads(f.readline())
        assert resp.get("ok"), resp
        return resp

    def test_two_workers_share_one_store(self, tmp_path):
        from uptune_tpu_torch.store.server import StoreServer
        srv = StoreServer("127.0.0.1", 0, str(tmp_path / "store")).start()
        addr = f"tcp://127.0.0.1:{srv.port}"
        procs = [subprocess.Popen(
            [sys.executable, HERE, "store", addr, tag],
            stdin=subprocess.PIPE, stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, text=True, env=_env())
            for tag in ("a", "b")]
        try:
            ports = []
            for p in procs:
                line = p.stdout.readline().strip()
                assert line.startswith("PORT "), (line, p.stderr.read())
                ports.append(int(line.split()[1]))
            pa, pb = ports
            ra = self._req(pa, {"op": "record", "n": 10, "base": 5.0})
            assert len(ra["keys"]) == 10 and ra["shipped"]
            sb = self._req(pb, {"op": "sync"})
            assert sb["merged"] == 10 and len(sb["fresh"]) == 10
            assert all(c["w"] == "a" for c in sb["fresh"])
            assert sb["best_qor"] == 5.0
            rb = self._req(pb, {"op": "record", "n": 4, "base": 1.0})
            assert len(rb["keys"]) == 4 and rb["shipped"]
            sa = self._req(pa, {"op": "sync"})
            assert len(sa["fresh"]) == 4
            assert all(c["w"] == "b" for c in sa["fresh"])
            assert sa["rows"] == 14 and sa["best_qor"] == 1.0
            la = self._req(pa, {"op": "lookup", "cfg": {"w": "b", "i": 2}})
            assert la["row"] is not None and la["row"]["qor"] == 3.0
            assert self._req(pb, {"op": "sync"})["merged"] == 0
            st = self._req(pa, {"op": "stats"})["stats"]["remote"]
            assert st["connected"] and st["acked"] == 10
            assert st["dropped"] == 0
            with srv._lock:
                assert srv.recorded == 14 and srv.dups == 0
        finally:
            srv.stop()
            for p in procs:
                if p.stdin:
                    p.stdin.close()     # the worker's exit signal
            for p in procs:
                try:
                    p.wait(timeout=WAIT_S)
                except subprocess.TimeoutExpired:
                    p.kill()


class TestLauncherTune:
    def test_two_replica_program_tune(self, tmp_path):
        """`ut-torch --num-hosts 2 prog.py --device cpu`: the replicas
        diverge, write separate archives and bests, and the launcher
        promotes the winner to best.json."""
        import shutil
        src = os.path.join(REPO, "samples", "rosenbrock", "rosenbrock.py")
        prog = tmp_path / "rosenbrock.py"
        shutil.copy(src, prog)
        r = subprocess.run(
            [sys.executable, "-m", "uptune_tpu_torch.cli", str(prog),
             "--num-hosts", "2", "--test-limit", "20", "--device", "cpu"],
            capture_output=True, text=True, timeout=WAIT_S * 2,
            env=_env(), cwd=str(tmp_path))
        assert r.returncode == 0, r.stdout + r.stderr
        assert "best across 2 replicas" in r.stdout
        assert (tmp_path / "ut.archive.jsonl").exists()
        assert (tmp_path / "ut.archive.h1.jsonl").exists()
        best = json.load(open(tmp_path / "best.json"))
        bests = [best["qor"]]
        if (tmp_path / "best.h1.json").exists():
            bests.append(json.load(open(tmp_path / "best.h1.json"))["qor"])
        assert best["qor"] == min(bests)


# -- the workers (this file run as a script) -------------------------------------
def _worker_engine():
    from uptune_tpu_torch.engine import FusedEngine, default_arms
    from uptune_tpu_torch.workloads import rosenbrock_space, sphere_device
    return FusedEngine(rosenbrock_space(4, -3.0, 3.0),
                       lambda v, p: sphere_device(v), arms=default_arms(1),
                       history_capacity=1 << 10, device="cpu")


def _mh_main() -> int:
    """One rank of the sharded engine over gloo: the hybrid mesh (two
    eval shards a process, the search axis across processes), run, and
    the global best every rank computes alike."""
    import torch
    from uptune_tpu_torch.parallel import (ShardedEngine, initialize,
                                           is_coordinator,
                                           make_multihost_mesh)
    from uptune_tpu_torch.parallel.mesh import all_gather
    from uptune_tpu_torch.parallel.multihost import shutdown
    cfg = initialize(timeout=float(os.environ["UT_DIST_TIMEOUT"]))
    steps = int(os.environ.get("UT_MH_STEPS", "25"))
    ckpt = os.environ.get("UT_MH_CKPT")
    resume = os.environ.get("UT_MH_RESUME") == "1"
    start_file = os.environ.get("UT_MH_START_FILE")
    n = cfg["num_processes"]
    mesh = make_multihost_mesh(2, devices=[torch.device("cpu")] * (2 * n))
    assert mesh.shape == {"search": n, "eval": 2}, mesh.shape
    se = ShardedEngine(_worker_engine(), mesh)
    # the same seed on every rank; each replica draws its own key
    state = se.init(1000)
    restored = None
    if resume and ckpt and os.path.exists(ckpt):
        with open(ckpt) as f:
            saved = json.load(f)
        restored = float(saved["qor"])
        k = len(se.replicas)
        u = torch.tensor(saved["u"], dtype=torch.float32)
        state = state._replace(best=state.best._replace(
            u=u[None, :].repeat(k, 1),
            qor=torch.full((k,), restored, dtype=torch.float32)))
    if start_file:
        with open(start_file, "w") as f:
            f.write(str(os.getpid()))
    state = se.run(state, steps)
    qors = all_gather(mesh, state.best.qor)
    us = all_gather(mesh, state.best.u)
    gbest = float(qors.min())
    spread = float(qors.max() - qors.min())
    if ckpt and not resume and is_coordinator():
        tmp = ckpt + f".tmp{os.getpid()}"
        with open(tmp, "w") as f:
            json.dump({"qor": gbest, "u": us[int(qors.argmin())].tolist()}, f)
        os.replace(tmp, ckpt)
    print(f"UT_MH pid={cfg['process_id']} coord={is_coordinator()} "
          f"replicas={qors.shape[0]} global_best={gbest:.9f} "
          f"global_best_hex={gbest.hex()} backend={cfg['backend']} "
          f"spread={spread:.3e} restored="
          f"{'-' if restored is None else f'{restored:.9f}'}", flush=True)
    shutdown()
    assert spread < 1e-6, f"replicas disagree after exchange: {qors}"
    assert gbest < 1.0, f"sharded engine failed to descend: {gbest}"
    if restored is not None:
        assert gbest <= restored + 1e-9, (gbest, restored)
    return 0


def _store_main(addr: str, tag: str) -> int:
    """The reference's tests/store_worker.py on the port: one RemoteStore
    behind a tiny wire surface the parent commands; exits when its stdin
    closes."""
    from uptune_tpu_torch.serve.wire import WireServer
    from uptune_tpu_torch.store.remote import RemoteStore

    store = RemoteStore(addr, ["coop-loopback-spec"], "coop-loopback",
                        refresh_interval=0.0)

    class Worker(WireServer):
        WIRE_NAME = "ut-store-worker"

        def _op_ping(self, req):
            return {"role": "store-worker", "tag": tag}

        def _op_record(self, req):
            keys = []
            for i in range(int(req.get("n", 1))):
                row = store.record({"w": tag, "i": i},
                                   float(req.get("base", 0.0)) + i)
                if row is not None:
                    keys.append(row["k"])
            return {"keys": keys, "shipped": store.flush_wait(20.0)}

        def _op_sync(self, req):
            merged = store.refresh()
            fresh = store.pop_fresh_rows()
            best = store.best_row()
            return {"merged": merged, "fresh": [r["cfg"] for r in fresh],
                    "rows": len(store),
                    "best_qor": None if best is None else best["qor"]}

        def _op_lookup(self, req):
            return {"row": store.lookup(dict(req["cfg"]))}

        def _op_stats(self, req):
            return {"stats": store.stats()}

        _OPS = {"ping": _op_ping, "record": _op_record, "sync": _op_sync,
                "lookup": _op_lookup, "stats": _op_stats}

    w = Worker("127.0.0.1", 0).start()
    print(f"PORT {w.port}", flush=True)
    sys.stdin.read()
    w.stop()
    store.close()
    return 0


if __name__ == "__main__":
    sys.path.insert(0, REPO)
    if sys.argv[1] == "mh":
        sys.exit(_mh_main())
    sys.exit(_store_main(sys.argv[2], sys.argv[3]))
