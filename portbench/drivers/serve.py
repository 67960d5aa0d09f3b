"""The serving window: one `SessionServer` on the card in this process,
its tenants driven over localhost TCP by client processes of their own
(`serve_client.py`) at a fixed offered rate.

Mix parameters: `asks_per_s` (the offered rate of turns, each an ask
and its tell, over all connections: a Poisson process drawn from the
seed), `client_processes`, `connections` (spread evenly over the
processes; the tenants spread evenly over the connections) and
`warm_epochs` (epochs of each connection's first tenant before the
window).  The configuration's `serve` block gives the tenants, the ask
size, whether the memo store is on, and the program name they share.

`trials_per_s` is every trial told back in the window over the window,
which runs from the go signal to the last reply: above the server's
capacity, what the server completes.  The traced run also reads the
95th percentile of every ask sent in the window, from its send to its
reply (`serve.ask_p95_ms`).  A client that holds JAX or the JAX package
after the window ends the run with an error.  After the window each
tenant's record is judged by the reference (`reference/tenants.py`)."""
from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys
import tempfile
import time
from pathlib import Path

from .. import devtrace, stats
from ..reference import tenants as ref_tenants
from .common import (Check, Outcome, Run, TraceCtx, launches, memory_peak,
                     program_space, sub_seed, synchronize)

CLIENT = Path(__file__).resolve().parent / "serve_client.py"
ROOT = Path(__file__).resolve().parents[2]
SPANS = ("serve.commit", "serve.propose")


class Clients:
    """The client processes, spoken to over their stdin and stdout."""

    def __init__(self, jobs):
        env = dict(os.environ, PYTHONPATH=str(ROOT))
        self.procs = [subprocess.Popen(
            [sys.executable, str(CLIENT)], stdin=subprocess.PIPE,
            stdout=subprocess.PIPE, text=True, env=env, cwd=str(ROOT))
            for _ in jobs]
        for p, job in zip(self.procs, jobs):
            self.send(p, job)

    @staticmethod
    def send(p, obj) -> None:
        p.stdin.write(json.dumps(obj) + "\n")
        p.stdin.flush()

    def each(self, obj=None, key: str = "") -> list:
        """Send `obj` to every client (a list: one each), if given, then
        read each one's next line, which must hold `key`."""
        if obj is not None:
            objs = obj if isinstance(obj, list) else [obj] * len(self.procs)
            for p, o in zip(self.procs, objs):
                self.send(p, o)
        out = []
        for p in self.procs:
            line = p.stdout.readline()
            msg = json.loads(line) if line.strip() else {}
            if key not in msg:
                raise RuntimeError(f"serve client {p.pid} said {line!r}")
            out.append(msg)
        return out

    def close(self) -> None:
        for p in self.procs:
            try:
                p.stdin.close()
            except OSError:
                pass
        for p in self.procs:
            try:
                p.wait(timeout=60)
            except subprocess.TimeoutExpired:
                p.kill()
                p.wait()


def jobs_for(r: Run, port: int, records) -> list:
    sv = r.config["serve"]
    n, n_proc, n_conn = (int(sv["tenants"]), int(r.mix["client_processes"]),
                         int(r.mix["connections"]))
    seeds = [sub_seed(r.seed, f"tenant.{i}") for i in range(n)]
    conns = [seeds[j::n_conn] for j in range(n_conn)]
    arrivals = [sub_seed(r.seed, f"arrivals.{j}") for j in range(n_conn)]
    return [{"root": str(ROOT), "port": port, "records": records,
             "program": sv["program"], "history": int(
                 r.config["history_capacity"]),
             "store": bool(sv["store"]), "ask": int(sv["ask"]),
             "warm_epochs": int(r.mix["warm_epochs"]),
             "asks_per_s": float(r.mix["asks_per_s"]),
             "connections_total": n_conn,
             "connections": conns[p::n_proc],
             "arrival_seeds": arrivals[p::n_proc]} for p in range(n_proc)]


def run(r: Run) -> Outcome:
    from uptune_tpu_torch import obs
    from uptune_tpu_torch.exec.space_io import records_from_space
    from uptune_tpu_torch.serve import SessionServer
    sv = r.config["serve"]
    records = records_from_space(program_space(r.config["space"]))
    work = Path(tempfile.mkdtemp(prefix="portbench-serve-"))
    srv = SessionServer(host="127.0.0.1", port=0,
                        slots=int(sv["tenants"]),
                        max_sessions=int(sv["tenants"]) + 64,
                        store_dir=str(work / "store"), work_dir=str(work),
                        device=r.device).start()
    r.note("server started")
    clients = None
    try:
        clients = Clients(jobs_for(r, srv.port, records))
        clients.each(key="ready")
        r.note("tenants open and warm")
        synchronize(r.device)
        w = devtrace.Window(r.trace)
        r.setup_done()
        w.open(0.0)                     # all of the window: few device ops
        l0 = launches()
        cursor = obs.metrics.window_snapshot()[1]
        t0 = time.monotonic()
        span_t0 = obs.now()
        stopped = clients.each({"t0": t0, "t1": t0 + r.seconds},
                               key="stopped")
        t_end = max(max(s["t_last"] for s in stopped), t0 + 1e-9)
        synchronize(r.device)
        found = sorted({m for s in stopped for m in s["forbidden"]})
        if found:
            raise SystemExit(f"portbench: a serve client loaded {found}, "
                             "which the benchmark must not")
        l1 = launches()
        hist = obs.metrics.window_snapshot(cursor)[0]["hists"].get(
            "serve.ask_ms", {})
        told = sum(s["told"] for s in stopped)
        w.close(told)
        peak = memory_peak(r.device)
        # the window on time.time_ns()'s clock, from its monotonic ends
        to_ns = time.time_ns() - time.monotonic_ns()
        span_origin_ns = time.time_ns() - int(obs.now() * 1e9)
        spans = [devtrace.Span(e["name"],
                               span_origin_ns + int(e["ts"] * 1e9),
                               span_origin_ns + int((e["ts"] + e["dur"])
                                                    * 1e9))
                 for e in obs.snapshot()["events"]
                 if e["dur"] is not None and e["ts"] + e["dur"] >= span_t0
                 and e["name"].startswith("serve.")]
        paths = [work / f"tenants.{i}.json"
                 for i in range(len(clients.procs))]
        clients.each([{"judge": str(p)} for p in paths], key="done")
        tenants = [t for p in paths for t in json.loads(p.read_text())]
    finally:
        if clients is not None:
            clients.close()
        srv.stop()
        shutil.rmtree(work, ignore_errors=True)
    asks = [x for s in stopped for x in s["ask_s"]]
    late = [x for s in stopped for x in s["late_s"]]
    window = t_end - t0
    r.note(f"{len(asks)} asks in the window, offered at "
           f"{r.mix['asks_per_s']}/s; turns started late by p50 "
           f"{stats.percentile(late, 50) * 1e3:.3f} ms, p95 "
           f"{stats.percentile(late, 95) * 1e3:.3f} ms, max "
           f"{max(late) * 1e3:.3f} ms")
    ctx = TraceCtx(w.t0, w.t1, w.units, w.ops, spans,
                   {n: l1[n] - l0[n] for n in l1}, {},
                   {"ask_hist": hist,
                    "ask_p95_ms": stats.percentile(asks, 95) * 1e3,
                    "window": (int(t0 * 1e9) + to_ns,
                               int(t_end * 1e9) + to_ns)})
    # the memo store remembers every tell; without it the tenant's
    # history bounds its dedup
    memory = None if sv["store"] else int(r.config["history_capacity"])
    n = ref_tenants.judge(tenants, r.config["space"], "float64",
                          memory=memory)
    checks = [Check(k, n[k], r.limits[k])
              for k in ("invalid_trials", "repeat_offers", "tells_lost",
                        "empty_asks", "errors", "best_gap")]
    return Outcome({"trials_per_s": stats.rate(told, window)},
                   sum(s["requests"] for s in stopped),
                   sum(s["failed"] for s in stopped), checks, peak, ctx,
                   dict(n, asks=len(asks), told=told, window_s=window,
                        late_p95_s=stats.percentile(late, 95)),
                   lambda: dict(ref_tenants.judge(
                       tenants, r.config["space"], "float64",
                       lower="float32", memory=memory),
                       precision="float32"))
