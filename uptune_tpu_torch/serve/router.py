"""The sharded front tier: `ut-torch route`.

Counterpart of `uptune_tpu/serve/router.py`, op for op and frame for
frame.  One ``SessionServer`` process tops out where Python tops out: a
single interpreter's worth of commit work.  This module scales PAST that
without giving up any of the single-server story — durability, strict
parity, auto-resume — by running K independent `ut-torch serve
--durable` shard processes behind one lightweight **router** process on
the same wire kernel:

* **Routing is consistent hashing by space signature.**  Sessions
  sharing a space signature must land on the SAME shard — that is
  where cross-tenant proposal batching (one ``BatchedEngine`` group)
  and the shared store memo live — so the routing key is the sha1 of
  the open request's canonical space records.  A ``HashRing`` with
  virtual nodes maps key -> shard; adding or removing one shard moves
  only ~1/K of the key space (every other tenant's session placement
  is undisturbed — the property a modulo table lacks).  Keys and
  placements are the JAX package's, bit for bit.
* **The router redirects; it never proxies.**  ``open``/``attach``
  answer with ``{"redirect": "host:port"}`` and the client reconnects
  straight to the owning shard (serve/client.py follows redirects
  transparently).  Steady-state ask/tell traffic therefore never
  crosses the router — it adds one extra round trip per session
  LIFETIME, not per op, and the front tier can be this single thin
  process.  The router imports neither torch nor the engine (on the
  card it imports torch once, to check that there is a card).
* **Shards are supervised.**  Each shard is a child `ut-torch serve
  --durable --device <the router's>` with its OWN checkpoint dir
  (recovery isolation) sharing ONE ``--store-dir`` (the cross-tenant
  memo survives resharding).  On the card each shard is a process with
  its own CUDA context, and each tenant commit there is one launch of
  the merge kernel.  A supervisor thread reaps dead shards and
  respawns them on the SAME port, so the client auto-resume protocol —
  reconnect with backoff, re-attach by durable id, replay the
  idempotent frontier — recovers routed sessions with zero acked
  committed loss and no router cooperation at all.  The
  ``route.spawn``/``route.kill`` fault points (obs/faults.py) make
  shard death deterministic for tests and benchmarks.  A router asked
  for the card checks for one before it spawns anything.
* **Telemetry aggregates through an embedded hub.**  Every shard
  ships its metrics windows and health rollups to a private
  ``TelemetryHub`` inside the router; the router's ``metrics`` /
  ``sources`` / ``health`` ops re-serve the hub's fleet rollup in the
  session-server scrape shape, with the few population gauges
  (``serve.sessions.active``, batch fill) re-aggregated as sums over
  live shards — so ``ut-torch top --addr <router>`` renders the whole
  fleet as one serving plane, and ``--fleet`` lists the per-shard rows.

The supervisor also converges shard count toward ``target`` (the
``scale`` op moves it at runtime): scale-up spawns and ring-joins new
shards; scale-down removes drained shards from the ring first so no
NEW session routes there while existing tenants finish.

The environment a shard inherits is the router's, less the fault
schedule; a ``UT_DEVICE_TRACE=DIR`` capture becomes ``DIR/<shard>`` for
each shard, so that K shards do not overwrite one ``device_trace.json``.
"""
from __future__ import annotations

import bisect
import hashlib
import json
import logging
import os
import signal
import socket
import subprocess
import sys
import threading
import time
from typing import Any, Dict, List, Optional, Tuple

from .. import obs
from ..obs import faults
from ..obs.hub import TelemetryHub
from .wire import RequestError, WireServer

log = logging.getLogger("uptune_tpu_torch")

__all__ = ["HashRing", "Router", "routing_key", "main"]

# how many sid -> shard placements the router remembers (closed
# sessions never report back, so the map is an LRU-ish bound, not a
# registry; an evicted id still attaches via the shard probe)
SESSION_MAP_CAP = 1 << 16


def check_device(device: str) -> None:
    """Raise RuntimeError when `device` names the card and this host has
    none — the check `ut-torch serve` makes before it binds, made here
    before any shard is spawned (a shard that cannot reach the card
    would only exit and be respawned).  The CPU needs no torch import."""
    if str(device).split(":")[0] == "cuda":
        from ..device import resolve_device
        resolve_device(device)


def routing_key(records: Any) -> str:
    """The consistent-hash key for one open request: sha1 over the
    canonical JSON of the declared space records.  Pure function of
    the space a tenant declares — tenants sharing a space signature
    hash identically and land on one shard, where they share a
    BatchedEngine group and a store scope.  The program token is NOT
    part of the key: programs partition the store, not the engine
    group, and keeping same-space programs co-resident preserves the
    cross-program batching the single server had."""
    blob = json.dumps(records, sort_keys=True, separators=(",", ":"))
    return hashlib.sha1(blob.encode()).hexdigest()


class HashRing:
    """Consistent hashing with virtual nodes.  Not thread-safe — the
    router mutates it under its own lock."""

    def __init__(self, replicas: int = 64):
        self.replicas = int(replicas)
        self._hashes: List[int] = []        # sorted vnode hashes
        self._owner: Dict[int, str] = {}    # vnode hash -> node name
        self._nodes: set = set()

    @staticmethod
    def _hash(token: str) -> int:
        return int.from_bytes(
            hashlib.sha1(token.encode()).digest()[:8], "big")

    def add(self, name: str) -> None:
        if name in self._nodes:
            return
        self._nodes.add(name)
        for i in range(self.replicas):
            h = self._hash(f"{name}#{i}")
            # vnode collisions across 64-bit sha1 prefixes are
            # ignorable; last-add-wins keeps the map consistent
            if h not in self._owner:
                bisect.insort(self._hashes, h)
            self._owner[h] = name

    def remove(self, name: str) -> None:
        if name not in self._nodes:
            return
        self._nodes.discard(name)
        for i in range(self.replicas):
            h = self._hash(f"{name}#{i}")
            if self._owner.get(h) == name:
                del self._owner[h]
                idx = bisect.bisect_left(self._hashes, h)
                if idx < len(self._hashes) and self._hashes[idx] == h:
                    self._hashes.pop(idx)

    def lookup(self, key: str) -> Optional[str]:
        """The node owning `key` (clockwise successor of its hash), or
        None on an empty ring."""
        if not self._hashes:
            return None
        h = self._hash(key)
        idx = bisect.bisect_right(self._hashes, h)
        if idx == len(self._hashes):
            idx = 0
        return self._owner[self._hashes[idx]]

    @property
    def nodes(self) -> List[str]:
        return sorted(self._nodes)

    def __len__(self) -> int:
        return len(self._nodes)


class _Shard:
    """One managed shard: its fixed address, its child process (None
    for a statically registered external shard), and its lifecycle
    counters."""

    __slots__ = ("name", "host", "port", "proc", "ckpt_dir",
                 "log_path", "restarts", "draining", "ready",
                 "started_unix")

    def __init__(self, name: str, host: str, port: int):
        self.name = name
        self.host = host
        self.port = int(port)
        self.proc: Optional[subprocess.Popen] = None
        self.ckpt_dir: Optional[str] = None
        self.log_path: Optional[str] = None
        self.restarts = 0
        self.draining = False
        self.ready = False
        self.started_unix = time.time()

    @property
    def addr(self) -> str:
        return f"{self.host}:{self.port}"

    @property
    def alive(self) -> bool:
        return self.proc is not None and self.proc.poll() is None

    @property
    def managed(self) -> bool:
        return self.proc is not None

    def row(self) -> Dict[str, Any]:
        return {"name": self.name, "addr": self.addr,
                "pid": self.proc.pid if self.proc is not None else None,
                "managed": self.managed, "alive": self.alive,
                "ready": self.ready, "draining": self.draining,
                "restarts": self.restarts,
                "uptime_s": round(time.time() - self.started_unix, 3)}


def _probe(host: str, port: int, payload: dict,
           timeout: float = 5.0) -> Optional[dict]:
    """One out-of-band request/response against a shard (readiness
    ping, attach probe).  Returns None on any connection/protocol
    failure — probing a dead shard is an expected, quiet event."""
    try:
        with socket.create_connection((host, port),
                                      timeout=timeout) as s:
            s.settimeout(timeout)
            f = s.makefile("rwb")
            f.write(json.dumps(payload, separators=(",", ":"))
                    .encode() + b"\n")
            f.flush()
            line = f.readline()
        return json.loads(line) if line else None
    except (OSError, ValueError):
        return None


class Router(WireServer):
    """The front-tier process: construct, ``start()`` (spawns and
    ring-joins the initial shards), point clients at ``.port``,
    ``stop()`` (drains the supervisor, then the shards).

    ``shards=0`` starts an empty tier for tests and external
    topologies — ``register()`` ring-joins already-running servers
    the supervisor never touches."""

    WIRE_NAME = "ut-route"
    SUPERVISE_INTERVAL = 1.0
    READY_TIMEOUT = 300.0       # shard cold start: torch import, CUDA init

    def __init__(self, host: str = "127.0.0.1", port: int = 0,
                 shards: int = 2, *, shard_host: str = "127.0.0.1",
                 slots: int = 8, max_sessions: int = 256,
                 store_dir: Optional[str] = None,
                 work_dir: Optional[str] = None,
                 orphan_ttl: Optional[float] = None,
                 supervise_interval: Optional[float] = None,
                 hub_timeline: Optional[str] = None,
                 replicas: int = 64,
                 autoscale: Optional[Tuple[float, float]] = None,
                 autoscale_bounds: Tuple[int, int] = (1, 16),
                 device: str = "cuda"):
        super().__init__(host, port)
        # where the shards' groups live: each shard is `ut-torch serve
        # --device <device>`; the card unless asked (as `serve` does)
        self.device = str(device)
        self.shard_host = str(shard_host)
        self.slots = int(slots)
        self.max_sessions = int(max_sessions)
        self.work_dir = os.path.abspath(work_dir or os.getcwd())
        self.run_dir = os.path.join(self.work_dir, "ut.route")
        self.store_dir = ("off" if store_dir in (None, "", "off")
                          else os.path.abspath(str(store_dir)))
        self.orphan_ttl = orphan_ttl
        self.supervise_interval = float(
            supervise_interval if supervise_interval is not None
            else self.SUPERVISE_INTERVAL)
        # the embedded fleet collector every shard ships to; timeline
        # off by default (the router's view is live, not forensic)
        self.hub = TelemetryHub(host="127.0.0.1", port=0,
                                timeline=hub_timeline)
        self._ring = HashRing(replicas=replicas)
        self._shards: Dict[str, _Shard] = {}
        self._sessions: Dict[str, str] = {}     # sid -> shard name
        self._target = int(shards)
        self._next_idx = 0
        self._spawning = 0      # in-flight spawns (booting, unjoined)
        # load-driven target adjustment off the hub's per-shard
        # gauges: (lo, hi) mean-sessions-per-shard thresholds
        self.autoscale = (None if autoscale is None else
                          (float(autoscale[0]), float(autoscale[1])))
        self.autoscale_bounds = (int(autoscale_bounds[0]),
                                 int(autoscale_bounds[1]))
        self._scale_hold = 0.0  # no-flap cooldown (unix deadline)
        self._sup_stop = threading.Event()
        self._sup_thread: Optional[threading.Thread] = None
        self.kills = 0          # route.kill injections fired

    # -- shard lifecycle -----------------------------------------------
    def _pick_port(self) -> int:
        s = socket.socket()
        s.bind((self.shard_host, 0))
        port = s.getsockname()[1]
        s.close()
        return port

    def _spawn_proc(self, shard: _Shard) -> None:
        """(Re)launch one shard child on its fixed port.  Never called
        under the router lock: Popen and the filesystem touches are
        blocking.  The ``route.spawn`` fault point can delay or fail
        the launch deterministically."""
        faults.fire("route.spawn")
        os.makedirs(shard.ckpt_dir, exist_ok=True)
        cmd = [sys.executable, "-m", "uptune_tpu_torch.cli", "serve",
               "--device", self.device,
               "--host", self.shard_host,
               "--port", str(shard.port),
               "--slots", str(self.slots),
               "--max-sessions", str(self.max_sessions),
               "--store-dir", self.store_dir,
               "--work-dir", self.work_dir,
               "--durable", shard.ckpt_dir,
               "--telemetry", f"127.0.0.1:{self.hub.port}"]
        if self.orphan_ttl is not None:
            cmd += ["--orphan-ttl", str(self.orphan_ttl)]
        # children must NOT inherit the router's fault schedules: an
        # armed route.kill spec would re-arm inside every shard as an
        # unknown-point error at startup.  PYTHONPATH is wired so the
        # `-m uptune_tpu_torch.cli` child imports from a plain checkout
        # or an unpacked archive too (utils/pypath.py)
        from ..utils.pypath import child_pythonpath
        env = {k: v for k, v in os.environ.items()
               if k != faults.ENV_VAR}
        env["PYTHONPATH"] = child_pythonpath()
        # a device-trace capture writes DIR/device_trace.json: one
        # directory a shard, or K shards overwrite one file (a respawn
        # rewrites its shard's, which a SIGKILLed process never wrote)
        dtrace = env.get("UT_DEVICE_TRACE", "").strip()
        if dtrace and dtrace.lower() not in ("0", "off", "false", "none"):
            env["UT_DEVICE_TRACE"] = os.path.join(os.path.abspath(dtrace),
                                                  shard.name)
        lf = open(shard.log_path, "ab")
        try:
            shard.proc = subprocess.Popen(
                cmd, cwd=self.work_dir, env=env, stdout=lf,
                stderr=subprocess.STDOUT)
        finally:
            lf.close()      # the child holds its own fd now
        shard.ready = False
        shard.started_unix = time.time()
        log.info("[ut-route] shard %s -> pid %d on %s", shard.name,
                 shard.proc.pid, shard.addr)

    def _new_shard(self) -> _Shard:
        """Allocate the next shard record (name, fixed port, dirs)
        under the lock, without spawning."""
        with self._lock:
            name = f"s{self._next_idx}"
            self._next_idx += 1
        shard = _Shard(name, self.shard_host, self._pick_port())
        shard.ckpt_dir = os.path.join(self.run_dir, name, "ckpt")
        shard.log_path = os.path.join(self.run_dir, name + ".log")
        return shard

    def _reserve_spawn(self) -> bool:
        """Atomically claim one spawn slot iff the tier (live shards
        PLUS in-flight spawns) is still below target.  A booting
        shard joins ``_shards`` only once ready, so without this
        reservation the supervisor's converge tick and a concurrent
        ``scale`` caller each see "below target" during the boot and
        overshoot together."""
        with self._lock:
            live = sum(1 for sh in self._shards.values()
                       if not sh.draining)
            if live + self._spawning >= self._target:
                return False
            self._spawning += 1
            return True

    def _spawn_shard(self) -> _Shard:
        """Spawn one new shard and ring-join it once it answers ping.
        Blocking (cold start pays the engine import) — callers run on
        the worker pool or the supervisor thread, never the loop, and
        must hold a ``_reserve_spawn()`` slot."""
        try:
            shard = self._new_shard()
            self._spawn_proc(shard)
            self._wait_ready(shard)
            with self._lock:
                self._shards[shard.name] = shard
                self._ring.add(shard.name)
        finally:
            with self._lock:
                self._spawning -= 1
        obs.count("route.spawns")
        return shard

    def _wait_ready(self, shard: _Shard,
                    timeout: Optional[float] = None) -> None:
        deadline = time.time() + (timeout if timeout is not None
                                  else self.READY_TIMEOUT)
        while time.time() < deadline:
            if _probe(shard.host, shard.port, {"op": "ping"},
                      timeout=2.0) is not None:
                shard.ready = True
                return
            if not shard.alive:
                tail = ""
                try:
                    with open(shard.log_path, "rb") as f:
                        tail = f.read()[-2000:].decode("utf-8",
                                                       "replace")
                except OSError:
                    pass
                raise RuntimeError(
                    f"shard {shard.name} died before ready "
                    f"(rc={shard.proc.returncode}): {tail}")
            time.sleep(0.25)
        raise RuntimeError(f"shard {shard.name} never became ready "
                           f"on {shard.addr}")

    def register(self, host: str, port: int,
                 name: Optional[str] = None) -> str:
        """Ring-join an EXTERNAL already-running server the supervisor
        must not manage (tests, pre-spawned topologies).  Returns the
        shard name."""
        with self._lock:
            if name is None:
                name = f"s{self._next_idx}"
                self._next_idx += 1
            shard = _Shard(name, host, port)
            shard.ready = True
            self._shards[name] = shard
            self._ring.add(name)
            # registering grows the tier: without the target bump the
            # supervisor's converge step would immediately drain the
            # shard it was just handed
            self._target = max(
                self._target,
                sum(1 for sh in self._shards.values()
                    if not sh.draining))
        return name

    # -- lifecycle ------------------------------------------------------
    def start(self) -> "Router":
        # no card, no shard: fail before anything binds or spawns
        check_device(self.device)
        os.makedirs(self.run_dir, exist_ok=True)
        self.hub.start()
        super().start()
        # the initial tier comes up before start() returns, so a
        # caller may open sessions immediately (shards booting in
        # parallel would be faster; booting serially keeps a small
        # host from thrashing K cold torch imports and CUDA inits at
        # once)
        while self._reserve_spawn():
            self._spawn_shard()
        self._sup_thread = threading.Thread(
            target=self._supervise, name="ut-route-sup", daemon=True)
        self._sup_thread.start()
        return self

    def stop(self) -> None:
        self._sup_stop.set()
        if self._sup_thread is not None:
            self._sup_thread.join(timeout=self.supervise_interval + 5)
        super().stop()
        with self._lock:
            shards = list(self._shards.values())
        for sh in shards:
            if sh.proc is not None and sh.proc.poll() is None:
                sh.proc.terminate()
        deadline = time.time() + 10
        for sh in shards:
            if sh.proc is None:
                continue
            while sh.proc.poll() is None and time.time() < deadline:
                time.sleep(0.1)
            if sh.proc.poll() is None:
                sh.proc.kill()
                sh.proc.wait()
        self.hub.stop()

    def _listen_banner(self) -> str:
        return (f" (shards={self._target}, hub=127.0.0.1:"
                f"{self.hub.port}, store={self.store_dir})")

    # -- supervisor -----------------------------------------------------
    def _supervise(self) -> None:
        """The control loop: deterministic kill injection, dead-shard
        respawn, target convergence, fleet-health gauges.  One tick
        must never die — a supervisor that exits silently turns every
        future shard death into a permanent outage."""
        while not self._sup_stop.wait(self.supervise_interval):
            try:
                self._tick()
            except Exception:
                log.exception("[ut-route] supervisor tick failed")

    def _tick(self) -> None:
        # 1) fault injection: `route.kill` armed with `error` makes
        # THIS tick SIGKILL the lowest-index live shard — the
        # deterministic stand-in for a shard host dying mid-drive
        try:
            faults.fire("route.kill")
        except faults.FaultInjected:
            self._kill_one()
        with self._lock:
            shards = list(self._shards.values())
            target = self._target
        # 2) reap + respawn: a dead managed shard comes back on the
        # SAME port with the SAME checkpoint dir, so `ut-torch serve
        # --durable` recovery replays its sessions and resuming
        # clients reconnect to the address they already hold
        for sh in shards:
            if sh.managed and not sh.alive and not sh.draining:
                rc = sh.proc.returncode
                sh.restarts += 1
                log.warning("[ut-route] shard %s died (rc=%s); "
                            "respawning on %s (restart #%d)",
                            sh.name, rc, sh.addr, sh.restarts)
                obs.count("route.restarts")
                self._spawn_proc(sh)
            elif sh.managed and sh.alive and not sh.ready:
                if _probe(sh.host, sh.port, {"op": "ping"},
                          timeout=2.0) is not None:
                    sh.ready = True
                    log.info("[ut-route] shard %s ready on %s",
                             sh.name, sh.addr)
        # 3) converge toward target: spawn up, drain down (drained
        # shards leave the ring immediately — no NEW session routes
        # there — and keep serving their existing tenants)
        live = [sh for sh in shards if not sh.draining]
        if len(live) < target:
            if self._reserve_spawn():
                self._spawn_shard()
        elif len(live) > target:
            victim = max(live, key=lambda sh: sh.name)
            with self._lock:
                victim.draining = True
                self._ring.remove(victim.name)
            log.info("[ut-route] draining shard %s (target %d)",
                     victim.name, target)
        # 4) load-driven autoscaling (opt-in): the hub's per-shard
        # session gauges move the target inside the configured
        # bounds — spawn when the tier runs hot, drain when idle
        if self.autoscale is not None:
            self._autoscale()
        # 5) fleet gauges off the hub rollup (worst-first health is
        # one `health` op away for operators; the gauge is the cheap
        # always-on signal)
        with self._lock:
            n_live = sum(1 for sh in self._shards.values()
                         if not sh.draining)
        obs.gauge("route.shards", n_live)

    def _autoscale(self) -> None:
        """One autoscale decision off the hub's live rollup: mean
        sessions per live shard above `hi` raises the target by one,
        below `lo` lowers it by one (the converge step does the
        actual spawn/drain).  A cooldown of a few supervisor ticks
        lets each adjustment settle — the new shard must boot and
        take load — before the next, so the tier cannot flap."""
        lo, hi = self.autoscale
        if time.time() < self._scale_hold:
            return
        sess = self.hub.gauge_values("serve.sessions.active")
        if not sess:
            return
        with self._lock:
            n_live = sum(1 for sh in self._shards.values()
                         if not sh.draining)
            target = self._target
        if not n_live:
            return
        mean = sum(sess) / n_live
        nmin, nmax = self.autoscale_bounds
        new = target
        if mean > hi and target < nmax:
            new = target + 1
        elif mean < lo and target > nmin:
            new = target - 1
        if new == target:
            return
        with self._lock:
            self._target = new
        self._scale_hold = time.time() + 5 * self.supervise_interval
        obs.count("route.autoscale.up" if new > target
                  else "route.autoscale.down")
        log.info("[ut-route] autoscale: mean %.1f sessions/shard "
                 "(lo=%g, hi=%g) -> target %d", mean, lo, hi, new)

    def _kill_one(self) -> None:
        """SIGKILL the lowest-index live managed shard (the
        deterministic route.kill action)."""
        with self._lock:
            victims = sorted(
                (sh for sh in self._shards.values()
                 if sh.managed and sh.alive and not sh.draining),
                key=lambda sh: int(sh.name.lstrip("s") or 0))
        if not victims:
            return
        sh = victims[0]
        self.kills += 1
        obs.count("route.kills")
        log.warning("[ut-route] route.kill: SIGKILL shard %s "
                    "(pid %d)", sh.name, sh.proc.pid)
        try:
            sh.proc.send_signal(signal.SIGKILL)
        except OSError:
            pass

    # -- routing --------------------------------------------------------
    def _shard_for_key(self, key: str) -> _Shard:
        with self._lock:
            name = self._ring.lookup(key)
            shard = self._shards.get(name) if name else None
        if shard is None:
            raise RequestError("no shards available")
        return shard

    def _remember(self, sid: str, shard_name: str) -> None:
        with self._lock:
            self._sessions[sid] = shard_name
            while len(self._sessions) > SESSION_MAP_CAP:
                self._sessions.pop(next(iter(self._sessions)))

    # -- ops ------------------------------------------------------------
    def _op_ping(self, req: dict) -> dict:
        with self._lock:
            n = sum(1 for sh in self._shards.values()
                    if not sh.draining)
            mapped = len(self._sessions)
        return {"t": time.time(), "role": "router", "shards": n,
                "sessions": mapped}

    def _op_open(self, req: dict) -> dict:
        """Route one open: hash the declared space records onto the
        ring and redirect the client to the owning shard.  The shard
        itself validates the space and runs admission — the router
        only needs the records' bytes, so it never imports the
        engine."""
        records = req.get("space")
        if not isinstance(records, list) or not records:
            raise RequestError("open needs 'space': a non-empty list "
                               "of param records")
        key = routing_key(records)
        shard = self._shard_for_key(key)
        sid = req.get("session")
        if isinstance(sid, str) and sid:
            # a client-minted durable id (the auto-resume protocol):
            # remember its placement so a later attach through the
            # router skips the probe
            self._remember(sid, shard.name)
        obs.count("route.opens")
        return {"redirect": shard.addr, "shard": shard.name,
                "key": key[:12]}

    def _op_attach(self, req: dict) -> dict:
        """Route a re-attach: known ids redirect straight to their
        recorded shard; unknown ids (router restarted, map evicted)
        are found by probing each live shard's session registry —
        durable sessions survive ROUTER death too, not just shard
        death."""
        sid = req.get("session")
        if not isinstance(sid, str) or not sid:
            raise RequestError("attach needs 'session': a durable "
                               "session id")
        with self._lock:
            name = self._sessions.get(sid)
            shard = self._shards.get(name) if name else None
            candidates = [sh for sh in self._shards.values()
                          if sh.ready]
        if shard is None:
            for sh in candidates:
                resp = _probe(sh.host, sh.port,
                              {"op": "stats", "sessions": True})
                if resp and sid in (resp.get("session_ids") or ()):
                    shard = sh
                    self._remember(sid, sh.name)
                    break
        if shard is None:
            raise RequestError(f"unknown session: {sid}")
        obs.count("route.attaches")
        return {"redirect": shard.addr, "shard": shard.name}

    def _op_route(self, req: dict) -> dict:
        """Pure lookup (diagnostics, tests): key -> owning shard."""
        key = req.get("key")
        if not isinstance(key, str) or not key:
            records = req.get("space")
            if not isinstance(records, list) or not records:
                raise RequestError("route needs 'key' or 'space'")
            key = routing_key(records)
        shard = self._shard_for_key(key)
        return {"shard": shard.name, "addr": shard.addr,
                "key": key[:12]}

    # one resolve's fan-out bound: the request side is capped by the
    # wire max_line, but k tiny keys resolve to k shard rows
    MAX_RESOLVE = 1024

    def _op_resolve(self, req: dict) -> dict:
        """Multi-signature resolve: many space-record
        lists (``spaces``) or precomputed routing keys (``keys``) to
        their owning shards in ONE round trip — a client opening many
        sessions against the sharded tier maps them all first instead
        of paying one redirect RTT per open.  Element-wise error
        walls: one malformed entry yields an error ROW, the rest
        still resolve."""
        spaces = req.get("spaces")
        keys = req.get("keys")
        if spaces is not None:
            if not isinstance(spaces, list):
                raise RequestError("'spaces' must be a list of space "
                                   "record lists")
            entries: List[Any] = spaces
            use_keys = False
        elif keys is not None:
            if not isinstance(keys, list):
                raise RequestError("'keys' must be a list of routing "
                                   "keys")
            entries = keys
            use_keys = True
        else:
            raise RequestError("resolve needs 'spaces' or 'keys'")
        if len(entries) > self.MAX_RESOLVE:
            raise RequestError(
                f"resolve carries {len(entries)} entries; capped at "
                f"{self.MAX_RESOLVE}")
        rows: List[Dict[str, Any]] = []
        for ent in entries:
            try:
                if use_keys:
                    if not isinstance(ent, str) or not ent:
                        raise RequestError(
                            "routing key must be a non-empty string")
                    key = ent
                else:
                    if not isinstance(ent, list) or not ent:
                        raise RequestError(
                            "space records must be a non-empty list")
                    key = routing_key(ent)
                shard = self._shard_for_key(key)
                rows.append({"shard": shard.name, "addr": shard.addr,
                             "key": key[:12]})
            except RequestError as e:
                rows.append({"error": str(e)})
        obs.count("route.resolves", len(rows))
        return {"resolved": rows}

    def _op_shards(self, req: dict) -> dict:
        with self._lock:
            rows = [sh.row() for sh in self._shards.values()]
            target = self._target
        rows.sort(key=lambda r: r["name"])
        return {"target": target, "shards": rows}

    def _op_scale(self, req: dict) -> dict:
        """Move the shard target.  Scale-up spawns synchronously (the
        caller wants capacity NOW and runs on the worker pool);
        scale-down is handed to the supervisor, one drain per tick."""
        try:
            target = int(req["shards"])
        except (KeyError, TypeError, ValueError) as e:
            raise RequestError(f"scale needs 'shards': an int ({e})")
        if not 0 <= target <= 64:
            raise RequestError(f"shards must be in [0, 64]: {target}")
        with self._lock:
            self._target = target
        spawned = []
        while self._reserve_spawn():
            spawned.append(self._spawn_shard().name)
        # a concurrent supervisor tick may hold some of the spawns:
        # wait until the RING reaches target (scale-up is "capacity
        # now" — the caller must be able to route to K shards when
        # this returns), bounded by the cold-start budget
        deadline = time.time() + self.READY_TIMEOUT
        while True:
            with self._lock:
                live = sum(1 for sh in self._shards.values()
                           if not sh.draining)
            if live >= target:
                break
            if time.time() > deadline:
                raise RequestError(
                    f"scale to {target} timed out at {live} live "
                    f"shard(s)")
            time.sleep(0.1)
        return {"target": target, "live": live, "spawned": spawned}

    def _op_metrics(self, req: dict) -> dict:
        """The fleet scrape, `ut top --addr <router>` shaped: the
        hub's rollup with the per-process population gauges
        re-aggregated as SUMS over live shards (last-write-wins is
        wrong for ``serve.sessions.active`` — five shards serving 40
        tenants each is 200 sessions, not 40)."""
        out = self.hub._op_metrics({})
        gauges = out["metrics"].setdefault("gauges", {})
        sess = self.hub.gauge_values("serve.sessions.active")
        if sess:
            gauges["serve.sessions.active"] = float(sum(sess))
        fills = self.hub.gauge_values("serve.batch_fill")
        if fills:
            gauges["serve.batch_fill"] = float(
                sum(fills) / len(fills))
        with self._lock:
            n_live = sum(1 for sh in self._shards.values()
                         if not sh.draining)
        out["sessions"] = int(sum(sess)) if sess else 0
        out["shards"] = n_live
        out["uptime_s"] = round(time.time() - self.started_unix, 3)
        return out

    def _op_sources(self, req: dict) -> dict:
        """The hub's per-source rows, annotated with the owning shard
        name by pid (`ut top --fleet` renders one row per shard)."""
        out = self.hub._op_sources(req)
        with self._lock:
            by_pid = {str(sh.proc.pid): sh.name
                      for sh in self._shards.values()
                      if sh.proc is not None}
        for row in out.get("rows", ()):
            name = by_pid.get(str(row.get("pid")))
            if name:
                row["shard"] = name
        return out

    def _op_health(self, req: dict) -> dict:
        """Worst-first fleet health: the hub's source verdicts plus
        the supervisor's shard liveness rows."""
        out = self.hub._op_health(req)
        with self._lock:
            rows = [sh.row() for sh in self._shards.values()]
        rows.sort(key=lambda r: r["name"])
        out["shards"] = rows
        return out

    def _op_stats(self, req: dict) -> dict:
        with self._lock:
            rows = [sh.row() for sh in self._shards.values()]
            mapped = len(self._sessions)
            target = self._target
        rows.sort(key=lambda r: r["name"])
        return {"shards": rows, "target": target,
                "sessions_mapped": mapped, "kills": self.kills,
                "restarts": sum(r["restarts"] for r in rows),
                "hub": self.hub._op_stats({})}

    _OPS = {"ping": _op_ping, "open": _op_open, "attach": _op_attach,
            "route": _op_route, "resolve": _op_resolve,
            "shards": _op_shards,
            "scale": _op_scale, "metrics": _op_metrics,
            "sources": _op_sources, "health": _op_health,
            "stats": _op_stats}


# ------------------------------------------------------------------ CLI
def build_parser():
    import argparse
    p = argparse.ArgumentParser(
        prog="ut-torch route",
        description="uptune-tpu (PyTorch port) sharded front tier: "
                    "consistent-hash session router over K `ut-torch "
                    "serve --durable` shards")
    p.add_argument("--host", default="127.0.0.1",
                   help="router bind address")
    p.add_argument("--port", type=int, default=8777,
                   help="router TCP port; 0 picks an ephemeral port")
    p.add_argument("--shards", type=int, default=2, metavar="K",
                   help="initial shard-process count (the `scale` op "
                        "moves it at runtime)")
    p.add_argument("--shard-host", default="127.0.0.1",
                   help="bind address for shard children")
    p.add_argument("--slots", type=int, default=8,
                   help="per-shard engine-group slot width")
    p.add_argument("--max-sessions", type=int, default=256,
                   help="per-shard admission limit")
    p.add_argument("--store-dir", default=None, metavar="DIR",
                   help="SHARED cross-tenant result memo all shards "
                        "mount; 'off'/unset disables")
    p.add_argument("--work-dir", default=None,
                   help="base dir for shard state (ut.route/ holds "
                        "per-shard checkpoint dirs and logs)")
    p.add_argument("--orphan-ttl", type=float, default=None,
                   metavar="SECONDS",
                   help="per-shard disconnected-tenant grace "
                        "(ut-torch serve --orphan-ttl)")
    p.add_argument("--supervise-interval", type=float, default=None,
                   metavar="SECONDS",
                   help="supervisor tick cadence (default 1.0)")
    p.add_argument("--hub-timeline", default=None, metavar="OUT.jsonl",
                   help="persist the embedded hub's fleet timeline "
                        "(default: off)")
    p.add_argument("--autoscale", default=None, metavar="LO:HI",
                   help="load-driven shard autoscaling: when mean "
                        "sessions per live shard (embedded-hub "
                        "serve.sessions.active gauges) exceeds HI the "
                        "supervisor spawns a shard, below LO it "
                        "drains one (default: off; static target)")
    p.add_argument("--autoscale-max", type=int, default=16, metavar="N",
                   help="upper shard-count bound for --autoscale")
    p.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                   help="where the shards' groups live (each shard is "
                        "`ut-torch serve --device DEVICE`; default: the "
                        "card, and a host without one exits 1 before a "
                        "shard is spawned unless given cpu)")
    p.add_argument("-v", "--verbose", action="store_true")
    return p


def main(argv: Optional[List[str]] = None) -> int:
    args = build_parser().parse_args(argv)
    logging.basicConfig(
        level=logging.DEBUG if args.verbose else logging.INFO,
        format="[%(relativeCreated)7.0fms] %(levelname)s %(message)s")
    # no card, no shard: fail before anything binds or spawns
    try:
        check_device(args.device)
    except RuntimeError as e:
        log.error("[ut-route] %s (pass --device cpu)", e)
        return 1
    # SIGTERM stops the router as ^C does: serve_forever unwinds into
    # stop(), which terminates the shards (none is left orphaned)
    def _terminate(signum, frame):
        raise KeyboardInterrupt
    signal.signal(signal.SIGTERM, _terminate)
    # UT_FAULTS (obs/faults.py): route.kill / route.spawn schedules
    # for sharded failover tests — never a production mode
    n_faults = faults.maybe_arm_from_env()
    if n_faults:
        log.warning("[ut-route] %d fault-injection rule(s) ARMED via "
                    "UT_FAULTS: %s", n_faults, faults.schedules())
    autoscale = None
    if args.autoscale:
        try:
            lo_s, hi_s = args.autoscale.split(":", 1)
            autoscale = (float(lo_s), float(hi_s))
            if not autoscale[0] < autoscale[1]:
                raise ValueError
        except ValueError:
            build_parser().error(
                "--autoscale wants LO:HI with LO < HI, got %r"
                % args.autoscale)
    r = Router(host=args.host, port=args.port, shards=args.shards,
               shard_host=args.shard_host, slots=args.slots,
               max_sessions=args.max_sessions,
               store_dir=args.store_dir, work_dir=args.work_dir,
               orphan_ttl=args.orphan_ttl,
               supervise_interval=args.supervise_interval,
               hub_timeline=args.hub_timeline,
               autoscale=autoscale,
               autoscale_bounds=(1, args.autoscale_max),
               device=args.device)
    r.serve_forever()
    return 0


if __name__ == "__main__":
    sys.exit(main())
