"""Python client for the session server: ``ut.connect()``.

    import uptune_tpu_torch as ut
    from uptune_tpu_torch.workloads import rosenbrock_space

    client = ut.connect("127.0.0.1:8765")
    s = client.open_session(rosenbrock_space(2, -3, 3), seed=7,
                            program="rosen-demo")
    for _ in range(200):
        for t in s.ask(4):
            s.tell(t.ticket, measure(t.config))
    print(s.best())
    s.close(); client.close()

Counterpart of `uptune_tpu/serve/client.py`: the frames are the JAX
package's, so either package's client talks to either package's server.
Like the JAX client it imports neither torch nor numpy (a tenant process
stays light).  One ``SessionClient`` is one TCP connection; it may multiplex ANY
number of sessions (requests are synchronous per connection and
serialized by an internal lock — open several clients for parallel
request streams).  Spaces are sent as JSON param records; a library
``Space`` is serialized via ``exec.space_io.records_from_space``.

Auto-resume (docs/SERVING.md "Durability & failover"):
``connect(addr, auto_resume=True)`` makes the connection crash-safe
against both transient network failures and full server restarts.
Every op gets a bounded socket timeout; on a connection failure the
client reconnects with exponential backoff plus jitter, re-attaches
each of its sessions by durable id, and replays only the idempotent
frontier:

* ``open`` carries a client-minted session id, so a retried open
  whose ack was lost re-attaches instead of leaking a session;
* a retried ``ask`` carries ``reissue``, so tickets the lost reply
  already handed out are re-offered rather than stranded;
* ``tell`` carries the ticket's epoch id and the session's
  incarnation token, so a duplicate replay after an
  acked-but-unobserved reply is detected and squashed server-side.

The one failure auto-resume surfaces instead of hiding: a ticket
from an in-flight epoch a server CRASH destroyed (the bounded-loss
contract) fails with a "restored" ServeError — re-``ask()`` and
retry with the fresh tickets.

Batched wire plane: ``SessionClient.batch(payloads)``
sends one multi-op frame (one round trip, ordered reply list,
per-sub-op error ENTRIES); ``ask_many``/``tell_many`` drive many
sessions' hot ops through one frame.  A torn frame replays whole
under auto-resume — every sub-op carries the resume protocol's
idempotency tags (replayed asks gain ``reissue``), so the replay is
idempotent by construction.  Down-level servers are sniffed from the
unknown-op error reply once (one loud log) and the client falls back
to sequential requests / the legacy ``tell``+``results`` spelling.
"""
from __future__ import annotations

import json
import logging
import socket
import threading
import time
import uuid
from typing import (Any, Dict, Iterable, List, NamedTuple, Optional,
                    Sequence, Tuple, Union)

from .. import obs
from ..obs.ship import backoff_jitter
from ..utils.net import reject_self_connect

log = logging.getLogger("uptune_tpu_torch")

# one reusable encoder for every request this process writes (the
# serve/wire reply-side twin): json.dumps re-resolves its options on
# every call, measurable at batched-frame request rates
_ENC = json.JSONEncoder(separators=(",", ":"),
                        check_circular=False).encode


class ServeError(RuntimeError):
    """The server answered ok=False."""


class ConnectionLostError(ServeError):
    """The connection died mid-exchange (closed, timed out, or
    desynced) — the retryable class auto-resume acts on."""


class Trial(NamedTuple):
    """One proposed trial: measure `config`, tell `ticket`.  `epoch`
    is the ticket's session-version tag, echoed on tell so resume
    replays are idempotent."""
    ticket: int
    config: Dict[str, Any]
    epoch: int = 0


def _parse_addr(addr: Union[str, tuple, None]) -> tuple:
    from ..api.session import settings
    if addr is None:
        return (str(settings["serve-host"]), int(settings["serve-port"]))
    if isinstance(addr, (tuple, list)):
        return (str(addr[0]), int(addr[1]))
    host, _, port = str(addr).rpartition(":")
    if not host:
        raise ValueError(f"address must be 'host:port', got {addr!r}")
    return (host, int(port))


def _mark_reissue(payload: Dict[str, Any]) -> None:
    """Stamp a replayed request's ask(s) with ``reissue`` so tickets
    the lost reply already handed out are re-offered, never re-minted
    — for a batch frame, every ask sub-op is stamped (the torn-frame
    replay is idempotent by construction: tells carry epoch+incarn
    tags, asks reissue, and everything else is naturally replayable)."""
    if payload.get("op") == "ask":
        payload["reissue"] = True
    elif payload.get("op") == "batch":
        for sub in payload.get("ops") or ():
            if isinstance(sub, dict) and sub.get("op") == "ask":
                sub["reissue"] = True


def connect(addr: Union[str, tuple, None] = None,
            timeout: float = 60.0, **kw: Any) -> "SessionClient":
    """Open a client connection (`addr` = "host:port", a (host, port)
    pair, or None for the configured serve-host/serve-port).  Keyword
    arguments (`auto_resume`, `op_timeout`, `max_retries`, ...) pass
    through to SessionClient."""
    host, port = _parse_addr(addr)
    return SessionClient(host, port, timeout=timeout, **kw)


class SessionClient:
    # bound on {"redirect": ...} hops one request may follow — a
    # misconfigured router pair bouncing a key between themselves
    # must surface as an error, not an infinite reconnect loop
    MAX_REDIRECTS = 4

    def __init__(self, host: str, port: int, timeout: float = 60.0,
                 *, op_timeout: Optional[float] = None,
                 auto_resume: bool = False, max_retries: int = 8,
                 backoff_base: float = 0.25, backoff_max: float = 5.0):
        self.host, self.port = host, int(port)
        self.connect_timeout = float(timeout)
        # bounded per-op timeout: defaults to the connect timeout so
        # no request can hang forever (the earlier behavior kept
        # the connect timeout on the socket; this makes it explicit
        # and independently tunable)
        self.op_timeout = float(op_timeout if op_timeout is not None
                                else timeout)
        self.auto_resume = bool(auto_resume)
        self.max_retries = int(max_retries)
        self.backoff_base = float(backoff_base)
        self.backoff_max = float(backoff_max)
        self._lock = threading.Lock()
        # serializes the reconnect+reattach sequence across threads
        # sharing this client (a separate lock: _reattach exchanges
        # under _lock, so holding _lock across it would deadlock)
        self._resume_lock = threading.Lock()
        self._broken = False
        self._sock: Optional[socket.socket] = None
        self._f = None
        # durable session ids this client opened (or attached), in
        # open order — re-attached after every reconnect so the new
        # connection owns them server-side
        self._resume_ids: List[str] = []
        self.reconnects = 0
        # down-level server sniffing: None = unknown,
        # True = the server speaks it, False = fell back (one loud
        # log at the flip, then quiet sequential/legacy compat)
        self._batch_ok: Optional[bool] = None
        self._tell_many_ok: Optional[bool] = None
        # redirect hops followed (the sharded front tier):
        # a router answers open/attach with {"redirect": "host:port"}
        # and the client re-homes the whole connection onto the
        # owning shard — steady-state ask/tell never crosses the
        # router again
        self.redirects = 0
        self._connect()

    # -- wire ----------------------------------------------------------
    def _connect(self) -> None:
        s = socket.create_connection((self.host, self.port),
                                     timeout=self.connect_timeout)
        reject_self_connect(s, f"{self.host}:{self.port}")
        s.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        s.settimeout(self.op_timeout)
        self._sock = s
        self._f = s.makefile("rwb")
        self._broken = False

    def _drop_conn(self) -> None:
        try:
            if self._f is not None:
                self._f.close()
            if self._sock is not None:
                self._sock.close()
        except OSError:
            pass
        self._f = None
        self._sock = None
        self._broken = True

    def _exchange(self, payload: Dict[str, Any]) -> Dict[str, Any]:
        """One synchronous request/response on the current connection;
        raises ConnectionLostError when the exchange cannot complete
        (and marks the connection broken: a died-mid-exchange reply
        may still be in flight, and the NEXT request would silently
        consume it as its own — the stream is desynced).

        Trace-context propagation (docs/OBSERVABILITY.md): when THIS
        process is tracing, the request carries a ``ctx`` span id and
        the round trip is recorded as a ``client.request`` span tagged
        with it; the server's matching ``serve.handle`` span carries
        the same id as ``parent``, so `ut-trace merge` joins the two
        shards and decomposes client-observed latency into wire vs
        server time.  Untraced clients send no extra field."""
        sid = None
        t0 = 0.0
        if obs.enabled():
            sid = obs.new_span_id()
            payload = {**payload, "ctx": {"span": sid}}
            t0 = time.perf_counter()
        with self._lock:
            if self._broken or self._f is None:
                raise ConnectionLostError(
                    "connection desynced by an interrupted request; "
                    "reconnect")
            try:
                self._f.write(_ENC(payload).encode() + b"\n")
                self._f.flush()
                line = self._f.readline()
            except BaseException as e:
                self._broken = True
                if isinstance(e, (OSError, ValueError)):
                    raise ConnectionLostError(
                        f"request {payload.get('op')!r} died "
                        f"mid-exchange: {e}") from e
                raise
        if sid is not None:
            obs.complete_span("client.request", t0=t0,
                              dur=time.perf_counter() - t0,
                              op=payload.get("op"), ctx=sid,
                              server=f"{self.host}:{self.port}")
        if not line:
            self._broken = True
            raise ConnectionLostError(
                f"server {self.host}:{self.port} closed the "
                f"connection")
        try:
            resp = json.loads(line)
        except ValueError as e:
            # a server dying mid-reply flushes a PARTIAL line; the
            # EOF readline returns it non-empty, so this is the same
            # connection-loss case as the empty read — it must reach
            # the resume machinery, not the caller
            self._broken = True
            raise ConnectionLostError(
                f"truncated reply from {self.host}:{self.port}: {e}"
            ) from e
        if not resp.get("ok"):
            raise ServeError(resp.get("error", "unknown server error"))
        return resp

    def _reattach(self) -> None:
        """Re-own this client's sessions on a fresh connection.  A
        session the server no longer knows (closed, orphan-swept, or
        unrecoverable) is PRUNED and the rest still attach — one dead
        session must not fail unrelated handles' ops on every
        reconnect, or leave a live sibling un-attached with its
        server-side orphan clock running.  The dead session surfaces
        naturally: its own handle's next op gets 'unknown session'.
        Connection-level failures still raise (the retry loop's
        business)."""
        for sid in list(self._resume_ids):
            try:
                self._exchange({"op": "attach", "session": sid})
            except ConnectionLostError:
                raise
            except ServeError:
                self._forget(sid)

    def request(self, op: str, **fields: Any) -> Dict[str, Any]:
        """One synchronous request/response; raises ServeError on
        ok=False.  With ``auto_resume``, connection failures
        reconnect with exponential backoff+jitter, re-attach every
        session this client owns, and replay the request with its
        idempotency tags (a replayed ``ask`` adds ``reissue`` so
        already-issued tickets are re-offered, never re-minted).

        A reply carrying ``redirect: "host:port"`` (the sharded front
        tier's open/attach answer) re-homes this client: the
        connection moves to the owning shard and the request is
        re-sent there, bounded by ``MAX_REDIRECTS`` hops.  Because
        ``self.host``/``self.port`` move too, every later reconnect —
        including auto-resume after a shard death — targets the shard
        directly, never the router."""
        payload = {"op": op, **{k: v for k, v in fields.items()
                                if v is not None}}
        attempt = 0
        hops = 0
        backoff = self.backoff_base
        while True:
            try:
                if self._broken or self._f is None:
                    if not self.auto_resume and hops == 0:
                        raise ConnectionLostError(
                            "connection desynced by an interrupted "
                            "request; reconnect")
                    # one thread reconnects; peers that also observed
                    # the break queue here and RE-CHECK — without the
                    # serialization, each thread's _drop_conn would
                    # keep closing the connection a peer just rebuilt
                    # and mutual interference could burn max_retries
                    # against a perfectly healthy server
                    with self._resume_lock:
                        if self._broken or self._f is None:
                            self._drop_conn()
                            self._connect()
                            self.reconnects += 1
                            self._reattach()
                    _mark_reissue(payload)
                resp = self._exchange(payload)
                target = resp.get("redirect")
                if isinstance(target, str) and target:
                    if hops >= self.MAX_REDIRECTS:
                        raise ServeError(
                            f"redirect limit ({self.MAX_REDIRECTS}) "
                            f"exceeded following {target!r}")
                    hops += 1
                    self.redirects += 1
                    host, _, port = target.rpartition(":")
                    self.host, self.port = (host or self.host,
                                            int(port))
                    # drop the old connection; the reconnect branch
                    # above re-dials the NEW address (and re-attaches
                    # any sessions this client already owns there)
                    with self._lock:
                        self._drop_conn()
                    continue
                return resp
            except (ConnectionLostError, OSError) as e:
                attempt += 1
                self._broken = True
                if not self.auto_resume or attempt > self.max_retries:
                    raise
                # jittered exponential backoff (the shipper's rule:
                # a fleet of resuming clients must not stampede the
                # restarted server in lockstep)
                time.sleep(backoff_jitter(backoff))
                backoff = min(self.backoff_max, backoff * 2)

    # -- batched wire plane ---------------------------------
    def _note_downlevel(self, what: str) -> None:
        """One loud log the first time a down-level server is sniffed;
        the compat fallback stays quiet after that."""
        log.warning(
            "[ut-client] server %s:%d does not speak %r (pre-batched "
            "wire plane); falling back to the legacy spelling for "
            "this connection", self.host, self.port, what)

    def batch(self, payloads: Sequence[Dict[str, Any]]
              ) -> List[Dict[str, Any]]:
        """Send many requests as ONE multi-op frame: one round trip,
        one ordered reply list.  Each payload is a full request dict
        (``{"op": ..., ...}``); each reply is that sub-op's full
        response — per-sub-op failures come back as ``ok=False``
        ENTRIES, never raised, so one bad sub-op cannot discard its
        siblings' results.  Frame-level failures raise ServeError.

        Under auto-resume a torn frame replays whole (see
        _mark_reissue — idempotent by construction).  A server
        without the batch op is sniffed from its unknown-op reply
        (once, loudly) and the frame degrades to sequential requests.

        Note: ``open``/``attach`` sub-ops are not registered for
        auto-reattach — use ``open_session``/``attach_session`` for
        sessions that must survive reconnects."""
        if self._batch_ok is False:
            return self._batch_fallback(payloads)
        ops = [dict(p) for p in payloads]
        try:
            resp = self.request("batch", ops=ops)
        except ServeError as e:
            if (self._batch_ok is None
                    and "unknown op" in str(e)):
                self._batch_ok = False
                self._note_downlevel("batch")
                return self._batch_fallback(payloads)
            raise
        self._batch_ok = True
        replies = resp.get("replies")
        if not isinstance(replies, list) or len(replies) != len(ops):
            raise ServeError(
                f"batch reply carries {len(replies or ())} replies "
                f"for {len(ops)} ops")
        return replies

    def _batch_fallback(self, payloads: Sequence[Dict[str, Any]]
                        ) -> List[Dict[str, Any]]:
        """The down-level degradation: one request per payload,
        errors folded into ok=False entries (the frame's element-wise
        contract, minus the single round trip)."""
        out: List[Dict[str, Any]] = []
        for p in payloads:
            op = p.get("op")
            fields = {k: v for k, v in p.items() if k != "op"}
            if op == "tell_many" and self._tell_many_ok is False:
                # the server is already known down-level: go straight
                # to the legacy tell+results spelling (same fields)
                op = "tell"
            try:
                out.append(self.request(op, **fields))
                continue
            except ServeError as e:
                if (op == "tell_many" and self._tell_many_ok is not
                        False and "unknown op" in str(e)):
                    self._tell_many_ok = False
                    self._note_downlevel("tell_many")
                    try:
                        out.append(self.request("tell", **fields))
                        continue
                    except ServeError as e2:
                        e = e2
                out.append({"ok": False, "error": str(e)})
        return out

    def ask_many(self, handles: Sequence["SessionHandle"],
                 n: int = 1) -> List[List["Trial"]]:
        """One batched ask across many sessions: a single width-k
        frame replaces k round trips (the per-shard ceiling lever
        the serving plane's batched-wire measurement prices).  Returns each
        handle's trials in order; a failed sub-ask raises."""
        replies = self.batch([{"op": "ask", "session": h.id,
                               "n": int(n)} for h in handles])
        out = []
        for h, r in zip(handles, replies):
            if not r.get("ok"):
                raise ServeError(r.get("error",
                                       "unknown server error"))
            out.append(h._absorb_ask(r))
        return out

    def tell_many(self, batches: Sequence[
            Tuple["SessionHandle", Iterable[Tuple[int, Any]]]]
                  ) -> List[Dict[str, Any]]:
        """One batched tell across many sessions: each (handle,
        results) pair becomes one vectorized ``tell_many`` sub-op —
        one frame, one reply per session, every tell acked behind its
        session's single durable drain.  A failed sub-op raises;
        per-TICKET failures stay element-wise inside each reply's
        ``errors`` list."""
        payloads, hs, tks = [], [], []
        for h, results in batches:
            rows = h._tell_rows(results)
            payloads.append({"op": "tell_many", "session": h.id,
                             "results": rows, "incarn": h.incarn})
            hs.append(h)
            tks.append([r["ticket"] for r in rows])
        replies = self.batch(payloads)
        out = []
        for h, tickets, r in zip(hs, tks, replies):
            if not r.get("ok"):
                raise ServeError(r.get("error",
                                       "unknown server error"))
            h._after_tell(r, tickets)
            out.append(r)
        return out

    def resolve(self, spaces: Sequence[Any]) -> List[Dict[str, Any]]:
        """Against a router: map many spaces to their owning shards
        in ONE round trip (each entry a Space or a list of param
        records) — open each session directly against its shard
        afterwards instead of paying a redirect hop per open.
        Returns one ``{"shard", "addr", "key"}`` row per entry
        (``{"error"}`` rows element-wise)."""
        from ..exec.space_io import records_from_space
        recs = [list(s) if isinstance(s, (list, tuple))
                else records_from_space(s) for s in spaces]
        return self.request("resolve", spaces=recs)["resolved"]

    # -- surface -------------------------------------------------------
    def ping(self) -> Dict[str, Any]:
        return self.request("ping")

    def metrics(self, format: Optional[str] = None) -> Dict[str, Any]:
        """The server's obs metrics scrape (counters / gauges /
        histogram summaries — docs/OBSERVABILITY.md names).
        ``format="prometheus"`` returns the text exposition in
        ``metrics_text`` instead of the JSON snapshot."""
        return self.request("metrics", format=format)

    def stats(self) -> Dict[str, Any]:
        return self.request("stats")

    def health(self, session: Optional[str] = None,
               **thresholds: Any) -> Dict[str, Any]:
        """Per-session search-quality verdicts (docs/SERVING.md): a
        session id narrows to one tenant; without it the server
        returns a bounded worst-first roll-up.  `stall_tells=` /
        `fail_rate_hi=` override the server thresholds per call."""
        return self.request("health", session=session, **thresholds)

    def open_session(self, space: Any, *, seed: int = 0,
                     program: str = "",
                     sense: str = "min",
                     arms: Optional[Sequence[str]] = None,
                     history_capacity: int = 1 << 10,
                     store: bool = True) -> "SessionHandle":
        """Open one tuning session.  `space` is a library Space or a
        list of JSON param records; `program` is the tenant-declared
        token naming WHAT is being measured — sessions naming the same
        program over the same space share the server's cross-tenant
        result memo.  Under ``auto_resume`` the session id is minted
        client-side, so a retried open re-attaches instead of leaking
        a second session."""
        if not isinstance(space, (list, tuple)):
            from ..exec.space_io import records_from_space
            space = records_from_space(space)
        sid = uuid.uuid4().hex[:16] if self.auto_resume else None
        resp = self.request(
            "open", space=list(space), seed=int(seed),
            program=str(program), sense=sense,
            arms=list(arms) if arms else None,
            history_capacity=int(history_capacity),
            store="on" if store else "off", session=sid)
        if self.auto_resume:
            self._resume_ids.append(resp["session"])
        return SessionHandle(self, resp["session"], resp)

    def attach_session(self, session_id: str) -> "SessionHandle":
        """Re-attach to a durable session by id (e.g. after this
        CLIENT process restarted — the server-restart case is handled
        transparently by auto_resume)."""
        resp = self.request("attach", session=str(session_id))
        if self.auto_resume and resp["session"] not in self._resume_ids:
            self._resume_ids.append(resp["session"])
        return SessionHandle(self, resp["session"], resp)

    def _forget(self, session_id: str) -> None:
        try:
            self._resume_ids.remove(session_id)
        except ValueError:
            pass

    def close(self) -> None:
        self._resume_ids.clear()
        self._drop_conn()

    def __enter__(self) -> "SessionClient":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


class SessionHandle:
    """One session on one client: ask / tell / best / close.  Tracks
    the per-ticket epoch tags and the session's incarnation token so
    every tell carries the resume protocol's idempotency fields."""

    def __init__(self, client: SessionClient, session_id: str,
                 info: Optional[dict] = None):
        self.client = client
        self.id = session_id
        self.info = dict(info or {})
        self.version = int(self.info.get("version", 0))
        self.incarn = self.info.get("incarn")
        self.store_served = 0
        self._ticket_epoch: Dict[int, int] = {}

    def _absorb_ask(self, resp: Dict[str, Any]) -> List[Trial]:
        """Fold one ask reply into this handle's resume bookkeeping
        (version, incarnation, per-ticket epoch tags) — shared by the
        single-request path and the batched-frame path."""
        self.version = resp.get("version", self.version)
        self.incarn = resp.get("incarn", self.incarn)
        self.store_served = resp.get("store_served", self.store_served)
        out = [Trial(t["ticket"], t["config"],
                     int(t.get("epoch", self.version)))
               for t in resp["trials"]]
        for t in out:
            self._ticket_epoch[t.ticket] = t.epoch
        return out

    def ask(self, n: int = 1) -> List[Trial]:
        return self._absorb_ask(
            self.client.request("ask", session=self.id, n=int(n)))

    def ask_many(self, n: int) -> List[Trial]:
        """`ask(n)` under its batched-plane name: a single ask is
        already k-wide in one round trip (the server issues the k
        tickets in one group-lock hold).  Cross-SESSION batching is
        where frames earn their keep — see SessionClient.ask_many."""
        return self.ask(n)

    def _after_tell(self, resp: Dict[str, Any], tickets) -> None:
        self.version = resp.get("version", self.version)
        for t in tickets:
            self._ticket_epoch.pop(t, None)

    def _tell_rows(self, results) -> List[Dict[str, Any]]:
        return [{"ticket": int(t), "qor": q,
                 "epoch": self._ticket_epoch.get(int(t))}
                for t, q in results]

    def tell(self, ticket: int, qor: Optional[float],
             dur: float = 0.0) -> Dict[str, Any]:
        resp = self.client.request(
            "tell", session=self.id, ticket=int(ticket), qor=qor,
            dur=dur or None,
            epoch=self._ticket_epoch.get(int(ticket)),
            incarn=self.incarn)
        self._after_tell(resp, [int(ticket)])
        return resp

    def tell_many(self, results) -> Dict[str, Any]:
        """Report many (ticket, qor) pairs in ONE round trip over the
        vectorized ``tell_many`` op: the server applies the whole
        batch in one group-lock hold and acks it behind one durable
        drain.  A server predating the op is sniffed from
        its unknown-op reply (once, loudly) and this handle's batches
        ride the legacy ``tell``+``results`` spelling instead."""
        rows = self._tell_rows(results)
        c = self.client
        if c._tell_many_ok is False:
            resp = c.request("tell", session=self.id, results=rows,
                             incarn=self.incarn)
        else:
            try:
                resp = c.request("tell_many", session=self.id,
                                 results=rows, incarn=self.incarn)
                c._tell_many_ok = True
            except ServeError as e:
                if (c._tell_many_ok is None
                        and "unknown op" in str(e)):
                    c._tell_many_ok = False
                    c._note_downlevel("tell_many")
                    resp = c.request("tell", session=self.id,
                                     results=rows, incarn=self.incarn)
                else:
                    raise
        self._after_tell(resp, [r["ticket"] for r in rows])
        return resp

    def best(self) -> Dict[str, Any]:
        return self.client.request("best", session=self.id)

    def health(self, **thresholds: Any) -> Dict[str, Any]:
        """This session's quality verdict ({"op": "health"})."""
        return self.client.request("health", session=self.id,
                                   **thresholds)["health"]

    def close(self) -> None:
        self.client._forget(self.id)
        try:
            self.client.request("close", session=self.id)
        except (ServeError, OSError):
            # already closed server-side, or the connection is gone —
            # the server reaps dead connections' sessions anyway
            pass

    def __enter__(self) -> "SessionHandle":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
