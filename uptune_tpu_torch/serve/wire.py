"""The newline-JSON/TCP service kernel: one reusable server loop for
every wire-speaking plane.

Counterpart of `uptune_tpu/serve/wire.py`, frame for frame: the session
server, the fleet-telemetry hub (obs/hub.py), the sharded front-tier
router (serve/router.py) and the remote
ResultStore server (store/server.py) all speak the same protocol: one
JSON object per
line, each carrying an ``op`` field, answered by one JSON object per
line.  This module owns the generic half so each service only writes
its op table:

* **Dispatch** — a class-level ``_OPS`` table maps op names to
  handler methods; ``handle(request) -> response`` is transport-free
  (tests and in-process benches drive it directly) and never raises:
  a ``RequestError`` comes back as ``ok=False`` with the message, any
  other exception is caught by the defensive per-op error wall and
  reported as ``internal:`` — one misbehaving client can never take
  the serving loop down.  An optional ``id`` field is echoed verbatim
  so clients may pipeline; an optional ``ctx`` span id is recorded as
  the handler span's ``parent`` so `ut-trace merge` joins
  client/server shards (docs/OBSERVABILITY.md).
* **Batch frames** — ``{"op": "batch", "ops": [...]}`` is
  handled by the kernel itself, so every wire-speaking service
  (``ut serve``, ``ut store``, ``ut hub``, ``ut route``) inherits it
  without touching its op table: one socket read, one dispatch walk,
  an ORDERED reply list written back as one coalesced send.  Each
  sub-op keeps its own error wall — a malformed sub-op yields an
  error *entry* in ``replies``, never a poisoned frame or connection
  — and the whole frame is bounded by the same ``max_line`` cap as a
  single request (one clean oversize error, then close).  Frames do
  not nest, and ``max_batch_ops`` bounds reply amplification.
* **Encode fast path** — one module-cached
  ``JSONEncoder`` serializes every reply (the obs/journal precedent:
  ``json.dumps`` re-resolves its options per call), and a handler may
  return a ``WireReply`` carrying its own preserialized wire text
  (built from per-epoch cached canonical config JSON on the session
  server's ask path) — the connection loop writes that text verbatim
  and a batch frame splices sub-reply texts instead of re-encoding
  k configs per k-wide ask.
* **Connection plane** — a single asyncio event loop
  (one ``-loop`` thread) owns accept + read + write for EVERY
  connection, replacing the thread-per-connection loops whose GIL
  handoffs were the ~1.7k asks/s ceiling (ROADMAP item 1): the loop
  never runs handler code — each parsed request is dispatched onto a
  BOUNDED worker pool (``max_workers``), so one slow commit stalls
  one worker, never the loop, and ten thousand idle tenants cost ten
  thousand coroutines instead of ten thousand threads.  Requests on
  one connection still complete in order (the coroutine awaits each
  dispatch), so per-connection semantics are exactly the old ones.
* **Per-connection state hooks** (``_conn_opened`` / ``_on_response``
  / ``_conn_closed``) let a service scope resources to the connection
  that created them and reap them when it dies — the session server's
  crashed-tenant slot reaping and the hub's source liveness both ride
  this seam, unchanged across the event-loop rewrite.
* **Hardening** — ``max_line`` caps one request line (one error
  reply, then close: the unread stream cannot be re-synchronized);
  ``idle_timeout`` bounds how long a silent connection may pin its
  coroutine.  Generous by default because serve tenants legitimately
  idle across external builds — instances may override either before
  ``start()``.
* **Reaping and shutdown** — dead connections prune themselves from
  the registry (long-lived servers stay bounded by LIVE connections
  under churn); ``stop()`` is a real barrier: the loop closes the
  listener and every connection, conn coroutines run their close
  hooks, and the loop thread is joined (bounded) so no handler races
  interpreter teardown writing to closed sockets.

Subclass contract::

    class MyServer(WireServer):
        WIRE_NAME = "my-server"          # log prefix + thread names
        def _op_ping(self, req): return {"t": time.time()}
        _OPS = {"ping": _op_ping}

``HANDLE_SPAN`` stays ``serve.handle`` for every service: the trace
merge tool joins ``client.request`` spans against that name, and a
hub or router is as much a serving plane as the session server.
"""
from __future__ import annotations

import asyncio
import json
import logging
import socket
import sys
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Callable, Dict, List, Optional, Set

from .. import obs
from ..obs import faults

log = logging.getLogger("uptune_tpu_torch")

__all__ = ["RequestError", "WireServer", "WireReply", "encode_reply"]

# one reusable encoder for every reply this process writes — the
# obs/journal measurement: ~25% cheaper per object than json.dumps,
# which re-resolves its options on every call
_ENC = json.JSONEncoder(separators=(",", ":"),
                        check_circular=False).encode


class RequestError(ValueError):
    """Bad request payload (reported to the client, never fatal)."""


class WireReply(dict):
    """A response dict that carries its own wire encoding.

    The encode fast path: a handler that can assemble its reply from
    preserialized fragments (the session server's ask path splices
    per-epoch cached canonical config JSON) returns one of these with
    ``wire_text`` set to the EXACT compact JSON of the dict —
    including ``"ok"`` — and the connection loop writes the text
    verbatim instead of re-encoding.  In-process consumers see a
    plain dict; the text is invisible to them.  The text/dict
    equivalence is a hard contract (tests assert
    ``json.loads(encode_reply(r)) == dict(r)``)."""

    __slots__ = ("wire_text",)


def encode_reply(resp: dict) -> str:
    """Compact JSON text of one response — the preserialized
    ``wire_text`` when the handler provided one, the cached encoder
    otherwise."""
    t = getattr(resp, "wire_text", None)
    if t is not None:
        return t
    return _ENC(resp)


def _set_id(out: dict, rid: Any) -> None:
    """Echo the client's ``id`` into a finished reply, keeping a
    preserialized ``wire_text`` consistent: the echo is spliced in
    before the closing brace, so the fast path survives pipelining."""
    out["id"] = rid
    t = getattr(out, "wire_text", None)
    if t is not None:
        out.wire_text = t[:-1] + ',"id":' + _ENC(rid) + "}"


class WireServer:
    """One wire-speaking process: construct, ``start()``, drive
    clients against ``.port``, ``stop()``.  Subclasses own the op
    table and any per-connection/service state."""

    WIRE_NAME = "ut-wire"
    HANDLE_SPAN = "serve.handle"
    _OPS: Dict[str, Callable[..., dict]] = {}

    # connection hardening — see module docstring
    MAX_LINE = 1 << 20
    IDLE_TIMEOUT = 1800.0
    # handler-pool bound: how many requests may execute
    # concurrently across ALL connections.  The pool is where blocking
    # handler work (group commits, checkpoint fsyncs, timeline
    # appends) lands so the event loop stays pure I/O; more workers
    # than cores only adds GIL pressure on this box
    MAX_WORKERS = 8
    # sub-ops one batch frame may carry: the request side
    # is already bounded by max_line, but k tiny sub-ops can fan out
    # into k large replies — this bounds the amplification
    MAX_BATCH_OPS = 256

    def __init__(self, host: str, port: int):
        self.host = str(host)
        self.port = int(port)
        self.max_line = int(self.MAX_LINE)
        self.idle_timeout: Optional[float] = self.IDLE_TIMEOUT
        self.max_workers = int(self.MAX_WORKERS)
        self.max_batch_ops = int(self.MAX_BATCH_OPS)
        self._lock = threading.RLock()
        self._listener: Optional[socket.socket] = None
        self._threads: List[threading.Thread] = []
        self._conns: List[socket.socket] = []
        self._running = False
        self._loop: Optional[asyncio.AbstractEventLoop] = None
        self._pool: Optional[ThreadPoolExecutor] = None
        self._stop_ev: Optional[asyncio.Event] = None
        self._tasks: Set[asyncio.Task] = set()   # loop-thread only
        self.started_unix = time.time()

    # -- per-connection hooks ------------------------------------------
    def _conn_opened(self, conn: socket.socket, addr) -> Any:
        """Called when a connection is accepted; the return value is
        this connection's state, threaded through `_on_response` and
        `_conn_closed` (None by default — stateless services skip all
        three hooks)."""
        return None

    def _on_response(self, state: Any, req: dict, resp: dict) -> None:
        """Called after every successfully parsed request is handled
        (bad-JSON lines never reach it).  Runs on the worker pool,
        directly after the handler, so response-ordering per
        connection is preserved."""

    def _conn_closed(self, state: Any) -> None:
        """Called exactly once when the connection dies — the reaping
        seam: release whatever `state` tracked.  Must never raise."""

    def _listen_banner(self) -> str:
        """Extra text for the listening log line (cosmetic)."""
        return ""

    # -- dispatch ------------------------------------------------------
    def handle(self, req: Any) -> dict:
        """Transport-free dispatch: one request dict -> one response
        dict (never raises; errors come back as ok=False).

        An optional ``ctx`` object (``{"span": id}``) is the client's
        trace context: the handler span records it as ``parent``, so
        a merged client+server trace joins each ``client.request``
        span to the ``serve.handle`` span it paid for — wire time is
        the difference (docs/OBSERVABILITY.md).

        A ``batch`` frame is unpacked here, in the kernel, so every
        subclass inherits multi-op frames with no op-table change."""
        if isinstance(req, dict) and req.get("op") == "batch":
            out = self._handle_batch(req)
            rid = req.get("id")
            if rid is not None:
                _set_id(out, rid)
            return out
        return self._handle_one(req)

    def _handle_batch(self, req: dict) -> dict:
        """One multi-op frame: dispatch each sub-op through the SAME
        per-op error wall a lone request gets, collect the ordered
        reply list, and preserialize the frame by splicing the
        sub-reply texts — sub-ops with cached wire text (the ask fast
        path) are never re-encoded.  Never raises."""
        ops = req.get("ops")
        if not isinstance(ops, list) or not ops:
            return {"ok": False,
                    "error": "batch needs 'ops': a non-empty list of "
                             "request objects"}
        if len(ops) > self.max_batch_ops:
            return {"ok": False,
                    "error": f"batch carries {len(ops)} ops; this "
                             f"server caps frames at "
                             f"{self.max_batch_ops}"}
        ctx = req.get("ctx")
        replies: List[dict] = []
        texts: List[str] = []
        failed = 0
        for sub in ops:
            if not isinstance(sub, dict):
                r: dict = {"ok": False,
                           "error": "batch sub-op must be a JSON "
                                    "object"}
            elif sub.get("op") == "batch":
                r = {"ok": False, "error": "batch frames do not nest"}
            else:
                if ctx is not None and "ctx" not in sub:
                    # the frame's trace context covers sub-ops that
                    # carry none of their own, so server spans still
                    # join the client.request span the frame paid for
                    sub = dict(sub, ctx=ctx)
                r = self._handle_one(sub)
            if not r.get("ok"):
                failed += 1
            replies.append(r)
            texts.append(encode_reply(r))
        obs.count("wire.batch_frames")
        obs.count("wire.batch_ops", len(replies))
        out = WireReply(ok=True, n=len(replies), failed=failed,
                        replies=replies)
        out.wire_text = ('{"ok":true,"n":%d,"failed":%d,"replies":[%s]}'
                         % (len(replies), failed, ",".join(texts)))
        return out

    def _handle_one(self, req: Any) -> dict:
        """Dispatch one (non-batch) request — the per-op error wall."""
        if not isinstance(req, dict):
            return {"ok": False, "error": "request must be a JSON "
                                          "object"}
        rid = req.get("id")
        op = req.get("op")
        ctx = req.get("ctx")
        # an unhashable op (list/dict) must hit the unknown-op reply,
        # not TypeError out of the dict lookup before the error wall
        fn = self._OPS.get(op) if isinstance(op, str) else None
        if fn is None:
            out = {"ok": False,
                   "error": f"unknown op {op!r}; valid: "
                            f"{sorted(self._OPS)}"}
        else:
            attrs = {"op": op}
            if isinstance(ctx, dict) and ctx.get("span") is not None:
                attrs["parent"] = str(ctx["span"])[:64]
            with obs.span(self.HANDLE_SPAN, **attrs) as sp:
                try:
                    res = fn(self, req)
                    # a WireReply already carries "ok" (and its
                    # preserialized text) — merging it into a fresh
                    # dict would throw the fast path away
                    out = (res if type(res) is WireReply
                           else {"ok": True, **res})
                except RequestError as e:
                    out = {"ok": False, "error": str(e)}
                    sp.set(error=True)
                except Exception as e:   # defensive: a client must not
                    # be able to take the serving loop down
                    log.exception("[%s] %s failed", self.WIRE_NAME, op)
                    out = {"ok": False,
                           "error": f"internal: {type(e).__name__}: {e}"}
                    sp.set(error=True)
        if rid is not None:
            _set_id(out, rid)
        return out

    def _dispatch(self, state: Any, req: dict) -> dict:
        """One request's worker-pool job: handler + response hook
        (the hook runs here, not on the loop, so a hook that blocks —
        the hub's durable timeline append — costs a worker slot, not
        the whole connection plane).  A batch frame fans the hook out
        per sub-op: connection-scoped state (the session server's
        ownership tracking keys on each sub-op's ``op``) must observe
        every sub-request, never the opaque frame."""
        resp = self.handle(req)
        if (isinstance(req, dict) and req.get("op") == "batch"
                and resp.get("ok")):
            for sub, r in zip(req.get("ops") or (),
                              resp.get("replies") or ()):
                if isinstance(sub, dict):
                    self._on_response(state, sub, r)
        else:
            self._on_response(state, req, resp)
        return resp

    # -- TCP -----------------------------------------------------------
    def start(self) -> "WireServer":
        """Bind + listen, then run the event loop in a daemon thread;
        .port holds the bound port (useful with port=0)."""
        # a serving process trades a little throughput for tail
        # latency: the interpreter's default 5ms GIL switch interval
        # parks every waiting request behind CPU-bound peers (config
        # decode, JSON, a tenant thread's own measurement loop) in
        # 5ms quanta — milliseconds of queueing on a sub-ms op.
        # the serving plane's ask p95 is measured under this setting
        if sys.getswitchinterval() > 0.001:
            sys.setswitchinterval(0.0005)
        s = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        s.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        s.bind((self.host, self.port))
        s.listen(128)
        # the socket is listening BEFORE start() returns: a client may
        # connect immediately (it queues in the backlog until the loop
        # thread starts accepting), exactly like the threaded kernel
        self.port = s.getsockname()[1]
        self._listener = s
        self._running = True
        self._pool = ThreadPoolExecutor(
            max_workers=self.max_workers,
            thread_name_prefix=f"{self.WIRE_NAME}-worker")
        self._loop = asyncio.new_event_loop()
        # created HERE (not in the loop thread) so a stop() racing a
        # just-started server always has an event to set
        self._stop_ev = asyncio.Event()
        t = threading.Thread(target=self._run_loop,
                             name=f"{self.WIRE_NAME}-loop",
                             daemon=True)
        t.start()
        with self._lock:
            self._threads.append(t)
        log.info("[%s] listening on %s:%d%s", self.WIRE_NAME,
                 self.host, self.port, self._listen_banner())
        return self

    def _run_loop(self) -> None:
        """The event-loop thread: owns every socket until stop()."""
        asyncio.set_event_loop(self._loop)
        try:
            self._loop.run_until_complete(self._main())
        except Exception:       # defensive: the loop dying must be
            # loud, never a silent half-dead server
            log.exception("[%s] event loop failed", self.WIRE_NAME)
        finally:
            self._loop.close()

    async def _main(self) -> None:
        server = await asyncio.start_server(
            self._serve_conn, sock=self._listener,
            limit=self.max_line + 1)
        try:
            await self._stop_ev.wait()
        finally:
            server.close()
            await server.wait_closed()
            # cancelling a conn task unwinds it through its finally:
            # writer closed, registry pruned, _conn_closed ran — the
            # gather is the barrier stop() joins through
            for task in list(self._tasks):
                task.cancel()
            if self._tasks:
                await asyncio.gather(*self._tasks,
                                     return_exceptions=True)
            # let the transports' scheduled close callbacks run so
            # every conn fd is really closed before the loop exits
            await asyncio.sleep(0)
            await asyncio.sleep(0)

    async def _serve_conn(self, reader: asyncio.StreamReader,
                          writer: asyncio.StreamWriter) -> None:
        conn = writer.get_extra_info("socket")
        addr = writer.get_extra_info("peername") or ("?", 0)
        task = asyncio.current_task()
        self._tasks.add(task)
        # both registries mutate under _lock everywhere, so stop()'s
        # shutdown snapshot is never a torn read; the finally below
        # prunes this conn's entry, keeping a long-lived server's
        # registry bounded by LIVE connections under open/close churn
        with self._lock:
            self._conns.append(conn)
        state = self._conn_opened(conn, addr)
        loop = asyncio.get_running_loop()
        try:
            faults.fire("wire.accept")
            if conn is not None:
                conn.setsockopt(socket.IPPROTO_TCP,
                                socket.TCP_NODELAY, 1)
            while self._running:
                try:
                    line = await asyncio.wait_for(
                        reader.readline(),
                        timeout=self.idle_timeout or None)
                except asyncio.TimeoutError:
                    obs.count("wire.idle_timeouts")
                    log.info("[%s] closing idle connection %s",
                             self.WIRE_NAME, addr)
                    break
                except ValueError:
                    # the stream reader's limit tripped mid-line: one
                    # complete error reply, then close — the rest of
                    # the oversized line is unread, so the stream
                    # cannot be re-synchronized
                    obs.count("wire.line_cap")
                    writer.write(_ENC(
                        {"ok": False,
                         "error": f"request line exceeds "
                                  f"{self.max_line} bytes"}
                    ).encode() + b"\n")
                    await writer.drain()
                    break
                if not line:
                    break
                line = line.strip()
                if not line:
                    continue
                faults.fire("wire.read")
                try:
                    req = json.loads(line)
                except json.JSONDecodeError as e:
                    resp = {"ok": False, "error": f"bad JSON: {e}"}
                else:
                    # handler work runs on the bounded pool; awaiting
                    # it keeps THIS connection's replies in request
                    # order while every other connection's coroutine
                    # stays runnable
                    resp = await loop.run_in_executor(
                        self._pool, self._dispatch, state, req)
                faults.fire("wire.reply")
                # one coalesced send per request — for a batch frame
                # this is the spliced sub-reply texts in one line, and
                # a WireReply's preserialized text goes out verbatim
                writer.write(encode_reply(resp).encode() + b"\n")
                await writer.drain()
        except (OSError, ValueError):
            pass            # client went away mid-exchange
        except asyncio.CancelledError:
            pass            # stop(): unwind through the finally
        finally:
            self._tasks.discard(task)
            try:
                writer.close()
            except OSError:
                pass
            with self._lock:
                try:
                    self._conns.remove(conn)
                except ValueError:
                    pass    # stop() already swept it
            # the reaping hook runs on the loop thread: it must stay
            # cheap (the subclass contract) and calling it here — not
            # on the pool — guarantees exactly-once even when stop()
            # has already torn the pool down
            self._conn_closed(state)

    def stop(self) -> None:
        self._running = False
        loop = self._loop
        if loop is not None and not loop.is_closed() \
                and self._stop_ev is not None:
            try:
                loop.call_soon_threadsafe(self._stop_ev.set)
            except RuntimeError:
                pass        # loop already closed under us
        elif self._listener is not None:
            # never started (or the loop died before serving): just
            # release the port
            try:
                self._listener.close()
            except OSError:
                pass
        # bounded join: the loop thread exits once _main's finally
        # has closed the listener and every connection — joining makes
        # stop() a real barrier, so no conn coroutine races
        # interpreter teardown writing to closed sockets
        with self._lock:
            threads = list(self._threads)
        me = threading.current_thread()
        for t in threads:
            if t is not me:     # a handler op may itself call stop()
                t.join(timeout=2.0)
        if self._pool is not None:
            # wait=False: a wedged handler gets the same 2s grace the
            # threaded kernel gave, not a veto over shutdown (stop()
            # may itself be running ON a pool thread — a handler op
            # calling stop() must not join itself)
            self._pool.shutdown(wait=False, cancel_futures=True)

    def serve_forever(self) -> None:
        """start() + block until KeyboardInterrupt (the CLI path)."""
        self.start()
        try:
            while True:
                time.sleep(3600)
        except KeyboardInterrupt:
            log.info("[%s] shutting down", self.WIRE_NAME)
        finally:
            self.stop()

    def __enter__(self) -> "WireServer":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()
