"""Evented binary front door: one selectors loop, many connections.

The legacy binding (:mod:`.http`) spends one
thread and one short-lived connection per request and re-inflates every
answer to JSON text; this module replaces the transport on the
query/ingest hot path with a single non-blocking event loop
(:mod:`selectors`) that owns accept/read/write for EVERY connection:

* **Persistent keep-alive connections** — HTTP/1.1 keep-alive is the
  default; a connection serves any number of requests until the client
  closes it or goes idle past ``ServeConfig.edge_idle_timeout_s``
  (the slow-loris bound: a peer that dribbles half a request forever
  is reaped, never parked on a blocked thread).
* **Pipelined request multiplexing** — a client may write request N+1
  before answer N arrives. Requests are dispatched to the server's
  micro-batching queue as they parse (so pipelined queries COALESCE),
  and responses flush strictly in request order per connection.
* **The result wire end to end** — ``POST /v1/query`` with ``Accept:
  application/x-mff-wire`` answers with the packed result-wire payload
  verbatim (framed by :func:`..data.result_wire.pack_frame`), through
  the same :func:`.http.query_from_doc` / :func:`.http.render_answer`
  pair the legacy binding uses. :mod:`.wireclient` is the first-party
  decoder.
* **Chunked range streaming** — a wire factors query carrying
  ``"chunk_days": N`` splits its day range into N-day sub-queries
  submitted upfront; each framed sub-answer flushes as its OWN
  ``Transfer-Encoding: chunked`` chunk the moment its dispatch
  completes (completion order — frames are self-describing, the
  client reassembles by each frame's ``start``). A mid-stream dispatch
  failure aborts the connection (chunked HTTP has no late error
  channel); ``edge.stream_aborts`` counts those.
* **Per-tenant admission quotas** — a token bucket per tenant key
  (``X-Tenant``, else ``X-API-Key``, else ``"anon"``) layered ABOVE
  pod admission, armed by ``ServeConfig.tenant_quota_rps``; refusals
  are ``429`` with the same ``Retry-After`` contract the shed ladder
  uses (:func:`.http.retry_after_seconds`).

Threading contract (declared below): the event loop
is SINGLE-THREADED BY DESIGN — exactly one loop thread touches
sockets, connection parse/flush state and the selector. The shared
state crossing threads is declared and guarded by ``_edge_lock``:
``_edge_conns`` (the connection table: loop thread mutates, dispatch
callbacks only consult liveness through the ready queue),
``_edge_ready`` (completions enqueued by worker/aux threads, drained
by the loop), and ``_edge_quota`` (token buckets). The one auxiliary
thread exists because some backend posts are synchronous by contract
(fleet ingest fan-out, flight dumps) and must not stall the loop.

Telemetry taxonomy (docs/observability.md): ``edge.open_connections``,
``edge.conns_opened`` / ``edge.conns_closed{reason=}``,
``edge.requests{method=}``, ``edge.pipelined_depth``,
``edge.answers{encoding=}``, ``edge.bytes_in`` /
``edge.bytes_out{encoding=}``, ``edge.chunks`` /
``edge.chunk_flush_seconds``, ``edge.quota_rejected{tenant=}``,
``edge.http_errors{code=}``, ``edge.stream_aborts``,
``edge.orphan_answers``, ``edge.loop_errors{error=}``.
"""

from __future__ import annotations

import dataclasses
import json
import queue
import selectors
import socket
import threading
import time
import urllib.parse
from collections import deque
from typing import Any, Callable, Dict, Optional, Tuple

from ..telemetry.opsplane import canonical_trace_id
from .http import (MAX_BODY_BYTES, MAX_INGEST_BODY_BYTES,
                   WIRE_CONTENT_TYPE, get_payload, query_from_doc,
                   render_answer, retry_after_seconds)
from .service import FactorServer, LoadShedError, Query

#: the lock contract the runtime lock-assertion twin (telemetry/lockcheck.py,
#: armed by MFF_LOCK_ASSERT=1) checks.
#: The loop thread owns sockets and per-connection state WITHOUT a lock
#: — that is the single-threaded-by-design part — so only the state
#: that crosses threads is guarded: the connection table (consulted
#: when draining completions), the completion queue (written by
#: executor/aux threads), and the tenant token buckets.
GLC_CONTRACT = {
    "EdgeServer": {
        "lock": "_edge_lock",
        "guards": ("_edge_conns", "_edge_ready", "_edge_quota"),
        "init": (),
        "locked": (),
    },
}

#: request line + header block bound (the legacy stdlib server's own
#: default header limit is 64 KiB over 100 lines; one bound here)
MAX_HEADER_BYTES = 32768

#: per-readable-event socket read size
_RECV_CHUNK = 1 << 18

_REASONS = {
    200: "OK", 400: "Bad Request", 404: "Not Found", 405: "Method Not "
    "Allowed", 409: "Conflict", 413: "Payload Too Large",
    429: "Too Many Requests", 500: "Internal Server Error",
    503: "Service Unavailable", 505: "HTTP Version Not Supported",
}


class _BadRequest(Exception):
    """Protocol-level malformation: answer ``status`` and close."""

    def __init__(self, status: int, msg: str):
        super().__init__(msg)
        self.status = status


def format_response(status: int, ctype: str, body: bytes, *,
                    trace_id: Optional[str] = None,
                    retry_after_s: Optional[float] = None,
                    close: bool = False) -> bytes:
    """One buffered HTTP/1.1 response, bytes-complete (the loop never
    partially materializes a response — partial WRITES are the
    socket's business, handled by the out-buffer)."""
    head = [
        f"HTTP/1.1 {status} {_REASONS.get(status, 'Unknown')}",
        f"Content-Type: {ctype}",
        f"Content-Length: {len(body)}",
    ]
    if trace_id:
        head.append(f"X-Trace-Id: {trace_id}")
    if retry_after_s is not None:
        head.append(f"Retry-After: {retry_after_seconds(retry_after_s)}")
    head.append("Connection: close" if close else
                "Connection: keep-alive")
    return ("\r\n".join(head) + "\r\n\r\n").encode("latin-1") + body


class _Stream:
    """A chunked-response slot: sub-answers land out of order, flush
    as chunks in completion order, terminate when all are in."""

    __slots__ = ("pending", "chunks", "failed", "headers_sent", "tid",
                 "t0")

    def __init__(self, pending: int, tid: Optional[str], t0: float):
        self.pending = pending
        self.chunks: deque = deque()
        self.failed = False
        self.headers_sent = False
        self.tid = tid
        self.t0 = t0


class _Conn:
    """Per-connection state. Loop-thread-only by design (Tier C: the
    contract guards the TABLE of these, not their insides)."""

    __slots__ = ("sock", "cid", "inbuf", "out", "slots", "next_slot",
                 "head", "t_last", "want_close", "events")

    def __init__(self, sock: socket.socket, cid: int):
        self.sock = sock
        self.cid = cid
        self.inbuf = bytearray()
        self.out = bytearray()
        #: slot -> None (pending) | bytes (ready) | _Stream
        self.slots: Dict[int, Any] = {}
        self.next_slot = 0
        self.head = 0
        self.t_last = time.monotonic()
        self.want_close = False
        self.events = 0


class ServerEdgeBackend:
    """Adapts one :class:`FactorServer` to the edge's backend protocol:
    ``get`` answers the whole GET surface synchronously (registry
    snapshots — no device work), ``submit_query`` returns the queue
    future, ``post`` maps the remaining POST routes to a future or a
    blocking call the edge runs on its aux thread."""

    label = "serve"

    def __init__(self, server: FactorServer,
                 timeout: Optional[float] = 60.0):
        self.server = server
        self.timeout = timeout

    @property
    def telemetry(self):
        return self.server.telemetry

    def get(self, path: str, query: dict, accept: str
            ) -> Optional[Tuple[int, str, bytes]]:
        return get_payload(self.server, path, query, accept)

    def submit_query(self, q: Query, tid: Optional[str]):
        return self.server.submit(q, trace_id=tid)

    def post(self, path: str, doc: dict, tid: Optional[str]):
        if path == "/v1/ingest":
            return "future", self.server.ingest(
                doc["bars"], doc["present"], trace_id=tid)
        if path == "/v1/discover":
            kwargs = dict(
                start=int(doc["start"]), end=int(doc["end"]),
                generations=int(doc.get("generations", 4)),
                pop=int(doc.get("pop", 128)),
                seed=int(doc.get("seed", 0)),
                horizon=int(doc.get("horizon", 1)),
                skeleton=str(doc.get("skeleton", "default")))
            return "future", self.server.discover(trace_id=tid,
                                                  **kwargs)
        if path == "/v1/debug/dump":
            server = self.server

            def dump():
                p = server.debug_dump()
                if p is None:
                    return 409, {"error": "no flight dump directory "
                                          "configured "
                                          "(ServeConfig.flight_dir)"}
                return 200, {"path": p, "requests": len(server.flight)}

            return "call", dump
        return None

    def max_body(self, path: str) -> int:
        return (MAX_INGEST_BODY_BYTES if path == "/v1/ingest"
                else MAX_BODY_BYTES)


class EdgeServer:
    """The evented front door. One loop thread, one aux thread, N
    persistent connections; see the module docstring for the protocol
    surface and the declared threading contract."""

    def __init__(self, backend, host: str = "127.0.0.1", port: int = 0,
                 *, quota_rps: float = 0.0, quota_burst: float = 0.0,
                 idle_timeout_s: float = 30.0, tick_s: float = 0.25):
        self.backend = backend
        self.telemetry = backend.telemetry
        self.quota_rps = float(quota_rps)
        self.quota_burst = float(quota_burst) if quota_burst > 0 \
            else max(1.0, float(quota_rps))
        self.idle_timeout_s = float(idle_timeout_s)
        self._tick_s = float(tick_s)

        self._edge_lock = threading.Lock()
        self._edge_conns: Dict[int, _Conn] = {}
        self._edge_ready: deque = deque()
        self._edge_quota: Dict[str, Tuple[float, float]] = {}
        self._next_cid = 0
        self._stopping = False

        self._listener = socket.create_server((host, port), backlog=128,
                                              reuse_port=False)
        self._listener.setblocking(False)
        self.server_address = self._listener.getsockname()

        self._wake_r, self._wake_w = socket.socketpair()
        self._wake_r.setblocking(False)
        self._wake_w.setblocking(False)

        self._sel = selectors.DefaultSelector()
        self._sel.register(self._listener, selectors.EVENT_READ,
                           "accept")
        self._sel.register(self._wake_r, selectors.EVENT_READ, "wake")

        self._aux_q: "queue.Queue" = queue.Queue()
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name="factor-serve-edge")
        self._aux = threading.Thread(target=self._aux_run, daemon=True,
                                     name="factor-edge-aux")
        self._thread.start()
        self._aux.start()
        from ..telemetry.lockcheck import maybe_install
        maybe_install(self)

    # -- lifecycle ----------------------------------------------------

    def close(self) -> None:
        """Stop the loop, join both threads, release every socket."""
        if self._stopping:
            return
        self._stopping = True
        self._wake()
        self._aux_q.put(None)
        if self._thread.is_alive():
            self._thread.join(timeout=10.0)
        if self._aux.is_alive():
            self._aux.join(timeout=10.0)
        for conn in list(self._edge_conns.values()):
            self._close_conn(conn, "shutdown")
        for sock in (self._listener, self._wake_r, self._wake_w):
            try:
                sock.close()
            except OSError:
                self.telemetry.counter("edge.loop_errors",
                                       error="close")
        try:
            self._sel.close()
        except (OSError, RuntimeError):
            self.telemetry.counter("edge.loop_errors",
                                   error="selector_close")

    def shutdown(self) -> None:
        """Alias so callers can hold an ``httpd``-shaped handle
        (:func:`.http.serve_frontdoor` returns either transport)."""
        self.close()

    # -- the loop -----------------------------------------------------

    def _run(self) -> None:
        while not self._stopping:
            try:
                self._loop_once()
            except Exception as e:  # noqa: BLE001 — loop must survive
                self.telemetry.counter("edge.loop_errors",
                                       error=type(e).__name__)

    def _loop_once(self) -> None:
        events = self._sel.select(timeout=self._tick_s)
        for key, mask in events:
            if key.data == "accept":
                self._accept()
            elif key.data == "wake":
                self._drain_wake()
            else:
                conn = key.data
                if mask & selectors.EVENT_READ \
                        and conn.cid in self._edge_conns:
                    self._on_readable(conn)
                if mask & selectors.EVENT_WRITE \
                        and conn.cid in self._edge_conns:
                    self._flush(conn)
        self._drain_ready()
        self._reap_idle(time.monotonic())

    def _wake(self) -> None:
        try:
            self._wake_w.send(b"\0")
        except (BlockingIOError, InterruptedError):
            return  # pipe full — the loop is already due to wake
        except OSError:
            return  # shutting down: the loop exits on _stopping

    def _drain_wake(self) -> None:
        while True:
            try:
                if not self._wake_r.recv(4096):
                    return
            except (BlockingIOError, InterruptedError):
                return
            except OSError:
                self.telemetry.counter("edge.loop_errors",
                                       error="wake_recv")
                return

    def _accept(self) -> None:
        while True:
            try:
                sock, _addr = self._listener.accept()
            except (BlockingIOError, InterruptedError):
                return
            except OSError:
                self.telemetry.counter("edge.loop_errors",
                                       error="accept")
                return
            sock.setblocking(False)
            try:
                sock.setsockopt(socket.IPPROTO_TCP,
                                socket.TCP_NODELAY, 1)
            except OSError:
                self.telemetry.counter("edge.loop_errors",
                                       error="nodelay")
            conn = _Conn(sock, self._next_cid)
            self._next_cid += 1
            with self._edge_lock:
                self._edge_conns[conn.cid] = conn
            self._sel.register(sock, selectors.EVENT_READ, conn)
            conn.events = selectors.EVENT_READ
            self.telemetry.counter("edge.conns_opened")
            self.telemetry.gauge("edge.open_connections",
                                 float(len(self._edge_conns)))

    def _close_conn(self, conn: _Conn, reason: str) -> None:
        with self._edge_lock:
            live = self._edge_conns.pop(conn.cid, None)
        if live is None:
            return
        try:
            self._sel.unregister(conn.sock)
        except (KeyError, ValueError, OSError):
            self.telemetry.counter("edge.loop_errors",
                                   error="unregister")
        try:
            conn.sock.close()
        except OSError:
            self.telemetry.counter("edge.loop_errors",
                                   error="sock_close")
        self.telemetry.counter("edge.conns_closed", reason=reason)
        self.telemetry.gauge("edge.open_connections",
                             float(len(self._edge_conns)))

    def _reap_idle(self, now: float) -> None:
        if self.idle_timeout_s <= 0:
            return
        for conn in list(self._edge_conns.values()):
            # only reap connections with no dispatch in flight: an
            # answer the server is still computing is not idleness —
            # a half-written request (slow loris) or an unread
            # response (slow reader) is
            if now - conn.t_last > self.idle_timeout_s \
                    and conn.head == conn.next_slot:
                self._close_conn(conn, "idle")

    # -- reads and protocol parse ------------------------------------

    def _on_readable(self, conn: _Conn) -> None:
        try:
            data = conn.sock.recv(_RECV_CHUNK)
        except (BlockingIOError, InterruptedError):
            return
        except OSError:
            self._close_conn(conn, "recv_error")
            return
        if not data:
            # peer closed; anything still in flight flushes nowhere
            self._close_conn(conn, "peer_closed")
            return
        conn.t_last = time.monotonic()
        conn.inbuf += data
        self.telemetry.counter("edge.bytes_in", float(len(data)))
        try:
            self._parse_requests(conn)
        except _BadRequest as e:
            self.telemetry.counter("edge.http_errors",
                                   code=str(e.status))
            slot = conn.next_slot
            conn.next_slot += 1
            conn.slots[slot] = format_response(
                e.status, "application/json",
                json.dumps({"error": str(e)}).encode(), close=True)
            conn.want_close = True
            conn.inbuf.clear()
        self._pump(conn)

    def _parse_requests(self, conn: _Conn) -> None:
        while not conn.want_close:
            parsed = self._try_parse(conn)
            if parsed is None:
                return
            self._dispatch(conn, *parsed)

    def _try_parse(self, conn: _Conn
                   ) -> Optional[Tuple[str, str, str, Dict[str, str],
                                       bytes]]:
        """One complete request off ``conn.inbuf``, or None when more
        bytes are needed. Raises :class:`_BadRequest` on protocol
        malformation (answer + close; no resynchronization)."""
        buf = conn.inbuf
        hdr_end = buf.find(b"\r\n\r\n")
        if hdr_end < 0:
            if len(buf) > MAX_HEADER_BYTES:
                raise _BadRequest(400, "header block too large")
            return None
        try:
            text = bytes(buf[:hdr_end]).decode("latin-1")
        except UnicodeDecodeError:
            raise _BadRequest(400, "undecodable header block")
        lines = text.split("\r\n")
        parts = lines[0].split()
        if len(parts) != 3:
            raise _BadRequest(400,
                              f"malformed request line {lines[0]!r}")
        method, target, version = parts
        if version not in ("HTTP/1.1", "HTTP/1.0"):
            raise _BadRequest(505, f"unsupported version {version!r}")
        headers: Dict[str, str] = {}
        for line in lines[1:]:
            if not line:
                continue
            key, sep, value = line.partition(":")
            if not sep or not key.strip():
                raise _BadRequest(400, f"malformed header {line!r}")
            headers[key.strip().lower()] = value.strip()
        if "chunked" in headers.get("transfer-encoding", "").lower():
            raise _BadRequest(400, "chunked request bodies are not "
                                   "supported; send Content-Length")
        try:
            length = int(headers.get("content-length", "0") or "0")
        except ValueError:
            raise _BadRequest(400, "malformed Content-Length")
        if length < 0:
            raise _BadRequest(400, "negative Content-Length")
        path = urllib.parse.urlparse(target).path
        if length > self.backend.max_body(path):
            # replying without reading the oversized body only works
            # if we then drop the connection
            raise _BadRequest(413, "body too large")
        body_start = hdr_end + 4
        if len(buf) - body_start < length:
            return None
        body = bytes(buf[body_start:body_start + length])
        del buf[:body_start + length]
        return method, target, version, headers, body

    # -- request dispatch --------------------------------------------

    def _dispatch(self, conn: _Conn, method: str, target: str,
                  version: str, headers: Dict[str, str], body: bytes
                  ) -> None:
        t0 = time.monotonic()
        tel = self.telemetry
        tel.counter("edge.requests", method=method)
        tel.observe("edge.pipelined_depth",
                    float(conn.next_slot - conn.head + 1))
        connection = headers.get("connection", "").lower()
        if connection == "close" or (version == "HTTP/1.0"
                                     and connection != "keep-alive"):
            conn.want_close = True
        slot = conn.next_slot
        conn.next_slot += 1
        conn.slots[slot] = None
        parsed = urllib.parse.urlparse(target)
        if method == "GET":
            res = self.backend.get(parsed.path,
                                   urllib.parse.parse_qs(parsed.query),
                                   headers.get("accept", ""))
            if res is None:
                self._slot_error(conn, slot, 404,
                                 f"no route {parsed.path}", None)
                return
            status, ctype, payload = res
            self._set_slot(conn, slot,
                           format_response(status, ctype, payload))
            if status >= 400:
                tel.counter("edge.http_errors", code=str(status))
            else:
                tel.counter("edge.answers", encoding="json")
                tel.counter("edge.bytes_out", float(len(payload)),
                            encoding="json")
            return
        if method != "POST":
            self._slot_error(conn, slot, 405,
                             f"method {method} not allowed", None)
            return
        self._handle_post(conn, slot, parsed.path, headers, body, t0)

    def _handle_post(self, conn: _Conn, slot: int, path: str,
                     headers: Dict[str, str], body: bytes, t0: float
                     ) -> None:
        tid = canonical_trace_id(headers.get("x-trace-id"))
        if path in ("/v1/query", "/v1/ingest"):
            retry = self._quota_admit(headers)
            if retry is not None:
                self._slot_error(conn, slot, 429,
                                 "tenant quota exceeded", tid,
                                 retry_after_s=retry, quota=True)
                return
        try:
            doc = json.loads(body or b"{}")
            if not isinstance(doc, dict):
                raise ValueError("request body must be a JSON object")
        except (ValueError, json.JSONDecodeError) as e:
            self._slot_error(conn, slot, 400,
                             f"malformed request: {e}", tid)
            return
        if path == "/v1/query":
            self._handle_query(conn, slot, doc, tid,
                               headers.get("accept", ""), t0)
            return
        echo_tid = None if path == "/v1/debug/dump" else tid
        try:
            action = self.backend.post(path, doc, tid)
        except LoadShedError as e:
            self._slot_error(conn, slot, 503, str(e), echo_tid,
                             retry_after_s=e.retry_after_s, shed=True)
            return
        except (KeyError, ValueError, TypeError) as e:
            self._slot_error(conn, slot, 400,
                             f"malformed request: {e}", echo_tid)
            return
        if action is None:
            self._slot_error(conn, slot, 404, f"no route {path}",
                             echo_tid)
            return
        kind, payload = action
        if kind == "future":
            cid = conn.cid
            payload.add_done_callback(
                lambda f: self._async_done(cid, slot,
                                           ("answer", None, echo_tid),
                                           f))
        else:  # "call": synchronous backend work — aux thread's job
            self._aux_q.put((conn.cid, slot, payload, echo_tid))

    def _handle_query(self, conn: _Conn, slot: int, doc: dict,
                      tid: Optional[str], accept: str, t0: float
                      ) -> None:
        try:
            q = query_from_doc(doc, accept)
            chunk_days = int(doc.get("chunk_days") or 0)
            if chunk_days < 0:
                raise ValueError("chunk_days must be >= 0")
            if chunk_days and (q.encoding != "wire"
                               or q.kind != "factors"):
                raise ValueError("chunk_days streams wire-encoded "
                                 "factors queries only")
        except (KeyError, ValueError, TypeError) as e:
            self._slot_error(conn, slot, 400,
                             f"malformed request: {e}", tid)
            return
        if chunk_days and q.end - q.start > chunk_days:
            self._handle_chunked(conn, slot, q, chunk_days, tid, t0)
            return
        try:
            fut = self.backend.submit_query(q, tid)
        except LoadShedError as e:
            self._slot_error(conn, slot, 503, str(e), tid,
                             retry_after_s=e.retry_after_s, shed=True)
            return
        except ValueError as e:
            self._slot_error(conn, slot, 400, str(e), tid)
            return
        cid = conn.cid
        fut.add_done_callback(
            lambda f: self._async_done(cid, slot, ("answer", q, tid),
                                       f))

    def _handle_chunked(self, conn: _Conn, slot: int, q: Query,
                        chunk_days: int, tid: Optional[str], t0: float
                        ) -> None:
        """Split ``[start, end)`` into ``chunk_days``-day sub-queries,
        submit them ALL before streaming starts (admission is
        all-or-nothing: a shed before the first byte is still a clean
        503), then stream each framed sub-answer as it completes."""
        ranges = [(s, min(s + chunk_days, q.end))
                  for s in range(q.start, q.end, chunk_days)]
        futs = []
        try:
            for s, e in ranges:
                sub = dataclasses.replace(q, start=s, end=e)
                futs.append((sub,
                             self.backend.submit_query(sub, tid)))
        except LoadShedError as err:
            self._slot_error(conn, slot, 503, str(err), tid,
                             retry_after_s=err.retry_after_s,
                             shed=True)
            return
        except ValueError as err:
            self._slot_error(conn, slot, 400, str(err), tid)
            return
        conn.slots[slot] = _Stream(len(futs), tid, t0)
        cid = conn.cid
        for sub, fut in futs:
            fut.add_done_callback(
                lambda f, sub=sub: self._async_done(
                    cid, slot, ("chunk", sub, tid), f))

    # -- completion plumbing -----------------------------------------

    def _async_done(self, cid: int, slot: int, ctx: tuple,
                    payload) -> None:
        """Runs on WHICHEVER thread resolves the work (executor
        callback, aux thread, or inline when already done): park the
        completion for the loop and wake it. The only cross-thread
        write, and it is guarded."""
        with self._edge_lock:
            self._edge_ready.append((cid, slot, ctx, payload))
        self._wake()

    def _aux_run(self) -> None:
        """The auxiliary worker: synchronous backend posts (fleet
        ingest fan-out, flight dumps) run here so the loop thread
        never blocks on them."""
        while True:
            item = self._aux_q.get()
            if item is None:
                return
            cid, slot, call, tid = item
            try:
                result = call()
            except Exception as e:  # noqa: BLE001 — mapped to HTTP
                result = e
            self._async_done(cid, slot, ("call", None, tid), result)

    def _drain_ready(self) -> None:
        while True:
            with self._edge_lock:
                if not self._edge_ready:
                    return
                cid, slot, ctx, payload = self._edge_ready.popleft()
            conn = self._edge_conns.get(cid)
            if conn is None or slot not in conn.slots:
                self.telemetry.counter("edge.orphan_answers")
                continue
            kind, q, tid = ctx
            if kind == "chunk":
                self._finish_chunk(conn, slot, q, tid, payload)
            elif kind == "call":
                self._finish_call(conn, slot, tid, payload)
            else:
                self._finish_answer(conn, slot, q, tid, payload)
            self._pump(conn)

    def _finish_answer(self, conn: _Conn, slot: int,
                       q: Optional[Query], tid: Optional[str],
                       fut) -> None:
        e = fut.exception()
        if isinstance(e, LoadShedError):
            self._slot_error(conn, slot, 503, str(e), tid,
                             retry_after_s=e.retry_after_s, shed=True)
            return
        if e is not None:
            self._slot_error(conn, slot, 500,
                             f"{type(e).__name__}: {e}", tid)
            return
        result = fut.result()
        try:
            if q is None:
                ctype, body = ("application/json",
                               json.dumps(result).encode())
            else:
                ctype, body = render_answer(result, q)
        except Exception as err:  # noqa: BLE001 — render failure
            self._slot_error(conn, slot, 500,
                             f"{type(err).__name__}: {err}", tid)
            return
        enc = "wire" if ctype == WIRE_CONTENT_TYPE else "json"
        self.telemetry.counter("edge.answers", encoding=enc)
        self.telemetry.counter("edge.bytes_out", float(len(body)),
                               encoding=enc)
        self._set_slot(conn, slot,
                       format_response(200, ctype, body,
                                       trace_id=tid))

    def _finish_call(self, conn: _Conn, slot: int,
                     tid: Optional[str], result) -> None:
        if isinstance(result, LoadShedError):
            self._slot_error(conn, slot, 503, str(result), tid,
                             retry_after_s=result.retry_after_s,
                             shed=True)
            return
        if isinstance(result, (KeyError, ValueError, TypeError)):
            self._slot_error(conn, slot, 400,
                             f"malformed request: {result}", tid)
            return
        if isinstance(result, BaseException):
            self._slot_error(conn, slot, 500,
                             f"{type(result).__name__}: {result}", tid)
            return
        status, doc = result
        body = json.dumps(doc).encode()
        if status >= 400:
            self.telemetry.counter("edge.http_errors",
                                   code=str(status))
        else:
            self.telemetry.counter("edge.answers", encoding="json")
            self.telemetry.counter("edge.bytes_out", float(len(body)),
                                   encoding="json")
        self._set_slot(conn, slot,
                       format_response(status, "application/json",
                                       body, trace_id=tid))

    def _finish_chunk(self, conn: _Conn, slot: int, sub_q: Query,
                      tid: Optional[str], fut) -> None:
        state = conn.slots.get(slot)
        if not isinstance(state, _Stream):
            self.telemetry.counter("edge.orphan_answers")
            return
        state.pending -= 1
        e = fut.exception()
        if e is not None:
            state.failed = True
            self.telemetry.counter("edge.stream_aborts",
                                   error=type(e).__name__)
            return
        try:
            ctype, frame = render_answer(fut.result(), sub_q)
            if ctype != WIRE_CONTENT_TYPE:
                raise ValueError("chunked sub-answer was not "
                                 "wire-encoded")
        except Exception as err:  # noqa: BLE001 — abort the stream
            state.failed = True
            self.telemetry.counter("edge.stream_aborts",
                                   error=type(err).__name__)
            return
        state.chunks.append(frame)
        self.telemetry.counter("edge.chunks")
        self.telemetry.counter("edge.bytes_out", float(len(frame)),
                               encoding="wire")

    # -- response assembly and writes --------------------------------

    def _set_slot(self, conn: _Conn, slot: int, data: bytes) -> None:
        conn.slots[slot] = data

    def _slot_error(self, conn: _Conn, slot: int, status: int,
                    msg: str, tid: Optional[str], *,
                    retry_after_s: Optional[float] = None,
                    shed: bool = False, quota: bool = False) -> None:
        doc: Dict[str, Any] = {"error": msg}
        if shed:
            doc["shed"] = True
        if quota:
            doc["quota"] = True
        self.telemetry.counter("edge.http_errors", code=str(status))
        self._set_slot(conn, slot, format_response(
            status, "application/json", json.dumps(doc).encode(),
            trace_id=tid, retry_after_s=retry_after_s))

    def _pump(self, conn: _Conn) -> None:
        """Move completed responses into the out-buffer IN SLOT ORDER
        (pipelined answers never reorder on the wire), flushing a
        streaming slot's ready chunks as they exist."""
        while conn.head < conn.next_slot:
            state = conn.slots.get(conn.head)
            if state is None:
                break  # head-of-line answer still in flight
            if isinstance(state, (bytes, bytearray)):
                conn.out += state
                del conn.slots[conn.head]
                conn.head += 1
                continue
            # _Stream
            if not state.headers_sent:
                head = ["HTTP/1.1 200 OK",
                        f"Content-Type: {WIRE_CONTENT_TYPE}",
                        "Transfer-Encoding: chunked"]
                if state.tid:
                    head.append(f"X-Trace-Id: {state.tid}")
                head.append("Connection: keep-alive")
                conn.out += ("\r\n".join(head)
                             + "\r\n\r\n").encode("latin-1")
                state.headers_sent = True
            while state.chunks:
                frame = state.chunks.popleft()
                conn.out += (f"{len(frame):x}\r\n".encode("latin-1")
                             + frame + b"\r\n")
                self.telemetry.observe("edge.chunk_flush_seconds",
                                       time.monotonic() - state.t0)
            if state.failed:
                # chunked HTTP has no mid-stream error channel: the
                # only honest signal is an aborted connection (the
                # client sees a missing terminating chunk)
                self._close_conn(conn, "stream_abort")
                return
            if state.pending == 0:
                conn.out += b"0\r\n\r\n"
                del conn.slots[conn.head]
                conn.head += 1
                continue
            break  # stream open, more sub-answers coming
        self._flush(conn)

    def _flush(self, conn: _Conn) -> None:
        if conn.cid not in self._edge_conns:
            return
        if conn.out:
            try:
                n = conn.sock.send(bytes(conn.out[:1 << 20]))
                if n:
                    del conn.out[:n]
            except (BlockingIOError, InterruptedError):
                n = 0
            except OSError:
                # mid-response disconnect: reap; in-flight answers for
                # this connection become orphans, the worker never
                # blocks on the dead socket
                self._close_conn(conn, "send_error")
                return
        want = selectors.EVENT_READ | (selectors.EVENT_WRITE
                                       if conn.out else 0)
        if want != conn.events:
            try:
                self._sel.modify(conn.sock, want, conn)
                conn.events = want
            except (KeyError, ValueError, OSError):
                self.telemetry.counter("edge.loop_errors",
                                       error="modify")
        if not conn.out and conn.want_close \
                and conn.head == conn.next_slot:
            self._close_conn(conn, "client_close")

    # -- tenant quotas ------------------------------------------------

    def _quota_admit(self, headers: Dict[str, str]
                     ) -> Optional[float]:
        """Token-bucket admission above pod admission: None admits;
        a float is the Retry-After hint (seconds until one token)."""
        rps = self.quota_rps
        if rps <= 0:
            return None
        tenant = (headers.get("x-tenant")
                  or headers.get("x-api-key") or "anon")
        now = time.monotonic()
        with self._edge_lock:
            tokens, t_prev = self._edge_quota.get(tenant,
                                                  (self.quota_burst,
                                                   now))
            tokens = min(self.quota_burst,
                         tokens + (now - t_prev) * rps)
            if tokens >= 1.0:
                self._edge_quota[tenant] = (tokens - 1.0, now)
                return None
            self._edge_quota[tenant] = (tokens, now)
            need = (1.0 - tokens) / rps
        self.telemetry.counter("edge.quota_rejected", tenant=tenant)
        return need


def serve_edge(server: FactorServer, host: str = "127.0.0.1",
               port: int = 0,
               timeout: Optional[float] = 60.0) -> EdgeServer:
    """Bind the evented front door over one :class:`FactorServer`.
    Returns the running :class:`EdgeServer` (``.server_address`` /
    ``.shutdown()``, the same handle shape as the legacy binding);
    quota and idle knobs come from ``ServeConfig``."""
    scfg = server.scfg
    backend = ServerEdgeBackend(server, timeout)
    return EdgeServer(backend, host=host, port=port,
                      quota_rps=scfg.tenant_quota_rps,
                      quota_burst=scfg.tenant_quota_burst,
                      idle_timeout_s=scfg.edge_idle_timeout_s)
