"""Stdlib-only HTTP/JSON binding for :class:`.service.FactorServer`.

Protocol-agnostic by construction: the handler only translates JSON to
:class:`..serve.service.Query` objects and futures back to JSON — every
serving semantic (batching, coalescing, caching, shedding) lives in the
server. ``ThreadingHTTPServer`` gives one thread per connection, which
is exactly what the micro-batching queue wants: concurrent HTTP clients
land in one collection window and coalesce.

Endpoints:

* ``POST /v1/query`` — body ``{"kind": "factors"|"ic"|"decile"|
  "intraday", "start": int, "end": int, "names"?: [..], "factor"?:
  str, "horizon"?: int, "group_num"?: int}`` -> the answer dict
  (``intraday`` ignores the range and reads the live streaming carry;
  needs a ``stream=True`` server).
  400 on a malformed query, 503 when the server sheds (breaker open /
  queue full) — the HTTP face of backpressure, 500 on a failed dispatch.
  Every 503 carries a ``Retry-After`` header derived from
  the breaker cooldown: the remaining cooldown on a breaker shed, the
  full cooldown as the backoff hint on a full-queue shed.
* ``POST /v1/ingest`` — body ``{"bars": [[[o,h,l,c,v]×T]×B],
  "present": [[bool×T]×B]}`` advances the streaming carry by ``B``
  minutes; -> ``{"minute", "bars"}``. Same error mapping as query
  (the JSON body bound is wider: a full universe-minute is big).
* ``POST /v1/discover`` — body ``{"start": int, "end": int,
  "generations"?: int, "pop"?: int, "seed"?: int, "horizon"?: int,
  "skeleton"?: "default"|"rich"}`` runs a bounded-generations
  factor-discovery job on the request queue (needs a
  ``research=True`` server) -> the discovery answer (the registered
  ``disc_<hash>`` name, its backtest stats, the persisted record
  path). Same error mapping as query; discovery jobs respect the
  breaker and the bounded queue like any other request.
* ``GET /v1/factors`` — the live factor universe: built-in names plus
  every factor discovered since startup, each immediately queryable
  by name through ``POST /v1/query``.
* ``POST /v1/debug/dump`` — on-demand flight-recorder capture:
  dumps the request ring + last-dispatch metadata +
  registry counter deltas; -> ``{"path", "requests"}`` (409 when no
  dump directory is configured anywhere).
* ``GET /healthz`` — liveness: breaker state, uptime, queue depth,
  flight-recorder counts, HBM-stats availability (+ the stream
  carry's minute cursor when streaming is on), and the
  ``factor_health`` data-quality block (worst-coverage
  factor, result-wire widen rate, drift bursts) — the same shape the
  fleet front door rolls up per replica.
* ``GET /v1/metrics`` — the telemetry registry: JSON snapshot by
  default; the standard Prometheus text format (v0.0.4) when the
  request asks for it (``Accept: text/plain`` / ``application/
  openmetrics-text``, or ``?format=prometheus``) — scrapeable by
  stock tooling.
* ``GET /v1/slo`` — the SLO plane: per-objective burn
  rates, budget remaining and alert state as JSON
  (``SloPlane.summary`` + the latest evaluation), or the
  ``slo_*``-only Prometheus view under the same content negotiation
  as ``/v1/metrics`` — for alerting rules that poll the SLO surface
  alone.
* ``GET /v1/timeline?name=&since=`` — the continuous telemetry
  timeline: the in-process frame ring, optionally
  filtered to series containing ``name`` and frames at/after unix
  second ``since`` (``limit`` bounds the tail).

Request tracing: ``POST /v1/query`` and ``POST /v1/ingest``
accept an ``X-Trace-Id`` header (``[A-Za-z0-9._-]{1,64}``; anything
else is replaced at admission) and every response — success or error —
echoes the request's effective trace ID back in the same header, so a
client can join its own logs to the server's span/request records.

This module is also the serve layer's shared endpoint
LIBRARY — :func:`query_from_doc`, :func:`render_answer` and
:func:`get_payload` are one implementation used by this legacy binding
AND the evented edge (:mod:`.edge`), so the two front doors cannot
drift; ``POST /v1/query`` honors ``Accept: application/x-mff-wire``
(the packed result-wire payload back verbatim, framed) on both.
:func:`serve_frontdoor` binds whichever transport ``ServeConfig.edge``
names.
"""

from __future__ import annotations

import json
import threading
import urllib.parse
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional, Tuple

from ..telemetry.opsplane import canonical_trace_id, to_prometheus
from .service import FactorServer, LoadShedError, Query

#: request-body bound (a factors query is a few hundred bytes)
MAX_BODY_BYTES = 1 << 20

#: ingest-body bound: B minutes × T tickers × 5 fields as JSON text
#: (~16 bytes/number puts a 64-minute × 5000-ticker micro-batch well
#: inside 64 MiB)
MAX_INGEST_BODY_BYTES = 64 << 20


#: the result-wire media type: a ``POST /v1/query`` carrying
#: ``Accept: application/x-mff-wire`` gets the packed result-wire
#: payload back VERBATIM, framed by ``data/result_wire.pack_frame`` —
#: both front doors (this module and :mod:`.edge`) honor it through the
#: same :func:`query_from_doc` / :func:`render_answer` pair.
WIRE_CONTENT_TYPE = "application/x-mff-wire"


def retry_after_seconds(retry_after_s: Optional[float]) -> int:
    """``Retry-After`` header value from a shed's backoff hint: whole
    seconds, rounded UP, floor 1 (a zero/None hint must still tell the
    client to back off for a beat, not hammer). Shared by this binding
    and the fleet front door so the two renderings cannot
    drift."""
    import math
    if retry_after_s is None or retry_after_s <= 0:
        return 1
    return max(1, math.ceil(retry_after_s))


def wants_prometheus(accept: str, query: dict) -> bool:
    """The ``/v1/metrics`` & ``/v1/slo`` content negotiation, shared by
    every front door (legacy serve, legacy fleet, edge)."""
    return ("text/plain" in accept or "openmetrics" in accept
            or query.get("format", [""])[0] == "prometheus")


def query_from_doc(doc: dict, accept: str = "") -> Query:
    """One JSON request body -> :class:`Query`, shared by both serve
    front doors and the fleet's (one parser, so the bindings cannot drift). Raises
    ``ValueError``/``TypeError``/``KeyError`` on malformed fields — the
    caller maps those to 400. Wire encoding is negotiated from the
    ``Accept`` header (``application/x-mff-wire``) or an explicit
    ``"encoding": "wire"`` in the body."""
    encoding = ("wire" if (WIRE_CONTENT_TYPE in (accept or "")
                           or doc.get("encoding") == "wire")
                else "json")
    return Query(
        kind=doc.get("kind", ""),
        start=int(doc.get("start", 0)),
        end=int(doc.get("end", 0)),
        names=tuple(doc["names"]) if doc.get("names") else None,
        factor=doc.get("factor"),
        horizon=int(doc.get("horizon", 1)),
        group_num=int(doc.get("group_num", 5)),
        encoding=encoding)


def render_answer(result: dict, q: Query) -> Tuple[str, bytes]:
    """One resolved answer dict -> ``(content_type, body)``. A wire
    answer (``result["wire"]``) frames the packed payload verbatim
    (:func:`..data.result_wire.pack_frame`); everything else is the
    JSON rendering both front doors always produced."""
    if q.encoding == "wire" and result.get("wire"):
        from ..data import result_wire as _rw
        body = _rw.pack_frame(
            result["payload"], n_factors=result["n_factors"],
            days=result["days"], tickers=result["tickers"],
            spill_rows=result["spill_rows"],
            start=result.get("start", 0), end=result.get("end", 0))
        return WIRE_CONTENT_TYPE, body
    return "application/json", json.dumps(result).encode()


def get_payload(server: FactorServer, path: str, query: dict,
                accept: str = "") -> Optional[Tuple[int, str, bytes]]:
    """The GET endpoint surface -> ``(status, content_type, body)``,
    or None for an unknown route. ONE implementation serves both the
    legacy thread-per-connection binding and the evented edge
    (:mod:`.edge`), so the two front doors answer identically by
    construction — the legacy-vs-edge parity tests then verify it."""
    if path == "/healthz":
        return 200, "application/json", \
            json.dumps(server.health()).encode()
    if path == "/v1/factors":
        return 200, "application/json", \
            json.dumps(server.factor_list()).encode()
    if path == "/v1/metrics":
        if wants_prometheus(accept, query):
            return 200, "text/plain; version=0.0.4; charset=utf-8", \
                to_prometheus(server.telemetry.registry).encode()
        return 200, "application/json", \
            json.dumps(server.telemetry.registry.snapshot()).encode()
    if path == "/v1/slo":
        if wants_prometheus(accept, query):
            from ..telemetry.slo import slo_prometheus
            return 200, "text/plain; version=0.0.4; charset=utf-8", \
                slo_prometheus(server.telemetry.registry).encode()
        return 200, "application/json", json.dumps({
            "slo": server.sloplane.summary(),
            "evaluation": server.sloplane.evaluate(),
        }).encode()
    if path == "/v1/timeline":
        try:
            name = query.get("name", [None])[0]
            since_raw = query.get("since", [None])[0]
            since = (float(since_raw) if since_raw is not None
                     else None)
            limit_raw = query.get("limit", [None])[0]
            limit = (int(limit_raw) if limit_raw is not None
                     else None)
        except (TypeError, ValueError) as e:
            return 400, "application/json", json.dumps(
                {"error": f"malformed timeline query: {e}"}).encode()
        frames = server.timeline.query(name=name, since=since,
                                       limit=limit)
        return 200, "application/json", json.dumps(
            {"frames": frames, "count": len(frames)}).encode()
    return None


def _make_handler(server: FactorServer, timeout: Optional[float]):
    class Handler(BaseHTTPRequestHandler):
        protocol_version = "HTTP/1.1"

        def log_message(self, fmt, *args):  # quiet by default
            pass

        def _reply(self, code: int, payload: dict,
                   trace_id: Optional[str] = None,
                   retry_after_s: Optional[float] = None) -> None:
            self._reply_bytes(code, json.dumps(payload).encode(),
                              "application/json", trace_id,
                              retry_after_s=retry_after_s)

        def _reply_bytes(self, code: int, body: bytes,
                         content_type: str,
                         trace_id: Optional[str] = None,
                         retry_after_s: Optional[float] = None) -> None:
            self.send_response(code)
            self.send_header("Content-Type", content_type)
            self.send_header("Content-Length", str(len(body)))
            if trace_id:
                self.send_header("X-Trace-Id", trace_id)
            if retry_after_s is not None:
                self.send_header("Retry-After",
                                 str(retry_after_seconds(retry_after_s)))
            self.end_headers()
            self.wfile.write(body)

        def _trace_id(self) -> str:
            """The request's effective trace ID: the propagated
            ``X-Trace-Id`` when well-formed, else freshly generated —
            the SAME canonicalization the server applies at admission,
            so the echoed header and the recorded ID always agree."""
            return canonical_trace_id(self.headers.get("X-Trace-Id"))

        def do_GET(self):  # noqa: N802 — BaseHTTPRequestHandler API
            # the whole GET surface is the shared
            # get_payload builder — the edge serves the same bytes
            parsed = urllib.parse.urlparse(self.path)
            res = get_payload(server, parsed.path,
                              urllib.parse.parse_qs(parsed.query),
                              self.headers.get("Accept", ""))
            if res is None:
                self._reply(404, {"error": f"no route {self.path}"})
                return
            status, ctype, body = res
            self._reply_bytes(status, body, ctype)

        def do_POST(self):  # noqa: N802 — BaseHTTPRequestHandler API
            if self.path == "/v1/ingest":
                self._post_ingest()
                return
            if self.path == "/v1/discover":
                self._post_discover()
                return
            if self.path == "/v1/debug/dump":
                self._post_dump()
                return
            if self.path != "/v1/query":
                self._reply(404, {"error": f"no route {self.path}"})
                return
            tid = self._trace_id()
            try:
                length = int(self.headers.get("Content-Length", "0"))
                if length > MAX_BODY_BYTES:
                    self._reply(413, {"error": "body too large"}, tid)
                    return
                doc = json.loads(self.rfile.read(length) or b"{}")
                q = query_from_doc(doc,
                                   self.headers.get("Accept", ""))
            except (KeyError, ValueError, TypeError,
                    json.JSONDecodeError) as e:
                self._reply(400, {"error": f"malformed request: {e}"},
                            tid)
                return
            try:
                fut = server.submit(q, trace_id=tid)
            except LoadShedError as e:
                self._reply(503, {"error": str(e), "shed": True}, tid,
                            retry_after_s=e.retry_after_s)
                return
            except ValueError as e:
                self._reply(400, {"error": str(e)}, tid)
                return
            try:
                ctype, body = render_answer(fut.result(timeout), q)
                self._reply_bytes(200, body, ctype, tid)
            except Exception as e:  # noqa: BLE001 — dispatch failure
                self._reply(500, {"error": f"{type(e).__name__}: {e}"},
                            tid)

        def _post_ingest(self):
            # no numpy here: the JSON lists go to the server verbatim
            # and service.py (the boundary module) owns
            # the array conversion + shape validation
            tid = self._trace_id()
            try:
                length = int(self.headers.get("Content-Length", "0"))
                if length > MAX_INGEST_BODY_BYTES:
                    self._reply(413, {"error": "body too large"}, tid)
                    return
                doc = json.loads(self.rfile.read(length) or b"{}")
                bars, present = doc["bars"], doc["present"]
            except (KeyError, ValueError, TypeError,
                    json.JSONDecodeError) as e:
                self._reply(400, {"error": f"malformed ingest: {e}"},
                            tid)
                return
            try:
                fut = server.ingest(bars, present, trace_id=tid)
            except LoadShedError as e:
                self._reply(503, {"error": str(e), "shed": True}, tid,
                            retry_after_s=e.retry_after_s)
                return
            except ValueError as e:
                self._reply(400, {"error": str(e)}, tid)
                return
            try:
                self._reply(200, fut.result(timeout), tid)
            except Exception as e:  # noqa: BLE001 — dispatch failure
                self._reply(500, {"error": f"{type(e).__name__}: {e}"},
                            tid)

        def _post_discover(self):
            tid = self._trace_id()
            try:
                length = int(self.headers.get("Content-Length", "0"))
                if length > MAX_BODY_BYTES:
                    self._reply(413, {"error": "body too large"}, tid)
                    return
                doc = json.loads(self.rfile.read(length) or b"{}")
                kwargs = dict(
                    start=int(doc["start"]), end=int(doc["end"]),
                    generations=int(doc.get("generations", 4)),
                    pop=int(doc.get("pop", 128)),
                    seed=int(doc.get("seed", 0)),
                    horizon=int(doc.get("horizon", 1)),
                    skeleton=str(doc.get("skeleton", "default")))
            except (KeyError, ValueError, TypeError,
                    json.JSONDecodeError) as e:
                self._reply(400, {"error": f"malformed discover: {e}"},
                            tid)
                return
            try:
                fut = server.discover(trace_id=tid, **kwargs)
            except LoadShedError as e:
                self._reply(503, {"error": str(e), "shed": True}, tid,
                            retry_after_s=e.retry_after_s)
                return
            except ValueError as e:
                self._reply(400, {"error": str(e)}, tid)
                return
            try:
                self._reply(200, fut.result(timeout), tid)
            except Exception as e:  # noqa: BLE001 — dispatch failure
                self._reply(500, {"error": f"{type(e).__name__}: {e}"},
                            tid)

        def _post_dump(self):
            try:
                path = server.debug_dump()
            except Exception as e:  # noqa: BLE001 — dump is best-effort
                self._reply(500, {"error": f"{type(e).__name__}: {e}"})
                return
            if path is None:
                self._reply(409, {"error": "no flight dump directory "
                                           "configured "
                                           "(ServeConfig.flight_dir)"})
                return
            self._reply(200, {"path": path,
                              "requests": len(server.flight)})

    return Handler


def serve_http(server: FactorServer, host: str = "127.0.0.1",
               port: int = 0, timeout: Optional[float] = 60.0,
               ) -> Tuple[ThreadingHTTPServer, threading.Thread]:
    """Bind ``server`` on ``host:port`` (0 = ephemeral) and serve from a
    daemon thread. Returns ``(httpd, thread)``; the bound port is
    ``httpd.server_address[1]``; stop with ``httpd.shutdown()``."""
    httpd = ThreadingHTTPServer((host, port),
                                _make_handler(server, timeout))
    httpd.daemon_threads = True
    thread = threading.Thread(target=httpd.serve_forever, daemon=True,
                              name="factor-serve-http")
    thread.start()
    return httpd, thread


def serve_frontdoor(server: FactorServer, host: str = "127.0.0.1",
                    port: int = 0, timeout: Optional[float] = 60.0,
                    transport: Optional[str] = None):
    """Bind the CONFIGURED front door: ``transport`` (or
    ``ServeConfig.edge`` when None) picks the evented selectors loop
    (``'edge'``, :mod:`.edge`) or this module's stdlib
    thread-per-connection server (``'legacy'`` — the A/B and fallback
    path). Returns an object with ``.server_address`` and
    ``.shutdown()`` either way, so callers stop caring which one
    runs."""
    transport = transport or server.scfg.edge
    if transport == "legacy":
        httpd, _thread = serve_http(server, host=host, port=port,
                                    timeout=timeout)
        return httpd
    if transport != "edge":
        raise ValueError(f"unknown front-door transport {transport!r} "
                         "(edge or legacy)")
    from .edge import serve_edge
    return serve_edge(server, host=host, port=port, timeout=timeout)
