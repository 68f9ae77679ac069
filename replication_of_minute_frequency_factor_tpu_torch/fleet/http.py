"""The pod front door: one HTTP surface multiplexing N replicas.

The port of the JAX package's ``fleet/http.py``. Same stdlib-only shape
as :mod:`..serve.http` (one thread per connection feeding the replicas'
micro-batch windows), same endpoints — a client cannot tell a pod from a
single server except by reading the payloads:

* ``POST /v1/query`` — routed by the coalescing-affinity key
  (:meth:`..fleet.router.FleetRouter.submit`); 503 + ``Retry-After``
  when the POD sheds (every candidate out) exactly like a single
  server's breaker shed.
* ``POST /v1/ingest`` — the fan-out: 200 with the per-replica leg map
  as long as ANY leg applied (failure isolation is the point — the
  response SAYS which legs failed/skipped), 503 only when none did.
* ``GET /healthz`` — per-replica payloads (the server's own shape)
  + the pod rollup (live/demoted, policy states, stream cursor skew,
  and the ``factor_health`` block: each replica's worst-coverage factor
  / widen rate / drift bursts read verbatim from its own healthz
  payload, with the stream cursor skew beside them).
* ``GET /v1/metrics`` — the POD registry: the control plane + every
  replica registry folded through ``telemetry.aggregate``'s
  registry-merge (:func:`pod_registry` — counters exact; never an
  ad-hoc merger). JSON by default, Prometheus text on content
  negotiation, same as the single server.
* ``GET /v1/slo`` — the POD SLO plane: the fleet's burn-rate objectives
  (availability over routed vs pod sheds, pod ingest freshness) as
  JSON, or the ``slo_*``-only Prometheus view of the CONTROL-PLANE
  registry under the same content negotiation.
* ``GET /v1/timeline?name=&since=`` — the pod timeline: control-plane
  rates + derived per-replica liveness/freshness series, same query
  surface as the single server.
* ``POST /v1/debug/dump`` — fans the on-demand flight capture out to
  every replica; returns ``{label: path}``.

Trace IDs: ``X-Trace-Id`` in/out as in :mod:`..serve.http`; the pod
assigns one ID at admission and the same ID crosses the router→replica
hop, so the two telemetry streams join on it.
"""

from __future__ import annotations

import json
import threading
import urllib.parse
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional, Tuple

from ..serve.http import (MAX_BODY_BYTES, MAX_INGEST_BODY_BYTES,
                          query_from_doc, render_answer,
                          retry_after_seconds, wants_prometheus)
from ..serve.service import LoadShedError, Query
from ..telemetry.opsplane import canonical_trace_id, to_prometheus
from .router import FactorFleet


def pod_registry(fleet: FactorFleet):
    """The pod metrics registry: the fleet control plane + every
    replica registry through :func:`..telemetry.aggregate
    .merge_registries` — the SAME fold the multihost bundle aggregator
    runs, so pod counter totals equal the per-replica sums by
    construction."""
    from ..telemetry.aggregate import merge_registries
    return merge_registries(
        [fleet.telemetry.registry]
        + [r.telemetry.registry for r in fleet.replicas])


def fleet_get_payload(fleet: FactorFleet, path: str, query: dict,
                      accept: str = ""
                      ) -> Optional[Tuple[int, str, bytes]]:
    """The pod GET surface -> ``(status, content_type, body)`` or None
    for an unknown route — ONE implementation for the legacy binding
    and the evented edge, the fleet twin of
    :func:`..serve.http.get_payload`."""
    if path == "/healthz":
        return 200, "application/json", \
            json.dumps(fleet.health()).encode()
    if path == "/v1/metrics":
        reg = pod_registry(fleet)
        if wants_prometheus(accept, query):
            return 200, "text/plain; version=0.0.4; charset=utf-8", \
                to_prometheus(reg).encode()
        return 200, "application/json", \
            json.dumps(reg.snapshot()).encode()
    if path == "/v1/slo":
        if wants_prometheus(accept, query):
            from ..telemetry.slo import slo_prometheus
            return 200, "text/plain; version=0.0.4; charset=utf-8", \
                slo_prometheus(fleet.telemetry.registry).encode()
        return 200, "application/json", json.dumps({
            "slo": fleet.sloplane.summary(),
            "evaluation": fleet.sloplane.evaluate(),
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
        frames = fleet.timeline.query(name=name, since=since,
                                      limit=limit)
        return 200, "application/json", json.dumps(
            {"frames": frames, "count": len(frames)}).encode()
    return None


def _dump_doc(fleet: FactorFleet) -> Tuple[int, dict]:
    """The fan-out flight capture shared by both front doors."""
    paths = {}
    for r in fleet.replicas:
        try:
            paths[r.label] = r.server.debug_dump()
        except Exception as e:  # noqa: BLE001 — best-effort
            paths[r.label] = f"error: {type(e).__name__}: {e}"
    if all(p is None for p in paths.values()):
        return 409, {"error": "no flight dump directory configured "
                              "on any replica "
                              "(ServeConfig.flight_dir)"}
    return 200, {"paths": paths}


def _make_handler(fleet: FactorFleet, timeout: Optional[float]):
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
            return canonical_trace_id(self.headers.get("X-Trace-Id"))

        def do_GET(self):  # noqa: N802 — BaseHTTPRequestHandler API
            # the whole GET surface is the shared fleet_get_payload —
            # the edge serves the same bytes by construction
            parsed = urllib.parse.urlparse(self.path)
            res = fleet_get_payload(fleet, parsed.path,
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
                # the ONE parser both serve front doors use (wire
                # encoding negotiated from Accept / the body)
                q = query_from_doc(doc, self.headers.get("Accept", ""))
            except (KeyError, ValueError, TypeError,
                    json.JSONDecodeError) as e:
                self._reply(400, {"error": f"malformed request: {e}"},
                            tid)
                return
            try:
                fut = fleet.submit(q, trace_id=tid)
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
                res = fleet.ingest(bars, present, trace_id=tid,
                                   timeout=timeout)
            except LoadShedError as e:
                self._reply(503, {"error": str(e), "shed": True}, tid,
                            retry_after_s=e.retry_after_s)
                return
            except ValueError as e:
                self._reply(400, {"error": str(e)}, tid)
                return
            self._reply(200, res, tid)

        def _post_dump(self):
            status, doc = _dump_doc(fleet)
            self._reply(status, doc)

    return Handler


def serve_fleet_http(fleet: FactorFleet, host: str = "127.0.0.1",
                     port: int = 0, timeout: Optional[float] = 60.0,
                     ) -> Tuple[ThreadingHTTPServer, threading.Thread]:
    """Bind the pod on ``host:port`` (0 = ephemeral) and serve from a
    daemon thread — the fleet twin of :func:`..serve.http.serve_http`;
    stop with ``httpd.shutdown()``."""
    httpd = ThreadingHTTPServer((host, port),
                                _make_handler(fleet, timeout))
    httpd.daemon_threads = True
    thread = threading.Thread(target=httpd.serve_forever, daemon=True,
                              name="factor-fleet-http")
    thread.start()
    return httpd, thread


class FleetEdgeBackend:
    """Adapts one :class:`FactorFleet` to the evented edge's backend
    protocol (see ``..serve.edge``). The pod's ingest
    fan-out is SYNCHRONOUS by contract (it waits every leg's future to
    build the per-leg map), so it runs as an aux-thread call — the
    loop thread never blocks on a replica."""

    label = "fleet"

    def __init__(self, fleet: FactorFleet,
                 timeout: Optional[float] = 60.0):
        self.fleet = fleet
        self.timeout = timeout

    @property
    def telemetry(self):
        return self.fleet.telemetry

    def get(self, path: str, query: dict, accept: str
            ) -> Optional[Tuple[int, str, bytes]]:
        return fleet_get_payload(self.fleet, path, query, accept)

    def submit_query(self, q: Query, tid):
        return self.fleet.submit(q, trace_id=tid)

    def post(self, path: str, doc: dict, tid):
        if path == "/v1/ingest":
            bars, present = doc["bars"], doc["present"]
            fleet, timeout = self.fleet, self.timeout

            def ingest():
                return 200, fleet.ingest(bars, present, trace_id=tid,
                                         timeout=timeout)

            return "call", ingest
        if path == "/v1/debug/dump":
            fleet = self.fleet

            def dump():
                return _dump_doc(fleet)

            return "call", dump
        return None

    def max_body(self, path: str) -> int:
        return (MAX_INGEST_BODY_BYTES if path == "/v1/ingest"
                else MAX_BODY_BYTES)


def serve_fleet_edge(fleet: FactorFleet, host: str = "127.0.0.1",
                     port: int = 0,
                     timeout: Optional[float] = 60.0):
    """Bind the evented front door over one pod — the fleet twin of
    :func:`..serve.edge.serve_edge`; quota/idle knobs come from
    ``FleetConfig``. Returns the running ``EdgeServer``."""
    from ..serve.edge import EdgeServer
    cfg = fleet.cfg
    backend = FleetEdgeBackend(fleet, timeout)
    return EdgeServer(backend, host=host, port=port,
                      quota_rps=cfg.tenant_quota_rps,
                      quota_burst=cfg.tenant_quota_burst,
                      idle_timeout_s=cfg.edge_idle_timeout_s)


def serve_fleet_frontdoor(fleet: FactorFleet, host: str = "127.0.0.1",
                          port: int = 0,
                          timeout: Optional[float] = 60.0,
                          transport: Optional[str] = None):
    """Bind the CONFIGURED pod front door (``FleetConfig.edge``; the
    fleet twin of :func:`..serve.http.serve_frontdoor`). Returns an
    object with ``.server_address`` and ``.shutdown()`` either way."""
    transport = transport or fleet.cfg.edge
    if transport == "legacy":
        httpd, _thread = serve_fleet_http(fleet, host=host, port=port,
                                          timeout=timeout)
        return httpd
    if transport != "edge":
        raise ValueError(f"unknown front-door transport {transport!r} "
                         "(edge or legacy)")
    return serve_fleet_edge(fleet, host=host, port=port,
                            timeout=timeout)
