"""The port's evented binary front door, held to tests/test_edge.py:
keep-alive connection multiplexing, the result wire carried end to end,
chunked range streaming, per-tenant admission quotas, and the robustness
ladder (malformed requests, slow loris, mid-response disconnects) —
every behaviour of the JAX package's edge tests, against the port's
``FactorServer`` on the CPU (``device='cpu'``). The fleet's pod door is
not ported; in its place the port's wire answers are decoded by the
JAX package's own client decoder.
"""

import json
import socket
import time

import numpy as np
import pytest

from replication_of_minute_frequency_factor_tpu_torch.serve import (
    FactorServer, Query, ServeConfig, SyntheticSource, WireClient,
    WireError, serve_edge, serve_frontdoor)
from replication_of_minute_frequency_factor_tpu_torch.serve.edge import (
    EdgeServer, ServerEdgeBackend)
from replication_of_minute_frequency_factor_tpu_torch.serve.http import (
    WIRE_CONTENT_TYPE)
from replication_of_minute_frequency_factor_tpu_torch.telemetry import Telemetry

NAMES = ("vol_return1min", "mmt_am", "liq_openvol")


def _server(n_days=8, n_tickers=32, names=NAMES, start=True, **scfg):
    tel = Telemetry()
    src = SyntheticSource(n_days=n_days, n_tickers=n_tickers, seed=3)
    srv = FactorServer(src, names=names, telemetry=tel,
                       serve_cfg=ServeConfig(**scfg), start=start,
                       device="cpu")
    return srv, tel


def _connect(door):
    host, port = door.server_address[:2]
    sock = socket.create_connection((host, port), timeout=30)
    sock.settimeout(30)
    return sock


def _request_bytes(method, path, body=b"", headers=()):
    head = [f"{method} {path} HTTP/1.1", "Host: edge"]
    head += [f"{k}: {v}" for k, v in headers]
    if body or method == "POST":
        head.append(f"Content-Length: {len(body)}")
    return ("\r\n".join(head) + "\r\n\r\n").encode("latin-1") + body


def _read_response(sock, buf=b""):
    """One buffered HTTP response off ``sock`` ->
    ``(status, headers, body, leftover)`` — leftover carries any bytes
    of the NEXT pipelined response already received."""
    while b"\r\n\r\n" not in buf:
        data = sock.recv(65536)
        if not data:
            raise ConnectionError("peer closed before headers")
        buf += data
    head, _, rest = buf.partition(b"\r\n\r\n")
    lines = head.decode("latin-1").split("\r\n")
    status = int(lines[0].split()[1])
    headers = {}
    for line in lines[1:]:
        key, _, value = line.partition(":")
        headers[key.strip().lower()] = value.strip()
    length = int(headers.get("content-length", "0"))
    while len(rest) < length:
        data = sock.recv(65536)
        if not data:
            raise ConnectionError("peer closed mid-body")
        rest += data
    return status, headers, rest[:length], rest[length:]


def _wait_counter(reg, name, minimum=1.0, deadline_s=30.0, **labels):
    t0 = time.monotonic()
    while time.monotonic() - t0 < deadline_s:
        value = (reg.counter_value(name, **labels) if labels
                 else reg.counter_total(name))
        if value >= minimum:
            return value
        time.sleep(0.02)
    raise AssertionError(f"counter {name} never reached {minimum}")


# --------------------------------------------------------------------------
# the result wire end to end
# --------------------------------------------------------------------------


def test_http_wire_answer_byte_identical_to_host_dequantize():
    """The packed payload the
    edge ships is the SAME buffer the in-process wire answer carries,
    so the HTTP client's dequantize and the host-side dequantize of
    the in-process answer agree BYTE for byte."""
    srv, _tel = _server()
    door = serve_edge(srv)
    cli = WireClient(*door.server_address[:2])
    try:
        http_out, meta = cli.query_wire(0, 8)
        inproc_out, inproc_meta = srv.client().factors_wire(0, 8)
        assert http_out.dtype == np.float32
        assert http_out.shape == (len(NAMES), 8, 32)
        assert http_out.tobytes() == inproc_out.tobytes()
        assert meta["payload_bytes"] == inproc_meta["payload_bytes"]
        # the exposure block was served from the SAME cached entry
        assert meta["n_factors"] == len(NAMES)
    finally:
        cli.close()
        door.shutdown()
        srv.close()


def test_wire_answers_reuse_one_connection():
    """Keep-alive is the default: any number of wire answers ride one
    TCP connection — exactly one ``edge.conns_opened`` for the whole
    cycle."""
    srv, tel = _server()
    door = serve_edge(srv)
    cli = WireClient(*door.server_address[:2])
    try:
        for _ in range(5):
            cli.query_wire(0, 4)
        reg = tel.registry
        assert reg.counter_total("edge.conns_opened") == 1
        assert reg.counter_value("edge.answers", encoding="wire") == 5
    finally:
        cli.close()
        door.shutdown()
        srv.close()


def test_chunked_stream_reassembles_to_buffered():
    """A ``chunk_days`` range answer streams >= 2 framed chunks and
    reassembles byte-identically to the buffered answer for the same
    range; a chunk size covering the whole range stays buffered."""
    srv, tel = _server()
    door = serve_edge(srv)
    cli = WireClient(*door.server_address[:2])
    try:
        buffered, _ = cli.query_wire(0, 8)
        chunked, meta = cli.query_wire(0, 8, chunk_days=2)
        assert meta["frames"] == 4
        assert meta["ranges"] == [(0, 2), (2, 4), (4, 6), (6, 8)]
        assert chunked.tobytes() == buffered.tobytes()
        assert tel.registry.counter_total("edge.chunks") == 4
        whole, meta1 = cli.query_wire(0, 4, chunk_days=8)
        assert meta1["frames"] == 1
        assert whole.tobytes() == buffered[:, :4, :].tobytes()
    finally:
        cli.close()
        door.shutdown()
        srv.close()


def test_chunking_requires_wire_factors():
    """``chunk_days`` outside its contract is a clean 400: JSON accept
    (no frame format to stream) and negative values both refuse."""
    srv, _tel = _server()
    door = serve_edge(srv)
    cli = WireClient(*door.server_address[:2])
    try:
        status, _hdrs, body = cli.post_json(
            "/v1/query",
            {"kind": "factors", "start": 0, "end": 4, "chunk_days": 2})
        assert status == 400
        assert "chunk_days" in json.loads(body)["error"]
        status, _hdrs, body = cli.post_json(
            "/v1/query",
            {"kind": "factors", "start": 0, "end": 4,
             "chunk_days": -1},
            headers={"Accept": WIRE_CONTENT_TYPE})
        assert status == 400
    finally:
        cli.close()
        door.shutdown()
        srv.close()


# --------------------------------------------------------------------------
# parity with the legacy door
# --------------------------------------------------------------------------


def test_get_surface_parity_legacy_vs_edge():
    """Both doors answer the whole GET surface through the SAME
    :func:`serve.http.get_payload`: status, content type and document
    shape agree endpoint by endpoint."""
    srv, _tel = _server()
    legacy = serve_frontdoor(srv, transport="legacy")
    edge = serve_frontdoor(srv, transport="edge")
    lcli = WireClient(*legacy.server_address[:2])
    ecli = WireClient(*edge.server_address[:2])
    try:
        for path in ("/healthz", "/v1/factors", "/v1/metrics",
                     "/v1/slo", "/v1/timeline?window=60"):
            ls, _lh, lbody = lcli.request("GET", path)
            es, _eh, ebody = ecli.request("GET", path)
            assert ls == es == 200, path
            ldoc, edoc = json.loads(lbody), json.loads(ebody)
            assert type(ldoc) is type(edoc), path
            if isinstance(ldoc, dict):
                # counters move between the two calls (the doors share
                # one registry); the SHAPE may not
                assert set(ldoc) == set(edoc), path
        for cli in (lcli, ecli):
            status, _h, body = cli.request("GET", "/nope")
            assert status == 404
            assert "error" in json.loads(body)
    finally:
        lcli.close()
        ecli.close()
        legacy.shutdown()
        legacy.server_close()
        edge.shutdown()
        srv.close()


def test_query_json_parity_and_trace_id_round_trip():
    """The same JSON query through both doors returns the same
    exposures, and an ``X-Trace-Id`` echoes back verbatim from both."""
    srv, _tel = _server()
    legacy = serve_frontdoor(srv, transport="legacy")
    edge = serve_frontdoor(srv, transport="edge")
    lcli = WireClient(*legacy.server_address[:2])
    ecli = WireClient(*edge.server_address[:2])
    doc = {"kind": "factors", "start": 0, "end": 4,
           "names": [NAMES[0]]}
    try:
        ls, lh, lbody = lcli.post_json(
            "/v1/query", doc, headers={"X-Trace-Id": "edge-parity-1"})
        es, eh, ebody = ecli.post_json(
            "/v1/query", doc, headers={"X-Trace-Id": "edge-parity-2"})
        assert ls == es == 200
        assert lh.get("x-trace-id") == "edge-parity-1"
        assert eh.get("x-trace-id") == "edge-parity-2"
        lexp = json.loads(lbody)["exposures"][NAMES[0]]
        eexp = json.loads(ebody)["exposures"][NAMES[0]]
        np.testing.assert_array_equal(np.asarray(lexp),
                                      np.asarray(eexp))
        # the wire negotiation answers the legacy door too — the
        # payload bytes agree with the edge's
        ls, lh, lbody = lcli.post_json(
            "/v1/query", {"kind": "factors", "start": 0, "end": 4},
            headers={"Accept": WIRE_CONTENT_TYPE})
        es, eh, ebody = ecli.post_json(
            "/v1/query", {"kind": "factors", "start": 0, "end": 4},
            headers={"Accept": WIRE_CONTENT_TYPE})
        assert ls == es == 200
        assert lh["content-type"] == eh["content-type"] \
            == WIRE_CONTENT_TYPE
        assert lbody == ebody
    finally:
        lcli.close()
        ecli.close()
        legacy.shutdown()
        legacy.server_close()
        edge.shutdown()
        srv.close()


def test_frontdoor_transport_selection():
    """``ServeConfig.edge`` picks the door; an unknown transport is a
    loud ValueError, not a silent fallback."""
    srv, _tel = _server(edge="legacy")
    try:
        door = serve_frontdoor(srv)
        assert not isinstance(door, EdgeServer)
        door.shutdown()
        door.server_close()
        door = serve_frontdoor(srv, transport="edge")
        assert isinstance(door, EdgeServer)
        door.shutdown()
        with pytest.raises(ValueError):
            serve_frontdoor(srv, transport="carrier-pigeon")
    finally:
        srv.close()


# --------------------------------------------------------------------------
# multiplexing
# --------------------------------------------------------------------------


def test_pipelined_requests_flush_in_request_order():
    """A client may write request N+1 before answer N arrives; the
    edge dispatches both but flushes strictly in request order — a
    wire query then a healthz GET written back-to-back come back as
    (wire, json) in that order on one connection."""
    srv, tel = _server()
    door = serve_edge(srv)
    sock = _connect(door)
    try:
        body = json.dumps({"kind": "factors", "start": 0,
                           "end": 4}).encode()
        sock.sendall(_request_bytes(
            "POST", "/v1/query", body,
            headers=[("Content-Type", "application/json"),
                     ("Accept", WIRE_CONTENT_TYPE)])
            + _request_bytes("GET", "/healthz"))
        s1, h1, b1, rest = _read_response(sock)
        s2, h2, b2, _ = _read_response(sock, rest)
        assert s1 == 200 and h1["content-type"] == WIRE_CONTENT_TYPE
        assert s2 == 200 and "json" in h2["content-type"]
        assert json.loads(b2)["factors"] == len(NAMES)
        assert tel.registry.counter_total("edge.conns_opened") == 1
    finally:
        sock.close()
        door.shutdown()
        srv.close()


def test_connection_close_honored_after_final_answer():
    """``Connection: close`` still answers the request, then drops the
    connection once the response has flushed."""
    srv, _tel = _server()
    door = serve_edge(srv)
    sock = _connect(door)
    try:
        sock.sendall(_request_bytes("GET", "/healthz",
                                    headers=[("Connection", "close")]))
        status, _headers, body, _rest = _read_response(sock)
        assert status == 200
        assert json.loads(body)["ok"] is True
        assert sock.recv(4096) == b""  # flushed, then dropped
    finally:
        sock.close()
        door.shutdown()
        srv.close()


# --------------------------------------------------------------------------
# robustness: malformed input, slow loris, disconnects
# --------------------------------------------------------------------------


def test_malformed_request_line_is_400_and_close():
    srv, tel = _server()
    door = serve_edge(srv)
    try:
        for raw in (b"GARBAGE\r\n\r\n",
                    b"GET /healthz HTTP/2.0\r\n\r\n",
                    b"GET /healthz HTTP/1.1\r\nbroken line\r\n\r\n",
                    b"POST /v1/query HTTP/1.1\r\n"
                    b"Content-Length: banana\r\n\r\n",
                    b"POST /v1/query HTTP/1.1\r\n"
                    b"Transfer-Encoding: chunked\r\n\r\n"):
            sock = _connect(door)
            try:
                sock.sendall(raw)
                status, _h, body, _rest = _read_response(sock)
                assert status in (400, 505), raw
                assert "error" in json.loads(body)
                assert sock.recv(4096) == b""  # malformation closes
            finally:
                sock.close()
        assert tel.registry.counter_total("edge.http_errors") >= 5
    finally:
        door.shutdown()
        srv.close()


def test_truncated_json_body_is_400_but_keeps_the_connection():
    """A syntactically complete request with an undecodable body is
    the CLIENT's bug, not a protocol breakdown: 400, connection stays
    usable for the next request."""
    srv, _tel = _server()
    door = serve_edge(srv)
    sock = _connect(door)
    try:
        sock.sendall(_request_bytes(
            "POST", "/v1/query", b'{"kind": "fac',
            headers=[("Content-Type", "application/json")]))
        status, _h, body, rest = _read_response(sock)
        assert status == 400
        assert "malformed" in json.loads(body)["error"]
        sock.sendall(_request_bytes("GET", "/healthz"))
        status, _h, _body, _rest = _read_response(sock, rest)
        assert status == 200
    finally:
        sock.close()
        door.shutdown()
        srv.close()


def test_oversized_body_is_413():
    srv, _tel = _server()
    door = serve_edge(srv)
    sock = _connect(door)
    try:
        sock.sendall(b"POST /v1/query HTTP/1.1\r\n"
                     b"Content-Length: 99999999\r\n\r\n")
        status, _h, _body, _rest = _read_response(sock)
        assert status == 413
    finally:
        sock.close()
        door.shutdown()
        srv.close()


def test_slow_loris_is_reaped_by_the_idle_timeout():
    """A peer that dribbles half a request forever is reaped after
    ``idle_timeout_s`` — never parked on a blocked thread — and the
    door keeps serving everyone else."""
    srv, tel = _server()
    door = EdgeServer(ServerEdgeBackend(srv), idle_timeout_s=0.3,
                      tick_s=0.05)
    sock = _connect(door)
    cli = WireClient(*door.server_address[:2])
    try:
        sock.sendall(b"POST /v1/query HTTP/1.1\r\nCont")
        assert sock.recv(4096) == b""  # reaped, no response owed
        _wait_counter(tel.registry, "edge.conns_closed", reason="idle")
        out, _meta = cli.query_wire(0, 4)
        assert out.shape == (len(NAMES), 4, 32)
    finally:
        cli.close()
        sock.close()
        door.shutdown()
        srv.close()


def test_in_flight_dispatch_is_never_reaped_as_idle():
    """The idle reaper only fires on connections with NO answer in
    flight: a request the server is still computing keeps its
    connection alive past the timeout."""
    srv, tel = _server(start=False)  # queue paused: answers pend
    door = EdgeServer(ServerEdgeBackend(srv), idle_timeout_s=0.2,
                      tick_s=0.05)
    sock = _connect(door)
    try:
        body = json.dumps({"kind": "factors", "start": 0,
                           "end": 4}).encode()
        sock.sendall(_request_bytes(
            "POST", "/v1/query", body,
            headers=[("Content-Type", "application/json")]))
        time.sleep(0.8)  # several timeouts with the dispatch in flight
        assert tel.registry.counter_value("edge.conns_closed",
                                          reason="idle") == 0
        srv.start()
        status, _h, _body, _rest = _read_response(sock)
        assert status == 200
    finally:
        sock.close()
        door.shutdown()
        srv.close()


def test_mid_response_disconnect_orphans_the_answer():
    """A client that vanishes mid-request is reaped when the loop sees
    EOF; its in-flight answer resolves into ``edge.orphan_answers``
    (the worker never blocks on the dead socket) and the door keeps
    serving."""
    srv, tel = _server(start=False)  # paused: the answer can't win
    door = serve_edge(srv)
    sock = _connect(door)
    body = json.dumps({"kind": "factors", "start": 0,
                       "end": 4}).encode()
    sock.sendall(_request_bytes(
        "POST", "/v1/query", body,
        headers=[("Content-Type", "application/json")]))
    time.sleep(0.1)  # let the loop parse + dispatch
    sock.close()     # vanish before the answer exists
    try:
        _wait_counter(tel.registry, "edge.conns_closed",
                      reason="peer_closed")
        srv.start()  # now the answer completes — into a dead slot
        _wait_counter(tel.registry, "edge.orphan_answers")
        cli = WireClient(*door.server_address[:2])
        try:
            out, _meta = cli.query_wire(0, 4)
            assert out.shape == (len(NAMES), 4, 32)
        finally:
            cli.close()
    finally:
        door.shutdown()
        srv.close()


# --------------------------------------------------------------------------
# per-tenant admission quotas
# --------------------------------------------------------------------------


def test_tenant_quota_429_retry_after_and_isolation():
    """Token buckets meter PER TENANT: exhausting one tenant's burst
    answers 429 + Retry-After + the ``quota`` marker (the shed
    contract's mirror) while another tenant is untouched; GETs are
    never metered."""
    srv, tel = _server(tenant_quota_rps=0.2, tenant_quota_burst=2.0)
    door = serve_edge(srv)
    a = WireClient(*door.server_address[:2], tenant="tenant-a")
    b = WireClient(*door.server_address[:2], tenant="tenant-b")
    try:
        a.query_wire(0, 4)
        a.query_wire(0, 4)
        with pytest.raises(WireError) as err:
            a.query_wire(0, 4)
        assert err.value.status == 429
        assert err.value.retry_after is not None
        assert err.value.retry_after >= 1.0
        assert err.value.doc.get("quota") is True
        out, _meta = b.query_wire(0, 4)  # b's bucket is its own
        assert out.shape == (len(NAMES), 4, 32)
        status, _h, _body = a.request("GET", "/healthz")
        assert status == 200  # the GET surface is not metered
        assert tel.registry.counter_value("edge.quota_rejected",
                                          tenant="tenant-a") == 1.0
    finally:
        a.close()
        b.close()
        door.shutdown()
        srv.close()


def test_quota_off_by_default():
    srv, _tel = _server()
    door = serve_edge(srv)
    cli = WireClient(*door.server_address[:2], tenant="anyone")
    try:
        for _ in range(8):
            cli.query_wire(0, 4)
    finally:
        cli.close()
        door.shutdown()
        srv.close()


# --------------------------------------------------------------------------
# the JAX package's client reads the port's wire
# --------------------------------------------------------------------------


def test_jax_wire_client_decodes_the_ports_edge_answers():
    """The frames the port's edge ships are the JAX package's frame
    format: its ``WireClient`` decodes them, buffered and chunked, to
    the same bytes the port's own client does."""
    from replication_of_minute_frequency_factor_tpu.serve import (
        WireClient as JaxWireClient)
    srv, _tel = _server()
    door = serve_edge(srv)
    cli = WireClient(*door.server_address[:2])
    jcli = JaxWireClient(*door.server_address[:2])
    try:
        out, meta = cli.query_wire(0, 8)
        jout, jmeta = jcli.query_wire(0, 8)
        assert out.shape == (len(NAMES), 8, 32)
        assert jout.tobytes() == out.tobytes()
        assert jmeta["payload_bytes"] == meta["payload_bytes"]
        chunked, cmeta = jcli.query_wire(0, 8, chunk_days=4)
        assert cmeta["frames"] == 2
        assert chunked.tobytes() == out.tobytes()
    finally:
        cli.close()
        jcli.close()
        door.shutdown()
        srv.close()
