"""First-party result-wire client decoder.

The serving edge answers ``POST /v1/query`` + ``Accept:
application/x-mff-wire`` with the packed result-wire payload VERBATIM
(framed by :func:`..data.result_wire.pack_frame`, one frame per
buffered answer, one frame per chunk of a streamed range answer).
This module is the other half of that contract:

* :func:`decode_answer` — an IN-PROCESS wire answer dict (what
  ``ServeClient.factors_wire`` gets back from the queue) to
  ``(exposures [F, D, T] f32, meta)``.
* :func:`decode_frames` — an HTTP response body of one or more frames
  to the same ``(exposures, meta)``; chunked range answers arrive in
  COMPLETION order and reassemble here by each frame's ``start``.
* :class:`WireClient` — a persistent keep-alive HTTP/1.1 client used
  by ``bench.py``'s load generators and the fleet tooling; one TCP
  connection serves any number of queries.

Note: everything here operates on ALREADY-FETCHED host bytes
(``np.frombuffer`` over a socket read); the device fetch happened on
the server side at its declared boundary. The module is in the serve
layer's host-sync scope and stays sync-free by construction.
"""

from __future__ import annotations

import http.client
import json
from typing import Any, Dict, Optional, Sequence, Tuple

import numpy as np

from ..data import result_wire as _rw
from .http import WIRE_CONTENT_TYPE


class WireError(RuntimeError):
    """A non-200 (or non-wire) answer to a wire query. Carries the
    HTTP ``status``, the decoded error ``doc`` and the parsed
    ``retry_after`` hint (seconds, None when absent) so callers can
    honor the shed/quota backoff contract without re-parsing."""

    def __init__(self, status: int, doc: dict,
                 retry_after: Optional[float] = None):
        super().__init__(f"wire query failed: HTTP {status} "
                         f"{doc.get('error', '')}".strip())
        self.status = status
        self.doc = doc
        self.retry_after = retry_after


def _strip_verdict(verdict: dict) -> dict:
    # the sidx plane is for parity gates, not JSON-able client meta
    return {k: v for k, v in verdict.items() if k != "sidx"}


def decode_answer(ans: dict, telemetry=None
                  ) -> Tuple[np.ndarray, Dict[str, Any]]:
    """One in-process wire answer dict -> ``(exposures, meta)``."""
    buf = ans["payload"]
    if not isinstance(buf, np.ndarray):
        buf = np.frombuffer(buf, dtype=np.uint8)
    names = ans.get("names")
    out, verdict = _rw.decode_block(
        buf, ans["n_factors"], ans["days"], ans["tickers"],
        ans["spill_rows"], telemetry=telemetry, names=names)
    meta = {
        "start": ans.get("start"), "end": ans.get("end"),
        "n_factors": int(ans["n_factors"]), "days": int(ans["days"]),
        "tickers": int(ans["tickers"]),
        "spill_rows": int(ans["spill_rows"]),
        "names": list(names or ()), "frames": 1,
        "payload_bytes": int(buf.nbytes),
        "verdict": _strip_verdict(verdict),
    }
    return out, meta


def decode_frames(body: bytes, telemetry=None,
                  names: Optional[Sequence[str]] = None
                  ) -> Tuple[np.ndarray, Dict[str, Any]]:
    """An HTTP wire body (>= 1 frames) -> ``(exposures, meta)``.

    Frames of a chunked range answer flush in completion order; each
    frame's header carries its ``(start, end)`` day range, so
    reassembly sorts by ``start`` and concatenates on the day axis —
    byte-identical to the buffered answer for the same range."""
    blocks = []
    for meta, payload in _rw.iter_frames(body):
        out, verdict = _rw.decode_block(
            payload, meta["n_factors"], meta["days"], meta["tickers"],
            meta["spill_rows"], telemetry=telemetry, names=names)
        blocks.append((meta, out, verdict))
    if not blocks:
        raise ValueError("wire body carried no frames")
    first = blocks[0][0]
    for meta, _out, _v in blocks[1:]:
        if (meta["n_factors"], meta["tickers"]) \
                != (first["n_factors"], first["tickers"]):
            raise ValueError("frames disagree on block geometry: "
                             f"{meta} vs {first}")
    blocks.sort(key=lambda b: b[0]["start"])
    out = (blocks[0][1] if len(blocks) == 1
           else np.concatenate([b[1] for b in blocks], axis=1))
    meta = {
        "start": blocks[0][0]["start"], "end": blocks[-1][0]["end"],
        "n_factors": first["n_factors"], "days": int(out.shape[1]),
        "tickers": first["tickers"],
        "spill_rows": first["spill_rows"],
        "frames": len(blocks),
        "payload_bytes": sum(b[0]["payload_bytes"] for b in blocks),
        "ranges": [(b[0]["start"], b[0]["end"]) for b in blocks],
        "verdict": _strip_verdict(blocks[0][2]) if len(blocks) == 1
        else {"frames": [_strip_verdict(b[2]) for b in blocks]},
    }
    return out, meta


class WireClient:
    """A persistent keep-alive HTTP client for either front door.

    One ``http.client.HTTPConnection`` is reused across requests
    (reconnecting ONCE on a stale keep-alive socket); ``tenant`` goes
    out as ``X-Tenant`` on every request so the edge's token buckets
    meter the right principal. Not thread-safe — bench gives each
    load-generator thread its own instance."""

    def __init__(self, host: str, port: int, timeout: float = 60.0,
                 tenant: Optional[str] = None, telemetry=None):
        self.host = host
        self.port = int(port)
        self.timeout = timeout
        self.tenant = tenant
        self.telemetry = telemetry
        self._conn: Optional[http.client.HTTPConnection] = None

    # -- transport ----------------------------------------------------

    def _connection(self) -> http.client.HTTPConnection:
        if self._conn is None:
            self._conn = http.client.HTTPConnection(
                self.host, self.port, timeout=self.timeout)
        return self._conn

    def close(self) -> None:
        if self._conn is not None:
            self._conn.close()
            self._conn = None

    def request(self, method: str, path: str, body: bytes = None,
                headers: Optional[Dict[str, str]] = None
                ) -> Tuple[int, Dict[str, str], bytes]:
        """One request over the persistent connection ->
        ``(status, lowercased headers, body)``."""
        hdrs = dict(headers or ())
        if self.tenant:
            hdrs.setdefault("X-Tenant", self.tenant)
        last: Optional[Exception] = None
        for attempt in range(2):
            conn = self._connection()
            try:
                conn.request(method, path, body=body, headers=hdrs)
                resp = conn.getresponse()
                data = resp.read()
                return (resp.status,
                        {k.lower(): v for k, v in resp.getheaders()},
                        data)
            except (http.client.HTTPException, OSError) as e:
                # a stale keep-alive socket (server reaped the idle
                # connection) fails exactly once; reconnect and retry
                last = e
                self.close()
        raise last  # type: ignore[misc]

    # -- JSON surface -------------------------------------------------

    def get_json(self, path: str) -> Tuple[int, Any]:
        status, _hdrs, data = self.request("GET", path)
        return status, json.loads(data)

    def post_json(self, path: str, doc: dict,
                  headers: Optional[Dict[str, str]] = None
                  ) -> Tuple[int, Dict[str, str], bytes]:
        hdrs = {"Content-Type": "application/json"}
        hdrs.update(headers or ())
        return self.request("POST", path,
                            body=json.dumps(doc).encode(),
                            headers=hdrs)

    def query_json(self, doc: dict) -> Tuple[int, Any]:
        status, _hdrs, data = self.post_json("/v1/query", doc)
        return status, json.loads(data)

    # -- the wire -----------------------------------------------------

    def query_wire(self, start: int, end: int, *,
                   chunk_days: Optional[int] = None
                   ) -> Tuple[np.ndarray, Dict[str, Any]]:
        """A wire-encoded full-set factors query ->
        ``(exposures [F, D, T] f32, meta)``. ``chunk_days`` asks the
        edge to stream the range as framed chunks (reassembled here);
        sheds and quota refusals raise :class:`WireError` with the
        server's ``Retry-After`` hint."""
        doc: Dict[str, Any] = {"kind": "factors", "start": int(start),
                               "end": int(end)}
        if chunk_days:
            doc["chunk_days"] = int(chunk_days)
        status, hdrs, data = self.post_json(
            "/v1/query", doc, headers={"Accept": WIRE_CONTENT_TYPE})
        if status != 200:
            try:
                err = json.loads(data)
            except (ValueError, json.JSONDecodeError):
                err = {"error": data[:200].decode("latin-1")}
            ra = hdrs.get("retry-after")
            raise WireError(status, err,
                            float(ra) if ra is not None else None)
        if WIRE_CONTENT_TYPE not in hdrs.get("content-type", ""):
            raise WireError(status, {"error": "server answered "
                                              "JSON where wire was "
                                              "negotiated"})
        return decode_frames(data, telemetry=self.telemetry)
