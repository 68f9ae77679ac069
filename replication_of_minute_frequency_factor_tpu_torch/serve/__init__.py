"""serve/ — the long-lived factor service.

The port of the JAX package's ``serve/`` package, with the same exports:

* :mod:`.executables` — :class:`ExecutableCache`, the keyed cache of
  built callables: build-once semantics, counted
  (``serve.executables{outcome=hit|miss}``), so "did this request build
  anything" is a registry counter, not a guess;
* :mod:`.expcache` — :class:`DeviceExposureCache`, computed
  ``[F, days, tickers]`` exposure blocks held in device memory under an
  explicit byte budget with LRU eviction and hit/miss/eviction counters;
* :mod:`.engine` — the device-facing compute: wire-decode + factor graph
  + daily-close per day-range block, and the IC / decile query graphs,
  all built through the executable cache;
* :mod:`.source` — data sources (:class:`SyntheticSource` for
  tests and demos, :class:`MinuteDirSource` over a directory of day
  files);
* :mod:`.service` — :class:`FactorServer`: the async request queue that
  micro-batches concurrent queries and COALESCES same-day-range ones
  into one block build, with per-request latency histograms,
  queue-depth/in-flight gauges and a load-shedding circuit breaker;
* :mod:`.http` — a stdlib-only HTTP/JSON binding (``serve_http``),
  plus the shared endpoint library both front doors answer through;
* :mod:`.edge` — the evented front door: one selectors loop,
  persistent keep-alive connections, pipelined multiplexing, the result
  wire end to end, chunked range streaming, per-tenant quotas
  (``serve_frontdoor`` picks edge vs legacy by ``ServeConfig.edge``);
* :mod:`.wireclient` — the first-party result-wire decoder +
  keep-alive :class:`WireClient`.

Streaming: ``FactorServer(stream=True)`` additionally owns a
:class:`..stream.engine.StreamEngine` — minute bars ingest through the
same request queue (:class:`Ingest`, ``POST /v1/ingest``) and
``Query(kind="intraday")`` serves the carry's partial-day exposures.
Discovery: ``FactorServer(research=True)`` additionally owns a
:class:`..research.evolve.DiscoveryEngine` — bounded evolutionary
searches run as :class:`Discover` jobs on the same queue (``POST
/v1/discover``), the winning genome registers as a live ``disc_<hash>``
factor, and ``GET /v1/factors`` lists built-in + discovered names.

Run it: ``python -m replication_of_minute_frequency_factor_tpu_torch
serve`` (``--device cpu`` on a machine without a card).
"""

from __future__ import annotations

from .executables import ExecutableCache
from .expcache import DeviceExposureCache
from .source import MinuteDirSource, SyntheticSource
from .service import (Discover, FactorServer, Ingest, LoadShedError,
                      Query, ServeConfig, ServeClient)
from .http import WIRE_CONTENT_TYPE, serve_frontdoor, serve_http
from .edge import EdgeServer, serve_edge
from .wireclient import WireClient, WireError, decode_answer, \
    decode_frames

__all__ = [
    "DeviceExposureCache", "Discover", "EdgeServer",
    "ExecutableCache", "FactorServer", "Ingest", "LoadShedError",
    "MinuteDirSource", "Query", "ServeClient", "ServeConfig",
    "SyntheticSource", "WIRE_CONTENT_TYPE", "WireClient", "WireError",
    "decode_answer", "decode_frames", "serve_edge", "serve_frontdoor",
    "serve_http",
]
