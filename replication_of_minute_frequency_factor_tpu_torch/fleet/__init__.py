"""fleet/ — N FactorServer replicas as ONE pod.

The port of the JAX package's ``fleet/``. ``serve/`` made the pipeline a
resident process; this package multiplies it, in one process: each
replica is a :class:`..serve.service.FactorServer` with its own worker
thread, pinned to the first device of its group. The fleet composes what
the server already has — the executable cache, the device-resident
exposure cache, the coalescing micro-batch queue and breaker, streaming
ingest, the flight recorder, HBM watermarks and the Prometheus scrape,
and the multihost bundle aggregation:

* :mod:`.replica` — :func:`partition_devices` (disjoint per-replica
  device groups) + :class:`Replica`: one FactorServer pinned to its
  group's first device with its own Telemetry, identity-stamped bundles
  (``process_index``/``host``), and the device-liveness probe;
* :mod:`.router` — :class:`FleetRouter`: bounded pod admission +
  **coalescing-aware affinity** (rendezvous hash on the query's
  ``(start, end)`` range, so same-range queries still collapse to one
  dispatch on one replica), ingest fan-out with per-replica failure
  isolation, trace-ID propagation through the hop;
  :class:`FactorFleet` composes replicas + policy + router;
* :mod:`.policy` — :class:`ShedPolicy`: demote/probe/restore driven by
  the breaker and measured HBM; pod-level shed (503 + ``Retry-After``)
  only when every candidate is out;
* :mod:`.http` — the one front door (``/v1/query``, ``/v1/ingest``,
  ``/healthz`` per replica + rollup, ``/v1/metrics`` as the
  registry-merge pod fold), HTTP-compatible with a single server; the
  evented edge binding rides the same payload functions
  (``serve_fleet_frontdoor`` picks edge or legacy by
  ``FleetConfig.edge``).

Run it: ``python -m replication_of_minute_frequency_factor_tpu_torch serve
--fleet N`` (every visible card, split into N groups; ``--device cpu``
runs the N replicas on the CPU).
"""

from __future__ import annotations

from .http import (FleetEdgeBackend, fleet_get_payload, pod_registry,
                   serve_fleet_edge, serve_fleet_frontdoor,
                   serve_fleet_http)
from .policy import ShedPolicy
from .replica import Replica, build_replicas, partition_devices
from .router import FactorFleet, FleetConfig, FleetRouter, FleetShedError

__all__ = [
    "FactorFleet", "FleetConfig", "FleetRouter", "FleetShedError",
    "Replica", "ShedPolicy", "build_replicas", "partition_devices",
    "FleetEdgeBackend", "fleet_get_payload", "pod_registry",
    "serve_fleet_edge", "serve_fleet_frontdoor", "serve_fleet_http",
]
