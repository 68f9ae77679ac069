"""The thin router: one pod surface over N replicas.

The port of the JAX package's ``fleet/router.py``, host code only.
Routing is **coalescing-aware affinity**: the routing key is the query's
``(start, end)`` day-range — the SAME key the replica's micro-batch
queue coalesces on — placed by rendezvous (highest-random-weight)
hashing over the current candidates. Same-range concurrent queries
therefore land on the same replica and still collapse to ONE device
dispatch in its queue, and each range's block callable and exposure
cache entry exists on exactly one replica (cache locality for free).
Intraday queries share one ``intraday`` key; a demotion only remaps the
keys the lost replica owned.

The hash is blake2b over ``label|repr(key)``, the JAX package's, with the
key's integers made Python ints first (:func:`canonical_key`): ``repr``
of a numpy or torch integer is not that of an ``int``, and the owner of
a range must not depend on the integer type a caller used.

Admission is bounded twice: a pod-level in-flight gate here (a router
in front of N bounded queues must not become the unbounded one), then
each replica's own queue/breaker. A replica-level shed reroutes to the
next candidate with the shed replica excluded; a pod with no candidates
sheds with ``Retry-After`` (:class:`FleetShedError`).

Ingest fan-out: :meth:`FleetRouter.ingest` broadcasts one minute-bar
micro-batch to every live stream replica with per-replica failure
isolation — a failed leg fails (and is surfaced) alone, later fan-outs
exclude the demoted replica until the policy re-probes it, and the pod
keeps serving intraday from the healthy carries.

Trace IDs propagate through the hop: the router canonicalizes at pod
admission, records its own ``route`` request record (replica + key),
and hands the SAME ID to the replica — one request is reconstructable
router→replica across the two telemetry streams.

Answer encoding propagates the same way: the router hands the
:class:`Query` to the owning replica VERBATIM, so a wire-encoded query
answers with the replica's packed result-wire payload and the router hop
never re-inflates it to JSON (``fleet.routed_wire`` counts those).

Host syncs: none. The one host conversion is the ``np.asarray`` that
normalizes an ingest body ONCE before the fan-out (N replicas then share
one buffer instead of each paying the conversion).
"""

from __future__ import annotations

import dataclasses
import hashlib
import threading
import time
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..serve.service import LoadShedError, Query
from ..telemetry.opsplane import canonical_trace_id
from .policy import ShedPolicy
from .replica import Replica, build_replicas


class FleetShedError(LoadShedError):
    """Pod-level shed: every routing candidate is out (demoted, queue
    full, breaker open). Carries the ``Retry-After`` hint like every
    other shed."""


@dataclasses.dataclass
class FleetConfig:
    """Pod knobs (per-replica knobs stay on ``ServeConfig``)."""
    #: pod-level in-flight bound across all replicas; past it the
    #: router sheds before touching any replica queue
    admission_limit: int = 4096
    #: seconds a demoted replica drains before the half-open probe
    demote_cooldown_s: float = 1.0
    #: demote when a replica's measured device bytes exceed
    #: ``cache_bytes * hbm_headroom_frac`` (no reading never demotes)
    hbm_headroom_frac: float = 1.5
    #: Retry-After fallback when no demotion cooldown is pending
    retry_after_default_s: float = 1.0
    #: routing keys remembered for the affinity hit-rate counter
    affinity_memory: int = 4096
    #: where POD-level flight dumps (``slo_burn`` on a pod objective)
    #: land (None = counters only). Replica anomaly dumps keep landing
    #: in each replica's own ``ServeConfig.flight_dir``.
    flight_dir: Optional[str] = None
    #: pod timeline sampler period (0 disables). Samples the
    #: CONTROL-PLANE registry (router/policy counters) plus derived
    #: per-replica signals — never the per-replica registry merge,
    #: which is scrape-time work (``/v1/metrics``)
    timeline_sample_period_s: float = 0.5
    #: divides the SLO burn windows (telemetry/slo.BURN_WINDOWS)
    slo_time_scale: float = 1.0
    #: pod freshness objective threshold (s) on the worst live
    #: replica's ingest staleness
    slo_staleness_s: float = 120.0
    #: pod front-door transport: ``'edge'`` = the evented selectors
    #: loop (:func:`.http.serve_fleet_edge`), ``'legacy'`` = stdlib
    #: thread-per-connection (the A/B and fallback path)
    edge: str = "edge"
    #: per-tenant token-bucket rate on the edge (requests/s; 0 = off),
    #: layered ABOVE pod admission — same contract as
    #: ``ServeConfig.tenant_quota_rps``
    tenant_quota_rps: float = 0.0
    #: bucket depth (0 -> ``max(1, tenant_quota_rps)``)
    tenant_quota_burst: float = 0.0
    #: edge idle-connection reap bound (s; the slow-loris bound)
    edge_idle_timeout_s: float = 30.0


def canonical_key(key: Sequence) -> Tuple:
    """A routing key with every integer a Python ``int`` (numpy and
    torch integers included) and strings kept: the form whose ``repr``
    the rendezvous hash reads."""
    return tuple(k if isinstance(k, str) else int(k) for k in key)


def _rendezvous_order(labels: Sequence[str], key: Tuple) -> List[str]:
    """Labels by descending rendezvous weight for ``key`` — a stable
    hash (not Python's seeded one), so the owner of a range survives
    process restarts and is test-assertable."""
    token = repr(canonical_key(key)).encode()

    def score(label: str) -> int:
        h = hashlib.blake2b(label.encode() + b"|" + token,
                            digest_size=8)
        return int.from_bytes(h.digest(), "big")

    return sorted(labels, key=score, reverse=True)


#: the lock contract the runtime lock-assertion twin
#: (telemetry/lockcheck.py) checks: the admission count and the affinity
#: memo are hit by every concurrently-routed request.
GLC_CONTRACT = {
    "FleetRouter": {
        "lock": "_lock",
        "guards": ("_inflight", "_route_memo"),
        "init": (),
        "locked": (),
    },
}


class FleetRouter:
    """Routes queries/ingests over the policy's current candidates."""

    def __init__(self, replicas: Sequence[Replica],
                 policy: ShedPolicy, telemetry=None,
                 cfg: Optional[FleetConfig] = None):
        from ..telemetry import get_telemetry
        self.replicas = list(replicas)
        self.policy = policy
        self.cfg = cfg or FleetConfig()
        self.telemetry = (telemetry if telemetry is not None
                          else get_telemetry())
        self._lock = threading.Lock()
        self._inflight = 0
        #: routing key -> last owning label (bounded): the affinity
        #: hit-rate's memory, not the routing truth (rendezvous is)
        self._route_memo: Dict[Tuple, str] = {}
        from ..telemetry.lockcheck import maybe_install
        maybe_install(self)

    def inflight(self) -> int:
        """Locked read of the admission count — the health rollup's
        accessor (cross-object reads of guarded state go through the
        owner's lock)."""
        with self._lock:
            return self._inflight

    # --- routing --------------------------------------------------------
    def routing_key(self, q: Query) -> Tuple:
        return (("intraday",) if q.kind == "intraday"
                else canonical_key((q.start, q.end)))

    def route_order(self, key: Tuple,
                    candidates: Optional[Sequence[Replica]] = None
                    ) -> List[Replica]:
        """Candidates in rendezvous preference order for ``key`` (the
        first is the key's owner while it stays live)."""
        if candidates is None:
            candidates = self.policy.candidates()
        by_label = {r.label: r for r in candidates}
        return [by_label[l_] for l_
                in _rendezvous_order(sorted(by_label), key)]

    def _admit(self) -> None:
        with self._lock:
            if self._inflight >= self.cfg.admission_limit:
                self.telemetry.counter("fleet.load_shed",
                                       reason="admission")
                raise FleetShedError(
                    f"pod admission queue full "
                    f"({self.cfg.admission_limit} in flight)",
                    retry_after_s=self.cfg.retry_after_default_s)
            self._inflight += 1

    def _release(self) -> None:
        with self._lock:
            self._inflight = max(0, self._inflight - 1)
            inflight = self._inflight
        self.telemetry.gauge("fleet.inflight", inflight)

    def _note_affinity(self, key: Tuple, label: str) -> None:
        with self._lock:
            prev = self._route_memo.get(key)
            if len(self._route_memo) >= self.cfg.affinity_memory \
                    and key not in self._route_memo:
                self._route_memo.clear()  # bounded, coarse reset
            self._route_memo[key] = label
        if prev is not None:
            self.telemetry.counter(
                "fleet.affinity",
                outcome="hit" if prev == label else "miss")

    def submit(self, q: Query, trace_id: Optional[str] = None):
        """Route one query; returns the owning replica's Future. The
        answer dict carries the pod-assigned trace ID back. Sheds with
        :class:`FleetShedError` when no candidate admits it."""
        tid = canonical_trace_id(trace_id)
        key = self.routing_key(q)
        self._admit()
        t0 = time.perf_counter()
        try:
            candidates = self.policy.candidates()
            if not candidates:
                self.telemetry.counter("fleet.load_shed",
                                       reason="no_candidates")
                raise FleetShedError(
                    "every replica is out of routing candidacy "
                    "(demoted/draining); pod is shedding",
                    retry_after_s=self.policy.retry_after_s(
                        self.cfg.retry_after_default_s))
            last_shed: Optional[LoadShedError] = None
            for replica in self.route_order(key, candidates):
                label = replica.label
                try:
                    fut = replica.server.submit(q, trace_id=tid)
                except LoadShedError as e:
                    # replica-level shed: exclude it, try the next
                    # candidate; its breaker/queue state reaches the
                    # policy on the next refresh
                    last_shed = e
                    self.telemetry.counter("fleet.reroutes",
                                           replica=label)
                    self.policy.note_result(label, ok=False)
                    continue
                self._note_affinity(key, label)
                self.telemetry.counter("fleet.routed", replica=label)
                if q.encoding == "wire":
                    # the replica leg carries the query's encoding
                    # verbatim — a wire query routed here answers with
                    # the packed payload, never a JSON re-inflation at
                    # the router hop
                    self.telemetry.counter("fleet.routed_wire",
                                           replica=label)
                self.telemetry.request({
                    "trace_id": tid, "op": "route", "status": "ok",
                    "data": {"replica": label, "kind": q.kind,
                             "key": list(key),
                             "route_s": round(time.perf_counter() - t0,
                                              6)}})
                policy = self.policy

                def _done(f, _label=label):
                    self._release()
                    policy.note_result(_label,
                                       ok=f.exception() is None)

                fut.add_done_callback(_done)
                return fut
            self.telemetry.counter("fleet.load_shed",
                                   reason="all_candidates_shed")
            raise FleetShedError(
                "every routing candidate shed the request",
                retry_after_s=(last_shed.retry_after_s
                               if last_shed is not None
                               and last_shed.retry_after_s
                               else self.policy.retry_after_s(
                                   self.cfg.retry_after_default_s)))
        except BaseException:
            self._release()
            raise

    # --- ingest fan-out -------------------------------------------------
    def ingest(self, bars, present, trace_id: Optional[str] = None,
               timeout: Optional[float] = 60.0) -> dict:
        """Broadcast one minute-bar micro-batch to every live stream
        replica. Per-replica failure isolation: each leg's error stays
        its own — the call only raises (:class:`FleetShedError`) when
        NO leg applied. Returns ``{"minute", "bars", "replicas":
        {label: leg}, "failed": [...], "trace_id"}`` where a skipped
        (demoted) replica's leg says so — the pod health view's
        evidence."""
        tid = canonical_trace_id(trace_id)
        # ONE normalization before the fan-out; every replica then
        # ingests the same host buffers
        bars = np.asarray(bars, np.float32)
        present = np.asarray(present, bool)
        stream_replicas = [r for r in self.replicas if r.stream]
        if not stream_replicas:
            raise ValueError("ingest needs at least one stream-enabled "
                             "replica (fleet built with stream=True)")
        live = {r.label for r in
                self.policy.candidates(stream_only=True)}
        legs: Dict[str, dict] = {}
        futures = {}
        for r in stream_replicas:
            if r.label not in live:
                legs[r.label] = {"ok": False, "skipped": True,
                                 "state": self.policy.state(r.label)}
                self.telemetry.counter("fleet.ingest_legs",
                                       outcome="skipped")
                continue
            try:
                futures[r.label] = r.server.ingest(bars, present,
                                                   trace_id=tid)
            except (LoadShedError, ValueError, RuntimeError) as e:
                legs[r.label] = {"ok": False,
                                 "error": f"{type(e).__name__}: {e}"}
                self.telemetry.counter("fleet.ingest_legs",
                                       outcome="shed")
                self.policy.note_result(r.label, ok=False)
        for label, fut in futures.items():
            try:
                res = fut.result(timeout)
                legs[label] = {"ok": True, "minute": res["minute"]}
                self.telemetry.counter("fleet.ingest_legs",
                                       outcome="ok")
                self.policy.note_result(label, ok=True)
            except Exception as e:  # noqa: BLE001 — isolate the leg
                legs[label] = {"ok": False,
                               "error": f"{type(e).__name__}: {e}"}
                self.telemetry.counter("fleet.ingest_legs",
                                       outcome="failed")
                self.policy.note_result(label, ok=False)
        ok_minutes = [leg["minute"] for leg in legs.values()
                      if leg.get("ok")]
        failed = sorted(l_ for l_, leg in legs.items()
                        if not leg.get("ok"))
        self.telemetry.counter("fleet.ingest_fanout")
        self.telemetry.request({
            "trace_id": tid, "op": "ingest_fanout",
            "status": "ok" if ok_minutes else "error",
            "data": {"legs": len(legs), "failed": failed}})
        if not ok_minutes:
            self.telemetry.counter("fleet.load_shed",
                                   reason="ingest_all_legs")
            raise FleetShedError(
                f"ingest fan-out failed on every stream replica "
                f"({failed})",
                retry_after_s=self.policy.retry_after_s(
                    self.cfg.retry_after_default_s))
        return {"trace_id": tid, "minute": max(ok_minutes),
                "bars": int(present.sum()), "replicas": legs,
                "failed": failed}


class FactorFleet:
    """N FactorServer replicas over disjoint device groups as ONE pod:
    replicas + shed policy + router composed, with the pod health and
    metrics views the front door (:mod:`.http`) serves.

    ``devices`` defaults to every visible card (raising when there is
    none); pass ``[torch.device('cpu')] * n_replicas`` to run the pod on
    the CPU. The pod control plane (router/policy counters, pod request
    records) lives on ``telemetry`` — its own stream, folded together
    with the per-replica registries by :func:`.http.pod_registry`.
    """

    def __init__(self, source, n_replicas: int,
                 names: Optional[Sequence[str]] = None,
                 serve_cfg=None, fleet_cfg: Optional[FleetConfig] = None,
                 replicate_quirks: bool = True,
                 rolling_impl: Optional[str] = None,
                 stream: bool = False,
                 stream_batches: Sequence[int] = (1,),
                 start: bool = True, telemetry=None,
                 devices: Optional[Sequence] = None):
        from ..telemetry import Telemetry
        self.source = source
        self.telemetry = (telemetry if telemetry is not None
                          else Telemetry())
        self.cfg = fleet_cfg or FleetConfig()
        self.replicas = build_replicas(
            source, n_replicas, devices=devices, names=names,
            serve_cfg=serve_cfg, replicate_quirks=replicate_quirks,
            rolling_impl=rolling_impl, stream=stream,
            stream_batches=stream_batches, start=start)
        self.policy = ShedPolicy(
            self.replicas, telemetry=self.telemetry,
            cooldown_s=self.cfg.demote_cooldown_s,
            hbm_headroom_frac=self.cfg.hbm_headroom_frac)
        self.router = FleetRouter(self.replicas, self.policy,
                                  telemetry=self.telemetry,
                                  cfg=self.cfg)
        self.telemetry.gauge("fleet.replicas", len(self.replicas))
        self._t_start = time.monotonic()
        #: pod SLO plane: the fleet owns its OWN flight recorder
        #: (pod-level ``slo_burn`` captures carry the router's
        #: route/ingest_fanout request records) and a sampler over the
        #: control-plane registry + derived per-replica liveness and
        #: freshness signals. Replica-level timelines run inside each
        #: FactorServer and are folded offline by
        #: ``telemetry.aggregate``.
        from ..telemetry.opsplane import FlightRecorder
        from ..telemetry.slo import fleet_objectives
        self.flight = FlightRecorder(telemetry=self.telemetry,
                                     dump_dir=self.cfg.flight_dir)
        self.timeline = self.telemetry.timeline
        self.sloplane = self.telemetry.sloplane
        self.timeline.add_source(self._pod_signals)
        has_stream = any(r.stream for r in self.replicas)
        self.sloplane.configure(
            fleet_objectives(staleness_s=self.cfg.slo_staleness_s,
                             streaming=has_stream),
            flight=self.flight, timeline=self.timeline,
            time_scale=self.cfg.slo_time_scale)
        if self.cfg.timeline_sample_period_s > 0:
            self.timeline.start(self.cfg.timeline_sample_period_s)

    def _pod_signals(self) -> dict:
        """Derived pod signals for the timeline sampler: live-replica
        count, per-replica liveness, and the worst live carry's
        ingest staleness — host-side policy/engine mirrors only."""
        states = self.policy.snapshot()["states"]
        out = {"fleet.live_replicas":
               float(sum(1 for s in states.values()
                         if s != "demoted"))}
        for label, state in states.items():
            out[f"fleet.replica_up{{replica={label}}}"] = (
                0.0 if state == "demoted" else 1.0)
        staleness = []
        for r in self.replicas:
            eng = getattr(r.server, "stream_engine", None)
            if eng is None:
                continue
            s = eng.staleness_s()
            if s is not None:
                staleness.append(s)
        if staleness:
            out["fleet.stream_staleness_s"] = round(max(staleness), 6)
        return out

    # --- request surface (the router's, re-exported) --------------------
    def submit(self, q: Query, trace_id: Optional[str] = None):
        return self.router.submit(q, trace_id=trace_id)

    def ingest(self, bars, present, trace_id: Optional[str] = None,
               timeout: Optional[float] = 60.0) -> dict:
        return self.router.ingest(bars, present, trace_id=trace_id,
                                  timeout=timeout)

    # --- pod views ------------------------------------------------------
    def health(self) -> dict:
        """Per-replica ``healthz`` payloads (the server's own shape)
        + the pod rollup: live/demoted counts, policy states, stream
        cursor skew across the live carries."""
        pod_state = self.policy.snapshot()
        reps = {r.label: r.health() for r in self.replicas}
        live = [l_ for l_, s in pod_state["states"].items()
                if s != "demoted"]
        payload = {
            "ok": bool(live),
            "replicas": reps,
            "pod": {
                "replicas": len(self.replicas),
                "live": len(live),
                "demoted": pod_state["demoted"],
                "states": pod_state["states"],
                "reasons": pod_state["reasons"],
                "inflight": self.router.inflight(),
                "uptime_s": round(time.monotonic() - self._t_start, 3),
            },
        }
        minutes = [h["stream_minute"] for h in reps.values()
                   if "stream_minute" in h]
        if minutes:
            payload["pod"]["stream_minute"] = max(minutes)
            payload["pod"]["stream_minute_skew"] = (max(minutes)
                                                    - min(minutes))
        # the pod's freshness is its WORST replica's wall-clock ingest
        # staleness (read verbatim from the shared healthz key; replicas
        # that never ingested report None and don't count)
        staleness = [h["stream_staleness_s"] for h in reps.values()
                     if h.get("stream_staleness_s") is not None]
        if staleness:
            payload["pod"]["stream_staleness_s"] = max(staleness)
        # pod factor-health rollup: the worst-coverage factor PER
        # REPLICA (read verbatim from the shared healthz shape) with the
        # stream cursor skew beside it: a replica whose data quality
        # collapsed and a replica whose carry fell behind are the same
        # triage page
        fh = {}
        for label, h in reps.items():
            block = h.get("factor_health") or {}
            fh[label] = {
                "available": bool(block.get("available")),
                "worst_coverage": block.get("worst_coverage"),
                "widen_rate": block.get("widen_rate"),
                "drift_bursts": (block.get("drift") or {}).get("bursts"),
            }
        payload["pod"]["factor_health"] = {
            "replicas": fh,
            "stream_minute_skew": payload["pod"].get(
                "stream_minute_skew"),
        }
        return payload

    def pod_registry(self):
        """The pod metrics view: the control plane + every replica
        registry through ``telemetry.aggregate``'s registry-merge fold
        (counters exact; see :func:`.http.pod_registry`)."""
        from .http import pod_registry
        return pod_registry(self)

    # --- lifecycle ------------------------------------------------------
    def start(self) -> "FactorFleet":
        for r in self.replicas:
            r.start()
        return self

    def close(self, timeout: float = 10.0) -> None:
        if self.cfg.timeline_sample_period_s > 0:
            self.timeline.stop()
        for r in self.replicas:
            r.close(timeout=timeout)

    def __enter__(self) -> "FactorFleet":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
