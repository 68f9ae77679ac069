"""Unified run telemetry.

The port of the JAX package's ``telemetry/__init__.py``. One injectable
:class:`Telemetry` object bundles the pieces every layer emits into:

* a :class:`.registry.MetricsRegistry` — counters, gauges, bounded
  histograms (p50/p95/p99/max) keyed by name+labels;
* a :class:`.spans.SpanTracer` — nesting span context managers with
  ``Timer`` semantics, ``torch.profiler`` annotation, Chrome/Perfetto
  ``trace_events`` export;
* a schema-versioned JSONL stream (:mod:`.sink`);
* a once-per-run manifest (:mod:`.manifest`);
* the lazily bound planes the long-lived services report through:
  ``hbm`` (:class:`.opsplane.HbmSampler`), ``meshplane``
  (:class:`.meshplane.MeshPlane`, its one-device surface),
  ``factorplane`` (:class:`.factorplane.FactorPlane`), ``timeline``
  (:class:`.timeline.TimelineStore`) and ``sloplane``
  (:class:`.slo.SloPlane`).

A process-wide default instance exists from first use
(``get_telemetry``), so hot paths instrument unconditionally at
dict-update cost; anything that wants an isolated stream (tests, a
server) builds its own ``Telemetry`` and passes it down or installs it
via ``set_telemetry``. ``python -m
replication_of_minute_frequency_factor_tpu_torch --telemetry-dir DIR``
writes the whole bundle to disk. The JAX package's pod aggregation,
regression gate, bundle validator and profiler trace capture
(``aggregate``, ``regress``, ``validate``, ``TraceCapture``) are not
ported yet.
"""

from __future__ import annotations

import contextlib
import os
import threading
import time
from typing import Dict, List, Optional

from ..utils.tracing import Timer
from .attribution import reconcile
from .factorplane import FactorPlane
from .meshplane import MeshPlane
from .opsplane import (FlightRecorder, HbmSampler, canonical_trace_id,
                       gen_trace_id, to_prometheus)
from .registry import Histogram, MetricsRegistry, render_key
from .sink import SCHEMA_VERSION, EventSink, validate_jsonl, validate_record
from .slo import Objective, SloPlane, slo_prometheus
from .spans import SpanTracer
from .timeline import TimelineStore

__all__ = [
    "SCHEMA_VERSION", "EventSink", "FactorPlane", "FlightRecorder",
    "HbmSampler", "Histogram", "MeshPlane", "MetricsRegistry",
    "Objective", "SloPlane", "SpanTracer",
    "StageTimer", "Telemetry", "TimelineStore",
    "canonical_trace_id",
    "gen_trace_id", "get_telemetry", "reconcile", "render_key",
    "set_telemetry", "slo_prometheus", "to_prometheus",
    "validate_jsonl", "validate_record",
]

#: retained free-form events bound (events past it count, not retain)
MAX_FREE_EVENTS = 5000

#: retained request-lifecycle records bound
MAX_REQUEST_RECORDS = 20000

#: the lock contract the runtime lock-assertion twin (.lockcheck)
#: checks: the event/request buffers take writes
#: from every instrumented thread, and the lazily-bound planes flip
#: exactly once under the same lock (double-checked creation).
GLC_CONTRACT = {
    "Telemetry": {
        "lock": "_lock",
        "guards": ("_events", "_events_dropped", "_requests",
                   "_requests_dropped", "_hbm", "_meshplane",
                   "_factorplane", "_timeline", "_sloplane"),
        "init": (),
        "locked": (),
    },
}


class StageTimer(Timer):
    """A :class:`..utils.tracing.Timer` whose stages ALSO land in a
    Telemetry object: each ``with timer("io")`` is a span (nesting,
    ``torch.profiler`` region, trace export) plus a
    ``span_seconds{span=io}`` histogram observation, while
    ``totals()``/``report()`` keep their per-run Timer meaning
    (``ExposureTable.timings``).

    Constructor ``labels`` attach to every stage's ``span_seconds``
    histogram observation (e.g. ``rolling_impl=cuda``) so a stage's
    time says which backend it belongs to; the span name, totals and
    trace export stay label-free."""

    def __init__(self, telemetry: "Telemetry", **labels):
        super().__init__()
        self._tel = telemetry
        self._labels = labels

    @contextlib.contextmanager
    def __call__(self, name: str):
        with self._tel.tracer(name, **self._labels):
            t0 = time.perf_counter()
            try:
                yield
            finally:
                dt = time.perf_counter() - t0
                with self._lock:
                    self._totals[name] = self._totals.get(name, 0.0) + dt
                    self._counts[name] = self._counts.get(name, 0) + 1


class Telemetry:
    """Registry + tracer + event buffer + write-to-disk, as one unit."""

    def __init__(self, annotate_spans: bool = True):
        self.registry = MetricsRegistry()
        self.tracer = SpanTracer(registry=self.registry,
                                 annotate=annotate_spans)
        self._events: List[dict] = []
        self._events_dropped = 0
        self._requests: List[dict] = []
        self._requests_dropped = 0
        self._hbm: Optional[HbmSampler] = None
        self._meshplane: Optional[MeshPlane] = None
        self._factorplane: Optional[FactorPlane] = None
        self._timeline: Optional[TimelineStore] = None
        self._sloplane: Optional[SloPlane] = None
        self._lock = threading.Lock()
        from .lockcheck import maybe_install
        maybe_install(self)

    @property
    def hbm(self) -> HbmSampler:
        """The device-memory watermark sampler bound to this telemetry
        (created on first use). Hot paths call
        ``tel.hbm.sample("<boundary>")`` — rate-limited and
        never-raising by contract."""
        if self._hbm is None:
            with self._lock:
                if self._hbm is None:
                    self._hbm = HbmSampler(telemetry=self)
        return self._hbm

    @property
    def meshplane(self) -> MeshPlane:
        """The shard-balance sampler bound to this telemetry (created
        on first use; its one-device surface). Dispatch boundaries call
        ``tel.meshplane.record_occupancy(frac, boundary)`` —
        never-raising by contract."""
        if self._meshplane is None:
            with self._lock:
                if self._meshplane is None:
                    self._meshplane = MeshPlane(telemetry=self)
        return self._meshplane

    @property
    def factorplane(self) -> FactorPlane:
        """The per-factor data-quality sampler bound to this telemetry
        (created on first use). Boundary modules feed it the
        ``[F, 9]`` stats side-outputs —
        ``tel.factorplane.observe_block(names, stats, boundary)`` —
        never-raising and fetch-free by contract (the stats already
        rode the caller's consolidated fetch)."""
        if self._factorplane is None:
            with self._lock:
                if self._factorplane is None:
                    self._factorplane = FactorPlane(telemetry=self)
        return self._factorplane

    @property
    def timeline(self) -> TimelineStore:
        """The continuous-telemetry timeline bound to this telemetry
        (created on first use). Owners call
        ``tel.timeline.start(period_s)`` for a sampler thread;
        :meth:`write` persists the ring as schema-v4 ``frame``
        records."""
        if self._timeline is None:
            with self._lock:
                if self._timeline is None:
                    self._timeline = TimelineStore(telemetry=self)
        return self._timeline

    @property
    def sloplane(self) -> SloPlane:
        """The SLO plane bound to this telemetry (created on first
        use). Inert until ``configure(objectives, ...)``;
        evaluated per timeline frame as multi-window burn rates —
        never-raising and host-side by contract."""
        if self._sloplane is None:
            with self._lock:
                if self._sloplane is None:
                    self._sloplane = SloPlane(telemetry=self)
        return self._sloplane

    # --- emit -----------------------------------------------------------
    def counter(self, name: str, value: float = 1.0, **labels) -> None:
        self.registry.counter(name, value, **labels)

    def gauge(self, name: str, value: float, **labels) -> None:
        self.registry.gauge(name, value, **labels)

    def observe(self, name: str, value: float, **labels) -> None:
        self.registry.observe(name, value, **labels)

    def span(self, name: str):
        return self.tracer(name)

    def stage_timer(self, **labels) -> StageTimer:
        """A :class:`StageTimer` on this telemetry; ``labels`` tag every
        stage's ``span_seconds`` histogram observation."""
        return StageTimer(self, **labels)

    def event(self, name: str, **data) -> None:
        """Free-form structured event (bounded retention)."""
        with self._lock:
            if len(self._events) < MAX_FREE_EVENTS:
                self._events.append({"name": name,
                                     "ts": round(time.time(), 3),
                                     "data": data})
            else:
                self._events_dropped += 1

    def events(self) -> List[dict]:
        """The retained free-form events, oldest first."""
        with self._lock:
            return list(self._events)

    def request(self, trace: dict) -> None:
        """One request's lifecycle record: ``{"trace_id",
        "op", "status", "data": {...}}`` — persisted as a schema-v2
        ``request`` record by :meth:`write`, so a single slow request
        is reconstructible from the bundle (bounded retention)."""
        with self._lock:
            if len(self._requests) < MAX_REQUEST_RECORDS:
                self._requests.append(dict(trace))
            else:
                self._requests_dropped += 1

    # --- persist --------------------------------------------------------
    def write(self, out_dir: str, cfg=None,
              manifest_extra: Optional[dict] = None,
              process_index: Optional[int] = None,
              host: Optional[str] = None) -> Dict[str, str]:
        """Write the run bundle into ``out_dir``:

        * ``manifest.json`` — provenance (once per run);
        * ``metrics.jsonl`` — schema-versioned stream: the manifest,
          every counter/gauge/histogram, every retained span, every
          free-form event;
        * ``trace.json`` — Chrome/Perfetto ``trace_events``.

        Every record (and the manifest) carries the schema-v3
        multihost identity stamps: ``process_index``/``host`` from
        :func:`..manifest.process_identity` unless overridden here.
        The manifest carries no ``xla`` block (torch compiles nothing);
        the executable cache's counts (``serve.executables``) stand in
        its place as the ``executables`` block.

        Returns ``{artifact: path}``.
        """
        from .manifest import build_manifest, process_identity

        os.makedirs(out_dir, exist_ok=True)
        paths = {"manifest": os.path.join(out_dir, "manifest.json"),
                 "metrics": os.path.join(out_dir, "metrics.jsonl"),
                 "trace": os.path.join(out_dir, "trace.json")}
        identity = process_identity()
        if process_index is not None:
            identity["process_index"] = int(process_index)
        if host is not None:
            identity["host"] = str(host)
        # what this run built, and whether the cache helped, is
        # provenance: stamp it so it is answerable without replaying
        # the metrics stream
        exes = executables_summary(self.registry)
        if exes:
            manifest_extra = {"executables": exes,
                              **(manifest_extra or {})}
        manifest = build_manifest(cfg, manifest_extra)
        manifest.update(identity)
        import json
        # atomic write — a reader of the bundle mid-write must never
        # see a torn manifest
        tmp = paths["manifest"] + ".tmp"
        with open(tmp, "w") as fh:
            json.dump(manifest, fh, indent=1)
        os.replace(tmp, paths["manifest"])
        with EventSink(paths["metrics"], common=identity) as sink:
            sink.emit("manifest", payload=manifest)
            for rec in self.registry.records():
                sink.emit(**{k: v for k, v in rec.items()})
            for ev in self.tracer.events():
                sink.emit("span", **ev)
            with self._lock:
                events = list(self._events)
                requests = list(self._requests)
            for ev in events:
                sink.emit("event", name=ev["name"], data=ev["data"])
            for tr in requests:
                sink.emit("request",
                          trace_id=str(tr.get("trace_id", "")),
                          op=str(tr.get("op", "")),
                          status=str(tr.get("status", "")),
                          data=dict(tr.get("data") or {}))
            # the timeline ring and SLO events, when bound — frames carry their OWN wall-clock ts (explicit fields
            # beat the sink's write-time stamp) so incident replay can
            # window them against flight dumps and request records
            if self._timeline is not None:
                for fr in self._timeline.frame_records():
                    sink.emit("frame", **fr)
            if self._sloplane is not None:
                for rec in self._sloplane.slo_records():
                    sink.emit("slo", **rec)
        self.tracer.write_chrome_trace(paths["trace"])
        return paths

    # --- report ---------------------------------------------------------
    def summary(self) -> str:
        """Human-readable end-of-run digest."""
        snap = self.registry.snapshot()
        lines = ["telemetry summary:"]
        if snap["counters"]:
            lines.append("  counters:")
            lines += [f"    {k} = {v:g}"
                      for k, v in snap["counters"].items()]
        if snap["gauges"]:
            lines.append("  gauges (last value):")
            lines += [f"    {k} = {v:g}" for k, v in snap["gauges"].items()]
        if snap["histograms"]:
            lines.append("  histograms (p50/p95/max, n):")
            for k, st in snap["histograms"].items():
                if st["count"]:
                    lines.append(
                        f"    {k}: p50={st['p50']:.4g} p95={st['p95']:.4g}"
                        f" max={st['max']:.4g} n={st['count']}")
        dropped = (self.tracer.dropped_spans + self._events_dropped
                   + self._requests_dropped)
        if dropped:
            lines.append(f"  ({dropped} spans/events dropped past "
                         "retention bounds)")
        return "\n".join(lines)


def executables_summary(registry) -> dict:
    """The executable cache's build story for the manifest: hits,
    misses (each a callable built) and the resident count; empty when
    nothing went through the cache."""
    hits = registry.counter_value("serve.executables", outcome="hit")
    misses = registry.counter_value("serve.executables", outcome="miss")
    if not (hits or misses):
        return {}
    resident = registry.gauge_value("serve.executables_resident")
    return {"hits": int(hits), "misses": int(misses),
            "resident": None if resident is None else int(resident)}


_current: Optional[Telemetry] = None
_current_lock = threading.Lock()


def get_telemetry() -> Telemetry:
    """The process-wide default Telemetry (created on first use)."""
    global _current
    if _current is None:
        with _current_lock:
            if _current is None:
                _current = Telemetry()
    return _current


def set_telemetry(tel: Telemetry) -> Telemetry:
    """Install ``tel`` as the process-wide default; returns it."""
    global _current
    with _current_lock:
        _current = tel
    return tel
