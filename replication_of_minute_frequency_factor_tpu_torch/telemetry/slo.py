"""SLO plane: declarative objectives + multi-window burn-rate alerts


An :class:`Objective` declares what "good" means for one service
dimension; the :class:`SloPlane` evaluates every objective on each
timeline frame (it registers itself as a
:meth:`..timeline.TimelineStore.on_frame` callback) as Google-SRE
multi-window burn rates:

* ``availability`` — non-shed fraction: error rate is
  ``delta(bad) / (delta(total) + delta(bad))`` over the window — the
  two counters are DISJOINT admission outcomes (``serve.requests``
  counts only admitted work; a shed raises before it), so demand is
  their sum (both read as cumulative
  :meth:`..registry.MetricsRegistry.counter_total` host-side sums — no
  device work);
* ``latency`` — p99 under target: error rate is the fraction of
  in-window frames whose ``p99:<latency_hist>`` exceeded
  ``threshold_ms``;
* ``freshness`` — stream staleness under target: error rate is the
  fraction of in-window frames whose ``gauge:<staleness_gauge>``
  exceeded ``threshold_s``.

Burn rate = error rate / error budget, where budget = ``1 - target``.
A burn of 1.0 spends the budget exactly at the objective's horizon;
the SRE alerting windows pair a short and a long window so a
transient spike (fails the short window only) and a slow leak (fails
the long window only) both stay quiet while a sustained burn — both
windows over threshold — fires. :data:`BURN_WINDOWS` carries the
canonical fast (5m/1h at 14.4x) and slow (6h/3d at 1x) pairs; both the
clock and a ``time_scale`` divisor are injectable so tests and the
``bench.slo_smoke`` harness compress hours into seconds without
touching the production constants.

A not-firing -> firing transition force-dumps the
:class:`..opsplane.FlightRecorder` with trigger ``slo_burn``, naming
the objective, its burn rate, and the top-moving timeline series over
the alert window — every burn incident arrives pre-correlated with the
requests that rode through it (``python -m ...telemetry.timeline``
replays the bundle into the incident report).

Exported state (scrape taxonomy, docs/slo.md): gauges
``slo.burn_rate{objective=,window=}``,
``slo.error_budget_remaining{objective=}``, ``slo.alert{objective=}``;
counter ``slo.alerts{objective=}``; schema-v4 ``slo`` records for each
alert transition plus one end-of-run verdict per objective.
"""

from __future__ import annotations

import dataclasses
import threading
import time
from collections import deque
from typing import Callable, Dict, List, Optional, Tuple

#: (label, short_window_s, long_window_s, burn threshold) — the SRE
#: workbook's paged-alert pairs: 2% of a 30d budget in 1h (14.4x) and
#: 10% in 3d (1x). An alert requires BOTH windows of a pair over the
#: threshold. Windows divide by the plane's ``time_scale``.
BURN_WINDOWS: Tuple[Tuple[str, float, float, float], ...] = (
    ("fast", 300.0, 3600.0, 14.4),
    ("slow", 21600.0, 259200.0, 1.0),
)

#: retained alert-transition events bound
MAX_SLO_EVENTS = 1000

#: evaluation-history bound (at the default 0.5 s sampling period this
#: spans the scaled windows the tests/smokes use with headroom)
SLO_HISTORY = 4096

#: the lock contract the runtime lock-assertion twin (telemetry/lockcheck.py)
#: checks: evaluate() runs on the sampler thread
#: while configure()/summary() run on callers' threads. ``_timeline``
#: and ``clock`` stay out — both settle before the sampler thread
#: exists in every wiring path, and ``_timeline`` is read lock-free on
#: the hot path by design.
GLC_CONTRACT = {
    "SloPlane": {
        "lock": "_lock",
        "guards": ("objectives", "time_scale", "_flight", "_history",
                   "_alerting", "_worst", "_alert_counts", "_events"),
        "init": (),
        "locked": (),
    },
}


@dataclasses.dataclass(frozen=True)
class Objective:
    """One declarative service-level objective.

    ``kind`` selects the signal: ``availability`` reads
    ``total_counter``/``bad_counter``; ``latency`` reads
    ``latency_hist``'s p99 against ``threshold_ms``; ``freshness``
    reads ``staleness_gauge`` against ``threshold_s``. ``target`` is
    the good fraction (0.99 leaves a 1% error budget)."""

    name: str
    kind: str  # availability | latency | freshness
    target: float
    total_counter: str = ""
    bad_counter: str = ""
    latency_hist: str = ""
    threshold_ms: float = 0.0
    staleness_gauge: str = ""
    threshold_s: float = 0.0

    def __post_init__(self):
        if self.kind not in ("availability", "latency", "freshness"):
            raise ValueError(f"unknown objective kind {self.kind!r}")
        if not (0.0 < self.target < 1.0):
            raise ValueError(f"target must be in (0, 1), "
                             f"got {self.target}")


def serve_objectives(latency_ms: float = 250.0,
                     staleness_s: float = 120.0,
                     streaming: bool = False) -> Tuple[Objective, ...]:
    """The standalone FactorServer's default objectives (docs/slo.md):
    availability over serve.requests vs serve.load_shed, p99 request
    latency, and — when the server streams — ingest freshness."""
    objs = [
        Objective(name="availability", kind="availability", target=0.99,
                  total_counter="serve.requests",
                  bad_counter="serve.load_shed"),
        Objective(name="latency", kind="latency", target=0.99,
                  latency_hist="serve.request_seconds",
                  threshold_ms=float(latency_ms)),
    ]
    if streaming:
        objs.append(Objective(name="freshness", kind="freshness",
                              target=0.99,
                              staleness_gauge="stream.staleness_s",
                              threshold_s=float(staleness_s)))
    return tuple(objs)


def fleet_objectives(staleness_s: float = 120.0,
                     streaming: bool = False) -> Tuple[Objective, ...]:
    """The fleet front door's default pod objectives: availability over
    fleet.routed vs fleet.load_shed (the router's own admission view —
    replica latency stays a replica objective), plus pod ingest
    freshness when the pod streams."""
    objs = [
        Objective(name="pod_availability", kind="availability",
                  target=0.99, total_counter="fleet.routed",
                  bad_counter="fleet.load_shed"),
    ]
    if streaming:
        objs.append(Objective(name="pod_freshness", kind="freshness",
                              target=0.99,
                              staleness_gauge="fleet.stream_staleness_s",
                              threshold_s=float(staleness_s)))
    return tuple(objs)


def _series_max(series: dict, prefix: str, name: str) -> Optional[float]:
    """Max of ``<prefix>:<name>`` over all label sets in one frame's
    series dict (``p99:serve.request_seconds{kind=factors}`` matches
    ``name="serve.request_seconds"``)."""
    exact = f"{prefix}:{name}"
    labeled = exact + "{"
    vals = [v for k, v in series.items()
            if k == exact or k.startswith(labeled)]
    return max(vals) if vals else None


class SloPlane:
    """Objectives + burn-rate evaluation over the timeline's cadence.

    Built lazily by :class:`..Telemetry` (``tel.sloplane``); inert
    until :meth:`configure` hands it objectives. ``evaluate`` runs on
    the sampler thread via ``timeline.on_frame`` — host-side arithmetic
    only, never raises out (the timeline swallows callback errors as a
    second line of defense)."""

    def __init__(self, telemetry=None,
                 clock: Callable[[], float] = time.monotonic):
        self._telemetry = telemetry
        self.clock = clock
        self.time_scale = 1.0
        self.objectives: Tuple[Objective, ...] = ()
        self._flight = None
        self._timeline = None
        self._lock = threading.Lock()
        #: per-objective deque of (t, signal-dict) evaluation history
        self._history: Dict[str, deque] = {}
        self._alerting: Dict[str, bool] = {}
        self._worst: Dict[str, float] = {}
        self._alert_counts: Dict[str, int] = {}
        self._events: List[dict] = []
        from .lockcheck import maybe_install
        maybe_install(self)

    def _tel(self):
        if self._telemetry is not None:
            return self._telemetry
        from . import get_telemetry
        return get_telemetry()

    # --- wiring ---------------------------------------------------------
    def configure(self, objectives, flight=None, timeline=None,
                  time_scale: float = 1.0,
                  clock: Optional[Callable[[], float]] = None
                  ) -> "SloPlane":
        """Install objectives and correlation hooks. ``flight`` is the
        FlightRecorder to force-dump on an alert transition;
        ``timeline`` provides the top-moving-series context (and, when
        given, this plane registers itself on its frame callbacks).
        ``time_scale`` divides every burn window — 3600.0 turns the 5m
        window into ~83 ms of test time."""
        with self._lock:
            self.objectives = tuple(objectives)
            self._flight = flight
            self.time_scale = float(time_scale)
            if clock is not None:
                self.clock = clock
            for o in self.objectives:
                self._history.setdefault(o.name,
                                         deque(maxlen=SLO_HISTORY))
                self._alerting.setdefault(o.name, False)
                self._worst.setdefault(o.name, 0.0)
                self._alert_counts.setdefault(o.name, 0)
        if timeline is not None:
            self._timeline = timeline
            timeline.on_frame(self.evaluate)
        return self

    # --- evaluation -----------------------------------------------------
    def _signal(self, obj: Objective, series: dict) -> dict:
        reg = self._tel().registry
        if obj.kind == "availability":
            return {"total": reg.counter_total(obj.total_counter),
                    "bad": reg.counter_total(obj.bad_counter)}
        if obj.kind == "latency":
            p99 = _series_max(series, "p99", obj.latency_hist)
            bad = (p99 is not None
                   and p99 * 1000.0 > obj.threshold_ms)
            return {"bad": 1.0 if bad else 0.0, "value": p99}
        # freshness
        val = _series_max(series, "gauge", obj.staleness_gauge)
        bad = val is not None and val > obj.threshold_s
        return {"bad": 1.0 if bad else 0.0, "value": val}

    def _window_error_rate(self, obj: Objective, hist, now: float,
                           window_s: float) -> float:
        entries = [(t, s) for t, s in hist if t >= now - window_s]
        if len(entries) < 2:
            return 0.0
        if obj.kind == "availability":
            _, first = entries[0]
            _, last = entries[-1]
            d_bad = max(0.0, last["bad"] - first["bad"])
            # disjoint outcomes: demand = admitted + shed
            demand = max(0.0, last["total"] - first["total"]) + d_bad
            if demand <= 0:
                return 0.0
            return max(0.0, min(1.0, d_bad / demand))
        flagged = sum(s["bad"] for _, s in entries)
        return flagged / len(entries)

    def evaluate(self, frame: Optional[dict] = None) -> dict:
        """Evaluate every objective against ``frame`` (or the
        timeline's latest); returns ``{objective: {window: burn, ...,
        "alerting": bool}}``. Publishes the ``slo.*`` gauges and, on a
        not-firing -> firing transition, force-dumps the flight
        recorder with the pre-correlated ``slo_burn`` payload."""
        tel = self._tel()
        if frame is None and self._timeline is not None:
            frame = self._timeline.latest()
        series = (frame or {}).get("series", {})
        now = self.clock()
        with self._lock:
            objectives = self.objectives
            scale = self.time_scale
        out: Dict[str, dict] = {}
        for obj in objectives:
            sig = self._signal(obj, series)
            with self._lock:
                hist = self._history[obj.name]
                hist.append((now, sig))
                hist_copy = list(hist)
            budget = 1.0 - obj.target
            fired_pair = None
            burns: Dict[str, float] = {}
            worst = 0.0
            for label, short_s, long_s, threshold in BURN_WINDOWS:
                short_w = short_s / scale
                long_w = long_s / scale
                b_short = self._window_error_rate(
                    obj, hist_copy, now, short_w) / budget
                b_long = self._window_error_rate(
                    obj, hist_copy, now, long_w) / budget
                burns[label] = b_short
                worst = max(worst, b_short)
                if b_short >= threshold and b_long >= threshold \
                        and fired_pair is None:
                    fired_pair = (label, short_w, b_short)
                tel.gauge("slo.burn_rate", round(b_short, 6),
                          objective=obj.name, window=label)
            # budget remaining over the slow pair's long horizon
            long_err = self._window_error_rate(
                obj, hist_copy, now, BURN_WINDOWS[-1][2] / scale)
            remaining = 1.0 - long_err / budget
            tel.gauge("slo.error_budget_remaining", round(remaining, 6),
                      objective=obj.name)
            firing = fired_pair is not None
            tel.gauge("slo.alert", 1.0 if firing else 0.0,
                      objective=obj.name)
            with self._lock:
                was = self._alerting[obj.name]
                self._alerting[obj.name] = firing
                self._worst[obj.name] = max(self._worst[obj.name],
                                            worst)
                transition = firing and not was
                if transition:
                    self._alert_counts[obj.name] += 1
            if transition:
                self._on_alert(obj, fired_pair)
            out[obj.name] = {**burns, "alerting": firing,
                             "budget_remaining": round(remaining, 6)}
        return out

    def _on_alert(self, obj: Objective,
                  fired: Tuple[str, float, float]) -> None:
        label, window_w, burn = fired
        tel = self._tel()
        tel.counter("slo.alerts", objective=obj.name)
        top = []
        if self._timeline is not None:
            try:
                top = self._timeline.top_movers(window_w, k=5)
            except Exception:  # noqa: BLE001 — alerting must not die
                top = []
        payload = {"event": "alert", "objective": obj.name,
                   "kind": obj.kind, "target": obj.target,
                   "burn_rate": round(burn, 6), "window": label,
                   "window_s": round(window_w, 6), "top_moving": top}
        with self._lock:
            if len(self._events) < MAX_SLO_EVENTS:
                self._events.append({"name": obj.name,
                                     "ts": round(time.time(), 3),
                                     "data": payload})
        if self._flight is not None:
            try:
                self._flight.dump("slo_burn", force=True, extra=payload)
            except Exception:  # noqa: BLE001 — alerting must not die
                pass

    # --- report ---------------------------------------------------------
    def summary(self) -> dict:
        """The bench-record ``slo`` block: per-objective verdicts plus
        the worst burn rate seen over the run (regress derives the
        available-gated ``<metric>.burn_rate_max`` sub-series from
        it)."""
        with self._lock:
            objectives = self.objectives
            worst = dict(self._worst)
            alerting = dict(self._alerting)
            counts = dict(self._alert_counts)
        frames = len(self._timeline) if self._timeline is not None else 0
        per = {}
        for obj in objectives:
            per[obj.name] = {
                "kind": obj.kind,
                "target": obj.target,
                "worst_burn_rate": round(worst.get(obj.name, 0.0), 6),
                "alerts": counts.get(obj.name, 0),
                "alerting": alerting.get(obj.name, False),
            }
        return {
            "available": bool(objectives),
            "frames": frames,
            "objectives": per,
            "worst_burn_rate": round(max(worst.values(), default=0.0),
                                     6),
            "alerts": sum(counts.values()),
        }

    def slo_records(self) -> List[dict]:
        """Schema-v4 ``slo`` record fields for the sink: every retained
        alert transition (with its original ``ts``) plus one end-of-run
        verdict per objective."""
        with self._lock:
            events = [dict(e) for e in self._events]
        out = list(events)
        summ = self.summary()
        for name, verdict in summ["objectives"].items():
            out.append({"name": name,
                        "data": {"event": "verdict", **verdict}})
        return out


def slo_prometheus(registry) -> str:
    """Prometheus text rendering of the registry's ``slo.*`` metrics
    only — the ``GET /v1/slo`` content-negotiated body (the full
    ``/v1/metrics`` scrape carries them too; this view is for alerting
    rules that poll the SLO surface alone)."""
    from .opsplane import to_prometheus
    from .registry import MetricsRegistry
    sub = MetricsRegistry()
    for rec in registry.records():
        if str(rec.get("name", "")).startswith("slo."):
            sub.ingest_record(rec)
    return to_prometheus(sub)
