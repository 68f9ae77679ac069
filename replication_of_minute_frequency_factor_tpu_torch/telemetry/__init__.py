"""Run telemetry, the part the host driver uses.

The port's copy of the JAX package's ``Telemetry`` core: a
:class:`.registry.MetricsRegistry` (counters, gauges, bounded
histograms keyed by name+labels), a bounded free-form event buffer, and
:class:`StageTimer`, whose stages are ``torch.profiler`` regions and
``span_seconds{span=...}`` histogram observations. A process-wide
default instance exists from first use (``get_telemetry``), so hot paths
instrument unconditionally at dict-update cost; a test or a run that
wants an isolated stream builds its own ``Telemetry`` and passes it down
or installs it via ``set_telemetry``. The span tracer, the JSONL sink,
the manifest and the device-facing planes are not ported.
"""

from __future__ import annotations

import contextlib
import threading
import time
from typing import List, Optional

from ..utils.tracing import Timer, trace_annotation
from .attribution import reconcile
from .registry import Histogram, MetricsRegistry, render_key

__all__ = ["Histogram", "MetricsRegistry", "StageTimer", "Telemetry",
           "get_telemetry", "reconcile", "render_key", "set_telemetry"]

#: retained free-form events bound (events past it count, not retain)
MAX_FREE_EVENTS = 5000


class StageTimer(Timer):
    """A :class:`..utils.tracing.Timer` whose stages ALSO land in a
    Telemetry object: each ``with timer("io")`` runs inside a
    ``torch.profiler`` region named ``io`` and ends in a
    ``span_seconds{span=io}`` histogram observation, while
    ``totals()``/``report()`` keep their per-run Timer meaning
    (``ExposureTable.timings``).

    Constructor ``labels`` attach to every stage's ``span_seconds``
    observation (e.g. ``rolling_impl=cuda``) so a stage's time says which
    backend it belongs to."""

    def __init__(self, telemetry: "Telemetry", **labels):
        super().__init__()
        self._tel = telemetry
        self._labels = labels

    @contextlib.contextmanager
    def __call__(self, name: str):
        t0 = time.perf_counter()
        try:
            with trace_annotation(name):
                yield
        finally:
            dt = time.perf_counter() - t0
            self._add(name, dt)
            self._tel.observe("span_seconds", dt, span=name, **self._labels)


class Telemetry:
    """Metrics registry + bounded event buffer, as one unit."""

    def __init__(self):
        self.registry = MetricsRegistry()
        self._events: List[dict] = []
        self._events_dropped = 0
        self._lock = threading.Lock()

    def counter(self, name: str, value: float = 1.0, **labels) -> None:
        self.registry.counter(name, value, **labels)

    def gauge(self, name: str, value: float, **labels) -> None:
        self.registry.gauge(name, value, **labels)

    def observe(self, name: str, value: float, **labels) -> None:
        self.registry.observe(name, value, **labels)

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
