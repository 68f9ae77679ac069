"""Metrics registry: counters, gauges, and bounded histograms.

The port's copy of the JAX package's ``telemetry/registry.py``, host-only
code. One process-wide (but injectable — see :mod:`.` ``Telemetry``)
registry that every layer emits into.

Metrics are keyed by ``(name, labels)`` where labels are an order-
insensitive set of key/value pairs, rendered Prometheus-style
(``name{k=v,k2=v2}``) in snapshots. All operations are thread-safe: the
pipeline's producer thread and the consumer's isolation path hit the
same keys concurrently. The JAX package's runtime lock-assertion hook
(``lockcheck.maybe_install``) and the parts that serve its JSONL sink
and pod aggregation (``records``, ``ingest_record``, ``merge``) belong to
the rest of the telemetry plane and are not ported.
"""

from __future__ import annotations

import threading
from typing import Dict, List, Optional, Tuple

#: retained-sample bound per histogram; count/sum/min/max stay exact
#: past it, percentiles come from the decimated reservoir
HIST_BOUND = 2048


def _key(name: str, labels: dict) -> Tuple[str, tuple]:
    """Hashable, label-order-insensitive metric key."""
    if not labels:
        return (name, ())
    return (name, tuple(sorted((str(k), str(v))
                               for k, v in labels.items())))


def render_key(name: str, labels: tuple) -> str:
    """``name{k=v,...}`` — the snapshot/JSONL rendering of a key."""
    if not labels:
        return name
    return name + "{" + ",".join(f"{k}={v}" for k, v in labels) + "}"


class Histogram:
    """Bounded histogram: exact ``count``/``sum``/``min``/``max``, and
    p50/p95 from a deterministic decimated reservoir.

    The reservoir keeps every observation until :data:`HIST_BOUND`
    samples are retained, then halves itself (every other sample) and
    doubles its stride, so memory is O(HIST_BOUND) no matter how many
    observations arrive while the retained set stays spread over the
    whole stream (a day-long pipeline run cannot OOM the registry).
    """

    __slots__ = ("count", "total", "min", "max",
                 "_samples", "_stride", "_seen")

    def __init__(self):
        self.count = 0
        self.total = 0.0
        self.min: Optional[float] = None
        self.max: Optional[float] = None
        self._samples: List[float] = []
        self._stride = 1
        self._seen = 0  # observations since the last retained sample

    def observe(self, value: float) -> None:
        value = float(value)
        self.count += 1
        self.total += value
        if self.min is None or value < self.min:
            self.min = value
        if self.max is None or value > self.max:
            self.max = value
        self._seen += 1
        if self._seen >= self._stride:
            self._seen = 0
            self._samples.append(value)
            if len(self._samples) >= HIST_BOUND:
                self._samples = self._samples[::2]
                self._stride *= 2

    def percentile(self, q: float) -> Optional[float]:
        """Nearest-rank percentile over the retained reservoir (q in
        [0, 1]); None when nothing was observed."""
        if not self._samples:
            return None
        s = sorted(self._samples)
        return s[min(len(s) - 1, max(0, round(q * (len(s) - 1))))]

    def stats(self) -> dict:
        return {"count": self.count,
                "sum": round(self.total, 9),
                "min": self.min, "max": self.max,
                "p50": self.percentile(0.50),
                "p95": self.percentile(0.95),
                # the tail quantile
                "p99": self.percentile(0.99)}


class MetricsRegistry:
    """Counters (monotonic sums), gauges (last-write-wins), histograms
    (bounded; p50/p95/max), all keyed by name+labels."""

    def __init__(self):
        self._lock = threading.Lock()
        self._counters: Dict[tuple, float] = {}
        self._gauges: Dict[tuple, float] = {}
        self._hists: Dict[tuple, Histogram] = {}

    # --- write ----------------------------------------------------------
    def counter(self, name: str, value: float = 1.0, **labels) -> None:
        k = _key(name, labels)
        with self._lock:
            self._counters[k] = self._counters.get(k, 0.0) + value

    def gauge(self, name: str, value: float, **labels) -> None:
        with self._lock:
            self._gauges[_key(name, labels)] = float(value)

    def observe(self, name: str, value: float, **labels) -> None:
        k = _key(name, labels)
        with self._lock:
            h = self._hists.get(k)
            if h is None:
                h = self._hists[k] = Histogram()
            h.observe(value)

    # --- read -----------------------------------------------------------
    def counter_value(self, name: str, **labels) -> float:
        """Exact-key counter read (0.0 when never incremented)."""
        with self._lock:
            return self._counters.get(_key(name, labels), 0.0)

    def counter_total(self, name: str) -> float:
        """Sum of a counter over ALL label sets sharing ``name``."""
        with self._lock:
            return sum(v for (n, _), v in self._counters.items()
                       if n == name)

    def gauge_value(self, name: str, **labels) -> Optional[float]:
        with self._lock:
            return self._gauges.get(_key(name, labels))

    def histogram_stats(self, name: str, **labels) -> Optional[dict]:
        with self._lock:
            h = self._hists.get(_key(name, labels))
            return h.stats() if h is not None else None

    def snapshot(self) -> dict:
        """Rendered-key snapshot of every metric (JSON-serializable)."""
        with self._lock:
            return {
                "counters": {render_key(n, ls): v
                             for (n, ls), v in sorted(self._counters.items())},
                "gauges": {render_key(n, ls): v
                           for (n, ls), v in sorted(self._gauges.items())},
                "histograms": {render_key(n, ls): h.stats()
                               for (n, ls), h in sorted(self._hists.items())},
            }
