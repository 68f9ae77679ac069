"""Metrics registry: counters, gauges, and bounded histograms.

The port's copy of the JAX package's ``telemetry/registry.py``, host-only
code. One process-wide (but injectable — see :mod:`.` ``Telemetry``)
registry that every layer emits into.

Metrics are keyed by ``(name, labels)`` where labels are an order-
insensitive set of key/value pairs, rendered Prometheus-style
(``name{k=v,k2=v2}``) in snapshots. All operations are thread-safe: the
pipeline's producer thread and the consumer's isolation path hit the
same keys concurrently.
"""

from __future__ import annotations

import threading
from typing import Dict, List, Optional, Tuple

from .lockcheck import maybe_install

#: the lock contract the runtime lock-assertion twin
#: (telemetry/lockcheck.py) checks: every metric map is mutated by
#: the pipeline producer thread, the serve worker, and the sampler
#: daemons concurrently, and ``_lock`` guards all three.
GLC_CONTRACT = {
    "MetricsRegistry": {
        "lock": "_lock",
        "guards": ("_counters", "_gauges", "_hists"),
        "init": (),
        "locked": (),
    },
}

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

    The reservoir keeps every observation until ``bound`` samples are
    retained, then halves itself (every other sample) and doubles its
    stride, so memory is O(bound) no matter how many observations
    arrive while the retained set stays spread over the whole stream
    (a day-long pipeline run cannot OOM the registry).
    """

    __slots__ = ("count", "total", "min", "max", "bound",
                 "_samples", "_stride", "_seen")

    def __init__(self, bound: int = HIST_BOUND):
        self.count = 0
        self.total = 0.0
        self.min: Optional[float] = None
        self.max: Optional[float] = None
        self.bound = bound
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
            if len(self._samples) >= self.bound:
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
                # the tail quantile the ops plane exports
                "p99": self.percentile(0.99)}

    @classmethod
    def from_stats(cls, count, total, vmin=None, vmax=None,
                   p50=None, p95=None, p99=None, bound: int = HIST_BOUND
                   ) -> "Histogram":
        """Reconstitute a histogram from its persisted JSONL stats
        (a registry rebuilt from a written bundle). ``count``/``sum``/
        ``min``/``max`` are exact — merging reconstituted histograms
        keeps pod counts and sums equal to the per-host sums by
        construction; the reservoir is re-seeded from the known order
        statistics, so merged percentiles are APPROXIMATE (the full
        sample stream is not persisted) and are documented as such in
        the pod bundle."""
        h = cls(bound)
        h.count = int(count)
        h.total = float(total)
        h.min = None if vmin is None else float(vmin)
        h.max = None if vmax is None else float(vmax)
        h._samples = sorted(float(v)
                            for v in (vmin, p50, p95, p99, vmax)
                            if v is not None)
        return h

    def copy(self) -> "Histogram":
        """Independent snapshot of this histogram's state — taken under
        the owning registry's lock so a concurrent ``observe`` on the
        source cannot tear the copy."""
        h = Histogram(self.bound)
        h.count = self.count
        h.total = self.total
        h.min = self.min
        h.max = self.max
        h._samples = list(self._samples)
        h._stride = self._stride
        h._seen = self._seen
        return h

    def merge(self, other: "Histogram") -> None:
        self.count += other.count
        self.total += other.total
        for v in (other.min, other.max):
            if v is None:
                continue
            if self.min is None or v < self.min:
                self.min = v
            if self.max is None or v > self.max:
                self.max = v
        self._samples.extend(other._samples)
        while len(self._samples) >= self.bound:
            self._samples = self._samples[::2]
            self._stride *= 2


class MetricsRegistry:
    """Counters (monotonic sums), gauges (last-write-wins), histograms
    (bounded; p50/p95/max), all keyed by name+labels."""

    def __init__(self):
        self._lock = threading.Lock()
        self._counters: Dict[tuple, float] = {}
        self._gauges: Dict[tuple, float] = {}
        self._hists: Dict[tuple, Histogram] = {}
        maybe_install(self)

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

    def records(self) -> List[dict]:
        """Per-metric schema records for the JSONL sink (see sink.py)."""
        out: List[dict] = []
        with self._lock:
            for (n, ls), v in sorted(self._counters.items()):
                out.append({"kind": "counter", "name": n,
                            "labels": dict(ls), "value": v})
            for (n, ls), v in sorted(self._gauges.items()):
                out.append({"kind": "gauge", "name": n,
                            "labels": dict(ls), "value": v})
            for (n, ls), h in sorted(self._hists.items()):
                out.append({"kind": "histogram", "name": n,
                            "labels": dict(ls), **h.stats()})
        return out

    def ingest_record(self, rec: dict) -> bool:
        """Fold one persisted metric record (the :meth:`records` /
        JSONL shape) back into this registry — the inverse direction
        (``slo_prometheus`` renders a filtered registry through it). Counters ADD (re-ingesting twice double-counts
        — aggregation reads each bundle once), gauges last-write-win,
        histograms reconstitute via :class:`Histogram.from_stats`.
        Returns False for non-metric kinds."""
        kind = rec.get("kind")
        name = rec.get("name")
        labels = rec.get("labels") or {}
        if not isinstance(name, str):
            return False
        if kind == "counter":
            self.counter(name, float(rec["value"]), **labels)
            return True
        if kind == "gauge":
            self.gauge(name, float(rec["value"]), **labels)
            return True
        if kind == "histogram":
            h = Histogram.from_stats(rec["count"], rec["sum"],
                                     rec.get("min"), rec.get("max"),
                                     rec.get("p50"), rec.get("p95"),
                                     rec.get("p99"))
            k = _key(name, labels)
            with self._lock:
                mine = self._hists.get(k)
                if mine is None:
                    mine = self._hists[k] = Histogram(h.bound)
                mine.merge(h)
            return True
        return False

    def merge(self, other: "MetricsRegistry") -> "MetricsRegistry":
        """Fold ``other`` into self: counters sum, gauges last-write-wins
        (``other`` is the later writer), histograms combine. Histogram
        state is deep-copied under ``other``'s lock, so a concurrent
        ``observe`` on ``other`` cannot mutate a histogram while this
        side merges its sample list."""
        with other._lock:
            counters = dict(other._counters)
            gauges = dict(other._gauges)
            hists = {k: h.copy() for k, h in other._hists.items()}
        with self._lock:
            for k, v in counters.items():
                self._counters[k] = self._counters.get(k, 0.0) + v
            self._gauges.update(gauges)
            for k, h in hists.items():
                mine = self._hists.get(k)
                if mine is None:
                    mine = self._hists[k] = Histogram(h.bound)
                mine.merge(h)
        return self
