"""Span tracer: nesting context managers with Timer semantics, optional
``torch.profiler`` annotation, and Chrome/Perfetto ``trace_events`` export.

The port's copy of the JAX package's ``telemetry/spans.py``; the profiler
region is :func:`..utils.tracing.trace_annotation`
(``torch.profiler.record_function``) where the JAX package opens a
``jax.profiler.TraceAnnotation``.

A span is one timed region. Spans nest (a thread-local stack tracks
depth), accumulate per-name totals exactly like
:class:`..utils.tracing.Timer` (``totals()``/``report()``), feed a
``span_seconds{span=<name>}`` histogram into an attached
:class:`.registry.MetricsRegistry`, and are retained (bounded) as events
exportable as a Chrome trace JSON — load it at https://ui.perfetto.dev
or chrome://tracing.
"""

from __future__ import annotations

import contextlib
import json
import os
import threading
import time
from typing import Dict, List, Optional

from .registry import MetricsRegistry

#: retained-span bound; past it spans still time/aggregate but drop from
#: the trace export (`dropped_spans` counts them)
MAX_EVENTS = 20000

#: the lock contract the runtime lock-assertion twin (telemetry/lockcheck.py)
#: checks: totals/counts/events take writes from
#: every instrumented thread. ``dropped_spans`` is a public monotonic
#: counter read lock-free by summaries and stays out of the guarded
#: set (the FlightRecorder.dump_count convention).
GLC_CONTRACT = {
    "SpanTracer": {
        "lock": "_lock",
        "guards": ("_totals", "_counts", "_events"),
        "init": (),
        "locked": (),
    },
}


class SpanTracer:
    """``with tracer("name"): ...`` — nested, thread-safe span timing.

    Drop-in for ``utils.tracing.Timer`` wherever one is accepted: the
    same ``__call__`` context-manager protocol, ``totals()`` and
    ``report()``. On top of that every span lands in ``registry`` as a
    ``span_seconds{span=name}`` observation and in the bounded event
    list behind :meth:`to_chrome_trace`.
    """

    def __init__(self, registry: Optional[MetricsRegistry] = None,
                 annotate: bool = True, max_events: int = MAX_EVENTS):
        self.registry = registry
        self.annotate = annotate
        self.max_events = max_events
        self._epoch = time.perf_counter()
        self._lock = threading.Lock()
        self._totals: Dict[str, float] = {}
        self._counts: Dict[str, int] = {}
        self._events: List[dict] = []
        self.dropped_spans = 0
        self._tls = threading.local()
        from .lockcheck import maybe_install
        maybe_install(self)

    def _depth(self) -> int:
        return getattr(self._tls, "depth", 0)

    @contextlib.contextmanager
    def _annotation(self, name: str):
        if not self.annotate:
            yield
            return
        try:
            from ..utils.tracing import trace_annotation
            cm = trace_annotation(name)
        except Exception:  # noqa: BLE001 — tracing must never break work
            yield
            return
        with cm:
            yield

    @contextlib.contextmanager
    def __call__(self, name: str, trace_id: Optional[str] = None,
                 **labels):
        """Extra ``labels`` ride on the ``span_seconds`` histogram
        observation AND the retained event (schema v3: the
        Chrome/Perfetto export and the JSONL span records carry them
        as args — e.g. ``kind=host_dispatch`` on collective dispatch
        spans, so a host-side span can never be read as on-device
        time); the span NAME, totals and attribution joins stay
        label-free. ``trace_id`` (schema v2) rides the
        retained event too: request-scoped spans join their request's
        lifecycle in the JSONL export."""
        self._tls.depth = depth = self._depth() + 1
        t0 = time.perf_counter()
        try:
            with self._annotation(name):
                yield
        finally:
            t1 = time.perf_counter()
            self._tls.depth = depth - 1
            self._record(name, t0, t1 - t0, depth - 1, trace_id, labels)

    def _record(self, name: str, t0: float, dt: float, depth: int,
                trace_id: Optional[str], labels: dict) -> None:
        with self._lock:
            self._totals[name] = self._totals.get(name, 0.0) + dt
            self._counts[name] = self._counts.get(name, 0) + 1
            if len(self._events) < self.max_events:
                event = {
                    "name": name,
                    "ts_us": round((t0 - self._epoch) * 1e6, 1),
                    "dur_us": round(dt * 1e6, 1),
                    "tid": threading.get_ident() & 0x7FFFFFFF,
                    "depth": depth,
                }
                if trace_id is not None:
                    event["trace_id"] = trace_id
                if labels:
                    event["labels"] = {str(k): str(v)
                                       for k, v in labels.items()}
                self._events.append(event)
            else:
                self.dropped_spans += 1
        if self.registry is not None:
            self.registry.observe("span_seconds", dt, span=name,
                                  **labels)

    def add_span(self, name: str, start_s: float, dur_s: float,
                 trace_id: Optional[str] = None, **labels) -> None:
        """Record a span with EXPLICIT timing (``start_s`` on the
        ``time.perf_counter`` clock, ``dur_s`` seconds) — for lifecycle
        phases measured outside a ``with`` block, e.g. a request's
        queue-wait (known only once the worker dequeues it) or a
        coalesced dispatch's device-time share fanned back out to each
        member request's ``trace_id``."""
        self._record(name, start_s, max(0.0, float(dur_s)),
                     self._depth(), trace_id, labels)

    # --- Timer parity ---------------------------------------------------
    def totals(self) -> Dict[str, float]:
        with self._lock:
            return dict(self._totals)

    def report(self) -> str:
        with self._lock:
            rows = [f"{k}: {self._totals[k]:.3f}s x{self._counts[k]}"
                    for k in sorted(self._totals, key=self._totals.get,
                                    reverse=True)]
        return "; ".join(rows) or "no timings"

    # --- export ---------------------------------------------------------
    def events(self) -> List[dict]:
        with self._lock:
            return list(self._events)

    def to_chrome_trace(self) -> dict:
        """Chrome/Perfetto ``trace_events`` JSON (complete 'X' events)."""
        pid = os.getpid()
        return {
            "displayTimeUnit": "ms",
            "traceEvents": [
                {"name": e["name"], "ph": "X", "pid": pid,
                 "tid": e["tid"], "ts": e["ts_us"], "dur": e["dur_us"],
                 "args": {
                     "depth": e["depth"],
                     **({"trace_id": e["trace_id"]}
                        if "trace_id" in e else {}),
                     # span labels surface in Perfetto's args pane, so
                     # e.g. kind=host_dispatch is visible per slice
                     **(e.get("labels") or {}),
                 }}
                for e in self.events()
            ],
        }

    def write_chrome_trace(self, path: str) -> str:
        # atomic write — trace files are read by external
        # viewers while a live tracer may still be exporting
        tmp = path + ".tmp"
        with open(tmp, "w") as fh:
            json.dump(self.to_chrome_trace(), fh)
        os.replace(tmp, path)
        return path
