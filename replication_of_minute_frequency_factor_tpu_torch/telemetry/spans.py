"""Span tracer: nesting context managers with Timer semantics, optional
``torch.profiler`` annotation, device time under a profiler, and
Chrome/Perfetto ``trace_events`` export.

The port's copy of the JAX package's ``telemetry/spans.py``; the profiler
region is :func:`..utils.tracing.trace_annotation`
(``torch.profiler.record_function``) where the JAX package opens a
``jax.profiler.TraceAnnotation``.

A span is one timed region. Spans nest (a thread-local stack tracks
depth and the parent span), accumulate per-name totals exactly like
:class:`..utils.tracing.Timer` (``totals()``/``report()``), feed a
``span_seconds{span=<name>}`` histogram into an attached
:class:`.registry.MetricsRegistry`, and are retained (bounded) as events
exportable as a Chrome trace JSON — load it at https://ui.perfetto.dev
or chrome://tracing.

**Device time.** The host enqueues kernels far ahead of the card, so a
span's host time says nothing of the card's. While a profiler session
runs (``torch.profiler``, or the program's
:class:`.attribution.TraceCapture`) — or always, with
``device_timing=True`` — each span also records a pair of CUDA timing
events on the current stream, at entry and at exit. The pairs wait in a
bounded pending list and are resolved only when the tracer is read
(:meth:`SpanTracer.device_totals`, :meth:`~SpanTracer.events`, the
exports): the hot path never waits for the device. A resolved span
carries ``device_us`` and ``device_self_us`` (its device time less that
of its timed direct children) and feeds ``span_device_seconds{span=}``.

**Clock.** Event ``ts_us`` count from the tracer's epoch, whose unix
time is :attr:`SpanTracer.base_time_ns`; the Chrome export writes it as
``baseTimeNanoseconds``, as ``torch.profiler``'s export does, so a
span's start and its ``user_annotation`` in a profiler trace of the same
run meet at one unix time.
"""

from __future__ import annotations

import contextlib
import itertools
import json
import os
import threading
import time
from typing import Callable, Dict, List, Optional

import torch

from .attribution import capture_active
from .registry import MetricsRegistry

#: retained-span bound; past it spans still time/aggregate but drop from
#: the trace export (`dropped_spans` counts them)
MAX_EVENTS = 20000

#: device-timed spans held unresolved; past it the older half is
#: resolved, which waits on the device only as far as those spans
MAX_PENDING = 8192

#: the lock contract the runtime lock-assertion twin (telemetry/lockcheck.py)
#: checks: totals/counts/events and the device-timing state take writes
#: from every instrumented thread. ``dropped_spans`` is a public monotonic
#: counter read lock-free by summaries and stays out of the guarded
#: set (the FlightRecorder.dump_count convention).
GLC_CONTRACT = {
    "SpanTracer": {
        "lock": "_lock",
        "guards": ("_totals", "_counts", "_events", "_pending",
                   "_device_totals", "_device_self_totals", "_child_us"),
        "init": (),
        "locked": (),
    },
}


def _cuda_timing_event():
    return torch.cuda.Event(enable_timing=True)


class SpanTracer:
    """``with tracer("name"): ...`` — nested, thread-safe span timing.

    Drop-in for ``utils.tracing.Timer`` wherever one is accepted: the
    same ``__call__`` context-manager protocol, ``totals()`` and
    ``report()``. On top of that every span lands in ``registry`` as a
    ``span_seconds{span=name}`` observation and in the bounded event
    list behind :meth:`to_chrome_trace`.

    ``device_timing``: None times spans on the device while a profiler
    session runs, True always, False never (an attribute: an operator
    may flip it). Spans record device events only when a CUDA context
    exists and the current stream is not capturing a graph.
    ``event_factory`` makes the timing events (default
    ``torch.cuda.Event(enable_timing=True)``); with one given, the CUDA
    checks are skipped.
    """

    def __init__(self, registry: Optional[MetricsRegistry] = None,
                 annotate: bool = True, max_events: int = MAX_EVENTS,
                 device_timing: Optional[bool] = None,
                 event_factory: Optional[Callable[[], object]] = None):
        self.registry = registry
        self.annotate = annotate
        self.max_events = max_events
        self.device_timing = device_timing
        self.max_pending = MAX_PENDING
        self._event_factory = event_factory
        self._epoch = time.perf_counter()
        #: unix nanoseconds at the epoch ``ts_us`` counts from
        self.base_time_ns = time.time_ns()
        self._lock = threading.Lock()
        self._resolve_lock = threading.Lock()
        self._ids = itertools.count(1)
        self._totals: Dict[str, float] = {}
        self._counts: Dict[str, int] = {}
        self._events: List[dict] = []
        self._pending: List[tuple] = []
        self._device_totals: Dict[str, float] = {}
        self._device_self_totals: Dict[str, float] = {}
        #: timed parent id -> device us of its resolved timed children
        self._child_us: Dict[int, float] = {}
        self.dropped_spans = 0
        self._tls = threading.local()
        from .lockcheck import maybe_install
        maybe_install(self)

    def _stack(self) -> list:
        """This thread's open spans, innermost last: ``(id, timed)``."""
        st = getattr(self._tls, "stack", None)
        if st is None:
            st = self._tls.stack = []
        return st

    def _depth(self) -> int:
        return len(self._stack())

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

    def _timing_on(self) -> bool:
        on = self.device_timing
        if on is None:
            on = torch.autograd._profiler_enabled() or capture_active()
        if not on:
            return False
        if self._event_factory is not None:
            return True
        return (torch.cuda.is_initialized()
                and not torch.cuda.is_current_stream_capturing())

    def _start_events(self):
        make = self._event_factory or _cuda_timing_event
        start, end = make(), make()
        start.record()
        return start, end

    @contextlib.contextmanager
    def __call__(self, name: str, trace_id: Optional[str] = None, *,
                 detail: Optional[dict] = None, **labels):
        """Extra ``labels`` ride on the ``span_seconds`` histogram
        observation AND the retained event (schema v3: the
        Chrome/Perfetto export and the JSONL span records carry them
        as args — e.g. ``kind=host_dispatch`` on collective dispatch
        spans, so a host-side span can never be read as on-device
        time); the span NAME, totals and attribution joins stay
        label-free. ``detail`` holds further labels of the retained
        event alone, kept off the histograms: values that change from
        call to call (sizes, byte counts) would split a span's series.
        ``trace_id`` (schema v2) rides the
        retained event too: request-scoped spans join their request's
        lifecycle in the JSONL export."""
        stack = self._stack()
        parent = stack[-1] if stack else None
        sid = next(self._ids)
        pair = self._start_events() if self._timing_on() else None
        stack.append((sid, pair is not None))
        depth = len(stack) - 1
        t0 = time.perf_counter()
        try:
            with self._annotation(name):
                yield
        finally:
            t1 = time.perf_counter()
            if pair is not None:
                pair[1].record()
            stack.pop()
            self._record(name, t0, t1 - t0, depth, trace_id, labels, sid,
                         parent, pair, detail)

    def _record(self, name: str, t0: float, dt: float, depth: int,
                trace_id: Optional[str], labels: dict, sid: int,
                parent: Optional[tuple], pair=None,
                detail: Optional[dict] = None) -> None:
        with self._lock:
            self._totals[name] = self._totals.get(name, 0.0) + dt
            self._counts[name] = self._counts.get(name, 0) + 1
            event = None
            if len(self._events) < self.max_events:
                event = {
                    "name": name,
                    "ts_us": round((t0 - self._epoch) * 1e6, 1),
                    "dur_us": round(dt * 1e6, 1),
                    "tid": threading.get_ident() & 0x7FFFFFFF,
                    "depth": depth,
                    "id": sid,
                    "parent": None if parent is None else parent[0],
                }
                if trace_id is not None:
                    event["trace_id"] = trace_id
                if labels or detail:
                    event["labels"] = {str(k): str(v) for k, v in
                                       {**labels, **(detail or {})}.items()}
                self._events.append(event)
            else:
                self.dropped_spans += 1
            if pair is not None:
                timed_parent = (parent[0] if parent is not None
                                and parent[1] else None)
                self._pending.append((pair, name, labels, event, sid,
                                      timed_parent))
                over = len(self._pending) > self.max_pending
            else:
                over = False
        if self.registry is not None:
            self.registry.observe("span_seconds", dt, span=name,
                                  **labels)
        if over:
            self._resolve(keep=self.max_pending // 2)

    def _resolve(self, keep: int = 0) -> None:
        """Resolve all but the newest ``keep`` pending spans, oldest
        first (a child closes, and so resolves, before its parent)."""
        with self._resolve_lock:
            with self._lock:
                n = len(self._pending) - keep
                if n <= 0:
                    return
                batch = list(self._pending[:n])
                self._pending = self._pending[n:]
            times = []
            for (start, end), *_ in batch:
                end.synchronize()
                times.append(start.elapsed_time(end) * 1e3)
            observed = []
            with self._lock:
                for (_, name, labels, event, sid, timed_parent), us in zip(
                        batch, times):
                    self_us = us - self._child_us.pop(sid, 0.0)
                    if timed_parent is not None:
                        self._child_us[timed_parent] = \
                            self._child_us.get(timed_parent, 0.0) + us
                    self._device_totals[name] = \
                        self._device_totals.get(name, 0.0) + us * 1e-6
                    self._device_self_totals[name] = \
                        self._device_self_totals.get(name, 0.0) \
                        + self_us * 1e-6
                    if event is not None:
                        event["device_us"] = round(us, 3)
                        event["device_self_us"] = round(self_us, 3)
                    observed.append((name, labels, us))
            if self.registry is not None:
                for name, labels, us in observed:
                    self.registry.observe("span_device_seconds", us * 1e-6,
                                          span=name, **labels)

    def add_span(self, name: str, start_s: float, dur_s: float,
                 trace_id: Optional[str] = None, **labels) -> None:
        """Record a span with EXPLICIT timing (``start_s`` on the
        ``time.perf_counter`` clock, ``dur_s`` seconds) — for lifecycle
        phases measured outside a ``with`` block, e.g. a request's
        queue-wait (known only once the worker dequeues it) or a
        coalesced dispatch's device-time share fanned back out to each
        member request's ``trace_id``."""
        stack = self._stack()
        self._record(name, start_s, max(0.0, float(dur_s)), len(stack),
                     trace_id, labels, next(self._ids),
                     stack[-1] if stack else None)

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

    # --- device time ----------------------------------------------------
    def device_totals(self) -> Dict[str, float]:
        """Device seconds per span name, over the device-timed spans
        (resolves the pending ones first)."""
        self._resolve()
        with self._lock:
            return dict(self._device_totals)

    def device_self_totals(self) -> Dict[str, float]:
        """:meth:`device_totals` less each span's timed direct
        children."""
        self._resolve()
        with self._lock:
            return dict(self._device_self_totals)

    # --- export ---------------------------------------------------------
    def events(self) -> List[dict]:
        self._resolve()
        with self._lock:
            return [dict(e) for e in self._events]

    def to_chrome_trace(self) -> dict:
        """Chrome/Perfetto ``trace_events`` JSON (complete 'X' events),
        ``ts`` from :attr:`base_time_ns`."""
        pid = os.getpid()
        return {
            "displayTimeUnit": "ms",
            "baseTimeNanoseconds": self.base_time_ns,
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
                     **{k: e[k] for k in ("device_us", "device_self_us")
                        if k in e},
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
