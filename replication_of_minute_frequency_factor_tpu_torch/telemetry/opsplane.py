"""Live ops plane for the resident services.

The port of the JAX package's ``telemetry/opsplane.py``. Three pieces the
long-lived processes (serve/, stream/) report through:

* :class:`HbmSampler` — device-memory watermarks read from
  ``torch.cuda.memory_stats`` (``allocated_bytes.all.current`` and
  ``.peak``) on a CUDA device. A sampler bound to the CPU reports an
  explicit ``unavailable`` marker and no bytes: torch keeps no
  allocator statistics there, and no live-tensor estimate stands in
  for them. Publishes ``device.hbm_bytes_in_use`` /
  ``device.hbm_peak_bytes`` / ``device.hbm_stats_available`` gauges per
  device, sampled at dispatch boundaries (serve/stream), plus an
  optional background sampler thread.

* :class:`FlightRecorder` — a bounded in-memory ring of recent
  request traces + last-dispatch metadata + registry counter deltas
  that dumps atomically to disk on an anomaly (breaker trip, load-shed
  burst, unhandled worker exception) or on demand
  (``POST /v1/debug/dump``). Dumps are schema-v2 JSONL written through
  :class:`..telemetry.sink.EventSink`, so every dump validates by
  construction.

* :func:`to_prometheus` — the standard Prometheus text exposition of a
  :class:`..telemetry.registry.MetricsRegistry` (counters, gauges,
  histogram-as-summary p50/p95/p99 quantiles, with labels), rendered from ONE
  atomic ``records()`` read so a concurrent scrape can never observe a
  torn snapshot. ``GET /v1/metrics`` content-negotiates it.
"""

from __future__ import annotations

import os
import re
import threading
import time
import uuid
from collections import deque
from typing import Dict, List, Optional

from .registry import MetricsRegistry

#: default bound on the flight recorder's request ring
FLIGHT_RING = 256

#: seconds between anomaly dumps (non-forced); a wedged service must
#: not spray one dump per failed request
MIN_DUMP_INTERVAL_S = 1.0

#: load-shed burst trigger: this many sheds inside the window dumps
SHED_BURST = 10
SHED_WINDOW_S = 1.0

#: default floor between two effective samples (dispatch boundaries
#: fire far faster than watermarks move)
SAMPLE_MIN_INTERVAL_S = 0.05


def gen_trace_id() -> str:
    """A fresh 16-hex request trace ID."""
    return uuid.uuid4().hex[:16]


_TRACE_ID_RE = re.compile(r"^[A-Za-z0-9._-]{1,64}$")


def canonical_trace_id(raw) -> str:
    """``raw`` when it is a well-formed propagated trace ID (the
    ``X-Trace-Id`` charset), else a fresh one — never raises, so a
    hostile header cannot take a request down."""
    if isinstance(raw, str) and _TRACE_ID_RE.match(raw):
        return raw
    return gen_trace_id()


# --------------------------------------------------------------------------
# device-memory watermarks
# --------------------------------------------------------------------------

#: the lock contract the runtime lock-assertion twin (telemetry/lockcheck.py)
#: checks. The sampler's watermark state
#: is shared between its daemon thread and any caller of ``sample``;
#: the recorder's ring is fed from request threads and drained by the
#: anomaly dump path. The recorder's public ``dump_count`` /
#: ``suppressed_count`` / ``dumps`` are written under the lock but read
#: lock-free by ``/healthz`` (monotonic ints and an append-only list —
#: a torn read is impossible), so they stay out of the guarded set.
GLC_CONTRACT = {
    "HbmSampler": {
        "lock": "_lock",
        "guards": ("_last_t", "_peaks", "_summary", "_thread"),
        "init": (),
        "locked": (),
    },
    "FlightRecorder": {
        "lock": "_lock",
        "guards": ("_ring", "_last_dispatch", "_sheds", "_last_dump_t",
                   "_last_counters", "_seq"),
        "init": (),
        "locked": (),
    },
}


class HbmSampler:
    """Per-device memory watermark sampler over the CUDA devices.

    ``sample()`` is safe to call from any thread at any rate: it
    rate-limits itself (``min_interval_s``; ``force=True`` bypasses),
    swallows every backend error, and publishes per device ``d``:

    * ``device.hbm_bytes_in_use{device=cuda:<i>, source=memory_stats}``
      — the caching allocator's live bytes
      (``torch.cuda.memory_stats(i)['allocated_bytes.all.current']``);
    * ``device.hbm_peak_bytes{device=...}`` — high watermark: the
      allocator's ``allocated_bytes.all.peak`` (what
      ``torch.cuda.max_memory_allocated`` reads), or the running max of
      the samples when that is larger;
    * ``device.hbm_stats_available{device=...}`` — 1 when the allocator
      reported real stats, 0 otherwise.

    ``device`` picks what is sampled: a CUDA device (or None, which is
    the card when one is present) reads every visible card; a CPU
    device reports ``cpu`` as unavailable, with no bytes, which is
    honest — torch keeps no allocator statistics for host memory.
    ``start(period_s)`` runs the same sample on a daemon thread;
    ``stop()`` joins it.
    """

    def __init__(self, telemetry=None,
                 min_interval_s: float = SAMPLE_MIN_INTERVAL_S,
                 device=None):
        self._telemetry = telemetry
        self.min_interval_s = float(min_interval_s)
        self.device = device
        self._lock = threading.Lock()
        self._last_t: float = 0.0
        self._peaks: Dict[str, float] = {}
        self._summary: dict = {"available": False, "source": "never",
                               "devices": {}, "samples": 0,
                               "bytes_in_use": 0, "peak_bytes": 0}
        self._thread: Optional[threading.Thread] = None
        self._stop = threading.Event()
        from .lockcheck import maybe_install
        maybe_install(self)

    def configure(self, device=None) -> "HbmSampler":
        """Bind the sampler to ``device`` (a ``torch.device`` or its
        name; None is the card when one is present)."""
        self.device = device
        return self

    def _tel(self):
        if self._telemetry is not None:
            return self._telemetry
        from . import get_telemetry
        return get_telemetry()

    # --- sampling -------------------------------------------------------
    def _read_devices(self) -> Dict[str, dict]:
        """``{device_key: {"bytes_in_use", "peak", "available"}}`` —
        best-effort, never raises."""
        try:
            import torch
            dev = (torch.device(self.device) if self.device is not None
                   else torch.device("cuda" if torch.cuda.is_available()
                                     else "cpu"))
            if dev.type != "cuda" or not torch.cuda.is_available():
                return {dev.type: {"bytes_in_use": 0.0, "peak": 0.0,
                                   "available": False}}
            n = torch.cuda.device_count()
        except Exception:  # noqa: BLE001 — no backend, no sample
            return {}
        out: Dict[str, dict] = {}
        for i in range(n):
            key = f"cuda:{i}"
            try:
                stats = torch.cuda.memory_stats(i)
            except Exception:  # noqa: BLE001 — a lost device reads empty
                stats = {}
            cur = stats.get("allocated_bytes.all.current")
            if isinstance(cur, (int, float)):
                out[key] = {
                    "bytes_in_use": float(cur),
                    "peak": float(stats.get("allocated_bytes.all.peak")
                                  or 0.0),
                    "available": True,
                }
            else:
                out[key] = {"bytes_in_use": 0.0, "peak": 0.0,
                            "available": False}
        return out

    def sample(self, boundary: str = "manual",
               force: bool = False) -> dict:
        """One watermark sample across all devices; returns (and
        caches) the :meth:`summary` dict. Rate-limited unless
        ``force``."""
        now = time.monotonic()
        with self._lock:
            if not force and now - self._last_t < self.min_interval_s:
                return dict(self._summary)
            self._last_t = now
        readings = self._read_devices()
        tel = self._tel()
        devices: Dict[str, dict] = {}
        any_available = bool(readings)
        source = "memory_stats"
        for key, r in sorted(readings.items()):
            src = "memory_stats" if r["available"] else "unavailable"
            if not r["available"]:
                any_available = False
                source = "unavailable"
            with self._lock:
                peak = max(self._peaks.get(key, 0.0), r["peak"],
                           r["bytes_in_use"])
                self._peaks[key] = peak
            tel.gauge("device.hbm_bytes_in_use", r["bytes_in_use"],
                      device=key, source=src)
            tel.gauge("device.hbm_peak_bytes", peak, device=key)
            tel.gauge("device.hbm_stats_available",
                      1.0 if r["available"] else 0.0, device=key)
            devices[key] = {"bytes_in_use": int(r["bytes_in_use"]),
                            "peak_bytes": int(peak),
                            "available": r["available"],
                            "source": src}
        tel.counter("device.hbm_samples", boundary=boundary)
        with self._lock:
            self._summary = {
                "available": any_available,
                "source": source if readings else "none",
                "devices": devices,
                "samples": self._summary.get("samples", 0) + 1,
                "bytes_in_use": int(sum(d["bytes_in_use"]
                                        for d in devices.values())),
                "peak_bytes": int(max(
                    [d["peak_bytes"] for d in devices.values()],
                    default=0)),
            }
            return dict(self._summary)

    def summary(self) -> dict:
        """The last sample's condensed view: ``available`` False means
        no number below is a measured device-memory stat."""
        with self._lock:
            return dict(self._summary)

    def reset_peaks(self) -> None:
        with self._lock:
            self._peaks.clear()

    # --- background thread ----------------------------------------------
    def start(self, period_s: float = 0.5) -> "HbmSampler":
        """Sample every ``period_s`` on a daemon thread (idempotent)."""
        with self._lock:
            if self._thread is not None and self._thread.is_alive():
                return self
            self._stop.clear()
            self._thread = threading.Thread(
                target=self._run, args=(float(period_s),), daemon=True,
                name="hbm-sampler")
            self._thread.start()
        return self

    def _run(self, period_s: float) -> None:
        while not self._stop.wait(period_s):
            try:
                self.sample(boundary="background")
            except Exception as e:  # noqa: BLE001 — sampling must never kill
                # count the swallow so a dying sampler is
                # observable instead of silently stalled
                self._tel().counter("hbm.sample_errors",
                                    error=type(e).__name__)

    def stop(self, timeout: float = 2.0) -> None:
        with self._lock:
            thread = self._thread
            self._thread = None
        self._stop.set()
        if thread is not None and thread.is_alive():
            thread.join(timeout)


# --------------------------------------------------------------------------
# flight recorder
# --------------------------------------------------------------------------


class FlightRecorder:
    """Bounded ring of recent request traces with anomaly-triggered
    atomic dumps.

    ``record_request(trace)`` appends one request-lifecycle dict
    (``{"trace_id", "op", "status", "data": {...}}`` — the same shape
    ``Telemetry.request`` persists); ``note_dispatch(meta)`` keeps the
    last dispatch's metadata; ``note_shed(reason)`` watches for shed
    bursts. ``dump(trigger)`` writes everything as one schema-v2 JSONL
    file (``flight_<pid>_<seq>_<trigger>.jsonl``) into ``dump_dir`` —
    written to a temp name and atomically renamed, so a reader never
    sees a half dump. With no ``dump_dir`` configured (and no explicit
    ``out_dir``), dumps are recorded as counters only; the ring keeps
    recording either way.
    """

    def __init__(self, telemetry=None, ring: int = FLIGHT_RING,
                 dump_dir: Optional[str] = None,
                 min_dump_interval_s: float = MIN_DUMP_INTERVAL_S,
                 shed_burst: int = SHED_BURST,
                 shed_window_s: float = SHED_WINDOW_S):
        self._telemetry = telemetry
        self.dump_dir = dump_dir
        self.min_dump_interval_s = float(min_dump_interval_s)
        self.shed_burst = int(shed_burst)
        self.shed_window_s = float(shed_window_s)
        self._lock = threading.Lock()
        self._ring: "deque[dict]" = deque(maxlen=int(ring))
        self._last_dispatch: dict = {}
        self._sheds: "deque[float]" = deque(maxlen=max(4, int(shed_burst)))
        self._last_dump_t: float = 0.0
        self._last_counters: Dict[str, float] = {}
        self._seq = 0
        self.dump_count = 0
        self.dumps: List[str] = []
        #: non-forced dumps dropped by the rate limit (
        #: satellite: the 1/s limit used to drop them SILENTLY —
        #: now counted, surfaced in /healthz's flight block)
        self.suppressed_count = 0
        from .lockcheck import maybe_install
        maybe_install(self)

    def _tel(self):
        if self._telemetry is not None:
            return self._telemetry
        from . import get_telemetry
        return get_telemetry()

    def __len__(self) -> int:
        with self._lock:
            return len(self._ring)

    # --- feed -----------------------------------------------------------
    def record_request(self, trace: dict) -> None:
        with self._lock:
            self._ring.append(dict(trace))
        self._tel().gauge("flight.ring_depth", len(self))

    def note_dispatch(self, meta: dict) -> None:
        with self._lock:
            self._last_dispatch = dict(meta)

    def note_shed(self, reason: str) -> Optional[str]:
        """Track a shed; dumps (trigger ``load_shed_burst``) when
        ``shed_burst`` sheds land inside ``shed_window_s``."""
        now = time.monotonic()
        with self._lock:
            self._sheds.append(now)
            burst = (len(self._sheds) >= self.shed_burst
                     and now - self._sheds[0] <= self.shed_window_s)
            if burst:
                self._sheds.clear()
        if burst:
            return self.dump("load_shed_burst",
                             extra={"reason": reason})
        return None

    # --- dump -----------------------------------------------------------
    def _counters_delta(self, registry: MetricsRegistry) -> dict:
        snap = registry.snapshot()["counters"]
        with self._lock:
            last = self._last_counters
            delta = {k: round(v - last.get(k, 0.0), 9)
                     for k, v in snap.items()
                     if v != last.get(k, 0.0)}
            self._last_counters = dict(snap)
        return {"counters": snap, "counters_delta": delta}

    def dump(self, trigger: str, out_dir: Optional[str] = None,
             extra: Optional[dict] = None,
             force: bool = False) -> Optional[str]:
        """Write the ring + last-dispatch metadata + registry counter
        deltas as one atomic schema-v2 JSONL file; returns its path, or
        None when rate-limited / no directory is configured. Never
        raises — a failed dump must not take the anomaly path down
        with it."""
        tel = self._tel()
        now = time.monotonic()
        with self._lock:
            if not force and now - self._last_dump_t \
                    < self.min_dump_interval_s:
                self.suppressed_count += 1
                suppressed = True
            else:
                suppressed = False
            if not suppressed:
                self._last_dump_t = now
        if suppressed:
            tel.counter("flight.suppressed_total", trigger=trigger)
            return None
        with self._lock:
            self._seq += 1
            seq = self._seq
            requests = list(self._ring)
            last_dispatch = dict(self._last_dispatch)
        tel.counter("flight.dumps", trigger=trigger)
        tel.event("flight.dump", trigger=trigger,
                  requests=len(requests))
        target = out_dir or self.dump_dir
        if target is None:
            return None
        try:
            from .manifest import process_identity
            from .sink import EventSink
            os.makedirs(target, exist_ok=True)
            name = f"flight_{os.getpid()}_{seq:03d}_{trigger}.jsonl"
            path = os.path.join(target, name)
            tmp = path + ".tmp"
            # identity-stamped (schema v3): a pod aggregation can tell
            # which host's anomaly each dump records
            with EventSink(tmp, common=process_identity()) as sink:
                sink.emit("dump", trigger=trigger, data={
                    "requests": len(requests),
                    "last_dispatch": last_dispatch,
                    **self._counters_delta(tel.registry),
                    **({"extra": extra} if extra else {}),
                })
                for trace in requests:
                    sink.emit("request",
                              trace_id=str(trace.get("trace_id", "")),
                              op=str(trace.get("op", "")),
                              status=str(trace.get("status", "")),
                              data=dict(trace.get("data") or {}))
            os.replace(tmp, path)
        except Exception:  # noqa: BLE001 — best-effort by contract
            tel.counter("flight.dump_failures", trigger=trigger)
            return None
        with self._lock:
            self.dump_count += 1
            self.dumps.append(path)
        return path


# --------------------------------------------------------------------------
# Prometheus text exposition
# --------------------------------------------------------------------------

_PROM_NAME_RE = re.compile(r"[^a-zA-Z0-9_:]")


def _prom_name(name: str) -> str:
    out = _PROM_NAME_RE.sub("_", name)
    if out and out[0].isdigit():
        out = "_" + out
    return out


def _prom_label_value(v) -> str:
    return (str(v).replace("\\", r"\\").replace('"', r'\"')
            .replace("\n", r"\n"))


def _prom_labels(labels: dict, extra: Optional[dict] = None) -> str:
    merged = dict(labels or {})
    if extra:
        merged.update(extra)
    if not merged:
        return ""
    inner = ",".join(
        f'{_prom_name(str(k))}="{_prom_label_value(v)}"'
        for k, v in sorted(merged.items()))
    return "{" + inner + "}"


def _prom_value(v) -> str:
    f = float(v)
    if f == int(f) and abs(f) < 1e15:
        return str(int(f))
    return repr(f)


def to_prometheus(registry: MetricsRegistry) -> str:
    """The registry as Prometheus text-format v0.0.4.

    Counters render with the conventional ``_total`` suffix, gauges
    as-is, histograms as summaries (``quantile="0.5"/"0.95"/"0.99"``
    from the bounded reservoir plus exact ``_sum``/``_count``). Metric and label
    names are sanitized to the Prometheus charset; everything is
    rendered from one atomic ``registry.records()`` read, so a scrape
    concurrent with writers is internally consistent."""
    lines: List[str] = []
    typed: set = set()

    def _type(name: str, kind: str) -> None:
        if name not in typed:
            typed.add(name)
            lines.append(f"# TYPE {name} {kind}")

    for rec in registry.records():
        base = _prom_name(rec["name"])
        labels = rec.get("labels") or {}
        if rec["kind"] == "counter":
            name = base + "_total"
            _type(name, "counter")
            lines.append(f"{name}{_prom_labels(labels)} "
                         f"{_prom_value(rec['value'])}")
        elif rec["kind"] == "gauge":
            _type(base, "gauge")
            lines.append(f"{base}{_prom_labels(labels)} "
                         f"{_prom_value(rec['value'])}")
        else:  # histogram -> summary
            _type(base, "summary")
            for q, field in (("0.5", "p50"), ("0.95", "p95"),
                             ("0.99", "p99")):
                v = rec.get(field)
                if v is not None:
                    lines.append(
                        f"{base}"
                        f"{_prom_labels(labels, {'quantile': q})} "
                        f"{_prom_value(v)}")
            lines.append(f"{base}_sum{_prom_labels(labels)} "
                         f"{_prom_value(rec['sum'])}")
            lines.append(f"{base}_count{_prom_labels(labels)} "
                         f"{_prom_value(rec['count'])}")
    return "\n".join(lines) + "\n"
