"""Continuous telemetry timeline: bounded in-process time series +
incident replay.

Every signal the registry holds is point-in-time — gauges overwrite,
Prometheus scrapes are stateless, bench records are one-shot snapshots.
:class:`TimelineStore` turns the registry into a *timeline*: a bounded
ring of ``frame`` samples taken at a fixed interval, each holding

* ``rate:<counter-key>`` — the counter's per-second rate over the
  frame's interval (pod-foldable: rates over the same interval SUM
  exactly, the property ``telemetry.aggregate`` re-verifies);
* ``gauge:<gauge-key>`` — the gauge's value at the sample instant,
  plus every registered *source* signal (stream cursor staleness
  seconds, discovery generations/sec, per-replica liveness — host-side
  mirrors only, never a device read);
* ``p50:/p95:/p99:<histogram-key>`` — the histogram quantiles.

Frames persist as schema-v4 ``frame`` records through the existing
JSONL sink (``Telemetry.write``), stamped with the
``process_index``/``host`` identity like every other record, so
``telemetry.aggregate`` folds N replica timelines onto one pod clock.

``start(period_s)`` runs the sampler on a daemon thread (the
:class:`..opsplane.HbmSampler` pattern: idempotent, never-raising,
``stop()`` joins); per-frame callbacks (:meth:`on_frame`) are how the
:class:`..slo.SloPlane` evaluates its burn rates on the same cadence.

Sampling reads ONLY host-side state (registry snapshots, host mirror
hooks) — zero host-blocking device syncs by construction, which
tests/test_slo.py counter-asserts.

Incident replay CLI::

    python -m replication_of_minute_frequency_factor_tpu_torch.telemetry.timeline \\
        BUNDLE_DIR

replays a persisted bundle into an incident report: every ``slo_burn``
flight dump becomes one incident with its alert window, the timeline
frames spanning it (with a first->last frame diff of the top-moving
series), the member request traces cross-linked by trace ID, and the
``slo`` records cross-linked by objective name. One machine-readable
JSON verdict line (the validate/regress convention), non-zero exit
when the bundle is unreadable.
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import sys
import threading
import time
from collections import deque
from typing import Callable, Dict, List, Optional

import numpy as np

#: default bound on the frame ring (at the default 0.5 s period this
#: retains ~6 minutes of history — enough to span the scaled alert
#: windows; raise it for long-lived servers)
TIMELINE_RING = 720

#: default sampler-thread period
SAMPLE_PERIOD_S = 0.5

#: the lock contract the runtime lock-assertion twin (telemetry/lockcheck.py)
#: checks: the frame ring and its delta
#: state are written by the sampler daemon and read by HTTP/query
#: threads; the wiring lists and the thread handle flip under the same
#: lock. ``_stop`` (threading.Event) is self-synchronizing and stays
#: out of the contract.
GLC_CONTRACT = {
    "TimelineStore": {
        "lock": "_lock",
        "guards": ("_frames", "_last_counters", "_last_t", "_seq",
                   "_sources", "_callbacks", "_thread"),
        "init": (),
        "locked": (),
    },
}


class TimelineStore:
    """Bounded ring of registry-delta frames on one clock.

    ``clock`` is injectable (tests/smokes pass a controllable one so
    burn windows scale to test time); wall-clock ``ts`` stamps ride
    every frame regardless, because persisted frames must correlate
    with flight dumps and request records on the bundle's clock.
    """

    def __init__(self, telemetry=None, ring: int = TIMELINE_RING,
                 clock: Callable[[], float] = time.monotonic):
        self._telemetry = telemetry
        self.clock = clock
        self._lock = threading.Lock()
        self._frames: "deque[dict]" = deque(maxlen=int(ring))
        self._last_counters: Dict[str, float] = {}
        self._last_t: Optional[float] = None
        self._seq = 0
        self._sources: List[Callable[[], dict]] = []
        self._callbacks: List[Callable[[dict], None]] = []
        self._thread: Optional[threading.Thread] = None
        self._stop = threading.Event()
        from .lockcheck import maybe_install
        maybe_install(self)

    def _tel(self):
        if self._telemetry is not None:
            return self._telemetry
        from . import get_telemetry
        return get_telemetry()

    # --- wiring ---------------------------------------------------------
    def add_source(self, fn: Callable[[], dict]) -> None:
        """Register a derived-signal source: a callable returning
        ``{series_name: value}`` read at every sample (host-side
        mirrors only — a source must never block on a device). A
        raising source is skipped for that frame, never fatal."""
        with self._lock:
            if fn not in self._sources:
                self._sources.append(fn)

    def on_frame(self, fn: Callable[[dict], None]) -> None:
        """Register a per-frame callback (the SLO plane's evaluation
        hook); called after each frame lands, outside the store lock."""
        with self._lock:
            if fn not in self._callbacks:
                self._callbacks.append(fn)

    # --- sampling -------------------------------------------------------
    def sample(self) -> dict:
        """Take one frame NOW: counter rates over the elapsed interval,
        gauge values, histogram quantiles, derived source signals.
        Returns the frame dict (also appended to the ring)."""
        now = self.clock()
        ts = round(time.time(), 3)
        snap = self._tel().registry.snapshot()
        with self._lock:
            last_t = self._last_t
            last_counters = self._last_counters
            sources = list(self._sources)
        dt = (now - last_t) if last_t is not None else 0.0
        series: Dict[str, float] = {}
        new_counters: Dict[str, float] = {}
        for key, v in snap["counters"].items():
            new_counters[key] = float(v)
            if dt > 0:
                rate = (float(v) - last_counters.get(key, 0.0)) / dt
                series[f"rate:{key}"] = round(max(0.0, rate), 9)
            else:
                series[f"rate:{key}"] = 0.0
        for key, v in snap["gauges"].items():
            series[f"gauge:{key}"] = float(v)
        for key, st in snap["histograms"].items():
            for q in ("p50", "p95", "p99"):
                if st.get(q) is not None:
                    series[f"{q}:{key}"] = float(st[q])
        for src in sources:
            try:
                for name, val in (src() or {}).items():
                    if val is None:
                        continue
                    series[f"gauge:{name}"] = float(val)
            except Exception:  # noqa: BLE001 — a source must not kill
                pass
        with self._lock:
            self._seq += 1
            frame = {"seq": self._seq, "t": now, "ts": ts,
                     "interval_s": round(dt, 6), "series": series}
            self._frames.append(frame)
            self._last_t = now
            self._last_counters = new_counters
            callbacks = list(self._callbacks)
        for cb in callbacks:
            try:
                cb(frame)
            except Exception:  # noqa: BLE001 — sampling must never kill
                pass
        return frame

    # --- read -----------------------------------------------------------
    def __len__(self) -> int:
        with self._lock:
            return len(self._frames)

    def frames(self) -> List[dict]:
        with self._lock:
            return [dict(f) for f in self._frames]

    def latest(self) -> Optional[dict]:
        with self._lock:
            return dict(self._frames[-1]) if self._frames else None

    def query(self, name: Optional[str] = None,
              since: Optional[float] = None,
              limit: Optional[int] = None) -> List[dict]:
        """Frames for ``GET /v1/timeline?name=&since=``: wall-clock
        ``ts >= since``, series filtered to keys containing ``name``
        (prefix-qualified keys included — ``name=serve.requests``
        matches ``rate:serve.requests{kind=factors}``)."""
        out = []
        for f in self.frames():
            if since is not None and f["ts"] < float(since):
                continue
            series = f["series"]
            if name:
                series = {k: v for k, v in series.items() if name in k}
            out.append({"seq": f["seq"], "ts": f["ts"],
                        "interval_s": f["interval_s"],
                        "series": series})
        if limit is not None:
            out = out[-int(limit):]
        return out

    def frame_records(self) -> List[dict]:
        """Schema-v4 ``frame`` record fields for the JSONL sink
        (``Telemetry.write``): the explicit ``ts`` is the frame's OWN
        wall clock (the sink's default stamp would be write time, which
        breaks incident-window correlation)."""
        return [{"seq": f["seq"], "ts": f["ts"],
                 "interval_s": f["interval_s"],
                 "series": dict(f["series"])}
                for f in self.frames()]

    def top_movers(self, window_s: float, k: int = 5) -> List[dict]:
        """The timeline series that moved most over the trailing
        ``window_s`` (the plane's clock): ranked by range-normalized
        first->last delta. This is the ``slo_burn`` dump's
        pre-correlation payload — which series moved with the burn."""
        now = self.clock()
        window = [f for f in self.frames()
                  if f["t"] >= now - float(window_s)]
        if len(window) < 2:
            return []
        per_key: Dict[str, List[float]] = {}
        for f in window:
            for key, v in f["series"].items():
                per_key.setdefault(key, []).append(v)
        rows = []
        for key, vals in per_key.items():
            if len(vals) < 2:
                continue
            arr = np.asarray(vals, dtype=float)  # host list; declared
            delta = float(arr[-1] - arr[0])
            scale = float(np.max(np.abs(arr)))
            score = abs(delta) / scale if scale > 0 else 0.0
            rows.append({"series": key,
                         "first": round(float(arr[0]), 9),
                         "last": round(float(arr[-1]), 9),
                         "delta": round(delta, 9),
                         "score": round(score, 6)})
        rows.sort(key=lambda r: (r["score"], abs(r["delta"])),
                  reverse=True)
        return rows[:int(k)]

    # --- background thread ----------------------------------------------
    def start(self, period_s: float = SAMPLE_PERIOD_S
              ) -> "TimelineStore":
        """Sample every ``period_s`` on a daemon thread (idempotent)."""
        with self._lock:
            if self._thread is not None and self._thread.is_alive():
                return self
            self._stop.clear()
            self._thread = threading.Thread(
                target=self._run, args=(float(period_s),), daemon=True,
                name="timeline-sampler")
            self._thread.start()
        return self

    def _run(self, period_s: float) -> None:
        while not self._stop.wait(period_s):
            try:
                self.sample()
            except Exception as e:  # noqa: BLE001 — sampling must never kill
                # a silent swallow here turns a real bug into a
                # stalled timeline; the counter makes it observable
                self._tel().counter("timeline.sample_errors",
                                    error=type(e).__name__)

    def stop(self, timeout: float = 2.0) -> None:
        with self._lock:
            thread = self._thread
            self._thread = None
        self._stop.set()
        if thread is not None and thread.is_alive():
            thread.join(timeout)


# --------------------------------------------------------------------------
# incident replay (the CLI)
# --------------------------------------------------------------------------


def _load_jsonl(path: str) -> List[dict]:
    out: List[dict] = []
    with open(path) as fh:
        for line in fh:
            line = line.strip()
            if not line:
                continue
            try:
                rec = json.loads(line)
            except json.JSONDecodeError:
                continue
            if isinstance(rec, dict):
                out.append(rec)
    return out


def _frame_diff(frames: List[dict], k: int = 10) -> List[dict]:
    """First->last series deltas over ``frames`` (persisted-record
    shape), largest |delta| first — the offline twin of
    :meth:`TimelineStore.top_movers` over an incident's window."""
    if len(frames) < 2:
        return []
    first, last = frames[0]["series"], frames[-1]["series"]
    rows = []
    for key in sorted(set(first) | set(last)):
        a = first.get(key)
        b = last.get(key)
        if a is None or b is None:
            continue
        rows.append({"series": key, "first": round(float(a), 9),
                     "last": round(float(b), 9),
                     "delta": round(float(b) - float(a), 9)})
    rows.sort(key=lambda r: abs(r["delta"]), reverse=True)
    return rows[:int(k)]


def incident_report(bundle_dir: str) -> dict:
    """Replay a persisted bundle into the incident report: every
    ``slo_burn`` flight dump cross-linked with the timeline frames
    spanning its alert window (by wall-clock ``ts``), the member
    request traces (by trace ID, joined against the bundle's own
    ``request`` records) and the ``slo`` event records (by objective
    name). Raises ``OSError``/``ValueError`` on an unreadable
    bundle."""
    jpath = os.path.join(bundle_dir, "metrics.jsonl")
    records = _load_jsonl(jpath)
    frames = sorted((r for r in records if r.get("kind") == "frame"),
                    key=lambda r: (r.get("ts", 0), r.get("seq", 0)))
    slo_events = [r for r in records if r.get("kind") == "slo"]
    requests = {}
    for r in records:
        if r.get("kind") == "request" and r.get("trace_id"):
            requests.setdefault(r["trace_id"], []).append(r)
    incidents = []
    flight_paths = sorted(glob.glob(
        os.path.join(bundle_dir, "flight_*.jsonl")))
    for fpath in flight_paths:
        lines = _load_jsonl(fpath)
        header = next((r for r in lines if r.get("kind") == "dump"),
                      None)
        if header is None or header.get("trigger") != "slo_burn":
            continue
        extra = (header.get("data") or {}).get("extra") or {}
        objective = str(extra.get("objective", ""))
        window_s = float(extra.get("window_s") or 0.0)
        t1 = float(header.get("ts") or 0.0)
        t0 = t1 - window_s
        # frame-interval slack on both edges: the sampler's clock and
        # the dump's wall stamp are not the same instant
        in_window = [r for r in frames
                     if t0 - 1.0 <= float(r.get("ts", 0)) <= t1 + 1.0]
        dump_requests = [r for r in lines
                         if r.get("kind") == "request"]
        dump_tids = [r.get("trace_id") for r in dump_requests
                     if r.get("trace_id")]
        linked = [t for t in dump_tids if t in requests]
        matching_events = [r for r in slo_events
                           if r.get("name") == objective]
        incidents.append({
            "trigger": "slo_burn",
            "dump": os.path.basename(fpath),
            "objective": objective,
            "burn_rate": extra.get("burn_rate"),
            "window": extra.get("window"),
            "window_s": window_s,
            "alert_ts": [round(t0, 3), round(t1, 3)],
            "frames_in_window": len(in_window),
            "frame_diff": _frame_diff(in_window),
            "top_moving": extra.get("top_moving") or [],
            "requests": {"in_dump": len(dump_tids),
                         "linked": len(linked),
                         "trace_ids": sorted(set(linked))[:10]},
            "slo_events": len(matching_events),
        })
    return {
        "ok": True,
        "bundle": bundle_dir,
        "frames": len(frames),
        "slo_events": len(slo_events),
        "request_traces": len(requests),
        "flight_dumps": len(flight_paths),
        "incidents": incidents,
    }


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m replication_of_minute_frequency_factor_tpu_torch"
             ".telemetry.timeline",
        description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("bundle", help="telemetry bundle directory "
                                   "(metrics.jsonl + flight_*.jsonl)")
    ap.add_argument("--out", metavar="FILE", default=None,
                    help="additionally write the report (indented) "
                         "to FILE")
    ap.add_argument("--require-incident", action="store_true",
                    help="exit 1 when no slo_burn incident was found "
                         "(the smoke-harness mode)")
    args = ap.parse_args(argv)
    try:
        report = incident_report(args.bundle)
    except (OSError, ValueError) as e:
        print(json.dumps({"ok": False, "error": str(e)}))
        return 2
    print(json.dumps(report))
    if args.out:
        with open(args.out, "w") as fh:
            json.dump(report, fh, indent=1)
    if args.require_incident and not report["incidents"]:
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
