"""Mesh observability plane: per-shard balance telemetry.

The port of the JAX package's ``telemetry/meshplane.py``.
:class:`MeshPlane` publishes:

* ``mesh.shard_time_s{shard=}`` gauges and ``mesh.shard_skew_ratio`` —
  per-shard completion watermarks from :meth:`MeshPlane.record_shard_times`
  (or :meth:`MeshPlane.measure_ready` on one tensor), with the
  skew-burst flight dump (trigger ``shard_skew_burst``) through the
  :class:`.opsplane.FlightRecorder`;
* ``mesh.pad_waste_frac{axis=}`` — the masked filler share of a padded
  axis;
* ``mesh.occupancy_frac{boundary=}`` gauge + histogram — useful-lane
  fraction of a dispatch (streaming scans: present bars / lanes;
  streaming cohort scatters: real rows / cohort size; serve
  micro-batches: drained requests / max_batch);
* on a ``(days, tickers)`` mesh of ranks (``parallel.mesh.Mesh``):
  per-rank completion watermarks gathered over the ranks
  (:meth:`MeshPlane.measure_ready_mesh`, or :meth:`watch_async_mesh`
  whose gather runs at :meth:`drain`), ``mesh.shard_time_s{axis=,
  shard=}``/``mesh.shard_skew_ratio{axis=}`` per axis
  (:meth:`record_axis_times`), and ``mesh.collective_dispatches{label=}``
  (:meth:`note_collective`).
"""

from __future__ import annotations

import threading
import time
from typing import Dict, List, Optional

#: shard skew (max/median completion watermark) past which a sample
#: counts toward a skew burst
SKEW_THRESHOLD = 2.0

#: consecutive over-threshold samples that trip a skew-burst dump
SKEW_BURST = 3

#: bounded wait for outstanding watcher threads at drain time
DRAIN_TIMEOUT_S = 30.0

def _median(vals: List[float]) -> float:
    s = sorted(vals)
    n = len(s)
    return s[n // 2] if n % 2 else 0.5 * (s[n // 2 - 1] + s[n // 2])


#: the lock contract the runtime lock-assertion twin (telemetry/lockcheck.py)
#: checks: every watermark/summary field
#: is fed by watcher daemon threads and read by bench/summary callers.
GLC_CONTRACT = {
    "MeshPlane": {
        "lock": "_lock",
        "guards": ("_flight", "_threads", "_consecutive", "_samples",
                   "_skew_bursts", "_boundaries", "_last_times",
                   "_last_skew", "_slow_shard", "_pad_waste",
                   "_pad_waste_axes", "_axes", "_occupancy",
                   "_collectives", "_pending_mesh"),
        "init": (),
        "locked": (),
    },
}


class MeshPlane:
    """Per-shard balance sampler bound to one Telemetry (see module
    docstring). The one-device entry points are never-raising and cheap
    enough for dispatch boundaries; ``summary()`` is the ``mesh``
    block."""

    def __init__(self, telemetry=None, flight=None,
                 skew_threshold: float = SKEW_THRESHOLD,
                 burst: int = SKEW_BURST,
                 dump_dir: Optional[str] = None):
        self._telemetry = telemetry
        self._flight = flight
        self.skew_threshold = float(skew_threshold)
        self.burst = int(burst)
        self.dump_dir = dump_dir
        self._lock = threading.Lock()
        self._threads: List[threading.Thread] = []
        self._consecutive = 0
        self._samples = 0
        self._skew_bursts = 0
        self._boundaries: Dict[str, int] = {}
        self._last_times: Dict[str, float] = {}
        self._last_skew: Optional[float] = None
        self._slow_shard: Optional[str] = None
        self._pad_waste: Optional[float] = None
        self._pad_waste_axes: Dict[str, float] = {}
        self._axes: Dict[str, dict] = {}
        self._occupancy: Optional[float] = None
        self._collectives = 0
        #: watch_async_mesh samples waiting for drain()'s gather
        self._pending_mesh: List[list] = []
        from .lockcheck import maybe_install
        maybe_install(self)

    def _tel(self):
        if self._telemetry is not None:
            return self._telemetry
        from . import get_telemetry
        return get_telemetry()

    def configure(self, dump_dir: Optional[str] = None,
                  skew_threshold: Optional[float] = None,
                  burst: Optional[int] = None) -> "MeshPlane":
        """Late-bind the dump directory / trigger knobs."""
        if dump_dir is not None:
            self.dump_dir = dump_dir
            if self._flight is not None:
                self._flight.dump_dir = dump_dir
        if skew_threshold is not None:
            self.skew_threshold = float(skew_threshold)
        if burst is not None:
            self.burst = int(burst)
        return self

    @property
    def flight(self):
        """The flight recorder skew bursts dump through (lazily built
        on this plane's telemetry + dump_dir; inject a shared one —
        e.g. FactorServer's — via the constructor)."""
        if self._flight is None:
            with self._lock:
                if self._flight is None:
                    from .opsplane import FlightRecorder
                    self._flight = FlightRecorder(
                        telemetry=self._telemetry,
                        dump_dir=self.dump_dir)
        return self._flight

    # --- shard watermarks ------------------------------------------------
    def record_shard_times(self, times: Dict, boundary: str = "manual",
                           ) -> dict:
        """One shard-balance sample from explicit per-shard seconds
        (``{shard_key: seconds}``) — the injection point tests use;
        ``measure_ready``/``watch_async`` feed it from live tensors. Publishes the
        per-shard gauges + skew ratio, advances the skew-burst
        trigger, and returns the sample's summary."""
        try:
            clean = {str(k): max(0.0, float(v))
                     for k, v in dict(times).items()}
        except (TypeError, ValueError):
            return {}
        if not clean:
            return {}
        tel = self._tel()
        for k, v in sorted(clean.items()):
            tel.gauge("mesh.shard_time_s", round(v, 6), shard=k)
        med = _median(list(clean.values()))
        worst = max(clean, key=clean.get)
        skew = (clean[worst] / med) if med > 0 else 1.0
        tel.gauge("mesh.shard_skew_ratio", round(skew, 4))
        tel.counter("mesh.samples", boundary=boundary)
        burst_path = None
        with self._lock:
            self._samples += 1
            self._boundaries[boundary] = \
                self._boundaries.get(boundary, 0) + 1
            self._last_times = clean
            self._last_skew = skew
            self._slow_shard = worst
            if skew > self.skew_threshold:
                self._consecutive += 1
                tripped = self._consecutive >= self.burst
                if tripped:
                    self._consecutive = 0
                    self._skew_bursts += 1
            else:
                self._consecutive = 0
                tripped = False
        if tripped:
            tel.counter("mesh.skew_bursts", boundary=boundary)
            # the dump names the straggler: triage starts from the
            # header, not from replaying the metrics stream
            burst_path = self.flight.dump(
                "shard_skew_burst", force=True,
                extra={"slow_shard": worst,
                       "skew_ratio": round(skew, 4),
                       "boundary": boundary,
                       "shard_times_s": {k: round(v, 6)
                                         for k, v in clean.items()}})
        return {"boundary": boundary, "n_shards": len(clean),
                "skew_ratio": round(skew, 4), "slow_shard": worst,
                "burst_dump": burst_path}

    def measure_ready(self, out, boundary: str = "manual",
                      t0: Optional[float] = None) -> dict:
        """The completion watermark of one tensor: wait for its device's
        queued work and record ``now - t0`` (``t0`` = the dispatch's
        start on the ``perf_counter`` clock) as a one-shard sample.
        Never raises."""
        if t0 is None:
            t0 = time.perf_counter()
        try:
            import torch
            dev = out.device
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
            key = str(dev) if dev.index is not None or dev.type != "cuda" \
                else f"cuda:{torch.cuda.current_device()}"
            times = {key: time.perf_counter() - t0}
        except Exception:  # noqa: BLE001 — observation must not kill work
            self._tel().counter("mesh.sample_failures", boundary=boundary)
            return {}
        return self.record_shard_times(times, boundary=boundary)

    def record_axis_times(self, axis: str, times: Dict) -> dict:
        """One per-AXIS balance sample: ``times`` maps an axis
        coordinate (day-shard row / ticker-shard column) to its
        completion watermark. Publishes ``mesh.shard_time_s{axis=,
        shard=}`` gauges and ``mesh.shard_skew_ratio{axis=}`` (whether
        the day split balances, apart from the ticker split). Does not
        advance the skew-burst trigger (the flat per-rank sample owns
        that); returns the axis summary."""
        try:
            clean = {str(k): max(0.0, float(v))
                     for k, v in dict(times).items()}
        except (TypeError, ValueError):
            return {}
        if not clean:
            return {}
        tel = self._tel()
        for k, v in sorted(clean.items()):
            tel.gauge("mesh.shard_time_s", round(v, 6), shard=k,
                      axis=axis)
        med = _median(list(clean.values()))
        worst = max(clean, key=clean.get)
        skew = (clean[worst] / med) if med > 0 else 1.0
        tel.gauge("mesh.shard_skew_ratio", round(skew, 4), axis=axis)
        summary = {"shard_time_s": {k: round(v, 6)
                                    for k, v in clean.items()},
                   "skew_ratio": round(skew, 4), "slow_shard": worst}
        with self._lock:
            self._axes[axis] = summary
        return summary

    @staticmethod
    def _ready_time(out, t0: float) -> float:
        """Seconds from ``t0`` until the work queued before now on
        ``out``'s device is done (an event waited on: no stream or
        device synchronize)."""
        import torch
        if getattr(out, "is_cuda", False):
            ev = torch.cuda.Event()
            ev.record(torch.cuda.current_stream(out.device))
            ev.synchronize()
        return time.perf_counter() - t0

    def _record_mesh(self, mesh, local: float, boundary: str) -> dict:
        """Gather every rank's watermark (a collective: every rank of
        the mesh calls it) and publish the flat per-rank sample and the
        per-axis aggregations: a day-shard row's watermark is the max
        over its ticker shards (the row is done when its straggler is),
        and vice versa."""
        import torch.distributed as dist
        if mesh.size > 1 and dist.is_initialized():
            box = [None] * dist.get_world_size()
            dist.all_gather_object(box, (mesh.rank, str(mesh.device),
                                         float(local)))
        else:
            box = [(mesh.rank, str(mesh.device), float(local))]
        t = mesh.shape["tickers"]
        times: Dict[str, float] = {}
        rows: Dict[str, float] = {}
        cols: Dict[str, float] = {}
        for r, dev, v in box:
            times[f"rank{r}:{dev}"] = v
            i, j = divmod(int(r), t)
            rows[f"day{i}"] = max(rows.get(f"day{i}", 0.0), v)
            cols[f"ticker{j}"] = max(cols.get(f"ticker{j}", 0.0), v)
        flat = self.record_shard_times(times, boundary=boundary)
        axes = {"days": self.record_axis_times("days", rows),
                "tickers": self.record_axis_times("tickers", cols)}
        return {**flat, "axes": axes}

    def measure_ready_mesh(self, out, mesh, boundary: str = "manual",
                           t0: Optional[float] = None) -> dict:
        """:meth:`measure_ready` for a ``(days, tickers)`` mesh of ranks:
        each rank waits for its own device's work on ``out`` (this
        rank's block), the watermarks are gathered over the ranks, and
        the flat per-rank sample (burst trigger included) and the
        per-axis views are published. A collective: every rank calls
        it. Never raises on a failed wait (the sample is dropped)."""
        if t0 is None:
            t0 = time.perf_counter()
        try:
            local = self._ready_time(out, t0)
        except Exception:  # noqa: BLE001 — observation must not kill work
            self._tel().counter("mesh.sample_failures", boundary=boundary)
            local = -1.0
        return self._record_mesh(mesh, local, boundary)

    def watch_async_mesh(self, out, mesh, boundary: str = "manual",
                         t0: Optional[float] = None) -> None:
        """:meth:`measure_ready_mesh` without blocking the caller: a
        daemon thread waits out this rank's device work, and the gather
        over the ranks runs at :meth:`drain` (on the caller's thread, so
        every rank's collectives stay in one order)."""
        if t0 is None:
            t0 = time.perf_counter()
        slot = [mesh, boundary, None]
        import torch
        ev = None
        if getattr(out, "is_cuda", False):
            # recorded here, on the caller's stream; the thread only
            # waits on it
            ev = torch.cuda.Event()
            ev.record(torch.cuda.current_stream(out.device))

        def wait():
            try:
                if ev is not None:
                    ev.synchronize()
                slot[2] = time.perf_counter() - t0
            except Exception:  # noqa: BLE001 — observation only
                slot[2] = -1.0

        th = threading.Thread(target=wait, daemon=True,
                              name="meshplane-watch-mesh")
        with self._lock:
            self._threads = [t for t in self._threads if t.is_alive()]
            self._threads.append(th)
            self._pending_mesh.append(slot)
        th.start()

    def watch_async(self, out, boundary: str = "manual",
                    t0: Optional[float] = None) -> None:
        """``measure_ready`` on a daemon thread: the hot loop keeps
        dispatching (its measured host-blocking syncs and the
        double-buffered overlap are untouched) while the watcher
        passively waits out each shard's readiness. ``drain()`` joins
        outstanding watchers before reading ``summary()``."""
        if t0 is None:
            t0 = time.perf_counter()
        th = threading.Thread(target=self.measure_ready,
                              args=(out, boundary, t0), daemon=True,
                              name="meshplane-watch")
        with self._lock:
            self._threads = [t for t in self._threads if t.is_alive()]
            self._threads.append(th)
        th.start()

    def drain(self, timeout: float = DRAIN_TIMEOUT_S) -> None:
        """Join outstanding watchers (bounded), then publish the pending
        :meth:`watch_async_mesh` samples (a collective per sample, in
        the order they were taken: every rank of their mesh drains)."""
        deadline = time.monotonic() + timeout
        with self._lock:
            threads = list(self._threads)
            self._threads = []
            pending = list(self._pending_mesh)
            self._pending_mesh = []
        for th in threads:
            th.join(max(0.0, deadline - time.monotonic()))
        for mesh, boundary, local in pending:
            self._record_mesh(mesh, -1.0 if local is None else local,
                              boundary)

    # --- padding / occupancy ---------------------------------------------
    def record_pad_waste(self, n_valid: int, n_padded: int,
                         axis: str = "tickers") -> Optional[float]:
        """The padded-lane waste fraction of an axis (the ticker
        bucket padding): ``1 - n_valid/n_padded``. Returns the fraction (None
        on degenerate input)."""
        try:
            n_valid, n_padded = int(n_valid), int(n_padded)
        except (TypeError, ValueError):
            return None
        if n_padded <= 0 or n_valid < 0 or n_valid > n_padded:
            return None
        frac = 1.0 - n_valid / n_padded
        self._tel().gauge("mesh.pad_waste_frac", round(frac, 6),
                          axis=axis)
        with self._lock:
            self._pad_waste = frac
            self._pad_waste_axes[str(axis)] = frac
        return frac

    def record_occupancy(self, frac, boundary: str = "manual") -> None:
        """Useful-lane fraction of one dispatch (cohort scatter rows
        present / cohort size; serve micro-batch fill)."""
        try:
            frac = min(1.0, max(0.0, float(frac)))
        except (TypeError, ValueError):
            return
        tel = self._tel()
        tel.gauge("mesh.occupancy_frac", round(frac, 6),
                  boundary=boundary)
        tel.observe("mesh.occupancy_frac", frac, boundary=boundary)
        with self._lock:
            self._occupancy = frac

    def note_collective(self, label: str) -> None:
        """Count one host-side collective dispatch (the span around it
        carries ``kind=host_dispatch``; on-device collective time comes
        from the trace attribution)."""
        self._tel().counter("mesh.collective_dispatches",
                            label=str(label))
        with self._lock:
            self._collectives += 1

    # --- report -----------------------------------------------------------
    def summary(self) -> dict:
        """The ``mesh`` block: ``available`` is True
        only when real shard watermarks were sampled — occupancy/pad
        numbers alone never masquerade as shard-balance evidence (the
        same explicit-marker contract as ``hbm.available``)."""
        with self._lock:
            return {
                "available": self._samples > 0,
                "n_shards": len(self._last_times),
                "samples": self._samples,
                "boundaries": dict(self._boundaries),
                "shard_time_s": {k: round(v, 6)
                                 for k, v in self._last_times.items()},
                "shard_skew_ratio": (round(self._last_skew, 4)
                                     if self._last_skew is not None
                                     else None),
                "slow_shard": self._slow_shard,
                "skew_bursts": self._skew_bursts,
                "pad_waste_frac": (round(self._pad_waste, 6)
                                   if self._pad_waste is not None
                                   else None),
                # per-axis views: pad waste keyed by the padded axis;
                # ``axes`` carries the last per-axis watermarks/skew
                # (mesh samples only)
                "pad_waste_frac_by_axis": {
                    k: round(v, 6)
                    for k, v in self._pad_waste_axes.items()},
                "axes": {k: dict(v) for k, v in self._axes.items()},
                "occupancy_frac": (round(self._occupancy, 6)
                                   if self._occupancy is not None
                                   else None),
                "collective_dispatches": self._collectives,
            }
