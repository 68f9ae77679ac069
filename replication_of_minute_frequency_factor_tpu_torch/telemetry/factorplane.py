"""Factor-health plane: per-factor data-quality telemetry.

The port of the JAX package's ``telemetry/factorplane.py``:

* :func:`factor_stats_block` — the device half: an ``[F, ...] ->
  [F, 9]`` masked moment sketch (lane/finite/NaN/+-inf counts, mean,
  std, min, max over the finite lanes), computed on the block's device
  as a side output of a dispatch that already produced the block, so it
  rides the block's fetch; :func:`factor_stats_host` is its numpy twin
  (copied), the parity oracle. Counts, min and max are exact on both;
  the port's mean and std are f64 sums rounded once to f32, the JAX
  package's and the twin's f32 sums whose order differs between
  devices and frameworks.

* :class:`FactorPlane` — the host half (copied), lazily bound as
  ``Telemetry.factorplane``: publishes ``factor.coverage_frac{factor=}``
  / ``factor.moment_z{factor=,stat=}`` / ``factor.widen_rate{factor=}``
  / ``factor.ready_frac{factor=}`` gauges, detects drift against a
  banked per-factor baseline (coverage drop + moment z-score,
  N-consecutive-sample bursts) and force-dumps the
  :class:`.opsplane.FlightRecorder` (trigger ``factor_drift_burst``),
  tracks the result wire's per-factor widen rate, and rolls the
  realized-IC numbers the serve layer's IC graph produces. Baseline
  updates require a justification
  (``update_baseline(justification=...)``). A stats block that arrives
  as a tensor is fetched here (``.cpu()``), after the dispatch that made
  it was already fetched.
"""

from __future__ import annotations

import threading
from collections import deque
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

#: column order of the [F, N_STATS] sketch (device and host halves share
#: it)
STAT_FIELDS = ("lanes", "finite", "nan", "posinf", "neginf",
               "mean", "std", "min", "max")
N_STATS = len(STAT_FIELDS)

#: |moment z-score| past which one sample counts toward a drift burst
Z_THRESHOLD = 6.0

#: absolute coverage-fraction drop vs the baseline that counts toward
#: a drift burst (a factor that covered 95% of lanes suddenly covering
#: 60% is a data problem regardless of its moments)
COVERAGE_DROP = 0.25

#: std blow-up/collapse factor vs the baseline that counts (order-of-
#: magnitude scale drift the mean z-score can miss on symmetric noise)
STD_RATIO = 8.0

#: consecutive drifting samples (per factor) that trip a flight dump —
#: the mesh plane's skew-burst shape, per factor
DRIFT_BURST = 3

#: rolling realized-IC window per (factor, horizon)
IC_WINDOW = 32


def factor_stats_block(x: torch.Tensor,
                       xs_axis_name=None) -> torch.Tensor:
    """``[F, ...]`` f32 -> ``[F, 9]`` f32 on ``x``'s device. Counts are
    exact (integer-valued f32); mean/std are two-pass over the finite
    lanes; min/max/moments are NaN when a factor has no finite lane.

    The moment sums accumulate in f64 and round to f32 once, so the
    order they are taken in (the device's reduction, the mesh's ranks)
    moves the f32 mean and std by about an ulp of their value, even
    where the terms cancel.

    ``xs_axis_name`` (on one rank of a mesh, inside ``with mesh:``):
    ``x`` is this rank's lanes and the sketch is the GLOBAL one over the
    axis's ranks, the same on each: counts, min and max all-reduced
    exactly, the f64 sums in the transport's order."""
    f = x.shape[0]
    flat = x.reshape(f, -1)
    lanes = flat.shape[1]
    finite = torch.isfinite(flat)
    n_fin = finite.sum(dim=1, dtype=torch.int32)
    n_nan = torch.isnan(flat).sum(dim=1, dtype=torch.int32)
    n_pos = (flat == float("inf")).sum(dim=1, dtype=torch.int32)
    n_neg = (flat == float("-inf")).sum(dim=1, dtype=torch.int32)
    wide = flat.to(torch.float64)
    zsum = torch.where(finite, wide, 0.0).sum(dim=1)
    n_lanes = torch.full((f,), float(lanes), dtype=torch.float64,
                         device=x.device)
    if xs_axis_name is not None:
        from ..parallel.collectives import xs_reduce_local
        # the counts ride the f64 sum, exactly
        red = xs_reduce_local(torch.stack(
            [n_lanes, n_fin.to(torch.float64), n_nan.to(torch.float64),
             n_pos.to(torch.float64), n_neg.to(torch.float64), zsum]),
            "sum", xs_axis_name)
        n_lanes, zsum = red[0], red[5]
        n_fin, n_nan, n_pos, n_neg = (red[i].to(torch.int32)
                                      for i in range(1, 5))
    denom = torch.clamp(n_fin.to(torch.float64), min=1.0)
    mean = zsum / denom
    var = torch.where(finite, (wide - mean[:, None]) ** 2,
                      0.0).sum(dim=1)
    big = float(np.finfo(np.float32).max)
    if lanes:
        mn = torch.where(finite, flat, big).amin(dim=1)
        mx = torch.where(finite, flat, -big).amax(dim=1)
    else:  # a rank whose lanes are all past the logical universe
        mn = torch.full((f,), big, device=x.device)
        mx = torch.full((f,), -big, device=x.device)
    if xs_axis_name is not None:
        var = xs_reduce_local(var, "sum", xs_axis_name)
        ext = xs_reduce_local(torch.stack([mn, -mx]), "min", xs_axis_name)
        mn, mx = ext[0], -ext[1]
    std = torch.sqrt(torch.clamp(var / denom, min=0.0)).to(torch.float32)
    mean = mean.to(torch.float32)
    has = n_fin > 0
    nan = float("nan")
    mean = torch.where(has, mean, nan)
    std = torch.where(has, std, nan)
    mn = torch.where(has, mn, nan)
    mx = torch.where(has, mx, nan)
    return torch.stack(
        [n_lanes.to(torch.float32), n_fin.to(torch.float32),
         n_nan.to(torch.float32), n_pos.to(torch.float32),
         n_neg.to(torch.float32), mean, std, mn, mx], dim=1)


def factor_stats_host(x: np.ndarray) -> np.ndarray:
    """Host-numpy twin of :func:`factor_stats_block`: the same [F, 9]
    layout; counts/min/max match exactly, the f32 moment sums by
    reduction order only."""
    x = np.asarray(x, np.float32)
    f = x.shape[0]
    flat = x.reshape(f, -1)
    lanes = flat.shape[1]
    finite = np.isfinite(flat)
    n_fin = finite.sum(axis=1)
    out = np.empty((f, N_STATS), np.float32)
    out[:, 0] = lanes
    out[:, 1] = n_fin
    out[:, 2] = np.isnan(flat).sum(axis=1)
    out[:, 3] = (flat == np.inf).sum(axis=1)
    out[:, 4] = (flat == -np.inf).sum(axis=1)
    z = np.where(finite, flat, np.float32(0.0))
    denom = np.maximum(n_fin, 1).astype(np.float32)
    mean = z.sum(axis=1, dtype=np.float32) / denom
    var = np.where(finite,
                   (flat - mean[:, None]) ** 2,
                   np.float32(0.0)).sum(axis=1, dtype=np.float32) / denom
    has = n_fin > 0
    big = np.float32(np.finfo(np.float32).max)
    mn = np.where(finite, flat, big).min(axis=1)
    mx = np.where(finite, flat, -big).max(axis=1)
    out[:, 5] = np.where(has, mean, np.nan)
    out[:, 6] = np.where(has, np.sqrt(np.maximum(var, 0.0)), np.nan)
    out[:, 7] = np.where(has, mn, np.nan)
    out[:, 8] = np.where(has, mx, np.nan)
    return out


def _row_dict(row: np.ndarray) -> dict:
    d = {k: float(row[i]) for i, k in enumerate(STAT_FIELDS)}
    d["coverage_frac"] = (d["finite"] / d["lanes"]) if d["lanes"] else 0.0
    return d


class FactorPlane:
    """Per-factor data-quality sampler bound to one Telemetry (see the
    module docstring). All entry points are never-raising and cheap
    enough for dispatch boundaries; ``summary()`` is the
    ``factor_health`` block bench records embed."""

    def __init__(self, telemetry=None, flight=None,
                 z_threshold: float = Z_THRESHOLD,
                 coverage_drop: float = COVERAGE_DROP,
                 std_ratio: float = STD_RATIO,
                 burst: int = DRIFT_BURST,
                 dump_dir: Optional[str] = None,
                 ic_window: int = IC_WINDOW):
        self._telemetry = telemetry
        self._flight = flight
        self.z_threshold = float(z_threshold)
        self.coverage_drop = float(coverage_drop)
        self.std_ratio = float(std_ratio)
        self.burst = int(burst)
        self.dump_dir = dump_dir
        self.ic_window = int(ic_window)
        self._lock = threading.Lock()
        self._samples = 0
        self._baseline: Dict[str, dict] = {}
        self._last: Dict[str, dict] = {}
        self._consecutive: Dict[str, int] = {}
        self._drift_bursts = 0
        self._last_burst: Optional[dict] = None
        self._widen: Dict[str, List[int]] = {}  # factor -> [widened, slices]
        self._stream: Optional[dict] = None
        self._ic: Dict[tuple, deque] = {}

    def _tel(self):
        if self._telemetry is not None:
            return self._telemetry
        from . import get_telemetry
        return get_telemetry()

    def configure(self, dump_dir: Optional[str] = None,
                  flight=None,
                  z_threshold: Optional[float] = None,
                  coverage_drop: Optional[float] = None,
                  burst: Optional[int] = None) -> "FactorPlane":
        """Late-bind the dump directory / shared flight recorder /
        trigger knobs (the serve layer wires its own FlightRecorder and
        ``ServeConfig.flight_dir`` in after the plane exists)."""
        if dump_dir is not None:
            self.dump_dir = dump_dir
            if self._flight is not None:
                self._flight.dump_dir = dump_dir
        if flight is not None:
            self._flight = flight
        if z_threshold is not None:
            self.z_threshold = float(z_threshold)
        if coverage_drop is not None:
            self.coverage_drop = float(coverage_drop)
        if burst is not None:
            self.burst = int(burst)
        return self

    @property
    def flight(self):
        """The flight recorder drift bursts dump through (lazily built
        on this plane's telemetry + dump_dir; inject a shared one —
        e.g. FactorServer's — via :meth:`configure`)."""
        if self._flight is None:
            with self._lock:
                if self._flight is None:
                    from .opsplane import FlightRecorder
                    self._flight = FlightRecorder(
                        telemetry=self._telemetry,
                        dump_dir=self.dump_dir)
        return self._flight

    # --- fused-stats observation -----------------------------------------
    def observe_block(self, names: Sequence[str], stats,
                      boundary: str = "manual") -> dict:
        """One fused-stats sample: ``stats`` is the ``[F, 9]`` sketch
        (host numpy, or a tensor whose producing dispatch the caller
        already fetched — its copy to the host here waits on nothing
        new). Publishes the per-factor gauges, advances the
        per-factor drift-burst triggers against the banked baselines
        (the first sample per factor BECOMES its baseline), and
        returns the sample's summary. Never raises."""
        try:
            if isinstance(stats, torch.Tensor):
                stats = stats.detach().cpu().numpy()
            stats = np.asarray(stats, np.float32)
            names = tuple(str(n) for n in names)
            if stats.ndim != 2 or stats.shape != (len(names), N_STATS):
                raise ValueError(f"stats shape {stats.shape} != "
                                 f"({len(names)}, {N_STATS})")
        except Exception:  # noqa: BLE001 — observation must not kill work
            self._tel().counter("factor.sample_failures",
                                boundary=boundary)
            return {}
        tel = self._tel()
        bursts = []
        worst = None
        drifting = []
        with self._lock:
            self._samples += 1
        for i, n in enumerate(names):
            row = _row_dict(stats[i])
            cov = row["coverage_frac"]
            tel.gauge("factor.coverage_frac", round(cov, 6), factor=n)
            if row["nan"]:
                tel.gauge("factor.nan_lanes", row["nan"], factor=n)
            if row["posinf"] or row["neginf"]:
                tel.gauge("factor.inf_lanes",
                          row["posinf"] + row["neginf"], factor=n)
            if worst is None or cov < worst[1]:
                worst = (n, cov)
            with self._lock:
                base = self._baseline.get(n)
                if base is None:
                    # the first sample banks the factor's baseline
                    self._baseline[n] = {
                        "coverage_frac": cov, "mean": row["mean"],
                        "std": row["std"]}
                    self._consecutive[n] = 0
                    self._last[n] = row
                    tel.gauge("factor.moment_z", 0.0, factor=n,
                              stat="mean")
                    continue
                self._last[n] = row
            reasons = self._drift_reasons(row, base, tel, n)
            with self._lock:
                if reasons:
                    drifting.append(n)
                    self._consecutive[n] = self._consecutive.get(n, 0) + 1
                    tripped = self._consecutive[n] >= self.burst
                    if tripped:
                        self._consecutive[n] = 0
                        self._drift_bursts += 1
                        burst = {"factor": n, "reasons": reasons,
                                 "boundary": boundary,
                                 "stats": {k: round(v, 6)
                                           for k, v in row.items()
                                           if np.isfinite(v)},
                                 "baseline": {
                                     k: (round(v, 6)
                                         if v == v else None)
                                     for k, v in base.items()}}
                        self._last_burst = burst
                        bursts.append(burst)
                else:
                    self._consecutive[n] = 0
        tel.counter("factor.samples", boundary=boundary)
        tel.gauge("factor.drifting", len(drifting))
        dump_paths = []
        for burst in bursts:
            tel.counter("factor.drift_bursts", factor=burst["factor"])
            # the dump names the factor and the offending stats: triage
            # starts from the header, not from replaying the stream
            path = self.flight.dump("factor_drift_burst", force=True,
                                    extra=burst)
            if path:
                dump_paths.append(path)
        return {"boundary": boundary, "factors": len(names),
                "worst_coverage": ({"factor": worst[0],
                                    "coverage_frac": round(worst[1], 6)}
                                   if worst else None),
                "drifting": drifting, "bursts": len(bursts),
                "burst_dumps": dump_paths}

    def _drift_reasons(self, row: dict, base: dict, tel,
                       name: str) -> List[str]:
        """Which drift signals this sample trips for one factor (also
        publishes the z gauges)."""
        reasons = []
        cov, b_cov = row["coverage_frac"], base["coverage_frac"]
        if b_cov - cov > self.coverage_drop:
            reasons.append(f"coverage_frac {cov:.3f} < baseline "
                           f"{b_cov:.3f} - {self.coverage_drop}")
        b_mean, b_std = base["mean"], base["std"]
        z = None
        if np.isfinite(row["mean"]) and np.isfinite(b_mean):
            scale = max(abs(b_std) if np.isfinite(b_std) else 0.0,
                        1e-3 * abs(b_mean), 1e-9)
            z = (row["mean"] - b_mean) / scale
            tel.gauge("factor.moment_z", round(float(z), 4),
                      factor=name, stat="mean")
            if abs(z) > self.z_threshold:
                reasons.append(f"mean z={z:.1f} past "
                               f"{self.z_threshold}")
        elif np.isfinite(b_mean):
            # a factor that HAD finite lanes and now has none is the
            # all-NaN kernel failure this plane exists to catch
            reasons.append("moments vanished (no finite lane)")
        if np.isfinite(row["std"]) and np.isfinite(b_std) and b_std > 0:
            r = row["std"] / b_std
            if r > self.std_ratio or r < 1.0 / self.std_ratio:
                reasons.append(f"std ratio {r:.2f} outside "
                               f"[1/{self.std_ratio}, {self.std_ratio}]")
        return reasons

    # --- baselines --------------------------------------------------------
    def bank_baseline(self, names: Optional[Sequence[str]] = None
                      ) -> Dict[str, dict]:
        """The banked per-factor baselines (read-only copy)."""
        with self._lock:
            if names is None:
                return {k: dict(v) for k, v in self._baseline.items()}
            return {n: dict(self._baseline[n]) for n in names
                    if n in self._baseline}

    def update_baseline(self, names: Optional[Sequence[str]] = None,
                        justification: Optional[str] = None) -> int:
        """Re-bank baselines from the LAST observed sample. Overwriting
        an existing baseline requires a non-empty ``justification``
        (an update-baseline contract: an intentional
        distribution shift is declared, never silent); the
        justification lands in a ``factor.baseline_update`` event.
        Returns how many baselines moved."""
        with self._lock:
            targets = tuple(names) if names is not None \
                else tuple(self._last)
            overwriting = [n for n in targets if n in self._baseline]
        if overwriting and not (isinstance(justification, str)
                                and justification.strip()):
            raise ValueError(
                "update_baseline would overwrite banked baselines for "
                f"{overwriting[:5]}{'...' if len(overwriting) > 5 else ''}"
                "; pass justification= (non-empty) to declare the "
                "distribution shift — baselines never move silently")
        moved = 0
        with self._lock:
            for n in targets:
                row = self._last.get(n)
                if row is None:
                    continue
                self._baseline[n] = {
                    "coverage_frac": row["coverage_frac"],
                    "mean": row["mean"], "std": row["std"]}
                self._consecutive[n] = 0
                moved += 1
        self._tel().event("factor.baseline_update", factors=moved,
                          justification=justification or "")
        return moved

    # --- result-wire widen health ----------------------------------------
    def observe_widen(self, names: Sequence[str], widened_by_factor,
                      slices_per_factor: int,
                      boundary: str = "result_wire") -> None:
        """Fold one decoded payload's per-factor widen counts into the
        cumulative widen rates (``widened_by_factor``: per-factor
        widened-slice counts aligned with ``names``, or a
        ``{factor: count}`` dict; ``slices_per_factor``: slices each
        factor contributed — days per block). Publishes
        ``factor.widen_rate{factor=}``; the overall rate is the
        ``widen_rate`` field regress gates."""
        try:
            names = tuple(str(n) for n in names)
            if isinstance(widened_by_factor, dict):
                counts = [int(widened_by_factor.get(n, 0))
                          for n in names]
            else:
                counts = [int(c) for c in widened_by_factor]
            if len(counts) != len(names) or int(slices_per_factor) <= 0:
                raise ValueError("shape mismatch")
        except Exception:  # noqa: BLE001 — observation must not kill work
            self._tel().counter("factor.sample_failures",
                                boundary=boundary)
            return
        tel = self._tel()
        with self._lock:
            for n, c in zip(names, counts):
                w = self._widen.setdefault(n, [0, 0])
                w[0] += c
                w[1] += int(slices_per_factor)
            rates = {n: (w[0] / w[1] if w[1] else 0.0)
                     for n, w in self._widen.items() if n in names}
        for n, r in rates.items():
            tel.gauge("factor.widen_rate", round(r, 6), factor=n)

    # --- streaming readiness ----------------------------------------------
    def observe_stream(self, names: Sequence[str], stats=None,
                       ready_frac=None, minute: Optional[int] = None,
                       boundary: str = "stream.snapshot") -> dict:
        """One streaming snapshot's health: the fused stats sample (if
        given) plus the readiness plane's per-factor ready fraction and
        the snapshot's minute cursor — ``stream.readiness_lag`` is the
        not-yet-ready mass (1 - mean ready fraction), the data-level
        lag signal a machine-level queue gauge cannot see."""
        out = {}
        if stats is not None:
            out = self.observe_block(names, stats, boundary=boundary)
        if ready_frac is None:
            return out
        try:
            names = tuple(str(n) for n in names)
            if isinstance(ready_frac, torch.Tensor):
                ready_frac = ready_frac.detach().cpu().numpy()
            rf = np.asarray(ready_frac, np.float32).reshape(-1)
            if rf.shape[0] != len(names):
                raise ValueError("ready_frac length mismatch")
        except Exception:  # noqa: BLE001 — observation must not kill work
            self._tel().counter("factor.sample_failures",
                                boundary=boundary)
            return out
        tel = self._tel()
        for n, r in zip(names, rf):
            tel.gauge("factor.ready_frac", round(float(r), 6), factor=n)
        lag = float(1.0 - rf.mean()) if rf.size else 0.0
        tel.gauge("stream.readiness_lag", round(lag, 6))
        least = int(np.argmin(rf)) if rf.size else None
        with self._lock:
            self._stream = {
                "minute": int(minute) if minute is not None else None,
                "readiness_lag": round(lag, 6),
                "least_ready": ({"factor": names[least],
                                 "ready_frac": round(float(rf[least]), 6)}
                                if least is not None else None),
            }
        out["stream"] = dict(self._stream)
        return out

    # --- realized IC health -----------------------------------------------
    def note_ic(self, factor: str, mean_ic, horizon: int = 1) -> None:
        """Fold one realized mean-IC observation (the serve layer's
        IC graph computes it whenever horizon data is
        available — this plane only rolls the numbers it already
        produced). Publishes ``factor.realized_ic`` (last) and
        ``factor.realized_ic_rolling`` (window mean)."""
        if mean_ic is None or not isinstance(mean_ic, (int, float)) \
                or isinstance(mean_ic, bool) or mean_ic != mean_ic:
            return
        key = (str(factor), int(horizon))
        with self._lock:
            dq = self._ic.get(key)
            if dq is None:
                dq = self._ic[key] = deque(maxlen=self.ic_window)
            dq.append(float(mean_ic))
            rolling = sum(dq) / len(dq)
        tel = self._tel()
        tel.gauge("factor.realized_ic", round(float(mean_ic), 6),
                  factor=str(factor), horizon=str(horizon))
        tel.gauge("factor.realized_ic_rolling", round(rolling, 6),
                  factor=str(factor), horizon=str(horizon))

    # --- report -----------------------------------------------------------
    def summary(self) -> dict:
        """The ``factor_health`` block for bench records / healthz:
        ``available`` is True only when fused stats were actually
        sampled — widen/IC numbers alone never masquerade as coverage
        evidence (the same explicit-marker contract as
        ``hbm.available``). ``coverage_frac`` is the WORST (minimum)
        per-factor coverage of the last samples and ``widen_rate`` the
        cumulative widened/slices ratio — the two fields regress
        derives gateable sub-series from."""
        with self._lock:
            worst = None
            for n, row in self._last.items():
                c = row["coverage_frac"]
                if worst is None or c < worst[1]:
                    worst = (n, c)
            w_tot = [sum(w[0] for w in self._widen.values()),
                     sum(w[1] for w in self._widen.values())]
            w_worst = None
            for n, w in self._widen.items():
                r = w[0] / w[1] if w[1] else 0.0
                if w_worst is None or r > w_worst[1]:
                    w_worst = (n, r)
            ic = {f"{n}@{h}": {"rolling_ic": round(sum(dq) / len(dq), 6),
                               "n": len(dq)}
                  for (n, h), dq in self._ic.items() if dq}
            return {
                "available": self._samples > 0,
                "factors": len(self._last),
                "samples": self._samples,
                "coverage_frac": (round(worst[1], 6)
                                  if worst is not None else None),
                "worst_coverage": ({"factor": worst[0],
                                    "coverage_frac": round(worst[1], 6)}
                                   if worst is not None else None),
                "widen_rate": (round(w_tot[0] / w_tot[1], 6)
                               if w_tot[1] else None),
                "widen": {"slices": w_tot[1], "widened": w_tot[0],
                          "worst": ({"factor": w_worst[0],
                                     "rate": round(w_worst[1], 6)}
                                    if w_worst is not None else None)},
                "drift": {"bursts": self._drift_bursts,
                          "last": self._last_burst,
                          "baselines": len(self._baseline)},
                "stream": dict(self._stream) if self._stream else None,
                "ic": ic or None,
            }
