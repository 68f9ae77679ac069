"""The traced window: ``torch.profiler`` over a fixed amount of the
cell's work, reduced to what the per-layer readers and the result's
``breakdown`` need.

The window is the host span of a ``record_function`` named
:data:`WINDOW` around the work (which ends in a device synchronise), so
the device's events and the window share the trace's clock. Device time
is the union of kernel, copy and fill events inside the window (the
arithmetic of ``chip_smoke.busy_share``); an idle gap is named by the
host operation that overlaps it most.
"""

from __future__ import annotations

import json
import os
import tempfile
from dataclasses import dataclass
from typing import Callable, List, Sequence, Tuple

#: the host span that marks the traced window
WINDOW = "perfbench.window"
#: trace categories of work on the device
DEVICE_CATS = frozenset({"kernel", "gpu_memcpy", "gpu_memset"})
#: trace categories of host work an idle gap is named by
HOST_CATS = frozenset({"cpu_op", "user_annotation"})
#: entries of each breakdown list
TOP = 10


def union(spans: Sequence[Tuple[float, float]], lo: float, hi: float
          ) -> List[Tuple[float, float]]:
    """The merged intervals of ``spans`` clipped to ``[lo, hi]``."""
    out: List[List[float]] = []
    for s, e in sorted((max(s, lo), min(e, hi)) for s, e in spans):
        if e <= s:
            continue
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]


def gaps(busy: Sequence[Tuple[float, float]], lo: float, hi: float
         ) -> List[Tuple[float, float]]:
    """The intervals of ``[lo, hi]`` that ``busy`` (merged) leaves free."""
    out, cur = [], lo
    for s, e in busy:
        if s > cur:
            out.append((cur, s))
        cur = max(cur, e)
    if hi > cur:
        out.append((cur, hi))
    return out


@dataclass
class TraceSummary:
    """A traced window: ``lo``/``hi`` in trace microseconds, device events
    as ``(name, cat, ts, dur)``, host events as ``(name, ts, dur)``."""

    lo: float
    hi: float
    device: List[Tuple[str, str, float, float]]
    host: List[Tuple[str, float, float]]

    def _busy(self):
        return union([(ts, ts + d) for _, _, ts, d in self.device],
                     self.lo, self.hi)

    @property
    def window_s(self) -> float:
        return (self.hi - self.lo) * 1e-6

    @property
    def busy_s(self) -> float:
        return sum(e - s for s, e in self._busy()) * 1e-6

    @property
    def kernels(self) -> List[Tuple[str, float]]:
        """``(name, microseconds)`` of each kernel inside the window."""
        return [(n, d) for n, c, ts, d in self.device
                if c == "kernel" and ts >= self.lo and ts + d <= self.hi]

    def host_at(self, s: float, e: float) -> str:
        """The host operation that overlaps ``[s, e]`` most (the shorter
        on a tie)."""
        best, key = "no host operation recorded", (0.0, 0.0)
        for n, ts, d in self.host:
            ov = min(e, ts + d) - max(s, ts)
            if ov > 0 and (ov, -d) > key:
                best, key = n, (ov, -d)
        return best

    def breakdown(self) -> dict:
        """The device operations that took most time and the longest idle
        gaps by what the host was doing, :data:`TOP` of each, in
        seconds."""
        by_op: dict = {}
        for n, c, ts, d in self.device:
            if ts >= self.lo and ts + d <= self.hi:
                by_op[n] = by_op.get(n, 0.0) + d * 1e-6
        ops = sorted(by_op.items(), key=lambda kv: -kv[1])[:TOP]
        free = sorted(gaps(self._busy(), self.lo, self.hi),
                      key=lambda g: g[0] - g[1])[:TOP]
        return {"device_ops": [[n, s] for n, s in ops],
                "idle_gaps": [[self.host_at(s, e), (e - s) * 1e-6]
                              for s, e in free]}


def summarize(events: Sequence[dict]) -> TraceSummary:
    """A Chrome trace's events reduced to a :class:`TraceSummary`."""
    lo = hi = None
    device, host = [], []
    for ev in events:
        if ev.get("ph") != "X":
            continue
        cat, name = ev.get("cat"), ev.get("name", "")
        ts, dur = float(ev["ts"]), float(ev.get("dur", 0.0))
        if cat == "user_annotation" and name == WINDOW:
            lo, hi = ts, ts + dur
        elif cat in DEVICE_CATS:
            device.append((name, cat, ts, dur))
        elif cat in HOST_CATS:
            host.append((name, ts, dur))
    if lo is None:
        raise RuntimeError(f"the trace holds no {WINDOW!r} span")
    return TraceSummary(lo=lo, hi=hi, device=device, host=host)


def _activities(device: str):
    from torch.profiler import ProfilerActivity

    acts = [ProfilerActivity.CPU]
    if device.startswith("cuda"):
        acts.append(ProfilerActivity.CUDA)
    return acts


def warm_profiler(device: str) -> None:
    """Start and stop the profiler once, so that its first use (CUPTI's
    start-up) falls in set-up and not in the traced window."""
    import torch
    from torch.profiler import profile

    with profile(activities=_activities(device)):
        torch.ones(1, device=device).add_(1)
        if device.startswith("cuda"):
            torch.cuda.synchronize()


def traced(fn: Callable[[], object], device: str) -> TraceSummary:
    """Run ``fn`` inside the profiler and the :data:`WINDOW` span; the
    trace passes through a temporary file under ``TMPDIR``."""
    import torch
    from torch.profiler import profile, record_function

    with profile(activities=_activities(device)) as prof:
        with record_function(WINDOW):
            fn()
            if device.startswith("cuda"):
                torch.cuda.synchronize()
    fd, path = tempfile.mkstemp(prefix="perfbench_trace_", suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    finally:
        os.unlink(path)
    return summarize(events)
