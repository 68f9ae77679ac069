"""Stage timing and profiler annotation.

``Timer`` wraps host-side stages (IO, gridding, device step), as the JAX
package's ``utils/tracing.py`` does; ``trace_annotation`` is
``torch.profiler.record_function``, so a tagged region shows up by name in
a ``torch.profiler`` trace when one is being captured.
"""

from __future__ import annotations

import contextlib
import threading
import time
from typing import Dict, List


class Timer:
    """Accumulating named stage timer. Thread-safe: the pipeline's
    producer thread and the consumer's per-day isolation path time the
    same stage names concurrently, and an unlocked read-modify-write
    would drop increments.

    >>> t = Timer()
    >>> with t("io"): ...
    >>> t.totals()["io"]
    """

    def __init__(self):
        self._totals: Dict[str, float] = {}
        self._counts: Dict[str, int] = {}
        self._lock = threading.Lock()

    @contextlib.contextmanager
    def __call__(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self._add(name, time.perf_counter() - t0)

    def _add(self, name: str, dt: float) -> None:
        with self._lock:
            self._totals[name] = self._totals.get(name, 0.0) + dt
            self._counts[name] = self._counts.get(name, 0) + 1

    def totals(self) -> Dict[str, float]:
        with self._lock:
            return dict(self._totals)

    def report(self) -> str:
        with self._lock:
            totals, counts = dict(self._totals), dict(self._counts)
        rows: List[str] = []
        for k in sorted(totals, key=totals.get, reverse=True):
            rows.append(f"{k}: {totals[k]:.3f}s x{counts[k]}")
        return "; ".join(rows) or "no timings"


@contextlib.contextmanager
def trace_annotation(name: str):
    """Named region in a ``torch.profiler`` trace (a no-op outside a
    capture, bar the call)."""
    from torch.profiler import record_function
    with record_function(name):
        yield
