"""Wall-clock reconciliation: the sum of a run's timed stages against its
wall time, with the unattributed residual explicit.

The port's copy of ``reconcile``, ``build_report`` and ``write_report``
from the JAX package's ``telemetry/attribution.py`` (pure host
arithmetic). The report carries no ``trace`` block: the profiler trace
capture and its post-processing (``TraceCapture``, the JAX package's
``summarize_trace_dir``) are not ported yet.
"""

from __future__ import annotations

import json
from typing import Dict, Optional

#: attribution report schema (the JAX package's ``REPORT_SCHEMA``)
REPORT_SCHEMA = 1

#: default fraction of wall time allowed to stay unattributed
DEFAULT_TOLERANCE = 0.10
#: unattributed seconds never flagged: micro-runs carry a few ms of
#: interpreter slack between stages that is 50% of a 10 ms wall and 0% of
#: any real one
FLOOR_S = 0.05


def reconcile(wall_s: float, stages: Optional[Dict[str, float]],
              tolerance: float = DEFAULT_TOLERANCE) -> dict:
    """``sum(stages)`` vs ``wall_s`` with an explicit residual.

    Non-seconds entries (``*_ms``, ``*_MB``, booleans, non-numbers) are
    dropped so callers can pass a phases/stages dict verbatim.
    ``unattributed_s`` is the wall time NO stage accounts for
    (``max(0, wall - sum)``); ``overlap_s`` is the surplus when
    concurrent stages sum past the wall (expected in the pipelined
    loops, never flagged). ``ok`` is False when the unattributed
    fraction exceeds ``tolerance`` AND the residual exceeds
    :data:`FLOOR_S`.
    """
    comp = {}
    for k, v in (stages or {}).items():
        if (isinstance(v, (int, float)) and not isinstance(v, bool)
                and not k.endswith("_ms") and not k.endswith("_MB")):
            comp[k] = float(v)
    attributed = sum(comp.values())
    wall = float(wall_s)
    unattributed = max(0.0, wall - attributed)
    overlap = max(0.0, attributed - wall)
    frac = (unattributed / wall) if wall > 0 else 0.0
    ok = frac <= tolerance or unattributed <= FLOOR_S
    block = {
        "wall_s": round(wall, 3),
        "attributed_s": round(attributed, 3),
        "unattributed_s": round(unattributed, 3),
        "overlap_s": round(overlap, 3),
        "unattributed_frac": round(frac, 4),
        "tolerance": tolerance,
        "stages": {k: round(v, 3) for k, v in comp.items()},
        "ok": ok,
    }
    return block


def build_report(stages: Optional[Dict[str, float]],
                 wall_s: Optional[float] = None,
                 reconciliation: Optional[dict] = None,
                 tolerance: float = DEFAULT_TOLERANCE) -> dict:
    """Attribution report: the stage seconds and the reconciliation
    block (computed from ``wall_s`` unless a precomputed one is
    passed)."""
    if reconciliation is None:
        reconciliation = reconcile(wall_s or 0.0, stages, tolerance)
    return {
        "schema": REPORT_SCHEMA,
        "stages_s": {k: round(float(v), 3)
                     for k, v in (stages or {}).items()
                     if isinstance(v, (int, float))},
        "reconciliation": reconciliation,
    }


def write_report(path: str, report: dict) -> str:
    with open(path, "w") as fh:
        json.dump(report, fh, indent=1)
    return path
