"""What the drivers share: the sample of lanes a run checks and the check
itself."""

from __future__ import annotations

import os
from typing import Dict

import numpy as np

from perfbench.recipes import seed_key
from perfbench.reference import compare

#: the number every cell compares, and the stream of the seed its sample
#: of lanes is drawn from
CHECK = "worst_factor_mismatch_pct"
SAMPLE_STREAM = 0x5EED


def pool_size(tasks: int) -> int:
    """Workers for ``tasks`` independent jobs: one a core, at most one a
    job."""
    return max(1, min(tasks, os.cpu_count() or 1))


def sample(seed: int, n: int, k: int, salt: int) -> np.ndarray:
    """``min(k, n)`` sorted distinct indices below ``n``, from the seed."""
    rng = np.random.default_rng([seed_key(seed), SAMPLE_STREAM, salt])
    return np.sort(rng.choice(n, size=min(k, n), replace=False))


def in_reference_order(got: Dict[str, np.ndarray], n: int) -> np.ndarray:
    """``[n, F]`` of the program's per-factor answers in the reference's
    factor order; a factor the program did not give is NaN throughout."""
    out = np.full((n, len(compare.FACTOR_NAMES)), np.nan)
    for j, name in enumerate(compare.FACTOR_NAMES):
        if name in got:
            out[:, j] = got[name]
    return out


def hold(got: np.ndarray, want: np.ndarray, limit: float, log) -> dict:
    """The check of ``got`` against ``want`` (both ``[N, F]``)."""
    shares = compare.mismatch(got, want)
    worst = sorted(shares.items(), key=lambda kv: -kv[1])[:5]
    log(f"{len(got)} lanes held to the reference; worst factors: "
        + ", ".join(f"{n} {v:.4f}%" for n, v in worst))
    return {CHECK: {"value": worst[0][1], "limit": float(limit)}}
