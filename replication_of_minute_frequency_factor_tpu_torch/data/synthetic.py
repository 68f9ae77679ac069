"""Synthetic A-share minute-bar generator for tests and benchmarks.

The port's copy of the JAX package's ``data/synthetic.py``: the same
seed gives bitwise the same rows (tests/test_torch_data.py). Produces
long-format day data with the pathologies the parity suite must
cover (SURVEY.md §4): missing bars / halts, zero-volume bars, constant
prices, short (<50 bar) days, and duplicate close values (exercising the
chip-factor tie handling).
"""

from __future__ import annotations

from typing import Dict

import numpy as np

from ..markets import get_session


def synth_day(
    rng: np.random.Generator,
    n_codes: int = 8,
    missing_prob: float = 0.0,
    zero_volume_prob: float = 0.0,
    constant_price_codes: int = 0,
    short_day_codes: int = 0,
    tick_decimals: int = 2,
    date: str = "2024-01-02",
    session=None,
) -> Dict[str, np.ndarray]:
    """Return long-format columns sorted by (code, time).

    * ``constant_price_codes`` leading codes trade flat all day (var=0 paths);
    * ``short_day_codes`` trailing codes only trade the last 30 slots
      (<50 bars: the rolling-window drop rule);
    * prices are rounded to ``tick_decimals`` so duplicate values occur.
    """
    sess = get_session(session)
    rows_code, rows_time = [], []
    rows = {k: [] for k in ("open", "high", "low", "close", "volume")}
    for i in range(n_codes):
        code = f"{600000 + i:06d}"
        slots = np.arange(sess.n_slots)
        if i >= n_codes - short_day_codes:
            slots = slots[-30:]
        if missing_prob > 0:
            keep = rng.random(len(slots)) >= missing_prob
            slots = slots[keep]
        if len(slots) == 0:
            continue
        n = len(slots)
        base = rng.uniform(5.0, 50.0)
        if i < constant_price_codes:
            close = np.full(n, round(base, tick_decimals))
            open_ = close.copy()
            high = close.copy()
            low = close.copy()
        else:
            steps = rng.normal(0, 0.001, n)
            mid = base * np.exp(np.cumsum(steps))
            open_ = np.round(mid * (1 + rng.normal(0, 3e-4, n)), tick_decimals)
            close = np.round(mid * (1 + rng.normal(0, 3e-4, n)), tick_decimals)
            hi = np.maximum(open_, close) * (1 + np.abs(rng.normal(0, 3e-4, n)))
            lo = np.minimum(open_, close) * (1 - np.abs(rng.normal(0, 3e-4, n)))
            high = np.round(hi, tick_decimals)
            low = np.round(lo, tick_decimals)
            open_ = np.maximum(open_, 0.01)
            close = np.maximum(close, 0.01)
            low = np.maximum(low, 0.01)
            high = np.maximum(high, low)
        volume = rng.integers(0 if zero_volume_prob > 0 else 100, 100_000,
                              n).astype(np.float64)
        if zero_volume_prob > 0:
            volume[rng.random(n) < zero_volume_prob] = 0.0
        rows_code.append(np.full(n, code))
        rows_time.append(sess.grid_times[slots])
        rows["open"].append(open_)
        rows["high"].append(high)
        rows["low"].append(low)
        rows["close"].append(close)
        rows["volume"].append(volume)

    out = {
        "code": np.concatenate(rows_code),
        "time": np.concatenate(rows_time).astype(np.int64),
        "date": np.full(sum(map(len, rows_code)), np.datetime64(date, "D")),
    }
    for k, v in rows.items():
        out[k] = np.concatenate(v).astype(np.float64)
    return out
