"""The benchmark's data recipes, frozen: every input a run feeds the
program, made from ``--seed``.

- :func:`make_batch` is ``bench.make_batch``'s recipe (a close random
  walk in f32 draws, open/high/low around it, tick-aligned prices,
  board-lot volume, 2% missing bars), as ``tests/torch_cases.make_batch``
  holds it for the port; :func:`year_batch` makes batch ``i`` of a
  run's year from ``default_rng([seed, i])``, as ``tests/torch_cases.Year``
  does.
- :func:`synth_day` is the port's ``data/synthetic.synth_day`` (missing
  bars, zero-volume bars, constant-price and short-day codes, tick
  rounding) and :func:`write_day_file` writes one day of it as an
  int-coded minute-bar parquet, as ``chip_smoke.write_day_file`` does.

The benchmark's tests hold each recipe byte for byte against the
original; the copies here are what a run uses, so no change to the
program or its tests can change the data.
"""

from __future__ import annotations

from pathlib import Path
from typing import Dict

import numpy as np

from .reference.sessions import SessionSpec


def seed_key(seed: int) -> int:
    """``--seed`` as a non-negative key of ``default_rng``."""
    return int(seed) % 2**64


def make_batch(rng, n_days: int, n_tickers: int, n_slots: int):
    """f32 bars ``[D, T, S, 5]`` and the bool mask ``[D, T, S]``."""
    shape = (n_days, n_tickers, n_slots)
    close = (10.0 * np.exp(np.cumsum(
        rng.standard_normal(shape, dtype=np.float32) * np.float32(1e-3),
        axis=-1)))
    open_ = close * (1 + rng.standard_normal(shape, dtype=np.float32)
                     * np.float32(1e-4))
    high = np.maximum(open_, close) * 1.0002
    low = np.minimum(open_, close) * 0.9998
    volume = (rng.integers(0, 1000, shape) * 100).astype(np.float32)
    bars = np.stack([open_, high, low, close, volume], axis=-1)
    bars[..., :4] = np.round(bars[..., :4], 2)
    mask = rng.random(shape, dtype=np.float32) > 0.02
    return bars.astype(np.float32), mask


def year_batch(seed: int, i: int, n_days: int, n_tickers: int,
               n_slots: int):
    """Batch ``i`` of the year of ``seed``."""
    return make_batch(np.random.default_rng([seed_key(seed), i]), n_days,
                      n_tickers, n_slots)


def synth_day(rng: np.random.Generator, session: SessionSpec,
              n_codes: int = 8, missing_prob: float = 0.0,
              zero_volume_prob: float = 0.0, constant_price_codes: int = 0,
              short_day_codes: int = 0, tick_decimals: int = 2,
              date: str = "2024-01-02") -> Dict[str, np.ndarray]:
    """Long-format columns of one day sorted by (code, time):
    ``constant_price_codes`` leading codes trade flat all day,
    ``short_day_codes`` trailing codes trade only the last 30 slots,
    prices are rounded to ``tick_decimals`` so duplicate values occur."""
    rows_code, rows_time = [], []
    rows = {k: [] for k in ("open", "high", "low", "close", "volume")}
    for i in range(n_codes):
        code = f"{600000 + i:06d}"
        slots = np.arange(session.n_slots)
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
        rows_time.append(session.grid_times[slots])
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


def trading_dates(n: int, start: str = "2024-01-02"):
    """``n`` weekdays from ``start``."""
    days = np.arange(np.datetime64(start), np.datetime64(start) + 3 * n)
    weekday = (days.astype("datetime64[D]").view("int64") - 4) % 7
    return [str(d) for d in days[weekday < 5][:n]]


def day_rng(seed: int, i: int) -> np.random.Generator:
    """The generator of day file ``i`` of ``seed``."""
    return np.random.default_rng([seed_key(seed), i])


def write_day_file(path: Path, date: str, seed: int, i: int,
                   session: dict, synth: dict) -> None:
    """Day ``i`` of ``seed`` as one int-coded minute-bar parquet."""
    import pyarrow as pa
    import pyarrow.parquet as pq

    from .reference.sessions import from_config

    d = synth_day(day_rng(seed, i), from_config(session), date=date,
                  **synth)
    cols = {"code": pa.array(d["code"].astype(np.int64))}
    for k in ("time", "open", "high", "low", "close", "volume"):
        cols[k] = pa.array(d[k])
    pq.write_table(pa.table(cols), path)
