"""Data sources for the factor service: who owns the minute bars.

The port's copy of the JAX package's ``serve/source.py`` (host numpy).
A source holds (or can produce) the dense ``[days, tickers, 240, 5]``
bar tensor + validity mask the serve engine encodes into blocks.
Day-ranges are addressed by integer index into ``days`` — the service's
coalescing key — with the day labels and ticker codes exposed for
responses.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np


class SyntheticSource:
    """Deterministic synthetic year: seeded once, fully materialized in
    host RAM — the test/demo/smoke source, sized by the caller."""

    def __init__(self, n_days: int = 32, n_tickers: int = 256,
                 seed: int = 0, missing_prob: float = 0.02,
                 session=None):
        from ..markets import get_session
        self.session = get_session(session)
        rng = np.random.default_rng(seed)
        shape = (n_days, n_tickers, self.session.n_slots)
        close = 10.0 * np.exp(np.cumsum(
            rng.standard_normal(shape, dtype=np.float32)
            * np.float32(1e-3), axis=-1))
        open_ = close * (1 + rng.standard_normal(shape, dtype=np.float32)
                         * np.float32(1e-4))
        high = np.maximum(open_, close) * 1.0002
        low = np.minimum(open_, close) * 0.9998
        volume = (rng.integers(0, 1000, shape) * 100).astype(np.float32)
        bars = np.stack([open_, high, low, close, volume], axis=-1)
        bars[..., :4] = np.round(bars[..., :4], 2)  # tick-aligned
        self._bars = bars.astype(np.float32)
        self._mask = rng.random(shape, dtype=np.float32) >= missing_prob
        self.codes: Tuple[str, ...] = tuple(
            f"{600000 + i:06d}" for i in range(n_tickers))
        d0 = np.datetime64("2024-01-02")
        self.days: Tuple[str, ...] = tuple(
            str(d0 + np.timedelta64(i, "D")) for i in range(n_days))

    @property
    def n_days(self) -> int:
        return len(self.days)

    @property
    def n_tickers(self) -> int:
        return len(self.codes)

    def slab(self, start: int, end: int):
        """``(bars [D, T, 240, 5], mask [D, T, 240])`` for days
        ``[start, end)`` — views, no copy."""
        return self._bars[start:end], self._mask[start:end]


class MinuteDirSource:
    """A directory of day-file parquets, gridded ONCE at construction
    onto a single union-code ticker axis (``pipeline._grid_batch``) so
    every day-range shares one ``[*, T, 240, *]`` layout — the property
    that lets blocks of equal day extent share one built callable.

    The whole directory's dense tensor lives in host RAM (a trading
    year of 5000 tickers is ~70 GB raw f32 — size the directory, or the
    source, to the host). A production deployment would page day groups
    from disk; this source is the correctness-first resident form.
    """

    #: day files carry cn_ashare wall-clock timestamps; the dir
    #: source grids on the canonical session
    session = None

    def __init__(self, minute_dir: str):
        from ..data import io as dio
        from ..pipeline import _grid_batch
        files = dio.list_day_files(minute_dir)
        if not files:
            raise ValueError(f"no day files under {minute_dir!r}")
        day_data = [(d, dio.read_minute_day_raw(p)) for d, p in files]
        bars, mask, codes, _present = _grid_batch(day_data)
        self._bars = bars.astype(np.float32)
        self._mask = mask
        self.codes = tuple(str(c) for c in codes)
        self.days = tuple(str(d) for d, _ in day_data)

    @property
    def n_days(self) -> int:
        return len(self.days)

    @property
    def n_tickers(self) -> int:
        return len(self.codes)

    def slab(self, start: int, end: int):
        return self._bars[start:end], self._mask[start:end]
