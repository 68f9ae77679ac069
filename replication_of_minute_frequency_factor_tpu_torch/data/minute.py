"""Minute-bar gridding: long rows -> dense ``[tickers, S, fields]`` array.

The port's copy of the JAX package's ``data/minute.py`` numpy path (the
C++ one-pass packer is not ported yet). One trading day of long-format
rows ``(code, time, open, high, low, close, volume)`` becomes a dense
f32 day array over the session's minute grid plus a validity mask —
missing bars become cleared mask lanes instead of absent rows. Output is
bitwise the JAX package's ``grid_day(..., use_native=False)``
(tests/test_torch_data.py).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import numpy as np

from ..markets import get_session

FIELDS = ("open", "high", "low", "close", "volume")
F_OPEN, F_HIGH, F_LOW, F_CLOSE, F_VOLUME = range(5)


@dataclasses.dataclass
class DayGrid:
    """One trading day, densely gridded.

    bars:  f32[T, S, 5]  (open, high, low, close, volume); 0 where invalid
    mask:  bool[T, S]    bar present at (ticker, slot)
    codes: [T] ticker identifiers, sorted ascending
    date:  the trading date (numpy datetime64[D] scalar or None)
    """

    bars: np.ndarray
    mask: np.ndarray
    codes: np.ndarray
    date: Optional[np.datetime64] = None

    @property
    def n_tickers(self) -> int:
        return self.bars.shape[0]


def grid_day(
    code: np.ndarray,
    time: np.ndarray,
    open_: np.ndarray,
    high: np.ndarray,
    low: np.ndarray,
    close: np.ndarray,
    volume: np.ndarray,
    date: Optional[np.datetime64] = None,
    codes: Optional[Sequence] = None,
    dtype=np.float32,
    session=None,
) -> DayGrid:
    """Scatter long-format rows of one day onto the dense minute grid.

    * off-grid timestamps (outside every session segment, or not a whole
      minute) are dropped;
    * duplicate (code, slot) rows keep the last occurrence;
    * ``codes`` pins the ticker axis (for cross-day batching); defaults to
      the sorted unique codes present;
    * ``session`` picks the market grid (None = the 240-slot cn_ashare
      day).
    """
    sess = get_session(session)
    code = np.asarray(code)

    if codes is None:
        codes = np.unique(code)
    else:
        # the ticker axis is always sorted ascending (np.searchsorted below
        # requires it; callers must read the axis order back off .codes)
        codes = np.sort(np.asarray(codes))
    tidx = np.searchsorted(codes, code)
    known = (tidx < len(codes)) & (np.take(codes, np.minimum(tidx, len(codes) - 1)) == code)

    T = len(codes)
    slots = sess.time_to_slot(np.asarray(time))
    ok = (slots >= 0) & known
    bars = np.zeros((T, sess.n_slots, len(FIELDS)), dtype=dtype)
    mask = np.zeros((T, sess.n_slots), dtype=bool)
    ti, si = tidx[ok], slots[ok]
    for f, col in zip(range(5), (open_, high, low, close, volume)):
        bars[ti, si, f] = np.asarray(col)[ok]
    mask[ti, si] = True
    return DayGrid(bars=bars, mask=mask, codes=codes, date=date)
