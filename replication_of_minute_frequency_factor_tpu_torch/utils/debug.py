"""Debug-mode input validation: the port's copy of the JAX package's
``utils/debug.py``.

A day array whose valid lanes carry NaN prices, negative volume, or
inverted high/low silently corrupts every downstream factor.
``validate_batch`` is the guard the pipeline runs when
``Config.debug_validate`` is on.
"""

from __future__ import annotations

from typing import List

import numpy as np

from ..data.minute import F_CLOSE, F_HIGH, F_LOW, F_OPEN, F_VOLUME


class DayDataError(ValueError):
    pass


def validate_batch(bars: np.ndarray, mask: np.ndarray,
                   raise_: bool = True) -> List[str]:
    """Check invariants of a ``[..., T, S, 5]`` day batch on valid lanes.

    Returns a list of violation descriptions (empty = clean); raises
    ``DayDataError`` with the full list when ``raise_``.
    """
    bars = np.asarray(bars)
    mask = np.asarray(mask)
    problems: List[str] = []
    v = bars[mask]  # [n_valid, 5]
    if not np.isfinite(v).all():
        n = int((~np.isfinite(v)).any(axis=-1).sum())
        problems.append(f"{n} valid bars carry non-finite fields")
    prices = v[:, [F_OPEN, F_HIGH, F_LOW, F_CLOSE]]
    if (prices <= 0).any():
        n = int((prices <= 0).any(axis=-1).sum())
        problems.append(f"{n} valid bars have non-positive prices")
    if (v[:, F_VOLUME] < 0).any():
        problems.append(
            f"{int((v[:, F_VOLUME] < 0).sum())} valid bars have "
            "negative volume")
    hl = v[:, F_HIGH] < v[:, F_LOW]
    if hl.any():
        problems.append(f"{int(hl.sum())} valid bars have high < low")
    if problems and raise_:
        raise DayDataError("; ".join(problems))
    return problems
