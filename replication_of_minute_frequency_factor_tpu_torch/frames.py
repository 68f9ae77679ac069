"""Host-side frame utilities: long rows <-> dense matrices, forward
returns, calendar periods, segment reductions.

These are the cheap O(rows) alignment steps around the device kernels —
the numpy equivalent of the reference's polars joins/group_bys
(Factor.py:144-171, :293-320). Dense ``[dates, tickers]`` matrices with a
presence mask are the hand-off format to :mod:`.eval_ops`.

The port's copy of the JAX package's ``frames.py``, unchanged: numpy
only, held bitwise to it by tests/test_torch_eval.py.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np


def long_to_matrix(
    code: np.ndarray,
    date: np.ndarray,
    value: np.ndarray,
    codes: Optional[np.ndarray] = None,
    dates: Optional[np.ndarray] = None,
    dtype=np.float32,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """Pivot long rows to ``(mat [D,T], present [D,T], dates [D], codes [T])``.

    Absent cells are NaN with ``present=False``; duplicate (date, code) rows
    keep the last. ``codes``/``dates`` pin the axes for cross-table
    alignment (the join key of reference Factor.py:163-171 becomes shared
    axes). ``dtype`` is f32 for device-bound exposures; host-side eval
    math (group_test's pct/tmc/cmc) passes f64 to match the reference's
    precision.
    """
    if codes is None:
        codes = np.unique(code)
    if dates is None:
        dates = np.unique(date)
    ci = np.searchsorted(codes, code)
    di = np.searchsorted(dates, date)
    ok = (ci < len(codes)) & (di < len(dates))
    ok &= np.take(codes, np.minimum(ci, len(codes) - 1)) == code
    ok &= np.take(dates, np.minimum(di, len(dates) - 1)) == date
    mat = np.full((len(dates), len(codes)), np.nan, dtype)
    present = np.zeros((len(dates), len(codes)), bool)
    mat[di[ok], ci[ok]] = value[ok]
    present[di[ok], ci[ok]] = True
    return mat, present, dates, codes


def forward_returns(code: np.ndarray, date: np.ndarray, pct: np.ndarray,
                    n: int) -> np.ndarray:
    """Future n-day log-compounded return per row, aligned to input order.

    Replicates Factor.py:144-161: within each code's row sequence (its own
    trading days, not a calendar grid),
    ``exp(sum of log1p(pct) over the next n rows) - 1``; NaN when fewer
    than n future rows exist or any of them has missing pct.
    """
    order = np.lexsort((date, code))
    c = np.asarray(code)[order]
    p = np.asarray(pct, np.float64)[order]
    m = len(p)
    if m == 0:
        return np.array([], np.float32)
    grp_start = np.r_[True, c[1:] != c[:-1]]
    ends = np.flatnonzero(np.r_[grp_start[1:], True])  # last idx per group
    gid = np.cumsum(grp_start) - 1
    end_of_group = ends[gid]

    lg = np.log1p(p)
    bad = ~np.isfinite(lg)
    cs = np.r_[0.0, np.cumsum(np.where(bad, 0.0, lg))]
    cb = np.r_[0, np.cumsum(bad)]
    idx = np.arange(m)
    tgt = np.minimum(idx + n, m - 1)
    has = idx + n <= end_of_group
    s = cs[tgt + 1] - cs[idx + 1]           # rows idx+1 .. idx+n
    poisoned = (cb[tgt + 1] - cb[idx + 1]) > 0
    fwd_sorted = np.where(has & ~poisoned, np.expm1(s), np.nan)
    fwd = np.empty(m, np.float32)
    fwd[order] = fwd_sorted.astype(np.float32)
    return fwd


_FREQ_ALIASES = {
    "week": "week", "w": "week", "1w": "week",
    "month": "month", "m": "month", "1mo": "month",
    "quarter": "quarter", "q": "quarter", "1q": "quarter",
    "year": "year", "y": "year", "1y": "year",
}


def period_start(dates: np.ndarray, frequency: str) -> np.ndarray:
    """Calendar period label (period's first day) per date.

    Weeks start Monday, months/quarters/years at their calendar start —
    polars ``group_by_dynamic(every=...)`` window labels
    (Factor.py:248-255, 293-304). Unknown frequencies raise ``ValueError``
    (the reference crashed with ``NameError`` — quirk Q8, fixed here).
    """
    freq = _FREQ_ALIASES.get(str(frequency).lower())
    if freq is None:
        raise ValueError(
            f"frequency must be week/month/quarter/year, got {frequency!r}")
    d = np.asarray(dates, "datetime64[D]")
    if freq == "week":
        e = d.astype(np.int64)
        return (d - (e + 3) % 7).astype("datetime64[D]")
    months = d.astype("datetime64[M]")
    if freq == "month":
        return months.astype("datetime64[D]")
    if freq == "quarter":
        mi = months.astype(np.int64)
        return ((mi // 3) * 3).astype("datetime64[M]").astype("datetime64[D]")
    return d.astype("datetime64[Y]").astype("datetime64[D]")


def group_segments(*keys: np.ndarray):
    """Sort rows by the key tuple and return ``(order, seg_ids, n_segs)``
    where equal-key runs share a segment id (host-side group_by)."""
    order = np.lexsort(tuple(reversed(keys)))
    m = len(order)
    if m == 0:
        return order, np.array([], np.int64), 0
    new = np.zeros(m, bool)
    new[0] = True
    for k in keys:
        ks = np.asarray(k)[order]
        new[1:] |= ks[1:] != ks[:-1]
    seg = np.cumsum(new) - 1
    return order, seg, int(seg[-1]) + 1


def segment_compound(values: np.ndarray, seg: np.ndarray,
                     n_segs: int) -> np.ndarray:
    """Per-segment compounded return ``prod(1 + v) - 1`` (NaN rows treated
    as 0 return, like polars' null-skipping product)."""
    lg = np.log1p(np.where(np.isfinite(values), values, 0.0))
    out = np.zeros(n_segs, np.float64)
    np.add.at(out, seg, lg)
    return np.expm1(out)


def segment_last(values: np.ndarray, seg: np.ndarray,
                 n_segs: int) -> np.ndarray:
    """Last row's value per segment (rows already in segment-sorted order).

    Every segment id produced by :func:`group_segments` is populated, so a
    plain overwrite scatter suffices."""
    values = np.asarray(values)
    out = np.empty(n_segs, values.dtype)
    out[seg] = values  # later rows overwrite earlier ones
    return out


def segment_weighted_mean(values: np.ndarray, weights: np.ndarray,
                          seg: np.ndarray, n_segs: int) -> np.ndarray:
    """Weighted mean per segment, skipping NaN value/weight rows."""
    v = np.asarray(values, np.float64)
    w = np.asarray(weights, np.float64)
    ok = np.isfinite(v) & np.isfinite(w)
    num = np.zeros(n_segs)
    den = np.zeros(n_segs)
    np.add.at(num, seg[ok], (v * w)[ok])
    np.add.at(den, seg[ok], w[ok])
    with np.errstate(invalid="ignore", divide="ignore"):
        return num / den
