"""Scalar statistics with polars default semantics, float64.

Matches the conventions in SURVEY.md §2.5 Q11: std/var ddof=1 (None when
n <= ddof), biased Fisher-Pearson skew g1, biased Fisher excess kurtosis,
Pearson correlation over pairwise-complete observations. ``None``/NaN
handling: these helpers receive plain ndarrays the caller has already
null-filtered; a float NaN inside propagates, as in polars.
"""

from __future__ import annotations

import numpy as np


def std1(v: np.ndarray) -> float:
    v = np.asarray(v, dtype=np.float64)
    if v.size < 2:
        return np.nan
    return float(v.std(ddof=1))


def skew_g1(v: np.ndarray) -> float:
    v = np.asarray(v, dtype=np.float64)
    if v.size == 0:
        return np.nan
    m = v.mean()
    m2 = ((v - m) ** 2).mean()
    m3 = ((v - m) ** 3).mean()
    with np.errstate(divide="ignore", invalid="ignore"):
        return float(m3 / m2 ** 1.5)


def kurt_excess(v: np.ndarray) -> float:
    v = np.asarray(v, dtype=np.float64)
    if v.size == 0:
        return np.nan
    m = v.mean()
    m2 = ((v - m) ** 2).mean()
    m4 = ((v - m) ** 4).mean()
    with np.errstate(divide="ignore", invalid="ignore"):
        return float(m4 / (m2 * m2) - 3.0)


def pearson(a: np.ndarray, b: np.ndarray) -> float:
    """Pearson r over pairwise-complete (both non-NaN) observations.

    Series are anchored to their first observation before the moment pass
    (shift-invariant): a constant series then has *exactly* zero variance
    and yields NaN, instead of letting f64 summation noise pose as signal.
    The JAX backend anchors identically (ops/masked.py). Under the
    alternative ``pins.READINGS['constant_window'] == 'noise'`` reading
    the anchor is skipped (see pins.py)."""
    from .. import pins

    a = np.asarray(a, dtype=np.float64)
    b = np.asarray(b, dtype=np.float64)
    ok = ~(np.isnan(a) | np.isnan(b))
    a, b = a[ok], b[ok]
    if a.size < 2:
        return np.nan
    if pins.reading("constant_window") == "degenerate":
        a, b = a - a[0], b - b[0]
    da, db = a - a.mean(), b - b.mean()
    with np.errstate(divide="ignore", invalid="ignore"):
        return float((da * db).sum() / np.sqrt((da * da).sum() * (db * db).sum()))


def rank_average(v: np.ndarray) -> np.ndarray:
    """1-based average-tie ranks (polars ``rank(method='average')``)."""
    v = np.asarray(v, dtype=np.float64)
    order = np.argsort(v, kind="stable")
    sv = v[order]
    n = v.size
    ranks_sorted = np.empty(n, dtype=np.float64)
    i = 0
    while i < n:
        j = i
        while j + 1 < n and sv[j + 1] == sv[i]:
            j += 1
        ranks_sorted[i:j + 1] = (i + j) / 2.0 + 1.0
        i = j + 1
    out = np.empty(n, dtype=np.float64)
    out[order] = ranks_sorted
    return out


def pct_change(v: np.ndarray) -> np.ndarray:
    """polars ``pct_change()``: v[i]/v[i-1] - 1, NaN (null) at index 0."""
    v = np.asarray(v, dtype=np.float64)
    out = np.full(v.shape, np.nan)
    if v.size > 1:
        with np.errstate(divide="ignore", invalid="ignore"):
            out[1:] = v[1:] / v[:-1] - 1.0
    return out
