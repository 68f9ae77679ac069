"""The plain reference over sampled lanes, and the comparison that decides
a run's ``correct``.

A lane is one (day, ticker): the 58 exposures the program wrote for it.
:func:`reference_lanes` computes them with the f64 kernels of
:mod:`.oracle` from the bars the benchmark itself made; :func:`mismatch`
holds the program's f32 answers to them lane by lane, at the golden-parity
suite's per-factor f32-vs-f64 tolerances (its noisy-scenario floor on
the tick-noise factors), and reports per factor the share
of lanes out of tolerance (NaN status counts: a lane NaN on one side only
is out). The number compared is the worst factor's share.

:func:`bf16` rounds to bfloat16: the control is the reference computed
from bf16 bars with bf16 answers, put in the program's place.
"""

from __future__ import annotations

from typing import Dict, Sequence

import numpy as np

from . import oracle
from .sessions import SessionSpec

#: f32-vs-f64 closeness per factor (tests/test_parity.py's RTOL, ATOL and
#: RTOL_OVERRIDE tables, frozen here): ranks are half-integers, higher
#: moments and correlations cancel in f32, products of ratios carry an
#: absolute error
RTOL_DEFAULT = 2e-3
RTOL = {
    "mmt_ols_qrs": 2e-2, "mmt_ols_corr_square_mean": 5e-3,
    "mmt_ols_corr_mean": 5e-3, "mmt_ols_beta_mean": 5e-3,
    "mmt_ols_beta_zscore_last": 2e-2,
    "shape_skew": 5e-3, "shape_kurt": 5e-3, "shape_skratio": 1e-2,
    "shape_skewVol": 5e-3, "shape_kurtVol": 5e-3, "shape_skratioVol": 1e-2,
    "doc_skew": 1e-2, "doc_kurt": 1e-2, "doc_std": 1e-2,
    "corr_prv": 5e-3, "corr_prvr": 5e-3, "corr_pv": 5e-3,
    "corr_pvd": 5e-3, "corr_pvl": 5e-3, "corr_pvr": 5e-3,
    "liq_amihud_1min": 5e-3,
}
ATOL_DEFAULT = 1e-6
ATOL = {
    "doc_pdf60": 1e-2, "doc_pdf70": 1e-2, "doc_pdf80": 1e-2,
    "doc_pdf90": 1e-2, "doc_pdf95": 1e-2,
    "shape_skratio": 1e-4, "shape_skratioVol": 1e-4,
    "doc_skew": 1e-3, "doc_kurt": 5e-3, "doc_std": 1e-3,
    "mmt_ols_qrs": 1e-4, "mmt_ols_beta_zscore_last": 1e-4,
    "corr_prv": 1e-4, "corr_prvr": 1e-4, "corr_pv": 1e-4,
    "corr_pvd": 1e-4, "corr_pvl": 1e-4, "corr_pvr": 1e-4,
    "trade_top20retRatio": 5e-5, "trade_top50retRatio": 5e-5,
    "mmt_top50VolumeRet": 1e-5, "mmt_bottom50VolumeRet": 1e-5,
    "mmt_top20VolumeRet": 1e-5, "mmt_bottom20VolumeRet": 1e-5,
}

#: factors that are pure tick-rounding noise on rounded prices whose
#: steps are a tick or two (both recipes' prices: ~10 CNY in 0.01 steps):
#: a one-ulp f32 price, as the program's ingest wire decodes it, moves
#: them by percents, so they are held to an absolute 5e-3 as the parity
#: suite holds them on its noise-dominated scenarios (NOISE_FACTORS,
#: NOISE_ATOL); they are dimensionless O(0.1-1) when meaningful
NOISE_FACTORS = frozenset({
    "vol_upRatio", "vol_downRatio", "shape_skew", "shape_kurt",
    "shape_skratio", "shape_skratioVol",
})
NOISE_ATOL = 5e-3

FACTOR_NAMES = tuple(oracle.ORACLE_FACTORS)


def atol(name: str) -> float:
    a = ATOL.get(name, ATOL_DEFAULT)
    return max(a, NOISE_ATOL) if name in NOISE_FACTORS else a


def reference_lanes(code, time, open_, high, low, close, volume,
                    want_codes, session: SessionSpec,
                    names: Sequence[str] = FACTOR_NAMES) -> np.ndarray:
    """``[len(want_codes), F]`` f64 exposures of one trading day.

    The day is given as all its long-format rows sorted by (code, time),
    every code of the day included, since the ``doc_pdf*`` ranks run over
    the whole day; only the groups of ``want_codes`` are computed. A code
    with no rows gets NaN throughout."""
    code = np.asarray(code)
    close = np.asarray(close, np.float64)
    starts = np.flatnonzero(np.r_[True, code[1:] != code[:-1]])
    ends = np.r_[starts[1:], len(code)]
    group_end = np.repeat(close[ends - 1], ends - starts)
    ranks = oracle.day_ranks(close, group_end)
    where = {code[s]: (s, e) for s, e in zip(starts, ends)}
    out = np.full((len(want_codes), len(names)), np.nan)
    for i, c in enumerate(want_codes):
        if c not in where:
            continue
        s, e = where[c]
        vals = oracle.group_factors(
            time[s:e], open_[s:e], high[s:e], low[s:e], close[s:e],
            volume[s:e], ranks[s:e], session, names)
        out[i] = [vals[n] for n in names]
    return out


def grid_rows(bars: np.ndarray, mask: np.ndarray, session: SessionSpec):
    """One day's dense ``[T, S, 5]`` bars and ``[T, S]`` mask as
    long-format rows sorted by (ticker index, time)."""
    t_idx, s_idx = np.nonzero(mask)
    b = bars[t_idx, s_idx].astype(np.float64)
    return (t_idx, session.grid_times[s_idx], b[:, 0], b[:, 1], b[:, 2],
            b[:, 3], b[:, 4])


def mismatch(got: np.ndarray, want: np.ndarray,
             names: Sequence[str] = FACTOR_NAMES) -> Dict[str, float]:
    """Per factor, the percent of lanes where ``got`` [N, F] is out of
    the f32 tolerance of ``want`` [N, F], or NaN on one side only."""
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    if got.shape != want.shape:
        raise ValueError(f"got {got.shape}, want {want.shape}")
    out = {}
    for j, n in enumerate(names):
        g, w = got[:, j], want[:, j]
        nan_g, nan_w = np.isnan(g), np.isnan(w)
        with np.errstate(invalid="ignore", over="ignore"):
            close = np.isclose(g, w, rtol=RTOL.get(n, RTOL_DEFAULT),
                               atol=atol(n))
        bad = (nan_g != nan_w) | (~nan_g & ~nan_w & ~close)
        out[n] = 100.0 * float(bad.mean()) if len(bad) else 0.0
    return out


def bf16(x: np.ndarray) -> np.ndarray:
    """``x`` rounded to bfloat16 (round to nearest even; NaN and inf
    kept), returned as f64."""
    f = np.asarray(x, np.float32)
    u = f.view(np.uint32).astype(np.uint64)
    r = ((u + 0x7FFF + ((u >> 16) & 1)) >> 16 << 16).astype(np.uint32)
    out = r.view(np.float32).astype(np.float64)
    return np.where(np.isfinite(f), out, f.astype(np.float64))


def control_lanes(code, time, open_, high, low, close, volume, want_codes,
                  session: SessionSpec,
                  names: Sequence[str] = FACTOR_NAMES) -> np.ndarray:
    """The control: :func:`reference_lanes` over bars held in bfloat16,
    its answers rounded to bfloat16."""
    return bf16(reference_lanes(code, time, bf16(open_), bf16(high),
                                bf16(low), bf16(close), bf16(volume),
                                want_codes, session, names))
