"""The venue recipe, frozen: a 24/7 venue's 1-minute klines for every
symbol, made from ``--seed``, in the shape of Binance's public spot
klines (github.com/binance/binance-public-data) under its
``exchangeInfo`` filters.

Each symbol has constants drawn once from the seed's symbol stream
(:func:`symbols`): a price level log-uniform over the configuration's
range, its tick ``10^(floor(log10 p) - k)`` with ``k`` drawn per symbol
(the ``PRICE_FILTER.tickSize`` rule) and its quantity step likewise from
the price (``LOT_SIZE.stepSize``), a per-minute volatility, a median
per-minute notional, its share of zero-trade minutes (the least liquid
tenth by notional much larger), and a listing or delisting day inside
the year for a fixed share of symbols. The venue has a fixed number of
maintenance gaps of missing minutes, each on a day of its own.

Day ``d`` of the year is made from ``default_rng([seed, 0xC1, d])`` alone
(:func:`day`), so days are made in any order, in threads, and the check
remakes only its sampled days. A day: each symbol's close is a random
walk from that day's level (the symbol's daily walk), rounded to the
tick; open, high and low lie around it on the tick; volume is the
notional over the price, rounded to the step. A zero-trade minute has
volume 0 and open, high, low and close equal to the previous close. A
minute before a listing, after a delisting or inside a maintenance gap
is masked out, and its bars are 0, as ``data/minute.grid_day`` fills
them. Bars are float32.

Only numpy: nothing of the program is imported here.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from .recipes import seed_key

#: the streams of the seed's generators: the symbols' constants, and each
#: day (``[seed, DAY_STREAM, d]``)
SYMBOL_STREAM = 0xC0
DAY_STREAM = 0xC1


@dataclass
class Symbols:
    """Each symbol's constants for a year of ``n_days`` days. Per-day
    arrays are ``[n_days, n]``."""

    #: the day's opening level, tick and quantity step
    level: np.ndarray
    tick: np.ndarray
    step: np.ndarray
    #: per-minute volatility of log price, median per-minute notional,
    #: share of zero-trade minutes
    vol: np.ndarray
    notional: np.ndarray
    zero_share: np.ndarray
    #: first valid minute of the year (0: listed before it) and the first
    #: minute past the last valid one (``n_days * slots``: never
    #: delisted), counted over the year's minutes
    first: np.ndarray
    end: np.ndarray
    #: ``[gaps, 3]``: day, first minute and minutes of each maintenance gap
    gaps: np.ndarray

    @property
    def n(self) -> int:
        return len(self.vol)


def _log_uniform(rng, lo: float, hi: float, n: int) -> np.ndarray:
    return np.exp(rng.uniform(np.log(lo), np.log(hi), n))


def _pow10_floor(x: np.ndarray) -> np.ndarray:
    return np.floor(np.log10(x))


def symbols(seed: int, n: int, n_days: int, n_slots: int,
            venue: dict) -> Symbols:
    """The constants of ``n`` symbols over a year of ``n_days`` days of
    ``n_slots`` minutes, by the configuration's ``venue`` block."""
    rng = np.random.default_rng([seed_key(seed), SYMBOL_STREAM])
    p0 = _log_uniform(rng, *venue["price"], n)
    k = rng.choice(np.asarray(venue["tick_digits"]), n)
    kq = rng.choice(np.asarray(venue["step_digits"]), n)
    vol = _log_uniform(rng, *venue["minute_vol"], n)
    notional = _log_uniform(rng, *venue["minute_notional"], n)
    zero = rng.uniform(*venue["zero_share"], n)
    illiquid = np.argsort(notional, kind="stable")[
        :int(round(venue["illiquid_share"] * n))]
    zero[illiquid] = rng.uniform(*venue["illiquid_zero_share"],
                                 len(illiquid))
    # the daily walk of the opening level: the day's variance of the
    # minute walk
    daily = rng.standard_normal((n_days, n)) * (vol * np.sqrt(n_slots))
    level = p0 * np.exp(np.concatenate(
        [np.zeros((1, n)), np.cumsum(daily[:-1], axis=0)]))
    tick = 10.0 ** (_pow10_floor(level) - k)
    step = 10.0 ** (-_pow10_floor(level) - kq)
    minutes = n_days * n_slots
    first = np.zeros(n, np.int64)
    end = np.full(n, minutes, np.int64)
    order = rng.permutation(n)
    n_listed = int(round(venue["listed_share"] * n))
    n_delisted = int(round(venue["delisted_share"] * n))
    listed = order[:n_listed]
    delisted = order[n_listed:n_listed + n_delisted]
    first[listed] = rng.integers(1, minutes, n_listed)
    end[delisted] = rng.integers(1, minutes, n_delisted)
    n_gaps = int(venue["gaps"])
    gap_days = np.sort(rng.choice(n_days, n_gaps, replace=False))
    gap_len = rng.integers(venue["gap_minutes"][0],
                           venue["gap_minutes"][1] + 1, n_gaps)
    gap_at = rng.integers(0, n_slots - gap_len + 1)
    return Symbols(level=level, tick=tick, step=step, vol=vol,
                   notional=notional, zero_share=zero, first=first,
                   end=end, gaps=np.stack([gap_days, gap_at, gap_len], 1))


def _on_tick(x: np.ndarray, tick: np.ndarray) -> np.ndarray:
    return np.rint(x / tick) * tick


def day(seed: int, d: int, sym: Symbols, n_slots: int,
        venue: dict, out=None):
    """Day ``d`` of the year: f32 bars ``[n, n_slots, 5]`` and the bool
    mask ``[n, n_slots]`` (written into ``out``, a pair of such arrays,
    when given)."""
    rng = np.random.default_rng([seed_key(seed), DAY_STREAM, int(d)])
    n, s = sym.n, n_slots
    vol = sym.vol[:, None]
    tick = sym.tick[d][:, None]
    step = sym.step[d][:, None]
    level = sym.level[d][:, None]
    z = rng.standard_normal((n, s), dtype=np.float32)
    walk = level * np.exp(np.cumsum(z * vol, axis=1))
    trade = rng.random((n, s), dtype=np.float32) >= sym.zero_share[:, None]
    start = np.maximum(_on_tick(level, tick), tick)
    traded = np.maximum(_on_tick(walk, tick), tick)
    # a zero-trade minute keeps the last traded close
    last = np.maximum.accumulate(
        np.where(trade, np.arange(s), -1), axis=1)
    close = np.where(last >= 0,
                     np.take_along_axis(traded, np.maximum(last, 0), 1),
                     start)
    prev = np.concatenate([start, close[:, :-1]], axis=1)
    wick = venue["wick"] * vol
    open_ = np.maximum(_on_tick(prev * (
        1 + wick * rng.standard_normal((n, s), dtype=np.float32)), tick),
        tick)
    top, bottom = np.maximum(open_, close), np.minimum(open_, close)
    high = np.maximum(_on_tick(top * (1 + wick * np.abs(
        rng.standard_normal((n, s), dtype=np.float32))), tick), top)
    low = np.clip(_on_tick(bottom * (1 - wick * np.abs(
        rng.standard_normal((n, s), dtype=np.float32))), tick), tick,
        bottom)
    notional = sym.notional[:, None] * np.exp(
        venue["notional_sigma"] * rng.standard_normal((n, s),
                                                      dtype=np.float32))
    volume = np.maximum(np.rint(notional / close / step), 1) * step
    minute = d * s + np.arange(s)
    mask = (minute >= sym.first[:, None]) & (minute < sym.end[:, None])
    for gd, at, length in sym.gaps:
        if gd == d:
            mask[:, at:at + length] = False
    bars, m = out if out is not None else (
        np.empty((n, s, 5), np.float32), np.empty((n, s), bool))
    for f, v in enumerate((np.where(trade, open_, prev),
                           np.where(trade, high, prev),
                           np.where(trade, low, prev), close,
                           np.where(trade, volume, 0.0))):
        bars[..., f] = np.where(mask, v, 0.0)
    m[...] = mask
    return bars, m

