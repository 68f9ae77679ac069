"""The harnesses' seeded cases: seed N here is the case the JAX package's
harness of the same name draws for seed N (``tools/fuzz/``), the rng
draws taken in the same order, so a seed found on either side replays on
the other. Each ``*_case(seed)`` draws the whole case up front; the
harness modules run the port and its reference on it.

Only ``numpy`` loads with this module; ``pandas`` loads inside the cases
that build frames.
"""

from __future__ import annotations

import numpy as np

from ..data.synthetic import synth_day

# ---------------------------------------------------------------------------
# parity
# ---------------------------------------------------------------------------

#: the historical day shape of parity seeds below 10k (the suite's
#: boundary-regression seeds replay it)
HISTORICAL_KW = dict(n_codes=10, missing_prob=0.12, zero_volume_prob=0.12,
                     constant_price_codes=2, short_day_codes=3)
#: the parity suite's kitchen-sink day (tests/test_parity.py)
KITCHEN_SINK_KW = dict(n_codes=10, missing_prob=0.1, zero_volume_prob=0.1,
                       constant_price_codes=1, short_day_codes=2)
#: seeds the parity suite pins: fuzz finds on precision boundaries at the
#: historical shape, fuzz finds of the wide tiers, the kitchen sink's
BOUNDARY_SEEDS = (116, 120, 206, 217, 218, 330, 739, 781, 850, 982, 6223,
                  7024, 7164)
WIDE_SEEDS = (30044, 30202, 30658, 31069, 32461, 32796, 32811)
KITCHEN_SINK_SEEDS = (0, 5, 10, 11)
PINNED_SEEDS = BOUNDARY_SEEDS + WIDE_SEEDS + KITCHEN_SINK_SEEDS
#: the first seed of each wide tier: the wide day shapes; the batched
#: multiday branch; the 40-120 code universes
WIDE_FROM, MULTIDAY_FROM, BIG_FROM = 10_000, 31_000, 32_000


def wide_scenario_kw(rng, big=False):
    """Day-shape keywords of a wide-tier seed (the parity suite's
    ``wide_scenario_kw``; ``big`` draws 40-120 code universes)."""
    n_codes = int(rng.integers(40, 121)) if big else int(rng.integers(3, 40))
    return dict(
        n_codes=n_codes,
        missing_prob=float(rng.choice([0.02, 0.12, 0.35])),
        zero_volume_prob=float(rng.choice([0.0, 0.12, 0.4])),
        constant_price_codes=int(rng.integers(0, n_codes // 2 + 1)),
        short_day_codes=int(rng.integers(0, n_codes // 2 + 1)))


def parity_case(seed: int):
    """The long-format days parity seed ``seed`` compares. Below 10k one
    day of the historical shape; from 10k one day of a wide shape; from
    31k a batch of 2-3 days a third of the time (the parity suite's
    ``run_wide_scenario_seed``)."""
    rng = np.random.default_rng(seed)
    if seed < WIDE_FROM:
        return [synth_day(rng, **HISTORICAL_KW)]
    kw = wide_scenario_kw(rng, big=seed >= BIG_FROM)
    if seed >= MULTIDAY_FROM and rng.random() < 0.35:
        n_days = int(rng.integers(2, 4))
        return [synth_day(rng, **kw, date=f"2024-01-{2 + i:02d}")
                for i in range(n_days)]
    return [synth_day(rng, **kw)]


def kitchen_sink_day(seed: int):
    return synth_day(np.random.default_rng(seed), **KITCHEN_SINK_KW)


# ---------------------------------------------------------------------------
# rolling (the place of the retired Pallas-kernel fuzz)
# ---------------------------------------------------------------------------

#: slot counts every sweep visits: the registered sessions' and the
#: vector-width classes (L % 4 == 0, L % 2 == 0, odd), the one-tile and
#: the more-than-128-tile rows, and the largest row the tiled kernel's
#: shared memory holds
ROLLING_PINNED_L = (240, 390, 1440, 1, 2, 3, 7, 49, 50, 51, 128, 129, 510,
                    511, 512, 513, 514, 515, 1023, 2047, 4097, 7263, 7264)
#: the largest slot count the tiled kernel takes (two stages of four
#: planes of a row in one block's shared memory)
TILED_MAX_L = 7264
#: inputs a case may hold, all planes counted once (f32 elements)
ROLLING_ELEMS = 24 << 20


def _rolling_shape(rng):
    """``(rows, L, window)`` of a rolling case: its first draws."""
    if rng.random() < 0.03:
        L = int(rng.integers(TILED_MAX_L + 1, 8193))  # past the span
    elif rng.random() < 1 / 3:
        L = int(ROLLING_PINNED_L[int(rng.integers(len(ROLLING_PINNED_L)))])
    else:
        L = int(np.exp(rng.uniform(0.0, np.log(TILED_MAX_L + 1))))
        L = max(1, min(L, TILED_MAX_L))
    max_rows = max(1, min(50_000, ROLLING_ELEMS // (3 * L)))
    rows = int(np.exp(rng.uniform(0.0, np.log(max_rows + 1))))
    rows = max(1, min(rows, max_rows))
    if rng.random() < 0.5:
        window = 50
    else:
        window = int(rng.integers(1, L + 6))
    return rows, L, window


def rolling_shape(seed: int):
    """``(rows, L, window)`` of :func:`rolling_case` ``(seed)``, without
    drawing its data."""
    return _rolling_shape(np.random.default_rng(seed))


def rolling_case(seed: int):
    """One second-moment case: ``dict(low, high, mask, window)``.

    ``L`` from 1 to 7264 (a pinned slot count a third of the time; past
    the kernels' shared-memory span 3% of the time),
    rows from 1 to ~50k within :data:`ROLLING_ELEMS`, windows from 1 to
    ``L + 5`` (50, the tiled kernel's, half the time); masks from full to
    sparse with all-masked rows and constant runs; prices near 10 or
    large magnitudes."""
    rng = np.random.default_rng(seed)
    rows, L, window = _rolling_shape(rng)
    scale = float(rng.choice([10.0, 10.0, 3.0, 1700.0, 41000.0, 2.5e5]))
    step = float(rng.choice([1e-4, 1e-3, 1e-2]))
    close = scale * np.exp(np.cumsum(
        rng.standard_normal((rows, L)) * step, axis=-1))
    low = close * (1 - rng.random((rows, L)) * 2e-3)
    high = low * (1 + rng.random((rows, L)) * 4e-3)
    if rng.random() < 0.5:
        low, high = np.round(low, 2), np.round(high, 2)
    density = float(rng.choice([1.0, 0.98, 0.9, 0.5, 0.1]))
    mask = rng.random((rows, L)) < density
    if rows > 1 and rng.random() < 0.5:
        mask[rng.random(rows) < 0.1] = False       # all-masked rows
    if rng.random() < 0.5:
        # constant runs: one value over a stretch of a row, full coverage
        for r in rng.integers(0, rows, size=min(rows, 4)):
            a = int(rng.integers(0, L))
            b = int(min(L, a + rng.integers(1, 3 * window + 2)))
            low[r, a:b] = low[r, a]
            high[r, a:b] = high[r, a]
            mask[r, a:b] = True
    if rng.random() < 0.3:
        mask[:, : int(rng.integers(0, L + 1))] = False  # a late open
    return dict(low=low.astype(np.float32), high=high.astype(np.float32),
                mask=mask, window=window)


# ---------------------------------------------------------------------------
# wire and grid (tools/fuzz/fuzz_wire.py, fuzz_grid.py)
# ---------------------------------------------------------------------------

def wire_case(seed: int):
    """``(bars [D, T, 240, 5] f32, mask)``: random shapes, price scales
    from 0.05 to 41000, every volume kind of the mode ladder, halted
    tickers, garbage on dead lanes and off-tick poison."""
    rng = np.random.default_rng(seed)
    D = int(rng.integers(1, 3))
    T = int(rng.integers(2, 30))
    base_price = float(rng.choice([0.05, 3.0, 12.0, 80.0, 300.0, 1700.0,
                                   30000.0, 41000.0]))
    shape = (D, T, 240)
    close = base_price * np.exp(np.cumsum(
        rng.normal(0, rng.choice([1e-4, 1e-3, 5e-3]), shape), -1))
    open_ = close * (1 + rng.normal(0, 1e-4, shape))
    high = np.maximum(open_, close) * (1 + np.abs(rng.normal(0, 2e-4, shape)))
    low = np.minimum(open_, close) * (1 - np.abs(rng.normal(0, 2e-4, shape)))
    vol_kind = rng.integers(0, 5)
    if vol_kind in (0, 1):
        volume = (rng.integers(0, 1000, shape) *
                  (100 if vol_kind == 0 else 1)).astype(np.float64)
    elif vol_kind == 2:
        volume = rng.integers(0, 1000, shape).astype(np.float64) * 1e5
    elif vol_kind == 3:
        volume = rng.integers(0, 60000, shape).astype(np.float64)
    else:
        volume = (rng.integers(0, 60000, shape) * 100).astype(np.float64)
    bars = np.stack([open_, high, low, close, volume], -1)
    bars[..., :4] = np.round(bars[..., :4], 2)
    bars = np.maximum(bars, 0.01 * (np.arange(5) < 4)).astype(np.float32)
    mask = rng.random(shape) > rng.choice([0.0, 0.05, 0.5])
    if rng.random() < 0.3:  # halted ticker
        mask[:, rng.integers(0, T)] = False
    if rng.random() < 0.3:  # garbage on dead lanes
        dead = np.argwhere(~mask)
        for i in range(min(3, len(dead))):
            bars[tuple(dead[i])] = [np.nan, np.inf, -5, 1e12, -3.3][i % 5]
    if rng.random() < 0.2:  # off-tick poison on a live lane
        live = np.argwhere(mask)
        if len(live):
            bars[tuple(live[0])][3] += 0.003
    return bars, mask


def grid_case(seed: int):
    """Long rows ``(codes, times, open, high, low, close, volume)`` with
    off-grid and sub-minute times, few codes (duplicates: last write
    wins)."""
    from ..sessions import GRID_TIMES

    rng = np.random.default_rng(seed)
    n = int(rng.integers(1, 2000))
    n_codes = int(rng.integers(1, 12))
    codes = np.array([f"{600000 + rng.integers(0, n_codes):06d}"
                      for _ in range(n)])
    kind = rng.random(n)
    times = np.where(kind < 0.7,
                     GRID_TIMES[rng.integers(0, 240, n)],
                     rng.choice([92900000, 113000000, 120000000, 150000000,
                                 93000001, 130000000 - 100000, 0, 235959999,
                                 93000000 + 50000], n))
    f = [np.round(rng.uniform(1, 100, n), 2) for _ in range(4)]
    v = rng.integers(0, 1e6, n).astype(np.float64)
    return codes, times, f[0], f[1], f[2], f[3], v


# ---------------------------------------------------------------------------
# evaluation (tools/fuzz/fuzz_eval.py, fuzz_resample.py, fuzz_l3.py,
# fuzz_group.py)
# ---------------------------------------------------------------------------

def eval_case(seed: int):
    """``dict(x, y, m, k, codes, dates, pct, n)``: ``[dates, tickers]``
    f32 exposures and returns (heavy ties 40% of the time), the valid
    mask, a quantile group count, and a ragged (code, date, pct) panel
    in shuffled row order with missing pct, and a horizon, for the
    forward returns (drawn after the JAX harness's draws, so its cases
    are unchanged)."""
    rng = np.random.default_rng(seed)
    n_d = int(rng.integers(2, 12))
    n_t = int(rng.integers(3, 60))
    x = rng.normal(0, 1, (n_d, n_t)).astype(np.float32)
    if rng.random() < 0.4:  # heavy ties
        x = np.round(x, 1).astype(np.float32)
    y = (0.3 * x + rng.normal(0, 1, x.shape)).astype(np.float32)
    m = rng.random(x.shape) > rng.choice([0.0, 0.1, 0.6])
    k = int(rng.integers(2, 11))
    n_codes = int(rng.integers(1, 12))
    n_days = int(rng.integers(1, 40))
    keep = rng.random((n_codes, n_days)) < rng.uniform(0.3, 1.0)
    codes, days = np.nonzero(keep)
    order = rng.permutation(len(codes))  # rows arrive in any order
    codes = codes[order]
    dates = (np.datetime64("2024-01-01") + days[order]).astype(
        "datetime64[D]")
    pct = rng.normal(0, 0.02, len(codes))
    pct[rng.random(len(codes)) < 0.05] = np.nan
    n = int(rng.integers(1, 6))
    return dict(x=x, y=y, m=m, k=k, codes=codes, dates=dates, pct=pct, n=n)


def resample_case(seed: int):
    """``dict(code, date, value, days_window)``: a ragged panel of NaN-
    bearing exposures, and the window of the ``days`` mode."""
    rng = np.random.default_rng(seed)
    n_codes = int(rng.integers(2, 8))
    n_days = int(rng.integers(3, 40))
    start = np.datetime64("2024-01-01") + int(rng.integers(0, 300))
    all_days = np.array([start + i for i in range(n_days)],
                        dtype="datetime64[D]")
    rows = {"code": [], "date": [], "value": []}
    for c in range(n_codes):
        keep = rng.random(n_days) > rng.choice([0.0, 0.3])
        if not keep.any():
            keep[0] = True
        d = all_days[keep]
        rows["code"] += [f"{600000+c:06d}"] * len(d)
        rows["date"].append(d)
        v = rng.normal(0, 1, len(d))
        v[rng.random(len(d)) < 0.1] = np.nan
        rows["value"].append(v)
    code = np.array(rows["code"], dtype=object)
    date = np.concatenate(rows["date"])
    value = np.concatenate(rows["value"]).astype(np.float32)
    return dict(code=code, date=date, value=value,
                days_window=int(rng.integers(1, 6)))


def _pv_panel(rng, codes, days, drop):
    """Daily PV rows per code over its own ragged subset of ``days``."""
    import pandas as pd

    pv_rows = []
    for c in codes:
        keep = rng.random(len(days)) > rng.choice(drop)
        for d in days[keep]:
            pv_rows.append((c, d, rng.normal(0, 0.02),
                            rng.uniform(1e9, 1e10), rng.uniform(7e8, 9e9)))
    return pd.DataFrame(pv_rows, columns=["code", "date", "pct_change",
                                          "tmc", "cmc"])


def l3_case(seed: int):
    """``dict(pv, exp, future_days, frequency, weight_param,
    group_num)``: a ragged PV panel, exposures on a subset of its rows
    (NaNs, ties), and the ic_test/group_test parameters."""
    rng = np.random.default_rng(seed)
    if seed < 10_000:
        n_codes = int(rng.integers(3, 12))
        n_days = int(rng.integers(6, 25))
    else:
        n_codes = int(rng.integers(3, 30))
        n_days = int(rng.integers(4, 60))
    codes = [f"{600000+i:06d}" for i in range(n_codes)]
    days = np.array([np.datetime64("2024-01-01") + i for i in
                     rng.choice(200, n_days, replace=False)])
    days.sort()
    pv = _pv_panel(rng, codes, days, [0.0, 0.25])
    exp = pv.sample(frac=rng.uniform(0.5, 1.0), random_state=seed)[
        ["code", "date"]].copy()
    exp["v"] = rng.normal(0, 1, len(exp))
    if rng.random() < 0.5:
        exp["v"] = np.round(exp["v"], 1)  # ties
    exp.loc[exp.sample(frac=0.1, random_state=seed + 1).index, "v"] = np.nan
    n = int(rng.integers(1, 4))
    freq = str(rng.choice(["week", "month"]))
    w = rng.choice([None, "tmc", "cmc"])
    return dict(pv=pv, exp=exp, future_days=n, frequency=freq,
                weight_param=None if w is None else str(w),
                group_num=int(rng.integers(2, 7)))


def group_case(seed: int):
    """``dict(pv, exp, group_num, frequency, weight_param)``: the group
    test's full value chain over a ragged panel."""
    rng = np.random.default_rng(seed)
    if seed < 10_000:
        n_codes = int(rng.integers(3, 10))
        n_days = int(rng.integers(8, 30))
    else:
        n_codes = int(rng.integers(3, 25))
        n_days = int(rng.integers(5, 70))
    K = int(rng.integers(2, 6))
    freq = str(rng.choice(["week", "month"]))
    wparam = rng.choice([None, "tmc", "cmc"])
    codes = [f"{600000+i:06d}" for i in range(n_codes)]
    days = np.array(sorted(np.datetime64("2024-01-01") + i for i in
                    rng.choice(120, n_days, replace=False)))
    pv = _pv_panel(rng, codes, days, [0.0, 0.2])
    exp = pv.sample(frac=rng.uniform(0.6, 1.0), random_state=seed)[
        ["code", "date"]].copy()
    exp["v"] = rng.normal(0, 1, len(exp)).astype(np.float32)
    if rng.random() < 0.4:
        exp["v"] = np.round(exp["v"], 1)
    exp.loc[exp.sample(frac=0.08, random_state=seed + 1).index, "v"] = np.nan
    return dict(pv=pv, exp=exp, group_num=K, frequency=freq,
                weight_param=None if wparam is None else str(wparam))


# ---------------------------------------------------------------------------
# search (tools/fuzz/fuzz_search.py)
# ---------------------------------------------------------------------------

def search_case(seed: int):
    """``(bars [D, T, 240, 5], mask, genomes [P, L], skeleton)``: D up to
    4 days (the cross-day features need shift chains), halted tickers
    and single-day halts, the default or the rich skeleton."""
    from .. import search

    rng = np.random.default_rng(seed)
    D = int(rng.integers(1, 5))
    T = int(rng.integers(2, 8))
    shape = (D, T, 240)
    close = 10.0 * np.exp(np.cumsum(
        rng.normal(0, 1e-3, shape), -1)).astype(np.float32)
    open_ = (close * (1 + rng.normal(0, 1e-4, shape))).astype(np.float32)
    high = np.maximum(open_, close) * 1.0002
    low = np.minimum(open_, close) * 0.9998
    vol = (rng.integers(0, 1000, shape) * 100).astype(np.float32)
    bars = np.stack([open_, high, low, close, vol], -1).astype(np.float32)
    mask = rng.random(shape) > rng.choice([0.0, 0.1, 0.6])
    if rng.random() < 0.3:
        mask[:, 0] = False  # halted ticker -> NaN factor
    if rng.random() < 0.3 and D > 1:
        mask[int(rng.integers(0, D)), int(rng.integers(0, T))] = False
    P = int(rng.integers(1, 24))
    skel = (search.RICH_SKELETON if rng.random() < 0.4
            else search.DEFAULT_SKELETON)
    genomes = search.random_population(rng, P, skel)
    return bars, mask, genomes, skel


# ---------------------------------------------------------------------------
# pipeline (tools/fuzz/fuzz_pipeline.py)
# ---------------------------------------------------------------------------

#: the isolation tier's first seed
ISOLATION_FROM = 10_000


def _day_file(rng, date_str, n_codes):
    """One day file's columns and whether its code column is int-coded
    (~40% of days: the CSMAR int-export shape)."""
    cols = synth_day(rng, n_codes=n_codes, date=date_str, missing_prob=0.05)
    return date_str, cols, bool(rng.random() < 0.4)


def pipeline_case(seed: int):
    """A pipeline scenario as a dict. From seed 10k (``kind`` ``'isolation'``):
    day files, one persistently poisoned day and a batch size. Below
    (``'resume'``): phase-1 and phase-2 day files, a batch size, an
    optional day failing through the fault hook, an optional transient
    launch failure (``chaos_p``; its own rng from ``seed + 7``)."""
    rng = np.random.default_rng(seed)
    if seed >= ISOLATION_FROM:
        n_codes = int(rng.integers(3, 8))
        n_days = int(rng.integers(2, 9))
        days = sorted(str(np.datetime64("2024-02-01") + int(i))
                      for i in rng.choice(40, n_days, replace=False))
        files = [_day_file(rng, ds, n_codes) for ds in days]
        poison = days[int(rng.integers(0, n_days))]
        return dict(kind="isolation", files=files, poison=poison,
                    days_per_batch=int(rng.integers(1, 5)))
    n_codes = int(rng.integers(3, 10))
    n1 = int(rng.integers(1, 8))
    n2 = int(rng.integers(1, 6))
    all_days = sorted(str(np.datetime64("2024-01-02") + int(i))
                      for i in rng.choice(60, n1 + n2, replace=False))
    first = [_day_file(rng, ds, n_codes) for ds in all_days[:n1]]
    dpb = int(rng.integers(1, 5))
    bad_day = (np.datetime64(all_days[int(rng.integers(0, n1))])
               if rng.random() < 0.3 else None)
    chaos_p = float(rng.choice([0.2, 0.5])) if rng.random() < 0.5 else None
    second = [_day_file(rng, ds, n_codes) for ds in all_days[n1:]]
    return dict(kind="resume", all_days=all_days, n1=n1, first=first,
                second=second, days_per_batch=dpb, bad_day=bad_day,
                chaos_p=chaos_p)


# ---------------------------------------------------------------------------
# parallel (tools/fuzz/fuzz_parallel.py)
# ---------------------------------------------------------------------------

#: the JAX harness's (days, tickers) mesh shapes; the in-process mesh is
#: tickers-only, so a case runs on the tickers extent of its draw
MESH_POOL = ((1, 8), (2, 4), (4, 2), (1, 4), (2, 2), (1, 2), (1, 1))
XS_D_POOL = (1, 3, 6)
XS_T_POOL = (5, 17, 40)
FACTOR_D_POOL = (1, 2)
FACTOR_T_POOL = (7, 16, 23)
NAME_POOL = (
    ("vol_return1min", "mmt_pm", "liq_openvol", "shape_skew"),
    ("doc_pdf60", "doc_vol10_ratio", "doc_kurt"),
    ("mmt_ols_qrs", "mmt_ols_beta_zscore_last"),
    ("corr_prv", "trade_headRatio", "vol_upRatio", "liq_amihud_1min"),
)


def parallel_case(seed: int):
    """``(xs, factors)``: a cross-section case ``dict(shards, x, y, m,
    k)`` (all-masked dates, single valid lanes, inexact constant
    cross-sections, shard-crossing ties, inf/NaN poison on masked
    lanes), and 60% of the time a factor-graph case ``dict(shards,
    bars, mask, names)`` (None for all 58), else None."""
    rng = np.random.default_rng(seed)
    shape = MESH_POOL[int(rng.integers(len(MESH_POOL)))]
    n_d = XS_D_POOL[int(rng.integers(len(XS_D_POOL)))]
    n_t = XS_T_POOL[int(rng.integers(len(XS_T_POOL)))]
    x = rng.normal(0, 1, (n_d, n_t)).astype(np.float32)
    y = (0.4 * x + rng.normal(0, 1, x.shape)).astype(np.float32)
    m = rng.random(x.shape) > rng.choice([0.0, 0.2, 0.7])
    if rng.random() < 0.3:
        m[int(rng.integers(n_d))] = False       # all-masked date
    if rng.random() < 0.3:
        d = int(rng.integers(n_d))
        m[d] = False
        m[d, int(rng.integers(n_t))] = True     # single valid lane
    if rng.random() < 0.4:
        # a constant cross-section at an f32-inexact value: an exactly
        # representable constant cancels bit for bit in any form
        x[int(rng.integers(n_d))] = 0.1
    if rng.random() < 0.5:
        x = np.round(x, 1).astype(np.float32)   # shard-crossing ties
    if rng.random() < 0.4:
        poison = rng.choice([np.inf, -np.inf, np.nan])
        x = np.where(m, x, np.float32(poison))
        y = np.where(m, y, np.float32(poison))
    xs = dict(shards=shape[1], x=x, y=y, m=m,
              k=int(rng.choice([3, 5, 10])))
    if not rng.random() < 0.6:
        return xs, None
    shape = MESH_POOL[int(rng.integers(len(MESH_POOL)))]
    n_d = FACTOR_D_POOL[int(rng.integers(len(FACTOR_D_POOL)))]
    n_t = FACTOR_T_POOL[int(rng.integers(len(FACTOR_T_POOL)))]
    if rng.random() < 0.06:
        names, n_d, n_t = None, 1, 16
    else:
        names = NAME_POOL[int(rng.integers(len(NAME_POOL)))]
    s = (n_d, n_t, 240)
    close = 10.0 * np.exp(np.cumsum(rng.normal(0, 1e-3, s), -1))
    open_ = close * (1 + rng.normal(0, 1e-4, s))
    high = np.maximum(open_, close) * (1 + np.abs(rng.normal(0, 2e-4, s)))
    low = np.minimum(open_, close) * (1 - np.abs(rng.normal(0, 2e-4, s)))
    volume = (rng.integers(0, 500, s) * rng.choice([1, 100])).astype(float)
    if rng.random() < 0.5:
        volume[rng.random(s) < 0.2] = 0.0       # zero-volume bars
    bars = np.stack([open_, high, low, close, volume], -1).astype(np.float32)
    mask = rng.random(s) > rng.choice([0.0, 0.05, 0.5])
    if rng.random() < 0.3:
        t = int(rng.integers(n_t))
        mask[:, t] = False
        mask[:, t, :int(rng.integers(1, 60))] = True   # <50-bar ticker
    if rng.random() < 0.2:
        mask[:, int(rng.integers(n_t))] = False        # fully halted
    return xs, dict(shards=shape[1], bars=bars, mask=mask, names=names)


# ---------------------------------------------------------------------------
# refdiff (tools/fuzz/fuzz_refdiff.py)
# ---------------------------------------------------------------------------

#: the first seed of the evaluation tier and of the resampler/driver tier
EVAL_FROM, FINAL_FROM = 100_000, 200_000


def refdiff_case(seed: int):
    """``(tier, kwargs)``: ``'day'`` below 100k (a day for the
    reference's cal_* code), ``'eval'`` from 100k (ic_test/group_test
    parameters), ``'final'`` from 200k (cal_final_exposure, with a
    driver scenario on every third seed)."""
    rng = np.random.default_rng(seed)
    if seed >= FINAL_FROM:
        kw = dict(n_codes=int(rng.integers(4, 14)),
                  n_days=int(rng.integers(20, 90)),
                  nan_prob=float(rng.choice([0.0, 0.1, 0.3])))
        pipe = None
        if seed % 3 == 0:
            pipe = dict(n_days=int(rng.integers(3, 7)),
                        precompute_days=int(rng.integers(0, 3)),
                        n_codes=int(rng.integers(4, 10)))
        return "final", dict(final=kw, pipeline=pipe)
    if seed >= EVAL_FROM:
        return "eval", dict(
            future_days=int(rng.integers(1, 8)),
            frequency=str(rng.choice(
                ["weekly", "monthly", "quarterly", "yearly"])),
            weight_param=rng.choice([None, "tmc", "cmc"]),
            group_num=int(rng.integers(3, 8)),
            n_codes=int(rng.integers(5, 35)),
            n_days=int(rng.integers(30, 220)),
            nan_prob=float(rng.choice([0.0, 0.05, 0.2, 0.4])),
            missing_row_prob=float(rng.choice([0.0, 0.05, 0.15])),
            nan_as_value=bool(rng.integers(0, 2)))
    kw = dict(
        n_codes=int(rng.integers(3, 12)),
        missing_prob=float(rng.choice([0.0, 0.05, 0.2, 0.5])),
        zero_volume_prob=float(rng.choice([0.0, 0.1, 0.3])),
        constant_price_codes=int(rng.integers(0, 3)),
        short_day_codes=int(rng.integers(0, 3)),
    )
    return "day", dict(day=synth_day(rng, **kw))
