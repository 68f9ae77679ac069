"""The 58 factor kernels in plain numpy over long-format rows, f64: the
benchmark's plain reference.

A frozen copy of the port's f64 oracle (an independent reimplementation
of the reference's polars expression graphs,
MinuteFrequentFactorCalculateMethodsCICC.py — file:line cited per
kernel), held here so that no change to the program can move the
yardstick. It imports nothing of the program: the session comes from
:mod:`.sessions`, the constant-window reading from :mod:`.stats`, and
the pandas frame driver is replaced by :func:`group_factors` and
:func:`day_ranks`, which take one day's rows from the caller.

Conventions:
  * each kernel is a scalar function of one (code, date) group's bars,
    sorted by time: it gets a ``Group`` of f64 arrays;
  * returning ``None`` means the group is *absent* from the output
    (filter-then-group kernels); ``np.nan`` means a row with a null/NaN
    value — both evaluate identically downstream (SURVEY.md Q10 filter);
  * quirks Q1-Q7 are replicated; ordering ambiguities are pinned as in the
    JAX backend (ascending value order; AM-then-PM sessions).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional, Sequence

import numpy as np

from .sessions import SessionSpec
from .stats import (CONSTANT_WINDOW, kurt_excess, pearson, pct_change,
                    rank_average, skew_g1, std1)

ORACLE_FACTORS: Dict[str, Callable] = {}


def _register(name: str):
    def deco(fn):
        ORACLE_FACTORS[name] = fn
        return fn
    return deco


@dataclasses.dataclass
class Group:
    """One (code, date) group's bars, time-sorted."""

    time: np.ndarray
    open: np.ndarray
    high: np.ndarray
    low: np.ndarray
    close: np.ndarray
    volume: np.ndarray
    grank: Optional[np.ndarray] = None  # global eod-return rank (doc_pdf*)
    #: market session spec: the sentinel boundaries the
    #: time-filter kernels consult
    session: Optional[SessionSpec] = None
    _rolling_cache: Optional[dict] = dataclasses.field(
        default=None, repr=False, compare=False)

    @property
    def sess(self) -> SessionSpec:
        return self.session

    @property
    def n(self) -> int:
        return len(self.time)

    @property
    def ret_co(self) -> np.ndarray:
        with np.errstate(divide="ignore", invalid="ignore"):
            return self.close / self.open - 1.0

    @property
    def vol_share(self) -> np.ndarray:
        with np.errstate(divide="ignore", invalid="ignore"):
            return self.volume / self.volume.sum()

    @property
    def eod_ret(self) -> np.ndarray:
        with np.errstate(divide="ignore", invalid="ignore"):
            return self.close[-1] / self.close


# --- 动量反转 / momentum (ref :12-480) ------------------------------------

def _sentinel_ratio(g: Group, t_first: int, t_last: int):
    sel = (g.time == t_first) | (g.time == t_last)
    if not sel.any():
        return None
    return g.close[sel][-1] / g.open[sel][0]


@_register("mmt_pm")
def mmt_pm(g: Group):
    return _sentinel_ratio(g, g.sess.T_PM_OPEN, g.sess.T_PM_CLOSE)  # ref :12-24


@_register("mmt_last30")
def mmt_last30(g: Group):
    return _sentinel_ratio(g, g.sess.T_LAST30_OPEN, g.sess.T_PM_CLOSE)  # ref :27-39


@_register("mmt_am")
def mmt_am(g: Group):
    return _sentinel_ratio(g, g.sess.T_AM_OPEN, g.sess.T_AM_CLOSE)  # ref :63-75


@_register("mmt_between")
def mmt_between(g: Group):
    return _sentinel_ratio(g, g.sess.T_BETWEEN_OPEN, g.sess.T_BETWEEN_CLOSE)  # ref :78-90


@_register("mmt_paratio")
def mmt_paratio(g: Group):
    """ref :42-60; session order pinned AM-then-PM (polars group order is
    nondeterministic there)."""
    am = g.time <= g.sess.T_NOON
    vals = []
    for sel in (am, ~am):
        if sel.any():
            vals.append(g.close[sel][-1] / g.open[sel][0] - 1.0)
    if not vals:
        return None
    return vals[-1] - vals[0]


def _rolling50(g: Group):
    """Windows over the trade-minute index, period 50, kept iff 50 present
    bars (ref :114-129). Returns dict of per-kept-window arrays, ddof=0.

    Second moments run on first-value-anchored prices (shift-invariant), so
    a constant-price stock gets *exactly* zero var/cov — the var_x==0
    fallback branch — rather than summation noise; the JAX backend's
    centred cumsums behave the same way. Raw windowed means are kept for
    the beta fallback (ref :130-134).

    The result is memoised on the Group: all five mmt_ols_* kernels share
    the one O(n*window) pass."""
    if g._rolling_cache is not None:
        return g._rolling_cache
    slots = g.sess.time_to_slot(g.time)
    xa = g.low.astype(np.float64)
    ya = g.high.astype(np.float64)
    if CONSTANT_WINDOW == "degenerate":
        xa = xa - np.float64(g.low[0])
        ya = ya - np.float64(g.high[0])
    out = {k: [] for k in ("cov", "var_x", "var_y", "mean_x", "mean_y")}
    for i in range(g.n):
        lo = np.searchsorted(slots, slots[i] - 49)
        if i - lo + 1 < 50:
            continue
        x, y = xa[lo:i + 1], ya[lo:i + 1]
        out["mean_x"].append(g.low[lo:i + 1].astype(np.float64).mean())
        out["mean_y"].append(g.high[lo:i + 1].astype(np.float64).mean())
        out["cov"].append(((x - x.mean()) * (y - y.mean())).mean())
        out["var_x"].append(x.var(ddof=0))
        out["var_y"].append(y.var(ddof=0))
    g._rolling_cache = {k: np.asarray(v, dtype=np.float64)
                        for k, v in out.items()}
    return g._rolling_cache


def _beta(st):
    with np.errstate(divide="ignore", invalid="ignore"):
        return np.where(st["var_x"] != 0.0, st["cov"] / st["var_x"],
                        st["mean_y"] / st["mean_x"])


def _corr_square_q4(st):
    """Quirk Q4 (ref :137): cov^0.5/(var_x*var_y); null when product 0."""
    prod = st["var_x"] * st["var_y"]
    with np.errstate(invalid="ignore", divide="ignore"):
        vals = np.sqrt(st["cov"]) / prod
    return vals[prod != 0.0]  # nulls removed; value-NaN kept (propagates)


@_register("mmt_ols_qrs")
def mmt_ols_qrs(g: Group):
    """ref :93-173."""
    st = _rolling50(g)
    nwin = st["cov"].size
    if nwin == 0:
        return None
    beta = _beta(st)
    cs = _corr_square_q4(st)
    beta_std = std1(beta)  # null iff nwin < 2 (NaN from values propagates)
    cond = nwin >= 2 and beta_std != 0.0 and cs.size > 0
    if not cond:
        return 0.0
    return float(cs.mean() * (beta[-1] - beta.mean()) / beta_std)


@_register("mmt_ols_corr_square_mean")
def mmt_ols_corr_square_mean(g: Group):
    """ref :176-222: cov^2/(var_x*var_y), null->0."""
    st = _rolling50(g)
    if st["cov"].size == 0:
        return None
    prod = st["var_x"] * st["var_y"]
    keep = prod != 0.0
    if not keep.any():
        return 0.0
    return float(((st["cov"][keep] ** 2) / prod[keep]).mean())


@_register("mmt_ols_corr_mean")
def mmt_ols_corr_mean(g: Group):
    """ref :225-271: cov/sqrt(var_x*var_y), null->0."""
    st = _rolling50(g)
    if st["cov"].size == 0:
        return None
    prod = st["var_x"] * st["var_y"]
    keep = prod != 0.0
    if not keep.any():
        return 0.0
    return float((st["cov"][keep] / np.sqrt(prod[keep])).mean())


@_register("mmt_ols_beta_mean")
def mmt_ols_beta_mean(g: Group):
    """ref :274-324."""
    st = _rolling50(g)
    if st["cov"].size == 0:
        return None
    return float(_beta(st).mean())


@_register("mmt_ols_beta_zscore_last")
def mmt_ols_beta_zscore_last(g: Group):
    """ref :327-376."""
    st = _rolling50(g)
    nwin = st["cov"].size
    if nwin == 0:
        return None
    beta = _beta(st)
    beta_std = std1(beta)
    if nwin >= 2 and beta_std > 0.0:  # NaN > 0 is False, as polars
        return float((beta[-1] - beta.mean()) / beta_std)
    return float(beta.mean())


def _volume_ret(g: Group, k: int, largest: bool):
    v = np.sort(g.volume)
    if largest:
        thr = v[-k:].min() if g.n >= k else v.min()
        sel = g.volume >= thr
    else:
        thr = v[:k].max() if g.n >= k else v.max()
        sel = g.volume <= thr
    with np.errstate(divide="ignore", invalid="ignore"):
        return float(np.prod(g.close[sel] / g.open[sel]) - 1.0)


@_register("mmt_top50VolumeRet")
def mmt_top50VolumeRet(g: Group):
    return _volume_ret(g, 50, True)  # ref :379-402


@_register("mmt_bottom50VolumeRet")
def mmt_bottom50VolumeRet(g: Group):
    return _volume_ret(g, 50, False)  # ref :405-428


@_register("mmt_top20VolumeRet")
def mmt_top20VolumeRet(g: Group):
    return _volume_ret(g, 20, True)  # ref :431-454


@_register("mmt_bottom20VolumeRet")
def mmt_bottom20VolumeRet(g: Group):
    return _volume_ret(g, 50, False)  # quirk Q1: bottom_k(50), ref :471


# --- 波动率 / volatility (ref :485-642) -----------------------------------

@_register("vol_volume1min")
def vol_volume1min(g: Group):
    return std1(g.volume)  # ref :485-496


@_register("vol_range1min")
def vol_range1min(g: Group):
    with np.errstate(divide="ignore", invalid="ignore"):
        return std1(g.high / g.low)  # ref :499-515


@_register("vol_return1min")
def vol_return1min(g: Group):
    return std1(g.ret_co)  # ref :518-534


def _signed_vol(g: Group, positive: bool):
    ret = g.ret_co
    sub = ret[ret > 0] if positive else ret[ret < 0]
    if sub.size < 2:  # std null -> fill_null(0), ref :557,:611
        return 0.0
    return std1(sub)


@_register("vol_upVol")
def vol_upVol(g: Group):
    return _signed_vol(g, True)  # ref :537-560


@_register("vol_upRatio")
def vol_upRatio(g: Group):
    with np.errstate(divide="ignore", invalid="ignore"):
        return float(np.float64(_signed_vol(g, True))
                     / np.float64(std1(g.ret_co)))  # ref :563-588


@_register("vol_downVol")
def vol_downVol(g: Group):
    return _signed_vol(g, False)  # ref :591-614


@_register("vol_downRatio")
def vol_downRatio(g: Group):
    with np.errstate(divide="ignore", invalid="ignore"):
        return float(np.float64(_signed_vol(g, False))
                     / np.float64(std1(g.ret_co)))  # ref :617-642


# --- 高阶特征 / shape (ref :647-729) --------------------------------------

@_register("shape_skew")
def shape_skew(g: Group):
    return skew_g1(g.ret_co)  # ref :647-657


@_register("shape_kurt")
def shape_kurt(g: Group):
    return kurt_excess(g.ret_co)  # ref :660-670


@_register("shape_skratio")
def shape_skratio(g: Group):
    with np.errstate(divide="ignore", invalid="ignore"):
        return float(np.float64(skew_g1(g.ret_co))
                     / np.float64(kurt_excess(g.ret_co)))  # ref :673-687


@_register("shape_skewVol")
def shape_skewVol(g: Group):
    return skew_g1(g.vol_share)  # ref :690-700


@_register("shape_kurtVol")
def shape_kurtVol(g: Group):
    return kurt_excess(g.vol_share)  # ref :703-713


@_register("shape_skratioVol")
def shape_skratioVol(g: Group):
    with np.errstate(divide="ignore", invalid="ignore"):
        return float(np.float64(skew_g1(g.vol_share))
                     / np.float64(kurt_excess(g.vol_share)))  # ref :716-729


# --- 流动性 / liquidity (ref :734-831) ------------------------------------

@_register("liq_amihud_1min")
def liq_amihud_1min(g: Group):
    """ref :734-761."""
    pct_abs = np.abs(pct_change(g.close))
    pct_abs[np.isnan(pct_abs)] = 0.0
    with np.errstate(divide="ignore", invalid="ignore"):
        terms = np.where(g.volume > 0, pct_abs / g.volume, 0.0)
    return float(terms.sum())


@_register("liq_closeprevol")
def liq_closeprevol(g: Group):
    sel = g.time < g.sess.T_CLOSE_AUCTION  # ref :764-775
    if not sel.any():
        return None
    return float(g.volume[sel].sum())


@_register("liq_closevol")
def liq_closevol(g: Group):
    sel = g.time >= g.sess.T_CLOSE_AUCTION  # ref :778-789
    if not sel.any():
        return None
    return float(g.volume[sel].sum())


@_register("liq_firstCallR")
def liq_firstCallR(g: Group):
    with np.errstate(divide="ignore", invalid="ignore"):
        return float(g.volume[0] / g.volume.sum())  # ref :792-802


@_register("liq_lastCallR")
def liq_lastCallR(g: Group):
    sel = g.time >= g.sess.T_CLOSE_AUCTION  # ref :805-820
    with np.errstate(divide="ignore", invalid="ignore"):
        return float(g.volume[sel].sum() / g.volume.sum())


@_register("liq_openvol")
def liq_openvol(g: Group):
    return float(g.volume[0])  # ref :823-831


# --- 量价相关性 / price-volume correlation (ref :836-932) ------------------

@_register("corr_prv")
def corr_prv(g: Group):
    return pearson(pct_change(g.close), g.volume)  # ref :836-847


@_register("corr_prvr")
def corr_prvr(g: Group):
    """ref :850-874: zero-volume bars removed before the pct-changes."""
    keep = g.volume != 0
    if not keep.any():
        return None
    return pearson(pct_change(g.close[keep]), pct_change(g.volume[keep]))


@_register("corr_pv")
def corr_pv(g: Group):
    return pearson(g.close, g.volume)  # ref :877-888


def _shift(v: np.ndarray, k: int) -> np.ndarray:
    out = np.full(v.shape, np.nan)
    if k > 0:
        out[k:] = v[:-k]
    else:
        out[:k] = v[-k:]
    return out


@_register("corr_pvd")
def corr_pvd(g: Group):
    return pearson(g.close, _shift(g.volume.astype(np.float64), 1))  # ref :891-902


@_register("corr_pvl")
def corr_pvl(g: Group):
    return pearson(g.close, _shift(g.volume.astype(np.float64), -1))  # ref :905-916


@_register("corr_pvr")
def corr_pvr(g: Group):
    keep = g.volume != 0  # ref :919-932
    if not keep.any():
        return None
    return pearson(g.close[keep], pct_change(g.volume[keep]))


# --- 筹码分布 / chip distribution (ref :937-1201) --------------------------

def _chip_group_sums(g: Group):
    """Volume shares summed per unique eod-return level (ref :948-951)."""
    share = g.vol_share
    ret = g.eod_ret
    uniq, inv = np.unique(ret, return_inverse=True)
    sums = np.zeros(uniq.size)
    np.add.at(sums, inv, share)
    return uniq, sums


@_register("doc_kurt")
def doc_kurt(g: Group):
    return kurt_excess(_chip_group_sums(g)[1])  # ref :937-957


@_register("doc_skew")
def doc_skew(g: Group):
    return skew_g1(_chip_group_sums(g)[1])  # ref :960-980


@_register("doc_std")
def doc_std(g: Group):
    return skew_g1(_chip_group_sums(g)[1])  # quirk Q2: skew, ref :998-1000


def _doc_pdf(g: Group, threshold: float):
    """ref :1006-1138: shares grouped by *global* rank, cumulative walk in
    ascending-rank order (our Q7 pinning), first rank crossing threshold."""
    assert g.grank is not None
    uniq, inv = np.unique(g.grank, return_inverse=True)
    sums = np.zeros(uniq.size)
    np.add.at(sums, inv, g.vol_share)
    cum = np.cumsum(sums)
    cross = np.nonzero(cum > threshold)[0]
    if cross.size == 0:
        return np.nan
    return float(uniq[cross[0]])


@_register("doc_pdf60")
def doc_pdf60(g: Group):
    return _doc_pdf(g, 0.6)


@_register("doc_pdf70")
def doc_pdf70(g: Group):
    return _doc_pdf(g, 0.7)


@_register("doc_pdf80")
def doc_pdf80(g: Group):
    return _doc_pdf(g, 0.8)


@_register("doc_pdf90")
def doc_pdf90(g: Group):
    return _doc_pdf(g, 0.9)


@_register("doc_pdf95")
def doc_pdf95(g: Group):
    return _doc_pdf(g, 0.95)


def _topk_share_sum(g: Group, k: int):
    share = np.sort(g.vol_share)
    return float(share[-k:].sum()) if g.n >= k else float(share.sum())


@_register("doc_vol10_ratio")
def doc_vol10_ratio(g: Group):
    return _topk_share_sum(g, 10)  # ref :1141-1159


@_register("doc_vol5_ratio")
def doc_vol5_ratio(g: Group):
    return _topk_share_sum(g, 5)  # ref :1162-1180


@_register("doc_vol50_ratio")
def doc_vol50_ratio(g: Group):
    return _topk_share_sum(g, 5)  # quirk Q3: top_k(5), ref :1195-1197


# --- 资金成交 / trade flow (ref :1206-1406) --------------------------------

@_register("trade_bottom20retRatio")
def trade_bottom20retRatio(g: Group):
    sel = g.time >= g.sess.T_TAIL20  # ref :1206-1224
    if not sel.any():
        return None
    v, ret = g.volume[sel], g.ret_co[sel]
    return float((ret * v / (v.sum() + 1.0)).sum())


@_register("trade_bottom50retRatio")
def trade_bottom50retRatio(g: Group):
    sel = g.time >= g.sess.T_TAIL50  # ref :1227-1248
    if not sel.any():
        return None
    v, ret = g.volume[sel], g.ret_co[sel]
    denom = v.sum() if v.sum() != 0 else 1.0
    return float((ret * v / denom).sum())


def _window_over_total(g: Group, sel):
    total = g.volume.sum()  # ref :1271-1274 fallback
    if total > 0:
        return float(g.volume[sel].sum() / total)
    return 0.125


@_register("trade_headRatio")
def trade_headRatio(g: Group):
    return _window_over_total(g, g.time <= g.sess.T_HEAD_END)  # ref :1251-1277


@_register("trade_tailRatio")
def trade_tailRatio(g: Group):
    return _window_over_total(g, g.time >= g.sess.T_LAST30_OPEN)  # ref :1280-1306


def _ret_over_share(g: Group, t_hi: int, sign: int):
    sel = g.time <= t_hi
    if not sel.any():
        return None
    v, ret = g.volume[sel], g.ret_co[sel]
    with np.errstate(divide="ignore", invalid="ignore"):
        share = v / v.sum()
        if sign == -1:
            num = np.where(ret < 0, np.abs(ret), 0.0)
        elif sign == 1:
            num = np.where(ret > 0, np.abs(ret), 0.0)
        else:
            num = ret
        return float((num / share).mean())


@_register("trade_top20retRatio")
def trade_top20retRatio(g: Group):
    return _ret_over_share(g, g.sess.T_TOP20_END, 0)  # ref :1309-1328


@_register("trade_top50retRatio")
def trade_top50retRatio(g: Group):
    return _ret_over_share(g, g.sess.T_TOP50_END, 0)  # ref :1331-1350


@_register("trade_topNeg20retRatio")
def trade_topNeg20retRatio(g: Group):
    return _ret_over_share(g, g.sess.T_TOP20_END, -1)  # ref :1353-1378


@_register("trade_topPos20retRatio")
def trade_topPos20retRatio(g: Group):
    return _ret_over_share(g, g.sess.T_TOP20_END, 1)  # ref :1381-1406


# --- driver ---------------------------------------------------------------

def day_ranks(close: np.ndarray, group_end: np.ndarray) -> np.ndarray:
    """The whole day's eod-return ranks (ref :1016, one trading day a
    frame): ``close`` is every row of the day in (code, time) order and
    ``group_end[i]`` the close of row i's group's last bar."""
    with np.errstate(divide="ignore", invalid="ignore"):
        eod = group_end.astype(np.float64) / close.astype(np.float64)
    return rank_average(eod)


def group_factors(time, open_, high, low, close, volume, grank,
                  session: SessionSpec,
                  names: Sequence[str]) -> Dict[str, float]:
    """Every factor of ``names`` over one (code, date) group's bars,
    sorted by time; NaN where the group is absent from a factor."""
    g = Group(time=np.asarray(time, np.int64),
              open=np.asarray(open_, np.float64),
              high=np.asarray(high, np.float64),
              low=np.asarray(low, np.float64),
              close=np.asarray(close, np.float64),
              volume=np.asarray(volume, np.float64),
              grank=grank, session=session)
    vals = {}
    for n in names:
        out = ORACLE_FACTORS[n](g)
        vals[n] = np.nan if out is None else float(out)
    return vals
