"""动量反转 / momentum-reversal factors (14).

Reference definitions: MinuteFrequentFactorCalculateMethodsCICC.py:12-480.
The sentinel-bar kernels replicate quirk Q6 (SURVEY.md §2.5): the reference
filters to two sentinel timestamps and takes last-close / first-open of
whatever survives, so a missing sentinel bar degrades to a 1-bar ratio
rather than erroring — here that is a masked first/last over the same
2-slot candidate set.
"""

from __future__ import annotations

import torch

from ..ops import (
    masked_first,
    masked_last,
    masked_mean,
    masked_product,
    bottomk_threshold,
    topk_threshold,
)
from .context import DayContext
from .registry import finalize_class, register, stream_requirement

_NAN = float("nan")


def _sentinel_ratio(ctx: DayContext, t_first: int, t_last: int):
    """last(close)/first(open) over the present bars among two sentinel
    times (reference :17-23 pattern). NaN when neither bar exists."""
    sel = ctx.mask & ((ctx.times == t_first) | (ctx.times == t_last))
    return masked_last(ctx.close, sel) / masked_first(ctx.open, sel)


@register("mmt_pm")
def mmt_pm(ctx: DayContext):
    """PM-session momentum: close(14:59)/open(13:00). Ref :12-24."""
    return _sentinel_ratio(ctx, ctx.session.T_PM_OPEN, ctx.session.T_PM_CLOSE)


@register("mmt_last30")
def mmt_last30(ctx: DayContext):
    """Last-30-minute momentum: close(14:59)/open(14:30). Ref :27-39."""
    return _sentinel_ratio(ctx, ctx.session.T_LAST30_OPEN, ctx.session.T_PM_CLOSE)


@register("mmt_am")
def mmt_am(ctx: DayContext):
    """AM-session momentum: close(11:29)/open(09:30). Ref :63-75."""
    return _sentinel_ratio(ctx, ctx.session.T_AM_OPEN, ctx.session.T_AM_CLOSE)


@register("mmt_between")
def mmt_between(ctx: DayContext):
    """Momentum excluding first/last 30 min: close(14:29)/open(10:00).
    Ref :78-90."""
    return _sentinel_ratio(ctx, ctx.session.T_BETWEEN_OPEN, ctx.session.T_BETWEEN_CLOSE)


@register("mmt_paratio")
def mmt_paratio(ctx: DayContext):
    """PM-session minus AM-session momentum (each last/first - 1).

    Ref :42-60 aggregates ``last - first`` over the two session rows in
    polars' nondeterministic group order; we fix the order to
    (AM, PM) ascending — the intended sign. A single-session day yields 0
    (last == first row); an empty day NaN.
    """
    am = ctx.mask & (ctx.times <= ctx.session.T_NOON)
    pm = ctx.mask & (ctx.times > ctx.session.T_NOON)
    mmt_am_v = masked_last(ctx.close, am) / masked_first(ctx.open, am) - 1.0
    mmt_pm_v = masked_last(ctx.close, pm) / masked_first(ctx.open, pm) - 1.0
    has_am = am.any(dim=-1)
    has_pm = pm.any(dim=-1)
    both = has_am & has_pm
    out = torch.where(both, mmt_pm_v - mmt_am_v, 0.0)
    return torch.where(has_am | has_pm, out, _NAN)


# --- rolling 50-bar regression family (ref :93-376) ----------------------

def _corr_square_quirk(st):
    """Quirk Q4 (ref :137): 'corr_square' = cov^0.5 / (var_x*var_y) —
    dimensionally wrong, NaN whenever cov < 0. Null when var product is 0."""
    prod = st["var_x"] * st["var_y"]
    ok = st["valid"] & (prod != 0.0)
    val = torch.sqrt(st["cov"]) / prod
    return val, ok


def _corr_square_fixed(st):
    """Intended definition (as used by ref :212): cov^2/(var_x*var_y)."""
    prod = st["var_x"] * st["var_y"]
    ok = st["valid"] & (prod != 0.0)
    val = (st["cov"] * st["cov"]) / prod
    return val, ok


@register("mmt_ols_qrs")
def mmt_ols_qrs(ctx: DayContext):
    """QRS indicator: mean(corr_square) * zscore_last(beta). Ref :93-173.

    Falls to 0 when beta_std == 0 / undefined (single window) or when no
    window has a nonzero variance product; NaN when no complete 50-bar
    window exists (group absent after the n>=50 filter, ref :129).
    """
    st = ctx.rolling50
    cs, cs_ok = (_corr_square_quirk(st) if ctx.replicate_quirks
                 else _corr_square_fixed(st))
    cs_mean = masked_mean(cs, cs_ok)
    has_cs = cs_ok.any(dim=-1)
    b_mean, b_std, b_last, n_win = ctx.beta_moments()
    cond = (n_win > 1) & (b_std != 0.0) & has_cs
    out = torch.where(cond, cs_mean * (b_last - b_mean) / b_std, 0.0)
    return torch.where(n_win > 0, out, _NAN)


@register("mmt_ols_corr_square_mean")
def mmt_ols_corr_square_mean(ctx: DayContext):
    """Mean of windowed cov^2/(var_x*var_y); null->0. Ref :176-222."""
    cs, cs_ok = _corr_square_fixed(ctx.rolling50)
    has = cs_ok.any(dim=-1)
    n_win = ctx.rolling50["valid"].sum(dim=-1)
    out = torch.where(has, masked_mean(cs, cs_ok), 0.0)
    return torch.where(n_win > 0, out, _NAN)


@register("mmt_ols_corr_mean")
def mmt_ols_corr_mean(ctx: DayContext):
    """Mean of windowed cov/sqrt(var_x*var_y); null->0. Ref :225-271."""
    st = ctx.rolling50
    prod = st["var_x"] * st["var_y"]
    ok = st["valid"] & (prod != 0.0)
    corr = st["cov"] / torch.sqrt(prod)
    has = ok.any(dim=-1)
    n_win = st["valid"].sum(dim=-1)
    out = torch.where(has, masked_mean(corr, ok), 0.0)
    return torch.where(n_win > 0, out, _NAN)


@register("mmt_ols_beta_mean")
def mmt_ols_beta_mean(ctx: DayContext):
    """Mean of windowed beta. Ref :274-324."""
    b_mean, _, _, n_win = ctx.beta_moments()
    return torch.where(n_win > 0, b_mean, _NAN)


@register("mmt_ols_beta_zscore_last")
def mmt_ols_beta_zscore_last(ctx: DayContext):
    """(beta_last - beta_mean)/beta_std when std > 0 else beta_mean.
    Ref :327-376."""
    b_mean, b_std, b_last, n_win = ctx.beta_moments()
    cond = (n_win > 1) & (b_std > 0.0)
    out = torch.where(cond, (b_last - b_mean) / b_std, b_mean)
    return torch.where(n_win > 0, out, _NAN)


# --- volume-conditioned momentum (ref :379-480) ---------------------------

def _volume_ret(ctx: DayContext, k: int, largest: bool):
    vol = ctx.volume
    if largest:
        thr = topk_threshold(vol, ctx.mask, k)
        sel = ctx.mask & (vol >= thr[..., None])
    else:
        thr = bottomk_threshold(vol, ctx.mask, k)
        sel = ctx.mask & (vol <= thr[..., None])
    out = masked_product(ctx.ratio_co, sel) - 1.0
    return torch.where(ctx.has_bars, out, _NAN)


@register("mmt_top50VolumeRet")
def mmt_top50VolumeRet(ctx: DayContext):
    """Compounded return over the 50 highest-volume bars. Ref :379-402."""
    return _volume_ret(ctx, 50, True)


@register("mmt_bottom50VolumeRet")
def mmt_bottom50VolumeRet(ctx: DayContext):
    """Compounded return over the 50 lowest-volume bars. Ref :405-428."""
    return _volume_ret(ctx, 50, False)


@register("mmt_top20VolumeRet")
def mmt_top20VolumeRet(ctx: DayContext):
    """Compounded return over the 20 highest-volume bars. Ref :431-454."""
    return _volume_ret(ctx, 20, True)


@register("mmt_bottom20VolumeRet")
def mmt_bottom20VolumeRet(ctx: DayContext):
    """Quirk Q1 (ref :471): despite the name, uses bottom_k(50) — identical
    to mmt_bottom50VolumeRet. ``replicate_quirks=False`` uses 20."""
    return _volume_ret(ctx, 50 if ctx.replicate_quirks else 20, False)


# --- streaming readiness ----------
# sentinel-ratio kernels need a bar at one of their two sentinel slots;
# the rolling family needs a complete 50-trade-minute window (50 present
# bars is the necessary bound — ops/rolling.py validity); the
# volume-conditioned compounds exist from the first bar.
stream_requirement("mmt_pm", "sent_pm")
stream_requirement("mmt_last30", "sent_last30")
stream_requirement("mmt_am", "sent_am")
stream_requirement("mmt_between", "sent_between")
stream_requirement("mmt_paratio", "bars")
for _n in ("mmt_ols_qrs", "mmt_ols_corr_square_mean", "mmt_ols_corr_mean",
           "mmt_ols_beta_mean", "mmt_ols_beta_zscore_last"):
    stream_requirement(_n, "bars", 50)
for _n in ("mmt_top50VolumeRet", "mmt_bottom50VolumeRet",
           "mmt_top20VolumeRet", "mmt_bottom20VolumeRet"):
    stream_requirement(_n, "bars")

# --- finalize exactness classes -----
# the sentinel ratios and mmt_paratio are pure selections over their
# windows (first open / last close) — the carried selection leaves
# reproduce them BITWISE; the rolling-50 family re-prices whole trailing
# windows per bar and the volume-conditioned compounds are top-k
# rank-dependent — both stay on the batch-prefix residual.
for _n in ("mmt_pm", "mmt_last30", "mmt_am", "mmt_between",
           "mmt_paratio"):
    finalize_class(_n, "exact_fold")
for _n in ("mmt_ols_qrs", "mmt_ols_corr_square_mean", "mmt_ols_corr_mean",
           "mmt_ols_beta_mean", "mmt_ols_beta_zscore_last",
           "mmt_top50VolumeRet", "mmt_bottom50VolumeRet",
           "mmt_top20VolumeRet", "mmt_bottom20VolumeRet"):
    finalize_class(_n, "batch_only")
