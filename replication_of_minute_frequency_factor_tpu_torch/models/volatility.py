"""波动率 / volatility factors (7).

Reference: MinuteFrequentFactorCalculateMethodsCICC.py:485-642. All are
``std(ddof=1)`` reductions; the up/down variants null-mask the opposite-sign
bars and ``fill_null(0)`` the degenerate (<2 bar) std.
"""

from __future__ import annotations

import torch

from ..ops import masked_moments, masked_std, var_of
from .context import DayContext
from .registry import finalize_class, register, stream_requirement

_NAN = float("nan")


@register("vol_volume1min")
def vol_volume1min(ctx: DayContext):
    """std of minute volume. Ref :485-496."""
    return masked_std(ctx.volume, ctx.mask)


@register("vol_range1min")
def vol_range1min(ctx: DayContext):
    """std of high/low. Ref :499-515."""
    return masked_std(ctx.range_hl, ctx.mask)


@register("vol_return1min")
def vol_return1min(ctx: DayContext):
    """std of close/open - 1. Ref :518-534."""
    return _return_std(ctx)


def _return_std(ctx: DayContext):
    """std of close/open - 1, memoised: vol_return1min's value and the
    up/down ratios' denominator, from the moment pass of ``ret_co`` that
    the shape factors read."""
    return ctx._get("ret_co_std",
                    lambda: torch.sqrt(var_of(ctx.moments("ret_co"))))


def _signed_vol(ctx: DayContext, positive: bool):
    """std of same-sign returns, null->0 (ref fill_null at :557,611),
    memoised: the up/down vol and its ratio read one.

    The group exists whenever the stock traded at all, so <2 same-sign bars
    gives 0, while an absent stock gives NaN.
    """
    def f():
        ret = ctx.ret_co
        sel = ctx.mask & ((ret > 0) if positive else (ret < 0))
        mo = n_sel, _, _ = masked_moments(ret, sel, orders=(2,))
        out = torch.where(n_sel < 2, 0.0, torch.sqrt(var_of(mo)))
        return torch.where(ctx.has_bars, out, _NAN)
    return ctx._get(("signed_vol", "up" if positive else "down"), f)


@register("vol_upVol")
def vol_upVol(ctx: DayContext):
    """Upside volatility. Ref :537-560."""
    return _signed_vol(ctx, True)


@register("vol_upRatio")
def vol_upRatio(ctx: DayContext):
    """Upside volatility / total volatility. Ref :563-588."""
    return _signed_vol(ctx, True) / _return_std(ctx)


@register("vol_downVol")
def vol_downVol(ctx: DayContext):
    """Downside volatility. Ref :591-614."""
    return _signed_vol(ctx, False)


@register("vol_downRatio")
def vol_downRatio(ctx: DayContext):
    """Downside volatility / total volatility. Ref :617-642."""
    return _signed_vol(ctx, False) / _return_std(ctx)


# --- streaming readiness ----------------------------------------
# ddof=1 reductions are NaN below 2 bars; the signed variants clamp the
# degenerate case to 0 and only need the group to exist.
for _n in ("vol_volume1min", "vol_range1min", "vol_return1min",
           "vol_upRatio", "vol_downRatio"):
    stream_requirement(_n, "bars", 2)
for _n in ("vol_upVol", "vol_downVol"):
    stream_requirement(_n, "bars")

# --- finalize exactness classes: every std here is a
# second central moment of a per-bar series (volume, high/low,
# close/open-1, the signed-return subsets) — all fold per bar as
# streamed Welford statistics (ops/incremental.py), f32-bounded per
# factor by stream.fastpath.STAT_FOLD_BOUNDS ----------------------------
for _n in ("vol_volume1min", "vol_range1min", "vol_return1min",
           "vol_upVol", "vol_upRatio", "vol_downVol", "vol_downRatio"):
    finalize_class(_n, "stat_fold")
