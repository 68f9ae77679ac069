"""资金成交 / trade-flow factors (8).

Reference: MinuteFrequentFactorCalculateMethodsCICC.py:1206-1406. The
"bottom" pair filters to the tail window first, so volume shares are within
that window (with the reference's odd +1 / ==0 denominator guards, quirk
Q5's ``.over('code')`` being per-day-equivalent); the head/tail ratios use a
0.125 fallback for zero-volume days (ref :1273,:1302).
"""

from __future__ import annotations

import torch

from ..ops import masked_mean, masked_sum
from .context import DayContext
from .registry import finalize_class, register, stream_requirement

_NAN = float("nan")


@register("trade_bottom20retRatio")
def trade_bottom20retRatio(ctx: DayContext):
    """sum(ret * volume/(window volume + 1)) over bars >= 14:40.
    Ref :1206-1224."""
    sel = ctx.time_mask(lo=ctx.session.T_TAIL20)
    denom = masked_sum(ctx.volume, sel) + 1.0
    term = ctx.ret_co * ctx.volume / denom[..., None]
    out = masked_sum(term, sel)
    return torch.where(sel.any(dim=-1), out, _NAN)


@register("trade_bottom50retRatio")
def trade_bottom50retRatio(ctx: DayContext):
    """Same over bars >= 14:10, denominator max(window volume, 1-if-zero).
    Ref :1227-1248."""
    sel = ctx.time_mask(lo=ctx.session.T_TAIL50)
    s = masked_sum(ctx.volume, sel)
    denom = torch.where(s == 0.0, 1.0, s)
    term = ctx.ret_co * ctx.volume / denom[..., None]
    out = masked_sum(term, sel)
    return torch.where(sel.any(dim=-1), out, _NAN)


def _window_over_total(ctx: DayContext, sel):
    """window volume / day volume with the 0.125 zero-day fallback."""
    win = masked_sum(ctx.volume, sel)
    total = ctx.vol_sum
    out = torch.where(total > 0.0, win / total, 0.125)
    return torch.where(ctx.has_bars, out, _NAN)


@register("trade_headRatio")
def trade_headRatio(ctx: DayContext):
    """Volume share of bars <= 10:00. Ref :1251-1277."""
    return _window_over_total(ctx, ctx.time_mask(hi=ctx.session.T_HEAD_END))


@register("trade_tailRatio")
def trade_tailRatio(ctx: DayContext):
    """Volume share of bars >= 14:30. Ref :1280-1306."""
    return _window_over_total(ctx, ctx.time_mask(lo=ctx.session.T_LAST30_OPEN))


def _ret_over_share(ctx: DayContext, t_hi: int, sign: int):
    """mean(f(ret) / window volume share) over bars <= t_hi.

    sign=0: plain ret (ref :1309-1350); sign=-1: |ret| where ret<0 else 0
    (:1353-1378); sign=+1: ret where ret>0 else 0 (:1381-1406). Zero-volume
    bars divide by a zero share, propagating inf/NaN exactly as the
    reference does.
    """
    sel = ctx.time_mask(hi=t_hi)
    share = ctx.volume / masked_sum(ctx.volume, sel)[..., None]
    ret = ctx.ret_co
    if sign == -1:
        num = torch.where(ret < 0, ret.abs(), 0.0)
    elif sign == 1:
        num = torch.where(ret > 0, ret.abs(), 0.0)
    else:
        num = ret
    return masked_mean(num / share, sel)


@register("trade_top20retRatio")
def trade_top20retRatio(ctx: DayContext):
    """mean(ret / volume share) over bars <= 09:50. Ref :1309-1328."""
    return _ret_over_share(ctx, ctx.session.T_TOP20_END, 0)


@register("trade_top50retRatio")
def trade_top50retRatio(ctx: DayContext):
    """mean(ret / volume share) over bars <= 10:20. Ref :1331-1350."""
    return _ret_over_share(ctx, ctx.session.T_TOP50_END, 0)


@register("trade_topNeg20retRatio")
def trade_topNeg20retRatio(ctx: DayContext):
    """Negative-return variant over bars <= 09:50. Ref :1353-1378."""
    return _ret_over_share(ctx, ctx.session.T_TOP20_END, -1)


@register("trade_topPos20retRatio")
def trade_topPos20retRatio(ctx: DayContext):
    """Positive-return variant over bars <= 09:50. Ref :1381-1406."""
    return _ret_over_share(ctx, ctx.session.T_TOP20_END, 1)


# --- streaming readiness: each window kernel waits for its
# own window's first bar; the day-share ratios exist with the day -------
stream_requirement("trade_bottom20retRatio", "tail20")
stream_requirement("trade_bottom50retRatio", "tail50")
stream_requirement("trade_headRatio", "bars")
stream_requirement("trade_tailRatio", "bars")
stream_requirement("trade_top20retRatio", "top20")
stream_requirement("trade_top50retRatio", "top50")
stream_requirement("trade_topNeg20retRatio", "top20")
stream_requirement("trade_topPos20retRatio", "top20")

# --- finalize exactness classes: the head/tail volume
# shares and the bottom-window ret·vol sums fold per bar (windowed f32
# sums); the top* mean(ret/share) family divides per-bar returns by a
# per-bar share whose zero-volume lanes must reproduce the reference's
# inf/NaN propagation exactly — that division stays on the batch
# residual rather than risking a folded inf/NaN mismatch -----------------
for _n in ("trade_bottom20retRatio", "trade_bottom50retRatio",
           "trade_headRatio", "trade_tailRatio"):
    finalize_class(_n, "stat_fold")
for _n in ("trade_top20retRatio", "trade_top50retRatio",
           "trade_topNeg20retRatio", "trade_topPos20retRatio"):
    finalize_class(_n, "batch_only")
