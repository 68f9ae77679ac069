"""流动性 / liquidity factors (6).

Reference: MinuteFrequentFactorCalculateMethodsCICC.py:734-831. The
close-auction boundary is 14:57 (``145700000``, ref :770,784,812).
"""

from __future__ import annotations

import torch

from ..ops import masked_first, masked_sum
from .context import DayContext
from .registry import register

_NAN = float("nan")


@register("liq_amihud_1min")
def liq_amihud_1min(ctx: DayContext):
    """sum(|close pct-change| / volume) over bars with volume > 0.

    Ref :734-761: pct_change over consecutive present bars (quirk Q5:
    ``.over('code')`` — equivalent per-day under the one-file-per-day
    layout), null filled with 0, zero-volume bars contribute 0.
    """
    pct, ok = ctx.pct_close
    pct_abs = torch.where(ok, pct.abs(), 0.0)
    term = torch.where(ctx.mask & (ctx.volume > 0), pct_abs / ctx.volume, 0.0)
    out = term.sum(dim=-1)
    return torch.where(ctx.has_bars, out, _NAN)


@register("liq_closeprevol")
def liq_closeprevol(ctx: DayContext):
    """Total volume before 14:57. Ref :764-775 (filter-then-group: a stock
    with no pre-auction bars is absent -> NaN)."""
    sel = ctx.time_mask(hi=ctx.session.T_CLOSE_AUCTION, hi_strict=True)
    return torch.where(sel.any(dim=-1), masked_sum(ctx.volume, sel), _NAN)


@register("liq_closevol")
def liq_closevol(ctx: DayContext):
    """Total volume in the last 3 minutes (>= 14:57). Ref :778-789."""
    sel = ctx.time_mask(lo=ctx.session.T_CLOSE_AUCTION)
    return torch.where(sel.any(dim=-1), masked_sum(ctx.volume, sel), _NAN)


@register("liq_firstCallR")
def liq_firstCallR(ctx: DayContext):
    """First bar's volume / day volume (opening-auction proxy).
    Ref :792-802."""
    return masked_first(ctx.volume, ctx.mask) / ctx.vol_sum


@register("liq_lastCallR")
def liq_lastCallR(ctx: DayContext):
    """Volume share of the >= 14:57 window (filter *inside* the agg, so the
    group always exists; an empty window sums to 0). Ref :805-820."""
    sel = ctx.time_mask(lo=ctx.session.T_CLOSE_AUCTION)
    out = masked_sum(ctx.volume, sel) / ctx.vol_sum
    return torch.where(ctx.has_bars, out, _NAN)


@register("liq_openvol")
def liq_openvol(ctx: DayContext):
    """First bar's volume. Ref :823-831."""
    return masked_first(ctx.volume, ctx.mask)
