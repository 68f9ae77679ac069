"""高阶特征 / return- and volume-distribution shape factors (6).

Reference: MinuteFrequentFactorCalculateMethodsCICC.py:647-729. Skew is the
biased g1, kurtosis biased Fisher excess (polars defaults, quirk Q11).
"""

from __future__ import annotations

from ..ops import masked_kurtosis, masked_skew
from .context import DayContext
from .registry import register


@register("shape_skew")
def shape_skew(ctx: DayContext):
    """skew(close/open - 1). Ref :647-657."""
    return masked_skew(ctx.ret_co, ctx.mask)


@register("shape_kurt")
def shape_kurt(ctx: DayContext):
    """kurtosis(close/open - 1). Ref :660-670."""
    return masked_kurtosis(ctx.ret_co, ctx.mask)


@register("shape_skratio")
def shape_skratio(ctx: DayContext):
    """skew/kurtosis of minute returns. Ref :673-687."""
    return masked_skew(ctx.ret_co, ctx.mask) / masked_kurtosis(ctx.ret_co, ctx.mask)


@register("shape_skewVol")
def shape_skewVol(ctx: DayContext):
    """skew of volume share. Ref :690-700."""
    return masked_skew(ctx.vol_share, ctx.mask)


@register("shape_kurtVol")
def shape_kurtVol(ctx: DayContext):
    """kurtosis of volume share. Ref :703-713."""
    return masked_kurtosis(ctx.vol_share, ctx.mask)


@register("shape_skratioVol")
def shape_skratioVol(ctx: DayContext):
    """skew/kurtosis of volume share. Ref :716-729."""
    return masked_skew(ctx.vol_share, ctx.mask) / masked_kurtosis(
        ctx.vol_share, ctx.mask)
