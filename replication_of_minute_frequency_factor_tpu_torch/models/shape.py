"""高阶特征 / return- and volume-distribution shape factors (6).

Reference: MinuteFrequentFactorCalculateMethodsCICC.py:647-729. Skew is the
biased g1, kurtosis biased Fisher excess (polars defaults, quirk Q11).
"""

from __future__ import annotations

from ..ops import kurtosis_of, skew_of
from .context import DayContext
from .registry import finalize_class, register, stream_requirement


@register("shape_skew")
def shape_skew(ctx: DayContext):
    """skew(close/open - 1). Ref :647-657."""
    return skew_of(ctx.moments("ret_co"))


@register("shape_kurt")
def shape_kurt(ctx: DayContext):
    """kurtosis(close/open - 1). Ref :660-670."""
    return kurtosis_of(ctx.moments("ret_co"))


@register("shape_skratio")
def shape_skratio(ctx: DayContext):
    """skew/kurtosis of minute returns. Ref :673-687."""
    m = ctx.moments("ret_co")
    return skew_of(m) / kurtosis_of(m)


@register("shape_skewVol")
def shape_skewVol(ctx: DayContext):
    """skew of volume share. Ref :690-700."""
    return skew_of(ctx.moments("vol_share"))


@register("shape_kurtVol")
def shape_kurtVol(ctx: DayContext):
    """kurtosis of volume share. Ref :703-713."""
    return kurtosis_of(ctx.moments("vol_share"))


@register("shape_skratioVol")
def shape_skratioVol(ctx: DayContext):
    """skew/kurtosis of volume share. Ref :716-729."""
    m = ctx.moments("vol_share")
    return skew_of(m) / kurtosis_of(m)


# --- streaming readiness: moments exist with the group (one
# bar already yields the 0/0 NaN the reference computes, not a gap) ----
for _n in ("shape_skew", "shape_kurt", "shape_skratio", "shape_skewVol",
           "shape_kurtVol", "shape_skratioVol"):
    stream_requirement(_n, "bars")

# --- finalize exactness classes: g1/g2 are ratios of central
# moments, streamed per bar as Welford M2/M3/M4 statistics. The *Vol
# variants exploit scale invariance — skew/kurtosis of vol_share =
# volume/vol_sum equal those of raw volume (and the zero-volume day
# degenerates to the same 0/0 NaN) — so the raw volume moments suffice.
for _n in ("shape_skew", "shape_kurt", "shape_skratio", "shape_skewVol",
           "shape_kurtVol", "shape_skratioVol"):
    finalize_class(_n, "stat_fold")
