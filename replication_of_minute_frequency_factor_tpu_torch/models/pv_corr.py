"""量价相关性 / price-volume correlation factors (6).

Reference: MinuteFrequentFactorCalculateMethodsCICC.py:836-932. All Pearson
over pairwise-valid bars; pct-changes and shifts run over consecutive
*present* bars (quirk Q5 for the ``.over('code')`` variants).
"""

from __future__ import annotations

from ..ops import masked_corr, pct_change_valid, shift_valid
from .context import DayContext
from .registry import finalize_class, register, stream_requirement


@register("corr_prv")
def corr_prv(ctx: DayContext):
    """corr(close pct-change, volume). Ref :836-847 (first bar's null pct
    drops that pair)."""
    pct, ok = ctx.pct_close
    return masked_corr(pct, ctx.volume, ok)


@register("corr_prvr")
def corr_prvr(ctx: DayContext):
    """corr(close pct-change, volume pct-change) over nonzero-volume bars.

    Ref :850-874: zero-volume bars are removed *before* the pct-changes, so
    changes straddle the removed bars.
    """
    base = ctx.mask & (ctx.volume != 0)
    pc, ok_c = pct_change_valid(ctx.close, base)
    pv, ok_v = pct_change_valid(ctx.volume, base)
    return masked_corr(pc, pv, ok_c & ok_v)


@register("corr_pv")
def corr_pv(ctx: DayContext):
    """corr(close, volume). Ref :877-888."""
    return masked_corr(ctx.close, ctx.volume, ctx.mask)


@register("corr_pvd")
def corr_pvd(ctx: DayContext):
    """corr(close, volume lagged one present bar). Ref :891-902."""
    v, ok = shift_valid(ctx.volume, ctx.mask, 1)
    return masked_corr(ctx.close, v, ok)


@register("corr_pvl")
def corr_pvl(ctx: DayContext):
    """corr(close, volume led one present bar). Ref :905-916."""
    v, ok = shift_valid(ctx.volume, ctx.mask, -1)
    return masked_corr(ctx.close, v, ok)


@register("corr_pvr")
def corr_pvr(ctx: DayContext):
    """corr(close, volume pct-change) over nonzero-volume bars.
    Ref :919-932."""
    base = ctx.mask & (ctx.volume != 0)
    pv, ok = pct_change_valid(ctx.volume, base)
    return masked_corr(ctx.close, pv, ok)


# --- streaming readiness: Pearson needs >1 pairwise-valid
# lane; the shift/pct variants lose their first present bar, so they
# need a third -----------------------------------------------------------
stream_requirement("corr_pv", "bars", 2)
for _n in ("corr_prv", "corr_prvr", "corr_pvd", "corr_pvl", "corr_pvr"):
    stream_requirement(_n, "bars", 3)

# --- finalize exactness classes: Pearson over
# first-valid-anchored series (the constant_window pin's production
# side) — the anchor subtracts a day-level selection from every bar,
# and the raw-moment cancellation a streamed co-moment fold would rely
# on is exactly the f32 noise the anchor exists to kill; the family
# stays on the batch residual deliberately --------------------------------
for _n in ("corr_pv", "corr_prv", "corr_prvr", "corr_pvd", "corr_pvl",
           "corr_pvr"):
    finalize_class(_n, "batch_only")
