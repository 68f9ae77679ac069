"""量价相关性 / price-volume correlation factors (6).

Reference: MinuteFrequentFactorCalculateMethodsCICC.py:836-932. All Pearson
over pairwise-valid bars; pct-changes and shifts run over consecutive
*present* bars (quirk Q5 for the ``.over('code')`` variants).
"""

from __future__ import annotations

from ..ops.pv_corr_cuda import NAMES
from .context import DayContext
from .registry import finalize_class, register, stream_requirement

# Each kernel reads its row of the shared ``DayContext.pv_corr``: the six
# are computed together (one launch of csrc/pv_corr.cu on the card; on the
# CPU ``ops.pv_corr_cuda.pv_corr_plain``, whose six compositions are the
# ones the docstrings below describe).


@register("corr_prv")
def corr_prv(ctx: DayContext):
    """corr(close pct-change, volume). Ref :836-847 (first bar's null pct
    drops that pair)."""
    return ctx.pv_corr[NAMES.index("corr_prv")]


@register("corr_prvr")
def corr_prvr(ctx: DayContext):
    """corr(close pct-change, volume pct-change) over nonzero-volume bars.

    Ref :850-874: zero-volume bars are removed *before* the pct-changes, so
    changes straddle the removed bars.
    """
    return ctx.pv_corr[NAMES.index("corr_prvr")]


@register("corr_pv")
def corr_pv(ctx: DayContext):
    """corr(close, volume). Ref :877-888."""
    return ctx.pv_corr[NAMES.index("corr_pv")]


@register("corr_pvd")
def corr_pvd(ctx: DayContext):
    """corr(close, volume lagged one present bar). Ref :891-902."""
    return ctx.pv_corr[NAMES.index("corr_pvd")]


@register("corr_pvl")
def corr_pvl(ctx: DayContext):
    """corr(close, volume led one present bar). Ref :905-916."""
    return ctx.pv_corr[NAMES.index("corr_pvl")]


@register("corr_pvr")
def corr_pvr(ctx: DayContext):
    """corr(close, volume pct-change) over nonzero-volume bars.
    Ref :919-932."""
    return ctx.pv_corr[NAMES.index("corr_pvr")]


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
