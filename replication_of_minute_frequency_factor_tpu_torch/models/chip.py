"""筹码分布 / chip (volume-at-price) distribution factors (11).

Reference: MinuteFrequentFactorCalculateMethodsCICC.py:937-1201. All build
``volume_d`` (volume share) and ``return`` (last-close / close) and group
shares by exact return value. The ``doc_pdf*`` quantile walk uses a rank
computed over the ENTIRE day frame (all stocks), not per stock — see
``DayContext.eod_ret_global_rank``. Q7's nondeterministic cumsum order is
resolved to ascending rank (ops/segments.py). The port of the JAX
package's ``models/chip.py``.

Eager torch does not merge repeated subexpressions as XLA does, so what
several factors share is memoised in the context: the segments of
(return, share) for the three moment factors, the sorted segments of
(global rank, share) for the five ``doc_pdf*``, and one ``topk_sum`` per k.
"""

from __future__ import annotations

from ..ops.ranking import topk_sum
from ..ops.segments import (
    _sorted_segments, pdf_quantile_rank, segment_stats_by_value)
from .context import DayContext
from .registry import finalize_class, register, stream_requirement


def _seg_moments(ctx: DayContext):
    return ctx._get("chip_segments", lambda: segment_stats_by_value(
        ctx.eod_ret, ctx.vol_share, ctx.mask))


def _pdf(ctx: DayContext, threshold: float):
    seg = ctx._get("chip_pdf_segments", lambda: _sorted_segments(
        ctx.eod_ret_global_rank, ctx.vol_share, ctx.mask))
    return pdf_quantile_rank(seg, threshold)


def _topk_share(ctx: DayContext, k: int):
    return ctx._get(("chip_topk_sum", k),
                    lambda: topk_sum(ctx.vol_share, ctx.mask, k))


@register("doc_kurt")
def doc_kurt(ctx: DayContext):
    """kurtosis of per-return-level volume shares. Ref :937-957."""
    return _seg_moments(ctx)[1]


@register("doc_skew")
def doc_skew(ctx: DayContext):
    """skew of per-return-level volume shares. Ref :960-980."""
    return _seg_moments(ctx)[0]


@register("doc_std")
def doc_std(ctx: DayContext):
    """Quirk Q2 (ref :998-1000): named 'std' but computes skew — identical
    to doc_skew. (No fixed variant: the reference defines no std formula.)"""
    return _seg_moments(ctx)[0]


@register("doc_pdf60")
def doc_pdf60(ctx: DayContext):
    """First global return-rank where cumulative share > 0.6. Ref :1006-1030."""
    return _pdf(ctx, 0.6)


@register("doc_pdf70")
def doc_pdf70(ctx: DayContext):
    """Threshold 0.7. Ref :1033-1057."""
    return _pdf(ctx, 0.7)


@register("doc_pdf80")
def doc_pdf80(ctx: DayContext):
    """Threshold 0.8. Ref :1060-1084."""
    return _pdf(ctx, 0.8)


@register("doc_pdf90")
def doc_pdf90(ctx: DayContext):
    """Threshold 0.9. Ref :1087-1111."""
    return _pdf(ctx, 0.9)


@register("doc_pdf95")
def doc_pdf95(ctx: DayContext):
    """Threshold 0.95. Ref :1114-1138."""
    return _pdf(ctx, 0.95)


@register("doc_vol10_ratio")
def doc_vol10_ratio(ctx: DayContext):
    """Sum of 10 largest volume shares. Ref :1141-1159."""
    return _topk_share(ctx, 10)


@register("doc_vol5_ratio")
def doc_vol5_ratio(ctx: DayContext):
    """Sum of 5 largest volume shares. Ref :1162-1180."""
    return _topk_share(ctx, 5)


@register("doc_vol50_ratio")
def doc_vol50_ratio(ctx: DayContext):
    """Quirk Q3 (ref :1195-1197): named top-50 but uses top_k(5) — identical
    to doc_vol5_ratio. ``replicate_quirks=False`` uses 50."""
    return _topk_share(ctx, 5 if ctx.replicate_quirks else 50)


# --- streaming readiness: the whole family is anchored on the
# END-OF-DAY close, so every bar retroactively reprices history — these
# kernels are the mathematically non-foldable class whose partial values
# come from the carried bar buffer, never from O(1) accumulators
# (docs/streaming.md); the group itself exists from the first bar --------
for _n in ("doc_kurt", "doc_skew", "doc_std", "doc_pdf60", "doc_pdf70",
           "doc_pdf80", "doc_pdf90", "doc_pdf95", "doc_vol10_ratio",
           "doc_vol5_ratio", "doc_vol50_ratio"):
    stream_requirement(_n, "bars")

# --- finalize exactness classes: end-of-day anchored
# (eod_ret reprices EVERY past bar when a new close arrives) plus the
# whole-frame rank / top-k selections — the canonical non-foldable
# class; every kernel here rides the batch-prefix residual ----------------
for _n in ("doc_kurt", "doc_skew", "doc_std", "doc_pdf60", "doc_pdf70",
           "doc_pdf80", "doc_pdf90", "doc_pdf95", "doc_vol10_ratio",
           "doc_vol5_ratio", "doc_vol50_ratio"):
    finalize_class(_n, "batch_only")
