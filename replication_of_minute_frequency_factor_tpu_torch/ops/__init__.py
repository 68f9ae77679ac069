"""Masked tensor ops with polars-compatible reduction semantics.

The dense ``[..., S]`` day grid carries a boolean validity mask; a cleared
lane is polars *null* (skipped by reductions), while a set lane holding NaN is
polars *NaN* (propagates through means/stds).
"""

from .masked import (  # noqa: F401
    count,
    cummax_last,
    masked_corr,
    masked_first,
    masked_kurtosis,
    masked_last,
    masked_max,
    masked_mean,
    masked_min,
    masked_product,
    masked_skew,
    masked_std,
    masked_sum,
    masked_var,
    ffill,
    pct_change_valid,
    shift_valid,
)
from .ranking import (  # noqa: F401
    bottomk_threshold,
    masked_order,
    rank_average,
    topk_sum,
    topk_threshold,
)
from .rolling import rolling_window_stats  # noqa: F401
from .segments import (  # noqa: F401
    pdf_quantile_rank,
    segment_stats_by_value,
)
from .incremental import (  # noqa: F401
    WINDOW_COUNTERS,
    init_inc,
    update_inc,
    update_inc_at,
    window_contains,
)
