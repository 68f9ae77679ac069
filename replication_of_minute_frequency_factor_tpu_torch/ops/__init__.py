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
from .ranking import bottomk_threshold, topk_threshold  # noqa: F401
from .rolling import rolling_window_stats  # noqa: F401
