"""Device-side evaluation ops: per-date cross-sectional statistics.

The hot loop of evaluation (reference Factor.py:172-182, :284-292) is a
reduction *across tickers for every date* of dense ``[dates, tickers]``
matrices (SURVEY.md §3.2). The JAX package ``vmap``s one date's function
over the date axis; here every op is batched over the leading axes and
reduces along the last, on the tensors' device. None of this is a Pallas
kernel in the JAX package, so none is a hand-written kernel here: every
op is an ordinary torch op.

The quantile labels must be bitwise the JAX package's, because a level or
an edge one ulp off moves a lane that ties it into the next bucket:

* the levels are ``jnp.linspace(0, 1, g + 1)``'s f32 bits, which are
  ``i * f32(1/g)`` (``torch.linspace`` and ``np.linspace(...).astype(f32)``
  differ from them in one or more levels at g = 3, 6, 7, 10, ...);
* the edges are numpy's two-sided lerp written as separate eager ops,
  never ``torch.lerp``/``addcmul``/``torch.compile``, which may fuse a
  product and a sum into one FMA on the card and round once instead of
  twice.
"""

from __future__ import annotations

import numpy as np
import torch

from . import pins
from .ops import masked_corr, rank_average
from .ops.ranking import _canonical_key

_NAN = float("nan")


def ic_series(exposure, fwd_ret, valid):
    """Per-date Pearson IC and Spearman rank-IC.

    exposure, fwd_ret: ``[dates, tickers]`` f32; valid: both present and
    non-NaN (reference drops NaN exposures before correlating,
    Factor.py:167-169). Returns ``(ic [dates], rank_ic [dates])`` — NaN
    where a date has <2 valid tickers or zero variance.
    """
    ic = masked_corr(exposure, fwd_ret, valid)
    rx = rank_average(exposure, valid)
    ry = rank_average(fwd_ret, valid)
    # rank_average leaves NaN outside ``valid``; neutralise before corr
    rank_ic = masked_corr(torch.where(valid, rx, 0.0),
                          torch.where(valid, ry, 0.0), valid)
    return ic, rank_ic


def qcut_labels(exposure, valid, group_num: int, nan_lanes=None):
    """Per-date quantile-bucket labels 0..group_num-1 (NaN-safe), int32.

    Matches polars ``qcut(group_num, allow_duplicates=True)`` over each date
    (Factor.py:284-292): bucket edges are the linear-interpolated quantiles
    of that date's valid exposures; duplicate edges collapse (a value never
    lands in an empty duplicate bucket because the count of edges below it
    is right-continuous). Invalid lanes get -1.

    ``nan_lanes`` marks lanes whose exposure is a value-NaN (present but
    not finite). Under the default ``pins.READINGS['qcut_nan'] ==
    'exclude'`` reading they stay -1 (excluded, like the shim's
    NaN->null); under the alternative ``'top_bin'`` reading they join
    the last bucket, polars' total-float-order possibility the
    reference's unfiltered group_test would expose (Factor.py:280-292).
    """
    lab = _qcut_labels(exposure, valid, group_num)
    if nan_lanes is not None and pins.reading("qcut_nan") == "top_bin":
        lab = torch.where(nan_lanes.to(lab.device), group_num - 1, lab)
    return lab


def quantile_levels(group_num: int, device=None):
    """The interior levels ``jnp.linspace(0, 1, group_num + 1)[1:-1]`` as
    f32, bit for bit: ``i * f32(1 / group_num)``, one f32 product each,
    made on the device (no copy from the host, which would wait)."""
    step = float(np.float32(1.0 / group_num))
    return torch.arange(1, group_num, dtype=torch.float32,
                        device=device) * step


def _qcut_labels(exposure, valid, group_num: int):
    """The labels of :func:`qcut_labels` without the NaN-lane reading: the
    JAX package's ``_qcut_labels_jit``, over every date at once."""
    qs = quantile_levels(group_num, exposure.device)
    n = valid.sum(dim=-1)
    # quantiles over valid lanes via sorted gather at fractional index; the
    # stable integer sort of jnp.argsort's key order (-0 ties +0, invalid
    # lanes sort last as +inf), so the gathered values are the JAX bits
    key = _canonical_key(torch.where(valid, exposure, float("inf")))
    order = torch.sort(key, dim=-1, stable=True).indices
    sx = torch.gather(torch.where(valid, exposure, 0.0), -1, order)
    pos = qs * (n - 1).clamp(min=0).to(torch.float32)[..., None]
    lo = torch.floor(pos).to(torch.int64)
    hi = torch.ceil(pos).to(torch.int64)
    frac = pos - lo.to(torch.float32)
    s_lo = torch.gather(sx, -1, lo)
    s_hi = torch.gather(sx, -1, hi)
    # np.quantile's exact _lerp, branch included: a + t*(b-a) below
    # t=0.5, b - (b-a)*(1-t) at or above (fuzz seed 6290: the two-product
    # form put a [-0.1, -0.1] cross-section's edge one ulp below the tied
    # value). One op each, so no product is fused into a sum.
    d = s_hi - s_lo
    upper = s_hi - d * (1.0 - frac)
    lower = s_lo + frac * d
    edges = torch.where(frac >= 0.5, upper, lower)
    # right-closed buckets like polars/pandas qcut: x <= edge_i -> bucket i
    lab = (exposure[..., None] > edges[..., None, :]).sum(
        dim=-1, dtype=torch.int32)
    return torch.where(valid & (n > 0)[..., None], lab, -1)


def coverage_counts(valid):
    """Per-date count of usable exposures (Factor.py:92-105), int32."""
    return valid.sum(dim=-1, dtype=torch.int32)


def decile_spread(exposure, fwd_ret, valid, group_num: int = 5):
    """Per-date long-short spread of the exposure's quantile buckets.

    ``exposure``/``fwd_ret``/``valid``: ``[dates, tickers]``. Buckets come
    from :func:`_qcut_labels` (the qcut core, reused, so a backtest's
    buckets can never drift from the group test's); the spread is
    ``mean(fwd_ret | top bucket) - mean(fwd_ret | bottom bucket)`` per
    date, NaN where either end bucket is empty.
    """
    labels = _qcut_labels(exposure, valid, group_num)              # [D, T]
    onehot = labels[..., None] == torch.arange(group_num,
                                               device=labels.device)
    okr = onehot & (valid & torch.isfinite(fwd_ret))[..., None]    # [D,T,G]
    n = okr.sum(dim=-2, dtype=torch.int32)                         # [D, G]
    s = torch.where(okr, fwd_ret[..., None], 0.0).sum(dim=-2)
    mean_ret = torch.where(n > 0, s / n.clamp(min=1), _NAN)
    return mean_ret[..., -1] - mean_ret[..., 0]                    # [D]
