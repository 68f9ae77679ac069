"""Masked reductions along the last axis, matching polars defaults.

Conventions (SURVEY.md §2.5 Q11):
  * null == masked-out lane: skipped by sum/mean/std/skew/kurtosis/corr;
  * NaN inside a valid lane propagates (polars treats NaN as a float value);
  * ``std``/``var`` default ``ddof=1``; result is null (NaN here) when
    ``n <= ddof``;
  * ``skew`` is the biased Fisher-Pearson g1 = m3 / m2^1.5;
  * ``kurtosis`` is biased Fisher excess = m4 / m2^2 - 3;
  * ``corr`` is Pearson over pairwise-valid lanes.

All functions broadcast over leading dims and reduce the trailing axis, so the
same code serves ``[S]``, ``[T, S]`` and ``[D, T, S]`` tensors. Central
moments use the two-pass (subtract-mean) form for f32 stability. The port of
the JAX package's ``ops/masked.py``: counts and selections are bitwise the
JAX package's, f32 moments agree to rounding (tests/test_torch_masked.py).
"""

from __future__ import annotations

import torch

from .. import pins

_NAN = float("nan")


def cummax_last(a):
    """Running max along the last axis."""
    return torch.cummax(a, dim=-1).values


def count(mask):
    return mask.sum(dim=-1)


def masked_sum(x, mask):
    return torch.where(mask, x, 0.0).sum(dim=-1)


def masked_mean(x, mask):
    return _mean(x, mask, count(mask))


def _mean(x, mask, n):
    return torch.where(n > 0, masked_sum(x, mask) / n.clamp(min=1), _NAN)


def masked_moments(x, mask, n=None, orders=(2, 3, 4)):
    """``(n, mean, sums)``: the count of ``mask``'s lanes (``count(mask)``
    unless given), the mean of ``x`` over them (NaN where there are none)
    and ``sums[k]``, the sum of their central powers of each order ``k``
    in ``orders`` (2, 3 or 4). The two-pass moment pass that
    :func:`var_of`, :func:`skew_of` and :func:`kurtosis_of` finish.

    The powers are products of ``d*d``: torch's pow by 2 and by 3 is
    ``d*d`` and ``d*d*d`` on the CPU and the card alike, and the fourth is
    ``(d*d)*(d*d)``, the repeated squaring jnp's integer power lowers to
    (torch's CPU ``pow(d, 4)`` runs the vector pow on whole 32-lane chunks
    and the scalar pow on the rest, so its bits would follow the tensor's
    length: a rank's ticker block vs the whole batch)."""
    if n is None:
        n = count(mask)
    mu = _mean(x, mask, n)
    d = torch.where(mask, x - mu[..., None], 0.0)
    d2 = d * d
    return n, mu, {k: (d2 if k == 2 else d2 * (d if k == 3 else d2)).sum(
        dim=-1) for k in orders}


def var_of(moments, ddof: int = 1):
    """The variance from :func:`masked_moments` (with order 2); NaN where
    the count is at most ``ddof``."""
    n, _, s = moments
    denom = (n - ddof).clamp(min=1)
    return torch.where(n > ddof, s[2] / denom, _NAN)


def skew_of(moments):
    """Biased Fisher-Pearson g1 from :func:`masked_moments` (with orders
    2 and 3); NaN where the count is 0."""
    n, _, s = moments
    nn = n.clamp(min=1)
    m2 = s[2] / nn
    m3 = s[3] / nn
    # m2^1.5 as m2 * sqrt(m2): both correctly rounded on every path, where
    # torch's CPU pow(m2, 1.5) differs between its vector and scalar
    # paths, so its bits would follow the tensor's length
    g1 = m3 / (m2 * torch.sqrt(m2))  # m2 == 0 -> NaN/inf, as polars
    return torch.where(n > 0, g1, _NAN)


def kurtosis_of(moments):
    """Biased Fisher excess kurtosis from :func:`masked_moments` (with
    orders 2 and 4); NaN where the count is 0."""
    n, _, s = moments
    nn = n.clamp(min=1)
    m2 = s[2] / nn
    m4 = s[4] / nn
    g2 = m4 / (m2 * m2) - 3.0
    return torch.where(n > 0, g2, _NAN)


def masked_var(x, mask, ddof: int = 1):
    return var_of(masked_moments(x, mask, orders=(2,)), ddof)


def masked_std(x, mask, ddof: int = 1):
    return torch.sqrt(masked_var(x, mask, ddof=ddof))


def masked_skew(x, mask):
    """Biased Fisher-Pearson g1 (polars ``Expr.skew(bias=True)`` default)."""
    return skew_of(masked_moments(x, mask, orders=(2, 3)))


def masked_kurtosis(x, mask):
    """Biased Fisher excess kurtosis (polars ``Expr.kurtosis()`` default)."""
    return kurtosis_of(masked_moments(x, mask, orders=(2, 4)))


def masked_corr(x, y, mask):
    """Pearson correlation over pairwise-valid lanes (polars ``pl.corr``).

    Both series are anchored to their first valid value before the moment
    pass: correlation is shift-invariant, and the anchoring makes a
    constant series yield *exactly* zero variance in f32 (hence NaN, as the
    f64 oracle) instead of rounding noise posing as signal. This is the
    production side of the ``constant_window`` pin (pins.py): under the
    ``"noise"`` reading the anchor is skipped.
    """
    n = count(mask)
    if pins.reading("constant_window") == "degenerate":
        x = x - masked_first(x, mask)[..., None]
        y = y - masked_first(y, mask)[..., None]
    mx = masked_mean(x, mask)
    my = masked_mean(y, mask)
    dx = torch.where(mask, x - mx[..., None], 0.0)
    dy = torch.where(mask, y - my[..., None], 0.0)
    cov = (dx * dy).sum(dim=-1)
    vx = (dx * dx).sum(dim=-1)
    vy = (dy * dy).sum(dim=-1)
    r = cov / torch.sqrt(vx * vy)  # zero variance -> NaN, as polars
    return torch.where(n > 1, r, _NAN)


def masked_product(x, mask):
    return torch.where(mask, x, 1.0).prod(dim=-1)


def masked_min(x, mask):
    n = count(mask)
    m = torch.where(mask, x, float("inf")).amin(dim=-1)
    return torch.where(n > 0, m, _NAN)


def masked_max(x, mask):
    n = count(mask)
    m = torch.where(mask, x, float("-inf")).amax(dim=-1)
    return torch.where(n > 0, m, _NAN)


def _first_valid_index(mask):
    # argmax is not implemented for bool on every device; on ties it
    # returns the first maximal index, which is what this relies on
    return mask.to(torch.uint8).argmax(dim=-1)


def _last_valid_index(mask):
    L = mask.shape[-1]
    return L - 1 - _first_valid_index(mask.flip(-1))


def masked_first(x, mask):
    """Value at the first valid lane (polars ``.first()`` on the group)."""
    idx = _first_valid_index(mask)
    v = torch.gather(x, -1, idx[..., None])[..., 0]
    return torch.where(count(mask) > 0, v, _NAN)


def masked_last(x, mask):
    idx = _last_valid_index(mask)
    v = torch.gather(x, -1, idx[..., None])[..., 0]
    return torch.where(count(mask) > 0, v, _NAN)


def _last_valid_so_far(mask):
    """Index of the last valid lane at or before each lane; -1 before the
    first valid lane."""
    idx = torch.arange(mask.shape[-1], device=mask.device)
    return cummax_last(torch.where(mask, idx, -1))


def ffill(x, mask):
    """Forward-fill values over invalid lanes (last valid value so far).

    Lanes before the first valid lane are left as NaN. Returns
    ``(filled, has_prev)`` where ``has_prev[..., i]`` says lane i has seen at
    least one valid lane at or before i.
    """
    last_valid = _last_valid_so_far(mask)
    has_prev = last_valid >= 0
    filled = torch.gather(x, -1, last_valid.clamp(min=0))
    return torch.where(has_prev, filled, _NAN), has_prev


def shift_valid(x, mask, periods: int = 1):
    """Shift over the *valid* lanes only — the dense-grid analogue of polars
    ``shift(periods)`` on a group whose rows are the present bars in slot
    order. Returns ``(values, out_mask)``: for ``periods=1`` each valid lane
    receives the previous valid lane's value (null at the first valid lane).

    Only |periods| == 1 is needed by the reference kernels.
    """
    if periods == 0:
        return x, mask
    if periods > 0:
        if periods != 1:
            raise NotImplementedError("only |periods| <= 1 supported")
        last_valid = _last_valid_so_far(mask)
        # previous valid index *strictly before* lane i
        prev = torch.cat(
            [torch.full_like(last_valid[..., :1], -1), last_valid[..., :-1]],
            dim=-1)
        ok = mask & (prev >= 0)
        vals = torch.gather(x, -1, prev.clamp(min=0))
        return torch.where(ok, vals, _NAN), ok
    if periods != -1:
        raise NotImplementedError("only |periods| <= 1 supported")
    rx, rm = shift_valid(x.flip(-1), mask.flip(-1), 1)
    return rx.flip(-1), rm.flip(-1)


def pct_change_valid(x, mask):
    """Percent change over consecutive *valid* lanes (polars
    ``pct_change()`` within a group of present bars). Null at the first
    valid lane. Returns ``(values, out_mask)``.

    Uses (x - prev)/prev for f32 accuracy (see ``DayContext.ret_co``)."""
    prev, ok = shift_valid(x, mask, 1)
    vals = (x - prev) / prev
    return torch.where(ok, vals, _NAN), ok
