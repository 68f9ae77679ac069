"""The port's masked reductions and top-k thresholds vs the JAX
package's, on the same random masked inputs: all-masked rows, rows with
n <= ddof, and NaN/±inf in valid lanes included.

Counts and selections (min/max/first/last, ffill, shifts, pct-change,
cummax, the top-k thresholds) must be bitwise equal. Sums and moments
are f32 reductions that the two frameworks take in different orders, so
they are held at a few ulps of the row's scale: |diff| <= 8 eps * s,
with s the row's sum of |terms| (mean/sum), or at rtol 2e-5 for the
scale-free moments (std, skew, kurtosis, corr) on rows of <= 40 finite
O(1) values; NaN positions must match exactly everywhere.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from replication_of_minute_frequency_factor_tpu.ops import masked as jm
from replication_of_minute_frequency_factor_tpu.ops import ranking as jr
from replication_of_minute_frequency_factor_tpu_torch.ops import masked as tm
from replication_of_minute_frequency_factor_tpu_torch.ops import ranking as tr

EPS = float(np.finfo(np.float32).eps)
ROWS, L = 10, 40


@pytest.fixture(scope="module", params=["clean", "nonfinite"])
def data(request):
    rng = np.random.default_rng(20 if request.param == "clean" else 21)
    x = rng.normal(0, 1, (ROWS, L)).astype(np.float32)
    y = (0.5 * x + rng.normal(0, 1, (ROWS, L))).astype(np.float32)
    mask = rng.random((ROWS, L)) < 0.7
    mask[0] = True            # fully valid row
    mask[1] = False           # empty row
    mask[2] = False           # one valid lane: n <= ddof
    mask[2, 7] = True
    mask[3] = False           # two valid lanes
    mask[3, [4, 30]] = True
    x[4, 0] = 123.0           # garbage in an invalid lane never leaks
    mask[4, 0] = False
    if request.param == "nonfinite":
        x[5, 3], mask[5, 3] = np.nan, True
        x[6, 9], mask[6, 9] = np.inf, True
        x[7, 1], mask[7, 1] = -np.inf, True
        x[8, [2, 5]], mask[8, [2, 5]] = (np.inf, -np.inf), True
        y[9, 11], mask[9, 11] = np.nan, True
    return x, y, mask


def _both(fn_t, fn_j, *arrays, **kw):
    t = fn_t(*(torch.from_numpy(a) for a in arrays), **kw)
    j = fn_j(*(jnp.asarray(a) for a in arrays), **kw)
    if isinstance(t, tuple):
        return ([v.numpy() for v in t], [np.asarray(v) for v in j])
    return t.numpy(), np.asarray(j)


def _bitwise(a, b):
    assert a.dtype == b.dtype or (a.dtype.kind == b.dtype.kind == "i")
    np.testing.assert_array_equal(a, b)
    if a.dtype.kind == "f":
        np.testing.assert_array_equal(np.signbit(a), np.signbit(b))


SELECTIONS = {
    "count": (tm.count, jm.count, 1),
    "masked_min": (tm.masked_min, jm.masked_min, 2),
    "masked_max": (tm.masked_max, jm.masked_max, 2),
    "masked_first": (tm.masked_first, jm.masked_first, 2),
    "masked_last": (tm.masked_last, jm.masked_last, 2),
    "ffill": (tm.ffill, jm.ffill, 2),
    "pct_change_valid": (tm.pct_change_valid, jm.pct_change_valid, 2),
}


@pytest.mark.parametrize("name", sorted(SELECTIONS))
def test_selections_bitwise(data, name):
    x, _, mask = data
    fn_t, fn_j, n_args = SELECTIONS[name]
    t, j = _both(fn_t, fn_j, *((mask,) if n_args == 1 else (x, mask)))
    for a, b in (zip(t, j) if isinstance(t, list) else [(t, j)]):
        _bitwise(a, b)


@pytest.mark.parametrize("periods", [-1, 0, 1])
def test_shift_valid_bitwise(data, periods):
    x, _, mask = data
    t, j = _both(tm.shift_valid, jm.shift_valid, x, mask, periods=periods)
    for a, b in zip(t, j):
        _bitwise(a, b)


def test_cummax_last_bitwise(data):
    x, _, mask = data
    idx = np.where(mask, np.arange(L), -1).astype(np.int32)
    for a in (idx, np.where(mask, x, -np.inf).astype(np.float32)):
        _bitwise(*_both(tm.cummax_last, jm.cummax_last, a))


def _row_scale(x, mask, k=1):
    return np.sum(np.where(mask, np.abs(x.astype(np.float64)) ** k, 0.0),
                  axis=-1)


def test_sum_and_mean_within_ulps(data):
    x, _, mask = data
    n = np.maximum(mask.sum(-1), 1)
    for fn_t, fn_j, scale in (
            (tm.masked_sum, jm.masked_sum, _row_scale(x, mask)),
            (tm.masked_mean, jm.masked_mean, _row_scale(x, mask) / n)):
        t, j = _both(fn_t, fn_j, x, mask)
        np.testing.assert_array_equal(np.isnan(t), np.isnan(j))
        fin = np.isfinite(j)
        np.testing.assert_array_equal(t[~fin], j[~fin])
        assert np.all(np.abs(t[fin] - j[fin]) <= 8 * EPS * scale[fin])


@pytest.mark.parametrize("name,kw", [
    ("masked_var", {"ddof": 0}), ("masked_var", {"ddof": 1}),
    ("masked_std", {"ddof": 0}), ("masked_std", {"ddof": 1}),
    ("masked_skew", {}), ("masked_kurtosis", {})])
def test_moments_close(data, name, kw):
    x, _, mask = data
    t, j = _both(getattr(tm, name), getattr(jm, name), x, mask, **kw)
    np.testing.assert_array_equal(np.isnan(t), np.isnan(j))
    np.testing.assert_array_equal(np.isinf(t), np.isinf(j))
    fin = np.isfinite(j)
    np.testing.assert_allclose(t[fin], j[fin], rtol=2e-5, atol=0)


def test_corr_and_product_close(data):
    x, y, mask = data
    t, j = _both(tm.masked_corr, jm.masked_corr, x, y, mask)
    np.testing.assert_array_equal(np.isnan(t), np.isnan(j))
    np.testing.assert_allclose(t[~np.isnan(j)], j[~np.isnan(j)], rtol=2e-5,
                               atol=4 * EPS)
    g = (1.0 + 0.01 * x).astype(np.float32)
    t, j = _both(tm.masked_product, jm.masked_product, g, mask)
    np.testing.assert_array_equal(np.isnan(t), np.isnan(j))
    fin = np.isfinite(j)
    # a product of n factors rounds n times: <= n ulps apart
    np.testing.assert_allclose(t[fin], j[fin], rtol=L * EPS, atol=0)


def test_corr_constant_series_is_nan_under_both_pins():
    from replication_of_minute_frequency_factor_tpu import pins as jpins
    from replication_of_minute_frequency_factor_tpu_torch import pins as tpins

    x = np.full((1, L), 10.37, np.float32)
    y = np.linspace(1, 2, L, dtype=np.float32)[None]
    m = np.ones((1, L), bool)
    t, j = _both(tm.masked_corr, jm.masked_corr, x, y, m)
    assert np.isnan(t[0]) and np.isnan(j[0])
    with tpins.pinned(constant_window="noise"), \
            jpins.pinned(constant_window="noise"):
        t, j = _both(tm.masked_corr, jm.masked_corr, x, y, m)
        np.testing.assert_array_equal(np.isnan(t), np.isnan(j))


@pytest.mark.parametrize("k", [1, 5, 39, 50])
@pytest.mark.parametrize("largest", [True, False])
def test_topk_threshold_bitwise(data, k, largest):
    """``k > n`` and all-invalid rows included; with NaN/±inf in valid
    lanes the selection follows the JAX package's total order (a NaN's
    sign bit decides its end), not ``torch.topk``'s float order."""
    x, _, mask = data
    t, j = _both(tr.topk_threshold, jr.topk_threshold, x, mask, k=k,
                 largest=largest)
    _bitwise(t, j)
    t2, j2 = _both(tr.bottomk_threshold, jr.bottomk_threshold, x, mask, k=k)
    _bitwise(t2, j2)


def test_topk_threshold_nan_sign_and_signed_zero():
    """A negative NaN (what x86 gives for 0/0) ranks below -inf and a
    positive one above +inf in the JAX selection; -0.0 ranks below +0.0.
    The port reproduces both, bit for bit."""
    neg_nan = np.copysign(np.float32(np.nan), np.float32(-1.0))
    assert np.signbit(neg_nan)
    x = np.array([[1.0, np.nan, 3.0, 2.0],
                  [1.0, neg_nan, 3.0, 2.0],
                  [0.0, -0.0, -0.0, 0.0],
                  [5.0, np.nan, neg_nan, 4.0]], np.float32)
    mask = np.ones(x.shape, bool)
    for k in (1, 2, 3, 4):
        for largest in (True, False):
            _bitwise(*_both(tr.topk_threshold, jr.topk_threshold, x, mask,
                            k=k, largest=largest))
