"""The port's sort-based ops and chip-family intermediates vs the JAX
package's, on the same seeded inputs.

Orders, ranks and tie groups must be bitwise equal: masked_order is
``jnp.lexsort``'s permutation, rank_average gives the same half-integer
ranks, including -0.0 next to +0.0, a valid ``+inf``, +NaN and -NaN valid
lanes, garbage in invalid lanes and all-invalid rows, and over a whole day
frame ``[2, 2400]``. The segment moments and the pdf quantile walk sum f32
in the device's scan order, so they are held at tests/test_parity.py's
tolerances for the doc_* factors. ``topk_sum`` is bitwise where no NaN is
involved; where a zero-volume day puts NaN shares in it, the port answers
NaN as the f64 oracle does, and the JAX package follows the sign of the
CPU's NaN (the one deliberate difference, pinned below).
"""

import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pandas as pd
import pytest
import torch

from replication_of_minute_frequency_factor_tpu.models import (
    DayContext as JaxContext, compute_factors_jit)
from replication_of_minute_frequency_factor_tpu.ops import ranking as jr
from replication_of_minute_frequency_factor_tpu.ops import segments as js
from replication_of_minute_frequency_factor_tpu.oracle import compute_oracle
from replication_of_minute_frequency_factor_tpu_torch import compute_batch
from replication_of_minute_frequency_factor_tpu_torch import data as tdata
from replication_of_minute_frequency_factor_tpu_torch.models import (
    DayContext, chip)
from replication_of_minute_frequency_factor_tpu_torch.ops import ranking as tr
from replication_of_minute_frequency_factor_tpu_torch.ops import segments as ts
from test_parity import ATOL, RTOL, RTOL_OVERRIDE
from torch_cases import crafted_rows

ROWS, L = 24, 60


def _crafted(seed):
    """Tie-heavy rows with the crafted lanes a sort must place exactly
    (``torch_cases.crafted_rows``)."""
    return crafted_rows(seed, ROWS, L)


def _both(fn_t, fn_j, *arrays, **kw):
    t = fn_t(*(torch.from_numpy(a) for a in arrays), **kw)
    j = fn_j(*(jnp.asarray(a) for a in arrays), **kw)
    if isinstance(t, tuple):
        return [v.numpy() for v in t], [np.asarray(v) for v in j]
    return t.numpy(), np.asarray(j)


def _bits(a):
    return a.view(np.int32) if a.dtype == np.float32 else a


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_masked_order_is_the_lexsort_permutation(seed):
    x, mask = _crafted(seed)
    t, j = _both(tr.masked_order, jr.masked_order, x, mask)
    np.testing.assert_array_equal(t, j)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_rank_average_bitwise(seed):
    x, mask = _crafted(seed)
    t, j = _both(tr.rank_average, jr.rank_average, x, mask)
    np.testing.assert_array_equal(_bits(t), _bits(j))
    assert np.isnan(t[2]).all()
    # -0.0 and +0.0 tie; each NaN is a group of its own, after +inf
    assert t[0, 0] == t[0, 1] and t[0, 3] != t[0, 4]
    assert t[0, 2] < t[0, 3] and t[0, 2] < t[0, 4]


def test_group_bounds_are_the_jax_scans():
    """The binary-search bounds equal the JAX package's two running-max
    scans over the same sorted rows."""
    x, mask = _crafted(3)
    skey, order = tr._masked_sort(torch.from_numpy(x), torch.from_numpy(mask))
    got = tr._group_bounds(skey, skey == tr._NAN_KEY)
    order = jnp.asarray(order.numpy())
    sx = jnp.take_along_axis(jnp.where(mask, x, 0.0), order, axis=-1)
    sm = jnp.take_along_axis(jnp.asarray(mask), order, axis=-1)
    new_group = jnp.concatenate(
        [jnp.ones((ROWS, 1), bool),
         (sx[:, 1:] != sx[:, :-1]) | (sm[:, 1:] != sm[:, :-1])], axis=-1)
    for a, b in zip(got, jr._group_bounds(new_group)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def _synth_batch(n_codes=10, n_days=2, seed=11, **kw):
    rng = np.random.default_rng(seed)
    days = [tdata.synth_day(rng, n_codes=n_codes, date=f"2024-01-{2 + d:02d}",
                            **kw) for d in range(n_days)]
    codes = np.unique(np.concatenate([d["code"] for d in days]))
    grids = [tdata.grid_day(d["code"], d["time"], d["open"], d["high"],
                            d["low"], d["close"], d["volume"], codes=codes)
             for d in days]
    return (np.stack([g.bars for g in grids]),
            np.stack([g.mask for g in grids]))


def test_whole_frame_rank_bitwise():
    """``eod_ret_global_rank``: one rank per day over all T*S lanes
    ([2, 2400] here), equal to the JAX package's bit for bit."""
    bars, mask = _synth_batch(missing_prob=0.1, zero_volume_prob=0.05,
                              constant_price_codes=2, short_day_codes=2)
    t = DayContext(torch.from_numpy(bars), torch.from_numpy(mask))
    j = JaxContext(jnp.asarray(bars), jnp.asarray(mask))
    for name in ("last_close", "eod_ret", "eod_ret_global_rank"):
        a, b = getattr(t, name).numpy(), np.asarray(getattr(j, name))
        np.testing.assert_array_equal(_bits(a), _bits(b), err_msg=name)
    rank = t.eod_ret_global_rank.numpy()
    assert rank.shape == (2, 10, 240)
    valid = mask.reshape(2, -1)
    for d in range(2):  # ranks 1..n over the day frame, summing to n(n+1)/2
        n = valid[d].sum()
        r = rank[d].reshape(-1)[valid[d]]
        assert r.min() >= 1 and r.max() <= n
        assert r.astype(np.float64).sum() == n * (n + 1) / 2


def _within(a, b, name):
    rtol = RTOL_OVERRIDE.get(name, RTOL["default"])
    atol = ATOL.get(name, ATOL["default"])
    np.testing.assert_array_equal(np.isnan(a), np.isnan(b))
    fin = np.isfinite(b)
    np.testing.assert_allclose(a[fin], b[fin], rtol=rtol, atol=atol)


@pytest.mark.parametrize("seed", [0, 1])
def test_segment_stats_within_parity_tolerance(seed):
    x, mask = _crafted(seed)
    x = np.abs(x)  # returns are positive; shares are non-negative
    w = np.random.default_rng(seed + 5).random((ROWS, L)).astype(np.float32)
    (skew, kurt), (jskew, jkurt) = _both(
        ts.segment_stats_by_value, js.segment_stats_by_value, x, w, mask)
    _within(skew, jskew, "doc_skew")
    _within(kurt, jkurt, "doc_kurt")


@pytest.mark.parametrize("threshold", [0.6, 0.7, 0.8, 0.9, 0.95])
def test_pdf_quantile_rank_within_parity_tolerance(threshold):
    x, mask = _crafted(4)
    w = np.random.default_rng(9).random((ROWS, L)).astype(np.float32)
    w = np.where(mask, w, 0.0).astype(np.float32)
    w = w / np.maximum(w.sum(-1, keepdims=True), 1e-30)
    # the composition the doc_pdf* factors run: one sort, then the walk
    t = ts.pdf_quantile_rank(ts._sorted_segments(
        *(torch.from_numpy(a) for a in (x, w, mask))), threshold).numpy()
    j = np.asarray(js.pdf_quantile_rank(jnp.asarray(x), jnp.asarray(w),
                                        jnp.asarray(mask), threshold))
    _within(t, j, f"doc_pdf{int(threshold * 100)}")


@pytest.mark.parametrize("k", [1, 2, 5, 10])
def test_topk_sum_bitwise(k):
    """At the factors' k (5 and 10) the k largest are summed in order,
    as XLA does."""
    rng = np.random.default_rng(k)
    x = (rng.random((32, 240)) ** 8).astype(np.float32)
    mask = rng.random((32, 240)) < 0.9
    mask[0] = False
    mask[1] = False
    mask[1, :3] = True  # fewer valid lanes than k
    x[2, 5], x[2, 6] = np.inf, -0.0
    t, j = _both(tr.topk_sum, jr.topk_sum, x, mask, k=k)
    np.testing.assert_array_equal(_bits(t), _bits(j))


@pytest.mark.parametrize("k", [50, 240])
def test_topk_sum_long_within_ulps(k):
    """``doc_vol50_ratio`` with the quirk off sums 50 shares; XLA does
    not take a sum that long in order, so it is held at a few ulps."""
    rng = np.random.default_rng(k)
    x = (rng.random((64, 240)) ** 8).astype(np.float32)
    mask = rng.random((64, 240)) < 0.9
    t, j = _both(tr.topk_sum, jr.topk_sum, x, mask, k=k)
    np.testing.assert_allclose(t, j, rtol=8 * np.finfo(np.float32).eps,
                               atol=0)


def _zero_volume_day():
    """One ticker, four bars, no volume traded: every share is 0/0."""
    times = np.array([93100000, 93200000, 93300000, 93400000], np.int64)
    day = {"code": np.array(["000001.SZ"] * 4), "time": times,
           "date": np.array([np.datetime64("2024-01-02")] * 4),
           "open": np.full(4, 10.0), "high": np.full(4, 10.02),
           "low": np.full(4, 9.98), "close": np.array([10.0, 10.01, 9.99,
                                                       10.0]),
           "volume": np.zeros(4)}
    g = tdata.grid_day(day["code"], day["time"], day["open"], day["high"],
                       day["low"], day["close"], day["volume"])
    return day, g.bars[None], g.mask[None]


def test_zero_volume_topk_sum_is_nan_as_the_oracle_not_minus_inf():
    """The one place the port is asked to differ from the JAX package on
    the CPU: a zero-volume day with fewer valid bars than k. x86's 0/0 is
    a NEGATIVE NaN, ``lax.top_k`` ranks it below the ``-inf`` of the
    invalid lanes, and JAX sums -inf; the f64 oracle sums the NaN shares;
    the port folds every NaN onto +NaN and gives NaN, as the oracle does,
    whatever sign the device's 0/0 has."""
    day, bars, mask = _zero_volume_day()
    names = ("doc_vol5_ratio", "doc_vol10_ratio", "doc_vol50_ratio")
    jax_out = compute_factors_jit(jnp.asarray(bars), jnp.asarray(mask),
                                  names=names)
    oracle = compute_oracle(pd.DataFrame(day)).set_index("code")
    port = compute_batch(bars, mask, names=names, device="cpu").numpy()
    for i, name in enumerate(names):
        assert np.asarray(jax_out[name])[0, 0] == -np.inf, name
        assert np.isnan(oracle.loc["000001.SZ", name]), name
        assert np.isnan(port[i, 0, 0]), name
    share = torch.zeros(4) / torch.zeros(4).sum()
    assert np.signbit(share.numpy()).all()  # the CPU's 0/0 is -NaN here too
    m = torch.ones(4, dtype=torch.bool)
    assert torch.isnan(tr.topk_sum(share, m, 5))
    assert torch.isnan(tr.topk_sum(-share, m, 5))  # and +NaN alike


def test_chip_factors_share_one_sort_per_intermediate(monkeypatch):
    """A context calls each segment intermediate's wrapper once
    (``ops.chip_segments_cuda``: the three moment factors one
    ``segment_moments``, the five doc_pdf* one ``pdf_ranks``, each one
    sort), and the three doc_vol*_ratio one ``volume_selections``
    (``ops.volume_select_cuda``: one order of each row's volume for every
    k; doc_vol5/doc_vol50 share one answer under quirk Q3)."""
    from replication_of_minute_frequency_factor_tpu_torch.ops import (
        chip_segments_cuda as cs, volume_select_cuda as vs)

    calls = {"moments": 0, "pdf": 0, "topk": 0}
    moments, pdf, topk = cs.segment_moments, cs.pdf_ranks, \
        vs.volume_selections

    def count(key, fn):
        def wrapped(*a, **kw):
            calls[key] += 1
            return fn(*a, **kw)
        return wrapped

    monkeypatch.setattr(cs, "segment_moments", count("moments", moments))
    monkeypatch.setattr(cs, "pdf_ranks", count("pdf", pdf))
    monkeypatch.setattr(vs, "volume_selections", count("topk", topk))
    bars, mask = _synth_batch(n_codes=4, n_days=1)
    names = tuple(n for n in chip.__dict__ if n.startswith("doc_"))
    assert len(names) == 11
    out = compute_batch(bars, mask, names=names, device="cpu")
    assert calls == {"moments": 1, "pdf": 1, "topk": 1}
    assert torch.equal(out[names.index("doc_std")],
                       out[names.index("doc_skew")])
    assert torch.equal(out[names.index("doc_vol50_ratio")],
                       out[names.index("doc_vol5_ratio")])


def test_registration_order_does_not_depend_on_import_order():
    """Importing the chip family's module first still registers the 58
    in the reference file's order."""
    code = ("import replication_of_minute_frequency_factor_tpu_torch.models"
            ".chip\n"
            "from replication_of_minute_frequency_factor_tpu_torch.models "
            "import factor_names\n"
            "print(' '.join(factor_names()))\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, check=True, timeout=300,
                         cwd=Path(__file__).resolve().parents[1]
                         ).stdout.split()
    from replication_of_minute_frequency_factor_tpu.models import (
        factor_names as jax_factor_names)
    assert tuple(out) == tuple(jax_factor_names())
