"""The port's evaluation ops, frames and daily readers vs the JAX
package's, on the same seeded inputs, on the CPU.

Bitwise: the quantile levels (``jnp.linspace``'s f32 bits), the qcut
labels at every group count of ``torch_cases.QCUT_GROUPS`` on random,
tied, duplicate-break, fuzz-6290, degenerate and all-invalid
cross-sections under both ``qcut_nan`` readings, the coverage counts,
every function of ``frames.py``, and the PV/stock-pool readers on the JAX
tests' fixtures. Within tolerance: per-date IC/rank-IC at
tests/test_torch_masked.py's corr tolerance (rtol 2e-5, atol 4 eps; NaN
dates identical), and ``decile_spread`` at tests/test_parity.py's default
tolerance (its f32 bucket sums are taken in another order).
"""

import os

import jax.numpy as jnp
import numpy as np
import pyarrow as pa
import pyarrow.parquet as pq
import pytest
import torch

from replication_of_minute_frequency_factor_tpu import eval_ops as je
from replication_of_minute_frequency_factor_tpu import frames as jf
from replication_of_minute_frequency_factor_tpu import pins as jpins
from replication_of_minute_frequency_factor_tpu.data import io as jio
from replication_of_minute_frequency_factor_tpu_torch import eval_ops as te
from replication_of_minute_frequency_factor_tpu_torch import frames as tf
from replication_of_minute_frequency_factor_tpu_torch import pins as tpins
from replication_of_minute_frequency_factor_tpu_torch.data import io as tio
from test_parity import ATOL, RTOL
from torch_cases import (
    QCUT_GROUPS, eval_exposure, eval_matrices, eval_pv, qcut_cases,
    weekdays)

EPS = float(np.finfo(np.float32).eps)
CASES = qcut_cases()
GOLDEN_PV = os.path.join(os.path.dirname(__file__), "golden",
                         "daily_pv.parquet")


def _t(*arrays):
    return tuple(torch.from_numpy(np.ascontiguousarray(a)) for a in arrays)


def _same(a, b):
    """Bitwise equality of two numpy arrays, dtype and NaN bits included."""
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype and a.shape == b.shape, (a.dtype, b.dtype)
    if a.dtype.kind == "f":
        a, b = a.view(f"i{a.itemsize}"), b.view(f"i{b.itemsize}")
    np.testing.assert_array_equal(a, b)


def test_levels_are_jnp_linspace_bits():
    for g in range(2, 257):
        want = np.asarray(jnp.linspace(0.0, 1.0, g + 1))[1:-1]
        _same(te.quantile_levels(g).numpy(), want)
    # the trap the levels avoid: torch.linspace is one ulp off at g = 10
    lin = torch.linspace(0.0, 1.0, 11)[1:-1].numpy()
    assert not np.array_equal(
        lin, np.asarray(jnp.linspace(0.0, 1.0, 11))[1:-1])


@pytest.mark.parametrize("group_num", QCUT_GROUPS)
@pytest.mark.parametrize("case", sorted(CASES))
def test_qcut_labels_bitwise(case, group_num):
    x, m, _ = CASES[case]
    want = np.asarray(je._qcut_labels_jit(x, m, group_num))
    got = te._qcut_labels(*_t(x, m), group_num).numpy()
    _same(got, want)
    assert got.dtype == np.int32
    assert (got[~m] == -1).all()


@pytest.mark.parametrize("reading", ["exclude", "top_bin"])
@pytest.mark.parametrize("group_num", [3, 10])
def test_qcut_nan_readings_bitwise(reading, group_num):
    for x, m, nan_lanes in CASES.values():
        with jpins.pinned(qcut_nan=reading), tpins.pinned(qcut_nan=reading):
            want = np.asarray(je.qcut_labels(x, m, group_num,
                                             nan_lanes=nan_lanes))
            got = te.qcut_labels(*_t(x, m), group_num,
                                 nan_lanes=torch.from_numpy(nan_lanes))
        _same(got.numpy(), want)
        top = (got.numpy() == group_num - 1)[nan_lanes]
        assert top.all() if reading == "top_bin" else not top.any()


def test_qcut_labels_match_polars_breaks_on_ties():
    """tests/test_factor_eval.py's duplicate-break semantics, through the
    port: labels equal first-bin searchsorted over uncollapsed breaks."""
    x, m, _ = CASES["duplicate_breaks"]
    k = 7
    labels = te.qcut_labels(*_t(x, m), k).numpy()
    for d in range(x.shape[0]):
        xs = x[d, m[d]].astype(np.float64)
        breaks = np.quantile(xs, [(i + 1) / k for i in range(k - 1)])
        np.testing.assert_array_equal(
            labels[d][m[d]], np.searchsorted(breaks, xs, side="left"))


def test_coverage_counts_bitwise():
    for x, m, _ in CASES.values():
        _same(te.coverage_counts(torch.from_numpy(m)).numpy(),
              np.asarray(je.coverage_counts(m)))


@pytest.mark.parametrize("seed", [3, 4])
def test_ic_series_within_corr_tolerance(seed):
    x, fwd, valid = eval_matrices(seed, 12, 300)
    valid[0] = False           # no cross-section
    valid[1] = False
    valid[1, :1] = True        # one lane
    x[2] = 1.5                 # constant exposure: zero variance
    got = [t.numpy() for t in te.ic_series(*_t(x, fwd, valid))]
    want = [np.asarray(a) for a in je.ic_series(x, fwd, valid)]
    for g, w in zip(got, want):
        assert g.dtype == w.dtype == np.float32
        np.testing.assert_array_equal(np.isnan(g), np.isnan(w))
        ok = ~np.isnan(w)
        assert ok.sum() >= 9
        np.testing.assert_allclose(g[ok], w[ok], rtol=2e-5, atol=4 * EPS)


@pytest.mark.parametrize("group_num", [2, 5, 10])
def test_decile_spread_within_parity_tolerance(group_num):
    x, fwd, valid = eval_matrices(5, 10, 400)
    fwd[3, :7] = np.nan
    valid[4] = False
    got = te.decile_spread(*_t(x, fwd, valid), group_num).numpy()
    want = np.asarray(je.decile_spread(x, fwd, valid, group_num))
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    ok = ~np.isnan(want)
    np.testing.assert_allclose(got[ok], want[ok], rtol=RTOL["default"],
                               atol=ATOL["default"])


# --------------------------------------------------------------------------
# frames.py: bitwise
# --------------------------------------------------------------------------
def _long(seed=11, n_codes=9, n_days=17):
    codes = np.array([f"{600000 + i:06d}" for i in range(n_codes)])
    exp = eval_exposure(seed, codes, weekdays(n_days))
    order = np.random.default_rng(seed).permutation(len(exp["code"]))
    return {k: v[order] for k, v in exp.items()}


@pytest.mark.parametrize("pinned_axes", [False, True])
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_long_to_matrix_bitwise(pinned_axes, dtype):
    e = _long()
    kw = {}
    if pinned_axes:
        kw = {"codes": np.unique(e["code"])[1:],
              "dates": np.unique(e["date"])[::2]}
    got = tf.long_to_matrix(e["code"], e["date"], e["value"], dtype=dtype,
                            **kw)
    want = jf.long_to_matrix(e["code"], e["date"], e["value"], dtype=dtype,
                             **kw)
    for g, w in zip(got, want):
        _same(g, w)


@pytest.mark.parametrize("n", [1, 3, 5])
def test_forward_returns_bitwise(n):
    codes = np.array([f"{600000 + i:06d}" for i in range(7)])
    pv = eval_pv(12, codes, weekdays(20))
    pv["pct_change"][::13] = np.nan
    args = (pv["code"], pv["date"], pv["pct_change"], n)
    _same(tf.forward_returns(*args), jf.forward_returns(*args))
    _same(tf.forward_returns(*(a[:0] for a in args[:3]), n),
          jf.forward_returns(*(a[:0] for a in args[:3]), n))


@pytest.mark.parametrize("freq", sorted(tf._FREQ_ALIASES))
def test_period_start_bitwise(freq):
    d = np.arange(np.datetime64("2023-11-20"), np.datetime64("2024-04-10"))
    _same(tf.period_start(d, freq), jf.period_start(d, freq))
    assert tf._FREQ_ALIASES == jf._FREQ_ALIASES
    with pytest.raises(ValueError):
        tf.period_start(d, "fortnight")


def test_segment_functions_bitwise():
    e = _long()
    period = tf.period_start(e["date"], "week")
    got = tf.group_segments(e["code"], period)
    want = jf.group_segments(e["code"], period)
    for g, w in zip(got, want):
        _same(np.asarray(g), np.asarray(w))
    order, seg, n = got
    v = e["value"][order].astype(np.float64) * 0.01
    w_ = np.abs(np.random.default_rng(1).normal(1e9, 1e8, len(v)))
    w_[::5] = np.nan
    _same(tf.segment_compound(v, seg, n), jf.segment_compound(v, seg, n))
    _same(tf.segment_last(v, seg, n), jf.segment_last(v, seg, n))
    _same(tf.segment_last(e["code"][order], seg, n).astype(str),
          jf.segment_last(e["code"][order], seg, n).astype(str))
    _same(tf.segment_weighted_mean(v, w_, seg, n),
          jf.segment_weighted_mean(v, w_, seg, n))
    empty = tf.group_segments(e["code"][:0], period[:0])
    assert empty[2] == 0 and jf.group_segments(e["code"][:0],
                                               period[:0])[2] == 0


# --------------------------------------------------------------------------
# the daily side of data/io.py, on the JAX tests' fixtures
# --------------------------------------------------------------------------
def _same_dicts(got, want):
    assert list(got) == list(want)
    for k in want:
        if want[k].dtype.kind in "UO":
            np.testing.assert_array_equal(got[k].astype(str),
                                          want[k].astype(str))
            assert got[k].dtype == want[k].dtype
        else:
            _same(got[k], want[k])


@pytest.mark.parametrize("columns", [None, ["code", "date", "pct_change"],
                                     ["code", "date", "pct_change", "tmc",
                                      "cmc"]])
def test_read_daily_pv_golden_bitwise(columns):
    _same_dicts(tio.read_daily_pv(GOLDEN_PV, columns),
                jio.read_daily_pv(GOLDEN_PV, columns))
    assert tio.DAILY_PV_RENAME == jio.DAILY_PV_RENAME


def test_read_daily_pv_csmar_names(tmp_path):
    """CSMAR column names, int codes and compact dates, renamed on load."""
    path = str(tmp_path / "csmar.parquet")
    pq.write_table(pa.table({
        "Stkcd": pa.array([2, 600519, 2], pa.int64()),
        "Trddt": pa.array(["20240102", "20240102", "20240103"]),
        "ChangeRatio": pa.array([0.01, -0.02, 0.03]),
        "Dsmvtll": pa.array([1e9, 2e9, 1e9]),
        "Dsmvosd": pa.array([7e8, 1.4e9, 7e8])}), path)
    for cols in (None, ["code", "date", "pct_change", "tmc", "cmc"]):
        got = tio.read_daily_pv(path, cols)
        _same_dicts(got, jio.read_daily_pv(path, cols))
    assert list(got["code"]) == ["000002", "600519", "000002"]


@pytest.mark.parametrize("dates", [
    np.array(["20240102", "20240103", " ", "2024010x"]),
    np.array(["2024-01-02", "2024-02-29", "NaT"]),
    np.array([20240102, 20240105]),
    np.array([b"20240102", b"20231229"]),
    np.array(["2024-01-02", "2024-01-03"], "datetime64[ns]"),
    np.array(["20240102", None], dtype=object),
])
def test_coerce_dates_bitwise(dates):
    _same(tio.coerce_dates(dates), jio.coerce_dates(dates))


def test_coerce_dates_rejects_year_garbage():
    for mod in (tio, jio):
        with pytest.raises(ValueError, match="unparseable"):
            mod.coerce_dates(np.array(["30000102"]))


def _pool_files(tmp_path):
    """tests/test_minfreq.py's two membership schemas."""
    exact = str(tmp_path / "pool_exact.parquet")
    pq.write_table(pa.table({
        "code": ["600000", "600000", "600001"],
        "date": ["2024-01-02", "2024-01-03", "2024-01-03"],
        "pool": ["hs300", "hs300", "zz500"]}), exact)
    interval = str(tmp_path / "pool_interval.parquet")
    pq.write_table(pa.table({
        "code": ["600000", "600002"],
        "in_date": ["2024-01-03", "2023-06-01"],
        "out_date": [None, "2024-01-04"],
        "pool": ["hs300", "hs300"]}), interval)
    single = str(tmp_path / "pool_single.parquet")
    pq.write_table(pa.table({
        "code": pa.array([600000, 2], pa.int64()),
        "date": ["20240102", "20240104"]}), single)
    return exact, interval, single


def test_stock_pool_readers_bitwise(tmp_path):
    dates = np.array(["2024-01-02", "2024-01-03", "2024-01-04"],
                     "datetime64[D]")
    codes = np.repeat(["600000", "600001", "600002", "000002"], 3)
    rows_d = np.tile(dates, 4)
    for path in _pool_files(tmp_path):
        for pool in ("hs300", "zz500"):
            try:
                want = jio.read_stock_pool(path, pool, dates)
            except ValueError as e:
                with pytest.raises(ValueError, match="available pools"):
                    tio.read_stock_pool(path, pool, dates)
                assert "available pools" in str(e)
                continue
            got = tio.read_stock_pool(path, pool, dates)
            np.testing.assert_array_equal(got[0].astype(str),
                                          want[0].astype(str))
            _same(got[1], want[1])
            _same(tio.membership_filter(codes, rows_d, *got),
                  jio.membership_filter(codes, rows_d, *want))
    empty = (np.array([], object), np.array([], "datetime64[D]"))
    _same(tio.membership_filter(codes, rows_d, *empty),
          jio.membership_filter(codes, rows_d, *empty))
    with pytest.raises(ValueError, match="available pools"):
        tio.read_stock_pool(_pool_files(tmp_path)[0], "hs3000", dates)
