"""The port's ``Factor`` vs the JAX package's, on the CPU.

Same inputs for both: tests/test_factor_eval.py's synthetic PV table
(``_make_pv``, weekdays, 5% of rows missing) with exposures built from it,
and the golden fixture (tests/golden/) through each package's own host
driver. Bitwise: ``coverage(return_df=True)``, and ``group_test``'s
per-period group returns and cumulative returns (equal-weighted, ``tmc``,
``cmc``; week/month/quarter/year) — the labels are bitwise and the rest is
the same host numpy. Within tolerance: per-date IC/rank-IC at
tests/test_torch_masked.py's corr tolerance (rtol 2e-5, atol 4 eps) with
the kept dates identical, and the four summary statistics at rtol 1e-4,
atol 1e-6.
"""

import os

import numpy as np
import pyarrow as pa
import pyarrow.parquet as pq
import pytest
import torch

from replication_of_minute_frequency_factor_tpu import frames as jf
from replication_of_minute_frequency_factor_tpu.config import Config as JConfig
from replication_of_minute_frequency_factor_tpu.factor import Factor as JFactor
from replication_of_minute_frequency_factor_tpu.pipeline import (
    compute_exposures as jax_compute_exposures)
from replication_of_minute_frequency_factor_tpu_torch.config import Config
from replication_of_minute_frequency_factor_tpu_torch.factor import Factor
from replication_of_minute_frequency_factor_tpu_torch.pipeline import (
    compute_exposures)
from test_factor_eval import _make_pv, _write_pv

EPS = float(np.finfo(np.float32).eps)
STATS = ("IC", "ICIR", "rank_IC", "rank_ICIR")
GOLDEN = os.path.join(os.path.dirname(__file__), "golden")
GOLDEN_PV = os.path.join(GOLDEN, "daily_pv.parquet")


@pytest.fixture
def pv_setup(tmp_path, rng):
    pv, days, codes = _make_pv(rng)
    path = str(tmp_path / "pv.parquet")
    _write_pv(pv, path)
    return pv, days, codes, path


def _pair(name, code, date, value):
    """The same exposure in both packages' ``Factor``; the port's on the
    CPU."""
    return (Factor(name, device="cpu").set_exposure(code, date, value),
            JFactor(name).set_exposure(code, date, value))


def _predictor(pv, rng):
    fwd = jf.forward_returns(pv["code"], pv["date"], pv["pct_change"], 5)
    return fwd + rng.normal(0, 0.05, len(fwd))


def _same(a, b):
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype and a.shape == b.shape
    if a.dtype.kind == "f":
        a, b = a.view(f"i{a.itemsize}"), b.view(f"i{b.itemsize}")
    np.testing.assert_array_equal(a, b)


def _hold_ic(t, j, got, want):
    """Per-date series within the corr tolerance, kept dates identical,
    the summary stats at rtol 1e-4 / atol 1e-6."""
    _same(got["date"], want["date"])
    for k in ("IC", "rank_IC"):
        assert got[k].dtype == want[k].dtype == np.float32
        np.testing.assert_array_equal(np.isnan(got[k]), np.isnan(want[k]))
        ok = ~np.isnan(want[k])
        np.testing.assert_allclose(got[k][ok], want[k][ok], rtol=2e-5,
                                   atol=4 * EPS)
    for k in STATS:
        np.testing.assert_allclose(getattr(t, k), getattr(j, k), rtol=1e-4,
                                   atol=1e-6, err_msg=k)


def test_coverage_return_df_bitwise(pv_setup, rng):
    pv, _, _, _ = pv_setup
    value = rng.normal(size=len(pv["code"]))
    value[::7] = np.nan
    t, j = _pair("toy", pv["code"], pv["date"], value)
    got = t.coverage(plot=False, return_df=True)
    want = j.coverage(plot=False, return_df=True)
    _same(got["date"], want["date"])
    _same(got["coverage"], want["coverage"])
    assert got["coverage"].dtype == np.int32
    assert t.coverage(plot_out=False) is None


@pytest.mark.parametrize("future_days", [1, 5])
def test_ic_test_within_tolerance(pv_setup, rng, future_days):
    pv, _, _, path = pv_setup
    t, j = _pair("toy", pv["code"], pv["date"], _predictor(pv, rng))
    got = t.ic_test(future_days=future_days, plot=False, return_df=True,
                    daily_pv_path=path)
    want = j.ic_test(future_days=future_days, plot=False, return_df=True,
                     daily_pv_path=path)
    _hold_ic(t, j, got, want)
    assert t.IC > 0.2
    stats = t.ic_test(future_days=future_days, plot=False,
                      daily_pv_path=path)
    assert set(stats) == set(STATS)
    with pytest.raises(ValueError, match="plot_variable"):
        t.ic_test(plot=False, plot_variable="ICIR", daily_pv_path=path)


@pytest.mark.parametrize("weight", [None, "tmc", "cmc"])
@pytest.mark.parametrize("frequency", ["week", "month", "quarter", "year"])
def test_group_test_returns_bitwise(pv_setup, rng, weight, frequency):
    pv, _, _, path = pv_setup
    # 80% of the PV rows carry an exposure, on a 0.1 grid (heavy ties)
    keep = rng.random(len(pv["code"])) < 0.8
    value = np.round(rng.normal(0, 1, int(keep.sum())), 1)
    value[::11] = np.nan
    t, j = _pair("toy", pv["code"][keep], pv["date"][keep], value)
    kw = dict(frequency=frequency, weight_param=weight, group_num=4,
              plot=False, return_df=True, daily_pv_path=path)
    got, want = t.group_test(**kw), j.group_test(**kw)
    for k in ("period", "group_return", "cum_return"):
        _same(got[k], want[k])
    if frequency in ("week", "month"):
        assert np.isfinite(got["group_return"]).any()


def test_group_test_empty_and_bad_weight(pv_setup):
    _, _, _, path = pv_setup
    t, j = _pair("toy", np.array([], object), np.array([], "datetime64[D]"),
                 np.array([], np.float32))
    got = t.group_test(plot=False, return_df=True, daily_pv_path=path)
    want = j.group_test(plot=False, return_df=True, daily_pv_path=path)
    assert got["group_return"].shape == want["group_return"].shape == (0, 5)
    with pytest.raises(ValueError, match="weight_param"):
        t.group_test(weight_param="bogus", plot=False, daily_pv_path=path)


def test_duplicate_pv_rows_raise(tmp_path, pv_setup, rng):
    pv, _, _, _ = pv_setup
    dup = {k: np.concatenate([v, v[:3]]) for k, v in pv.items()}
    path = str(tmp_path / "dup.parquet")
    _write_pv(dup, path)
    t, _ = _pair("toy", pv["code"], pv["date"], rng.normal(size=len(pv["code"])))
    with pytest.raises(ValueError, match="duplicate"):
        t.ic_test(plot=False, daily_pv_path=path)


def test_parquet_round_trip_matches_jax(tmp_path, pv_setup, rng):
    pv, _, _, _ = pv_setup
    t, j = _pair("toy", pv["code"], pv["date"],
                 rng.normal(size=len(pv["code"])))
    pt = t.to_parquet(str(tmp_path / "port"))
    pj = j.to_parquet(str(tmp_path / "jax"))
    assert pq.read_table(pt).equals(pq.read_table(pj))
    back = Factor("toy", device="cpu").read_parquet(pt)
    for k in ("code", "date", "toy"):
        np.testing.assert_array_equal(back.factor_exposure[k],
                                      t.factor_exposure[k])
    with pytest.raises(RuntimeError, match="no exposure"):
        Factor("empty", device="cpu").coverage(plot=False)


def test_reference_positional_exposure_mapping(pv_setup):
    pv, _, _, _ = pv_setup
    f = Factor("pct_change", pv, device="cpu")
    _same(f.factor_exposure["pct_change"],
          JFactor("pct_change", pv).factor_exposure["pct_change"])


def test_evaluation_refuses_the_cpu_unless_asked(pv_setup, monkeypatch):
    pv, _, _, path = pv_setup
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    f = Factor("toy").set_exposure(pv["code"], pv["date"], pv["pct_change"])
    for call in (lambda: f.coverage(plot=False),
                 lambda: f.ic_test(plot=False, daily_pv_path=path),
                 lambda: f.group_test(plot=False, daily_pv_path=path)):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            call()
    f.device = "cuda"
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        f.coverage(plot=False)


def test_three_chart_types_render_headless(tmp_path, pv_setup, rng):
    pv, _, _, path = pv_setup
    t, _ = _pair("toy", pv["code"], pv["date"], _predictor(pv, rng))
    paths = [str(tmp_path / f"{k}.png") for k in ("cov", "ic", "grp")]
    t.coverage(plot=True, save_path=paths[0])
    t.ic_test(future_days=5, plot=True, save_path=paths[1],
              daily_pv_path=path, plot_variable="rank_IC")
    t.group_test(frequency="week", plot=True, save_path=paths[2],
                 daily_pv_path=path)
    for p in paths:
        assert os.path.getsize(p) > 5_000, p


def test_golden_fixture_evaluates_as_jax(tmp_path):
    """tests/test_golden_fixture.py's user path: compute on the golden day
    file, then coverage and ic_test against the golden PV (int codes,
    compact dates), each package through its own driver."""
    names = ["vol_return1min", "mmt_ols_qrs"]
    port = compute_exposures(GOLDEN, names, cfg=Config(minute_dir=GOLDEN),
                             cache_path=str(tmp_path / "t.parquet"),
                             progress=False, device="cpu")
    ref = jax_compute_exposures(GOLDEN, names,
                                cfg=JConfig(minute_dir=GOLDEN),
                                cache_path=str(tmp_path / "j.parquet"),
                                progress=False)
    for name in names:
        t, j = (F(name, **kw).set_exposure(tab.columns["code"],
                                           tab.columns["date"],
                                           tab.columns[name])
                for F, kw, tab in ((Factor, {"device": "cpu"}, port),
                                   (JFactor, {}, ref)))
        got = t.coverage(plot=False, return_df=True)
        _same(got["coverage"], j.coverage(plot=False,
                                          return_df=True)["coverage"])
        got = t.ic_test(future_days=1, plot=False, return_df=True,
                        daily_pv_path=GOLDEN_PV)
        want = j.ic_test(future_days=1, plot=False, return_df=True,
                         daily_pv_path=GOLDEN_PV)
        _same(got["date"], want["date"])
        for k in ("IC", "rank_IC"):
            np.testing.assert_allclose(got[k], want[k], rtol=2e-5,
                                       atol=4 * EPS)
    assert list(got["date"]) == [np.datetime64("2024-01-02")]
