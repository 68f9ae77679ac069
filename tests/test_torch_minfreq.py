"""The port's ``MinFreqFactor`` vs the JAX package's, on the CPU.

``cal_final_exposure`` is the same host numpy in both packages, so every
mode, method and frequency is held bitwise on tests/test_minfreq.py's
inputs (the exactness cases and the stock pools included). The compute
half runs each package's own driver over the same day files: the port's
``cal_exposure_by_min_data`` (``device='cpu'``) for an ``mmt_ols_*``
factor, an aliased kernel and the resume, then the slice whole —
``cal_final_exposure``, ``ic_test`` and ``group_test`` — against the JAX
package on the same files and PV parquet: exposures through
tests/test_parity.py's comparator, labels and group returns bitwise where
the exposures are, IC statistics within rtol 1e-4 / atol 1e-6.
"""

import os

import numpy as np
import pandas as pd
import pyarrow as pa
import pyarrow.parquet as pq
import pytest
import torch

from replication_of_minute_frequency_factor_tpu import config as jconfig
from replication_of_minute_frequency_factor_tpu.minfreq import (
    MinFreqFactor as JMinFreqFactor)
from replication_of_minute_frequency_factor_tpu_torch import config as tconfig
from replication_of_minute_frequency_factor_tpu_torch.minfreq import (
    MinFreqFactor)
from replication_of_minute_frequency_factor_tpu_torch.models import registry
from test_minfreq import daily_exposure  # noqa: F401 — the shared fixture
from test_parity import _check, _degenerate_beta_codes
from test_pipeline import _write_day
from torch_cases import eval_pv, write_pv

STATS = ("IC", "ICIR", "rank_IC", "rank_ICIR")


@pytest.fixture
def minute_dir(tmp_path, rng):
    d = tmp_path / "kline"
    d.mkdir()
    for ds in ("2024-01-02", "2024-01-03", "2024-01-04", "2024-01-05",
               "2024-01-08", "2024-01-09", "2024-01-10", "2024-01-11",
               "2024-01-12", "2024-01-15"):
        _write_day(str(d), rng, ds, n_codes=12, missing_prob=0.05)
    return str(d)


def _pair(name, code, date, value):
    return (MinFreqFactor(name, device="cpu").set_exposure(code, date, value),
            JMinFreqFactor(name).set_exposure(code, date, value))


def _same_exposure(t, j):
    assert t.factor_name == j.factor_name
    te, je = t.factor_exposure, j.factor_exposure
    assert list(te) == list(je)
    np.testing.assert_array_equal(te["code"].astype(str),
                                  je["code"].astype(str))
    for k in list(te)[1:]:
        assert te[k].dtype == je[k].dtype
        np.testing.assert_array_equal(te[k].view(np.int32 if k != "date"
                                                 else np.int64),
                                      je[k].view(np.int32 if k != "date"
                                                 else np.int64))


@pytest.mark.parametrize("method", ["o", "m", "z", "std"])
@pytest.mark.parametrize("frequency", ["week", "month", "quarter", "year",
                                       "w", "1mo"])
def test_final_exposure_calendar_bitwise(daily_exposure, frequency, method):
    t, j = _pair("x", *daily_exposure)
    _same_exposure(t.cal_final_exposure(frequency, method=method),
                   j.cal_final_exposure(frequency, method=method))


@pytest.mark.parametrize("method", ["o", "m", "z", "std"])
@pytest.mark.parametrize("window", [1, 3, 5])
def test_final_exposure_days_bitwise(daily_exposure, window, method):
    t, j = _pair("x", *daily_exposure)
    got = t.cal_final_exposure(window, method=method, mode="days")
    _same_exposure(got, j.cal_final_exposure(window, method=method,
                                             mode="days"))
    assert got.device == "cpu"


def test_final_exposure_constant_windows_bitwise():
    """tests/test_minfreq.py's exactness cases: constant windows and
    groups give std exactly 0 and z NaN, in both packages alike."""
    code = np.array(["600000"] * 5, object)
    date = np.array([f"2024-01-0{d}" for d in range(2, 7)],
                    dtype="datetime64[D]")
    for val in (np.array([2.5, 2.5, 2.5, 2.5, 3.0], np.float32),
                np.full(5, 7.25, np.float32)):
        t, j = _pair("toy", code, date, val)
        for args in ((1, "z", "days"), (3, "std", "days"), (3, "z", "days"),
                     (2, "m", "days"), ("week", "z", "calendar"),
                     ("week", "std", "calendar")):
            _same_exposure(t.cal_final_exposure(*args),
                           j.cal_final_exposure(*args))
    s3 = MinFreqFactor("toy", device="cpu").set_exposure(
        code, date, np.array([2.5, 2.5, 2.5, 2.5, 3.0], np.float32))
    np.testing.assert_array_equal(
        s3.cal_final_exposure(3, "std", "days").factor_exposure[
            "toy_3_std"][2:4], np.zeros(2, np.float32))


def test_final_exposure_rejects_bad_arguments(daily_exposure):
    t, _ = _pair("x", *daily_exposure)
    for bad in (0, -3):
        with pytest.raises(ValueError, match="window"):
            t.cal_final_exposure(bad, method="z", mode="days")
    with pytest.raises(ValueError, match="method"):
        t.cal_final_exposure("week", method="max")
    with pytest.raises(ValueError, match="mode"):
        t.cal_final_exposure("week", mode="hours")
    with pytest.raises(ValueError, match="quirk Q9"):
        t.cal_final_exposure("week", stock_pool="hs300")


def test_stock_pool_membership_bitwise(tmp_path):
    """tests/test_minfreq.py's two pool schemas, set through each
    package's ``set_config``."""
    dates = np.array(["2024-01-02", "2024-01-03", "2024-01-04"],
                     "datetime64[D]")
    codes = ["600000", "600001", "600002"]
    code_col = np.repeat(codes, len(dates))
    date_col = np.tile(dates, len(codes))
    vals = np.arange(9, dtype=np.float32)
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
    old = (tconfig.get_config(), jconfig.get_config())
    try:
        for path, n_rows in ((exact, 2), (interval, 4)):
            tconfig.set_config(tconfig.Config(stock_pool_path=path))
            jconfig.set_config(jconfig.Config(stock_pool_path=path))
            for args in ((1, "o", "days"), ("week", "m", "calendar")):
                t, j = _pair("x", code_col, date_col, vals)
                got = t.cal_final_exposure(*args, pool="hs300")
                _same_exposure(got, j.cal_final_exposure(*args,
                                                         pool="hs300"))
            assert len(t.cal_final_exposure(
                1, "o", "days", stock_pool="hs300").factor_exposure[
                    "code"]) == n_rows
        t, _ = _pair("x", code_col, date_col, vals)
        with pytest.raises(ValueError, match="available pools"):
            t.cal_final_exposure(1, method="o", mode="days",
                                 stock_pool="hs3000")
    finally:
        tconfig.set_config(old[0])
        jconfig.set_config(old[1])


# --------------------------------------------------------------------------
# the compute half and the slice whole
# --------------------------------------------------------------------------
def _compute_pair(name, minute_dir, tmp_path, **kw):
    t = MinFreqFactor(name, device="cpu").cal_exposure_by_min_data(
        minute_dir=minute_dir, path=str(tmp_path / "port"),
        cfg=tconfig.Config(days_per_batch=4), progress=False, **kw)
    j = JMinFreqFactor(name).cal_exposure_by_min_data(
        minute_dir=minute_dir, path=str(tmp_path / "jax"),
        cfg=jconfig.Config(days_per_batch=4), progress=False, **kw)
    return t, j


def _hold_exposures(t, j, kernel, minute_dir):
    """Codes and dates bitwise, NaN positions identical, values through
    tests/test_parity.py's comparator (noisy scenario, the beta z pair
    past its sub-noise numerators), as tests/test_torch_pipeline.py
    holds the driver."""
    from replication_of_minute_frequency_factor_tpu.data import io as jdio

    te, je = t.factor_exposure, j.factor_exposure
    codes = te["code"].astype(str)
    np.testing.assert_array_equal(codes, je["code"].astype(str))
    np.testing.assert_array_equal(te["date"], je["date"])
    a, b = te[t.factor_name], je[j.factor_name]
    np.testing.assert_array_equal(np.isnan(a), np.isnan(b))
    beta = {str(d): _degenerate_beta_codes(pd.DataFrame(
        jdio.read_minute_day(p))) for d, p in jdio.list_day_files(minute_dir)}
    failures = []
    for r, (code, date) in enumerate(zip(codes, te["date"].astype(str))):
        skip, num_scale = beta[date]
        if kernel == "mmt_ols_qrs" and code in skip:
            continue
        _check(date, kernel, code, b[r], a[r], True, failures,
               aux={"beta_num_scale": num_scale.get(code)})
    assert not failures, "\n".join(failures[:40])
    assert np.isfinite(a).sum() > len(a) // 2


def test_the_slice_whole_matches_jax(minute_dir, tmp_path):
    """compute -> cache -> cal_final_exposure -> ic_test -> group_test for
    an mmt_ols_* factor (the path through the rolling kernel's plain
    version here), each package on the same files and PV parquet."""
    name = "mmt_ols_qrs"
    t, j = _compute_pair(name, minute_dir, tmp_path)
    assert os.path.exists(tmp_path / "port" / f"{name}.parquet")
    _hold_exposures(t, j, name, minute_dir)
    codes = np.unique(t.factor_exposure["code"].astype(str))
    pv_path = tmp_path / "pv.parquet"
    write_pv(eval_pv(31, codes, np.unique(t.factor_exposure["date"])),
             pv_path)
    # the slice bitwise from here on where the exposures are: resample
    # the JAX exposure in both packages
    t.set_exposure(*(j.factor_exposure[k] for k in ("code", "date", name)))
    tw = t.cal_final_exposure("week", method="z")
    jw = j.cal_final_exposure("week", method="z")
    _same_exposure(tw, jw)
    for f_t, f_j in ((t, j), (tw, jw)):
        got = f_t.ic_test(future_days=1, plot=False, return_df=True,
                          daily_pv_path=str(pv_path))
        want = f_j.ic_test(future_days=1, plot=False, return_df=True,
                           daily_pv_path=str(pv_path))
        np.testing.assert_array_equal(got["date"], want["date"])
        for k in STATS:
            np.testing.assert_allclose(getattr(f_t, k), getattr(f_j, k),
                                       rtol=1e-4, atol=1e-6, err_msg=k)
    kw = dict(frequency="week", weight_param="tmc", group_num=3,
              plot=False, return_df=True, daily_pv_path=str(pv_path))
    got, want = t.group_test(**kw), j.group_test(**kw)
    for k in ("period", "group_return", "cum_return"):
        np.testing.assert_array_equal(got[k], want[k])
    assert np.isfinite(got["group_return"]).any()


@pytest.fixture
def _restore_aliases():
    """The alias this file's test registers leaves the process's registry
    as it was: other files that share the worker check its names."""
    live = (registry.ALIASES, registry.FINALIZE_CLASSES)
    saved = [dict(d) for d in live]
    yield
    for d, before in zip(live, saved):
        d.clear()
        d.update(before)


def test_aliased_kernel_matches_jax(minute_dir, tmp_path, _restore_aliases):
    t, j = (F("my_custom_vol", **kw).cal_exposure_by_min_data(
        calculate_method="vol_return1min", minute_dir=minute_dir,
        path=str(tmp_path / sub), cfg=C(days_per_batch=4), progress=False)
        for F, kw, C, sub in ((MinFreqFactor, {"device": "cpu"},
                               tconfig.Config, "port"),
                              (JMinFreqFactor, {}, jconfig.Config, "jax")))
    assert "my_custom_vol" in t.factor_exposure
    assert os.path.exists(tmp_path / "port" / "my_custom_vol.parquet")
    assert "my_custom_vol" not in registry.factor_names()
    _hold_exposures(t, j, "vol_return1min", minute_dir)
    with pytest.raises(KeyError):
        MinFreqFactor("nope", device="cpu").cal_exposure_by_min_data(
            calculate_method="not_a_kernel", minute_dir=minute_dir)
    with pytest.raises(KeyError, match="not a registered kernel"):
        MinFreqFactor("nope", device="cpu").cal_exposure_by_min_data(
            minute_dir=minute_dir)


def test_resume_computes_only_new_days(minute_dir, tmp_path, rng):
    cfg = tconfig.Config(days_per_batch=4)
    cache_dir = str(tmp_path / "factors")
    f = MinFreqFactor("vol_return1min", device="cpu")
    sentinel = object()
    assert f._read_exposure(cache_dir, sentinel) is sentinel
    f.cal_exposure_by_min_data(minute_dir=minute_dir, path=cache_dir,
                               cfg=cfg, progress=False)
    n_before = len(f.factor_exposure["code"])
    _write_day(minute_dir, rng, "2024-01-16", n_codes=12)
    seen = []
    f2 = MinFreqFactor("vol_return1min", device="cpu")
    f2.cal_exposure_by_min_data(minute_dir=minute_dir, path=cache_dir,
                                cfg=cfg, progress=False,
                                fault_hook=seen.append)
    assert seen == [np.datetime64("2024-01-16")]
    assert len(f2.factor_exposure["code"]) > n_before
    old = f2.factor_exposure["date"] < np.datetime64("2024-01-16")
    np.testing.assert_array_equal(
        f2.factor_exposure["vol_return1min"][old],
        f.factor_exposure["vol_return1min"])
    g = MinFreqFactor("vol_return1min", device="cpu")
    exp = g._read_exposure(os.path.join(cache_dir,
                                        "vol_return1min.parquet"))
    np.testing.assert_array_equal(exp["code"], f2.factor_exposure["code"])


def test_compute_refuses_the_cpu_unless_asked(minute_dir, tmp_path,
                                              monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        MinFreqFactor("mmt_pm").cal_exposure_by_min_data(
            minute_dir=minute_dir, path=str(tmp_path), progress=False)
    assert not os.path.exists(tmp_path / "mmt_pm.parquet")
