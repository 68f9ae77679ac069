"""The port's f64 oracle and ``Config.backend`` on the CPU.

The oracle (``oracle/``, host numpy/pandas) is a copy of the JAX
package's on the port's ``markets`` and ``pins``: on the same synthetic
day it gives the JAX oracle's frame bit for bit at three sessions. The
driver's ``backend='numpy'`` runs it over each day file: the same table
as the JAX package's ``backend='numpy'`` on the same files, bit for bit,
and within tests/test_parity.py's comparator of the port's device path
(``backend='torch'``, the oracle in the reference's place).
``backend='polars'`` with no reference tree raises what the JAX
package's raises, before any day.
"""

import os

import numpy as np
import pandas as pd
import pytest
import torch

from replication_of_minute_frequency_factor_tpu.config import Config as JConfig
from replication_of_minute_frequency_factor_tpu.data.synthetic import (
    synth_day)
from replication_of_minute_frequency_factor_tpu.markets import (
    get_session as jax_session)
from replication_of_minute_frequency_factor_tpu.oracle import (
    ORACLE_FACTORS as JAX_ORACLE_FACTORS)
from replication_of_minute_frequency_factor_tpu.oracle import (
    compute_oracle as jax_compute_oracle)
from replication_of_minute_frequency_factor_tpu.pipeline import (
    compute_exposures as jax_compute_exposures)
from replication_of_minute_frequency_factor_tpu_torch import pipeline as pl
from replication_of_minute_frequency_factor_tpu_torch.config import Config
from replication_of_minute_frequency_factor_tpu_torch.oracle import (
    ORACLE_FACTORS, compute_oracle)
from test_pipeline import NAMES, _assert_matches_snapshot, _load_snapshot
from test_torch_pipeline import _hold_to_jax, minute_dir  # noqa: F401


def _cfg(**kw):
    kw.setdefault("days_per_batch", 2)
    return Config(**kw)


def _frame(seed, session, n_codes=12):
    day = synth_day(np.random.default_rng(seed), n_codes=n_codes,
                    missing_prob=0.05, zero_volume_prob=0.03,
                    constant_price_codes=1, short_day_codes=1,
                    session=jax_session(session))
    df = pd.DataFrame(day)
    df["date"] = np.datetime64("2024-01-02")
    return df


def test_oracle_registers_the_jax_oracles_factors():
    assert list(ORACLE_FACTORS) == list(JAX_ORACLE_FACTORS)
    assert len(ORACLE_FACTORS) == 58


@pytest.mark.parametrize("session", ["cn_ashare_240", "us_390",
                                     "hk_halfday"])
def test_oracle_copy_is_the_jax_oracle_bitwise(session):
    df = _frame(17, session)
    got = compute_oracle(df.copy(), session=session)
    want = jax_compute_oracle(df.copy(), session=session)
    assert list(got.columns) == list(want.columns)
    assert got["code"].tolist() == want["code"].tolist()
    for name in ORACLE_FACTORS:
        a = got[name].to_numpy(np.float64)
        b = want[name].to_numpy(np.float64)
        np.testing.assert_array_equal(a.view(np.int64), b.view(np.int64),
                                      err_msg=name)


def test_numpy_backend_is_the_jax_numpy_backend(minute_dir):  # noqa: F811
    """The same day files through both packages' ``backend='numpy'``:
    rows, codes, dates and every value bit for bit."""
    got = pl.compute_exposures(minute_dir, cfg=_cfg(backend="numpy"),
                               progress=False)
    want = jax_compute_exposures(
        minute_dir, cfg=JConfig(days_per_batch=2, backend="numpy"),
        progress=False)
    assert got.factor_names == want.factor_names
    assert len(got) == len(want) == 18
    np.testing.assert_array_equal(got.columns["code"].astype(str),
                                  want.columns["code"].astype(str))
    np.testing.assert_array_equal(got.columns["date"], want.columns["date"])
    for name in got.factor_names:
        np.testing.assert_array_equal(got.columns[name].view(np.int32),
                                      want.columns[name].view(np.int32),
                                      err_msg=name)


def test_numpy_backend_matches_torch_backend(minute_dir):  # noqa: F811
    """The JAX package's own check of its two backends (same NaN
    pattern, values within 2e-4), and then all 58 through
    test_parity's comparator with the oracle as the reference."""
    t_np = pl.compute_exposures(minute_dir, cfg=_cfg(backend="numpy"),
                                progress=False)
    t_torch = pl.compute_exposures(minute_dir, cfg=_cfg(), progress=False,
                                   device="cpu")
    assert len(t_np) == len(t_torch)
    for n in NAMES:
        a, b = t_np.columns[n], t_torch.columns[n]
        both = np.isfinite(a) & np.isfinite(b)
        np.testing.assert_array_equal(np.isfinite(a), np.isfinite(b),
                                      err_msg=f"{n}: NaN pattern differs")
        np.testing.assert_allclose(a[both], b[both], rtol=2e-4, atol=1e-6,
                                   err_msg=f"{n}: values differ")
    _hold_to_jax(t_torch, t_np, minute_dir)


def test_numpy_backend_matches_reference_snapshot(minute_dir):  # noqa: F811
    """The oracle over the fixture days reproduces the vendored
    reference-output snapshot exactly, as the JAX package's does."""
    prov, _ = _load_snapshot()
    t = pl.compute_exposures(minute_dir, prov["names"],
                             cfg=_cfg(backend="numpy"), progress=False)
    _assert_matches_snapshot(t, rtol=0.0, atol=0.0)


def test_numpy_backend_needs_no_card(minute_dir, monkeypatch):  # noqa: F811
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    t = pl.compute_exposures(minute_dir, ("vol_return1min",),
                             cfg=_cfg(backend="numpy"), progress=False)
    assert len(t) == 18
    with pytest.raises(RuntimeError, match="device='cpu'"):
        pl.compute_exposures(minute_dir, ("vol_return1min",), cfg=_cfg(),
                             progress=False)


def test_numpy_backend_caches_and_resumes(minute_dir, tmp_path):  # noqa: F811
    cache = str(tmp_path / "np.parquet")
    first = pl.compute_exposures(minute_dir, ("mmt_am",), cache_path=cache,
                                 cfg=_cfg(backend="numpy"), progress=False)
    again = pl.compute_exposures(minute_dir, ("mmt_am",), cache_path=cache,
                                 cfg=_cfg(backend="numpy"), progress=False)
    assert len(first) == len(again) == 18
    np.testing.assert_array_equal(first.columns["mmt_am"],
                                  again.columns["mmt_am"])
    assert "io" not in again.timings  # nothing new to read


def test_polars_backend_raises_naming_the_reason(minute_dir, tmp_path,
                                                 monkeypatch):  # noqa: F811
    """``backend='polars'`` runs now (tests/test_torch_refdiff.py holds its
    output); with no reference tree it raises what the JAX package raises,
    the harness's FileNotFoundError naming the missing file, before any
    day is read, and writes no cache."""
    from replication_of_minute_frequency_factor_tpu_torch.refdiff import (
        harness)
    from tools.refdiff import harness as jax_harness

    for h in (harness, jax_harness):
        monkeypatch.setattr(h, "REFERENCE_DIR", str(tmp_path / "no_tree"))
        monkeypatch.setattr(h, "_ref_kernels_mod", None)
    errors, seen = [], []
    for run in (lambda c: pl.compute_exposures(
                    minute_dir, cfg=_cfg(backend="polars"), cache_path=c,
                    progress=False, device="cpu", fault_hook=seen.append),
                lambda c: jax_compute_exposures(
                    minute_dir, cfg=JConfig(backend="polars"),
                    cache_path=c, progress=False, fault_hook=seen.append)):
        cache = str(tmp_path / f"cache{len(errors)}.parquet")
        with pytest.raises(FileNotFoundError, match="no_tree") as exc:
            run(cache)
        errors.append(str(exc.value))
        assert not os.path.exists(cache)
    assert errors[0] == errors[1] and seen == []


def test_unknown_backend_and_fixed_quirks_off_device_raise(
        minute_dir):  # noqa: F811
    with pytest.raises(ValueError, match="backend must be one of"):
        pl.compute_exposures(minute_dir, cfg=_cfg(backend="jax"),
                             progress=False, device="cpu")
    with pytest.raises(ValueError, match="replicate_quirks=False"):
        pl.compute_exposures(
            minute_dir, cfg=_cfg(backend="numpy", replicate_quirks=False),
            progress=False)


def test_backend_config_defaults_and_env(monkeypatch):
    """``backend`` defaults to the device path and reads ``MFF_BACKEND``,
    as the JAX package's field does; ``donate_buffers`` and
    ``profile_dir`` have the JAX package's defaults and overrides."""
    assert Config().backend == "torch" and JConfig().backend == "jax"
    assert Config().donate_buffers is JConfig().donate_buffers is True
    assert Config().profile_dir is JConfig().profile_dir is None
    monkeypatch.setenv("MFF_BACKEND", "numpy")
    monkeypatch.setenv("MFF_PROFILE_DIR", "/tmp/prof")
    monkeypatch.setenv("MFF_DONATE_BUFFERS", "0")
    t, j = Config.from_env(), JConfig.from_env()
    for field in ("backend", "profile_dir", "donate_buffers"):
        assert getattr(t, field) == getattr(j, field), field
    assert (t.backend, t.profile_dir, t.donate_buffers) == (
        "numpy", "/tmp/prof", False)
