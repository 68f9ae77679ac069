"""The port's session specs, pins and config fields equal the JAX
package's: the state that carries across the port."""

import dataclasses

import numpy as np
import pytest

from replication_of_minute_frequency_factor_tpu import config as jconfig
from replication_of_minute_frequency_factor_tpu import markets as jmarkets
from replication_of_minute_frequency_factor_tpu import pins as jpins
from replication_of_minute_frequency_factor_tpu_torch import config as tconfig
from replication_of_minute_frequency_factor_tpu_torch import markets as tmarkets
from replication_of_minute_frequency_factor_tpu_torch import pins as tpins

SESSIONS = ("cn_ashare_240", "us_390", "hk_halfday", "crypto_1440")


def test_same_registered_sessions():
    assert tmarkets.session_names() == jmarkets.session_names()
    assert set(SESSIONS) <= set(tmarkets.session_names())
    assert tmarkets.DEFAULT_SESSION.name == jmarkets.DEFAULT_SESSION.name


@pytest.mark.parametrize("name", SESSIONS)
def test_session_spec_equal_field_by_field(name):
    t, j = tmarkets.get_session(name), jmarkets.get_session(name)
    for f in dataclasses.fields(j):
        assert getattr(t, f.name) == getattr(j, f.name), f.name
    assert t.n_slots == j.n_slots
    assert t.mask_bytes == j.mask_bytes
    assert t.grid_times.dtype == j.grid_times.dtype
    np.testing.assert_array_equal(t.grid_times, j.grid_times)
    assert t.sentinels == j.sentinels
    for k, v in j.sentinels.items():
        assert getattr(t, k) == v
    assert t.describe() == j.describe()


@pytest.mark.parametrize("name", SESSIONS)
def test_time_to_slot_matches(name):
    t, j = tmarkets.get_session(name), jmarkets.get_session(name)
    rng = np.random.default_rng(3)
    times = np.concatenate([
        j.grid_times,
        rng.integers(0, 24, 64) * 10_000_000
        + rng.integers(0, 60, 64) * 100_000
        + rng.choice([0, 0, 0, 1000], 64)])
    np.testing.assert_array_equal(t.time_to_slot(times),
                                  j.time_to_slot(times))
    slots = np.arange(j.n_slots)
    np.testing.assert_array_equal(t.slot_to_time(slots),
                                  j.slot_to_time(slots))


def test_register_session_refuses_a_changed_layout():
    spec = tmarkets.get_session("us_390")
    assert tmarkets.register_session(spec) is spec
    with pytest.raises(ValueError, match="already registered"):
        tmarkets.register_session(
            dataclasses.replace(spec, segments=((9 * 60 + 30, 389),)))
    with pytest.raises(KeyError, match="unknown session"):
        tmarkets.get_session("nope")


def test_pins_readings_equal():
    assert tpins.READINGS == jpins.READINGS
    assert tpins._VALID == jpins._VALID
    for name in jpins.READINGS:
        assert tpins.reading(name) == jpins.reading(name)


def test_pinned_flips_and_restores():
    with tpins.pinned(constant_window="noise"):
        assert tpins.reading("constant_window") == "noise"
    assert tpins.reading("constant_window") == "degenerate"
    with pytest.raises(ValueError, match="unknown reading"):
        tpins.pinned(constant_window="bogus")


def test_config_fields_carry_across(monkeypatch):
    j, t = jconfig.Config(), tconfig.Config()
    assert t.replicate_quirks == j.replicate_quirks
    # the port's rolling_impl values are its own: 'cuda' by default
    assert t.rolling_impl == "cuda"
    monkeypatch.setenv("MFF_ROLLING_IMPL", "torch")
    monkeypatch.setenv("MFF_REPLICATE_QUIRKS", "0")
    assert tconfig.Config.from_env().rolling_impl == "torch"
    assert tconfig.Config.from_env().replicate_quirks is False
    assert jconfig.Config.from_env().replicate_quirks is False
    # the host driver's fields: the JAX package's defaults and overrides
    # ... and the evaluation's data roots and stock-pool file
    # ... and the streaming snapshot's finalize
    fields = ("minute_dir", "days_per_batch", "wire_transfer",
              "debug_validate", "attribution_tolerance", "daily_pv_path",
              "factor_dir", "stock_pool_path", "finalize_impl")
    for field in fields:
        assert getattr(t, field) == getattr(j, field), field
    assert t.days_per_batch == 8
    monkeypatch.setenv("MFF_MINUTE_DIR", "/data/minute")
    monkeypatch.setenv("MFF_DAYS_PER_BATCH", "3")
    monkeypatch.setenv("MFF_ATTRIBUTION_TOLERANCE", "0.25")
    monkeypatch.setenv("MFF_DAILY_PV_PATH", "/data/pv.parquet")
    monkeypatch.setenv("MFF_FACTOR_DIR", "/data/factors")
    monkeypatch.setenv("MFF_STOCK_POOL_PATH", "/data/pool.parquet")
    monkeypatch.setenv("MFF_FINALIZE_IMPL", "fast")
    tc, jc = tconfig.Config.from_env(), jconfig.Config.from_env()
    for field in fields:
        assert getattr(tc, field) == getattr(jc, field), field
    assert (tc.minute_dir, tc.days_per_batch, tc.attribution_tolerance,
            tc.daily_pv_path, tc.factor_dir, tc.stock_pool_path,
            tc.finalize_impl) \
        == ("/data/minute", 3, 0.25, "/data/pv.parquet", "/data/factors",
            "/data/pool.parquet", "fast")
    # every port field is a JAX field; the others are not fields at all
    assert {f.name for f in dataclasses.fields(t)} <= set(vars(j))
    assert t.mesh_shape is None and j.mesh_shape is None
    assert not hasattr(t, "compile_telemetry") \
        and not hasattr(t, "not_ported")


def test_sessions_module_pins_every_jax_constant():
    """The port's ``sessions.py`` (the cn_ashare_240 constants) equals the
    JAX package's, name by name, and its slot conversions agree."""
    from replication_of_minute_frequency_factor_tpu import sessions as js
    from replication_of_minute_frequency_factor_tpu_torch import (
        sessions as ts)

    names = [k for k in vars(js) if k.isupper()]
    assert len(names) >= 19
    assert sorted(k for k in vars(ts) if k.isupper()) == sorted(names)
    for k in names:
        a, b = getattr(ts, k), getattr(js, k)
        if isinstance(b, np.ndarray):
            assert a.dtype == b.dtype, k
            np.testing.assert_array_equal(a, b, err_msg=k)
        elif k == "SPEC":
            assert a.describe() == b.describe()
        else:
            assert type(a) is type(b) and a == b, k
    times = np.array([93000000, 112900000, 113000000, 130000000, 145900000,
                      150000000, 93000500, -1, 0])
    np.testing.assert_array_equal(ts.time_to_slot(times),
                                  js.time_to_slot(times))
    slots = np.arange(240)
    np.testing.assert_array_equal(ts.slot_to_time(slots),
                                  js.slot_to_time(slots))
