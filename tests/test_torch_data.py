"""The port's ``grid_day`` and ``synth_day`` are bitwise the JAX
package's (its numpy gridding path), at every registered session."""

import numpy as np
import pytest

from replication_of_minute_frequency_factor_tpu import data as jdata
from replication_of_minute_frequency_factor_tpu_torch import data as tdata

SESSIONS = ("cn_ashare_240", "us_390", "hk_halfday", "crypto_1440")
SYNTH_KW = dict(n_codes=6, missing_prob=0.1, zero_volume_prob=0.1,
                constant_price_codes=1, short_day_codes=1)


def _assert_same_columns(a, b):
    assert set(a) == set(b)
    for k in a:
        assert a[k].dtype == b[k].dtype, k
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


@pytest.mark.parametrize("session", SESSIONS)
def test_synth_day_bitwise(session):
    t = tdata.synth_day(np.random.default_rng(11), session=session,
                        **SYNTH_KW)
    j = jdata.synth_day(np.random.default_rng(11), session=session,
                        **SYNTH_KW)
    _assert_same_columns(t, j)


def _messy_rows(session, seed=5):
    """A synthetic day plus the rows gridding must handle: off-grid and
    sub-minute times, an unknown code, and a duplicate (code, slot)."""
    day = jdata.synth_day(np.random.default_rng(seed), session=session,
                          **SYNTH_KW)
    extra = {
        "code": np.array([day["code"][0], day["code"][1], "999999",
                          day["code"][2]]),
        "time": np.array([235900000 if session != "crypto_1440"
                          else 235900500, day["time"][3] + 1000,
                          day["time"][0], day["time"][5]], np.int64),
    }
    for k in ("open", "high", "low", "close", "volume"):
        extra[k] = np.full(4, 7.5)
    return {k: np.concatenate([day[k], extra[k]]) for k in extra}


@pytest.mark.parametrize("session", SESSIONS)
def test_grid_day_bitwise(session):
    rows = _messy_rows(session)
    args = [rows[k] for k in ("code", "time", "open", "high", "low",
                              "close", "volume")]
    t = tdata.grid_day(*args, session=session)
    j = jdata.grid_day(*args, session=session, use_native=False)
    assert t.bars.dtype == j.bars.dtype == np.float32
    np.testing.assert_array_equal(t.bars, j.bars)
    np.testing.assert_array_equal(t.mask, j.mask)
    np.testing.assert_array_equal(t.codes, j.codes)
    # a pinned ticker axis (cross-day batching) grids the same way
    codes = np.array(sorted(set(rows["code"]) | {"000001"}))[::-1]
    t = tdata.grid_day(*args, codes=codes, session=session)
    j = jdata.grid_day(*args, codes=codes, session=session,
                       use_native=False)
    np.testing.assert_array_equal(t.bars, j.bars)
    np.testing.assert_array_equal(t.mask, j.mask)
    np.testing.assert_array_equal(t.codes, j.codes)


def test_grid_day_keeps_the_last_duplicate():
    code = np.array(["600000", "600000"])
    time = np.array([93000000, 93000000], np.int64)
    vals = [np.array([1.0, 2.0])] * 5
    g = tdata.grid_day(code, time, *vals)
    assert g.mask.sum() == 1 and g.bars[0, 0, 3] == 2.0
