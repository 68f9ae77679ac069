"""The frozen data recipes byte for byte against the originals they copy,
and the sample of checked lanes as a function of the seed alone."""

import json
import sys

import numpy as np
import pytest

from perfbench import recipes
from perfbench.drivers import common
from perfbench.reference import sessions

from conftest import BENCH, ROOT

sys.path.insert(0, str(ROOT / "tests"))
torch_cases = pytest.importorskip("torch_cases")

SESSIONS = {name: sessions.from_config(json.loads(
    (BENCH / "configs" / f"{cfg}.json").read_text())["session"])
    for name, cfg in (("cn_ashare_240", "cn_ashare_5000"),
                      ("us_390", "us_russell3000"))}


@pytest.mark.parametrize("session", sorted(SESSIONS))
@pytest.mark.parametrize("seed", [0, 2**31 + 17, 2**40 + 3])
def test_make_batch_is_torch_cases(session, seed):
    n_slots = SESSIONS[session].n_slots
    got = recipes.year_batch(seed, 1, 2, 7, n_slots)
    want = torch_cases.Year(seed, 2, 2, 7, session)[1]
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.tobytes() == w.tobytes()


@pytest.mark.parametrize("session", sorted(SESSIONS))
def test_synth_day_is_the_ports(session):
    from replication_of_minute_frequency_factor_tpu_torch.data import (
        synth_day)

    kw = dict(n_codes=40, missing_prob=0.02, zero_volume_prob=0.01,
              constant_price_codes=3, short_day_codes=3, date="2024-01-03")
    got = recipes.synth_day(np.random.default_rng(9), SESSIONS[session],
                            **kw)
    want = synth_day(np.random.default_rng(9), session=session, **kw)
    assert got.keys() == want.keys()
    for k in want:
        assert got[k].dtype == want[k].dtype
        assert got[k].tobytes() == want[k].tobytes()


def test_sessions_are_the_ports():
    from replication_of_minute_frequency_factor_tpu_torch.markets import (
        get_session)

    for name, spec in SESSIONS.items():
        port = get_session(name)
        assert spec.n_slots == port.n_slots
        assert np.array_equal(spec.grid_times, port.grid_times)
        assert spec.sentinels == port.sentinels


def test_trading_dates():
    assert recipes.trading_dates(6) == [
        "2024-01-02", "2024-01-03", "2024-01-04", "2024-01-05",
        "2024-01-08", "2024-01-09"]


def test_the_sample_depends_on_the_seed_alone():
    a = common.sample(2**31 + 99, 5000, 600, 3)
    assert np.array_equal(a, common.sample(2**31 + 99, 5000, 600, 3))
    assert len(np.unique(a)) == 600 and (np.diff(a) > 0).all()
    assert not np.array_equal(a, common.sample(2**31 + 98, 5000, 600, 3))
    assert len(common.sample(1, 4, 10, 0)) == 4
