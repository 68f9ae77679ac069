"""Driver fuzz (``tools/fuzz/fuzz_pipeline.py``) on a device:
``compute_exposures`` over random day sequences of int-coded and
string-coded parquet day files.

* Below seed 10k (resume): a first run with an optional day failing
  through the fault hook and an optional transient launch failure (one,
  which the batch retry must hide), then newer days and a resume that
  computes exactly the days past the cache's newest, a reload of the
  cache, and a no-op rerun that keeps every value's bits.
* From 10k (isolation): one persistently poisoned day (its host prep
  raises) costs exactly itself in any batch geometry, and after healing
  ``retry_failed=True`` recovers it from the failure ledger.
"""

from __future__ import annotations

import logging
import os
import shutil
import tempfile

import numpy as np

from . import scenarios

NAMES = ("vol_return1min", "mmt_pm", "doc_kurt")


class DeviceChaos:
    """Transient launch failures: each ``compute_packed_prepared`` call
    fails with probability ``p``, at most ``max_fails`` times in all."""

    def __init__(self, real, rng, p, max_fails):
        self.real = real
        self.rng = rng
        self.p = p
        self.left = max_fails

    def __call__(self, *a, **kw):
        if self.left > 0 and self.rng.random() < self.p:
            self.left -= 1
            raise RuntimeError("chaos: injected device failure")
        return self.real(*a, **kw)


def write_day(d: str, date_str: str, cols, int_codes: bool) -> None:
    import pyarrow as pa
    import pyarrow.parquet as pq

    if int_codes:
        code_col = pa.array(cols["code"].astype(np.int64))
    else:
        code_col = pa.array([str(c) for c in cols["code"]])
    arrays = {"code": code_col, "time": pa.array(cols["time"])}
    for k in ("open", "high", "low", "close", "volume"):
        arrays[k] = pa.array(cols[k])
    pq.write_table(pa.table(arrays),
                   os.path.join(d, date_str.replace("-", "") + ".parquet"))


def _isolation(c, td, dev) -> None:
    from .. import pipeline as pl
    from ..config import Config

    kline = os.path.join(td, "kline")
    os.mkdir(kline)
    for f in c["files"]:
        write_day(kline, *f)
    days = [f[0] for f in c["files"]]
    poison = c["poison"]
    cache = os.path.join(td, "cache.parquet")
    cfg = Config(days_per_batch=c["days_per_batch"])
    real = pl._grid_batch

    def bad_grid(day_data, shard_mult=1):
        if any(str(d) == poison for d, _ in day_data):
            raise RuntimeError("poisoned day")
        return real(day_data, shard_mult=shard_mult)

    pl._grid_batch = bad_grid
    try:
        t1 = pl.compute_exposures(kline, NAMES, cache_path=cache, cfg=cfg,
                                  progress=False, device=dev)
    finally:
        pl._grid_batch = real
    assert t1.failures.keys() == [poison], (t1.failures.keys(), poison)
    assert set(map(str, t1.columns["date"])) == set(days) - {poison}
    t2 = pl.compute_exposures(kline, NAMES, cache_path=cache, cfg=cfg,
                              progress=False, retry_failed=True, device=dev)
    assert set(map(str, t2.columns["date"])) == set(days)
    assert not t2.failures
    assert not os.path.exists(cache + ".failures.json")


def _resume(c, seed, td, dev) -> None:
    from .. import pipeline as pl
    from ..config import Config

    kline = os.path.join(td, "kline")
    os.mkdir(kline)
    for f in c["first"]:
        write_day(kline, *f)
    all_days, n1 = c["all_days"], c["n1"]
    cache = os.path.join(td, "cache.parquet")
    cfg = Config(days_per_batch=c["days_per_batch"])
    bad_day = c["bad_day"]

    def hook(date):
        if bad_day is not None and date == bad_day:
            raise RuntimeError("injected")

    real = pl.compute_packed_prepared
    if c["chaos_p"] is not None:
        # one transient failure rides the batch retry and must be
        # invisible (two could fail one batch's launch and its retry)
        pl.compute_packed_prepared = DeviceChaos(
            real, np.random.default_rng(seed + 7), c["chaos_p"], 1)
    try:
        t1 = pl.compute_exposures(kline, NAMES, cache_path=cache, cfg=cfg,
                                  progress=False, fault_hook=hook,
                                  device=dev)
    finally:
        pl.compute_packed_prepared = real
    days1 = set(map(str, t1.columns["date"]))
    want1 = set(all_days[:n1]) - ({str(bad_day)} if bad_day is not None
                                  else set())
    assert days1 == want1, (days1, want1)
    if bad_day is not None:
        assert len(t1.failures) == 1
        assert os.path.exists(cache + ".failures.json")
    for f in c["second"]:
        write_day(kline, *f)
    t2 = pl.compute_exposures(kline, NAMES, cache_path=cache, cfg=cfg,
                              progress=False, device=dev)
    days2 = set(map(str, t2.columns["date"]))
    if not days1:
        want2 = set(all_days)  # no cache was written: a full recompute
    else:
        # everything newer than the cache's newest day, a failed day
        # that sorts after it included
        want2 = days1 | {d for d in all_days if d > max(days1)}
    assert days2 == want2, (days2, want2)
    t3 = pl.ExposureTable.load(cache)
    assert set(map(str, t3.columns["date"])) == days2
    assert tuple(t3.factor_names) == NAMES
    t4 = pl.compute_exposures(kline, NAMES, cache_path=cache, cfg=cfg,
                              progress=False, device=dev)
    for n in NAMES:
        np.testing.assert_array_equal(
            np.asarray(t4.columns[n]).view(np.int32),
            np.asarray(t2.columns[n]).view(np.int32), err_msg=n)


def check_case(seed: int, dev) -> None:
    c = scenarios.pipeline_case(seed)
    td = tempfile.mkdtemp()
    try:
        if c["kind"] == "isolation":
            _isolation(c, td, dev)
        else:
            _resume(c, seed, td, dev)
    finally:
        shutil.rmtree(td, ignore_errors=True)


def run(lo: int, hi: int, device="cuda"):
    from .. import pipeline as pl
    from . import device_of, sweep

    dev = device_of(device)
    # the driver logs every injected failure it isolates: expected here
    log = logging.getLogger(pl.__name__)
    level = log.level
    log.setLevel(logging.ERROR)
    try:
        return sweep("pipeline", range(lo, hi),
                     lambda s: check_case(s, dev))
    finally:
        log.setLevel(level)
