"""The port's host driver: ``compute_exposures`` over day files, on the CPU.

Every test of tests/test_pipeline.py that the port's host driver covers,
with the same ``minute_dir`` fixture (three 6-ticker days from
``rng(0)``) and ``device='cpu'``: file listing, end to end, resume,
failed, corrupted and unrepresentable days, the atomic write, schema
drift, every injected device failure (retry, breaker, isolation,
give-up), the factor top-up, the cache that never shrinks, the failure
ledger's lifetime, int- vs str-coded files. Then the port against the JAX
package's host driver on the same directory (codes, dates and row order
bitwise, NaN and inf positions identical, values through
tests/test_parity.py's comparator),
and against the vendored reference snapshot at the JAX test's own
tolerance; the ``pipeline.*`` telemetry of tests/test_telemetry.py; and
the cache as one contract: each package resumes a parquet and an ``.mffz``
cache the other wrote.
"""

import json
import os

import numpy as np
import pandas as pd
import pyarrow as pa
import pyarrow.parquet as pq
import pytest
import torch

from replication_of_minute_frequency_factor_tpu.config import Config as JConfig
from replication_of_minute_frequency_factor_tpu.data.synthetic import synth_day
from replication_of_minute_frequency_factor_tpu.pipeline import (
    compute_exposures as jax_compute_exposures)
from replication_of_minute_frequency_factor_tpu_torch import native
from replication_of_minute_frequency_factor_tpu_torch import pipeline as pl
from replication_of_minute_frequency_factor_tpu_torch.config import Config
from replication_of_minute_frequency_factor_tpu_torch.data import io as dio
from replication_of_minute_frequency_factor_tpu_torch.pipeline import (
    ExposureTable)
from replication_of_minute_frequency_factor_tpu_torch.telemetry import (
    Telemetry, get_telemetry, reconcile, set_telemetry)
from test_parity import (
    _check_cell, _degenerate_beta_codes, _doc_pdf_acceptable, _lazy)
from test_pipeline import (
    NAMES, _Flaky, _assert_matches_snapshot, _load_snapshot, _write_day)


def compute_exposures(*args, **kw):
    """The port's ``compute_exposures`` on the CPU (the tests' only
    device)."""
    kw.setdefault("progress", False)
    return pl.compute_exposures(*args, device="cpu", **kw)


@pytest.fixture
def minute_dir(tmp_path, rng):
    d = tmp_path / "kline"
    d.mkdir()
    for ds in ("2024-01-02", "2024-01-03", "2024-01-04"):
        _write_day(str(d), rng, ds, missing_prob=0.05)
    return str(d)


def _cfg(**kw):
    kw.setdefault("days_per_batch", 2)
    return Config(**kw)


def _dates(t):
    return set(map(str, np.unique(t.columns["date"])))


def test_day_file_listing_and_date_parse(minute_dir):
    files = dio.list_day_files(minute_dir)
    assert [str(d) for d, _ in files] == [
        "2024-01-02", "2024-01-03", "2024-01-04"]
    assert dio.parse_day_filename("foo.parquet") is None
    assert dio.parse_day_filename("20240102.parquet") == np.datetime64(
        "2024-01-02")
    assert dio.parse_day_filename("20241302.parquet") is None


def test_compute_exposures_end_to_end(minute_dir, tmp_path):
    cache = str(tmp_path / "factors.parquet")
    t = compute_exposures(minute_dir, NAMES, cache_path=cache, cfg=_cfg())
    assert t.factor_names == NAMES
    assert len(np.unique(t.columns["date"])) == 3
    # sorted by (date, code)
    order = np.lexsort((t.columns["code"], t.columns["date"]))
    assert (order == np.arange(len(t))).all()
    # cache written and loadable
    t2 = ExposureTable.load(cache)
    assert len(t2) == len(t)
    np.testing.assert_array_equal(t2.columns["code"], t.columns["code"])
    for n in NAMES:
        np.testing.assert_array_equal(t2.columns[n], t.columns[n])
    assert set(t.timings) == {"io", "grid", "wire_encode", "pack", "launch",
                              "device", "save"}
    assert t.reconciliation["stages"].keys() == t.timings.keys()


def test_framed_cache_round_trips(minute_dir, tmp_path):
    cache = str(tmp_path / "factors.mffz")
    t = compute_exposures(minute_dir, NAMES, cache_path=cache, cfg=_cfg())
    with open(cache, "rb") as fh:
        assert fh.read(4) == dio.FRAME_MAGIC
    back = ExposureTable.load(cache)
    assert list(back.columns) == list(t.columns)
    np.testing.assert_array_equal(back.columns["date"], t.columns["date"])
    for n in NAMES:
        np.testing.assert_array_equal(back.columns[n], t.columns[n])


def test_incremental_resume_only_computes_new_days(minute_dir, tmp_path, rng):
    cache = str(tmp_path / "factors.parquet")
    compute_exposures(minute_dir, NAMES, cache_path=cache, cfg=_cfg())
    base = ExposureTable.load(cache)
    # add a new day; only it should be computed, and old rows must survive
    _write_day(minute_dir, rng, "2024-01-05")
    seen = []
    t = compute_exposures(minute_dir, NAMES, cache_path=cache, cfg=_cfg(),
                          fault_hook=lambda d: seen.append(d))
    assert seen == [np.datetime64("2024-01-05")]
    assert t.max_date == np.datetime64("2024-01-05")
    old = t.columns["date"] < np.datetime64("2024-01-05")
    assert old.sum() == len(base)
    for n in NAMES:
        np.testing.assert_array_equal(t.columns[n][old], base.columns[n])


def test_failed_day_is_skipped_and_reported(minute_dir, tmp_path):
    bad = np.datetime64("2024-01-03")

    def hook(date):
        if date == bad:
            raise RuntimeError("injected fault")

    cache = str(tmp_path / "f.parquet")
    t = compute_exposures(minute_dir, NAMES, cfg=_cfg(), fault_hook=hook,
                          cache_path=cache)
    assert t.failures.keys() == [str(bad)]
    assert "injected fault" in t.failures.summary()
    assert bad not in t.columns["date"]
    assert len(np.unique(t.columns["date"])) == 2
    # the ledger persists next to the cache for post-run inspection
    with open(cache + ".failures.json") as fh:
        rec = json.load(fh)
    assert rec[0]["key"] == str(bad) and "injected fault" in rec[0]["error"]
    # a clean rerun does NOT reattempt the lost mid-history day (resume
    # filters past the cache max), so the ledger carries forward
    compute_exposures(minute_dir, NAMES, cfg=_cfg(), cache_path=cache)
    with open(cache + ".failures.json") as fh:
        assert [r["key"] for r in json.load(fh)] == [str(bad)]
    # retry_failed recovers it; only then is the ledger cleared
    t2 = compute_exposures(minute_dir, NAMES, cfg=_cfg(), cache_path=cache,
                           retry_failed=True)
    assert str(bad) in _dates(t2)
    assert not os.path.exists(cache + ".failures.json")


def test_corrupted_day_file_is_skipped_and_reported(minute_dir, tmp_path):
    bad = [f for f in os.listdir(minute_dir) if f.startswith("20240103")][0]
    with open(os.path.join(minute_dir, bad), "wb") as fh:
        fh.write(b"not a parquet file")
    t = compute_exposures(minute_dir, NAMES, cfg=_cfg(),
                          cache_path=str(tmp_path / "f.parquet"))
    assert t.failures.keys() == ["2024-01-03"]
    assert np.datetime64("2024-01-03") not in t.columns["date"]
    assert len(np.unique(t.columns["date"])) == 2


def test_wire_unrepresentable_day_falls_back_to_raw(tmp_path, rng):
    """Off-tick prices make wire.encode return None; the pipeline must
    ship raw f32 and produce the numbers it gives with the wire off."""
    d = tmp_path / "kline_offtick"
    d.mkdir()
    cols = synth_day(rng, n_codes=6, date="2024-01-02")
    for k in ("open", "high", "low", "close"):
        cols[k] = cols[k] + 0.0005  # off the 0.01 CNY tick grid
    arrays = {"code": pa.array([str(c) for c in cols["code"]]),
              "time": pa.array(cols["time"])}
    for k in ("open", "high", "low", "close", "volume"):
        arrays[k] = pa.array(cols[k])
    pq.write_table(pa.table(arrays), str(d / "20240102.parquet"))

    tel = Telemetry()
    on = compute_exposures(str(d), NAMES, cfg=_cfg(), telemetry=tel)
    off = compute_exposures(str(d), NAMES,
                            cfg=_cfg(wire_transfer=False))
    assert len(on) == 6 and not on.failures
    assert "wire_encode" in on.timings  # encode attempted, fell back
    assert "wire_encode" not in off.timings
    assert tel.registry.counter_value("pipeline.encode_kind",
                                      kind="raw") == 1
    for n in NAMES:
        np.testing.assert_array_equal(on.columns[n], off.columns[n])


@pytest.mark.parametrize("field,value", [
    ("compile_telemetry", True),
    ("compilation_cache_dir", "cache")])
def test_fields_not_ported_raise(field, value):
    assert hasattr(JConfig(), field)
    with pytest.raises(TypeError, match=field):
        _cfg(**{field: value})


def test_compute_exposures_refuses_the_cpu_unless_asked(minute_dir,
                                                        monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        pl.compute_exposures(minute_dir, NAMES, cfg=_cfg(), progress=False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        pl.compute_exposures(minute_dir, NAMES, cfg=_cfg(), progress=False,
                             device="cuda")


def test_atomic_write_leaves_no_temp_on_failure(tmp_path):
    path = str(tmp_path / "out.parquet")

    class Boom:
        pass

    for write in (dio.write_parquet_atomic, dio.write_framed_table_atomic):
        with pytest.raises(Exception):
            write(Boom(), path)  # not a table -> raises
        assert not os.path.exists(path)
        assert [f for f in os.listdir(tmp_path) if f.endswith(".tmp")] == []


def test_single_factor_view_matches_reference_shape(minute_dir):
    t = compute_exposures(minute_dir, NAMES, cfg=_cfg())
    one = t.single("mmt_am")
    assert set(one) == {"code", "date", "mmt_am"}
    assert len(one["mmt_am"]) == len(t)


def test_failed_day_retry_semantics(minute_dir, tmp_path):
    """A failed day NEWER than everything cached is retried on the next
    run, one OLDER than the cache max stays skipped until retry_failed
    re-lists it from the ledger."""
    cache = str(tmp_path / "f.parquet")

    def fail_on(target):
        def hook(date):
            if str(date) == target:
                raise RuntimeError("injected")
        return hook

    t1 = compute_exposures(minute_dir, NAMES, cache_path=cache, cfg=_cfg(),
                           fault_hook=fail_on("2024-01-04"))
    assert _dates(t1) == {"2024-01-02", "2024-01-03"}
    t2 = compute_exposures(minute_dir, NAMES, cache_path=cache, cfg=_cfg())
    assert _dates(t2) == {"2024-01-02", "2024-01-03", "2024-01-04"}
    assert not t2.failures

    cache2 = str(tmp_path / "g.parquet")
    t3 = compute_exposures(minute_dir, NAMES, cache_path=cache2, cfg=_cfg(),
                           fault_hook=fail_on("2024-01-03"))
    assert _dates(t3) == {"2024-01-02", "2024-01-04"}
    t4 = compute_exposures(minute_dir, NAMES, cache_path=cache2, cfg=_cfg())
    assert _dates(t4) == {"2024-01-02", "2024-01-04"}
    with open(cache2 + ".failures.json") as fh:
        assert [r["key"] for r in json.load(fh)] == ["2024-01-03"]
    t5 = compute_exposures(minute_dir, NAMES, cache_path=cache2,
                           cfg=_cfg(), retry_failed=True)
    assert _dates(t5) == {"2024-01-02", "2024-01-03", "2024-01-04"}
    assert not t5.failures
    assert not os.path.exists(cache2 + ".failures.json")
    t6 = compute_exposures(minute_dir, NAMES, cache_path=cache2,
                           cfg=_cfg(), retry_failed=True)
    assert len(t6) == len(t5)


def test_ledger_entry_survives_until_resolved(minute_dir, tmp_path):
    cache = str(tmp_path / "f.parquet")
    compute_exposures(minute_dir, NAMES, cache_path=cache, cfg=_cfg())
    ledger = cache + ".failures.json"
    phantom = [{"key": "2023-12-29", "source": "gone.parquet",
                "error": "RuntimeError: old failure", "trace": ""}]
    with open(ledger, "w") as fh:
        json.dump(phantom, fh)
    t = compute_exposures(minute_dir, NAMES, cache_path=cache,
                          cfg=_cfg(), retry_failed=True)
    assert not t.failures
    with open(ledger) as fh:
        assert [r["key"] for r in json.load(fh)] == ["2023-12-29"]
    with open(ledger, "w") as fh:
        fh.write('["2023-12-29"]')  # list of strings, not records
    t = compute_exposures(minute_dir, NAMES, cache_path=cache,
                          cfg=_cfg(), retry_failed=True)
    assert not t.failures
    assert not os.path.exists(ledger)


def test_concat_rejects_schema_drift():
    a = ExposureTable.empty(["vol_return1min"])
    b = ExposureTable.empty(["mmt_pm"])
    with pytest.raises(ValueError, match="columns"):
        ExposureTable.concat([a, b])
    c = ExposureTable({"code": np.array([], dtype=object),
                       "date": np.array([], dtype="datetime64[D]"),
                       "mmt_pm": np.array([], dtype=np.float32)})
    d = ExposureTable({"mmt_pm": np.array([], dtype=np.float32),
                       "code": np.array([], dtype=object),
                       "date": np.array([], dtype="datetime64[D]")})
    assert list(ExposureTable.concat([c, d]).columns) == list(c.columns)
    with pytest.raises(ValueError, match="'code' and 'date'"):
        ExposureTable({"mmt_pm": np.array([], dtype=np.float32)})


def test_debug_validate_isolates_the_bad_day(minute_dir, tmp_path):
    """``cfg.debug_validate`` runs ``validate_batch`` in host prep: a day
    with an inverted bar fails alone (host-prep isolation), its
    batch-mates survive, and the checker reads as the JAX package's."""
    from replication_of_minute_frequency_factor_tpu.utils.debug import (
        validate_batch as jax_validate)
    from replication_of_minute_frequency_factor_tpu_torch.utils.debug import (
        DayDataError, validate_batch)
    path = [p for d, p in dio.list_day_files(minute_dir)
            if str(d) == "2024-01-03"][0]
    day = pq.read_table(path).to_pandas()
    day.loc[3, "high"] = day.loc[3, "low"] - 0.5
    day.loc[4, "volume"] = -100.0
    pq.write_table(pa.Table.from_pandas(day, preserve_index=False), path)
    t = compute_exposures(minute_dir, NAMES, cfg=_cfg(days_per_batch=3,
                                                      debug_validate=True),
                          cache_path=str(tmp_path / "c.parquet"))
    assert t.failures.keys() == ["2024-01-03"]
    assert "high < low" in t.failures.summary()
    assert _dates(t) == {"2024-01-02", "2024-01-04"}
    loose = compute_exposures(minute_dir, NAMES, cfg=_cfg(days_per_batch=3))
    assert not loose.failures
    bars, mask, _, _ = pl._grid_batch(
        [(d, dio.read_minute_day_raw(p))
         for d, p in dio.list_day_files(minute_dir)])
    assert validate_batch(bars, mask, raise_=False) == jax_validate(
        bars, mask, raise_=False) != []
    with pytest.raises(DayDataError, match="negative volume"):
        validate_batch(bars, mask)


def _patch(monkeypatch, fn):
    monkeypatch.setattr(pl, "compute_packed_prepared", fn)


def _count_calls(fail_on):
    """A compute_packed_prepared double failing the calls numbered in
    ``fail_on`` (a set, or a callable of the call number)."""
    real = pl.compute_packed_prepared
    calls = {"n": 0}

    def double(*a, **kw):
        calls["n"] += 1
        bad = fail_on(calls["n"]) if callable(fail_on) else \
            calls["n"] in fail_on
        if bad:
            raise RuntimeError("injected device failure")
        return real(*a, **kw)
    return double, calls


def test_transient_device_failure_is_retried(minute_dir, tmp_path,
                                             monkeypatch):
    flaky = _Flaky(pl.compute_packed_prepared, fail_first=1)
    _patch(monkeypatch, flaky)
    t = compute_exposures(minute_dir, ["vol_return1min"],
                          cache_path=str(tmp_path / "c.parquet"), cfg=_cfg())
    assert len(t.failures) == 0
    assert len(np.unique(t.columns["date"])) == 3
    assert flaky.calls >= 2


def test_dead_device_trips_circuit_breaker_and_saves_progress(
        minute_dir, tmp_path, monkeypatch):
    _patch(monkeypatch, _Flaky(pl.compute_packed_prepared,
                               fail_first=10 ** 9))
    cache = str(tmp_path / "c.parquet")
    with pytest.raises(RuntimeError, match="consecutive"):
        compute_exposures(minute_dir, ["vol_return1min"], cache_path=cache,
                          cfg=_cfg(days_per_batch=1))
    assert os.path.exists(cache + ".failures.json")


def test_single_bad_batch_is_skipped_not_fatal(minute_dir, tmp_path,
                                               monkeypatch):
    double, _ = _count_calls({2, 3})  # batch 2: launch and retry
    _patch(monkeypatch, double)
    t = compute_exposures(minute_dir, ["vol_return1min"],
                          cache_path=str(tmp_path / "c.parquet"),
                          cfg=_cfg(days_per_batch=1))
    assert len(t.failures) == 1
    assert len(np.unique(t.columns["date"])) == 2


def test_poisoned_day_is_isolated_from_its_batch(minute_dir, tmp_path,
                                                 monkeypatch):
    """Call sequence: 1 = batch launch, 2 = batch retry, 3/4/5 = per-day
    isolation (day 2 poisoned)."""
    double, calls = _count_calls({1, 2, 4})
    _patch(monkeypatch, double)
    t = compute_exposures(minute_dir, ["vol_return1min"],
                          cache_path=str(tmp_path / "c.parquet"),
                          cfg=_cfg(days_per_batch=3))
    assert calls["n"] == 5
    assert t.failures.keys() == ["2024-01-03"]
    assert _dates(t) == {"2024-01-02", "2024-01-04"}


def test_transient_batch_failure_isolates_to_zero_losses(
        minute_dir, tmp_path, monkeypatch):
    double, _ = _count_calls({1, 2})
    _patch(monkeypatch, double)
    t = compute_exposures(minute_dir, ["vol_return1min"],
                          cache_path=str(tmp_path / "c.parquet"),
                          cfg=_cfg(days_per_batch=3))
    assert not t.failures
    assert len(np.unique(t.columns["date"])) == 3


def test_hostfail_batch_isolates_innocent_days(minute_dir, tmp_path,
                                               monkeypatch):
    real_grid = pl._grid_batch

    def bad_grid(day_data):
        if any(str(d) == "2024-01-03" for d, _ in day_data):
            raise RuntimeError("injected grid failure")
        return real_grid(day_data)

    monkeypatch.setattr(pl, "_grid_batch", bad_grid)
    t = compute_exposures(minute_dir, ["vol_return1min"],
                          cache_path=str(tmp_path / "c.parquet"),
                          cfg=_cfg(days_per_batch=3))
    assert t.failures.keys() == ["2024-01-03"]
    assert _dates(t) == {"2024-01-02", "2024-01-04"}


def test_repeated_isolation_still_trips_the_breaker(minute_dir, tmp_path,
                                                    monkeypatch, rng):
    for ds in ("2024-01-05", "2024-01-08", "2024-01-09"):
        _write_day(minute_dir, rng, ds, missing_prob=0.05)  # 6 days total
    # per 2-day batch: launch fail, retry fail, two solo passes
    double, _ = _count_calls(lambda n: (n - 1) % 4 < 2)
    _patch(monkeypatch, double)
    with pytest.raises(RuntimeError, match="consecutive"):
        compute_exposures(minute_dir, ["vol_return1min"],
                          cache_path=str(tmp_path / "c.parquet"),
                          cfg=_cfg(days_per_batch=2))
    t = ExposureTable.load(str(tmp_path / "c.parquet"))
    assert len(np.unique(t.columns["date"])) >= 4


def test_isolation_gives_up_against_a_dead_device(minute_dir, tmp_path,
                                                  monkeypatch):
    double, calls = _count_calls(lambda n: True)
    _patch(monkeypatch, double)
    t = compute_exposures(minute_dir, ["vol_return1min"],
                          cache_path=str(tmp_path / "c.parquet"),
                          cfg=_cfg(days_per_batch=3))
    # 2 batch attempts + 2 solo attempts, then give-up
    assert calls["n"] == 4
    assert sorted(t.failures.keys()) == ["2024-01-02", "2024-01-03",
                                         "2024-01-04"]


def test_cache_topup_computes_only_missing_factors(minute_dir, tmp_path,
                                                   caplog):
    import logging
    cache = str(tmp_path / "f.parquet")
    two = ["vol_return1min", "mmt_pm"]
    three = two + ["liq_openvol"]
    compute_exposures(minute_dir, two, cache_path=cache, cfg=_cfg())
    with caplog.at_level(logging.INFO):
        got = compute_exposures(minute_dir, three, cache_path=cache,
                                cfg=_cfg())
    assert any("topping up" in r.message for r in caplog.records)
    assert not any("recomputing all days" in r.message
                   for r in caplog.records)
    fresh = compute_exposures(minute_dir, three,
                              cache_path=str(tmp_path / "g.parquet"),
                              cfg=_cfg())
    assert len(got) == len(fresh)
    np.testing.assert_array_equal(got.columns["code"], fresh.columns["code"])
    for n in three:
        np.testing.assert_array_equal(got.columns[n], fresh.columns[n])
    reread = compute_exposures(minute_dir, three, cache_path=cache,
                               cfg=_cfg())
    assert set(three) <= set(reread.factor_names)


def test_cache_topup_falls_back_when_day_files_changed(minute_dir,
                                                       tmp_path, caplog):
    import logging
    import shutil
    md2 = str(tmp_path / "kline2")
    shutil.copytree(minute_dir, md2)
    cache = str(tmp_path / "f.parquet")
    compute_exposures(md2, ["vol_return1min"], cache_path=cache,
                      cfg=_cfg(minute_dir=md2))
    first = sorted(os.listdir(md2))[0]
    os.remove(os.path.join(md2, first))
    with caplog.at_level(logging.WARNING):
        got = compute_exposures(md2, ["vol_return1min", "mmt_pm"],
                                cache_path=cache, cfg=_cfg(minute_dir=md2))
    assert any("recomputing all days" in r.message for r in caplog.records)
    fresh = compute_exposures(md2, ["vol_return1min", "mmt_pm"],
                              cache_path=str(tmp_path / "h.parquet"),
                              cfg=_cfg(minute_dir=md2))
    assert len(got) == len(fresh)


def test_subset_request_never_shrinks_the_cache(minute_dir, tmp_path, rng):
    cache = str(tmp_path / "f.parquet")
    wide = ["vol_return1min", "mmt_pm", "liq_openvol"]
    compute_exposures(minute_dir, wide, cache_path=cache, cfg=_cfg())
    t = compute_exposures(minute_dir, ["mmt_pm"], cache_path=cache,
                          cfg=_cfg())
    assert set(wide) <= set(ExposureTable.load(cache).factor_names)
    assert set(wide) <= set(t.factor_names)
    _write_day(minute_dir, rng, "2024-01-05")
    compute_exposures(minute_dir, ["mmt_pm"], cache_path=cache, cfg=_cfg())
    reread = ExposureTable.load(cache)
    assert set(wide) <= set(reread.factor_names)
    new_rows = reread.columns["date"] == np.datetime64("2024-01-05")
    assert new_rows.any()
    assert np.isfinite(
        reread.columns["liq_openvol"][new_rows].astype(float)).any()


def _write_coded_days(d_int, d_str):
    """Three days written twice, int-coded and str-coded, with one code
    below 100000 (zero-padding: '000123')."""
    rng2 = np.random.default_rng(11)
    for ds in ("2024-01-02", "2024-01-03", "2024-01-04"):
        cols = synth_day(rng2, n_codes=7, date=ds, missing_prob=0.05)
        lowest = np.sort(np.unique(cols["code"]))[0]
        code_str = np.where(cols["code"] == lowest, "000123", cols["code"])
        arrays = {"time": pa.array(cols["time"])}
        for k in ("open", "high", "low", "close", "volume"):
            arrays[k] = pa.array(cols[k])
        name = ds.replace("-", "") + ".parquet"
        pq.write_table(pa.table(dict(
            code=pa.array(code_str.astype(str)), **arrays)),
            os.path.join(str(d_str), name))
        pq.write_table(pa.table(dict(
            code=pa.array(code_str.astype(np.int64)), **arrays)),
            os.path.join(str(d_int), name))


def test_int_coded_files_match_str_coded_files(tmp_path):
    d_int, d_str = tmp_path / "kline_int", tmp_path / "kline_str"
    d_int.mkdir()
    d_str.mkdir()
    _write_coded_days(d_int, d_str)
    t_int = compute_exposures(str(d_int), NAMES, cfg=_cfg())
    t_str = compute_exposures(str(d_str), NAMES, cfg=_cfg())
    assert list(t_int.columns["code"]) == list(t_str.columns["code"])
    assert "000123" in set(t_int.columns["code"])
    assert (t_int.columns["date"] == t_str.columns["date"]).all()
    for n in NAMES:
        np.testing.assert_array_equal(t_int.columns[n], t_str.columns[n])


def test_int_codes_to_str_never_truncates_wide_codes():
    got = dio.int_codes_to_str(np.array([1_000_000, 100_000, 2]))
    assert list(got) == ["1000000", "100000", "000002"]
    got = dio.int_codes_to_str(np.array([0, 123, 999_999]))
    assert list(got) == ["000000", "000123", "999999"]
    assert dio.int_codes_to_str(np.array([], dtype=np.int64)).size == 0


def test_grid_batch_pads_as_jax():
    """Codes, pads (int and string), present and the bucket-padded axis
    are the JAX package's, over a batch that mixes an int day and a day
    with a code missing."""
    from replication_of_minute_frequency_factor_tpu import pipeline as jpl
    rng = np.random.default_rng(3)
    days = []
    for i, ds in enumerate(("2024-01-02", "2024-01-03")):
        cols = synth_day(rng, n_codes=5 + i, date=ds, missing_prob=0.1)
        cols["code"] = cols["code"].astype(np.int64)
        days.append((np.datetime64(ds), cols))
    str_days = [(d, dict(c, code=dio.int_codes_to_str(c["code"])))
                for d, c in days]
    for batch in (days, str_days, [days[0], str_days[1]]):
        got = pl._grid_batch(batch)
        want = jpl._grid_batch(batch)
        for a, b in zip(got, want):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)
    assert got[0].shape[1] == pl.TICKER_BUCKET == 256


# --- the port against the JAX package's compute_exposures -------------------

def _hold_to_jax(port, ref, minute_dir):
    """Codes, dates and row order bitwise; NaN and inf positions
    identical; values through tests/test_parity.py's comparator (noisy
    scenario: the fixture days have missing bars), doc_pdf* through its
    acceptance sets, the beta z pair past its sub-noise numerators."""
    from replication_of_minute_frequency_factor_tpu.data import (
        io as jdio)
    assert port.factor_names == ref.factor_names
    np.testing.assert_array_equal(port.columns["code"].astype(str),
                                  ref.columns["code"].astype(str))
    np.testing.assert_array_equal(port.columns["date"],
                                  ref.columns["date"])
    days = {str(d): pd.DataFrame(jdio.read_minute_day(p))
            for d, p in jdio.list_day_files(minute_dir)}
    beta = {d: _degenerate_beta_codes(df) for d, df in days.items()}
    pdf = {d: _lazy(lambda df=df: _doc_pdf_acceptable(df))
           for d, df in days.items()}
    failures = []
    codes = port.columns["code"].astype(str)
    dates = port.columns["date"].astype(str)
    for name in port.factor_names:
        a, b = port.columns[name], ref.columns[name]
        assert np.array_equal(np.isnan(a), np.isnan(b)), name
        assert np.array_equal(np.where(np.isinf(a), np.sign(a), 0),
                              np.where(np.isinf(b), np.sign(b), 0)), name
        for r in range(len(a)):
            skip, num_scale = beta[dates[r]]
            if name in ("mmt_ols_qrs", "mmt_ols_beta_zscore_last") \
                    and codes[r] in skip:
                continue
            aux = {k: ref.columns[k][r]
                   for k in ("shape_kurt", "shape_kurtVol")}
            aux["beta_num_scale"] = num_scale.get(codes[r])
            _check_cell(f"{dates[r]}", name, codes[r], b[r], a[r], True,
                        failures, aux, pdf[dates[r]])
    assert not failures, "\n".join(failures[:40])


def test_all_58_match_jax_on_the_fixture_days(minute_dir):
    port = compute_exposures(minute_dir, cfg=_cfg())
    ref = jax_compute_exposures(minute_dir, cfg=JConfig(days_per_batch=2),
                                progress=False)
    assert len(port.factor_names) == 58 and len(port) == 18
    _hold_to_jax(port, ref, minute_dir)


def test_all_58_match_jax_across_batches_and_buckets(tmp_path):
    """40 tickers x 5 days at two days a batch: three batches, codes that
    come and go between days (so each batch's union differs), and the
    256 bucket's pad lanes."""
    d = tmp_path / "kline40"
    d.mkdir()
    rng = np.random.default_rng(40)
    for ds in ("2024-01-02", "2024-01-03", "2024-01-04", "2024-01-05",
               "2024-01-08"):
        cols = synth_day(rng, n_codes=40, date=ds, missing_prob=0.05,
                         zero_volume_prob=0.05, short_day_codes=2)
        keep = cols["code"] != cols["code"][rng.integers(len(cols["code"]))]
        arrays = {k: pa.array(np.asarray(cols[k])[keep])
                  for k in ("code", "time", "open", "high", "low", "close",
                            "volume")}
        pq.write_table(pa.table(arrays),
                       str(d / (ds.replace("-", "") + ".parquet")))
    port = compute_exposures(str(d), cfg=_cfg())
    ref = jax_compute_exposures(str(d), cfg=JConfig(days_per_batch=2),
                                progress=False)
    assert len(port) == 5 * 39
    _hold_to_jax(port, ref, str(d))


def test_port_matches_reference_snapshot(minute_dir):
    """The vendored reference outputs for the fixture days, at the JAX
    device path's own tolerance (tests/test_pipeline.py)."""
    prov, _ = _load_snapshot()
    t = compute_exposures(minute_dir, prov["names"], cfg=_cfg())
    _assert_matches_snapshot(t, rtol=5e-5, atol=1e-6)


# --- telemetry ---------------------------------------------------------------

def test_pipeline_smoke_populates_gauges_under_failure(
        minute_dir, tmp_path, monkeypatch):
    double, _ = _count_calls({1})
    _patch(monkeypatch, double)
    tel = Telemetry()
    native.reset_counts()
    # installed as the process default too: the io layer reports there
    prev = get_telemetry()
    try:
        assert set_telemetry(tel) is tel
        t = compute_exposures(minute_dir, ["vol_return1min"],
                              cache_path=str(tmp_path / "c.parquet"),
                              cfg=_cfg(), telemetry=tel)
    finally:
        set_telemetry(prev)
    assert not t.failures and len(np.unique(t.columns["date"])) == 3
    reg = tel.registry
    assert reg.counter_value("pipeline.retries", stage="launch") == 1
    assert reg.gauge_value("pipeline.queue_depth") is not None
    assert reg.histogram_stats("pipeline.queue_depth")["count"] > 0
    assert reg.gauge_value("pipeline.inflight_batches") == 0
    for stage in ("io", "grid", "wire_encode", "pack", "launch", "device"):
        st = reg.histogram_stats("span_seconds", span=stage,
                                 rolling_impl="cuda")
        assert st is not None and st["count"] > 0, stage
    assert reg.counter_total("pipeline.encode_kind") \
        == reg.counter_value("pipeline.batches_launched") \
        - reg.counter_total("pipeline.retries") \
        == reg.counter_value("pipeline.encode_kind", kind="wire") == 2
    assert reg.counter_value("pipeline.batches_completed") == 2
    assert reg.counter_value("pipeline.days_completed") == 3
    assert reg.counter_value("io.day_files_read") == 3
    assert reg.counter_value("io.parquet_writes") == 1
    # the CPU run copies nothing through pinned memory
    assert reg.counter_value("pipeline.h2d_bytes") == 0
    # every grid and encode took the path it resolved, and said so
    assert native.resolved_counts("wire") == {
        "native" if native.available() else "numpy": 2}
    assert {"io", "grid", "device"} <= set(t.timings)
    assert [e["name"] for e in tel.events()] == ["reconciliation"]


def test_pipeline_counts_failed_days_and_breaker(minute_dir, tmp_path,
                                                 monkeypatch):
    double, _ = _count_calls(lambda n: True)
    _patch(monkeypatch, double)
    tel = Telemetry()
    with pytest.raises(RuntimeError, match="consecutive"):
        compute_exposures(minute_dir, ["vol_return1min"],
                          cache_path=str(tmp_path / "c.parquet"),
                          cfg=_cfg(days_per_batch=1), telemetry=tel)
    reg = tel.registry
    assert reg.counter_value("pipeline.circuit_breaker_trips") == 1
    assert reg.gauge_value("pipeline.breaker_consecutive_failures") == 3
    assert reg.counter_total("pipeline.failed_days") >= 3


def test_stage_timer_feeds_totals_histograms_and_the_profiler():
    tel = Telemetry()
    timer = tel.stage_timer(rolling_impl="torch")
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        for _ in range(2):
            with timer("grid"):
                pass
    assert timer.totals()["grid"] >= 0 and "grid:" in timer.report()
    st = tel.registry.histogram_stats("span_seconds", span="grid",
                                      rolling_impl="torch")
    assert st["count"] == 2
    assert any(e.key == "grid" for e in prof.key_averages())


def test_reconcile_flags_unattributed_time_only_past_the_floor():
    ok = reconcile(10.0, {"io": 5.0, "device": 4.5, "launch_ms": 1e6})
    assert ok["ok"] and ok["unattributed_s"] == 0.5
    assert set(ok["stages"]) == {"io", "device"}
    bad = reconcile(10.0, {"io": 5.0})
    assert not bad["ok"] and bad["unattributed_frac"] == 0.5
    assert reconcile(0.06, {"io": 0.01})["ok"]  # under the 0.05 s floor
    over = reconcile(1.0, {"grid": 0.8, "device": 0.7})
    assert over["ok"] and over["overlap_s"] == 0.5


def _run(package, minute_dir, cache_path=None, **kw):
    """One package's ``compute_exposures`` over ``minute_dir`` (NAMES, two
    days a batch)."""
    if package == "port":
        return compute_exposures(minute_dir, NAMES, cache_path=cache_path,
                                 cfg=_cfg(), **kw)
    return jax_compute_exposures(minute_dir, NAMES, cache_path=cache_path,
                                 cfg=JConfig(days_per_batch=2),
                                 progress=False, **kw)


@pytest.mark.parametrize("fmt", ["parquet", "mffz"])
@pytest.mark.parametrize("writer,reader", [("jax", "port"),
                                           ("port", "jax")])
def test_each_package_resumes_the_others_cache(tmp_path, rng, fmt, writer,
                                               reader):
    """The on-disk cache is one contract: a cache one package wrote, as
    parquet or framed ``.mffz``, resumes in the other, which computes
    only the new day, keeps every cached row's bits, and writes new rows
    bitwise its own fresh run's."""
    d = tmp_path / "kline"
    d.mkdir()
    for ds in ("2024-01-02", "2024-01-03"):
        _write_day(str(d), rng, ds, missing_prob=0.05)
    cache = str(tmp_path / f"factors.{fmt}")
    base = _run(writer, str(d), cache)
    new_day = np.datetime64("2024-01-04")
    _write_day(str(d), rng, str(new_day))
    seen = []
    got = _run(reader, str(d), cache, fault_hook=seen.append)
    assert seen == [new_day]
    fresh = _run(reader, str(d))
    old = got.columns["date"] < new_day
    assert old.sum() == len(base) == 12 and len(got) == 18
    mine = fresh.columns["date"] == new_day

    def col(table, key):
        v = np.asarray(table.columns[key])
        return v.astype(str) if key == "code" else v

    for key in ("code", "date", *NAMES):
        np.testing.assert_array_equal(col(got, key)[old], col(base, key),
                                      err_msg=key)
        np.testing.assert_array_equal(col(got, key)[~old],
                                      col(fresh, key)[mine], err_msg=key)
