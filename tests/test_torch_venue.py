"""The venue year on the CPU: a 24/7 venue's klines
(``perfbench/klines.py`` under ``binance_spot_1500``'s ``venue`` block, at
24 symbols) through the resident loop's raw ingest, the ``wire.decode``
span's labels and the resident loop's count of steps by ingest kind, and
the benchmark's ``ingest_bytes_per_bar`` reader of them.

The year's prices run over 11 decades on per-symbol ticks, with
fractional quantities, zero-trade minutes, listings and maintenance gaps:
the ingest wire refuses every batch, so the year ships raw, and all 58
factors of ``compute_packed_resident(kind='raw', session='crypto_1440')``
are held to the port's f64 oracle at the parity suite's tolerances
(``fuzz/comparator.py``, the suite's tables to the last digit).

The module imports neither jax nor the JAX package:

    python -m pytest --noconftest tests/test_torch_venue.py -q
"""

import json
import sys
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from replication_of_minute_frequency_factor_tpu_torch import pipeline as pl
from replication_of_minute_frequency_factor_tpu_torch.data import wire
from replication_of_minute_frequency_factor_tpu_torch.fuzz import (
    comparator as C)
from replication_of_minute_frequency_factor_tpu_torch.models import (
    factor_names)
from replication_of_minute_frequency_factor_tpu_torch.telemetry import (
    Telemetry, get_telemetry, set_telemetry)

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from perfbench import harness  # noqa: E402
from perfbench import trace as pt  # noqa: E402
from perfbench.drivers import venue  # noqa: E402
import torch_cases as tc  # noqa: E402

CONFIG = json.loads(
    (ROOT / "perfbench/configs/binance_spot_1500.json").read_text())
SESSION = "crypto_1440"
SLOTS = 1440
#: the tiny year: batches x days x symbols, the config's own tiny size
N_BATCHES, DAYS = 2, 2
SYMBOLS = CONFIG["tiny"]["tickers"]
#: seeds whose tiny year holds a symbol trading in under half its minutes
SEEDS = (3, 2**31 + 7, 2**40 + 5)


def _cell(batches=N_BATCHES, days=DAYS):
    return harness.Cell(
        name="venue", workload={}, config=dict(CONFIG, tickers=SYMBOLS),
        mix={"batches": batches, "days_per_batch": days}, end_to_end=[],
        per_layer=[])


def _year(seed):
    """The tiny year's symbols and its batches' f32 bars and masks."""
    cell = _cell()
    sym = venue.year_symbols(cell, seed)
    batches = []
    for i in range(N_BATCHES):
        _, _, bars, mask = venue.raw_buffer(DAYS, SYMBOLS, SLOTS)
        venue.make_batch(cell, seed, sym, i, (bars, mask), map)
        batches.append((bars.copy(), mask.copy()))
    return sym, batches


@pytest.fixture
def fresh_telemetry():
    prev = get_telemetry()
    tel = set_telemetry(Telemetry())
    try:
        yield tel
    finally:
        set_telemetry(prev)


# --- (a) the venue's batches do not fit the ingest wire -------------------

@pytest.mark.parametrize("seed", SEEDS)
def test_the_wire_refuses_every_venue_batch(seed):
    sym, batches = _year(seed)
    for bars, mask in batches:
        assert wire.encode(bars, mask, floor={}) is None
    # prices over decades on ticks finer than 0.01, fractional quantities
    valid = np.concatenate([b[..., 3][m] for b, m in batches])
    assert valid.max() / valid.min() > 1e3
    vol = np.concatenate([b[..., 4][m] for b, m in batches])
    assert (vol != np.rint(vol)).any() and (vol == 0).any()


def test_the_driver_ships_the_venue_year_raw_as_pack_arrays_packs_it():
    seed = SEEDS[0]
    _, batches = _year(seed)
    bufs, spec, kind = venue.ship_year(_cell(), seed, "cpu")
    assert kind == "raw" and len(bufs) == N_BATCHES
    for buf, (bars, mask) in zip(bufs, batches):
        want, want_spec = wire.pack_arrays((bars, mask.view(np.uint8)))
        assert spec == want_spec
        assert np.array_equal(buf.numpy(), want)
    assert sum(b.numel() for b in bufs) == 21 * N_BATCHES * DAYS \
        * SYMBOLS * SLOTS


def test_the_driver_ships_a_year_the_wire_takes_through_the_wire(
        monkeypatch):
    """The same driver over tick-aligned board lots (``make_batch``'s
    recipe): every batch goes through the wire under one floor, as
    ``torch_cases.encode_year`` ships it."""
    year = tc.Year(9, N_BATCHES, DAYS, SYMBOLS, session=SESSION)

    def tick_aligned(cell, seed, sym, i, out, days_map):
        out[0][...], out[1][...] = year[i]

    monkeypatch.setattr(venue, "make_batch", tick_aligned)
    bufs, spec, kind = venue.ship_year(_cell(), 9, "cpu")
    want, want_spec, want_kind = tc.encode_year(year)
    assert (kind, spec) == (want_kind, want_spec) == ("wire", want_spec)
    for got, w in zip(bufs, want):
        assert np.array_equal(got.numpy(), w)


# --- (b) all 58 factors of the raw resident year against the oracle -------

def _frame(bars, mask, date):
    t, s = np.nonzero(mask)
    b = bars[t, s].astype(np.float64)
    from replication_of_minute_frequency_factor_tpu_torch.markets import (
        get_session)
    return {"code": t.astype(np.int64),
            "time": get_session(SESSION).grid_times[s],
            "date": np.full(len(t), date), "open": b[:, 0],
            "high": b[:, 1], "low": b[:, 2], "close": b[:, 3],
            "volume": b[:, 4]}


@pytest.mark.parametrize("seed", SEEDS)
def test_the_raw_resident_venue_year_matches_the_oracle(seed):
    import pandas as pd

    from replication_of_minute_frequency_factor_tpu_torch.oracle import (
        compute_oracle)

    sym, batches = _year(seed)
    # the year holds a listing, a maintenance gap and a symbol that
    # trades in under half its minutes
    minutes = N_BATCHES * DAYS * SLOTS
    assert ((sym.first > 0) & (sym.first < minutes)).any()
    assert len(sym.gaps) == 2 and (sym.gaps[:, 0] < N_BATCHES * DAYS).all()
    assert (sym.zero_share > 0.5).any()
    bufs = [torch.from_numpy(wire.pack_arrays((b, m.view(np.uint8)))[0])
            for b, m in batches]
    spec = wire.pack_arrays((batches[0][0], batches[0][1].view(
        np.uint8)))[1]
    names = factor_names()
    ys = pl.compute_packed_resident(bufs, spec, "raw", names,
                                    session=SESSION, device="cpu").numpy()
    assert ys.shape == (N_BATCHES, 58, DAYS, SYMBOLS)
    days = [(i * DAYS + d, batches[i][0][d], batches[i][1][d])
            for i in range(N_BATCHES) for d in range(DAYS)]
    dates = [np.datetime64("2024-01-01") + k for k, _, _ in days]
    frames = [pd.DataFrame(_frame(b, m, dt))
              for (_, b, m), dt in zip(days, dates)]
    df = pd.concat(frames)
    oracle = compute_oracle(df, session=SESSION).set_index(["code",
                                                            "date"])
    failures: list = []
    checked = 0
    for (k, bars, mask), date, sub in zip(days, dates, frames):
        i, d = divmod(k, DAYS)
        skip, ns = C._degenerate_beta_codes(sub, session=SESSION)
        pdf_acc = C._lazy(lambda sub=sub: C._doc_pdf_acceptable(
            sub, session=SESSION))
        for j, name in enumerate(names):
            for t in range(SYMBOLS):
                if name in ("mmt_ols_qrs", "mmt_ols_beta_zscore_last") \
                        and t in skip:
                    continue
                key = (t, date)
                here = key in oracle.index
                ov = oracle.loc[key, name] if here else np.nan
                aux = ({a: oracle.loc[key, a]
                        for a in ("shape_kurt", "shape_kurtVol")}
                       if here else {})
                aux["beta_num_scale"] = ns.get(t)
                C._check_cell(f"s{seed}/day{k}", name, t, ov,
                              ys[i, j, d, t], False, failures, aux,
                              pdf_acc)
                checked += 1
    assert checked == len(days) * 58 * SYMBOLS
    assert not failures, "\n".join(failures[:40]) + \
        f"\n({len(failures)} total)"


# --- (d) the decode span's labels and the resident kind counter -----------

def _tiny_buffers(kind):
    if kind == "wire":
        bufs, spec, got = tc.encode_year(tc.Year(3, N_BATCHES, DAYS, 16,
                                                 session=SESSION))
        assert got == "wire"
        return [torch.from_numpy(b).clone() for b in bufs], spec, \
            N_BATCHES * DAYS * 16 * SLOTS
    _, batches = _year(SEEDS[0])
    packs = [wire.pack_arrays((b, m.view(np.uint8))) for b, m in batches]
    return [torch.from_numpy(p[0]) for p in packs], packs[0][1], \
        N_BATCHES * DAYS * SYMBOLS * SLOTS


@pytest.mark.parametrize("kind", ["wire", "raw"])
def test_decode_spans_carry_kind_bars_bytes_and_steps_count_by_kind(
        fresh_telemetry, kind):
    bufs, spec, bars = _tiny_buffers(kind)
    pl.compute_packed_resident(bufs, spec, kind,
                               names=("vol_return1min",),
                               session=SESSION, device="cpu")
    spans = [e for e in fresh_telemetry.tracer.events()
             if e["name"] == "wire.decode"]
    assert len(spans) == N_BATCHES
    for e, b in zip(spans, bufs):
        assert e["labels"] == {"kind": kind,
                               "bars": str(bars // N_BATCHES),
                               "bytes": str(b.numel())}
    reg = fresh_telemetry.registry
    # the sizes ride on the events alone: the span's histogram is one
    # series a kind, whatever the batches' sizes
    assert reg.histogram_stats("span_seconds", span="wire.decode",
                               kind=kind)["count"] == N_BATCHES
    assert reg.counter_value("resident.encode_kind", kind=kind) \
        == N_BATCHES
    assert reg.counter_total("resident.encode_kind") == N_BATCHES


# --- (e) the benchmark's reader of those labels ---------------------------

class HostClockEvent:
    """An event stamped on the host's clock: device timing on the CPU."""

    def record(self, stream=None):
        self.t = time.perf_counter()

    def synchronize(self):
        pass

    def elapsed_time(self, end):
        return (end.t - self.t) * 1e3


def _reader():
    return harness._load_module(
        harness.reader_path(ROOT / "perfbench", "ingest_bytes_per_bar"),
        "test_reader_ingest_bytes_per_bar").read


@pytest.mark.parametrize("kind", ["wire", "raw"])
def test_ingest_bytes_per_bar_reads_the_shipped_bytes(fresh_telemetry,
                                                      kind):
    bufs, spec, bars = _tiny_buffers(kind)
    fresh_telemetry.tracer._event_factory = HostClockEvent

    def year():
        pl.compute_packed_resident([b.clone() for b in bufs], spec, kind,
                                   names=("vol_return1min",),
                                   session=SESSION, device="cpu")

    year()  # the warm pass, outside the window: never device-timed
    run = harness.Run(cell=None, trace=pt.traced(year, "cpu"),
                      counters={"days_traced": N_BATCHES * DAYS})
    got = _reader()(run)
    want = sum(b.numel() for b in bufs) / bars
    assert got == pytest.approx(want, rel=1e-12)
    if kind == "raw":
        assert got == 21.0
    else:
        assert got < 21.0 / 4


def test_ingest_bytes_per_bar_is_silent_without_the_labels(
        fresh_telemetry, monkeypatch):
    """A program whose decode span has no labels (the parent of this
    reader) reads nothing; nor does a window with no decode spans."""
    bufs, spec, _ = _tiny_buffers("raw")
    fresh_telemetry.tracer._event_factory = HostClockEvent
    tracer = fresh_telemetry.tracer
    real = type(tracer).__call__

    def unlabelled(self, name, trace_id=None, **labels):
        return real(self, name, trace_id,
                    **({} if name == "wire.decode" else labels))

    monkeypatch.setattr(type(tracer), "__call__", unlabelled)

    def year():
        pl.compute_packed_resident([b.clone() for b in bufs], spec, "raw",
                                   names=("vol_return1min",),
                                   session=SESSION, device="cpu")

    run = harness.Run(cell=None, trace=pt.traced(year, "cpu"),
                      counters={"days_traced": N_BATCHES * DAYS})
    assert all("labels" not in e for e in tracer.events()
               if e["name"] == "wire.decode")
    assert _reader()(run) is None
    assert _reader()(harness.Run(cell=None, trace=None, counters={})) \
        is None
