"""The pv_corr family computed together: ``DayContext.pv_corr``, its
plain version ``ops.pv_corr_cuda.pv_corr_plain`` and the hand-written
kernel ``csrc/pv_corr.cu`` behind it on the card.

On the CPU the six factors are held bit for bit to their compositions as
``models/pv_corr.py`` wrote them before they were computed together (the
copies below), at 240 and 390 slots, on crafted edge rows, under both
readings of the ``constant_window`` pin; the intermediate is computed once
per context and is one ``ctx.pv_corr`` span; the trace tier counts the
kernel's launches under its own key; and the benchmark's
``pv_corr_roofline_pct`` reads the spans. The ``cuda`` tests hold the
kernel to the plain version on the card at 240, 390 and 1440 slots, count
one launch per context and per resident step, and check that the wrapper
refuses what the kernel does not take before any launch.

The module imports neither jax nor the JAX package:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_pv_corr.py -q
"""

import time
from collections import Counter
from pathlib import Path

import pytest
import torch

from replication_of_minute_frequency_factor_tpu_torch import pins
from replication_of_minute_frequency_factor_tpu_torch import pipeline as pl
from replication_of_minute_frequency_factor_tpu_torch.analysis import (
    trace_tier)
from replication_of_minute_frequency_factor_tpu_torch.models import (
    DayContext, compute_factors, registry)
from replication_of_minute_frequency_factor_tpu_torch.ops import (
    masked_corr, pct_change_valid, pv_corr_cuda, shift_valid)
from replication_of_minute_frequency_factor_tpu_torch.telemetry import (
    Telemetry, get_telemetry, set_telemetry)
from torch_cases import (
    PV_CORR_CONSTANT_ROWS, Year, encode_year, pv_corr_rows, same_bits)

ROOT = Path(__file__).resolve().parents[1]
SESSIONS = {240: "cn_ashare_240", 390: "us_390", 1440: "crypto_1440"}
READINGS = ("degenerate", "noise")


def _parent(name, close, volume, mask):
    """The family's kernels as models/pv_corr.py wrote them before the six
    were computed together."""
    if name == "corr_prv":
        pct, ok = pct_change_valid(close, mask)
        return masked_corr(pct, volume, ok)
    if name == "corr_prvr":
        base = mask & (volume != 0)
        pc, ok_c = pct_change_valid(close, base)
        pv, ok_v = pct_change_valid(volume, base)
        return masked_corr(pc, pv, ok_c & ok_v)
    if name == "corr_pv":
        return masked_corr(close, volume, mask)
    if name == "corr_pvd":
        v, ok = shift_valid(volume, mask, 1)
        return masked_corr(close, v, ok)
    if name == "corr_pvl":
        v, ok = shift_valid(volume, mask, -1)
        return masked_corr(close, v, ok)
    assert name == "corr_pvr"
    base = mask & (volume != 0)
    pv, ok = pct_change_valid(volume, base)
    return masked_corr(close, pv, ok)


def _rows(n_slots, seed=5, random_rows=16, device="cpu"):
    bars, mask = pv_corr_rows(seed, n_slots, random_rows)
    return (torch.from_numpy(bars).to(device),
            torch.from_numpy(mask).to(device))


@pytest.fixture
def fresh_telemetry():
    prev = get_telemetry()
    tel = set_telemetry(Telemetry())
    try:
        yield tel
    finally:
        set_telemetry(prev)


# --- the plain version is the parent's compositions -------------------------

@pytest.mark.parametrize("name", pv_corr_cuda.NAMES)
@pytest.mark.parametrize("reading", READINGS)
@pytest.mark.parametrize("n_slots", [240, 390])
def test_plain_is_the_parent_composition_bit_for_bit(n_slots, reading,
                                                     name):
    bars, mask = _rows(n_slots)
    close, volume = bars[..., 3], bars[..., 4]
    with pins.pinned(constant_window=reading):
        got = pv_corr_cuda.pv_corr_plain(close, volume, mask)
        want = _parent(name, close, volume, mask)
    assert got.shape == (6, mask.shape[0])
    assert same_bits(got[pv_corr_cuda.NAMES.index(name)], want)


@pytest.mark.parametrize("reading", READINGS)
@pytest.mark.parametrize("n_slots", [240, 390])
def test_registered_factors_are_the_parent_compositions(n_slots, reading):
    """The six registered kernels on a ``[days, tickers]`` context, each
    bit for bit its composition before this change."""
    bars, mask = _rows(n_slots)
    bars, mask = bars.reshape(2, -1, n_slots, 5), mask.reshape(2, -1,
                                                               n_slots)
    with pins.pinned(constant_window=reading):
        got = compute_factors(bars, mask, names=pv_corr_cuda.NAMES,
                              session=SESSIONS[n_slots])
        for name in pv_corr_cuda.NAMES:
            want = _parent(name, bars[..., 3], bars[..., 4], mask)
            assert same_bits(got[name], want), name


def test_constant_rows_are_exactly_nan_under_the_degenerate_reading():
    """A constant close or volume gives exactly zero variance once
    anchored, so all six are NaN, as the f64 oracle."""
    bars, mask = _rows(240)
    got = pv_corr_cuda.pv_corr(bars, mask)
    assert torch.isnan(got[:, list(PV_CORR_CONSTANT_ROWS)]).all()


# --- one intermediate per context --------------------------------------------

@pytest.mark.parametrize("first", pv_corr_cuda.NAMES)
def test_the_context_computes_the_six_once(fresh_telemetry, first):
    bars, mask = _rows(240)
    bars, mask = bars.reshape(2, -1, 240, 5), mask.reshape(2, -1, 240)
    tr = fresh_telemetry.tracer
    ctx = DayContext(bars, mask, tracer=tr)
    before = pv_corr_cuda.launches
    order = (first,) + tuple(n for n in pv_corr_cuda.NAMES if n != first)
    got = {n: registry.resolve(n)(ctx) for n in order}
    spans = [e for e in tr.events() if e["name"] == "ctx.pv_corr"]
    assert len(spans) == 1
    assert spans[0]["labels"] == {"rows": str(mask[..., 0].numel()),
                                  "slots": "240", "impl": "plain"}
    assert pv_corr_cuda.launches == before  # the plain path never counts
    plain = pv_corr_cuda.pv_corr_plain(bars[..., 3], bars[..., 4], mask)
    for k, n in enumerate(pv_corr_cuda.NAMES):
        assert same_bits(got[n], plain[k]), n


def _tiny_year(n=2, days=2, tickers=16, seed=3):
    bufs, spec, kind = encode_year(Year(seed, n, days, tickers))
    assert kind == "wire"
    return [torch.from_numpy(b).clone() for b in bufs], spec


def test_a_resident_step_computes_it_once(fresh_telemetry):
    """One ``ctx.pv_corr`` span a step, under the first of the family's
    kernels the step calls, labelled with the step's rows."""
    n, days, tickers = 2, 2, 16
    bufs, spec = _tiny_year(n, days, tickers)
    pl.compute_packed_resident(bufs, spec, "wire", rolling_impl="cuda",
                               device="cpu")
    ev = fresh_telemetry.tracer.events()
    ids = {e["id"]: e["name"] for e in ev}
    spans = [e for e in ev if e["name"] == "ctx.pv_corr"]
    assert len(spans) == n
    first = next(f for f in registry.factor_names()
                 if f in pv_corr_cuda.NAMES)
    for e in spans:
        assert ids[e["parent"]] == "factor." + first
        assert e["labels"] == {"rows": str(days * tickers), "slots": "240",
                               "impl": "plain"}


# --- the trace tier ----------------------------------------------------------

def test_the_trace_tier_counts_the_pv_corr_launches(monkeypatch):
    """The kernel is a ctypes call the op recorder cannot see: its
    launches come from the wrapper's counter, under ``kernel:pv_corr``,
    beside ``kernel:second_moments``."""
    from replication_of_minute_frequency_factor_tpu_torch.ops import (
        rolling_cuda)

    def fake_launch(rolling=False):
        pv_corr_cuda.launches += 1
        if rolling:
            rolling_cuda.launches["tiled"] += 1
        return torch.ones(3) * 2.0

    monkeypatch.setattr(pv_corr_cuda, "launches", 0)
    monkeypatch.setattr(rolling_cuda, "launches",
                        {"tiled": 0, "rowwise": 0})
    _, t = trace_tier.trace(fake_launch)
    assert t.launches == 1
    ops = t.fingerprint()["ops"]
    assert ops[trace_tier.PV_CORR_KERNEL_KEY] == 1
    assert trace_tier.KERNEL_KEY not in ops
    _, t = trace_tier.trace(lambda: fake_launch(rolling=True))
    assert t.launches == 2
    assert t.kernel_launches == {trace_tier.KERNEL_KEY: 1,
                                 trace_tier.PV_CORR_KERNEL_KEY: 1}
    assert t.fingerprint()["n_ops"] == sum(t.ops.values())


def test_on_the_cpu_no_trace_counts_a_pv_corr_launch():
    """Every traced kernel of the family computes the plain version on
    the CPU: the intermediate's ops, no launch key."""
    bars, mask = trace_tier.canonical_inputs()
    for name in pv_corr_cuda.NAMES:
        _, t = trace_tier.trace_kernel(registry.resolve(name), bars, mask)
        assert t.launches == 0 and not t.syncs
        assert trace_tier.PV_CORR_KERNEL_KEY not in t.counts()
        assert t.ops.get("aten.stack.default") == 1, name


def test_the_wrapper_refuses_a_device_it_cannot_launch_on():
    """A tensor off the CPU that is not on a CUDA device raises before
    any launch, with the counter unchanged."""
    bars, mask = _rows(240, random_rows=0)
    before = pv_corr_cuda.launches
    with pytest.raises(ValueError, match="CUDA device"):
        pv_corr_cuda.pv_corr(bars.to("meta"), mask.to("meta"))
    with pytest.raises(ValueError, match="CUDA device"):
        pv_corr_cuda.pv_corr(bars, mask.to("meta"))
    assert pv_corr_cuda.launches == before


# --- the benchmark's reader ----------------------------------------------------

def _reader():
    from perfbench import harness
    return harness._load_module(
        harness.reader_path(ROOT / "perfbench", "pv_corr_roofline_pct"),
        "test_reader_pv_corr_roofline_pct").read


class _FakeEvent:
    now = 0.0

    def record(self, stream=None):
        self.t = _FakeEvent.now

    def synchronize(self):
        pass

    def elapsed_time(self, end):
        return end.t - self.t


def _window(tel, pv_ms=0.4, rows=160000, slots=240, steps=2):
    """``steps`` steps of spans on a fake device clock (ms), each with a
    ``ctx.pv_corr`` of ``pv_ms`` under a ``factor.corr_prv``, and the
    traced window's host annotations for them."""
    from perfbench import trace as pt

    tr = tel.tracer
    tr.device_timing, tr._event_factory = True, _FakeEvent
    host = []

    def span(name, ms, inner=(), **labels):
        t0 = time.perf_counter() * 1e6
        with tr(name, **labels):
            _FakeEvent.now += ms
            for sub in inner:
                sub()
        host.append((name, t0, time.perf_counter() * 1e6 - t0))

    for _ in range(steps):
        span("factor.corr_prv", 0.01, inner=[
            lambda: span("ctx.pv_corr", pv_ms, rows=rows, slots=slots,
                         impl="cuda")])
        span("factor.corr_pv", 0.01)
    lo = min(ts for _, ts, _ in host) - 1.0
    hi = max(ts + d for _, ts, d in host) + 1.0
    return pt.TraceSummary(lo=lo, hi=hi, device=[], host=host)


def _run(summary, days=64):
    from perfbench.harness import Run
    return Run(cell=None, trace=summary, counters={"days_traced": days})


def test_the_roofline_reader_reads_the_spans(fresh_telemetry):
    """Bytes ``rows x slots x 9`` read and ``rows x 6 x 4`` written, at
    the HBM peak, over the spans' device time."""
    from perfbench import roofline

    summary = _window(fresh_telemetry, pv_ms=0.4)
    least = (9 * 160000 * 240 + 24 * 160000) / roofline.HBM_BYTES_PER_S
    assert _reader()(_run(summary)) == pytest.approx(100 * least / 0.4e-3)


def test_the_roofline_reader_is_silent_without_its_spans(fresh_telemetry):
    """Silent on a window short of an annotation, on one without device
    time, and on a program without the span (the parent's)."""
    summary = _window(fresh_telemetry)
    drop = next(i for i, h in enumerate(summary.host)
                if h[0] == "ctx.pv_corr")
    short = type(summary)(lo=summary.lo, hi=summary.hi, device=[],
                          host=summary.host[:drop] + summary.host[drop + 1:])
    assert _reader()(_run(short)) is None
    assert _reader()(_run(None)) is None
    set_telemetry(Telemetry())
    tr = get_telemetry().tracer
    tr.device_timing, tr._event_factory = True, _FakeEvent
    with tr("factor.corr_pv"):
        _FakeEvent.now += 1.0
    assert _reader()(_run(summary)) is None


# --- on the card -----------------------------------------------------------------

def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")


def _close(got, want, n_slots, rows=None):
    """NaN where the plain version is NaN, and within ``n_slots * eps`` of
    it elsewhere: the kernel takes each sum in another order (lane partial
    sums, then a butterfly of shuffles), which can move a sum by up to
    ``n * eps`` of the sum of its terms' magnitudes; Cauchy-Schwarz bounds
    that sum for the covariance by ``sqrt(var_x * var_y)``, so ``r``
    moves by at most about ``n * eps``."""
    got, want = got.cpu(), want.cpu()
    if rows is not None:
        got, want = got[:, rows], want[:, rows]
    assert torch.equal(torch.isnan(got), torch.isnan(want))
    ok = ~torch.isnan(want)
    err = (got[ok] - want[ok]).abs().max().item() if ok.any() else 0.0
    assert err <= n_slots * torch.finfo(torch.float32).eps, err


@pytest.mark.cuda
@pytest.mark.parametrize("reading", READINGS)
@pytest.mark.parametrize("n_slots", [240, 390, 1440])
def test_kernel_matches_plain_on_the_card(n_slots, reading):
    """The kernel against the plain version on the card and on the CPU,
    over the crafted rows and 2000 drawn ones. Under the "noise" reading
    a constant row's correlation is rounding noise by design, which the
    order of summation decides, so those two rows are left out there;
    under "degenerate" they are exactly NaN."""
    _card()
    bars, mask = _rows(n_slots, seed=n_slots, random_rows=2000,
                       device="cuda")
    rows = None if reading == "degenerate" else [
        r for r in range(mask.shape[0]) if r not in PV_CORR_CONSTANT_ROWS]
    before = pv_corr_cuda.launches
    with pins.pinned(constant_window=reading):
        got = pv_corr_cuda.pv_corr(bars, mask)
        torch.cuda.synchronize()
        assert pv_corr_cuda.launches == before + 1
        plain_card = pv_corr_cuda.pv_corr_plain(bars[..., 3], bars[..., 4],
                                                mask)
        plain_cpu = pv_corr_cuda.pv_corr(bars.cpu(), mask.cpu())
        again = pv_corr_cuda.pv_corr(bars, mask)
    _close(got, plain_card, n_slots, rows)
    _close(got, plain_cpu, n_slots, rows)
    if reading == "degenerate":
        assert torch.isnan(got[:, list(PV_CORR_CONSTANT_ROWS)]).all()
    assert same_bits(again, got)  # no atomics: the bits repeat


@pytest.mark.cuda
def test_kernel_takes_a_prefix_mask_and_leading_dims_on_the_card():
    """A stream-style prefix mask over a ``[days, tickers]`` batch: the
    kernel reads only what lies before each bar."""
    _card()
    bars, mask = _rows(240, seed=11, random_rows=2000, device="cuda")
    mask[:, 90:] = False
    bars = bars.reshape(4, -1, 240, 5)
    mask = mask.reshape(4, -1, 240)
    got = pv_corr_cuda.pv_corr(bars, mask)
    assert got.shape == (6,) + tuple(mask.shape[:-1])
    _close(got.reshape(6, -1), pv_corr_cuda.pv_corr_plain(
        bars[..., 3], bars[..., 4], mask).reshape(6, -1), 240)


@pytest.mark.cuda
def test_one_launch_per_context_on_the_card(fresh_telemetry):
    """All 58 factors of a batch launch the kernel once; a resident year
    of ``n`` steps launches it ``n`` times, each under one labelled
    ``ctx.pv_corr`` span."""
    _card()
    bars, mask = _rows(240, random_rows=300, device="cuda")
    bars, mask = bars.reshape(4, -1, 240, 5), mask.reshape(4, -1, 240)
    before = pv_corr_cuda.launches
    out = compute_factors(bars, mask, rolling_impl="cuda")
    torch.cuda.synchronize()
    assert pv_corr_cuda.launches == before + 1
    for k, n in enumerate(pv_corr_cuda.NAMES):
        _close(out[n][None].reshape(1, -1),
               _parent(n, bars[..., 3], bars[..., 4], mask)
               .reshape(1, -1), 240)
    n = 3
    bufs, spec = _tiny_year(n, 2, 64)
    before = pv_corr_cuda.launches
    pl.compute_packed_resident([b.cuda() for b in bufs], spec, "wire",
                               rolling_impl="cuda")
    torch.cuda.synchronize()
    assert pv_corr_cuda.launches == before + n
    spans = [e for e in fresh_telemetry.tracer.events()
             if e["name"] == "ctx.pv_corr"]
    assert Counter(e["labels"]["impl"] for e in spans) == {"cuda": n + 1}


@pytest.mark.cuda
def test_wrapper_refuses_what_the_kernel_does_not_take():
    """A non-contiguous, wrong-dtype, mixed-device or misshapen input, or
    rows longer than a block's shared memory holds, raises before any
    launch, with the counter unchanged."""
    _card()
    bars, mask = _rows(240, random_rows=8, device="cuda")
    before = pv_corr_cuda.launches
    with pytest.raises(ValueError, match="contiguous"):
        pv_corr_cuda.pv_corr(bars[::2], mask[::2])
    with pytest.raises(ValueError, match="contiguous"):
        pv_corr_cuda.pv_corr(bars, mask.t().contiguous().t())
    with pytest.raises(TypeError, match="float32"):
        pv_corr_cuda.pv_corr(bars.double(), mask)
    with pytest.raises(TypeError, match="bool"):
        pv_corr_cuda.pv_corr(bars, mask.to(torch.uint8))
    with pytest.raises(ValueError, match="CUDA device"):
        pv_corr_cuda.pv_corr(bars, mask.cpu())
    with pytest.raises(ValueError, match="CUDA device"):
        pv_corr_cuda.pv_corr(bars.cpu(), mask)
    with pytest.raises(ValueError, match="expected"):
        pv_corr_cuda.pv_corr(bars[:, :, :4].contiguous(), mask)
    with pytest.raises(ValueError, match="expected"):
        pv_corr_cuda.pv_corr(bars, mask[:4])
    wide = pv_corr_cuda.MAX_SLOTS + 1
    with pytest.raises(ValueError, match="slots"):
        pv_corr_cuda.pv_corr(torch.zeros(2, wide, 5, device="cuda"),
                             torch.ones(2, wide, dtype=torch.bool,
                                        device="cuda"))
    torch.cuda.synchronize()
    assert pv_corr_cuda.launches == before
    # a context over a non-contiguous view makes it contiguous first
    view = bars.reshape(4, -1, 240, 5)[:, ::2]
    vmask = mask.reshape(4, -1, 240)[:, ::2]
    got = DayContext(view, vmask).pv_corr
    assert pv_corr_cuda.launches == before + 1
    _close(got.reshape(6, -1), pv_corr_cuda.pv_corr_plain(
        view[..., 3], view[..., 4], vmask).reshape(6, -1), 240)
