"""The reader of ``volume_select_roofline_pct``: its bytes over the device
self time of the ``ctx.volume_selections`` spans on a made-up trace, and
its silence on a program without the labelled span."""

import importlib.util

import pytest

from perfbench import harness, roofline
from perfbench.trace import TraceSummary


def reader(name):
    path = harness.reader_path(harness.BENCH_DIR, name)
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


class _FakeEvent:
    """A CUDA timing event on a fake device clock (ms)."""
    now = 0.0

    def record(self, stream=None):
        self.t = _FakeEvent.now

    def synchronize(self):
        pass

    def elapsed_time(self, end):
        return end.t - self.t


def _volume_select_window(labels, ms=0.08, steps=2, sum_ms=0.02):
    """``steps`` steps of ``ctx.volume_selections`` spans of ``ms`` self
    time (ms) on a fake device clock, each under a ``factor.*`` span and
    holding a nested ``ctx.vol_sum`` of ``sum_ms``, in a fresh telemetry;
    returns the traced window's summary of their host annotations."""
    import time

    from replication_of_minute_frequency_factor_tpu_torch.telemetry import (
        Telemetry, set_telemetry)

    tr = set_telemetry(Telemetry()).tracer
    tr.device_timing, tr._event_factory = True, _FakeEvent
    host = []

    def span(name, took, inner=None, **kw):
        t0 = time.perf_counter() * 1e6
        with tr(name, **kw):
            _FakeEvent.now += took
            if inner is not None:
                inner()
        host.append((name, t0, time.perf_counter() * 1e6 - t0))

    for _ in range(steps):
        span("factor.mmt_top50VolumeRet", 0.01, lambda: span(
            "ctx.volume_selections", ms,
            lambda: span("ctx.vol_sum", sum_ms), **labels))
    lo = min(ts for _, ts, _ in host) - 1.0
    hi = max(ts + d for _, ts, d in host) + 1.0
    return TraceSummary(lo=lo, hi=hi, device=[], host=host)


@pytest.fixture
def restore_telemetry():
    from replication_of_minute_frequency_factor_tpu_torch.telemetry import (
        get_telemetry, set_telemetry)

    prev = get_telemetry()
    try:
        yield
    finally:
        set_telemetry(prev)


def test_volume_select_roofline_reader(restore_telemetry):
    """13 bytes a bar and 4 + 4 x answers a row at the HBM peak over the
    spans' device self time: the volume sum computed inside is not the
    kernel's."""
    labels = dict(rows=160000, slots=240, impl="cuda", answers=5)
    run = harness.Run(None, _volume_select_window(labels), {})
    least = (13 * 160000 * 240 + (4 + 4 * 5) * 160000) \
        / roofline.HBM_BYTES_PER_S
    assert least == pytest.approx(0.1502e-3, rel=1e-3)
    assert reader("volume_select_roofline_pct.resident")(run) == \
        pytest.approx(100 * 2 * least / (2 * 0.08e-3))


def test_volume_select_roofline_reader_is_silent_without_its_labels(
        restore_telemetry):
    """Silent on spans without the labels, without a trace, and on a
    program without the span (the parent's)."""
    read = reader("volume_select_roofline_pct.resident")
    unlabelled = _volume_select_window({})
    assert read(harness.Run(None, unlabelled, {})) is None
    partial = _volume_select_window(dict(rows=8, slots=240, impl="cuda"))
    assert read(harness.Run(None, partial, {})) is None
    assert read(harness.Run(None, None, {})) is None
    from replication_of_minute_frequency_factor_tpu_torch.telemetry import (
        Telemetry, set_telemetry)
    set_telemetry(Telemetry())
    assert read(harness.Run(None, unlabelled, {})) is None
