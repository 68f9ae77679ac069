"""The metric arithmetic on fixed inputs: the idle union, the roofline's
bytes, the rates over a window, and the readers on a made-up trace."""

import importlib.util

import pytest

from perfbench import harness, roofline
from perfbench.trace import TraceSummary, gaps, summarize, union


def reader(name):
    path = harness.reader_path(harness.BENCH_DIR, name)
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def trace():
    """A 100 us window: kernels at 10-30 and 20-40 (overlapping), a copy
    at 60-70, a kernel half outside the window at 95-110; the host in
    ``aten::add`` over 40-60."""
    return TraceSummary(
        lo=0.0, hi=100.0,
        device=[("k_a", "kernel", 10.0, 20.0),
                ("second_moments_tiled_kernel", "kernel", 20.0, 20.0),
                ("Memcpy DtoH", "gpu_memcpy", 60.0, 10.0),
                ("k_late", "kernel", 95.0, 15.0)],
        host=[("aten::add", 40.0, 20.0), ("outer", 0.0, 100.0)])


def test_union_and_gaps():
    assert union([(10, 30), (20, 40), (60, 70), (95, 110)], 0, 100) == [
        (10, 40), (60, 70), (95, 100)]
    assert gaps([(10, 40), (60, 70), (95, 100)], 0, 100) == [
        (0, 10), (40, 60), (70, 95)]
    assert union([(5, 5), (200, 300)], 0, 100) == []


def test_busy_idle_and_breakdown():
    t = trace()
    assert t.busy_s == pytest.approx(45e-6)
    assert t.window_s == pytest.approx(100e-6)
    assert reader("device_idle_pct.resident")(
        harness.Run(None, t, {})) == pytest.approx(55.0)
    b = t.breakdown()
    assert b["idle_gaps"][0] == ["outer", pytest.approx(25e-6)]
    assert b["idle_gaps"][1] == ["aten::add", pytest.approx(20e-6)]
    assert [n for n, _ in b["device_ops"]] == [
        "k_a", "second_moments_tiled_kernel", "Memcpy DtoH"]


def test_summarize_finds_the_window():
    ev = [{"ph": "X", "cat": "user_annotation", "name": "perfbench.window",
           "ts": 5, "dur": 50},
          {"ph": "X", "cat": "kernel", "name": "k", "ts": 10, "dur": 5},
          {"ph": "X", "cat": "cpu_op", "name": "aten::mul", "ts": 6,
           "dur": 2},
          {"ph": "i", "cat": "kernel", "name": "marker", "ts": 7}]
    t = summarize(ev)
    assert (t.lo, t.hi) == (5.0, 55.0)
    assert t.kernels == [("k", 5.0)] and t.host == [("aten::mul", 6.0, 2.0)]
    with pytest.raises(RuntimeError):
        summarize(ev[1:])


def test_roofline_bytes_at_the_resident_step():
    # PERF.md's kernel table: 1075.2 MB and 0.3210 ms at [160000, 240]
    assert roofline.moment_bytes(160000, 240) == 1075.2e6
    assert roofline.moment_least_s(160000, 240) == pytest.approx(
        0.32096e-3, rel=1e-4)


def test_rolling_roofline_reader():
    t = trace()
    run = harness.Run(None, t, {"rolling_shape": (160000, 240)})
    # one 20 us call whose least time is 320.96 us
    assert reader("rolling_roofline_pct.resident")(run) == pytest.approx(
        100 * 320.955e-6 / 20e-6, rel=1e-4)
    assert reader("rolling_roofline_pct.resident")(
        harness.Run(None, t, {})) is None
    none = TraceSummary(0.0, 1.0, [], [])
    assert reader("rolling_roofline_pct.resident")(
        harness.Run(None, none, {"rolling_shape": (1, 1)})) is None


def test_launches_and_producer_readers():
    t = trace()
    run = harness.Run(None, t, {"days_traced": 2, "producer_s": 0.5})
    # k_late ends past the window: two kernels inside it
    assert reader("launches_per_day.resident")(run) == 1.0
    assert reader("producer_ms_per_day.backfill")(run) == 250.0
    assert reader("producer_ms_per_day.backfill")(
        harness.Run(None, t, {"days_traced": 2})) is None


def test_days_per_second_over_the_window():
    from perfbench.drivers import backfill, resident

    r = resident.Driver.__new__(resident.Driver)
    r.attempted = 512
    assert r.end_to_end(4.0) == {"resident_days_per_s": 128.0}
    b = backfill.Driver.__new__(backfill.Driver)
    b.attempted = 120
    assert b.end_to_end(24.0) == {"backfill_days_per_s": 5.0}
