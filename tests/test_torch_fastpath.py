"""The port's O(1)-per-bar fast finalize on the CPU (tests/test_fastpath.py's
gates).

Every kernel declares ``finalize_class`` in {exact_fold, stat_fold,
batch_only} at the JAX package's split (6/22/30); the foldable kernels
materialize from the carried statistics (``stream/fastpath.py``) and the
rest ride the batch-prefix residual. Per class, at the three tier-1
sessions: ``exact_fold`` bitwise the exact finalize, ``stat_fold`` within
its ``STAT_FOLD_BOUNDS`` pin, ``batch_only`` bitwise between the two
impls. The port's fast values are held against the JAX fast finalize run
on the JAX carry of the same minutes within the same pins.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from replication_of_minute_frequency_factor_tpu.markets import (
    get_session as jax_session)
from replication_of_minute_frequency_factor_tpu.stream import (
    fastpath as jfp)
from replication_of_minute_frequency_factor_tpu.stream.engine import (
    StreamEngine as JaxEngine)
from replication_of_minute_frequency_factor_tpu_torch.config import (
    Config, get_config, set_config)
from replication_of_minute_frequency_factor_tpu_torch.models.registry import (
    ALIASES, FINALIZE_CLASS_VALUES, FINALIZE_CLASSES, factor_names,
    finalize_classes, register_alias)
from replication_of_minute_frequency_factor_tpu_torch.ops import incremental
from replication_of_minute_frequency_factor_tpu_torch.stream import fastpath
from replication_of_minute_frequency_factor_tpu_torch.stream.engine import (
    StreamEngine)
from replication_of_minute_frequency_factor_tpu_torch.telemetry import (
    Telemetry)
from torch_cases import feed, feed_cohorts, same_bits, stream_day

SESSIONS = ("cn_ashare_240", "us_390", "crypto_1440")
CLASS_SPLIT = {"exact_fold": 6, "stat_fold": 22, "batch_only": 30}


def _engine(n, names, **kw):
    return StreamEngine(n, names=names, device="cpu", **kw)


def test_every_kernel_declares_a_finalize_class():
    cls = finalize_classes()
    assert set(cls) == set(factor_names())
    assert set(cls.values()) <= set(FINALIZE_CLASS_VALUES)
    counts = {c: sum(1 for v in cls.values() if v == c)
              for c in FINALIZE_CLASS_VALUES}
    assert counts == CLASS_SPLIT
    fastpath.check_fast_coverage()
    stat = {n for n, c in cls.items() if c == "stat_fold"}
    assert stat == set(fastpath.STAT_FOLD_BOUNDS)
    assert fastpath.STAT_FOLD_BOUNDS == jfp.STAT_FOLD_BOUNDS
    assert set(fastpath.FAST_FORMULAS) == set(jfp.FAST_FORMULAS)
    assert fastpath.FOLDABLE_CLASSES == jfp.FOLDABLE_CLASSES


def test_partition_preserves_order_and_splits_by_class():
    names = factor_names()
    fold, residual = fastpath.partition_names(names)
    cls = finalize_classes()
    assert fold == tuple(n for n in names
                         if cls[n] in fastpath.FOLDABLE_CLASSES)
    assert residual == tuple(n for n in names
                             if cls[n] not in fastpath.FOLDABLE_CLASSES)
    assert len(fold) == CLASS_SPLIT["exact_fold"] + CLASS_SPLIT["stat_fold"]
    assert (fold, residual) == jfp.partition_names(names)


def test_alias_is_batch_only():
    name = "torch_test_alias_return_std"
    register_alias(name, "vol_return1min")
    try:
        assert finalize_classes()[name] == "batch_only"
        assert fastpath.partition_names((name,)) == ((), (name,))
    finally:
        ALIASES.pop(name)
        FINALIZE_CLASSES.pop(name)


def test_finalize_impl_resolution(monkeypatch):
    """'fast' resolves fast only when a foldable kernel is served; the
    default comes from ``Config.finalize_impl`` (``MFF_FINALIZE_IMPL``)."""
    cls = finalize_classes()
    batch_only = tuple(n for n in factor_names()
                       if cls[n] == "batch_only")[:2]
    assert _engine(4, ("vol_return1min",),
                   finalize_impl="fast").finalize_impl_resolved == "fast"
    assert _engine(4, batch_only,
                   finalize_impl="fast").finalize_impl_resolved == "exact"
    assert _engine(4, ("vol_return1min",)).finalize_impl_resolved == "exact"
    with pytest.raises(ValueError, match="finalize_impl"):
        _engine(4, ("vol_return1min",), finalize_impl="warm")
    monkeypatch.setenv("MFF_FINALIZE_IMPL", "fast")
    assert Config.from_env().finalize_impl == "fast"
    old = get_config()
    try:
        set_config(Config(finalize_impl="fast"))
        eng = _engine(4, ("vol_return1min",))
        assert eng.finalize_impl == eng.finalize_impl_resolved == "fast"
    finally:
        set_config(old)
    tel = Telemetry()
    _engine(4, ("vol_return1min", "doc_std"), finalize_impl="fast",
            telemetry=tel)
    assert tel.registry.gauge_value("stream.finalize_fold_factors") == 1
    assert tel.registry.gauge_value("stream.finalize_residual_factors") == 1


def _day(sname, seed=21, tickers=6):
    return stream_day(seed, tickers, jax_session(sname).n_slots)


@pytest.mark.parametrize("sname", SESSIONS)
def test_fast_parity_all_58_within_pinned_bounds(sname):
    """A full day under both impls: exact_fold bitwise the exact
    finalize, stat_fold within its pin, batch_only bitwise across impls,
    the readiness plane the same."""
    names = factor_names()
    bars, mask = _day(sname)
    n, s = mask.shape
    fast = _engine(n, names, session=sname, finalize_impl="fast")
    exact = _engine(n, names, session=sname, finalize_impl="exact")
    assert fast.finalize_impl_resolved == "fast"
    for eng in (fast, exact):
        feed(eng, bars, mask, 0, s, micro=s)
    f_exp, f_ready = (x.numpy() for x in fast.snapshot())
    e_exp, e_ready = (x.numpy() for x in exact.snapshot())
    np.testing.assert_array_equal(f_ready, e_ready)
    cls = finalize_classes()
    bad = []
    for j, name in enumerate(names):
        rep = fastpath.parity_report(name, e_exp[j], f_exp[j])
        if not rep["ok"]:
            bad.append((name, rep))
        if cls[name] == "batch_only" and not np.array_equal(
                f_exp[j], e_exp[j], equal_nan=True):
            bad.append((name, "batch_only differs across impls"))
    assert not bad, f"{sname}: {bad[:5]} ({len(bad)} total)"


@pytest.mark.parametrize("sname", SESSIONS)
def test_port_fast_values_match_the_jax_fast_finalize(sname):
    """The port's fast values against JAX ``stream_finalize_fast`` over
    the JAX carry of the same day cut at the same minute, within the
    pins (exact_fold bitwise)."""
    bars, mask = _day(sname, seed=37)
    n, s = mask.shape
    hi = s - 11
    fold = fastpath.partition_names(factor_names())[0]
    eng = _engine(n, fold, session=sname, finalize_impl="fast")
    feed(eng, bars, mask, 0, hi, micro=16)
    got = eng.snapshot()[0].numpy()
    jeng = JaxEngine(n, names=("liq_openvol",), session=sname)
    feed(jeng, bars, mask, 0, hi, micro=16)
    jinc = {k.split("/", 1)[1]: jnp.asarray(v)
            for k, v in jeng.save().items() if k.startswith("inc/")}
    want = np.asarray(jfp.stream_finalize_fast(jinc, fold))
    bad = [(n_, rep) for j, n_ in enumerate(fold)
           if not (rep := fastpath.parity_report(n_, want[j], got[j]))["ok"]]
    assert not bad, bad[:5]


@pytest.mark.parametrize("impl", ("exact", "fast"))
def test_midday_restore_matches_never_stopping(impl):
    n = 8
    bars, mask = _day("cn_ashare_240", seed=13, tickers=n)
    names = ("vol_return1min", "shape_skew", "mmt_am", "mmt_ols_qrs")
    straight = _engine(n, names, finalize_impl=impl)
    feed(straight, bars, mask, 0, 240, micro=240)
    first = _engine(n, names, finalize_impl=impl)
    feed(first, bars, mask, 0, 97, micro=97)
    snap = first.save()
    assert {k.split("/", 1)[1] for k in snap if k.startswith("inc/")} \
        == set(incremental.init_inc(n))
    resumed = _engine(n, names, finalize_impl=impl,
                      executables=first.executables).restore(snap)
    feed(resumed, bars, mask, 97, 240, micro=143)
    a, ra = straight.snapshot()
    b, rb = resumed.snapshot()
    assert same_bits(a, b) and torch.equal(ra, rb)


def test_wrong_session_restore_still_refused_fast():
    snap = _engine(4, ("vol_return1min",), finalize_impl="fast").save()
    crypto = _engine(4, ("vol_return1min",), session="crypto_1440",
                     finalize_impl="fast")
    with pytest.raises(ValueError, match="slot"):
        crypto.restore(snap)


def test_cohort_scan_mix_bit_identical_fast():
    """The statistic fold does not care how a minute arrived: the same
    minutes wholesale through the scan, or as cohort scatters and
    single-minute scans in turn, give bitwise leaves and a bitwise fast
    snapshot."""
    n, k, minutes = 16, 8, 24
    bars, mask = stream_day(3, n)
    names = ("vol_return1min", "shape_skew", "trade_headRatio",
             "liq_amihud_1min", "mmt_am", "mmt_paratio")
    scan = _engine(n, names, finalize_impl="fast")
    feed(scan, bars, mask, 0, minutes, micro=minutes)
    mix = _engine(n, names, finalize_impl="fast")
    for t in range(minutes):
        if t % 2:
            feed_cohorts(mix, bars, mask, t, t + 1, k)
        else:
            feed(mix, bars, mask, t, t + 1, micro=1)
    a, b = scan.save(), mix.save()
    differ = [key for key in a
              if not np.array_equal(a[key], b[key], equal_nan=True)]
    assert differ == []
    assert same_bits(scan.snapshot()[0], mix.snapshot()[0])


def test_warm_fast_engine_builds_nothing_more():
    tel = Telemetry()
    n = 8
    bars, mask = stream_day(5, n)
    eng = StreamEngine(n, names=("vol_return1min", "mmt_ols_qrs"),
                       finalize_impl="fast", telemetry=tel, device="cpu")
    eng.warmup(micro_batches=(4,), cohorts=(3,))
    reg = tel.registry
    before = reg.counter_value("serve.executables", outcome="miss")
    feed(eng, bars, mask, 0, 16, micro=4)
    eng.ingest_cohort(np.ascontiguousarray(bars[:3, 16]),
                      np.arange(3, dtype=np.int32))
    eng.advance()
    exp, _ = eng.snapshot()
    assert exp.shape == (2, n)
    assert reg.counter_value("serve.executables", outcome="miss") == before
    assert reg.counter_value("stream.finalize_snapshots", impl="fast") == 1


def test_range_pin_misses_on_tight_spreads_as_the_jax_formula_does():
    """A reference fault, not the port's: on ``synth_day``'s tight
    high/low spreads (the std of high/low ~3e-4 around 1.0, near f32's
    resolution there) the Welford fold of ``vol_range1min`` misses the
    JAX package's own ``STAT_FOLD_BOUNDS`` pin against the exact finalize
    (the running mean's rounding is a large share of each deviation). The
    JAX engine misses it on the same day; the port misses it with it, its
    fast values within the pin of JAX's, and the other stat_fold factors
    hold theirs."""
    from replication_of_minute_frequency_factor_tpu_torch.data import (
        grid_day, synth_day)

    rng = np.random.default_rng(2)
    d = synth_day(rng, n_codes=16, date="2024-01-02", missing_prob=0.02)
    g = grid_day(d["code"], d["time"], d["open"], d["high"], d["low"],
                 d["close"], d["volume"])
    names = ("vol_range1min", "vol_return1min", "vol_volume1min")
    port, jax_vals = {}, {}
    for impl in ("exact", "fast"):
        eng = _engine(16, names, finalize_impl=impl)
        feed(eng, g.bars, g.mask, 0, 60, micro=60)
        port[impl] = eng.snapshot()[0].numpy()
        jeng = JaxEngine(16, names=names, finalize_impl=impl)
        feed(jeng, g.bars, g.mask, 0, 60, micro=60)
        jax_vals[impl] = np.asarray(jeng.snapshot()[0])
    for j, name in enumerate(names):
        ours = fastpath.parity_report(name, port["exact"][j],
                                      port["fast"][j])
        theirs = jfp.parity_report(name, jax_vals["exact"][j],
                                   jax_vals["fast"][j])
        assert ours["ok"] == theirs["ok"] == (name != "vol_range1min"), (
            ours, theirs)
        assert fastpath.parity_report(name, jax_vals["fast"][j],
                                      port["fast"][j])["ok"]


def _kurtosis_root_day(seed: int, tickers: int = 4, slots: int = 240):
    """A day whose ticker 0 has minute returns (close/open - 1, open 1.0)
    with an excess kurtosis of about 0: its last return is bisected until
    the f64 excess kurtosis of the f32 returns changes sign. The other
    tickers are plain random walks."""
    rng = np.random.default_rng(seed)
    ret = (rng.standard_normal((tickers, slots)) * 1e-3).astype(np.float32)

    def excess(last):
        r = ret[0].astype(np.float64)
        r[-1] = np.float32(1.0 + np.float32(last)) - np.float32(1.0)
        d = r - r.mean()
        return (d ** 4).mean() / (d ** 2).mean() ** 2 - 3.0

    grid = np.linspace(-2e-2, 2e-2, 4001)
    signs = np.sign([excess(x) for x in grid])
    k = int(np.flatnonzero(signs[:-1] != signs[1:])[0])
    a, b = grid[k], grid[k + 1]
    for _ in range(80):
        m = 0.5 * (a + b)
        a, b = (m, b) if np.sign(excess(m)) == signs[k] else (a, m)
    ret[0, -1] = np.float32(a)
    open_ = np.ones((tickers, slots), np.float32)
    close = (open_ + ret).astype(np.float32)
    high = np.maximum(open_, close) * np.float32(1.0002)
    low = np.minimum(open_, close) * np.float32(0.9998)
    volume = (rng.integers(1, 1000, (tickers, slots)) * 100).astype(
        np.float32)
    bars = np.stack([open_, high, low, close, volume], -1).astype(np.float32)
    return bars, np.ones((tickers, slots), bool)


def test_skratio_pin_misses_where_the_kurtosis_crosses_zero_as_jax_does():
    """A reference fault, not the port's: ``shape_skratio`` is skew over
    excess kurtosis, so on a ticker whose excess kurtosis is about 0 the
    ratio amplifies the f32 rounding of either finalize without bound,
    and the JAX package's own fast finalize misses its ``STAT_FOLD_BOUNDS``
    pin there. The port misses it with it; on the other tickers both
    packages hold the pin and the port's fast values are within it of
    JAX's."""
    bars, mask = _kurtosis_root_day(2)
    n = mask.shape[0]
    names = ("shape_skratio",)
    port, jax_vals = {}, {}
    for impl in ("exact", "fast"):
        eng = _engine(n, names, finalize_impl=impl)
        feed(eng, bars, mask, 0, 240, micro=16)
        port[impl] = eng.snapshot()[0].numpy()[0]
        jeng = JaxEngine(n, names=names, finalize_impl=impl)
        feed(jeng, bars, mask, 0, 240, micro=16)
        jax_vals[impl] = np.asarray(jeng.snapshot()[0])[0]
    name = names[0]
    ours = fastpath.parity_report(name, port["exact"], port["fast"])
    theirs = jfp.parity_report(name, jax_vals["exact"], jax_vals["fast"])
    assert not ours["ok"] and not theirs["ok"], (ours, theirs)
    rest = slice(1, None)
    assert fastpath.parity_report(name, port["exact"][rest],
                                  port["fast"][rest])["ok"]
    assert jfp.parity_report(name, jax_vals["exact"][rest],
                             jax_vals["fast"][rest])["ok"]
    assert fastpath.parity_report(name, jax_vals["fast"][rest],
                                  port["fast"][rest])["ok"]
