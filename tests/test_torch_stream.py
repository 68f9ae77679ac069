"""The port's streaming engine on the CPU, against itself and the JAX
package's (tests/test_stream.py's gates).

The load-bearing claim: folding a day minute by minute (or cohort by
cohort) through the port's ``init_carry / update / finalize`` gives, at
every minute, exactly the port's own batch graph (``compute_batch``) on
the day cut at that minute: bitwise, for all 58 kernels, at
``cn_ashare_240``, ``us_390`` and ``crypto_1440``. Against the JAX
package: the full-day fold within tests/test_parity.py's ``_check_cell``
of ``compute_factors_jit(rolling_impl='conv')``; after the same minutes
the carries' integer counters, selections and windowed sums bitwise and
the Welford moments within :data:`MOMENT_RTOL` (XLA contracts the M2
update into an FMA; the port runs separate eager ops); the readiness
planes bitwise; and a carry snapshot moves between the packages both
ways. The days are ``torch_cases.stream_day``: the JAX package's
``bench.make_batch`` recipe, absent bars holding drawn values.
"""

import time

import jax
import numpy as np
import pytest
import torch

from replication_of_minute_frequency_factor_tpu.markets import (
    get_session as jax_session)
from replication_of_minute_frequency_factor_tpu.models.registry import (
    compute_factors_jit, finalize_classes as jax_finalize_classes,
    stream_requirements as jax_stream_requirements)
from replication_of_minute_frequency_factor_tpu.stream import carry as jsc
from replication_of_minute_frequency_factor_tpu.stream.engine import (
    StreamEngine as JaxEngine)
from replication_of_minute_frequency_factor_tpu_torch import (
    compute_batch, compute_exposures_streamed)
from replication_of_minute_frequency_factor_tpu_torch.data import (
    result_wire as rw)
from replication_of_minute_frequency_factor_tpu_torch.models import (
    DayContext, factor_names)
from replication_of_minute_frequency_factor_tpu_torch.models.registry import (
    finalize_classes, stream_requirements)
from replication_of_minute_frequency_factor_tpu_torch.ops import incremental
from replication_of_minute_frequency_factor_tpu_torch.parallel import (
    resident_mesh)
from replication_of_minute_frequency_factor_tpu_torch.stream import (
    carry as sc)
from replication_of_minute_frequency_factor_tpu_torch.stream.engine import (
    StreamEngine)
from replication_of_minute_frequency_factor_tpu_torch.telemetry import (
    Telemetry)
from replication_of_minute_frequency_factor_tpu_torch.telemetry.factorplane import (
    factor_stats_host)
from test_parity import _check_cell
from torch_cases import (
    feed, feed_cohorts, minutes_of, prefix_day, same_bits, stream_day)

#: one kernel per family shape class (tests/test_stream.py's set)
FAMILY = ("vol_return1min", "mmt_ols_qrs", "doc_kurt", "doc_pdf60",
          "trade_headRatio", "liq_openvol", "mmt_am")
SESSIONS = ("cn_ashare_240", "us_390", "crypto_1440")
#: Welford moment leaves: the JAX scan fuses ``m2 + delta * delta_n *
#: n_old`` into an FMA, so these differ from the port's by an ulp a step;
#: held within MOMENT_RTOL of the leaf's largest magnitude (M3, a sum
#: that cancels to near zero, is the loosest: ~9e-6 seen)
MOMENT_LEAVES = tuple(f"st_{s}_{m}" for s in ("ret", "volu")
                      for m in ("m2", "m3", "m4")) + (
    "st_range_m2", "st_retpos_m2", "st_retneg_m2")
MOMENT_RTOL = 5e-5


def _engine(n, names=FAMILY, **kw):
    kw.setdefault("device", "cpu")
    return StreamEngine(n, names=names, **kw)


def _jax_carry(bars, mask, hi, session=None):
    """The JAX engine's saved carry after minutes [0, hi)."""
    eng = JaxEngine(mask.shape[0], names=("liq_openvol",), session=session)
    feed(eng, bars, mask, 0, hi, micro=16)
    return eng.save()


def _hold_to_jax(label, names, port, ref, failures):
    """Per factor: NaN positions identical, values through test_parity's
    comparator with the JAX value in the reference's place."""
    for i, name in enumerate(names):
        a, b = port[i], ref[i]
        if not np.array_equal(np.isnan(a), np.isnan(b)):
            failures.append(f"{label}/{name}: NaN positions differ")
        for t in range(a.shape[0]):
            aux = {k: ref[names.index(k), t]
                   for k in ("shape_kurt", "shape_kurtVol") if k in names}
            _check_cell(label, name, t, b[t], a[t], True, failures, aux,
                        lambda: {})


# --------------------------------------------------------------------------
# the parity gate: S increments == the full day, all 58, bitwise
# --------------------------------------------------------------------------


@pytest.mark.parametrize("sname", SESSIONS)
def test_stream_S_increment_parity_all_58(sname):
    """Feeding every minute of a day reproduces the port's batch result
    for all 58 kernels bit for bit, and the JAX package's within the
    parity suite's tolerances."""
    s = jax_session(sname).n_slots
    bars, mask = stream_day(42, 12, s)
    names = factor_names()
    got = compute_exposures_streamed(bars, mask, micro_batch=16,
                                     session=sname, device="cpu")
    want = compute_batch(bars, mask, session=sname, device="cpu").numpy()
    bad = [n for i, n in enumerate(names)
           if not np.array_equal(want[i], got[n], equal_nan=True)]
    assert bad == [], f"{sname}: streamed fold differs from batch: {bad}"
    ref = compute_factors_jit(jax.device_put(bars), jax.device_put(mask),
                              names=names, rolling_impl="conv",
                              session=sname)
    ref = np.stack([np.asarray(ref[n]) for n in names])
    failures = []
    _hold_to_jax(f"stream-{sname}", names,
                 np.stack([got[n] for n in names]), ref, failures)
    assert not failures, "\n".join(failures[:40])


# --------------------------------------------------------------------------
# partial-day prefix + readiness (monotone, sound, the JAX package's bits)
# --------------------------------------------------------------------------


def test_partial_day_prefix_matches_batch_and_readiness():
    """At every sampled minute the snapshot is bitwise the port's batch on
    the day cut there; readiness is monotone, sound (a not-ready lane is
    NaN) and bitwise the JAX carry's readiness at the same minute."""
    bars, mask = stream_day(3, 12)
    eng = _engine(12)
    jeng = JaxEngine(12, names=("liq_openvol",))
    last = None
    for t_stop in (0, 1, 7, 51, 120, 240):
        eng.reset()
        jeng.reset()
        feed(eng, bars, mask, 0, t_stop)
        feed(jeng, bars, mask, 0, t_stop, micro=16)
        exp, ready = (x.numpy() for x in eng.snapshot())
        pb, pm = prefix_day(bars, mask, t_stop)
        want = compute_batch(pb, pm, names=FAMILY, device="cpu").numpy()
        np.testing.assert_array_equal(want, exp, err_msg=f"t={t_stop}")
        jinc = {k.split("/", 1)[1]: v for k, v in jeng.save().items()
                if k.startswith("inc/")}
        jready = np.asarray(jsc.readiness(jinc, FAMILY))
        np.testing.assert_array_equal(ready, jready, err_msg=f"t={t_stop}")
        assert not np.any(~ready & ~np.isnan(exp)), t_stop
        if last is not None:
            assert not np.any(last & ~ready), t_stop
        last = ready


def test_stream_requirements_and_finalize_classes_equal_jax():
    reqs = stream_requirements()
    assert reqs == jax_stream_requirements()
    assert set(reqs) >= set(factor_names())
    for name, (counter, minimum) in reqs.items():
        assert counter in incremental.WINDOW_COUNTERS, name
        assert minimum >= 1, name
    ours, theirs = finalize_classes(), jax_finalize_classes()
    assert {n: ours[n] for n in factor_names()} == \
        {n: theirs[n] for n in factor_names()}


@pytest.mark.parametrize("sname", SESSIONS)
def test_window_counters_equal_jax(sname):
    from replication_of_minute_frequency_factor_tpu.ops import (
        incremental as jinc)

    assert incremental.window_counters_for(sname) == \
        jinc.window_counters_for(sname)
    assert incremental.STAT_LEAVES_F32 == jinc.STAT_LEAVES_F32
    assert incremental.STAT_LEAVES_I32 == jinc.STAT_LEAVES_I32
    assert incremental.SEL_LEAVES == jinc.SEL_LEAVES
    init, jinit = incremental.init_inc(3), jinc.init_inc(3)
    assert list(init) == list(jinit)
    for k in init:
        assert init[k].dtype == jinit[k].dtype, k
        np.testing.assert_array_equal(init[k], jinit[k])


# --------------------------------------------------------------------------
# the carry: cohort == scan, the JAX carry, save/restore across packages
# --------------------------------------------------------------------------


def test_cohort_ingest_equals_scan_ingest_bitwise():
    """The same minutes as K-ticker cohorts (padding rows dropped) leave
    every carry leaf bitwise the whole-minute scan path's."""
    n, k = 12, 5   # k does not divide n: the pad path runs
    bars, mask = stream_day(7, n)
    scan = _engine(n, names=FAMILY[:1])
    feed(scan, bars, mask, 0, 60, micro=6)
    cohort = _engine(n, names=FAMILY[:1], executables=scan.executables)
    feed_cohorts(cohort, bars, mask, 0, 60, k)
    a, b = scan.save(), cohort.save()
    assert set(a) == set(b)
    for key in a:
        assert a[key].dtype == b[key].dtype, key
        np.testing.assert_array_equal(a[key], b[key], err_msg=key)


@pytest.mark.parametrize("sname", SESSIONS)
def test_carry_leaves_match_the_jax_carry(sname):
    """After the same minutes every leaf has the JAX leaf's dtype and
    shape; counters, selections, sums and means are bitwise, the Welford
    moments within MOMENT_RTOL of the leaf's scale."""
    s = jax_session(sname).n_slots
    bars, mask = stream_day(11, 12, s)
    hi = s - 7
    want = _jax_carry(bars, mask, hi, session=sname)
    eng = _engine(12, names=FAMILY[:1], session=sname)
    feed(eng, bars, mask, 0, hi, micro=16)
    got = eng.save()
    assert set(got) == set(want)
    for key in want:
        a, b = np.asarray(got[key]), np.asarray(want[key])
        assert a.dtype == b.dtype and a.shape == b.shape, key
        leaf = key.split("/", 1)[-1]
        if leaf in MOMENT_LEAVES:
            scale = float(np.abs(b).max())
            np.testing.assert_allclose(a, b, rtol=MOMENT_RTOL,
                                       atol=MOMENT_RTOL * scale,
                                       err_msg=key)
        else:
            np.testing.assert_array_equal(a, b, err_msg=key)


def test_midday_restart_produces_identical_tail():
    n = 12
    bars, mask = stream_day(11, n)
    names = FAMILY[:3]
    eng = _engine(n, names=names)
    feed(eng, bars, mask, 0, 120)
    snap = eng.save()
    assert int(snap["t"]) == 120
    restored = _engine(n, names=names,
                       executables=eng.executables).restore(snap)
    assert restored.minutes == 120
    feed(eng, bars, mask, 120, 240)
    feed(restored, bars, mask, 120, 240)
    assert same_bits(eng.snapshot()[0], restored.snapshot()[0])
    sa, sb = eng.save(), restored.save()
    for key in sa:
        np.testing.assert_array_equal(sa[key], sb[key], err_msg=key)


def test_snapshots_move_between_the_packages_both_ways():
    """A JAX snapshot at minute 97 restores into the port and the port
    finishes the day bitwise its own uninterrupted run; a port snapshot
    restores into the JAX engine and JAX finishes bitwise its own. The
    two finished days agree within the parity suite's tolerances."""
    n = 12
    bars, mask = stream_day(17, n)
    names = FAMILY
    port = _engine(n, names=names)
    feed(port, bars, mask, 0, 240)
    port_exp = port.snapshot()[0].numpy()
    jax_eng = JaxEngine(n, names=names)
    feed(jax_eng, bars, mask, 0, 240, micro=16)
    jax_exp = np.asarray(jax_eng.snapshot()[0])

    mid_jax = JaxEngine(n, names=names, executables=jax_eng.executables)
    feed(mid_jax, bars, mask, 0, 97, micro=16)
    into_port = _engine(n, names=names).restore(mid_jax.save())
    assert into_port.minutes == 97
    feed(into_port, bars, mask, 97, 240)
    assert same_bits(into_port.snapshot()[0], torch.from_numpy(port_exp))

    mid_port = _engine(n, names=names)
    feed(mid_port, bars, mask, 0, 97)
    into_jax = JaxEngine(n, names=names,
                         executables=jax_eng.executables).restore(
        mid_port.save())
    feed(into_jax, bars, mask, 97, 240, micro=16)
    np.testing.assert_array_equal(np.asarray(into_jax.snapshot()[0]),
                                  jax_exp)
    failures = []
    _hold_to_jax("restored", names, port_exp, jax_exp, failures)
    assert not failures, "\n".join(failures)


def test_carry_roundtrip_preserves_every_leaf():
    c = sc.init_carry(4)
    host = sc.carry_from_host(sc.carry_to_host(
        sc.carry_to_device(c, "cpu")))
    assert set(host) == set(c)
    for k in ("bars", "mask", "t"):
        np.testing.assert_array_equal(host[k], c[k], err_msg=k)
    assert set(host["inc"]) == set(c["inc"])
    for k in c["inc"]:
        assert host["inc"][k].dtype == c["inc"][k].dtype, k
        np.testing.assert_array_equal(host["inc"][k], c["inc"][k])
    want = jsc.carry_to_host(jax.device_put(jsc.init_carry(4)))
    got = sc.carry_to_host(sc.carry_to_device(c, "cpu"))
    assert set(got) == set(want)
    for k in want:
        assert np.asarray(got[k]).dtype == np.asarray(want[k]).dtype, k


def test_saved_snapshot_does_not_alias_the_carry():
    """A saved snapshot keeps its values while the engine ingests on, and
    restoring one never writes into it."""
    bars, mask = stream_day(5, 4)
    eng = _engine(4, names=FAMILY[:1])
    feed(eng, bars, mask, 0, 10)
    snap = eng.save()
    frozen = {k: np.array(v, copy=True) for k, v in snap.items()}
    feed(eng, bars, mask, 10, 30)
    other = _engine(4, names=FAMILY[:1]).restore(snap)
    feed(other, bars, mask, 10, 20)
    for k in frozen:
        np.testing.assert_array_equal(snap[k], frozen[k], err_msg=k)


# --------------------------------------------------------------------------
# DayContext injection: the int32 carry count against the int64 batch one
# --------------------------------------------------------------------------


def test_injected_int32_count_gives_the_batch_bits():
    """The carry's ``n_bars`` is int32 where ``mask.sum`` is int64; it is
    injected as it is, because every consumer reads it through
    ``has_bars`` (``> 0``): all 58 come out bitwise the batch's."""
    bars, mask = stream_day(23, 8)
    b, m = torch.from_numpy(np.where(mask[..., None], bars, 0.0)), \
        torch.from_numpy(mask)
    plain = DayContext(b, m)
    assert plain.n_bars.dtype == torch.int64
    inject = {"n_bars": m.sum(dim=-1, dtype=torch.int32),
              "last_close": plain.last_close}
    ctx = DayContext(b, m, inject=inject)
    assert ctx.n_bars.dtype == torch.int32
    names = factor_names()
    from replication_of_minute_frequency_factor_tpu_torch.models import (
        compute_factors)
    want = compute_factors(b, m, names=names)
    got = compute_factors(b, m, names=names, inject=inject)
    for n in names:
        assert same_bits(got[n], want[n]), n
    # a sharded tickers axis resolves through the active mesh: outside
    # one the cross-sectional rank has no group to gather over
    ctx = DayContext(b, m, xs_axis_name="tickers")
    with pytest.raises(RuntimeError, match="active mesh"):
        ctx.eod_ret_global_rank


# --------------------------------------------------------------------------
# the side outputs on the snapshot
# --------------------------------------------------------------------------


def test_snapshot_wire_and_stats_hold_the_raw_snapshot():
    """``snapshot_wire_stats`` decodes within RESULT_BOUNDS of the raw
    snapshot with exact NaN status, its stats' counts/min/max are bitwise
    ``factor_stats_host`` of the raw exposures, and the exposures are the
    plain snapshot's bits."""
    n = 12
    bars, mask = stream_day(29, n)
    names = factor_names()
    eng = _engine(n, names=names)
    feed(eng, bars, mask, 0, 130, micro=16)
    exp, ready = eng.snapshot()
    e2, r2, stats = eng.snapshot_stats()
    assert same_bits(e2, exp) and torch.equal(r2, ready)
    payload, r3, stats_w = eng.snapshot_wire_stats()
    p_only, _ = eng.snapshot_wire()
    assert torch.equal(payload, p_only) and torch.equal(r3, ready)
    raw = exp.numpy()
    host = factor_stats_host(raw)
    for s in (stats.numpy(), stats_w.numpy()):
        for col in (0, 1, 2, 3, 4, 7, 8):
            np.testing.assert_array_equal(s[:, col], host[:, col])
        np.testing.assert_allclose(s[:, 5:7], host[:, 5:7], rtol=1e-5,
                                   atol=1e-6)
    dec, verdict = rw.decode_block(payload.numpy(), len(names), 1, n,
                                   eng.result_spec.spill_rows,
                                   telemetry=Telemetry())
    chk = rw.check_bounds(raw[:, None, :], dec, names, sidx=verdict["sidx"])
    assert chk["ok"], chk
    assert same_bits(torch.from_numpy(rw.encode_block(
        exp[:, None, :], eng.result_spec).numpy()), payload)


# --------------------------------------------------------------------------
# guardrails
# --------------------------------------------------------------------------


def test_over_ingest_past_the_day_raises():
    n = 4
    bars, mask = stream_day(1, n)
    eng = _engine(n, names=FAMILY[:1])
    feed(eng, bars, mask, 0, 240)
    with pytest.raises(ValueError, match="overruns"):
        eng.ingest_minutes(np.zeros((1, n, 5), np.float32),
                           np.zeros((1, n), bool))
    with pytest.raises(ValueError, match="advancing past"):
        eng.advance()
    with pytest.raises(ValueError, match="no slot left"):
        eng.ingest_cohort(np.zeros((1, 5), np.float32),
                          np.zeros(1, np.int32))


def test_restore_rejects_wrong_universe_and_session():
    eng = _engine(4, names=FAMILY[:1])
    snap = eng.save()
    other = _engine(6, names=FAMILY[:1], executables=eng.executables)
    with pytest.raises(ValueError, match="sized for 6"):
        other.restore(snap)
    crypto = _engine(4, names=FAMILY[:1], session="crypto_1440")
    with pytest.raises(ValueError, match="slot"):
        crypto.restore(snap)


def test_ticker_count_mismatch_and_bad_inputs_raise():
    eng = _engine(4, names=FAMILY[:1])
    with pytest.raises(ValueError, match="engine holds"):
        eng.ingest_minutes(np.zeros((1, 5, 5), np.float32),
                           np.zeros((1, 5), bool))
    with pytest.raises(TypeError, match="int32"):
        eng.ingest_cohort(np.zeros((1, 5), np.float32),
                          np.zeros(1, np.int64))
    for bad in (-1, 5):
        with pytest.raises(ValueError, match="cohort indices"):
            eng.ingest_cohort(np.zeros((1, 5), np.float32),
                              np.array([bad], np.int32))
    # a ticker-sharded carry runs (tests/test_torch_placements.py holds
    # it); a mesh that is not an in-process one is refused
    mesh = resident_mesh(2, devices=["cpu", "cpu"])
    try:
        sharded = StreamEngine(4, names=FAMILY[:1], mesh=mesh)
        sharded.ingest_minutes(np.zeros((1, 4, 5), np.float32),
                               np.ones((1, 4), bool))
        exp, ready = sharded.snapshot()
        assert exp.shape == ready.shape == (1, 4) and sharded.minutes == 1
    finally:
        mesh.close()
    with pytest.raises(TypeError, match="in-process mesh"):
        StreamEngine(4, names=FAMILY[:1], mesh=object())
    with pytest.raises(ValueError, match="finalize_impl"):
        _engine(4, names=FAMILY[:1], finalize_impl="warm")


def test_warm_engine_builds_nothing_over_ingest_and_snapshots():
    """After warmup at the declared shapes, ingest, cohorts, advance and
    every snapshot kind leave ``serve.executables{outcome=miss}`` flat."""
    tel = Telemetry()
    n = 8
    bars, mask = stream_day(5, n)
    eng = StreamEngine(n, names=FAMILY[:2], telemetry=tel, device="cpu")
    eng.warmup(micro_batches=(4,), cohorts=(3,))
    reg = tel.registry
    misses = reg.counter_value("serve.executables", outcome="miss")
    assert misses == len(eng.executables) == 7
    feed(eng, bars, mask, 0, 16, micro=4)
    eng.ingest_cohort(np.ascontiguousarray(bars[:3, 16]),
                      np.arange(3, dtype=np.int32))
    eng.advance()
    eng.snapshot()
    eng.snapshot_stats()
    eng.snapshot_wire()
    eng.snapshot_wire_stats()
    assert reg.counter_value("serve.executables", outcome="miss") == misses
    assert reg.counter_value("serve.executables", outcome="hit") == 10
    assert reg.gauge_value("serve.executables_resident") == 7
    assert reg.counter_value("stream.updates", kind="scan") == 4
    assert reg.counter_value("stream.updates", kind="cohort") == 1
    assert reg.counter_value("stream.updates", kind="advance") == 1
    assert reg.counter_value("stream.bars") == int(mask[:, :16].sum()) + 3
    assert reg.counter_value("stream.snapshots") == 2
    assert reg.counter_value("stream.snapshots", kind="wire") == 2
    assert reg.counter_value("stream.finalize_snapshots", impl="exact") == 4
    assert reg.gauge_value("stream.minute") == 17
    assert reg.gauge_value("stream.carry_bytes") == sc.carry_nbytes(
        eng.carry)
    assert reg.histogram_stats("stream.update_seconds", kind="scan")


def test_staleness_none_until_first_ingest_then_counts_up():
    n = 6
    eng = _engine(n, names=FAMILY[:1])
    assert eng.staleness_s() is None
    bars, mask = stream_day(0, n)
    feed(eng, bars, mask, 0, 2)
    s1 = eng.staleness_s()
    assert s1 is not None and 0.0 <= s1 < 60.0
    time.sleep(0.05)
    s2 = eng.staleness_s()
    assert s2 > s1
    feed(eng, bars, mask, 2, 4)
    assert eng.staleness_s() < s2
    assert eng.cursor() == {"minute": 4, "tickers": n,
                            "session": "cn_ashare_240"}


def test_stream_entry_points_refuse_the_cpu_unless_asked(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    bars, mask = stream_day(0, 3)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        StreamEngine(3, names=FAMILY[:1])
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        StreamEngine(3, names=FAMILY[:1], device="cuda")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        compute_exposures_streamed(bars, mask, names=FAMILY[:1])
    got = compute_exposures_streamed(bars, mask, names=FAMILY[:1],
                                     device="cpu")
    assert got["vol_return1min"].shape == (3,)
    b, p = minutes_of(bars, mask, 0, 2)
    eng = StreamEngine(3, names=FAMILY[:1], device="cpu")
    eng.ingest_minutes(b, p)
    assert eng.carry["bars"].device.type == "cpu"
