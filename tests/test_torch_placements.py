"""The placements inside one server process, on the CPU: the in-process
mesh (``parallel.resident_mesh(n, devices=[cpu] * n)``), the
ticker-sharded stream carry, the population-sharded discovery generation,
and a server or fleet replica that spreads both over its devices.

What each holds:

* the in-process collectives: bitwise the single-device ops (every shard
  ranks or reduces the identical gathered frame, sums in shard order);
  a shard that raises before its exchange makes every shard raise,
  under a time limit of its own;
* ``StreamEngine(mesh=)``: against the JAX package's sharded engine
  (``resident_mesh(4)`` over its 8 virtual CPU devices,
  tests/test_stream.py's re-placement pin) within tests/test_parity.py's
  comparator, as tests/test_torch_stream.py holds the unsharded engine,
  with the readiness planes bitwise; bitwise the port's unsharded engine
  through scan, cohort (a pad row at ``idx == T`` included), advance,
  the side outputs, a save and restore across placements, and a day
  folded as cohorts;
* ``generation_fitness_sharded``: bitwise the port's single-device
  generation at the chunk of a shard's block, pad rows never selected,
  and within test_torch_research.py's holds of JAX's single-device
  generation (JAX's own sharded generation fails under the installed
  jax; ROADMAP's reference notes);
* ``DiscoveryEngine(mesh=)``: the shard count, the occupancy, one sync a
  generation, the top-k collective counted, the single-device engine's
  search at the matched chunk;
* ``FactorServer(devices=[cpu] * 4)`` with ``stream_sharded`` and
  ``discover_sharded``: the gauges, intraday answers bitwise a standalone
  server's, a discover job; the one-device and non-dividing cases stay on
  one device; a 2-replica fleet over ``[cpu] * 8``, held to the JAX
  package's sharded fleet.
"""

import threading

import jax
import numpy as np
import pytest
import torch
import torch.distributed as dist

from replication_of_minute_frequency_factor_tpu import fleet as jfleet
from replication_of_minute_frequency_factor_tpu import serve as jserve
from replication_of_minute_frequency_factor_tpu.parallel import (
    resident_mesh as jax_resident_mesh)
from replication_of_minute_frequency_factor_tpu.research import (
    fitness as JF)
from replication_of_minute_frequency_factor_tpu.stream.engine import (
    StreamEngine as JaxEngine)
from replication_of_minute_frequency_factor_tpu_torch import search as P
from replication_of_minute_frequency_factor_tpu_torch.fleet import (
    FactorFleet)
from replication_of_minute_frequency_factor_tpu_torch.models import (
    registry as models_registry)
from replication_of_minute_frequency_factor_tpu_torch.ops import (
    rank_average)
from replication_of_minute_frequency_factor_tpu_torch.ops.masked import (
    masked_mean)
from replication_of_minute_frequency_factor_tpu_torch.parallel import (
    LocalMesh, collectives as xc, resident_mesh, transport)
from replication_of_minute_frequency_factor_tpu_torch.parallel.mesh import (
    TICKERS_AXIS, Mesh)
from replication_of_minute_frequency_factor_tpu_torch.research import (
    DiscoveryEngine, fitness as PF, registry as PR)
from replication_of_minute_frequency_factor_tpu_torch.serve import (
    FactorServer, Query, ServeConfig, SyntheticSource)
from replication_of_minute_frequency_factor_tpu_torch.serve.executables import (
    ExecutableCache)
from replication_of_minute_frequency_factor_tpu_torch.stream.engine import (
    StreamEngine)
from replication_of_minute_frequency_factor_tpu_torch.telemetry import (
    Telemetry)
from test_torch_research import INTERP_ATOL, INTERP_RTOL, _day_data
from test_torch_stream import _hold_to_jax
from torch_cases import (
    bounded_population, feed, feed_cohorts, minutes_of, same_order,
    stream_day)

#: tests/test_stream.py's family subset: doc_pdf60 is the one global rank
NAMES = ("vol_return1min", "mmt_ols_qrs", "doc_kurt", "doc_pdf60")
#: tests/test_fastpath.py's statistic-leaf set
FAST_NAMES = ("vol_return1min", "shape_skew", "trade_headRatio")
T = 16
CPU = torch.device("cpu")
#: a limit of its own for anything that could wait at a barrier forever
HANG_S = 120


def _mesh(n=4):
    return resident_mesh(n, devices=[CPU] * n)


@pytest.fixture
def mesh():
    m = _mesh()
    yield m
    m.close()


@pytest.fixture(autouse=True)
def _restore_registries():
    """A discover job registers its genome process-wide: each test leaves
    the registries as they were."""
    live = (models_registry.ALIASES, models_registry.FINALIZE_CLASSES,
            PR.DISCOVERED)
    saved = [dict(d) for d in live]
    yield
    for d, before in zip(live, saved):
        d.clear()
        d.update(before)


def _bits(x) -> np.ndarray:
    a = np.asarray(x.cpu() if isinstance(x, torch.Tensor) else x)
    return a.view(np.int32) if a.dtype == np.float32 else a


def _same(a, b) -> bool:
    """Bitwise, with NaN positions compared apart from the other lanes
    (a NaN that went through a Python float may change its sign bit)."""
    a = np.asarray(a, np.float32)
    b = np.asarray(b, np.float32)
    nan = np.isnan(a)
    return (a.shape == b.shape and np.array_equal(nan, np.isnan(b))
            and np.array_equal(a[~nan].view(np.int32),
                               b[~nan].view(np.int32)))


def _within(seconds, fn):
    """``fn()`` on a thread of its own, which must end within
    ``seconds``; returns what it returned or raised."""
    box = {}

    def go():
        try:
            box["out"] = fn()
        except BaseException as e:  # handed to the test
            box["err"] = e

    th = threading.Thread(target=go, daemon=True)
    th.start()
    th.join(seconds)
    assert not th.is_alive(), f"still waiting after {seconds} s"
    return box


# --------------------------------------------------------------------------
# the in-process mesh and its collectives
# --------------------------------------------------------------------------


def test_resident_mesh_with_devices_is_an_in_process_mesh():
    m = resident_mesh(3, devices=[CPU] * 4)
    try:
        assert isinstance(m, LocalMesh)
        assert m.shape == {"days": 1, "tickers": 3} and m.size == 3
        assert m.devices == (CPU,) * 3 and m.device == CPU
        assert m.key() == ("local", "cpu", "cpu", "cpu")
        views = m.run(lambda v: (v.coordinate, v.axis_index(TICKERS_AXIS),
                                 v.backend, str(v.device),
                                 threading.current_thread().name))
        assert [v[:4] for v in views] == [((0, i), i, "local", "cpu")
                                          for i in range(3)]
        assert len({v[4] for v in views}) == 3  # a thread a shard
        assert resident_mesh(devices=[CPU] * 2).size == 2
    finally:
        m.close()
    with pytest.raises(ValueError, match="tickers-only"):
        resident_mesh(4, devices=[CPU] * 4, shape=(2, 2))
    with pytest.raises(ValueError, match="needs 5 devices"):
        resident_mesh(5, devices=[CPU] * 4)
    # without a process group, a CPU device keeps the one-rank mesh
    one = resident_mesh(1, device="cpu")
    assert isinstance(one, Mesh) and not isinstance(one, LocalMesh)


def test_the_mesh_asks_for_a_card_and_raises_without_one(monkeypatch):
    """No device list means every visible card; a card asked for and
    absent raises, never a quiet CPU run."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        resident_mesh(2)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        resident_mesh(2, devices=["cuda:0", "cuda:0"])


def _frame(seed, t=24, d=3):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((d, t)).astype(np.float32)
    x[:, 5] = x[:, 6]  # ties
    m = rng.random((d, t)) > 0.2
    return torch.from_numpy(x), torch.from_numpy(m)


@pytest.mark.parametrize("op", ["gather", "sum", "min", "max", "object",
                                "gather_to_first"])
def test_transport_over_the_in_process_group(mesh, op):
    """Each transport call over a shard's group handle: the gather in
    shard order, the reductions in shard order and the same bits on every
    shard, objects in shard order."""
    x, _ = _frame(1)
    blocks = list(x.chunk(4, dim=-1))
    red = {"sum": dist.ReduceOp.SUM, "min": dist.ReduceOp.MIN,
           "max": dist.ReduceOp.MAX}

    def body(v, blk):
        g = v.group(TICKERS_AXIS)
        assert transport.backend_of(g) == "local"
        if op == "gather":
            return transport.all_gather(blk, g, dim=-1)
        if op == "object":
            return transport.all_gather_object(("shard", v.rank), g)
        if op == "gather_to_first":
            return transport.gather(blk, g)
        return transport.all_reduce(blk, red[op], g)

    out = mesh.run(body, blocks)
    if op == "gather":
        for o in out:
            assert torch.equal(o, x)
    elif op == "object":
        assert out == [[("shard", i) for i in range(4)]] * 4
    elif op == "gather_to_first":
        assert [torch.equal(a, b) for a, b in zip(out[0], blocks)] == \
            [True] * 4
        assert out[1:] == [None] * 3
    else:
        want = blocks[0].clone()
        fn = {"sum": torch.add, "min": torch.minimum,
              "max": torch.maximum}[op]
        for b in blocks[1:]:
            want = fn(want, b)
        for o in out:
            assert torch.equal(_bits_t(o), _bits_t(want))


def _bits_t(t):
    return t.view(torch.int32) if t.dtype == torch.float32 else t


def test_cross_sectional_collectives_are_the_single_device_ops(mesh):
    """The per-rank bodies of ``collectives`` on the in-process mesh:
    the rank, the global rank and the masked mean bitwise the
    single-device ops on the whole frame."""
    x, m = _frame(2)
    xs, ms = list(x.chunk(4, -1)), list(m.chunk(4, -1))

    def body(v, bx, bm):
        return (xc.xs_rank_local(bx, bm),
                xc.xs_global_rank_local(bx.reshape(1, -1),
                                        bm.reshape(1, -1)),
                xc.xs_masked_mean_local(bx, bm))

    out = mesh.run(body, xs, ms)
    rank = torch.cat([o[0] for o in out], -1)
    assert torch.equal(_bits_t(rank), _bits_t(rank_average(x, m)))
    grank = torch.cat([o[1] for o in out], -1)
    flat = torch.cat([b.reshape(1, -1) for b in xs], -1)
    mflat = torch.cat([b.reshape(1, -1) for b in ms], -1)
    assert torch.equal(_bits_t(grank), _bits_t(rank_average(flat, mflat)))
    # the mean's partial sums are added in shard order: the same bits on
    # every shard, and within the f32 rounding bound of a 24-lane sum
    # (24 eps) of the single-device sum
    for o in out[1:]:
        assert torch.equal(_bits_t(o[2]), _bits_t(out[0][2]))
    eps = float(np.finfo(np.float32).eps)
    torch.testing.assert_close(out[0][2], masked_mean(x, m),
                               rtol=24 * eps, atol=0)


def test_shards_take_turns_on_the_host_between_exchanges(mesh):
    """One shard runs on the host at a time, each up to its next
    exchange: the stretches of work the shards log between exchanges
    never overlap, and each exchange still sees every shard."""
    import time
    log = []
    lock = threading.Lock()

    def body(v):
        g = v.group(TICKERS_AXIS)
        seen = []
        for step in range(3):
            t0 = time.perf_counter()
            time.sleep(0.01)  # gives up the GIL, not the turn
            with lock:
                log.append((t0, time.perf_counter(), v.rank, step))
            seen.append(transport.all_gather_object(v.rank, g))
        return seen

    out = _within(HANG_S, lambda: mesh.run(body))["out"]
    assert out == [[[0, 1, 2, 3]] * 3] * 4
    spans = sorted(log)
    assert len(spans) == 12
    for (a0, a1, *_), (b0, b1, *_) in zip(spans, spans[1:]):
        assert a1 <= b0, "two shards ran at once"


@pytest.mark.parametrize("where", ["plain", "guarded"])
def test_a_shard_raising_before_its_exchange_makes_every_shard_raise(
        mesh, where):
    """Shard 2 raises before the gather the others wait in: every shard
    raises (the failing one its own error, the others PeerStepError),
    within a limit of its own; under ``status_guard`` the others raise
    from the status swap. The mesh runs again afterwards."""
    def body(v):
        g = v.group(TICKERS_AXIS)
        ctx = (transport.status_guard(g) if where == "guarded"
               else threading.Lock())
        with ctx:
            if v.rank == 2:
                raise ValueError("shard 2 failed before its exchange")
            return transport.all_gather(torch.ones(2) * v.rank, g, dim=0)

    box = _within(HANG_S, lambda: mesh.run(body))
    err = box.get("err")
    assert isinstance(err, ValueError) and "shard 2" in str(err)
    kinds = [type(e).__name__ for e in err.shard_errors]
    assert kinds == ["PeerStepError", "PeerStepError", "ValueError",
                     "PeerStepError"]
    again = _within(HANG_S, lambda: mesh.run(
        lambda v: transport.all_gather(torch.ones(1) * v.rank,
                                       v.group(TICKERS_AXIS), dim=0)))
    assert torch.equal(again["out"][3], torch.arange(4.0))


# --------------------------------------------------------------------------
# the ticker-sharded stream carry
# --------------------------------------------------------------------------


def _snap(engine):
    e, r = engine.snapshot()
    return np.asarray(e), np.asarray(r)


def test_sharded_stream_matches_jax_sharded_and_the_unsharded_engine(mesh):
    """tests/test_stream.py's re-placement pin on both packages: a
    mid-day carry saved unsharded and restored onto a 4-shard placement
    finalizes as the unsharded engine does (the port bitwise, JAX's
    sharded engine within the parity comparator, readiness bitwise), and
    so does the continued fold through scan, cohort (with a dropped pad
    row) and advance, and the round trip back to an unsharded engine."""
    bars, mask = stream_day(17, T)
    plain = StreamEngine(T, names=NAMES, device="cpu")
    feed(plain, bars, mask, 0, 97, micro=16)  # mid-day, mid-micro-batch
    sharded = StreamEngine(T, names=NAMES, mesh=mesh).restore(plain.save())
    assert len(sharded.carry) == 4
    assert [c["bars"].shape[0] for c in sharded.carry] == [T // 4] * 4
    jplain = JaxEngine(T, names=NAMES)
    feed(jplain, bars, mask, 0, 97, micro=16)
    jsharded = JaxEngine(T, names=NAMES,
                         mesh=jax_resident_mesh(4)).restore(jplain.save())
    assert len(jsharded.carry["bars"].sharding.device_set) == 4

    failures = []

    def hold(label):
        ep, rp = _snap(plain)
        es, rs = _snap(sharded)
        ej, rj = (np.asarray(a) for a in jax.device_get(jsharded.snapshot()))
        assert np.array_equal(_bits(es), _bits(ep)), label
        assert np.array_equal(rs, rp) and np.array_equal(rs, rj), label
        _hold_to_jax(label, NAMES, es, ej, failures)
        return es

    hold("restored at minute 97")
    for eng in (plain, sharded, jsharded):
        feed(eng, bars, mask, 97, 140)
    hold("scan to minute 140")
    rows = np.ascontiguousarray(bars[:3, 140]).astype(np.float32)
    idx = np.array([0, 5, T], np.int32)  # incl. a dropped pad row
    for eng in (plain, sharded, jsharded):
        eng.ingest_cohort(rows, idx)
        eng.advance()
    es = hold("cohort and advance at minute 140")
    back = StreamEngine(T, names=NAMES, device="cpu").restore(sharded.save())
    eb, _ = _snap(back)
    assert np.array_equal(_bits(eb), _bits(es))
    # a JAX sharded carry restores onto the port's sharded engine
    from_jax = StreamEngine(T, names=NAMES, mesh=mesh).restore(
        jsharded.save())
    ef, _ = _snap(from_jax)
    _hold_to_jax("JAX's sharded carry, restored", NAMES, ef,
                 np.asarray(jsharded.snapshot()[0]), failures)
    assert not failures, "\n".join(failures[:40])


@pytest.mark.parametrize("minute", [60, 120, 240])
def test_sharded_snapshots_of_a_day_are_the_unsharded_bits(mesh, minute):
    """The day folded in 16-minute micro-batches on both placements: at
    each exact snapshot the exposures and readiness bitwise, all four
    snapshot kinds (the payload byte for byte, the stats bitwise), the
    saved carries equal leaf by leaf."""
    bars, mask = stream_day(23, T)
    plain = StreamEngine(T, names=NAMES, device="cpu")
    sharded = StreamEngine(T, names=NAMES, mesh=mesh)
    for eng in (plain, sharded):
        feed(eng, bars, mask, 0, minute, micro=16)
    ep, rp = _snap(plain)
    es, rs = _snap(sharded)
    assert np.array_equal(_bits(es), _bits(ep)) and np.array_equal(rs, rp)
    for kind in ("snapshot_stats", "snapshot_wire", "snapshot_wire_stats"):
        a, b = getattr(plain, kind)(), getattr(sharded, kind)()
        assert len(a) == len(b)
        for x, y in zip(a, b):
            assert x.dtype == y.dtype and np.array_equal(_bits(x), _bits(y)),\
                kind
    sp, ss = plain.save(), sharded.save()
    assert set(sp) == set(ss)
    for k in sp:
        assert np.array_equal(sp[k], ss[k], equal_nan=True), k


def test_sharded_replacement_covers_statistic_leaves(mesh):
    """tests/test_fastpath.py's pin on the fast finalize: a mid-day carry
    saved unsharded restores onto 4 shards with every statistic leaf cut
    into ticker blocks, and the fast snapshot and the continued fold stay
    bitwise the unsharded engine's and within the parity comparator of
    JAX's sharded engine."""
    bars, mask = stream_day(17, T)
    plain = StreamEngine(T, names=FAST_NAMES, device="cpu",
                         finalize_impl="fast")
    plain.ingest_minutes(*minutes_of(bars, mask, 0, 97))
    sharded = StreamEngine(T, names=FAST_NAMES, mesh=mesh,
                           finalize_impl="fast").restore(plain.save())
    assert sharded.finalize_impl_resolved == "fast"
    for c in sharded.carry:
        for key, leaf in c["inc"].items():
            assert leaf.shape[0] == T // 4, key
    jplain = JaxEngine(T, names=FAST_NAMES, finalize_impl="fast")
    jplain.ingest_minutes(*minutes_of(bars, mask, 0, 97))
    jsharded = JaxEngine(T, names=FAST_NAMES, finalize_impl="fast",
                         mesh=jax_resident_mesh(4)).restore(jplain.save())
    failures = []
    for lo, hi in ((None, None), (97, 140)):
        if lo is not None:
            for eng in (plain, sharded, jsharded):
                eng.ingest_minutes(*minutes_of(bars, mask, lo, hi))
        ep, rp = _snap(plain)
        es, rs = _snap(sharded)
        assert np.array_equal(_bits(es), _bits(ep))
        assert np.array_equal(rs, rp)
        ej = np.asarray(jsharded.snapshot()[0])
        _hold_to_jax(f"fast to {hi or 97}", FAST_NAMES, es, ej, failures)
    assert not failures, "\n".join(failures[:40])


def test_sharded_cohort_day_equals_the_scan_day(mesh):
    """A day's minutes as 8-ticker cohorts (absent tickers and the short
    tail padded with ``idx == T``) plus ``advance``, on 4 shards: every
    carry leaf bitwise the scan path's on one device."""
    bars, mask = stream_day(5, T)
    scan = StreamEngine(T, names=NAMES[:1], device="cpu")
    feed(scan, bars, mask, 0, 64, micro=16)
    cohort = StreamEngine(T, names=NAMES[:1], mesh=mesh)
    feed_cohorts(cohort, bars, mask, 0, 64, k=6)
    a, b = scan.save(), cohort.save()
    assert int(b["t"]) == 64
    for k in a:
        assert np.array_equal(a[k], b[k], equal_nan=True), k


def test_sharded_engine_refuses_what_it_cannot_place(mesh):
    with pytest.raises(ValueError, match="divide"):
        StreamEngine(15, names=NAMES[:1], mesh=mesh)
    with pytest.raises(ValueError, match="not both"):
        StreamEngine(T, names=NAMES[:1], mesh=mesh, device="cpu")
    with pytest.raises(TypeError, match="in-process mesh"):
        StreamEngine(T, names=NAMES[:1], mesh=resident_mesh(1,
                                                            device="cpu"))


def test_warm_sharded_engine_builds_nothing_and_keys_its_placement(mesh):
    """After warmup a sharded engine's ingest, cohort, advance and every
    snapshot kind build nothing; the placement is in the key, so an
    unsharded engine on the same cache builds its own callables."""
    tel = Telemetry()
    cache = ExecutableCache(telemetry=tel)
    bars, mask = stream_day(3, T)
    eng = StreamEngine(T, names=NAMES, mesh=mesh, executables=cache,
                       telemetry=tel)
    eng.warmup(micro_batches=(8,), cohorts=(4,))
    reg = tel.registry

    def misses():
        return reg.counter_value("serve.executables", outcome="miss")

    before = misses()
    feed(eng, bars, mask, 0, 16, micro=8)
    eng.ingest_cohort(np.ascontiguousarray(bars[:4, 16]),
                      np.arange(4, dtype=np.int32))
    eng.advance()
    for kind in ("snapshot", "snapshot_stats", "snapshot_wire",
                 "snapshot_wire_stats"):
        getattr(eng, kind)()
    assert misses() == before
    other = StreamEngine(T, names=NAMES, device="cpu", executables=cache,
                         telemetry=tel)
    other.warmup(micro_batches=(8,))
    assert misses() > before


# --------------------------------------------------------------------------
# the population-sharded generation and DiscoveryEngine(mesh=)
# --------------------------------------------------------------------------


def test_sharded_generation_is_the_single_device_one_and_never_picks_pad(
        mesh):
    """pop 10 padded to 12 over 4 shards: at chunk 1 every row of the
    stats bitwise the port's single-device generation on the padded
    population; the top-k is the single-device top-k of the logical
    rows (the pad rows, which the unmasked single-device top-k would pick
    here, never selected)."""
    bars, mask, fr, fv = _day_data(seed=3)
    eng = DiscoveryEngine(device="cpu", telemetry=Telemetry())
    data = eng.prepare(bars, mask, fr, fv)
    g = P.random_population(np.random.default_rng(1), 12,
                            P.DEFAULT_SKELETON)
    g[10:] = 0
    single, _, _ = PF.generation_fitness(g, *data.device_args, chunk=1,
                                         n_elite=4)
    stats, vals, idx = PF.generation_fitness_sharded(
        g, *data.device_args, mesh, chunk=1, n_elite=4, n_pop=10)
    assert np.array_equal(_bits(stats), _bits(single))
    assert (idx < 10).all()
    lv, li = PF.device_topk(single[:10, 0], 4)
    assert torch.equal(idx, li) and np.array_equal(_bits(vals), _bits(lv))
    unmasked, _ = PF.device_topk(single[:, 0], 4)
    assert not torch.equal(unmasked, lv)  # the pad would have been picked
    with pytest.raises(ValueError, match="divide"):
        PF.generation_fitness_sharded(g[:10], *data.device_args, mesh)


def test_sharded_generation_holds_to_jax_single_device():
    """The sharded generation against JAX's ``generation_fitness`` on the
    same genomes: test_torch_research.py's holds (NaN positions, the
    fitness and IC columns within the interpreter tolerance, rank IC and
    spread on the candidates whose exposures order alike), and the top-k
    JAX's where the fitness is bitwise."""
    skel = P.DEFAULT_SKELETON
    bars, mask, fr, fv = _day_data(days=5, tickers=32, seed=3)
    g = bounded_population(4, 40, skel)
    m = _mesh(4)
    try:
        eng = DiscoveryEngine(mesh=m, telemetry=Telemetry())
        data = eng.prepare(bars, mask, fr, fv)
        stats, vals, idx = PF.generation_fitness_sharded(
            g, *data.device_args, m, skeleton=skel, chunk=5, n_elite=6)
    finally:
        m.close()
    got = stats.numpy()
    want, _, _ = (np.asarray(a) for a in JF.generation_fitness(
        g, bars, mask, fr, fv, skeleton=skel, group_num=5, chunk=16,
        n_elite=6))
    assert got.shape == want.shape == (40, 4)
    assert np.array_equal(np.isnan(got), np.isnan(want))
    for c in (0, 1):
        np.testing.assert_allclose(got[:, c], want[:, c],
                                   rtol=INTERP_RTOL, atol=INTERP_ATOL)
    import jax.numpy as jnp
    from replication_of_minute_frequency_factor_tpu import search as J
    vals_j = np.asarray(jax.jit(J.eval_programs, static_argnums=3)(
        g, bars, mask, skel))
    mine = P.eval_programs(g, torch.from_numpy(bars),
                           torch.from_numpy(mask), skel).numpy()
    order = same_order(mine, vals_j, np.isfinite(vals_j) & fv)
    assert order.sum() > len(g) // 2
    np.testing.assert_allclose(got[order, 2:], want[order, 2:],
                               rtol=INTERP_RTOL, atol=INTERP_ATOL)
    # JAX's top-k on the port's fitness column is the port's
    jv, ji = jax.lax.top_k(jnp.nan_to_num(got[:, 0], nan=-1.0), 6)
    assert np.array_equal(idx.numpy(), np.asarray(ji))


def test_discovery_engine_on_a_mesh(mesh):
    """``DiscoveryEngine(mesh=)``: four shards, pop 10 padded to 12
    (occupancy 10/12), one sync and one counted top-k collective a
    generation, nothing built in the loop, and at the matched chunk (1)
    the single-device engine's search under the same rng."""
    bars, mask, fr, fv = _day_data(seed=4)
    out = []
    tels = []
    for kw in ({"mesh": mesh}, {"device": "cpu"}):
        tel = Telemetry()
        eng = DiscoveryEngine(telemetry=tel, device_batch=1, **kw)
        data = eng.prepare(bars, mask, fr, fv)
        if "mesh" in kw:
            assert eng.n_shards == 4 and eng.device == CPU
            assert len(data.feats) == 4
        eng.warmup(data, 10)
        out.append(eng.evolve(data, pop=10, generations=3,
                              rng=np.random.default_rng(42)))
        tels.append(tel)
    sh, one = out
    assert sh.n_shards == 4 and one.n_shards == 1
    assert sh.occupancy == pytest.approx(10 / 12) and one.occupancy == 1.0
    assert sh.syncs_per_generation == 1.0 == one.syncs_per_generation
    assert sh.compiles_during_loop == 0
    reg = tels[0].registry
    assert reg.counter_value("mesh.collective_dispatches",
                             label="discover_topk") == 3
    assert reg.gauge_value("discover.population_occupancy") == \
        pytest.approx(10 / 12)
    assert np.array_equal(sh.genome, one.genome)
    assert np.array_equal(sh.history, one.history)
    assert sh.fitness == one.fitness
    assert (sh.device_topk[1] < 10).all()


# --------------------------------------------------------------------------
# the server and the fleet
# --------------------------------------------------------------------------


def _src(n_tickers=16):
    return SyntheticSource(n_days=8, n_tickers=n_tickers, seed=3)


def _minutes(src, lo, hi):
    bars, mask = src.slab(0, 1)
    return minutes_of(bars[0], mask[0], lo, hi)


def _intraday(server_like, src):
    """Minutes 0-16 of the source's first day ingested in two
    micro-batches (a server's ingest is a future, a fleet's is its legs),
    then one intraday answer."""
    for lo in (0, 8):
        res = server_like.ingest(*_minutes(src, lo, lo + 8))
        if hasattr(res, "result"):
            res.result(120)
    return server_like.submit(Query("intraday")).result(120)


def _standalone_intraday(names=NAMES, n_tickers=16):
    src = _src(n_tickers)
    with FactorServer(src, names=names, device="cpu", stream=True,
                      stream_batches=(8,),
                      serve_cfg=ServeConfig(hbm_sample_period_s=0)) as srv:
        return _intraday(srv, src)


def _hold_intraday(got, want, names=NAMES):
    assert got["minute"] == want["minute"] == 16
    for n in names:
        assert _same(got["exposures"][n], want["exposures"][n]), n
        assert np.array_equal(np.asarray(got["ready"][n]),
                              np.asarray(want["ready"][n])), n


def test_server_spreads_stream_and_discovery_over_its_devices(tmp_path):
    """``devices=[cpu] * 4`` with both knobs: the carry over 4 ticker
    shards and the population over 4 (both gauges read 4), intraday
    answers bitwise a standalone server's, and a discover job runs on the
    sharded engine with one sync a generation."""
    src = _src()
    tel = Telemetry()
    cfg = ServeConfig(stream_sharded=True, discover_sharded=True,
                      hbm_sample_period_s=0, research_dir=str(tmp_path))
    with FactorServer(src, names=NAMES, devices=[CPU] * 4, stream=True,
                      stream_batches=(8,), research=True, serve_cfg=cfg,
                      telemetry=tel) as srv:
        reg = tel.registry
        assert reg.gauge_value("stream.carry_sharded") == 4
        assert reg.gauge_value("discover.n_shards") == 4
        assert srv.stream_engine.mesh.size == 4
        assert srv.research_engine.mesh.size == 4
        got = _intraday(srv, src)
        ans = srv.discover(0, 8, generations=2, pop=10,
                           seed=7).result(600)
    _hold_intraday(got, _standalone_intraday())
    assert ans["n_shards"] == 4 and ans["syncs_per_generation"] == 1.0
    assert ans["compiles_during_loop"] == 0


@pytest.mark.parametrize("case", ["one_device", "non_dividing"])
def test_server_stays_on_one_device_where_a_placement_does_not_apply(case):
    """One device (both knobs) or a universe that does not divide over the
    devices (``stream_sharded``): the engine stays on ``devices[0]``,
    silently, and the gauges say so."""
    n_tickers = 16 if case == "one_device" else 15
    devices = [CPU] if case == "one_device" else [CPU] * 4
    src = _src(n_tickers)
    tel = Telemetry()
    cfg = ServeConfig(stream_sharded=True, discover_sharded=True,
                      hbm_sample_period_s=0)
    with FactorServer(src, names=NAMES, devices=devices, stream=True,
                      stream_batches=(8,), research=(case == "one_device"),
                      serve_cfg=cfg, telemetry=tel) as srv:
        reg = tel.registry
        assert reg.gauge_value("stream.carry_sharded") == 0
        assert srv.stream_engine.mesh is None
        if case == "one_device":
            assert reg.gauge_value("discover.n_shards") == 1
        got = _intraday(srv, src)
    _hold_intraday(got, _standalone_intraday(n_tickers=n_tickers))


def test_fleet_replicas_spread_their_carry_over_their_groups():
    """A 2-replica fleet over ``[cpu] * 8`` with both knobs: each replica's
    carry spans its 4 devices, and a routed intraday answer is bitwise a
    standalone server's and within the parity comparator of the JAX
    package's fleet with its carries sharded over 4 virtual devices."""
    src = _src(24)
    cfg = dict(stream_sharded=True, discover_sharded=True,
               hbm_sample_period_s=0)
    with FactorFleet(src, 2, names=NAMES, serve_cfg=ServeConfig(**cfg),
                     stream=True, stream_batches=(8,),
                     devices=[CPU] * 8) as fleet:
        for r in fleet.replicas:
            assert r.telemetry.registry.gauge_value(
                "stream.carry_sharded") == 4
            assert r.server.stream_engine.mesh.devices == (CPU,) * 4
        got = _intraday(fleet, src)
    _hold_intraday(got, _standalone_intraday(n_tickers=24))
    jsrc = jserve.SyntheticSource(n_days=8, n_tickers=24, seed=3)
    jfl = jfleet.FactorFleet(jsrc, 2, names=NAMES,
                             serve_cfg=jserve.ServeConfig(**cfg),
                             stream=True, stream_batches=(8,))
    try:
        assert all(r.server.stream_engine.mesh is not None
                   for r in jfl.replicas)
        want = _intraday(jfl, jsrc)
    finally:
        jfl.close()
    failures = []
    mine = np.stack([np.asarray(got["exposures"][n], np.float32)
                     for n in NAMES])
    ref = np.stack([np.asarray(want["exposures"][n], np.float32)
                    for n in NAMES])
    _hold_to_jax("fleet intraday", NAMES, mine, ref, failures)
    assert not failures, "\n".join(failures[:40])
