"""The port's sharded resident loops on the CPU: four gloo ranks spawned
once for the module (``torch_cases.run_on_ranks``), JAX in this process.

* the 1-D loop (``compute_packed_resident_sharded`` on a ``(1, 4)`` mesh)
  over all 58 factors against the JAX package's
  ``compute_packed_resident_sharded`` on its 8 virtual CPU devices
  (tests/test_parity.py's comparator, NaN/inf positions identical) and
  against the port's single-device loop bitwise, non-dividing tickers
  included; its side outputs are the global ones;
* the 2-D loop (``compute_packed_resident_2d`` on ``(2, 2)``) against the
  single-device loop bitwise — the JAX package's 2-D loop fails on the
  installed jax, so the single-device runs are its yardstick — with the
  cross-day carry at a day-shard boundary bitwise the JAX package's
  single-device span fold, the carry threaded across pipelined groups,
  both axes padded, and the handoff counted once a call;
* the donation contract on both loops, and the copies of
  ``bench.encode_year_sharded``/``encode_year_2d`` byte for byte.
"""

import jax
import numpy as np
import pytest
import torch

import bench
from replication_of_minute_frequency_factor_tpu import (
    pipeline as jax_pipeline)
from replication_of_minute_frequency_factor_tpu.data import wire as jwire
from replication_of_minute_frequency_factor_tpu.parallel import (
    put_packed_year, resident_mesh)
from replication_of_minute_frequency_factor_tpu.stream import (
    carry as jcarry)
from replication_of_minute_frequency_factor_tpu_torch import pipeline as pl
from replication_of_minute_frequency_factor_tpu_torch.data import (
    result_wire as rw)
from replication_of_minute_frequency_factor_tpu_torch.data import wire
from replication_of_minute_frequency_factor_tpu_torch.models import (
    factor_names)
from replication_of_minute_frequency_factor_tpu_torch.stream import (
    carry as tcarry)
from replication_of_minute_frequency_factor_tpu_torch.telemetry import (
    factorplane)
from test_torch_resident import _hold_to_jax
import torch_cases as tc

WORLD = 4
MESH_2D = (2, 2)
SOME = ("vol_return1min", "mmt_ols_qrs", "doc_kurt", "doc_vol10_ratio",
        "doc_pdf60", "vol_upRatio", "trade_headRatio", "liq_openvol")
EPS = float(np.finfo(np.float32).eps)


def _make_year(n_batches=3, days=2, tickers=32, seed=0):
    return [tc.make_batch(np.random.default_rng([seed, i]), days, tickers)
            for i in range(n_batches)]


def _single(batches, names, **kw):
    """The port's single-device resident loop on the unpadded year."""
    bufs, spec, kind = tc.encode_year(batches)
    return pl.compute_packed_resident(
        [torch.from_numpy(b).clone() for b in bufs], spec, kind, names,
        device="cpu", **kw)


def _bits(x):
    return np.ascontiguousarray(x).view(np.int32)


def _tickers(results, key):
    """The ranks' ``[..., T/t]`` blocks of a (1, t) job side by side."""
    parts = sorted((r[key]["coord"][1], r[key]["ys"]) for r in results)
    return np.concatenate([y for _, y in parts], axis=-1)


def _tiles(results, key):
    """The ranks' ``[N, F, D/d, T/t]`` tiles of a 2-D job assembled."""
    rows = {}
    for r in results:
        i, j = r[key]["coord"]
        rows.setdefault(i, {})[j] = r[key]["ys"]
    return np.concatenate(
        [np.concatenate([rows[i][j] for j in sorted(rows[i])], axis=-1)
         for i in sorted(rows)], axis=-2)


YEARS = {
    "all58": dict(n_batches=3, days=2, tickers=32, seed=0),
    "pad": dict(n_batches=2, days=2, tickers=30, seed=3),
    "side": dict(n_batches=2, days=2, tickers=30, seed=23),
    "all58_2d": dict(n_batches=3, days=4, tickers=32, seed=0),
    "handoff": dict(n_batches=2, days=4, tickers=32, seed=21),
    "piped": dict(n_batches=2, days=2, tickers=32, seed=5),
    "pads_2d": dict(n_batches=2, days=3, tickers=29, seed=3),
}


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """Every sharded job of this module on one spawned group of four
    ranks; returns ``(results, inputs)``."""
    names = factor_names()
    jobs, inputs = [], {}
    for key, n_shards in (("all58", WORLD), ("pad", WORLD)):
        year = _make_year(**YEARS[key])
        stacks, spec, kind, t_pad = tc.encode_year_sharded(year, True,
                                                           n_shards)
        inputs[key] = (year, stacks, spec, kind, t_pad)
        jobs.append((key, "resident_1d", dict(
            stacks=stacks, spec=spec, kind=kind,
            names=names if key == "all58" else SOME)))
    year = _make_year(**YEARS["side"])
    stacks, spec, kind, t_pad = tc.encode_year_sharded(year, True, WORLD)
    rspec = rw.ResultWireSpec.for_names(SOME, days=2, spill_rows=64)
    inputs["side"] = (year, stacks, spec, kind, t_pad, rspec)
    jobs.append(("side", "resident_1d", dict(
        stacks=stacks, spec=spec, kind=kind, names=SOME, result_spec=rspec,
        factor_stats=year[0][0].shape[1])))
    for key, group, nm in (("all58_2d", 3, names), ("handoff", 2, SOME),
                           ("piped_one", 2, SOME[:1]),
                           ("piped_two", 1, SOME[:1]),
                           ("pads_2d", 2, SOME)):
        year = _make_year(**YEARS[key.split("_")[0] if key.startswith(
            "piped") else key])
        stacks, spec, kind, t_pad, d_pad = tc.encode_year_2d(
            year, True, *MESH_2D)
        inputs[key] = (year, stacks, spec, kind, t_pad, d_pad)
        jobs.append((key, "resident_2d", dict(
            stacks=stacks, spec=spec, kind=kind, names=nm, shape=MESH_2D,
            group=group, t_pad=t_pad)))
    year = _make_year(**YEARS["pads_2d"])
    stacks, spec, kind, t_pad, d_pad = tc.encode_year_2d(year, True,
                                                         *MESH_2D)
    jobs.append(("side_2d", "resident_2d", dict(
        stacks=stacks, spec=spec, kind=kind, names=SOME, shape=MESH_2D,
        group=2, t_pad=t_pad, factor_stats=(3, 29),
        result_spec=rw.ResultWireSpec.for_names(SOME, days=d_pad,
                                                spill_rows=64))))
    year = _make_year(n_batches=2, days=2, tickers=16, seed=9)
    s1, sp1, k1, t_pad = tc.encode_year_sharded(year, True, WORLD)
    s2, sp2, k2, _, _ = tc.encode_year_2d(year, True, *MESH_2D)
    assert k1 == k2 == "wire"
    jobs.append(("donation", "donation", dict(
        stacks_1d=s1, spec_1d=sp1, stacks_2d=s2, spec_2d=sp2, kind=k1,
        names=SOME[:1], t_pad=t_pad)))
    results = tc.run_on_ranks(jobs, WORLD,
                              workdir=tmp_path_factory.mktemp("ranks"))
    return results, inputs


def test_sharded_resident_matches_jax_sharded_all_58(ranks):
    """THE parity gate: all 58 factors, the port's (1, 4) loop against the
    JAX package's sharded scan on its 8 virtual devices."""
    results, inputs = ranks
    year, _, _, _, t_pad = inputs["all58"]
    names = factor_names()
    assert len(names) == 58 and len(jax.devices()) == 8
    got = _tickers(results, "all58")
    stacks, spec, kind, jt = bench.encode_year_sharded(year, True, 8)
    assert kind == "wire" and jt == t_pad == 32
    mesh = resident_mesh(8)
    want = np.asarray(jax_pipeline.compute_packed_resident_sharded(
        put_packed_year(np.stack(stacks), mesh), spec, kind, mesh, names,
        rolling_impl="conv"))
    assert got.shape == want.shape == (3, 58, 2, 32)
    _hold_to_jax("sharded", names, got, want)
    assert {r["all58"]["backend"] for r in results} == {"gloo"}


def test_sharded_resident_matches_single_device_all_58(ranks):
    """Within the port the sharded loop is the single-device loop bit for
    bit, every factor (the JAX package's ulp pair included)."""
    results, inputs = ranks
    names = factor_names()
    want = _single(inputs["all58"][0], names).numpy()
    got = _tickers(results, "all58")
    for j, n in enumerate(names):
        np.testing.assert_array_equal(_bits(got[:, j]), _bits(want[:, j]),
                                      err_msg=f"{n} diverged sharded")


def test_sharded_resident_pads_nondividing_tickers(ranks):
    """30 tickers over 4 ranks: the year pads with masked lanes to 32 and
    the first 30 lanes equal the single-device run on the unpadded
    batches."""
    results, inputs = ranks
    year, _, _, _, t_pad = inputs["pad"]
    assert t_pad == 32
    got = _tickers(results, "pad")
    want = _single(year, SOME).numpy()
    assert got.shape[-1] == 32 and want.shape[-1] == 30
    np.testing.assert_array_equal(_bits(got[..., :30]), _bits(want))


def test_sharded_side_outputs_are_the_global_ones(ranks):
    """Result wire and stats on the sharded loop: each rank's payload is
    the single-device payload's arrays restricted to its tickers byte
    for byte; the stats over the 30 logical tickers are the same on
    every rank, counts/min/max bitwise the single-device sketch and the
    moments within 32 eps of its scale."""
    results, inputs = ranks
    year, stacks, spec, kind, t_pad, rspec = inputs["side"]
    # the single-device loop on the same year padded to 32 tickers
    padded, _, _ = tc._pad_year(year, 1, WORLD)
    single_raw = _single(padded, SOME)
    L = None
    for r in results:
        j = r["side"]["coord"][1]
        pay, stats = r["side"]["ys"], r["side"]["stats"]
        for n in range(len(stacks)):
            want = rw.encode_block(single_raw[n], rspec).numpy()
            arrs = _unpack_payload(want, len(SOME), 2, 32, rspec)
            sl = slice(j * 8, (j + 1) * 8)
            mine = wire.pack_arrays((arrs[0][..., sl], arrs[1], arrs[2],
                                     arrs[3], arrs[4][:, sl]))[0]
            np.testing.assert_array_equal(pay[n], mine)
            L = pay.shape[1]
            ref = factorplane.factor_stats_block(
                single_raw[n][..., :30]).numpy()
            np.testing.assert_array_equal(stats[n][:, :5], ref[:, :5])
            np.testing.assert_array_equal(stats[n][:, 7:], ref[:, 7:])
            scale = np.maximum(np.abs(ref[:, 5:7]), 1e-6)
            assert (np.abs(stats[n][:, 5:7] - ref[:, 5:7])
                    <= 32 * EPS * scale).all()
    assert L is not None
    others = [r["side"]["stats"] for r in results]
    for o in others[1:]:
        np.testing.assert_array_equal(_bits(o), _bits(others[0]))


def _unpack_payload(buf, f, d, t, rspec):
    """The five arrays of a result-wire payload (host)."""
    return [np.frombuffer(buf[off:].tobytes(), np.dtype(dt),
                          count=int(np.prod(shape))).reshape(shape)
            for dt, shape, off in rw.payload_spec(f, d, t,
                                                  rspec.spill_rows)]


def test_resident_2d_matches_single_device_all_58(ranks):
    """All 58 factors, the (2, 2) loop's tiles assembled against the
    single-device loop, bit for bit."""
    results, inputs = ranks
    names = factor_names()
    got = _tiles(results, "all58_2d")
    want = _single(inputs["all58_2d"][0], names).numpy()
    assert got.shape == want.shape == (3, 58, 4, 32)
    for j, n in enumerate(names):
        np.testing.assert_array_equal(_bits(got[:, j]), _bits(want[:, j]),
                                      err_msg=f"{n} diverged on (2, 2)")


def test_cross_day_carry_handoff_at_shard_boundary(ranks):
    """4-day batches on (2, 2): days 0-1 and 2-3 of every batch sit on
    different day-shards. The factors stay bitwise and the year-end
    carry handed off over the days axis equals the JAX package's
    single-device span fold over the same decoded days, on every rank."""
    results, inputs = ranks
    year = inputs["handoff"][0]
    got = _tiles(results, "handoff")
    np.testing.assert_array_equal(_bits(got), _bits(_single(year, SOME)))
    bufs, spec, kind = tc.encode_year(year)
    assert kind == "wire"
    state = {**jcarry.init_span_state(32),
             "day": np.full(32, -1, np.int32)}
    dec = jax.jit(lambda b: jwire.decode(*jwire.unpack(b, spec)))
    fold = jax.jit(lambda s, b, n: jcarry.combine_span_state(
        s, jcarry.span_prefix_state(*dec(b), day_base=n * 4)))
    for n, b in enumerate(bufs):
        state = fold(state, b, np.int32(n))
    ref = jax.device_get(state)
    for r in results:
        j = r["handoff"]["coord"][1]
        c = r["handoff"]["carry"]
        sl = slice(j * 16, (j + 1) * 16)
        np.testing.assert_array_equal(c["n_bars"], ref["n_bars"][sl])
        np.testing.assert_array_equal(c["has"], ref["has"][sl])
        np.testing.assert_array_equal(_bits(c["last_close"]),
                                      _bits(ref["last_close"][sl]))
        assert c["n_bars"].max() <= 240


def test_carry_threads_across_pipelined_groups(ranks):
    """Two calls of one batch each, the carry threaded on the device, end
    in the same year-end carry as one call over both batches."""
    results, _ = ranks
    for r in results:
        one, two = r["piped_one"]["carry"], r["piped_two"]["carry"]
        for k in ("last_close", "n_bars", "has"):
            np.testing.assert_array_equal(
                np.asarray(one[k]).view(np.uint8),
                np.asarray(two[k]).view(np.uint8), err_msg=k)
        assert r["piped_one"]["handoffs"] == 1
        assert r["piped_two"]["handoffs"] == 2


def test_resident_2d_pads_both_axes(ranks):
    """3-day x 29-ticker batches on (2, 2): days pad to 4 with fully
    masked filler days, tickers to 30 with masked lanes; the logical
    block equals the single-device run on the unpadded batches, and the
    stats over the logical extents are the 1-D loop's."""
    results, inputs = ranks
    year, _, _, _, t_pad, d_pad = inputs["pads_2d"]
    assert (t_pad, d_pad) == (30, 4)
    got = _tiles(results, "pads_2d")
    want = _single(year, SOME).numpy()
    np.testing.assert_array_equal(_bits(got[..., :3, :29]), _bits(want))
    side = [r["side_2d"] for r in results]
    # the payload: the 1-D loop's for the rank's ticker block, the same on
    # both day-shards (the day rows are gathered first)
    padded, _, _ = tc._pad_year(year, 2, 2)
    raw = _single(padded, SOME)
    rspec = rw.ResultWireSpec.for_names(SOME, days=4, spill_rows=64)
    for s in side:
        j = s["coord"][1]
        for n in range(raw.shape[0]):
            arrs = _unpack_payload(rw.encode_block(raw[n], rspec).numpy(),
                                   len(SOME), 4, 30, rspec)
            sl = slice(j * 15, (j + 1) * 15)
            np.testing.assert_array_equal(s["ys"][n], wire.pack_arrays(
                (arrs[0][..., sl], *arrs[1:4], arrs[4][:, sl]))[0])
    ref = pl.compute_packed_resident(
        [torch.from_numpy(b).clone() for b in tc.encode_year(year)[0]],
        tc.encode_year(year)[1], "wire", SOME, factor_stats=True,
        device="cpu")[1].numpy()
    for s in side:
        np.testing.assert_array_equal(s["stats"][..., :5], ref[..., :5])
        np.testing.assert_array_equal(s["stats"][..., 7:], ref[..., 7:])
        scale = np.maximum(np.abs(ref[..., 5:7]), 1e-6)
        assert (np.abs(s["stats"][..., 5:7] - ref[..., 5:7])
                <= 32 * EPS * scale).all()


def test_resident_2d_handoff_count_and_mesh_block(ranks):
    """Every call counts one carry-handoff dispatch, as the JAX package
    counts it, and the loop publishes the mesh block: four ranks, per
    axis."""
    results, _ = ranks
    for r in results:
        assert r["handoff"]["handoffs"] == 1  # one call, group = year
        s = r["handoff"]["mesh"]
        assert s["available"] and s["n_shards"] == WORLD
        assert set(s["axes"]) == {"days", "tickers"}
        assert s["boundaries"]["resident.group2d"] == 1


def test_donation_contract_on_each_sharded_path(ranks):
    """Donation forced on: after each loop every handle is dead, any use
    raises DonatedBufferError, debug_validate names the contract at the
    next entry, and the 2-D loop's carry is not donated."""
    results, _ = ranks
    for r in results:
        for label in ("1d", "2d"):
            d = r["donation"][label]
            assert d["dead"], label
            assert "donated" in d["use"], d
            assert "argument 0 is a dead buffer" in d["guard"], d
            assert d["carry_usable"], label


@pytest.mark.parametrize("use_wire", [True, False])
def test_encode_year_sharded_and_2d_are_bench_bytes(use_wire):
    """``torch_cases.encode_year_sharded``/``encode_year_2d`` are
    ``bench.py``'s byte for byte (specs, kinds, paddings)."""
    year = _make_year(n_batches=3, days=3, tickers=30, seed=4)
    got = tc.encode_year_sharded(year, use_wire, 4, bucket=8)
    want = bench.encode_year_sharded(year, use_wire, 4, bucket=8)
    assert got[1:] == want[1:]
    for a, b in zip(got[0], want[0]):
        np.testing.assert_array_equal(a, b)
    got = tc.encode_year_2d(year, use_wire, 2, 4)
    want = bench.encode_year_2d(year, use_wire, 2, 4)
    assert got[1:] == want[1:]
    for a, b in zip(got[0], want[0]):
        np.testing.assert_array_equal(a, b)


def test_span_state_is_the_jax_fold_bitwise():
    """``span_prefix_state`` and ``combine_span_state`` against the JAX
    package's on the same bars, a day with no bar included."""
    b, m = tc.make_batch(np.random.default_rng(12), 3, 16)
    m[2, :5] = False
    m[:, 7] = False
    for base in (0, 6):
        got = tcarry.span_prefix_state(torch.from_numpy(b),
                                       torch.from_numpy(m), base)
        want = jax.device_get(jcarry.span_prefix_state(b, m, base))
        for k in want:
            np.testing.assert_array_equal(
                np.asarray(got[k].numpy()).view(np.uint8),
                np.asarray(want[k]).view(np.uint8), err_msg=k)
    a = tcarry.span_prefix_state(torch.from_numpy(b[:2]),
                                 torch.from_numpy(m[:2]), 0)
    c = tcarry.span_prefix_state(torch.from_numpy(b[2:]),
                                 torch.from_numpy(m[2:]), 2)
    whole = tcarry.span_prefix_state(torch.from_numpy(b),
                                     torch.from_numpy(m), 0)
    for x, y in ((a, c), (c, a)):
        got = tcarry.combine_span_state(x, y)
        for k in got:
            assert torch.equal(got[k].view(torch.uint8) if got[k].dtype
                               != torch.bool else got[k],
                               whole[k].view(torch.uint8) if whole[k].dtype
                               != torch.bool else whole[k]), k
    init = tcarry.init_span_state(16)
    jinit = jcarry.init_span_state(16)
    for k in jinit:
        np.testing.assert_array_equal(init[k].view(np.uint8),
                                      jinit[k].view(np.uint8))
