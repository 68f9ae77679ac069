"""The port's multi-rank layer on the CPU: ``parallel/`` (mesh, layouts,
collectives, multihost, launch), the wire's shard packers,
``DayContext(xs_axis_name=)``, ``sharded_compute_factors`` and
``compute_exposures(cfg.mesh_shape=(1, n))``.

The group jobs run on four gloo ranks spawned once for the module
(``torch_cases.run_on_ranks``); JAX runs in this process on its 8
virtual CPU devices. Bars: ``xs_global_rank_local``, ``xs_rank`` and
``xs_qcut`` bitwise the unsharded op; the moment collectives at
tests/test_parallel.py's tolerances; the shard packers' bytes, masks and
counts bitwise JAX's; the sharded factors bitwise the port's
single-device run and within tests/test_parity.py's comparator of the
JAX package's sharded run; the sharded driver's cache equal to the
single-device cache.
"""

import json
import os

import numpy as np
import pytest
import torch

from replication_of_minute_frequency_factor_tpu import ops as jops
from replication_of_minute_frequency_factor_tpu.data import wire as jwire
from replication_of_minute_frequency_factor_tpu.parallel import (
    make_mesh as jax_make_mesh, shard_day_batch as jax_shard_day_batch,
    sharded_compute_factors as jax_sharded_compute_factors)
from replication_of_minute_frequency_factor_tpu.parallel import (
    mesh as jmesh)
from replication_of_minute_frequency_factor_tpu_torch import (
    compute_batch, eval_ops)
from replication_of_minute_frequency_factor_tpu_torch import pipeline as pl
from replication_of_minute_frequency_factor_tpu_torch.config import Config
from replication_of_minute_frequency_factor_tpu_torch.data import wire
from replication_of_minute_frequency_factor_tpu_torch.models import (
    DayContext, factor_names)
from replication_of_minute_frequency_factor_tpu_torch.ops import (
    masked_corr, masked_mean, masked_std, rank_average)
from replication_of_minute_frequency_factor_tpu_torch.parallel import (
    collectives as xc, launch, mesh as tmesh, multihost)
from replication_of_minute_frequency_factor_tpu_torch.stream.carry import (
    combine_span_state)
from test_torch_resident import _hold_to_jax
import torch_cases as tc

WORLD = 4
EPS = float(np.finfo(np.float32).eps)


def _xs_data():
    """tests/test_parallel.py's cross-section (6 dates x 40 tickers):
    an all-masked-but-two date and exact ties across shard boundaries."""
    rng = np.random.default_rng(7)
    dates, tickers = 6, 40
    x = rng.normal(size=(dates, tickers)).astype(np.float32)
    y = rng.normal(size=(dates, tickers)).astype(np.float32)
    m = rng.random((dates, tickers)) > 0.2
    m[3] = False
    m[3, :2] = True
    x[1, ::5] = 0.25
    return x, y, m


def _population():
    rng = np.random.default_rng(11)
    stats = rng.normal(size=(24, 4)).astype(np.float32)
    stats[3, 0] = np.nan
    stats[20:, 0] = 9.0  # padding rows past n_pop must never win
    return stats


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    x, y, m = _xs_data()
    bars, mask = tc.make_batch(np.random.default_rng(3), 2, 12)
    fbars, fmask = tc.make_batch(np.random.default_rng(4), 3, 9)
    jobs = [("xs", "xs", dict(x=x, y=y, m=m, stats=_population(),
                              n_pop=20, k=5)),
            ("factors", "factors", dict(bars=bars, mask=mask,
                                        shape=(2, 2))),
            ("pad", "factors", dict(bars=fbars, mask=fmask, shape=(2, 2),
                                    names=("doc_pdf60", "vol_return1min"))),
            ("multihost", "multihost", dict(bars=bars, mask=mask)),
            ("handoff4", "handoff", dict(shape=(4, 1))),
            ("handoff2", "handoff", dict(shape=(2, 2))),
            ("meshplane", "meshplane", {})]
    # last: it leaves rank 1's packed step wrapped (raising only once)
    kline = tmp_path_factory.mktemp("kline")
    _write_days(str(kline), np.random.default_rng(2))
    jobs.append(("exposures", "exposures_in_group",
                 dict(minute_dir=str(kline), names=NAMES, fail_rank=1,
                      cache_path=str(kline / "mesh.parquet"))))
    results = tc.run_on_ranks(jobs, WORLD,
                              workdir=tmp_path_factory.mktemp("ranks"))
    return results, dict(xs=(x, y, m), factors=(bars, mask),
                         pad=(fbars, fmask), kline=kline)


def _cat(results, key, field, axis=-1):
    parts = sorted((r[key]["coord"][1], r[key][field]) for r in results)
    return np.concatenate([p for _, p in parts], axis=axis)


def test_xs_moment_collectives_match_local(ranks):
    results, data = ranks
    x, y, m = (torch.from_numpy(a) for a in data["xs"])
    for r in results:
        np.testing.assert_allclose(r["xs"]["mean"], masked_mean(x, m),
                                   rtol=1e-5)
        np.testing.assert_allclose(r["xs"]["std"], masked_std(x, m),
                                   rtol=1e-5)
        np.testing.assert_allclose(r["xs"]["ic"], masked_corr(x, y, m),
                                   rtol=1e-5, atol=1e-6)
        # one dispatch counted per wrapper call (mean, std, ic, rank, 3 qcut)
        assert r["xs"]["dispatches"] == 7


def test_xs_moment_collectives_match_jax_sharded(ranks):
    """The same cross-section through the JAX package's sharded
    collectives on its (1, 8) mesh."""
    from replication_of_minute_frequency_factor_tpu.parallel import (
        xs_masked_mean, xs_masked_std, xs_pearson)

    results, data = ranks
    x, y, m = data["xs"]
    mesh = jax_make_mesh((1, 8))
    got = results[0]["xs"]
    np.testing.assert_allclose(got["mean"],
                               np.asarray(xs_masked_mean(mesh, x, m)),
                               rtol=1e-5)
    np.testing.assert_allclose(got["std"],
                               np.asarray(xs_masked_std(mesh, x, m)),
                               rtol=1e-5)
    np.testing.assert_allclose(got["ic"],
                               np.asarray(xs_pearson(mesh, x, y, m)),
                               rtol=1e-5, atol=1e-6)


def test_xs_rank_qcut_and_global_rank_are_the_unsharded_ops(ranks):
    """The gathered order statistics are bitwise the single-device ops
    (and the rank and labels bitwise the JAX package's)."""
    results, data = ranks
    x, _, m = data["xs"]
    tx, tm_ = torch.from_numpy(x), torch.from_numpy(m)
    rank = _cat(results, "xs", "rank")
    want = rank_average(tx, tm_).numpy()
    np.testing.assert_array_equal(rank.view(np.int32), want.view(np.int32))
    np.testing.assert_array_equal(
        np.nan_to_num(rank, nan=-1),
        np.nan_to_num(np.asarray(jops.rank_average(x, m)), nan=-1))
    for g in (3, 5, 10):
        parts = sorted((r["xs"]["coord"][1], r["xs"]["qcut"][g])
                       for r in results)
        lab = np.concatenate([p for _, p in parts], axis=-1)
        np.testing.assert_array_equal(
            lab, eval_ops._qcut_labels(tx, tm_, g).numpy())
    grank = _cat(results, "xs", "grank")
    # each rank's flattened block: its tickers of every date, so the
    # gathered frame is [rank0 block | rank1 block | ...]
    blocks = np.concatenate([np.asarray(x[:, j * 10:(j + 1) * 10]).reshape(
        -1) for j in range(WORLD)])[None]
    mblocks = np.concatenate([np.asarray(m[:, j * 10:(j + 1) * 10]).reshape(
        -1) for j in range(WORLD)])[None]
    want = rank_average(torch.from_numpy(blocks),
                        torch.from_numpy(mblocks)).numpy()
    np.testing.assert_array_equal(grank.view(np.int32), want.view(np.int32))


def test_population_topk_is_replicated_and_masks_padding(ranks):
    results, _ = ranks
    stats = _population()
    fit = np.nan_to_num(stats[:, 0], nan=-1.0)
    fit[20:] = -np.inf
    want_idx = np.argsort(-fit, kind="stable")[:5]
    for r in results:
        full, vals, idx = r["xs"]["topk"]
        np.testing.assert_array_equal(full, stats)
        assert sorted(idx.tolist()) == sorted(want_idx.tolist())
        np.testing.assert_array_equal(np.sort(vals), np.sort(fit[want_idx]))


def test_sharded_factors_match_single_device_and_jax(ranks):
    """``shard_day_batch`` + ``sharded_compute_factors`` on (2, 2): the
    assembled blocks are the port's single-device run bit for bit, and
    within test_parity's comparator of the JAX package's sharded run on
    its (2, 4) mesh; ``DayContext(xs_axis_name=)``'s rank is the
    single-device whole-frame rank."""
    results, data = ranks
    bars, mask = data["factors"]
    names = factor_names()
    single = compute_batch(bars, mask, device="cpu").numpy()
    got = np.zeros_like(single)
    for r in results:
        i, j = r["factors"]["coord"]
        for f, n in enumerate(names):
            blk = r["factors"]["factors"][n]
            got[f, i:i + 1, j * 6:(j + 1) * 6] = blk
        assert r["factors"]["n_tickers"] == 12
    np.testing.assert_array_equal(got.view(np.int32),
                                  single.view(np.int32))
    mesh = jax_make_mesh((2, 4))
    bs, ms, n = jax_shard_day_batch(bars, mask, mesh)
    ref = jax_sharded_compute_factors(bs, ms, mesh)
    ref = np.stack([np.asarray(ref[nm])[:, :n] for nm in names])
    _hold_to_jax("sharded-factors", names, got[None], ref[None])
    ctx = DayContext(torch.from_numpy(bars), torch.from_numpy(mask))
    whole = ctx.eod_ret_global_rank.numpy()
    for r in results:
        i, j = r["factors"]["coord"]
        np.testing.assert_array_equal(
            r["factors"]["grank"].view(np.int32),
            whole[i:i + 1, j * 6:(j + 1) * 6].view(np.int32))


def test_shard_day_batch_pads_both_axes_and_masks(ranks):
    """3 days x 9 tickers on (2, 2): days pad to 4, tickers to 10 with
    masked lanes; the logical block is the single-device run and the
    ticker pad lands in the pad-waste gauge."""
    results, data = ranks
    bars, mask = data["pad"]
    names = ("doc_pdf60", "vol_return1min")
    single = compute_batch(bars, mask, names=names, device="cpu").numpy()
    got = np.zeros((2, 4, 10), np.float32)
    for r in results:
        i, j = r["pad"]["coord"]
        for f, n in enumerate(names):
            got[f, 2 * i:2 * i + 2, 5 * j:5 * j + 5] = \
                r["pad"]["factors"][n]
        assert r["pad"]["pad_waste"]["tickers"] == pytest.approx(
            1 - 9 / 10)
    np.testing.assert_array_equal(got[:, :3, :9].view(np.int32),
                                  single.view(np.int32))


def test_multihost_inside_a_group(ranks):
    """In a group of four: process index and count, the (1, 4) global
    mesh, and each process's own tickers block on its device."""
    results, data = ranks
    bars, mask = data["factors"]
    for rank, r in enumerate(results):
        mh = r["multihost"]
        assert (mh["index"], mh["count"]) == (rank, WORLD)
        assert mh["shape"] == {"days": 1, "tickers": WORLD}
        assert mh["coord"] == (0, rank)
        sl = slice(rank * 3, (rank + 1) * 3)
        np.testing.assert_array_equal(mh["bars"], bars[:, sl])
        np.testing.assert_array_equal(mh["mask"], mask[:, sl])
        assert mh["built"] == 1


def test_carry_handoff_folds_the_days_axis(ranks):
    """``xs_carry_handoff_local`` on a 4-rank and a 2-rank days axis: every
    rank of an axis ends with the fold of the axis's states (newest day
    wins per lane, a lane no rank saw stays empty)."""
    results, _ = ranks
    for key, d in (("handoff4", 4), ("handoff2", 2)):
        states = []
        for i in range(d):
            has = torch.tensor([True, i % 2 == 0, False, i == 0])
            states.append({
                "last_close": torch.tensor([1.0, 2.0, 3.0, 4.0]) * (i + 1),
                "n_bars": torch.tensor([10, 20, 30, 40],
                                       dtype=torch.int32) + i,
                "has": has,
                "day": torch.where(has, i, -1).to(torch.int32)})
        want = states[0]
        for s in states[1:]:
            want = combine_span_state(want, s)
        for r in results:
            got = r[key]["state"]
            for k in want:
                np.testing.assert_array_equal(got[k], want[k].numpy(),
                                              err_msg=f"{key}/{k}")


def test_mesh_watermarks_are_gathered_on_every_rank(ranks):
    """``measure_ready_mesh`` publishes the flat per-rank sample and the
    per-axis views of a (2, 2) mesh; ``note_collective`` counts."""
    results, _ = ranks
    for r in results:
        s = r["meshplane"]["summary"]
        assert s["available"] and s["n_shards"] == WORLD
        assert set(s["axes"]) == {"days", "tickers"}
        assert set(s["axes"]["days"]["shard_time_s"]) == {"day0", "day1"}
        assert s["collective_dispatches"] == 1
        assert r["meshplane"]["sample"]["boundary"] == "test"


@pytest.mark.parametrize("mode", ["wire", "raw"])
def test_wire_shard_packers_are_the_jax_bytes(mode):
    """``shard_arrays``/``pack_sharded``/``shard_arrays_2d``/
    ``pack_sharded_2d`` byte for byte the JAX package's, on the wire's
    arrays and on the raw fallback's; a non-dividing extent raises."""
    bars, mask = tc.make_batch(np.random.default_rng(2), 4, 24)
    arrays = (wire.encode(bars, mask).arrays if mode == "wire"
              else (bars, mask.view(np.uint8)))
    for n in (1, 2, 3, 4, 8):
        got, gspec = wire.pack_sharded(arrays, n)
        want, wspec = jwire.pack_sharded(arrays, n)
        np.testing.assert_array_equal(got, want)
        assert gspec == wspec
        for a, b in zip(wire.shard_arrays(arrays, n),
                        jwire.shard_arrays(arrays, n)):
            for u, v in zip(a, b):
                np.testing.assert_array_equal(u, v)
    for d, t in ((1, 4), (2, 3), (4, 2), (2, 8)):
        got, gspec = wire.pack_sharded_2d(arrays, d, t)
        want, wspec = jwire.pack_sharded_2d(arrays, d, t)
        np.testing.assert_array_equal(got, want)
        assert gspec == wspec
    with pytest.raises(ValueError, match="pad the batch"):
        wire.pack_sharded(arrays, 5)
    with pytest.raises(ValueError, match="pad the batch"):
        wire.pack_sharded_2d(arrays, 3, 4)


def test_layouts_name_the_jax_partition_specs():
    """Each layout description names, per array axis, what the JAX
    package's PartitionSpec names; the wire's per-array layouts are its
    mesh shardings' specs."""
    for name in ("packed_year_spec", "scan_output_spec",
                 "packed_year_2d_spec", "scan_output_2d_spec",
                 "span_carry_spec"):
        assert getattr(tmesh, name)() == tuple(getattr(jmesh, name)()), name
    for batched in (True, False):
        assert tmesh.day_batch_spec(batched) == tuple(
            jmesh.day_batch_spec(batched))
        assert tmesh.mask_spec(batched) == tuple(jmesh.mask_spec(batched))
    jsh = jwire.mesh_shardings(jax_make_mesh((1, 8)))
    assert wire.mesh_specs() == tuple(tuple(s.spec) for s in jsh)
    assert (tmesh.DAYS_AXIS, tmesh.TICKERS_AXIS) == (jmesh.DAYS_AXIS,
                                                     jmesh.TICKERS_AXIS)


def test_one_rank_mesh_runs_without_a_process_group():
    """With no group, ``make_mesh`` gives the one-rank mesh (its
    collectives are the identity) and refuses any wider shape; a named
    axis outside ``with mesh:`` raises; ``wire.put`` and
    ``shard_day_batch`` hand the whole batch to the one rank."""
    mesh = tmesh.make_mesh(None, "cpu")
    assert mesh.shape == {"days": 1, "tickers": 1} and mesh.size == 1
    assert mesh.group("tickers") is None and mesh.backend is None
    with pytest.raises(ValueError, match="does not match 1 ranks"):
        tmesh.make_mesh((1, 2), "cpu")
    x, _, m = _xs_data()
    tx, tm_ = torch.from_numpy(x), torch.from_numpy(m)
    assert torch.equal(xc.xs_rank(mesh, tx, tm_).nan_to_num(-1),
                       rank_average(tx, tm_).nan_to_num(-1))
    with pytest.raises(RuntimeError, match="active mesh"):
        xc.xs_rank_local(tx, tm_)
    bars, mask = tc.make_batch(np.random.default_rng(1), 2, 8)
    b, msk, n = tmesh.shard_day_batch(bars, mask, mesh)
    assert n == 8 and torch.equal(b, torch.from_numpy(bars))
    enc = wire.encode(bars, mask)
    for a, t in zip(enc.arrays, wire.put(enc.arrays, mesh)):
        np.testing.assert_array_equal(np.asarray(a), t.numpy())
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            tmesh.make_mesh(None)


def test_initialize_is_a_no_op_without_a_coordinator(monkeypatch):
    """No coordinator named and none in the environment: a single-process
    run, no group (as the JAX package's ``initialize``); the transport
    choice is explicit."""
    for k in ("MASTER_ADDR", "MASTER_PORT", "RANK", "WORLD_SIZE"):
        monkeypatch.delenv(k, raising=False)
    multihost.initialize()
    assert not torch.distributed.is_initialized()
    assert (multihost.process_index(), multihost.process_count()) == (0, 1)
    assert multihost.choose_backend("cpu", 4) == "gloo"
    if not torch.cuda.is_available():
        assert multihost.choose_backend("cuda", 1) == "gloo"


def _raises(rank):
    if rank == 1:
        raise ValueError("rank one refuses")
    return rank


def _sleeps(rank):
    import time
    time.sleep(60)


def test_run_ranks_reports_a_failing_rank_and_a_hung_group(tmp_path):
    """A rank that raises ends the group and its traceback is raised
    here; a group past its clock is ended and raises TimeoutError."""
    with pytest.raises(RuntimeError, match="rank one refuses"):
        launch.run_ranks(_raises, 2, device="cpu", workdir=str(tmp_path))
    with pytest.raises(TimeoutError, match="still running"):
        launch.run_ranks(_sleeps, 2, device="cpu", timeout_s=6,
                         workdir=str(tmp_path))


NAMES = ("vol_return1min", "mmt_am", "liq_openvol", "doc_pdf80",
         "mmt_ols_qrs")


DAYS = ("2024-01-02", "2024-01-03", "2024-01-04")


def _write_days(d, rng, bad=None):
    """Three day files of six tickers; on day ``bad`` every bar's high
    is set below its low (a file that reads, but fails validation)."""
    import pyarrow as pa
    import pyarrow.parquet as pq
    from replication_of_minute_frequency_factor_tpu_torch.data.synthetic import (
        synth_day)

    for ds in DAYS:
        cols = synth_day(rng, n_codes=6, date=ds, missing_prob=0.05)
        if ds == bad:
            cols["high"] = cols["low"] * 0.5
        table = pa.table({"code": pa.array([str(c) for c in cols["code"]]),
                          "time": pa.array(cols["time"]),
                          **{k: pa.array(cols[k]) for k in
                             ("open", "high", "low", "close", "volume")}})
        pq.write_table(table, os.path.join(
            d, ds.replace("-", "") + "_cleaned.parquet"))


def _assert_same_cache(got, want):
    """Codes, dates and every factor bit for bit."""
    assert len(got) == len(want) > 0
    for k in ("code", "date"):
        np.testing.assert_array_equal(np.asarray(got.columns[k]),
                                      np.asarray(want.columns[k]))
    for n in NAMES:
        np.testing.assert_array_equal(got.columns[n].view(np.int32),
                                      want.columns[n].view(np.int32))


def test_compute_exposures_sharded_matches_single(tmp_path):
    """``cfg.mesh_shape=(1, 2)`` spawns two ranks; the cache they write
    equals the single-device cache bit for bit (codes, dates, every
    factor), and the returned table is that cache."""
    kline = tmp_path / "kline"
    kline.mkdir()
    _write_days(str(kline), np.random.default_rng(0))
    single = pl.compute_exposures(str(kline), NAMES,
                                  cache_path=str(tmp_path / "one.parquet"),
                                  cfg=Config(days_per_batch=2),
                                  progress=False, device="cpu")
    sharded = pl.compute_exposures(
        str(kline), NAMES, cache_path=str(tmp_path / "two.parquet"),
        cfg=Config(days_per_batch=2, mesh_shape=(1, 2)), progress=False,
        device="cpu")
    cache = pl.ExposureTable.load(str(tmp_path / "two.parquet"))
    want = pl.ExposureTable.load(str(tmp_path / "one.parquet"))
    assert len(want) == len(single)
    for got in (sharded, cache):
        _assert_same_cache(got, want)


def test_compute_exposures_sharded_isolates_a_bad_day(tmp_path):
    """A day file that fails validation, in a two-day batch: the mesh
    run isolates the batch per day as the single-device run does, so
    its healthy batch-mate is computed, the caches are equal bit for
    bit, and both failure ledgers hold the bad day alone."""
    kline = tmp_path / "kline"
    kline.mkdir()
    _write_days(str(kline), np.random.default_rng(1), bad=DAYS[1])
    runs = {}
    for tag, shape in (("one", None), ("two", (1, 2))):
        cache = str(tmp_path / f"{tag}.parquet")
        out = pl.compute_exposures(
            str(kline), NAMES, cache_path=cache,
            cfg=Config(days_per_batch=2, debug_validate=True,
                       mesh_shape=shape), progress=False, device="cpu")
        with open(cache + ".failures.json") as fh:
            ledger = sorted(rec["key"] for rec in json.load(fh))
        runs[tag] = (out, pl.ExposureTable.load(cache), ledger)
    (single, want, ledger1), (sharded, got, ledger2) = runs["one"], runs["two"]
    assert ledger1 == ledger2 == [DAYS[1]]
    assert sorted(single.failures.keys()) == sorted(
        sharded.failures.keys()) == [DAYS[1]]
    assert sorted({str(d) for d in want.columns["date"]}) == [DAYS[0],
                                                              DAYS[2]]
    for table in (sharded, got):
        _assert_same_cache(table, want)


def test_compute_exposures_in_a_group_retries_a_failed_rank(ranks):
    """Every rank of the four-rank group calls ``compute_exposures`` (as
    under torchrun) and rank 1's first step raises after its
    collectives: rank 0 learns it before the gather, retries the batch
    once, the ranks stay in step, and the cache is the single-device
    cache bit for bit."""
    results, inputs = ranks
    kline = inputs["kline"]
    want = pl.compute_exposures(str(kline), NAMES,
                                cfg=Config(days_per_batch=2),
                                progress=False, device="cpu")
    assert all(r["exposures"] is None for r in results[1:])
    got = results[0]["exposures"]
    assert got["failures"] == [] and got["retries"] == 1
    _assert_same_cache(pl.ExposureTable(got["columns"]), want)
    _assert_same_cache(pl.ExposureTable.load(str(kline / "mesh.parquet")),
                       want)


def test_compute_exposures_in_a_group_isolates_a_rank_failing_before_its_gather(
        tmp_path):
    """Rank 2's compute raises before its ``doc_pdf*`` gather on the
    first two-day batch, on the retry and on that batch's first day
    alone. The ranks swap a status ahead of every collective of the
    step, so none is left in the gather: rank 0 retries the batch,
    isolates it by day as the single-device pipeline does, records the one
    day that fails alone and completes the run, and every other day is
    bitwise the fault-free cache. The group runs under its own time
    limit, so a rank left in a collective fails the test instead of
    stalling the suite."""
    kline = tmp_path / "kline"
    kline.mkdir()
    _write_days(str(kline), np.random.default_rng(2))
    results = tc.run_on_ranks(
        [("exposures", "exposures_in_group",
          dict(minute_dir=str(kline), names=NAMES, fail_rank=2,
               gather_faults=3, cache_path=str(kline / "mesh.parquet")))],
        WORLD, workdir=tmp_path, timeout_s=240)
    assert all(r["exposures"] is None for r in results[1:])
    got = results[0]["exposures"]
    assert got["failures"] == [DAYS[0]]
    assert got["retries"] == 1 and got["isolations"] == 1
    full = pl.compute_exposures(str(kline), NAMES,
                                cfg=Config(days_per_batch=2),
                                progress=False, device="cpu")
    keep = np.asarray(full.columns["date"]) != np.datetime64(DAYS[0])
    want = pl.ExposureTable({k: np.asarray(v)[keep]
                             for k, v in full.columns.items()})
    _assert_same_cache(pl.ExposureTable(got["columns"]), want)
    _assert_same_cache(pl.ExposureTable.load(str(kline / "mesh.parquet")),
                       want)


def test_mesh_shape_days_axis_rejected(tmp_path):
    with pytest.raises(ValueError, match="tickers axis only"):
        pl.compute_exposures(str(tmp_path), NAMES,
                             cfg=Config(days_per_batch=2,
                                        mesh_shape=(2, 2)),
                             progress=False, device="cpu")
    with pytest.raises(ValueError, match="spawns its ranks"):
        pl.compute_exposures(str(tmp_path), NAMES,
                             cfg=Config(days_per_batch=2,
                                        mesh_shape=(1, 2)),
                             progress=False, device="cpu",
                             fault_hook=print)
