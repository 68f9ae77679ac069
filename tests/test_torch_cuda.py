"""The port's hand-written kernels on the card (``cuda`` marker).

Every test here skips without a CUDA device: the kernels have no CPU mode.
Window 50 runs the tiled kernel, any other window the rowwise one; the
two give the same bits. The wire decode and the sort-based ops are plain
torch, held card against CPU bit for bit (the CPU path is the one the
other tests hold against the JAX package). The host driver's card path
(pinned buffers, the copy stream, the result fetch) is held against its
CPU run at tests/test_parity.py's tolerances, through ``chip_smoke.py``'s
comparator, and against an injected launch failure. The resident year
loop is enqueued without a host sync, donates its buffers and matches its
CPU run; a ``TraceCapture`` on the card sees device time and names the
tiled kernel.
The module imports neither jax nor the JAX package, so on a machine with
the card and without jax the tests run alone, past the jax set-up in
conftest.py:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py -q
"""

import importlib.util
from pathlib import Path

import numpy as np
import pytest
import torch

from replication_of_minute_frequency_factor_tpu_torch import (
    compute_batch, compute_packed, eval_ops, fuzz, pins)
from replication_of_minute_frequency_factor_tpu_torch import pipeline as pl
from replication_of_minute_frequency_factor_tpu_torch.config import Config
from replication_of_minute_frequency_factor_tpu_torch.models import (
    DayContext, factor_names)
from replication_of_minute_frequency_factor_tpu_torch.telemetry import (
    Telemetry)
from replication_of_minute_frequency_factor_tpu_torch.data import wire
from replication_of_minute_frequency_factor_tpu_torch.fuzz import comparator
from replication_of_minute_frequency_factor_tpu_torch.ops import (
    masked_order, rank_average)
from replication_of_minute_frequency_factor_tpu_torch.ops import rolling
from replication_of_minute_frequency_factor_tpu_torch.ops import rolling_cuda
from torch_cases import (
    WIRE_MODE_CASES, crafted_rows, eval_matrices, expected_wire_modes,
    qcut_cases, same_bits, wire_mode_case)

W = 50


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")


def _moment_inputs(rows, length, seed, window=W):
    g = torch.Generator(device="cuda").manual_seed(seed)
    close = 10 * torch.exp(torch.cumsum(
        torch.randn(rows, length, generator=g, device="cuda") * 1e-3, -1))
    mask = torch.rand(rows, length, generator=g, device="cuda") > 0.05
    args = rolling.second_moment_inputs(close * 0.999, close * 1.001, mask,
                                        window)
    return args, rolling._windowed_sum(mask, window) > window - 0.5


def _launched(before):
    return {k: n - before[k] for k, n in rolling_cuda.launches.items()}


@pytest.mark.cuda
@pytest.mark.parametrize("rows,length", [(8 * 5000, 240), (4001, 390),
                                         (4001, 150), (3, 1440), (5, 40)])
def test_kernel_matches_plain_on_the_card(rows, length):
    """The tiled kernel (window 50, through the wrapper) vs its plain
    version on valid lanes, and bit for bit vs the rowwise kernel on every
    lane (``python3 chip_smoke.py`` runs the same checks at the main
    path's shapes). At 40 slots no window is complete."""
    _card()
    args, valid = _moment_inputs(rows, length, rows + length)
    before = dict(rolling_cuda.launches)
    got = rolling_cuda.second_moments(*args, W)
    base = rolling_cuda._second_moments_rowwise(*args, W)
    torch.cuda.synchronize()
    assert _launched(before) == {"tiled": 1, "rowwise": 1}
    plain = rolling_cuda.second_moments_plain(*args, W)
    for a, b, c in zip(got, base, plain):
        assert same_bits(a, b)
        torch.testing.assert_close(a[valid], c[valid], rtol=1e-5, atol=1e-9)


@pytest.mark.cuda
@pytest.mark.parametrize("window,kernel", [(20, "rowwise"), (W, "tiled")])
def test_window_picks_the_kernel(window, kernel):
    _card()
    args, valid = _moment_inputs(64, 240, window, window)
    before = dict(rolling_cuda.launches)
    got = rolling_cuda.second_moments(*args, window)
    torch.cuda.synchronize()
    assert _launched(before) == {k: int(k == kernel)
                                 for k in rolling_cuda.launches}
    for a, b in zip(got, rolling_cuda.second_moments_plain(*args, window)):
        torch.testing.assert_close(a[valid], b[valid], rtol=1e-5, atol=1e-9)


@pytest.mark.cuda
def test_tiled_kernel_refuses_a_misaligned_view():
    """A view 4 bytes into its storage raises before any launch; the
    rowwise kernel, which reads single floats, takes it."""
    _card()
    args, _ = _moment_inputs(8, 240, 1)
    buf = torch.empty(8 * 240 + 1, device="cuda")
    view = buf[1:].view(8, 240)
    view.copy_(args[0])
    assert view.is_contiguous() and view.data_ptr() % 16
    before = dict(rolling_cuda.launches)
    with pytest.raises(ValueError, match="16-byte aligned"):
        rolling_cuda.second_moments(view, *args[1:], W)
    assert _launched(before) == {"tiled": 0, "rowwise": 0}
    got = rolling_cuda._second_moments_rowwise(view, *args[1:], W)
    for a, b in zip(got, rolling_cuda.second_moments(*args, W)):
        assert same_bits(a, b)


@pytest.mark.cuda
def test_wrapper_refuses_what_the_kernel_does_not_take():
    _card()
    args, _ = _moment_inputs(8, 240, 0)
    before = dict(rolling_cuda.launches)
    with pytest.raises(TypeError, match="float32"):
        rolling_cuda.second_moments(args[0].double(), *args[1:], W)
    with pytest.raises(ValueError, match="contiguous"):
        rolling_cuda.second_moments(
            *(a.t().contiguous().t() for a in args), W)
    with pytest.raises(ValueError, match="shape"):
        rolling_cuda.second_moments(args[0][:4], *args[1:], W)
    with pytest.raises(ValueError, match="one CUDA device"):
        rolling_cuda.second_moments(args[0].cpu(), *args[1:], W)
    assert rolling_cuda.launches == before


@pytest.mark.cuda
@pytest.mark.parametrize("n_slots", [240, 390, 1440])
@pytest.mark.parametrize("case", WIRE_MODE_CASES)
def test_wire_decode_card_equals_cpu(n_slots, case):
    """Every rung of every ladder (u16 volume and the mask's pad bits at
    390 slots included) decodes to the same bits on the card."""
    _card()
    bars, mask = wire_mode_case(n_slots + sum(case), n_slots, *case)
    enc = wire.encode(bars, mask)
    assert enc.modes == expected_wire_modes(n_slots, *case)
    buf, spec = wire.pack_arrays(enc.arrays)
    got = wire.decode(*wire.unpack(torch.from_numpy(buf).cuda(), spec))
    want = wire.decode(*wire.unpack(torch.from_numpy(buf), spec))
    assert got[0].is_cuda
    assert same_bits(got[0], want[0]) and same_bits(got[1], want[1])
    assert np.array_equal(want[1].numpy(), mask)


@pytest.mark.cuda
@pytest.mark.parametrize("lanes", [64, 2 * 240 * 500])
def test_rank_average_card_equals_cpu(lanes):
    """Crafted rows (signed zeros, +-inf, both NaN signs, an all-invalid
    row) and long tie-heavy frames rank and order alike on the card."""
    _card()
    x, mask = crafted_rows()
    if lanes != x.shape[-1]:
        rng = np.random.default_rng(lanes)
        x = (rng.integers(0, 4000, (2, lanes)) / 1000).astype(np.float32)
        mask = rng.random((2, lanes)) < 0.95
    xt, mt = torch.from_numpy(x), torch.from_numpy(mask)
    for fn in (rank_average, masked_order):
        assert same_bits(fn(xt.cuda(), mt.cuda()), fn(xt, mt))


@pytest.mark.cuda
@pytest.mark.parametrize("group_num", [3, 5, 10])
def test_qcut_labels_card_equals_cpu(group_num):
    """The quantile labels on the card are bitwise the CPU's (the CPU's
    are bitwise the JAX package's): the crafted cross-sections and a
    full-width tie-heavy year."""
    _card()
    x, _, valid = eval_matrices(group_num, 244, 5000)
    for xs, ms, nan_lanes in [(x, valid, ~valid), *qcut_cases().values()]:
        xt, mt, nt = (torch.from_numpy(a) for a in (xs, ms, nan_lanes))
        with pins.pinned(qcut_nan="top_bin"):
            got = eval_ops.qcut_labels(xt.cuda(), mt.cuda(), group_num,
                                       nan_lanes=nt.cuda())
            want = eval_ops.qcut_labels(xt, mt, group_num, nan_lanes=nt)
        assert same_bits(got, want)
        assert same_bits(eval_ops.coverage_counts(mt.cuda()),
                         eval_ops.coverage_counts(mt))


@pytest.mark.cuda
def test_ic_series_card_within_tolerance_of_cpu():
    _card()
    args = [torch.from_numpy(a) for a in eval_matrices(8, 244, 5000)]
    got = eval_ops.ic_series(*(a.cuda() for a in args))
    want = eval_ops.ic_series(*args)
    for g, w in zip(got, want):
        g = g.cpu()
        assert torch.equal(torch.isnan(g), torch.isnan(w))
        torch.testing.assert_close(g, w, rtol=2e-5, atol=4 * 2.0**-23,
                                   equal_nan=True)


@pytest.mark.cuda
def test_compute_packed_targets_the_card():
    _card()
    bars, mask = wire_mode_case(7, 240, 1, 1, 4)
    enc = wire.encode(bars, mask)
    got = compute_packed(enc.arrays, "wire")
    assert got.is_cuda and got.shape == (58, 2, 6)
    buf, spec = wire.pack_arrays(enc.arrays)
    dec = wire.decode(*wire.unpack(torch.from_numpy(buf).cuda(), spec))
    assert same_bits(got, compute_batch(*dec))


def _smoke():
    """chip_smoke.py as a module (its day-file writer, batch rebuilder and
    card-vs-CPU comparator); it imports neither jax nor the JAX package."""
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", Path(__file__).resolve().parents[1] / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.cuda
def test_pinned_stream_copy_is_bitwise_the_pageable_path():
    """compute_packed_prepared from a numpy buffer, from a pinned host
    tensor (copied on the current stream) and from a device buffer copied
    on a side stream that the current one waits on: the same bits."""
    _card()
    bars, mask = wire_mode_case(11, 240, 1, 1, 4, lead=(2, 64))
    enc = wire.encode(bars, mask)
    buf, spec = wire.pack_arrays(enc.arrays)
    pageable = pl.compute_packed_prepared(buf, spec, "wire")
    pinned = torch.empty(buf.nbytes, dtype=torch.uint8, pin_memory=True)
    wire.pack_arrays(enc.arrays, out=pinned.numpy())
    side = torch.cuda.Stream()
    with torch.cuda.stream(side):
        dbuf = pinned.to("cuda", non_blocking=True)
        copied = torch.cuda.Event()
        copied.record(side)
    torch.cuda.current_stream().wait_event(copied)
    dbuf.record_stream(torch.cuda.current_stream())
    for got in (pl.compute_packed_prepared(pinned, spec, "wire"),
                pl.compute_packed_prepared(dbuf, spec, "wire")):
        assert got.is_cuda and same_bits(got, pageable)
    with pytest.raises(ValueError, match="1-D uint8"):
        pl.compute_packed_prepared(pinned.view(torch.int32), spec, "wire")


def _day_files(tmp_path, n_days=4, n_tickers=40):
    smoke = _smoke()
    d = tmp_path / "kline"
    d.mkdir()
    synth = dict(missing_prob=0.05, zero_volume_prob=0.05,
                 constant_price_codes=2, short_day_codes=2)
    for i, date in enumerate(smoke.trading_dates(n_days)):
        smoke.write_day_file(d / (date.replace("-", "") + ".parquet"), date,
                             n_tickers, 17 + i, synth)
    return smoke, d


@pytest.mark.cuda
def test_driver_on_the_card_equals_the_cpu(tmp_path):
    """Two batches of two days through compute_exposures on the card and
    on the CPU: the same rows, and each batch's block within
    tests/test_parity.py's tolerances (chip_smoke phase 7's comparison)."""
    _card()
    smoke, d = _day_files(tmp_path)
    cfg = Config(days_per_batch=2)
    tel = Telemetry()
    got = pl.compute_exposures(str(d), cfg=cfg, progress=False,
                               telemetry=tel)
    want = pl.compute_exposures(str(d), cfg=cfg, progress=False,
                                device="cpu")
    assert not got.failures and len(got) == len(want) == 4 * 40
    for k in ("code", "date"):
        assert np.array_equal(got.columns[k], want.columns[k])
    reg = tel.registry
    assert reg.counter_value("pipeline.batches_completed") == 2
    assert reg.histogram_stats("pipeline.h2d_ms")["count"] == 2
    assert reg.counter_value("pipeline.h2d_bytes") > 0
    names = factor_names()
    tables = comparator.tables()
    for dates, bars, mask, codes, present in smoke.driver_batches(d, 2):
        a, b = (torch.from_numpy(smoke.table_block(t, dates, codes,
                                                   present, names))
                for t in (got, want))
        ctx = DayContext(torch.from_numpy(bars), torch.from_numpy(mask),
                         rolling_impl="torch")
        kurt = {n: b[names.index(n)].double().numpy()
                for n in ("shape_kurt", "shape_kurtVol")}
        smoke.compare_blocks(f"driver {dates[0]}", names, a, b, tables,
                             ctx.beta_moments()[:3], noisy=True, kurt=kurt,
                             pdf_ctx=ctx)


@pytest.mark.cuda
def test_injected_launch_failure_on_the_card_loses_no_day(tmp_path,
                                                         monkeypatch):
    _card()
    _, d = _day_files(tmp_path)
    real = pl.compute_packed_prepared
    calls = [0]

    def flaky(*a, **kw):
        calls[0] += 1
        if calls[0] == 1:
            raise RuntimeError("injected launch failure")
        return real(*a, **kw)

    monkeypatch.setattr(pl, "compute_packed_prepared", flaky)
    tel = Telemetry()
    t = pl.compute_exposures(str(d), cache_path=str(tmp_path / "c.parquet"),
                             cfg=Config(days_per_batch=2), progress=False,
                             telemetry=tel)
    assert not t.failures and len(np.unique(t.columns["date"])) == 4
    assert tel.registry.counter_value("pipeline.retries",
                                      stage="launch") == 1
    assert calls[0] == 3


@pytest.mark.cuda
def test_stream_day_on_the_card_matches_the_cpu_port():
    """A 64-ticker day streamed on the card: the snapshot is bitwise
    compute_batch on the card (one tiled launch), and within
    tests/test_parity.py's tolerances of the same day streamed on the CPU
    (chip_smoke's comparator)."""
    _card()
    from replication_of_minute_frequency_factor_tpu_torch import (
        compute_exposures_streamed)
    from torch_cases import stream_day

    smoke = _smoke()
    bars, mask = stream_day(41, 64)
    names = factor_names()
    before = dict(rolling_cuda.launches)
    got = compute_exposures_streamed(bars, mask, rolling_impl="cuda")
    assert _launched(before) == {"tiled": 1, "rowwise": 0}
    want = compute_exposures_streamed(bars, mask, device="cpu")
    a = torch.from_numpy(np.stack([got[n] for n in names]))
    b = torch.from_numpy(np.stack([want[n] for n in names]))
    batch = compute_batch(bars, mask, rolling_impl="cuda")
    assert same_bits(a, batch.cpu())
    clean = np.where(mask[..., None], bars, 0.0).astype(np.float32)
    ctx = DayContext(torch.from_numpy(clean), torch.from_numpy(mask),
                     rolling_impl="torch")
    kurt = {n: b[names.index(n)].double().numpy()
            for n in ("shape_kurt", "shape_kurtVol")}
    smoke.compare_blocks("stream card-vs-cpu", names, a, b,
                         comparator.tables(), ctx.beta_moments()[:3],
                         noisy=True, kurt=kurt, pdf_ctx=ctx)


@pytest.mark.cuda
def test_tiled_kernel_on_a_partial_day_mask_matches_plain():
    """The streaming snapshot's input: slots past the cursor all empty.
    The tiled kernel against its plain version on the valid windows and
    bit for bit against the rowwise kernel; no window past the cursor is
    valid."""
    _card()
    g = torch.Generator(device="cuda").manual_seed(60)
    rows, length, cursor = 4001, 240, 60
    close = 10 * torch.exp(torch.cumsum(
        torch.randn(rows, length, generator=g, device="cuda") * 1e-3, -1))
    mask = torch.rand(rows, length, generator=g, device="cuda") > 0.05
    mask[:, cursor:] = False
    low = torch.where(mask, close * 0.999, 0.0)
    high = torch.where(mask, close * 1.001, 0.0)
    args = rolling.second_moment_inputs(low, high, mask, W)
    valid = rolling._windowed_sum(mask, W) > W - 0.5
    assert bool(valid.any()) and not bool(valid[:, cursor:].any())
    before = dict(rolling_cuda.launches)
    got = rolling_cuda.second_moments(*args, W)
    base = rolling_cuda._second_moments_rowwise(*args, W)
    torch.cuda.synchronize()
    assert _launched(before) == {"tiled": 1, "rowwise": 1}
    for a, b, c in zip(got, base, rolling_cuda.second_moments_plain(*args,
                                                                    W)):
        assert same_bits(a, b)
        torch.testing.assert_close(a[valid], c[valid], rtol=1e-5, atol=1e-9)


@pytest.mark.cuda
def test_packed_side_outputs_on_the_card():
    """``compute_packed(..., result_spec=, factor_stats=True)`` on the
    card: the payload is byte for byte the CPU encode of the card's raw
    block, the stats' counts/min/max the host sketch's, and the raw block
    the same with and without the side outputs."""
    _card()
    from replication_of_minute_frequency_factor_tpu_torch.data import (
        result_wire as rw)
    from replication_of_minute_frequency_factor_tpu_torch.telemetry import (
        factorplane)

    bars, mask = wire_mode_case(12, 240, 1, 1, 4, lead=(2, 64))
    arrays = wire.encode(bars, mask).arrays
    names = factor_names()
    spec = rw.ResultWireSpec.for_names(names, days=2, spill_rows=64)
    raw = compute_packed(arrays, "wire", rolling_impl="cuda")
    payload, stats = compute_packed(arrays, "wire", result_spec=spec,
                                    factor_stats=True, rolling_impl="cuda")
    raw2, stats2 = compute_packed(arrays, "wire", factor_stats=True,
                                  rolling_impl="cuda")
    assert payload.is_cuda and same_bits(raw2, raw)
    assert torch.equal(stats2, stats)
    assert torch.equal(payload.cpu(), rw.encode_block(raw.cpu(), spec))
    host = factorplane.factor_stats_host(raw.cpu().numpy())
    got = stats.cpu().numpy()
    for col in (0, 1, 2, 3, 4, 7, 8):
        np.testing.assert_array_equal(got[:, col], host[:, col])
    np.testing.assert_allclose(got[:, 5:7], host[:, 5:7], rtol=1e-5,
                               atol=1e-7)


def _served(device, names, n_days=4, n_tickers=64):
    """All of ``names`` over days [0, n_days) of a seeded source, served
    on ``device``: ``(source, answer, mmt_ols_qrs IC answer, the cached
    block on the CPU, server telemetry)``."""
    from replication_of_minute_frequency_factor_tpu_torch.serve import (
        FactorServer, SyntheticSource)
    src = SyntheticSource(n_days=n_days, n_tickers=n_tickers, seed=11)
    tel = Telemetry()
    with FactorServer(src, names=names, telemetry=tel, device=device,
                      rolling_impl="cuda") as srv:
        ans = srv.client(600).factors(0, n_days)
        ic = srv.client(600).ic("mmt_ols_qrs", 0, n_days)
        block = {k: v.cpu() for k, v in srv.cache.get((0, n_days)).items()}
    return src, ans, ic, block, tel


@pytest.mark.cuda
def test_served_block_on_the_card_matches_the_cpu_server():
    """A block served on the card: one tiled launch, the exposures
    bitwise ``compute_batch`` on the card over the block's decoded bars,
    within tests/test_parity.py's tolerances of the same block served on
    the CPU (chip_smoke's comparator); the card's IC within
    tests/test_torch_eval.py's IC tolerance of the IC graph run on the CPU
    over the card's block."""
    _card()
    from replication_of_minute_frequency_factor_tpu_torch.serve import (
        engine)
    smoke = _smoke()
    names = factor_names()
    before = dict(rolling_cuda.launches)
    src, got, ic, block, tel = _served("cuda", names)
    assert _launched(before) == {"tiled": 1, "rowwise": 0}
    _, want, _, _, _ = _served("cpu", names)
    assert tel.registry.counter_total("serve.dispatches") == 1
    a = torch.from_numpy(np.stack([np.asarray(got["exposures"][n],
                                              np.float32) for n in names]))
    b = torch.from_numpy(np.stack([np.asarray(want["exposures"][n],
                                              np.float32) for n in names]))
    bars, mask = src.slab(0, 4)
    buf, spec = wire.pack_arrays(wire.encode(bars, mask).arrays)
    dbars, dmask = wire.decode(*wire.unpack(torch.from_numpy(buf).cuda(),
                                            spec))
    batch = compute_batch(dbars, dmask, rolling_impl="cuda").cpu()
    nan = torch.isnan(a)
    assert torch.equal(nan, torch.isnan(batch))
    assert same_bits(torch.where(nan, 0.0, a), torch.where(nan, 0.0, batch))
    cbars, cmask = (t.cpu() for t in (dbars, dmask))
    ctx = DayContext(torch.where(cmask[..., None], cbars, 0.0), cmask,
                     rolling_impl="torch")
    smoke.compare_blocks("serve card-vs-cpu", names, a, b,
                         comparator.tables(), ctx.beta_moments()[:3],
                         noisy=True, pdf_ctx=ctx)
    row = names.index("mmt_ols_qrs")
    cpu_ic = engine._ic_fn(block["exposures"], block["close"],
                           block["valid"], row, 1)
    for key, w in zip(("ic", "rank_ic"), cpu_ic):
        g = np.asarray(ic[key], np.float64)
        w = w.double().numpy()
        assert np.array_equal(np.isnan(g), np.isnan(w))
        ok = ~np.isnan(w)
        np.testing.assert_allclose(g[ok], w[ok], rtol=2e-5,
                                   atol=4 * float(np.finfo(np.float32).eps))


@pytest.mark.cuda
def test_a_cold_engine_counts_its_kernel_library_load_in_the_loop():
    """The serve build gate counts what the process builds
    (``kernels.build_count``: nvcc runs and library loads), not the
    executable cache's keys. A server on the card loads the kernel
    library at construction, so its request loop builds nothing; once
    the library is unloaded the engine is cold again, and its next block
    build counts the one load it makes in the loop, while a cache hit
    and a new range of the same extent count none."""
    _card()
    from replication_of_minute_frequency_factor_tpu_torch import kernels
    from replication_of_minute_frequency_factor_tpu_torch.serve import (
        FactorServer, Query, ServeConfig, SyntheticSource)
    src = SyntheticSource(n_days=8, n_tickers=64, seed=9)
    with FactorServer(src, names=("vol_return1min", "mmt_ols_qrs"),
                      rolling_impl="cuda", telemetry=Telemetry(),
                      serve_cfg=ServeConfig(hbm_sample_period_s=0),
                      device="cuda") as srv:
        built = kernels.build_count()
        srv.submit(Query("factors", 0, 4)).result(600)
        assert kernels.build_count() == built
        assert kernels.unload("rolling_moments")
        before = dict(rolling_cuda.launches)
        srv.submit(Query("factors", 4, 8)).result(600)
        assert kernels.build_count() == built + 1
        assert _launched(before) == {"tiled": 1, "rowwise": 0}
        srv.submit(Query("factors", 4, 8)).result(600)
        srv.submit(Query("factors", 2, 6)).result(600)
        assert kernels.build_count() == built + 1


@pytest.mark.cuda
def test_fleet_on_the_card_answers_bitwise_the_standalone_server():
    """Two replicas sharing the card (``devices=[cuda:0, cuda:0]``): the
    routed block is built on the owner's card with one tiled launch, the
    answer is bitwise the standalone server's on the card, and each
    replica's health names the card."""
    _card()
    from replication_of_minute_frequency_factor_tpu_torch.fleet import (
        FactorFleet)
    from replication_of_minute_frequency_factor_tpu_torch.serve import (
        FactorServer, Query, ServeConfig, SyntheticSource)
    names = ("vol_return1min", "mmt_ols_qrs")
    src = SyntheticSource(n_days=8, n_tickers=64, seed=9)
    card = torch.device("cuda", 0)
    scfg = ServeConfig(hbm_sample_period_s=0)
    with FactorFleet(src, 2, names=names, rolling_impl="cuda",
                     serve_cfg=scfg, devices=[card, card]) as pod:
        before = dict(rolling_cuda.launches)
        got = pod.submit(Query("factors", 0, 6)).result(600)
        torch.cuda.synchronize()
        assert _launched(before) == {"tiled": 1, "rowwise": 0}
        owner = pod.router.route_order((0, 6))[0]
        block = owner.server.cache.get((0, 6))
        assert {t.device for t in block.values()} == {card}
        for h in pod.health()["replicas"].values():
            assert h["replica"]["devices"][0].startswith("cuda:0 ")
    with FactorServer(src, names=names, rolling_impl="cuda",
                      serve_cfg=scfg, device="cuda") as srv:
        want = srv.submit(Query("factors", 0, 6)).result(600)
    for n in names:
        assert np.asarray(got["exposures"][n], np.float32).tobytes() == \
            np.asarray(want["exposures"][n], np.float32).tobytes()


@pytest.mark.cuda
def test_exposure_cache_eviction_frees_card_memory():
    """Torch cannot delete a tensor under live references; the cache drops
    its own, and nothing else holds a served block, so
    ``torch.cuda.memory_allocated`` falls by the evicted block's bytes."""
    _card()
    from replication_of_minute_frequency_factor_tpu_torch.serve import (
        DeviceExposureCache)
    from replication_of_minute_frequency_factor_tpu_torch.serve.expcache \
        import entry_nbytes

    def block():
        return {"exposures": torch.ones(58, 8, 5000, device="cuda"),
                "close": torch.ones(8, 5000, device="cuda"),
                "valid": torch.ones(8, 5000, dtype=torch.bool,
                                    device="cuda")}

    torch.cuda.synchronize()
    first = block()
    nbytes = entry_nbytes(first)
    cache = DeviceExposureCache(int(nbytes * 1.5), telemetry=Telemetry())
    cache.put("a", first)
    del first
    torch.cuda.synchronize()
    held = torch.cuda.memory_allocated()
    cache.put("b", block())  # evicts "a"
    torch.cuda.synchronize()
    after = torch.cuda.memory_allocated()
    assert cache.get("a") is None and len(cache) == 1
    # the new block is allocated, the evicted one freed: net about zero
    assert after - held < nbytes // 2
    cache.clear()
    torch.cuda.synchronize()
    assert torch.cuda.memory_allocated() <= held - nbytes + 4096


@pytest.mark.cuda
def test_hbm_sampler_is_available_on_the_card():
    """On the card the sampler reads the caching allocator: available,
    the current bytes and a peak that is ``max_memory_allocated``'s."""
    _card()
    tel = Telemetry()
    keep = torch.ones(1 << 20, device="cuda")
    torch.cuda.synchronize()
    out = tel.hbm.configure(device="cuda").sample("test", force=True)
    assert out["available"] is True and out["source"] == "memory_stats"
    dev = f"cuda:{torch.cuda.current_device()}"
    assert out["devices"][dev]["bytes_in_use"] \
        == torch.cuda.memory_allocated()
    assert out["devices"][dev]["peak_bytes"] \
        == torch.cuda.max_memory_allocated()
    del keep


#: the interpreter tolerance of tests/test_torch_search.py (the JAX
#: package's, tests/test_search.py:38)
SEARCH_RTOL, SEARCH_ATOL = 2e-4, 1e-6


def _discovery_slab(n_days=6, n_tickers=48, seed=5):
    from replication_of_minute_frequency_factor_tpu_torch.research import (
        host_forward_returns)
    from replication_of_minute_frequency_factor_tpu_torch.serve import (
        SyntheticSource)
    bars, mask = SyntheticSource(n_days=n_days, n_tickers=n_tickers,
                                 seed=seed).slab(0, n_days)
    return (bars, mask) + host_forward_returns(bars, mask)


@pytest.mark.cuda
def test_one_generation_launches_without_a_sync():
    """A warm generation on the card is enqueued without one device
    wait (``set_sync_debug_mode("error")`` up to the fetch); its top-k
    is the host argsort's first ``n_elite``; a short loop keeps one
    sync a generation and builds nothing."""
    _card()
    from replication_of_minute_frequency_factor_tpu_torch import search
    from replication_of_minute_frequency_factor_tpu_torch.research import (
        DiscoveryEngine)
    slab = _discovery_slab()
    eng = DiscoveryEngine(telemetry=Telemetry(), device="cuda")
    data = eng.prepare(*slab)
    pop = 64
    n_elite = eng._n_elite(pop, 0.1)
    eng.warmup(data, pop)
    exe = eng._generation_exe(data, pop, n_elite)
    g = search.random_population(np.random.default_rng(3), pop)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        stats, top_vals, top_idx = exe(g, *data.device_args)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    stats = stats.cpu().numpy()
    assert stats.shape == (pop, 4)
    fits = np.nan_to_num(stats[:, 0], nan=-1.0)
    host = np.argsort(-fits, kind="stable")[:n_elite]
    np.testing.assert_array_equal(top_idx.cpu().numpy(), host)
    np.testing.assert_array_equal(top_vals.cpu().numpy(), fits[host])
    res = eng.evolve(data, pop=pop, generations=3,
                     rng=np.random.default_rng(4))
    assert res.syncs_per_generation == 1.0
    assert res.compiles_during_loop == 0


@pytest.mark.cuda
def test_generation_stats_on_the_card_equal_the_cpu():
    """``generation_stats`` on the card against the port on the CPU for
    one population over the ops of bounded conditioning: NaN positions
    identical, fitness and IC within the interpreter tolerance, the rank
    IC and spread likewise on the candidates whose card and CPU exposures
    order every date alike (torch_cases.same_order)."""
    _card()
    from replication_of_minute_frequency_factor_tpu_torch import search
    from replication_of_minute_frequency_factor_tpu_torch.research import (
        fitness)
    from torch_cases import bounded_population, same_order
    bars, mask, fr, fv = _discovery_slab()
    g = bounded_population(7, 96, search.DEFAULT_SKELETON)
    out, vals = {}, {}
    for dev in ("cpu", "cuda"):
        args = [torch.from_numpy(np.ascontiguousarray(a)).to(dev)
                for a in (bars, mask, fr, fv)]
        feats = search._features(args[0], args[1])
        out[dev] = fitness.generation_stats(
            g, feats, args[1], args[2], args[3], search.DEFAULT_SKELETON,
            5, 32).cpu().numpy()
        vals[dev] = search.eval_programs(g, args[0], args[1]).cpu().numpy()
    order = same_order(vals["cuda"], vals["cpu"],
                       np.isfinite(vals["cpu"]) & fv)
    cpu, card = out["cpu"], out["cuda"]
    assert np.array_equal(np.isnan(cpu), np.isnan(card))
    np.testing.assert_allclose(card[:, :2], cpu[:, :2], rtol=SEARCH_RTOL,
                               atol=SEARCH_ATOL)
    np.testing.assert_allclose(card[order, 2:], cpu[order, 2:],
                               rtol=SEARCH_RTOL, atol=SEARCH_ATOL)
    assert order.sum() > len(g) // 2


@pytest.mark.cuda
def test_served_discovered_factor_on_the_card_matches_make_kernel(
        tmp_path):
    """A research server on the card discovers a factor; its served
    exposures equal the registered kernel evaluated on the block's
    decoded bars on the card (NaN positions identical, rtol 1e-5 / atol
    1e-6, tests/test_research.py:358-359), and the rebuild after the
    registration is one tiled launch."""
    _card()
    from replication_of_minute_frequency_factor_tpu_torch.research import (
        registry)
    from replication_of_minute_frequency_factor_tpu_torch.serve import (
        FactorServer, Query, ServeConfig, SyntheticSource)
    src = SyntheticSource(n_days=8, n_tickers=64, seed=9)
    names = ("vol_return1min", "mmt_ols_qrs")
    with FactorServer(src, names=names, rolling_impl="cuda",
                      serve_cfg=ServeConfig(research_dir=str(tmp_path),
                                            hbm_sample_period_s=0),
                      telemetry=Telemetry(), research=True,
                      device="cuda") as srv:
        ans = srv.discover(0, 6, generations=2, pop=32,
                           seed=7).result(600)
        assert ans["syncs_per_generation"] == 1.0
        assert ans["compiles_during_loop"] == 0
        name = ans["name"]
        before = dict(rolling_cuda.launches)
        got = srv.submit(Query("factors", 0, 6, names=(name,))).result(600)
        torch.cuda.synchronize()
        assert _launched(before) == {"tiled": 1, "rowwise": 0}
    rec = registry.load_record(ans["record_path"])
    from replication_of_minute_frequency_factor_tpu_torch.models import (
        registry as models_registry)
    for d in (models_registry.ALIASES, models_registry.FINALIZE_CLASSES,
              registry.DISCOVERED):
        d.pop(name)  # the registration stays inside this test
    bars, mask = src.slab(0, 6)
    buf, spec = wire.pack_arrays(wire.encode(bars, mask).arrays)
    dbars, dmask = wire.decode(*wire.unpack(torch.from_numpy(buf).cuda(),
                                            spec))
    ctx = DayContext(dbars, dmask.to(torch.bool))
    want = registry.make_kernel(rec.genome, rec.skeleton)(ctx).cpu().numpy()
    a = np.asarray(got["exposures"][name], np.float32)
    assert np.array_equal(np.isnan(a), np.isnan(want))
    np.testing.assert_allclose(a, want, rtol=1e-5, atol=1e-6)


def _resident_year(n=3, days=4, tickers=256, seed=61):
    """A small year of ``bench.make_batch`` batches under one shared
    floor (``torch_cases.encode_year``)."""
    from torch_cases import Year, encode_year
    bufs, spec, kind = encode_year(Year(seed, n, days, tickers))
    assert kind == "wire"
    return bufs, spec


def _to_card(bufs):
    """Device-resident copies, from pinned memory without a wait."""
    return [torch.from_numpy(b).pin_memory().to("cuda", non_blocking=True)
            for b in bufs]


@pytest.mark.cuda
def test_resident_year_launches_without_a_sync_and_donates():
    """The resident loop enqueues every step with no device wait
    (``set_sync_debug_mode("error")`` around the call), launches the tiled
    kernel once a batch, releases each donated buffer (any reuse raises
    ``DonatedBufferError``), and each step is bitwise the per-batch call
    on a fresh copy of its buffer."""
    _card()
    names = factor_names()
    bufs, spec = _resident_year()
    pl.compute_packed_prepared(bufs[0], spec, "wire", names[:4])  # warm
    dbufs = _to_card(bufs)
    torch.cuda.synchronize()
    before = dict(rolling_cuda.launches)
    torch.cuda.set_sync_debug_mode("error")
    try:
        ys = pl.compute_packed_resident(dbufs, spec, "wire", names,
                                        rolling_impl="cuda")
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert _launched(before) == {"tiled": len(bufs), "rowwise": 0}
    host = ys.cpu()
    assert tuple(host.shape) == (len(bufs), len(names), 4, 256)
    for b in dbufs:
        with pytest.raises(pl.DonatedBufferError):
            b.sum()
    with pytest.raises(pl.DonatedBufferError):
        pl.compute_packed_resident(dbufs, spec, "wire", names)
    for i in (0, len(bufs) - 1):
        one = pl.compute_packed_prepared(_to_card(bufs[i:i + 1])[0], spec,
                                         "wire", names, rolling_impl="cuda")
        assert same_bits(one.cpu(), host[i])


@pytest.mark.cuda
def test_resident_year_on_the_card_matches_the_cpu():
    """The same year on the card and on the CPU: each batch's block within
    tests/test_parity.py's tolerances (chip_smoke's comparator), doc_pdf*
    exact off the threshold's edge band."""
    _card()
    smoke = _smoke()
    names = factor_names()
    bufs, spec = _resident_year(seed=67)
    got = pl.compute_packed_resident(_to_card(bufs), spec, "wire", names,
                                     rolling_impl="cuda").cpu()
    want = pl.compute_packed_resident(
        [torch.from_numpy(b).clone() for b in bufs], spec, "wire", names,
        device="cpu")
    tables = comparator.tables()
    for i, b in enumerate(bufs):
        bars, mask = wire.decode(*wire.unpack(torch.from_numpy(b), spec))
        ctx = DayContext(bars, mask, rolling_impl="torch")
        kurt = {n: want[i, names.index(n)].double().numpy()
                for n in ("shape_kurt", "shape_kurtVol")}
        smoke.compare_blocks(f"resident batch {i}", names, got[i], want[i],
                             tables, ctx.beta_moments()[:3], kurt=kurt,
                             pdf_ctx=ctx)


@pytest.mark.cuda
def test_trace_capture_on_the_card_names_the_kernel(tmp_path):
    """A capture around the packed path on the card: device time is
    available, the tiled kernel is among the ops, the stage annotation is
    read, and the capture exported one trace."""
    _card()
    from replication_of_minute_frequency_factor_tpu_torch.telemetry import (
        attribution)
    names = factor_names()
    bufs, spec = _resident_year(n=1, seed=71)
    pl.compute_packed_prepared(bufs[0], spec, "wire", names[:4])  # warm
    tel = Telemetry()
    timer = tel.stage_timer()
    pdir = str(tmp_path / "prof")
    with attribution.TraceCapture(pdir, telemetry=tel) as cap:
        with timer("launch"):
            out = pl.compute_packed_prepared(bufs[0], spec, "wire", names,
                                             rolling_impl="cuda")
        with timer("device"):
            torch.cuda.synchronize()
    assert out.is_cuda and cap.path is not None
    block = attribution.device_time_block(pdir)
    assert block["available"] is True and block["device_time_s"] > 0
    s = attribution.summarize_trace_dir(pdir, top_n=None)
    ops = [r["op"] for r in s["device_breakdown"]["top_ops_us"]]
    assert any("second_moments_tiled_kernel" in op for op in ops)
    assert {"launch", "device"} <= set(s["stage_annotations_us"])
    assert {"fusion", "reduction", "sort_scan"} <= set(block["by_class_s"])
    assert tel.registry.counter_value("attribution.trace_captures") == 1


# --------------------------------------------------------------------------
# the sharded loops and the sharded driver: two ranks on the card
# --------------------------------------------------------------------------

def _two_rank_year(days=4, tickers=256, n=2):
    from torch_cases import make_batch
    return [make_batch(np.random.default_rng([7, i]), days, tickers)
            for i in range(n)]


@pytest.mark.cuda
def test_sharded_resident_year_on_two_ranks_matches_single_device(
        tmp_path):
    """The 1-D loop on two ranks sharing the card (gloo, staged through
    pinned host buffers) against the single-device loop on the card: all
    58 factors bitwise (the JAX package's ulp pair within its 16-eps bar),
    the tiled kernel launched once a step on each rank."""
    _card()
    from torch_cases import (encode_year, encode_year_sharded, run_on_ranks,
                             sharded_misses)
    names = factor_names()
    year = _two_rank_year()
    bufs, spec, kind = encode_year(year)
    want = pl.compute_packed_resident(
        [torch.from_numpy(b).cuda() for b in bufs], spec, kind, names,
        device="cuda").cpu().numpy()
    stacks, sspec, skind, _ = encode_year_sharded(year, True, 2)
    res = run_on_ranks([("y", "resident_1d", dict(
        stacks=stacks, spec=sspec, kind=skind, names=names,
        device="cuda"))], 2, workdir=tmp_path, device="cuda")
    got = np.concatenate([r["y"]["ys"] for r in sorted(
        res, key=lambda r: r["y"]["coord"])], axis=-1)
    assert sharded_misses(names, got, want) == {}
    for r in res:
        assert r["y"]["launches"] == {"tiled": 2, "rowwise": 0}
        assert r["y"]["backend"] == "gloo"


@pytest.mark.cuda
def test_resident_2d_on_the_card_counts_its_handoffs(tmp_path):
    """The 2-D loop on a (2, 1) mesh of two ranks on the card, one batch
    a call: one carry handoff a call, and the tiles and the year-end carry
    equal the single-device loop and span fold."""
    _card()
    from replication_of_minute_frequency_factor_tpu_torch.stream import (
        carry as scarry)
    from torch_cases import (encode_year, encode_year_2d, run_on_ranks,
                             sharded_misses)
    names = ("vol_return1min", "mmt_ols_qrs", "doc_pdf60")
    year = _two_rank_year()
    bufs, spec, kind = encode_year(year)
    dbufs = [torch.from_numpy(b).cuda() for b in bufs]
    want = pl.compute_packed_resident([b.clone() for b in dbufs], spec,
                                      kind, names,
                                      device="cuda").cpu().numpy()
    state = {k: torch.from_numpy(v).cuda()
             for k, v in scarry.init_span_state(256).items()}
    state["day"] = torch.full((256,), -1, dtype=torch.int32, device="cuda")
    for n, b in enumerate(dbufs):
        state = scarry.combine_span_state(state, scarry.span_prefix_state(
            *pl._decode(b, spec, kind), n * 4))
    stacks, sspec, skind, t_pad, _ = encode_year_2d(year, True, 2, 1)
    res = run_on_ranks([("y", "resident_2d", dict(
        stacks=stacks, spec=sspec, kind=skind, names=names, shape=(2, 1),
        group=1, t_pad=t_pad, device="cuda"))], 2, workdir=tmp_path,
        device="cuda")
    tiles = sorted(res, key=lambda r: r["y"]["coord"])
    got = np.concatenate([r["y"]["ys"] for r in tiles], axis=-2)
    assert sharded_misses(names, got, want) == {}
    for r in res:
        assert r["y"]["handoffs"] == 2  # one a call, two calls
        for k in ("last_close", "n_bars", "has"):
            assert np.array_equal(
                np.asarray(r["y"]["carry"][k]).view(np.uint8),
                state[k].cpu().numpy().view(np.uint8)), k


@pytest.mark.cuda
def test_compute_mesh_tickers_2_on_the_card_matches_the_unsharded_cache(
        tmp_path):
    """``compute --mesh-tickers 2`` on the card (two ranks sharing it)
    writes the cache of the single-device run, bit for bit."""
    _card()
    import pyarrow as pa
    import pyarrow.parquet as pq
    from replication_of_minute_frequency_factor_tpu_torch.__main__ import (
        main)
    from replication_of_minute_frequency_factor_tpu_torch.data.synthetic import (
        synth_day)
    kline = tmp_path / "kline"
    kline.mkdir()
    rng = np.random.default_rng(5)
    for ds in ("2024-01-02", "2024-01-03", "2024-01-04", "2024-01-05"):
        cols = synth_day(rng, n_codes=300, date=ds, missing_prob=0.05)
        pq.write_table(pa.table(
            {"code": pa.array(cols["code"].astype(np.int64)),
             **{k: pa.array(cols[k]) for k in
                ("time", "open", "high", "low", "close", "volume")}}),
            str(kline / (ds.replace("-", "") + ".parquet")))
    one, two = str(tmp_path / "one.parquet"), str(tmp_path / "two.parquet")
    base = ["compute", "--minute-dir", str(kline), "--quiet",
            "--days-per-batch", "2"]
    assert main(base + ["--cache", one]) == 0
    assert main(base + ["--cache", two, "--mesh-tickers", "2"]) == 0
    a, b = pl.ExposureTable.load(two), pl.ExposureTable.load(one)
    assert list(a.columns) == list(b.columns) and len(a) == len(b) > 0
    for k in a.columns:
        x, y = np.asarray(a.columns[k]), np.asarray(b.columns[k])
        if x.dtype == np.float32:
            x, y = x.view(np.int32), y.view(np.int32)
        np.testing.assert_array_equal(x, y, err_msg=k)


@pytest.mark.cuda
def test_sharded_generation_on_two_shards_of_the_card_launches_without_a_sync():
    """The population sharded over ``[cuda:0, cuda:0]`` (two worker
    threads, a stream each, on one card): a warm generation is enqueued
    without one device wait (``set_sync_debug_mode("error")`` up to the
    fetch), and its stats and top-k are bitwise the single-device
    generation's at the matched chunk (the chunk divides a shard's
    block, so both cut the population alike)."""
    _card()
    from replication_of_minute_frequency_factor_tpu_torch import search
    from replication_of_minute_frequency_factor_tpu_torch.parallel import (
        resident_mesh)
    from replication_of_minute_frequency_factor_tpu_torch.research import (
        DiscoveryEngine)
    slab = _discovery_slab()
    card0 = torch.device("cuda", 0)
    mesh = resident_mesh(2, devices=[card0, card0])
    try:
        sharded = DiscoveryEngine(telemetry=Telemetry(), mesh=mesh,
                                  device_batch=8)
        single = DiscoveryEngine(telemetry=Telemetry(), device="cuda",
                                 device_batch=8)
        pop = 64
        n_elite = sharded._n_elite(pop, 0.1)
        exes = {}
        for label, eng in (("sharded", sharded), ("single", single)):
            data = eng.prepare(*slab)
            eng.warmup(data, pop)
            exes[label] = (eng._generation_exe(data, pop, n_elite), data)
        g = search.random_population(np.random.default_rng(3), pop)
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            out = {k: exe(g, *data.device_args)
                   for k, (exe, data) in exes.items()}
        finally:
            torch.cuda.set_sync_debug_mode("default")
        for a, b in zip(out["sharded"], out["single"]):
            assert same_bits(a.cpu(), b.cpu())
        res = sharded.evolve(exes["sharded"][1], pop=pop, generations=3,
                             rng=np.random.default_rng(4))
        assert res.n_shards == 2 and res.syncs_per_generation == 1.0
        assert res.compiles_during_loop == 0
    finally:
        mesh.close()


@pytest.mark.cuda
def test_sharded_snapshot_on_two_shards_of_the_card_is_the_unsharded_bits():
    """A 64-ticker day's carry over ``[cuda:0, cuda:0]``: the exact
    snapshot, enqueued without a device wait, launches the tiled kernel
    once a shard and is bitwise the unsharded engine's on the card, the
    wire payload byte for byte."""
    _card()
    from replication_of_minute_frequency_factor_tpu_torch.parallel import (
        resident_mesh)
    from replication_of_minute_frequency_factor_tpu_torch.stream import (
        StreamEngine)
    from torch_cases import feed, stream_day

    bars, mask = stream_day(41, 64)
    names = factor_names()
    card0 = torch.device("cuda", 0)
    mesh = resident_mesh(2, devices=[card0, card0])
    try:
        plain = StreamEngine(64, names=names, rolling_impl="cuda",
                             device="cuda", telemetry=Telemetry())
        sharded = StreamEngine(64, names=names, rolling_impl="cuda",
                               mesh=mesh, telemetry=Telemetry())
        for eng in (plain, sharded):
            eng.warmup()
            feed(eng, bars, mask, 0, 60, micro=16)
        torch.cuda.synchronize()
        before = dict(rolling_cuda.launches)
        torch.cuda.set_sync_debug_mode("error")
        try:
            got, ready = sharded.snapshot()
        finally:
            torch.cuda.set_sync_debug_mode("default")
        assert _launched(before) == {"tiled": 2, "rowwise": 0}
        want, want_ready = plain.snapshot()
        assert same_bits(got.cpu(), want.cpu())
        assert torch.equal(ready.cpu(), want_ready.cpu())
        pa, _, sa = plain.snapshot_wire_stats()
        pb, _, sb = sharded.snapshot_wire_stats()
        assert torch.equal(pa.cpu(), pb.cpu())
        assert same_bits(sa.cpu(), sb.cpu())
    finally:
        mesh.close()


@pytest.mark.cuda
def test_trace_tier_on_the_card_sees_no_sync_and_counts_the_kernel():
    """The analysis package's op-trace tier on the card: every kernel at
    the canonical shape runs without a host sync under
    ``set_sync_debug_mode("error")``, its fingerprint is the CPU's plus
    the pinned upload of the grid times, and an ``mmt_ols_*`` kernel
    through the hand-written kernel counts one launch under
    ``kernel:second_moments`` in place of the plain version's ops. The
    pv_corr family runs its hand-written kernel on every card trace: each
    of the six counts one launch under ``kernel:pv_corr`` in place of the
    plain version's ops, for the wrapper's. So does the chip family's
    kernel, under ``kernel:chip_segments``: the three moment factors in
    place of the plain moments, the five doc_pdf* in place of the plain
    pdf walks. And the volume order statistics' kernel, under
    ``kernel:volume_select``: each of the four mmt_*VolumeRet and the
    three doc_vol*_ratio in place of the plain compositions of every
    answer."""
    _card()
    from replication_of_minute_frequency_factor_tpu_torch.analysis import (
        trace_tier as tt)
    from replication_of_minute_frequency_factor_tpu_torch.models import (
        registry)
    from replication_of_minute_frequency_factor_tpu_torch.ops import (
        chip_segments_cuda, pv_corr_cuda, volume_select_cuda)

    cb, cm = tt.canonical_inputs()
    gb, gm = cb.cuda(), cm.cuda()
    _, pv_plain = tt.trace(lambda: pv_corr_cuda.pv_corr(cb, cm))
    chip_args, vol_args = {}, {}
    for dev, (b, m) in (("cpu", (cb, cm)), ("cuda", (gb, gm))):
        ctx = DayContext(b, m)
        chip_args[dev] = (ctx.eod_ret, ctx.vol_share, ctx.mask,
                          ctx.eod_ret_global_rank)
        vol_args[dev] = (ctx.bars.contiguous(), ctx.mask, ctx.vol_sum,
                         ctx.volume_answers)
    vol_names = ("mmt_top50VolumeRet", "mmt_bottom50VolumeRet",
                 "mmt_top20VolumeRet", "mmt_bottom20VolumeRet",
                 "doc_vol10_ratio", "doc_vol5_ratio", "doc_vol50_ratio")
    _, vol_plain = tt.trace(lambda: volume_select_cuda.volume_selections(
        *vol_args["cpu"]))
    chip_plain = {
        "moments": tt.trace(lambda: chip_segments_cuda.segment_moments(
            *chip_args["cpu"][:3]))[1],
        "pdf": tt.trace(lambda: chip_segments_cuda.pdf_ranks(
            *chip_args["cpu"]))[1]}
    torch.cuda.set_sync_debug_mode("error")
    try:
        _, pv_wrap = tt.trace(lambda: pv_corr_cuda.pv_corr(gb, gm))
        assert pv_wrap.kernel_launches == {"kernel:pv_corr": 1}
        chip_wrap = {
            "moments": tt.trace(lambda: chip_segments_cuda.segment_moments(
                *chip_args["cuda"][:3]))[1],
            "pdf": tt.trace(lambda: chip_segments_cuda.pdf_ranks(
                *chip_args["cuda"]))[1]}
        for t in chip_wrap.values():
            assert t.kernel_launches == {"kernel:chip_segments": 1}
        _, vol_wrap = tt.trace(lambda: volume_select_cuda.volume_selections(
            *vol_args["cuda"]))
        assert vol_wrap.kernel_launches == {"kernel:volume_select": 1}
        for n in registry.factor_names():
            fn = registry.resolve(n)
            _, tc = tt.trace_kernel(fn, cb, cm, "torch")
            _, tg = tt.trace_kernel(fn, gb, gm, "torch")
            assert not tg.syncs and not tc.syncs, n
            want = dict(tc.counts())
            want["aten.pin_memory.default"] = \
                want.get("aten.pin_memory.default", 0) + 1
            if n in pv_corr_cuda.NAMES:
                want = tt.add_counts(tt.add_counts(
                    want, pv_plain.counts(), -1), pv_wrap.counts())
            part = ("moments" if n in ("doc_skew", "doc_kurt", "doc_std")
                    else "pdf" if n.startswith("doc_pdf") else None)
            if part is not None:
                want = tt.add_counts(tt.add_counts(
                    want, chip_plain[part].counts(), -1),
                    chip_wrap[part].counts())
            if n in vol_names:
                want = tt.add_counts(tt.add_counts(
                    want, vol_plain.counts(), -1), vol_wrap.counts())
            assert tg.counts() == dict(sorted(want.items())), n
        _, tk = tt.trace_kernel(registry.resolve("mmt_ols_qrs"), gb, gm,
                                "cuda")
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert tk.launches == 1 and tk.impl_counts == {("cuda", "cuda"): 1}
    assert tk.counts()["kernel:second_moments"] == 1
    args = rolling.second_moment_inputs(gb[..., 2], gb[..., 1], gm, W)
    _, plain = tt.trace(lambda: rolling_cuda.second_moments_plain(*args, W))
    _, wrap = tt.trace(lambda: rolling_cuda.second_moments(*args, W))
    _, tt_ = tt.trace_kernel(registry.resolve("mmt_ols_qrs"), gb, gm,
                             "torch")
    want = dict(tt_.counts())
    for op, c in plain.counts().items():
        want[op] -= c
    for op, c in wrap.counts().items():
        want[op] = want.get(op, 0) + c
    assert tk.counts() == {k: v for k, v in sorted(want.items()) if v}


@pytest.mark.cuda
@pytest.mark.parametrize("name", fuzz.HARNESSES)
def test_fuzz_harness_on_the_card(name):
    """Each fuzz harness of the port clean over a short window on the
    card (the refdiff one on the stand-in reference tree)."""
    _card()
    kw = {}
    if name == "refdiff":
        kw["tree"] = str(Path(__file__).parent / "fixtures" /
                         "refdiff_torch")
    lo, hi = (0, 40) if name == "rolling" else (0, 3)
    assert fuzz.harness(name).run(lo, hi, "cuda", **kw) == []
