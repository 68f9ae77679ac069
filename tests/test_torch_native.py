"""The port's native grid packer and wire encoder (its own copy of
``gridpack.cpp``, built into build/native/) against the JAX package's
native and numpy paths, byte for byte: tests/test_native.py's cases, and
every rung of every ladder (``torch_cases.WIRE_MODE_CASES``). Threaded
equals single-threaded; a stale ABI triggers one rebuild; every call
counts the path it requested and the one it resolved."""

import ctypes

import numpy as np
import pytest

from replication_of_minute_frequency_factor_tpu import native as jn
from replication_of_minute_frequency_factor_tpu import sessions
from replication_of_minute_frequency_factor_tpu.data import wire as jw
from replication_of_minute_frequency_factor_tpu.data.minute import (
    grid_day as jgrid_day)
from replication_of_minute_frequency_factor_tpu.data.synthetic import synth_day
from replication_of_minute_frequency_factor_tpu_torch import native as tn
from replication_of_minute_frequency_factor_tpu_torch.data import wire as tw
from replication_of_minute_frequency_factor_tpu_torch.data.minute import (
    grid_day)
from torch_cases import WIRE_MODE_CASES, expected_wire_modes, wire_mode_case

COLS = ("code", "time", "open", "high", "low", "close", "volume")


@pytest.fixture(autouse=True)
def _library():
    """Both packages' libraries build here (the tests need g++, as the
    JAX package's test_native.py does)."""
    assert tn.available(), "the port's native library did not build"
    assert jn.available(), "the JAX package's native library did not build"


def _grid_all(cols, **kw):
    """The port's native and numpy grids and the JAX package's native and
    numpy grids of one day."""
    args = [cols[k] for k in COLS]
    return [f(*args, use_native=u, **kw)
            for f in (grid_day, jgrid_day) for u in (True, False)]


def _assert_same_grids(grids):
    ref = grids[-1]
    for g in grids[:-1]:
        assert g.bars.dtype == ref.bars.dtype == np.float32
        np.testing.assert_array_equal(g.bars, ref.bars)
        np.testing.assert_array_equal(g.mask, ref.mask)
        np.testing.assert_array_equal(g.codes, ref.codes)


def _assert_wire_bytes(port, ref):
    assert (port is None) == (ref is None)
    if port is None:
        return
    for x, y, nm in zip(port.arrays, ref.arrays,
                        ("base", "dclose", "dohl", "volume", "mask", "vs")):
        x, y = np.asarray(x), np.asarray(y)
        assert x.dtype == y.dtype and x.shape == y.shape, nm
        assert x.tobytes() == y.tobytes(), nm


def _encode_all(bars, mask, **kw):
    """The port's native encoding, held byte for byte to its numpy one and
    to the JAX package's native and numpy ones; returns it."""
    port = tw.encode(bars, mask, use_native=True, **kw)
    for ref in (tw.encode(bars, mask, use_native=False, **kw),
                jw.encode(bars, mask, use_native=True, **kw),
                jw.encode(bars, mask, use_native=False, **kw)):
        _assert_wire_bytes(port, ref)
    if port is not None:
        assert port.modes == tw.encode(bars, mask, use_native=False,
                                       **kw).modes
    return port


def test_native_grid_matches_numpy_and_jax(rng):
    cols = synth_day(rng, n_codes=20, missing_prob=0.1, zero_volume_prob=0.1,
                     short_day_codes=3, constant_price_codes=2)
    # off-grid rows the packer must drop: lunch break + sub-minute
    cols["time"][::37] = 120000000
    cols["time"][5] = 93000500
    _assert_same_grids(_grid_all(cols))


def test_native_unknown_codes_and_pinned_axis(rng):
    cols = synth_day(rng, n_codes=4)
    pinned = np.array(["600000", "600002", "999999"], dtype=object)
    grids = _grid_all(cols, codes=pinned)
    _assert_same_grids(grids)
    assert not grids[0].mask[list(grids[0].codes).index("999999")].any()


def test_native_last_write_wins():
    code = np.array(["600000", "600000"])
    time = np.array([93000000, 93000000], np.int64)
    one = np.array([1.0, 2.0])
    g = grid_day(code, time, one, one, one, one, one, use_native=True)
    assert g.bars[0, 0, 0] == 2.0 and g.mask.sum() == 1


def test_abi_and_slot_formula_parity():
    times = np.concatenate([sessions.GRID_TIMES,
                            np.array([92900000, 113000000, 120000000,
                                      150000000, 93000001], np.int64)])
    want = sessions.time_to_slot(times)
    n = len(times)
    v = np.arange(n, dtype=np.float64)
    g = grid_day(np.array(["600000"] * n), times, v, v, v, v, v,
                 use_native=True)
    np.testing.assert_array_equal(np.sort(np.flatnonzero(g.mask[0])),
                                  np.sort(want[want >= 0]))
    assert tn.load().grid_pack_abi_version() == tn.ABI_VERSION == 11


def test_native_wire_encode_matches_numpy_and_jax(rng):
    cols = synth_day(rng, n_codes=12, missing_prob=0.1, zero_volume_prob=0.1,
                     short_day_codes=2)
    g = grid_day(*[cols[k] for k in COLS])
    bars, mask = g.bars[None], g.mask[None]
    assert _encode_all(bars, mask) is not None
    # unrepresentable input rejected by all four
    bad = bars.copy()
    i = tuple(np.argwhere(mask)[0])
    bad[i][3] += 0.005
    assert _encode_all(bad, mask) is None
    # a NaN lane after a genuine violation must not launder the batch;
    # NaN alone rejects too
    vi = np.argwhere(mask[0])
    for fields in ((3,), (4,), (3, 4)):
        bad = bars.copy()
        bad[0][tuple(vi[0])][3] += 0.3
        for f in fields:
            bad[0][tuple(vi[-1])][f] = np.nan
        assert _encode_all(bad, mask) is None, fields
    nan_only = bars.copy()
    nan_only[0][tuple(vi[0])][4] = np.nan
    assert _encode_all(nan_only, mask) is None


@pytest.mark.parametrize("case", WIRE_MODE_CASES)
def test_every_rung_encodes_as_jax(case):
    bars, mask = wire_mode_case(sum(case) * 17 + 1, 240, *case)
    enc = _encode_all(bars, mask)
    assert enc.modes == expected_wire_modes(240, *case)


def test_sticky_floor_widens_alike():
    """A floor threaded through a run widens once and stays wide on both
    paths; a fresh floor packs narrow again."""
    wide = wire_mode_case(1, 240, 2, 3, 4)
    narrow = wire_mode_case(2, 240, 0, 0, 0)
    floors = {True: {}, False: {}}
    for bars, mask in (wide, narrow):
        encs = {u: tw.encode(bars, mask, use_native=u, floor=f)
                for u, f in floors.items()}
        _assert_wire_bytes(encs[True], encs[False])
        assert encs[True].modes == encs[False].modes == {
            "dclose_mode": 2, "ohl_mode": 3, "vol_mode": 4}
    assert floors[True] == floors[False]
    assert tw.encode(*narrow, use_native=True).modes == {
        "dclose_mode": 0, "ohl_mode": 0, "vol_mode": 0}


@pytest.mark.parametrize("what", ["masked_garbage", "high_price",
                                  "fractional_volume", "boundary_ticks",
                                  "negative_volume", "double_sweep"])
def test_edge_batches_bitwise(rng, what):
    """tests/test_native.py's edge cases: garbage on masked-out lanes,
    a ~1700 CNY ticker, a fractional volume past 2^22, prices near the
    2^22-tick bound, -0.0004 and -0.0 volumes, the > 2e6-tick double
    sweep."""
    cols = synth_day(rng, n_codes=6, missing_prob=0.2)
    g = grid_day(*[cols[k] for k in COLS])
    bars, mask = g.bars[None].copy(), g.mask[None]
    vi = np.argwhere(mask[0])
    if what == "masked_garbage":
        dead = np.argwhere(~mask[0])
        bars[0][tuple(dead[0])] = np.nan
        bars[0][tuple(dead[1])][3] = np.inf
        bars[0][tuple(dead[2])][0] = 12.34567
        assert _encode_all(bars, mask) is not None
    elif what == "high_price":
        hot = np.round(bars[0, 2] * 37.0, 2).astype(np.float32)
        bars[0, 2] = np.where(mask[0, 2, :, None], hot, 0.0)
        _encode_all(bars, mask)
    elif what == "fractional_volume":
        bars[0][tuple(vi[0])][4] = 4194304.5
        assert _encode_all(bars, mask) is None
    elif what in ("boundary_ticks", "double_sweep"):
        t = bars[0, 1]
        top = 41942.0 if what == "boundary_ticks" else 30000.0
        scale = top / np.maximum(t[..., 3:4], 1e-6)
        bars[0, 1, :, :4] = np.where(
            mask[0, 1, :, None], (t[..., :4] * scale).astype(np.float32),
            0.0)
        assert _encode_all(bars, mask) is not None
    else:
        bars[0][tuple(vi[0])][4] = -0.0004
        assert _encode_all(bars, mask) is None
        bars[0][tuple(vi[0])][4] = -0.0
        assert _encode_all(bars, mask) is not None


def _decode(enc):
    """The port's decode of one encoding, on the CPU, as numpy."""
    import torch
    buf, spec = tw.pack_arrays(enc.arrays)
    bars, mask = tw.decode(*tw.unpack(torch.from_numpy(buf), spec))
    return bars.numpy(), mask.numpy()


def test_wire_int4_dclose_mode_pinned():
    """The int4-pair close-delta rung on both encoders: deltas within
    +/-7 pack byte-identically (even slot in the low nibble) and decode to
    the exact tick walk across masked gaps; +/-8 widens to int8."""
    deltas = np.zeros(240, np.int64)
    deltas[1], deltas[2], deltas[3] = 7, -7, 1
    deltas[9], deltas[11], deltas[100] = 5, -3, 2
    mask = np.ones((1, 1, 240), bool)
    mask[0, 0, 4:9] = False
    vol = np.full(240, 500.0, np.float32)
    for widen in (False, True):
        d = deltas.copy()
        if widen:
            d[11] = 8
        ct = 1000 + np.cumsum(d)
        close = (ct * 0.01).astype(np.float32)
        bars = np.stack([close, close, close, close, vol], -1)[None, None]
        floor = {}
        enc = _encode_all(bars, mask, floor=floor)
        if widen:
            assert enc.dclose.dtype == np.int8 and floor["dclose_mode"] == 1
        else:
            assert enc.dclose.shape[-1] == 120
            assert enc.dclose.dtype == np.uint8 and floor == {}
        dec, dmask = _decode(enc)
        np.testing.assert_array_equal(dmask, mask)
        got = np.round(dec[0, 0, :, 3] / 0.01).astype(np.int64)
        np.testing.assert_array_equal(got[mask[0, 0]], ct[mask[0, 0]])


def test_wire_tight_ohl_and_vol10_layout_pinned():
    """Hand-computed bytes of the tight OHL rung (int4 body | 2-bit wicks)
    and of vol10 (four 10-bit values per 5 bytes), then the exact decode."""
    ct = np.full(240, 2000, np.int64)
    dop, h_off, l_off = (np.zeros(240, np.int64) for _ in range(3))
    dop[0] = 3
    dop[1], h_off[1], l_off[1] = -2, 1, 2
    dop[2], h_off[2], l_off[2] = -8, 3, 3
    ot = ct + dop
    ht = np.maximum(ct, ot) + h_off
    lt = np.minimum(ct, ot) - l_off
    vol_lots = np.zeros(240, np.int64)
    vol_lots[:4] = [1, 2, 3, 1023]
    bars = np.stack([ot * 0.01, ht * 0.01, lt * 0.01, ct * 0.01,
                     vol_lots * 100.0], -1).astype(np.float32)[None, None]
    mask = np.ones((1, 1, 240), bool)
    enc = _encode_all(bars, mask)
    assert enc.dohl.shape[-1] == 1 and enc.volume.shape[-1] == 300
    assert enc.vol_scale == 100.0
    np.testing.assert_array_equal(enc.dohl[0, 0, :3, 0], [0x03, 0x9E, 0xF8])
    np.testing.assert_array_equal(enc.volume[0, 0, :5],
                                  [0x01, 0x08, 0x30, 0xC0, 0xFF])
    dec, dmask = _decode(enc)
    np.testing.assert_array_equal(dmask, mask)
    for f, t in enumerate((ot, ht, lt)):
        np.testing.assert_array_equal(
            np.round(dec[0, 0, :, f] / 0.01).astype(np.int64), t)
    np.testing.assert_array_equal(dec[0, 0, :, 4], vol_lots * 100.0)


def test_wire_encode_threaded_matches_single(rng):
    cols = synth_day(rng, n_codes=30, missing_prob=0.1, zero_volume_prob=0.1)
    g = grid_day(*[cols[k] for k in COLS])
    bars, mask = np.stack([g.bars, g.bars]), np.stack([g.mask, g.mask])
    one = tn.wire_encode_native(bars, mask, n_threads=1)
    many = tn.wire_encode_native(bars, mask, n_threads=4)
    ref = jn.wire_encode_native(bars, mask, n_threads=3)
    for a, b, c in zip(one, many, ref):
        np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(a, c)
    bad = bars.copy()
    bad[1, -1, 100, 3] += 0.005
    m2 = mask.copy()
    m2[1, -1, 100] = True
    assert tn.wire_encode_native(bad, m2, n_threads=4) is None


def test_resolution_is_counted_and_native_is_never_faked(rng, monkeypatch):
    cols = synth_day(rng, n_codes=4)
    args = [cols[k] for k in COLS]
    tn.reset_counts()
    g = grid_day(*args)
    grid_day(*args, use_native=False)
    enc = tw.encode(g.bars[None], g.mask[None])
    assert tn.IMPL_COUNTS == {("grid", "auto", "native"): 1,
                              ("grid", "numpy", "numpy"): 1,
                              ("wire", "auto", "native"): 1}
    assert tn.resolved_counts("wire") == {"native": 1}
    # other sessions take the numpy path, and it is counted so
    us = synth_day(rng, n_codes=4, session="us_390")
    ug = grid_day(*[us[k] for k in COLS], session="us_390")
    tw.encode(ug.bars[None], ug.mask[None])
    assert tn.IMPL_COUNTS[("grid", "auto", "numpy")] == 1
    assert tn.IMPL_COUNTS[("wire", "auto", "numpy")] == 1
    # without the library: auto falls back (counted), True raises
    monkeypatch.setattr(tn, "load", lambda: None)
    tn.reset_counts()
    assert _same(tw.encode(g.bars[None], g.mask[None]), enc)
    assert tn.IMPL_COUNTS == {("wire", "auto", "numpy"): 1}
    with pytest.raises(RuntimeError, match="unavailable"):
        tw.encode(g.bars[None], g.mask[None], use_native=True)
    with pytest.raises(RuntimeError, match="unavailable"):
        grid_day(*args, use_native=True)


def _same(a, b):
    return all(np.asarray(x).tobytes() == np.asarray(y).tobytes()
               for x, y in zip(a.arrays, b.arrays))


def test_stale_abi_triggers_one_rebuild(tmp_path, monkeypatch):
    """A library at the build path that reports another ABI version is
    rebuilt from the source once, then loads."""
    src = tn.SOURCE.read_text()
    assert src.count("return 11;") == 1
    stale_src = tmp_path / "stale.cpp"
    stale_src.write_text(src.replace("return 11;", "return 10;"))
    monkeypatch.setattr(tn, "BUILD_DIR", tmp_path / "native")
    path = tn.library_path()
    assert path.parent == tmp_path / "native"
    monkeypatch.setattr(tn, "SOURCE", stale_src)
    assert tn._build(path)
    stale = ctypes.CDLL(str(path))
    stale.grid_pack_abi_version.restype = ctypes.c_int64
    assert stale.grid_pack_abi_version() == 10
    tn._close(stale)
    monkeypatch.undo()
    monkeypatch.setattr(tn, "BUILD_DIR", tmp_path / "native")
    monkeypatch.setattr(tn, "_lib", None)
    monkeypatch.setattr(tn, "_tried", False)
    lib = tn.load()
    # the same path now holds the current source's build
    assert tn.library_path() == path
    assert lib is not None and lib.grid_pack_abi_version() == 11


def test_the_source_is_the_jax_packages_below_its_header():
    port = tn.SOURCE.read_text()
    ref = (tn.SOURCE.parents[2] / "replication_of_minute_frequency_factor_tpu"
           / "native" / "gridpack.cpp").read_text()
    cut = "#include <cmath>"
    assert port[port.index(cut):] == ref[ref.index(cut):]
    assert tn.BUILD_DIR == tn.SOURCE.parents[2] / "build" / "native"
