"""The port's ingest wire and packed path vs the JAX package's.

The host half must write the JAX package's bytes exactly: the port's numpy
encoder against the JAX package's numpy path (``use_native=False``) and its
default (the C++ encoder where it builds, at 240 slots). The device half
must give the JAX package's bars bit for bit: ``decode`` on every rung of
every ladder (3 close-delta, 4 OHL and 5 volume modes), at 240, 390 (mask
pad bits, u16 volume), 150 and 1440 slots, and with the sticky ``floor``.
Batches are crafted to reach each rung (``torch_cases.wire_mode_case``:
lot volumes, volumes <= 1023, deltas past 7 and past 127).
``compute_packed`` on the CPU must equal ``compute_batch`` on the same
decoded bars.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from replication_of_minute_frequency_factor_tpu.data import wire as jw
from replication_of_minute_frequency_factor_tpu_torch import (
    compute_batch, compute_packed)
from replication_of_minute_frequency_factor_tpu_torch import data as tdata
from replication_of_minute_frequency_factor_tpu_torch import native as tn
from replication_of_minute_frequency_factor_tpu_torch.data import wire as tw
from replication_of_minute_frequency_factor_tpu_torch.models import (
    factor_names)
from replication_of_minute_frequency_factor_tpu_torch.pipeline import (
    compute_packed_prepared)
from torch_cases import WIRE_MODE_CASES, expected_wire_modes, wire_mode_case

SLOTS = (240, 390, 150, 1440)


def _same_bytes(port, ref):
    """Two encodings (or ``arrays`` tuples) are the same bytes, dtypes and
    shapes."""
    if port is None or ref is None:
        return port is None and ref is None
    a, b = port.arrays, ref.arrays
    return len(a) == len(b) and all(
        np.asarray(x).dtype == np.asarray(y).dtype
        and np.shape(x) == np.shape(y)
        and np.atleast_1d(x).tobytes() == np.atleast_1d(y).tobytes()
        for x, y in zip(a, b))


def _decode_both(enc):
    """The port's decode (CPU tensors) and the JAX package's, of one
    encoding, each through its own pack/unpack."""
    buf, spec = tw.pack_arrays(enc.arrays)
    jbuf, jspec = jw.pack_arrays(enc.arrays)
    assert buf.tobytes() == jbuf.tobytes() and spec == jspec
    got = tw.decode(*tw.unpack(torch.from_numpy(buf), spec))
    want = jw.decode(*jw.unpack(jnp.asarray(jbuf), jspec))
    return [t.numpy() for t in got], [np.asarray(a) for a in want]


def _assert_decode_bitwise(enc, mask):
    (bars, m), (jbars, jm) = _decode_both(enc)
    assert bars.dtype == jbars.dtype == np.float32
    np.testing.assert_array_equal(bars.view(np.int32), jbars.view(np.int32))
    np.testing.assert_array_equal(m, jm)
    np.testing.assert_array_equal(m, mask)
    return bars


@pytest.mark.parametrize("n_slots", SLOTS)
@pytest.mark.parametrize("case", WIRE_MODE_CASES)
def test_every_mode_encodes_and_decodes_as_jax(n_slots, case):
    bars, mask = wire_mode_case(sum(case) * 31 + n_slots, n_slots, *case)
    enc = tw.encode(bars, mask)
    assert enc.modes == expected_wire_modes(n_slots, *case)
    assert _same_bytes(enc, jw.encode(bars, mask, use_native=False))
    assert _same_bytes(enc, jw.encode(bars, mask))
    dec = _assert_decode_bitwise(enc, mask)
    # the decode is the bars, up to the reciprocal-multiply price wobble
    np.testing.assert_allclose(dec, bars, rtol=2 * np.finfo(np.float32).eps)
    np.testing.assert_array_equal(dec[..., 4], bars[..., 4])


def _synth(session, seed, n_codes=12, n_days=2, **kw):
    rng = np.random.default_rng(seed)
    days = [tdata.synth_day(rng, n_codes=n_codes, session=session,
                            date=f"2024-01-{2 + d:02d}", **kw)
            for d in range(n_days)]
    codes = np.unique(np.concatenate([d["code"] for d in days]))
    grids = [tdata.grid_day(d["code"], d["time"], d["open"], d["high"],
                            d["low"], d["close"], d["volume"], codes=codes,
                            session=session) for d in days]
    return (np.stack([g.bars for g in grids]),
            np.stack([g.mask for g in grids]))


@pytest.mark.parametrize("session", ["cn_ashare_240", "us_390",
                                     "hk_halfday", "crypto_1440"])
def test_synthetic_batches_encode_and_decode_as_jax(session):
    bars, mask = _synth(session, 5, missing_prob=0.1, zero_volume_prob=0.05)
    enc = tw.encode(bars, mask)
    assert _same_bytes(enc, jw.encode(bars, mask, use_native=False))
    assert _same_bytes(enc, jw.encode(bars, mask))
    assert enc.maskbits.shape[-1] == tw.mask_bytes(mask.shape[-1])
    _assert_decode_bitwise(enc, mask)


def test_us390_mask_pad_bits_and_u16_volume():
    """390 % 8 != 0: the mask ships 49 bytes and decode drops the 2 pad
    bits; 390 % 4 != 0: small volumes widen to u16, not vol10."""
    bars, mask = wire_mode_case(390, 390, 0, 0, 0)
    assert mask[..., -2:].any() and not mask[..., -2:].all()
    enc = tw.encode(bars, mask)
    assert enc.maskbits.shape[-1] == 49 and enc.volume.dtype == np.uint16
    assert enc.modes["vol_mode"] == 2
    _assert_decode_bitwise(enc, mask)


def test_sticky_floor_matches_jax():
    """A floor dict threaded through a run only ever widens: a narrow
    batch after a wide one packs wide, on both sides."""
    wide = wire_mode_case(1, 240, 2, 3, 4)
    narrow = wire_mode_case(2, 240, 0, 0, 0)
    floor, jfloor = {}, {}
    for bars, mask in (wide, narrow):
        enc = tw.encode(bars, mask, floor=floor)
        assert _same_bytes(enc, jw.encode(bars, mask, use_native=False,
                                          floor=jfloor))
        assert enc.modes == {"dclose_mode": 2, "ohl_mode": 3,
                             "vol_mode": 4}
        _assert_decode_bitwise(enc, mask)
    assert floor == jfloor == {"dclose_mode": 2, "ohl_mode": 3,
                               "vol_mode": 4}
    assert tw.encode(*narrow).modes == {"dclose_mode": 0, "ohl_mode": 0,
                                        "vol_mode": 0}


@pytest.mark.parametrize("what", ["off_tick", "fractional_volume",
                                  "negative_volume"])
def test_unrepresentable_batches_are_refused_as_jax(what):
    bars, mask = wire_mode_case(3, 240, 1, 1, 4)
    i = np.nonzero(mask)
    lane = tuple(a[0] for a in i)
    if what == "off_tick":
        bars[lane + (3,)] += np.float32(0.003)
    elif what == "fractional_volume":
        bars[lane + (4,)] = 1000.5
    else:
        bars[lane + (4,)] = -100.0
    assert tw.encode(bars, mask) is None
    assert jw.encode(bars, mask, use_native=False) is None


def test_native_copies_are_the_jax_packages():
    """The ladders and packers the port copied, on the same inputs."""
    from replication_of_minute_frequency_factor_tpu import native as jn

    for name in ("DCLOSE_SHAPES", "OHL_SHAPES", "VOL_SHAPES",
                 "VOL_LOT_MODES"):
        assert getattr(tn, name) == getattr(jn, name)
    rng = np.random.default_rng(0)
    dohl = np.stack([rng.integers(-8, 8, (4, 240)),
                     rng.integers(0, 4, (4, 240)),
                     rng.integers(-4, 0, (4, 240))], -1).astype(np.int16)
    dohl[..., 1] += np.maximum(dohl[..., 0], 0)
    dohl[..., 2] += np.minimum(dohl[..., 0], 0)
    dclose = rng.integers(-7, 8, (4, 240)).astype(np.int16)
    vol = rng.integers(0, 1024, (4, 240))
    for fn, arg in (("pack_wick", dohl), ("pack_tight", dohl),
                    ("pack_dclose4", dclose), ("pack_vol10", vol)):
        np.testing.assert_array_equal(getattr(tn, fn)(arg),
                                      getattr(jn, fn)(arg))


def test_unpack_inverts_pack_arrays():
    rng = np.random.default_rng(1)
    arrays = (rng.random((3, 5)).astype(np.float32),
              rng.integers(-128, 128, (7,)).astype(np.int8),
              rng.integers(0, 65536, (2, 3)).astype(np.uint16),
              rng.integers(-2**31, 2**31 - 1, (5,)).astype(np.int32),
              rng.integers(0, 256, (1, 3, 1)).astype(np.uint8),
              rng.integers(-2**15, 2**15, (3,)).astype(np.int16),
              np.float32(100.0))
    buf, spec = tw.pack_arrays(arrays)
    assert buf.dtype == np.uint8 and all(off % 4 == 0 for _, _, off in spec)
    out = tw.unpack(torch.from_numpy(buf), spec)
    for a, t in zip(arrays, out):
        assert tuple(t.shape) == np.shape(a)
        if a.dtype == np.uint16:  # compared through its int16 bits
            t = t.view(torch.int16)
            a = a.view(np.int16)
        np.testing.assert_array_equal(t.numpy(), a)


@pytest.mark.parametrize("session", ["cn_ashare_240", "us_390"])
def test_compute_packed_equals_compute_batch(session):
    bars, mask = _synth(session, 9, n_codes=8, missing_prob=0.05,
                        zero_volume_prob=0.05, short_day_codes=2)
    enc = tw.encode(bars, mask)
    buf, spec = tw.pack_arrays(enc.arrays)
    dec_bars, dec_mask = tw.decode(*tw.unpack(torch.from_numpy(buf), spec))
    got = compute_packed(enc.arrays, "wire", session=session, device="cpu")
    want = compute_batch(dec_bars, dec_mask, session=session, device="cpu")
    assert got.shape == (58, 2, 8)
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))
    raw = compute_packed((bars, mask.astype(np.uint8)), "raw",
                         session=session, device="cpu")
    want = compute_batch(bars, mask, session=session, device="cpu")
    assert torch.equal(raw.view(torch.int32), want.view(torch.int32))
    names = ("doc_pdf60", "mmt_ols_qrs")
    some = compute_packed_prepared(buf, spec, "wire", names=names,
                                   session=session, device="cpu")
    pick = got[[factor_names().index(n) for n in names]]
    assert torch.equal(some.view(torch.int32), pick.view(torch.int32))


def test_compute_packed_refuses_what_is_not_ported():
    """The result wire and the stats sketch are ported (held in
    tests/test_torch_result_wire.py); what the packed path still refuses
    is an unknown kind and a result spec pinned for another factor
    list."""
    from replication_of_minute_frequency_factor_tpu_torch.data import (
        result_wire as rw)

    bars, mask = wire_mode_case(4, 240, 1, 1, 1)
    arrays = tw.encode(bars, mask).arrays
    names = ("mmt_am", "vol_return1min")
    with pytest.raises(ValueError, match="spec pins 1 factors"):
        compute_packed(arrays, "wire", names,
                       result_spec=rw.ResultWireSpec.for_names(names[:1]),
                       device="cpu")
    payload, stats = compute_packed(
        arrays, "wire", names, factor_stats=True, device="cpu",
        result_spec=rw.ResultWireSpec.for_names(names, days=2))
    assert payload.dtype == torch.uint8 and stats.shape == (2, 9)
    with pytest.raises(ValueError, match="kind"):
        compute_packed(arrays, "bars", device="cpu")
