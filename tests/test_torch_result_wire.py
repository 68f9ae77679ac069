"""The port's result wire and factor-stats sketch against the JAX
package's, on the CPU.

* The payload layout is ``wire.pack_arrays``' (the port's packer).
* ``encode_block`` is byte-identical to JAX ``jax.jit(encode_block)`` on
  seeded ``[F, D, T]`` blocks (NaN, +/-inf, constant, offset-dominated,
  heavy-tailed and volume-scaled slices). Byte identity needs the forms
  XLA runs: the step ``rng * f32(1/65534)`` (XLA turns the division by the
  constant into that product; eager division differs), round half to
  even, the clip before the int16 cast, the round trip as separate ops
  (no FMA), an int32 cumsum for the spill row, and a discard row where
  JAX's scatter drops.
* The widen paths of tests/test_result_wire.py: inf, strict pin,
  overflow -> ``ResultWireOverflow`` -> ``grow``.
* The copied host decode and the MFW1 frames against the JAX ones, both
  directions.
* The packed path's side outputs against JAX ``compute_packed`` on the
  same arrays, and unchanged exposures with and without them.
* ``factor_stats_block``: counts, min and max bitwise against JAX's; mean
  and std within rtol :data:`MOMENT_RTOL` (both sum f32 lanes, in
  different orders).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from replication_of_minute_frequency_factor_tpu import pipeline as jpl
from replication_of_minute_frequency_factor_tpu.data import (
    result_wire as jrw)
from replication_of_minute_frequency_factor_tpu.data import wire as jwire
from replication_of_minute_frequency_factor_tpu.telemetry import (
    Telemetry as JaxTelemetry)
from replication_of_minute_frequency_factor_tpu.telemetry.factorplane import (
    factor_stats_block as jax_stats)
from replication_of_minute_frequency_factor_tpu_torch import (
    compute_packed, wire)
from replication_of_minute_frequency_factor_tpu_torch.data import (
    result_wire as rw)
from replication_of_minute_frequency_factor_tpu_torch.models import (
    factor_names)
from replication_of_minute_frequency_factor_tpu_torch.telemetry import (
    Telemetry)
from replication_of_minute_frequency_factor_tpu_torch.telemetry import (
    factorplane as fp)
from torch_cases import same_bits, stream_day

NAMES = ("vol_return1min", "mmt_am", "liq_amihud_1min",
         "vol_volume1min", "corr_pv", "doc_pdf60")
#: the packed-path hold's factors: one per family, strict pins included
PACKED_NAMES = ("mmt_am", "mmt_ols_qrs", "vol_volume1min", "vol_upVol",
                "shape_skewVol", "liq_amihud_1min", "liq_openvol",
                "corr_pv", "doc_pdf60", "trade_headRatio")
#: relative tolerance of the sketch's f32 mean/std against another
#: reduction order
MOMENT_RTOL = 1e-5


def _block(rng, f=len(NAMES), d=3, t=64):
    """tests/test_result_wire.py's block: NaN lanes, a volume-scaled
    factor, a constant slice."""
    x = rng.standard_normal((f, d, t)).astype(np.float32)
    x[0, 0, :5] = np.nan
    x[3] = np.abs(x[3]) * 1e6
    x[4, 2, :] = 2.5
    return x


def _hard_block(seed, f=58, d=3, t=37):
    """Slices across many decades, some offset-dominated, 5% NaN, one
    +inf and one -inf lane."""
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal((f, d, t))
         * 10.0 ** rng.integers(-4, 6, (f, d, 1))).astype(np.float32)
    x += ((10.0 ** rng.integers(-3, 8, (f, d, 1)))
          * (rng.random((f, d, 1)) < 0.3)).astype(np.float32)
    x[rng.random(x.shape) < 0.05] = np.nan
    x[0, 0, 3] = np.inf
    x[1, -1, 0] = -np.inf
    x[2, -1] = 7.25
    return x


def _jax_encode(x, spec):
    enc = jax.jit(jrw.encode_block, static_argnums=1)
    return np.asarray(enc(jnp.asarray(x), spec))


def _encode(x, spec):
    return rw.encode_block(torch.from_numpy(x), spec).numpy()


def _specs(names, days, spill_rows=None):
    return (rw.ResultWireSpec.for_names(names, spill_rows, days=days),
            jrw.ResultWireSpec.for_names(names, spill_rows, days=days))


@pytest.mark.parametrize("f,d,t,s", [(5, 3, 17, 4), (58, 8, 5000, 10),
                                     (1, 1, 1, 4), (3, 2, 6, 0)])
def test_payload_spec_matches_pack_arrays(f, d, t, s):
    zeros = [np.zeros(shape, dt)
             for dt, shape in rw.payload_arrays_shapes(f, d, t, s)]
    buf, spec = wire.pack_arrays(zeros)
    assert spec == rw.payload_spec(f, d, t, s) == jrw.payload_spec(f, d, t, s)
    assert len(buf) == rw.payload_nbytes(f, d, t, s) \
        == jrw.payload_nbytes(f, d, t, s)


def test_specs_and_bounds_equal_jax():
    names = factor_names()
    for days in (1, 8):
        a, b = _specs(names, days)
        assert a.bounds == b.bounds and a.spill_rows == b.spill_rows
    assert rw.RESULT_BOUNDS == jrw.RESULT_BOUNDS
    assert (rw.Q_NAN, rw.Q_LIM, rw.Q_STEPS) == (jrw.Q_NAN, jrw.Q_LIM,
                                                jrw.Q_STEPS)
    assert a.grow(100).spill_rows == b.grow(100).spill_rows == 125


@pytest.mark.parametrize("seed", range(8))
def test_encode_block_is_byte_identical_to_jax(seed):
    names = factor_names()
    x = _hard_block(seed)
    spec, jspec = _specs(names, x.shape[1])
    got, want = _encode(x, spec), _jax_encode(x, jspec)
    assert got.dtype == np.uint8 and got.shape == want.shape
    assert np.array_equal(got, want)


def test_encode_block_small_blocks_byte_identical_to_jax():
    rng = np.random.default_rng(0)
    x = _block(rng)
    for spill in (None, 0, 2):
        spec, jspec = _specs(NAMES, 3, spill)
        assert np.array_equal(_encode(x, spec), _jax_encode(x, jspec))


def test_step_is_the_product_xla_runs_not_the_division():
    """XLA compiles ``rng / f32(65534)`` to ``rng * f32(1/65534)``; the two
    differ by an ulp on some ranges, which would move every lane of the
    slice. The port computes the product."""
    rng = np.random.default_rng(1)
    r = (rng.random(20000, dtype=np.float32)
         * 10.0 ** rng.integers(-6, 6, 20000)).astype(np.float32)
    jit_div = np.asarray(jax.jit(lambda v: v / jnp.float32(rw.Q_STEPS))(
        jnp.asarray(r)))
    prod = r * (np.float32(1) / np.float32(rw.Q_STEPS))
    div = r / np.float32(rw.Q_STEPS)
    assert np.array_equal(jit_div, prod)
    assert not np.array_equal(div, prod)


def test_round_is_half_to_even_and_clip_precedes_the_cast():
    v = np.array([-2.5, -1.5, -0.5, 0.5, 1.5, 2.5, 3.5, 40000.0, -40000.0,
                  np.nan], np.float32)
    got = torch.round(torch.from_numpy(v)).numpy()
    np.testing.assert_array_equal(got, np.asarray(jnp.round(v)))
    x = np.zeros((1, 1, 4), np.float32)
    x[0, 0] = [0.0, 1.0, 2.0, np.nan]
    out, _ = rw.decode_block(_encode(x, rw.ResultWireSpec(((0.0, 1e-5,
                                                            False),), 4)),
                             1, 1, 4, 4, telemetry=Telemetry())
    np.testing.assert_array_equal(out, x)


def test_round_trip_parity_and_nan_status():
    x = _block(np.random.default_rng(0))
    spec = rw.ResultWireSpec.for_names(NAMES, days=3)
    out, v = rw.decode_block(_encode(x, spec), *x.shape, spec.spill_rows,
                             telemetry=Telemetry())
    assert np.array_equal(np.isnan(out), np.isnan(x))
    assert rw.check_bounds(x, out, NAMES, sidx=v["sidx"])["ok"]
    assert np.array_equal(out[4, 2], x[4, 2])
    assert v["quantized"] + v["widened"] == x.shape[0] * x.shape[1]


def test_inf_widens_and_offset_dominated_meets_contract():
    rng = np.random.default_rng(0)
    x = _block(rng)
    x[1, 0, 7] = np.inf
    x[1, 1] = (1e5 + rng.standard_normal(x.shape[-1])).astype(np.float32)
    x[2, 2] = (1e4 + rng.standard_normal(x.shape[-1]) * 100.0) \
        .astype(np.float32)
    spec, jspec = _specs(NAMES, 3)
    buf = _encode(x, spec)
    assert np.array_equal(buf, _jax_encode(x, jspec))
    out, v = rw.decode_block(buf, *x.shape, spec.spill_rows,
                             telemetry=Telemetry())
    assert v["sidx"][1, 0] >= 0 and np.array_equal(out[1, 0], x[1, 0])
    assert rw.check_bounds(x, out, NAMES, sidx=v["sidx"])["ok"]


def test_strict_pin_widens_heavy_tailed_slice():
    x = _block(np.random.default_rng(0))
    x[3, 1] = np.abs(x[3, 1]) * 1e6
    x[3, 1, 5] = 1e-4
    x[3, 1, 6] = 2e-4
    spec, jspec = _specs(NAMES, 3)
    buf = _encode(x, spec)
    assert np.array_equal(buf, _jax_encode(x, jspec))
    out, v = rw.decode_block(buf, *x.shape, spec.spill_rows,
                             telemetry=Telemetry(), names=NAMES)
    assert v["sidx"][3, 1] >= 0
    assert np.array_equal(out[3, 1], x[3, 1])
    assert v["widened_by_factor"]["vol_volume1min"] >= 1


def test_overflow_marks_strict_raises_and_floor_grows():
    x = _block(np.random.default_rng(0))
    x[:, :, 7] = np.inf
    bounds = tuple(rw.factor_bounds(n) for n in NAMES)
    spec = rw.ResultWireSpec(bounds=bounds, spill_rows=2)
    buf = _encode(x, spec)
    assert np.array_equal(buf, _jax_encode(
        x, jrw.ResultWireSpec(bounds=bounds, spill_rows=2)))
    tel = Telemetry()
    out, v = rw.decode_block(buf, *x.shape, spec.spill_rows, strict=False,
                             telemetry=tel)
    assert v["overflow"] == x.shape[0] * x.shape[1] - 2
    assert tel.registry.counter_value("result.overflow_slices") == \
        v["overflow"]
    with pytest.raises(rw.ResultWireOverflow):
        rw.decode_block(buf, *x.shape, spec.spill_rows, telemetry=tel)
    grown = spec.grow(v["widened"] + v["overflow"])
    assert grown.spill_rows >= x.shape[0] * x.shape[1]
    out2, v2 = rw.decode_block(_encode(x, grown), *x.shape,
                               grown.spill_rows, telemetry=tel)
    assert v2["overflow"] == 0
    assert np.array_equal(out2, x, equal_nan=True)
    assert grown.grow(1).spill_rows == grown.spill_rows


@pytest.mark.parametrize("seed", (0, 3))
def test_decode_matches_jax_both_directions(seed):
    """The copied host decode gives the JAX decode's bits and verdict on
    either package's payload."""
    names = factor_names()
    x = _hard_block(seed)
    spec, jspec = _specs(names, x.shape[1])
    for buf in (_encode(x, spec), _jax_encode(x, jspec)):
        a, va = rw.decode_block(buf, *x.shape, spec.spill_rows,
                                strict=False, telemetry=Telemetry(),
                                names=names)
        b, vb = jrw.decode_block(buf, *x.shape, spec.spill_rows,
                                 strict=False, telemetry=JaxTelemetry(),
                                 names=names)
        assert va["overflow"] > 0       # the overflow marks decode alike
        assert np.array_equal(a, b, equal_nan=True)
        sidx = va.pop("sidx")
        assert np.array_equal(sidx, vb.pop("sidx"))
        assert va == vb
        assert rw.check_bounds(x, a, names, sidx=sidx) == \
            jrw.check_bounds(x, b, names, sidx=sidx)
        with pytest.raises(rw.ResultWireOverflow):
            rw.decode_block(buf, *x.shape, spec.spill_rows,
                            telemetry=Telemetry())


def test_frames_cross_between_the_packages():
    names = factor_names()
    x = _hard_block(5, d=2)
    spec, _ = _specs(names, 2)
    payload = _encode(x, spec)
    geo = dict(n_factors=len(names), days=2, tickers=x.shape[-1],
               spill_rows=spec.spill_rows)
    ours = rw.pack_frame(payload, start=3, end=5, **geo)
    theirs = jrw.pack_frame(payload, start=3, end=5, **geo)
    assert ours == theirs
    stream = ours + rw.pack_frame(payload, start=-1, end=-1, **geo)
    for unpack in (rw.iter_frames, jrw.iter_frames):
        frames = list(unpack(stream))
        assert [m["start"] for m, _ in frames] == [3, -1]
        for _, p in frames:
            assert np.array_equal(p, payload)
    meta, p, nxt = jrw.unpack_frame(ours)
    assert nxt == len(ours) and meta == rw.unpack_frame(theirs)[0]
    for bad in (ours[:-1], b"XXXX" + ours[4:], ours + b"\0"):
        with pytest.raises(ValueError):
            list(rw.iter_frames(bad))
        with pytest.raises(ValueError):
            list(jrw.iter_frames(bad))
    with pytest.raises(ValueError, match="packs to"):
        rw.pack_frame(payload[:-4], **geo)


# --------------------------------------------------------------------------
# the packed path's side outputs
# --------------------------------------------------------------------------


def _packed_case():
    bars, mask = stream_day(31, 16)
    bars = np.where(mask[..., None], bars, 0.0).astype(np.float32)
    return bars[None], mask[None]


@pytest.mark.parametrize("kind", ["wire", "raw"])
def test_packed_side_outputs_match_jax(kind):
    """``compute_packed(..., result_spec=, factor_stats=True)``: the
    payload is the port's own encode of its raw block (so, by the test
    above, what JAX would make of the same block); the raw block is the
    same with and without the side outputs; against JAX ``compute_packed``
    on the same arrays the widen dispositions (sidx) are identical, the
    decodes have the same NaN status and agree within the quantization
    step plus test_parity's tolerance, and the stats' counts are
    identical."""
    bars, mask = _packed_case()
    names = PACKED_NAMES
    if kind == "wire":
        arrays = wire.encode(bars, mask, use_native=False).arrays
        jarrays = jwire.encode(bars, mask, use_native=False).arrays
        for a, b in zip(arrays, jarrays):
            assert np.array_equal(np.asarray(a), np.asarray(b))
    else:
        arrays = jarrays = (bars, mask.astype(np.uint8))
    spec, jspec = _specs(names, 1)
    raw = compute_packed(arrays, kind, names, device="cpu")
    payload, stats = compute_packed(arrays, kind, names, result_spec=spec,
                                    factor_stats=True, device="cpu")
    raw2, stats2 = compute_packed(arrays, kind, names, factor_stats=True,
                                  device="cpu")
    assert same_bits(raw2, raw)
    assert torch.equal(stats2, stats)
    assert torch.equal(payload, rw.encode_block(raw, spec))
    jpayload, jstats = jpl.compute_packed(jarrays, kind, names,
                                          rolling_impl="conv",
                                          result_spec=jspec,
                                          factor_stats=True)
    shape = (len(names), 1, bars.shape[1])
    dec, v = rw.decode_block(payload.numpy(), *shape, spec.spill_rows,
                             telemetry=Telemetry())
    jdec, jv = rw.decode_block(np.asarray(jpayload), *shape,
                               spec.spill_rows, telemetry=Telemetry())
    assert np.array_equal(v["sidx"], jv["sidx"])
    assert np.array_equal(np.isnan(dec), np.isnan(jdec))
    assert rw.check_bounds(raw.numpy(), dec, names, sidx=v["sidx"])["ok"]
    jstats = np.asarray(jstats)
    np.testing.assert_array_equal(stats.numpy()[:, :5], jstats[:, :5])
    fin = np.isfinite(dec)
    step = np.abs(jdec[fin]) * 4e-3 + 1e-4 * np.abs(jdec[fin]).max()
    assert (np.abs(dec[fin] - jdec[fin]) <= step).all()


def test_packed_stats_take_the_logical_tickers():
    bars, mask = _packed_case()
    arrays = (bars, mask.astype(np.uint8))
    raw, stats = compute_packed(arrays, "raw", PACKED_NAMES,
                                factor_stats=10, device="cpu")
    want = fp.factor_stats_host(raw.numpy()[..., :10])
    assert stats.shape == (len(PACKED_NAMES), fp.N_STATS)
    np.testing.assert_array_equal(stats.numpy()[:, :5], want[:, :5])
    np.testing.assert_array_equal(stats.numpy()[:, 7:], want[:, 7:])
    assert float(stats[0, 0]) == 10.0


# --------------------------------------------------------------------------
# the factor-stats sketch
# --------------------------------------------------------------------------


def _stats_block(seed):
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal((9, 4, 33)) * 10.0 ** rng.integers(
        -3, 5, (9, 1, 1))).astype(np.float32)
    x[rng.random(x.shape) < 0.1] = np.nan
    x[0, 0, 0], x[0, 1, 1], x[1, 0, 2] = np.inf, -np.inf, np.inf
    x[2] = np.nan                      # a factor with no finite lane
    x[3] = 4.5                         # constant
    return x


@pytest.mark.parametrize("seed", (0, 1, 2))
def test_factor_stats_block_matches_jax(seed):
    x = _stats_block(seed)
    got = fp.factor_stats_block(torch.from_numpy(x)).numpy()
    want = np.asarray(jax.jit(jax_stats)(jnp.asarray(x)))
    host = fp.factor_stats_host(x)
    assert got.shape == want.shape == (9, fp.N_STATS)
    assert fp.STAT_FIELDS == ("lanes", "finite", "nan", "posinf", "neginf",
                              "mean", "std", "min", "max")
    for col in (0, 1, 2, 3, 4, 7, 8):
        np.testing.assert_array_equal(got[:, col], want[:, col])
        np.testing.assert_array_equal(got[:, col], host[:, col])
    for ref in (want, host):
        np.testing.assert_allclose(got[:, 5:7], ref[:, 5:7],
                                   rtol=MOMENT_RTOL, atol=0)
    assert np.isnan(got[2, 5:]).all()
    assert got[3, 6] == 0.0 and got[3, 5] == 4.5
