"""The port's resident year loop on the CPU: ``compute_packed_resident``,
``result_wire.encode_stacked`` and the donation contract.

The same year (``torch_cases.Year``: batches of ``bench.make_batch``'s
recipe, encoded under one shared floor by the copy of
``bench.encode_year``) goes through the JAX package's
``compute_packed_resident`` (its scan executable, rolling ``'conv'``, the
plain reference of the Pallas kernel) and the port's. NaN and inf
positions must be identical and the values within tests/test_parity.py's
comparator; each resident step must be bitwise the port's per-batch
``compute_packed_prepared`` on the same buffer; the result wire's bytes
must be the port's ``encode_block`` of each raw slice; ``encode_stacked``
and the copies of ``make_batch``/``encode_year`` are byte-identical to
theirs.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bench
from replication_of_minute_frequency_factor_tpu import (
    pipeline as jax_pipeline)
from replication_of_minute_frequency_factor_tpu.data import (
    result_wire as jax_rw)
from replication_of_minute_frequency_factor_tpu_torch import config
from replication_of_minute_frequency_factor_tpu_torch import pipeline as pl
from replication_of_minute_frequency_factor_tpu_torch.config import Config
from replication_of_minute_frequency_factor_tpu_torch.data import (
    result_wire as rw)
from replication_of_minute_frequency_factor_tpu_torch.models import (
    factor_names)
from replication_of_minute_frequency_factor_tpu_torch.telemetry import (
    factorplane)
from test_parity import _check_cell
import torch_cases as tc

#: the year: batches x days x tickers
N_BATCHES, DAYS, TICKERS = 3, 2, 32
#: the factors of the side-output and other-session holds: one of each
#: family, the rolling kernel's among them
SOME = ("vol_return1min", "mmt_ols_qrs", "mmt_ols_beta_mean", "liq_openvol",
        "corr_pv", "shape_skew", "doc_pdf80", "trade_top20retRatio",
        "doc_std", "mmt_top20VolumeRet")


def _year(session="cn_ashare_240", kind="wire", seed=5):
    year = tc.Year(seed, N_BATCHES, DAYS, TICKERS, session=session)
    bufs, spec, got = tc.encode_year(year, use_wire=kind == "wire")
    assert got == kind
    return bufs, spec


def _port(bufs):
    """Fresh device-resident (CPU) copies of the host buffers."""
    return [torch.from_numpy(b).clone() for b in bufs]


def _jax(bufs):
    return tuple(jnp.asarray(b) for b in bufs)


def _hold_to_jax(label, names, port, ref):
    """Per factor: NaN and inf positions identical, every value through
    test_parity's comparator with the JAX value in the reference's
    place."""
    failures = []
    for i, name in enumerate(names):
        a, b = port[:, i], ref[:, i]
        if not np.array_equal(np.isnan(a), np.isnan(b)):
            failures.append(f"{label}/{name}: NaN positions differ")
        if not np.array_equal(np.where(np.isinf(a), np.sign(a), 0),
                              np.where(np.isinf(b), np.sign(b), 0)):
            failures.append(f"{label}/{name}: inf positions differ")
        for n in range(a.shape[0]):
            for d in range(a.shape[1]):
                for t in range(a.shape[2]):
                    aux = {k: ref[n, names.index(k), d, t]
                           for k in ("shape_kurt", "shape_kurtVol")
                           if k in names}
                    _check_cell(f"{label}/b{n}/d{d}", name, t,
                                b[n, d, t], a[n, d, t], False, failures,
                                aux, lambda: {})
    assert not failures, "\n".join(failures[:40])


def _bits(x: np.ndarray) -> np.ndarray:
    return np.ascontiguousarray(x).view(np.int32)


@pytest.mark.parametrize("kind", ["wire", "raw"])
@pytest.mark.parametrize("session", ["cn_ashare_240", "us_390"])
def test_resident_matches_jax_resident(kind, session):
    """All 58 factors at cn_ashare_240 (the named set at us_390): the
    port's resident loop against the JAX package's scan executable on the
    same buffers."""
    names = factor_names() if session == "cn_ashare_240" else SOME
    bufs, spec = _year(session, kind)
    port = pl.compute_packed_resident(_port(bufs), spec, kind, names,
                                      session=session, device="cpu")
    ref = np.asarray(jax_pipeline.compute_packed_resident(
        _jax(bufs), spec, kind, names, rolling_impl="conv",
        session=session))
    assert port.shape == ref.shape == (N_BATCHES, len(names), DAYS,
                                       TICKERS)
    assert port.dtype == torch.float32
    _hold_to_jax(f"{session}/{kind}", names, port.numpy(), ref)


@pytest.mark.parametrize("kind", ["wire", "raw"])
def test_each_resident_step_is_the_per_batch_call_bitwise(kind):
    """Step i of the loop is the port's ``compute_packed_prepared`` on
    buffer i, bit for bit (one body, shared by construction)."""
    names = factor_names()
    bufs, spec = _year(kind=kind, seed=11)
    ys = pl.compute_packed_resident(_port(bufs), spec, kind, names,
                                    device="cpu").numpy()
    for i, b in enumerate(bufs):
        one = pl.compute_packed_prepared(b, spec, kind, names,
                                         device="cpu").numpy()
        np.testing.assert_array_equal(_bits(ys[i]), _bits(one))


def test_resident_result_wire_and_stats_match_jax():
    """With ``result_spec`` and ``factor_stats``: each payload slice is the
    port's ``encode_block`` of the raw slice byte for byte and decodes
    within test_parity's comparator of JAX's decoded payload; the stats
    are the port's ``factor_stats_block`` of the raw slice bitwise, and
    JAX's stats' counts exactly, their moments within f32 tolerance."""
    names = factor_names()
    bufs, spec = _year(seed=23)
    rspec = rw.ResultWireSpec.for_names(names, days=DAYS)
    raw = pl.compute_packed_resident(_port(bufs), spec, "wire", names,
                                     device="cpu")
    payload, stats = pl.compute_packed_resident(
        _port(bufs), spec, "wire", names, result_spec=rspec,
        factor_stats=True, device="cpu")
    L = rw.payload_nbytes(len(names), DAYS, TICKERS, rspec.spill_rows)
    assert payload.shape == (N_BATCHES, L) and payload.dtype == torch.uint8
    assert stats.shape == (N_BATCHES, len(names), 9)
    jspec = jax_rw.ResultWireSpec.for_names(names, days=DAYS)
    assert jspec.bounds == rspec.bounds
    jpay, jstats = jax_pipeline.compute_packed_resident(
        _jax(bufs), spec, "wire", names, rolling_impl="conv",
        result_spec=jspec, factor_stats=True)
    jpay, jstats = np.asarray(jpay), np.asarray(jstats)
    assert jpay.shape == tuple(payload.shape)
    dec_port, dec_jax = [], []
    for i in range(N_BATCHES):
        np.testing.assert_array_equal(
            payload[i].numpy(), rw.encode_block(raw[i], rspec).numpy())
        np.testing.assert_array_equal(
            _bits(stats[i].numpy()),
            _bits(factorplane.factor_stats_block(raw[i]).numpy()))
        dec_port.append(rw.decode_block(payload[i].numpy(), len(names),
                                        DAYS, TICKERS, rspec.spill_rows)[0])
        dec_jax.append(jax_rw.decode_block(jpay[i], len(names), DAYS,
                                           TICKERS, jspec.spill_rows)[0])
    _hold_to_jax("result-wire", names, np.stack(dec_port),
                 np.stack(dec_jax))
    st = stats.numpy()
    for col in (0, 1, 2, 3, 4):  # lanes, finite, nan, +inf, -inf
        np.testing.assert_array_equal(st[..., col], jstats[..., col])
    np.testing.assert_allclose(st[..., 5:], jstats[..., 5:], rtol=2e-3,
                               atol=1e-6)


def test_encode_stacked_is_jax_encode_stacked_bytes():
    """``[N, F, D, T]`` f32 with NaN, +-inf, constant and heavy-tailed
    slices: the port's ``encode_stacked`` is JAX's compiled one byte for
    byte (the JAX package runs it inside a jitted graph; its eager vmap
    divides by the step count where the compiled graph multiplies by the
    reciprocal), and each row is ``encode_block`` of its slice."""
    names = ("vol_return1min", "mmt_ols_qrs", "liq_openvol",
             "vol_volume1min")
    rng = np.random.default_rng(3)
    x = rng.standard_normal((3, len(names), 4, 64)).astype(np.float32)
    x[0, 0, 1, 5] = np.nan
    x[1, 1, 2, :] = np.nan
    x[1, 2, 0, 7] = np.inf
    x[2, 3, 3, 9] = -np.inf
    x[2, 0, 2, :] = 1.5
    x[0, 3, 0] = np.exp(rng.uniform(-12, 12, 64)).astype(np.float32)
    spec = rw.ResultWireSpec.for_names(names, days=4)
    got = rw.encode_stacked(torch.from_numpy(x), spec)
    want = np.asarray(jax.jit(jax_rw.encode_stacked, static_argnums=1)(
        jnp.asarray(x), jax_rw.ResultWireSpec.for_names(names, days=4)))
    assert got.dtype == torch.uint8
    np.testing.assert_array_equal(got.numpy(), want)
    for i in range(3):
        np.testing.assert_array_equal(
            got[i].numpy(),
            rw.encode_block(torch.from_numpy(x[i]), spec).numpy())


@pytest.mark.parametrize("session", ["cn_ashare_240", "us_390"])
def test_make_batch_and_encode_year_are_bench_bytes(session):
    """``torch_cases.make_batch``/``encode_year`` are ``bench.py``'s
    byte for byte, and a :class:`torch_cases.Year` made lazily encodes to
    the same buffers as its batches held in a list."""
    for n_days, n_tickers in ((2, 16), (3, 8)):
        a = tc.make_batch(np.random.default_rng(9), n_days, n_tickers,
                          session=session)
        b = bench.make_batch(np.random.default_rng(9), n_days, n_tickers,
                             session=session)
        assert a[0].dtype == b[0].dtype and a[1].dtype == b[1].dtype
        np.testing.assert_array_equal(a[0].view(np.int32),
                                      b[0].view(np.int32))
        np.testing.assert_array_equal(a[1], b[1])
    year = tc.Year(13, 3, 2, 16, session=session)
    held = [year[i] for i in range(len(year))]
    for use_wire in (True, False):
        got = tc.encode_year(year, use_wire)
        want = bench.encode_year(held, use_wire)
        assert got[1] == want[1] and got[2] == want[2]
        assert len(got[0]) == len(want[0]) == 3
        for g, w in zip(got[0], want[0]):
            np.testing.assert_array_equal(g, w)


def test_encode_year_converges_on_one_spec_across_a_widened_batch():
    """A batch that needs wider lanes than the others forces a second
    pass under the widened floor: every buffer then shares one spec, as
    in ``bench.encode_year``."""
    batches = [tc.make_batch(np.random.default_rng(i), 2, 16)
               for i in range(3)]
    bars, mask = batches[2]
    bars[0, 0, :, 4] = np.where(mask[0, 0], 70_000_000.0, 0.0)  # int32 vol
    got = tc.encode_year(batches)
    want = bench.encode_year(batches, True)
    assert got[2] == want[2] == "wire"
    assert got[1] == want[1]
    for g, w in zip(got[0], want[0]):
        np.testing.assert_array_equal(g, w)


# --------------------------------------------------------------------------
# the donation contract
# --------------------------------------------------------------------------


def test_donation_gates_on_config_and_device():
    """Donation needs ``Config.donate_buffers`` (default on) AND the card:
    on the CPU nothing is donated, as in the JAX package."""
    cfg = Config()
    assert cfg.donate_buffers
    assert pl._donate_device_buffers(cfg, torch.device("cpu")) is False
    assert pl._donate_device_buffers(cfg, torch.device("cuda")) is True
    assert pl._donate_device_buffers(cfg, "cuda:0") is True
    cfg.donate_buffers = False
    assert pl._donate_device_buffers(cfg, torch.device("cuda")) is False


def test_buffers_stay_live_on_the_cpu_by_default():
    names = SOME
    bufs, spec = _year(seed=31)
    dbufs = _port(bufs)
    first = pl.compute_packed_resident(dbufs, spec, "wire", names,
                                       device="cpu")
    assert all(type(b) is torch.Tensor for b in dbufs)
    for b, h in zip(dbufs, bufs):
        np.testing.assert_array_equal(b.numpy(), h)
    again = pl.compute_packed_resident(dbufs, spec, "wire", names,
                                       device="cpu")
    np.testing.assert_array_equal(_bits(first.numpy()), _bits(again.numpy()))


def _donating(monkeypatch):
    monkeypatch.setattr(pl, "_donate_device_buffers", lambda *a, **k: True)


def test_donated_buffers_are_released_and_dead_after_the_call(monkeypatch):
    """With donation on, every buffer's storage is released and any use of
    the handle raises ``DonatedBufferError``; the result is the same
    bits as without donation."""
    names = SOME
    bufs, spec = _year(seed=37)
    keep = pl.compute_packed_resident(_port(bufs), spec, "wire", names,
                                      device="cpu")
    _donating(monkeypatch)
    dbufs = _port(bufs)
    storages = [b.untyped_storage() for b in dbufs]
    got = pl.compute_packed_resident(dbufs, spec, "wire", names,
                                     device="cpu")
    np.testing.assert_array_equal(_bits(got.numpy()), _bits(keep.numpy()))
    assert all(s.nbytes() == 0 for s in storages)
    for b in dbufs:
        with pytest.raises(pl.DonatedBufferError, match="donated"):
            b + 1
        with pytest.raises(pl.DonatedBufferError):
            b.shape
    with pytest.raises(pl.DonatedBufferError):
        pl.compute_packed_resident(dbufs, spec, "wire", names, device="cpu")
    with pytest.raises(pl.DonatedBufferError):
        pl.compute_packed_prepared(dbufs[0], spec, "wire", names,
                                   device="cpu")


def test_debug_validate_names_the_donation_contract(monkeypatch):
    _donating(monkeypatch)
    monkeypatch.setattr(config, "_config", Config(debug_validate=True))
    names = ("vol_return1min",)
    bufs, spec = _year(seed=41)
    dbufs = _port(bufs)
    pl.compute_packed_resident(dbufs, spec, "wire", names, device="cpu")
    with pytest.raises(pl.DonatedBufferError,
                       match=r"argument 0 is a dead buffer.*donate_buffers"):
        pl.compute_packed_resident(dbufs, spec, "wire", names, device="cpu")


def test_a_buffer_that_cannot_be_released_is_refused_before_any_step(
        monkeypatch):
    """A numpy-backed tensor's storage cannot be freed: donating it is
    refused up front, with nothing run and the buffer intact."""
    _donating(monkeypatch)
    bufs, spec = _year(seed=43)
    dbufs = [torch.from_numpy(b) for b in bufs]
    with pytest.raises(ValueError, match="cannot be released"):
        pl.compute_packed_resident(dbufs, spec, "wire", ("vol_return1min",),
                                   device="cpu")
    assert all(type(b) is torch.Tensor for b in dbufs)


# --------------------------------------------------------------------------
# arguments
# --------------------------------------------------------------------------


def test_resident_refuses_buffers_it_cannot_run():
    bufs, spec = _year(seed=47)
    names = ("vol_return1min",)
    with pytest.raises(ValueError, match="at least one"):
        pl.compute_packed_resident([], spec, "wire", names, device="cpu")
    with pytest.raises(ValueError, match="kind"):
        pl.compute_packed_resident(_port(bufs), spec, "bars", names,
                                   device="cpu")
    with pytest.raises(TypeError, match="device-resident"):
        pl.compute_packed_resident(bufs, spec, "wire", names, device="cpu")
    short = _port(bufs)
    short[1] = short[1][:-4].clone()
    with pytest.raises(ValueError, match="one shared floor"):
        pl.compute_packed_resident(short, spec, "wire", names, device="cpu")
    wide = _port(bufs)
    wide[0] = wide[0].view(torch.int32)
    with pytest.raises(ValueError, match="1-D uint8"):
        pl.compute_packed_resident(wide, spec, "wire", names, device="cpu")


def test_resident_refuses_the_cpu_unless_asked(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    bufs, spec = _year(seed=53)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        pl.compute_packed_resident(_port(bufs), spec, "wire",
                                   ("vol_return1min",))
