"""The port's 58 factors vs the JAX package's, per factor, through the
batch entry point.

``compute_batch(..., device='cpu')`` against JAX ``compute_factors_jit``
with ``rolling_impl='pallas_interpret'`` (the Pallas kernel on the
interpreter) and ``'conv'``, on two-day batches of ten tickers drawn with
the pathologies tests/test_parity.py draws: clean, ragged, zero-volume,
constant-price, short (< 50 bar) days, fuzz seed 739 (two windows with
exactly-equal betas), and one batch each at ``us_390``, ``hk_halfday`` and
``crypto_1440``. ``replicate_quirks=False`` is held across all 58 on the
seven ``cn_ashare_240``/``us_390`` scenarios (``doc_vol50_ratio`` reaches
``topk_sum`` at k = 50 there).

NaN and inf positions must be exactly equal. Values are held by
tests/test_parity.py's own comparator (``_check``: its RTOL/ATOL/
RTOL_OVERRIDE tables, its noise floor on the scenarios it calls noisy,
its degenerate-kurtosis skip of the skew/kurt ratios) with the JAX value
in the reference's place. ``doc_pdf*`` goes through test_parity's
``_check_cell``: a rank off the JAX one by more than its slack passes only
if it is one of the day's acceptance set (``_doc_pdf_acceptable``: the
f64 oracle's walk at the threshold and at threshold +/- PDF_EDGE_EPS, over
f64, f32-quantised and device returns). The beta z-score pair (``mmt_ols_qrs``,
``mmt_ols_beta_zscore_last``) skips the codes whose f64 beta z numerator
is sub-noise, and widens rtol just above that cutoff, exactly as
tests/test_parity.py:98-122 does (``_degenerate_beta_codes``).
"""

import jax.numpy as jnp
import numpy as np
import pandas as pd
import pytest
import torch

from replication_of_minute_frequency_factor_tpu import data as jdata
from replication_of_minute_frequency_factor_tpu.models import (
    compute_factors_jit, factor_names as jax_factor_names)
from replication_of_minute_frequency_factor_tpu_torch import compute_batch
from replication_of_minute_frequency_factor_tpu_torch import data as tdata
from replication_of_minute_frequency_factor_tpu_torch.models import (
    factor_names)
from test_parity import (
    _check, _check_cell, _degenerate_beta_codes, _doc_pdf_acceptable, _lazy)

N_CODES, N_DAYS = 10, 2
BETA_Z = ("mmt_ols_qrs", "mmt_ols_beta_zscore_last")

#: name -> (seed, synth_day keywords, session, noisy as test_parity runs it)
SCENARIOS = {
    "clean": (1, {}, None, False),
    "ragged": (2, {"missing_prob": 0.15}, None, True),
    "zerovol": (3, {"zero_volume_prob": 0.2}, None, False),
    "constant": (4, {"constant_price_codes": 3}, None, True),
    "short": (5, {"short_day_codes": 3, "missing_prob": 0.05}, None, True),
    "seed739": (739, {"missing_prob": 0.12, "zero_volume_prob": 0.12,
                      "constant_price_codes": 2, "short_day_codes": 3},
                None, True),
    "us_390": (6, {"missing_prob": 0.05, "zero_volume_prob": 0.05},
               "us_390", True),
    "hk_halfday": (7, {"missing_prob": 0.05, "zero_volume_prob": 0.05},
                   "hk_halfday", True),
    "crypto_1440": (8, {"missing_prob": 0.02}, "crypto_1440", True),
}
#: the scenarios the quirk switch is held on across all 58 factors
QUIRK_SCENARIOS = ("clean", "ragged", "zerovol", "constant", "short",
                   "seed739", "us_390")


def _batch(data, seed, kw, session):
    rng = np.random.default_rng(seed)
    days = [data.synth_day(rng, n_codes=N_CODES, session=session,
                           date=f"2024-01-{2 + d:02d}", **kw)
            for d in range(N_DAYS)]
    codes = np.unique(np.concatenate([d["code"] for d in days]))
    grids = [data.grid_day(d["code"], d["time"], d["open"], d["high"],
                           d["low"], d["close"], d["volume"], codes=codes,
                           session=session)
             for d in days]
    return (days, codes, np.stack([g.bars for g in grids]),
            np.stack([g.mask for g in grids]))


@pytest.fixture(scope="module", params=sorted(SCENARIOS))
def scenario(request):
    """One scenario's batch through the port (CPU) and through the JAX
    package under both rolling backends, plus the f64 beta-z skip sets."""
    seed, kw, session, noisy = SCENARIOS[request.param]
    days, codes, bars, mask = _batch(tdata, seed, kw, session)
    _, jcodes, jbars, jmask = _batch(jdata, seed, kw, session)
    np.testing.assert_array_equal(bars, jbars)
    np.testing.assert_array_equal(mask, jmask)
    np.testing.assert_array_equal(codes, jcodes)
    names = factor_names()
    port = compute_batch(bars, mask, session=session, device="cpu").numpy()
    jax_out = {
        impl: compute_factors_jit(jnp.asarray(jbars), jnp.asarray(jmask),
                                  names=names, rolling_impl=impl,
                                  session=session)
        for impl in ("pallas_interpret", "conv")}
    jax_out = {impl: np.stack([np.asarray(out[n]) for n in names])
               for impl, out in jax_out.items()}
    beta = [_degenerate_beta_codes(pd.DataFrame(d), session=session)
            for d in days]
    pdf = [_lazy(lambda d=d: _doc_pdf_acceptable(pd.DataFrame(d),
                                                 session=session))
           for d in days]
    return request.param, names, codes, port, jax_out, beta, pdf, noisy


def test_port_names_are_the_reference_order_minus_the_chip_family():
    """Since the chip family was ported the port's names are the JAX
    package's 58, in its order."""
    names = factor_names()
    assert len(names) == 58
    assert names == tuple(jax_factor_names())


@pytest.mark.parametrize("impl", ["pallas_interpret", "conv"])
def test_factors_match_jax(scenario, impl):
    label, names, codes, port, jax_out, beta, pdf, noisy = scenario
    ref = jax_out[impl]
    assert port.shape == ref.shape == (len(names), N_DAYS, len(codes))
    failures = []
    for i, name in enumerate(names):
        a, b = port[i], ref[i]
        if not np.array_equal(np.isnan(a), np.isnan(b)):
            failures.append(f"{label}/{name}: NaN positions differ")
        if not np.array_equal(np.where(np.isinf(a), np.sign(a), 0),
                              np.where(np.isinf(b), np.sign(b), 0)):
            failures.append(f"{label}/{name}: inf positions differ")
        for d in range(N_DAYS):
            skip, num_scale = beta[d]
            for t, code in enumerate(codes):
                if name in BETA_Z and code in skip:
                    continue  # sub-noise beta z numerator: test_parity:98
                aux = {k: ref[names.index(k), d, t]
                       for k in ("shape_kurt", "shape_kurtVol")}
                aux["beta_num_scale"] = num_scale.get(code)
                _check_cell(f"{label}/{impl}/d{d}", name, code, b[d, t],
                            a[d, t], noisy, failures, aux, pdf[d])
    assert not failures, "\n".join(failures[:40])


def test_quirk_switch_matches_jax():
    """``replicate_quirks=False`` selects the intended definitions on
    both sides (Q1 bottom-20 volume, Q4 corr-square)."""
    _, codes, bars, mask = _batch(tdata, *SCENARIOS["clean"][:3])
    names = ("mmt_bottom20VolumeRet", "mmt_ols_qrs")
    port = compute_batch(bars, mask, names=names, device="cpu",
                         replicate_quirks=False).numpy()
    ref = compute_factors_jit(jnp.asarray(bars), jnp.asarray(mask),
                              names=names, replicate_quirks=False,
                              rolling_impl="conv")
    failures = []
    for i, name in enumerate(names):
        b = np.asarray(ref[name])
        assert np.array_equal(np.isnan(port[i]), np.isnan(b))
        for d in range(N_DAYS):
            for t, code in enumerate(codes):
                _check("quirks-off", name, code, b[d, t], port[i, d, t],
                       False, failures)
    assert not failures, "\n".join(failures)
    quirky = compute_batch(bars, mask, names=names, device="cpu").numpy()
    assert not np.allclose(quirky[0], port[0])


@pytest.mark.parametrize("label", QUIRK_SCENARIOS)
def test_quirks_off_all_58_match_jax(label):
    """``replicate_quirks=False`` across all 58 factors against JAX
    ``compute_factors_jit(rolling_impl='conv')`` under test_parity's
    comparator: NaN positions identical, values through ``_check_cell``."""
    seed, kw, session, noisy = SCENARIOS[label]
    days, codes, bars, mask = _batch(tdata, seed, kw, session)
    names = factor_names()
    port = compute_batch(bars, mask, session=session, device="cpu",
                         replicate_quirks=False).numpy()
    out = compute_factors_jit(jnp.asarray(bars), jnp.asarray(mask),
                              names=names, replicate_quirks=False,
                              rolling_impl="conv", session=session)
    ref = np.stack([np.asarray(out[n]) for n in names])
    beta = [_degenerate_beta_codes(pd.DataFrame(d), session=session)
            for d in days]
    pdf = [_lazy(lambda d=d: _doc_pdf_acceptable(pd.DataFrame(d),
                                                 session=session))
           for d in days]
    failures = []
    for i, name in enumerate(names):
        a, b = port[i], ref[i]
        if not np.array_equal(np.isnan(a), np.isnan(b)):
            failures.append(f"{label}/{name}: NaN positions differ")
        for d in range(N_DAYS):
            skip, num_scale = beta[d]
            for t, code in enumerate(codes):
                if name in BETA_Z and code in skip:
                    continue
                aux = {k: ref[names.index(k), d, t]
                       for k in ("shape_kurt", "shape_kurtVol")}
                aux["beta_num_scale"] = num_scale.get(code)
                _check_cell(f"{label}/quirks-off/d{d}", name, code,
                            b[d, t], a[d, t], noisy, failures, aux, pdf[d])
    assert not failures, "\n".join(failures[:40])
    quirky = compute_batch(bars, mask, session=session, device="cpu").numpy()
    changed = {names[i] for i in range(len(names))
               if not np.array_equal(quirky[i], port[i], equal_nan=True)}
    assert {"doc_vol50_ratio", "mmt_bottom20VolumeRet"} <= changed


def test_compute_batch_takes_tensors_and_casts_f64():
    _, _, bars, mask = _batch(tdata, *SCENARIOS["ragged"][:3])
    a = compute_batch(bars, mask, device="cpu")
    b = compute_batch(torch.from_numpy(bars.astype(np.float64)),
                      torch.from_numpy(mask), device="cpu")
    assert a.dtype == b.dtype == torch.float32
    torch.testing.assert_close(a, b, rtol=0, atol=0, equal_nan=True)
    one = compute_batch(bars[0], mask[0], device="cpu")
    assert one.shape == (58, N_CODES)
    with pytest.raises(ValueError, match="slots per day"):
        compute_batch(bars, mask, session="us_390", device="cpu")
    with pytest.raises(ValueError, match="day batch"):
        compute_batch(bars[..., :4], mask, device="cpu")
