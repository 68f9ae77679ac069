"""The parity suite's comparator, without JAX: the port's factors on a
device against the f64 oracle (:mod:`..oracle`).

A copy of ``tests/test_parity.py``'s tolerance tables and comparator
protocol (``_check``, ``_check_cell``, ``_degenerate_beta_codes``,
``_doc_pdf_acceptable``, ``_lazy``) on the port's own oracle, grid and
device graph, so the fuzz harnesses and ``chip_smoke.py`` hold the port
to the suite's word on a machine that has no JAX. The tables are the
suite's to the last digit (``tests/test_torch_fuzz_parity.py`` pins
them and the verdicts on the suite's pinned seeds); nothing here is
looser than the suite.

Only ``numpy`` and ``torch`` load with this module: the oracle and
``pandas`` load inside the functions that need them.
"""

from __future__ import annotations

import numpy as np

# default: f32 vs f64 closeness
RTOL = {"default": 2e-3}
ATOL = {
    "default": 1e-6,
    # rank outputs are half-integers in [1, T*240]
    "doc_pdf60": 1e-2, "doc_pdf70": 1e-2, "doc_pdf80": 1e-2,
    "doc_pdf90": 1e-2, "doc_pdf95": 1e-2,
    # higher-moment ratios suffer f32 cancellation on near-symmetric data
    "shape_skratio": 1e-4, "shape_skratioVol": 1e-4,
    "doc_skew": 1e-3, "doc_kurt": 5e-3, "doc_std": 1e-3,
    "mmt_ols_qrs": 1e-4, "mmt_ols_beta_zscore_last": 1e-4,
    # Pearson correlations near zero: the f32 covariance is a
    # near-cancelling 240-term sum, so the absolute error is ~n*eps_f32
    # for O(1) normalized terms (raised by heavy-tailed volume changes)
    "corr_prv": 1e-4, "corr_prvr": 1e-4, "corr_pv": 1e-4,
    "corr_pvd": 1e-4, "corr_pvl": 1e-4, "corr_pvr": 1e-4,
    # means of ret/volume-share terms that can nearly cancel
    "trade_top20retRatio": 5e-5, "trade_top50retRatio": 5e-5,
    # product-of-ratios minus 1: absolute error on a product ~ 1
    "mmt_top50VolumeRet": 1e-5, "mmt_bottom50VolumeRet": 1e-5,
    "mmt_top20VolumeRet": 1e-5, "mmt_bottom20VolumeRet": 1e-5,
}

#: factors that are tick-rounding noise on short rounded-price days; on
#: the scenarios the suite calls noisy their atol rises to NOISE_ATOL
NOISE_FACTORS = frozenset({
    "vol_upRatio", "vol_downRatio", "shape_skew", "shape_kurt",
    "shape_skratio", "shape_skratioVol",
})
NOISE_ATOL = 5e-3
RTOL_OVERRIDE = {
    "mmt_ols_qrs": 2e-2, "mmt_ols_corr_square_mean": 5e-3,
    "mmt_ols_corr_mean": 5e-3, "mmt_ols_beta_mean": 5e-3,
    "mmt_ols_beta_zscore_last": 2e-2,
    "shape_skew": 5e-3, "shape_kurt": 5e-3, "shape_skratio": 1e-2,
    "shape_skewVol": 5e-3, "shape_kurtVol": 5e-3, "shape_skratioVol": 1e-2,
    "doc_skew": 1e-2, "doc_kurt": 1e-2, "doc_std": 1e-2,
    "corr_prv": 5e-3, "corr_prvr": 5e-3, "corr_pv": 5e-3,
    "corr_pvd": 5e-3, "corr_pvl": 5e-3, "corr_pvr": 5e-3,
    "liq_amihud_1min": 5e-3,
}

#: |kurtosis| below which the skew/kurt ratios are pure noise (skipped)
DEGENERATE_KURT = 0.05
#: absolute f32 wobble of a kurtosis estimate: widens the ratios' rtol
#: by KURT_ABS_NOISE/|kurt| just above the cutoff
KURT_ABS_NOISE = 1.5e-3
#: beta z-score numerator (of scale) below which the z family is f32
#: noise (skipped)
DEGENERATE_BETA_Z = 2e-4
#: the oracle's beta std near the f32 sub-resolution snap (skipped)
DEGENERATE_BETA_STD = 64 * np.finfo(np.float32).eps
#: per-window beta relative f32 error: widens the z family's rtol by
#: BETA_EPS_REL/(num/scale) just above the cutoff
BETA_EPS_REL = 6e-6
#: rank-unit allowance for doc_pdf* under noisy scenarios
PDF_RANK_SLACK = 20.0
#: accumulation-noise band around the doc_pdf threshold
PDF_EDGE_EPS = 3e-5
_PDF_THRESHOLDS = {"doc_pdf60": 0.6, "doc_pdf70": 0.7, "doc_pdf80": 0.8,
                   "doc_pdf90": 0.9, "doc_pdf95": 0.95}

#: the names ``chip_smoke.py`` reads as its tolerance tables
TABLE_NAMES = ("RTOL", "ATOL", "RTOL_OVERRIDE", "NOISE_FACTORS",
               "NOISE_ATOL", "DEGENERATE_BETA_Z", "DEGENERATE_BETA_STD",
               "BETA_EPS_REL", "DEGENERATE_KURT", "KURT_ABS_NOISE",
               "PDF_EDGE_EPS", "_PDF_THRESHOLDS", "PDF_RANK_SLACK")


def tables() -> dict:
    """The tolerance tables by name (:data:`TABLE_NAMES`)."""
    g = globals()
    return {k: g[k] for k in TABLE_NAMES}


def _degenerate_beta_codes(df, session=None):
    """Per-code beta z conditioning of a one-day frame: ``(skip_set,
    num_scale)``, ``skip_set`` the codes whose oracle beta z numerator
    (or beta std) is sub-noise, ``num_scale[code]`` num/scale of the
    others for the BETA_EPS_REL widening."""
    from ..oracle.kernels import Group, _beta, _rolling50

    out = set()
    num_scale = {}
    for code, sub in df.sort_values("time").groupby("code"):
        g = Group(sub["time"].to_numpy(), sub["open"].to_numpy(),
                  sub["high"].to_numpy(), sub["low"].to_numpy(),
                  sub["close"].to_numpy(), sub["volume"].to_numpy(),
                  session=session)
        st = _rolling50(g)
        if len(st["var_x"]) < 2:
            continue
        b = _beta(st)
        num = abs(float(b[-1]) - float(np.mean(b)))
        std = float(np.std(b, ddof=1))
        scale = max(abs(float(np.mean(b))), abs(float(b[-1])), 1e-30)
        if (not np.isfinite(num) or num < DEGENERATE_BETA_Z * scale
                or std < DEGENERATE_BETA_STD * scale):
            out.add(code)
        else:
            num_scale[code] = num / scale
    return out, num_scale


def _eod_ret_device(bars, mask):
    """The device graph's end-of-day-relative return
    (``DayContext.eod_ret``: last present close over each close) on the
    tensors' device."""
    from ..ops.masked import masked_last

    close = bars[..., 3]
    return masked_last(close, mask)[..., None] / close


def _device_eod_rows(code, time, cols, session=None, device="cpu"):
    """Acceptance channel 3: ``device``'s own f32 end-of-day returns, one
    per (sorted) row; None when a row does not map onto the minute grid
    or two rows share a (code, slot)."""
    import torch

    from ..data.minute import grid_day
    from ..markets import get_session

    g = grid_day(code, time, cols["open"], cols["high"], cols["low"],
                 cols["close"], cols["volume"], session=session)
    eod = _eod_ret_device(torch.from_numpy(g.bars).to(device),
                          torch.from_numpy(g.mask).to(device))
    eod = eod.cpu().numpy().astype(np.float64)
    gcodes = np.asarray(g.codes)
    ti = np.searchsorted(gcodes, code)
    si = get_session(session).time_to_slot(np.asarray(time))
    known = ((ti < len(gcodes))
             & (gcodes[np.minimum(ti, len(gcodes) - 1)] == code))
    if (si < 0).any() or not known.all():
        return None
    if ((code[1:] == code[:-1]) & (si[1:] == si[:-1])).any():
        return None
    return eod[ti, si]


def _doc_pdf_acceptable(df, session=None, device="cpu"):
    """Acceptance sets ``{(code, factor): {rank values}}`` for doc_pdf* on
    a one-date frame: the oracle's walk re-read at the threshold and at
    threshold +/- PDF_EDGE_EPS, over the f64 end-of-day returns, the
    returns quantized to f32, and ``device``'s own f32 returns (which
    must lie within 4 ulp of the correctly-rounded f32 ones)."""
    from ..oracle.kernels import Group, _doc_pdf
    from ..oracle.stats import rank_average

    df = df.sort_values(["code", "time"], kind="stable")
    code = df["code"].to_numpy()
    cols = {c: df[c].to_numpy(np.float64)
            for c in ("open", "high", "low", "close", "volume")}
    time = df["time"].to_numpy(np.int64)
    starts = np.r_[0, np.nonzero(code[1:] != code[:-1])[0] + 1, len(code)]
    spans = list(zip(starts[:-1], starts[1:]))
    channels = []
    for quantize in (False, True):
        eod = np.empty(len(df), np.float64)
        with np.errstate(divide="ignore", invalid="ignore"):
            c = cols["close"]
            if quantize:
                c = c.astype(np.float32).astype(np.float64)
            for b0, b1 in spans:
                eod[b0:b1] = c[b1 - 1] / c[b0:b1]
        if quantize:
            eod = eod.astype(np.float32).astype(np.float64)
        channels.append(eod)
    dev = _device_eod_rows(code, time, cols, session=session, device=device)
    if dev is not None:
        q = channels[1]
        if not np.array_equal(dev, q, equal_nan=True):
            fin = np.isfinite(q) & np.isfinite(dev)
            inf = np.isinf(q) | np.isinf(dev)
            eps = np.finfo(np.float32).eps
            bounded = (
                np.array_equal(np.isnan(dev), np.isnan(q))
                and np.array_equal(dev[inf], q[inf])
                and bool(np.all(np.abs(dev[fin] - q[fin])
                                <= 4 * eps * np.abs(q[fin])
                                + np.finfo(np.float32).tiny))
            )
            assert bounded, (
                "device eod_ret deviates from correctly-rounded f32 "
                "beyond the 4-ulp band — a device arithmetic regression, "
                "not a tie-structure channel")
            channels.append(dev)
    out: dict = {}
    for eod in channels:
        grank = rank_average(eod)
        for b0, b1 in spans:
            g = Group(time=time[b0:b1],
                      **{k: v[b0:b1] for k, v in cols.items()},
                      grank=grank[b0:b1])
            for name, thr in _PDF_THRESHOLDS.items():
                acc = out.setdefault((code[b0], name), set())
                for t in (thr - PDF_EDGE_EPS, thr, thr + PDF_EDGE_EPS):
                    val = _doc_pdf(g, t)
                    if np.isfinite(val):
                        acc.add(float(val))
    return out


def _check(label, name, code, ov, jvv, noisy, failures, aux=None):
    """One value ``jvv`` of the port against the oracle's ``ov``;
    appends a message to ``failures`` when it is out of tolerance."""
    ratio_denom = None
    if aux is not None and name in ("shape_skratio", "shape_skratioVol"):
        # a degenerate denominator makes the ratio noise on either side
        # of any nan/inf/finite boundary, so this skip precedes them
        denom = aux.get(
            "shape_kurt" if name == "shape_skratio" else "shape_kurtVol",
            np.nan)
        if np.isfinite(denom) and abs(denom) < DEGENERATE_KURT:
            return
        if np.isfinite(denom):
            ratio_denom = abs(denom)
    if np.isnan(ov) != np.isnan(jvv):
        failures.append(f"{label}/{name}/{code}: nan mismatch "
                        f"oracle={ov} port={jvv}")
        return
    if np.isnan(ov):
        return
    if np.isinf(ov) or np.isinf(jvv):
        if not (np.isinf(ov) and np.isinf(jvv)
                and np.sign(ov) == np.sign(jvv)):
            failures.append(f"{label}/{name}/{code}: inf mismatch "
                            f"oracle={ov} port={jvv}")
        return
    rtol = RTOL_OVERRIDE.get(name, RTOL["default"])
    atol = ATOL.get(name, ATOL["default"])
    if ratio_denom is not None:
        rtol += KURT_ABS_NOISE / ratio_denom
    if (aux is not None
            and name in ("mmt_ols_qrs", "mmt_ols_beta_zscore_last")):
        ns = aux.get("beta_num_scale")
        if ns:
            rtol += BETA_EPS_REL / ns
    if noisy and name in NOISE_FACTORS:
        atol = max(atol, NOISE_ATOL)
    if aux is not None and name.startswith("doc_pdf"):
        atol = max(atol, PDF_RANK_SLACK)
    if not np.isclose(ov, jvv, rtol=rtol, atol=atol):
        failures.append(f"{label}/{name}/{code}: oracle={ov!r} port={jvv!r}")


def _check_cell(label, name, code, ov, jvv, noisy, failures, aux,
                pdf_acceptance):
    """One (factor, code) comparison, the single-day and multiday paths'
    one protocol. ``pdf_acceptance`` is a zero-arg callable returning the
    date's (lazily built) doc_pdf acceptance sets: a doc_pdf value off
    the oracle passes if it is within the normal slack of any member."""
    if name in _PDF_THRESHOLDS:
        tmp: list = []
        _check(label, name, code, ov, jvv, noisy, tmp, aux=aux)
        if not tmp:
            return

        def _alt_ok(alt):
            t2: list = []
            _check(label, name, code, alt, jvv, noisy, t2, aux=aux)
            return not t2
        if not any(_alt_ok(a)
                   for a in pdf_acceptance().get((code, name), ())):
            failures.extend(tmp)
        return
    _check(label, name, code, ov, jvv, noisy, failures, aux=aux)


def _lazy(build):
    """Memoise a zero-arg builder (the acceptance sets are built only
    when some doc_pdf cell fails the primary check)."""
    cache: list = []

    def get():
        if not cache:
            cache.append(build())
        return cache[0]
    return get
