"""Execute the reference's real kernel code on the shim; diff vs the port.

The port's copy of the repo's ``tools/refdiff/harness.py``, with every
differential pointed at this package (its f64 oracle, :class:`Factor`,
:class:`MinFreqFactor` and :class:`Config`, its synthetic days), so that
``backend='polars'`` and the port's differentials need no repo checkout
and import nothing of the JAX package or of ``tools``.

Chain of custody for parity:

    reference cal_* source  --runs on-->  polars_shim   (this harness)
        vs  oracle/kernels.py (numpy, f64)              (this harness)
        vs  the torch backend (f32, dense grid)         (the parity tests)

Both sides of THIS harness are f64, so tolerances are near-exact.

Containment: the reference modules EXECUTE IN-PROCESS with full
interpreter access — module import runs arbitrary top-level code, and
nothing about the shim constrains what the executed modules themselves
can do. The mitigation is provenance, not isolation: before any exec the
target file's SHA-256 is checked against the pinned hash of the audited
snapshot (``_REFERENCE_SHA256``), so the only code that can run is the
exact bytes reviewed in SURVEY.md — a tampered or swapped reference tree
fails closed. To run a deliberately different snapshot (e.g. a future
refresh, or a stand-in tree in tests), re-audit it and update the pins,
or set ``REFDIFF_ALLOW_UNPINNED=1`` to accept the risk explicitly. This
applies to the port's ``backend='polars'`` path too (the pipeline calls
:func:`load_reference_kernels` once, before its day loop).
"""

from __future__ import annotations

import contextlib
import hashlib
import importlib.util
import os
import sys
import types

import numpy as np

#: the audited reference tree: ``REFDIFF_REFERENCE_DIR``, else the same
#: mount point tools/refdiff/harness.py defaults to, so both packages'
#: backends read one tree
REFERENCE_DIR = os.environ.get("REFDIFF_REFERENCE_DIR", "/root/reference")
_KERNELS = "MinuteFrequentFactorCalculateMethodsCICC.py"

# SHA-256 of the audited reference snapshot (2025-10-24). exec of any
# file that does not match fails closed — see module docstring.
_REFERENCE_SHA256 = {
    "Factor.py":
        "ccfa843b81a3aa2ebe8a8716306c467737fb0124969b045905b5f74ea4fff997",
    "MinuteFrequentFactorCICC.py":
        "543a9242b42d41342acadc3044b291181947c7d21e857edc8b59b3b694e026fb",
    _KERNELS:
        "d242416203f1c42a3a315a9a28fd8bf3142fda444aed87a5a4bbe203ad328f52",
}


def _verified_reference_source(filename):
    """Read ``filename`` under REFERENCE_DIR ONCE and hash exactly the
    bytes that will be executed (hash-then-reread would reopen the
    TOCTOU window the pin exists to close). Returns (path, source)."""
    path = os.path.join(REFERENCE_DIR, filename)
    with open(path, "rb") as fh:
        source = fh.read()
    digest = hashlib.sha256(source).hexdigest()
    if digest != _REFERENCE_SHA256.get(filename):
        if os.environ.get("REFDIFF_ALLOW_UNPINNED") == "1":
            return path, source
        raise RuntimeError(
            f"refusing to execute unpinned reference file {path}: "
            f"sha256 {digest} != audited pin "
            f"{_REFERENCE_SHA256.get(filename)}; re-audit the snapshot "
            "and update harness._REFERENCE_SHA256, or set "
            "REFDIFF_ALLOW_UNPINNED=1 to accept the risk")
    return path, source


def _exec_reference_module(filename, modname, extra_modules=None):
    """Compile + exec the verified bytes of a reference file as a module,
    with the shim (and any ``extra_modules``) resolvable only for the
    exec's duration."""
    path, source = _verified_reference_source(filename)
    mod = types.ModuleType(modname)
    mod.__file__ = path
    code = compile(source, path, "exec")
    with _modules_installed(polars=install_shim(),
                            **(extra_modules or {})):
        exec(code, mod.__dict__)
    return mod


@contextlib.contextmanager
def _modules_installed(**mods):
    """Temporarily install ``sys.modules`` entries for the duration of a
    reference ``exec_module`` (its top-level ``import polars`` /
    ``from Factor import Factor`` must resolve to the shim-backed
    modules), restoring the previous state afterwards so a later genuine
    ``import polars`` or ``import Factor`` in this process cannot
    silently resolve to refdiff internals."""
    missing = object()
    prior = {name: sys.modules.get(name, missing) for name in mods}
    sys.modules.update(mods)
    try:
        yield
    finally:
        for name, old in prior.items():
            if old is missing:
                sys.modules.pop(name, None)
            else:
                sys.modules[name] = old

# f64-vs-f64, but not bit-identical: the oracle anchors moment passes
# (oracle/stats.py pearson) and orders summations differently. Defaults
# are near-machine; per-factor widenings must cite evidence.
RTOL_DEFAULT = 1e-9
ATOL_DEFAULT = 1e-12
RTOL = {
    # rolling cov/var chains: shim uses np.var/np.cov-style two-pass per
    # window, oracle uses cumulative-sum identities (oracle/kernels.py
    # _rolling50) — f64 agreement to ~1e-12 normally, but the qrs
    # z-score divides by beta_std which can be ~1e-10 on near-constant
    # windows, amplifying the summation-order difference
    "mmt_ols_qrs": 1e-6, "mmt_ols_beta_zscore_last": 1e-6,
    "mmt_ols_corr_square_mean": 1e-8, "mmt_ols_corr_mean": 1e-8,
    "mmt_ols_beta_mean": 1e-8,
    # skew/kurt ratios: both sides compute biased g1/g2 but with
    # different centering-order; near-zero kurtosis amplifies
    "shape_skratio": 1e-7, "shape_skratioVol": 1e-7,
}
ATOL = {
    # correlations: near-zero r is a cancelling sum in both backends
    "corr_prv": 1e-10, "corr_prvr": 1e-10, "corr_pv": 1e-10,
    "corr_pvd": 1e-10, "corr_pvl": 1e-10, "corr_pvr": 1e-10,
}


_shim_proxy = None


def install_shim() -> types.ModuleType:
    """Return the polars module the differentials run on: a REAL polars
    if one is importable (strictly better than the shim), else a proxy
    around :mod:`.polars_shim`.

    Despite the name this does NOT mutate ``sys.modules``: callers use
    the returned module directly, and the reference exec sites install
    it only for the duration of the exec via ``_modules_installed``.
    The proxy exists
    because the shim cannot define a module-level ``len`` without
    shadowing the builtin for its own internals.
    """
    global _shim_proxy
    if _shim_proxy is not None:
        return _shim_proxy
    existing = sys.modules.get("polars")
    if (existing is not None
            and not getattr(existing, "__is_refdiff_shim__", False)) \
            or importlib.util.find_spec("polars"):
        import polars as real

        _shim_proxy = real
        return real
    from . import polars_shim as shim

    mod = types.ModuleType("polars")
    for k in dir(shim):
        if not k.startswith("_"):
            setattr(mod, k, getattr(shim, k))
    mod.len = shim._pl_len
    mod.__is_refdiff_shim__ = True
    _shim_proxy = mod
    return mod


_ref_kernels_mod = None


def load_reference_kernels():
    """Import the reference's kernel module against the shim (cached)."""
    global _ref_kernels_mod
    if _ref_kernels_mod is not None:
        return _ref_kernels_mod
    _ref_kernels_mod = _exec_reference_module(_KERNELS,
                                              "refdiff_ref_kernels")
    return _ref_kernels_mod


def day_frame(day: dict):
    """Long-format day columns (data.synth_day output) -> shim DataFrame,
    sorted (code, time) like a real day file."""
    pl = install_shim()
    order = np.lexsort((np.asarray(day["time"]), np.asarray(day["code"])))
    cols = {
        "code": np.asarray(day["code"])[order],
        "date": np.asarray(day["date"])[order]
        if "date" in day else np.repeat("2024-01-02", order.size),
        "time": np.asarray(day["time"], dtype=np.int64)[order],
    }
    for k in ("open", "high", "low", "close", "volume"):
        cols[k] = np.asarray(day[k], dtype=np.float64)[order]
    return pl.DataFrame(cols)


def run_reference(day: dict, names=None) -> dict:
    """{factor_name: {code: float}} via the reference's own cal_* code."""
    mod = load_reference_kernels()
    df = day_frame(day)
    if names is None:
        names = [n[4:] for n in dir(mod) if n.startswith("cal_")]
    out = {}
    for name in names:
        res = getattr(mod, "cal_" + name)(df)
        codes = res["code"].to_numpy()
        vals = res[name].to_numpy()
        out[name] = {str(c): float(v) for c, v in zip(codes, vals)}
    return out


def run_oracle(day: dict, names=None) -> dict:
    """Same shape via the port's numpy oracle (f64)."""
    import pandas as pd

    from ..oracle import compute_oracle

    df = pd.DataFrame({
        "code": day["code"],
        "date": day.get("date", np.repeat("2024-01-02",
                                          len(day["code"]))),
        "time": day["time"],
        **{k: day[k] for k in ("open", "high", "low", "close", "volume")},
    })
    wide = compute_oracle(df, names=names)
    out = {}
    for name in wide.columns:
        if name in ("code", "date"):
            continue
        out[name] = {str(c): float(v)
                     for c, v in zip(wide["code"], wide[name])}
    return out


_ref_factor_mod = None


def load_reference_factor_module():
    """Import the reference's Factor.py (evaluation layer) on the shim."""
    global _ref_factor_mod
    if _ref_factor_mod is not None:
        return _ref_factor_mod
    os.environ.setdefault("MPLBACKEND", "Agg")
    _ref_factor_mod = _exec_reference_module("Factor.py",
                                             "refdiff_ref_factor")
    return _ref_factor_mod


def synth_eval_data(rng, n_codes=18, n_days=90, nan_prob=0.06,
                    missing_row_prob=0.04, start="2024-01-01"):
    """Synthetic exposure + daily-PV long tables for the eval differential.

    Weekday dates only; exposure has NaN patches (reference filters them
    in ic_test, buckets them null in group_test); PV drops some rows
    (suspended stocks) and includes tmc/cmc weights.
    """
    all_days = np.arange(np.datetime64(start, "D"),
                         np.datetime64(start, "D") + int(n_days * 1.5))
    dates = all_days[(all_days.astype(int) + 3) % 7 < 5][:n_days]
    codes = np.array([f"{600000 + i:06d}" for i in range(n_codes)])
    cc, dd = np.meshgrid(np.arange(n_codes), np.arange(len(dates)),
                         indexing="ij")
    code_col = codes[cc.ravel()]
    date_col = dates[dd.ravel()]
    n = code_col.size
    # exposure: f32-representable values so both stacks see identical bits
    expo_val = rng.normal(0, 1, n).astype(np.float32).astype(np.float64)
    expo_val[rng.random(n) < nan_prob] = np.nan
    exposure = {"code": code_col, "date": date_col, "value": expo_val}
    keep = rng.random(n) >= missing_row_prob
    pv = {
        "code": code_col[keep],
        "date": date_col[keep],
        "pct_change": np.round(rng.normal(0, 0.02, keep.sum()), 6),
        "tmc": np.round(np.exp(rng.normal(10, 1, keep.sum())), 2),
        "cmc": np.round(np.exp(rng.normal(9, 1, keep.sum())), 2),
    }
    # a few zero-cap rows exercise the sum==0 -> 0 weight fallback
    zero = rng.random(keep.sum()) < 0.01
    pv["tmc"][zero] = 0.0
    return exposure, pv


def _exposure_frame(pl, exposure, factor_name, nan_as_value=False):
    """Exposure long table as the reference would hold it.

    Default: NaN factor values are NULLS (what its parquet cache holds
    when kernels emit null for undefined values). ``nan_as_value=True``
    keeps them as float NaN with a true validity bit — the provenance
    polars arithmetic like 0/0 produces, and the scenario where the
    ``qcut_nan`` pin ambiguity is actually reachable in group_test
    (see SEMANTIC_PINS; tests/test_pin_bounds.py)."""
    from .polars_shim import Series as ShimSeries

    vals = np.asarray(exposure["value"], np.float64)
    if getattr(pl, "__is_refdiff_shim__", False):
        validity = (np.ones(vals.size, bool) if nan_as_value
                    else np.isfinite(vals))
        val_col = ShimSeries(vals, validity)
    elif nan_as_value:  # real polars: NaN is an ordinary float value
        val_col = [float(v) for v in vals]
    else:  # real polars: None marks null
        val_col = [None if not np.isfinite(v) else float(v) for v in vals]
    return pl.DataFrame({
        "code": exposure["code"],
        "date": exposure["date"].astype("datetime64[D]"),
        factor_name: val_col,
    })


def run_reference_eval(exposure, pv, factor_name="f", future_days=5,
                       frequency="monthly", weight_param=None,
                       group_num=5, nan_as_value=False):
    """Reference Factor.ic_test + group_test on the shim.

    ``_read_daily_pv_data`` is replaced (its body is a read of a
    hardcoded Windows path, Factor.py:49); everything from Factor.py:127
    onward runs verbatim. Returns (stats, ic_rows, group_rows).
    """
    pl = install_shim()
    mod = load_reference_factor_module()
    f = mod.Factor(factor_name, _exposure_frame(pl, exposure,
                                                factor_name,
                                                nan_as_value))

    def fake_read(column_need=None):
        cols = column_need or list(pv)
        return pl.DataFrame({c: pv[c] for c in cols})

    orig = mod.Factor._read_daily_pv_data
    mod.Factor._read_daily_pv_data = staticmethod(fake_read)
    try:
        cov_df = f.coverage(plot_out=False, return_df=True)
        ic_df = f.ic_test(future_days=future_days, plot_out=False,
                          return_df=True)
        stats = {"IC": f.IC, "ICIR": f.ICIR, "rank_IC": f.rank_IC,
                 "rank_ICIR": f.rank_ICIR}
        group_df = f.group_test(frequency=frequency,
                                weight_param=weight_param,
                                group_num=group_num, plot_out=False,
                                return_df=True)
    finally:
        mod.Factor._read_daily_pv_data = orig
    ic_rows = {np.datetime64(d, "D"): (float(i), float(r))
               for d, i, r in zip(ic_df["date"].to_numpy(),
                                  ic_df["IC"].to_numpy(),
                                  ic_df["rank_IC"].to_numpy())}
    # coverage: dates whose whole cross-section is NaN are absent from
    # the reference's output (the filter drops their rows pre-group_by)
    cov_rows = {np.datetime64(d, "D"): int(v)
                for d, v in zip(cov_df["date"].to_numpy(),
                                cov_df[factor_name].to_numpy())}
    group_rows = {}
    labels = group_df["group"].to_numpy()
    for d, g, r in zip(group_df["date"].to_numpy(), labels,
                       group_df["pct_change"].to_numpy()):
        gi = int(str(g).rsplit("_", 1)[1]) - 1
        group_rows[(np.datetime64(d, "D"), gi)] = float(r)
    return stats, ic_rows, group_rows, cov_rows


_FREQ_REF_TO_REPO = {"weekly": "week", "monthly": "month",
                     "quarterly": "quarter", "yearly": "year"}
_EVERY = {"weekly": "1w", "monthly": "1mo", "quarterly": "1q",
          "yearly": "1y"}


def run_repo_eval(exposure, pv, tmp_dir, factor_name="f", future_days=5,
                  frequency="monthly", weight_param=None, group_num=5,
                  device=None):
    """Same scenario through the port's Factor (production eval path) on
    ``device`` (the card unless ``'cpu'``)."""
    import pyarrow as pa

    from ..data.io import write_parquet_atomic
    from ..factor import Factor

    pv_path = os.path.join(tmp_dir, "daily_pv.parquet")
    write_parquet_atomic(pa.table({
        "Stkcd": pv["code"],
        "Trddt": np.datetime_as_string(pv["date"].astype("datetime64[D]")),
        "ChangeRatio": pv["pct_change"],
        "Dsmvtll": pv["tmc"],
        "Dsmvosd": pv["cmc"],
    }), pv_path)
    f = Factor(factor_name, device=device).set_exposure(exposure["code"],
                                         exposure["date"],
                                         exposure["value"])
    cov = f.coverage(plot=False, return_df=True)
    cov_rows = {np.datetime64(d, "D"): int(v)
                for d, v in zip(cov["date"], cov["coverage"]) if v > 0}
    ic = f.ic_test(future_days=future_days, plot=False, return_df=True,
                   daily_pv_path=pv_path)
    stats = {"IC": f.IC, "ICIR": f.ICIR, "rank_IC": f.rank_IC,
             "rank_ICIR": f.rank_ICIR}
    gt = f.group_test(frequency=_FREQ_REF_TO_REPO[frequency],
                      weight_param=weight_param, group_num=group_num,
                      plot=False, return_df=True,
                      daily_pv_path=pv_path)
    ic_rows = {np.datetime64(d, "D"): (float(i), float(r))
               for d, i, r in zip(ic["date"], ic["IC"], ic["rank_IC"])}
    # repo periods are labeled by period START; the reference labels by
    # the right edge — map start -> right edge for comparison
    group_rows = {}
    from .polars_shim import _bucket_label
    for pi, p in enumerate(gt["period"]):
        right = _bucket_label(np.datetime64(p, "D"),
                              _EVERY[frequency], "right")
        for gi in range(group_num):
            v = gt["group_return"][pi, gi]
            if np.isfinite(v):
                group_rows[(right, gi)] = float(v)
    return stats, ic_rows, group_rows, cov_rows


def compare_eval(rng_seed=0, future_days=5, frequency="monthly",
                 weight_param=None, group_num=5, tmp_dir=None,
                 nan_as_value=False, device=None, **synth_kw):
    """Full eval differential; returns a list of mismatch strings."""
    import tempfile

    rng = np.random.default_rng(rng_seed)
    exposure, pv = synth_eval_data(rng, **synth_kw)
    own_tmp = tmp_dir is None
    if own_tmp:
        tmp_ctx = tempfile.TemporaryDirectory()
        tmp_dir = tmp_ctx.name
    try:
        ref_stats, ref_ic, ref_grp, ref_cov = run_reference_eval(
            exposure, pv, future_days=future_days, frequency=frequency,
            weight_param=weight_param, group_num=group_num,
            nan_as_value=nan_as_value)
        repo_stats, repo_ic, repo_grp, repo_cov = run_repo_eval(
            exposure, pv, tmp_dir, future_days=future_days,
            frequency=frequency, weight_param=weight_param,
            group_num=group_num, device=device)
    finally:
        if own_tmp:
            tmp_ctx.cleanup()
    failures = []
    if ref_cov != repo_cov:
        extra = set(ref_cov.items()) ^ set(repo_cov.items())
        failures.append(f"coverage mismatch on {sorted(extra)[:6]}")
    # IC series: repo eval kernels run f32 on device -> ~1e-4 absolute
    for d in sorted(set(ref_ic) | set(repo_ic)):
        if d not in ref_ic or d not in repo_ic:
            failures.append(f"ic date {d}: only in "
                            f"{'reference' if d in ref_ic else 'repo'}")
            continue
        for j, nm in enumerate(("IC", "rank_IC")):
            a, b = ref_ic[d][j], repo_ic[d][j]
            if np.isnan(a) != np.isnan(b) or (
                    not np.isnan(a)
                    and not np.isclose(a, b, rtol=5e-4, atol=2e-4)):
                failures.append(f"{nm}@{d}: ref={a!r} repo={b!r}")
    for k in ("IC", "ICIR", "rank_IC", "rank_ICIR"):
        a, b = ref_stats[k], repo_stats[k]
        if a is None or b is None:
            if a is not None or b is not None:
                failures.append(f"{k}: ref={a!r} repo={b!r}")
            continue
        if not np.isclose(a, b, rtol=1e-3, atol=2e-4):
            failures.append(f"{k}: ref={a!r} repo={b!r}")
    # group returns: all-f64 on both sides -> tight
    for key in sorted(set(ref_grp) | set(repo_grp)):
        if key not in ref_grp or key not in repo_grp:
            failures.append(f"group {key}: only in "
                            f"{'reference' if key in ref_grp else 'repo'}")
            continue
        a, b = ref_grp[key], repo_grp[key]
        if not np.isclose(a, b, rtol=1e-8, atol=1e-10):
            failures.append(f"group {key}: ref={a!r} repo={b!r}")
    return failures


class RefdiffUnsupported(RuntimeError):
    """Raised when a differential cannot run in this environment (e.g.
    the reference's own code is invalid on real polars — quirk Q13)."""


def _require_shim():
    """The minfreq differentials need the SHIM specifically: the
    reference's calendar-mode ``group_by_dynamic`` call omits the
    required ``index_column`` (quirk Q13), which modern real polars
    rejects with TypeError before any comparison can happen."""
    pl = install_shim()
    if not getattr(pl, "__is_refdiff_shim__", False):
        raise RefdiffUnsupported(
            "reference MinuteFrequentFactorCICC code cannot run on real "
            "polars (quirk Q13: group_by_dynamic without index_column); "
            "these differentials require the shim")
    return pl


class _OsRedirect:
    """Stand-in for the ``os`` module inside the reference's
    MinuteFrequentFactorCICC module: its minute-dir and cache-dir paths
    are hardcoded Windows literals (:64,68), so ``listdir``/``path.join``
    redirect those two roots to harness-provided directories. Everything
    else passes through."""

    _KLINE = r"D:\QuantData\KLine_cleaned"
    _CACHE = r"D:\QuantData\MinuteFreqFactor\CICC Factor"

    class _PathNS:
        def __init__(self, outer):
            self._o = outer

        def join(self, a, *rest):
            a = self._o._map(a)
            return os.path.join(a, *rest)

        def __getattr__(self, name):
            return getattr(os.path, name)

    def __init__(self, kline_dir, cache_dir):
        self._kline = kline_dir
        self._cache = cache_dir
        self.path = self._PathNS(self)

    def _map(self, p):
        if p == self._KLINE:
            return self._kline
        if p == self._CACHE:
            return self._cache
        return p

    def listdir(self, p):
        return sorted(os.listdir(self._map(p)))

    def __getattr__(self, name):
        return getattr(os, name)


def load_reference_minfreq_module(kline_dir, cache_dir):
    """Import the reference's MinuteFrequentFactorCICC.py on the shim.

    ``from Factor import Factor`` resolves to the shim-backed reference
    Factor module; the hardcoded data roots redirect via _OsRedirect.
    Re-imported per call because the redirect dirs change per scenario.
    """
    _require_shim()
    fmod = load_reference_factor_module()
    mod = _exec_reference_module("MinuteFrequentFactorCICC.py",
                                 "refdiff_ref_minfreq",
                                 extra_modules={"Factor": fmod})
    mod.os = _OsRedirect(kline_dir, cache_dir)
    return mod


def write_day_files(minute_dir, days, n_codes=8, seed=0, **synth_kw):
    """Synthetic day parquets named YYYYMMDD.parquet (the reference's
    file-table contract, MinuteFrequentFactorCICC.py:69-77)."""
    import pyarrow as pa
    import pyarrow.parquet as pq

    from ..data.synthetic import synth_day

    os.makedirs(minute_dir, exist_ok=True)
    for i, date in enumerate(days):
        rng = np.random.default_rng(seed + i)
        day = synth_day(rng, n_codes=n_codes, date=str(date), **synth_kw)
        n = len(day["code"])
        t = pa.table({
            "code": pa.array(list(day["code"]), pa.string()),
            "date": pa.array([np.datetime64(date, "D").item()] * n,
                             pa.date32()),
            "time": pa.array(np.asarray(day["time"], np.int64)),
            **{k: pa.array(np.asarray(day[k], np.float64))
               for k in ("open", "high", "low", "close", "volume")},
        })
        fname = str(date).replace("-", "") + ".parquet"
        pq.write_table(t, os.path.join(minute_dir, fname))


def run_reference_pipeline(kline_dir, cache_dir, factor_name,
                           path=None):
    """Reference cal_exposure_by_min_data (incremental resume included)
    -> {(code, date): value} and the raw row count."""
    mod = load_reference_minfreq_module(kline_dir, cache_dir)
    kmod = load_reference_kernels()
    f = mod.MinFreqFactor(factor_name)
    f.cal_exposure_by_min_data(getattr(kmod, "cal_" + factor_name),
                               path=path, n_jobs=1)
    out = f.factor_exposure
    codes = out["code"].to_numpy()
    dates = out["date"].to_numpy().astype("datetime64[D]")
    vals = out[factor_name].to_numpy()
    return {(str(c), d): float(v)
            for c, d, v in zip(codes, dates, vals)}, len(codes)


def run_repo_pipeline(minute_dir, factor_name, cache_path=None,
                      device=None):
    """Same scenario through the port's MinFreqFactor on ``device``.

    ``cache_path`` must always be explicit: ``path=None`` would resolve
    the GLOBAL ``Config.factor_dir`` cache, leaking state between
    scenarios (this exact leak produced phantom dates in an early fuzz
    run of this harness).
    """
    from ..config import Config
    from ..minfreq import MinFreqFactor

    if cache_path is None:
        cache_path = os.path.join(minute_dir,
                                  f"_refdiff_{factor_name}.parquet")
    cfg = Config(minute_dir=minute_dir, days_per_batch=4,
                 factor_dir=os.path.dirname(cache_path))
    f = MinFreqFactor(factor_name, device=device)
    f.cal_exposure_by_min_data(path=cache_path, minute_dir=minute_dir,
                               cfg=cfg, progress=False)
    exp = f.factor_exposure
    return {(str(c), np.datetime64(d, "D")): float(v)
            for c, d, v in zip(exp["code"], exp["date"],
                               exp[factor_name])}, len(exp["code"])


def compare_pipeline(tmp_dir, factor_name="vol_return1min", n_days=5,
                     n_codes=8, precompute_days=0, seed=0, device=None,
                     **synth_kw):
    """Pipeline differential: day files + optional pre-seeded cache ->
    reference incremental driver vs repo driver."""
    _require_shim()  # fail in ms, before the expensive repo precompute
    kline = os.path.join(tmp_dir, "kline")
    ref_cache_dir = os.path.join(tmp_dir, "ref_cache")
    os.makedirs(ref_cache_dir, exist_ok=True)
    all_days = np.arange(np.datetime64("2024-03-04"),
                         np.datetime64("2024-03-04") + n_days * 2)
    days = [d for d in all_days if (d.astype(int) + 3) % 7 < 5][:n_days]
    write_day_files(kline, days, n_codes=n_codes, seed=seed, **synth_kw)

    repo_cache = None
    if precompute_days:
        # seed both caches from the repo's first-pass on the early days
        early = os.path.join(tmp_dir, "early")
        write_day_files(early, days[:precompute_days], n_codes=n_codes,
                        seed=seed, **synth_kw)
        from ..config import Config
        from ..minfreq import MinFreqFactor
        f0 = MinFreqFactor(factor_name, device=device)
        f0.cal_exposure_by_min_data(
            minute_dir=early, cfg=Config(minute_dir=early),
            progress=False)
        repo_cache = os.path.join(tmp_dir, f"{factor_name}.parquet")
        f0.to_parquet(repo_cache)
        import shutil
        shutil.copy(repo_cache,
                    os.path.join(ref_cache_dir,
                                 f"{factor_name}.parquet"))

    ref_rows, ref_n = run_reference_pipeline(kline, ref_cache_dir,
                                             factor_name)
    repo_rows, repo_n = run_repo_pipeline(kline, factor_name,
                                          cache_path=repo_cache,
                                          device=device)
    failures = []
    if ref_n != len(ref_rows):
        failures.append(f"reference emitted duplicate rows "
                        f"({ref_n} vs {len(ref_rows)})")
    if repo_n != len(repo_rows):
        failures.append(f"repo emitted duplicate rows "
                        f"({repo_n} vs {len(repo_rows)})")
    for key in sorted(set(ref_rows) | set(repo_rows)):
        if key not in ref_rows or key not in repo_rows:
            failures.append(
                f"{key}: only in "
                f"{'reference' if key in ref_rows else 'repo'}")
            continue
        a, b = ref_rows[key], repo_rows[key]
        if np.isnan(a) != np.isnan(b):
            failures.append(f"{key}: nan mismatch ref={a!r} repo={b!r}")
        elif not np.isnan(a) and not np.isclose(a, b, rtol=2e-3,
                                                atol=1e-6):
            failures.append(f"{key}: ref={a!r} repo={b!r}")
    return failures


def compare_final_exposure(rng_seed=0, n_codes=10, n_days=60,
                           nan_prob=0.1, device=None):
    """cal_final_exposure differential across every (mode, method,
    frequency) config (reference MinuteFrequentFactorCICC.py:114-245)."""
    pl = _require_shim()
    rng = np.random.default_rng(rng_seed)
    exposure, _ = synth_eval_data(rng, n_codes=n_codes, n_days=n_days,
                                  nan_prob=nan_prob)
    name = "f"
    mod = load_reference_minfreq_module("/nonexistent", "/nonexistent")
    rf = mod.MinFreqFactor(name, _exposure_frame(pl, exposure, name))
    from ..minfreq import MinFreqFactor
    pf = MinFreqFactor(name, device=device).set_exposure(
        exposure["code"], exposure["date"], exposure["value"])

    _freq_map = {"weekly": "week", "monthly": "month"}
    failures = []
    configs = ([("calendar", f, m) for f in ("weekly", "monthly")
                for m in ("o", "m", "z", "std")]
               + [("days", t, m) for t in (3, 5)
                  for m in ("o", "m", "z", "std")])
    for mode, freq, method in configs:
        tag = f"{mode}/{freq}/{method}"
        ref_df = rf.cal_final_exposure(frequency=freq, method=method,
                                       mode=mode)
        repo_freq = _freq_map.get(freq, freq)
        res = pf.cal_final_exposure(frequency=repo_freq, method=method,
                                    mode=mode)
        out_name = (f"{freq}_{name}_{method}" if mode == "calendar"
                    else f"{name}_{freq}_{method}")
        repo_name = (f"{repo_freq}_{name}_{method}"
                     if mode == "calendar" else out_name)
        rcodes = ref_df["code"].to_numpy()
        rdates = ref_df["date"].to_numpy().astype("datetime64[D]")
        rvals = ref_df[out_name].to_numpy()
        ref_rows = {(str(c), d): float(v)
                    for c, d, v in zip(rcodes, rdates, rvals)}
        rex = res.factor_exposure
        repo_rows = {(str(c), np.datetime64(d, "D")): float(v)
                     for c, d, v in zip(rex["code"], rex["date"],
                                        rex[repo_name])}
        for key in sorted(set(ref_rows) | set(repo_rows)):
            if key not in ref_rows or key not in repo_rows:
                failures.append(
                    f"{tag} {key}: only in "
                    f"{'reference' if key in ref_rows else 'repo'}")
                continue
            a, b = ref_rows[key], repo_rows[key]
            if np.isnan(a) != np.isnan(b):
                failures.append(f"{tag} {key}: nan mismatch "
                                f"ref={a!r} repo={b!r}")
            # repo output is stored f32 (set_exposure) — compare at f32
            # precision against the reference's f64
            elif not np.isnan(a) and not np.isclose(a, b, rtol=5e-6,
                                                    atol=1e-6):
                failures.append(f"{tag} {key}: ref={a!r} repo={b!r}")
    return failures


def compare_day(day: dict, names=None):
    """Run both stacks on one day; return a list of mismatch strings."""
    ref = run_reference(day, names=names)
    orc = run_oracle(day, names=list(ref) if names is None else names)
    failures = []
    for name, ref_vals in sorted(ref.items()):
        orc_vals = orc.get(name, {})
        for code in sorted(set(ref_vals) | set(orc_vals)):
            rv = ref_vals.get(code, np.nan)
            ov = orc_vals.get(code, np.nan)
            if np.isnan(rv) != np.isnan(ov):
                failures.append(f"{name}/{code}: nan mismatch "
                                f"ref={rv!r} oracle={ov!r}")
                continue
            if np.isnan(rv):
                continue
            if np.isinf(rv) or np.isinf(ov):
                if not (np.isinf(rv) and np.isinf(ov)
                        and np.sign(rv) == np.sign(ov)):
                    failures.append(f"{name}/{code}: inf mismatch "
                                    f"ref={rv!r} oracle={ov!r}")
                continue
            rtol = RTOL.get(name, RTOL_DEFAULT)
            atol = ATOL.get(name, ATOL_DEFAULT)
            if not np.isclose(rv, ov, rtol=rtol, atol=atol):
                failures.append(f"{name}/{code}: ref={rv!r} oracle={ov!r}")
    return failures
