"""``MinFreqFactor`` — the minute-factor pipeline class (L2 user API).

Mirrors the reference's ``MinFreqFactor(Factor)``
(MinuteFrequentFactorCICC.py:8-245): exposure-cache resolution
(``_read_exposure``, :27-48), the batch/incremental compute entry point
(``cal_exposure_by_min_data``, :50-112) and the final-exposure resampler
(``cal_final_exposure``, :114-245). The port of the JAX package's
``minfreq.py``: the compute driver is the port's
:func:`~.pipeline.compute_exposures` on the factor's device, and the
resampler is the same host numpy, copied.
"""

from __future__ import annotations

import os
from typing import Callable, Optional, Union

import numpy as np

from . import frames
from .config import Config, get_config
from .factor import Factor
from .models.registry import factor_names, register_alias
from .pipeline import compute_exposures

AGG_METHODS = ("o", "m", "z", "std")


class MinFreqFactor(Factor):
    """One minute-frequency factor: compute, cache, resample, evaluate.

    ``device`` as in :class:`~.factor.Factor`: it is also where
    :meth:`cal_exposure_by_min_data` computes."""

    def __init__(self, factor_name: str, factor_exposure=None, *,
                 device=None):
        super().__init__(factor_name, factor_exposure, device=device)

    # ------------------------------------------------------------------
    # cache resolution (reference :27-48)
    # ------------------------------------------------------------------
    def _read_exposure(self, path: Optional[str] = None, default=None):
        """Load a cached exposure. ``path`` may be the parquet file itself
        or a directory containing ``<factor_name>.parquet``; returns
        ``default`` when no cache exists (the caller then computes from
        scratch) — the reference's third positional argument (:27-48)."""
        path = self._resolve_path(path)
        if not os.path.exists(path):
            return default
        self.read_parquet(path)
        return self.factor_exposure

    # ------------------------------------------------------------------
    # batch/incremental compute (reference :50-112)
    # ------------------------------------------------------------------
    def cal_exposure_by_min_data(
        self,
        calculate_method: Union[str, Callable, None] = None,
        path: Optional[str] = None,
        n_jobs: Optional[int] = None,
        minute_dir: Optional[str] = None,
        cfg: Optional[Config] = None,
        progress: bool = True,
        fault_hook=None,
        retry_failed: bool = False,
    ) -> "MinFreqFactor":
        """Compute this factor for every day file, resuming incrementally.

        The resume rule is the reference's: only day files NEWER than the
        cached max date recompute, so a day that failed mid-run while
        later days completed is never retried by a plain rerun — pass
        ``retry_failed=True`` to also recompute the days recorded in
        ``<cache>.failures.json``.

        ``calculate_method`` is a registered kernel name (defaults to
        ``factor_name``) or an ad-hoc kernel ``fn(ctx) -> [..., T]`` —
        the reference passed the ``cal_xxx`` function object here
        (MinuteFrequentFactorCICC.py:50). The exposure cache at ``path``
        follows the reference's contract: only day files newer than the
        cached max date recompute.

        ``n_jobs`` (the reference's joblib process count, :54) is accepted
        for drop-in compatibility and ignored: there is no process pool —
        days batch through one device pass.
        """
        del n_jobs
        cfg = cfg or get_config()
        name = self.factor_name
        if calculate_method is not None:
            if isinstance(calculate_method, str) \
                    and calculate_method not in factor_names():
                raise KeyError(
                    f"unknown factor kernel {calculate_method!r}")
            # expose the kernel under this factor's name so the cache column
            # carries factor_name (reference cached <factor_name>.parquet
            # whatever cal_* method produced it)
            register_alias(name, calculate_method)
        elif name not in factor_names():
            raise KeyError(
                f"{name!r} is not a registered kernel; pass "
                f"calculate_method= (one of {len(factor_names())} names)")

        cache_path = self._resolve_path(path)
        table = compute_exposures(
            minute_dir=minute_dir, names=(name,), cache_path=cache_path,
            cfg=cfg, progress=progress, fault_hook=fault_hook,
            retry_failed=retry_failed, device=self.device)
        self.failures = getattr(table, "failures", None)
        self.set_exposure(table.columns["code"], table.columns["date"],
                          table.columns[name])
        return self

    # ------------------------------------------------------------------
    # final-exposure resampling (reference :114-245)
    # ------------------------------------------------------------------
    def cal_final_exposure(
        self,
        frequency: Union[str, int] = "week",
        method: str = "o",
        mode: str = "calendar",
        stock_pool: str = "full",
        pool: Optional[str] = None,
    ) -> "MinFreqFactor":
        """Resample the daily exposure along the date axis, per code.

        ``mode='calendar'``: calendar buckets (week/month/quarter/year) with
        aggregation ``method`` — 'o' last, 'm' mean, 'z' (last-mean)/std,
        'std' — output named ``{frequency}_{name}_{method}``
        (reference :130-186, column naming :141).

        ``mode='days'``: rolling ``frequency``-day window over each code's
        own trading days, ``min_samples = frequency``; 'z' and 'std' use
        population std (ddof=0, reference :222,234); output named
        ``{name}_{t}_{method}`` (:189).

        ``stock_pool``: the reference advertises index pools (hs300/
        zz500/zz1000) but raises for anything except ``'full'`` (quirk
        Q9, MinuteFrequentFactorCICC.py:137-140). Here a non-'full' pool
        works when ``Config.stock_pool_path`` names a membership parquet
        (exact member-days or CSMAR in/out-date intervals — see
        ``data.io.read_stock_pool``): exposure rows outside the pool are
        dropped before resampling. Without a configured membership file
        the reference's error is kept.

        Host numpy only; the result carries this factor's ``device``.
        """
        if pool is not None:  # the reference's spelling of stock_pool
            stock_pool = pool
        if method not in AGG_METHODS:
            raise ValueError(f"method must be one of {AGG_METHODS}")
        exp = self._require_exposure()
        code, date = exp["code"], exp["date"]
        val = np.asarray(exp[self.factor_name], np.float64)

        if stock_pool != "full":
            pool_path = get_config().stock_pool_path
            if pool_path is None:
                raise ValueError(
                    "stock_pool={!r} needs Config.stock_pool_path (a "
                    "membership parquet); without one only 'full' exists "
                    "— the reference itself raises here (quirk Q9, "
                    "MinuteFrequentFactorCICC.py:137-140)".format(stock_pool))
            from .data import io as dio
            pc, pd_ = dio.read_stock_pool(pool_path, stock_pool,
                                          np.unique(date))
            sel = dio.membership_filter(code, date, pc, pd_)
            code, date, val = code[sel], date[sel], val[sel]

        if mode == "calendar":
            period = frames.period_start(date, frequency)
            order, seg, n = frames.group_segments(code, period)
            v = val[order]
            nanv = ~np.isfinite(v)
            cnt = np.zeros(n)
            s = np.zeros(n)
            ss = np.zeros(n)
            np.add.at(cnt, seg[~nanv], 1.0)
            np.add.at(s, seg[~nanv], v[~nanv])
            np.add.at(ss, seg[~nanv], v[~nanv] ** 2)
            with np.errstate(invalid="ignore", divide="ignore"):
                mean = s / cnt
                std1 = np.sqrt(np.maximum(ss - cnt * mean**2, 0.0)
                               / (cnt - 1))
            # exactly-constant groups: sum-of-squares rounding can leave a
            # tiny nonzero std (turning the z-score's 0/0 into garbage);
            # segment min==max detects them exactly. cnt==1 keeps its NaN
            # std (ddof=1), matching polars' null.
            smin = np.full(n, np.inf)
            smax = np.full(n, -np.inf)
            np.minimum.at(smin, seg[~nanv], v[~nanv])
            np.maximum.at(smax, seg[~nanv], v[~nanv])
            const_s = (cnt > 0) & (smin == smax)
            mean = np.where(const_s, smin, mean)
            std1 = np.where(const_s & (cnt > 1), 0.0, std1)
            # 'last' skips NaN like polars .last() skips... (polars last()
            # returns the literal last element; NaN rows were never written
            # by the pipeline as nulls — keep literal last)
            last = frames.segment_last(v, seg, n)
            with np.errstate(invalid="ignore", divide="ignore"):
                if method == "o":
                    out = last
                elif method == "m":
                    out = mean
                elif method == "z":
                    out = (last - mean) / std1  # 0/0 (constant) -> NaN
                else:
                    out = std1
            out_code = frames.segment_last(np.asarray(code, object)[order],
                                           seg, n)
            out_date = frames.segment_last(period[order], seg, n)
            new_name = f"{frequency}_{self.factor_name}_{method}"
        elif mode == "days":
            t = int(frequency)
            if t < 1:
                raise ValueError(f"rolling window must be >= 1 day, got {t}")
            if method == "o":
                # pure passthrough rename — NO rolling window and NO
                # min_samples mask (MinuteFrequentFactorCICC.py:190-198,
                # verified by tools/refdiff compare_final_exposure); skip
                # the window machinery entirely
                out, out_code, out_date = val.copy(), code, date
                new_name = f"{self.factor_name}_{t}_{method}"
                return self._finish_final_exposure(out_code, out_date,
                                                   out, new_name)
            order = np.lexsort((date, code))
            c, v = np.asarray(code, object)[order], val[order]
            grp_start = np.r_[True, c[1:] != c[:-1]]
            gid = np.cumsum(grp_start) - 1
            first_of_group = np.flatnonzero(grp_start)[gid]
            idx = np.arange(len(v))
            pos = idx - first_of_group  # row index within the code group
            nanv = ~np.isfinite(v)
            cs = np.r_[0.0, np.cumsum(np.where(nanv, 0.0, v))]
            css = np.r_[0.0, np.cumsum(np.where(nanv, 0.0, v * v))]
            cb = np.r_[0, np.cumsum(nanv)]
            lo = idx - t + 1
            ok = (pos >= t - 1)
            lo_c = np.maximum(lo, 0)
            wsum = cs[idx + 1] - cs[lo_c]
            wss = css[idx + 1] - css[lo_c]
            wbad = (cb[idx + 1] - cb[lo_c]) > 0
            with np.errstate(invalid="ignore", divide="ignore"):
                mean = wsum / t
                var0 = np.maximum(wss / t - mean**2, 0.0)  # ddof=0 (:222,234)
                std0 = np.sqrt(var0)
            # Exactly-constant windows (every window when t == 1):
            # prefix-sum differencing cannot represent their zero variance
            # — cs rounding leaves std0 tiny-nonzero or mean != v, turning
            # the z-score's 0/0 into garbage. A window ending at idx is
            # constant iff the run of adjacent-equal non-NaN values ending
            # there spans it (O(n), vs O(n*t) windowed min/max); its mean
            # is then the row's own value exactly. Windows crossing code
            # groups or containing NaN are masked by ok/wbad below, so a
            # run continuing across a group boundary never ships.
            eq = np.zeros(len(v), bool)
            if len(v) > 1:
                eq[1:] = ~nanv[1:] & ~nanv[:-1] & (v[1:] == v[:-1])
            run = idx - np.maximum.accumulate(np.where(~eq, idx, 0))
            const_w = (run >= t - 1) & ~nanv
            mean = np.where(const_w, v, mean)  # const_w excludes NaN rows
            std0 = np.where(const_w, 0.0, std0)
            with np.errstate(invalid="ignore", divide="ignore"):
                if method == "m":
                    res = mean
                elif method == "z":
                    res = (v - mean) / std0
                else:
                    res = std0
            res = np.where(ok & ~wbad, res, np.nan)
            out = np.empty_like(res)
            out[order] = res
            out_code, out_date = code, date
            new_name = f"{self.factor_name}_{t}_{method}"
        else:
            raise ValueError(f"mode must be 'calendar' or 'days', got {mode!r}")

        return self._finish_final_exposure(out_code, out_date, out,
                                           new_name)

    def _finish_final_exposure(self, out_code, out_date, out, new_name):
        result = MinFreqFactor(new_name, device=self.device)
        result.set_exposure(out_code, np.asarray(out_date, "datetime64[D]"),
                            np.asarray(out, np.float32))
        # sorted (date, code) like every exposure (SURVEY.md §2.3)
        o = np.lexsort((result.factor_exposure["code"],
                        result.factor_exposure["date"]))
        result.factor_exposure = {k: np.asarray(vv)[o]
                                  for k, vv in result.factor_exposure.items()}
        return result
