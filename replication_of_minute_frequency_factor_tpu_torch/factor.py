"""L3 evaluation & persistence — the ``Factor`` base class.

API mirrors the reference's ``Factor`` (Factor.py:7-350): exposure holder +
``coverage`` / ``ic_test`` / ``group_test`` / ``to_parquet``, with the same
summary attributes (``IC``, ``ICIR``, ``rank_IC``, ``rank_ICIR``,
Factor.py:16-19,187-190). The port of the JAX package's ``factor.py``: the
pivots, joins and calendar group-bys are the same host-side numpy
(:mod:`.frames`, copied); the per-date cross-sectional statistics run in
:mod:`.eval_ops` on the device the factor was given (the card unless
``device='cpu'``), and come back to numpy where the JAX package fetches
them.

Join semantics note (quirk Q10): the reference aligns exposure to daily
returns with ``pl.concat(how='align_left')`` on (code, date); here exposure
axes define the grid and daily data is gathered onto it — the same left
semantics without the string-keyed join.
"""

from __future__ import annotations

import os
from typing import Dict, Optional

import numpy as np
import torch

from . import eval_ops, frames
from .config import get_config
from .data import io as dio
from .pipeline import resolve_device
from .utils.logging import get_logger

logger = get_logger(__name__)


def aggregate_period_returns(labels, present, pv_present, pct_mat,
                             dates, frequency, group_num, w_mat=None):
    """The group_test HOST section: faithful align-left period
    aggregation (reference Factor.py:280-320), copied from the JAX
    package.

    The reference's ``concat(how='align_left')`` keeps the EXPOSURE
    grid's (code, date) rows, so a period's compounded return uses the
    exposure rows' joined pct_change (pv-missing days compound as 0),
    and the positional ``.last()`` picks the last exposure date of the
    period — where the group label may be null (NaN factor) and
    tmc/cmc may be null (no pv row that day); those nulls survive into
    the one-period lag exactly as in the reference, and the lag steps
    to the code's previous EXISTING period row, not blindly one period
    back (Factor.py:305-314).

    Returns ``(periods, ret_mat)``: the kept period starts and the
    ``[P, group_num]`` per-period group returns (NaN where a period has
    no usable row for a group).
    """
    period = frames.period_start(dates, frequency)  # [D], date-sorted
    pstarts = np.nonzero(np.r_[True, period[1:] != period[:-1]])[0]
    uperiods = period[pstarts]
    n_d, n_codes = pct_mat.shape
    n_p = len(uperiods)
    # straight product like the reference's (pct+1).product()-1 —
    # a log1p/expm1 formulation would NaN on pct <= -1 (delisting-to-
    # zero or bad rows) where the reference stays finite
    contrib = np.where(present & pv_present & np.isfinite(pct_mat),
                       1.0 + pct_mat, 1.0)
    ret_per = np.multiply.reduceat(contrib, pstarts, axis=0) - 1.0
    row_idx = np.where(present, np.arange(n_d)[:, None], -1)
    last_idx = np.maximum.reduceat(row_idx, pstarts, axis=0)  # [P,T]
    has_row = last_idx >= 0
    gather = np.maximum(last_idx, 0)
    lab_last = np.where(
        has_row, np.take_along_axis(labels, gather, axis=0), -1)

    # previous existing period row per code (Factor.py:305-314)
    parange = np.where(has_row, np.arange(n_p)[:, None], -1)
    prev = np.maximum.accumulate(parange, axis=0)
    prev = np.vstack([np.full((1, n_codes), -1), prev[:-1]])
    has_prev = prev >= 0
    pg = np.maximum(prev, 0)
    g_lag = np.where(
        has_prev, np.take_along_axis(lab_last, pg, axis=0), -1)
    usable = has_row & (g_lag >= 0)
    if w_mat is not None:
        w_last = np.where(
            has_row, np.take_along_axis(w_mat, gather, axis=0), np.nan)
        w = np.where(
            has_prev, np.take_along_axis(w_last, pg, axis=0), np.nan)

    ret_mat = np.full((n_p, group_num), np.nan)
    for g in range(group_num):
        sel = usable & (g_lag == g)
        any_row = sel.any(axis=1)
        if w_mat is None:
            cnt = sel.sum(axis=1)
            s = np.where(sel, ret_per, 0.0).sum(axis=1)
            with np.errstate(invalid="ignore"):
                ret_mat[:, g] = np.where(any_row, s / np.maximum(cnt, 1),
                                         np.nan)
        else:
            wok = sel & np.isfinite(w)
            wk = np.where(wok, w, 0.0)
            num = (np.where(wok, ret_per, 0.0) * wk).sum(axis=1)
            den = wk.sum(axis=1)
            # den == 0 -> 0 return (the reference's sum!=0 guard,
            # Factor.py:265-272); no usable row at all -> no output
            with np.errstate(invalid="ignore"):
                val = np.where(den != 0, num / np.where(den != 0, den,
                                                        1.0), 0.0)
            ret_mat[:, g] = np.where(any_row, val, np.nan)

    keep_p = usable.any(axis=1)
    return uperiods[keep_p], ret_mat[keep_p]


class Factor:
    """Holds one factor's long-format exposure and evaluates it.

    ``device`` is where :meth:`coverage`, :meth:`ic_test` and
    :meth:`group_test` run their cross-sectional ops: the card by default
    (raising when there is none), or ``'cpu'`` when asked."""

    def __init__(self, factor_name: str, factor_exposure=None, *,
                 device=None):
        self.factor_name = factor_name
        self.device = device
        #: dict(code=[N] str, date=[N] datetime64[D], <factor_name>=[N] f32)
        self.factor_exposure: Optional[Dict[str, np.ndarray]] = None
        self.IC: Optional[float] = None
        self.ICIR: Optional[float] = None
        self.rank_IC: Optional[float] = None
        self.rank_ICIR: Optional[float] = None
        if factor_exposure is not None:
            # the reference's second positional (Factor.py:8): any
            # mapping with code/date/<factor_name> columns
            self.set_exposure(factor_exposure["code"],
                              factor_exposure["date"],
                              factor_exposure[factor_name])

    # ------------------------------------------------------------------
    # data access
    # ------------------------------------------------------------------
    def set_exposure(self, code, date, value) -> "Factor":
        self.factor_exposure = {
            "code": np.asarray(code, dtype=object),
            "date": np.asarray(date, dtype="datetime64[D]"),
            self.factor_name: np.asarray(value, dtype=np.float32),
        }
        return self

    def _require_exposure(self) -> Dict[str, np.ndarray]:
        if self.factor_exposure is None:
            raise RuntimeError(
                f"factor {self.factor_name!r} has no exposure loaded")
        return self.factor_exposure

    def _read_daily_pv_data(self, columns=None,
                            path: Optional[str] = None) -> Dict[str, np.ndarray]:
        """Daily PV loader (reference Factor.py:21-62) — CSMAR renames +
        date parsing + column projection, path from config instead of the
        hardcoded ``D:\\QuantData`` root."""
        path = path or get_config().daily_pv_path
        pv = dio.read_daily_pv(path, columns)
        if "code" in pv and "date" in pv and len(pv["code"]):
            # daily data is one row per (code, date) by construction; a
            # duplicated key would silently compound twice in the
            # reference but be deduped by the matrix pivots here — make
            # malformed input loud instead (clean-divergence policy, Q8)
            key = np.rec.fromarrays(
                [np.asarray(pv["code"]).astype(str),  # exact itemsize
                 np.asarray(pv["date"], dtype="datetime64[D]")])
            if len(np.unique(key)) != len(key):
                raise ValueError(
                    f"daily PV data at {path!r} has duplicate "
                    f"(code, date) rows "
                    f"({len(key) - len(np.unique(key))} extras)")
        return pv

    # ------------------------------------------------------------------
    # persistence (reference Factor.py:64-90)
    # ------------------------------------------------------------------
    def _resolve_path(self, path: Optional[str]) -> str:
        path = path or get_config().factor_dir
        if os.path.isdir(path) or not path.endswith(".parquet"):
            path = os.path.join(path, f"{self.factor_name}.parquet")
        return path

    def to_parquet(self, path: Optional[str] = None) -> str:
        import pyarrow as pa

        exp = self._require_exposure()
        table = pa.table({
            "code": pa.array([str(c) for c in exp["code"]], pa.string()),
            "date": pa.array(exp["date"]),
            self.factor_name: pa.array(
                np.asarray(exp[self.factor_name], np.float32)),
        })
        path = self._resolve_path(path)
        dio.write_parquet_atomic(table, path)
        return path

    def read_parquet(self, path: Optional[str] = None) -> "Factor":
        import pyarrow.parquet as pq

        t = pq.read_table(self._resolve_path(path))
        self.set_exposure(
            np.asarray(t.column("code").to_pylist(), dtype=object),
            t.column("date").to_numpy(zero_copy_only=False),
            t.column(self.factor_name).to_numpy(zero_copy_only=False))
        return self

    # ------------------------------------------------------------------
    # evaluation
    # ------------------------------------------------------------------
    def _exposure_matrix(self, with_present: bool = False):
        exp = self._require_exposure()
        mat, present, dates, codes = frames.long_to_matrix(
            exp["code"], exp["date"], exp[self.factor_name])
        valid = present & np.isfinite(mat)
        if with_present:
            return mat, valid, present, dates, codes
        return mat, valid, dates, codes

    def coverage(self, plot: bool = True, return_df: bool = False,
                 save_path: Optional[str] = None,
                 plot_out: Optional[bool] = None):
        """Per-date usable-exposure counts (reference Factor.py:92-125).

        ``plot_out`` is the reference's spelling of ``plot`` (accepted so
        reference call sites port verbatim)."""
        if plot_out is not None:
            plot = plot_out
        dev = resolve_device(self.device)
        _, valid, dates, _ = self._exposure_matrix()
        counts = eval_ops.coverage_counts(
            torch.from_numpy(valid).to(dev)).cpu().numpy()
        fig = None
        if plot:
            from . import plotting
            fig = plotting.plot_coverage(dates, counts, self.factor_name,
                                         save_path)
        if return_df:
            return {"date": dates, "coverage": counts}
        return fig

    def ic_test(self, future_days: int = 5, plot: bool = True,
                return_df: bool = False, save_path: Optional[str] = None,
                daily_pv_path: Optional[str] = None,
                plot_out: Optional[bool] = None,
                plot_variable: str = "IC"):
        """Pearson/Spearman IC vs. the future ``future_days``-day return
        (reference Factor.py:127-229).

        Sets ``IC/ICIR/rank_IC/rank_ICIR``; ICIR uses sample std (ddof=1)
        of the per-date IC series. ``plot_out`` is the reference's
        spelling of ``plot``; ``plot_variable`` ('IC' or 'rank_IC')
        selects the plotted series (Factor.py:131,191-226).

        Compatibility is KEYWORD-level: the reference's positional order
        is ``(future_days, plot_out, plot_variable, return_df)`` and
        differs from this signature after the first argument — port
        positional reference call sites to keywords (docs/MIGRATION.md).
        """
        if plot_out is not None:
            plot = plot_out
        if plot_variable not in ("IC", "rank_IC"):
            raise ValueError(
                f"plot_variable must be 'IC' or 'rank_IC', "
                f"got {plot_variable!r}")
        dev = resolve_device(self.device)
        mat, valid, dates, codes = self._exposure_matrix()
        pv = self._read_daily_pv_data(["code", "date", "pct_change"],
                                      path=daily_pv_path)
        fwd = frames.forward_returns(pv["code"], pv["date"],
                                     pv["pct_change"], future_days)
        fwd_mat, fwd_present, _, _ = frames.long_to_matrix(
            pv["code"], pv["date"], fwd, codes=codes, dates=dates)
        both = valid & fwd_present & np.isfinite(fwd_mat)
        ic, rank_ic = eval_ops.ic_series(
            *(torch.from_numpy(a).to(dev) for a in (
                np.nan_to_num(mat), np.nan_to_num(fwd_mat), both)))
        ic = ic.cpu().numpy()
        rank_ic = rank_ic.cpu().numpy()
        keep = np.isfinite(ic)  # drop dates with no usable cross-section
        ic_k, rank_k, dates_k = ic[keep], rank_ic[keep], dates[keep]
        if len(ic_k):
            self.IC = float(np.mean(ic_k))
            self.ICIR = float(np.mean(ic_k) / np.std(ic_k, ddof=1))
            self.rank_IC = float(np.nanmean(rank_k))
            self.rank_ICIR = float(
                np.nanmean(rank_k) / np.nanstd(rank_k, ddof=1))
        else:
            logger.warning(
                "ic_test: no date with a usable cross-section — exposure "
                "and daily PV data share no (code, date) pairs with finite "
                "forward returns; IC stats left as None. Check that both "
                "sources cover the same dates and code format.")
        stats = {"IC": self.IC, "ICIR": self.ICIR,
                 "rank_IC": self.rank_IC, "rank_ICIR": self.rank_ICIR}
        fig = None
        if plot and len(ic_k):
            from . import plotting
            if plot_variable == "rank_IC":
                series = rank_k
                pstats = {"rank_IC": self.rank_IC,
                          "rank_ICIR": self.rank_ICIR}
            else:
                series = ic_k
                pstats = {"IC": self.IC, "ICIR": self.ICIR}
            fig = plotting.plot_ic(dates_k, series, self.factor_name,
                                   stats=pstats, save_path=save_path,
                                   label=plot_variable)
        if return_df:
            return {"date": dates_k, "IC": ic_k, "rank_IC": rank_k}
        return stats if fig is None else fig

    def group_test(self, frequency: str = "month",
                   weight_param: Optional[str] = None, group_num: int = 5,
                   plot: bool = True, return_df: bool = False,
                   save_path: Optional[str] = None,
                   daily_pv_path: Optional[str] = None,
                   plot_out: Optional[bool] = None):
        """Decile backtest (reference Factor.py:231-350).

        Per-date quantile buckets -> calendar resample (week/month/quarter/
        year) of compounded returns per stock -> one-period lag of group
        label and market caps (the lookahead guard, Factor.py:305-314) ->
        equal/'tmc'/'cmc'-weighted group returns per period.

        Bad ``frequency``/``weight_param`` raise ``ValueError`` (the
        reference crashed with ``NameError`` — quirk Q8, fixed).
        """
        if plot_out is not None:  # the reference's spelling of ``plot``
            plot = plot_out
        if weight_param not in (None, "tmc", "cmc"):
            raise ValueError(
                f"weight_param must be None/'tmc'/'cmc', got {weight_param!r}")
        dev = resolve_device(self.device)
        mat, valid, present, dates, codes = self._exposure_matrix(
            with_present=True)
        if mat.size == 0:
            empty = np.empty((0, group_num))
            return ({"period": dates[:0], "group_return": empty,
                     "cum_return": empty} if return_df else None)
        labels = eval_ops.qcut_labels(
            *(torch.from_numpy(a).to(dev) for a in (np.nan_to_num(mat),
                                                     valid)),
            group_num,
            # value-NaN only: +/-inf exposures are NOT NaN-bucketed under
            # total order
            nan_lanes=torch.from_numpy(present & np.isnan(mat)).to(dev),
        ).cpu().numpy()

        pv = self._read_daily_pv_data(
            ["code", "date", "pct_change", "tmc", "cmc"], path=daily_pv_path)
        pct_mat, pv_present, _, _ = frames.long_to_matrix(
            pv["code"], pv["date"], pv["pct_change"], codes=codes,
            dates=dates, dtype=np.float64)
        if weight_param is not None:
            ones = np.ones(len(pv["code"]), np.float64)
            w_mat, _, _, _ = frames.long_to_matrix(
                pv["code"], pv["date"],
                np.asarray(pv.get(weight_param, ones), np.float64),
                codes=codes, dates=dates, dtype=np.float64)

        periods, ret_mat = aggregate_period_returns(
            labels, present, pv_present, pct_mat, dates, frequency,
            group_num,
            w_mat=w_mat if weight_param is not None else None)
        cum = np.cumprod(np.nan_to_num(ret_mat) + 1.0, axis=0) - 1.0

        fig = None
        if plot and len(periods):
            from . import plotting
            fig = plotting.plot_group_returns(
                periods, cum, self.factor_name,
                labels=[f"G{j}" for j in range(group_num)],
                save_path=save_path)
        if return_df:
            return {"period": periods, "group_return": ret_mat,
                    "cum_return": cum}
        return fig
