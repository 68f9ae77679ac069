"""Shared-intermediate context for the factor kernels.

The reference recomputes returns/shares/rolling stats inside every kernel
(one polars pass per factor). Here every intermediate is computed at most
once per day tensor and shared by all factors that need it. The port of
the JAX package's ``models/context.py``.

Field layout follows :mod:`..data.minute` (open, high, low, close, volume).
"""

from __future__ import annotations

import torch

from ..data.minute import F_CLOSE, F_HIGH, F_LOW, F_OPEN, F_VOLUME
from ..markets import get_session
from ..ops import (
    masked_last,
    masked_mean,
    masked_std,
    masked_sum,
    pct_change_valid,
    rank_average,
    rolling_window_stats,
)
from ..utils.upload import to_device


class DayContext:
    """Lazily-memoised intermediates over ``bars [..., T, S, 5]``.

    ``mask [..., T, S]`` marks present bars. All downstream factor values
    have shape ``[..., T]``.
    """

    #: the mmt_ols_* family's window length in trade minutes (reference
    #: ``period='50i'``) — shared by every rolling backend
    ROLLING_WINDOW = 50

    def __init__(self, bars, mask, replicate_quirks: bool = True,
                 rolling_impl: str = None, xs_axis_name: str = None,
                 inject: dict = None, session=None):
        self.bars = bars
        self.mask = mask
        #: the market session spec: slot count, grid times and the
        #: sentinel boundaries the time-filter kernels consult
        #: (``ctx.session.T_CLOSE_AUCTION`` etc.); None resolves the
        #: canonical ``cn_ashare_240``
        self.session = get_session(session)
        if bars.shape[-2] != self.session.n_slots:
            raise ValueError(
                f"bars have {bars.shape[-2]} slots per day; session "
                f"{self.session.name!r} has {self.session.n_slots}")
        self.replicate_quirks = replicate_quirks
        self.rolling_impl = rolling_impl  # None -> Config.rolling_impl
        #: the mesh axis the tickers dim is sharded over when this context
        #: runs on one rank of a mesh (the sharded resident loops), resolved
        #: through the active mesh (``with mesh:``); None = the tickers axis
        #: is whole. Only the cross-sectional intermediates consult it.
        self.xs_axis_name = xs_axis_name
        #: ``inject`` seeds the memo with intermediates computed elsewhere:
        #: the streaming finalize's carry leaves (stream/carry.py). An
        #: injected value must be bitwise what the batch formulation
        #: computes from (bars, mask), which holds for the reorder-exact
        #: class only (integer counts, pure selections; ops/incremental.py).
        #: The carry's ``n_bars`` is int32 where ``mask.sum`` gives int64;
        #: every consumer reads it through ``has_bars`` (``> 0``), which
        #: is the same for both.
        self._memo = dict(inject) if inject else {}
        #: HHMMSSmmm per slot (int64, on the bars' device), broadcastable
        #: against [..., T, S]
        self.times = to_device(self.session.grid_times, bars.device)

    # --- raw fields -----------------------------------------------------
    @property
    def open(self):
        return self.bars[..., F_OPEN]

    @property
    def high(self):
        return self.bars[..., F_HIGH]

    @property
    def low(self):
        return self.bars[..., F_LOW]

    @property
    def close(self):
        return self.bars[..., F_CLOSE]

    @property
    def volume(self):
        return self.bars[..., F_VOLUME]

    def _get(self, key, fn):
        if key not in self._memo:
            self._memo[key] = fn()
        return self._memo[key]

    # --- shared intermediates -------------------------------------------
    @property
    def n_bars(self):
        return self._get("n_bars", lambda: self.mask.sum(dim=-1))

    @property
    def has_bars(self):
        return self._get("has_bars", lambda: self.n_bars > 0)

    @property
    def ret_co(self):
        """close/open - 1 per bar (the reference's intrabar 'return').

        Computed as (close-open)/open: the subtraction of nearby f32 prices
        is exact (Sterbenz), so the tiny return keeps full relative
        precision.
        """
        return self._get("ret_co",
                         lambda: (self.close - self.open) / self.open)

    @property
    def ratio_co(self):
        """close/open per bar (momentum products)."""
        return self._get("ratio_co", lambda: self.close / self.open)

    @property
    def range_hl(self):
        return self._get("range_hl", lambda: self.high / self.low)

    @property
    def pct_close(self):
        """(values, ok): close pct-change over consecutive present bars."""
        return self._get("pct_close",
                         lambda: pct_change_valid(self.close, self.mask))

    @property
    def vol_sum(self):
        return self._get("vol_sum",
                         lambda: masked_sum(self.volume, self.mask))

    @property
    def vol_share(self):
        """volume / day-total volume (NaN on zero-volume days, as 0/0)."""
        return self._get(
            "vol_share", lambda: self.volume / self.vol_sum[..., None])

    @property
    def last_close(self):
        """Last present bar's close, ``[..., T]`` — the end-of-day anchor
        of the chip family."""
        return self._get("last_close",
                         lambda: masked_last(self.close, self.mask))

    @property
    def eod_ret(self):
        """last present close / close per bar — the chip factors' 'return'
        (reference MinuteFrequentFactorCalculateMethodsCICC.py:946-947)."""
        return self._get("eod_ret",
                         lambda: self.last_close[..., None] / self.close)

    @property
    def eod_ret_global_rank(self):
        """Average-tie rank of ``eod_ret`` across the ENTIRE day frame
        (all tickers x slots, one rank per day), matching the reference's
        whole-frame ``.rank()`` in the ``doc_pdf*`` kernels (:1016) — the
        rank there is *not* per stock.

        With ``xs_axis_name`` set this is the one intermediate that
        communicates: it goes through
        :func:`..parallel.collectives.xs_global_rank_local` (all-gather
        the cross-section over the axis's group, rank the whole frame,
        this rank's lanes back), bitwise the single-device rank."""
        def f():
            v, m = self.eod_ret, self.mask
            flat = v.shape[:-2] + (v.shape[-2] * v.shape[-1],)
            if self.xs_axis_name is not None:
                # imported here: collectives imports the registry, which
                # imports this module
                from ..parallel.collectives import xs_global_rank_local
                r = xs_global_rank_local(v.reshape(flat), m.reshape(flat),
                                         self.xs_axis_name)
            else:
                r = rank_average(v.reshape(flat), m.reshape(flat))
            return r.reshape(v.shape)
        return self._get("eod_grank", f)

    @property
    def rolling50(self):
        """Windowed (low, high) regression stats over
        :data:`ROLLING_WINDOW` trade minutes — the single largest shared
        intermediate (all five mmt_ols_* kernels read it, so one batch
        launches the second-moment kernel once). ``self.rolling_impl``
        picks the backend (ops/rolling.ROLLING_IMPLS)."""
        return self._get(
            "rolling50",
            lambda: rolling_window_stats(self.low, self.high, self.mask,
                                         self.ROLLING_WINDOW,
                                         impl=self.rolling_impl))

    @property
    def rolling_beta(self):
        """Per-window beta with the reference's var_x=0 fallback
        (cov/var_x, else mean_high/mean_low; :130-134). Garbage outside
        ``rolling50['valid']`` lanes."""
        def f():
            st = self.rolling50
            return torch.where(st["var_x"] != 0.0,
                               st["cov"] / st["var_x"],
                               st["mean_y"] / st["mean_x"])
        return self._get("rolling_beta", f)

    def beta_moments(self):
        """(mean, std ddof=1, last, n_windows) of beta over valid windows.

        ``std`` snaps to exactly 0 below f32 resolution (16 ulps of the
        beta scale): when two windows' betas are EQUAL in exact
        arithmetic the f64 oracle computes std==0 and takes the
        degenerate branch of ``mmt_ols_qrs``/``mmt_ols_beta_zscore_last``,
        while f32 round-off yields a tiny nonzero std whose z-scores are
        pure noise amplification. The snap is backend-independent, as in
        the JAX package."""
        def f():
            st = self.rolling50
            valid, beta = st["valid"], self.rolling_beta
            n = valid.sum(dim=-1)
            mean = masked_mean(beta, valid)
            std = masked_std(beta, valid)
            last = masked_last(beta, valid)
            scale = torch.maximum(mean.abs(), last.abs())
            eps = torch.finfo(torch.float32).eps
            std = torch.where(std <= 16 * eps * scale, 0.0, std)
            return mean, std, last, n
        return self._get("beta_moments", f)

    def time_mask(self, lo=None, hi=None, lo_strict=False, hi_strict=False):
        """Present-bar mask additionally bounded by HHMMSSmmm sentinels."""
        m = self.mask
        if lo is not None:
            m = m & ((self.times > lo) if lo_strict else (self.times >= lo))
        if hi is not None:
            m = m & ((self.times < hi) if hi_strict else (self.times <= hi))
        return m
