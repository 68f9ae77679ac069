"""O(1)-per-bar fast finalize: the foldable kernels materialized from
the carried sufficient statistics alone.

The port of the JAX package's ``stream/fastpath.py``. The exact finalize
(``carry.finalize``) re-reads the carried bar prefix, bitwise but O(day)
work a snapshot. For every kernel whose ``finalize_class`` is
``exact_fold`` or ``stat_fold`` a closed form exists over the carried
per-lane statistics (``ops/incremental.py``), so a snapshot of those
factors costs O(F·T) whatever the cursor; ``batch_only`` kernels ride
the batch-prefix residual and keep the exact finalize's bits.

Exactness per class: ``exact_fold`` reads reorder-exact leaves only and
is bitwise the batch kernel; ``stat_fold`` reads f32 accumulators whose
order differs from the batch reduction's, each factor's divergence
pinned by :data:`STAT_FOLD_BOUNDS` (the JAX package's values).
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch

from ..models.registry import finalize_classes

_NAN = float("nan")

#: finalize classes a fast formula exists for
FOLDABLE_CLASSES = ("exact_fold", "stat_fold")


# --------------------------------------------------------------------------
# shared sub-formulas (each mirrors its ops/masked.py batch twin's
# guard structure exactly — only the moment SOURCE differs)
# --------------------------------------------------------------------------


def _std_unbiased(n, m2):
    """``masked_std`` (ddof=1) from a Welford M2 and its count: NaN
    below 2 observations, like the batch two-pass form."""
    nf = n.to(torch.float32)
    return torch.sqrt(torch.where(
        n > 1, m2 / torch.clamp(nf - 1.0, min=1.0), _NAN))


def _g1(n, m2, m3):
    """Biased Fisher-Pearson skew g1 from Welford M2/M3 (``masked_skew``
    twin: m2 == 0 degenerates to the same NaN/inf)."""
    nn = torch.clamp(n, min=1).to(torch.float32)
    m2b = m2 / nn
    m3b = m3 / nn
    return torch.where(n > 0, m3b / torch.pow(m2b, 1.5), _NAN)


def _g2(n, m2, m4):
    """Biased Fisher excess kurtosis from Welford M2/M4."""
    nn = torch.clamp(n, min=1).to(torch.float32)
    m2b = m2 / nn
    m4b = m4 / nn
    return torch.where(n > 0, m4b / (m2b * m2b) - 3.0, _NAN)


def _signed_vol(inc, leaf):
    """``volatility._signed_vol`` twin: std of the same-sign return
    subset, <2 subset bars -> 0, absent stock -> NaN."""
    n_sel = inc[f"st_{leaf}_n"]
    s = _std_unbiased(n_sel, inc[f"st_{leaf}_m2"])
    out = torch.where(n_sel < 2, 0.0, s)
    return torch.where(inc["bars"] > 0, out, _NAN)


def _win_over_total(inc, window):
    """``trade_flow._window_over_total`` twin: window volume / day
    volume with the 0.125 zero-volume-day fallback."""
    total = inc["vol_sum"]
    out = torch.where(total > 0.0, inc[f"st_volsum_{window}"] / total,
                      0.125)
    return torch.where(inc["bars"] > 0, out, _NAN)


def _sentinel_ratio(inc, window):
    """``momentum._sentinel_ratio`` twin from the carried selections:
    last in-window close / first in-window open (NaN/NaN -> NaN when
    the window never fired, quirk Q6's degradation included — a single
    present sentinel bar makes first == last == that bar)."""
    return inc[f"sel_last_close_{window}"] / inc[f"sel_first_open_{window}"]


def _paratio(inc):
    """``mmt_paratio`` twin: PM minus AM session momentum from the
    per-half selection leaves, 0 when only one half exists, NaN when
    neither does — the same where() ladder as the batch kernel over
    bitwise-equal first/last values."""
    has_am = inc["am"] > 0
    has_pm = inc["pm"] > 0
    am_v = inc["sel_last_close_am"] / inc["sel_first_open_am"] - 1.0
    pm_v = inc["sel_last_close_pm"] / inc["sel_first_open_pm"] - 1.0
    out = torch.where(has_am & has_pm, pm_v - am_v, 0.0)
    return torch.where(has_am | has_pm, out, _NAN)


def _bottom20(inc):
    """``trade_bottom20retRatio`` twin: the +1 denominator guard, sum
    of ret·volume folded per bar, one division at finalize (the batch
    form divides every term — algebraically equal, rtol-bounded)."""
    out = inc["st_rv_tail20"] / (inc["st_volsum_tail20"] + 1.0)
    return torch.where(inc["tail20"] > 0, out, _NAN)


def _bottom50(inc):
    """``trade_bottom50retRatio`` twin (the ``== 0 -> 1`` guard)."""
    s = inc["st_volsum_tail50"]
    out = inc["st_rv_tail50"] / torch.where(s == 0.0, 1.0, s)
    return torch.where(inc["tail50"] > 0, out, _NAN)


#: kernel name -> materialization from the ``inc`` statistic leaves.
#: The ``shape_*Vol`` rows exploit scale invariance: g1/g2 of
#: ``vol_share = volume / vol_sum`` equal g1/g2 of raw volume (a
#: zero-volume day degenerates to the same 0/0 NaN via M2 == 0).
FAST_FORMULAS = {
    # volatility (std family)
    "vol_volume1min": lambda inc: _std_unbiased(inc["bars"],
                                                inc["st_volu_m2"]),
    "vol_range1min": lambda inc: _std_unbiased(inc["bars"],
                                               inc["st_range_m2"]),
    "vol_return1min": lambda inc: _std_unbiased(inc["bars"],
                                                inc["st_ret_m2"]),
    "vol_upVol": lambda inc: _signed_vol(inc, "retpos"),
    "vol_downVol": lambda inc: _signed_vol(inc, "retneg"),
    "vol_upRatio": lambda inc: _signed_vol(inc, "retpos") / _std_unbiased(
        inc["bars"], inc["st_ret_m2"]),
    "vol_downRatio": lambda inc: _signed_vol(inc, "retneg") / _std_unbiased(
        inc["bars"], inc["st_ret_m2"]),
    # shape (moment-ratio family)
    "shape_skew": lambda inc: _g1(inc["bars"], inc["st_ret_m2"],
                                  inc["st_ret_m3"]),
    "shape_kurt": lambda inc: _g2(inc["bars"], inc["st_ret_m2"],
                                  inc["st_ret_m4"]),
    "shape_skratio": lambda inc: _g1(inc["bars"], inc["st_ret_m2"],
                                     inc["st_ret_m3"]) / _g2(
        inc["bars"], inc["st_ret_m2"], inc["st_ret_m4"]),
    "shape_skewVol": lambda inc: _g1(inc["bars"], inc["st_volu_m2"],
                                     inc["st_volu_m3"]),
    "shape_kurtVol": lambda inc: _g2(inc["bars"], inc["st_volu_m2"],
                                     inc["st_volu_m4"]),
    "shape_skratioVol": lambda inc: _g1(inc["bars"], inc["st_volu_m2"],
                                        inc["st_volu_m3"]) / _g2(
        inc["bars"], inc["st_volu_m2"], inc["st_volu_m4"]),
    # liquidity
    "liq_amihud_1min": lambda inc: torch.where(inc["bars"] > 0,
                                               inc["st_amihud"], _NAN),
    "liq_closeprevol": lambda inc: torch.where(
        inc["pre_auction"] > 0, inc["st_volsum_pre_auction"], _NAN),
    "liq_closevol": lambda inc: torch.where(
        inc["auction"] > 0, inc["st_volsum_auction"], _NAN),
    "liq_firstCallR": lambda inc: inc["sel_first_volume"] / inc["vol_sum"],
    "liq_lastCallR": lambda inc: torch.where(
        inc["bars"] > 0, inc["st_volsum_auction"] / inc["vol_sum"], _NAN),
    "liq_openvol": lambda inc: inc["sel_first_volume"],
    # trade flow
    "trade_headRatio": lambda inc: _win_over_total(inc, "head"),
    "trade_tailRatio": lambda inc: _win_over_total(inc, "tail30"),
    "trade_bottom20retRatio": _bottom20,
    "trade_bottom50retRatio": _bottom50,
    # momentum (pure selections)
    "mmt_pm": lambda inc: _sentinel_ratio(inc, "sent_pm"),
    "mmt_last30": lambda inc: _sentinel_ratio(inc, "sent_last30"),
    "mmt_am": lambda inc: _sentinel_ratio(inc, "sent_am"),
    "mmt_between": lambda inc: _sentinel_ratio(inc, "sent_between"),
    "mmt_paratio": _paratio,
}


#: per-factor pinned divergence bounds for the ``stat_fold`` class:
#: ``|fast - batch| <= rtol * |batch| + atol_rel * scale`` per finite
#: lane, where ``scale`` is the max finite |batch| of the compared
#: frame (the result-wire RESULT_BOUNDS convention); non-finite lanes
#: must match by class (NaN/+inf/-inf). ``exact_fold`` factors carry an
#: implicit (0, 0) — bitwise. The JAX package's values (its
#: docs/PIN_BOUNDS.md), unchanged. Rationale per family: windowed non-negative sums differ only
#: by reduction-tree order (~sqrt(n)·eps); Welford std is
#: backward-stable; the moment RATIOS (g1, g2) divide two noisy
#: moments and the skew/kurt ratio compounds two of those.
STAT_FOLD_BOUNDS: Dict[str, Tuple[float, float]] = {
    "vol_volume1min": (1e-4, 1e-5),
    "vol_range1min": (1e-4, 1e-5),
    "vol_return1min": (1e-4, 1e-5),
    "vol_upVol": (1e-4, 1e-5),
    "vol_downVol": (1e-4, 1e-5),
    "vol_upRatio": (3e-4, 3e-5),
    "vol_downRatio": (3e-4, 3e-5),
    "shape_skew": (3e-3, 3e-3),
    "shape_kurt": (3e-3, 3e-3),
    "shape_skratio": (1e-2, 1e-2),
    "shape_skewVol": (3e-3, 3e-3),
    "shape_kurtVol": (3e-3, 3e-3),
    "shape_skratioVol": (1e-2, 1e-2),
    "liq_amihud_1min": (1e-4, 1e-6),
    "liq_closeprevol": (1e-4, 1e-6),
    "liq_closevol": (1e-4, 1e-6),
    "liq_firstCallR": (1e-4, 1e-6),
    "liq_lastCallR": (1e-4, 1e-6),
    "trade_headRatio": (1e-4, 1e-6),
    "trade_tailRatio": (1e-4, 1e-6),
    "trade_bottom20retRatio": (3e-4, 3e-5),
    "trade_bottom50retRatio": (3e-4, 3e-5),
}


def check_fast_coverage() -> None:
    """Machine check of the class/formula seam: every kernel declared
    ``exact_fold``/``stat_fold`` must have a fast formula, every fast
    formula must belong to a foldable kernel, and every ``stat_fold``
    kernel must carry a pinned bound. Fails loudly when an engine is
    built, like ``stream_requirements()``."""
    cls = finalize_classes()
    foldable = {n for n, c in cls.items() if c in FOLDABLE_CLASSES}
    missing = sorted(foldable - set(FAST_FORMULAS))
    orphans = sorted(set(FAST_FORMULAS) - foldable)
    unbounded = sorted(n for n, c in cls.items()
                       if c == "stat_fold" and n not in STAT_FOLD_BOUNDS)
    if missing or orphans or unbounded:
        raise RuntimeError(
            "fast-finalize coverage broken: "
            f"foldable kernels with no FAST_FORMULAS entry: {missing}; "
            f"formulas for non-foldable kernels: {orphans}; "
            f"stat_fold kernels with no STAT_FOLD_BOUNDS pin: "
            f"{unbounded}")


def partition_names(names) -> Tuple[Tuple[str, ...], Tuple[str, ...]]:
    """Split a snapshot's factor list into (fold, residual) by declared
    finalize class, preserving order within each part. Coverage is
    machine-checked on every call (when an engine is built, never per
    snapshot)."""
    check_fast_coverage()
    cls = finalize_classes()
    fold = tuple(n for n in names if cls[n] in FOLDABLE_CLASSES)
    residual = tuple(n for n in names if cls[n] not in FOLDABLE_CLASSES)
    return fold, residual


def stream_finalize_fast(inc, names: Tuple[str, ...]):
    """Stacked ``[F_fold, T]`` exposures of the foldable factors, a pure
    function of the ``inc`` statistic leaves: no bar-buffer read, no
    slot-count dependence, O(F·T) work whatever the cursor or session."""
    return torch.stack([FAST_FORMULAS[n](inc) for n in names])


def parity_report(name: str, batch, fast) -> Dict[str, object]:
    """Host-side pinned-bound comparison of one factor's fast vs batch
    exposures (the tests and ``chip_smoke.py``). Non-finite lanes must
    match by class; finite lanes obey the factor's bound (implicit
    (0, 0) == bitwise for ``exact_fold``)."""
    b = np.asarray(batch, np.float32)
    f = np.asarray(fast, np.float32)
    cls = finalize_classes()[name]
    # only stat_fold carries a nonzero bound; exact_fold AND batch_only
    # (byte-identical between impls by construction) compare bitwise
    rtol, atol_rel = (STAT_FOLD_BOUNDS[name] if cls == "stat_fold"
                      else (0.0, 0.0))
    class_mismatch = int(np.sum(
        (np.isnan(b) != np.isnan(f))
        | (np.isposinf(b) != np.isposinf(f))
        | (np.isneginf(b) != np.isneginf(f))))
    finite = np.isfinite(b) & np.isfinite(f)
    scale = float(np.max(np.abs(b[finite]), initial=0.0))
    err = np.abs(f[finite] - b[finite])
    allow = rtol * np.abs(b[finite]) + atol_rel * scale
    max_excess = float(np.max(err - allow, initial=0.0))
    ok = class_mismatch == 0 and max_excess <= 0.0
    return {"name": name, "class": cls, "ok": bool(ok),
            "rtol": rtol, "atol_rel": atol_rel,
            "nonfinite_class_mismatch": class_mismatch,
            "max_abs_err": float(np.max(err, initial=0.0)),
            "max_excess": max_excess}
