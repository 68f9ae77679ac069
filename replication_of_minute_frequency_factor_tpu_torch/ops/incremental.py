"""Incremental (per-minute fold) forms of the masked reductions.

The port of the JAX package's ``ops/incremental.py``. The streaming carry
(``stream/carry.py``) advances per arriving bar; the accumulators here
are the fold-step twins of the batch reductions in :mod:`.masked`, in two
exactness classes:

* **exact under reordering**: integer window counters and pure
  selections (``first_open``/``last_close`` and the ``sel_*`` leaves
  pick a stored f32 value). Folding them minute by minute is bitwise the
  batch reduction over the completed mask, so the exact finalize injects
  ``bars`` and ``last_close`` into :class:`..models.context.DayContext`'s
  memo.
* **order-sensitive**: the f32 accumulators (``vol_sum`` and the ``st_*``
  sufficient statistics). They never feed the exact finalize; the fast
  finalize (``stream/fastpath.py``) materializes its ``stat_fold``
  kernels from them within pinned bounds.

Window counters are int32, as in the JAX carry and its save format (a
torch ``sum`` of a bool would be int64). The minute's window membership
is a host bool read from the engine's host cursor: the slot's time and
every window test are Python values, so a minute costs no device read,
and a window the minute is outside leaves its leaves untouched (the
where() the JAX package evaluates there selects the old value, bitwise).

The dense (:func:`update_inc`) and cohort (:func:`update_inc_at`) paths
run every statistic through one function, :func:`_fold_stats`, whose
Welford steps are written op for op as in the JAX package, as separate
eager ops, so both paths fold bitwise alike.
"""

from __future__ import annotations

import functools
from typing import Dict, Tuple

import numpy as np
import torch

from ..data.minute import F_CLOSE, F_HIGH, F_LOW, F_OPEN, F_VOLUME
from ..markets import get_session

_NAN = float("nan")

#: windows whose first-open/last-close selections anchor the
#: ``exact_fold`` kernels (sentinel ratios + mmt_paratio's halves)
SEL_WINDOWS = ("am", "pm", "sent_pm", "sent_last30", "sent_am",
               "sent_between")
#: windows whose f32 volume sums feed ``stat_fold`` kernels
VOLSUM_WINDOWS = ("pre_auction", "auction", "head", "tail20", "tail30",
                  "tail50")
#: windows whose ret·volume sums feed the bottom-ret-ratio pair
RV_WINDOWS = ("tail20", "tail50")

#: zero-init f32 statistic leaves (order-sensitive accumulators)
STAT_LEAVES_F32 = (
    "st_ret_mean", "st_ret_m2", "st_ret_m3", "st_ret_m4",
    "st_volu_mean", "st_volu_m2", "st_volu_m3", "st_volu_m4",
    "st_range_mean", "st_range_m2",
    "st_retpos_mean", "st_retpos_m2",
    "st_retneg_mean", "st_retneg_m2",
    "st_amihud",
) + tuple(f"st_volsum_{w}" for w in VOLSUM_WINDOWS) \
  + tuple(f"st_rv_{w}" for w in RV_WINDOWS)
#: zero-init int32 subset counters (reorder-exact)
STAT_LEAVES_I32 = ("st_retpos_n", "st_retneg_n")
#: NaN-init f32 selection leaves (reorder-exact)
SEL_LEAVES = ("sel_first_volume",) + tuple(
    f"sel_{kind}_{w}" for w in SEL_WINDOWS
    for kind in ("first_open", "last_close"))


@functools.lru_cache(maxsize=None)
def window_counters_for(session=None) -> Dict[str, Tuple]:
    """Counter name -> window spec for one market session.

    ``("range", lo, hi, lo_strict, hi_strict)`` bounds the slot time like
    ``DayContext.time_mask`` (None = unbounded); ``("exact", times)``
    matches the sentinel-bar kernels' 2-slot candidate sets. The names
    are the same for every session (each spec defines the windows at its
    own boundaries), so one readiness contract serves every market."""
    s = get_session(session)
    return {
        "bars": ("range", None, None, False, False),
        "am": ("range", None, s.T_NOON, False, False),
        "pm": ("range", s.T_NOON, None, True, False),
        "pre_auction": ("range", None, s.T_CLOSE_AUCTION, False, True),
        "auction": ("range", s.T_CLOSE_AUCTION, None, False, False),
        "head": ("range", None, s.T_HEAD_END, False, False),
        "top20": ("range", None, s.T_TOP20_END, False, False),
        "top50": ("range", None, s.T_TOP50_END, False, False),
        "tail20": ("range", s.T_TAIL20, None, False, False),
        "tail30": ("range", s.T_LAST30_OPEN, None, False, False),
        "tail50": ("range", s.T_TAIL50, None, False, False),
        "sent_pm": ("exact", (s.T_PM_OPEN, s.T_PM_CLOSE)),
        "sent_last30": ("exact", (s.T_LAST30_OPEN, s.T_PM_CLOSE)),
        "sent_am": ("exact", (s.T_AM_OPEN, s.T_AM_CLOSE)),
        "sent_between": ("exact", (s.T_BETWEEN_OPEN, s.T_BETWEEN_CLOSE)),
    }


#: the canonical cn_ashare_240 windows (counter NAMES are identical for
#: every session)
WINDOW_COUNTERS: Dict[str, Tuple] = window_counters_for(None)


def window_contains(spec: Tuple, time: int) -> bool:
    """Does the HHMMSSmmm ``time`` (a host int) fall inside the window
    ``spec``?"""
    kind = spec[0]
    if kind == "exact":
        return any(time == t for t in spec[1])
    _, lo, hi, lo_strict, hi_strict = spec
    ok = True
    if lo is not None:
        ok = ok and ((time > lo) if lo_strict else (time >= lo))
    if hi is not None:
        ok = ok and ((time < hi) if hi_strict else (time <= hi))
    return bool(ok)


def init_inc(n_tickers: int) -> Dict[str, np.ndarray]:
    """Zero-state accumulators for ``n_tickers`` lanes, as host numpy
    (the engine copies the whole carry to its device once)."""
    out: Dict[str, np.ndarray] = {
        name: np.zeros((n_tickers,), np.int32) for name in WINDOW_COUNTERS}
    out["vol_sum"] = np.zeros((n_tickers,), np.float32)
    out["first_open"] = np.full((n_tickers,), np.nan, np.float32)
    out["last_close"] = np.full((n_tickers,), np.nan, np.float32)
    for name in STAT_LEAVES_F32:
        out[name] = np.zeros((n_tickers,), np.float32)
    for name in STAT_LEAVES_I32:
        out[name] = np.zeros((n_tickers,), np.int32)
    for name in SEL_LEAVES:
        out[name] = np.full((n_tickers,), np.nan, np.float32)
    return out


def _welford_step(n_old_f, mean, m2, x):
    """Per-lane Welford fold of (mean, M2) for one observation ``x``;
    ``n_old_f`` is the pre-update count as f32. Each M2 increment is
    ``delta * (delta/n) * n_old``, a same-sign product, so M2 stays
    non-negative."""
    n = n_old_f + 1.0
    delta = x - mean
    delta_n = delta / n
    return mean + delta_n, m2 + delta * delta_n * n_old_f


def _welford4_step(n_old_f, mean, m2, m3, m4, x):
    """Per-lane fold of the first four central moments (Pébay's
    one-observation update); the M2 line is :func:`_welford_step`'s."""
    n = n_old_f + 1.0
    delta = x - mean
    delta_n = delta / n
    delta_n2 = delta_n * delta_n
    term1 = delta * delta_n * n_old_f
    new_m4 = m4 + (term1 * delta_n2 * (n * n - 3.0 * n + 3.0)
                   + 6.0 * delta_n2 * m2 - 4.0 * delta_n * m3)
    new_m3 = m3 + term1 * delta_n * (n - 2.0) - 3.0 * delta_n * m2
    return mean + delta_n, m2 + term1, new_m3, new_m4


def _fold_stats(get, open_, high, low, close, volume, present, inw):
    """Post-bar values of every sufficient-statistic leaf.

    ``get(name)`` returns the pre-update per-lane value of a carry leaf:
    the dense path passes ``inc.__getitem__`` (``[T]``), the cohort path
    a gather at the cohort's indices (``[K]``). ``inw[window]`` is the
    minute's host bool of window membership; ``present`` gates lanes (a
    bool tensor, or True for the cohort, whose rows are present by
    construction). Leaves of windows the minute is outside keep their
    value and are left out of the result."""
    def gate(cond, new, old):
        return new if cond is True else torch.where(cond, new, old)

    out = {}
    bars_old = get("bars")
    nf = bars_old.to(torch.float32)
    ret = (close - open_) / open_
    rng = high / low

    # first-four-moment Welford series over all present bars
    for leaf, x in (("ret", ret), ("volu", volume)):
        ks = tuple(f"st_{leaf}_{p}" for p in ("mean", "m2", "m3", "m4"))
        new = _welford4_step(nf, *(get(k) for k in ks), x)
        for k, v in zip(ks, new):
            out[k] = gate(present, v, get(k))
    n_mean, n_m2 = _welford_step(nf, get("st_range_mean"),
                                 get("st_range_m2"), rng)
    out["st_range_mean"] = gate(present, n_mean, get("st_range_mean"))
    out["st_range_m2"] = gate(present, n_m2, get("st_range_m2"))

    # signed-return subsets carry their own counts
    for leaf, cond in (("retpos", ret > 0), ("retneg", ret < 0)):
        sel = cond if present is True else present & cond
        n_old = get(f"st_{leaf}_n")
        mean, m2 = get(f"st_{leaf}_mean"), get(f"st_{leaf}_m2")
        n_mean, n_m2 = _welford_step(n_old.to(torch.float32), mean, m2,
                                     ret)
        out[f"st_{leaf}_n"] = n_old + sel.to(torch.int32)
        out[f"st_{leaf}_mean"] = torch.where(sel, n_mean, mean)
        out[f"st_{leaf}_m2"] = torch.where(sel, n_m2, m2)

    # windowed f32 sums
    for w in VOLSUM_WINDOWS:
        if inw[w]:
            out[f"st_volsum_{w}"] = get(f"st_volsum_{w}") + gate(
                present, volume, 0.0)
    for w in RV_WINDOWS:
        if inw[w]:
            out[f"st_rv_{w}"] = get(f"st_rv_{w}") + gate(
                present, ret * volume, 0.0)

    # amihud term sum: |pct change over consecutive present closes| /
    # volume; the first present bar contributes 0, as the batch kernel's
    # null-filled first pct
    prev = get("last_close")
    has_prev = bars_old > 0
    pct_abs = torch.where(has_prev, ((close - prev) / prev).abs(), 0.0)
    term = torch.where(volume > 0.0, pct_abs / volume, 0.0)
    out["st_amihud"] = get("st_amihud") + gate(present, term, 0.0)

    # pure selections (reorder-exact anchors of the exact_fold kernels);
    # in-order ingestion makes first-arrival == first-slot
    never = bars_old == 0
    first_vol = never if present is True else never & present
    out["sel_first_volume"] = torch.where(first_vol, volume,
                                          get("sel_first_volume"))
    for w in SEL_WINDOWS:
        if not inw[w]:
            continue
        unseen = get(w) == 0
        first = unseen if present is True else present & unseen
        out[f"sel_first_open_{w}"] = torch.where(
            first, open_, get(f"sel_first_open_{w}"))
        out[f"sel_last_close_{w}"] = gate(
            present, close, get(f"sel_last_close_{w}"))
    return out


def _stat_windows(wc):
    """The window specs the statistic fold consults."""
    need = set(SEL_WINDOWS) | set(VOLSUM_WINDOWS) | set(RV_WINDOWS)
    return {w: wc[w] for w in need}


def _slot_time(sess, t: int) -> int:
    if not 0 <= int(t) < sess.n_slots:
        raise ValueError(f"slot {t} is outside the {sess.n_slots}-slot "
                         f"{sess.name} day")
    return int(sess.grid_times[int(t)])


def update_inc(inc, t: int, values, present, session=None):
    """One-minute fold step: bump every window counter for the present
    lanes and advance the selection and statistic leaves.

    ``t`` is the minute's slot (a host int), ``values [T, 5]`` the bar
    fields, ``present [T]`` which tickers traded this minute. Returns a
    new leaf dict; leaves the minute leaves unchanged are the same
    tensors."""
    sess = get_session(session)
    wc = window_counters_for(sess)
    time = _slot_time(sess, t)
    out = dict(inc)
    bump = present.to(torch.int32)
    for name, spec in wc.items():
        if window_contains(spec, time):
            out[name] = inc[name] + bump
    out["vol_sum"] = inc["vol_sum"] + torch.where(
        present, values[..., F_VOLUME], 0.0)
    out["last_close"] = torch.where(present, values[..., F_CLOSE],
                                    inc["last_close"])
    never_seen = inc["bars"] == 0
    out["first_open"] = torch.where(never_seen & present,
                                    values[..., F_OPEN], inc["first_open"])
    inw = {w: window_contains(spec, time)
           for w, spec in _stat_windows(wc).items()}
    out.update(_fold_stats(
        inc.__getitem__, values[..., F_OPEN], values[..., F_HIGH],
        values[..., F_LOW], values[..., F_CLOSE], values[..., F_VOLUME],
        present, inw))
    return out


def _scatter(leaf, idx, rows):
    """``leaf`` with ``rows`` written at ``idx`` along dim 0; an index
    equal to ``len(leaf)`` (a cohort's padding) lands in a discard row,
    where the JAX package's ``mode="drop"`` drops it. Returns a new
    tensor."""
    ext = torch.cat([leaf, leaf[:1]])
    ext[idx] = rows
    return ext[:leaf.shape[0]]


def update_inc_at(inc, t: int, rows, idx, session=None):
    """Cohort (scatter) twin of :func:`update_inc`: ``rows [K, 5]`` are
    bars for tickers ``idx [K]`` (int64 on the leaves' device) at slot
    ``t``. Padding rows carry ``idx == n_tickers`` and are dropped. Each
    ticker appears at most once per call (a live feed delivers one bar
    per ticker a minute); duplicates are undefined."""
    sess = get_session(session)
    wc = window_counters_for(sess)
    time = _slot_time(sess, t)
    n = inc["bars"].shape[0]
    # gather-then-scatter: padding lanes gather a clamped lane's value,
    # which the scatter sends to the discard row
    gidx = idx.clamp(max=n - 1)
    out = dict(inc)
    for name, spec in wc.items():
        if window_contains(spec, time):
            out[name] = _scatter(inc[name], idx, inc[name][gidx] + 1)
    out["vol_sum"] = _scatter(inc["vol_sum"], idx,
                              inc["vol_sum"][gidx] + rows[..., F_VOLUME])
    out["last_close"] = _scatter(inc["last_close"], idx, rows[..., F_CLOSE])
    seen = inc["bars"][gidx] > 0
    first = torch.where(seen, inc["first_open"][gidx], rows[..., F_OPEN])
    out["first_open"] = _scatter(inc["first_open"], idx, first)
    inw = {w: window_contains(spec, time)
           for w, spec in _stat_windows(wc).items()}
    new_rows = _fold_stats(
        lambda k: inc[k][gidx],
        rows[..., F_OPEN], rows[..., F_HIGH], rows[..., F_LOW],
        rows[..., F_CLOSE], rows[..., F_VOLUME], True, inw)
    for k, v in new_rows.items():
        out[k] = _scatter(inc[k], idx, v)
    return out
