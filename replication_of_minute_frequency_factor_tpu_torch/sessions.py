"""A-share trading sessions and the 240-slot minute grid.

The reference encodes bar timestamps as integers ``HHMMSSmmm`` (hour*1e7), e.g.
``93000000`` = 09:30, ``145900000`` = 14:59, and converts to a "trade minute"
index via minutes-since-midnight (``time // 1e7 * 60 + time % 1e7 / 1e5``) and
a session-offset subtraction (reference
``MinuteFrequentFactorCalculateMethodsCICC.py:98-106``):

    trade_minute = msm - 570   if msm < 720   (morning, 09:30 -> 0)
                 = msm - 660   otherwise      (afternoon, 13:00 -> 120)

Bars are labelled by window *start*: the morning session is 09:30..11:29
(slots 0..119) and the afternoon session 13:00..14:59 (slots 120..239), a
dense 240-slot grid. Note 11:30 would collide with 13:00 at slot 120 under the
reference's formula; canonical data carries no 11:30 bar, and our loader
rejects off-grid timestamps rather than silently aliasing them.

This module is the ``cn_ashare_240`` instance of :mod:`.markets`: every
constant below re-exports that frozen :class:`~.markets.SessionSpec`'s
values, as the JAX package's ``sessions.py`` does (a copy of it; the
constants are pinned to the JAX package's by tests/test_torch_markets.py).
Everything session-shaped takes a spec; new markets register in
``markets/registry.py``.
"""

from __future__ import annotations

import numpy as np

from .markets.registry import CN_ASHARE_240 as SPEC

N_SLOTS = SPEC.n_slots
AM_SLOTS = SPEC.segments[0][1]  # 09:30..11:29
PM_SLOTS = SPEC.segments[1][1]  # 13:00..14:59

_AM_OPEN_MSM = SPEC.segments[0][0]   # 570
_PM_OPEN_MSM = SPEC.segments[1][0]   # 780
_NOON_MSM = 720

#: HHMMSSmmm timestamp of every slot (length 240). Kernels express the
#: reference's time filters as boolean masks over this array, e.g.
#: ``GRID_TIMES >= 145700000`` for the last-3-minute window.
GRID_TIMES: np.ndarray = SPEC.grid_times


def time_to_slot(time_int: np.ndarray) -> np.ndarray:
    """Vectorised HHMMSSmmm -> slot index; -1 for off-grid timestamps.

    Off-grid = outside [09:30, 11:30) ∪ [13:00, 15:00), or with a non-zero
    seconds/millis component (the grid is whole minutes).
    """
    return SPEC.time_to_slot(time_int)


def slot_to_time(slot: np.ndarray) -> np.ndarray:
    """Slot index -> HHMMSSmmm (inverse of :func:`time_to_slot`)."""
    return SPEC.slot_to_time(slot)


# Named sentinel times used by the reference kernels
# (MinuteFrequentFactorCalculateMethodsCICC.py:18,33,69,84,770,1212,...).
# Values come from the cn_ashare_240 spec (derived semantically from the
# grid, with T_NOON pinned to the historical 11:30 constant).
T_AM_OPEN = SPEC.T_AM_OPEN
T_AM_CLOSE = SPEC.T_AM_CLOSE
T_NOON = SPEC.T_NOON
T_PM_OPEN = SPEC.T_PM_OPEN
T_PM_CLOSE = SPEC.T_PM_CLOSE
T_LAST30_OPEN = SPEC.T_LAST30_OPEN
T_BETWEEN_OPEN = SPEC.T_BETWEEN_OPEN
T_BETWEEN_CLOSE = SPEC.T_BETWEEN_CLOSE
T_CLOSE_AUCTION = SPEC.T_CLOSE_AUCTION  # last-3-minutes boundary
T_TAIL20 = SPEC.T_TAIL20
T_TAIL50 = SPEC.T_TAIL50
T_HEAD_END = SPEC.T_HEAD_END
T_TOP20_END = SPEC.T_TOP20_END
T_TOP50_END = SPEC.T_TOP50_END
