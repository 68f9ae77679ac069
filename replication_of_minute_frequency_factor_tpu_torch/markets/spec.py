"""Frozen market session specs: the day shape as data, not constants.

The port's own copy of the JAX package's ``markets/spec.py`` (numpy
only; the port imports nothing of the JAX package). A
:class:`SessionSpec` holds one market's day shape as a frozen,
hashable value:

* ``segments`` — the wall-clock session layout as ``(open_msm,
  n_slots)`` pairs (msm = minutes since midnight), which derive the
  dense slot grid, the ``HHMMSSmmm`` timestamp of every slot, and the
  wall-clock <-> slot mapping;
* the **sentinel times** the factor kernels filter on (close-auction
  boundary, first/last 30 minutes, the AM/PM split, ...) — derived
  from the grid by the handbook's *semantic* rules ("the last 3
  minutes", "the first 31 bars") so the same kernel definitions run
  on any registered market, with per-spec overrides where a
  historical constant differs from the derived value (cn's ``T_NOON``
  is 11:30, one minute past the last AM slot — both produce identical
  masks on-grid);
* ``calendar`` and ``fields`` — trading-calendar tag and bar field
  conventions (metadata for sources/loaders; the kernels only consume
  the grid).

Every registered spec is equal field by field to the JAX package's
(tests/test_torch_markets.py). Registered specs live in
:mod:`.registry`.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Dict, Tuple

import numpy as np

#: bar field conventions shared by every shipped spec (matches
#: data/minute.FIELDS; duplicated literally to keep this module at the
#: bottom of the import graph)
DEFAULT_FIELDS = ("open", "high", "low", "close", "volume")


def _msm_to_time(msm: np.ndarray) -> np.ndarray:
    """minutes-since-midnight -> HHMMSSmmm integer."""
    return (msm // 60) * 10_000_000 + (msm % 60) * 100_000


@functools.lru_cache(maxsize=None)
def _grid_times_for(segments: Tuple[Tuple[int, int], ...]) -> np.ndarray:
    """HHMMSSmmm per slot for a segment layout (cached per layout —
    specs are frozen, so the array is shared and marked read-only)."""
    parts = []
    for open_msm, n in segments:
        parts.append(_msm_to_time(open_msm + np.arange(n)))
    out = np.concatenate(parts).astype(np.int64)
    out.setflags(write=False)
    return out


@dataclasses.dataclass(frozen=True)
class SessionSpec:
    """One market's trading-day shape. Frozen + hashable, so equal
    specs compare and hash equal wherever they are used as keys.

    ``sentinel_overrides`` pins historical constants that differ from
    the derived semantic value (see module docstring); everything else
    derives from ``segments``.
    """

    #: registry name, e.g. ``cn_ashare_240`` (also the bench/regress
    #: series discriminator)
    name: str
    #: ``((open_msm, n_slots), ...)`` wall-clock session segments in
    #: day order; msm = minutes since midnight of the first bar label
    segments: Tuple[Tuple[int, int], ...]
    #: trading-calendar tag (day-count/holiday convention of sources)
    calendar: str = "cn_ashare"
    #: bar field conventions (order matches the day tensor's last axis)
    fields: Tuple[str, ...] = DEFAULT_FIELDS
    #: price tick the wire format quantizes on
    tick: float = 0.01
    #: slots in the close-auction window (the reference's last-3-minute
    #: boundary; sessions with no auction still define the window — it
    #: is "the last N minutes" semantically)
    close_auction_slots: int = 3
    #: ``{"T_NOON": 113000000, ...}`` — exact HHMMSSmmm values taking
    #: precedence over the derived sentinels
    sentinel_overrides: Tuple[Tuple[str, int], ...] = ()

    def __post_init__(self):
        if not self.segments:
            raise ValueError(f"session {self.name!r} has no segments")
        for open_msm, n in self.segments:
            if n <= 0 or open_msm < 0 or open_msm + n > 24 * 60:
                raise ValueError(
                    f"session {self.name!r}: segment ({open_msm}, {n}) "
                    "leaves the day")

    # --- grid -----------------------------------------------------------
    @property
    def n_slots(self) -> int:
        """Slots (label minutes) per trading day."""
        return sum(n for _, n in self.segments)

    @property
    def grid_times(self) -> np.ndarray:
        """HHMMSSmmm timestamp of every slot (length ``n_slots``,
        read-only, shared across equal layouts)."""
        return _grid_times_for(self.segments)

    def time_to_slot(self, time_int: np.ndarray) -> np.ndarray:
        """Vectorised HHMMSSmmm -> slot index; -1 for off-grid
        timestamps (outside every segment, or with a sub-minute
        component — the grid is whole minutes)."""
        time_int = np.asarray(time_int, dtype=np.int64)
        hm = (time_int // 10_000_000 * 60
              + (time_int % 10_000_000) // 100_000)
        sub_minute = time_int % 100_000 != 0
        slot = np.full(time_int.shape, -1, np.int64)
        base = 0
        for open_msm, n in self.segments:
            inside = (hm >= open_msm) & (hm < open_msm + n)
            slot = np.where(inside, hm - open_msm + base, slot)
            base += n
        return np.where(sub_minute, np.int64(-1), slot)

    def slot_to_time(self, slot: np.ndarray) -> np.ndarray:
        """Slot index -> HHMMSSmmm (inverse of :meth:`time_to_slot`)."""
        return self.grid_times[np.asarray(slot)]

    # --- sentinels ------------------------------------------------------
    #
    # The handbook's time filters, as grid-relative rules. Indices into
    # grid_times; every rule reproduces the cn constant exactly at the
    # canonical 240 layout (pinned for the JAX package in
    # tests/test_markets.py; tests/test_torch_markets.py holds these equal).

    def _first_session_slots(self) -> int:
        """Slots in the "AM" session: segment 0 for multi-segment
        markets, the first half for continuous ones (the AM/PM kernels
        need *some* split; half-day is the neutral choice and is pinned
        per spec by the derived sentinels)."""
        if len(self.segments) > 1:
            return self.segments[0][1]
        return self.n_slots // 2

    @property
    def _derived_sentinels(self) -> Dict[str, int]:
        g = self.grid_times
        n = self.n_slots
        n_am = self._first_session_slots()

        def at(i: int) -> int:
            # clamp: tiny sessions degrade to the nearest boundary
            return int(g[min(max(i, 0), n - 1)])

        return {
            # session boundaries
            "T_AM_OPEN": at(0),
            "T_AM_CLOSE": at(n_am - 1),
            "T_NOON": at(n_am - 1),  # cn overrides to 11:30 (see doc)
            "T_PM_OPEN": at(n_am),
            "T_PM_CLOSE": at(n - 1),
            # close-auction boundary: the last `close_auction_slots`
            "T_CLOSE_AUCTION": at(n - self.close_auction_slots),
            # head/tail windows (the reference's `<=`/`>=` filters keep
            # the boundary slot, hence the off-by-one-looking indices —
            # they reproduce the handbook's bar counts)
            "T_LAST30_OPEN": at(n - 30),
            "T_TAIL20": at(n - 20),
            "T_TAIL50": at(n - 50),
            "T_HEAD_END": at(30),
            "T_TOP20_END": at(20),
            "T_TOP50_END": at(50),
            "T_BETWEEN_OPEN": at(30),
            "T_BETWEEN_CLOSE": at(n - 31),
        }

    @property
    def sentinels(self) -> Dict[str, int]:
        """All named sentinel times (derived + overrides applied)."""
        out = self._derived_sentinels
        out.update(dict(self.sentinel_overrides))
        return out

    def __getattr__(self, name: str):
        # sentinel attribute access (spec.T_CLOSE_AUCTION etc.) —
        # __getattr__ only fires for names not found normally, so the
        # dataclass fields are unaffected
        if name.startswith("T_"):
            try:
                return self.sentinels[name]
            except KeyError:
                pass
        raise AttributeError(
            f"{type(self).__name__} {self.name!r} has no attribute "
            f"{name!r}")

    # --- wire layout ----------------------------------------------------
    @property
    def mask_bytes(self) -> int:
        """Bytes of the bit-packed validity mask per (ticker, day)
        (np.packbits pads the last byte with zero bits)."""
        return -(-self.n_slots // 8)

    def describe(self) -> dict:
        """JSON-ready summary (docs/sessions.md's registration
        workflow prints this)."""
        return {
            "name": self.name,
            "n_slots": self.n_slots,
            "segments": [list(s) for s in self.segments],
            "calendar": self.calendar,
            "fields": list(self.fields),
            "tick": self.tick,
            "close_auction_slots": self.close_auction_slots,
            "sentinels": self.sentinels,
        }
