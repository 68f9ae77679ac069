"""The incremental kernel contract: ``init_carry / update / finalize``.

The port of the JAX package's ``stream/carry.py``. A carry is the whole
streaming state of one trading day over a ``T``-ticker universe, held on
one device and advanced as a fold over minutes:

``bars [T, S, 5]``
    the day buffer, filled one minute-column per update (absent lanes
    stay 0; kernels never read a masked lane's value);
``mask [T, S]``
    which (ticker, slot) lanes hold a bar;
``t``
    the minute cursor, the next slot an update writes: a host int here
    (the JAX carry holds an i32 device scalar), so an update reads its
    slot's window membership without a device read;
``inc {...}``
    the accumulators of :mod:`..ops.incremental`.

The buffer is part of the carry because 30 of the 58 kernels are
anchored on end-of-day state (``eod_ret`` reprices every past bar when a
bar arrives, the ``doc_pdf*`` walk re-ranks the frame), so ``finalize``
re-reads the prefix: it runs the batch kernels over the masked partial
buffer with the reorder-exact accumulators injected, and at the last
minute its result is bitwise the full day's.

Updates write the day buffer's minute column in place (the JAX
package's ``dynamic_update_slice`` into a donated buffer); every ``inc``
leaf is a new tensor. The flat ``{path: np.ndarray}`` snapshot of
:func:`carry_to_host` is the JAX package's format: a snapshot either
package saves restores into the other.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..data.minute import FIELDS
from ..markets import get_session
from ..models.registry import (
    compute_factors,
    factor_names,
    stream_requirements,
)
from ..ops import incremental as inc_ops

#: carry keys, in serialization order
CARRY_KEYS = ("bars", "mask", "t", "inc")


def init_carry(n_tickers: int, session=None) -> Dict[str, object]:
    """Empty-day carry as host numpy (the engine copies it to its device
    whole). ``session`` sizes the day buffer (None = the 240-slot
    cn_ashare day)."""
    n_slots = get_session(session).n_slots
    return {
        "bars": np.zeros((n_tickers, n_slots, len(FIELDS)), np.float32),
        "mask": np.zeros((n_tickers, n_slots), bool),
        "t": np.int32(0),
        "inc": inc_ops.init_inc(n_tickers),
    }


def update_minute(carry, values, present, session=None):
    """One fold step: write minute ``t``'s bars and advance the cursor.

    ``values [T, 5]`` are the bar fields for every ticker (garbage where
    absent), ``present [T]`` marks which tickers traded. Absent lanes
    write 0 into the buffer."""
    t = int(carry["t"])
    carry["bars"][:, t] = torch.where(present[:, None], values, 0.0)
    carry["mask"][:, t] = present
    return {"bars": carry["bars"], "mask": carry["mask"], "t": t + 1,
            "inc": inc_ops.update_inc(carry["inc"], t, values, present,
                                      session=session)}


def update_tickers(carry, rows, idx, session=None):
    """Cohort fold step: bars for ``K`` tickers at the current minute.

    ``rows [K, 5]`` land at ``(idx[k], t)``; the cursor does not move
    (call :func:`advance` at the minute boundary). Padding rows use
    ``idx == n_tickers`` and are dropped. Streaming the same minutes
    through cohorts or through :func:`update_minute` gives a bitwise
    identical carry."""
    t = int(carry["t"])
    idx = idx.to(torch.int64)
    n = carry["mask"].shape[0]
    # the minute's column with a discard row for the padding indices,
    # where the JAX package's mode="drop" scatter drops them
    col = torch.cat([carry["bars"][:, t],
                     rows.new_zeros((1, rows.shape[1]))])
    col[idx] = rows
    carry["bars"][:, t] = col[:n]
    mcol = torch.cat([carry["mask"][:, t],
                      carry["mask"].new_zeros((1,))])
    mcol[idx] = True
    carry["mask"][:, t] = mcol[:n]
    return {"bars": carry["bars"], "mask": carry["mask"], "t": t,
            "inc": inc_ops.update_inc_at(carry["inc"], t, rows, idx,
                                         session=session)}


def advance(carry, minutes: int = 1):
    """Move the minute cursor (a minute with no cohort delivery is a
    legal, fully absent minute)."""
    return {**carry, "t": int(carry["t"]) + int(minutes)}


def readiness(carry_inc, names: Sequence[str]):
    """``[F, T]`` bool: which kernels' defining groups are non-empty at
    this point of the day (registry.STREAM_REQUIREMENTS). Monotone in the
    fold and sound: a False lane's exposure is NaN."""
    reqs = stream_requirements()
    rows = []
    for n in names:
        counter, minimum = reqs[n]
        rows.append(carry_inc[counter] >= minimum)
    return torch.stack(rows)


def finalize(carry, names: Optional[Tuple[str, ...]] = None,
             replicate_quirks: bool = True,
             rolling_impl: Optional[str] = None,
             session=None, xs_axis_name: Optional[str] = None
             ) -> Dict[str, torch.Tensor]:
    """Exposures of the partial day: ``{name: [T]}``, the batch kernels
    over the carried ``(bars, mask)`` prefix with the reorder-exact
    accumulators (``n_bars``, ``last_close``) injected.
    ``xs_axis_name``: the carry is one shard's ticker block of a mesh
    (inside ``with mesh:``), and the ``doc_pdf*`` rank gathers over it."""
    if names is None:
        names = factor_names()
    inject = {"n_bars": carry["inc"]["bars"],
              "last_close": carry["inc"]["last_close"]}
    return compute_factors(carry["bars"], carry["mask"], names=names,
                           replicate_quirks=replicate_quirks,
                           rolling_impl=rolling_impl, inject=inject,
                           session=session, xs_axis_name=xs_axis_name)


def finalize_with_readiness(carry, names: Tuple[str, ...],
                            replicate_quirks: bool = True,
                            rolling_impl: Optional[str] = None,
                            session=None, finalize_impl: str = "exact",
                            xs_axis_name: Optional[str] = None):
    """The engine's snapshot: stacked exposures ``[F, T]`` and the
    readiness plane ``[F, T]``.

    ``finalize_impl='exact'`` is the bitwise batch-prefix finalize above
    (O(day) a snapshot); ``'fast'`` materializes the foldable kernels from
    the carried statistics (``stream/fastpath.py``, O(F·T)) and runs only
    the ``batch_only`` residual over the prefix. Same layout and factor
    order either way. ``xs_axis_name`` as :func:`finalize` (the fast
    formulas are per lane and need no collective)."""
    if finalize_impl not in ("exact", "fast"):
        raise ValueError(f"unknown finalize_impl {finalize_impl!r} "
                         "(valid: 'exact', 'fast')")
    if finalize_impl == "exact":
        out = finalize(carry, names, replicate_quirks, rolling_impl,
                       session=session, xs_axis_name=xs_axis_name)
        exposures = torch.stack([out[n] for n in names])
        return exposures, readiness(carry["inc"], names)
    from . import fastpath

    fold, residual = fastpath.partition_names(tuple(names))
    vals = {}
    if fold:
        fast = fastpath.stream_finalize_fast(carry["inc"], fold)
        vals.update({n: fast[i] for i, n in enumerate(fold)})
    if residual:
        vals.update(finalize(carry, residual, replicate_quirks,
                             rolling_impl, session=session,
                             xs_axis_name=xs_axis_name))
    exposures = torch.stack([vals[n] for n in names])
    return exposures, readiness(carry["inc"], names)


# --------------------------------------------------------------------------
# the cross-day span state (the 2-D resident loop's carry)
# --------------------------------------------------------------------------
#
# The 2-D resident loop splits each batch's days over day-shards, so a
# carry threads across day-spans: the same two reorder-exact accumulators
# ``finalize`` injects (``inc/bars`` -> ``n_bars`` and ``inc/last_close``),
# taken from the latest day that held any bar. A resident year's end carry
# is the state a streaming engine's accumulators hold at that day's close.
# Both fields are pure selections and integer counts, so every fold and
# handoff below is bitwise under any sharding or combine order.


def init_span_state(n_tickers: int) -> Dict[str, np.ndarray]:
    """Empty cross-day carry as host numpy (``parallel.mesh.
    put_span_carry`` puts a rank's tickers slice on its device):
    ``last_close`` NaN / ``n_bars`` 0 / ``has`` False per lane."""
    return {"last_close": np.full((n_tickers,), np.nan, np.float32),
            "n_bars": np.zeros((n_tickers,), np.int32),
            "has": np.zeros((n_tickers,), bool)}


def span_prefix_state(bars, mask, day_base: int = 0):
    """Intraday prefix state of a day-span ``bars [D, T, S, 5]`` / ``mask
    [D, T, S]``: per ticker lane, the finalize-inject pair of the LAST day
    in the span that held any bar — ``last_close`` (that day's last
    present close) and ``n_bars`` (that day's bar count) — plus ``has``
    (any bar in the span) and ``day`` (the global day index that produced
    the state, ``day_base + local``, -1 when none; the combine's ordering
    key). ``day_base`` is a host int, so nothing waits on the device."""
    from ..data.minute import F_CLOSE

    dev = mask.device
    n_bars = mask.sum(dim=-1, dtype=torch.int32)               # [D, T]
    slots = torch.arange(mask.shape[-1], dtype=torch.int32, device=dev)
    last_slot = torch.where(mask, slots, -1).amax(dim=-1)      # [D, T]
    lc = torch.gather(bars[..., F_CLOSE], -1,
                      last_slot.clamp(min=0).long()[..., None])[..., 0]
    didx = torch.arange(bars.shape[0], dtype=torch.int32,
                        device=dev)[:, None]
    last_day = torch.where(n_bars > 0, didx, -1).amax(dim=0)   # [T]
    sel = last_day.clamp(min=0).long()[None, :]
    has = last_day >= 0

    def pick(a):
        return torch.gather(a, 0, sel)[0]

    return {
        "last_close": torch.where(has, pick(lc), float("nan")),
        "n_bars": torch.where(has, pick(n_bars), 0).to(torch.int32),
        "has": has,
        "day": torch.where(has, last_day + int(day_base),
                           -1).to(torch.int32),
    }


def combine_span_state(a, b):
    """Associative, commutative, IDEMPOTENT combine of two span states on
    one lane axis: the state from the strictly later day wins per lane
    (day keys are globally distinct, so ties occur only at the empty
    ``day == -1`` state, whose payload is the shared initial value)."""
    newer = b["has"] & (~a["has"] | (b["day"] > a["day"]))
    out = {k: torch.where(newer, b[k], a[k])
           for k in ("last_close", "n_bars", "day")}
    out["has"] = a["has"] | b["has"]
    return out


# --------------------------------------------------------------------------
# serialization (mid-day restart: save -> restore -> identical tail)
# --------------------------------------------------------------------------


def _host(x) -> np.ndarray:
    return x.detach().to("cpu", copy=True).numpy()


def carry_to_host(carry) -> Dict[str, np.ndarray]:
    """Flat ``{path: np.ndarray}`` copy of the carry (``inc/<leaf>``,
    ``bars``, ``mask``, ``t`` as a 0-d int32 array), the JAX package's
    format. Restoring it with :func:`carry_from_host` and continuing the
    fold is bitwise never having stopped."""
    flat = {f"inc/{k}": _host(v) for k, v in carry["inc"].items()}
    flat["bars"] = _host(carry["bars"])
    flat["mask"] = _host(carry["mask"])
    flat["t"] = np.asarray(carry["t"], np.int32)
    return flat


def carry_from_host(snapshot: Dict[str, object]) -> Dict[str, object]:
    """Rebuild the carry's structure from a :func:`carry_to_host`
    snapshot (host side; the engine copies it to its device)."""
    inc = {k.split("/", 1)[1]: np.asarray(v) for k, v in snapshot.items()
           if k.startswith("inc/")}
    return {"bars": np.asarray(snapshot["bars"]),
            "mask": np.asarray(snapshot["mask"]),
            "t": np.int32(snapshot["t"]), "inc": inc}


def carry_to_device(host: Dict[str, object], device) -> Dict[str, object]:
    """A host carry (:func:`init_carry`, :func:`carry_from_host`) copied
    onto ``device``; the copies never share memory with ``host``."""
    def put(a):
        return torch.tensor(np.asarray(a), device=device)

    return {"bars": put(host["bars"]), "mask": put(host["mask"]),
            "t": int(host["t"]),
            "inc": {k: put(v) for k, v in host["inc"].items()}}


def split_tickers(host: Dict[str, object], n_shards: int
                  ) -> List[Dict[str, object]]:
    """A host carry (:func:`init_carry`, :func:`carry_from_host`) as
    ``n_shards`` host carries of contiguous ticker blocks, in shard order:
    every leaf whose axis 0 is the ticker count is cut (views:
    :func:`carry_to_device` copies), the rest (the cursor) is replicated.
    The ticker count must divide."""
    n_tickers = np.shape(host["mask"])[0]
    if n_tickers % n_shards:
        raise ValueError(f"{n_tickers} tickers do not divide over "
                         f"{n_shards} shards")
    blk = n_tickers // n_shards

    def cut(a, i):
        a = np.asarray(a)
        if a.ndim and a.shape[0] == n_tickers:
            return a[i * blk:(i + 1) * blk]
        return a

    return [{"bars": cut(host["bars"], i), "mask": cut(host["mask"], i),
             "t": host["t"],
             "inc": {k: cut(v, i) for k, v in host["inc"].items()}}
            for i in range(n_shards)]


def merge_tickers(snapshots: Sequence[Dict[str, np.ndarray]]
                  ) -> Dict[str, np.ndarray]:
    """Flat :func:`carry_to_host` snapshots of ticker blocks, in shard
    order, as one flat snapshot of the whole universe: every leaf with a
    ticker axis concatenated, the cursor taken from the first."""
    return {k: (a if np.ndim(a) == 0
                else np.concatenate([s[k] for s in snapshots]))
            for k, a in snapshots[0].items()}


def carry_nbytes(carry) -> int:
    """Device bytes held by the carry (the ``stream.carry_bytes``
    gauge)."""
    leaves = [carry["bars"], carry["mask"], *carry["inc"].values()]
    return sum(x.numel() * x.element_size() for x in leaves) + 4
