"""Batch entry points and the host driver: day files in, the exposure
cache out, on the device.

:func:`compute_batch` takes bars and mask; :func:`compute_packed` (and its
device half :func:`compute_packed_prepared`) takes the arrays of the
ingest wire (or the raw bars and uint8 mask) packed into one uint8
buffer, copies that one buffer to the device, unpacks and decodes it
there — the JAX package's ``pipeline._compute_packed``.

:func:`compute_exposures` is the JAX package's host driver of the same
name: it lists the minute-bar day files, resumes past the cache's max date,
batches the days, runs :func:`_run_device_pipeline` (a producer thread
grids, encodes and packs batch i+1 into a pinned host buffer while the
card computes batch i; the copy runs on a stream of its own, the result
comes back to a pinned buffer without blocking), isolates failed days,
and keeps the columnar :class:`ExposureTable` cache with its failure
ledger. The packed path takes the JAX package's two side outputs: the
result wire (:mod:`.data.result_wire`, the block quantized on the device)
and the factor-stats sketch (:mod:`.telemetry.factorplane`).

:func:`compute_packed_resident` is the JAX package's resident year loop:
N device-resident packed buffers through the same body, one after
another with no host round trip, into one preallocated result fetched
once; on the card it donates its input buffers.
:func:`compute_packed_resident_sharded` and :func:`compute_packed_resident_2d`
run the same loop on each rank of a ``(1, n)`` or ``(d, t)`` mesh
(:mod:`.parallel`) over its shard of the year, and ``Config.mesh_shape =
(1, n)`` shards the host driver's tickers over n ranks (the same
:func:`_run_device_pipeline`, its launch scattered over the ranks).

:func:`compute_exposures_streamed` folds one day through the streaming
engine (:mod:`.stream`).
"""

from __future__ import annotations

import json
import os
import queue
import threading
import time
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from .config import Config, get_config
from .data import io as dio
from .data import result_wire as _result_wire
from .data import wire
from .data.minute import grid_day
from .markets import get_session
from .models import compute_factors, factor_names
from .telemetry import Telemetry, get_telemetry
from .telemetry import attribution as _attribution
from .telemetry.factorplane import factor_stats_block as _factor_stats_block
from .utils.logging import FailureReport, get_logger
from .utils.tracing import Timer, trace_annotation

logger = get_logger(__name__)


def resolve_device(device=None) -> torch.device:
    """The device a computation runs on: the card unless the caller asks
    for another. Never falls back to the CPU on its own."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' to run on the CPU")
    return dev


def compute_batch(bars, mask, names: Optional[Sequence[str]] = None,
                  session=None, device=None,
                  rolling_impl: Optional[str] = None,
                  replicate_quirks: Optional[bool] = None) -> torch.Tensor:
    """The named factors (default: all 58, in registry order)
    over a batch of gridded days, stacked to ``[F, D, T]``.

    ``bars [D, T, S, 5]`` and ``mask [D, T, S]`` are numpy arrays or
    tensors (any leading shape works; the result is ``[F, *lead, T]``).
    Bars are cast to f32 on the way in, as the JAX package's
    ``jnp.asarray`` does. ``device`` defaults to ``cuda`` and raises when
    no card is present; pass ``device='cpu'`` to run on the CPU.
    ``rolling_impl`` and ``replicate_quirks`` default to the config's.
    """
    dev = resolve_device(device)
    if isinstance(bars, np.ndarray):
        bars = torch.from_numpy(np.ascontiguousarray(bars, np.float32))
    if isinstance(mask, np.ndarray):
        mask = torch.from_numpy(np.ascontiguousarray(mask, bool))
    bars = bars.to(device=dev, dtype=torch.float32)
    mask = mask.to(device=dev, dtype=torch.bool)
    if tuple(mask.shape) != tuple(bars.shape[:-1]) or bars.shape[-1] != 5:
        raise ValueError(f"bars {tuple(bars.shape)} and mask "
                         f"{tuple(mask.shape)} do not form a day batch")
    return _stacked(bars, mask, names, session, rolling_impl,
                    replicate_quirks)


def _stacked(bars, mask, names, session, rolling_impl, replicate_quirks,
             xs_axis_name=None):
    """The named factors over device tensors, stacked to ``[F, ...]``;
    None arguments take the registry's and the config's defaults.
    ``xs_axis_name``: the tickers are one rank's of a mesh (inside
    ``with mesh:``)."""
    cfg = get_config()
    if rolling_impl is None:
        rolling_impl = cfg.rolling_impl
    if replicate_quirks is None:
        replicate_quirks = cfg.replicate_quirks
    names = factor_names() if names is None else tuple(names)
    out = compute_factors(bars, mask, names=names,
                          replicate_quirks=replicate_quirks,
                          rolling_impl=rolling_impl,
                          session=get_session(session),
                          xs_axis_name=xs_axis_name)
    return torch.stack([out[n] for n in names])


def compute_packed_prepared(buf, spec, kind: str,
                            names: Optional[Sequence[str]] = None,
                            replicate_quirks: Optional[bool] = None,
                            rolling_impl: Optional[str] = None,
                            result_spec=None, factor_stats=False,
                            session=None, device=None):
    """Device half of the packed path: one copy of an already-packed host
    buffer (``wire.pack_arrays``) to the device, unpack there, decode when
    ``kind='wire'`` (``kind='raw'`` ships ``(bars f32, mask uint8)``), and
    the named factors stacked to ``[F, D, T]`` on the device.

    ``buf`` is a numpy buffer, or a 1-D uint8 tensor: a pinned host one is
    copied with ``non_blocking=True`` on the current stream, one already
    on the device is used as it is. ``device`` defaults to ``cuda`` and
    raises when no card is present.

    ``result_spec`` (a :class:`.data.result_wire.ResultWireSpec`) makes
    the result the packed quantized payload (``[L] uint8``) in place of
    the raw f32 stack. ``factor_stats`` (True, or the count of logical
    tickers, so pad lanes past it do not read as missing) adds the
    ``[F, 9]`` sketch of :func:`.telemetry.factorplane.factor_stats_block`
    of the raw stack, taken before the encode: the return is then
    ``(result, stats)``. Neither changes the exposures' bits.
    """
    _check_kind(kind)
    dev = resolve_device(device)
    if isinstance(buf, torch.Tensor):
        _check_buffer(buf, "buf")
        buf = buf.to(dev, non_blocking=True)
    else:
        buf = torch.from_numpy(np.ascontiguousarray(buf, np.uint8)).to(dev)
    return _packed_step(buf, spec, kind, names, replicate_quirks,
                        rolling_impl, result_spec, factor_stats, session)


def _check_kind(kind: str) -> None:
    if kind not in ("wire", "raw"):
        raise ValueError(f"kind must be 'wire' or 'raw', not {kind!r}")


def _check_buffer(buf: torch.Tensor, what: str) -> None:
    if buf.dtype != torch.uint8 or buf.dim() != 1:
        raise ValueError(f"{what} is a {buf.dtype} tensor of shape "
                         f"{tuple(buf.shape)}, expected 1-D uint8")


def _decode(buf, spec, kind):
    """Unpack a device buffer and decode it when ``kind='wire'``
    (``'raw'`` ships ``(bars f32, mask uint8)``): ``(bars, mask)``."""
    arrs = wire.unpack(buf, spec)
    if kind == "wire":
        return wire.decode(*arrs)
    bars, mask = arrs  # the mask ships as uint8
    return bars, mask.to(torch.bool)


def _packed_step(buf, spec, kind, names, replicate_quirks, rolling_impl,
                 result_spec, factor_stats, session, xs_axis_name=None):
    """The packed path's body on a device buffer: unpack, decode, the
    named factors stacked to ``[F, D, T]``, and the side outputs. One
    function for the per-batch call and each step of the resident loops,
    so a resident step is bitwise the per-batch call by construction.
    ``xs_axis_name``: the buffer holds one rank's tickers of a mesh."""
    bars, mask = _decode(buf, spec, kind)
    stacked = _stacked(bars, mask, names, session, rolling_impl,
                       replicate_quirks, xs_axis_name)
    return _side_outputs(stacked, result_spec, factor_stats, xs_axis_name)


def _side_outputs(stacked, result_spec, factor_stats, xs_axis_name=None):
    """The stacked block, or its result-wire payload, with the stats
    sketch of the raw block when asked (see
    :func:`compute_packed_prepared`). ``factor_stats`` may be True, the
    logical ticker count, or a ``(days, tickers)`` pair of logical
    extents. With ``xs_axis_name`` the block holds one rank's tickers:
    the sketch and the payload's quantization are the global ones, and
    the logical extent is read against this rank's global lanes."""
    stats = None
    if factor_stats:
        block = stacked
        if factor_stats is not True:
            fd, ft = ((None, factor_stats) if np.ndim(factor_stats) == 0
                      else factor_stats)
            t = stacked.shape[-1]
            lo = (_axis_index(xs_axis_name) * t
                  if xs_axis_name is not None else 0)
            k = min(t, max(0, int(ft) - lo))
            block = stacked[..., :k]
            if fd is not None:
                block = block[..., :int(fd), :]
        stats = _factor_stats_block(block, xs_axis_name)
    if result_spec is not None:
        stacked = _result_wire.encode_block(stacked, result_spec,
                                            xs_axis_name)
    if factor_stats:
        return stacked, stats
    return stacked


def _axis_index(axis_name) -> int:
    from .parallel.mesh import current_mesh
    return current_mesh().axis_index(axis_name)


def compute_packed(arrays, kind: str, names: Optional[Sequence[str]] = None,
                   replicate_quirks: Optional[bool] = None,
                   rolling_impl: Optional[str] = None, result_spec=None,
                   factor_stats=False, session=None, device=None):
    """One-call packed path: pack the host arrays (``WireBatch.arrays``
    for ``kind='wire'``, ``(bars, mask.astype(uint8))`` for ``'raw'``) into
    one buffer, then :func:`compute_packed_prepared`."""
    buf, spec = wire.pack_arrays(arrays)
    return compute_packed_prepared(
        buf, spec, kind, names, replicate_quirks, rolling_impl,
        result_spec, factor_stats, session=session, device=device)


class DonatedBufferError(RuntimeError):
    """A device buffer was reused after :func:`compute_packed_resident`
    donated it (``Config.donate_buffers`` on the card): by the first
    torch call on the handle, or, under ``Config.debug_validate``, by
    the next entry point with the argument and the contract named."""


def _donate_device_buffers(cfg: Optional[Config] = None,
                           device=None) -> bool:
    """Whether the resident loop donates its input buffers: gated by
    ``Config.donate_buffers`` AND the card. On the CPU nothing is
    donated, as in the JAX package, so tests keep their buffers."""
    cfg = cfg or get_config()
    return bool(cfg.donate_buffers) and device is not None \
        and torch.device(device).type == "cuda"


class _DonatedTensor(torch.Tensor):
    """The class a donated buffer's handle takes once its storage is
    released: every torch function on it raises
    :class:`DonatedBufferError`. A tensor whose storage was only resized
    to 0 would not fail loudly: elementwise kernels read its null data
    pointer (a segfault on the CPU, an illegal address on the card)."""

    @classmethod
    def __torch_function__(cls, func, types, args=(), kwargs=None):
        if func is torch.Tensor.__repr__:
            return "<a donated buffer, released>"
        raise DonatedBufferError(
            f"{getattr(func, '__name__', func)} on a buffer that "
            "compute_packed_resident donated (Config.donate_buffers): its "
            "storage was released and the handle is dead to the caller")


def _guard_donated_args(arrs, caller: str,
                        cfg: Optional[Config] = None) -> None:
    """``Config.debug_validate`` guard of the donation contract: a buffer
    that an earlier call donated is caught at the NEXT entry with a
    message that names the argument and the contract. Without the guard
    the first torch call on the handle raises the same error class with
    a shorter message. Gated, as in the JAX package."""
    cfg = cfg or get_config()
    if not cfg.debug_validate:
        return
    for i, a in enumerate(arrs):
        if isinstance(a, _DonatedTensor):
            raise DonatedBufferError(
                f"{caller}: argument {i} is a dead buffer — an earlier "
                "call donated it (Config.donate_buffers; the buffer is "
                "dead to the caller, see compute_packed_resident's "
                "docstring). Copy a fresh buffer to the device instead "
                "of reusing the donated handle.")


def _invalidate_donated(arrs) -> None:
    """Release each buffer's storage (``untyped_storage().resize_(0)``)
    and mark its handle dead (:class:`_DonatedTensor`). The memory goes
    back to the caching allocator, which is stream-ordered: kernels
    already enqueued on the current stream still read the bytes. A
    buffer that may have been made on another stream (a copy stream) is
    first recorded on the current one, so its block is not handed out
    while the current stream may still read it."""
    for a in arrs:
        if a.is_cuda:
            a.record_stream(torch.cuda.current_stream(a.device))
        a.untyped_storage().resize_(0)
        a.__class__ = _DonatedTensor


def compute_packed_resident(dbufs, spec, kind: str,
                            names: Optional[Sequence[str]] = None,
                            replicate_quirks: Optional[bool] = None,
                            rolling_impl: Optional[str] = None,
                            result_spec=None, factor_stats=False,
                            session=None, device=None):
    """N device-resident packed buffers through the packed path, one
    after another on the current stream, with no host round trip in
    between; the stacked result stays on the device (fetch it once).

    ``dbufs`` is a sequence of 1-D uint8 tensors on ``device`` that all
    share ``spec`` (encode with one shared widen-only ``floor``; see
    ``tests/torch_cases.encode_year``). Each step runs the body of
    :func:`compute_packed_prepared` (so it is bitwise that call on the
    same buffer) and writes into a preallocated output: ``[N, F, D, T]``
    f32, or ``[N, L]`` uint8 with ``result_spec``, plus ``[N, F, 9]``
    stats with ``factor_stats`` (the return is then ``(result, stats)``).
    The inputs are not stacked: that would hold the year's bytes twice.

    The JAX package's scan executable; eager torch enqueues each step's
    kernels as the loop runs, so nothing is lowered or compiled ahead
    (the JAX package's ``lower_packed_resident`` has no counterpart).

    On the card (``Config.donate_buffers``) the buffers are DONATED:
    each one's storage is released once its step is enqueued, so the
    year's inputs are not all live at once, and the handles are dead to
    the caller (any reuse raises; ``Config.debug_validate`` turns that
    into a :class:`DonatedBufferError` naming this contract at the next
    entry). Copy fresh buffers in rather than reusing donated ones. On
    the CPU nothing is donated. ``device`` defaults to ``cuda`` and
    raises when no card is present.
    """
    _check_kind(kind)
    dev = resolve_device(device)

    def step(buf, i):
        return _packed_step(buf, spec, kind, names, replicate_quirks,
                            rolling_impl, result_spec, factor_stats,
                            session)

    return _resident_loop(dbufs, dev, "compute_packed_resident", step,
                          bool(factor_stats))


def _resident_loop(dbufs, dev, caller: str, step, with_stats: bool):
    """The resident loops' shared frame: check the buffers, run
    ``step(buf, i)`` over them in order into preallocated outputs
    (``[N, *y]``, plus ``[N, *stats]`` when ``with_stats``), and donate
    each buffer once its step is enqueued (on the card, under
    ``Config.donate_buffers``)."""
    cfg = get_config()
    dbufs = list(dbufs)
    if not dbufs:
        raise ValueError(f"{caller} needs at least one buffer")
    _guard_donated_args(dbufs, caller, cfg)
    for i, b in enumerate(dbufs):
        if not isinstance(b, torch.Tensor):
            raise TypeError(f"dbufs[{i}] is a {type(b).__name__}, expected "
                            "a device-resident uint8 tensor")
        _check_buffer(b, f"dbufs[{i}]")
        if b.device.type != dev.type or (dev.index is not None
                                          and b.device != dev):
            raise ValueError(f"dbufs[{i}] is on {b.device}, not {dev}")
        if b.shape != dbufs[0].shape:
            raise ValueError(f"dbufs[{i}] has {b.shape[0]} bytes, dbufs[0] "
                             f"{dbufs[0].shape[0]}: encode the year under "
                             "one shared floor")
    donating = _donate_device_buffers(cfg, dev)
    if donating:
        for i, b in enumerate(dbufs):
            if not b.untyped_storage().resizable():
                raise ValueError(f"dbufs[{i}]'s storage cannot be released; "
                                 "donate buffers made by a copy to the "
                                 "device")
    n = len(dbufs)
    out = stats = None
    for i, buf in enumerate(dbufs):
        res = step(buf, i)
        y, st = res if with_stats else (res, None)
        if out is None:
            out = torch.empty((n, *y.shape), dtype=y.dtype, device=y.device)
            if st is not None:
                stats = torch.empty((n, *st.shape), dtype=st.dtype,
                                    device=st.device)
        out[i] = y
        if st is not None:
            stats[i] = st
        if donating:
            _invalidate_donated((buf,))
    return (out, stats) if with_stats else out


def compute_packed_resident_sharded(dbufs, spec, kind: str, mesh,
                                    names: Optional[Sequence[str]] = None,
                                    replicate_quirks: Optional[bool] = None,
                                    rolling_impl: Optional[str] = None,
                                    result_spec=None, factor_stats=False,
                                    session=None):
    """The resident year over a ``(1, n)`` mesh, run on each of its
    ranks: the JAX package's ``compute_packed_resident_sharded``.

    ``dbufs`` is this rank's N buffers of the year's ticker shard
    (``parallel.mesh.put_packed_year`` of the ``[N, S, L]`` stack that
    ``data.wire.pack_sharded`` makes), on ``mesh.device``. Each step is
    :func:`compute_packed_resident`'s body on this rank's tickers, with
    the ``doc_pdf*`` rank gathered over the tickers axis (the one
    collective of the 58 kernels). Returns this rank's ``[N, F, D,
    T/n]`` on its device. The side outputs are the GLOBAL ones: with
    ``result_spec`` the per-(factor, day) min/max and widen decisions
    are all-reduced before this rank encodes its lanes (its ``[N, L]``
    payload is the single-device payload's arrays restricted to its
    tickers), and ``factor_stats`` (True or the logical ticker count, so
    pad lanes never read as missing) is the ``[N, F, 9]`` sketch of the
    whole block on every rank (counts/min/max exact, f64 sums in the
    transport's order, rounded once). The donation contract is
    :func:`compute_packed_resident`'s."""
    from .parallel.mesh import DAYS_AXIS, TICKERS_AXIS

    _check_kind(kind)
    if mesh.shape[DAYS_AXIS] != 1:
        raise ValueError(
            f"compute_packed_resident_sharded takes a tickers-only mesh, "
            f"not {tuple(mesh.shape.values())}: the 2-D loop is "
            "compute_packed_resident_2d")

    def step(buf, i):
        return _packed_step(buf, spec, kind, names, replicate_quirks,
                            rolling_impl, result_spec, factor_stats,
                            session, xs_axis_name=TICKERS_AXIS)

    t0 = time.perf_counter()
    with mesh:
        out = _resident_loop(dbufs, mesh.device,
                             "compute_packed_resident_sharded", step,
                             bool(factor_stats))
    # this rank's completion watermark, waited for off the caller's
    # thread; gathered over the ranks at meshplane.drain()
    get_telemetry().meshplane.watch_async_mesh(
        out[0] if factor_stats else out, mesh, boundary="resident.group",
        t0=t0)
    return out


def compute_packed_resident_2d(dbufs, spec, kind: str, mesh,
                               names: Optional[Sequence[str]] = None,
                               replicate_quirks: Optional[bool] = None,
                               rolling_impl: Optional[str] = None,
                               result_spec=None, factor_stats=False,
                               carry_in=None, n_tickers=None, session=None):
    """The resident year over a 2-D ``(days=d, tickers=t)`` mesh, with the
    cross-day carry handoff: the JAX package's
    ``compute_packed_resident_2d``, run on each rank.

    ``dbufs`` is this rank's N tile buffers (``parallel.mesh.
    put_packed_year_2d`` of the ``[N, Sd, St, L]`` stack of
    ``data.wire.pack_sharded_2d``): each step covers day-span ``i`` x
    ticker block ``j`` of one batch. Per step: the packed body on the
    tile (the ``doc_pdf*`` rank gathered over tickers; each day-shard
    ranks its own days' frames), and the tile's intraday prefix state
    (``stream.carry.span_prefix_state``, global day index ``n * d *
    D_loc + i * D_loc`` as the ordering key) folded into the carry. After
    the loop the carry is handed off over the days axis
    (``parallel.collectives.xs_carry_handoff_local``), so every
    day-shard holds the global state.

    ``carry_in`` ({``last_close``, ``n_bars``, ``has``} ``[T/t]``, this
    rank's tickers; ``stream.carry.init_span_state`` +
    ``parallel.mesh.put_span_carry``) seeds the fold and is older than
    anything this call sees; a caller pipelining groups threads the
    returned carry into the next call. ``carry_in=None`` seeds an empty
    carry of ``n_tickers`` (the padded extent; required then).

    Returns ``(ys, carry)``: ``ys`` this rank's ``[N, F, D/d, T/t]``.
    ``factor_stats`` (True, or a ``(days, tickers)`` pair of logical
    extents) adds the global ``[N, F, 9]`` sketch: ``(ys, stats,
    carry)``. With ``result_spec`` each batch's day rows are gathered
    over the days axis and the payload is the 1-D loop's for this ticker
    block (the same on every day-shard). Each call counts one
    ``carry_handoff`` dispatch in ``mesh.collective_dispatches``. The
    donation contract is :func:`compute_packed_resident`'s for
    ``dbufs``; the carry is never donated."""
    from .parallel import transport
    from .parallel.collectives import xs_carry_handoff_local
    from .parallel.mesh import DAYS_AXIS, TICKERS_AXIS, put_span_carry
    from .stream.carry import (combine_span_state, init_span_state,
                               span_prefix_state)

    _check_kind(kind)
    if carry_in is None:
        if n_tickers is None:
            raise ValueError("carry_in=None needs n_tickers (the padded "
                             "ticker extent) to seed the carry")
        carry_in = put_span_carry(init_span_state(int(n_tickers)), mesh)
    get_telemetry().meshplane.note_collective("carry_handoff")
    d_shards = mesh.shape[DAYS_AXIS]
    i_day = mesh.axis_index(DAYS_AXIS)
    days_group = mesh.group(DAYS_AXIS)
    keys = ("last_close", "n_bars", "has")
    # the incoming carry is older than anything this call sees: day -1
    # loses to every real day and wins only where no bar lands
    state = {**{k: carry_in[k] for k in keys},
             "day": torch.full(carry_in["n_bars"].shape, -1,
                               dtype=torch.int32,
                               device=carry_in["n_bars"].device)}
    side = result_spec is not None or bool(factor_stats)

    def step(buf, n):
        nonlocal state
        bars, mask = _decode(buf, spec, kind)
        y = _stacked(bars, mask, names, session, rolling_impl,
                     replicate_quirks, TICKERS_AXIS)
        d_local = bars.shape[0]
        # global day order is batch-major, day-shard-minor
        st = span_prefix_state(bars, mask,
                               day_base=n * d_shards * d_local
                               + i_day * d_local)
        state = combine_span_state(state, st)
        if not side:
            return y
        # the side outputs see the batch's whole day axis
        whole = transport.all_gather(y, days_group, dim=1)
        res = _side_outputs(whole, result_spec, factor_stats, TICKERS_AXIS)
        if result_spec is None:
            return y, res[1]
        return res

    t0 = time.perf_counter()
    with mesh:
        out = _resident_loop(dbufs, mesh.device,
                             "compute_packed_resident_2d", step,
                             bool(factor_stats))
        carry = xs_carry_handoff_local(state, combine_span_state,
                                       DAYS_AXIS, d_shards)
    carry = {k: carry[k] for k in keys}
    get_telemetry().meshplane.watch_async_mesh(
        out[0] if factor_stats else out, mesh,
        boundary="resident.group2d", t0=t0)
    if factor_stats:
        return out[0], out[1], carry
    return out, carry


#: ticker-axis bucket size: T pads up to a multiple, so every batch of a
#: universe has the JAX package's shape (and so its result bits)
TICKER_BUCKET = 256


class ExposureTable:
    """Long-format exposure rows ``(code, date, factor...)`` sorted by
    (date, code) — the reference's exposure contract widened to many
    factor columns."""

    def __init__(self, columns: Dict[str, np.ndarray]):
        if "code" not in columns or "date" not in columns:
            raise ValueError("an ExposureTable needs 'code' and 'date' "
                             "columns")
        self.columns = columns

    # --- construction ---------------------------------------------------
    @classmethod
    def empty(cls, names: Sequence[str]) -> "ExposureTable":
        cols = {"code": np.array([], dtype=object),
                "date": np.array([], dtype="datetime64[D]")}
        for n in names:
            cols[n] = np.array([], dtype=np.float32)
        return cls(cols)

    @classmethod
    def concat(cls, parts: Sequence["ExposureTable"]) -> "ExposureTable":
        keys = list(parts[0].columns)
        for i, p in enumerate(parts[1:], start=1):
            if set(p.columns) != set(keys):
                # schema drift (e.g. a cache written by a different factor
                # list) must fail loudly, not as a KeyError mid-concat;
                # column ORDER differences reconcile to part 0's order
                raise ValueError(
                    f"ExposureTable.concat: part {i} columns "
                    f"{sorted(p.columns)} != part 0 columns {sorted(keys)}")
        cols = {k: np.concatenate([np.asarray(p.columns[k]) for p in parts])
                for k in keys}
        return cls(cols)

    # --- views ----------------------------------------------------------
    @property
    def factor_names(self) -> Tuple[str, ...]:
        return tuple(k for k in self.columns if k not in ("code", "date"))

    def __len__(self) -> int:
        return len(self.columns["code"])

    @property
    def max_date(self) -> Optional[np.datetime64]:
        d = self.columns["date"]
        return d.max() if len(d) else None

    def sort(self) -> "ExposureTable":
        order = np.lexsort((self.columns["code"], self.columns["date"]))
        self.columns = {k: np.asarray(v)[order]
                        for k, v in self.columns.items()}
        return self

    def single(self, name: str) -> Dict[str, np.ndarray]:
        """Reference-shaped single-factor view ``(code, date, <name>)``."""
        return {"code": self.columns["code"], "date": self.columns["date"],
                name: self.columns[name]}

    # --- parquet --------------------------------------------------------
    def to_arrow(self):
        """The table as a ``pyarrow.Table`` (code string, date date32,
        factors float32)."""
        import pyarrow as pa

        arrays, fields = [], []
        for k, v in self.columns.items():
            if k == "code":
                arrays.append(pa.array([str(c) for c in v], pa.string()))
                fields.append(pa.field(k, pa.string()))
            elif k == "date":
                arrays.append(pa.array(v.astype("datetime64[D]")))
                fields.append(pa.field(k, pa.date32()))
            else:
                arrays.append(pa.array(np.asarray(v, np.float32)))
                fields.append(pa.field(k, pa.float32()))
        return pa.Table.from_arrays(arrays, schema=pa.schema(fields))

    @classmethod
    def from_arrow(cls, table) -> "ExposureTable":
        cols = {}
        for name in table.schema.names:
            col = table.column(name)
            if name == "code":
                cols[name] = np.asarray(col.to_pylist(), dtype=object)
            elif name == "date":
                cols[name] = col.to_numpy(
                    zero_copy_only=False).astype("datetime64[D]")
            else:
                cols[name] = col.to_numpy(zero_copy_only=False)
        return cls(cols)

    def save(self, path: str) -> None:
        """Atomic cache write. ``.mffz`` paths take the framed
        compressed format (arrow IPC + zstd/lz4/zlib chain —
        data/io.frame_bytes); everything else stays parquet. Both are
        tempfile-then-rename crash-safe."""
        if path.endswith(".mffz"):
            dio.write_framed_table_atomic(self.to_arrow(), path)
        else:
            dio.write_parquet_atomic(self.to_arrow(), path)

    @classmethod
    def load(cls, path: str) -> "ExposureTable":
        if path.endswith(".mffz"):
            return cls.from_arrow(dio.read_framed_table(path))
        import pyarrow.parquet as pq
        return cls.from_arrow(pq.read_table(path))


def _pad_bucket(n: int, bucket: int = TICKER_BUCKET) -> int:
    return max(bucket, -(-n // bucket) * bucket)


def _grid_batch(day_data: List[Tuple[np.datetime64, Dict[str, np.ndarray]]],
                shard_mult: int = 1):
    """Union-code, bucket-padded dense batch for a list of day columns.

    Returns ``(bars [D,Tp,240,5], mask [D,Tp,240], codes [Tp],
    present [D,Tp])`` where ``present`` marks codes that had rows in that
    day's file (they get an output row even if every bar was off-grid,
    matching the reference's per-group row). ``Tp`` pads to a multiple of
    both TICKER_BUCKET and ``shard_mult`` (the mesh's tickers extent).
    """
    # The code axis never becomes object dtype: object put Python-level
    # comparisons inside every searchsorted/compare/isin of every day.
    # Per-day uniques are computed once and reused for both the union and
    # `present`. When every day carries raw integer codes
    # (data/io.read_minute_day_raw, compute_exposures' reader) the whole grid
    # runs on int64 and only the Tp-element axis is rendered to the
    # normalized string form, once.
    code_arrays = [np.asarray(d["code"]) for _, d in day_data]
    int_path = all(c.dtype.kind in "iu" for c in code_arrays)
    day_uniqs = [np.unique(c) for c in code_arrays]
    if int_path and any(len(u) for u in day_uniqs):
        nonempty = [u for u in day_uniqs if len(u)]
        if (min(int(u[0]) for u in nonempty) < 0
                or max(int(u[-1]) for u in nonempty) > 999_999):
            # out of the zero-padded 6-char domain: int sort order would
            # no longer match the rendered string sort order — normalize
            # per day and take the string path
            int_path = False
            code_arrays = [dio.int_codes_to_str(c) for c in code_arrays]
            day_uniqs = [np.unique(c) for c in code_arrays]
    elif not int_path and any(c.dtype.kind in "iu" for c in code_arrays):
        # mixed int/str days in one batch: normalize the int ones
        code_arrays = [dio.int_codes_to_str(c) if c.dtype.kind in "iu"
                       else c for c in code_arrays]
        day_uniqs = [np.unique(c) for c in code_arrays]
    all_codes = np.unique(np.concatenate(day_uniqs))
    bucket = TICKER_BUCKET * shard_mult // np.gcd(TICKER_BUCKET, shard_mult)
    t_pad = _pad_bucket(len(all_codes), int(bucket))
    n_pads = t_pad - len(all_codes)
    if int_path:
        # pad codes 10^6+i sort after every real code, like the
        # '__padN__' names do in the string path
        axis = np.concatenate([all_codes.astype(np.int64),
                               1_000_000 + np.arange(n_pads,
                                                     dtype=np.int64)])
        codes_out = np.concatenate([
            dio.int_codes_to_str(all_codes),
            np.array([f"__pad{i}__" for i in range(n_pads)])
            if n_pads else np.empty(0, "U6")])
    else:
        all_str = all_codes.astype(str)
        # explicit dtype for the empty case: np.array([]) is float64 and
        # would promote the whole axis to U32 (or raise on older numpy)
        pads = (np.array([f"__pad{i}__" for i in range(n_pads)])
                if n_pads else np.empty(0, all_str.dtype))
        # concatenate promotes to the wider 'U' width; pads sort after
        # real codes ('_' > any digit used in A-share codes)
        axis = codes_out = np.sort(np.concatenate([all_str, pads]))
    bars_l, mask_l, present_l = [], [], []
    for (_, d), c, uniq in zip(day_data, code_arrays, day_uniqs):
        g = grid_day(c, d["time"], d["open"], d["high"], d["low"],
                     d["close"], d["volume"], codes=axis)
        bars_l.append(g.bars)
        mask_l.append(g.mask)
        # positions in `axis` == positions in `codes_out` (both carry
        # the sorted real codes first, pads after — pads are never
        # present, so only their positions-as-filler matter)
        present_l.append(np.isin(g.codes, uniq))
    return (np.stack(bars_l), np.stack(mask_l), codes_out,
            np.stack(present_l))


#: consecutive failed batches before the device pipeline gives up (the
#: per-batch retry makes each of these TWO device attempts)
_CIRCUIT_BREAKER = 3

#: stop soloing after this many consecutive day-launch failures inside
#: one isolation pass: against a dead device every solo launch just
#: fails again, so after two the remaining days are recorded unattempted
#: (recoverable via retry_failed) and the breaker decides the run's fate
_ISOLATION_GIVEUP = 2


def _run_device_pipeline(batches, names, cfg: Config, timer: Timer,
                         parts: List["ExposureTable"],
                         failures: Optional[FailureReport] = None,
                         path_of: Optional[Dict[str, str]] = None,
                         telemetry: Optional[Telemetry] = None,
                         device=None, mesh=None) -> None:
    """Double-buffered device pipeline: a producer thread prepares batch
    i+1 (grid + validate + wire-encode + pack) while the device computes
    batch i, through a bounded queue of two batches.

    On the card the producer packs each batch into a pinned host buffer
    (torch's caching host allocator, which reuses a buffer only once the
    copies recorded on it have completed); the consumer copies it with
    ``non_blocking=True`` on a copy stream of its own, the compute stream
    waits on that copy's event, and the ``[F, D, Tp]`` result starts its
    non-blocking copy back to a pinned host buffer right after the
    launch. The consumer launches batch i+1 before it settles batch i,
    so the card has the next batch queued while the host waits on this
    one's result. A payload (and its pinned buffer) lives until its batch
    settles, so a retry re-copies the same bytes. On the CPU
    (``device='cpu'``) the same loop runs on plain host arrays.

    With ``mesh`` (global rank 0 of a ``(1, n)`` mesh, the other ranks in
    :func:`_mesh_worker`) the tickers are padded to a multiple of both
    TICKER_BUCKET and n, each batch is packed into n per-shard buffers
    (``wire.pack_sharded``), and a launch is :func:`_mesh_launch`:
    scattered, computed on every rank, gathered back here. Retry,
    isolation and the breaker are the same.

    Elasticity: a batch that fails on the device is retried ONCE; if the
    retry also fails — or host prep (grid/encode) fails, which is
    near-always deterministic — multi-day batches are ISOLATED per day
    (fresh host prep from disk, one launch per day), so a single poisoned
    day cannot take its batch-mates down: only the days that fail alone
    land in ``failures``. ``_CIRCUIT_BREAKER`` consecutive dead batches
    abort (a CUDA error is sticky: after one, every launch fails, and the
    breaker ends the run); completed batches always survive an abort (the
    consumer flushes its in-flight batch before raising and the caller
    saves a resume-safe partial cache)."""
    tel = telemetry if telemetry is not None else get_telemetry()
    dev = mesh.device if mesh is not None else resolve_device(device)
    card = dev.type == "cuda"
    copy_stream = (torch.cuda.Stream(device=dev)
                   if card and mesh is None else None)
    n_shards, grid_kw = 1, {}
    if mesh is not None:
        from .parallel.mesh import TICKERS_AXIS
        n_shards = mesh.axis_size(TICKERS_AXIS)
        grid_kw = {"shard_mult": n_shards}
    inflight = [0]  # launched-not-yet-materialized batches (gauge)

    def _note_queue_depth(depth: int) -> None:
        # gauge = the last sampled depth; histogram = its distribution
        # over the run, sampled after each put and each get (a p95 pinned
        # at maxsize means the device is the bottleneck; when the
        # producer is, the gets read 0 and the puts 1, the batch not yet
        # taken by the waiting consumer)
        tel.gauge("pipeline.queue_depth", depth)
        tel.observe("pipeline.queue_depth", depth)

    q: "queue.Queue" = queue.Queue(maxsize=2)
    stop = threading.Event()  # set on consumer abort; unblocks producer
    wire_floor: dict = {}  # widen-only dtype state across this run's batches

    def _qput(item) -> bool:
        """Bounded put that gives up when the consumer aborted —
        otherwise a breaker abort would leave the daemon producer
        blocked on a full queue forever, pinning the batches it holds."""
        while not stop.is_set():
            try:
                q.put(item, timeout=0.5)
                _note_queue_depth(q.qsize())
                return True
            except queue.Full:
                continue
        return False

    def _record_batch_failure(dates, exc):
        if failures is None:
            raise exc
        tel.counter("pipeline.failed_days", len(dates))
        for d in dates:
            failures.record(str(d), (path_of or {}).get(str(d), ""), exc)

    def pack(arrays):
        """One host buffer of ``arrays``: pinned on the card (a failed
        pin raises), plain numpy on the CPU; on a mesh an ``[n, L]``
        stack of per-shard buffers, scattered from the host."""
        if mesh is not None:
            return wire.pack_sharded(arrays, n_shards)
        if not card:
            return wire.pack_arrays(arrays)
        spec, nbytes = wire.pack_spec(arrays)
        host = torch.empty(nbytes, dtype=torch.uint8, pin_memory=True)
        wire.pack_arrays(arrays, out=host.numpy())
        return host, spec

    def prep(batch):
        """Host half for one batch of (date, day-columns) pairs: grid +
        validate + wire-encode + pack into the launch payload. Shared by
        the producer thread and by per-day isolation on the consumer
        (widen-only ``wire_floor`` updates are monotonic, so the
        cross-thread sharing is benign). Raises on failure."""
        dates = [d for d, _ in batch]
        with timer("grid"):
            bars, mask, codes, present = _grid_batch(batch, **grid_kw)
        if cfg.debug_validate:
            from .utils.debug import validate_batch
            validate_batch(bars, mask)
        w = None
        if cfg.wire_transfer:
            with timer("wire_encode"):
                w = wire.encode(bars, mask, floor=wire_floor)
        # the wire->raw fallback triples the bytes on the link; count it
        # per batch so it can never be invisible
        tel.counter("pipeline.encode_kind",
                    kind="wire" if w is not None else "raw")
        with timer("pack"):
            if w is not None:
                buf, spec = pack(w.arrays)
                kind = "wire"
            else:
                buf, spec = pack((bars, np.asarray(mask).view(np.uint8)))
                kind = "raw"
        return (dates, codes, present, (buf, spec, kind))

    def produce():
        try:
            for batch in batches:
                dates = [d for d, _ in batch]
                try:
                    payload = prep(batch)
                except Exception as e:  # noqa: BLE001 — batch isolation
                    logger.warning("host prep failed for batch %s: %s",
                                   dates, e)
                    if not _qput(("hostfail", (dates, e))):
                        return
                    continue
                if not _qput(("batch", payload)):
                    return
        except BaseException as e:  # surface in the consumer thread
            _qput(("error", e))
            return
        _qput(("done", None))

    threading.Thread(target=produce, daemon=True).start()

    def copy_in(host):
        """The pinned ``host`` buffer onto the card on the copy stream;
        the compute (current) stream waits on the copy's event. Returns
        the device buffer and ``(start, end, bytes)`` of the copy."""
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        with torch.cuda.stream(copy_stream):
            start.record(copy_stream)
            dbuf = host.to(dev, non_blocking=True)
            end.record(copy_stream)
        compute = torch.cuda.current_stream(dev)
        compute.wait_event(end)
        # allocated on the copy stream, read on the compute stream
        dbuf.record_stream(compute)
        return dbuf, (start, end, host.numel())

    def launch(item):
        dates, codes, present, (buf, spec, kind) = item
        tel.counter("pipeline.batches_launched")
        copy = None
        with timer("launch"), trace_annotation("factor_batch"):
            if mesh is not None:
                out = _mesh_launch(mesh, buf, (
                    "batch", spec, kind, tuple(names),
                    cfg.replicate_quirks, cfg.rolling_impl))
                tel.counter("pipeline.h2d_bytes", buf.nbytes)
            else:
                if card:
                    buf, copy = copy_in(buf)
                out = compute_packed_prepared(
                    buf, spec, kind, names=names,
                    replicate_quirks=cfg.replicate_quirks,
                    rolling_impl=cfg.rolling_impl, device=dev)
            if card:
                # start the device->host copy now, not at materialize
                # time: it then overlaps the next batch's launch
                host = torch.empty(out.shape, dtype=out.dtype,
                                   pin_memory=True)
                host.copy_(out, non_blocking=True)
                done = torch.cuda.Event()
                done.record()
                out = (host, done)
        inflight[0] += 1  # in flight only once the dispatch succeeded
        tel.gauge("pipeline.inflight_batches", inflight[0])
        return dates, codes, present, out, copy

    def materialize(pending):
        dates, codes, present, out, copy = pending
        try:
            with timer("device"):
                if card:
                    host, done = out
                    done.synchronize()
                    stacked = host.numpy()
                else:
                    stacked = out.numpy()
        finally:
            # the batch leaves the in-flight window whether the fetch
            # succeeded or is about to be retried through launch()
            inflight[0] = max(0, inflight[0] - 1)
            tel.gauge("pipeline.inflight_batches", inflight[0])
        if copy is not None:
            start, end, nbytes = copy
            tel.counter("pipeline.h2d_bytes", nbytes)
            tel.observe("pipeline.h2d_ms", start.elapsed_time(end))
        # build ALL day tables before touching parts: a mid-loop failure
        # followed by the whole-batch retry must not leave day 1's rows
        # appended twice (duplicate (code, date) rows in the cache)
        parts.extend(_batch_parts(dates, codes, present, stacked, names))
        tel.counter("pipeline.batches_completed")
        tel.counter("pipeline.days_completed", len(dates))

    consecutive = 0

    def _bump_breaker(exc):
        nonlocal consecutive
        consecutive += 1
        tel.gauge("pipeline.breaker_consecutive_failures", consecutive)
        if consecutive >= _CIRCUIT_BREAKER:
            tel.counter("pipeline.circuit_breaker_trips")
            raise RuntimeError(
                f"device pipeline: {consecutive} consecutive batches "
                "failed — device looks dead; aborting (completed batches "
                "are preserved and the cache resume will pick up from "
                "here)") from exc

    def _count_failure(dates, exc):
        """Record-and-bump for failures with nothing to isolate
        (single-day batches, and callers running without a ledger)."""
        _record_batch_failure(dates, exc)
        _bump_breaker(exc)

    def _isolate_batch(dates, exc):
        """A batch failed beyond its one retry (or failed host prep):
        re-run each day ALONE with fresh host prep from disk, so one
        poisoned day cannot take its batch-mates down with it — only
        the days that fail individually are recorded. Single-day
        batches have nothing to isolate and record directly.

        Breaker policy: EVERY isolation event bumps the breaker, even
        when all days recover solo — isolation costs 2+N launches, so a
        device that fails every multi-day batch but passes days solo
        must still trip the breaker after _CIRCUIT_BREAKER batches
        rather than grind the whole file list; only a cleanly settled
        batch resets the count."""
        if failures is None:
            raise exc
        if len(dates) <= 1:
            _count_failure(dates, exc)
            return
        logger.warning("batch %s failed beyond retry (%s); isolating "
                       "per day", dates, exc)
        tel.counter("pipeline.batch_isolations")
        solo_fails = 0
        for d in dates:
            path = (path_of or {}).get(str(d), "")
            if solo_fails >= _ISOLATION_GIVEUP:
                tel.counter("pipeline.isolation_giveup_days")
                failures.record(str(d), path, exc)
                continue
            try:
                with timer("io"):
                    day = dio.read_minute_day_raw(path)
                if len(day["code"]) == 0:
                    raise ValueError("empty day file")
                materialize(launch(prep([(d, day)])))
            except Exception as e2:  # noqa: BLE001 — per-day isolation
                logger.warning("day %s failed in isolation: %s", d, e2)
                tel.counter("pipeline.isolated_day_failures")
                failures.record(str(d), path, e2)
                solo_fails += 1
        _bump_breaker(exc)

    def settle(payload, launched, retried=False):
        """materialize; on failure re-run the whole batch once, then
        record its days as failures and trip the breaker if the device
        looks dead."""
        nonlocal consecutive
        try:
            materialize(launched)
            consecutive = 0
            tel.gauge("pipeline.breaker_consecutive_failures", 0)
            return
        except Exception as e:  # noqa: BLE001 — batch isolation
            if not retried:
                logger.warning("batch %s failed on device (%s); "
                               "retrying once", payload[0], e)
                tel.counter("pipeline.retries", stage="materialize")
                try:
                    relaunched = launch(payload)
                except Exception as e2:  # noqa: BLE001
                    _isolate_batch(payload[0], e2)
                else:
                    settle(payload, relaunched, retried=True)
                return
            _isolate_batch(payload[0], e)

    pending = None  # (payload, launched)

    def flush_pending():
        """Materialize the in-flight batch NOW — called whenever the
        pipelined ordering is about to break (a later batch failed, or
        we are about to raise), so a healthy completed batch can never
        be dropped on the floor by a neighbour's failure."""
        nonlocal pending
        if pending is not None:
            p_, l_ = pending
            pending = None
            settle(p_, l_)

    try:
        while True:
            kind, payload = q.get()
            _note_queue_depth(q.qsize())
            if kind == "error":
                try:
                    flush_pending()
                finally:
                    raise payload
            if kind == "done":
                break
            if kind == "hostfail":
                # host-prep failures get no same-shape retry (they are
                # almost always deterministic — bad file, encode bug),
                # but multi-day batches still isolate per day so one bad
                # day's grid/encode failure cannot record its innocent
                # batch-mates; failures count toward the breaker either
                # way (a systemic host problem must abort, not grind
                # through the file list recording every day)
                dates, e = payload
                tel.counter("pipeline.host_prep_failures")
                flush_pending()
                _isolate_batch(dates, e)
                continue
            try:
                launched = launch(payload)
            except Exception as e:  # noqa: BLE001 — batch isolation
                logger.warning("batch %s failed at launch (%s); "
                               "retrying once", payload[0], e)
                tel.counter("pipeline.retries", stage="launch")
                try:
                    launched = launch(payload)
                except Exception as e2:  # noqa: BLE001
                    # settle the independent in-flight batch BEFORE
                    # counting this failure (its success must not reset
                    # the counter, and its data must survive whatever we
                    # raise next)
                    flush_pending()
                    _isolate_batch(payload[0], e2)
                    continue
            if pending is not None:
                settle(*pending)
            pending = (payload, launched)
        flush_pending()
    except BaseException:
        # unblock and drain the producer so an abort can't leak the
        # daemon thread + the batches it holds
        stop.set()
        try:
            while True:
                q.get_nowait()
        except queue.Empty:
            pass
        raise


def _batch_parts(dates, codes, present, stacked, names
                 ) -> List[ExposureTable]:
    """One table part a day of a batch's ``[F, D, Tp]`` host result: the
    codes present that day (the boolean selections copy out of the
    result buffer)."""
    out = []
    for i, date in enumerate(dates):
        sel = present[i]
        cols = {"code": codes[sel].astype(object),
                "date": np.full(int(sel.sum()), date, "datetime64[D]")}
        for j, n in enumerate(names):
            cols[n] = stacked[j, i, sel].astype(np.float32)
        out.append(ExposureTable(cols))
    return out


def _mesh_launch(mesh, stack, head):
    """Global rank 0's launch of one batch on a ``(1, n)`` mesh: the
    batch's ``head`` (the step's arguments) broadcast to every rank, the
    ``[n, L]`` per-shard ``stack`` scattered, then :func:`_mesh_step`.
    Returns the batch's ``[F, D, Tp]`` on this rank's device."""
    from .parallel import transport

    transport.broadcast_object(head)
    return _mesh_step(mesh, head, [torch.from_numpy(stack[s])
                                   for s in range(stack.shape[0])])


def _mesh_step(mesh, head, chunks=None):
    """One batch on every rank of a ``(1, n)`` mesh: global rank 0's
    per-shard buffers (``chunks``, None elsewhere) scattered, each rank's
    tickers computed on its device (the ``doc_pdf*`` rank gathered over
    the tickers axis), the results gathered back. Returns the batch's
    ``[F, D, Tp]`` on rank 0, None elsewhere.

    The ranks swap a status ahead of every collective of the step
    (``transport.status_guard``) and once more after its compute, before
    the result gather. A rank whose compute fails swaps its error instead
    of entering its next collective, so every rank learns of the failure
    in the same swap: rank 0 raises (and retries or isolates the batch as
    any failed batch) and every rank stays in step for the next one,
    whether the failure came before the ``doc_pdf*`` gather or after it.
    Not covered: a failure inside a collective itself (a transport error,
    a rank that dies): gloo then raises on the other ranks, NCCL waits out
    the process group's timeout, and the run aborts with its completed
    batches saved."""
    from .parallel import transport
    from .parallel.mesh import TICKERS_AXIS

    _, spec, kind, names, replicate_quirks, rolling_impl = head
    group = mesh.group(TICKERS_AXIS)
    mine = transport.scatter_bytes(chunks, group)
    y, err, errs = None, None, None
    with transport.status_guard(group):
        try:
            if mesh.device.type == "cuda":
                mine = mine.pin_memory().to(mesh.device, non_blocking=True)
            with mesh:
                y = _packed_step(mine, spec, kind, names, replicate_quirks,
                                 rolling_impl, None, False, None,
                                 xs_axis_name=TICKERS_AXIS)
        except transport.PeerStepError as e:  # every rank saw this swap
            errs = e.errors
        except Exception as e:  # noqa: BLE001 — reported to rank 0
            logger.warning("mesh step failed on rank %d: %s", mesh.rank, e)
            err = f"rank {mesh.rank}: {type(e).__name__}: {e}"
    if errs is None:
        errs = transport.swap_status(err, group)
    if errs:
        if mesh.rank == 0:
            raise RuntimeError("mesh step failed: " + "; ".join(errs))
        return None
    parts = transport.gather(y, group)
    return None if parts is None else torch.cat(parts, dim=-1)


def _mesh_worker(mesh) -> None:
    """A rank other than 0 of a mesh run of :func:`compute_exposures`:
    serve rank 0's batches until it says the run is over."""
    from .parallel import transport

    while True:
        head = transport.broadcast_object(None)
        if head[0] == "exit":
            return
        _mesh_step(mesh, head)


#: ``Config.backend`` values: the device pipeline, the host oracle, and
#: the reference's own kernels (refused, :data:`POLARS_REFUSAL`)
BACKENDS = ("torch", "numpy", "polars")

POLARS_REFUSAL = (
    "backend='polars' is not ported: it runs the reference's own kernels "
    "through tools/refdiff, whose harness imports the JAX package, and "
    "the port imports none of it (ROADMAP Queue 1 item 7c); "
    "backend='numpy' runs the f64 oracle")


def _run_oracle(batches, names, parts: List[ExposureTable]) -> None:
    """The numpy backend: the f64 oracle (:mod:`.oracle`, the reference's
    polars semantics) over each day's long-format rows on the host, one
    table part a day."""
    import pandas as pd

    from .oracle import compute_oracle

    for batch in batches:
        for date, d in batch:
            df = pd.DataFrame(
                {k: d[k] for k in ("code", "time", "open", "high", "low",
                                   "close", "volume")})
            df["date"] = date
            wide = compute_oracle(df, names)
            cols = {"code": wide["code"].to_numpy(dtype=object),
                    "date": np.full(len(wide), date, "datetime64[D]")}
            for n in names:
                cols[n] = wide[n].to_numpy(np.float32)
            parts.append(ExposureTable(cols))


def _topup_missing_factors(cached, missing, all_files, minute_dir,
                           cache_path, cfg, progress, fault_hook, device):
    """Column top-up when a cache lacks some requested factors: compute
    ONLY the missing factors over the cached days and merge them in
    column-wise. Both runs grid the same day files, so the (code, date)
    row sets must match exactly; if they don't (a day file changed on
    disk, or a top-up day failed), fall back to the full-recompute path
    for correctness. Returns the merged cache, or None for the fallback.
    """
    max_d = cached.max_date
    overlap = [(d, p) for d, p in all_files
               if max_d is not None and d <= max_d]
    if not overlap:
        logger.warning(
            "cache %s lacks factors %s and no day files at or before its "
            "max date remain in %s; recomputing all days", cache_path,
            missing, minute_dir)
        return None
    logger.info("cache %s lacks factors %s; topping up %d cached days",
                cache_path, missing, len(overlap))
    topup = compute_exposures(
        minute_dir=minute_dir, names=missing, cache_path=None, cfg=cfg,
        progress=progress, fault_hook=fault_hook, device=device,
        _files_override=overlap)
    key_c = np.char.add(np.char.add(cached.columns["date"].astype(str),
                                    "|"),
                        cached.columns["code"].astype(str))
    key_t = np.char.add(np.char.add(topup.columns["date"].astype(str),
                                    "|"),
                        topup.columns["code"].astype(str))
    if key_c.shape != key_t.shape or not (key_c == key_t).all():
        logger.warning(
            "top-up rows differ from cache %s (day files changed or a "
            "top-up day failed); recomputing all days", cache_path)
        return None
    for n in missing:
        cached.columns[n] = topup.columns[n]
    return cached


def _read_ledger(ledger_path: str) -> List[dict]:
    """The prior failure ledger's records; malformed content is ignored
    with a warning, never fatal."""
    if not os.path.exists(ledger_path):
        return []
    try:
        with open(ledger_path) as fh:
            raw = json.load(fh)
    except (OSError, ValueError) as e:
        logger.warning("unreadable failure ledger %s: %s", ledger_path, e)
        return []
    if not isinstance(raw, list):
        logger.warning("failure ledger %s is not a list; ignoring it",
                       ledger_path)
        return []
    records = [r for r in raw if isinstance(r, dict)]
    if len(records) != len(raw):
        logger.warning("failure ledger %s has %d malformed entries "
                       "(ignored)", ledger_path, len(raw) - len(records))
    return records


def compute_exposures(
    minute_dir: Optional[str] = None,
    names: Optional[Sequence[str]] = None,
    cache_path: Optional[str] = None,
    cfg: Optional[Config] = None,
    progress: bool = True,
    fault_hook: Optional[Callable[[np.datetime64], None]] = None,
    retry_failed: bool = False,
    telemetry: Optional[Telemetry] = None,
    device=None,
    _files_override: Optional[Sequence] = None,
) -> ExposureTable:
    """Compute factor exposures for every day file, incrementally.

    * runs on the card unless ``device='cpu'``; without a card it raises;
    * the multi-factor cache at ``cache_path`` only ever GROWS factors:
      requesting factors it lacks tops up just those columns over the
      cached days (full recompute only if the day files no longer align),
      and requesting a subset computes the union for new days rather
      than pruning the cache on save. The returned table carries the
      union; select the columns you asked for;
    * resumes past ``cache_path``'s max cached date. A day that FAILED
      mid-run while later days completed lies BEFORE the advanced max
      date, so a plain re-run never retries it; it lands in the failure
      ledger (``<cache_path>.failures.json``), and ``retry_failed=True``
      re-lists precisely those days and recomputes them alongside any
      new days;
    * a failing day is logged into the returned table's ``.failures``
      report and skipped;
    * ``fault_hook(date)`` is the fault-injection test hook, called for
      every day the run reads;
    * ``telemetry`` injects a :class:`..telemetry.Telemetry` for this
      run's metrics (default: the process-wide instance);
    * the returned table carries ``.timings`` (per-stage seconds:
      ``io``, ``grid``, ``wire_encode``, ``pack``, ``launch``,
      ``device``, and ``save`` when a cache is written) and ``.reconciliation`` (stage sum vs wall with the
      ``unattributed_s`` residual explicit — telemetry.attribution);
      with ``cfg.profile_dir`` set the whole run sits inside a crash-safe
      ``torch.profiler`` capture (``telemetry.attribution.TraceCapture``)
      whose Chrome trace lands in that directory;
    * ``cfg.backend`` picks the path: ``'torch'`` the device pipeline,
      ``'numpy'`` the f64 oracle (:mod:`.oracle`) over each day on the
      host (no card needed), ``'polars'`` raises NotImplementedError;
    * ``cfg.mesh_shape = (1, n)`` shards the device pipeline's tickers
      axis over ``n`` ranks (:func:`_run_device_pipeline` with a mesh,
      the same retry and isolation); a days axis of
      more than 1 is a ValueError. Without a process group the ranks are
      spawned here (``parallel.launch``; ``telemetry`` and ``fault_hook``
      then stay with this process and must be None) and rank 0's table
      is returned; inside a group of ``n`` ranks (``torchrun``) every
      rank calls this, rank 0 reads, writes the cache and returns the
      table, the others return None. The cache equals the
      single-device run's.
    """
    cfg = cfg or get_config()
    kw = dict(minute_dir=minute_dir, names=names, cache_path=cache_path,
              cfg=cfg, progress=progress, fault_hook=fault_hook,
              retry_failed=retry_failed, telemetry=telemetry,
              device=device, _files_override=_files_override)
    if cfg.mesh_shape is None:
        return _compute_exposures(**kw)
    return _compute_exposures_mesh(**kw)


#: the mesh of the mesh run this thread is rank 0 of (a cache top-up
#: inside it runs on the same ranks)
_MESH_RUN = threading.local()

MESH_DAYS_REFUSAL = (
    "mesh_shape {shape}: the streaming pipeline shards the tickers axis "
    "only (batch day counts vary, the last batch would not divide a days "
    "axis) — use mesh_shape=(1, n); the days axis is for "
    "parallel.sharded_compute_factors on fixed batches, and the resident "
    "loops shard via compute_packed_resident_sharded / "
    "compute_packed_resident_2d + parallel.resident_mesh")


def _compute_exposures_mesh(**kw) -> Optional[ExposureTable]:
    """:func:`compute_exposures` with ``cfg.mesh_shape`` set."""
    import torch.distributed as dist

    from .parallel import transport
    from .parallel.mesh import make_mesh

    cfg = kw["cfg"]
    shape = tuple(int(v) for v in cfg.mesh_shape)
    if len(shape) != 2 or shape[0] != 1 or shape[1] < 1:
        raise ValueError(MESH_DAYS_REFUSAL.format(shape=shape))
    if cfg.backend != "torch":
        raise ValueError(f"mesh_shape {shape} shards the device pipeline; "
                         f"backend {cfg.backend!r} runs on the host")
    n = shape[1]
    inner = getattr(_MESH_RUN, "mesh", None)
    if inner is not None:
        return _compute_exposures(**kw, mesh=inner)
    if n == 1:
        return _compute_exposures(**kw)
    if not dist.is_initialized():
        if kw["telemetry"] is not None or kw["fault_hook"] is not None:
            raise ValueError(
                "compute_exposures(mesh_shape=...) spawns its ranks: "
                "telemetry and fault_hook stay in this process, pass None "
                "(or start the ranks with torchrun)")
        from .parallel.launch import run_ranks
        dev = resolve_device(kw["device"])
        args = {k: v for k, v in kw.items()
                if k not in ("telemetry", "fault_hook", "device")}
        args["progress"] = False
        return run_ranks(_exposures_rank, n, args=(args, dev.type),
                         device=dev.type)[0]
    if dist.get_world_size() != n:
        raise ValueError(f"mesh_shape {shape} needs {n} ranks; the process "
                         f"group has {dist.get_world_size()}")
    mesh = make_mesh(shape, kw["device"])
    if dist.get_rank() != 0:
        _mesh_worker(mesh)
        return None
    _MESH_RUN.mesh = mesh
    try:
        return _compute_exposures(**kw, mesh=mesh)
    finally:
        _MESH_RUN.mesh = None
        transport.broadcast_object(("exit",))


def _exposures_rank(rank: int, kw: dict, device_type: str):
    """One spawned rank of :func:`compute_exposures`' mesh run."""
    return compute_exposures(**kw, device=device_type)


def _compute_exposures(
    minute_dir: Optional[str] = None,
    names: Optional[Sequence[str]] = None,
    cache_path: Optional[str] = None,
    cfg: Optional[Config] = None,
    progress: bool = True,
    fault_hook: Optional[Callable[[np.datetime64], None]] = None,
    retry_failed: bool = False,
    telemetry: Optional[Telemetry] = None,
    device=None,
    _files_override: Optional[Sequence] = None,
    mesh=None,
) -> ExposureTable:
    """:func:`compute_exposures` on this process; ``mesh`` (global rank
    0 of a mesh run) shards the device pipeline over its ranks."""
    cfg = cfg or get_config()
    if cfg.backend not in BACKENDS:
        # a typo'd backend must not silently run the device pipeline — a
        # numpy-vs-device differential would then vacuously pass
        raise ValueError(f"backend must be one of {BACKENDS}, got "
                         f"{cfg.backend!r}")
    if cfg.backend == "polars":
        raise NotImplementedError(POLARS_REFUSAL)
    if cfg.backend != "torch" and not cfg.replicate_quirks:
        # the oracle can only produce the quirked values; caching them as
        # 'fixed' would poison a later fixed-quirks comparison
        raise ValueError(
            "replicate_quirks=False (--fixed-quirks) exists only on the "
            "torch backend; the numpy backend reproduces the reference's "
            "quirked semantics by construction")
    # the oracle runs on the host: only the device path needs the card
    dev = (mesh.device if mesh is not None else resolve_device(device)
           ) if cfg.backend == "torch" else None
    minute_dir = minute_dir or cfg.minute_dir
    names = tuple(names) if names is not None else factor_names()

    all_files = (list(_files_override) if _files_override is not None
                 else dio.list_day_files(minute_dir))

    cached = None
    if cache_path is not None and os.path.exists(cache_path):
        cached = ExposureTable.load(cache_path)
        missing = [n for n in names if n not in cached.factor_names]
        if missing:
            cached = _topup_missing_factors(
                cached, missing, all_files, minute_dir, cache_path,
                cfg, progress, fault_hook, dev)
        if cached is not None:
            # The persisted cache's factor set only GROWS: a subset
            # request must never prune and overwrite a wider cache. New
            # days therefore compute the UNION — near-free, since one
            # batch evaluates every factor in one pass anyway.
            extra = [n for n in cached.factor_names if n not in names]
            if extra:
                names = tuple(names) + tuple(extra)

    files = all_files
    if cached is not None and cached.max_date is not None:
        files = [(d, p) for d, p in files if d > cached.max_date]
    prior_ledger: List[dict] = []
    if cache_path is not None:
        prior_ledger = _read_ledger(cache_path + ".failures.json")
    if retry_failed and cache_path is not None:
        # Re-list the ledger's failed days (they sit at or before the
        # cached max date, which the resume filter above skips forever).
        retry_keys = {rec.get("key") for rec in prior_ledger}
        retry_keys.discard(None)
        if retry_keys:
            have = {str(d) for d, _ in files}
            extra = [(d, p) for d, p in all_files
                     if str(d) in retry_keys and str(d) not in have]
            gone = retry_keys - {str(d) for d, _ in all_files}
            if gone:
                logger.warning("ledger days %s no longer exist in %s",
                               sorted(gone), minute_dir)
            if extra:
                logger.info("retrying %d ledger days: %s", len(extra),
                            [str(d) for d, _ in extra])
                files = sorted(files + extra)
                # any good cached rows a stale ledger day may hold are
                # dropped at MERGE time, only if the day actually
                # produced fresh rows — dropping up front would regress
                # the cache if the retry fails or the run aborts first

    failures = FailureReport()
    tel = telemetry if telemetry is not None else get_telemetry()
    # a StageTimer keeps Timer's per-run totals (``.timings``) AND feeds
    # every stage into the telemetry histograms and the profiler; the
    # rolling_impl label says which rolling backend a run's time is for
    timer = tel.stage_timer(rolling_impl=cfg.rolling_impl)
    parts: List[ExposureTable] = []
    # crash-safe capture window: the profiler stops and exports its trace
    # on EVERY exit, per-day failure isolation and aborts included
    trace = _attribution.TraceCapture(cfg.profile_dir if files else None,
                                      telemetry=tel, timer=timer)
    iterator: Sequence = files
    if progress and files:
        try:
            from tqdm import tqdm
            iterator = tqdm(files, desc="day files", unit="day")
        except ImportError:
            pass

    t0 = time.perf_counter()
    # the device pipeline keeps integer codes integer through the grid
    # (normalized once at the batch axis, _grid_batch); the oracle joins
    # on code STRINGS and needs the normalizing reader
    reader = (dio.read_minute_day_raw if cfg.backend == "torch"
              else dio.read_minute_day)

    def read_batches():
        """Yield lists of (date, day-columns), one list per device batch,
        with per-day failure isolation."""
        batch: List[Tuple[np.datetime64, Dict[str, np.ndarray]]] = []
        for date, path in iterator:
            try:
                if fault_hook is not None:
                    fault_hook(date)
                with timer("io"):
                    day = reader(path)
                if len(day["code"]) == 0:
                    raise ValueError("empty day file")
                batch.append((date, day))
            except Exception as e:  # noqa: BLE001 — per-day isolation
                failures.record(str(date), path, e)
                logger.warning("skipping day %s (%s): %s", date, path, e)
                continue
            if len(batch) >= cfg.days_per_batch:
                yield batch
                batch = []
        if batch:
            yield batch

    def dispatch_backend():
        if cfg.backend == "numpy":
            _run_oracle(read_batches(), names, parts)
        else:
            _run_device_pipeline(read_batches(), names, cfg, timer, parts,
                                 failures=failures,
                                 path_of={str(d): p for d, p in files},
                                 telemetry=tel, device=dev, mesh=mesh)

    try:
        with trace:  # the trace is exported on every exit path
            dispatch_backend()
    except Exception as e:  # noqa: BLE001 — crash-consistent save below
        # preserve every completed batch before re-raising: parts hold
        # whole days only, so the cache written below is resume-safe and
        # the next run continues past it
        fatal = e
        logger.error("pipeline aborted (%s); saving %d completed parts "
                     "before re-raising", e, len(parts))
    else:
        fatal = None

    new = (ExposureTable.concat(parts).sort() if parts
           else ExposureTable.empty(names))
    if cached is not None and len(cached):
        keep = ["code", "date", *names]
        cached.columns = {k: cached.columns[k] for k in keep}
        if len(new):
            # fresh rows win over cached rows for the same day (only
            # reachable when a stale ledger listed a day the cache also
            # holds and retry_failed recomputed it); whole-day grain,
            # so a date-level drop is exact
            new_dates = np.unique(new.columns["date"])
            keep_rows = ~np.isin(cached.columns["date"], new_dates)
            if not keep_rows.all():
                cached.columns = {k: v[keep_rows]
                                  for k, v in cached.columns.items()}
        result = ExposureTable.concat([cached, new]).sort()
    else:
        result = new
    result.failures = failures
    if cache_path is not None and len(result):
        # a stage of its own, inside the reconciled wall: the per-row code
        # rendering and the parquet write are part of what a caller waits
        with timer("save"):
            result.save(cache_path)
    elapsed = time.perf_counter() - t0
    if files:
        logger.info("computed %d factors x %d new days in %.2fs "
                    "(%d rows, %d failed days) [%s]", len(names), len(files),
                    elapsed, len(new), len(failures), timer.report())
    result.timings = timer.totals()
    # wall-clock reconciliation: sum of the timed stages vs the measured
    # wall, unattributed residual explicit. Past-tolerance unattributed
    # time is a measurement gap — flagged and logged, never fatal;
    # overlap from the pipelined threads is reported separately.
    result.reconciliation = _attribution.reconcile(
        elapsed, result.timings, tolerance=cfg.attribution_tolerance)
    if files:
        tel.event("reconciliation", **result.reconciliation)
        if not result.reconciliation["ok"]:
            logger.warning(
                "wall-clock reconciliation FAILED: %.2fs of %.2fs (%.0f%%)"
                " unattributed — the stage taxonomy is missing a term "
                "(stages: %s)",
                result.reconciliation["unattributed_s"], elapsed,
                100 * result.reconciliation["unattributed_frac"],
                timer.report())
    if cache_path is not None:
        # Ledger persistence rule: a prior entry drops off only when the
        # day is RESOLVED this run — it produced fresh rows (recovered)
        # or re-entered ``failures`` (failed again, fresh error). Days a
        # run merely listed but never reached (breaker abort, crash)
        # keep their entries; erasing them would strand the day forever,
        # since the resume filter skips everything at or before the
        # cached max date.
        resolved = (set(map(str, new.columns["date"]))
                    | set(failures.keys()))
        carried = [rec for rec in prior_ledger
                   if rec.get("key") not in resolved]
        ledger = cache_path + ".failures.json"
        if failures or carried:
            failures.save(ledger, carried=carried)
        elif os.path.exists(ledger):  # nothing lost anywhere: drop it
            os.remove(ledger)
    if fatal is not None:
        raise fatal
    return result


def compute_exposures_streamed(bars, mask, names=None, micro_batch=16,
                               replicate_quirks=True, rolling_impl=None,
                               engine=None, session=None, device=None):
    """One day of minute bars folded through the streaming engine: host
    ``bars [T, S, 5]`` / ``mask [T, S]`` in, ``{name: np [T]}`` out, with
    one fetch. ``micro_batch`` minutes advance per ingest call; an
    injected ``engine`` (reset first) reuses its warm callables and must
    match the universe. At the last minute the result is bitwise
    :func:`compute_batch` on the same day. ``device`` defaults to
    ``cuda`` and raises when no card is present."""
    from .stream.engine import StreamEngine

    t_total = mask.shape[-1]
    if engine is None:
        engine = StreamEngine(mask.shape[0], names=names,
                              replicate_quirks=replicate_quirks,
                              rolling_impl=rolling_impl, session=session,
                              device=device)
    else:
        engine.reset()
    s = 0
    while s < t_total:
        e = min(s + micro_batch, t_total)
        engine.ingest_minutes(
            np.ascontiguousarray(np.swapaxes(bars[:, s:e], 0, 1)),
            np.ascontiguousarray(mask[:, s:e].T))
        s = e
    exposures, _ready = engine.snapshot()
    host = exposures.cpu().numpy()  # the one fetch
    return {n: host[j] for j, n in enumerate(engine.names)}
