"""Blocked-quantized RESULT wire: the device->host leg of an exposure
block.

The port of the JAX package's ``data/result_wire.py``. A ``[F, D, T]``
block is quantized on the device, per (factor, day) slice, to an affine
int16 map; a slice whose round trip misses its factor's pinned bound
(``RESULT_BOUNDS``), or that holds +/-inf or a non-finite scale, widens
to bitwise f32 rows in a spill plane. The payload is ONE uint8 buffer in
``wire.pack_arrays``' layout (4-byte aligned chunks):

  q       [F, D, T] int16  quantized lanes; NaN lanes ship ``Q_NAN``
  scale   [F, D]    f32    per-slice step ((hi - lo) / 65534; 1.0 for
                           degenerate hi == lo slices)
  offset  [F, D]    f32    per-slice lo
  sidx    [F, D]    int16  -1 quantized; >= 0 spill row; -2 widened
                           past the spill budget (OVERFLOW)
  spill   [S, T]    f32    raw rows of widened slices, in flat (f, d)
                           order of widening

The device half (:func:`encode_block`) is torch; the host half
(:func:`decode_block`, :func:`check_bounds`, the MFW1 frames) is numpy,
copied from the JAX package, and takes already-fetched buffers.

Two forms follow what the JAX package's compiled graph runs, so the
payload is byte-identical to its ``jax.jit(encode_block)``: the step is
``rng * f32(1/65534)`` (XLA turns the division by the constant into that
product), and the round trip ``(q + Q_LIM) * scale + offset`` is
separate eager ops, so no product fuses into an FMA that would move a
widen decision.
"""

from __future__ import annotations

import dataclasses
import struct
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from ..utils.upload import to_device

#: int16 NaN sentinel (decodes to NaN; never produced by quantization)
Q_NAN = -32768
#: quantized lanes land in [-Q_LIM, Q_LIM]
Q_LIM = 32767
#: number of representable quantization steps
Q_STEPS = 2 * Q_LIM  # 65534

#: sidx markers
SIDX_QUANTIZED = -1
SIDX_OVERFLOW = -2

#: default pinned bound: range-relative absolute error. The int16
#: quantization guarantees (hi - lo) / 131068 ~= 7.63e-6 x range, so 1e-5
#: holds with ~1.3x margin; a slice that cannot meet it widens.
DEFAULT_ATOL_REL = 1e-5
DEFAULT_RTOL = 0.0

#: per-factor pinned bounds ``(rtol, atol_rel, force_widen)``: the STRICT
#: class pins the volume/amount-scaled factors purely value-relative, so
#: a heavy-tailed slice widens instead of shipping range-relative noise
_STRICT = (2e-3, 0.0, False)
RESULT_BOUNDS: Dict[str, Tuple[float, float, bool]] = {
    "vol_volume1min": _STRICT,
    "vol_upVol": _STRICT,
    "vol_downVol": _STRICT,
    "liq_amihud_1min": _STRICT,
    "liq_openvol": _STRICT,
    "liq_closevol": _STRICT,
    "liq_closeprevol": _STRICT,
    "shape_skewVol": _STRICT,
    "shape_kurtVol": _STRICT,
}


def factor_bounds(name: str) -> Tuple[float, float, bool]:
    """Pinned ``(rtol, atol_rel, force_widen)`` for one factor."""
    return RESULT_BOUNDS.get(name, (DEFAULT_RTOL, DEFAULT_ATOL_REL,
                                    False))


class ResultWireOverflow(RuntimeError):
    """More slices widened than the spill budget holds; the payload marks
    them (``sidx == -2``). Grow the widen-only floor
    (:meth:`ResultWireSpec.grow`) and encode again."""


@dataclasses.dataclass(frozen=True)
class ResultWireSpec:
    """Encode spec: ``bounds[f]`` is factor f's pinned ``(rtol, atol_rel,
    force_widen)``, ``spill_rows`` the widen budget S. Hashable, so it
    keys the stream engine's callable cache as it keys the JAX package's
    executables."""
    bounds: Tuple[Tuple[float, float, bool], ...]
    spill_rows: int

    @classmethod
    def for_names(cls, names: Sequence[str],
                  spill_rows: Optional[int] = None,
                  days: int = 8) -> "ResultWireSpec":
        names = tuple(names)
        if spill_rows is None:
            spill_rows = default_spill_rows(len(names), days)
        return cls(bounds=tuple(factor_bounds(n) for n in names),
                   spill_rows=int(spill_rows))

    def grow(self, needed: int, headroom: float = 1.25
             ) -> "ResultWireSpec":
        """Widen-only floor bump: never shrinks."""
        rows = max(self.spill_rows, int(np.ceil(needed * headroom)))
        return dataclasses.replace(self, spill_rows=rows)


def default_spill_rows(n_factors: int, days: int) -> int:
    """Default spill budget: ~2% of the block's slices, floored at 4."""
    return max(4, int(np.ceil(0.02 * n_factors * max(1, days))))


# --------------------------------------------------------------------------
# payload spec (host): mirrors wire.pack_arrays' layout math
# --------------------------------------------------------------------------


def payload_arrays_shapes(n_factors: int, days: int, tickers: int,
                          spill_rows: int):
    """``(dtype, shape)`` of the payload arrays, in pack order."""
    return (
        (np.dtype(np.int16), (n_factors, days, tickers)),    # q
        (np.dtype(np.float32), (n_factors, days)),           # scale
        (np.dtype(np.float32), (n_factors, days)),           # offset
        (np.dtype(np.int16), (n_factors, days)),             # sidx
        (np.dtype(np.float32), (spill_rows, tickers)),       # spill
    )


def payload_spec(n_factors: int, days: int, tickers: int,
                 spill_rows: int) -> tuple:
    """The ``((dtype_str, shape, byte_offset), ...)`` spec
    ``wire.pack_arrays`` makes of the payload arrays (4-byte aligned
    chunks)."""
    spec, off = [], 0
    for dt, shape in payload_arrays_shapes(n_factors, days, tickers,
                                           spill_rows):
        spec.append((dt.str, shape, off))
        nbytes = int(np.prod(shape, dtype=np.int64)) * dt.itemsize
        off += nbytes + ((-(off + nbytes)) % 4)
    return tuple(spec)


def payload_nbytes(n_factors: int, days: int, tickers: int,
                   spill_rows: int) -> int:
    """Total packed payload length in bytes (the device buffer's L)."""
    last_dt, last_shape, last_off = payload_spec(
        n_factors, days, tickers, spill_rows)[-1]
    nbytes = (int(np.prod(last_shape, dtype=np.int64))
              * np.dtype(last_dt).itemsize)
    end = last_off + nbytes
    return end + ((-end) % 4)


# --------------------------------------------------------------------------
# device encode (torch, on the block's device)
# --------------------------------------------------------------------------


def _pack_device(arrays) -> torch.Tensor:
    """Reinterpret each array's bytes and concatenate them into one flat
    uint8 tensor with ``wire.pack_arrays``' 4-byte alignment."""
    chunks = []
    off = 0
    for a in arrays:
        b = a.contiguous().reshape(-1).view(torch.uint8)
        nbytes = b.shape[0]
        pad = (-(off + nbytes)) % 4
        chunks.append(b)
        if pad:
            chunks.append(torch.zeros(pad, dtype=torch.uint8,
                                      device=b.device))
        off += nbytes + pad
    return torch.cat(chunks)


def encode_block(x: torch.Tensor, spec: ResultWireSpec) -> torch.Tensor:
    """Quantize one ``[F, D, T]`` f32 exposure block on its device into
    the packed ``[L] uint8`` payload (module docstring): per slice,
    masked min/max -> affine int16 with the NaN sentinel -> round-trip
    check against the factor's bound -> widen to the spill plane on a
    miss."""
    f, d, t = x.shape
    if len(spec.bounds) != f:
        raise ValueError(f"spec pins {len(spec.bounds)} factors; block "
                         f"has {f}")
    dev = x.device
    finite = torch.isfinite(x)
    has_finite = finite.any(dim=-1)                           # [F, D]
    big = float(np.finfo(np.float32).max)
    lo = torch.where(finite, x, big).amin(dim=-1)
    hi = torch.where(finite, x, -big).amax(dim=-1)
    lo = torch.where(has_finite, lo, 0.0)
    hi = torch.where(has_finite, hi, 0.0)
    rng = hi - lo
    degenerate = rng <= 0.0
    inv_steps = torch.full((), float(np.float32(1.0) / np.float32(Q_STEPS)),
                           dtype=torch.float32, device=dev)
    scale = torch.where(degenerate, 1.0, rng * inv_steps)
    offset = lo
    qf = torch.round((x - offset[..., None]) / scale[..., None])
    q = torch.clamp(qf - float(Q_LIM), -float(Q_LIM), float(Q_LIM))
    q = torch.where(finite, q, float(Q_NAN)).to(torch.int16)
    # round-trip check, the host dequantize's expression, op by op
    xr = q.to(torch.float32) + float(Q_LIM)
    xr = xr * scale[..., None]
    xr = xr + offset[..., None]
    err = (xr - x).abs()
    # the bounds go up without a host wait (utils/upload.py)
    rtol = to_device([b[0] for b in spec.bounds], dev,
                     torch.float32)[:, None, None]
    atol_rel = to_device([b[1] for b in spec.bounds], dev,
                         torch.float32)[:, None, None]
    force = to_device([b[2] for b in spec.bounds], dev,
                      torch.bool)[:, None]
    bound = atol_rel * rng[..., None]
    bound = bound + rtol * x.abs()
    lane_bad = finite & ~(err <= bound)
    widen = (lane_bad.any(dim=-1)
             | torch.isinf(x).any(dim=-1)
             | ~torch.isfinite(scale)
             | force)                                         # [F, D]
    wflat = widen.reshape(-1)
    # int32 like the JAX package's cumsum (torch's would be int64)
    row = torch.cumsum(wflat.to(torch.int32), 0, dtype=torch.int32) - 1
    fits = wflat & (row < spec.spill_rows)
    sidx = torch.where(
        wflat, torch.where(fits, row, SIDX_OVERFLOW),
        SIDX_QUANTIZED).reshape(f, d).to(torch.int16)
    # scatter the widened slices' raw rows; rows past the budget (and the
    # quantized ones) go to a discard row, where JAX's mode="drop" drops
    target = torch.where(fits, row, spec.spill_rows).to(torch.int64)
    spill = torch.zeros((spec.spill_rows + 1, t), dtype=torch.float32,
                        device=dev)
    spill[target] = x.reshape(-1, t)
    return _pack_device((q, scale, offset, sidx, spill[:spec.spill_rows]))


def encode_stacked(x: torch.Tensor, spec: ResultWireSpec) -> torch.Tensor:
    """``[N, F, D, T]`` -> ``[N, L]`` uint8: one :func:`encode_block` for
    each leading slice (the JAX package's ``vmap`` of it)."""
    if x.dim() != 4:
        raise ValueError(f"encode_stacked takes [N, F, D, T], not "
                         f"{tuple(x.shape)}")
    return torch.stack([encode_block(b, spec) for b in x])


# --------------------------------------------------------------------------
# host decode (numpy; input is an already-fetched host buffer)
# --------------------------------------------------------------------------


def _unpack_host(buf: np.ndarray, spec: tuple):
    out = []
    flat = buf.reshape(-1).view(np.uint8)
    for dtype_str, shape, off in spec:
        dt = np.dtype(dtype_str)
        n = int(np.prod(shape, dtype=np.int64))
        out.append(flat[off:off + n * dt.itemsize].view(dt)
                   .reshape(shape))
    return out


def decode_block(buf: np.ndarray, n_factors: int, days: int,
                 tickers: int, spill_rows: int, strict: bool = True,
                 telemetry=None, names: Optional[Sequence[str]] = None):
    """Dequantize one fetched payload back to ``([F, D, T] f32,
    verdict)``: widened slices bitwise, quantized slices within the
    pinned bound, NaN lanes NaN. ``verdict`` reports ``{quantized,
    widened, overflow, payload_bytes, f32_bytes, ratio, sidx}`` (and
    ``widened_by_factor`` with ``names``); ``strict`` raises
    :class:`ResultWireOverflow` when a slice overflowed the spill budget.
    Counters: ``result.decode_blocks``, ``result.bytes``,
    ``result.widened_slices``, ``result.widen_count{factor=}``,
    ``result.overflow_slices``; gauge ``result.spill_occupancy_frac``."""
    spec = payload_spec(n_factors, days, tickers, spill_rows)
    q, scale, offset, sidx, spill = _unpack_host(buf, spec)
    out = ((q.astype(np.float32) + np.float32(Q_LIM))
           * scale[..., None] + offset[..., None])
    out[q == Q_NAN] = np.nan
    widened = sidx >= 0
    if widened.any():
        out[widened] = spill[sidx[widened].astype(np.int64)]
    n_overflow = int((sidx == SIDX_OVERFLOW).sum())
    payload_bytes = int(buf.nbytes)
    f32_bytes = n_factors * days * tickers * 4
    verdict = {
        "quantized": int((sidx == SIDX_QUANTIZED).sum()),
        "widened": int(widened.sum()),
        "overflow": n_overflow,
        "payload_bytes": payload_bytes,
        "f32_bytes": f32_bytes,
        "ratio": round(f32_bytes / payload_bytes, 3)
        if payload_bytes else None,
        # the per-slice disposition plane, for parity gates (check_bounds)
        "sidx": sidx,
    }
    tel = telemetry
    if tel is None:
        from ..telemetry import get_telemetry
        tel = get_telemetry()
    tel.counter("result.decode_blocks")
    tel.counter("result.bytes", payload_bytes)
    tel.counter("result.widened_slices", verdict["widened"])
    if names is not None:
        if len(names) != n_factors:
            raise ValueError(f"names has {len(names)} entries; payload "
                             f"holds {n_factors} factors")
        per_factor = ((sidx != SIDX_QUANTIZED).sum(axis=1)
                      .astype(np.int64))
        by_factor = {}
        for n, c in zip(names, per_factor):
            if c:
                tel.counter("result.widen_count", int(c),
                            factor=str(n))
                by_factor[str(n)] = int(c)
        verdict["widened_by_factor"] = by_factor
        if spill_rows > 0:
            tel.gauge("result.spill_occupancy_frac",
                      round(verdict["widened"] / spill_rows, 6))
    if n_overflow:
        tel.counter("result.overflow_slices", n_overflow)
    if strict and n_overflow:
        raise ResultWireOverflow(
            f"{n_overflow} widened slice(s) did not fit the {spill_rows}"
            f"-row spill budget; grow the widen-only floor "
            f"(ResultWireSpec.grow) and re-encode")
    return out, verdict


def check_bounds(raw: np.ndarray, decoded: np.ndarray,
                 names: Sequence[str], sidx: Optional[np.ndarray] = None
                 ) -> dict:
    """Parity gate: ``decoded`` against the raw f32 block under the pinned
    per-factor contract — bitwise where widened, within ``atol_rel *
    range + rtol * |x|`` where quantized, NaN status everywhere. Returns
    ``{ok, bad_factors, max_rel_err}``."""
    bad, max_rel = [], 0.0
    for i, n in enumerate(names):
        a, b = raw[i], decoded[i]
        if not np.array_equal(np.isnan(a), np.isnan(b)):
            bad.append(n)
            continue
        finite = np.isfinite(a)
        if not np.array_equal(finite, np.isfinite(b)):
            bad.append(n)
            continue
        rtol, atol_rel, _ = factor_bounds(n)
        for d in range(a.shape[0]):
            af, bf = a[d], b[d]
            fin = np.isfinite(af)
            if sidx is not None and sidx[i, d] >= 0:
                if not np.array_equal(af[fin], bf[fin]):
                    bad.append(n)
                continue
            if not fin.any():
                continue
            lo, hi = af[fin].min(), af[fin].max()
            bound = atol_rel * (hi - lo) + rtol * np.abs(af[fin])
            err = np.abs(bf[fin] - af[fin])
            if not (err <= np.maximum(bound, 0.0)).all():
                bad.append(n)
            scale_ref = max(abs(lo), abs(hi), 1e-30)
            max_rel = max(max_rel, float(err.max(initial=0.0))
                          / scale_ref)
    return {"ok": not bad, "bad_factors": sorted(set(bad)),
            "max_rel_err": max_rel}


# --------------------------------------------------------------------------
# wire framing: the HTTP leg of the result wire
# --------------------------------------------------------------------------

#: frame magic: "Minute Factor Wire", layout version 1
FRAME_MAGIC = b"MFW1"
FRAME_VERSION = 1

#: fixed-size frame header: magic, version, flags (reserved 0), n_factors,
#: days, tickers, spill_rows, start, end (signed: a rangeless intraday
#: frame carries -1), payload_len
_FRAME_HEADER = struct.Struct("<4sHHIIIIiiI")
FRAME_HEADER_BYTES = _FRAME_HEADER.size


def pack_frame(payload, *, n_factors: int, days: int, tickers: int,
               spill_rows: int, start: int = 0, end: int = 0) -> bytes:
    """One self-describing frame: header + the fetched payload verbatim."""
    body = payload.tobytes() if hasattr(payload, "tobytes") \
        else bytes(payload)
    expect = payload_nbytes(n_factors, days, tickers, spill_rows)
    if len(body) != expect:
        raise ValueError(
            f"payload is {len(body)} bytes; the "
            f"[{n_factors}, {days}, {tickers}] + {spill_rows}-row "
            f"spill geometry packs to {expect}")
    head = _FRAME_HEADER.pack(FRAME_MAGIC, FRAME_VERSION, 0,
                              n_factors, days, tickers, spill_rows,
                              start, end, len(body))
    return head + body


def unpack_frame(buf, offset: int = 0) -> Tuple[dict, np.ndarray, int]:
    """Parse ONE frame at ``offset`` -> ``(meta, payload, next_offset)``;
    ``ValueError`` on a bad magic, an unknown version, a header whose
    length disagrees with its geometry, or a truncated buffer."""
    view = memoryview(buf)
    if len(view) - offset < FRAME_HEADER_BYTES:
        raise ValueError(
            f"truncated result-wire frame: {len(view) - offset} bytes "
            f"at offset {offset}; the header alone is "
            f"{FRAME_HEADER_BYTES}")
    (magic, version, _flags, n_factors, days, tickers, spill_rows,
     start, end, payload_len) = _FRAME_HEADER.unpack_from(view, offset)
    if magic != FRAME_MAGIC:
        raise ValueError(f"bad result-wire frame magic {bytes(magic)!r}"
                         f" (want {FRAME_MAGIC!r})")
    if version != FRAME_VERSION:
        raise ValueError(f"unknown result-wire frame version {version}")
    expect = payload_nbytes(n_factors, days, tickers, spill_rows)
    if payload_len != expect:
        raise ValueError(
            f"frame header claims {payload_len} payload bytes; the "
            f"[{n_factors}, {days}, {tickers}] + {spill_rows}-row "
            f"geometry packs to {expect}")
    body_off = offset + FRAME_HEADER_BYTES
    if len(view) - body_off < payload_len:
        raise ValueError(
            f"truncated result-wire frame: payload wants {payload_len} "
            f"bytes, buffer holds {len(view) - body_off}")
    payload = np.frombuffer(view, np.uint8, count=payload_len,
                            offset=body_off)
    meta = {"version": version, "n_factors": n_factors, "days": days,
            "tickers": tickers, "spill_rows": spill_rows,
            "start": start, "end": end, "payload_bytes": payload_len}
    return meta, payload, body_off + payload_len


def iter_frames(buf):
    """Yield every ``(meta, payload)`` frame in ``buf`` in order; trailing
    garbage raises like :func:`unpack_frame`."""
    offset, n = 0, len(memoryview(buf))
    while offset < n:
        meta, payload, offset = unpack_frame(buf, offset)
        yield meta, payload
