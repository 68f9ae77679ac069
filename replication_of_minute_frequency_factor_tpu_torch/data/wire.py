"""Compact host->device wire format for day batches.

A-share prices are tick-aligned (0.01 CNY) and volumes trade in board
lots, so a batch ships as:

  base     [D, T]         f32    first valid close (ticks*0.01)
  dclose   [D, T, 120]    uint8  close tick-delta vs previous valid close,
                                 two int4 deltas per byte (|d| <= 7);
                                 widens to [..., 240] int8, then int16
  dohl     [D, T, 240, 1] uint8  tight packing: int4 open-close delta |
                                 high-wick 2 bits << 4 | low-wick 2 bits
                                 << 6, wicks measured from the bar body;
                                 widens to the [..., 2] wick packing
                                 (int8 delta + nibble wicks), then
                                 [..., 3] int8, then int16 per-field
  volume   [D, T, 300]    uint8  four 10-bit volumes per 5 bytes
                                 (little-endian bit stream), in shares
                                 or 100-share lots (vol_scale); widens
                                 to [..., 240] uint16 shares/lots, then
                                 int32 shares
  maskbits [D, T, 30]     uint8  validity mask, bit-packed little-endian

instead of 21 bytes a bar (f32 bars + bool mask). Every narrowing is
per-batch with a widening fallback, so one expensive ticker or heavy-volume
day widens its field instead of rejecting the batch. The format is
session-generic: encode reads the slot count off the mask, decode from
``dohl``'s slot axis, and a sub-byte packing whose divisor the slot count
misses (``pack_dclose4`` needs an even count, vol10 a multiple of 4) is
simply never chosen. The port of the JAX
package's ``data/wire.py``: the host half (:func:`encode`, through the C++
single-pass encoder or numpy, and :func:`pack_arrays`) writes the JAX
package's bytes exactly, and the device half (:func:`unpack`,
:func:`decode`) is plain torch on whatever device the buffer lies on,
giving the JAX package's bars bit for bit.

Decoded prices are tick counts times the f32 reciprocal of 100, not tick
counts divided by 100: XLA strength-reduces the JAX package's constant
division to that multiply, which is not correctly rounded, and torch's
``/`` is true division (about a quarter of prices would land one ulp
away). The wobble is semantically safe — equal tick counts decode to
identical floats, so every sign/threshold comparison in the kernels is
unaffected. ``encode`` returns None whenever the data doesn't fit the
format at all (off-tick prices, >int16 deltas, non-integer or >int31
volume); callers then ship raw f32.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from .. import native
from ..native import TICKS_PER_UNIT, narrow_wire

_I16 = 32767

#: the keys of ``WireBatch.modes`` (and of a run's widen-only floor)
_MODE_KEYS = ("dclose_mode", "ohl_mode", "vol_mode")

#: numpy dtype -> torch dtype of every array the wire and the raw path ship
_TORCH_DTYPES = {np.dtype(t): d for t, d in (
    (np.uint8, torch.uint8), (np.int8, torch.int8),
    (np.int16, torch.int16), (np.uint16, torch.uint16),
    (np.int32, torch.int32), (np.float32, torch.float32))}


def mask_bytes(n_slots: int) -> int:
    """Bit-packed mask bytes per (ticker, day) for a slot count
    (np.packbits zero-pads the final byte)."""
    return -(-n_slots // 8)


def vol10_bytes(n_slots: int) -> int:
    """10-bit-packed volume bytes for a slot count (only produced when
    ``n_slots % 4 == 0``; see :func:`..native.narrow_wire`)."""
    return n_slots // 4 * 5


@dataclasses.dataclass
class WireBatch:
    base: np.ndarray      # [..., T] f32
    dclose: np.ndarray    # [..., T, 120] u8 int4-pair, or [..., 240] i8/i16
    dohl: np.ndarray      # [..., T, 240, 1] u8 tight / [..., 2] u8 wick /
                          # [..., 3] i8/i16 per-field
    volume: np.ndarray    # [..., T, 300] u8 10-bit packed, or
                          # [..., T, 240] uint16/int32
    maskbits: np.ndarray  # [..., T, 30] uint8 (little-endian bit order)
    vol_scale: float      # shares per volume unit (1 or 100)
    #: the rung of each field's ladder this batch was packed at
    #: (``native.DCLOSE_SHAPES``/``OHL_SHAPES``/``VOL_SHAPES`` indices, as
    #: ``native.narrow_wire`` or the native encoder's floor picked them)
    modes: dict

    @property
    def arrays(self):
        return (self.base, self.dclose, self.dohl, self.volume,
                self.maskbits, np.float32(self.vol_scale))

    @property
    def nbytes(self) -> int:
        return sum(np.asarray(a).nbytes for a in self.arrays)


def pack_mask(mask: np.ndarray) -> np.ndarray:
    """[..., S] bool -> [..., ceil(S/8)] uint8, little-endian bit
    order (packbits zero-pads the final byte; decode slices back)."""
    return np.packbits(np.asarray(mask, bool), axis=-1, bitorder="little")


def encode(bars: np.ndarray, mask: np.ndarray,
           floor: Optional[dict] = None,
           use_native: Optional[bool] = None) -> Optional[WireBatch]:
    """Host-side packing; None when the batch can't be represented.

    ``floor`` is the widen-only mode state a pipeline run threads through
    successive batches (see ``native.narrow_wire``): a field never packs
    narrower than an earlier batch of the run did. ``use_native`` selects
    the C++ single-pass encoder (``native.wire_encode_native``, threaded
    across tickers, the GIL released); default: native when it builds,
    numpy otherwise. The native encoder is baked to 240 slots, so other
    sessions take the numpy path, and ``use_native=True`` raises when the
    library is unavailable. Both give the same bytes and modes; the path
    taken is counted in ``native.IMPL_COUNTS[('wire', requested,
    resolved)]``.
    """
    bars = np.asarray(bars)
    mask = np.asarray(mask)
    floor = floor if floor is not None else {}
    if (use_native is None or use_native) and mask.shape[-1] == 240:
        if native.available():
            out = native.wire_encode_native(bars, mask, floor=floor)
            native.count("wire", use_native, "native")
            if out is None:  # unrepresentable; semantics match numpy
                return None
            base, dclose, dohl, volume, vol_scale = out
            return WireBatch(
                base=base, dclose=dclose, dohl=dohl, volume=volume,
                maskbits=pack_mask(mask), vol_scale=vol_scale,
                modes={k: floor.get(k, 0) for k in _MODE_KEYS})
        if use_native:
            raise RuntimeError("native wire encoder unavailable")
    native.count("wire", use_native, "numpy")
    # float64 throughout: under NEP 50 a bare ``f32_array / 0.01`` would
    # stay FLOAT32 and round high tick counts to different integers.
    # Multiply by the integral inverse rather than dividing by the
    # non-representable 0.01.
    inv = TICKS_PER_UNIT
    o, h, l, c, v = (bars[..., i].astype(np.float64) for i in range(5))

    ct = np.rint(c * inv)
    # Tick alignment of every price field on valid lanes: absolute 1e-3
    # ticks plus a relative 4-f32-ulp term — prices arrive as f32, whose
    # representation error measured in ticks grows with magnitude.
    for p in (o, h, l, c):
        pt = (p * inv)[mask]
        r = np.rint(pt)
        if not (np.abs(pt - r) <= 1e-3 + 2.4e-7 * np.abs(r)).all():
            return None
    if np.abs(ct[mask]).max(initial=0) > 2**22:  # f32-exact tick range
        return None
    vv = v[mask]
    # volume integrality is ABSOLUTE 1e-3 (no relative term): f32 holds
    # fractional volumes up to 2^23
    if len(vv) and (not (np.abs(vv - np.rint(vv)) <= 1e-3).all()
                    or vv.max(initial=0) >= 2**31 or vv.min(initial=0) < 0):
        return None

    ctm = np.where(mask, ct, 0.0)
    # previous valid close ticks per slot (base before the first valid bar)
    idx = np.where(mask, np.arange(mask.shape[-1]), -1)
    last_valid = np.maximum.accumulate(idx, axis=-1)
    prev_valid = np.concatenate(
        [np.full(last_valid.shape[:-1] + (1,), -1), last_valid[..., :-1]],
        axis=-1)
    first_idx = np.argmax(mask, axis=-1)
    base_ct = np.take_along_axis(ctm, first_idx[..., None], axis=-1)[..., 0]
    prev_ct = np.where(
        prev_valid >= 0,
        np.take_along_axis(ctm, np.maximum(prev_valid, 0), axis=-1),
        base_ct[..., None])
    dclose = np.where(mask, ct - prev_ct, 0.0)
    dopen = np.where(mask, np.rint(o * inv) - ct, 0.0)
    dhigh = np.where(mask, np.rint(h * inv) - ct, 0.0)
    dlow = np.where(mask, np.rint(l * inv) - ct, 0.0)
    dohl = np.stack([dopen, dhigh, dlow], axis=-1)
    dohl_max = int(np.abs(dohl).max(initial=0))
    dclose_max = int(np.abs(dclose).max(initial=0))
    if dclose_max > _I16 or dohl_max > _I16:
        return None
    vol_i = np.where(mask, np.rint(v), 0).astype(np.int64)
    dop, dh, dl = dohl[..., 0], dohl[..., 1], dohl[..., 2]
    h_off = dh - np.maximum(dop, 0)
    l_off = np.minimum(dop, 0) - dl
    wick_ok = int(((np.abs(dop) <= 127) & (h_off >= 0) & (h_off <= 15)
                   & (l_off >= 0) & (l_off <= 15)).all())
    tight_ok = int(((dop >= -8) & (dop <= 7) & (h_off >= 0) & (h_off <= 3)
                    & (l_off >= 0) & (l_off <= 3)).all())
    stats = (dohl_max, dclose_max,
             int((vol_i % 100 == 0).all()), int(vol_i.max(initial=0)),
             wick_ok, tight_ok)
    (base, dclose, dohl, volume, vol_scale), modes = narrow_wire(
        (base_ct / inv).astype(np.float32),
        dclose.astype(np.int16), dohl.astype(np.int16),
        vol_i.astype(np.int32), stats, floor=floor)
    return WireBatch(base=base, dclose=dclose, dohl=dohl, volume=volume,
                     maskbits=pack_mask(mask), vol_scale=vol_scale,
                     modes=modes)


def _int4(b):
    """Sign-extend the low nibble of int32 ``b``."""
    return ((b & 0xF) ^ 8) - 8


def decode(base, dclose, dohl, volume, maskbits, vol_scale):
    """Unpack wire tensors -> ``(bars [..., T, S, 5] f32, mask)`` on their
    device.

    The slot count comes from ``dohl``'s slot axis (every dohl mode keeps
    it), so the same decode serves every session's layout.
    """
    n_slots = dohl.shape[-2]
    dev = maskbits.device
    shifts = torch.arange(8, dtype=torch.int32, device=dev)
    bits = (maskbits.to(torch.int32)[..., None] >> shifts) & 1
    m = bits.reshape(maskbits.shape[:-1] + (maskbits.shape[-1] * 8,))
    if maskbits.shape[-1] * 8 != n_slots:  # pad-bit slice only when
        m = m[..., :n_slots]               # S % 8 != 0 (us_390)
    m = m.to(torch.bool)
    if dclose.shape[-1] == n_slots // 2 and n_slots % 2 == 0 \
            and dclose.shape[-1] != n_slots:  # int4-pair packing
        b = dclose.to(torch.int32)
        dc = torch.stack([_int4(b), _int4(b >> 4)], dim=-1) \
            .reshape(dclose.shape[:-1] + (n_slots,))
    else:
        dc = dclose.to(torch.int32)
    # f32 multiply then round half to even, as jnp.round
    ct = torch.round(base * float(TICKS_PER_UNIT)).to(torch.int32)[..., None] \
        + torch.cumsum(dc, dim=-1, dtype=torch.int32)
    if dohl.shape[-1] == 1:  # tight packing (see module docstring)
        b = dohl[..., 0].to(torch.int32)
        ot = ct + _int4(b)
        ht = torch.maximum(ct, ot) + ((b >> 4) & 0x3)
        lt = torch.minimum(ct, ot) - (b >> 6)
    elif dohl.shape[-1] == 2:  # wick packing
        b0 = dohl.view(torch.int8)[..., 0].to(torch.int32)
        b1 = dohl[..., 1].to(torch.int32)
        ot = ct + b0
        ht = torch.maximum(ct, ot) + (b1 >> 4)
        lt = torch.minimum(ct, ot) - (b1 & 0xF)
    else:
        d = dohl.to(torch.int32)
        ot = ct + d[..., 0]
        ht = ct + d[..., 1]
        lt = ct + d[..., 2]
    # the f32 reciprocal of the tick count: the multiplier XLA puts in
    # place of the JAX package's division (module docstring)
    scale = torch.full((), 1.0 / TICKS_PER_UNIT, dtype=torch.float32,
                       device=dev)
    close, open_, high, low = (t.to(torch.float32) * scale
                               for t in (ct, ot, ht, lt))
    if n_slots % 4 == 0 and volume.dtype == torch.uint8 \
            and volume.shape[-1] == vol10_bytes(n_slots):
        # 10-bit packed (4 values/5 bytes)
        g = volume.reshape(volume.shape[:-1] + (n_slots // 4, 5)) \
            .to(torch.int32)
        b0, b1, b2, b3, b4 = (g[..., i] for i in range(5))
        vals = torch.stack([b0 | ((b1 & 0x3) << 8),
                            (b1 >> 2) | ((b2 & 0xF) << 6),
                            (b2 >> 4) | ((b3 & 0x3F) << 4),
                            (b3 >> 6) | (b4 << 2)], dim=-1)
        vol_units = vals.reshape(volume.shape[:-1] + (n_slots,))
    elif volume.dtype == torch.uint16:
        # through int16 bits: uint16 has few kernels on every device
        vol_units = volume.view(torch.int16).to(torch.int32) & 0xFFFF
    else:
        vol_units = volume
    vol = vol_units.to(torch.float32) * vol_scale.to(torch.float32)
    zero = torch.zeros_like(close)
    bars = torch.stack(
        [torch.where(m, f, zero) for f in (open_, high, low, close, vol)],
        dim=-1)
    return bars, m


def pack_spec(arrays) -> tuple:
    """``(spec, nbytes)`` of the buffer :func:`pack_arrays` makes of
    ``arrays``: ``spec`` is a hashable ``((dtype, shape, byte_offset),
    ...)``, every chunk padded to 4 bytes, so every slice's offset is a
    multiple of its element size."""
    spec, off = [], 0
    for a in arrays:
        a = np.asarray(a)
        spec.append((a.dtype.str, a.shape, off))
        off += -(-a.nbytes // 4) * 4
    return tuple(spec), off


def pack_arrays(arrays, out: Optional[np.ndarray] = None) -> tuple:
    """Concatenate host arrays into ONE uint8 buffer + a static spec.

    A batch ships as one buffer instead of six (and returns one stacked
    tensor instead of 58 — see the pipeline), so it costs one host->device
    copy. :func:`unpack` slices and reinterprets on device. ``out`` (a
    1-D uint8 array of ``pack_spec(arrays)[1]`` bytes, e.g. the numpy view
    of a pinned host tensor) receives the bytes in place of a new buffer;
    the pad bytes are zero either way.
    """
    arrays = [np.asarray(a) for a in arrays]
    spec, nbytes = pack_spec(arrays)
    if out is None:
        out = np.empty(nbytes, np.uint8)
    elif out.dtype != np.uint8 or out.shape != (nbytes,):
        raise ValueError(f"pack_arrays: out is {out.dtype} {out.shape}, "
                         f"expected uint8 ({nbytes},)")
    for a, (_, _, off) in zip(arrays, spec):
        b = np.ascontiguousarray(a).reshape(-1).view(np.uint8)
        out[off:off + b.nbytes] = b
        out[off + b.nbytes:off + -(-b.nbytes // 4) * 4] = 0
    return out, spec


def unpack(buf, spec):
    """Invert :func:`pack_arrays` on the buffer's device: each array is a
    view of ``buf`` (a 1-D uint8 tensor) reinterpreted as its dtype."""
    out = []
    for dtype_str, shape, off in spec:
        dt = np.dtype(dtype_str)
        n = int(np.prod(shape, dtype=np.int64)) if shape else 1
        raw = buf[off:off + n * dt.itemsize]
        out.append(raw.view(_TORCH_DTYPES[dt]).reshape(shape))
    return tuple(out)
