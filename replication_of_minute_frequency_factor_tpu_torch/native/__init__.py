"""The wire encoder's narrowing: per-field mode ladders and the sub-byte
packers.

The numpy half of the JAX package's ``native/__init__.py`` (its ladders,
``pack_*`` and ``narrow_wire``), copied so that the port stands alone.
The C++ single-pass encoder (``gridpack.cpp``) and its ctypes binding are
not ported yet: the port's :func:`..data.wire.encode` is the numpy path.
"""

from __future__ import annotations

import numpy as np


#: per-field format ladders at 240 slots, narrowest first; a mode is an
#: index into its ladder (:func:`narrow_wire` picks them)
#: (slots-axis length, dtype): int4-pair pack / int8 / int16
DCLOSE_SHAPES = ((120, np.uint8), (240, np.int8), (240, np.int16))
#: tight 1-byte pack / 2-byte wick pack / int8 x3 / int16 x3
OHL_SHAPES = ((1, np.uint8), (2, np.uint8), (3, np.int8), (3, np.int16))
#: (slots-axis length, dtype): 10-bit packed shares / 10-bit packed lots /
#: u16 shares / u16 lots / i32 shares
VOL_SHAPES = ((300, np.uint8), (300, np.uint8),
              (240, np.uint16), (240, np.uint16), (240, np.int32))
VOL_LOT_MODES = (1, 3)  # modes whose unit is the 100-share board lot


def pack_wick(dohl: np.ndarray) -> np.ndarray:
    """int16 ``[..., 240, 3]`` open/high/low deltas -> uint8 ``[..., 240, 2]``
    wick packing: byte0 = int8 open-close delta (two's complement), byte1 =
    (high-wick << 4) | low-wick, the wicks measured from the bar body.
    Caller guarantees representability (stats wick flag)."""
    dop = dohl[..., 0]
    h_off = (dohl[..., 1] - np.maximum(dop, 0)).astype(np.uint8)
    l_off = (np.minimum(dop, 0) - dohl[..., 2]).astype(np.uint8)
    return np.stack([dop.astype(np.int8).view(np.uint8),
                     (h_off << 4) | l_off], axis=-1)


def pack_tight(dohl: np.ndarray) -> np.ndarray:
    """int16 ``[..., 240, 3]`` open/high/low deltas -> uint8 ``[..., 240, 1]``
    tight packing: int4 open-close delta (two's complement, -8..7) |
    (high-wick & 3) << 4 | (low-wick & 3) << 6, wicks measured from the
    bar body. Caller guarantees representability (stats tight flag)."""
    dop = dohl[..., 0]
    h_off = (dohl[..., 1] - np.maximum(dop, 0)).astype(np.uint8)
    l_off = (np.minimum(dop, 0) - dohl[..., 2]).astype(np.uint8)
    b = (dop.astype(np.int8).view(np.uint8) & 0xF) \
        | (h_off << 4) | (l_off << 6)
    return b[..., None]


def pack_dclose4(dclose: np.ndarray) -> np.ndarray:
    """int16 ``[..., 240]`` close deltas (each |d| <= 7) -> uint8
    ``[..., 120]``: two int4 two's-complement deltas per byte, even slot
    in the low nibble."""
    u = (dclose.astype(np.int8).view(np.uint8) & 0xF) \
        .reshape(dclose.shape[:-1] + (dclose.shape[-1] // 2, 2))
    return (u[..., 0] | (u[..., 1] << 4)).astype(np.uint8)


def pack_vol10(vol: np.ndarray) -> np.ndarray:
    """int ``[..., S]`` volumes (each <= 1023, ``S % 4 == 0``) -> uint8
    ``[..., S//4*5]``: four 10-bit values per 5 bytes, little-endian
    bit order (value k's bit b lands at stream bit 10k+b)."""
    groups = vol.shape[-1] // 4
    g = vol.reshape(vol.shape[:-1] + (groups, 4)).astype(np.uint16)
    v0, v1, v2, v3 = (g[..., i] for i in range(4))
    out = np.empty(vol.shape[:-1] + (groups, 5), np.uint8)
    out[..., 0] = v0 & 0xFF
    out[..., 1] = (v0 >> 8) | ((v1 & 0x3F) << 2)
    out[..., 2] = (v1 >> 6) | ((v2 & 0xF) << 4)
    out[..., 3] = (v2 >> 4) | ((v3 & 0x3) << 6)
    out[..., 4] = v3 >> 2
    return out.reshape(vol.shape[:-1] + (groups * 5,))


def narrow_wire(base, dclose, dohl, volume, stats, floor=None):
    """Numpy-path narrowing, the JAX package's native encoder's mode
    ladders exactly (per field: first mode at or above the widen-only
    ``floor`` that fits the batch stats); tests/test_torch_wire.py holds
    the bytes to both of the JAX package's encoders. Returns the narrowed
    ``(base, dclose, dohl, volume, vol_scale)`` and the modes picked
    (``{"dclose_mode", "ohl_mode", "vol_mode"}``, ladder indices)."""
    floor = floor if floor is not None else {}
    dmax_ohl, dmax_c, v_lots, vmax, wick_ok, tight_ok = \
        (int(s) for s in stats)
    # sub-byte packings gate on the slot count's divisibility:
    # int4-pair dclose needs an even S, 10-bit volume S % 4 == 0.
    # A session missing a divisor (us_390's volume) just starts one
    # rung wider — widen-only floors stay monotonic per run.
    n_slots = dclose.shape[-1]

    def pick(key, fits):
        mode = floor.get(key, 0)
        while not fits[mode]:
            mode += 1
        if mode > floor.get(key, 0):
            floor[key] = mode
        return mode

    cm = pick("dclose_mode", (dmax_c <= 7 and n_slots % 2 == 0,
                              dmax_c <= 127, True))
    if cm == 0:
        dclose = pack_dclose4(dclose)
    elif cm == 1:
        dclose = dclose.astype(np.int8)
    om = pick("ohl_mode", (bool(tight_ok), bool(wick_ok),
                           dmax_ohl <= 127, True))
    if om == 0:
        dohl = pack_tight(dohl)
    elif om == 1:
        dohl = pack_wick(dohl)
    elif om == 2:
        dohl = dohl.astype(np.int8)
    vol4 = n_slots % 4 == 0
    vm = pick("vol_mode", (vol4 and vmax <= 1023,
                           vol4 and bool(v_lots) and vmax // 100 <= 1023,
                           vmax <= 0xFFFF,
                           bool(v_lots) and vmax // 100 <= 0xFFFF, True))
    vol_scale = 1.0
    if vm == 0:
        volume = pack_vol10(volume)
    elif vm == 1:
        volume = pack_vol10(volume // 100)
        vol_scale = 100.0
    elif vm == 2:
        volume = volume.astype(np.uint16)
    elif vm == 3:
        volume = (volume // 100).astype(np.uint16)
        vol_scale = 100.0
    modes = {"dclose_mode": cm, "ohl_mode": om, "vol_mode": vm}
    return (base, dclose, dohl, volume, vol_scale), modes
