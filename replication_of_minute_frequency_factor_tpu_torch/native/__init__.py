"""The native grid packer and wire encoder (``gridpack.cpp``), their
ctypes binding, and the numpy wire narrowing beside them.

The port's copy of the JAX package's ``native/__init__.py``. The C++
source is the JAX package's, copied into this directory; the loader
builds it with ``g++`` at first use into ``build/native/`` at the
checkout root (named by a hash of the source, the flags and the host
CPU's features), checks its
ABI version and rebuilds once on a mismatch. :func:`..data.minute.grid_day`
and :func:`..data.wire.encode` take the native path when it loads, and
the numpy path otherwise or when asked; every call counts the path it
requested and the one it resolved in :data:`IMPL_COUNTS`, so a quiet
numpy run can never pass as the native path. The ladders, ``pack_*`` and
:func:`narrow_wire` are the numpy path's narrowing, which the native
encoder reproduces byte for byte (tests/test_torch_native.py).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path
from typing import Dict, Optional, Tuple

import numpy as np

SOURCE = Path(__file__).resolve().parent / "gridpack.cpp"
BUILD_DIR = SOURCE.parent.parent.parent / "build" / "native"
#: the ABI version ``gridpack.cpp`` reports (``grid_pack_abi_version``)
ABI_VERSION = 11
#: g++ flags, tried in order: -march=native unlocks the wide vectors the
#: encoder's pass-1 loop is shaped for (AVX-512: 8 doubles/vector);
#: -mtune=native for toolchains where native ISA probing fails
ARCH_FLAGS = ("-march=native", "-mtune=native")
_CXX_FLAGS = ("-O3", "-fno-math-errno", "-shared", "-fPIC")

#: ticks per currency unit (the 0.01 tick) that prices are packed in
TICKS_PER_UNIT = 100

#: (op, requested, resolved) -> calls: op is 'grid' or 'wire', requested
#: 'auto' (None), 'native' (True) or 'numpy' (False), resolved 'native'
#: or 'numpy'
IMPL_COUNTS: Dict[Tuple[str, str, str], int] = {}

_lib: Optional[ctypes.CDLL] = None
_tried = False
_lock = threading.Lock()


def count(op: str, use_native: Optional[bool], resolved: str) -> None:
    """Count one call of ``op`` that asked for ``use_native`` and ran the
    ``resolved`` path."""
    key = (op, {None: "auto", True: "native", False: "numpy"}[use_native],
           resolved)
    with _lock:
        IMPL_COUNTS[key] = IMPL_COUNTS.get(key, 0) + 1


def resolved_counts(op: str) -> Dict[str, int]:
    """``{resolved path: calls}`` of ``op`` since the last reset."""
    out: Dict[str, int] = {}
    with _lock:
        for (o, _, res), n in IMPL_COUNTS.items():
            if o == op:
                out[res] = out.get(res, 0) + n
    return out


def reset_counts() -> None:
    with _lock:
        IMPL_COUNTS.clear()


def _cpu_features() -> bytes:
    """The host CPU's feature flags (``/proc/cpuinfo``), which
    ``-march=native`` compiles for; empty where they cannot be read."""
    try:
        with open("/proc/cpuinfo", "rb") as fh:
            for line in fh:
                if line.startswith(b"flags"):
                    return line
    except OSError:
        pass
    return b""


def library_path() -> Path:
    """Where the library for this source, these flags and this CPU's
    features lives: a checkout copied to another machine builds anew
    rather than load code compiled for other instructions."""
    digest = hashlib.sha256(
        SOURCE.read_bytes() + " ".join(_CXX_FLAGS + ARCH_FLAGS).encode()
        + _cpu_features())
    return BUILD_DIR / f"libgridpack-{digest.hexdigest()[:16]}.so"


def _build(path: Path) -> bool:
    """Compile the source to ``path`` (atomically: other processes never
    see a partial library); False when no flag set compiles."""
    path.parent.mkdir(parents=True, exist_ok=True)
    tmp = path.with_name(f"{path.name}.{os.getpid()}.tmp")
    for arch_flag in ARCH_FLAGS:
        try:
            subprocess.run(["g++", *_CXX_FLAGS[:2], arch_flag,
                            *_CXX_FLAGS[2:], "-o", str(tmp), str(SOURCE)],
                           check=True, capture_output=True, timeout=120)
        except (OSError, subprocess.SubprocessError):
            continue
        os.replace(tmp, path)
        return True
    tmp.unlink(missing_ok=True)
    return False


def _open(path: Path) -> ctypes.CDLL:
    lib = ctypes.CDLL(str(path))
    lib.grid_pack_abi_version.restype = ctypes.c_int64
    return lib


def _close(lib: ctypes.CDLL) -> None:
    """Unload ``lib``, so that a rebuilt file at its path loads anew
    (dlopen hands back the loaded object for a path it already holds)."""
    import _ctypes
    _ctypes.dlclose(lib._handle)


def load() -> Optional[ctypes.CDLL]:
    """The native library, building it on first call; None if
    unavailable (no g++, or a build that fails)."""
    global _lib, _tried
    with _lock:
        if _lib is not None or _tried:
            return _lib
        _tried = True
        path = library_path()
        if not path.exists() and not _build(path):
            return None
        try:
            lib = _open(path)
            if lib.grid_pack_abi_version() != ABI_VERSION:
                # stale build from an older source tree: rebuild once
                _close(lib)
                if not _build(path):
                    return None
                lib = _open(path)
                if lib.grid_pack_abi_version() != ABI_VERSION:
                    return None
        except (OSError, AttributeError):
            return None
        _bind(lib)
        _lib = lib
        return _lib


def _bind(lib: ctypes.CDLL) -> None:
    lib.grid_pack.restype = ctypes.c_int64
    lib.grid_pack.argtypes = [
        ctypes.POINTER(ctypes.c_int64),   # tidx
        ctypes.POINTER(ctypes.c_int64),   # time
        ctypes.POINTER(ctypes.c_double),  # open
        ctypes.POINTER(ctypes.c_double),  # high
        ctypes.POINTER(ctypes.c_double),  # low
        ctypes.POINTER(ctypes.c_double),  # close
        ctypes.POINTER(ctypes.c_double),  # volume
        ctypes.c_int64,                   # n_rows
        ctypes.c_int64,                   # n_tickers
        ctypes.POINTER(ctypes.c_float),   # bars out
        ctypes.POINTER(ctypes.c_uint8),   # mask out
    ]
    lib.wire_encode.restype = ctypes.c_int64
    lib.wire_encode.argtypes = [
        ctypes.POINTER(ctypes.c_float),   # bars [n,240,5]
        ctypes.POINTER(ctypes.c_uint8),   # mask [n,240]
        ctypes.c_int64,                   # n_tickers (flattened)
        ctypes.c_double,                  # inv_tick
        ctypes.c_int64,                   # dclose_mode (0 int4-pair,
                                          #   1 i8, 2 i16)
        ctypes.c_int64,                   # ohl_mode (0 tight, 1 wick,
                                          #           2 i8x3, 3 i16x3)
        ctypes.c_int64,                   # vol_mode (0/1 10-bit shares/
                                          #   lots, 2/3 u16, 4 i32)
        ctypes.POINTER(ctypes.c_float),   # base out
        ctypes.c_void_p,                  # dclose out
        ctypes.c_void_p,                  # dohl out
        ctypes.c_void_p,                  # volume out
        ctypes.POINTER(ctypes.c_int64),   # viol out [3]
    ]


def available() -> bool:
    return load() is not None


def grid_pack_native(tidx: np.ndarray, time: np.ndarray, open_: np.ndarray,
                     high: np.ndarray, low: np.ndarray, close: np.ndarray,
                     volume: np.ndarray, n_tickers: int):
    """One-pass native scatter; returns ``(bars [T,240,5] f32,
    mask [T,240] bool)``. Caller guarantees ``tidx`` is -1 for unknown
    codes."""
    lib = load()
    if lib is None:
        raise RuntimeError("native gridpack unavailable")
    n = len(tidx)
    tidx = np.ascontiguousarray(tidx, np.int64)
    time = np.ascontiguousarray(time, np.int64)
    f64 = [np.ascontiguousarray(a, np.float64)
           for a in (open_, high, low, close, volume)]
    if time.shape != (n,) or any(a.shape != (n,) for a in f64):
        raise ValueError("grid_pack_native: every column must have "
                         f"{n} rows")
    bars = np.zeros((n_tickers, 240, 5), np.float32)
    mask = np.zeros((n_tickers, 240), np.uint8)

    def p(a, t):
        return a.ctypes.data_as(ctypes.POINTER(t))

    lib.grid_pack(p(tidx, ctypes.c_int64), p(time, ctypes.c_int64),
                  *[p(a, ctypes.c_double) for a in f64],
                  n, n_tickers,
                  p(bars, ctypes.c_float), p(mask, ctypes.c_uint8))
    return bars, mask.astype(bool)


def wire_encode_native(bars: np.ndarray, mask: np.ndarray,
                       n_threads: Optional[int] = None,
                       floor: Optional[dict] = None):
    """One-pass native wire pack of ``bars [..., T, 240, 5] f32`` directly
    into the narrowest formats the data (and the widen-only ``floor``)
    allow.

    Returns ``(base, dclose, dohl, volume, vol_scale)`` with the leading
    batch shape preserved, or None when the batch is unrepresentable in
    any format (caller falls back to shipping raw f32). When a requested
    narrow format overflows mid-pass the encoder aborts with violation
    flags and the pass retries one step wider (bounded by the ladder
    length, and ``floor`` makes widenings sticky per run); on return
    ``floor`` holds the modes the batch was packed at (a missing key is
    mode 0), as :func:`narrow_wire` leaves it.

    Tickers are independent, so each pass chunks across ``n_threads``
    (default: up to 8 cores; the ctypes call releases the GIL).
    """
    lib = load()
    if lib is None:
        return None
    floor = floor if floor is not None else {}
    bars = np.ascontiguousarray(bars, np.float32)
    lead = bars.shape[:-2]  # [..., T]
    if bars.shape[-2:] != (240, 5) or np.shape(mask) != bars.shape[:-1]:
        raise ValueError(f"wire_encode_native: bars {bars.shape} and mask "
                         f"{np.shape(mask)} are not [..., 240, 5] and "
                         "[..., 240]")
    n = int(np.prod(lead)) if lead else 1
    m8 = np.ascontiguousarray(mask, np.uint8).reshape(n, 240)
    bars_f = bars.reshape(n, 240, 5)
    base = np.empty((n,), np.float32)

    if n_threads is None:
        n_threads = min(os.cpu_count() or 1, 8)
    n_threads = max(1, min(n_threads, n))
    bounds = np.linspace(0, n, n_threads + 1).astype(int)

    def p(a, t=None):
        if t is None:
            return ctypes.c_void_p(a.ctypes.data)
        return a.ctypes.data_as(ctypes.POINTER(t))

    while True:
        cm = floor.get("dclose_mode", 0)
        om = floor.get("ohl_mode", 0)
        vm = floor.get("vol_mode", 0)
        clen, cdt = DCLOSE_SHAPES[cm]
        dclose = np.empty((n, clen), cdt)
        width, odt = OHL_SHAPES[om]
        dohl = np.empty((n, 240, width), odt)
        vlen, vdt = VOL_SHAPES[vm]
        volume = np.empty((n, vlen), vdt)
        viols = [np.zeros(3, np.int64) for _ in range(n_threads)]

        def run(lo: int, hi: int, viol: np.ndarray):
            return lib.wire_encode(
                p(bars_f[lo:hi], ctypes.c_float),
                p(m8[lo:hi], ctypes.c_uint8),
                hi - lo, float(TICKS_PER_UNIT), cm, om, vm,
                p(base[lo:hi], ctypes.c_float),
                p(dclose[lo:hi]), p(dohl[lo:hi]), p(volume[lo:hi]),
                p(viol, ctypes.c_int64))

        if n_threads == 1:
            rcs = [run(0, n, viols[0])]
        else:
            import concurrent.futures as cf
            with cf.ThreadPoolExecutor(n_threads) as ex:
                rcs = list(ex.map(run, bounds[:-1], bounds[1:], viols))
        if any(rc < 0 for rc in rcs):
            return None
        if not any(rc == 1 for rc in rcs):
            break
        v = np.stack(viols).any(axis=0)
        if v[0]:
            floor["dclose_mode"] = cm + 1
        if v[1]:
            floor["ohl_mode"] = om + 1
        if v[2]:
            floor["vol_mode"] = vm + 1

    vol_scale = 100.0 if floor.get("vol_mode", 0) in VOL_LOT_MODES else 1.0
    return (base.reshape(lead), dclose.reshape(lead + (dclose.shape[-1],)),
            dohl.reshape(lead + (240, dohl.shape[-1])),
            volume.reshape(lead + (volume.shape[-1],)), vol_scale)


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
