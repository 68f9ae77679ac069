"""The six price-volume correlations on Hopper: the kernel's wrapper, its
launch count and its plain version.

The kernel is ``csrc/pv_corr.cu``, whose header says what it computes,
what bounds it and what its design does about it. It replaces no TPU
kernel: the JAX package computes the family (``models/pv_corr.py``) in
plain jnp. One launch computes all six correlations of every ``(day,
ticker)`` row in one read of the row, where the plain version runs six
compositions of ``shift_valid`` / ``pct_change_valid`` and
``masked_corr`` over whole fields. This module checks the inputs,
allocates the output, launches the kernel on the current stream and
counts the launch. For tensors that lie on the CPU it computes the plain
version, :func:`pv_corr_plain`; for CUDA tensors it launches the kernel
or raises.
"""

from __future__ import annotations

import ctypes
import math
import threading

import torch

from .. import kernels, pins
from ..data.minute import F_CLOSE, F_VOLUME
from .masked import masked_corr, pct_change_valid, shift_valid

#: the six factors, in the order of the output's first axis
NAMES = ("corr_prv", "corr_prvr", "corr_pv", "corr_pvd", "corr_pvl",
         "corr_pvr")

#: kernel launches since the last :func:`reset_launches`; the plain path
#: never counts. Shards of an in-process mesh launch from threads of their
#: own, so the count is taken under a lock
launches = 0
_COUNT_LOCK = threading.Lock()

_ENTRY = "pv_corr_six"

#: the most slots a row may have on the card: a row's stage (seven f32
#: planes and three bit planes) must fit one block's shared memory
MAX_SLOTS = 8192


def reset_launches() -> None:
    global launches
    launches = 0


def pv_corr_plain(close, volume, mask):
    """The six correlations ``[6, ...]`` in :data:`NAMES` order over
    ``close``, ``volume`` and ``mask`` ``[..., S]``: the family's
    compositions as ``models/pv_corr.py`` wrote them, stacked. The
    ``constant_window`` pin is read by ``masked_corr``."""
    pct, ok = pct_change_valid(close, mask)
    base = mask & (volume != 0)
    pc, ok_c = pct_change_valid(close, base)
    pv, ok_v = pct_change_valid(volume, base)
    v_lag, ok_lag = shift_valid(volume, mask, 1)
    v_lead, ok_lead = shift_valid(volume, mask, -1)
    return torch.stack([
        masked_corr(pct, volume, ok),           # corr_prv
        masked_corr(pc, pv, ok_c & ok_v),       # corr_prvr
        masked_corr(close, volume, mask),       # corr_pv
        masked_corr(close, v_lag, ok_lag),      # corr_pvd
        masked_corr(close, v_lead, ok_lead),    # corr_pvl
        masked_corr(close, pv, ok_v),           # corr_pvr
    ])


def _kernel():
    lib = kernels.load("pv_corr")
    fn = getattr(lib, _ENTRY)
    fn.argtypes = [ctypes.c_void_p] * 3 + [
        ctypes.c_longlong, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    lib.pv_corr_error_string.argtypes = [ctypes.c_int]
    lib.pv_corr_error_string.restype = ctypes.c_char_p
    return lib, fn


def pv_corr(bars, mask):
    """The six correlations ``[6, ...]`` (:data:`NAMES` order) of every
    row of ``bars [..., S, 5]`` f32 (open, high, low, close, volume) under
    ``mask [..., S]``. CPU tensors take the plain version; CUDA tensors
    must be contiguous, f32 bars and a bool mask of the bars' leading
    shape, on one device."""
    if bars.device.type == "cpu" and mask.device.type == "cpu":
        return pv_corr_plain(bars[..., F_CLOSE], bars[..., F_VOLUME], mask)
    return _launch(bars, mask,
                   pins.reading("constant_window") == "degenerate")


def _launch(bars, mask, anchor: bool):
    global launches
    dev = bars.device
    for name, t in (("bars", bars), ("mask", mask)):
        if dev.type != "cuda" or t.device != dev:
            raise ValueError(f"pv_corr: {name} is on {t.device}; both "
                             "inputs must be on one CUDA device")
        if not t.is_contiguous():
            raise ValueError(f"pv_corr: {name} is not contiguous")
    if bars.dtype != torch.float32:
        raise TypeError(f"pv_corr: bars are {bars.dtype}, expected "
                        "torch.float32")
    if mask.dtype != torch.bool:
        raise TypeError(f"pv_corr: mask is {mask.dtype}, expected "
                        "torch.bool")
    if bars.dim() < 2 or bars.shape[-1] != 5 \
            or tuple(mask.shape) != tuple(bars.shape[:-1]):
        raise ValueError(f"pv_corr: bars {tuple(bars.shape)} and mask "
                         f"{tuple(mask.shape)}; expected [..., S, 5] and "
                         "[..., S]")
    if not 1 <= mask.shape[-1] <= MAX_SLOTS:
        raise ValueError(f"pv_corr: {mask.shape[-1]} slots; the kernel "
                         f"takes 1 to {MAX_SLOTS}")
    out = torch.empty((6,) + tuple(mask.shape[:-1]), dtype=torch.float32,
                      device=dev)
    L = mask.shape[-1]
    rows = math.prod(mask.shape[:-1])
    if rows == 0:
        return out
    lib, fn = _kernel()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = fn(bars.data_ptr(), mask.data_ptr(), out.data_ptr(), rows, L,
                int(anchor), stream)
    if rc != 0:
        msg = lib.pv_corr_error_string(rc).decode()
        raise RuntimeError(f"{_ENTRY} launch failed: {msg} "
                           f"(cudaError {rc})")
    with _COUNT_LOCK:
        launches += 1
    return out
