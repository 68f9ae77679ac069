"""The rolling second-moment pass on Hopper: the kernels' wrapper, their
launch counts and their plain version.

Replaces the TPU kernel
``replication_of_minute_frequency_factor_tpu/ops/rolling_pallas.py::
second_moments``. The kernels are in ``csrc/rolling_moments.cu``, whose
header says what bounds them and what their design does about it: the
*tiled* kernel (register-blocked sliding window, asynchronous row
staging) computes window :data:`TILED_WINDOW`, the main path's; the
*rowwise* kernel computes any other window. Both give the same bits.
This module checks the inputs, allocates the outputs, launches a kernel
on the current stream and counts the launch. For tensors that lie on the
CPU it computes the plain version, :func:`second_moments_plain`; for
CUDA tensors it launches a kernel or raises.
"""

from __future__ import annotations

import ctypes
import threading

import torch

from .. import kernels
from .rolling import _second_moments_conv

#: the plain torch version of the kernels (the tests hold the kernels
#: against it on the card)
second_moments_plain = _second_moments_conv

#: the window the tiled kernel is compiled for (csrc/rolling_moments.cu
#: ``kTiledWindow``); every other window goes to the rowwise kernel
TILED_WINDOW = 50

#: kernel launches per kernel since the last :func:`reset_launches`; the
#: plain path never counts. Shards of an in-process mesh launch from
#: threads of their own, so each count is taken under a lock
launches = {"tiled": 0, "rowwise": 0}
_COUNT_LOCK = threading.Lock()

_ENTRIES = {"tiled": "rolling_second_moments_tiled",
            "rowwise": "rolling_second_moments_rowwise"}
_NAMES = ("xc", "yc", "mu_x", "mu_y")


def reset_launches() -> None:
    for k in launches:
        launches[k] = 0


def _kernel(variant: str):
    lib = kernels.load("rolling_moments")
    fn = getattr(lib, _ENTRIES[variant])
    fn.argtypes = [ctypes.c_void_p] * 7 + [
        ctypes.c_longlong, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    lib.rolling_error_string.argtypes = [ctypes.c_int]
    lib.rolling_error_string.restype = ctypes.c_char_p
    return lib, fn


def kernel_for(window: int) -> str:
    """Which kernel :func:`second_moments` launches for ``window``."""
    return "tiled" if int(window) == TILED_WINDOW else "rowwise"


def second_moments(xc, yc, mu_x, mu_y, window: int):
    """``(s_xx, s_yy, s_xy)`` over trailing windows of ``window`` slots.

    Inputs are the centred series and their window means
    (``rolling.second_moment_inputs``), ``[..., L]`` f32 each, any
    leading shape; outputs match. CPU tensors take the plain version;
    CUDA tensors must all be contiguous f32 of one shape on one device,
    and, for the tiled kernel, start 16-byte aligned.
    """
    tensors = (xc, yc, mu_x, mu_y)
    if all(t.device.type == "cpu" for t in tensors):
        return second_moments_plain(xc, yc, mu_x, mu_y, window)
    return _launch(kernel_for(window), tensors, window)


def _second_moments_rowwise(xc, yc, mu_x, mu_y, window: int):
    """The rowwise kernel at any window, ``TILED_WINDOW`` included: the
    baseline that ``chip_smoke.py`` and the card tests hold the tiled
    kernel against, bit for bit. CUDA tensors only."""
    return _launch("rowwise", (xc, yc, mu_x, mu_y), window)


def _launch(variant: str, tensors, window: int):
    xc = tensors[0]
    dev = xc.device
    for name, t in zip(_NAMES, tensors):
        if dev.type != "cuda" or t.device != dev:
            raise ValueError(f"second_moments: {name} is on {t.device}; "
                             "all inputs must be on one CUDA device")
        if t.dtype != torch.float32:
            raise TypeError(f"second_moments: {name} is {t.dtype}, "
                            "expected torch.float32")
        if t.shape != xc.shape:
            raise ValueError(f"second_moments: {name} has shape "
                             f"{tuple(t.shape)}, expected {tuple(xc.shape)}")
        if not t.is_contiguous():
            raise ValueError(f"second_moments: {name} is not contiguous")
        if variant == "tiled" and t.data_ptr() % 16:
            raise ValueError(f"second_moments: {name} is not 16-byte "
                             "aligned (a view with a storage offset?); the "
                             "tiled kernel reads 16-byte vectors")
    if xc.dim() < 1 or int(window) < 1:
        raise ValueError("second_moments: need a slot axis and window >= 1")
    outs = tuple(torch.empty(xc.shape, dtype=torch.float32, device=dev)
                 for _ in range(3))
    L = xc.shape[-1]
    rows = xc.numel() // L if L else 0
    if rows == 0:
        return outs
    lib, fn = _kernel(variant)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = fn(*(t.data_ptr() for t in tensors),
                *(o.data_ptr() for o in outs), rows, L, int(window), stream)
    if rc != 0:
        msg = lib.rolling_error_string(rc).decode()
        raise RuntimeError(f"{_ENTRIES[variant]} launch failed: {msg} "
                           f"(cudaError {rc})")
    with _COUNT_LOCK:
        launches[variant] += 1
    return outs
