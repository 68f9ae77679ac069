"""The rolling second-moment pass on Hopper: the kernel's wrapper, its
launch count and its plain version.

Replaces the TPU kernel
``replication_of_minute_frequency_factor_tpu/ops/rolling_pallas.py::
second_moments``. The kernel is ``csrc/rolling_moments.cu``; its header
says what bounds it (memory traffic: seven f32 ``[rows, L]`` planes) and
what its design does about that. This module checks the inputs,
allocates the outputs, launches the kernel on the current stream and
counts the launches. For tensors that lie on the CPU it computes the
plain version, :func:`second_moments_plain`; for CUDA tensors it
launches the kernel or raises.
"""

from __future__ import annotations

import ctypes

import torch

from .. import kernels
from .rolling import _second_moments_conv

#: the plain torch version of the kernel (the tests hold the kernel
#: against it on the card)
second_moments_plain = _second_moments_conv

#: kernel launches since the last :func:`reset_launches`; the plain path
#: never counts
launches = 0

_NAMES = ("xc", "yc", "mu_x", "mu_y")


def reset_launches() -> None:
    global launches
    launches = 0


def _kernel():
    lib = kernels.load("rolling_moments")
    fn = lib.rolling_second_moments
    fn.argtypes = [ctypes.c_void_p] * 7 + [
        ctypes.c_longlong, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    lib.rolling_error_string.argtypes = [ctypes.c_int]
    lib.rolling_error_string.restype = ctypes.c_char_p
    return lib, fn


def second_moments(xc, yc, mu_x, mu_y, window: int):
    """``(s_xx, s_yy, s_xy)`` over trailing windows of ``window`` slots.

    Inputs are the centred series and their window means
    (``rolling.second_moment_inputs``), ``[..., L]`` f32 each, any
    leading shape; outputs match. CPU tensors take the plain version;
    CUDA tensors must all be contiguous f32 of one shape on one device.
    """
    global launches
    tensors = (xc, yc, mu_x, mu_y)
    if all(t.device.type == "cpu" for t in tensors):
        return second_moments_plain(xc, yc, mu_x, mu_y, window)
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
    if xc.dim() < 1 or int(window) < 1:
        raise ValueError("second_moments: need a slot axis and window >= 1")
    outs = tuple(torch.empty(xc.shape, dtype=torch.float32, device=dev)
                 for _ in range(3))
    L = xc.shape[-1]
    rows = xc.numel() // L if L else 0
    if rows == 0:
        return outs
    lib, fn = _kernel()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = fn(*(t.data_ptr() for t in tensors),
                *(o.data_ptr() for o in outs), rows, L, int(window), stream)
    if rc != 0:
        msg = lib.rolling_error_string(rc).decode()
        raise RuntimeError(f"rolling_second_moments launch failed: {msg} "
                           f"(cudaError {rc})")
    launches += 1
    return outs
