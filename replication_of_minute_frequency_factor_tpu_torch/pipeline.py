"""Batch entry points: a batch of gridded days in, a stacked ``[F, ...]``
factor block out, on the device.

:func:`compute_batch` takes bars and mask; :func:`compute_packed` (and its
device half :func:`compute_packed_prepared`) takes the arrays of the
ingest wire (or the raw bars and uint8 mask) packed into one uint8
buffer, copies that one buffer to the device, unpacks and decodes it
there — the JAX package's ``pipeline._compute_packed``. The
``compute_exposures`` day loop, the result wire and the factor-stats side
output come with later slices.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch

from .config import get_config
from .data import wire
from .markets import get_session
from .models import compute_factors, factor_names


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


def _stacked(bars, mask, names, session, rolling_impl, replicate_quirks):
    """The named factors over device tensors, stacked to ``[F, ...]``;
    None arguments take the registry's and the config's defaults."""
    cfg = get_config()
    if rolling_impl is None:
        rolling_impl = cfg.rolling_impl
    if replicate_quirks is None:
        replicate_quirks = cfg.replicate_quirks
    names = factor_names() if names is None else tuple(names)
    out = compute_factors(bars, mask, names=names,
                          replicate_quirks=replicate_quirks,
                          rolling_impl=rolling_impl,
                          session=get_session(session))
    return torch.stack([out[n] for n in names])


def compute_packed_prepared(buf, spec, kind: str,
                            names: Optional[Sequence[str]] = None,
                            replicate_quirks: Optional[bool] = None,
                            rolling_impl: Optional[str] = None,
                            result_spec=None, factor_stats=False,
                            session=None, device=None) -> torch.Tensor:
    """Device half of the packed path: one copy of an already-packed host
    buffer (``wire.pack_arrays``) to the device, unpack there, decode when
    ``kind='wire'`` (``kind='raw'`` ships ``(bars f32, mask uint8)``), and
    the named factors stacked to ``[F, D, T]`` on the device.

    ``device`` defaults to ``cuda`` and raises when no card is present.
    ``result_spec`` and ``factor_stats`` (the result wire and the
    factor-stats side output) are not ported yet and raise if given.
    """
    if result_spec is not None or factor_stats:
        raise NotImplementedError(
            "result_spec and factor_stats are not ported yet")
    if kind not in ("wire", "raw"):
        raise ValueError(f"kind must be 'wire' or 'raw', not {kind!r}")
    dev = resolve_device(device)
    buf = torch.from_numpy(np.ascontiguousarray(buf, np.uint8)).to(dev)
    arrs = wire.unpack(buf, spec)
    if kind == "wire":
        bars, mask = wire.decode(*arrs)
    else:
        bars, mask = arrs  # the mask ships as uint8
        mask = mask.to(torch.bool)
    return _stacked(bars, mask, names, session, rolling_impl,
                    replicate_quirks)


def compute_packed(arrays, kind: str, names: Optional[Sequence[str]] = None,
                   replicate_quirks: Optional[bool] = None,
                   rolling_impl: Optional[str] = None, result_spec=None,
                   factor_stats=False, session=None,
                   device=None) -> torch.Tensor:
    """One-call packed path: pack the host arrays (``WireBatch.arrays``
    for ``kind='wire'``, ``(bars, mask.astype(uint8))`` for ``'raw'``) into
    one buffer, then :func:`compute_packed_prepared`."""
    buf, spec = wire.pack_arrays(arrays)
    return compute_packed_prepared(
        buf, spec, kind, names, replicate_quirks, rolling_impl,
        result_spec, factor_stats, session=session, device=device)
