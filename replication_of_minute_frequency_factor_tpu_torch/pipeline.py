"""Batch entry point: day tensors in, a stacked ``[F, ...]`` factor block
out — the counterpart of the JAX package's ``pipeline._compute_packed``
with ``kind='raw'`` (the wire decode and the ``compute_exposures`` day
loop come with a later slice)."""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch

from .config import get_config
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
    """The named factors (default: every ported one, in registry order)
    over a batch of gridded days, stacked to ``[F, D, T]``.

    ``bars [D, T, S, 5]`` and ``mask [D, T, S]`` are numpy arrays or
    tensors (any leading shape works; the result is ``[F, *lead, T]``).
    Bars are cast to f32 on the way in, as the JAX package's
    ``jnp.asarray`` does. ``device`` defaults to ``cuda`` and raises when
    no card is present; pass ``device='cpu'`` to run on the CPU.
    ``rolling_impl`` and ``replicate_quirks`` default to the config's.
    """
    dev = resolve_device(device)
    cfg = get_config()
    if rolling_impl is None:
        rolling_impl = cfg.rolling_impl
    if replicate_quirks is None:
        replicate_quirks = cfg.replicate_quirks
    if isinstance(bars, np.ndarray):
        bars = torch.from_numpy(np.ascontiguousarray(bars, np.float32))
    if isinstance(mask, np.ndarray):
        mask = torch.from_numpy(np.ascontiguousarray(mask, bool))
    bars = bars.to(device=dev, dtype=torch.float32)
    mask = mask.to(device=dev, dtype=torch.bool)
    if tuple(mask.shape) != tuple(bars.shape[:-1]) or bars.shape[-1] != 5:
        raise ValueError(f"bars {tuple(bars.shape)} and mask "
                         f"{tuple(mask.shape)} do not form a day batch")
    names = factor_names() if names is None else tuple(names)
    out = compute_factors(bars, mask, names=names,
                          replicate_quirks=replicate_quirks,
                          rolling_impl=rolling_impl,
                          session=get_session(session))
    return torch.stack([out[n] for n in names])
