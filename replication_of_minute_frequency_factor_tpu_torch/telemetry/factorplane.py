"""Factor-health statistics: the per-factor data-quality sketch.

The device-facing part of the JAX package's ``telemetry/factorplane.py``:
:func:`factor_stats_block` computes, on the block's device, an
``[F, ...] -> [F, 9]`` masked moment sketch (lane/finite/NaN/+-inf
counts, mean, std, min, max over the finite lanes) as a side output of a
dispatch that already produced the block, so it rides the block's fetch;
:func:`factor_stats_host` is its numpy twin (copied), the parity oracle.
Counts, min and max are exact on both; mean and std are f32 sums whose
order differs between devices and frameworks. The host ``FactorPlane``
(drift detection, flight dumps) is not ported.
"""

from __future__ import annotations

import numpy as np
import torch

#: column order of the [F, N_STATS] sketch (device and host halves share
#: it)
STAT_FIELDS = ("lanes", "finite", "nan", "posinf", "neginf",
               "mean", "std", "min", "max")
N_STATS = len(STAT_FIELDS)


def factor_stats_block(x: torch.Tensor) -> torch.Tensor:
    """``[F, ...]`` f32 -> ``[F, 9]`` f32 on ``x``'s device. Counts are
    exact (integer-valued f32); mean/std are two-pass over the finite
    lanes; min/max/moments are NaN when a factor has no finite lane."""
    f = x.shape[0]
    flat = x.reshape(f, -1)
    lanes = flat.shape[1]
    finite = torch.isfinite(flat)
    n_fin = finite.sum(dim=1, dtype=torch.int32)
    n_nan = torch.isnan(flat).sum(dim=1, dtype=torch.int32)
    n_pos = (flat == float("inf")).sum(dim=1, dtype=torch.int32)
    n_neg = (flat == float("-inf")).sum(dim=1, dtype=torch.int32)
    z = torch.where(finite, flat, 0.0)
    denom = torch.clamp(n_fin.to(torch.float32), min=1.0)
    mean = z.sum(dim=1) / denom
    var = torch.where(finite, (flat - mean[:, None]) ** 2,
                      0.0).sum(dim=1) / denom
    std = torch.sqrt(torch.clamp(var, min=0.0))
    big = float(np.finfo(np.float32).max)
    mn = torch.where(finite, flat, big).amin(dim=1)
    mx = torch.where(finite, flat, -big).amax(dim=1)
    has = n_fin > 0
    nan = float("nan")
    mean = torch.where(has, mean, nan)
    std = torch.where(has, std, nan)
    mn = torch.where(has, mn, nan)
    mx = torch.where(has, mx, nan)
    return torch.stack(
        [torch.full((f,), float(lanes), dtype=torch.float32,
                    device=x.device),
         n_fin.to(torch.float32), n_nan.to(torch.float32),
         n_pos.to(torch.float32), n_neg.to(torch.float32),
         mean, std, mn, mx], dim=1)


def factor_stats_host(x: np.ndarray) -> np.ndarray:
    """Host-numpy twin of :func:`factor_stats_block`: the same [F, 9]
    layout; counts/min/max match exactly, the f32 moment sums by
    reduction order only."""
    x = np.asarray(x, np.float32)
    f = x.shape[0]
    flat = x.reshape(f, -1)
    lanes = flat.shape[1]
    finite = np.isfinite(flat)
    n_fin = finite.sum(axis=1)
    out = np.empty((f, N_STATS), np.float32)
    out[:, 0] = lanes
    out[:, 1] = n_fin
    out[:, 2] = np.isnan(flat).sum(axis=1)
    out[:, 3] = (flat == np.inf).sum(axis=1)
    out[:, 4] = (flat == -np.inf).sum(axis=1)
    z = np.where(finite, flat, np.float32(0.0))
    denom = np.maximum(n_fin, 1).astype(np.float32)
    mean = z.sum(axis=1, dtype=np.float32) / denom
    var = np.where(finite,
                   (flat - mean[:, None]) ** 2,
                   np.float32(0.0)).sum(axis=1, dtype=np.float32) / denom
    has = n_fin > 0
    big = np.float32(np.finfo(np.float32).max)
    mn = np.where(finite, flat, big).min(axis=1)
    mx = np.where(finite, flat, -big).max(axis=1)
    out[:, 5] = np.where(has, mean, np.nan)
    out[:, 6] = np.where(has, np.sqrt(np.maximum(var, 0.0)), np.nan)
    out[:, 7] = np.where(has, mn, np.nan)
    out[:, 8] = np.where(has, mx, np.nan)
    return out
