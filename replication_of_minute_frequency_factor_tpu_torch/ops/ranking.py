"""Top-k threshold ops on the masked minute grid.

``topk_threshold`` reproduces the ``volume.top_k(k).min()`` /
``bottom_k(k).max()`` cut used by the ``mmt_*VolumeRet`` family
(reference MinuteFrequentFactorCalculateMethodsCICC.py:389-397,417-421).
The port of the JAX package's ``ops/ranking.py`` threshold pair; the
sort-based ``rank_average``/``masked_order``/``topk_sum`` come with the
chip factors.
"""

from __future__ import annotations

import torch

_NAN = float("nan")


def _total_order_key(x):
    """int32 key whose integer order is IEEE-754 totalOrder on f32:
    -NaN < -inf < ... < -0 < +0 < ... < +inf < +NaN. The JAX package's
    ``lax.top_k`` ranks in this order, while ``torch.topk`` on floats
    puts every NaN first whatever its sign; ranking the integer key
    reproduces the JAX selection bit for bit."""
    i = x.contiguous().view(torch.int32)
    return i ^ ((i >> 31) & 0x7FFFFFFF)


def topk_threshold(x, mask, k: int, largest: bool = True):
    """k-th largest (smallest) valid value; all-valid extreme when n < k.

    Matches polars ``x.top_k(k).min()`` (``bottom_k(k).max()``), which
    returns min/max over however many elements exist when the group is
    shorter than k. NaN when the group is empty.
    """
    k = min(k, x.shape[-1])
    key = torch.where(mask, x, float("-inf") if largest else float("inf"))
    if not largest:
        key = -key
    idx = torch.topk(_total_order_key(key), k, dim=-1).indices  # descending
    vals = torch.gather(key, -1, idx)
    n = mask.sum(dim=-1)
    kk = torch.clamp(n.clamp(min=1), max=k) - 1
    thr = torch.gather(vals, -1, kk[..., None])[..., 0]
    if not largest:
        thr = -thr
    return torch.where(n > 0, thr, _NAN)


def bottomk_threshold(x, mask, k: int):
    return topk_threshold(x, mask, k, largest=False)
