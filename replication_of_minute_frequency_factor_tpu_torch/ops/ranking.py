"""Ranking and top-k ops on the masked minute grid.

``rank_average`` reproduces polars ``Expr.rank(method='average')`` (the
``doc_pdf*`` chip factors' whole-frame rank, reference
MinuteFrequentFactorCalculateMethodsCICC.py:1016). ``topk_threshold``
reproduces the ``volume.top_k(k).min()`` / ``bottom_k(k).max()`` cut used
by the ``mmt_*VolumeRet`` family (:389-397,417-421) and ``topk_sum`` the
``top_k(k).sum()`` of ``doc_vol*_ratio`` (:1153-1156). The port of the
JAX package's ``ops/ranking.py``.

Every order here is taken on an explicit integer key, never on float
keys: how a float sort or ``torch.topk`` places NaN, -0.0 and +0.0
differs between devices and from JAX, while an integer sort is exact
and stable everywhere, so the CPU and the card give the same
permutation.
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


def _canonical_key(x):
    """Total-order key of ``x`` with -0.0 folded onto +0.0 and every NaN
    onto +qNaN: the order ``jnp.sort`` uses (signed zeros equal, every
    NaN one value, sorted last)."""
    x = torch.where(x == 0, 0.0, x)
    return _total_order_key(torch.where(torch.isnan(x), _NAN, x))


def _group_bounds(skey, singleton):
    """Per-lane start/end sorted position of the tie-group each sorted lane
    belongs to: the run of equal keys in ``skey`` (sorted ascending along
    the last axis), or the lane alone where ``singleton``.

    The JAX package finds the same bounds with two running-max scans over
    the group starts. Binary searches of each key in its own sorted row
    give them with no scan along the row, which matters for the
    whole-frame rank: a row of ``T*S`` lanes (1.2M at 5000 tickers) is one
    long sequential scan for torch's CUDA scan kernels, and a binary search
    per lane is not.
    """
    idx = torch.arange(skey.shape[-1], device=skey.device)
    start = torch.searchsorted(skey, skey, side="left")
    end = torch.searchsorted(skey, skey, side="right") - 1
    return (torch.where(singleton, idx, start),
            torch.where(singleton, idx, end))


def _masked_sort(x, mask):
    """(sorted keys, order) of one stable integer sort: invalidity in bit
    32 of an int64 key, the value's canonical total-order key below it."""
    key = _canonical_key(torch.where(mask, x, 0.0)).to(torch.int64)
    key = key + (2**31) + ((~mask).to(torch.int64) << 32)
    return torch.sort(key, dim=-1, stable=True)


#: the sort key of a valid NaN lane (every NaN canonicalises to +qNaN)
_NAN_KEY = int(_total_order_key(torch.tensor([_NAN]))[0]) + 2**31


def masked_order(x, mask):
    """Stable ascending sort order with invalid lanes strictly last.

    ``jnp.lexsort((where(mask, x, 0), ~mask))``'s permutation: validity
    is the primary key, so a genuine ``+inf`` in a valid lane still sorts
    before every invalid lane; -0.0 and +0.0 are equal, and every NaN is
    one value, sorted after ``+inf``.
    """
    return _masked_sort(x, mask).indices


def rank_average(x, mask):
    """Average-tie ranks (1-based) among valid lanes; NaN elsewhere.

    Tie groups occupy consecutive positions after a stable sort, so the
    average rank of a group spanning sorted positions [s, e] is
    ((s+1) + (e+1)) / 2 — no segment-sum needed. As in the JAX package,
    ties are float equality: -0.0 ties +0.0, and every NaN is a group of
    its own.
    """
    skey, order = _masked_sort(x, mask)
    start, end = _group_bounds(skey, skey == _NAN_KEY)
    avg = (start + end).to(torch.float32) / 2.0 + 1.0
    # the inverse permutation, by scatter rather than a second sort
    inv = torch.empty_like(order).scatter_(
        -1, order, torch.arange(order.shape[-1], device=order.device)
        .expand_as(order).contiguous())
    ranks = torch.gather(avg, -1, inv)
    return torch.where(mask, ranks, _NAN)


def topk_sum(x, mask, k: int):
    """Sum of the k largest valid values (all of them when n < k) —
    polars ``x.top_k(k).sum()`` (doc_vol*_ratio, reference :1153-1156).

    Ranks the total-order key as :func:`topk_threshold` does, but with
    every NaN folded onto +NaN first, so a NaN share (a zero-volume day's
    0/0) ranks above the ``-inf`` of the invalid lanes and the sum is NaN
    on every device, as the f64 oracle's is. The JAX package ranks the
    NaN's own sign bit there instead: x86's 0/0 is -NaN, which sorts
    below ``-inf``, so on the CPU it returns ``-inf`` when fewer valid
    lanes than k hold the NaN (tests/test_torch_chip.py pins the three
    answers). The k values are summed in order, largest first, as XLA
    does for these small k.
    """
    k = min(k, x.shape[-1])
    key = torch.where(mask, x, float("-inf"))
    key = torch.where(torch.isnan(key), _NAN, key)
    idx = torch.topk(_total_order_key(key), k, dim=-1).indices
    vals = torch.gather(key, -1, idx)
    n = mask.sum(dim=-1)
    take = torch.arange(k, device=x.device) < n.clamp(max=k)[..., None]
    vals = torch.where(take, vals, 0.0)
    s = vals[..., 0]
    for i in range(1, k):
        s = s + vals[..., i]
    return torch.where(n > 0, s, _NAN)
