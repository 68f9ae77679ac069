"""The volume order statistics on Hopper: the kernel's wrapper and its
plain version.

The kernel is ``csrc/volume_select.cu``, whose header says what it
computes, what bounds it and what its design does about it. It replaces
no TPU kernel: the JAX package computes the factors it serves, the four
``mmt_*VolumeRet`` compounds and the three ``doc_vol*_ratio`` share sums,
in plain jnp (``ops/ranking.py``). One launch sorts each ``(day,
ticker)`` row's volume once, on chip, and answers every requested order
statistic of it, where the plain version runs a ``torch.topk``
composition for each. This module checks the inputs and allocates the
output; ``kernels.py`` launches and counts. For tensors that lie on the
CPU it computes the plain version, :func:`volume_selections_plain`; for
CUDA tensors it launches the kernel or raises.

An answer is a ``(kind, k)`` pair, the kind one of :data:`KINDS`:

- ``"top"`` / ``"bottom"``: the compound ``prod(close / open) - 1`` over
  the valid bars whose volume is at least (at most) the k-th largest
  (smallest) valid volume, ties included; NaN for a row without a bar;
- ``"share_sum"``: the sum of the k largest valid volume shares (volume
  over ``vol_sum``), largest first;
- ``"top_threshold"`` / ``"bottom_threshold"``: the thresholds the
  compounds select by (``ranking.topk_threshold``), which the card tests
  hold bit for bit.

The kernel's share sums and thresholds are the plain version's bits on
the CPU (on the card the plain bottom threshold places a valid NaN volume
otherwise: the card's negation of a NaN keeps its sign); its compounds
multiply in f64 in another order, and are held to the plain version at
the parity tolerances.
"""

from __future__ import annotations

import math

import torch

from .. import kernels
from ..data.minute import F_CLOSE, F_OPEN, F_VOLUME
from .masked import masked_product
from .ranking import bottomk_threshold, topk_sum, topk_threshold

#: the kinds of answer, in the kernel's numbering
KINDS = ("top", "bottom", "share_sum", "top_threshold", "bottom_threshold")

_LIB = _ENTRY = "volume_select"

#: the most slots a row may have, the longest session's 1440 padded to a
#: power of two: rows longer than 512 slots take a block a row
MAX_SLOTS = 2048
#: the most answers one launch computes
MAX_ANSWERS = 8

_NAN = float("nan")


def volume_selections_plain(bars, mask, vol_sum, answers):
    """``[len(answers), ...]``: each answer over ``bars [..., S, 5]``,
    ``mask [..., S]`` and ``vol_sum [...]`` by the compositions the
    factors ran before (``ops.ranking``'s ``topk_threshold``,
    ``bottomk_threshold`` and ``topk_sum``, ``masked_product``), stacked.
    Each shared operand is computed once, as the context memoised it."""
    volume = bars[..., F_VOLUME]
    memo = {}

    def once(key, fn):
        if key not in memo:
            memo[key] = fn()
        return memo[key]

    out = []
    for kind, k in answers:
        if kind == "share_sum":
            share = once("share", lambda: volume / vol_sum[..., None])
            out.append(topk_sum(share, mask, k))
            continue
        top = kind in ("top", "top_threshold")
        thr = (topk_threshold(volume, mask, k) if top
               else bottomk_threshold(volume, mask, k))
        if kind.endswith("_threshold"):
            out.append(thr)
            continue
        sel = mask & ((volume >= thr[..., None]) if top
                      else (volume <= thr[..., None]))
        ratio = once("ratio", lambda: bars[..., F_CLOSE] / bars[..., F_OPEN])
        has_bars = once("has_bars", lambda: mask.sum(dim=-1) > 0)
        out.append(torch.where(has_bars, masked_product(ratio, sel) - 1.0,
                               _NAN))
    return torch.stack(out)


def volume_selections(bars, mask, vol_sum, answers):
    """``[len(answers), ...]``: each ``(kind, k)`` of ``answers`` (kinds
    as :data:`KINDS`) over every row of ``bars [..., S, 5]`` f32 (open,
    high, low, close, volume) under ``mask [..., S]``, with each row's
    valid volume summed in ``vol_sum [...]``. CPU tensors take
    :func:`volume_selections_plain`; CUDA tensors must be contiguous, f32
    bars and sums and a bool mask of the bars' leading shape, on one
    device."""
    answers = tuple(answers)
    for t, what in ((bars, "bars"), (mask, "mask"), (vol_sum, "vol_sum")):
        want = torch.bool if what == "mask" else torch.float32
        if t.dtype != want:
            raise TypeError(f"volume_selections: {what} is {t.dtype}, "
                            f"expected {want}")
        if not t.is_contiguous():
            raise ValueError(f"volume_selections: {what} is not contiguous")
    if bars.dim() < 2 or bars.shape[-1] != 5 \
            or tuple(mask.shape) != tuple(bars.shape[:-1]) \
            or tuple(vol_sum.shape) != tuple(mask.shape[:-1]):
        raise ValueError(f"volume_selections: bars {tuple(bars.shape)}, mask "
                         f"{tuple(mask.shape)} and vol_sum "
                         f"{tuple(vol_sum.shape)}; expected [..., S, 5], "
                         "[..., S] and [...]")
    if not 1 <= mask.shape[-1] <= MAX_SLOTS:
        raise ValueError(f"volume_selections: {mask.shape[-1]} slots; the "
                         f"kernel takes 1 to {MAX_SLOTS}")
    if not 1 <= len(answers) <= MAX_ANSWERS or any(
            kind not in KINDS or not isinstance(k, int) or k < 1
            for kind, k in answers):
        raise ValueError(f"volume_selections: answers {answers}; expected "
                         f"1 to {MAX_ANSWERS} (kind, k) pairs, kinds of "
                         f"{KINDS}, k >= 1")
    if kernels.device_path("volume_selections", bars=bars, mask=mask,
                           vol_sum=vol_sum) == "plain":
        return volume_selections_plain(bars, mask, vol_sum, answers)
    out = torch.empty((len(answers),) + tuple(mask.shape[:-1]),
                      dtype=torch.float32, device=bars.device)
    rows = math.prod(mask.shape[:-1])
    if rows:
        spec = torch.tensor([v for kind, k in answers
                             for v in (KINDS.index(kind),
                                       min(k, mask.shape[-1]))],
                            dtype=torch.int32)
        kernels.launch(_LIB, _ENTRY, bars.device, bars.data_ptr(),
                       mask.data_ptr(), vol_sum.data_ptr(), out.data_ptr(),
                       rows, mask.shape[-1], spec.data_ptr(), len(answers))
    return out
