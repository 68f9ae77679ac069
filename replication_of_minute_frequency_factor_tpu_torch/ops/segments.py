"""Group-by-exact-value segment ops for the chip (volume-at-price) factors.

The ``doc_*`` family (reference
MinuteFrequentFactorCalculateMethodsCICC.py:937-1201) groups each stock's
volume shares by exact end-of-day-relative return value, then takes moments
of the per-group sums, or walks the cumulative distribution to a quantile.

On the dense grid this becomes: sort the lanes by value, detect tie-group
boundaries, and read per-segment sums off a cumulative-weight array at the
segment *end* positions. Moments over segments then reuse the ordinary
masked reductions with "is a segment end" as the mask — no scatter or
segment sum. The port of the JAX package's ``ops/segments.py``.

Ordering note (SURVEY.md §2.5 Q7): the reference's ``cum_sum`` runs in
polars' non-deterministic group-output order; the order is fixed to
ascending value (= ascending rank), the intended semantics, as the JAX
package and its numpy oracle do. The cumulative sum is accumulated in f64
and rounded to f32 a lane (the CPU's f32 cumsum, bit for bit, and the
same bits on the card at any row count); the JAX package's f32 scan
associates otherwise, so a cumulative share within rounding of a
``doc_pdf*`` threshold may cross one group earlier or later than there
(tests/test_parity.py's ``PDF_EDGE_EPS``).
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

from .masked import cummax_last, masked_kurtosis, masked_skew
from .ranking import masked_order

_NAN = float("nan")


class Segments(NamedTuple):
    """Lanes in ascending-value order: ``sv`` the sorted values, ``seg_sum``
    (at segment-end lanes) the summed weight of that tie-group, ``is_end``
    the last lane of each valid tie-group, ``cumw`` the running weight
    cumsum."""
    sv: torch.Tensor
    seg_sum: torch.Tensor
    is_end: torch.Tensor
    cumw: torch.Tensor


def _sorted_segments(values, weights, mask) -> Segments:
    """Sort lanes by value; return per-lane segment-end flags and segment
    sums. Invalid lanes sort strictly last (:func:`.ranking.masked_order`),
    so a valid ``+inf`` keeps its own segment."""
    order = masked_order(values, mask)
    sv = torch.gather(torch.where(mask, values, 0.0), -1, order)
    sw = torch.gather(torch.where(mask, weights, 0.0), -1, order)
    smask = torch.gather(mask, -1, order)

    L = values.shape[-1]
    first = torch.ones_like(smask[..., :1])
    new_group = torch.cat(
        [first, (sv[..., 1:] != sv[..., :-1])
         | (smask[..., 1:] != smask[..., :-1])], dim=-1)
    is_end = torch.cat([new_group[..., 1:], first], dim=-1) & smask

    # accumulated in f64 and rounded once a lane: the CPU's f32 cumsum
    # does exactly this, and torch's CUDA f32 scan associates by the
    # tensor's row count, so a rank's ticker block and the whole batch
    # would get other bits; this way every device and shape agrees
    cumw = torch.cumsum(sw, dim=-1, dtype=torch.float64).to(torch.float32)
    idx = torch.arange(L, device=values.device)
    start = cummax_last(torch.where(new_group, idx, -1))
    prev_cum = torch.where(
        start > 0, torch.gather(cumw, -1, (start - 1).clamp(min=0)), 0.0)
    return Segments(sv, cumw - prev_cum, is_end, cumw)


def segment_stats_by_value(values, weights, mask
                           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(skew, kurtosis) of per-unique-value weight sums — ``doc_skew`` /
    ``doc_kurt`` / ``doc_std``-as-coded (reference :948-1001)."""
    seg = _sorted_segments(values, weights, mask)
    return (masked_skew(seg.seg_sum, seg.is_end),
            masked_kurtosis(seg.seg_sum, seg.is_end))


def pdf_quantile_rank(seg: Segments, threshold: float):
    """First (lowest-value) segment of ``seg`` (:func:`_sorted_segments` of
    values, weights, mask) whose cumulative weight exceeds ``threshold``;
    returns that segment's value.

    Matches ``doc_pdf*`` (reference :1022-1027) under the ascending-order
    resolution of quirk Q7: with non-negative weights the end-of-segment
    cumulative sums are non-decreasing in value order, so "min rank among
    qualifying" equals "first segment whose cumulative share crosses the
    threshold". NaN when nothing qualifies (e.g. NaN shares from a
    zero-volume day). It takes the segments rather than the lanes, so the
    five ``doc_pdf*`` thresholds share one sort.
    """
    qualify = seg.is_end & (seg.cumw > threshold)
    any_q = qualify.any(dim=-1)
    # argmax on ties returns the first maximal index; bool is cast first
    first = qualify.to(torch.uint8).argmax(dim=-1)
    val = torch.gather(seg.sv, -1, first[..., None])[..., 0]
    return torch.where(any_q, val, _NAN)
