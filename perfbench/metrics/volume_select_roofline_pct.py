"""``volume_select_roofline_pct.<path>``: the volume order statistics'
share of their roofline over the traced window, by the program's
``ctx.volume_selections`` spans (one a ``DayContext``, labelled ``rows``,
``slots``, ``impl`` and ``answers``): the least time of each call, its
bytes at the HBM peak, over the spans' device self time (an intermediate
computed inside the span, such as the day's volume sum, is not its
work). The bytes are what the work needs whatever implements it: the f32
volume, open and close and the bool mask read once (13 bytes a bar), and
of each row the f32 volume sum read and each f32 answer written once (4 +
4 bytes an answer). Read as ``chip_segments_roofline_pct`` reads its
spans; a program without the labelled span reads nothing."""

from perfbench import roofline
from perfbench.metrics.decode_ms_per_day import device_spans

SPAN = "ctx.volume_selections"
#: bytes a bar read (volume, open and close f32, the mask bool)
BAR_BYTES = 4 + 4 + 4 + 1


def row_bytes(answers: int) -> int:
    """Bytes a row moves: its volume sum read, ``answers`` answers
    written."""
    return 4 + 4 * answers


def least_s(rows: int, slots: int, answers: int) -> float:
    """The least time of one call over ``[rows, slots]``: its bytes at the
    HBM rate."""
    return (BAR_BYTES * rows * slots + row_bytes(answers) * rows) \
        / roofline.HBM_BYTES_PER_S


def read(run):
    spans = device_spans(run, lambda n: n == SPAN)
    if spans is None:
        return None
    try:
        least = sum(least_s(int(e["labels"]["rows"]),
                            int(e["labels"]["slots"]),
                            int(e["labels"]["answers"])) for e in spans)
    except (KeyError, TypeError, ValueError):
        return None
    took = sum(e["device_self_us"] for e in spans) * 1e-6
    return 100.0 * least / took if took > 0 else None
