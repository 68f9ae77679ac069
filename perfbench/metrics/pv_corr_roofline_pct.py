"""``pv_corr_roofline_pct.<path>``: the six price-volume correlations'
share of their roofline over the traced window, by the program's
``ctx.pv_corr`` spans (one a ``DayContext``, labelled ``rows``, ``slots``
and ``impl``): the least time of each call, its bytes at the HBM peak,
over the spans' device time. The bytes are what the work needs whatever
implements it: f32 close, f32 volume and the bool mask read once (9
bytes a bar) and the six f32 answers of each row written once. Read as
``rolling_span_roofline_pct`` reads its spans; a program without the
span reads nothing."""

from perfbench import roofline
from perfbench.metrics.decode_ms_per_day import device_spans

#: bytes a bar read (close and volume f32, the mask bool) and a row written
BAR_BYTES = 4 + 4 + 1
ROW_BYTES = 6 * 4


def least_s(rows: int, slots: int) -> float:
    """The least time of one call over ``[rows, slots]``: its bytes at the
    HBM rate (a few dozen FP32 instructions a bar stay under it)."""
    return (BAR_BYTES * rows * slots + ROW_BYTES * rows) \
        / roofline.HBM_BYTES_PER_S


def read(run):
    spans = device_spans(run, lambda n: n == "ctx.pv_corr")
    if spans is None:
        return None
    try:
        least = sum(least_s(int(e["labels"]["rows"]),
                            int(e["labels"]["slots"])) for e in spans)
    except (KeyError, TypeError, ValueError):
        return None
    took = sum(e["device_us"] for e in spans) * 1e-6
    return 100.0 * least / took if took > 0 else None
