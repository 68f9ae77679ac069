"""``ingest_bytes_per_bar.<path>``: the bytes the program shipped to the
card a bar of its input over the traced window: ``Σ bytes / Σ bars`` of
its ``wire.decode`` spans, each labelled with the ingest ``kind``
(``wire`` or ``raw``), the ``bars`` of its buffer (days × tickers ×
slots) and the buffer's length in ``bytes``. Raw f32 bars and a byte of
mask read 21.0; the ingest wire reads what its packing takes. The spans
count as ``decode_ms_per_day`` counts them; a program whose spans lack
the labels reads nothing."""

from perfbench.metrics.decode_ms_per_day import device_spans


def read(run):
    spans = device_spans(run, lambda n: n == "wire.decode")
    if spans is None:
        return None
    try:
        shipped = sum(int(e["labels"]["bytes"]) for e in spans)
        bars = sum(int(e["labels"]["bars"]) for e in spans)
    except (KeyError, TypeError, ValueError):
        return None
    return shipped / bars if bars > 0 else None
