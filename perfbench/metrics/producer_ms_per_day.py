"""``producer_ms_per_day.<path>``: the host driver's producer stages
(``ExposureTable.timings``' ``io``, ``grid``, ``wire_encode`` and
``pack`` seconds, the program's own spans) summed over the traced
window's passes, per trading day computed."""


def read(run):
    s = run.counters.get("producer_s")
    days = run.counters.get("days_traced")
    if s is None or not days:
        return None
    return 1e3 * s / days
