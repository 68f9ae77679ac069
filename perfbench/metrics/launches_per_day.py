"""``launches_per_day.<path>``: the CUDA kernels the traced window ran
(kernel events in the profiler's trace) over the trading days it
computed. The count repeats exactly run to run."""


def read(run):
    days = run.counters.get("days_traced")
    if run.trace is None or not days:
        return None
    n = len(run.trace.kernels)
    return n / days if n else None
