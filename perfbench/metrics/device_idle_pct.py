"""``device_idle_pct.<path>``: the share of the traced window in which
nothing ran on the device (no kernel, copy or fill), from the profiler's
trace: 100 minus the union of device activity over the window."""


def read(run):
    t = run.trace
    if t is None or t.window_s <= 0:
        return None
    return 100.0 * (1.0 - t.busy_s / t.window_s)
