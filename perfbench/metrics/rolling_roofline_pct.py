"""``rolling_roofline_pct.<path>``: the rolling second-moment kernels'
share of their roofline over the traced window: the least time of every
call (bytes at the HBM peak, :mod:`perfbench.roofline`, from the cell's
``[rows, slots]``) over the device time of those kernels. The kernels are
found by the program's kernel name."""

from perfbench import roofline

#: a substring of the program's second-moment kernels' names
KERNEL = "second_moments"


def read(run):
    shape = run.counters.get("rolling_shape")
    if run.trace is None or shape is None:
        return None
    times = [d for n, d in run.trace.kernels if KERNEL in n]
    if not times or sum(times) <= 0:
        return None
    least = len(times) * roofline.moment_least_s(*shape)
    return 100.0 * least / (sum(times) * 1e-6)
