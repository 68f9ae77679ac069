"""Grid fuzz: the port's native (C++) minute-grid scatter against its
numpy one on random long rows — off-grid and sub-minute times, unknown
codes, duplicate (code, minute) rows where the last write wins
(``tools/fuzz/fuzz_grid.py``). Host code: ``device`` is only resolved.
"""

from __future__ import annotations

import numpy as np

from . import scenarios


def check_case(seed: int) -> None:
    from ..data.minute import grid_day

    rows = scenarios.grid_case(seed)
    a = grid_day(*rows, use_native=True)
    b = grid_day(*rows, use_native=False)
    np.testing.assert_array_equal(a.codes, b.codes, err_msg="codes")
    np.testing.assert_array_equal(a.mask, b.mask, err_msg="mask")
    np.testing.assert_array_equal(a.bars.view(np.int32),
                                  b.bars.view(np.int32), err_msg="bars")


def run(lo: int, hi: int, device="cuda"):
    from . import device_of, sweep

    device_of(device)
    return sweep("grid", range(lo, hi), check_case, every=100)
