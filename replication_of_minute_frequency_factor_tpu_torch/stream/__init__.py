"""Online intraday factor engine: stream minutes, not days.

The incremental kernel contract lives in :mod:`.carry`
(``init_carry / update / finalize``), the O(1)-per-bar fast finalize in
:mod:`.fastpath`, and the engine that keeps a day's carry on the device
and advances it through warm callables in :mod:`.engine`.
"""

from .carry import (  # noqa: F401
    carry_from_host,
    carry_nbytes,
    carry_to_host,
    finalize,
    finalize_with_readiness,
    init_carry,
    readiness,
    update_minute,
    update_tickers,
    advance,
)
from .engine import StreamEngine  # noqa: F401
