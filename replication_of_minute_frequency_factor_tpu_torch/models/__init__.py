"""L1 factor kernel library: the CICC minute-frequency factors in torch.

Each factor is a function ``f(ctx: DayContext) -> [..., T]`` over the dense
day tensor; ``compute_factors`` runs any subset with the shared
intermediates (returns, volume shares, rolling regression stats) computed
once per call.
"""

from .context import DayContext  # noqa: F401
from .registry import (  # noqa: F401
    FACTORS,
    compute_factors,
    factor_names,
    register,
    resolve,
)
