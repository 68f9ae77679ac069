"""Factor registry and the compute entry point."""

from __future__ import annotations

from typing import Callable, Dict, Optional, Sequence, Tuple

from .context import DayContext

#: name -> kernel(ctx) -> [..., T], in the reference file's order
FACTORS: Dict[str, Callable] = {}


def register(name: str):
    def deco(fn):
        FACTORS[name] = fn
        return fn
    return deco


def _load_all():
    # import for registration side effects (ordered as the reference file;
    # the chip family comes with a later slice)
    from . import momentum, volatility, shape, liquidity, pv_corr, trade_flow  # noqa: F401


def resolve(name: str) -> Callable:
    _load_all()
    try:
        return FACTORS[name]
    except KeyError:
        raise KeyError(f"unknown or not yet ported factor {name!r}") from None


def factor_names() -> Tuple[str, ...]:
    _load_all()
    return tuple(FACTORS)


def compute_factors(bars, mask, names: Optional[Sequence[str]] = None,
                    replicate_quirks: bool = True,
                    rolling_impl: Optional[str] = None,
                    session=None):
    """Compute the named factors (default: every ported one) over a day
    tensor.

    ``bars [..., T, S, 5]`` f32 and ``mask [..., T, S]`` bool, on one
    device; returns ``{name: [..., T]}`` on that device.
    ``rolling_impl`` picks the mmt_ols_* second-moment backend
    (``ops.rolling.ROLLING_IMPLS``; None reads ``Config.rolling_impl``).
    ``session`` (a ``markets.SessionSpec`` or registry name; None is
    ``cn_ashare_240``) sets the day shape and the sentinel boundaries.
    """
    _load_all()
    if names is None:
        names = tuple(FACTORS)
    ctx = DayContext(bars, mask, replicate_quirks=replicate_quirks,
                     rolling_impl=rolling_impl, session=session)
    return {n: resolve(n)(ctx) for n in names}
