"""Factor registry and the compute entry point."""

from __future__ import annotations

from typing import Callable, Dict, Optional, Sequence, Tuple

from .context import DayContext

#: name -> kernel(ctx) -> [..., T], in the reference file's order (the
#: package's ``__init__`` imports the families in that order, whichever
#: module is imported first)
FACTORS: Dict[str, Callable] = {}

#: user-defined names -> kernel; consulted after FACTORS, never reported by
#: :func:`factor_names` (keeps the canonical set closed for parity suites)
ALIASES: Dict[str, Callable] = {}


def register(name: str):
    def deco(fn):
        FACTORS[name] = fn
        return fn
    return deco


def register_alias(name: str, kernel) -> None:
    """Expose a kernel (an existing name or an ad-hoc ``fn(ctx)``) under a
    user-chosen factor name (MinFreqFactor's ``calculate_method=``).

    The JAX package also files the alias under a finalize class for its
    streaming fast path; the port keeps no finalize classes until
    streaming is ported (ROADMAP Queue 1 item 7)."""
    if isinstance(kernel, str):
        kernel = FACTORS[kernel]
    ALIASES[name] = kernel


def resolve(name: str) -> Callable:
    try:
        return FACTORS[name]
    except KeyError:
        pass
    try:
        return ALIASES[name]
    except KeyError:
        raise KeyError(f"unknown factor {name!r}") from None


def factor_names() -> Tuple[str, ...]:
    return tuple(FACTORS)


def compute_factors(bars, mask, names: Optional[Sequence[str]] = None,
                    replicate_quirks: bool = True,
                    rolling_impl: Optional[str] = None,
                    session=None):
    """Compute the named factors (default: all 58) over a day tensor.

    ``bars [..., T, S, 5]`` f32 and ``mask [..., T, S]`` bool, on one
    device; returns ``{name: [..., T]}`` on that device.
    ``rolling_impl`` picks the mmt_ols_* second-moment backend
    (``ops.rolling.ROLLING_IMPLS``; None reads ``Config.rolling_impl``).
    ``session`` (a ``markets.SessionSpec`` or registry name; None is
    ``cn_ashare_240``) sets the day shape and the sentinel boundaries.
    """
    if names is None:
        names = tuple(FACTORS)
    ctx = DayContext(bars, mask, replicate_quirks=replicate_quirks,
                     rolling_impl=rolling_impl, session=session)
    return {n: resolve(n)(ctx) for n in names}
