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

#: kernel name -> (window counter, minimum count): the streaming readiness
#: contract. While ``inc[counter] < minimum`` the kernel's defining group
#: is empty, so its partial-day exposure is NaN; a ready kernel may still
#: be NaN through degenerate data. Counters are the integer accumulators
#: of ``ops/incremental.py``, monotone over the day, so readiness is
#: monotone too. Every family module declares its kernels' requirements
#: next to the kernels.
STREAM_REQUIREMENTS: Dict[str, Tuple[str, int]] = {}

#: the three finalize exactness classes:
#:
#: ``exact_fold``  — the fast-finalize formula reads pure selections /
#:                   integer counters from the carry and is bitwise the
#:                   batch formulation;
#: ``stat_fold``   — the formula reads f32 statistics folded per bar:
#:                   mathematically the same, bounded per factor by
#:                   ``stream.fastpath.STAT_FOLD_BOUNDS``;
#: ``batch_only``  — anchored / rank-dependent / order-sensitive: the fast
#:                   path runs these through the same batch-prefix
#:                   finalize as ``finalize_impl='exact'``.
FINALIZE_CLASS_VALUES = ("exact_fold", "stat_fold", "batch_only")

#: kernel name -> finalize class; every registered kernel (built-in and
#: alias alike) must carry one (:func:`finalize_classes` fails loudly on
#: gaps, like :func:`stream_requirements`)
FINALIZE_CLASSES: Dict[str, str] = {}


def register(name: str):
    def deco(fn):
        FACTORS[name] = fn
        return fn
    return deco


def stream_requirement(name: str, counter: str, minimum: int = 1) -> None:
    """Declare the readiness requirement of a registered kernel (see
    :data:`STREAM_REQUIREMENTS`). ``counter`` must name a window counter
    of ``ops.incremental.WINDOW_COUNTERS``."""
    from ..ops.incremental import WINDOW_COUNTERS
    if counter not in WINDOW_COUNTERS:
        raise ValueError(f"unknown window counter {counter!r} for "
                         f"kernel {name!r}")
    STREAM_REQUIREMENTS[name] = (counter, int(minimum))


def stream_requirements() -> Dict[str, Tuple[str, int]]:
    """The full readiness map; raises if a canonical kernel declared
    none."""
    missing = [n for n in FACTORS if n not in STREAM_REQUIREMENTS]
    if missing:
        raise RuntimeError(
            f"kernels with no stream readiness requirement: {missing}")
    return dict(STREAM_REQUIREMENTS)


def finalize_class(name: str, cls: str) -> None:
    """Declare the finalize exactness class of a registered kernel (see
    :data:`FINALIZE_CLASSES`), next to the kernel."""
    if cls not in FINALIZE_CLASS_VALUES:
        raise ValueError(f"unknown finalize class {cls!r} for kernel "
                         f"{name!r} (valid: {FINALIZE_CLASS_VALUES})")
    FINALIZE_CLASSES[name] = cls


def finalize_classes() -> Dict[str, str]:
    """The finalize-class map over the canonical kernels and every
    alias; raises if one declared none."""
    missing = [n for n in FACTORS if n not in FINALIZE_CLASSES]
    missing += [n for n in ALIASES if n not in FINALIZE_CLASSES]
    if missing:
        raise RuntimeError(
            f"kernels with no finalize class: {missing}")
    return {n: FINALIZE_CLASSES[n]
            for n in (*FACTORS, *(n for n in ALIASES
                                  if n not in FACTORS))}


def register_alias(name: str, kernel) -> None:
    """Expose a kernel (an existing name or an ad-hoc ``fn(ctx)``) under a
    user-chosen factor name (MinFreqFactor's ``calculate_method=``).

    An alias is ``batch_only`` unless it already has a class: the fast
    formulas are keyed by the canonical name, so an alias of a foldable
    kernel rides the batch residual, and an ad-hoc ``fn(ctx)`` has no
    incremental form."""
    if isinstance(kernel, str):
        kernel = FACTORS[kernel]
    ALIASES[name] = kernel
    FINALIZE_CLASSES.setdefault(name, "batch_only")


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
                    inject: Optional[dict] = None,
                    session=None, xs_axis_name: Optional[str] = None):
    """Compute the named factors (default: all 58) over a day tensor.

    ``bars [..., T, S, 5]`` f32 and ``mask [..., T, S]`` bool, on one
    device; returns ``{name: [..., T]}`` on that device.
    ``rolling_impl`` picks the mmt_ols_* second-moment backend
    (``ops.rolling.ROLLING_IMPLS``; None reads ``Config.rolling_impl``).
    ``inject`` seeds the DayContext memo with carry-native intermediates
    (the streaming finalize; see DayContext). ``session`` (a
    ``markets.SessionSpec`` or registry name; None is ``cn_ashare_240``)
    sets the day shape and the sentinel boundaries. ``xs_axis_name``
    names the mesh axis the tickers dim is sharded over when this runs on
    one rank of a mesh (inside ``with mesh:``): per-(ticker, day) kernels
    are unaffected, only the ``doc_pdf*`` rank gathers (DayContext).
    """
    if names is None:
        names = tuple(FACTORS)
    ctx = DayContext(bars, mask, replicate_quirks=replicate_quirks,
                     rolling_impl=rolling_impl, inject=inject,
                     session=session, xs_axis_name=xs_axis_name)
    return {n: resolve(n)(ctx) for n in names}
