"""Repo-wide readings for the two polars semantics that cannot be
verified without polars (the port's copy of the JAX package's
``pins.py``).

Each pin names a behavior of the reference's engine that its expression
text does not determine. Both readings of each are implemented; this
dict is the single registry the port's kernels consult
(ops/masked.py, ops/rolling.py). The readings are held equal to the JAX
package's by tests/test_torch_markets.py.

``constant_window`` — whether a constant window (limit-locked stock)
produces exactly-zero variance (``"degenerate"``, default: moments run
on first-observation-anchored series) or two-pass rounding noise
(``"noise"``).

``qcut_nan`` — whether group_test's qcut buckets a value-NaN exposure to
null (``"exclude"``, default) or to the top bin under polars' total
float order (``"top_bin"``). Read by the evaluation layer, which the
port has not reached yet; kept so the registry matches.
"""

from __future__ import annotations

READINGS = {
    "constant_window": "degenerate",  # or "noise"
    "qcut_nan": "exclude",            # or "top_bin"
}

_VALID = {
    "constant_window": ("degenerate", "noise"),
    "qcut_nan": ("exclude", "top_bin"),
}


def reading(name: str) -> str:
    return READINGS[name]


class pinned:
    """Context manager: temporarily select alternative readings.

    ``with pins.pinned(constant_window="noise"): ...``

    The port runs eagerly and reads the pins on every call, so there is
    no cache to clear.
    """

    def __init__(self, **overrides):
        for k, v in overrides.items():
            if v not in _VALID[k]:
                raise ValueError(f"{k}: unknown reading {v!r}")
        self._overrides = overrides

    def __enter__(self):
        self._saved = {k: READINGS[k] for k in self._overrides}
        READINGS.update(self._overrides)
        return self

    def __exit__(self, *exc):
        READINGS.update(self._saved)
        return False
