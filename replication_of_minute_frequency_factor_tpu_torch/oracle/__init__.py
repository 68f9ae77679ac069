"""CPU oracle backend: reference (polars) semantics in numpy/pandas, f64.

The port's copy of the JAX package's ``oracle/`` (host code, no torch),
on the port's ``markets`` and ``pins``; tests/test_torch_oracle.py holds
it to the JAX package's bit for bit.

This is an *independent* second implementation of the 58 factor kernels,
written against the long-format row layout the reference consumes
(SURVEY.md §2.3) rather than the dense grid — so the golden-parity suite
(SURVEY.md §4 item 1) compares two genuinely different code paths. It also
serves as the framework's ``backend='numpy'`` execution path (the container
has no polars).

Quirks Q1-Q7 are replicated bit-for-bit; nondeterministic orderings (Q7,
paratio group order) are pinned to the same deterministic choice as the JAX
backend (ascending value / session order).
"""

from .kernels import ORACLE_FACTORS, compute_oracle  # noqa: F401
