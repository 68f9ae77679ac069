"""PyTorch/CUDA port of the minute-frequency factor framework.

A package of its own beside the JAX package
(``replication_of_minute_frequency_factor_tpu``), which stays the
reference: the same module layout and names, written in torch, with the
JAX package's Pallas TPU kernel rewritten by hand for Hopper (``csrc/``).
It imports neither jax nor the JAX package.

Ported so far: session specs, pins and config, gridding and synthetic
days, the masked/top-k/rolling ops, ``DayContext`` and 47 of the 58
factors (all but the chip family), with :func:`compute_batch` as the
batch entry point. Entry points run on the card unless the caller passes
``device='cpu'``.
"""

from .pipeline import compute_batch  # noqa: F401
