"""graftlint — static contract analysis of the port's 58-kernel engine.

The port of the JAX package's ``analysis/`` (three tiers, the same rule
codes and report keys):

* **Tier A** (:mod:`.ast_tier`) — a rule engine over the package's
  Python AST, in torch terms: torch attributes that don't exist on the
  installed torch, Python loops over tensor extents in the kernel
  layers, host syncs (``.item()``, ``.cpu()``, ``nonzero``, ...) in
  device-hot modules outside their declared boundary symbols, unpaired
  ``start_trace``-style acquisitions, raw ``torch.mean``/``std`` where
  ``ops.masked`` reductions are mandated, and the finalize-class
  declarations.
* **Tier B** (:mod:`.trace_tier`) — runs every registered kernel at the
  canonical ``(days, tickers, 240)`` shape under an ATen op recorder
  (``TorchDispatchMode``): op counts that grow with the data (a Python
  loop over it), float64 ops, host syncs, plus a per-kernel op-count
  fingerprint written to ``analysis_report_torch.json`` so graph drift
  is diffable in review; the hand-written kernels' launches under
  ``kernel:second_moments`` and ``kernel:pv_corr``.
* **Tier C** (:mod:`.concurrency_tier`) — the JAX package's
  lock-discipline and thread-lifecycle rules GL-C1..GL-C4, a copy, over
  the port's ``GLC_CONTRACT`` declarations.

Accepted violations live in the committed :data:`BASELINE_PATH`
(:mod:`.violations`), each with a mandatory written justification.
Run it: ``python -m replication_of_minute_frequency_factor_tpu_torch
analyze`` (``--device cpu`` traces on the CPU). Nothing here imports jax
or the JAX package; the JAX package's files can be scanned as text.
"""

from __future__ import annotations

from .violations import BASELINE_PATH, Baseline, Violation
from .ast_tier import run_ast_tier
from .concurrency_tier import run_concurrency_tier
from .trace_tier import run_trace_tier
from .report import build_report, manifest_block, write_report

__all__ = [
    "BASELINE_PATH", "Baseline", "Violation", "build_report",
    "manifest_block", "run_ast_tier", "run_concurrency_tier",
    "run_trace_tier", "write_report",
]
