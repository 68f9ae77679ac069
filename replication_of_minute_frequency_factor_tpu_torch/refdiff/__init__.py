"""Differential testing of the reference's *actual code*, and the engine
of ``backend='polars'``: the port's copy of the repo's ``tools/refdiff``.

``polars_shim`` is a minimal interpreter for the polars expression API
surface the reference tree uses (all three files). ``harness`` makes it
resolvable as ``polars`` only for the duration of each reference exec
(hash-pinned to the audited snapshot), executes the real ``cal_*``
expression graphs on day data, and compares against the port's numpy
oracle, its evaluation and its driver.

Why a shim and not real polars: where no polars wheel can be installed
the reference cannot run on its real engine. The shim executes the
reference's own expression *graphs* (catching any transcription error in
our reimplementations — wrong column, wrong filter, wrong operation
order), while engine-level semantics polars doesn't spell out in the
expression text (null handling, tie-breaking, group order) are pinned
explicitly in one place (``polars_shim.SEMANTIC_PINS``). A real polars,
where one can be imported, is used instead.

The package is imported by a relative import, so the port's polars
backend needs no repo checkout: nothing here imports ``tools`` or the
JAX package.
"""
