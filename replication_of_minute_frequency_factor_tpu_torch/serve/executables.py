"""Keyed cache of built callables, with build-once semantics.

The port of the JAX package's ``serve/executables.py``. There an entry is
an AOT-compiled XLA executable and a miss compiles; torch compiles
nothing, so an entry is the engine's callable bound to everything that
shapes it (universe, factor names, quirks, rolling backend, session,
finalize, the ingest shape, the result-wire spec), and a miss binds it.
The counters keep their names: ``serve.executables{outcome=hit|miss}``
counts the keys looked up and added, and the gauge
``serve.executables_resident`` counts the entries. A miss builds
nothing: what torch really builds (``nvcc`` runs and kernel-library
loads) is :func:`..kernels.build_count`, the port's form of the JAX
gate ``xla.compiles == 0``.
"""

from __future__ import annotations

import threading
from typing import Callable, Dict, Hashable


class ExecutableCache:
    """Hashable key -> built callable, each built once.

    ``get(label, key, build_fn)`` returns the cached callable for ``key``
    or builds it once with ``build_fn()``. Builds are serialized under one
    lock (a second caller with the same key waits for the first build);
    hits are lock-scoped dict reads."""

    def __init__(self, telemetry=None):
        self._lock = threading.Lock()
        self._exes: Dict[Hashable, Callable] = {}
        self._telemetry = telemetry

    def _tel(self):
        if self._telemetry is not None:
            return self._telemetry
        from ..telemetry import get_telemetry
        return get_telemetry()

    def __len__(self) -> int:
        with self._lock:
            return len(self._exes)

    def get(self, label: str, key: Hashable,
            build_fn: Callable[[], Callable]) -> Callable:
        """The callable for ``key``, built once via ``build_fn()``."""
        tel = self._tel()
        with self._lock:
            exe = self._exes.get(key)
            if exe is not None:
                tel.counter("serve.executables", outcome="hit")
                return exe
            tel.counter("serve.executables", outcome="miss")
            exe = build_fn()
            self._exes[key] = exe
            tel.gauge("serve.executables_resident", len(self._exes))
            return exe
