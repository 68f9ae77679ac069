"""Structured logging + failure reporting.

The port's copy of the JAX package's ``utils/logging.py``. Failures
aggregate into a structured report attached to pipeline results so a
batch run can be audited after the fact.
"""

from __future__ import annotations

import dataclasses
import logging
import traceback
from typing import List

_CONFIGURED = False


def get_logger(name: str) -> logging.Logger:
    global _CONFIGURED
    if not _CONFIGURED:
        h = logging.StreamHandler()
        h.setFormatter(logging.Formatter(
            "%(asctime)s %(levelname)s %(name)s: %(message)s"))
        root = logging.getLogger(
            "replication_of_minute_frequency_factor_tpu_torch")
        if not root.handlers:
            root.addHandler(h)
            root.setLevel(logging.INFO)
        _CONFIGURED = True
    return logging.getLogger(name)


@dataclasses.dataclass
class Failure:
    key: str          # e.g. the trading date
    source: str       # e.g. the file path
    error: str
    trace: str


class FailureReport:
    """Per-task failure isolation ledger: a failed day is recorded with
    its error and traceback instead of vanishing."""

    def __init__(self):
        self.failures: List[Failure] = []

    def record(self, key: str, source: str, exc: BaseException) -> None:
        self.failures.append(Failure(
            key=key, source=source, error=f"{type(exc).__name__}: {exc}",
            trace=traceback.format_exc()))

    def __len__(self) -> int:
        return len(self.failures)

    def __bool__(self) -> bool:
        return bool(self.failures)

    def keys(self) -> List[str]:
        return [f.key for f in self.failures]

    def summary(self) -> str:
        if not self.failures:
            return "no failures"
        lines = [f"{len(self.failures)} failed:"]
        lines += [f"  {f.key} ({f.source}): {f.error}" for f in self.failures]
        return "\n".join(lines)

    def save(self, path: str, carried=()) -> None:
        """Write the ledger as JSON (one record per failed day) so a
        skipped day is inspectable after the run, not just a log line.

        ``carried`` are prior-ledger records (dicts) for days this run
        did NOT reattempt — they are still lost and must stay on the
        ledger, or a later clean run would erase the only pointer
        ``retry_failed`` has to them."""
        import json
        with open(path, "w") as fh:
            json.dump(list(carried)
                      + [{"key": f.key, "source": f.source,
                          "error": f.error, "trace": f.trace}
                         for f in self.failures], fh, indent=1)
