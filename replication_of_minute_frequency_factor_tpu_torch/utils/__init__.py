"""Host utilities: failure ledger, logging, stage timing, debug checks."""

from .logging import FailureReport, get_logger
from .tracing import Timer, trace_annotation

__all__ = ["FailureReport", "get_logger", "Timer", "trace_annotation"]
