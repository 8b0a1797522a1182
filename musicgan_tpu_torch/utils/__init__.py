"""Utilities: metrics logging, the stall watchdog, supervised restart
(``supervise``) and tracing / debug mode (``profiling``)."""

from .metrics import MetricLogger
from .watchdog import EXIT_STALLED, StallWatchdog

__all__ = ["EXIT_STALLED", "MetricLogger", "StallWatchdog"]
