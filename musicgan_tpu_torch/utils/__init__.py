"""Utilities: metrics logging and the stall watchdog."""

from .metrics import MetricLogger
from .watchdog import EXIT_STALLED, StallWatchdog

__all__ = ["EXIT_STALLED", "MetricLogger", "StallWatchdog"]
