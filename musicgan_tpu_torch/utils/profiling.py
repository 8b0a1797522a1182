"""Tracing / profiling and debug-mode hooks (counterpart of the JAX
package's ``utils/profiling.py``).

* :func:`trace`: context manager around ``torch.profiler`` (CPU and, where
  a card is present, CUDA activity) writing a Chrome trace
  (``trace.json``, Perfetto opens it) into a directory;
* :class:`StepTimer`: wall-clock step timing with a percentile summary,
  synchronising with the card every ``sync_every`` steps so the time is
  the device's work, not its launches;
* :func:`enable_debug_mode`: the counterpart of ``jax_debug_nans``: every
  kernel wrapper checks its output (``ops/nan_check.py``) and raises
  ``FloatingPointError`` naming the op at the first non-finite value, and
  autograd's anomaly mode names the backward op that makes one.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Iterator

import torch

from ..ops import nan_check

__all__ = ["trace", "step_timer", "enable_debug_mode", "StepTimer", "TRACE_NAME"]

TRACE_NAME = "trace.json"


@contextlib.contextmanager
def trace(logdir: str) -> Iterator[torch.profiler.profile]:
    """Capture a trace: ``with trace("/tmp/trace"): step(...)`` writes
    ``/tmp/trace/trace.json``."""
    os.makedirs(logdir, exist_ok=True)
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(logdir, TRACE_NAME))


def enable_debug_mode(nans: bool = True, disable_jit: bool = False) -> None:
    """``nans``: check every kernel's output and turn on autograd's anomaly
    mode (one sync a launch, and a slower backward: for debugging only).
    ``disable_jit`` has no counterpart in an eager port and raises."""
    if disable_jit:
        raise ValueError(
            "disable_jit has no counterpart in musicgan_tpu_torch: it runs "
            "eagerly already (nothing is traced or compiled)"
        )
    if nans:
        torch.autograd.set_detect_anomaly(True)
        nan_check.ENABLED = True


class StepTimer:
    """Rolling step timer; ``sync_every`` forces a device sync so the
    measured time is real execution, not just the launches."""

    def __init__(self, sync_every: int = 50):
        self.sync_every = sync_every
        self.times: list[float] = []
        self._last = time.perf_counter()
        self._count = 0

    def tick(self, sync_value: torch.Tensor | None = None) -> float:
        self._count += 1
        if (
            sync_value is not None
            and self._count % self.sync_every == 0
            and sync_value.device.type == "cuda"
        ):
            torch.cuda.synchronize(sync_value.device)
        now = time.perf_counter()
        dt = now - self._last
        self._last = now
        self.times.append(dt)
        return dt

    def summary(self) -> dict:
        if not self.times:
            return {}
        xs = sorted(self.times)
        n = len(xs)
        return {
            "steps": n,
            "mean_ms": 1000 * sum(xs) / n,
            "p50_ms": 1000 * xs[n // 2],
            "p90_ms": 1000 * xs[int(n * 0.9)],
        }


def step_timer(sync_every: int = 50) -> StepTimer:
    return StepTimer(sync_every)
