"""Shared measurement primitives of the port's timing harnesses
(counterpart of ``musicgan_tpu/utils/timing.py``).

The autotuner (``ops/autotune.py``) times its candidates with these.
Methodology: the work is queued on the device, the dispatch ends where the
host waits for it (:func:`_wait`: ``torch.cuda.synchronize()`` on a CUDA
device, the same as fetching one scalar with ``.item()``), and the
separately measured scalar round trip (:func:`scalar_rtt`) is subtracted,
clamped so that jitter never makes a measurement negative.  On the CPU the
work runs as it is called and the same clock reads it.
"""

from __future__ import annotations

import time

import torch

__all__ = ["scalar_rtt"]


def _wait(device: torch.device) -> None:
    """End a dispatch: wait for the device's queued work."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def scalar_rtt(reps: int = 5, device: str | torch.device = "cuda") -> float:
    """Round trip of a trivial one-scalar dispatch (a launch, then the host
    reads the value back): the constant every dispatch timing subtracts.
    Tens of microseconds on a local card."""
    device = torch.device(device)
    x = torch.zeros((), device=device)
    (x + 1.0).item()  # first launch and allocation outside the timed loop
    t0 = time.perf_counter()
    for _ in range(reps):
        (x + 1.0).item()
    return (time.perf_counter() - t0) / reps
