"""Shared measurement primitives of the port's timing harnesses
(counterpart of ``musicgan_tpu/utils/timing.py``).

The autotuner (``ops/autotune.py``) and any script that ranks or reports
device work use the same three measurements, so that their numbers are
comparable.  Methodology: the work is queued on the device, the dispatch
ends where the host waits for it (``torch.cuda.synchronize()`` on a CUDA
device, the same as fetching one scalar with ``.item()``), and the
separately measured scalar round trip is subtracted, clamped so that jitter
never makes a measurement negative.  On the CPU the work runs as it is
called and the same clock reads it.
"""

from __future__ import annotations

import time

import torch

__all__ = ["scalar_rtt", "time_dispatch", "measure_peak_tflops"]


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


def time_dispatch(fn, *args, reps: int = 3, rtt: float = 0.0, device: str | torch.device = "cuda") -> float:
    """Best-of-``reps`` wall seconds of one dispatch of ``fn(*args)`` on
    ``device``, after one warm-up call (builds, first launches), less
    ``rtt`` but clamped to half the raw time (the round trip is jittery;
    the correction must never dominate, let alone go negative)."""
    device = torch.device(device)
    fn(*args)
    _wait(device)
    best = float("inf")
    for _ in range(reps):
        t0 = time.perf_counter()
        fn(*args)
        _wait(device)
        best = min(best, time.perf_counter() - t0)
    return max(best - rtt, 0.5 * best)


def measure_peak_tflops(
    dtype: torch.dtype = torch.float32,
    rtt: float = 0.0,
    precision: str | None = None,
    n: int = 2048,
    depth: int = 64,
    reps: int = 3,
    device: str | torch.device = "cuda",
) -> float:
    """Measured matrix-product rate of this run's card, TFLOP/s: an ``n x
    n`` product chained ``depth`` deep in one dispatch (``tanh`` between
    the links keeps the values bounded and is noise next to the ``n^3``
    term).  ``precision`` is ``torch.set_float32_matmul_precision``'s
    argument for the call only, restored afterwards: ``"highest"`` keeps
    float32 products in float32, ``"high"`` lets them run in TF32 on the
    tensor cores; ``None`` leaves the process's setting."""
    device = torch.device(device)
    a = torch.full((n, n), 0.5, dtype=dtype, device=device)
    b = torch.full((n, n), 0.001, dtype=dtype, device=device)

    def chain():
        c = a
        for _ in range(depth):
            c = torch.tanh(c @ b)
        return c.float().sum()

    before = torch.get_float32_matmul_precision()
    if precision is not None:
        torch.set_float32_matmul_precision(precision)
    try:
        dt = time_dispatch(chain, reps=reps, rtt=rtt, device=device)
    finally:
        torch.set_float32_matmul_precision(before)
    return 2.0 * n**3 * depth / dt / 1e12
