"""The traced run: ``torch.profiler`` over the measured window, reduced to
what the per-layer readers need.

The device's busy time is the union of the intervals of its kernels and
copies inside the window, the arithmetic of the port's
``scripts/torch_profile_synthesis.py::busy_us`` (copied here; the script
stays as it is).  The window is the one the driver measures (its host
clock's ``time_ns`` at either end, the profiler's time base), so the idle
share counts every moment of the window in which nothing ran on the device,
the ramp at either end included.  The benchmark's own spans (``port_bench.*``)
are host events; the profiler's copies of them on the device's timeline are
left out.  A mix whose traffic file sets ``"trace_host_ops": false`` is
traced on the device only (kernels, copies and the CUDA runtime's calls),
for a host path that the recording of every operator would slow.
"""

from __future__ import annotations

import bisect
import contextlib
import dataclasses
from collections import defaultdict

import torch

__all__ = ["TraceData", "busy_s", "profiled", "reduce_events", "WINDOW_SPAN"]

WINDOW_SPAN = "port_bench.window"
SHORT_GAP_S = 20e-6  # gaps shorter than this are summed as "shorter_gaps"


def busy_s(intervals) -> float:
    """Length of the union of ``(start, end)`` intervals."""
    total, cur_s, cur_e = 0.0, None, None
    for s, e in sorted(intervals):
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        total += cur_e - cur_s
    return total


@dataclasses.dataclass
class TraceData:
    """Device and host events of the window, times in seconds from its
    start.  ``device``: ``(name, start, end)`` of every kernel and copy,
    clipped to the window; ``host``: the CPU events that overlap it."""

    window_s: float
    device: list
    host: list

    def kernels(self) -> list:
        return [d for d in self.device if not d[0].startswith(("Memcpy", "Memset"))]

    def copies(self, kind: str = "") -> list:
        """Copies whose name holds ``kind`` (``"DtoH"``, ``"HtoD"``, ...)."""
        return [d for d in self.device if d[0].startswith("Memcpy") and kind in d[0]]

    def busy_s(self) -> float:
        return busy_s((s, e) for _, s, e in self.device)

    def seconds_by_name(self) -> dict:
        out = defaultdict(float)
        for name, s, e in self.device:
            out[name] += e - s
        return dict(out)

    def idle_gaps(self) -> dict:
        """Seconds of the device's idle gaps by what the host was doing at
        each gap's midpoint (the innermost CPU event covering it); gaps
        shorter than ``SHORT_GAP_S`` summed as ``shorter_gaps``."""
        spans = sorted((s, e) for _, s, e in self.device)
        gaps, cursor = [], 0.0
        for s, e in spans:
            if s > cursor:
                gaps.append((cursor, s))
            cursor = max(cursor, e)
        if cursor < self.window_s:
            gaps.append((cursor, self.window_s))
        host = sorted(self.host, key=lambda h: h[1])
        starts = [h[1] for h in host]
        out = defaultdict(float)
        for a, b in gaps:
            if b - a < SHORT_GAP_S:
                out["shorter_gaps"] += b - a
                continue
            mid, name = (a + b) / 2, "no_host_span"
            i = bisect.bisect_right(starts, mid) - 1
            for j in range(i, max(i - 4000, -1), -1):
                if host[j][2] >= mid:
                    name = host[j][0]
                    break
            out[name] += b - a
        return dict(out)


def reduce_events(events, window_ns: tuple[int, int]) -> TraceData:
    """``TraceData`` of the window ``window_ns`` (``time.time_ns()`` at its
    ends) from raw profiler events (objects with ``name()``,
    ``device_type()``, ``start_ns()``, ``duration_ns()``)."""
    w0, w1 = window_ns
    cuda = torch.autograd.DeviceType.CUDA
    device, host = [], []
    for e in events:
        s, name = e.start_ns(), e.name()
        t = s + e.duration_ns()
        if t <= w0 or s >= w1:
            continue
        on_device = e.device_type() == cuda
        if on_device and (name.startswith("port_bench.") or getattr(e, "is_user_annotation", lambda: False)()):
            continue
        row = (name, (max(s, w0) - w0) * 1e-9, (min(t, w1) - w0) * 1e-9)
        (device if on_device else host).append(row)
    return TraceData((w1 - w0) * 1e-9, device, host)


@contextlib.contextmanager
def profiled(enabled: bool, host_ops: bool = True):
    """A profiler over the device (and the host's operators with
    ``host_ops``) while ``enabled``; yields a holder whose ``events`` are
    the raw events once the block has left."""

    class Holder:
        events = None

    holder = Holder()
    if not enabled:
        yield holder
        return
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA] if host_ops else [ProfilerActivity.CUDA]
    with profile(activities=acts) as prof:
        yield holder
    holder.events = prof.profiler.kineto_results.events()
