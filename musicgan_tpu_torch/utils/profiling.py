"""Tracing / profiling and debug-mode hooks (counterpart of the JAX
package's ``utils/profiling.py``).

* :func:`trace`: context manager around ``torch.profiler`` (CPU and, where
  a card is present, CUDA activity) writing a Chrome trace
  (``trace.json``, Perfetto opens it) into a directory;
* :class:`span`: the program's own spans at its layer boundaries (the
  ``mg.*`` names), kept in memory while a profiler records, inside
  :func:`recording`, or always for a span opened with ``always=True``;
  :func:`spans` reads them and :func:`to_profiler_ns` puts their times on
  the profiler's clock;
* :func:`enable_debug_mode`: the counterpart of ``jax_debug_nans``: every
  kernel wrapper checks its output (``ops/nan_check.py``) and raises
  ``FloatingPointError`` naming the op at the first non-finite value, and
  autograd's anomaly mode names the backward op that makes one.

A span is ``Span(name, parent, t0_ns, t1_ns, thread_id, index)``: its
times on ``time.perf_counter_ns()``, ``parent`` the ``index`` of the span
that encloses it on the same thread (None for a root), so that every span
of one call or one iteration shares its root's index.  The last
``CAPACITY`` spans are kept; :func:`dropped` counts the older ones let go.
While the profiler is on, a span is also a ``record_function`` of the
same name, so a trace shows it on the profiler's own timeline.
"""

from __future__ import annotations

import contextlib
import itertools
import os
import threading
import time
from collections import deque
from typing import Iterator, NamedTuple, Optional

import torch

__all__ = [
    "trace", "enable_debug_mode", "TRACE_NAME", "Span", "span", "recording", "spans", "clear_spans", "dropped",
    "to_profiler_ns", "CAPACITY",
]

TRACE_NAME = "trace.json"
CAPACITY = 65_536


class Span(NamedTuple):
    name: str
    parent: Optional[int]
    t0_ns: int
    t1_ns: int
    thread_id: int
    index: int


_SPANS: deque = deque(maxlen=CAPACITY)
_LOCK = threading.Lock()
_IDS = itertools.count()


class _Local(threading.local):
    def __init__(self):
        self.stack = []  # the indices of this thread's open spans


_LOCAL = _Local()
_state = {"dropped": 0, "recording": 0}
_profiler_enabled = torch.autograd._profiler_enabled


def _offset_ns() -> int:
    """``time.time_ns()`` (the profiler's time base) less
    ``time.perf_counter_ns()``, read between two perf-counter reads."""
    a = time.perf_counter_ns()
    wall = time.time_ns()
    return wall - (a + time.perf_counter_ns()) // 2


_OFFSET_NS = _offset_ns()


def to_profiler_ns(t_ns: int) -> int:
    """A span's perf-counter time on the profiler's clock."""
    return t_ns + _OFFSET_NS


class span:
    """``with span("mg.train.critic"): ...`` records the block as a span
    while a profiler records (``torch.autograd._profiler_enabled()``), inside
    :func:`recording`, or with ``always`` (cold paths only: builds,
    measurements).  ``t0_ns`` gives the span an earlier start than its
    ``with`` (a perf-counter time), for work that began on another call.
    Otherwise it costs one check."""

    __slots__ = ("name", "always", "t0_ns", "_on", "_rf", "_parent", "_index", "_t0")

    def __init__(self, name: str, always: bool = False, t0_ns: Optional[int] = None):
        self.name, self.always, self.t0_ns = name, always, t0_ns

    def __enter__(self) -> "span":
        profiler = _profiler_enabled()
        self._on = profiler or self.always or _state["recording"] > 0
        if not self._on:
            return self
        stack = _LOCAL.stack
        self._parent = stack[-1] if stack else None
        self._index = next(_IDS)
        stack.append(self._index)
        # Both ends are read just after the profiler's event reads its own,
        # so that span and event line up on the profiler's clock: the slow
        # part of entering or leaving a record_function comes before its
        # clock read.
        self._rf = torch.profiler.record_function(self.name) if profiler else None
        if self._rf is not None:
            self._rf.__enter__()
        self._t0 = time.perf_counter_ns() if self.t0_ns is None else self.t0_ns
        return self

    def __exit__(self, *exc) -> None:
        if not self._on:
            return
        if self._rf is not None:
            self._rf.__exit__(*exc)
        t1 = time.perf_counter_ns()
        _LOCAL.stack.pop()
        record = Span(self.name, self._parent, self._t0, t1, threading.get_ident(), self._index)
        with _LOCK:
            if len(_SPANS) == CAPACITY:
                _state["dropped"] += 1
            _SPANS.append(record)


@contextlib.contextmanager
def recording() -> Iterator[None]:
    """Record every span inside the block, in every thread, with no
    profiler on (tests; an operator's look at one call)."""
    with _LOCK:
        _state["recording"] += 1
    try:
        yield
    finally:
        with _LOCK:
            _state["recording"] -= 1


def spans() -> list:
    """The spans kept, in the order they ended."""
    with _LOCK:
        return list(_SPANS)


def dropped() -> int:
    """Spans let go since the last :func:`clear_spans`, oldest first, to
    keep ``CAPACITY``."""
    return _state["dropped"]


def clear_spans() -> None:
    with _LOCK:
        _SPANS.clear()
        _state["dropped"] = 0


@contextlib.contextmanager
def trace(logdir: str) -> Iterator[torch.profiler.profile]:
    """Capture a trace: ``with trace("/tmp/trace"): step(...)`` writes
    ``/tmp/trace/trace.json``, the ``mg.*`` spans among its events."""
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
    from ..ops import nan_check

    if disable_jit:
        raise ValueError(
            "disable_jit has no counterpart in musicgan_tpu_torch: it runs "
            "eagerly already (nothing is traced or compiled)"
        )
    if nans:
        torch.autograd.set_detect_anomaly(True)
        nan_check.ENABLED = True
