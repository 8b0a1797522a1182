"""Device-stall failure detection (counterpart of
``musicgan_tpu/utils/watchdog.py``; SURVEY.md §5: failure detection).

A wedged accelerator (a hung kernel, a lost device) leaves
the thread that next reads the device blocked inside the CUDA runtime:
Python cannot cancel or time-bound a pending synchronisation, so the train
loop just stops making progress with ~0% CPU.

The standard large-scale recovery is crash-and-resume: *detect* the
stall, exit with a retryable status, and let a supervisor restart the
job from its latest checkpoint (training here checkpoints every
``save_every`` iterations and resumes exactly).  This module is the
detector; exit code ``EXIT_STALLED`` (75, BSD ``EX_TEMPFAIL``) is the
contract with whatever supervises the process.

The train loop calls :meth:`StallWatchdog.beat` at every point where it
has *evidence of device progress*: after metric fetches and checkpoint
writes, i.e. real device->host copies.  Kernel launches are asynchronous
and would beat even against a dead device, so they don't count.  The
timeout must therefore exceed the worst honest beat interval:
``log_every`` x step-time plus the kernels' first build; the 900 s default
used by the CLI covers both with margin.
"""

from __future__ import annotations

import faulthandler
import os
import sys
import threading
import time

__all__ = [
    "EXIT_STALLED",
    "StallWatchdog",
    "beat_active",
    "is_distributed_failure",
    "is_runtime_error",
]

# BSD sysexits EX_TEMPFAIL: "temporary failure, retry is reasonable".
EXIT_STALLED = 75

# The process's enabled watchdog, so that long device phases outside the
# train loop's fetches can witness their own progress: the autotuner's
# measurement at a stage's first step times several train graphs (and may
# build kernels), honest work during which the loop fetches nothing.
# Without beats a healthy measurement would be killed as a stall, and since
# the winner persists only after every candidate finished, a supervised
# restart would enter the same boundary again until --max-restarts ran out.
_ACTIVE: "StallWatchdog | None" = None


def beat_active() -> None:
    """Beat the process's enabled watchdog, if any (no-op otherwise)."""
    wd = _ACTIVE
    if wd is not None:
        wd.beat()

# When the coordinator (or a peer) dies, surviving processes don't stall
# silently — their next collective/dispatch errors with a gRPC-flavored
# runtime failure.  Those deaths are exactly as retryable as a stall (the
# supervisor relaunches with --resume), but an ordinary rc-1 crash is not,
# so the train CLI maps only exceptions matching these markers to
# EXIT_STALLED.  The markers are the JAX package's (substrings of
# distributed-runtime messages: heartbeats, barrier timeouts, channel
# teardown), kept whole so that both packages call the same failures
# retryable, then torch.distributed's own; NCCL's and the CUDA runtime's
# ("unavailable", "connection reset", "shutting down") are among them.
_DIST_FAILURE_MARKERS = (
    "coordination service",
    "coordinationservice",
    "heartbeat",
    "deadline_exceeded",
    "deadline exceeded",
    "unavailable",
    "barrier",
    "socket closed",
    "connection reset",
    "connection refused",
    "failed to connect",
    "broken pipe",
    "shutting down",
    "preempt",
    # CPU collectives ride Gloo; when a peer dies mid-run the survivor's
    # next collective raises "Gloo context initialization failed: ...
    # Connect timeout".  The prefix alone covers that message; a bare
    # "connect timeout" marker would also swallow unrelated client
    # timeouts (HTTP/MLflow).
    "gloo context initialization failed",
    # torch.distributed: its error classes by name (a collective that
    # failed in the backend or the network, a store that lost its peer),
    # gloo's messages when a peer's socket goes ("Connection closed by
    # peer"; "Connection reset by peer" is matched above), the NCCL
    # watchdog's timeout of a collective, and the TCPStore's timeout when
    # a peer never comes back to the rendezvous.
    "distbackenderror",
    "distnetworkerror",
    "diststoreerror",
    "connection closed by peer",
    "collective operation timeout",
    "waiting for clients",
)


def is_runtime_error(exc: BaseException) -> bool:
    """Is ``exc`` a CUDA *runtime* error (the class a device's death
    surfaces as), as opposed to an ordinary Python exception whose
    message merely contains a distributed-failure marker?  Single-host
    retryable-exit mapping requires this so e.g. a BrokenPipeError from a
    closed preview stream keeps propagating as a real crash.

    PyTorch raises ``torch.AcceleratorError`` where it has that class, and
    a plain ``RuntimeError`` whose message names the CUDA (or cuDNN, NCCL)
    error elsewhere, as this package's kernel launcher does."""
    import torch

    accel = getattr(torch, "AcceleratorError", None)
    if accel is not None and isinstance(exc, accel):
        return True
    if type(exc).__name__ == "AcceleratorError":
        return True
    if not isinstance(exc, RuntimeError):
        return False
    s = str(exc)
    return any(m in s for m in ("CUDA error", "cuDNN error", "NCCL error"))


def is_distributed_failure(exc: BaseException) -> bool:
    """Heuristic: does ``exc`` look like the distributed runtime dying
    under us (lead/peer death, coordination-service loss) rather than a
    bug in this process?  The train loop maps such failures to
    :data:`EXIT_STALLED` so that a supervisor relaunches the run; on one
    host the exception must also be :func:`is_runtime_error`."""
    s = f"{type(exc).__name__}: {exc}".lower()
    return any(m in s for m in _DIST_FAILURE_MARKERS)


class StallWatchdog:
    """Daemon-thread stall detector.  ``timeout_s <= 0`` disables it
    entirely (no thread is started; ``beat``/``close`` are no-ops).

    Starts DISARMED: the clock only runs after the first ``beat()``
    (arming at construction would count process startup, the corpus
    upload and the kernels' build against the steady-state timeout).

    On expiry it dumps all thread stacks (so the wedged frame is
    visible in the log) and ``os._exit``\\ s with :data:`EXIT_STALLED`.
    ``os._exit`` rather than an exception on purpose: the stalled thread
    is *blocked in C* and will never see a Python exception; only the
    process dying releases the device so a restart can claim it.
    """

    def __init__(
        self,
        timeout_s: float,
        poll_s: float = 5.0,
        _exit=os._exit,  # injectable for tests
        _stream=None,
    ):
        self.timeout_s = float(timeout_s)
        self._poll_s = min(poll_s, max(0.01, self.timeout_s / 4 or poll_s))
        self._exit = _exit
        self._stream = _stream  # default sys.stderr, resolved at fire time
        self._last: float | None = None  # None = disarmed
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None
        if self.timeout_s > 0:
            global _ACTIVE
            _ACTIVE = self  # the latest enabled instance wins (one per run)
            self._thread = threading.Thread(
                target=self._watch, name="musicgan-stall-watchdog", daemon=True
            )
            self._thread.start()

    # -- train-loop surface -------------------------------------------------
    def beat(self) -> None:
        """Record evidence of device progress (arms the clock)."""
        if self._thread is None:
            return
        with self._lock:
            self._last = time.monotonic()

    def disarm(self) -> None:
        """Stop the clock without stopping the thread (e.g. around a
        deliberately long host-only phase)."""
        with self._lock:
            self._last = None

    def close(self) -> None:
        """Shut the detector down (end of training)."""
        global _ACTIVE
        if _ACTIVE is self:
            _ACTIVE = None
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=2 * self._poll_s)
            self._thread = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False

    # -- detector -----------------------------------------------------------
    def _watch(self) -> None:
        while not self._stop.wait(self._poll_s):
            with self._lock:
                last = self._last
            if last is None:
                continue
            age = time.monotonic() - last
            if age > self.timeout_s:
                stream = self._stream or sys.stderr
                print(
                    f"[watchdog] no device progress for {age:.0f}s "
                    f"(timeout {self.timeout_s:.0f}s) — assuming a wedged "
                    f"accelerator dispatch; exiting {EXIT_STALLED} for "
                    "supervised restart from the latest checkpoint. "
                    "Thread stacks follow.",
                    file=stream,
                    flush=True,
                )
                try:
                    faulthandler.dump_traceback(file=stream)
                    stream.flush()
                except Exception:
                    pass
                self._exit(EXIT_STALLED)
                return  # only reached with an injected _exit (tests)
