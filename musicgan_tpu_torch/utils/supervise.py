"""Supervised restart for transient device failures (counterpart of the JAX
package's ``utils/supervise.py``).

When a training child exits with :data:`~musicgan_tpu_torch.utils.watchdog.EXIT_STALLED`
(a wedged device, a preemption signal caught and flushed) or dies on a
signal, the shape of a preempted host, the supervisor relaunches it,
resuming from the latest checkpoint.  Any other exit status is returned
unchanged: a real crash (assertion, NaN check, bad config) must NOT be
retried into a loop.

Used by ``python -m musicgan_tpu_torch train --max-restarts N`` (the parent
process becomes the supervisor and re-invokes the CLI with ``--resume``,
``__main__.py::supervised_train_cmd``) and directly by scripts.
"""

from __future__ import annotations

import subprocess
import sys
import time
from typing import Callable, Sequence

from .watchdog import EXIT_STALLED

__all__ = ["run_supervised"]


def run_supervised(
    make_cmd: Callable[[int], Sequence[str]],
    max_restarts: int,
    retry_codes: Sequence[int] = (EXIT_STALLED,),
    retry_signals: bool = True,
    backoff_s: float = 30.0,
    max_backoff_s: float = 300.0,
    env: dict | None = None,
    _sleep=time.sleep,  # injectable for tests
    _run=subprocess.run,
) -> int:
    """Run ``make_cmd(attempt)`` as a child process, restarting on
    retryable failures; returns the final exit status.

    ``make_cmd`` receives the attempt index (0 = first run) so callers
    can e.g. add ``--resume`` only from attempt 1 on.  ``retry_signals``
    also retries negative returncodes (child killed by a signal: what a
    host preemption or OOM kill looks like).  Backoff doubles per
    consecutive failure up to ``max_backoff_s``: a down device needs
    minutes, not a tight relaunch spin.
    """
    attempt = 0
    delay = backoff_s
    while True:
        cmd = list(make_cmd(attempt))
        rc = _run(cmd, env=env).returncode
        if rc == 0:
            return 0
        retryable = rc in retry_codes or (retry_signals and rc < 0)
        if not retryable or attempt >= max_restarts:
            if retryable and attempt >= max_restarts:
                print(
                    f"[supervise] retryable exit {rc} but restart budget "
                    f"({max_restarts}) exhausted; giving up",
                    file=sys.stderr,
                    flush=True,
                )
            return rc
        attempt += 1
        print(
            f"[supervise] child exited {rc} (retryable); restart "
            f"{attempt}/{max_restarts} in {delay:.0f}s",
            file=sys.stderr,
            flush=True,
        )
        _sleep(delay)
        delay = min(delay * 2, max_backoff_s)
