"""The kernels' non-finite check of ``train --debug-nans`` (the counterpart
of JAX's ``jax_debug_nans``, set by ``utils/profiling.py::enable_debug_mode``).

While :data:`ENABLED` is True every kernel wrapper of ``ops/`` passes its
output through :func:`checked`, on the kernel's branch and on the plain
version's, which raises ``FloatingPointError`` naming the op at the first
non-finite value.  The check costs one ``torch.isfinite(...).all()`` and a
sync with the host per call, and runs only while enabled: off, a wrapper
launches nothing more.
"""

from __future__ import annotations

import torch

__all__ = ["ENABLED", "checked"]

ENABLED = False


def checked(name: str, out):
    """``out`` (a tensor or a tuple of tensors), after the check if enabled."""
    if ENABLED:
        for t in out if isinstance(out, tuple) else (out,):
            if not bool(torch.isfinite(t).all()):
                raise FloatingPointError(
                    f"{name}: non-finite value in its output (debug-nans mode)"
                )
    return out
