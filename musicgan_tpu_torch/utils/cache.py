"""Where the port's built kernels live across processes (counterpart of
``musicgan_tpu/utils/cache.py``, the persistent compilation cache).

The port's compiled artifacts are the shared libraries that
``ops/_build.py`` (the CUDA kernels, ``nvcc``) and ``native/`` (the host
tail, ``g++``) build on first use, each under a name keyed by a hash of its
sources and flags.  By default they go to ``musicgan_tpu_torch/_build/``
(git-ignored), so a second process on the same checkout loads them instead
of building again.  ``MUSICGAN_COMPILE_CACHE`` points both at another
directory; ``MUSICGAN_NO_COMPILE_CACHE=1`` opts out, and the process then
builds into a fresh temporary directory of its own.
"""

from __future__ import annotations

import atexit
import os
import shutil
import tempfile
from pathlib import Path

import torch

__all__ = ["enable_compilation_cache"]


def _set_build_dir(path: str) -> None:
    from .. import native
    from ..ops import _build

    _build.BUILD_DIR = Path(path)
    native.BUILD_DIR = path


def enable_compilation_cache(path: str | None = None) -> str | None:
    """Point the kernel builds at a persistent directory and return it, as
    JAX's does for the accelerator platforms only.

    Without a CUDA device this does nothing unless a path is forced (the
    argument or ``MUSICGAN_COMPILE_CACHE``): no kernel builds there, and the
    default ``_build/`` already holds the host tail.  With a device the
    default is ``musicgan_tpu_torch/_build/``.  ``MUSICGAN_NO_COMPILE_CACHE``
    wins over everything: the builds go to a temporary directory of this
    process, removed at its exit, and the result is None."""
    if os.environ.get("MUSICGAN_NO_COMPILE_CACHE"):
        tmp = tempfile.mkdtemp(prefix="musicgan_build_")
        atexit.register(shutil.rmtree, tmp, ignore_errors=True)
        _set_build_dir(tmp)
        return None
    forced = path or os.environ.get("MUSICGAN_COMPILE_CACHE")
    if not forced and not torch.cuda.is_available():
        return None
    from ..ops import _build

    path = forced or str(_build.DEFAULT_BUILD_DIR)
    os.makedirs(path, exist_ok=True)
    _set_build_dir(path)
    return path
