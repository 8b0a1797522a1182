"""Native (C++) host-side ops, bound via ctypes (counterpart of the JAX
package's ``native`` module).

The device compute is CUDA; this package holds the native pieces of the
HOST side: the fused ingest tail (``host_ops.cpp::mg_magn_phase_pack``),
which replaces ~12 numpy passes of the pure-Python mirror
(``audio/ingest.py``) with two fused passes.  ``host_ops.cpp`` here is the
port's own copy of the JAX package's source, byte for byte (a test holds
the two together); nothing of the JAX package is read at run time.

The shared library is compiled on first use with ``g++ -O3 -march=native``
into ``musicgan_tpu_torch/_build/``, under a name keyed by a hash of the
source and the flags (as ``ops/_build.py`` keys the ``.cu`` libraries), so a
changed source or flag builds anew and nothing is written beside the
source.  If no compiler is available or the build fails,
``is_available()`` is False and ``audio.ingest.process_signal``'s
``"auto"`` backend takes the numpy path.  No pybind11: the ABI is plain C.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading

import numpy as np

__all__ = [
    "is_available", "magn_phase_pack", "PackStream", "build", "lib_path",
]

_DIR = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_DIR, "host_ops.cpp")
BUILD_DIR = os.path.join(os.path.dirname(_DIR), "_build")
# ``-fno-math-errno`` only, NOT ``-ffast-math``, which would break the
# exact wrap-edge semantics the parity tests pin down.
CXX_FLAGS = ("-O3", "-march=native", "-fno-math-errno", "-shared", "-fPIC")
_LOCK = threading.Lock()
_LIB: ctypes.CDLL | None = None
_FAILED = False


def lib_path() -> str:
    """``_build/libmusicgan_host-<hash>.so``, the hash over the flags and
    the source."""
    h = hashlib.sha256(" ".join(CXX_FLAGS).encode())
    with open(_SRC, "rb") as f:
        h.update(f.read())
    return os.path.join(BUILD_DIR, f"libmusicgan_host-{h.hexdigest()[:16]}.so")


def build(force: bool = False) -> str:
    """Compile host_ops.cpp -> ``lib_path()``; returns the .so path.

    Raises ``RuntimeError`` on compiler failure (callers catch it)."""
    so = lib_path()
    if not force and os.path.exists(so):
        return so
    os.makedirs(BUILD_DIR, exist_ok=True)
    # Per-process tmp name: create_dataset starts N workers that may all
    # build on a fresh host concurrently.  Each compiles to its own file
    # and promotes with an atomic os.replace: last writer wins, every
    # candidate is a complete .so (a SHARED tmp path lets concurrent g++
    # runs truncate each other mid-write and promote garbage).
    tmp = f"{so}.{os.getpid()}.tmp"
    cmd = ["g++", *CXX_FLAGS, "-o", tmp, _SRC]
    try:
        proc = subprocess.run(
            cmd, capture_output=True, text=True, timeout=300
        )
        if proc.returncode != 0:
            raise RuntimeError(f"native build failed:\n{proc.stderr}")
        os.replace(tmp, so)
    except (OSError, subprocess.TimeoutExpired) as e:
        raise RuntimeError(f"native build failed to launch: {e!r}") from e
    finally:
        try:
            os.unlink(tmp)
        except OSError:
            pass
    return so


def _load() -> ctypes.CDLL | None:
    global _LIB, _FAILED
    if _LIB is not None or _FAILED:
        return _LIB
    with _LOCK:
        if _LIB is not None or _FAILED:
            return _LIB
        lib = None
        for force in (False, True):
            try:
                lib = ctypes.CDLL(build(force=force))
                lib.mg_pack_begin  # symbol probe
            except (RuntimeError, OSError, AttributeError):
                # A truncated or corrupt .so under the right name (a copy
                # cut short) fails to load or lacks symbols: drop it and
                # build once more; if that fails too, there is no native
                # tail in this process.
                lib = None
                try:
                    os.unlink(lib_path())
                except OSError:
                    pass
                continue
            break
        if lib is None:
            _FAILED = True
            return None
        fn = lib.mg_magn_phase_pack
        fn.restype = ctypes.c_int
        fn.argtypes = [
            ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64,
            ctypes.c_int64, ctypes.c_void_p, ctypes.c_int64,
            ctypes.c_void_p,
        ]
        lib.mg_pack_begin.restype = ctypes.c_void_p
        lib.mg_pack_begin.argtypes = [
            ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
            ctypes.c_void_p, ctypes.c_int64,
        ]
        lib.mg_pack_frames.restype = ctypes.c_int
        lib.mg_pack_frames.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64,
            ctypes.c_void_p,
        ]
        lib.mg_pack_finish.restype = ctypes.c_int
        lib.mg_pack_finish.argtypes = [ctypes.c_void_p, ctypes.c_void_p]
        lib.mg_pack_free.restype = None
        lib.mg_pack_free.argtypes = [ctypes.c_void_p]
        _LIB = lib
    return _LIB


def is_available() -> bool:
    return _load() is not None


class PackStream:
    """Streaming counterpart of :func:`magn_phase_pack`.

    Feed frame-major complex64 blocks as they are produced (window
    multiply + rfft per block stay cache-resident instead of
    materializing the whole ~40 MB spectrogram), then :meth:`finish` to
    normalize and get the packed array.  Identical arithmetic to the
    one-shot entry (which IS this stream driven with a single block):
    bit-exact for any block split.

    ``t_total`` must be the exact number of frames that will be fed (the
    trim geometry needs it up front).
    """

    def __init__(self, t_total: int, ld: int, bark: np.ndarray, n_vec: int):
        lib = _load()
        if lib is None:
            raise RuntimeError("native library unavailable; check is_available()")
        bark = np.ascontiguousarray(bark, np.float32)
        n_bins = bark.shape[0]
        self._n_chunks = (t_total - 1) // n_vec
        if self._n_chunks == 0 or n_bins > ld:
            raise ValueError("track shorter than one chunk or bad geometry")
        self._lib = lib
        self._t_total, self._ld = t_total, ld
        self._fed = 0
        self.out = np.empty((self._n_chunks, 2, n_bins, n_vec), np.float32)
        self._st = lib.mg_pack_begin(
            t_total, ld, n_bins, bark.ctypes.data, n_vec
        )
        if not self._st:
            raise MemoryError("mg_pack_begin failed")

    def feed(self, z_block: np.ndarray) -> None:
        # real checks, not asserts: under `python -O` a NULL handle would
        # segfault in C and an ld mismatch would read out of bounds
        if not self._st:
            raise ValueError("PackStream already finished")
        z_block = np.ascontiguousarray(z_block, np.complex64)
        t_block, ld = z_block.shape
        if ld != self._ld:
            raise ValueError(f"block ld {ld} != stream ld {self._ld}")
        rc = self._lib.mg_pack_frames(
            self._st, z_block.ctypes.data, t_block, self.out.ctypes.data
        )
        if rc != 0:
            raise ValueError(f"mg_pack_frames rc={rc} (overfeed?)")
        self._fed += t_block

    def finish(self) -> np.ndarray:
        if not self._st:
            raise ValueError("PackStream already finished")
        if self._fed != self._t_total:
            raise ValueError(
                f"fed {self._fed} of {self._t_total} frames before finish()"
            )
        st, self._st = self._st, None
        rc = self._lib.mg_pack_finish(st, self.out.ctypes.data)
        if rc != 0:
            raise ValueError(f"mg_pack_finish rc={rc}")
        return self.out

    def __del__(self):
        if getattr(self, "_st", None):
            self._lib.mg_pack_free(self._st)


def magn_phase_pack(
    z_frames: np.ndarray, bark: np.ndarray, n_vec: int
) -> np.ndarray | None:
    """Fused complex spectrogram -> packed, normalized chunks.

    ``z_frames``: complex64 ``(T, ld)`` FRAME-major (the batched-rfft
    layout; no transpose needed).  Only the first ``len(bark)`` columns
    are used, so passing the raw rfft output with ``ld = n_bins + 1``
    drops the Nyquist bin for free.  Returns float32
    ``((T-1)//n_vec, 2, n_bins, n_vec)``, or ``None`` if the track is
    shorter than one chunk, mirroring ``audio.ingest.process_signal``.
    """
    lib = _load()
    if lib is None:
        raise RuntimeError("native library unavailable; check is_available()")
    z_frames = np.ascontiguousarray(z_frames, np.complex64)
    bark = np.ascontiguousarray(bark, np.float32)
    t, ld = z_frames.shape
    n_bins = bark.shape[0]
    n_chunks = (t - 1) // n_vec
    if n_chunks == 0 or n_bins > ld:
        return None
    out = np.empty((n_chunks, 2, n_bins, n_vec), np.float32)
    rc = lib.mg_magn_phase_pack(
        z_frames.ctypes.data, t, ld, n_bins, bark.ctypes.data, n_vec,
        out.ctypes.data,
    )
    if rc != 0:
        return None
    return out
