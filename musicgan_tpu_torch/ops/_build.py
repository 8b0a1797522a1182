"""Build the CUDA kernels of ``csrc/`` with ``nvcc`` and load them.

Each ``csrc/<name>.cu`` is compiled on first use into its own shared
library with a plain C interface,
``_build/<name>-<hash>.so``, and loaded with ``ctypes``.  The hash covers
the source, every ``csrc/*.cuh`` header and the flags, so a changed source
builds anew.  This takes seconds per file; a source that included
PyTorch's headers would take minutes.

Every C entry point returns ``cudaGetLastError()`` after its launch, and
the launcher that :func:`kernel` returns raises when it is not 0: a launch
that the CUDA runtime refuses (too many threads, too much shared memory) never
runs, and a later ``torch.cuda.synchronize()`` would not report it.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

import torch

from ..utils import profiling

__all__ = ["build_all", "load", "kernel", "PTR", "INT", "FLOAT"]

_PKG = Path(__file__).resolve().parent.parent
SRC_DIR = _PKG / "csrc"
DEFAULT_BUILD_DIR = _PKG / "_build"
BUILD_DIR = DEFAULT_BUILD_DIR  # utils/cache.py may point it elsewhere
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
)

PTR, INT, FLOAT = ctypes.c_void_p, ctypes.c_int, ctypes.c_float

_LIBS: dict[str, ctypes.CDLL] = {}
_LAUNCHERS: dict[str, object] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    path = os.path.join(home, "bin", "nvcc")
    if not os.path.isfile(path):
        raise RuntimeError(
            "nvcc not found on PATH, under $CUDA_HOME or /usr/local/cuda: "
            "the CUDA toolkit is needed to build the kernels in "
            f"{SRC_DIR}"
        )
    return path


def _lib_path(name: str) -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in [SRC_DIR / f"{name}.cu", *sorted(SRC_DIR.glob("*.cuh"))]:
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:16]}.so"


def _start_build(name: str) -> tuple[subprocess.Popen, Path, Path, int] | None:
    """Start ``nvcc`` for one source unless its library is built already."""
    out = _lib_path(name)
    if out.exists():
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(SRC_DIR / f"{name}.cu")]
    t0_ns = time.perf_counter_ns()
    proc = subprocess.Popen(
        cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
    )
    return proc, tmp, out, t0_ns


def _finish_build(job: tuple[subprocess.Popen, Path, Path, int]) -> None:
    """Wait for one ``nvcc``: an ``mg.build.compile`` span from its start,
    recorded whether or not a profiler is on."""
    proc, tmp, out, t0_ns = job
    with profiling.span("mg.build.compile", always=True, t0_ns=t0_ns):
        log, _ = proc.communicate()
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed for {out.name}:\n{log}")
    os.replace(tmp, out)  # atomic: a concurrent builder sees all or nothing


def build_all() -> float:
    """Compile every ``csrc/*.cu`` that is not built yet, one ``nvcc`` per
    source, all started together.  Returns the seconds it took; each
    source's ``nvcc`` is an ``mg.build.compile`` span (``utils/profiling.py``)."""
    t0 = time.perf_counter()
    jobs = [_start_build(src.stem) for src in sorted(SRC_DIR.glob("*.cu"))]
    errors = []

    def finish(job):  # one thread a job reads its nvcc's output as it comes
        try:
            _finish_build(job)
        except RuntimeError as e:
            errors.append(str(e))

    threads = [threading.Thread(target=finish, args=(job,)) for job in jobs if job is not None]
    for t in threads:
        t.start()
    for t in threads:  # wait for every nvcc, failed or not, before raising
        t.join()
    if errors:
        raise RuntimeError("\n".join(errors))
    return time.perf_counter() - t0


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built first if needed."""
    lib = _LIBS.get(name)
    if lib is None:
        job = _start_build(name)
        if job is not None:
            _finish_build(job)
        lib = _LIBS[name] = ctypes.CDLL(str(_lib_path(name)))
    return lib


def kernel(name: str, symbol: str, argtypes: list):
    """Launcher for the C entry point ``symbol`` of ``csrc/<name>.cu``.

    ``argtypes`` are the ctypes of its arguments before the stream, which
    comes last (pointers and the stream as ``c_void_p``).  The launcher
    takes those arguments and the ``device`` whose current PyTorch stream
    the kernel joins, and raises if the launch reports an error."""
    launcher = _LAUNCHERS.get(symbol)
    if launcher is not None:
        return launcher
    lib = load(name)
    fn = getattr(lib, symbol)
    fn.argtypes = [*argtypes, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    lib.mg_error_string.argtypes = [ctypes.c_int]
    lib.mg_error_string.restype = ctypes.c_char_p

    def launcher(*args, device):
        if device.index is None or device.index == torch.cuda.current_device():
            err = fn(*args, torch.cuda.current_stream().cuda_stream)
        else:
            with torch.cuda.device(device):
                err = fn(*args, torch.cuda.current_stream(device).cuda_stream)
        if err != 0:
            msg = lib.mg_error_string(err).decode()
            raise RuntimeError(f"{symbol}: CUDA error {err} at launch: {msg}")

    _LAUNCHERS[symbol] = launcher
    return launcher
