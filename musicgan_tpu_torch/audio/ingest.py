"""Parallel host-side dataset ingest: WAV -> packed spectrogram shards
(counterpart of the JAX package's ``audio/ingest.py``; the shards and the
``index.json`` it writes are byte-identical to that module's on the same
WAVs, and ``audio/dataset.py`` reads either).

Replaces the reference's serial, one-``.pt``-file-per-sample writer
(reference ``create_dataset.py:13-64``) with:

* a **multiprocessing pool** over WAV files (the reference's hot outer loop,
  ``create_dataset.py:34``, parallelized);
* a **pure-numpy mirror** of the STFT/magn-phase pipeline and a fused C++
  tail (``native/host_ops.cpp``), so worker processes stay lightweight:
  ingest runs on the host only and never initialises a device;
* **packed float32 shards** (``shard_{k}.npy`` of shape ``(n, 2, 512, 512)``
  + ``index.json``) instead of thousands of tiny float64 ``.pt`` files,
  8x smaller on disk and memmap-friendly for the training loader.
"""

from __future__ import annotations

import glob
import json
import multiprocessing as mp
import os
import sys
import threading
from typing import Iterable, Sequence

import numpy as np
import torch

from .. import native
from ..config import AudioConfig
from .io import load_wav
from .stft import hann_window

_CFG = AudioConfig()

__all__ = [
    "process_wav",
    "process_signal",
    "create_dataset",
    "ShardWriter",
    "INDEX_NAME",
    "BACKENDS",
]

INDEX_NAME = "index.json"
BACKENDS = ("auto", "native", "numpy", "torch")


# ---------------------------------------------------------------------------
# numpy mirror of the STFT pipeline (audio/stft.py + audio/functions.py)
# ---------------------------------------------------------------------------

def _rfft_batch(frames: np.ndarray) -> np.ndarray:
    """Batched float32 rfft along axis 1 on the host, through torch's CPU
    rfft (~4.8x scipy's pocketfft on this class of host)."""
    return torch.fft.rfft(torch.from_numpy(frames), dim=1).numpy()


def _framing_setup(
    x: np.ndarray, n_fft: int, hop: int
) -> tuple[np.ndarray, int, np.ndarray]:
    """Shared centered-framing geometry: returns ``(view, t, win_n)``:
    the zero-copy strided frame view (``view[:t]`` are the STFT frames,
    pre-window), the frame count, and the window with the
    1/sqrt(sum(win^2)) normalization FOLDED IN (the DFT is linear: saves
    a full pass over the spectrogram)."""
    pad = n_fft // 2
    t = 1 + len(x) // hop
    xp = np.pad(x.astype(np.float32), (pad, pad), mode="reflect")
    total = (t - 1) * hop + n_fft
    if len(xp) < total:
        xp = np.pad(xp, (0, total - len(xp)))
    view = np.lib.stride_tricks.sliding_window_view(xp, n_fft)[::hop]
    win = hann_window(n_fft)
    norm = np.sqrt(np.sum(win.astype(np.float64) ** 2)).astype(np.float32)
    return view, t, win / norm


def _stft_frames(x: np.ndarray, n_fft: int, hop: int) -> np.ndarray:
    """Centered, window-normalized STFT -> complex64 ``(T, n_fft//2+1)``
    FRAME-major (the natural batched-rfft layout; the native tail consumes
    it directly, skipping the 40+ MB bin-major transpose).

    Same semantics as :func:`musicgan_tpu_torch.audio.stft.stft`.  Frames
    come from a zero-copy strided view, the window normalization is folded
    in (:func:`_framing_setup`), and the batched rfft is torch's
    (:func:`_rfft_batch`).
    """
    view, t, win_n = _framing_setup(x, n_fft, hop)
    return _rfft_batch(view[:t] * win_n[None, :])


def _stft_np(x: np.ndarray, n_fft: int, hop: int) -> np.ndarray:
    """Bin-major view of :func:`_stft_frames`: ``(n_fft//2+1, T)``."""
    return _stft_frames(x, n_fft, hop).T


def _phase_diff_np(phase: np.ndarray) -> np.ndarray:
    """Elementwise-wrapped first difference of the raw phase: exactly
    ``np.diff(unwrap(phase), axis=1)`` (the unwrap adjustment is local, so
    the cumsum cancels under the diff), without materializing the unwrapped
    phase or accumulating float error.  Edge rule matches the reference
    ``audio/functions.py:17-23``: a ``-pi`` wrap of a positive jump maps to
    ``+pi``.

    The diff and wrap run in float64: a sign-flipping (near-real) bin has
    ``dphi == +-float32(pi)`` EXACTLY, which is greater than true pi; f64
    wraps it (sign flip) while f32 modulo would not, and parity with the
    f64 unwrap semantics decides those bins (tested).
    """
    p64 = phase.astype(np.float64)
    d = p64[:, 1:] - p64[:, :-1]
    dm = np.mod(d + np.pi, 2.0 * np.pi) - np.pi
    dm[(dm == -np.pi) & (d > 0)] = np.pi
    keep = np.abs(d) < np.pi  # unwrap leaves |dphi| < pi untouched
    return np.where(keep, d, dm).astype(np.float32)


def _bark_scale_np(n_bins: int, sample_rate: int) -> np.ndarray:
    freqs = np.linspace(20.0, sample_rate // 2, n_bins)
    scale = 6.0 * np.arcsinh(freqs / 600.0)
    return (scale / np.linalg.norm(scale)).astype(np.float32)


def process_wav(
    wav_path: str, cfg: AudioConfig = _CFG
) -> np.ndarray | None:
    """One WAV -> ``(N, 2, n_bins, n_vec)`` float32 chunks, or ``None`` if the
    track is shorter than one chunk (reference skip at
    ``create_dataset.py:41-42``)."""
    signal, _ = load_wav(wav_path, expected_sample_rate=cfg.sample_rate)
    return process_signal(signal, cfg)


_BLOCK_FRAMES = 1024  # ~4 MB windowed + ~4 MB spectrum per block


def _process_signal_native_blocked(
    signal: np.ndarray, cfg: AudioConfig
) -> np.ndarray | None:
    """Blocked window->rfft->pack pipeline over the streaming native API:
    each block of frames is windowed into one scratch buffer and
    transformed by torch's ``out=`` rfft into another, then fed."""
    view, t, win_n = _framing_setup(signal, cfg.n_fft, cfg.stft_stride)
    if (t - 1) // cfg.n_vec == 0:
        return None  # shorter than one chunk (same rule as the one-shot)
    ld = cfg.n_fft // 2 + 1
    stream = native.PackStream(
        t, ld, _bark_scale_np(cfg.n_bins, cfg.sample_rate), cfg.n_vec
    )
    nb0 = min(_BLOCK_FRAMES, t)
    fscr = np.empty((nb0, cfg.n_fft), np.float32)
    zscr = np.empty((nb0, ld), np.complex64)
    fth, zth = torch.from_numpy(fscr), torch.from_numpy(zscr)
    for i0 in range(0, t, _BLOCK_FRAMES):
        nb = min(_BLOCK_FRAMES, t - i0)
        np.multiply(view[i0:i0 + nb], win_n[None, :], out=fscr[:nb])
        torch.fft.rfft(fth[:nb], dim=1, out=zth[:nb])
        stream.feed(zscr[:nb])
    return stream.finish()


def process_signal(
    signal: np.ndarray, cfg: AudioConfig = _CFG, backend: str = "auto"
) -> np.ndarray | None:
    """In-memory signal -> ``(N, 2, n_bins, n_vec)`` float32 chunks (the
    pure-compute part of :func:`process_wav`; timed on its own).

    ``backend``: "auto" takes "native" (the fused C++ tail,
    ``native/host_ops.cpp``: two passes instead of ~12, held to the numpy
    mirror) where the library builds, else "numpy", the mirror the
    equality tests pin to the STFT pipeline; "torch" is the same tail in
    ATen, an equality-tested alternative.  All run on the host.

    The native path runs BLOCKED: window multiply, rfft, and the fused
    pack tail per ~1k-frame block through the streaming kernel API
    (:class:`musicgan_tpu_torch.native.PackStream`): the two whole-track
    ~40 MB temporaries (windowed frames, complex spectrogram) never
    materialize, and per-track memory is bounded regardless of track
    length.  Bit-exact vs the one-shot kernel for any block split (tested).
    """
    if backend not in BACKENDS:
        raise ValueError(f"backend must be one of {BACKENDS}, got {backend!r}")
    if backend == "auto":
        backend = "native" if native.is_available() else "numpy"

    if backend == "native":
        return _process_signal_native_blocked(signal, cfg)

    zf = _stft_frames(signal, cfg.n_fft, cfg.stft_stride)  # (T, n_bins+1)
    # fewer than one FULL chunk after the first-difference frame drop:
    # same rule as the native path
    if (zf.shape[0] - 1) // cfg.n_vec == 0:
        return None
    z = np.ascontiguousarray(zf.T[:-1, :])  # bin-major mirrors' layout
    if backend == "torch":
        magn, phase = _magn_phase_torch(z, cfg)
    else:
        magn = np.abs(z)
        phase = np.angle(z)
        np.multiply(
            magn, _bark_scale_np(cfg.n_bins, cfg.sample_rate)[:, None],
            out=magn,
        )
        phase = _phase_diff_np(phase)
        magn = magn[:, 1:]
        for a in (magn, phase):  # min-max -> [-1, 1], in place
            mn, mx = a.min(), a.max()
            a -= mn
            a *= np.float32(2.0 / (mx - mn))
            a -= np.float32(1.0)

    t = magn.shape[1]
    magn = magn[:, t % cfg.n_vec :]
    phase = phase[:, t % cfg.n_vec :]
    n = magn.shape[1] // cfg.n_vec
    out = np.empty((n, 2, cfg.n_bins, cfg.n_vec), np.float32)
    out[:, 0] = magn.reshape(cfg.n_bins, n, cfg.n_vec).transpose(1, 0, 2)
    out[:, 1] = phase.reshape(cfg.n_bins, n, cfg.n_vec).transpose(1, 0, 2)
    return out


def _magn_phase_torch(z: np.ndarray, cfg: AudioConfig):
    """Post-FFT tail in torch on the host (zero-copy in/out).  Same math as
    the numpy branch: bark-scaled magnitude and wrapped phase difference,
    both min-max normalized to [-1, 1]."""
    zt = torch.from_numpy(np.ascontiguousarray(z))
    magn = zt.abs()
    phase = zt.angle()
    magn *= torch.from_numpy(
        _bark_scale_np(cfg.n_bins, cfg.sample_rate)
    ).unsqueeze(1)

    p64 = phase.double()  # f64 diff/wrap for exact-pi parity (see numpy)
    d = p64[:, 1:] - p64[:, :-1]
    dm = torch.remainder(d + np.pi, 2.0 * np.pi) - np.pi
    dm[(dm == -np.pi) & (d > 0)] = np.pi
    d = torch.where(d.abs() < np.pi, d, dm).float()
    magn = magn[:, 1:]

    for a in (magn, d):
        mn, mx = a.min(), a.max()
        a.sub_(mn).mul_(2.0 / float(mx - mn)).sub_(1.0)
    return magn.numpy(), d.numpy()


# ---------------------------------------------------------------------------
# shard writer
# ---------------------------------------------------------------------------

class ShardWriter:
    """Accumulates ``(2, H, W)`` samples and writes packed ``.npy`` shards.

    The index is (re)written ATOMICALLY after every shard flush with
    ``"complete": false``, so a concurrently-running trainer can pick up
    new shards mid-ingest (``SpectrogramDataset.refresh``): streaming
    ingest overlaps dataset building with training.  ``close()`` marks the
    index complete.
    """

    def __init__(self, out_dir: str, samples_per_shard: int = 128):
        os.makedirs(out_dir, exist_ok=True)
        self.out_dir = out_dir
        self.samples_per_shard = samples_per_shard
        self._buf: list[np.ndarray] = []
        self._shards: list[dict] = []
        self._total = 0

    def add(self, chunks: np.ndarray) -> None:
        for c in chunks:
            self._buf.append(c)
            self._total += 1
            if len(self._buf) >= self.samples_per_shard:
                self._flush()

    def _index_dict(self, complete: bool) -> dict:
        flushed = sum(s["num_samples"] for s in self._shards)
        return {
            # the format's name is the JAX package's: one format, two writers
            "format": "musicgan_tpu.shards.v1",
            "dtype": "float32",
            "sample_shape": [2, _CFG.n_bins, _CFG.n_vec],
            "total_samples": flushed,
            "shards": list(self._shards),
            "complete": complete,
        }

    def _write_index(self, index: dict) -> None:
        # atomic: a concurrent reader sees either the old or the new index,
        # never a torn file
        path = os.path.join(self.out_dir, INDEX_NAME)
        tmp = path + ".tmp"
        with open(tmp, "w") as f:
            json.dump(index, f, indent=1)
        os.replace(tmp, path)

    def _flush(self) -> None:
        if not self._buf:
            return
        k = len(self._shards)
        name = f"shard_{k:05d}.npy"
        arr = np.stack(self._buf, axis=0)
        np.save(os.path.join(self.out_dir, name), arr)
        self._shards.append({"file": name, "num_samples": int(arr.shape[0])})
        self._buf = []
        self._write_index(self._index_dict(complete=False))

    def close(self) -> dict:
        self._flush()
        index = self._index_dict(complete=True)
        assert index["total_samples"] == self._total
        self._write_index(index)
        return index


# ---------------------------------------------------------------------------
# the parallel pool
# ---------------------------------------------------------------------------

def _worker(path: str):
    try:
        return path, process_wav(path)
    except Exception as e:  # surface decode errors without killing the pool
        return path, e


def _audio_files(audio_path: str) -> list[str]:
    """The files a glob or a bare directory names (sorted)."""
    if os.path.isdir(audio_path):
        # A bare directory is the natural way to name a corpus; the
        # reference requires the caller to spell the glob
        # (``create_dataset.py:18``): accept both.  The extensions are the
        # JAX package's (its optional non-WAV decoders); here a non-WAV
        # file lands in the index's ``errors``.  Match case-insensitively
        # (CD rippers write TRACK01.WAV) and recurse (album
        # subdirectories are a common corpus layout).
        exts = {".wav", ".flac", ".ogg", ".mp3"}
        files = sorted(
            os.path.join(root, name)
            for root, _dirs, names in os.walk(audio_path)
            for name in names
            if os.path.splitext(name)[1].lower() in exts
        )
    else:
        files = sorted(glob.glob(audio_path))
    files = [f for f in files if os.path.isfile(f)]
    if not files:
        # A silent 0-sample dataset wastes a whole unattended run before
        # anything notices.
        raise FileNotFoundError(
            f"create_dataset: no audio files match {audio_path!r}"
        )
    return files


def _start_method() -> str:
    """``fork`` for a single-threaded caller, else ``forkserver`` (or
    ``spawn``): forking a multi-threaded process can deadlock the child
    (CPython's own warning), and a caller that has initialised CUDA or
    torch's thread pools has native threads, which
    ``threading.active_count()`` does not see, so ``/proc/self/task`` is
    counted where it exists."""
    try:
        n_threads = len(os.listdir("/proc/self/task"))
    except OSError:
        # No /proc (macOS etc.): OS threads can't be counted; assume some.
        n_threads = max(threading.active_count(), 2)
    if hasattr(os, "fork") and n_threads == 1:
        return "fork"
    if "forkserver" in mp.get_all_start_methods():
        return "forkserver"
    return "spawn"


def create_dataset(
    audio_path: str | Sequence[str],
    dataset_output_dir: str,
    num_workers: int | None = None,
    samples_per_shard: int = 128,
    progress: bool = True,
) -> dict:
    """Glob WAVs and build a packed spectrogram-shard dataset in parallel
    (the replacement for reference ``create_dataset.py:13-64``).

    Returns the written index dict, plus ``errors``: ``(path, repr)`` for
    each file that failed to decode.  ``progress`` prints ``ingest k/N`` to
    stderr as files finish.

    Start-method note: a single-threaded caller gets cheap ``fork``
    workers.  Once any extra OS thread exists (a CUDA context has some),
    workers use ``forkserver``/``spawn`` (:func:`_start_method`), and each
    worker imports the caller's main module, as multiprocessing does: a
    calling *script* must be import-safe (its body under ``if __name__ ==
    "__main__":``).  The CLI and library callers are.
    """
    if isinstance(audio_path, str):
        files = _audio_files(audio_path)
    else:
        files = list(audio_path)
    if num_workers is None:
        num_workers = max(1, min(len(files), os.cpu_count() or 1))

    writer = ShardWriter(dataset_output_dir, samples_per_shard)
    iterator: Iterable
    if num_workers > 1 and len(files) > 1:
        method = _start_method()
        ctx = mp.get_context(method)
        if method == "forkserver":
            # The forkserver needs this module only (the pool pickles
            # _worker by reference), so it preloads that, not CPython's
            # default ['__main__'].  Importing it imports torch but
            # initialises no device: the workers' compute is the
            # numpy/native tail.
            ctx.set_forkserver_preload(["musicgan_tpu_torch.audio.ingest"])
        pool = ctx.Pool(num_workers)
        iterator = pool.imap(_worker, files)
    else:
        pool = None
        iterator = map(_worker, files)

    errors = []
    try:
        for k, (path, result) in enumerate(iterator, 1):
            if isinstance(result, Exception):
                errors.append((path, repr(result)))
            elif result is not None:
                writer.add(result)
            if progress:
                print(f"ingest {k}/{len(files)}", file=sys.stderr, flush=True)
    finally:
        if pool is not None:
            pool.close()
            pool.join()

    index = writer.close()
    index["errors"] = errors
    return index
