"""Fused inverse STFT: a hand-written CUDA kernel for Hopper beside its
plain PyTorch version.

``istft_fused`` (K5) replaces ``musicgan_tpu/ops/istft_pallas.py::
istft_fused`` (Pallas kernel from ``_kernel_factory``); the kernel is
``csrc/istft.cu``.  One launch goes from the ``(B, n_bins, T)`` spectra to
the trimmed ``(B, (T - 1) * hop)`` signal: each frame's inverse real FFT in
shared memory, the Hann window (times the ``normalized=True`` scale), the
overlap-add of the ``r = n_fft / hop`` slices of each hop, the COLA
division and the ``n_fft / 2`` centring trim.

What bounds it on an H100: bytes.  The function reads the spectra and
writes the signal once, 131 MB at the synthesis shape, 0.04 ms at 3.35
TB/s; the FFT's arithmetic (about 25k FLOP a frame) is a quarter of that
time.  The TPU kernel is an iDFT written as a matrix product (8,208 FLOP an
output sample, the MXU being the TPU's only fast unit); on the card that
costs 40 times the FFT's arithmetic, so the port transforms each frame by
an FFT and keeps everything but the spectra and the signal on the chip.
The float64 host tables, cached per device: the twiddles
(:func:`twiddle_table`), the window with its scale and ``1 / n_fft``
(:func:`window_table`) and the inverse COLA envelope
(:func:`inverse_envelope_table`), which the kernel reads by the first and
last frame slice each hop holds.

Two routes, chosen by the lengths (never by an error): the FFT above for
``n_fft`` a power of two from 16 to 4096 (the model's is 1024) with ``hop
= n_fft / r`` and ``r`` below the frames a block transforms
(:func:`kernel_frames`: 32 up to ``n_fft`` 1024, 16 at 2048, 8 at 4096);
and for every other ``n_fft % hop == 0`` (as the TPU kernel takes) a
windowed iDFT as a register-tiled product with the bases
(:func:`windowed_idft_bases`), the overlap-add summed inside it and COLA and
the trim in its epilogue (:func:`uses_fft`).  Any ``T`` and batch; the
wrapper raises only where the TPU kernel asserts.

Dispatch: a CPU tensor takes the plain version, the port's vocoder
``audio/stft.py::istft_real_imag``; a CUDA tensor launches the kernel;
anything else raises.  ``istft_fused.launches`` counts launches (a signal
of no samples, ``T = 1``, launches nothing), ``istft_fused.idft_launches``
those on the iDFT route.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from . import _build
from .nan_check import checked
from ..audio.stft import _idft_bases, hann_window, istft_real_imag

__all__ = [
    "istft_fused",
    "twiddle_table",
    "window_table",
    "inverse_envelope_table",
    "kernel_frames",
    "uses_fft",
    "windowed_idft_bases",
]


def twiddle_table(n_fft: int) -> np.ndarray:
    """``exp(2 pi i k / n_fft)`` for ``k < n_fft``, float64, as ``(n_fft, 2)``
    (real, imaginary): the FFT's twiddles and the real transform's packing."""
    ang = 2.0 * np.pi * np.arange(n_fft, dtype=np.float64) / n_fft
    return np.stack([np.cos(ang), np.sin(ang)], axis=1)


def window_table(n_fft: int, normalized: bool) -> np.ndarray:
    """The synthesis window times the ``normalized=True`` scale of
    ``istft_real_imag`` and ``1 / n_fft`` (the kernel's FFT is unscaled),
    float64 ``(n_fft,)``."""
    w = hann_window(n_fft, np.float64)
    scale = np.sqrt(np.sum(w**2)) if normalized else 1.0
    return w * scale / n_fft


def inverse_envelope_table(n_fft: int, hop: int) -> np.ndarray:
    """``(r, r, hop)`` float64: entry ``[jlo, jhi, h]`` is one over the
    window-square envelope at offset ``h`` of a hop that holds slices
    ``jlo..jhi`` of its frames (``cola_trim``'s clamp at 1e-11 kept).
    Interior hops hold all ``r`` slices; the first and last ``r - 1`` hops
    of a signal hold fewer."""
    r = n_fft // hop
    w2 = (hann_window(n_fft, np.float64) ** 2).reshape(r, hop)
    table = np.ones((r, r, hop))
    for jlo in range(r):
        for jhi in range(jlo, r):
            table[jlo, jhi] = 1.0 / np.maximum(w2[jlo : jhi + 1].sum(axis=0), 1e-11)
    return table


@functools.lru_cache(maxsize=8)
def _tables(n_fft: int, hop: int, normalized: bool, device: torch.device):
    """The kernel's three tables as float32 on ``device``, made once."""
    return tuple(
        torch.from_numpy(a.astype(np.float32).reshape(-1)).to(device)
        for a in (twiddle_table(n_fft), window_table(n_fft, normalized),
                  inverse_envelope_table(n_fft, hop))
    )


_ISTFT_ARGS = [_build.PTR] * 6 + [_build.INT] * 5


@functools.lru_cache(maxsize=None)
def kernel_frames(n_fft: int) -> int:
    """Frames a block of the kernel transforms at ``n_fft``, as the
    compiled kernel has it (0 where it takes no such ``n_fft``);
    ``hop = n_fft / r`` needs ``r`` below it.  Needs the CUDA toolkit."""
    fn = _build.load("istft").mg_istft_frames
    fn.argtypes, fn.restype = [ctypes.c_int], ctypes.c_int
    return fn(n_fft)


def uses_fft(n_fft: int, hop: int) -> bool:
    """Whether ``(n_fft, hop)`` takes the FFT route (else the iDFT route):
    ``n_fft`` a power of two from 16 to 4096 and ``n_fft / hop`` below
    :func:`kernel_frames`.  Needs the CUDA toolkit."""
    return n_fft & (n_fft - 1) == 0 and 16 <= n_fft <= 4096 and n_fft // hop < kernel_frames(n_fft)


@functools.lru_cache(maxsize=8)
def windowed_idft_bases(n_fft: int, normalized: bool, device: torch.device):
    """The iDFT route's operands on ``device``: the inverse real-DFT bases
    ``(n_bins, n_fft)`` (``audio/stft.py::_idft_bases``) times the window
    and the ``normalized=True`` scale, made in float64 and rounded once;
    and the window squared in float32, as ``cola_trim`` makes it."""
    cos_ib, sin_ib = _idft_bases(n_fft)
    w = hann_window(n_fft, np.float64)
    scale = np.sqrt(np.sum(w**2)) if normalized else 1.0
    bases = tuple(
        torch.from_numpy((b.astype(np.float64) * w[None, :] * scale).astype(np.float32)).to(device)
        for b in (cos_ib, sin_ib)
    )
    return (*bases, torch.from_numpy(hann_window(n_fft)).to(device) ** 2)


_DFT_ARGS = [_build.PTR] * 6 + [_build.INT] * 5


def istft_fused(real, imag, n_fft: int = 1024, hop: int = 256, normalized: bool = True):
    """Inverse STFT from ``(B, n_bins, T)`` (or unbatched ``(n_bins, T)``)
    real/imag parts -> ``(B, (T-1)*hop)`` signals; the same function as
    ``audio.stft.istft_real_imag``, its plain version."""
    assert n_fft % hop == 0
    if real.device.type == "cpu":
        return checked("istft_fused", istft_real_imag(real, imag, n_fft, hop, normalized))
    if real.device.type != "cuda":
        raise ValueError(f"istft_fused: no kernel for device {real.device}")
    unbatched = real.ndim == 2
    if unbatched:
        real, imag = real[None], imag[None]
    bsz, n_bins, t = real.shape
    if n_bins != n_fft // 2 + 1 or imag.shape != real.shape:
        raise ValueError(f"istft_fused: spectra {tuple(real.shape)}, {tuple(imag.shape)} for n_fft {n_fft}")
    for x in (real, imag):
        if x.device != real.device or x.dtype != torch.float32:
            raise ValueError(f"istft_fused: spectra must be float32 on {real.device}")
    y = torch.empty(bsz, (t - 1) * hop, device=real.device, dtype=torch.float32)
    if t > 1:
        real, imag = real.contiguous(), imag.contiguous()
        if uses_fft(n_fft, hop):
            tw, gwin, inv_env = _tables(n_fft, hop, normalized, real.device)
            _build.kernel("istft", "mg_istft", _ISTFT_ARGS)(
                real.data_ptr(), imag.data_ptr(), tw.data_ptr(), gwin.data_ptr(),
                inv_env.data_ptr(), y.data_ptr(), bsz, n_bins, t, n_fft, hop, device=real.device,
            )
        else:
            wc, ws, win2 = windowed_idft_bases(n_fft, normalized, real.device)
            _build.kernel("istft", "mg_istft_dft", _DFT_ARGS)(
                real.data_ptr(), imag.data_ptr(), wc.data_ptr(), ws.data_ptr(), win2.data_ptr(),
                y.data_ptr(), bsz, n_bins, t, n_fft, hop, device=real.device,
            )
            istft_fused.idft_launches += 1
        istft_fused.launches += 1
    return checked("istft_fused", y[0] if unbatched else y)


istft_fused.launches = 0
istft_fused.idft_launches = 0  # of them on the iDFT route
