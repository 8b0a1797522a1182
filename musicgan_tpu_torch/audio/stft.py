"""Inverse STFT as a matrix-DFT, in full float32.

The plain vocoder of the port: ``istft_real_imag`` is the counterpart of
``musicgan_tpu/audio/stft.py::istft_real_imag`` and matches
``torch.istft(center=True, length=None)`` after the ``normalized=True``
rescale of ``torchaudio.functional.inverse_spectrogram``.  It is the
plain version of the fused kernel (``ops/istft_fused.py``), which
computes the same function.  The forward
``stft`` belongs to the data path and is not here yet.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

__all__ = [
    "hann_window",
    "overlap_add",
    "signal_length",
    "istft_real_imag",
]


def hann_window(n: int, dtype=np.float32) -> np.ndarray:
    """Periodic Hann window, identical to ``torch.hann_window(n)``."""
    k = np.arange(n, dtype=np.float64)
    w = 0.5 * (1.0 - np.cos(2.0 * np.pi * k / n))
    return w.astype(dtype)


@functools.lru_cache(maxsize=8)
def _idft_bases(n_fft: int) -> tuple[np.ndarray, np.ndarray]:
    """Inverse rfft bases mapping ``(n_bins,)`` spectra to ``(n_fft,)`` frames.

    ``x = real @ cos_ib + imag @ sin_ib`` where interior bins carry weight
    ``2/n`` (conjugate-symmetric pair) and the DC/Nyquist bins weight ``1/n``.
    """
    n_bins = n_fft // 2 + 1
    f = np.arange(n_bins, dtype=np.float64)[:, None]
    k = np.arange(n_fft, dtype=np.float64)[None, :]
    ang = 2.0 * np.pi * f * k / n_fft
    weight = np.full((n_bins, 1), 2.0 / n_fft)
    weight[0, 0] = 1.0 / n_fft
    weight[-1, 0] = 1.0 / n_fft
    cos_ib = (np.cos(ang) * weight).astype(np.float32)
    sin_ib = (-np.sin(ang) * weight).astype(np.float32)
    return cos_ib, sin_ib


def signal_length(n_frames: int, hop: int) -> int:
    """Output length of a centered iSTFT with ``length=None``."""
    return (n_frames - 1) * hop


def overlap_add(frames: torch.Tensor, hop: int) -> torch.Tensor:
    """Overlap-add ``(..., T, n_fft)`` frames at stride ``hop`` ->
    ``(..., (T + r - 1) * hop)`` signals, ``r = n_fft // hop``."""
    t, n_fft = frames.shape[-2:]
    assert n_fft % hop == 0
    r = n_fft // hop
    lead = frames.shape[:-2]
    chunks = frames.reshape(*lead, t, r, hop)
    acc = frames.new_zeros(*lead, t + r - 1, hop)
    for j in range(r):
        acc[..., j : j + t, :] += chunks[..., j, :]
    return acc.reshape(*lead, -1)


def cola_trim(y: torch.Tensor, t: int, n_fft: int, hop: int) -> torch.Tensor:
    """Divide the overlap-added ``(..., (t + r - 1) * hop)`` signal by the
    window-square envelope (COLA normalisation) and trim the ``n_fft/2``
    centring pad: the epilogue shared by both iSTFT lowerings."""
    window = torch.from_numpy(hann_window(n_fft)).to(y.device)
    env = overlap_add((window**2).expand(t, n_fft), hop)
    y = y / torch.clamp(env, min=1e-11)
    pad = n_fft // 2
    return y[..., pad : pad + signal_length(t, hop)]


def istft_real_imag(
    real: torch.Tensor,
    imag: torch.Tensor,
    n_fft: int = 1024,
    hop: int = 256,
    normalized: bool = True,
) -> torch.Tensor:
    """Inverse STFT from real/imag parts ``(..., n_bins, T)`` -> signals
    ``(..., (T - 1) * hop)``, float32 throughout (the caller keeps TF32
    off on the card: ``torch.backends.cuda.matmul.allow_tf32`` is False
    by default)."""
    window = torch.from_numpy(hann_window(n_fft)).to(real.device)
    if normalized:
        scale = torch.sqrt(torch.sum(window**2))
        real = real * scale
        imag = imag * scale
    cos_ib, sin_ib = (torch.from_numpy(b).to(real.device) for b in _idft_bases(n_fft))
    # (..., T, n_bins) @ (n_bins, n_fft) -> (..., T, n_fft) time frames.
    frames = real.transpose(-1, -2) @ cos_ib + imag.transpose(-1, -2) @ sin_ib
    frames = frames * window
    return cola_trim(overlap_add(frames, hop), real.shape[-1], n_fft, hop)
