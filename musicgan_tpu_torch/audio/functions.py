"""Magnitude / instantaneous-frequency images back to audio.

Counterparts of ``musicgan_tpu/audio/functions.py``'s inverse half
(reference ``audio/functions.py:26-35,97-139``).  Each function takes one
music's ``(N, 2, n_bins, W)`` chunks, as in JAX, or a batch of musics
``(M, N, 2, n_bins, W)``, which stands in for JAX's ``vmap``: every
reduction (the magnitude's min-max rescale) and the phase prefix sum stay
per music.
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch

from ..config import AudioConfig
from .stft import istft_real_imag

_DEFAULT = AudioConfig()

__all__ = [
    "bark_scale_vector",
    "bark_magn_scale",
    "mp_to_real_imag",
    "magn_phase_to_signal",
]


@functools.lru_cache(maxsize=4)
def _bark_scale_np(n_bins: int, sample_rate: int) -> np.ndarray:
    """L2-normalized ``6 * arcsinh(f / 600)`` weight over 20 Hz .. Nyquist
    (reference ``audio/functions.py:26-35``)."""
    min_hz, max_hz = 20.0, sample_rate // 2
    freqs = np.linspace(min_hz, max_hz, n_bins)
    scale = 6.0 * np.arcsinh(freqs / 600.0)
    scale = scale / np.linalg.norm(scale)
    return scale.astype(np.float32)


def bark_scale_vector(
    n_bins: int = _DEFAULT.n_bins,
    sample_rate: int = _DEFAULT.sample_rate,
    device: torch.device | str = "cpu",
) -> torch.Tensor:
    return torch.from_numpy(_bark_scale_np(n_bins, sample_rate)).to(device)


def bark_magn_scale(magn: torch.Tensor, unscale: bool = False) -> torch.Tensor:
    """Multiply (or divide) magnitude rows by the bark weight.

    ``magn``: ``(..., n_bins, T)`` — a per-bin scalar weight, not a
    re-binning (reference ``audio/functions.py:26-35``)."""
    scale = bark_scale_vector(magn.shape[-2], device=magn.device)[:, None]
    return magn / scale if unscale else magn * scale


def mp_to_real_imag(
    magn_phase: torch.Tensor, cfg: AudioConfig = _DEFAULT
) -> tuple[torch.Tensor, torch.Tensor]:
    """``(N, 2, n_bins, W)`` magn/phase chunks of one music (or a batch
    ``(M, N, 2, n_bins, W)``) -> complex-spectrum parts ``([M,]
    n_fft//2+1, N*W)`` for either iSTFT lowering (reference
    ``audio/functions.py:108-128``)."""
    batched = magn_phase.ndim == 5
    if not batched:
        magn_phase = magn_phase[None]
    m, _, two, n_bins, _ = magn_phase.shape
    assert two == 2 and n_bins == cfg.n_bins, magn_phase.shape

    # (M, N, 2, H, W) -> (M, 2, H, N * W): chunks concatenated along time.
    mp = magn_phase.permute(0, 2, 3, 1, 4).reshape(m, 2, n_bins, -1)
    magn, phase = mp[:, 0], mp[:, 1]

    magn = (magn + 1.0) / 2.0
    magn = bark_magn_scale(magn, unscale=True)
    span = magn.amax(dim=(1, 2), keepdim=True) - magn.amin(dim=(1, 2), keepdim=True)
    magn = magn / span

    phase = (phase + 1.0) / 2.0 * 2.0 * math.pi - math.pi
    # Instantaneous frequency -> absolute phase: prefix sum over time.
    phase = torch.cumsum(phase, dim=-1)
    phase = torch.remainder(phase, 2 * math.pi)

    real = magn * torch.cos(phase)
    imag = magn * torch.sin(phase)

    # Re-append the zero Nyquist row dropped when the images were made.
    real = torch.nn.functional.pad(real, (0, 0, 0, 1))
    imag = torch.nn.functional.pad(imag, (0, 0, 0, 1))
    return (real, imag) if batched else (real[0], imag[0])


def magn_phase_to_signal(
    magn_phase: torch.Tensor, cfg: AudioConfig = _DEFAULT
) -> torch.Tensor:
    """Invert ``(N, 2, n_bins, W)`` magn/phase chunks (or a batch of them)
    to a waveform ``([M,] (N*W - 1) * hop)`` through the plain iSTFT
    (reference ``audio/functions.py:97-137``)."""
    real, imag = mp_to_real_imag(magn_phase, cfg)
    return istft_real_imag(real, imag, n_fft=cfg.n_fft, hop=cfg.stft_stride)
