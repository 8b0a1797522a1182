"""STFT and inverse STFT as matrix-DFTs, in full float32.

Counterpart of ``musicgan_tpu/audio/stft.py``.  ``stft`` frames the
reflect-centred signal and multiplies it by the cos/sin bases; it matches
``torchaudio.functional.spectrogram(power=None, normalized=True)``.
``istft_real_imag`` matches ``torch.istft(center=True, length=None)``
after the ``normalized=True`` rescale of
``torchaudio.functional.inverse_spectrogram``; it is the plain version of
the fused kernel (``ops/istft_fused.py``), which computes the same
function.

Both DFTs are float32 products (float64 where the caller passes float64).
On the card TF32 must stay off for them
(``torch.backends.cuda.matmul.allow_tf32``, False by default): a TF32 DFT
would scramble the phase.  ``stft`` refuses to run with it on.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

__all__ = [
    "hann_window",
    "num_frames",
    "frame_signal",
    "stft",
    "overlap_add",
    "signal_length",
    "istft_real_imag",
    "istft",
]


def hann_window(n: int, dtype=np.float32) -> np.ndarray:
    """Periodic Hann window, identical to ``torch.hann_window(n)``."""
    k = np.arange(n, dtype=np.float64)
    w = 0.5 * (1.0 - np.cos(2.0 * np.pi * k / n))
    return w.astype(dtype)


@functools.lru_cache(maxsize=8)
def _dft_bases(n_fft: int) -> tuple[np.ndarray, np.ndarray]:
    """Real/imag rfft bases, in float64: ``X[f] = sum_k x[k] *
    exp(-2i*pi*f*k/n)``, ``real = x @ cos_basis``, ``imag = -(x @
    sin_basis)``, each ``(n_fft, n_fft//2 + 1)``.  The caller casts them to
    its dtype (float32 after a float64 computation, as in JAX)."""
    n_bins = n_fft // 2 + 1
    k = np.arange(n_fft, dtype=np.float64)[:, None]
    f = np.arange(n_bins, dtype=np.float64)[None, :]
    ang = 2.0 * np.pi * k * f / n_fft
    return np.cos(ang), np.sin(ang)


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


def num_frames(signal_len: int, hop: int) -> int:
    """Frame count of a centered STFT (``torch.stft`` convention)."""
    return 1 + signal_len // hop


def signal_length(n_frames: int, hop: int) -> int:
    """Output length of a centered iSTFT with ``length=None``."""
    return (n_frames - 1) * hop


def frame_signal(x: torch.Tensor, n_fft: int, hop: int) -> torch.Tensor:
    """Center-pad (reflect) and frame a 1-D signal into ``(T, n_fft)``,
    ``T = num_frames(len(x), hop)``; ``n_fft`` a multiple of ``hop``, as in
    JAX.  The frames are a strided view of the padded signal."""
    assert n_fft % hop == 0, "n_fft must be a multiple of hop"
    assert x.ndim == 1, f"(L,), actual = {tuple(x.shape)}"
    pad = n_fft // 2
    x = torch.nn.functional.pad(x[None, None], (pad, pad), mode="reflect")[0, 0]
    return x.unfold(0, n_fft, hop)


def _check_no_tf32(x: torch.Tensor) -> None:
    if x.device.type == "cuda" and x.dtype == torch.float32 and torch.backends.cuda.matmul.allow_tf32:
        raise RuntimeError(
            "the STFT's DFT is a float32 product and TF32 would scramble its "
            "phase: set torch.backends.cuda.matmul.allow_tf32 = False"
        )


def stft(
    x: torch.Tensor,
    n_fft: int = 1024,
    hop: int = 256,
    normalized: bool = True,
) -> torch.Tensor:
    """Centered STFT of a 1-D signal -> complex ``(n_fft//2 + 1, T)``
    (complex64; complex128 for a float64 signal).

    Matches ``torchaudio.functional.spectrogram(power=None,
    normalized=True)`` (reference ``audio/functions.py:53-59``): Hann
    window, reflect-centred, output divided by ``sqrt(sum(window**2))``."""
    dtype = torch.float64 if x.dtype == torch.float64 else torch.float32
    x = x.to(dtype)
    _check_no_tf32(x)
    window = torch.from_numpy(hann_window(n_fft, np.float64)).to(x.device, dtype)
    frames = frame_signal(x, n_fft, hop) * window
    cos_b, sin_b = (torch.from_numpy(b).to(x.device, dtype) for b in _dft_bases(n_fft))
    real = frames @ cos_b
    imag = -(frames @ sin_b)
    if normalized:
        scale = torch.rsqrt(torch.sum(window**2))
        real = real * scale
        imag = imag * scale
    return torch.complex(real, imag).T  # (n_bins, T)


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


def istft(
    z: torch.Tensor,
    n_fft: int = 1024,
    hop: int = 256,
    normalized: bool = True,
) -> torch.Tensor:
    """Inverse STFT from a complex ``(..., n_bins, T)`` spectrogram."""
    return istft_real_imag(z.real, z.imag, n_fft, hop, normalized)
