"""GANSynth-style magnitude / instantaneous-frequency transforms.

Counterparts of ``musicgan_tpu/audio/functions.py`` (reference
``audio/functions.py:13-139``).  The forward half (``unwrap``,
``signal_to_stft``, ``wav_to_stft``, ``stft_to_phase_magn``) turns a track
into image chunks; it runs on the device of its input, ``wav_to_stft`` on
``cuda`` unless the caller passes ``device="cpu"``.  The inverse half takes
one music's ``(N, 2, n_bins, W)`` chunks, as in JAX, or a batch of musics
``(M, N, 2, n_bins, W)``, which stands in for JAX's ``vmap``: every
reduction (the magnitude's min-max rescale) and the phase prefix sum stay
per music.

GANSynth's images (``AudioConfig(freq_scale="mel_if")``) take
:func:`mel_if_to_real_imag` instead: log-mel magnitude squared and mel
instantaneous frequency, frames x mel bins, back to the linear spectrum
through two products with the mel-to-linear operator.
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch

from ..config import AudioConfig
from ..device import resolve_device
from ..models.layers import library_numerics
from ..utils import profiling
from .rebin import mel_to_linear_matrix
from .stft import istft_real_imag, stft

_DEFAULT = AudioConfig()

__all__ = [
    "unwrap",
    "bark_scale_vector",
    "bark_magn_scale",
    "signal_to_stft",
    "wav_to_stft",
    "stft_to_phase_magn",
    "mp_to_real_imag",
    "magn_phase_to_signal",
    "mel_to_linear_operator",
    "mel_to_linear",
    "mel_if_to_real_imag",
]


def unwrap(phi: torch.Tensor, dim: int = 1) -> torch.Tensor:
    """Phase unwrap along ``dim`` (reference ``audio/functions.py:17-23``),
    in the dtype of ``phi`` on its device, as JAX's ``unwrap``: wrap the
    first difference into (-pi, pi], fix the -pi/+pi boundary, zero the
    corrections below the pi threshold, prefix-sum them."""
    dphi = torch.diff(phi, dim=dim, prepend=phi.narrow(dim, 0, 1))
    dphi_m = torch.remainder(dphi + math.pi, 2 * math.pi) - math.pi
    dphi_m = torch.where((dphi_m == -math.pi) & (dphi > 0), math.pi, dphi_m)
    phi_adj = torch.where(torch.abs(dphi) < math.pi, 0.0, dphi_m - dphi)
    return phi + torch.cumsum(phi_adj, dim=dim)


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


def signal_to_stft(signal: torch.Tensor, cfg: AudioConfig = _DEFAULT) -> torch.Tensor:
    """Mono signal -> complex ``(n_bins, T)`` STFT on the signal's device,
    Nyquist row dropped (reference ``audio/functions.py:38-62``)."""
    return stft(signal, n_fft=cfg.n_fft, hop=cfg.stft_stride)[:-1, :]


def wav_to_stft(
    wav_path: str, cfg: AudioConfig = _DEFAULT, device: str | torch.device | None = None
) -> torch.Tensor:
    """Host WAV decode, then the STFT on ``device`` (``cuda`` unless the
    caller passes ``"cpu"``; reference ``audio/functions.py:38-62``): 44.1
    kHz asserted, mono by channel mean, normalized Hann spectrogram, Nyquist
    row dropped -> complex ``(n_bins, T)``."""
    from .io import load_wav

    device = resolve_device(device)
    signal, _ = load_wav(wav_path, expected_sample_rate=cfg.sample_rate)
    return signal_to_stft(torch.from_numpy(signal).to(device), cfg)


def stft_to_phase_magn(
    complex_values: torch.Tensor, nb_vec: int = _DEFAULT.n_vec
) -> tuple[torch.Tensor, torch.Tensor]:
    """Complex STFT ``(n_bins, T)`` -> ``(N, n_bins, nb_vec)`` magn and
    phase, on its device (reference ``audio/functions.py:65-94``):
    bark-weighted magnitude, unwrapped-phase first difference
    (instantaneous frequency), track-global min-max to [-1, 1], leading
    frames trimmed to a multiple of ``nb_vec``, then chunks along time."""
    magn = torch.abs(complex_values)
    phase = torch.angle(complex_values)

    magn = bark_magn_scale(magn, unscale=False)
    phase = unwrap(phase)

    phase = phase[:, 1:] - phase[:, :-1]
    magn = magn[:, 1:]

    magn = (magn - magn.min()) / (magn.max() - magn.min())
    phase = (phase - phase.min()) / (phase.max() - phase.min())
    magn, phase = magn * 2.0 - 1.0, phase * 2.0 - 1.0

    t = magn.shape[1]
    magn = magn[:, t % nb_vec :]
    phase = phase[:, t % nb_vec :]
    n = magn.shape[1] // nb_vec
    n_bins = magn.shape[0]
    # (n_bins, N * nb_vec) -> (N, n_bins, nb_vec)
    magn = magn.reshape(n_bins, n, nb_vec).permute(1, 0, 2)
    phase = phase.reshape(n_bins, n, nb_vec).permute(1, 0, 2)
    return magn, phase


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

    magn = unit_magnitude(magn)
    span = magn.amax(dim=(1, 2), keepdim=True) - magn.amin(dim=(1, 2), keepdim=True)
    magn = magn / span

    # Instantaneous frequency -> absolute phase: prefix sum over time.
    phase = torch.cumsum(instantaneous_frequency(phase), dim=-1)
    real, imag = spectrum_parts(magn, phase)
    return (real, imag) if batched else (real[0], imag[0])


# The three pieces of mp_to_real_imag around its two reductions over time
# (the magnitude's span and the phase's prefix sum), shared with the
# time-sharded synthesis (parallel/longclip.py), which makes those two
# reductions across its shards.


def unit_magnitude(magn: torch.Tensor) -> torch.Tensor:
    """The magnitude channel in [-1, 1] -> the bark-unscaled magnitude
    (``(..., n_bins, T)``), before its division by the clip's span."""
    return bark_magn_scale((magn + 1.0) / 2.0, unscale=True)


def instantaneous_frequency(phase: torch.Tensor) -> torch.Tensor:
    """The phase channel in [-1, 1] -> radians per frame in [-pi, pi]."""
    return (phase + 1.0) / 2.0 * 2.0 * math.pi - math.pi


def spectrum_parts(magn: torch.Tensor, phase: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """The normalised magnitude and the prefix-summed phase ``(...,
    n_bins, T)`` -> real and imaginary parts ``(..., n_bins + 1, T)``: the
    phase taken mod 2 pi, and the zero Nyquist row dropped when the images
    were made appended again."""
    phase = torch.remainder(phase, 2 * math.pi)
    real = magn * torch.cos(phase)
    imag = magn * torch.sin(phase)
    real = torch.nn.functional.pad(real, (0, 0, 0, 1))
    imag = torch.nn.functional.pad(imag, (0, 0, 0, 1))
    return real, imag


def magn_phase_to_signal(
    magn_phase: torch.Tensor, cfg: AudioConfig = _DEFAULT
) -> torch.Tensor:
    """Invert ``(N, 2, n_bins, W)`` magn/phase chunks (or a batch of them)
    to a waveform ``([M,] (N*W - 1) * hop)`` through the plain iSTFT
    (reference ``audio/functions.py:97-137``)."""
    real, imag = mp_to_real_imag(magn_phase, cfg)
    return istft_real_imag(real, imag, n_fft=cfg.n_fft, hop=cfg.stft_stride)


@functools.lru_cache(maxsize=8)
def mel_to_linear_operator(n_fft: int, sample_rate: int, device: torch.device) -> torch.Tensor:
    """:func:`rebin.mel_to_linear_matrix` as float32 on ``device``, made
    once."""
    return torch.from_numpy(mel_to_linear_matrix(n_fft, sample_rate).astype(np.float32)).to(device)


def mel_to_linear(x: torch.Tensor, a: torch.Tensor) -> torch.Tensor:
    """``(M, T, n_mel)`` frames on the mel bins -> ``(M, n_freq, T)`` on the
    linear ones: ``(x @ a)`` transposed, made in that layout by one batched
    product in float32 (TF32 off).  ``mel_to_linear.launches`` counts
    calls."""
    with library_numerics():
        out = torch.bmm(a.t().expand(x.shape[0], -1, -1), x.transpose(1, 2))
    mel_to_linear.launches += 1
    return out


mel_to_linear.launches = 0


def mel_if_to_real_imag(img: torch.Tensor, cfg: AudioConfig) -> tuple[torch.Tensor, torch.Tensor]:
    """GANSynth's ``specgrams_helper.melspecgrams_to_specgrams`` and
    ``specgrams_to_stfts``: ``(M, 2, T, n_mel)`` float32 images (time x
    frequency) -> real and imaginary parts ``(M, n_fft // 2 + 1, T)``.

    ``L = 8 Y0 - 5`` (the log-mel magnitude squared in [-13, 3]: the
    source's normalizer takes its constants from its dataset, which it does
    not publish), ``P = Y1``; ``|S|^2 = exp(L) @ A`` and the phase ``cumsum_t(pi
    P) @ A`` (:func:`mel_to_linear`, span ``mg.synth.mel``); the spectrum
    ``sqrt(|S|^2 + 1e-6) e^{i phase}`` over the linear bins and a zero
    Nyquist row.  The source takes the linear phase through its
    instantaneous frequency and a prefix sum again: that is its unwrap,
    which ``e^{i phase}`` does not see, so it is left out."""
    if cfg.freq_scale != "mel_if":
        raise ValueError(f"mel_if_to_real_imag: an AudioConfig of mel_if images, not {cfg}")
    m, two, t, n_mel = img.shape
    if two != 2 or n_mel != cfg.n_fft // 2:
        raise ValueError(f"mel_if_to_real_imag: image {tuple(img.shape)} for n_fft {cfg.n_fft}")
    a = mel_to_linear_operator(cfg.n_fft, cfg.sample_rate, img.device)
    mag2 = torch.exp(img[:, 0] * 8.0 - 5.0)
    phase = torch.cumsum(img[:, 1] * math.pi, dim=1)
    with profiling.span("mg.synth.mel"):
        mag2, phase = mel_to_linear(mag2, a), mel_to_linear(phase, a)
    n = a.shape[1]
    real, imag = img.new_empty(m, n + 1, t), img.new_empty(m, n + 1, t)
    real[:, n].zero_()
    imag[:, n].zero_()
    mag = torch.sqrt(mag2.add_(1e-6))
    torch.mul(mag, torch.cos(phase), out=real[:, :n])
    torch.mul(mag, torch.sin(phase), out=imag[:, :n])
    return real, imag
