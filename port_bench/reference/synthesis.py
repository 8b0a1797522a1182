"""Plain reference of synthesis: latent -> magnitude / IF image -> waveform.

The generator follows the reference repository's ``networks/generator.py``
(Ipsedo/MusicGAN): eight blocks of conv3x3, LeakyReLU, PixelNorm, nearest
2x upsample, conv3x3, LeakyReLU, PixelNorm, then the stage's head, a 1x1
conv and tanh.  At the fully grown stage with alpha 1 the fade branch adds
nothing and is left out.  The vocoder follows its ``audio/functions.py``:
the magnitude channel is bark-unscaled and divided by the clip's span, the
instantaneous frequency is summed over time into a phase, and an inverse
STFT (Hann window of 1024, hop 256, ``normalized=True``, centred) gives the
waveform.  Here the inverse FFT is ``torch.fft.irfft``.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

__all__ = ["load_generator", "generator_image", "vocode"]


def load_generator(path: str, n_blocks: int, device) -> dict:
    """The reference repository's saved generator (``state_dict`` with its
    own names: block ``i``'s convs at ``_Generator__gen_blocks.i.0`` and
    ``.i.4``, the head at ``_Generator__end_block.0``) as a dict of float32
    tensors on ``device``: ``conv1.i``, ``conv2.i`` (weight, bias) and
    ``head``."""
    sd = torch.load(path, map_location="cpu", weights_only=True)
    w = {}
    for i in range(n_blocks):
        pre = f"_Generator__gen_blocks.{i}"
        w[f"conv1.{i}"] = (sd[f"{pre}.0.weight"], sd[f"{pre}.0.bias"])
        w[f"conv2.{i}"] = (sd[f"{pre}.4.weight"], sd[f"{pre}.4.bias"])
    w["head"] = (sd["_Generator__end_block.0.weight"], sd["_Generator__end_block.0.bias"])
    return {k: tuple(t.to(device, torch.float32) for t in v) for k, v in w.items()}


def _conv(x, wb, rounding):
    w, b = wb
    if rounding is not None:
        x, w = rounding(x), rounding(w)
    return F.conv2d(x, w, b, padding=w.shape[-1] // 2)


def _pixel_norm(x, eps):
    return x * torch.rsqrt(torch.mean(x * x, dim=1, keepdim=True) + eps)


def generator_image(weights: dict, z_nhwc: torch.Tensor, n_blocks: int, slope: float = 0.2,
                    eps: float = 1e-8, rounding=None) -> torch.Tensor:
    """``(B, h, w, C)`` latent -> ``(B, 2, h * 2**n_blocks, w *
    2**n_blocks)`` image in [-1, 1]."""
    x = z_nhwc.permute(0, 3, 1, 2).to(torch.float32)
    for i in range(n_blocks):
        x = _pixel_norm(F.leaky_relu(_conv(x, weights[f"conv1.{i}"], rounding), slope), eps)
        x = F.interpolate(x, scale_factor=2, mode="nearest")
        x = _pixel_norm(F.leaky_relu(_conv(x, weights[f"conv2.{i}"], rounding), slope), eps)
    return torch.tanh(_conv(x, weights["head"], rounding))


def _bark_scale(n_bins: int, sample_rate: int, device) -> torch.Tensor:
    """``6 arcsinh(f / 600)`` over 20 Hz .. Nyquist, unit 2-norm, float32."""
    f = np.linspace(20.0, sample_rate // 2, n_bins)
    s = 6.0 * np.arcsinh(f / 600.0)
    return torch.from_numpy((s / np.linalg.norm(s)).astype(np.float32)).to(device)


def vocode(img: torch.Tensor, n_fft: int = 1024, hop: int = 256, sample_rate: int = 44100,
           rounding=None) -> torch.Tensor:
    """``(B, 2, n_fft // 2, T)`` image -> ``(B, (T - 1) * hop)`` waveforms.
    ``rounding`` (a control's) rounds every tensor the vocoder makes: the
    magnitude and the phase (after the prefix sum), the spectrum's parts,
    the frames."""
    q = rounding if rounding is not None else (lambda x: x)
    b, _, n_bins, t = img.shape
    magn = q((img[:, 0] + 1.0) / 2.0 / _bark_scale(n_bins, sample_rate, img.device)[:, None])
    magn = q(magn / (magn.amax(dim=(1, 2), keepdim=True) - magn.amin(dim=(1, 2), keepdim=True)))
    phase = q(torch.cumsum(q((img[:, 1] + 1.0) / 2.0 * 2.0 * math.pi - math.pi), dim=-1))
    phase = torch.remainder(phase, 2 * math.pi)
    spec = torch.polar(magn, phase)
    # The inverse real FFT of a real signal reads no imaginary part at the
    # DC and Nyquist bins; cuFFT's does, so it is made 0 here.
    spec[:, 0] = spec[:, 0].real
    spec = F.pad(spec, (0, 0, 0, 1))  # the Nyquist row the images drop
    window = torch.hann_window(n_fft, periodic=True, dtype=torch.float64).to(img.device, torch.float32)
    spec = spec * torch.sqrt(torch.sum(window * window))
    spec = torch.complex(q(spec.real), q(spec.imag))
    frames = q(torch.fft.irfft(spec.transpose(1, 2), n=n_fft, dim=-1)) * window  # (B, T, n_fft)
    r = n_fft // hop
    out = img.new_zeros(b, t + r - 1, hop)
    env = img.new_zeros(t + r - 1, hop)
    wsq = (window * window).reshape(r, hop)
    for j in range(r):
        out[:, j : j + t] += frames[:, :, j * hop : (j + 1) * hop]
        env[j : j + t] += wsq[j]
    out = (out / env.clamp(min=1e-11)).reshape(b, -1)
    return out[:, n_fft // 2 : n_fft // 2 + (t - 1) * hop]
