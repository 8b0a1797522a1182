"""Plain reference of GANSynth's synthesis: latent and pitch -> log-mel /
mel-IF image -> waveform.

The model is the "IF-Mel + H" generator of Engel et al., *GANSynth:
Adversarial Neural Audio Synthesis* (ICLR 2019, https://arxiv.org/abs/1902.08710,
its Appendix B), in magenta's ``magenta/models/gansynth`` (``lib/networks.py``
over ``tensorflow_gan``'s progressive GAN ``generator``,
``lib/specgrams_helper.py``, ``lib/spectral_ops.py``):

* input ``x0 = [z, onehot(pitch)]``, pixel-normed over its values;
* block 1: the source's ``(h, w)`` VALID conv on the input zero-padded to
  ``(2h - 1, 2w - 1)`` (here ``F.conv2d`` on exactly that), LeakyReLU 0.2,
  PixelNorm (eps 1e-8), a 3x3 conv at the same width, LeakyReLU, PixelNorm;
* blocks 2 on: nearest 2x up, 3x3 conv to the block's width, LeakyReLU,
  PixelNorm, 3x3 conv, LeakyReLU, PixelNorm;
* ``to_rgb``: a 1x1 conv to 2 channels and tanh: the (time, mel) image of
  the normalized log-mel magnitude squared and the mel instantaneous
  frequency in units of pi;
* the vocoder: ``exp`` of the denormalized magnitude and the prefix sum over
  time of ``pi`` times the frequency, each times the mel-to-linear matrix,
  ``sqrt(|S|^2 + 1e-6) e^{i phase}`` with a zero Nyquist bin, an inverse
  STFT with a periodic Hann window (``torch.fft.irfft``, overlap-add, the
  window-square envelope divided out, the ``n_fft / 2`` centring trimmed).

Plain float32 PyTorch with TF32 off (the caller's ``lower.numerics``); it
imports nothing of the program.  Departures from the source:

* weights are random, drawn by :func:`draw_weights` as ``N(0, 2 / fan_in)``
  (``to_rgb`` ``N(0, 1 / fan_in)``) with zero biases: the equalized learning
  rate's run-time scale at initialization, the same forward as the source's
  ``N(0, 1)`` weights times ``sqrt(2 / fan_in)``; the trained checkpoints
  are not in the repository;
* the normalizer ``L = 8 Y0 - 5`` (log magnitude squared in [-13, 3]) and
  ``P = Y1``: the source computes its constants from its dataset and does
  not publish them;
* the phase: the source takes the linear phase through its instantaneous
  frequency and a prefix sum again, which is its unwrap, ``e^{i phase}``
  the same; left out;
* the crop: the first ``crop`` samples of the centred inverse (the source
  crops its uncentred inverse by a hop), the envelope divided out at the
  edges as at the centre.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

__all__ = ["draw_weights", "generator_image", "mel_to_linear_matrix", "vocode"]


def _layers(widths, n_in: int, start) -> list[tuple[str, tuple, float]]:
    """``(name, OIHW shape, gain)`` of every conv in the source's order."""
    out = [("b1.dense", (widths[0], n_in, *start), 2.0), ("b1.conv", (widths[0], widths[0], 3, 3), 2.0)]
    for k in range(1, len(widths)):
        out.append((f"b{k + 1}.conv0", (widths[k], widths[k - 1], 3, 3), 2.0))
        out.append((f"b{k + 1}.conv1", (widths[k], widths[k], 3, 3), 2.0))
    out.append(("to_rgb", (2, widths[-1], 1, 1), 1.0))
    return out


def draw_weights(widths, n_latent: int, n_classes: int, start, generator: torch.Generator, device) -> dict:
    """Every conv's ``(weight, bias)`` in float32 on ``device``:
    ``N(0, gain / fan_in)`` from ``generator`` in the source's layer order,
    zero biases.  ``widths``: the channels of each block (GANSynth's
    published ``min(4096 / 2^k, 256)``: 256, 256, 256, 256, 128, 64, 32)."""
    w = {}
    for name, shape, gain in _layers(widths, n_latent + n_classes, start):
        fan_in = shape[1] * shape[2] * shape[3]
        weight = torch.randn(shape, generator=generator, device=device) * math.sqrt(gain / fan_in)
        w[name] = (weight, torch.zeros(shape[0], device=device))
    return w


def _pixel_norm(x, eps):
    return x * torch.rsqrt(torch.mean(x * x, dim=1, keepdim=True) + eps)


def _conv(x, wb, rounding, padding):
    w, b = wb
    if rounding is not None:
        x, w = rounding(x), rounding(w)
    return F.conv2d(x, w, b, padding=padding)


def generator_image(weights: dict, z: torch.Tensor, labels: torch.Tensor, n_classes: int, slope: float = 0.2,
                    eps: float = 1e-8, rounding=None) -> torch.Tensor:
    """``(B, C)`` (or ``(B, 1, 1, C)``) latents and ``(B,)`` class indices ->
    ``(B, 2, T, n_mel)`` images in [-1, 1].  ``labels`` None: the one-hot
    all zeros (the pitch left out, what the pitch's own effect on the image
    is read against).  ``rounding`` (a control's) rounds both operands of
    every conv."""
    bsz = z.shape[0]
    x = z.reshape(bsz, -1).to(torch.float32)
    onehot = (x.new_zeros(bsz, n_classes) if labels is None
              else F.one_hot(labels.to(x.device, torch.long), n_classes).to(torch.float32))
    x = torch.cat([x, onehot], dim=1)
    x = _pixel_norm(x, eps)[:, :, None, None]
    h, w = weights["b1.dense"][0].shape[2:]
    x = F.pad(x, (w - 1, w - 1, h - 1, h - 1))
    x = _pixel_norm(F.leaky_relu(_conv(x, weights["b1.dense"], rounding, 0), slope), eps)
    x = _pixel_norm(F.leaky_relu(_conv(x, weights["b1.conv"], rounding, 1), slope), eps)
    k = 2
    while f"b{k}.conv0" in weights:
        x = F.interpolate(x, scale_factor=2, mode="nearest")
        for j in (0, 1):
            x = _pixel_norm(F.leaky_relu(_conv(x, weights[f"b{k}.conv{j}"], rounding, 1), slope), eps)
        k += 1
    return torch.tanh(_conv(x, weights["to_rgb"], rounding, 0))


def _hz_to_mel(f):
    return 1127.0 * np.log(1.0 + np.asarray(f, np.float64) / 700.0)


def _mel_to_hz(m):
    return 700.0 * (np.exp(np.asarray(m, np.float64) / 1127.0) - 1.0)


def mel_to_linear_matrix(n_fft: int, sample_rate: int) -> np.ndarray:
    """The source's ``_mel_to_linear_matrix`` over ``n_fft // 2`` mel and
    linear bins, 0 Hz to the Nyquist, in float64: ``W[f, m]`` the triangle
    of band ``m`` (edges ``m, m + 1, m + 2`` of ``n + 2`` evenly spaced in
    HTK mel; in band order, a band narrower than ``1.5 nyquist / n`` Hz
    widened to ``centre +- 1127 asinh(0.5 th / (centre_hz + 700))`` mel,
    written through views of the one edge array as the source's loop does,
    so that it moves its neighbours' edges) at bin ``f``'s frequency
    ``linspace(0, nyquist, n)[f]``, the DC bin's row zero; then ``W^T
    diag(d)``, ``d_f`` one over the column sum ``f`` of ``W W^T`` where that
    sum is above 1e-8, else the sum.  ``(n_mel, n_freq)``."""
    n, nyq = n_fft // 2, sample_rate / 2.0
    edges = np.linspace(_hz_to_mel(0.0), _hz_to_mel(nyq), n + 2)
    lower, center, upper = edges[:-2], edges[1:-1], edges[2:]  # views, as in the source
    th = 1.5 * nyq / n
    for m in range(n):
        if _mel_to_hz(upper[m]) - _mel_to_hz(lower[m]) < th:
            rhs = 0.5 * th / (_mel_to_hz(center[m]) + 700.0)
            dm = 1127.0 * np.log(rhs + np.sqrt(1.0 + rhs**2))
            lower[m] = center[m] - dm
            upper[m] = center[m] + dm
    freqs = np.linspace(0.0, nyq, n)
    w = np.zeros((n, n))
    for m in range(n):
        lo_hz, c_hz, up_hz = _mel_to_hz(lower[m]), _mel_to_hz(center[m]), _mel_to_hz(upper[m])
        f = freqs[1:]
        w[1:, m] = np.maximum(0.0, np.minimum((f - lo_hz) / (c_hz - lo_hz), (up_hz - f) / (up_hz - c_hz)))
    col = (w @ w.T).sum(axis=0)
    d = np.array([1.0 / s if abs(s) > 1e-8 else s for s in col])
    return w.T @ np.diag(d)


_MATRICES: dict = {}


def _matrix(n_fft: int, sample_rate: int, device) -> torch.Tensor:
    key = (n_fft, sample_rate, str(device))
    if key not in _MATRICES:
        _MATRICES[key] = torch.from_numpy(mel_to_linear_matrix(n_fft, sample_rate).astype(np.float32)).to(device)
    return _MATRICES[key]


def vocode(img: torch.Tensor, n_fft: int = 2048, hop: int = 512, sample_rate: int = 16000, crop: int = 64000,
           rounding=None) -> torch.Tensor:
    """``(B, 2, T, n_fft // 2)`` images -> ``(B, crop)`` waveforms (all
    ``(T - 1) * hop`` samples for ``crop`` 0).  ``rounding`` (a control's)
    rounds every tensor the vocoder makes and both operands of each mel
    product: the magnitude, the prefix-summed phase, the matrix, the
    products, the spectrum's parts, the frames."""
    q = rounding if rounding is not None else (lambda x: x)
    b, _, t, _ = img.shape
    a = q(_matrix(n_fft, sample_rate, img.device))
    mag2 = q(q(torch.exp(img[:, 0] * 8.0 - 5.0)) @ a)  # (B, T, n_freq)
    phase = q(q(torch.cumsum(img[:, 1] * math.pi, dim=1)) @ a)
    spec = F.pad(torch.polar(torch.sqrt(mag2 + 1e-6), phase), (0, 1))  # the Nyquist bin
    spec = torch.complex(q(spec.real), q(spec.imag))
    window = torch.hann_window(n_fft, periodic=True, dtype=torch.float64).to(img.device, torch.float32)
    frames = q(torch.fft.irfft(spec, n=n_fft, dim=-1)) * window  # (B, T, n_fft)
    r = n_fft // hop
    out = img.new_zeros(b, t + r - 1, hop)
    env = img.new_zeros(t + r - 1, hop)
    wsq = (window * window).reshape(r, hop)
    for j in range(r):
        out[:, j : j + t] += frames[:, :, j * hop : (j + 1) * hop]
        env[j : j + t] += wsq[j]
    out = (out / env.clamp(min=1e-11)).reshape(b, -1)[:, n_fft // 2 : n_fft // 2 + (t - 1) * hop]
    return out[:, :crop] if crop else out
