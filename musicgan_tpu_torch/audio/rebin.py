"""Perceptual frequency re-binning (mel / bark / ERB) as matrix products.

Counterpart of ``musicgan_tpu/audio/rebin.py``.  The reference explores
re-binning STFT rows into perceptual-scale buckets in a notebook with
``torch_scatter.scatter_mean``; here, as in JAX, re-binning is a product
with a precomputed bucket-averaging operator (exactly scatter-mean), and
its round trip a product with the operator that broadcasts each bucket back
over its member rows.  The operators are built in numpy; the products run
on the device of the spectrum.

GANSynth's mel spectrograms (``magenta/models/gansynth/lib/spectral_ops.py``,
``specgrams_helper.py``) are made by another operator, triangular HTK-mel
bands with a least width: :func:`linear_to_mel_weight_matrix`, and turned
back to the linear bins by :func:`mel_to_linear_matrix`.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

__all__ = ["scale_frequencies", "rebin_operator", "rebin", "unbin", "mel_band_edges",
           "linear_to_mel_weight_matrix", "mel_to_linear_matrix"]


def scale_frequencies(scale: str, n_freqs: int, sample_rate: int = 44100) -> np.ndarray:
    """Map linear FFT-bin center frequencies onto a perceptual scale."""
    f = np.linspace(0.0, sample_rate / 2, n_freqs)
    if scale == "mel":
        return 2595.0 * np.log10(1.0 + f / 700.0)
    if scale == "bark":
        return 6.0 * np.arcsinh(f / 600.0)
    if scale == "erb":
        return 24.7 * 9.265 * np.log1p(f / (24.7 * 9.265))
    if scale == "linear":
        return f
    raise ValueError(f"unknown scale {scale!r}")


@functools.lru_cache(maxsize=16)
def rebin_operator(
    scale: str, n_freqs: int, n_bins: int, sample_rate: int = 44100
) -> tuple[np.ndarray, np.ndarray]:
    """(A, A_inv): ``A @ spec`` averages FFT rows into ``n_bins`` equal-width
    buckets on the perceptual scale (== scatter_mean); ``A_inv @ binned``
    broadcasts each bucket back over its member rows."""
    s = scale_frequencies(scale, n_freqs, sample_rate)
    edges = np.linspace(s[0], s[-1], n_bins + 1)
    bucket = np.clip(np.searchsorted(edges, s, side="right") - 1, 0, n_bins - 1)

    a = np.zeros((n_bins, n_freqs), np.float32)
    a[bucket, np.arange(n_freqs)] = 1.0
    counts = np.maximum(a.sum(axis=1, keepdims=True), 1.0)
    a_mean = a / counts                      # (n_bins, n_freqs): scatter-mean
    a_inv = a.T.astype(np.float32)           # broadcast back to member rows
    return a_mean, a_inv


def _operator_on(a: np.ndarray, like: torch.Tensor) -> torch.Tensor:
    return torch.from_numpy(a).to(like.device, like.dtype)


def rebin(
    spec: torch.Tensor, scale: str = "bark", n_bins: int = 128, sample_rate: int = 44100
) -> torch.Tensor:
    """(n_freqs, T) magnitude -> (n_bins, T) perceptual-scale bins."""
    a, _ = rebin_operator(scale, spec.shape[0], n_bins, sample_rate)
    return _operator_on(a, spec) @ spec


def unbin(
    binned: torch.Tensor, n_freqs: int, scale: str = "bark", sample_rate: int = 44100
) -> torch.Tensor:
    """(n_bins, T) -> (n_freqs, T): each FFT row takes its bucket's value."""
    _, a_inv = rebin_operator(scale, n_freqs, binned.shape[0], sample_rate)
    return _operator_on(a_inv, binned) @ binned


def _hz_to_mel(f):
    """HTK mel: ``1127 ln(1 + f / 700)`` (written as the source writes it:
    the widening's chained steps carry its roundings)."""
    return 1127.0 * np.log(1.0 + np.asarray(f, np.float64) / 700.0)


def _mel_to_hz(m):
    return 700.0 * (np.exp(np.asarray(m, np.float64) / 1127.0) - 1.0)


def mel_band_edges(n_mel: int, n_freq: int, sample_rate: int, lower_hz: float = 0.0,
                   upper_hz: float | None = None) -> np.ndarray:
    """The ``n_mel + 2`` HTK-mel edges of GANSynth's bands, float64: evenly
    spaced from ``lower_hz`` to ``upper_hz`` (the Nyquist by default), band
    ``i`` the edges ``i, i + 1, i + 2``.  In band order, a band narrower than
    1.5 bin widths (``nyquist / n_freq``) is widened to ``centre +- 1127
    asinh(0.5 th / (centre_hz + 700))``, written into the one array: the
    source's lower, centre and upper edges are numpy views of it, so a
    widened band moves the centre of the band after it, which the next step
    then reads."""
    nyquist = sample_rate / 2.0
    upper_hz = nyquist if upper_hz is None else upper_hz
    edges = np.linspace(_hz_to_mel(lower_hz), _hz_to_mel(upper_hz), n_mel + 2)
    th = 1.5 * nyquist / n_freq
    for i in range(n_mel):
        lo, c, up = _mel_to_hz(edges[i : i + 3])
        if up - lo < th:
            rhs = 0.5 * th / (c + 700.0)
            dm = 1127.0 * np.log(rhs + np.sqrt(1.0 + rhs**2))  # asinh
            edges[i], edges[i + 2] = edges[i + 1] - dm, edges[i + 1] + dm
    return edges


def linear_to_mel_weight_matrix(n_mel: int, n_freq: int, sample_rate: int, lower_hz: float = 0.0,
                                upper_hz: float | None = None) -> np.ndarray:
    """GANSynth's ``spectral_ops.linear_to_mel_weight_matrix``, float64
    ``(n_freq, n_mel)``: bin ``f`` at ``linspace(0, nyquist, n_freq)[f]``
    (the DC bin's row zero), band ``i`` a triangle over
    :func:`mel_band_edges` ``i, i + 1, i + 2``.  Weights ``max(0, min(lower
    slope, upper slope))``, the slopes linear in Hz."""
    freqs = np.linspace(0.0, sample_rate / 2.0, n_freq)[1:, None]
    edges = _mel_to_hz(mel_band_edges(n_mel, n_freq, sample_rate, lower_hz, upper_hz))
    lo, c, up = (edges[None, k : k + n_mel] for k in range(3))
    w = np.maximum(0.0, np.minimum((freqs - lo) / (c - lo), (up - freqs) / (up - c)))
    return np.pad(w, ((1, 0), (0, 0)))


@functools.lru_cache(maxsize=8)
def mel_to_linear_matrix(n_fft: int, sample_rate: int) -> np.ndarray:
    """GANSynth's ``specgrams_helper._mel_to_linear_matrix`` at ``n_fft //
    2`` mel bins over ``n_fft // 2`` linear bins (the Nyquist dropped), 0 Hz
    to the Nyquist, float64 ``(n_mel, n_freq)``: ``A = W^T diag(d)`` for
    :func:`linear_to_mel_weight_matrix`'s ``W``, ``d_f = 1 / sum_g (W
    W^T)[g, f]`` where that sum is above 1e-8, else the sum itself (so the
    DC bin's column is zero).  A mel spectrogram ``(T, n_mel) @ A`` is the
    linear one."""
    n = n_fft // 2
    w = linear_to_mel_weight_matrix(n, n, sample_rate)
    s = (w @ w.T).sum(axis=0)
    d = np.where(np.abs(s) > 1e-8, 1.0 / np.where(s == 0.0, 1.0, s), s)
    return w.T * d[None, :]
