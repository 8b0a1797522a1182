"""Perceptual frequency re-binning (mel / bark / ERB) as matrix products.

Counterpart of ``musicgan_tpu/audio/rebin.py``.  The reference explores
re-binning STFT rows into perceptual-scale buckets in a notebook with
``torch_scatter.scatter_mean``; here, as in JAX, re-binning is a product
with a precomputed bucket-averaging operator (exactly scatter-mean), and
its round trip a product with the operator that broadcasts each bucket back
over its member rows.  The operators are built in numpy; the products run
on the device of the spectrum.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

__all__ = ["scale_frequencies", "rebin_operator", "rebin", "unbin"]


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
