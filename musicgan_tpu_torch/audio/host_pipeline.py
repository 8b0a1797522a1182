"""Host-side per-stage input pipeline (numpy mirror of the device path;
counterpart of ``musicgan_tpu/audio/host_pipeline.py``).

The train step can run the full input pipeline on the device
(``audio/transforms.py::grower_transform``), but shipping raw
512x512 batches to the device costs 12.6 MB/step that the early growth
stages immediately throw away (a 4x4 stage consumes 768 bytes of it).
This module runs min-max -> [-1, 1] -> bilinear resize on the
host (inside the prefetch thread), so the host->device transfer scales
with the *stage* resolution: 16,000x less data at stage 0.

The resize operator is half-pixel sampling with an unwidened triangle
kernel (the reference era's torchvision Resize semantics, what
``audio/transforms.py::resize_batch`` computes on the device), so host and
device pipelines are interchangeable.
"""

from __future__ import annotations

import functools

import numpy as np

__all__ = ["resize_operator", "prepare_batch"]


@functools.lru_cache(maxsize=32)
def resize_operator(src: int, dst: int) -> np.ndarray:
    """1-D linear resize matrix ``A`` (dst, src): ``out = A @ x`` is the
    bilinear resize without antialiasing."""
    if src == dst:
        return np.eye(src, dtype=np.float32)
    scale = dst / src
    out_idx = np.arange(dst, dtype=np.float64)
    sample = (out_idx + 0.5) / scale - 0.5  # half-pixel centers
    in_idx = np.arange(src, dtype=np.float64)
    t = in_idx[None, :] - sample[:, None]  # antialias=False: unwidened tri
    weights = np.maximum(0.0, 1.0 - np.abs(t))
    weights /= weights.sum(axis=1, keepdims=True)
    return weights.astype(np.float32)


def prepare_batch(
    x: np.ndarray, size: int, out_dtype=np.float32
) -> np.ndarray:
    """(B, 2, 512, 512) raw batch -> (B, 2, size, size), per-sample
    per-channel min-max to [-1, 1] then resize — identical semantics to
    the reference transform chain (reference ``utils.py:70-86``)."""
    x = x.astype(np.float32, copy=False)
    x_min = x.min(axis=(2, 3), keepdims=True)
    x_max = x.max(axis=(2, 3), keepdims=True)
    x = (x - x_min) / (x_max - x_min + 1e-8)
    x = x * 2.0 - 1.0
    if size != x.shape[-1]:
        a = resize_operator(x.shape[2], size)  # (size, 512)
        # separable: rows then cols, batched over (B, C)
        x = np.einsum("ij,bcjk->bcik", a, x, optimize=True)
        x = np.einsum("kj,bcij->bcik", a, x, optimize=True)
    return np.ascontiguousarray(x, dtype=out_dtype)
