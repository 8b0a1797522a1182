"""Batch transforms of the train step's input pipeline, on the batch's
device (counterpart of ``musicgan_tpu/audio/transforms.py``).

The raw full-resolution batch is shipped to the device once and all
per-stage scaling happens there.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

__all__ = ["channel_min_max_norm", "change_range", "resize_batch", "grower_transform"]


def channel_min_max_norm(x: torch.Tensor, epsilon: float = 1e-8) -> torch.Tensor:
    """Per-sample, per-channel min-max to [0, 1] on ``(B, C, H, W)``
    (reference ``audio/transforms.py:8-31``)."""
    assert x.ndim == 4
    x_min = x.amin(dim=(2, 3), keepdim=True)
    x_max = x.amax(dim=(2, 3), keepdim=True)
    return (x - x_min) / (x_max - x_min + epsilon)


def change_range(x: torch.Tensor, lower: float, upper: float) -> torch.Tensor:
    """Affine remap of a [0, 1] tensor into [lower, upper]
    (reference ``audio/transforms.py:34-40``)."""
    return x * (upper - lower) + lower


def resize_batch(x: torch.Tensor, size: int) -> torch.Tensor:
    """Resize ``(B, C, H, W)`` images to ``(B, C, size, size)``: bilinear
    with half-pixel centres and no antialiasing, which is what JAX's
    ``jax.image.resize(..., "bilinear", antialias=False)`` computes and what
    the reference era's ``torchvision.transforms.Resize`` did on tensors."""
    return F.interpolate(
        x, size=(size, size), mode="bilinear", align_corners=False, antialias=False
    )


def grower_transform(x: torch.Tensor, size: int) -> torch.Tensor:
    """The per-stage input pipeline (reference ``utils.py:70-86``):
    per-channel min-max -> [-1, 1] -> resize to the current stage size."""
    x = channel_min_max_norm(x)
    x = change_range(x, -1.0, 1.0)
    if size != x.shape[-1]:
        x = resize_batch(x, size)
    return x
