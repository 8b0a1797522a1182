"""Primitive layers of the generator and the critic, NCHW, plain PyTorch.

Counterparts of ``musicgan_tpu/models/layers.py`` (which is NHWC).  They
are the plain versions that the hand-written kernels of ``ops/`` are held
against.  Weights are in PyTorch's OIHW layout.  On the card, callers that
use these as a yardstick keep TF32 off
(``torch.backends.cudnn.allow_tf32 = False``): cuDNN convolutions run in
TF32 by default.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

__all__ = [
    "conv2d",
    "linear",
    "leaky_relu",
    "pixel_norm",
    "upsample_nearest_2x",
    "avg_pool_2x",
    "conv3x3_on_nearest_up2x",
]


def conv2d(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor | None) -> torch.Tensor:
    """3x3/1x1 'same' convolution, ``(B, cin, H, W)`` -> ``(B, cout, H, W)``."""
    return F.conv2d(x, w, b, padding="same")


def linear(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``(B, cin) @ (cout, cin).T + b`` (reference ``layers.py:123-134``;
    the weight is in PyTorch's ``(cout, cin)`` layout)."""
    return F.linear(x, w, b)


def leaky_relu(x: torch.Tensor, slope: float = 0.2) -> torch.Tensor:
    return torch.where(x >= 0, x, slope * x)


def pixel_norm(x: torch.Tensor, eps: float = 1e-8) -> torch.Tensor:
    """ProGAN pixelwise feature norm over channels (dim 1 in NCHW;
    reference ``layers.py:5-23``)."""
    mean_sq = torch.mean(torch.square(x), dim=1, keepdim=True)
    return x * torch.rsqrt(mean_sq + eps)


def upsample_nearest_2x(x: torch.Tensor) -> torch.Tensor:
    """Nearest-neighbor 2x upsample, NCHW (reference ``generator.py:25-28``)."""
    b, c, h, w = x.shape
    return x[:, :, :, None, :, None].expand(b, c, h, 2, w, 2).reshape(b, c, 2 * h, 2 * w)


def avg_pool_2x(x: torch.Tensor) -> torch.Tensor:
    """2x2/2 average pool, NCHW (reference ``layers.py:168-171``)."""
    b, c, h, w = x.shape
    return x.reshape(b, c, h // 2, 2, w // 2, 2).mean(dim=(3, 5))


def subpixel_phase_kernels(w: torch.Tensor) -> list[torch.Tensor]:
    """OIHW 3x3 kernel -> the four 2x2 phase kernels of
    ``conv3x3(upsample_nearest_2x(x))``, index ``a * 2 + b`` for output
    pixel ``(2i+a, 2j+b)``.  On a nearest-2x grid the 3x3 window touches
    2x2 distinct source pixels; taps aliasing the same pixel are summed.
    Phase ``a = 0`` sources rows ``(i-1, i)`` with taps ``(w0 | w1+w2)``,
    ``a = 1`` rows ``(i, i+1)`` with ``(w0+w1 | w2)``; columns alike."""
    rows = [
        torch.stack([w[:, :, 0], w[:, :, 1] + w[:, :, 2]], dim=2),  # a = 0
        torch.stack([w[:, :, 0] + w[:, :, 1], w[:, :, 2]], dim=2),  # a = 1
    ]

    def col_comb(wa, b):
        if b == 0:
            return torch.stack([wa[..., 0], wa[..., 1] + wa[..., 2]], dim=-1)
        return torch.stack([wa[..., 0] + wa[..., 1], wa[..., 2]], dim=-1)

    return [col_comb(rows[a], b) for a in (0, 1) for b in (0, 1)]


def subpixel_conv(x: torch.Tensor, phase_kernels, b: torch.Tensor) -> torch.Tensor:
    """Apply four OIHW 2x2 phase kernels to ``(B, cin, H, W)`` and
    interleave the phases into ``(B, cout, 2H, 2W)`` (+ bias)."""
    bsz, _, h, w = x.shape
    # Padding (left, right, top, bottom) selects the source pair of a phase.
    pads = {0: (1, 0), 1: (0, 1)}
    ys = [
        F.conv2d(F.pad(x, pads[p & 1] + pads[p >> 1]), k)
        for p, k in enumerate(phase_kernels)
    ]
    cout = ys[0].shape[1]
    t = torch.stack(ys, dim=-1).reshape(bsz, cout, h, w, 2, 2)
    out = t.permute(0, 1, 2, 4, 3, 5).reshape(bsz, cout, 2 * h, 2 * w)
    return out + b[None, :, None, None]


def conv3x3_on_nearest_up2x(
    x: torch.Tensor, w: torch.Tensor, b: torch.Tensor
) -> torch.Tensor:
    """``conv3x3(upsample_nearest_2x(x))`` without the upsampled tensor
    (sub-pixel decomposition, 2.25x fewer MACs); equal to the naive path."""
    return subpixel_conv(x, subpixel_phase_kernels(w), b)
