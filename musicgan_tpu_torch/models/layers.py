"""Primitive layers of the generator and the critic, NCHW, plain PyTorch.

Counterparts of ``musicgan_tpu/models/layers.py`` (which is NHWC).  They
are the plain versions that the hand-written kernels of ``ops/`` are held
against, and the library lowerings of the ``conv_impl`` names ``"xla"``
and ``"subpixel"`` (``conv2d``, ``linear``, ``conv3x3_on_nearest_up2x`` in
a ``compute_dtype``, as the JAX package computes those outside any Pallas
kernel).  Weights are in PyTorch's OIHW layout.  cuDNN convolutions run in
TF32 by default (``torch.backends.cudnn.allow_tf32``): the lowerings run
under :func:`library_numerics`, and callers that use these as a yardstick
on the card keep TF32 off themselves.
"""

from __future__ import annotations

import contextlib

import torch
import torch.nn.functional as F

__all__ = [
    "library_numerics",
    "conv2d_same",
    "conv2d",
    "linear",
    "leaky_relu",
    "pixel_norm",
    "upsample_nearest_2x",
    "avg_pool_2x",
    "conv3x3_on_nearest_up2x",
]


@contextlib.contextmanager
def library_numerics(deterministic: bool = False):
    """The library lowerings' numerics on the card, each flag restored on
    exit: float32 convolutions and products in float32, not TF32 (cuDNN's
    default would be quietly less precise than the kernels' 3xTF32), and with
    ``deterministic`` cuDNN's deterministic algorithms and no benchmark
    search (its default weight gradients sum in an order that changes from
    run to run, and a train run must resume bit for bit).  Set by hand: the
    ``torch.backends.cudnn.flags`` context also switches cuDNN off."""
    cudnn, matmul = torch.backends.cudnn, torch.backends.cuda.matmul
    saved = (cudnn.allow_tf32, matmul.allow_tf32, cudnn.deterministic, cudnn.benchmark)
    cudnn.allow_tf32 = matmul.allow_tf32 = False
    if deterministic:
        cudnn.deterministic, cudnn.benchmark = True, False
    try:
        yield
    finally:
        cudnn.allow_tf32, matmul.allow_tf32, cudnn.deterministic, cudnn.benchmark = saved


def _bias(out: torch.Tensor, b: torch.Tensor | None) -> torch.Tensor:
    return out if b is None else out + b[None, :, None, None]


def _checked(name: str, out: torch.Tensor) -> torch.Tensor:
    """``train --debug-nans``'s check of a library lowering's output, as the
    kernel wrappers check theirs (``ops/nan_check.py``; imported here at
    call time, ``ops`` imports this module)."""
    from ..ops.nan_check import checked

    return checked(name, out)


def conv2d_same(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor | None) -> torch.Tensor:
    """3x3/1x1 'same' convolution in ``x``'s dtype, ``(B, cin, H, W)`` ->
    ``(B, cout, H, W)``: the conv of the kernels' plain versions."""
    return F.conv2d(x, w, b, padding="same")


def conv2d(
    x: torch.Tensor, w: torch.Tensor, b: torch.Tensor | None, compute_dtype: torch.dtype = torch.float32
) -> torch.Tensor:
    """The library lowering's 3x3/1x1 'same' convolution.

    JAX's rule (``musicgan_tpu/models/layers.py::conv2d``): in float32 a
    float32 product; in bf16 both operands are cast to bf16, the conv runs
    and rounds in bf16, the result is cast to float32 and then the bias is
    added (bf16 operands with a float32 result break the conv's transpose
    under JAX's grad, so the JAX package computes in bf16 throughout)."""
    if compute_dtype == torch.float32:
        return _checked("conv2d", conv2d_same(x, w, b))
    out = F.conv2d(x.to(compute_dtype), w.to(compute_dtype), padding="same")
    return _checked("conv2d", _bias(out.to(torch.float32), b))


def linear(
    x: torch.Tensor, w: torch.Tensor, b: torch.Tensor, compute_dtype: torch.dtype = torch.float32
) -> torch.Tensor:
    """``(B, cin) @ (cout, cin).T + b`` (reference ``layers.py:123-134``;
    the weight is in PyTorch's ``(cout, cin)`` layout), in ``compute_dtype``
    by :func:`conv2d`'s rule."""
    if compute_dtype == torch.float32:
        return _checked("linear", F.linear(x, w, b))
    return _checked("linear", F.linear(x.to(compute_dtype), w.to(compute_dtype)).to(torch.float32) + b)


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
    return _bias(out, b)


def conv3x3_on_nearest_up2x(
    x: torch.Tensor, w: torch.Tensor, b: torch.Tensor, compute_dtype: torch.dtype = torch.float32
) -> torch.Tensor:
    """``conv3x3(upsample_nearest_2x(x))`` without the upsampled tensor
    (sub-pixel decomposition, 2.25x fewer MACs); equal to the naive path,
    and twice differentiable through autograd.  In bf16 the weight is cast
    first and the aliasing taps are summed in bf16, as JAX's function does,
    and each phase's bf16 result is cast to float32 before the bias."""
    if compute_dtype == torch.float32:
        out = subpixel_conv(x, subpixel_phase_kernels(w), b)
    else:
        phases = subpixel_phase_kernels(w.to(compute_dtype))
        out = _bias(subpixel_conv(x.to(compute_dtype), phases, None).to(torch.float32), b)
    return _checked("conv3x3_on_nearest_up2x", out)
