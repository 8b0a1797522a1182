"""The ToMagnPhase head on a bf16 activation: a hand-written CUDA kernel
for Hopper beside its plain PyTorch version.

The head is a 1x1 conv from the last block's ``C`` channels to 2 (magnitude
and phase), its bias and tanh, float32 out.  In the JAX package it is XLA's
``_head_nchw`` (``musicgan_tpu/models/generator.py``), with no Pallas
kernel.  :func:`head1x1_plain` is that function in PyTorch: the activation
upcast to float32, a batched ``(2, C) @ (C, H*W)`` product, the bias, tanh;
it is differentiable and is what every float32 input takes.  On a bf16
activation those are four launches that move about five times the bytes
of the function; :func:`head1x1` (``csrc/head1x1_bf16.cu``) reads the bf16
activation once and writes the float32 image once, with float32 sums in
channel order and the full-precision ``tanhf``.

Dispatch: a CPU tensor takes the plain version, a CUDA tensor launches the
kernel or raises (the kernel takes a contiguous bf16 ``x`` and float32
weights on its device).  ``head1x1.launches`` counts launches.  The
generator picks between the kernel and the plain version by
:func:`takes_kernel`.
"""

from __future__ import annotations

import torch

from . import _build
from .nan_check import checked

__all__ = ["head1x1", "head1x1_plain", "takes_kernel"]

MAX_CHANNELS = 4096  # the kernel keeps the weights in shared memory


def takes_kernel(dtype: torch.dtype, device_type: str, needs_grad: bool) -> bool:
    """Whether a head's input takes :func:`head1x1`: a bf16 activation on a
    CUDA device with no gradient wanted.  Everything else (float32, a graph
    that needs a gradient, the CPU) takes :func:`head1x1_plain`."""
    return dtype == torch.bfloat16 and device_type == "cuda" and not needs_grad


def head1x1_plain(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``tanh(w @ x + b)`` over the channels of the NCHW ``x``: ``(B, C, H,
    W)`` -> ``(B, 2, H, W)`` in ``w``'s dtype, for ``w`` ``(2, C)`` and ``b``
    ``(2,)``.  ``x`` is cast to ``w``'s dtype first (JAX's ``_head_nchw``
    upcasts a bf16 activation), then multiplied as a batched product on
    the activation itself (an einsum over ``bchw``, or a broadcast matmul,
    would first copy it)."""
    x = x.to(w.dtype)
    bsz, c, hh, ww = x.shape
    y = torch.bmm(w.expand(bsz, -1, -1), x.reshape(bsz, c, hh * ww))
    return torch.tanh(y.reshape(bsz, -1, hh, ww) + b[None, :, None, None])


_ARGS = [_build.PTR] * 4 + [_build.INT] * 4


def head1x1(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """The same function as :func:`head1x1_plain`; on a CUDA device one
    launch of the kernel, which takes ``x`` bf16 and contiguous, ``w``
    ``(2, C)`` and ``b`` ``(2,)`` float32 on ``x``'s device, and gives a
    float32 image.  No gradient."""
    if x.device.type == "cpu":
        return checked("head1x1", head1x1_plain(x, w, b))
    if x.device.type != "cuda":
        raise ValueError(f"head1x1: no kernel for device {x.device}")
    if x.dtype != torch.bfloat16 or x.ndim != 4 or not x.is_contiguous():
        raise ValueError(f"head1x1: the kernel takes a contiguous 4-d bf16 x, not {x.dtype} {tuple(x.shape)} "
                         f"with strides {x.stride()}")
    bsz, c, hh, ww = x.shape
    if not 1 <= c <= MAX_CHANNELS:
        raise ValueError(f"head1x1: {c} channels (the kernel takes 1 to {MAX_CHANNELS})")
    for name, t, shape in (("w", w, (2, c)), ("b", b, (2,))):
        if t.shape != shape or t.dtype != torch.float32 or t.device != x.device:
            raise ValueError(f"head1x1: {name} must be float32 {shape} on {x.device}, not {t.dtype} "
                             f"{tuple(t.shape)} on {t.device}")
    y = torch.empty(bsz, 2, hh, ww, device=x.device, dtype=torch.float32)
    if y.numel():
        w, b = w.detach().contiguous(), b.detach().contiguous()
        _build.kernel("head1x1_bf16", "mg_head1x1_bf16", _ARGS)(
            x.data_ptr(), w.data_ptr(), b.data_ptr(), y.data_ptr(), bsz, c, hh, ww, device=x.device,
        )
        head1x1.launches += 1
    return checked("head1x1", y)


head1x1.launches = 0
