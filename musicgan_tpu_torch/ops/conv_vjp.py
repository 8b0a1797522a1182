"""The trainable fused conv: the CUDA forward kernels under a gradient whose
input-gradient conv is the hand-written kernel again.

Counterpart of ``musicgan_tpu/ops/conv_vjp.py::conv3x3_act`` (a
``jax.custom_vjp``), as a ``torch.autograd.Function`` with the same split:

* **forward**: ``fused_conv3x3_msq`` (K2) when PixelNorm is on, which also
  gives the pre-norm ``m = mean_c(u^2)`` map, else ``fused_conv3x3`` (K1).
  Saved for the backward: ``x`` (only if the weight needs a gradient), ``w``,
  the output ``y`` and ``m``.  No pre-activation is kept: ``u = y / r`` and
  ``sign(preact) = sign(y)``, because LeakyReLU and the positive norm scale
  both keep the sign.
* **backward, epilogue** (plain PyTorch, as it is XLA elementwise math in
  JAX): per pixel, with ``r = (m + eps)^-1/2`` and ``y_c = u_c * r``,

      dL/du_c = r * (g_c - y_c * mean_k(g_k * y_k)),
      dpre    = du * where(y >= 0, 1, slope)

  (the subgradient at 0 is 1, as in ``layers.leaky_relu``, whose
  ``torch.where`` gives the same under autograd).
* **backward, input gradient**: K1 on ``dpre`` with the 180-degree-rotated,
  in/out-swapped weights and no bias: the transpose of a 'SAME' 3x3 conv is
  a 'SAME' 3x3 conv.  It is launched on the card, never a library call.
* **backward, weight and bias**: the weight gradient is
  :func:`weight_grad3x3`, a hand-written kernel (``csrc/wgrad3x3.cu``) that
  sums in a fixed order, so a train run on the card gives the same bits
  run after run and a resumed run equals the uninterrupted one (JAX leaves
  it to XLA; its plain version is the library's conv-backward-weights);
  ``db = sum(dpre)``.

The Function is differentiable once (``once_differentiable``).  The WGAN-GP
needs an input gradient inside the loss; ``models/discriminator.py::
critic_input_grad_nchw_train`` unrolls that inner backward by hand from
first-order calls of this Function, so nothing here is differentiated twice.

Dispatch: on a CPU tensor ``conv3x3_act`` is :func:`conv3x3_act_plain`
(ordinary autograd through the plain conv), on a CUDA tensor it is the
Function, anything else raises.  The Function packs the weights for the
kernels at every call: they change at every train step.
"""

from __future__ import annotations

import torch
from torch.autograd.function import once_differentiable

from . import _build
from .conv import conv3x3_plain, fused_conv3x3, fused_conv3x3_msq

__all__ = ["conv3x3_act", "conv3x3_act_plain", "conv3x3_act_backward", "weight_grad3x3",
           "weight_grad3x3_plain"]


def conv3x3_act_plain(x, w, b, slope=0.2, pixel_norm=False, eps=1e-8):
    """Plain version: the plain conv and epilogue under ordinary autograd."""
    return conv3x3_plain(x, w, b, slope, pixel_norm, eps)


def weight_grad3x3_plain(x, dpre, w_shape):
    """Plain version of :func:`weight_grad3x3`: the library's weight
    gradient of a 3x3 'SAME' conv (TF32 off on the card, where cuDNN would
    take it by default)."""
    tf32 = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        return torch.nn.grad.conv2d_weight(x, w_shape, dpre, padding=1)
    finally:
        torch.backends.cudnn.allow_tf32 = tf32


_WGRAD_ARGS = [_build.PTR] * 4 + [_build.INT] * 5


def weight_grad3x3(x, dpre, w_shape):
    """Weight gradient ``(cout, cin, 3, 3)`` of a 3x3 'SAME' conv from its
    input ``x`` ``(B, cin, H, W)`` and the gradient at its output ``dpre``
    ``(B, cout, H, W)``.  On a CUDA tensor the kernel of
    ``csrc/wgrad3x3.cu``, float32 summed in a fixed order, so the same
    inputs give the same bits run after run (cuDNN's default algorithms do
    not, and its deterministic ones lose accuracy at 512x512); on a CPU
    tensor its plain version; anything else raises.  Counts its launches
    in ``.launches``."""
    if x.device.type == "cpu":
        return weight_grad3x3_plain(x, dpre, w_shape)
    if x.device.type != "cuda":
        raise ValueError(f"weight_grad3x3: no kernel for device {x.device}")
    bsz, cin, h, w = x.shape
    cout = w_shape[0]
    if tuple(w_shape) != (cout, cin, 3, 3) or dpre.shape != (bsz, cout, h, w):
        raise ValueError(f"weight_grad3x3: {tuple(x.shape)}, {tuple(dpre.shape)} for weights {tuple(w_shape)}")
    for t in (x, dpre):
        if t.device != x.device or t.dtype != torch.float32:
            raise ValueError(f"weight_grad3x3: every operand must be float32 on {x.device}")
    x, dpre = x.contiguous(), dpre.contiguous()
    fn = _build.load("wgrad3x3").mg_wgrad3x3_chunks
    fn.argtypes, fn.restype = [_build.INT] * 5, _build.INT
    with torch.cuda.device(x.device):
        chunks = fn(bsz, cin, cout, h, w)
    part = torch.empty(chunks, cout, cin, 9, device=x.device, dtype=torch.float32)
    dw = torch.empty(cout, cin, 3, 3, device=x.device, dtype=torch.float32)
    _build.kernel("wgrad3x3", "mg_wgrad3x3", _WGRAD_ARGS)(
        x.data_ptr(), dpre.data_ptr(), part.data_ptr(), dw.data_ptr(), bsz, cin, cout, h, w,
        device=x.device,
    )
    weight_grad3x3.launches += 1
    return dw


weight_grad3x3.launches = 0


def conv3x3_act_backward(x, w, y, m, g, slope, pixel_norm, eps, needs=(True, True, True)):
    """The hand-written backward of ``conv3x3_act``: ``(dx, dw, db)`` from
    the saved ``x, w, y, m`` and the cotangent ``g``; ``needs`` says which
    of the three to compute (the others are None).  The input gradient goes
    through ``fused_conv3x3``: K1 on a CUDA tensor, its plain version on a
    CPU tensor, which is how the CPU tests check this algebra."""
    if pixel_norm:
        r = torch.rsqrt(m + eps)  # (B, 1, H, W)
        du = r * (g - y * torch.mean(g * y, dim=1, keepdim=True))
    else:
        du = g
    dpre = du if slope is None else du * torch.where(y >= 0, 1.0, slope)
    dx = dw = db = None
    if needs[0]:
        w_t = w.flip(2, 3).transpose(0, 1)  # rot180, in/out swap (OIHW)
        dx = fused_conv3x3(dpre, w_t, None)
    if needs[1]:
        dw = weight_grad3x3(x, dpre, w.shape)
    if needs[2]:
        db = dpre.sum(dim=(0, 2, 3))
    return dx, dw, db


class _Conv3x3Act(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w, b, slope, pixel_norm, eps):
        if pixel_norm:
            y, m = fused_conv3x3_msq(x, w, b, slope, eps)
        else:
            y, m = fused_conv3x3(x, w, b, slope, False, eps), None
        ctx.slope, ctx.pixel_norm, ctx.eps = slope, pixel_norm, eps
        ctx.save_for_backward(x if ctx.needs_input_grad[1] else None, w, y, m)
        return y

    @staticmethod
    @once_differentiable
    def backward(ctx, g):
        x, w, y, m = ctx.saved_tensors
        dx, dw, db = conv3x3_act_backward(
            x, w, y, m, g, ctx.slope, ctx.pixel_norm, ctx.eps, ctx.needs_input_grad[:3]
        )
        return dx, dw, db, None, None, None


def conv3x3_act(x, w, b, slope=0.2, pixel_norm=False, eps=1e-8):
    """3x3 'SAME' conv + bias (+ LeakyReLU) (+ PixelNorm) on NCHW float32
    with OIHW weights, differentiable once in ``(x, w, b)``.  ``b`` may be
    None; ``slope`` None means no LeakyReLU."""
    if x.device.type == "cpu":
        return conv3x3_act_plain(x, w, b, slope, pixel_norm, eps)
    if x.device.type != "cuda":
        raise ValueError(f"conv3x3_act: no kernel for device {x.device}")
    return _Conv3x3Act.apply(x, w, b, slope, pixel_norm, eps)
