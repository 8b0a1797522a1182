"""Progressive-growing critic (WGAN discriminator) as an ``nn.Module``
(counterpart of ``musicgan_tpu/models/discriminator.py``: the trainable
kernel path ``_discriminator_forward_nchw_train`` and the library lowering
of ``discriminator_forward``).

All 9 down-blocks, all 9 input heads and the final linear exist from
construction, so the parameter set never changes shape.  ``stage`` counts
DOWN from 7 (4x4 input) to 0 (512x512 input) as the model grows.  Mirrored
fade-in for ``stage < n - 2``:
``alpha * block_s(head_s(x)) + (1 - alpha) * head_{s+1}(avgpool(x))``.

Internally NCHW; the public :meth:`Discriminator.forward` keeps the JAX
layout (NHWC image in).  ``conv_impl`` selects the lowering as in JAX's
``discriminator_forward``: under ``"pallas_train"`` and ``"pallas_gp"`` every
3x3 conv goes through ``ops/conv_vjp.py::conv3x3_act`` (LeakyReLU, no
PixelNorm): the kernel K1 on the card, forward and input gradient, and the
plain version on the CPU; heads (1x1 convs) and the final linear are
batched products in float32, as they are XLA in JAX.  Under every other
name (the library lowering) every conv and the final linear are
``models/layers.py``'s in the ``compute_dtype``, differentiable twice.

:func:`critic_input_grad_nchw_train` is the WGAN-GP's inner input gradient,
unrolled by hand so that the train step differentiates every conv once.
"""

from __future__ import annotations

import torch
from torch import nn

from ..config import ModelConfig
from ..ops import conv_vjp
from . import layers
from .generator import TRAIN_KERNEL_IMPLS
from .layers import avg_pool_2x, leaky_relu, linear, upsample_nearest_2x

_DEFAULT = ModelConfig()

__all__ = ["Discriminator", "critic_input_grad_nchw_train", "discriminator_param_count"]


class DiscBlock(nn.Module):
    """Conv3x3 -> LeakyReLU -> AvgPool2x -> Conv3x3 -> LeakyReLU
    (reference ``discriminator.py:14-33``)."""

    def __init__(self, cin: int, cout: int, device=None):
        super().__init__()
        self.conv1 = nn.Conv2d(cin, cout, 3, padding=1, device=device)
        self.conv2 = nn.Conv2d(cout, cout, 3, padding=1, device=device)

    def forward_acts(self, x: torch.Tensor, slope: float):
        """Both post-activations ``(c1, c2)``; ``c2`` is the block's output."""
        c1 = conv_vjp.conv3x3_act(x, self.conv1.weight, self.conv1.bias, slope, False, 0.0)
        c2 = conv_vjp.conv3x3_act(
            avg_pool_2x(c1), self.conv2.weight, self.conv2.bias, slope, False, 0.0
        )
        return c1, c2

    def forward(self, x: torch.Tensor, slope: float) -> torch.Tensor:
        return self.forward_acts(x, slope)[1]

    def forward_library(self, x: torch.Tensor, slope: float, dtype: torch.dtype) -> torch.Tensor:
        """The block in the library lowering (JAX's ``_block_apply``)."""
        x = leaky_relu(layers.conv2d(x, self.conv1.weight, self.conv1.bias, dtype), slope)
        return leaky_relu(layers.conv2d(avg_pool_2x(x), self.conv2.weight, self.conv2.bias, dtype), slope)


class Discriminator(nn.Module):
    """9 down-blocks + 9 input heads + the final linear.  Parameters start
    from PyTorch's default init, ``U(+-1/sqrt(fan_in))`` as in JAX, drawn
    from a ``torch.Generator`` seeded with ``seed``."""

    def __init__(self, cfg: ModelConfig = _DEFAULT, device=None, seed: int = 0):
        super().__init__()
        self.cfg = cfg
        self.blocks = nn.ModuleList(
            DiscBlock(cin, cout, device) for cin, cout in cfg.disc_channels
        )
        self.heads = nn.ModuleList(
            nn.Conv2d(2, cin, 1, device=device) for cin, _ in cfg.disc_channels
        )
        self.clf = nn.Linear(cfg.disc_channels[-1][1], 1, device=device)
        g = torch.Generator(device=self.clf.weight.device).manual_seed(seed)
        with torch.no_grad():
            for m in self.modules():
                if isinstance(m, (nn.Conv2d, nn.Linear)):
                    bound = 1.0 / (m.weight[0].numel()) ** 0.5  # fan_in
                    m.weight.uniform_(-bound, bound, generator=g)
                    m.bias.uniform_(-bound, bound, generator=g)

    def _head(self, i: int, x: torch.Tensor) -> torch.Tensor:
        """MagPhase input head: 1x1 conv (2 -> C) + LeakyReLU (reference
        ``discriminator.py:37-50``), as a batched ``(C, 2) @ (2, H*W)``."""
        h = self.heads[i]
        b, c, hh, ww = x.shape
        w = h.weight[:, :, 0, 0].expand(b, -1, -1)
        y = torch.bmm(w, x.reshape(b, c, hh * ww)).reshape(b, -1, hh, ww)
        return leaky_relu(y + h.bias[None, :, None, None], self.cfg.leaky_slope)

    def forward_nchw(
        self, x: torch.Tensor, stage: int, alpha, impl: str | None = None,
        compute_dtype: torch.dtype = torch.float32,
    ) -> torch.Tensor:
        """``(B, 2, H, W)`` at the stage's resolution -> ``(B, 1)`` critic
        score.  ``stage``: 7 = 4x4 input, 0 = 512x512 input.  ``impl``
        (default ``self.cfg.conv_impl``): the kernels under
        ``"pallas_train"`` / ``"pallas_gp"``, else the library lowering in
        ``compute_dtype``."""
        impl = self.cfg.conv_impl if impl is None else impl
        if impl in TRAIN_KERNEL_IMPLS:
            return self._forward(x, stage, alpha, True, torch.float32)
        with layers.library_numerics():
            return self._forward(x, stage, alpha, False, compute_dtype)

    def _forward(self, x: torch.Tensor, stage: int, alpha, kernels: bool, dtype: torch.dtype) -> torch.Tensor:
        n, slope = len(self.blocks), self.cfg.leaky_slope

        def head(i, t):
            if kernels:
                return self._head(i, t)
            h = self.heads[i]  # JAX's NHWC lax path: a 1x1 conv in the compute dtype
            return leaky_relu(layers.conv2d(t, h.weight, h.bias, dtype), slope)

        def block(i, t):
            return self.blocks[i](t, slope) if kernels else self.blocks[i].forward_library(t, slope, dtype)

        out = block(stage, head(stage, x))
        if stage < n - 2:  # mirrored fade-in against the coarser input head
            out = alpha * out + (1.0 - alpha) * head(stage + 1, avg_pool_2x(x))
        for i in range(stage + 1, n):
            out = block(i, out)
        return linear(out.reshape(out.shape[0], -1), self.clf.weight, self.clf.bias, dtype)

    def forward(
        self, x: torch.Tensor, stage: int, alpha, impl: str | None = None,
        compute_dtype: torch.dtype = torch.float32,
    ) -> torch.Tensor:
        """``x``: ``(B, H, W, 2)`` NHWC, as in JAX's ``discriminator_forward``."""
        return self.forward_nchw(x.permute(0, 3, 1, 2), stage, alpha, impl, compute_dtype)


def critic_input_grad_nchw(disc: Discriminator, xn: torch.Tensor, stage: int, alpha) -> torch.Tensor:
    """:func:`critic_input_grad_nchw_train` on an NCHW input, NCHW out."""
    n, slope = len(disc.blocks), disc.cfg.leaky_slope
    fade = stage < n - 2

    def mask(t):
        # sign(post-activation) == sign(pre-activation): slope > 0.
        return torch.where(t >= 0, 1.0, slope)

    def conv_t(ct, w):
        return conv_vjp.conv3x3_act(ct, w.flip(2, 3).transpose(0, 1), None, None, False, 0.0)

    # ---- forward, recording post-activations.  They reach the result only
    # through the masks, whose derivative is zero, so no graph is kept. ----
    with torch.no_grad():
        h_new = disc._head(stage, xn)
        acts = [disc.blocks[stage].forward_acts(h_new, slope)]
        out = acts[0][1]
        if fade:
            h_old = disc._head(stage + 1, avg_pool_2x(xn))
            out = alpha * out + (1.0 - alpha) * h_old
        for i in range(stage + 1, n):
            acts.append(disc.blocks[i].forward_acts(out, slope))
            out = acts[-1][1]

    # ---- explicit backward of sum(score) w.r.t. xn ------------------------
    def block_bwd(blk, c1, c2, d_c2):
        d_pl = conv_t(d_c2 * mask(c2), blk.conv2.weight)
        d_c1 = upsample_nearest_2x(d_pl) * 0.25  # avg-pool's transpose
        return conv_t(d_c1 * mask(c1), blk.conv1.weight)

    def head_bwd(i, h, d_h):
        b, c, hh, ww = d_h.shape
        w_t = disc.heads[i].weight[:, :, 0, 0].t().expand(b, -1, -1)  # (B, 2, C)
        return torch.bmm(w_t, (d_h * mask(h)).reshape(b, c, hh * ww)).reshape(b, 2, hh, ww)

    bsz = xn.shape[0]
    d_out = disc.clf.weight.reshape(1, -1, 1, 1).expand(bsz, -1, 1, 1)
    for i in range(n - 1, stage, -1):
        d_out = block_bwd(disc.blocks[i], *acts[i - stage], d_out)
    d_new = alpha * d_out if fade else d_out
    d_xn = head_bwd(stage, h_new, block_bwd(disc.blocks[stage], *acts[0], d_new))
    if fade:
        d_pooled = head_bwd(stage + 1, h_old, (1.0 - alpha) * d_out)
        d_xn = d_xn + upsample_nearest_2x(d_pooled) * 0.25
    return d_xn


def critic_input_grad_nchw_train(disc: Discriminator, x: torch.Tensor, stage: int, alpha) -> torch.Tensor:
    """``grad_x sum_b D(x)`` with the critic's backward pass UNROLLED by
    hand from first-order convs; ``x`` and the result are ``(B, H, W, 2)``
    NHWC (counterpart of JAX's function of the same name, impl
    ``"pallas_gp"``).

    Why: the WGAN-GP needs this input gradient *inside* the loss, so the
    usual ``autograd.grad(create_graph=True)`` formulation differentiates
    the critic twice, beyond the one differentiation of ``conv3x3_act``.
    Here the inner backward is explicit: the transpose of each 'SAME'
    conv3x3 is a 'SAME' conv3x3 with rot180 / in-out-swapped weights (the
    kernel K1, through ``conv3x3_act`` with no bias and no epilogue),
    avg-pool's transpose is a nearest-2x broadcast x 0.25, LeakyReLU's is a
    sign-mask multiply, and the 1x1 heads and the final linear transpose to
    batched products.  Every op is then differentiated ONCE by the outer
    backward of the train step; the weight gradient of a transposed conv
    flows back to ``w`` through the ``flip`` / ``transpose`` views.

    Exactness: the only dependence on the parameters that is dropped is the
    one through the LeakyReLU sign masks, whose derivative is zero almost
    everywhere; double backward through ``torch.where`` gives its condition
    no gradient either.  So this matches
    ``autograd.grad(D(x).sum(), x, create_graph=True)`` on the plain critic
    to float tolerance, including the outer parameter gradient, and the
    recorded forward can run under ``torch.no_grad()``.
    """
    return critic_input_grad_nchw(disc, x.permute(0, 3, 1, 2), stage, alpha).permute(0, 2, 3, 1)


def discriminator_param_count(cfg: ModelConfig = _DEFAULT, stage: int | None = None) -> int:
    """Active parameter count at ``stage`` (None = all allocated).

    At stage 0 with the fade head included this equals the reference's
    fully-grown count of 1,647,089."""

    def conv_n(kh, kw, cin, cout):
        return kh * kw * cin * cout + cout

    total = sum(
        conv_n(3, 3, cin, cout) + conv_n(3, 3, cout, cout)
        for cin, cout in cfg.disc_channels
    )
    total += cfg.disc_channels[-1][1] + 1  # final linear
    if stage is None:
        total += sum(conv_n(1, 1, 2, cin) for cin, _ in cfg.disc_channels)
    else:
        total += conv_n(1, 1, 2, cfg.disc_channels[stage][0])
        if stage < len(cfg.disc_channels) - 2:
            total += conv_n(1, 1, 2, cfg.disc_channels[stage + 1][0])
    return total
