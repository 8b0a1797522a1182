"""Progressive-growing generator as an ``nn.Module`` (counterpart of
``musicgan_tpu/models/generator.py``, impls ``"pallas_up"`` and
``"pallas_block"`` in float32).

All 8 blocks and all 8 ToMagnPhase heads exist from construction, as in
JAX, so the parameter set never changes shape.  Internally NCHW; the
public :meth:`Generator.forward` keeps the JAX layout (NHWC latent in,
NHWC image out).  Each block is ``fused_conv3x3`` (conv1 + LeakyReLU +
PixelNorm) then ``fused_upconv3x3`` (up2x + conv2 + LeakyReLU +
PixelNorm): on the card they are the kernels K1 and K3, on the CPU their
plain versions.  With ``ModelConfig.conv_impl == "pallas_block"`` a block
that ``fused_block_fits`` at its sizes is one launch of ``fused_block``
(K4) instead, as in JAX's ``block_nchw`` (on the CPU by an H100's rule:
K4's plain version is the pair's own).  Each block packs its conv weights for
the kernels once, not per call.  Heads and the fade-in are plain PyTorch, as
they are XLA in JAX.

Training runs :meth:`Generator.forward_nchw_train` instead (counterpart of
``_generator_forward_nchw_train``, impl ``"pallas_train"``): each block is
``conv3x3_act`` with PixelNorm (forward kernel K2), a plain 2x upsample and
``conv3x3_act`` again, all under the once-differentiable gradient of
``ops/conv_vjp.py``, and the fade head is computed at every ``alpha``.

Fade-in (reference ``generator.py:106-126``): at stage s > 0 the output is
``alpha * head_s(block_s(x)) + (1 - alpha) * up2x(head_{s-1}(x))``.
"""

from __future__ import annotations

import torch
from torch import nn

from ..config import ModelConfig
from ..ops import conv as conv_ops
from ..ops import conv_vjp
from .layers import upsample_nearest_2x

_DEFAULT = ModelConfig()

__all__ = ["Generator", "generator_param_count"]


class GenBlock(nn.Module):
    """Conv3x3 -> LeakyReLU -> PixelNorm -> Up2x -> Conv3x3 -> LeakyReLU ->
    PixelNorm (reference ``generator.py:16-39``)."""

    def __init__(self, cin: int, cout: int, device=None):
        super().__init__()
        self.conv1 = nn.Conv2d(cin, cin, 3, padding=1, device=device)
        self.conv2 = nn.Conv2d(cin, cout, 3, padding=1, device=device)
        self._packs: dict[str, tuple] = {}

    def _packed(self, name: str) -> torch.Tensor:
        """The kernels' layout of conv ``name``'s weight (``kernel_weights``
        for ``conv1``, ``kernel_upconv_weights`` for ``conv2``: K1, K3 and
        K4 read the same), made once and kept until the weight changes (in
        place, which bumps its version, or by a move to other storage)."""
        w = getattr(self, name).weight
        key = (w.device, w.data_ptr(), w._version)
        hit = self._packs.get(name)
        if hit is None or hit[0] != key:
            pack = conv_ops.kernel_weights if name == "conv1" else conv_ops.kernel_upconv_weights
            hit = self._packs[name] = (key, pack(w.detach()))
        return hit[1]

    def forward(
        self, x: torch.Tensor, slope: float, eps: float, use_block: bool = False
    ) -> torch.Tensor:
        """``use_block``: take the whole-block kernel where its size rule
        (``ops.conv.fused_block_fits``) says so."""
        w1, w2 = self.conv1.weight, self.conv2.weight
        if use_block and conv_ops.fused_block_fits(
            w1.shape[1], w1.shape[0], w2.shape[0], size=(x.shape[0], *x.shape[2:]), device=x.device
        ):
            return conv_ops.fused_block(
                x, w1, self.conv1.bias, w2, self.conv2.bias, slope, eps,
                w1_packed=self._packed("conv1"), w2_packed=self._packed("conv2"),
            )
        x = conv_ops.fused_conv3x3(
            x, self.conv1.weight, self.conv1.bias, slope, True, eps,
            w_packed=self._packed("conv1"),
        )
        return conv_ops.fused_upconv3x3(
            x, self.conv2.weight, self.conv2.bias, slope, True, eps,
            w_packed=self._packed("conv2"),
        )

    def forward_train(self, x: torch.Tensor, slope: float, eps: float) -> torch.Tensor:
        x = conv_vjp.conv3x3_act(x, self.conv1.weight, self.conv1.bias, slope, True, eps)
        x = upsample_nearest_2x(x)  # its transpose is a 2x2 sum-pool, left to autograd
        return conv_vjp.conv3x3_act(x, self.conv2.weight, self.conv2.bias, slope, True, eps)


class Generator(nn.Module):
    """8 up-blocks + 8 heads (all stages).  Parameters start from
    PyTorch's conv init, ``U(+-1/sqrt(fan_in))`` as in JAX, drawn from a
    ``torch.Generator`` seeded with ``seed``."""

    def __init__(self, cfg: ModelConfig = _DEFAULT, device=None, seed: int = 0):
        super().__init__()
        self.cfg = cfg
        self.blocks = nn.ModuleList(
            GenBlock(cin, cout, device) for cin, cout in cfg.gen_channels
        )
        self.heads = nn.ModuleList(
            nn.Conv2d(cout, 2, 1, device=device) for _, cout in cfg.gen_channels
        )
        g = torch.Generator(device=self.heads[0].weight.device).manual_seed(seed)
        with torch.no_grad():
            for m in self.modules():
                if isinstance(m, nn.Conv2d):
                    bound = 1.0 / (m.in_channels * m.kernel_size[0] * m.kernel_size[1]) ** 0.5
                    m.weight.uniform_(-bound, bound, generator=g)
                    m.bias.uniform_(-bound, bound, generator=g)

    def _head(self, i: int, x: torch.Tensor) -> torch.Tensor:
        """ToMagnPhase head: 1x1 conv + tanh, as a batched ``(2, C) @
        (C, H*W)`` product on the NCHW activation itself (an einsum over
        ``bchw``, or a broadcast matmul, first copies it)."""
        h = self.heads[i]
        b, c, hh, ww = x.shape
        w = h.weight[:, :, 0, 0].expand(b, -1, -1)
        y = torch.bmm(w, x.reshape(b, c, hh * ww))
        return torch.tanh(y.reshape(b, -1, hh, ww) + h.bias[None, :, None, None])

    def forward_nchw(self, z: torch.Tensor, stage: int, alpha: float = 1.0) -> torch.Tensor:
        """``(B, C, h, w)`` latent -> ``(B, 2, h * 2^(stage+1), w *
        2^(stage+1))`` magn/phase image in [-1, 1]."""
        slope, eps = self.cfg.leaky_slope, self.cfg.pixel_norm_eps
        use_block = self.cfg.conv_impl == "pallas_block"
        out = z
        for i in range(stage):
            out = self.blocks[i](out, slope, eps, use_block)
        out_mp = self._head(stage, self.blocks[stage](out, slope, eps, use_block))
        # At alpha == 1 the fade term (1 - alpha) * old is exactly zero (tanh
        # is finite), so it is not computed: synthesis always runs there.
        if stage > 0 and alpha != 1.0:
            old = upsample_nearest_2x(self._head(stage - 1, out))
            out_mp = alpha * out_mp + (1.0 - alpha) * old
        return out_mp

    def forward_nchw_train(self, z: torch.Tensor, stage: int, alpha) -> torch.Tensor:
        """The differentiable forward of the train step, same shapes as
        :meth:`forward_nchw`.  ``alpha`` may be a tensor on the device: the
        fade term is computed whatever its value, so nothing reads it back."""
        slope, eps = self.cfg.leaky_slope, self.cfg.pixel_norm_eps
        out = z
        for i in range(stage):
            out = self.blocks[i].forward_train(out, slope, eps)
        out_mp = self._head(stage, self.blocks[stage].forward_train(out, slope, eps))
        if stage > 0:
            old = upsample_nearest_2x(self._head(stage - 1, out))
            out_mp = alpha * out_mp + (1.0 - alpha) * old
        return out_mp

    def forward(
        self, z: torch.Tensor, stage: int, alpha: float = 1.0, train: bool = False
    ) -> torch.Tensor:
        """``z``: ``(B, h, w, rand_channels)`` NHWC, as in JAX's
        ``generator_forward`` -> ``(B, H, W, 2)``.  ``train`` selects the
        differentiable forward."""
        fwd = self.forward_nchw_train if train else self.forward_nchw
        return fwd(z.permute(0, 3, 1, 2), stage, alpha).permute(0, 2, 3, 1)


def generator_param_count(cfg: ModelConfig = _DEFAULT, stage: int | None = None) -> int:
    """Number of parameters *active* at ``stage`` (None = all allocated).

    At stage 7 with the fade head included this equals the reference's
    fully-grown count of 902,132."""

    def conv_n(kh, kw, cin, cout):
        return kh * kw * cin * cout + cout

    total = sum(
        conv_n(3, 3, cin, cin) + conv_n(3, 3, cin, cout)
        for cin, cout in cfg.gen_channels
    )
    if stage is None:
        total += sum(conv_n(1, 1, cout, 2) for _, cout in cfg.gen_channels)
    else:
        total += conv_n(1, 1, cfg.gen_channels[stage][1], 2)
        if stage > 0:
            total += conv_n(1, 1, cfg.gen_channels[stage - 1][1], 2)
    return total
