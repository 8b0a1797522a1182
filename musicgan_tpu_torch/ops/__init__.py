"""Hand-written CUDA kernels for Hopper (sources in ``csrc/``), each beside
its plain PyTorch version: ``conv.fused_conv3x3``, ``conv.fused_conv3x3_msq``,
``conv.fused_upconv3x3``, ``conv.fused_block``,
``istft_fused.istft_fused`` and ``head.head1x1``; and
``conv_vjp.conv3x3_act``, the trainable conv built on the first two and
``conv_vjp.weight_grad3x3``, its weight gradient."""

from .conv import (
    fused_block,
    fused_block_fits,
    fused_conv3x3,
    fused_conv3x3_msq,
    fused_upconv3x3,
    kernel_upconv_weights,
    kernel_weights,
    pack_upconv_weights,
    pack_weights,
)
from .conv_vjp import conv3x3_act

__all__ = [
    "conv3x3_act",
    "fused_block",
    "fused_block_fits",
    "fused_conv3x3",
    "fused_conv3x3_msq",
    "fused_upconv3x3",
    "kernel_upconv_weights",
    "kernel_weights",
    "pack_upconv_weights",
    "pack_weights",
]
