"""Hand-written CUDA kernels for Hopper (sources in ``csrc/``), each beside
its plain PyTorch version: ``conv.fused_conv3x3``, ``conv.fused_upconv3x3``
and ``istft_fused.istft_fused``."""

from .conv import fused_conv3x3, fused_upconv3x3, pack_upconv_weights, pack_weights

__all__ = [
    "fused_conv3x3",
    "fused_upconv3x3",
    "pack_upconv_weights",
    "pack_weights",
]
