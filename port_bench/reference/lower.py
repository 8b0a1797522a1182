"""Rounding of a product's operands to a lower precision, for the controls.

A control is the reference put in the program's place and computed in the
precision just below the one the configuration states: fp8 (e4m3, one
scale a tensor) below the bf16 generator, bf16 below the float32 vocoder,
TF32 below float32 training.  Every
convolution and linear layer of the reference passes its two operands
through :func:`operand_rounding`'s function; the products then accumulate
in float32, as the tensor cores do.

TF32 here rounds the operands' mantissa to 10 bits, to nearest, which is
what the tensor cores do to a float32 operand.  The rounding stands in the
forward products only; on the card the training control switches the
library's TF32 on instead, which rounds the backward products too
(:func:`numerics`).
"""

from __future__ import annotations

import contextlib

import torch

__all__ = ["round_tf32", "round_bf16", "round_fp8", "operand_rounding", "numerics"]

FP8_MAX = 448.0  # largest finite float8_e4m3fn


def round_tf32(x: torch.Tensor) -> torch.Tensor:
    """float32 with its mantissa rounded to TF32's 10 bits (to nearest,
    ties to even)."""
    bits = x.contiguous().view(torch.int32)
    lsb = (bits >> 13) & 1
    return ((bits + 0xFFF + lsb) & ~0x1FFF).view(torch.float32)


def round_bf16(x: torch.Tensor) -> torch.Tensor:
    """float32 rounded to bfloat16 (to nearest) and back."""
    return x.to(torch.bfloat16).to(torch.float32)


def round_fp8(x: torch.Tensor) -> torch.Tensor:
    """float32 rounded to float8 e4m3 under one scale a tensor (its largest
    magnitude at the format's largest value), and back."""
    scale = x.detach().abs().amax().clamp(min=1e-30) / FP8_MAX
    return (x / scale).to(torch.float8_e4m3fn).to(torch.float32) * scale


def operand_rounding(precision: str):
    """The function applied to each operand of a product: ``None`` for the
    reference's own float32, else the rounding to ``precision``.  Rounded
    values pass gradients straight through."""
    if precision == "float32":
        return None
    fn = {"tf32": round_tf32, "float8_e4m3fn": round_fp8, "bfloat16": round_bf16}[precision]

    def rounded(x: torch.Tensor) -> torch.Tensor:
        return x + (fn(x.detach()) - x).detach() if x.requires_grad else fn(x)

    return rounded


@contextlib.contextmanager
def numerics(precision: str, device):
    """The library's numerics for a run of the reference: TF32 off, but for
    the TF32 control on the card.  Flags restored on exit."""
    cudnn, matmul = torch.backends.cudnn, torch.backends.cuda.matmul
    saved = (cudnn.allow_tf32, matmul.allow_tf32)
    cudnn.allow_tf32 = matmul.allow_tf32 = precision == "tf32" and torch.device(device).type == "cuda"
    try:
        yield
    finally:
        cudnn.allow_tf32, matmul.allow_tf32 = saved
