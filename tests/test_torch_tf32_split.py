"""The arithmetic premise of the conv template's tensor-core route (3xTF32).

The large-image shape of K1, K2 and K3 (``csrc/conv_tile.cuh``) multiplies
on the tensor cores in TF32, which keeps 10 of float32's 23 mantissa bits.
It splits each operand into ``big = tf32(v)`` and ``small = tf32(v - big)``
(both rounded to nearest, ties away from zero: ``cvt.rna.tf32.f32``) and
sums ``big*big + big*small + small*big`` in float32.  These tests emulate
that split in PyTorch on the CPU, at every width the route takes on the
synthesis and train paths (channels at full width, images cut to 8 x 66),
and hold the result against the float64 conv: within 1e-6 of the largest
output, where one TF32 product (``big*big`` alone) misses the conv bar of
1e-4 that the kernels are held to against their plain versions.
"""

import numpy as np
import pytest
import torch

from musicgan_tpu_torch.models.layers import conv2d, subpixel_conv, subpixel_phase_kernels

# Products of TF32 values are exact in float32 (11 x 11 significant bits);
# what is left is float32 accumulation over 9 * cin (or 4 * cin) products.
TOL_3XTF32 = 1e-6
TOL_CONV = 1e-4  # the kernels' bar against their plain versions


def tf32_rna(v: torch.Tensor) -> torch.Tensor:
    """float32 -> the nearest TF32 value (10 mantissa bits), ties away from
    zero, as ``cvt.rna.tf32.f32``: add half of the 13 dropped bits to the
    magnitude and clear them (a carry into the exponent is the right
    rounding)."""
    bits = v.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def split(v: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    big = tf32_rna(v)
    return big, tf32_rna(v - big)


def _operands(seed, cin, cout, h=8, w=66):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((1, cin, h, w))
    wt = rng.standard_normal((cout, cin, 3, 3)) / np.sqrt(9 * cin)
    return torch.tensor(x, dtype=torch.float32), torch.tensor(wt, dtype=torch.float32)


def _conv3x3(x, wt):
    (xb, xs), (wb, ws) = split(x), split(wt)
    three = conv2d(xb, wb, None) + conv2d(xb, ws, None) + conv2d(xs, wb, None)
    return three, conv2d(xb, wb, None), conv2d(x.double(), wt.double(), None)


def _upconv3x3(x, wt):
    # The kernel splits the summed 2x2 phase kernels (float32), as
    # ops/conv.py::kernel_upconv_weights lays them out.
    zero = torch.zeros(wt.shape[0])
    phases = subpixel_phase_kernels(wt)
    pb, ps = zip(*(split(k) for k in phases))
    xb, xs = split(x)
    three = subpixel_conv(xb, pb, zero) + subpixel_conv(xb, ps, zero) + subpixel_conv(xs, pb, zero)
    ref = subpixel_conv(x.double(), subpixel_phase_kernels(wt.double()), zero.double())
    return three, subpixel_conv(xb, pb, zero), ref


# (cin, cout) of every conv the large shape takes at the path's widths
# (ModelConfig(): generator 32-128 channels, critic 16-80 from 64x64 up):
# K1 in the critic forward and as its input gradients (channels swapped),
# K2 and K1 in the generator's training forward and input gradients, K1 in
# synthesis; K3 in synthesis.
K1_WIDTHS = sorted({
    (16, 32), (32, 32), (32, 48), (48, 48), (48, 64), (64, 64), (64, 80),  # critic
    (32, 16), (48, 32), (64, 48), (80, 64),                                # its input gradients
    (80, 64), (64, 48), (48, 32), (32, 16),                                # generator (K2)
    (96, 96), (80, 80),                                                    # synthesis K1
})
K3_WIDTHS = [(96, 80), (80, 64), (64, 48), (48, 32), (32, 16)]


def test_tf32_rounding_is_to_nearest_with_ten_mantissa_bits():
    v = torch.tensor([1.0 + 2.0**-11, 1.0 + 2.0**-11 + 2.0**-20, -(1.0 + 3 * 2.0**-11), 3.0, 2.0 - 2.0**-12])
    want = torch.tensor([1.0 + 2.0**-10, 1.0 + 2.0**-10, -(1.0 + 2 * 2.0**-10), 3.0, 2.0])
    assert torch.equal(tf32_rna(v), want)
    big, small = split(v)
    assert torch.equal(big + small, v)  # these values need fewer than 22 bits


@pytest.mark.parametrize("cin,cout", K1_WIDTHS)
def test_3xtf32_conv3x3_is_float32_accurate(cin, cout):
    x, wt = _operands(cin * 1000 + cout, cin, cout)
    three, one, ref = _conv3x3(x, wt)
    scale = ref.abs().max().item()
    assert (three.double() - ref).abs().max().item() <= TOL_3XTF32 * scale
    assert (one.double() - ref).abs().max().item() > TOL_CONV * scale


@pytest.mark.parametrize("cin,cout", K3_WIDTHS)
def test_3xtf32_upconv3x3_is_float32_accurate(cin, cout):
    x, wt = _operands(cin * 1000 + cout + 7, cin, cout)
    three, one, ref = _upconv3x3(x, wt)
    assert three.shape == (1, cout, 16, 132)
    scale = ref.abs().max().item()
    assert (three.double() - ref).abs().max().item() <= TOL_3XTF32 * scale
    assert (one.double() - ref).abs().max().item() > TOL_CONV * scale
