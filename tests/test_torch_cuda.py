"""Kernel-vs-plain parity of the port's CUDA kernels, on an NVIDIA GPU.

Every test here needs the card and skips without one.  The file imports
no JAX, so it also runs where JAX is not installed:

    python -m pytest tests/test_torch_cuda.py --noconftest -q

The plain versions run on the same card with TF32 off (cuDNN convolutions
default to TF32), so the comparison measures the kernel, not TF32.
"""

import numpy as np
import pytest
import torch

from musicgan_tpu_torch.audio.stft import istft_real_imag
from musicgan_tpu_torch.ops import conv as conv_ops
from musicgan_tpu_torch.ops import istft_fused as istft_ops

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is False)")
    tf32 = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    yield torch.device("cuda")
    torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = tf32


def _conv_inputs(seed, b, cin, cout, h, w, device):
    rng = np.random.default_rng(seed)
    x = torch.tensor(rng.standard_normal((b, cin, h, w)), dtype=torch.float32, device=device)
    wt = torch.tensor(rng.standard_normal((cout, cin, 3, 3)) * 0.1, dtype=torch.float32, device=device)
    bias = torch.tensor(rng.standard_normal(cout) * 0.1, dtype=torch.float32, device=device)
    return x, wt, bias


# Ragged edges (2x2 and 2x20 of block 0, widths that are not a multiple of
# the 32-column tile), cin not a multiple of the 8-channel step, cout not a
# multiple of the 16-channel warp group, and the largest cout (128).
CONV_SHAPES = [
    (2, 32, 32, 2, 2), (5, 32, 128, 2, 20), (1, 5, 7, 3, 37),
    (2, 12, 20, 9, 33), (1, 128, 112, 8, 80), (1, 32, 16, 64, 160),
]


@pytest.mark.parametrize("epilogue", [True, False])
@pytest.mark.parametrize("b,cin,cout,h,w", CONV_SHAPES)
def test_fused_conv3x3_kernel_matches_plain(cuda, b, cin, cout, h, w, epilogue):
    x, wt, bias = _conv_inputs(0, b, cin, cout, h, w, cuda)
    kw = dict(slope=0.2, pixel_norm=True) if epilogue else {}
    n0 = conv_ops.fused_conv3x3.launches
    got = conv_ops.fused_conv3x3(x, wt, bias, **kw)
    torch.cuda.synchronize()
    assert conv_ops.fused_conv3x3.launches == n0 + 1
    ref = conv_ops.conv3x3_plain(x, wt, bias, **kw)
    torch.testing.assert_close(got, ref, atol=1e-4, rtol=0)
    prepacked = conv_ops.fused_conv3x3(x, wt, bias, **kw, w_packed=conv_ops.pack_weights(wt))
    torch.testing.assert_close(prepacked, got, atol=0, rtol=0)


@pytest.mark.parametrize("epilogue", [True, False])
@pytest.mark.parametrize("b,cin,cout,h,w", CONV_SHAPES)
def test_fused_upconv3x3_kernel_matches_plain(cuda, b, cin, cout, h, w, epilogue):
    x, wt, bias = _conv_inputs(1, b, cin, cout, h, w, cuda)
    kw = dict(slope=0.2, pixel_norm=True) if epilogue else {}
    n0 = conv_ops.fused_upconv3x3.launches
    got = conv_ops.fused_upconv3x3(x, wt, bias, **kw)
    torch.cuda.synchronize()
    assert conv_ops.fused_upconv3x3.launches == n0 + 1
    ref = conv_ops.upconv3x3_plain(x, wt, bias, **kw)
    torch.testing.assert_close(got, ref, atol=1e-4, rtol=0)
    prepacked = conv_ops.fused_upconv3x3(
        x, wt, bias, **kw, w_packed=conv_ops.pack_upconv_weights(wt)
    )
    torch.testing.assert_close(prepacked, got, atol=0, rtol=0)


@pytest.mark.parametrize("b,t", [(1, 257), (3, 300), (2, 512)])
def test_istft_fused_kernel_matches_plain(cuda, b, t):
    rng = np.random.default_rng(2)
    re, im = (
        torch.tensor(rng.standard_normal((b, 513, t)), dtype=torch.float32, device=cuda)
        for _ in range(2)
    )
    n0 = istft_ops.istft_fused.launches
    got = istft_ops.istft_fused(re, im)
    torch.cuda.synchronize()
    assert istft_ops.istft_fused.launches == n0 + 1
    ref = istft_real_imag(re, im)
    torch.testing.assert_close(got, ref, atol=2e-4, rtol=0)


def test_kernels_reject_a_wrong_dtype(cuda):
    x, wt, bias = _conv_inputs(3, 1, 8, 8, 4, 4, cuda)
    with pytest.raises(ValueError):
        conv_ops.fused_conv3x3(x.double(), wt.double(), bias.double())
