"""The port's kernel modules against the JAX package, on the CPU.

On a CPU tensor each wrapper of ``musicgan_tpu_torch.ops`` takes its
plain PyTorch version; the JAX side runs its Pallas kernels in interpret
mode, as ``tests/test_ops.py`` does.  The same numpy inputs feed both.
The kernels themselves are held against these plain versions on the card
(``tests/test_torch_cuda.py``, ``chip_smoke.py``).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from musicgan_tpu.audio.stft import istft_real_imag as jax_istft_real_imag
from musicgan_tpu.models import layers as jax_layers
from musicgan_tpu.ops import conv as jax_conv
from musicgan_tpu.ops.istft_pallas import istft_fused as jax_istft_fused
from musicgan_tpu_torch.audio.stft import istft_real_imag
from musicgan_tpu_torch.models import layers
from musicgan_tpu_torch.ops import conv
from musicgan_tpu_torch.ops.istft_fused import istft_fused


def _oihw(w_hwio):
    return torch.from_numpy(np.ascontiguousarray(w_hwio.transpose(3, 2, 0, 1)))


def _conv_inputs(rng, b, cin, cout, h, w):
    x = rng.standard_normal((b, cin, h, w)).astype(np.float32)
    wt = (rng.standard_normal((3, 3, cin, cout)) * 0.1).astype(np.float32)
    bias = (rng.standard_normal(cout) * 0.1).astype(np.float32)
    return x, wt, bias


# Ragged H/W (2x2 and 2x20 as in block 0, widths off the kernels' tiles)
# and channel counts off the kernels' 8/16-channel steps.
CONV_SHAPES = [(1, 16, 32, 8, 40), (2, 8, 12, 2, 20), (1, 5, 7, 3, 5), (2, 32, 32, 2, 2)]


@pytest.mark.parametrize("b,cin,cout,h,w", CONV_SHAPES)
def test_fused_conv3x3_matches_jax(rng, b, cin, cout, h, w):
    x, wt, bias = _conv_inputs(rng, b, cin, cout, h, w)
    ref = jax_conv.fused_conv3x3(
        jnp.asarray(x), jnp.asarray(wt), jnp.asarray(bias),
        slope=0.2, pixel_norm=True, interpret=True,
    )
    got = conv.fused_conv3x3(
        torch.from_numpy(x), _oihw(wt), torch.from_numpy(bias), 0.2, True
    )
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-4, rtol=0)


def test_fused_conv3x3_no_epilogue_matches_jax(rng):
    x, wt, bias = _conv_inputs(rng, 1, 16, 16, 8, 36)
    ref = jax_conv.fused_conv3x3(
        jnp.asarray(x), jnp.asarray(wt), jnp.asarray(bias), interpret=True
    )
    got = conv.fused_conv3x3(torch.from_numpy(x), _oihw(wt), torch.from_numpy(bias))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-4, rtol=0)


@pytest.mark.parametrize("b,cin,cout,h,w", CONV_SHAPES[:3])
def test_fused_upconv3x3_matches_jax(rng, b, cin, cout, h, w):
    x, wt, bias = _conv_inputs(rng, b, cin, cout, h, w)
    got = conv.fused_upconv3x3(
        torch.from_numpy(x), _oihw(wt), torch.from_numpy(bias), 0.2, True
    ).numpy()
    ref = jax_conv.fused_upconv3x3(
        jnp.asarray(x), jnp.asarray(wt), jnp.asarray(bias),
        slope=0.2, pixel_norm=True, interpret=True,
    )
    np.testing.assert_allclose(got, np.asarray(ref), atol=1e-4, rtol=0)


@pytest.mark.parametrize("b,cin,cout,h,w", CONV_SHAPES[:2])
def test_upconv_plain_matches_jax_subpixel_layer(rng, b, cin, cout, h, w):
    """Without the epilogue, K3's plain version is JAX's
    ``layers.conv3x3_on_nearest_up2x`` (NHWC there, NCHW here)."""
    x, wt, bias = _conv_inputs(rng, b, cin, cout, h, w)
    got = conv.fused_upconv3x3(torch.from_numpy(x), _oihw(wt), torch.from_numpy(bias))
    ref = jax_layers.conv3x3_on_nearest_up2x(
        jnp.asarray(x.transpose(0, 2, 3, 1)), {"w": jnp.asarray(wt), "b": jnp.asarray(bias)}
    )
    np.testing.assert_allclose(
        got.numpy(), np.asarray(ref).transpose(0, 3, 1, 2), atol=1e-4, rtol=0
    )
    # and the naive up2x-then-conv, both in the port
    naive = layers.conv2d(
        layers.upsample_nearest_2x(torch.from_numpy(x)), _oihw(wt), torch.from_numpy(bias)
    )
    np.testing.assert_allclose(got.numpy(), naive.numpy(), atol=1e-4, rtol=0)


def test_packings_equal_jax_exactly(rng):
    _, wt, _ = _conv_inputs(rng, 1, 6, 10, 1, 1)
    np.testing.assert_array_equal(
        conv.pack_weights(_oihw(wt)).numpy(), np.asarray(jax_conv.pack_weights(jnp.asarray(wt)))
    )
    np.testing.assert_array_equal(
        conv.pack_upconv_weights(_oihw(wt)).numpy(),
        np.asarray(jax_conv.pack_upconv_weights(jnp.asarray(wt))),
    )


@pytest.mark.parametrize("t", [257, 300, 512])
def test_istft_fused_matches_jax(rng, t):
    real = rng.normal(size=(2, 513, t)).astype(np.float32)
    imag = rng.normal(size=(2, 513, t)).astype(np.float32)
    got = istft_fused(torch.from_numpy(real), torch.from_numpy(imag)).numpy()
    ref_kernel = np.asarray(jax_istft_fused(jnp.asarray(real), jnp.asarray(imag), interpret=True))
    ref_xla = np.stack([
        np.asarray(jax_istft_real_imag(jnp.asarray(real[i]), jnp.asarray(imag[i])))
        for i in range(2)
    ])
    assert got.shape == ref_kernel.shape == ref_xla.shape == (2, (t - 1) * 256)
    np.testing.assert_allclose(got, ref_kernel, atol=2e-4, rtol=0)
    np.testing.assert_allclose(got, ref_xla, atol=2e-4, rtol=0)


def test_istft_fused_unbatched(rng):
    real = rng.normal(size=(513, 64)).astype(np.float32)
    imag = rng.normal(size=(513, 64)).astype(np.float32)
    got = istft_fused(torch.from_numpy(real), torch.from_numpy(imag)).numpy()
    ref = np.asarray(jax_istft_real_imag(jnp.asarray(real), jnp.asarray(imag)))
    np.testing.assert_allclose(got, ref, atol=2e-4, rtol=0)


@pytest.mark.parametrize("op", ["conv", "upconv", "istft"])
def test_wrappers_raise_on_a_device_without_a_kernel(op):
    """A tensor that is neither on the CPU nor on CUDA has no path: the
    wrapper raises instead of computing somewhere else."""
    meta = torch.device("meta")
    x = torch.empty(1, 4, 4, 4, device=meta)
    w = torch.empty(4, 4, 3, 3, device=meta)
    b = torch.empty(4, device=meta)
    before = (conv.fused_conv3x3.launches, conv.fused_upconv3x3.launches, istft_fused.launches)
    with pytest.raises(ValueError, match="no kernel for device meta"):
        if op == "conv":
            conv.fused_conv3x3(x, w, b)
        elif op == "upconv":
            conv.fused_upconv3x3(x, w, b)
        else:
            istft_fused(torch.empty(1, 513, 8, device=meta), torch.empty(1, 513, 8, device=meta))
    after = (conv.fused_conv3x3.launches, conv.fused_upconv3x3.launches, istft_fused.launches)
    assert after == before


@pytest.mark.parametrize("op", ["conv", "upconv", "istft"])
def test_cpu_tensors_take_the_plain_version_and_count_no_launch(rng, op):
    """On the CPU each wrapper is exactly its plain version, whatever
    packed weights it is handed, and counts no launch."""
    x, wt, bias = (torch.from_numpy(a) for a in _conv_inputs(rng, 1, 4, 6, 4, 4))
    w = _oihw(wt.numpy())
    before = (conv.fused_conv3x3.launches, conv.fused_upconv3x3.launches, istft_fused.launches)
    if op == "conv":
        got = conv.fused_conv3x3(x, w, bias, 0.2, True, w_packed=torch.zeros(6, 36))
        ref = conv.conv3x3_plain(x, w, bias, 0.2, True)
    elif op == "upconv":
        got = conv.fused_upconv3x3(x, w, bias, 0.2, True, w_packed=torch.zeros(4, 6, 16))
        ref = conv.upconv3x3_plain(x, w, bias, 0.2, True)
    else:
        re, im = (torch.from_numpy(rng.normal(size=(2, 513, 9)).astype(np.float32)) for _ in "ri")
        got, ref = istft_fused(re, im), istft_real_imag(re, im)
    torch.testing.assert_close(got, ref, atol=0, rtol=0)
    after = (conv.fused_conv3x3.launches, conv.fused_upconv3x3.launches, istft_fused.launches)
    assert after == before


# Lengths outside the card's FFT route (n_fft not a power of two, or n_fft /
# hop past the frames an FFT block holds): the port takes any n_fft % hop ==
# 0, as the TPU kernel does.
@pytest.mark.parametrize("n_fft,hop", [(96, 32), (768, 256), (1024, 16), (99, 33)])
def test_istft_fused_other_lengths_match_jax(rng, n_fft, hop):
    t = 24
    real = rng.normal(size=(2, n_fft // 2 + 1, t)).astype(np.float32)
    imag = rng.normal(size=(2, n_fft // 2 + 1, t)).astype(np.float32)
    got = istft_fused(torch.from_numpy(real), torch.from_numpy(imag), n_fft, hop).numpy()
    ref = np.asarray(jax_istft_fused(jnp.asarray(real), jnp.asarray(imag), n_fft, hop, interpret=True))
    assert got.shape == ref.shape == (2, (t - 1) * hop)
    np.testing.assert_allclose(got, ref, atol=1e-5, rtol=0)
