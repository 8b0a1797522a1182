"""The host-side halves of the redesigned kernels, on the CPU: the tables
and layouts that the iSTFT and conv kernels read, against numpy in
float64 and the JAX package's packings; and the plain versions that the
kernels are held to on the card, at the PixelNorm widths past 128
channels that the conv kernels now take, against the JAX package's Pallas
kernels in interpret mode (as ``tests/test_ops.py`` runs them)."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from musicgan_tpu.ops import conv as jax_conv
from musicgan_tpu_torch.audio.stft import cola_trim, hann_window
from musicgan_tpu_torch.ops import conv
from musicgan_tpu_torch.ops import istft_fused as istft_ops


@pytest.mark.parametrize("n_fft", [256, 1024])
def test_twiddle_table_is_exp_2_pi_i_k_over_n(n_fft):
    tw = istft_ops.twiddle_table(n_fft)
    want = np.exp(2j * np.pi * np.arange(n_fft) / n_fft)
    assert tw.shape == (n_fft, 2) and tw.dtype == np.float64
    np.testing.assert_allclose(tw[:, 0] + 1j * tw[:, 1], want, atol=1e-15, rtol=0)


@pytest.mark.parametrize("normalized", [True, False])
def test_window_table_folds_scale_and_one_over_n(normalized):
    w = hann_window(1024, np.float64)
    scale = np.sqrt(np.sum(w**2)) if normalized else 1.0
    np.testing.assert_allclose(
        istft_ops.window_table(1024, normalized), w * scale / 1024, rtol=1e-15, atol=0
    )


def _cola_trim_by_table(y, t, n_fft, hop):
    """``csrc/istft.cu``'s epilogue rule: trimmed output sample n lies at
    padded hop ``n // hop + r / 2``, which holds slices ``jlo..jhi`` of its
    frames; it is divided by the envelope read from the table there."""
    r = n_fft // hop
    table = istft_ops.inverse_envelope_table(n_fft, hop)
    n = np.arange((t - 1) * hop)
    qp, h = n // hop + r // 2, n % hop
    jlo, jhi = np.maximum(0, qp - t + 1), np.minimum(r - 1, qp)
    return y[..., n + n_fft // 2] * table[jlo, jhi, h]


@pytest.mark.parametrize("hop", [128, 256, 512])
@pytest.mark.parametrize("t", [1, 2, 3, 4, 5, 17])
def test_inverse_envelope_and_trim_match_cola_trim_on_a_ramp(hop, t):
    """The kernel's epilogue rule (the envelope by the slices a hop holds,
    the centring trim) against the plain versions' ``cola_trim``, on a ramp
    that makes every sample distinct; float32 envelopes in ``cola_trim``."""
    n_fft, r = 1024, 1024 // hop
    n = (t + r - 1) * hop
    ramp = (np.arange(2 * n, dtype=np.float64).reshape(2, n) + 1.0) / n
    got = _cola_trim_by_table(ramp, t, n_fft, hop)
    want = cola_trim(torch.from_numpy(ramp), t, n_fft, hop).numpy()
    assert got.shape == want.shape == (2, (t - 1) * hop)
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)


def test_inverse_envelope_interior_is_the_full_sum():
    table = istft_ops.inverse_envelope_table(1024, 256)
    w2 = hann_window(1024, np.float64) ** 2
    full = w2.reshape(4, 256).sum(axis=0)
    np.testing.assert_allclose(table[0, 3], 1.0 / full, rtol=1e-15)
    np.testing.assert_allclose(table[1, 2], 1.0 / (w2[256:512] + w2[512:768]), rtol=1e-15)


def _hwio(rng, cin, cout):
    return (rng.standard_normal((3, 3, cin, cout)) * 0.1).astype(np.float32)


def _oihw(w_hwio):
    return torch.from_numpy(np.ascontiguousarray(w_hwio.transpose(3, 2, 0, 1)))


@pytest.mark.parametrize("cin,cout", [(6, 10), (5, 16), (3, 33), (16, 160)])
def test_kernel_weights_are_jax_pack_weights_permuted(rng, cin, cout):
    """``kernel_weights``: JAX's ``(cout, 9*cin)`` packing, K ordered
    ``(dy, dx, c)``, as ``(cin, 9, coutp)`` with zeros past ``cout``."""
    wt = _hwio(rng, cin, cout)
    packed = np.asarray(jax_conv.pack_weights(jnp.asarray(wt)))          # (cout, 9*cin)
    coutp = -(-cout // 16) * 16
    want = np.zeros((cin, 9, coutp), np.float32)
    want[:, :, :cout] = packed.reshape(cout, 9, cin).transpose(2, 1, 0)
    np.testing.assert_array_equal(conv.kernel_weights(_oihw(wt)).numpy(), want)


@pytest.mark.parametrize("cin,cout", [(6, 10), (4, 32)])
def test_kernel_upconv_weights_are_jax_pack_upconv_weights_permuted(rng, cin, cout):
    wt = _hwio(rng, cin, cout)
    packed = np.asarray(jax_conv.pack_upconv_weights(jnp.asarray(wt)))  # (4, cout, 4*cin)
    coutp = -(-cout // 16) * 16
    want = np.zeros((4, cin, 4, coutp), np.float32)
    want[..., :cout] = packed.reshape(4, cout, 4, cin).transpose(0, 3, 2, 1)
    np.testing.assert_array_equal(conv.kernel_upconv_weights(_oihw(wt)).numpy(), want)


# The critic's widths past 128 channels, at its image sizes there, with a
# batch and a ragged image.
WIDE = [(2, 128, 144, 4, 4), (3, 144, 160, 2, 2), (1, 20, 144, 3, 5), (2, 16, 160, 5, 7)]


@pytest.mark.parametrize("b,cin,cout,h,w", WIDE)
def test_pixel_norm_past_128_channels_matches_jax(rng, b, cin, cout, h, w):
    """``fused_conv3x3(pixel_norm=True)`` and ``fused_conv3x3_msq`` at
    ``cout`` 144 and 160: on the CPU the plain versions, which the kernels
    are held to on the card, against the JAX kernels (interpret mode)."""
    x = rng.standard_normal((b, cin, h, w)).astype(np.float32)
    wt = _hwio(rng, cin, cout)
    bias = (rng.standard_normal(cout) * 0.1).astype(np.float32)
    xt, wo, bt = torch.from_numpy(x), _oihw(wt), torch.from_numpy(bias)
    ref = jax_conv.fused_conv3x3(
        jnp.asarray(x), jnp.asarray(wt), jnp.asarray(bias), slope=0.2, pixel_norm=True,
        interpret=True,
    )
    np.testing.assert_allclose(
        conv.fused_conv3x3(xt, wo, bt, 0.2, True).numpy(), np.asarray(ref), atol=1e-4, rtol=0
    )
    y_ref, m_ref = jax_conv.fused_conv3x3_msq(
        jnp.asarray(x), jnp.asarray(wt), jnp.asarray(bias), slope=0.2, eps=1e-8, interpret=True
    )
    y, m = conv.fused_conv3x3_msq(xt, wo, bt, 0.2, 1e-8)
    np.testing.assert_allclose(y.numpy(), np.asarray(y_ref), atol=1e-4, rtol=0)
    np.testing.assert_allclose(m.numpy(), np.asarray(m_ref), atol=0, rtol=1e-4)


def test_wrappers_refuse_pixel_norm_past_a_cluster():
    """PixelNorm's cap is now a cluster of 8 blocks of 128 channels; past
    it the wrapper says so (the check comes before any launch)."""
    x = torch.empty(1, 4, 2, 2, device="meta")
    w = torch.empty(conv.MAX_PIXEL_NORM_CHANNELS + 16, 4, 3, 3, device="meta")
    with pytest.raises(ValueError, match="PixelNorm"):
        conv._operands("conv3x3", x, w, None, True, w.shape[0])
    conv._operands("conv3x3", x, w, None, False, w.shape[0])  # no cap without it
