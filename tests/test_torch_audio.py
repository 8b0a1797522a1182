"""The port's audio modules against the JAX package, on the CPU."""

import importlib

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from musicgan_tpu.audio import functions as jax_fn
from musicgan_tpu_torch.audio import functions, io, stft

# The JAX audio package exports a function named ``stft`` over its module.
jax_stft = importlib.import_module("musicgan_tpu.audio.stft")


def test_window_and_bases_equal_jax():
    np.testing.assert_array_equal(stft.hann_window(1024), jax_stft.hann_window(1024))
    for ours, theirs in zip(stft._idft_bases(1024), jax_stft._idft_bases(1024)):
        np.testing.assert_array_equal(ours, theirs)
    np.testing.assert_allclose(
        stft.hann_window(1024), torch.hann_window(1024).numpy(), atol=1e-6
    )
    np.testing.assert_array_equal(
        functions.bark_scale_vector().numpy(), np.asarray(jax_fn.bark_scale_vector())
    )


def test_overlap_add_matches_jax(rng):
    frames = rng.standard_normal((2, 7, 1024)).astype(np.float32)
    got = stft.overlap_add(torch.from_numpy(frames), 256).numpy()
    for b in range(2):
        ref = np.asarray(jax_stft.overlap_add(jnp.asarray(frames[b]), 256))
        np.testing.assert_allclose(got[b], ref, atol=1e-6, rtol=0)


def _mp_image(rng, m, n, w):
    """Generator-like images in [-1, 1]: magnitude and instantaneous
    frequency channels, ``(M, N, 2, 512, W)``."""
    return np.tanh(rng.standard_normal((m, n, 2, 512, w))).astype(np.float32)


def test_mp_to_real_imag_is_per_music(rng):
    """The batched form equals JAX's ``vmap`` over musics: the magnitude's
    min-max rescale reduces per music, not over the batch."""
    mp = _mp_image(rng, 3, 2, 64)
    mp[1, :, 0] *= 0.2  # a quieter music: a batch-wide reduction would show
    real, imag = functions.mp_to_real_imag(torch.from_numpy(mp))
    jr, ji = jax.vmap(jax_fn.mp_to_real_imag)(jnp.asarray(mp))
    assert real.shape == (3, 513, 128)
    np.testing.assert_allclose(real.numpy(), np.asarray(jr), atol=1e-4, rtol=0)
    np.testing.assert_allclose(imag.numpy(), np.asarray(ji), atol=1e-4, rtol=0)
    # one music alone gives the same as its slot of the batch
    r1, i1 = functions.mp_to_real_imag(torch.from_numpy(mp[1]))
    torch.testing.assert_close(r1, real[1], atol=0, rtol=0)
    torch.testing.assert_close(i1, imag[1], atol=0, rtol=0)


def test_phase_wraps_like_jax_remainder():
    """``phase % 2pi`` keeps the divisor's sign in both frameworks."""
    x = np.array([-7.0, -0.5, 0.0, 3.0, 6.5, 13.0], np.float32)
    np.testing.assert_array_equal(
        torch.remainder(torch.from_numpy(x), 2 * np.pi).numpy(),
        np.asarray(jnp.asarray(x) % (2 * jnp.pi)),
    )


@pytest.mark.parametrize("n,w", [(1, 512), (2, 96)])
def test_magn_phase_to_signal_matches_jax(rng, n, w):
    """Waveform bar 1e-4, as the repo holds the vocoder (nb_vec 1)."""
    mp = _mp_image(rng, 1, n, w)[0]
    got = functions.magn_phase_to_signal(torch.from_numpy(mp)).numpy()
    ref = np.asarray(jax_fn.magn_phase_to_signal(jnp.asarray(mp)))
    assert got.shape == ref.shape == ((n * w - 1) * 256,)
    np.testing.assert_allclose(got, ref, atol=1e-4, rtol=0)


def test_istft_real_imag_matches_torch_istft(rng):
    """The plain vocoder is torch.istft after the normalized rescale."""
    real = rng.standard_normal((513, 40)).astype(np.float32)
    imag = rng.standard_normal((513, 40)).astype(np.float32)
    imag[0] = imag[-1] = 0.0  # a real signal's DC and Nyquist bins
    got = stft.istft_real_imag(torch.from_numpy(real), torch.from_numpy(imag))
    window = torch.hann_window(1024)
    ref = torch.istft(
        torch.complex(torch.from_numpy(real), torch.from_numpy(imag)),
        1024, 256, window=window, center=True,
    ) * torch.sqrt(torch.sum(window**2))
    torch.testing.assert_close(got, ref, atol=1e-4, rtol=0)


def test_wav_roundtrip(tmp_path, rng):
    sig = (0.3 * rng.standard_normal(4410)).astype(np.float32)
    path = str(tmp_path / "x.wav")
    io.save_wav(path, sig, 44100)
    back, sr = io.load_wav(path, expected_sample_rate=44100)
    assert sr == 44100
    np.testing.assert_array_equal(back, sig)
    with pytest.raises(ValueError, match="sample rate"):
        io.load_wav(path, expected_sample_rate=22050)
