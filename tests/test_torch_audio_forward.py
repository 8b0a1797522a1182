"""The port's forward audio half (``audio/stft.py``'s ``stft``,
``frame_signal``, ``num_frames`` and ``istft``; ``audio/functions.py``'s
``unwrap``, ``signal_to_stft``, ``wav_to_stft`` and ``stft_to_phase_magn``),
``audio/rebin.py`` and ``view_audio`` against the JAX package, on the CPU.

Parity inputs are broadband noise: for near-silent STFT bins the phase is
rounding noise in either package, so a tone would test nothing but that."""

import importlib
import os

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from musicgan_tpu.audio import functions as jax_fn
from musicgan_tpu.audio.io import save_wav as jax_save_wav
from musicgan_tpu_torch.audio import functions
from musicgan_tpu_torch.config import AudioConfig

# Both audio packages export functions named ``stft`` and ``rebin`` over
# their modules.
jax_stft = importlib.import_module("musicgan_tpu.audio.stft")
jax_rebin = importlib.import_module("musicgan_tpu.audio.rebin")
stft = importlib.import_module("musicgan_tpu_torch.audio.stft")
rebin = importlib.import_module("musicgan_tpu_torch.audio.rebin")

SR = AudioConfig().sample_rate
# The repo's bar for the forward pipeline's images (tests/test_ingest.py):
# the phase channel is a min-max-scaled frequency, so an STFT rounding of
# 1e-6 relative can move a bin near a -pi/pi wrap by up to its full range
# only where the magnitude is tiny; on broadband noise it holds far below.
TOL_IMAGE = 2e-3


def _noise(rng, n: int) -> np.ndarray:
    return (rng.standard_normal(n) * 0.3).astype(np.float32)


@pytest.mark.parametrize("length,n_fft,hop", [
    (5_000, 1024, 256), (44_100 + 37, 1024, 256), (1_024, 1024, 256),
    (999, 64, 16), (4_097, 512, 128), (300, 256, 256),
])
def test_frames_and_stft_match_jax(rng, length, n_fft, hop):
    """Frame count, frames bit for bit (the same reflect pad), and the
    complex STFT within 2e-5 of JAX's float32 matrix-DFT (sums of up to
    1024 float32 products of magnitude ~1 in another order)."""
    x = _noise(rng, length)
    assert stft.num_frames(length, hop) == jax_stft.num_frames(length, hop)
    frames = stft.frame_signal(torch.from_numpy(x), n_fft, hop)
    ref = np.asarray(jax_stft.frame_signal(jnp.asarray(x), n_fft, hop))
    assert frames.shape == ref.shape == (stft.num_frames(length, hop), n_fft)
    np.testing.assert_array_equal(frames.numpy(), ref)

    z = stft.stft(torch.from_numpy(x), n_fft, hop)
    zr = np.asarray(jax_stft.stft(jnp.asarray(x), n_fft, hop))
    assert z.shape == zr.shape and z.dtype == torch.complex64
    np.testing.assert_allclose(z.numpy(), zr, atol=2e-5, rtol=0)


def test_stft_matches_torch_stft(rng):
    """And the library's own normalized STFT (the reference's
    ``torchaudio`` spectrogram), within 2e-5."""
    x = torch.from_numpy(_noise(rng, 20_000))
    window = torch.hann_window(1024)
    ref = torch.stft(x, 1024, 256, window=window, center=True, pad_mode="reflect",
                     normalized=False, return_complex=True) / window.pow(2).sum().sqrt()
    torch.testing.assert_close(stft.stft(x), ref, atol=2e-5, rtol=0)


@pytest.mark.parametrize("t", [9, 64])
def test_istft_of_a_complex_spectrogram_matches_jax(rng, t):
    z = (rng.standard_normal((513, t)) + 1j * rng.standard_normal((513, t))).astype(np.complex64)
    got = stft.istft(torch.from_numpy(z)).numpy()
    ref = np.asarray(jax_stft.istft(jnp.asarray(z)))
    assert got.shape == ref.shape == ((t - 1) * 256,)
    np.testing.assert_allclose(got, ref, atol=1e-5, rtol=0)


def test_stft_istft_round_trip(rng):
    x = _noise(rng, 256 * 40)
    back = stft.istft(stft.stft(torch.from_numpy(x))).numpy()
    np.testing.assert_allclose(back, x[: back.shape[0]], atol=1e-5, rtol=0)


def test_stft_refuses_tf32_on_the_card(monkeypatch):
    """A TF32 DFT would scramble the phase: on a CUDA tensor ``stft``
    raises while TF32 matmuls are allowed (the check runs before any work,
    so a tensor that only claims to be on the card shows it)."""
    class _OnCard(torch.Tensor):
        @property
        def device(self):
            return torch.device("cuda")

    x = torch.zeros(4096).as_subclass(_OnCard)
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", True)
    with pytest.raises(RuntimeError, match="allow_tf32"):
        stft.stft(x)


@pytest.mark.parametrize("shape,dim", [((7, 300), 1), ((300, 5), 0), ((4, 6, 50), 2)])
def test_unwrap_matches_jax_and_numpy(rng, shape, dim):
    """Wrapped phases with jumps of every size: the port's float32 unwrap
    equals JAX's to float32 rounding of the prefix sums (values reach ~100
    rad after 300 steps, where one float32 ulp is 7.6e-6: 3e-5 is four),
    and numpy's float64 ``unwrap`` to 1e-4."""
    phi = np.angle(np.exp(1j * np.cumsum(rng.uniform(-4, 4, shape), axis=dim))).astype(np.float32)
    got = functions.unwrap(torch.from_numpy(phi), dim=dim).numpy()
    ref = np.asarray(jax_fn.unwrap(jnp.asarray(phi), axis=dim))
    np.testing.assert_allclose(got, ref, atol=3e-5, rtol=0)
    np.testing.assert_allclose(got, np.unwrap(phi.astype(np.float64), axis=dim), atol=1e-4, rtol=0)


def test_signal_to_stft_and_phase_magn_match_jax(rng):
    """A 3.5 s broadband track through both packages: the complex STFT
    (Nyquist row dropped) within 2e-5, and the magnitude and phase images
    within 2e-3 (the repo's bar for this pipeline); the magnitude holds
    much tighter, 1e-5."""
    x = _noise(rng, int(SR * 3.5))
    z = functions.signal_to_stft(torch.from_numpy(x))
    zr = jax_fn.signal_to_stft(jnp.asarray(x))
    assert z.shape == zr.shape == (512, stft.num_frames(x.shape[0], 256))
    np.testing.assert_allclose(z.numpy(), np.asarray(zr), atol=2e-5, rtol=0)

    magn, phase = functions.stft_to_phase_magn(z)
    mr, pr = jax_fn.stft_to_phase_magn(zr)
    assert magn.shape == phase.shape == tuple(mr.shape) == (1, 512, 512)
    np.testing.assert_allclose(magn.numpy(), np.asarray(mr), atol=1e-5, rtol=0)
    np.testing.assert_allclose(phase.numpy(), np.asarray(pr), atol=TOL_IMAGE, rtol=0)
    # ... and most of the phase image far inside that bar
    assert float(np.median(np.abs(phase.numpy() - np.asarray(pr)))) < 1e-5


def test_wav_to_stft_matches_jax(tmp_path, rng):
    """From a WAV file on disk, with a shorter ``nb_vec`` that splits the
    track into several chunks and trims the leading frames."""
    p = str(tmp_path / "noise.wav")
    jax_save_wav(p, _noise(rng, int(SR * 2.2)), SR)
    z = functions.wav_to_stft(p, device="cpu")
    zr = jax_fn.wav_to_stft(p)
    np.testing.assert_allclose(z.numpy(), np.asarray(zr), atol=2e-5, rtol=0)
    magn, phase = functions.stft_to_phase_magn(z, nb_vec=96)
    mr, pr = jax_fn.stft_to_phase_magn(zr, nb_vec=96)
    assert magn.shape == tuple(mr.shape) == (3, 512, 96)
    np.testing.assert_allclose(magn.numpy(), np.asarray(mr), atol=1e-5, rtol=0)
    np.testing.assert_allclose(phase.numpy(), np.asarray(pr), atol=TOL_IMAGE, rtol=0)


def test_phase_magn_in_float64_is_within_the_bar_of_float32(rng):
    """The float64 path (what ``chip_smoke.py`` holds the card's float32
    against) agrees with float32 at the same 2e-3."""
    x = torch.from_numpy(_noise(rng, int(SR * 3.5)))
    m32, p32 = functions.stft_to_phase_magn(functions.signal_to_stft(x))
    m64, p64 = functions.stft_to_phase_magn(functions.signal_to_stft(x.double()))
    assert m64.dtype == torch.float64
    assert (m32.double() - m64).abs().max().item() < 1e-5
    assert (p32.double() - p64).abs().max().item() < TOL_IMAGE


def test_wav_to_stft_raises_without_a_gpu(tmp_path, rng):
    if torch.cuda.is_available():
        pytest.skip("a GPU is present, so the default device is usable")
    p = str(tmp_path / "a.wav")
    jax_save_wav(p, _noise(rng, 4096), SR)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        functions.wav_to_stft(p)


@pytest.mark.parametrize("scale", ["mel", "bark", "erb", "linear"])
def test_rebin_operator_equals_jax(scale):
    for ours, theirs in zip(rebin.rebin_operator(scale, 513, 64), jax_rebin.rebin_operator(scale, 513, 64)):
        np.testing.assert_array_equal(ours, theirs)
    np.testing.assert_array_equal(rebin.scale_frequencies(scale, 513),
                                  jax_rebin.scale_frequencies(scale, 513))


@pytest.mark.parametrize("scale,n_bins", [("bark", 128), ("mel", 64), ("erb", 33)])
def test_rebin_and_unbin_match_jax(rng, scale, n_bins):
    """Products of an averaging operator: within 1e-6 of JAX's."""
    spec = rng.uniform(0, 1, (513, 40)).astype(np.float32)
    got = rebin.rebin(torch.from_numpy(spec), scale, n_bins)
    ref = np.asarray(jax_rebin.rebin(jnp.asarray(spec), scale, n_bins))
    np.testing.assert_allclose(got.numpy(), ref, atol=1e-6, rtol=0)
    back = rebin.unbin(got, 513, scale).numpy()
    np.testing.assert_allclose(back, np.asarray(jax_rebin.unbin(jnp.asarray(ref), 513, scale)),
                               atol=1e-6, rtol=0)


def test_view_audio_writes_two_pngs(tmp_path, rng):
    pytest.importorskip("matplotlib")
    from musicgan_tpu_torch.view_audio import view_audio

    p = str(tmp_path / "track.wav")
    jax_save_wav(p, _noise(rng, int(SR * 6.5)), SR)
    out = tmp_path / "png"
    paths = view_audio(p, 1, output_dir=str(out), device="cpu")
    assert paths == [str(out / "track_magnitude_1.png"), str(out / "track_phase_1.png")]
    for q in paths:
        with open(q, "rb") as f:
            assert f.read(8) == b"\x89PNG\r\n\x1a\n"
        assert os.path.getsize(q) > 1000
