"""Dataset ingest of the port (``musicgan_tpu_torch/audio/ingest.py`` and
``native/``) against the JAX package's on the same seeded inputs: the
numpy mirror and every ``process_signal`` backend bit for bit, the native
tail's streaming API, and ``create_dataset``'s shards and ``index.json``
byte for byte."""

import filecmp
import os
import threading

import numpy as np
import pytest

from musicgan_tpu import native as jax_native
from musicgan_tpu.audio import ingest as jax_ingest
from musicgan_tpu_torch import native
from musicgan_tpu_torch.__main__ import main
from musicgan_tpu_torch.audio import ingest
from musicgan_tpu_torch.audio.io import save_wav
from musicgan_tpu_torch.config import AudioConfig

CFG = AudioConfig()
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _signal(seconds: float, seed: int) -> np.ndarray:
    """Broadband, music-like: two tones and noise."""
    sr = CFG.sample_rate
    t = np.arange(int(sr * seconds)) / sr
    noise = np.random.default_rng(seed).standard_normal(t.shape)
    return (0.2 * np.sin(2 * np.pi * 330 * t) + 0.1 * np.sin(2 * np.pi * 991 * t)
            + 0.05 * noise).astype(np.float32)


def _corpus(d, n=3, seconds=3.2):
    os.makedirs(d, exist_ok=True)
    for i in range(n):
        save_wav(os.path.join(d, f"t{i}.wav"), _signal(seconds + 1.5 * i, i), CFG.sample_rate)
    return d


def test_host_ops_source_is_the_jax_packages_byte_for_byte():
    with open(os.path.join(ROOT, "musicgan_tpu", "native", "host_ops.cpp"), "rb") as f:
        theirs = f.read()
    with open(os.path.join(ROOT, "musicgan_tpu_torch", "native", "host_ops.cpp"), "rb") as f:
        assert f.read() == theirs


def test_native_builds_into_the_ports_build_directory():
    assert native.is_available()
    path = native.lib_path()
    assert os.path.dirname(path) == os.path.join(ROOT, "musicgan_tpu_torch", "_build")
    assert os.path.isfile(path)
    assert native.CXX_FLAGS == ("-O3", "-march=native", "-fno-math-errno", "-shared", "-fPIC")


def test_numpy_mirror_equals_jax_bit_for_bit():
    sig = _signal(2.1, 3)
    view, t, win = ingest._framing_setup(sig, CFG.n_fft, CFG.stft_stride)
    view_j, t_j, win_j = jax_ingest._framing_setup(sig, CFG.n_fft, CFG.stft_stride)
    assert t == t_j
    np.testing.assert_array_equal(view[:t], view_j[:t])
    np.testing.assert_array_equal(win, win_j)
    np.testing.assert_array_equal(
        ingest._stft_frames(sig, CFG.n_fft, CFG.stft_stride),
        jax_ingest._stft_frames(sig, CFG.n_fft, CFG.stft_stride),
    )
    np.testing.assert_array_equal(ingest._stft_np(sig, 256, 64), jax_ingest._stft_np(sig, 256, 64))
    np.testing.assert_array_equal(
        ingest._bark_scale_np(CFG.n_bins, CFG.sample_rate),
        jax_ingest._bark_scale_np(CFG.n_bins, CFG.sample_rate),
    )
    rng = np.random.default_rng(4)
    ph = rng.uniform(-np.pi, np.pi, (64, 400)).astype(np.float32)
    # near-real bins: EXACT +-float32(pi) angles, the wrap's sign edge
    ph[0, ::2], ph[0, 1::2] = np.float32(np.pi), 0.0
    ph[1, ::2], ph[1, 1::2] = 0.0, np.float32(-np.pi)
    np.testing.assert_array_equal(ingest._phase_diff_np(ph), jax_ingest._phase_diff_np(ph))
    want = np.diff(np.unwrap(ph.astype(np.float64), axis=1), axis=1)
    np.testing.assert_allclose(ingest._phase_diff_np(ph), want, atol=2e-6)


@pytest.mark.parametrize("backend", ["native", "numpy", "torch", "auto"])
def test_process_signal_equals_jax_under_each_backend(backend):
    """Same torch rfft, same ``host_ops.cpp`` built with the same flags:
    the same bits under each backend."""
    sig = _signal(4.0, 5)
    got = ingest.process_signal(sig, backend=backend)
    want = jax_ingest.process_signal(sig, backend=backend)
    assert got.shape == (1, 2, CFG.n_bins, CFG.n_vec) and got.dtype == np.float32
    np.testing.assert_array_equal(got, want)


def test_backends_agree_and_the_blocked_path_crosses_blocks(monkeypatch):
    """The three tails agree at the JAX tests' bar (2e-6), and the blocked
    native pipeline gives the one-block result's bits across many blocks."""
    sig = _signal(4.0, 6)
    a = ingest.process_signal(sig, backend="numpy")
    b = ingest.process_signal(sig, backend="native")
    c = ingest.process_signal(sig, backend="torch")
    np.testing.assert_allclose(a, b, atol=2e-6)
    np.testing.assert_allclose(a, c, atol=2e-6)
    monkeypatch.setattr(ingest, "_BLOCK_FRAMES", 97)
    np.testing.assert_array_equal(ingest.process_signal(sig, backend="native"), b)
    with pytest.raises(ValueError, match="backend"):
        ingest.process_signal(sig, backend="jax")


def test_pack_stream_is_invariant_to_the_block_split():
    rng = np.random.default_rng(7)
    t, ld, n_bins, n_vec = 131, 17, 16, 32
    z = (rng.standard_normal((t, ld)) + 1j * rng.standard_normal((t, ld))).astype(np.complex64)
    bark = ingest._bark_scale_np(n_bins, 44100)
    want = native.magn_phase_pack(z, bark, n_vec)
    np.testing.assert_array_equal(want, jax_native.magn_phase_pack(z, bark, n_vec))
    for split in (1, 3, 16, 50, t):
        stream = native.PackStream(t, ld, bark, n_vec)
        for i in range(0, t, split):
            stream.feed(z[i:i + split])
        np.testing.assert_array_equal(stream.finish(), want, err_msg=f"split={split}")


def test_pack_stream_guards():
    """Real exceptions, not asserts: misuse must not reach the C layer."""
    bark = ingest._bark_scale_np(8, 44100)
    rng = np.random.default_rng(0)
    z = (rng.standard_normal((33, 9)) + 1j * rng.standard_normal((33, 9))).astype(np.complex64)
    stream = native.PackStream(33, 9, bark, 16)
    with pytest.raises(ValueError, match="ld"):
        stream.feed(z[:, :5])
    stream.feed(z)
    with pytest.raises(ValueError, match="overfeed"):
        stream.feed(z[:1])
    stream.finish()
    with pytest.raises(ValueError, match="finished"):
        stream.feed(z)
    with pytest.raises(ValueError, match="finished"):
        stream.finish()
    short = native.PackStream(33, 9, bark, 16)
    short.feed(z[:10])
    with pytest.raises(ValueError, match="fed 10 of 33"):
        short.finish()
    with pytest.raises(ValueError, match="shorter than one chunk"):
        native.PackStream(16, 9, bark, 16)


def test_one_chunk_boundary_and_short_tracks_give_none(tmp_path):
    """Exactly n_vec frames is shorter than one chunk (the first difference
    drops a frame): every backend says None, as does a 0.5 s WAV."""
    sig = np.zeros((CFG.n_vec - 1) * CFG.stft_stride, np.float32)
    for backend in ingest.BACKENDS:
        assert ingest.process_signal(sig, CFG, backend=backend) is None, backend
    p = str(tmp_path / "short.wav")
    save_wav(p, _signal(0.5, 1), CFG.sample_rate)
    assert ingest.process_wav(p) is None


def _same_tree(a, b):
    names = sorted(os.listdir(a))
    assert names == sorted(os.listdir(b))
    for name in names:
        assert filecmp.cmp(os.path.join(a, name), os.path.join(b, name), shallow=False), name
    return names


def test_create_dataset_is_byte_identical_to_jax(tmp_path):
    wavs = _corpus(str(tmp_path / "wavs"))
    ours, theirs = str(tmp_path / "ours"), str(tmp_path / "theirs")
    got = ingest.create_dataset(str(tmp_path / "wavs" / "*.wav"), ours, num_workers=1,
                                samples_per_shard=2, progress=False)
    want = jax_ingest.create_dataset(str(tmp_path / "wavs" / "*.wav"), theirs, num_workers=1,
                                     samples_per_shard=2, progress=False)
    assert got == want and got["errors"] == []
    assert got["total_samples"] == 4 and got["complete"]  # 1 + 1 + 2 chunks
    assert _same_tree(ours, theirs) == ["index.json", "shard_00000.npy", "shard_00001.npy"]
    assert os.path.isdir(wavs)


def test_create_dataset_pool_from_a_threaded_process(tmp_path):
    """A caller with threads (here, one started for the purpose; on the
    card, CUDA's) never forks: the pool takes the forkserver, which
    preloads the port's ingest only, and the result is the serial one's."""
    _corpus(str(tmp_path / "wavs"))
    pattern = str(tmp_path / "wavs" / "*.wav")
    one, two = str(tmp_path / "one"), str(tmp_path / "two")
    ingest.create_dataset(pattern, one, num_workers=1, samples_per_shard=2, progress=False)
    stop = threading.Event()
    th = threading.Thread(target=stop.wait)
    th.start()
    try:
        assert ingest._start_method() == "forkserver"
        index = ingest.create_dataset(pattern, two, num_workers=2, samples_per_shard=2, progress=False)
    finally:
        stop.set()
        th.join(timeout=10)
    assert not th.is_alive()
    assert index["errors"] == [] and index["total_samples"] == 4
    _same_tree(one, two)


def test_bare_directory_is_read_recursively_and_case_insensitively(tmp_path):
    corpus = tmp_path / "corpus"
    (corpus / "album1").mkdir(parents=True)
    save_wav(str(corpus / "TRACK01.WAV"), _signal(3.2, 1), CFG.sample_rate)
    save_wav(str(corpus / "album1" / "t2.wav"), _signal(3.2, 2), CFG.sample_rate)
    (corpus / "notes.txt").write_text("not audio")
    (corpus / "album1" / "t3.flac").write_bytes(b"fLaC not decodable here")
    index = ingest.create_dataset(str(corpus), str(tmp_path / "ds"), num_workers=1,
                                  samples_per_shard=2, progress=False)
    assert index["total_samples"] == 2
    # the port decodes WAV only: the .flac lands in the errors
    assert [os.path.basename(p) for p, _ in index["errors"]] == ["t3.flac"]


def test_a_path_matching_nothing_raises(tmp_path):
    with pytest.raises(FileNotFoundError, match="no audio files"):
        ingest.create_dataset(str(tmp_path / "*.wav"), str(tmp_path / "ds"), progress=False)
    (tmp_path / "empty").mkdir()
    with pytest.raises(FileNotFoundError, match="no audio files"):
        ingest.create_dataset(str(tmp_path / "empty"), str(tmp_path / "ds"), progress=False)


def test_create_dataset_cli(tmp_path, capsys):
    _corpus(str(tmp_path / "wavs"), n=2)
    out = str(tmp_path / "ds")
    main(["create_dataset", str(tmp_path / "wavs"), "-o", out, "-w", "1", "--samples-per-shard", "2"])
    assert capsys.readouterr().out == f"wrote 2 samples in 1 shards to {out}\n"
    with pytest.raises(SystemExit):
        main(["create_dataset", str(tmp_path / "wavs"), "-o", out, "--device", "cpu"])
