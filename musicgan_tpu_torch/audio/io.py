"""WAV I/O through ``scipy.io.wavfile`` (counterpart of
``musicgan_tpu/audio/io.py``'s WAV path; the optional soundfile/torchaudio
decoders for other formats are not ported).  Device compute never touches
this module."""

from __future__ import annotations

import numpy as np
from scipy.io import wavfile

__all__ = ["load_wav", "save_wav"]

_PCM_SCALE = {
    np.dtype(np.int16): 1 << 15,
    np.dtype(np.int32): 1 << 31,
    np.dtype(np.uint8): 1 << 7,
}


def load_wav(path: str, expected_sample_rate: int | None = None):
    """Read a WAV file -> (mono float32 signal in [-1, 1], sample_rate).

    Multi-channel audio is averaged to mono, matching reference
    ``audio/functions.py:49``."""
    sr, data = wavfile.read(path)
    if expected_sample_rate is not None and sr != expected_sample_rate:
        raise ValueError(
            f"Audio sample rate must be {expected_sample_rate}Hz, "
            f'file "{path}" is {sr}Hz'
        )
    if data.dtype in _PCM_SCALE:
        scale = _PCM_SCALE[np.dtype(data.dtype)]
        if data.dtype == np.uint8:  # 8-bit WAV is unsigned, offset binary
            data = data.astype(np.float32) - 128.0
        data = data.astype(np.float32) / scale
    else:
        data = data.astype(np.float32)
    if data.ndim == 2:
        data = data.mean(axis=1)
    return data, sr


def save_wav(path: str, signal: np.ndarray, sample_rate: int) -> None:
    """Write a mono float waveform as a 32-bit float WAV."""
    wavfile.write(path, sample_rate, np.asarray(signal, dtype=np.float32))
