"""Audio subsystem: STFT <-> magn/phase transforms, WAV I/O, frequency
re-binning and the train step's batch transforms.

Unlike the JAX package, the functions ``stft.stft`` and ``rebin.rebin`` are
not exported here: the names stay those of their modules."""

from .functions import (
    bark_magn_scale,
    bark_scale_vector,
    magn_phase_to_signal,
    mel_if_to_real_imag,
    mp_to_real_imag,
    signal_to_stft,
    stft_to_phase_magn,
    unwrap,
    wav_to_stft,
)
from .io import load_wav, save_wav
from .rebin import rebin_operator, scale_frequencies, unbin
from .stft import (
    frame_signal,
    hann_window,
    istft,
    istft_real_imag,
    num_frames,
    overlap_add,
    signal_length,
)
from .transforms import (
    change_range,
    channel_min_max_norm,
    grower_transform,
    resize_batch,
)

__all__ = [
    "bark_magn_scale",
    "bark_scale_vector",
    "change_range",
    "channel_min_max_norm",
    "frame_signal",
    "grower_transform",
    "hann_window",
    "istft",
    "istft_real_imag",
    "load_wav",
    "magn_phase_to_signal",
    "mel_if_to_real_imag",
    "mp_to_real_imag",
    "num_frames",
    "overlap_add",
    "rebin_operator",
    "resize_batch",
    "save_wav",
    "scale_frequencies",
    "signal_length",
    "signal_to_stft",
    "stft_to_phase_magn",
    "unbin",
    "unwrap",
    "wav_to_stft",
]
