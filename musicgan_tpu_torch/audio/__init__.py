"""Audio subsystem: magn/phase images -> spectra -> iSTFT -> WAV, and the
train step's batch transforms."""

from .functions import (
    bark_magn_scale,
    bark_scale_vector,
    magn_phase_to_signal,
    mp_to_real_imag,
)
from .io import load_wav, save_wav
from .stft import hann_window, istft_real_imag, overlap_add, signal_length
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
    "grower_transform",
    "hann_window",
    "istft_real_imag",
    "load_wav",
    "magn_phase_to_signal",
    "mp_to_real_imag",
    "overlap_add",
    "resize_batch",
    "save_wav",
    "signal_length",
]
