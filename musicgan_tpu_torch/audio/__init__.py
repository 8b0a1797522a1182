"""Audio subsystem of the synthesis path: magn/phase images -> spectra ->
iSTFT -> WAV."""

from .functions import (
    bark_magn_scale,
    bark_scale_vector,
    magn_phase_to_signal,
    mp_to_real_imag,
)
from .io import load_wav, save_wav
from .stft import hann_window, istft_real_imag, overlap_add, signal_length

__all__ = [
    "bark_magn_scale",
    "bark_scale_vector",
    "hann_window",
    "istft_real_imag",
    "load_wav",
    "magn_phase_to_signal",
    "mp_to_real_imag",
    "overlap_add",
    "save_wav",
    "signal_length",
]
