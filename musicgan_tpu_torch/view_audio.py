"""Visualization workflow: WAV -> magnitude/phase images (counterpart of
``musicgan_tpu/view_audio.py``; reference ``view_audio.py:6-26``).

The STFT and the image transform run on ``cuda`` unless the caller passes
``device="cpu"``.  PNGs are written next to the input (or shown when a
display is available and ``save`` is False).  matplotlib is imported inside
the function: the package imports without it.
"""

from __future__ import annotations

import os

import torch

from .audio import stft_to_phase_magn, wav_to_stft
from .device import resolve_device

__all__ = ["view_audio"]


def view_audio(
    audio_path: str,
    image_idx: int,
    save: bool = True,
    output_dir: str | None = None,
    device: str | torch.device | None = None,
) -> list[str]:
    device = resolve_device(device)
    import matplotlib

    if save:
        matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    z = wav_to_stft(audio_path, device=device)
    magn, phase = stft_to_phase_magn(z)
    magn = magn[image_idx].cpu().numpy()
    phase = phase[image_idx].cpu().numpy()

    out_paths = []
    base = os.path.splitext(os.path.basename(audio_path))[0]
    out_dir = output_dir or os.path.dirname(os.path.abspath(audio_path))
    if save:
        os.makedirs(out_dir, exist_ok=True)
    for name, img in (("magnitude", magn), ("phase", phase)):
        fig, ax = plt.subplots()
        fig.suptitle(name)
        ax.matshow(img / (img.max() - img.min()), cmap="plasma")
        if save:
            p = os.path.join(out_dir, f"{base}_{name}_{image_idx}.png")
            fig.savefig(p)
            plt.close(fig)
            out_paths.append(p)
        else:
            fig.show()
    return out_paths
