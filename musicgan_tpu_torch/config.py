"""Configuration dataclasses of the synthesis path and the train step.

Copies of ``musicgan_tpu.config``'s ``AudioConfig``, ``ModelConfig``,
``TrainConfig`` (the fields the train step reads) and ``GenerateConfig``
(this package imports nothing of the JAX one).  The kernel behind each
conv is chosen by the tensor's device, so ``ModelConfig`` carries no
``conv_impl``.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple


@dataclasses.dataclass(frozen=True)
class AudioConfig:
    """STFT geometry (reference ``audio/constant.py:1-4``)."""

    n_fft: int = 1024
    n_vec: int = 512          # frames per training sample (image width)
    stft_stride: int = 256    # hop length
    sample_rate: int = 44100

    @property
    def n_bins(self) -> int:
        """Frequency bins kept after dropping the Nyquist row (512)."""
        return self.n_fft // 2

    @property
    def seconds_per_sample(self) -> float:
        """Wall-clock audio seconds covered by one 512x512 sample."""
        return self.n_vec * self.stft_stride / self.sample_rate


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    """Network geometry (reference ``generator.py:67-76``,
    ``discriminator.py:60-70``)."""

    rand_channels: int = 32
    latent_height: int = 2
    latent_width: int = 2
    # Generator per-block (in, out) channels; 8 blocks: 4x4 .. 512x512.
    gen_channels: Tuple[Tuple[int, int], ...] = (
        (32, 128), (128, 112), (112, 96), (96, 80),
        (80, 64), (64, 48), (48, 32), (32, 16),
    )
    # Discriminator per-block (in, out) channels; 9 blocks: 512 -> 1.
    disc_channels: Tuple[Tuple[int, int], ...] = (
        (16, 32), (32, 48), (48, 64), (64, 80), (80, 96),
        (96, 112), (112, 128), (128, 144), (144, 160),
    )
    leaky_slope: float = 0.2
    pixel_norm_eps: float = 1e-8

    @property
    def n_stages(self) -> int:
        return len(self.gen_channels)  # 8 (stages 0..7)


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    """Hyperparameters of the train step (reference ``train.py:34-43,
    101-116,189``).  The schedule, logging and data-placement fields of the
    JAX ``TrainConfig`` come with the train loop."""

    batch_size: int = 6
    disc_lr: float = 1e-3
    gen_lr: float = 1e-3
    betas: Tuple[float, float] = (0.0, 0.9)
    n_critic: int = 5                # G step every 5th iteration
    grad_penalty_weight: float = 10.0
    drift_eps: float = 0.0           # ProGAN eps-drift: + eps * E[D(x_real)^2]
    ema_decay: float = 0.0           # generator weight EMA for eval; 0 = off
    chunk_steps: int = 10            # iterations per ``build_chunk_step`` call
    seed: int = 0
    compute_dtype: str = "float32"   # the only one ported (ROADMAP B8)

    def __post_init__(self):
        if self.compute_dtype != "float32":
            raise NotImplementedError(
                f"compute_dtype {self.compute_dtype!r}: only float32 is ported; "
                "bf16 I/O of the conv kernels is ROADMAP.md section B item 8"
            )


@dataclasses.dataclass(frozen=True)
class GenerateConfig:
    """Inference defaults (reference ``generate.py:12-65``,
    ``__main__.py:67-78``)."""

    nb_vec: int = 10     # latent width multiplier -> ~29.7 s of audio
    nb_music: int = 5
