"""Configuration dataclasses of the synthesis path and the train loop.

Copies of ``musicgan_tpu.config``'s ``AudioConfig``, ``ModelConfig``,
``TrainConfig`` and ``GenerateConfig`` (this package imports nothing of the
JAX one).  Whether a kernel runs or its plain version is chosen by the
tensor's device; ``ModelConfig.conv_impl`` chooses the lowering of the
generator's and the critic's convs, as in JAX.
"""

from __future__ import annotations

import dataclasses
import json
from typing import Optional, Tuple

# The names musicgan_tpu.config.ModelConfig.conv_impl takes, all ported.
CONV_IMPLS = (
    "auto", "xla", "subpixel", "pallas", "pallas_up", "pallas_block",
    "pallas_bf16", "pallas_up_bf16", "pallas_block_bf16", "pallas_train", "pallas_gp",
)
COMPUTE_DTYPES = ("float32", "bfloat16", "bfloat16_f32gp")
# What an image's two channels are (AudioConfig.freq_scale).
FREQ_SCALES = ("bark", "mel_if")


@dataclasses.dataclass(frozen=True)
class AudioConfig:
    """STFT geometry (reference ``audio/constant.py:1-4``)."""

    n_fft: int = 1024
    n_vec: int = 512          # frames per training sample (image width)
    stft_stride: int = 256    # hop length
    sample_rate: int = 44100
    # The image's spectrum: "bark" (MusicGAN's): channel 0 the bark-weighted
    # magnitude, channel 1 the instantaneous frequency, both in [-1, 1] on
    # the linear bins, the iSTFT normalized; "mel_if" (GANSynth's,
    # ``audio/functions.py::mel_if_to_real_imag``): channel 0 the
    # normalized log-mel magnitude squared, channel 1 the mel instantaneous
    # frequency in units of pi, on ``n_fft // 2`` mel bins, the iSTFT not
    # normalized (``tf.signal.inverse_stft``).  A "bark" image is bins x
    # frames, a "mel_if" one frames x bins.
    freq_scale: str = "bark"
    crop: int = 0             # samples a waveform keeps from its start; 0: all

    def __post_init__(self):
        if self.freq_scale not in FREQ_SCALES or self.crop < 0:
            raise ValueError(f"AudioConfig: freq_scale {self.freq_scale!r} (one of {FREQ_SCALES}), crop "
                             f"{self.crop} (>= 0)")

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
    # The lowering of the convs (``Generator.forward_nchw``,
    # ``Discriminator.forward_nchw``), the JAX package's names:
    # * "xla": the library lowering, ``F.conv2d`` / ``torch.matmul`` in the
    #   compute dtype (``models/layers.py``); "subpixel": the same with each
    #   up2x + conv3x3 as four 2x2 phase convs.  Differentiable twice.
    # * "pallas_up": each generator block as the conv kernel and the up-conv
    #   kernel (K1 + K3); "pallas_block": the whole-block kernel (K4) where
    #   ``ops.conv.fused_block_fits``, the pair elsewhere; "pallas": K1, a
    #   plain up2x, K1 again.  The "_bf16" names run the same in bf16.
    #   Inference only.
    # * "pallas_train": the trainable kernels (``ops/conv_vjp.py``, K2 and K1
    #   forward, K1 input gradients, the weight-gradient kernel), once
    #   differentiable: the gradient penalty's critic takes "xla";
    #   "pallas_gp": the same with the penalty's inner gradient unrolled by
    #   hand on the kernels.
    # * "auto": measured per shape by ``ops/autotune.py`` in the entry points
    #   (generate, serve, eval, the train step); inside the modules it means
    #   "xla", and on a CPU device it resolves to "xla" without measuring.
    conv_impl: str = "auto"
    # GANSynth's generator (Engel et al. 2019, the progressive GAN's), off
    # at the defaults, which are MusicGAN's:
    # * n_classes: a conditional generator; a one-hot label of this many
    #   classes joins the latent.
    # * dense_start: ``(h, w)`` of a dense input: the latent is ``(B, 1, 1,
    #   rand_channels)``, joined by the one-hot and pixel-normed, and a dense
    #   layer (the source's VALID ``(h, w)`` conv on the zero-padded 1x1
    #   input) gives ``gen_channels[0][0]`` channels at ``(h, w)``, then
    #   LeakyReLU and PixelNorm.  ``()``: the latent is the first block's
    #   input.
    # * tail_conv: a 3x3 conv, LeakyReLU and PixelNorm at the last width
    #   and the output size, before the head.
    # * audio: the vocoder's geometry; None: ``AudioConfig()``.
    # Any of them makes a generator that runs grown only: one head, no fade,
    # no training.
    n_classes: int = 0
    dense_start: Tuple[int, ...] = ()
    tail_conv: bool = False
    audio: Optional[AudioConfig] = None

    def __post_init__(self):
        if self.conv_impl not in CONV_IMPLS:
            raise ValueError(f"unknown conv_impl {self.conv_impl!r}; one of {CONV_IMPLS}")
        if len(self.dense_start) not in (0, 2) or (self.n_classes and not self.dense_start) or self.n_classes < 0:
            raise ValueError(f"dense_start {self.dense_start!r} is () or (h, w); n_classes {self.n_classes} "
                             "needs a dense input")

    @property
    def n_stages(self) -> int:
        return len(self.gen_channels)  # 8 (stages 0..7)

    @property
    def topology(self) -> str:
        """``""`` for MusicGAN's generator, else what sets it apart (the
        autotune table keys carry it)."""
        parts = [f"dense{self.dense_start[0]}x{self.dense_start[1]}"] if self.dense_start else []
        parts += [f"cls{self.n_classes}"] if self.n_classes else []
        parts += ["tail"] if self.tail_conv else []
        return "+".join(parts)

    @property
    def grown_only(self) -> bool:
        """A generator of one stage (``n_stages - 1``), one head, no fade."""
        return bool(self.dense_start or self.n_classes or self.tail_conv)

    @property
    def audio_config(self) -> AudioConfig:
        return AudioConfig() if self.audio is None else self.audio

    def image_size(self, latent_hw) -> tuple[int, int]:
        """The grown image's ``(H, W)`` from the latent's ``(h, w)``."""
        h, w = self.dense_start or latent_hw
        return h * 2**self.n_stages, w * 2**self.n_stages

    def frames(self, latent_hw) -> int:
        """STFT frames of the image: its time axis (the first of a "mel_if"
        image, the second of a "bark" one)."""
        h, w = self.image_size(latent_hw)
        return h if self.audio_config.freq_scale == "mel_if" else w


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    """Training hyperparameters (reference ``train.py:34-43,101-116,189``);
    the fields and defaults of ``musicgan_tpu.config.TrainConfig``."""

    batch_size: int = 6
    disc_lr: float = 1e-3
    gen_lr: float = 1e-3
    betas: Tuple[float, float] = (0.0, 0.9)
    nb_epoch: int = 1000
    n_critic: int = 5                # G step every 5th iteration
    grad_penalty_weight: float = 10.0
    drift_eps: float = 0.0           # ProGAN eps-drift: + eps * E[D(x_real)^2]
    ema_decay: float = 0.0           # generator weight EMA for eval; 0 = off
    # Progressive-growth schedule, in cumulative samples viewed.
    fadein_lengths: Tuple[int, ...] = (
        1, 25_000, 37_500, 50_000, 62_500, 75_000, 87_500, 100_000,
    )
    train_lengths: Tuple[int, ...] = (
        50_000, 100_000, 150_000, 200_000, 250_000, 300_000, 350_000,
    )
    save_every: int = 1000           # checkpoint + preview cadence (iters)
    metric_window: int = 20
    log_every: int = 200
    nb_preview: int = 6
    seed: int = 0
    # "bfloat16": bf16 conv / matmul operands (float32 parameters, Adam and
    # loss); "bfloat16_f32gp": the same but the gradient penalty in float32
    # (VALIDATION.md r2).  bf16 trains through the library lowerings only.
    compute_dtype: str = "float32"
    data_axis: str = "data"          # axis name of the data-parallel process group
    max_stage: Optional[int] = None  # cap growth (e.g. 3 for 32x32 runs)
    chunk_steps: int = 10            # iterations per ``build_chunk_step`` call;
    # identical to single stepping (tested); set 1 to disable
    host_pipeline: bool = True       # per-stage scaling on the host when
    # streaming: the host-to-device copy then scales with the stage's
    # resolution instead of always shipping raw 512x512 batches
    device_dataset: str = "auto"     # "on" | "off" | "auto": ship the whole
    # corpus to device memory once and pass per-step indices instead of
    # batches; "auto" enables it when the corpus fits the budget below
    device_dataset_budget_bytes: int = 4 << 30
    device_dataset_dtype: str = "float32"  # "bfloat16" halves the resident
    # corpus; rows are upcast as each batch is gathered, compute stays float32
    stall_timeout_s: float = 0.0     # > 0 enables the stall watchdog
    # (utils/watchdog.py): no metric fetch or checkpoint for this long exits 75
    tb_dir: Optional[str] = None     # optional TensorBoard sink
    mlflow_uri: Optional[str] = None  # optional MLflow sink (needs mlflow)

    def __post_init__(self):
        if self.compute_dtype not in COMPUTE_DTYPES:
            raise ValueError(f"unknown compute_dtype {self.compute_dtype!r}; one of {COMPUTE_DTYPES}")


@dataclasses.dataclass(frozen=True)
class GenerateConfig:
    """Inference defaults (reference ``generate.py:12-65``,
    ``__main__.py:67-78``)."""

    nb_vec: int = 10     # latent width multiplier -> ~29.7 s of audio
    nb_music: int = 5


# Fields the JAX package's configs lack: a config's JSON leaves each out at
# its default, so MusicGAN's configs write what they always wrote.
_LATER_FIELDS = ("freq_scale", "crop", "n_classes", "dense_start", "tail_conv", "audio")


def config_to_json(cfg) -> str:
    d = dataclasses.asdict(cfg)
    for f in dataclasses.fields(cfg):
        if f.name in _LATER_FIELDS and getattr(cfg, f.name) == f.default:
            del d[f.name]
    return json.dumps(d, indent=2, default=str)


def train_config_from_overrides(**overrides) -> TrainConfig:
    """Build a TrainConfig from CLI-style overrides, ignoring ``None``s."""
    clean = {k: v for k, v in overrides.items() if v is not None}
    return dataclasses.replace(TrainConfig(), **clean)
