"""Generation workflow: latent -> spectrogram image -> waveform.

Counterpart of ``musicgan_tpu/generate.py``.  ``synthesize_fn`` resolves
``ModelConfig.conv_impl`` ("auto" by default) and the vocoder per latent
shape (``ops/autotune.py``: measured once on the card and persisted; "xla"
on the CPU), then the generator runs its blocks through the lowering that
won: the fused conv kernels (K1 and K3 under ``"pallas_up"``, the
whole-block kernel K4 where ``ops.conv.fused_block_fits`` under
``"pallas_block"``, K1 twice around a plain up2x under ``"pallas"``; in bf16
under the ``_bf16`` names) or the library lowering (``"xla"``,
``"subpixel"``: ``F.conv2d``), the image float32 either way.  The
magnitude/phase image is turned into spectra in plain PyTorch (bark
unscale, phase prefix sum, cos/sin, per music as JAX's ``vmap`` does), and
the vocoder inverts the whole batch: the fused iSTFT kernel (K5) in one
launch under ``"pallas"``, the plain matmul iSTFT on the device under
``"xla"``.

Width-extended latents give long clips: ``z`` of width ``2 * nb_vec``
produces ``512 * nb_vec`` STFT frames, about ``2.97 * nb_vec`` seconds.

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``,
which runs every kernel's plain version; without a GPU they raise.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

from .audio import mp_to_real_imag, save_wav
from .audio.stft import istft_real_imag
from .config import AudioConfig, GenerateConfig, ModelConfig
from .device import resolve_device
from .models import Generator
from .models.layers import library_numerics
from .ops.istft_fused import istft_fused

__all__ = ["resolve_device", "latents", "synthesize_fn", "load_generator_params", "generate"]


def latents(
    model_cfg: ModelConfig, nb_vec: int, nb_music: int, seed: int, device
) -> torch.Tensor:
    """The seeded latent draw: ``(nb_music, latent_height, latent_width *
    nb_vec, rand_channels)`` standard normals from
    ``torch.Generator(device).manual_seed(seed)``.  ``generate`` draws
    through it, a ``serve`` request (``nb_music=1``: the same draw as
    ``generate(seed=s, nb_music=1)``) and ``eval`` / ``compare``; tests
    replace it to hand in JAX's draws (JAX and PyTorch draw different numbers
    from one seed)."""
    shape = (nb_music, model_cfg.latent_height, model_cfg.latent_width * nb_vec,
             model_cfg.rand_channels)
    rng = torch.Generator(device=device).manual_seed(seed)
    return torch.randn(shape, generator=rng, device=device)


@torch.no_grad()
def _synthesize(
    gen: Generator, z: torch.Tensor, stage: int, model_cfg: ModelConfig, istft_impl: str = "xla"
) -> torch.Tensor:
    """``(M, h, 2*nb_vec, C)`` latent -> ``(M, T)`` waveforms through
    ``model_cfg.conv_impl`` (a resolved name: "auto" here is "xla", as in
    the generator) and the vocoder ``istft_impl``: ``"pallas"`` is the
    kernel K5, ``"xla"`` the plain matmul iSTFT on the device.

    For a partially grown ``stage`` the image is nearest-upsampled to the
    full 512-bin resolution before vocoding, so audio can be auditioned
    from any growth checkpoint."""
    img = gen.forward_nchw(z.permute(0, 3, 1, 2), stage, 1.0, model_cfg.conv_impl)  # (M, 2, H, W)
    n_stages = model_cfg.n_stages
    if stage < n_stages - 1:
        img = F.interpolate(img, scale_factor=2 ** (n_stages - 1 - stage), mode="nearest")
    acfg = AudioConfig()
    real, imag = mp_to_real_imag(img[:, None], acfg)  # (M, n_bins + 1, T)
    if istft_impl == "pallas":
        return istft_fused(real, imag, n_fft=acfg.n_fft, hop=acfg.stft_stride)
    with library_numerics():  # its products in float32, not TF32
        return istft_real_imag(real, imag, n_fft=acfg.n_fft, hop=acfg.stft_stride)


def synthesize_fn(model_cfg: ModelConfig = ModelConfig(), stage: int = 7):
    """Returns ``f(gen, z) -> waveforms``: the synthesis path.  ``z`` is
    ``(M, h, w, C)`` (numpy or tensor) and moves to ``gen``'s device.

    ``conv_impl="auto"`` resolves to the measured winner at the first call
    of each latent shape, and the vocoder likewise (cached per process and
    persisted; ``ops/autotune.py``), here, where ``z``'s shape is known.
    Inside a CUDA-graph capture the resolution reads the tables only (the
    persisted winner, else "xla") and never runs the timing harness."""
    from .ops.autotune import resolve_conv_impl, resolve_istft_impl

    def f(gen: Generator, z) -> torch.Tensor:
        device = next(gen.parameters()).device
        z = torch.as_tensor(z, dtype=torch.float32, device=device)
        cfg = resolve_conv_impl(model_cfg, tuple(z.shape), stage, device=device)
        # Spectrum frames the vocoder inverts: the stack upsamples x2 per
        # block and partial stages are nearest-upsampled to full resolution,
        # so every latent column becomes 2^n_stages frames at any stage.
        t_frames = z.shape[2] * 2**model_cfg.n_stages
        istft_impl = resolve_istft_impl(t_frames, device=device)
        return _synthesize(gen, z, stage, cfg, istft_impl)

    return f


def load_generator_params(
    ckpt: str, model_cfg: ModelConfig = ModelConfig(), device="cuda"
) -> Generator:
    """Load a generator from either a checkpoint of this package's ``train``
    (a run directory, its ``checkpoints`` directory or a specific ``save_N``
    directory) or a reference PyTorch ``gen_*.pt`` state_dict.  A
    ``musicgan_tpu`` (orbax) checkpoint directory raises
    ``NotImplementedError``."""
    if os.path.isfile(ckpt) and ckpt.endswith(".pt"):
        from .models.torch_ingest import load_reference_generator

        return load_reference_generator(ckpt, model_cfg, device=device)

    from .train.checkpoint import CheckpointManager, resolve_checkpoint
    from .train.step import init_train_state

    root, save_idx = resolve_checkpoint(ckpt)
    template = init_train_state(0, model_cfg, device=device)
    state, _ = CheckpointManager(root).restore(save_idx, template, load_rng=False)
    # EMA-carrying runs (TrainConfig.ema_decay > 0) ship the averaged
    # weights: the ProGAN/GANSynth eval convention.
    if state.gen_ema is not None:
        state.gen.load_state_dict(state.gen_ema)
    return state.gen


def generate(
    output_dir: str,
    rand_channels: int,
    gen_ckpt: str,
    nb_vec: int = GenerateConfig.nb_vec,
    nb_music: int = GenerateConfig.nb_music,
    seed: int = 0,
    stage: int = 7,
    model_cfg: Optional[ModelConfig] = None,
    audio_cfg: AudioConfig = AudioConfig(),
    z=None,
    device: str | torch.device | None = None,
) -> list[str]:
    """CLI workflow (reference ``generate.py:12-65``): sample ``nb_music``
    wide latents, synthesize, write ``sound_{i}.wav``.  Returns paths.

    ``z``: optional explicit latent batch ``(nb_music, latent_height,
    latent_width * nb_vec, rand_channels)`` overriding the seeded draw,
    for cross-framework parity tests (JAX and PyTorch draw different
    numbers from one seed; matching by value is exact)."""
    device = resolve_device(device)
    if model_cfg is None:
        model_cfg = (
            ModelConfig()
            if rand_channels == ModelConfig.rand_channels
            else dataclasses.replace(ModelConfig(), rand_channels=rand_channels)
        )
    os.makedirs(output_dir, exist_ok=True)

    gen = load_generator_params(gen_ckpt, model_cfg, device)
    expect = (
        nb_music,
        model_cfg.latent_height,
        model_cfg.latent_width * nb_vec,
        model_cfg.rand_channels,
    )
    if z is None:
        z = latents(model_cfg, nb_vec, nb_music, seed, device)
    elif tuple(z.shape) != expect:
        raise ValueError(f"z shape {tuple(z.shape)} != expected {expect}")
    waves = synthesize_fn(model_cfg, stage)(gen, z).cpu().numpy()

    paths = []
    for i, w in enumerate(waves):
        p = os.path.join(output_dir, f"sound_{i}.wav")
        save_wav(p, w, audio_cfg.sample_rate)
        paths.append(p)
    return paths
